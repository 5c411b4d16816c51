"""PyTorch port of the SLAM core (feature_detector_tpu/slam: lie, linalg3,
camera, evaluate, geometry, pose_graph, single-device ba) against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
RANSACs get JAX's own Gumbel draws (``ransac_draws``), so everything after
the draw is compared directly.  Tolerances, each measured on these inputs
(listed in CHANGES.md too):

- lie, linalg3, camera: 1e-6 (inverse and solve relative 1e-6);
- evaluate: 1e-5;
- triangulate 1e-4 (points); E up to sign 2e-3 of JAX's and 1e-3 of the
  float64 solution (the 8-point eigenvector's float32 limit, see the test);
  the decomposition of the same E 1e-4;
- two_view_init and epipolar_inlier_gate given JAX's draws: poses 1e-4,
  inlier masks equal;
- pnp_solve, pnp_refine, pose_graph_solve: 1e-4;
- ba_solve (the port solves wholly in float64; JAX, under its _x64_scope,
  solves in float64 over float32 state): cameras and points within 1e-4 of
  their magnitude (BA_RTOL; measured at most 1.9e-5), gated observations
  equal;
- _ba_solve_impl with dense frames in float32 on both sides: 5e-4
  (BA_F32_ATOL; measured 8.2e-5); a problem in a batch against the same
  problem alone: 5e-3 (BA_BATCH_ATOL; measured 1.5e-3 on points: float32
  LM amplifies the batched BLAS's other rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_detector_tpu.core.config import BAOptions as JBAOptions
from feature_detector_tpu.slam import ba as JBA
from feature_detector_tpu.slam import camera as JCAM
from feature_detector_tpu.slam import evaluate as JEV
from feature_detector_tpu.slam import geometry as JG
from feature_detector_tpu.slam import lie as JL
from feature_detector_tpu.slam import linalg3 as JL3
from feature_detector_tpu.slam import pose_graph as JPG
from feature_detector_tpu_torch.core.config import BAOptions
from feature_detector_tpu_torch.core.convert import from_jax
from feature_detector_tpu_torch.slam import ba as TBA
from feature_detector_tpu_torch.slam import camera as TCAM
from feature_detector_tpu_torch.slam import evaluate as TEV
from feature_detector_tpu_torch.slam import geometry as TG
from feature_detector_tpu_torch.slam import lie as TL
from feature_detector_tpu_torch.slam import linalg3 as TL3
from feature_detector_tpu_torch.slam import pose_graph as TPG
from tests.test_slam import perturb, synthetic_ba

CAM_BA = JCAM.Pinhole(fx=400.0, fy=400.0, cx=376.0, cy=240.0)  # tests/test_slam.py
CAM_2V = JCAM.Pinhole(fx=300.0, fy=300.0, cx=160.0, cy=120.0)  # tests/test_geometry.py
POSE_ATOL = 1e-4
BA_RTOL = 1e-4
BA_F32_ATOL = 5e-4
BA_BATCH_ATOL = 5e-3


def t(x):
    return torch.from_numpy(np.array(x))


def n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def ransac_draws(seed: int, rounds: int, count: int) -> np.ndarray:
    """JAX's Gumbel noise of geometry.two_view_init / epipolar_inlier_gate."""
    keys = jax.random.split(jax.random.PRNGKey(seed), rounds)
    return np.array(jax.vmap(lambda k: jax.random.gumbel(k, (count,)))(keys))


def two_view_scene(seed: int, count: int = 64, outliers: int = 0, noise: float = 0.3):
    """Points in front of A (identity) and B; B's pixels with noise and
    ``outliers`` gross mismatches."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (count, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    r_b = n(TL.so3_exp(t(np.float32([0.02, 0.3, -0.01]) + rng.normal(0, 0.02, 3).astype(np.float32))))
    c_b = np.array([1.2, 0.1, 0.2], np.float32) + rng.normal(0, 0.1, 3).astype(np.float32)
    t_b = -r_b @ c_b
    uv_a = n(TCAM.project(t(pts), CAM_2V)) + rng.normal(0, noise, (count, 2)).astype(np.float32)
    uv_b = n(TCAM.project(t(pts @ r_b.T + t_b), CAM_2V)) + rng.normal(0, noise, (count, 2)).astype(np.float32)
    if outliers:
        bad = rng.choice(count, outliers, replace=False)
        uv_b[bad] += rng.uniform(20, 60, (outliers, 2)).astype(np.float32) * np.sign(rng.normal(size=(outliers, 2)))
    return pts, r_b, t_b, uv_a.astype(np.float32), uv_b.astype(np.float32)


# --------------------------------------------------------------------------
# lie, linalg3, camera, evaluate
# --------------------------------------------------------------------------


def test_lie_equals_jax():
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(32, 3)) * 0.8).astype(np.float32)
    w[0] = 0.0
    w[1] = 1e-9
    w[2] = [np.pi, 0.0, 0.0]
    tr = rng.normal(size=(32, 3)).astype(np.float32)
    r = np.asarray(JL.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(n(TL.so3_exp(t(w))), r, atol=1e-6)
    np.testing.assert_allclose(n(TL.hat(t(w))), np.asarray(JL.hat(jnp.asarray(w))), atol=0)
    np.testing.assert_allclose(n(TL.so3_log(t(r))), np.asarray(JL.so3_log(jnp.asarray(r))), atol=1e-6)
    d = (rng.normal(size=(32, 6)) * 0.1).astype(np.float32)
    for got, want in (
        (TL.se3_update(t(r), t(tr), t(d)), JL.se3_update(jnp.asarray(r), jnp.asarray(tr), jnp.asarray(d))),
        (TL.se3_inverse(t(r), t(tr)), JL.se3_inverse(jnp.asarray(r), jnp.asarray(tr))),
        (TL.se3_compose(t(r), t(tr), t(r[::-1].copy()), t(tr[::-1].copy())),
         JL.se3_compose(jnp.asarray(r), jnp.asarray(tr), jnp.asarray(r[::-1]), jnp.asarray(tr[::-1]))),
    ):
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(n(g), np.asarray(w_), atol=1e-6)
    np.testing.assert_allclose(n(TL.se3_log(t(r), t(tr))), np.asarray(JL.se3_log(jnp.asarray(r), jnp.asarray(tr))),
                               atol=1e-6)
    np.testing.assert_allclose(n(TL.se3_apply(t(r), t(tr), t(tr))),
                               np.asarray(JL.se3_apply(jnp.asarray(r), jnp.asarray(tr), jnp.asarray(tr))), atol=1e-6)


def test_jacfwd_equals_jax():
    """The perturbation Jacobian of an SE(3) residual, batched."""
    rng = np.random.default_rng(2)
    r = np.asarray(JL.so3_exp(jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32))))
    tr = rng.normal(size=(5, 3)).astype(np.float32)
    x = rng.normal(size=(5, 3)).astype(np.float32)

    def fj(d, r, tr, x):
        rr, tt = JL.se3_update(r, tr, d)
        return JL.se3_apply(rr, tt, x)

    want = np.asarray(jax.vmap(lambda *a: jax.jacfwd(fj)(jnp.zeros(6), *a))(jnp.asarray(r), jnp.asarray(tr),
                                                                             jnp.asarray(x)))
    got = TL.jacfwd(lambda d: TL.se3_apply(*TL.se3_update(t(r), t(tr), d), t(x)), torch.zeros(5, 6))
    np.testing.assert_allclose(n(got), want, atol=1e-6)


def test_linalg3_equals_jax():
    rng = np.random.default_rng(3)
    m = (rng.normal(size=(64, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(n(TL3.det3(t(m))), np.asarray(JL3.det3(jnp.asarray(m))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(TL3.adjugate3(t(m))), np.asarray(JL3.adjugate3(jnp.asarray(m))), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(n(TL3.inv3(t(m))), np.asarray(JL3.inv3(jnp.asarray(m))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(TL3.solve3(t(m), t(b))), np.asarray(JL3.solve3(jnp.asarray(m), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-6)
    sing = np.zeros((2, 3, 3), np.float32)  # the determinant guard
    np.testing.assert_array_equal(n(TL3.inv3(t(sing))), np.asarray(JL3.inv3(jnp.asarray(sing))))


def test_camera_equals_jax():
    rng = np.random.default_rng(4)
    p = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-0.5, 8, 50)  # behind and at the camera too
    cam = TCAM.Pinhole(*CAM_BA)
    np.testing.assert_allclose(n(TCAM.project(t(p), cam)), np.asarray(JCAM.project(jnp.asarray(p), CAM_BA)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(TCAM.projection_jacobian(t(p), cam)),
                               np.asarray(JCAM.projection_jacobian(jnp.asarray(p), CAM_BA)), rtol=1e-6, atol=1e-6)
    r2 = rng.uniform(0, 9, 50).astype(np.float32)
    r2[0] = 0.0
    np.testing.assert_allclose(n(TCAM.huber_weight(t(r2), 2.0)), np.asarray(JCAM.huber_weight(jnp.asarray(r2), 2.0)),
                               atol=1e-6)


@pytest.mark.parametrize("with_scale", [False, True])
def test_evaluate_equals_jax(with_scale):
    rng = np.random.default_rng(5)
    gt = np.cumsum(rng.normal(size=(40, 3)), 0).astype(np.float32)
    rot = np.asarray(JL.so3_exp(jnp.asarray(np.float32([0.1, -0.4, 0.2]))))
    est = (1.7 * gt @ rot.T + np.float32([1, -2, 0.5]) + rng.normal(0, 0.05, gt.shape)).astype(np.float32)
    a_t = TEV.umeyama_alignment(t(est), t(gt), with_scale=with_scale)
    a_j = JEV.umeyama_alignment(jnp.asarray(est), jnp.asarray(gt), with_scale=with_scale)
    for g, w in zip(a_t, a_j):
        np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-5)
    np.testing.assert_allclose(float(TEV.ate_rmse(est, gt, with_scale=with_scale)),
                               float(JEV.ate_rmse(jnp.asarray(est), jnp.asarray(gt), with_scale=with_scale)), atol=1e-5)
    rots = np.asarray(JL.so3_exp(jnp.asarray(rng.normal(0, 0.3, (40, 3)).astype(np.float32))))
    rots2 = np.asarray(JL.so3_exp(jnp.asarray(rng.normal(0, 0.01, (40, 3)).astype(np.float32)))) @ rots
    for delta in (1, 3):
        got = TEV.rpe_rmse(rots2, est, rots, gt, delta)
        want = JEV.rpe_rmse(jnp.asarray(rots2), jnp.asarray(est), jnp.asarray(rots), jnp.asarray(gt), delta)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------


def test_triangulate_equals_jax():
    pts, r_b, t_b, uv_a, uv_b = two_view_scene(0, 96)
    uv_a[0] = uv_b[0] = 0.0  # degenerate and behind-camera rays too
    uv_b[1] = uv_a[1]
    want_p, want_ok = JG.triangulate(jnp.eye(3), jnp.zeros(3), jnp.asarray(r_b), jnp.asarray(t_b),
                                      jnp.asarray(uv_a), jnp.asarray(uv_b), CAM_2V)
    got_p, got_ok = TG.triangulate(torch.eye(3), torch.zeros(3), t(r_b), t(t_b), t(uv_a), t(uv_b), CAM_2V)
    np.testing.assert_array_equal(n(got_ok), np.asarray(want_ok))
    ok = np.asarray(want_ok)
    np.testing.assert_allclose(n(got_p)[ok], np.asarray(want_p)[ok], atol=1e-4, rtol=1e-5)
    assert ok.sum() > 90


E_ATOL_JAX = 2e-3  # E against JAX's, up to sign (measured at most 1.7e-3 on these inputs)
E_ATOL_F64 = 1e-3  # E against the float64 solution, up to sign (measured at most 4.9e-4; JAX's 1.4e-3)


@pytest.mark.parametrize("noise", [0.0, 0.3])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_essential_and_decomposition_equal_jax(seed, noise):
    """E up to sign.  The normal matrix of the unnormalized 8-point system
    has its two smallest eigenvalues close (relative gap 3e-4 to 1e-3 here),
    so float32 rounding in another order moves the eigenvector by up to
    about 2e-3 in both packages: E is held against JAX's at E_ATOL_JAX and
    against the float64 solution at E_ATOL_F64.  The decomposition is
    compared on JAX's own E and on -E."""
    pts, r_b, t_b, uv_a, uv_b = two_view_scene(seed, 64, noise=noise)
    w = np.random.default_rng(seed).uniform(0.2, 1.0, 64).astype(np.float32)
    e_j = np.asarray(JG.essential_from_matches(jnp.asarray(uv_a), jnp.asarray(uv_b), jnp.asarray(w), CAM_2V))
    e_t = n(TG.essential_from_matches(t(uv_a), t(uv_b), t(w), CAM_2V))
    xa = n(TG.backproject(t(uv_a), CAM_2V)).astype(np.float64)
    xb = n(TG.backproject(t(uv_b), CAM_2V)).astype(np.float64)
    a = (xb[:, :, None] * xa[:, None, :]).reshape(-1, 9)
    u, s, vt = np.linalg.svd(np.linalg.eigh((a * w[:, None]).T @ a)[1][:, 0].reshape(3, 3))
    e64 = u @ np.diag([(s[0] + s[1]) / 2, (s[0] + s[1]) / 2, 0.0]) @ vt
    up_to_sign = lambda x, y: min(np.abs(x - y).max(), np.abs(x + y).max())
    print(f"E, seed {seed}, noise {noise}: port - JAX {up_to_sign(e_t, e_j):.3g}; from float64: "
          f"port {up_to_sign(e_t, e64):.3g}, JAX {up_to_sign(e_j, e64):.3g}")
    assert up_to_sign(e_t, e_j) <= E_ATOL_JAX
    assert up_to_sign(e_t, e64) <= E_ATOL_F64
    for e in (e_j, -e_j):  # the decomposition is the same for E and -E
        r_j, t_j = JG.decompose_essential(jnp.asarray(e), jnp.asarray(uv_a), jnp.asarray(uv_b), jnp.asarray(w), CAM_2V)
        r_t, t_t = TG.decompose_essential(t(e), t(uv_a), t(uv_b), t(w), CAM_2V)
        np.testing.assert_allclose(n(r_t), np.asarray(r_j), atol=POSE_ATOL)
        np.testing.assert_allclose(n(t_t), np.asarray(t_j), atol=POSE_ATOL)


@pytest.mark.parametrize("seed,outliers", [(1, 0), (2, 12), (3, 20)])
def test_two_view_init_equals_jax_given_its_draws(seed, outliers):
    pts, r_b, t_b, uv_a, uv_b = two_view_scene(seed, 96, outliers)
    valid = np.ones(96, bool)
    valid[-6:] = False
    want = JG.two_view_init(jnp.asarray(uv_a), jnp.asarray(uv_b), jnp.asarray(valid), CAM_2V)
    got = TG.two_view_init(t(uv_a), t(uv_b), t(valid), CAM_2V, gumbel=t(ransac_draws(0, 64, 96)))
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), atol=POSE_ATOL)
    np.testing.assert_allclose(n(got[1]), np.asarray(want[1]), atol=POSE_ATOL)
    np.testing.assert_array_equal(n(got[3]), np.asarray(want[3]))
    assert np.abs(n(got[0]) - r_b).max() < 2e-2 and n(got[3]).sum() >= 60


def test_two_view_init_batched_equals_one_by_one():
    """A batch of problems (the chunk solver's layout) gives each problem's
    own answer."""
    scenes = [two_view_scene(s, 64, 6) for s in (4, 5)]
    uv_a = np.stack([s[3] for s in scenes])
    uv_b = np.stack([s[4] for s in scenes])
    valid = np.ones((2, 64), bool)
    g = t(ransac_draws(0, 64, 64))
    batch = TG.two_view_init(t(uv_a), t(uv_b), t(valid), CAM_2V, gumbel=g)
    for i in range(2):
        one = TG.two_view_init(t(uv_a[i]), t(uv_b[i]), t(valid[i]), CAM_2V, gumbel=g)
        for b, o in zip(batch, one):
            np.testing.assert_allclose(n(b[i]).astype(np.float64), n(o).astype(np.float64), atol=1e-5)


def test_epipolar_gate_equals_jax_given_its_draws():
    scenes = [two_view_scene(s, 96, 20) for s in (6, 7, 8)]
    uv_a = np.stack([s[3] for s in scenes])
    uv_b = np.stack([s[4] for s in scenes])
    valid = np.ones((3, 96), bool)
    valid[1, 40:] = False
    want = np.asarray(jax.vmap(lambda a, b, v: JG.epipolar_inlier_gate(a, b, v, CAM_2V))(
        jnp.asarray(uv_a), jnp.asarray(uv_b), jnp.asarray(valid)))
    got = n(TG.epipolar_inlier_gate(t(uv_a), t(uv_b), t(valid), CAM_2V, gumbel=t(ransac_draws(0, 48, 96))))
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 150


def test_ransac_draws_come_from_a_cpu_generator():
    a = TG.ransac_gumbel(0, 48, 256, "cpu")
    gen = torch.Generator().manual_seed(0)
    u = torch.rand((48, 256), generator=gen)
    assert torch.equal(a, -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny))))
    assert not torch.equal(a, TG.ransac_gumbel(1, 48, 256, "cpu"))


def test_pnp_equals_jax():
    pts, r_b, t_b, uv_a, uv_b = two_view_scene(9, 80, 8)
    d = np.asarray(JL.so3_exp(jnp.asarray([0.02, -0.03, 0.01])), np.float32)
    r0 = d @ r_b
    t0 = t_b + np.array([0.05, -0.04, 0.08], np.float32)
    valid = np.ones(80, bool)
    valid[:5] = False
    r_j, t_j = JG.pnp_solve(jnp.asarray(r0), jnp.asarray(t0), jnp.asarray(pts), jnp.asarray(uv_b), jnp.asarray(valid),
                            CAM_2V, iters=15, gate_px=3.0)
    r_t, t_t = TG.pnp_solve(t(r0), t(t0), t(pts), t(uv_b), t(valid), CAM_2V, iters=15, gate_px=3.0)
    np.testing.assert_allclose(n(r_t), np.asarray(r_j), atol=POSE_ATOL)
    np.testing.assert_allclose(n(t_t), np.asarray(t_j), atol=POSE_ATOL)
    w = valid.astype(np.float32)
    r_j, t_j = JG.pnp_refine(jnp.asarray(r0), jnp.asarray(t0), jnp.asarray(pts), jnp.asarray(uv_b), jnp.asarray(w),
                             CAM_2V)
    r_t, t_t = TG.pnp_refine(t(r0), t(t0), t(pts), t(uv_b), t(w), CAM_2V)
    np.testing.assert_allclose(n(r_t), np.asarray(r_j), atol=POSE_ATOL)
    np.testing.assert_allclose(n(t_t), np.asarray(t_j), atol=POSE_ATOL)


# --------------------------------------------------------------------------
# pose graph
# --------------------------------------------------------------------------


def loop_graph():
    """tests/test_slam.py TestPoseGraph.test_loop_closure_converges."""
    rng = np.random.default_rng(6)
    count = 8
    rots, trans = [], []
    for i in range(count):
        a = 2 * np.pi * i / count
        rots.append(np.asarray(JL.so3_exp(jnp.asarray([0.0, 0.0, a]))))
        trans.append(np.array([np.cos(a), np.sin(a), 0.0], np.float32))
    rots = np.stack(rots).astype(np.float32)
    trans = np.stack(trans).astype(np.float32)
    ei, ej, er, et = [], [], [], []
    for i in range(count):
        j = (i + 1) % count
        inv_r, inv_t = JL.se3_inverse(jnp.asarray(rots[i]), jnp.asarray(trans[i]))
        rr, rt = JL.se3_compose(inv_r, inv_t, jnp.asarray(rots[j]), jnp.asarray(trans[j]))
        ei.append(i)
        ej.append(j)
        er.append(np.asarray(rr))
        et.append(np.asarray(rt))
    dw = rng.normal(size=(count, 3)).astype(np.float32) * 0.05
    dt = rng.normal(size=(count, 3)).astype(np.float32) * 0.05
    dw[0] = dt[0] = 0
    return JPG.PoseGraph(
        rot=jnp.asarray(np.asarray(JL.so3_exp(jnp.asarray(dw))) @ rots),
        trans=jnp.asarray(trans + dt),
        edge_i=jnp.asarray(np.array(ei + [-1], np.int32)),  # one padding edge
        edge_j=jnp.asarray(np.array(ej + [3], np.int32)),
        edge_rot=jnp.asarray(np.stack(er + [np.eye(3, dtype=np.float32)])),
        edge_trans=jnp.asarray(np.stack(et + [np.zeros(3, np.float32)])),
    ), trans


def test_pose_graph_equals_jax():
    graph, truth = loop_graph()
    for opts_kw in ({"max_iterations": 10, "damping": 1e-6}, {"max_iterations": 3, "damping": 1e-3}):
        want = JPG.pose_graph_solve(graph, JBAOptions(num_fixed_cameras=1, **opts_kw))
        got = TPG.pose_graph_solve(from_jax(graph, "cpu"), BAOptions(num_fixed_cameras=1, **opts_kw))
        np.testing.assert_allclose(n(got.rot), np.asarray(want.rot), atol=1e-4)
        np.testing.assert_allclose(n(got.trans), np.asarray(want.trans), atol=1e-4)
    np.testing.assert_allclose(n(got.trans), np.asarray(want.trans), atol=1e-4)


# --------------------------------------------------------------------------
# bundle adjustment
# --------------------------------------------------------------------------


def _outlier_problem(seed):
    """tests/test_slam.py TestBA.test_robust_to_outliers."""
    rng = np.random.default_rng(seed)
    gt = synthetic_ba(rng)
    obs_uv = np.asarray(gt.obs_uv).copy()
    obs_uv[::13, 0] += 80.0
    return perturb(gt._replace(obs_uv=jnp.asarray(obs_uv)), rng)


def _assert_ba_close(got, want, rtol):
    for field in ("rot", "trans", "points"):
        w = np.asarray(getattr(want, field))
        print(f"BA {field}: max difference {np.abs(n(getattr(got, field)) - w).max() / max(1.0, np.abs(w).max()):.3g} "
              "of the magnitude")
        np.testing.assert_allclose(n(getattr(got, field)), w, rtol=0, atol=rtol * max(1.0, np.abs(w).max()),
                                   err_msg=field)


@pytest.mark.parametrize("case", ["clean", "outliers_0", "outliers_1", "outliers_2", "outliers_3", "outliers_4"])
def test_ba_solve_f64_equals_jax(case):
    num_fixed = None
    if case == "clean":
        rng = np.random.default_rng(4)
        problem = perturb(synthetic_ba(rng), rng)
        kw = dict(max_iterations=15, damping=1e-6, huber_delta=1e9)
        # Noise-free data leave monocular scale free under one fixed camera
        # (any scale has cost 0), so the states are compared with cameras 0
        # and 1 (both unperturbed) fixed; the gauge-free solve by its cost.
        for opts in (JBAOptions(**kw),):
            c_j = float(JBA.reprojection_cost(JBA.ba_solve(problem, CAM_BA, opts), CAM_BA, opts))
            c_t = float(TBA.reprojection_cost(TBA.ba_solve(from_jax(problem, "cpu"), CAM_BA, BAOptions(**kw)), CAM_BA,
                                              BAOptions(**kw)))
            assert c_j < 1e-3 and c_t < 1e-3, (c_j, c_t)
        num_fixed = 2
    else:
        problem = _outlier_problem(int(case[-1]))
        kw = dict(max_iterations=15, damping=1e-4, huber_delta=2.0, gate_px=2.5, gate_rounds=2)
    want = JBA.ba_solve(problem, CAM_BA, JBAOptions(**kw), num_fixed)
    got = TBA.ba_solve(from_jax(problem, "cpu"), CAM_BA, BAOptions(**kw), num_fixed)
    _assert_ba_close(got, want, BA_RTOL)
    if case != "clean":
        # The observations the consensus gate keeps, from each solution.
        with JBA._x64_scope():
            _, gate_j = JBA._relandmark(want.rot, want.trans, want.points, want.obs_cam, want.obs_uv, CAM_BA, 2.5)
        d = lambda x: x.to(torch.float64)
        _, gate_t = TBA._relandmark(d(got.rot), d(got.trans), d(got.points), got.obs_cam, d(got.obs_uv), CAM_BA, 2.5)
        np.testing.assert_array_equal(n(gate_t), np.asarray(gate_j))
        assert np.asarray(gate_j)[::13].sum() < np.asarray(gate_j).sum()
    cost = float(TBA.reprojection_cost(got, CAM_BA, BAOptions(huber_delta=1e9)))
    np.testing.assert_allclose(cost, float(JBA.reprojection_cost(want, CAM_BA, JBAOptions(huber_delta=1e9))),
                               rtol=1e-3, atol=1e-6)


def dense_frames_problem():
    """tests/test_slam.py TestDenseFramesBA.test_dense_frames_matches_generic."""
    rng = np.random.default_rng(11)
    n_cams, count = 10, 64
    pts = rng.uniform(-2, 2, (count, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    rots, trans = [], []
    for i in range(n_cams):
        a = 0.05 * (i - n_cams / 2)
        r = np.asarray(JL.so3_exp(jnp.asarray([0.0, a, 0.0])))
        c = np.array([2 * np.sin(a), 0.0, -0.5 * np.cos(a)], np.float32)
        rots.append(r)
        trans.append(-r @ c)
    rots = np.stack(rots).astype(np.float32)
    trans = np.stack(trans).astype(np.float32)
    obs_cam = np.full((count, n_cams), -1, np.int32)
    obs_uv = np.zeros((count, n_cams, 2), np.float32)
    for l in range(count):
        for d in range(n_cams):
            if rng.uniform() < 0.6:
                obs_cam[l, d] = d
                obs_uv[l, d] = np.asarray(JCAM.project(jnp.asarray(rots[d] @ pts[l] + trans[d]), CAM_BA)) \
                    + rng.normal(size=2) * 0.3
    return JBA.BAProblem(rot=jnp.asarray(rots), trans=jnp.asarray(trans),
                         points=jnp.asarray(pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05),
                         obs_cam=jnp.asarray(obs_cam), obs_uv=jnp.asarray(obs_uv))


def test_ba_dense_frames_f32_equals_jax():
    """The chunk solver's call: dense frame slots, float32 solves with one
    refinement step on both sides (JAX traced without x64)."""
    prob = dense_frames_problem()
    kw = dict(max_iterations=10, huber_delta=2.0, gate_px=3.0, gate_rounds=1)
    want = JBA._ba_solve_jit(prob, CAM_BA, JBAOptions(**kw), None, True)
    tp = from_jax(prob, "cpu")
    got = TBA._ba_solve_impl(tp, CAM_BA, BAOptions(**kw), dense_frames=True)
    diff = {f: float(np.abs(n(getattr(got, f)) - np.asarray(getattr(want, f))).max()) for f in ("rot", "trans", "points")}
    print("dense frames, float32: max difference", diff)
    for field in ("rot", "trans", "points"):
        np.testing.assert_allclose(n(getattr(got, field)), np.asarray(getattr(want, field)), atol=BA_F32_ATOL,
                                   err_msg=field)
    # Dense frame slots and the generic gather/scatter layout agree, and a
    # batch of two problems gives each its own answer.
    generic = TBA._ba_solve_impl(tp, CAM_BA, BAOptions(**kw))
    np.testing.assert_allclose(n(generic.rot), n(got.rot), atol=1e-4)
    np.testing.assert_allclose(n(generic.points), n(got.points), atol=5e-3)
    two = TBA.BAProblem(*[torch.stack([x, x]) for x in tp])
    both = TBA._ba_solve_impl(two, CAM_BA, BAOptions(**kw), dense_frames=True)
    diff = {f: float(np.abs(n(getattr(both, f)[1]) - n(getattr(got, f))).max()) for f in ("rot", "trans", "points")}
    print("dense frames, float32, batched against alone: max difference", diff)
    assert max(diff.values()) <= BA_BATCH_ATOL


def test_ba_problem_conversion():
    prob = dense_frames_problem()
    tp = from_jax(prob, "cpu")
    assert isinstance(tp, TBA.BAProblem) and tp.obs_cam.dtype == torch.int32
    for a, b in zip(tp, prob):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    assert isinstance(from_jax(CAM_BA), TCAM.Pinhole)
