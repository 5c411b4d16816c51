"""PyTorch port of the multi-device package (feature_detector_tpu/parallel,
slam/ba.py make_distributed_ba) against the port's single-device path and
the JAX package, on the CPU.

Four gloo ranks, each its own process (tests/torch_dist_worker.py, which
imports nothing of JAX), run every case once; the tests read their results.
JAX runs here, in the test process, on 4 of its 8 virtual CPU devices.
Inputs are seeded synthetic frames and BA problems.  Tolerances, each
measured on these inputs (listed in CHANGES.md too):

- every rank returns the same arrays, bit for bit;
- frame-parallel detection, BRIEF and matching: equal to the port's
  single-device batch and to JAX's make_batched_frontend /
  make_two_frame_matcher, exactly;
- row-sharded responses and row_sharded_map: equal to the port's
  single-device maps exactly; against JAX's make_row_sharded_response the
  pinned rounding of tests/test_torch_detect.py (rtol 1e-5 plus 1e-5 of the
  map's largest magnitude);
- distributed BA, dense: cameras and points within BA_DIST_RTOL of their
  magnitude of the port's ba_solve (the landmark sums split over 4 ranks
  round in another order; measured 1.8e-15), and within BA_JAX_RTOL of
  JAX's make_distributed_ba where the gauge is fixed (JAX keeps float32
  state; measured 5.4e-6);
- distributed BA, camera-sharded CG: the cost bounds of tests/test_slam.py
  against the port's dense ba_solve and JAX's camera-sharded solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from feature_detector_tpu.core.config import BAOptions as JBAOptions
from feature_detector_tpu.core.config import DetectorOptions as JDetectorOptions
from feature_detector_tpu.kernels import detect as KJ
from feature_detector_tpu.parallel import frontend as JF
from feature_detector_tpu.parallel.halo import row_sharded_map as jax_row_sharded_map
from feature_detector_tpu.parallel.mesh import make_mesh as jax_make_mesh
from feature_detector_tpu.slam import ba as JBA
from feature_detector_tpu_torch.core.config import BAOptions, DetectorOptions, HarrisOptions, ShiTomasiOptions
from feature_detector_tpu_torch.core.convert import from_jax
from feature_detector_tpu_torch.core.types import words_to_numpy
from feature_detector_tpu_torch.frontend.detector import detect_good_features_batch
from feature_detector_tpu_torch.kernels import detect as KT
from feature_detector_tpu_torch.kernels.brief import brief_compute
from feature_detector_tpu_torch.match.hamming import match_hamming
from feature_detector_tpu_torch.parallel import distributed
from feature_detector_tpu_torch.parallel.mesh import make_mesh
from feature_detector_tpu_torch.slam import ba as TBA
from tests import torch_dist_worker as W
from tests.test_slam import CAM, perturb, synthetic_ba
from tests.test_torch_slam import _outlier_problem
from tests.torch_port_inputs import synth_frame, synth_stack

WORLD = 4
BA_DIST_RTOL = 1e-9
BA_JAX_RTOL = 1e-4  # tests/test_torch_slam.py BA_RTOL
GATED_LANDMARKS = 62  # no multiple of the world: two padding landmarks
CG_CAMS = (16, 13)  # 13: 78 rows over 4 ranks pad to 80 (tests/test_slam.py:160)
BA_FIELDS = W.BA_FIELDS


def _problems():
    rng = np.random.default_rng(5)  # tests/test_slam.py test_distributed_matches_single_device
    gt = synthetic_ba(rng, n_pts=64)
    out = {"dense": perturb(gt, rng)}
    gated = _outlier_problem(0)
    out["gated"] = gated._replace(**{f: getattr(gated, f)[:GATED_LANDMARKS] for f in BA_FIELDS[2:]})
    for c in CG_CAMS:
        rng = np.random.default_rng(6)
        out[f"cg{c}"] = perturb(synthetic_ba(rng, n_cams=c, n_pts=256, deg=4), rng)
    return out


@pytest.fixture(scope="module")
def inputs():
    image = synth_frame(40, 240, 320)
    mask = np.ones(image.shape, np.int32)
    mask[100:140, 200:300] = 0
    data = {"frames": synth_stack(range(30, 38)), "image": image, "mask": mask, "cg_cams": np.asarray(CG_CAMS)}
    for key, p in _problems().items():
        data.update({f"{key}_{f}": np.asarray(getattr(p, f)) for f in BA_FIELDS})
    return data


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return W.Ranks("parallel", WORLD, inputs, tmp_path_factory.mktemp("ranks")).results()


@pytest.fixture(scope="module")
def rank0(ranks):
    return ranks[0]


def _jax_mesh(axis):
    return jax_make_mesh((WORLD,), (axis,))


def _problem(inputs, key):
    return JBA.BAProblem(*(jnp.asarray(inputs[f"{key}_{f}"]) for f in BA_FIELDS))


def _valid_uv(jax_features):
    """JAX's positions with empty slots zeroed.  JAX's vmapped incremental
    detector leaves a copy of the last pick in the slots after its picks;
    the port's batched detector, which the frame-parallel path runs, leaves
    zeros there (both mark them invalid)."""
    return np.asarray(jax_features.uv) * np.asarray(jax_features.valid)[..., None]


def _assert_close(got, want, rtol, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    print(f"{what}: max difference {err:.3g} of the magnitude (bound {rtol})")
    assert err <= rtol, what


# --------------------------------------------------------------------------
# Start-up and replication
# --------------------------------------------------------------------------


def test_initialize_single_process_noop(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize() is False
    assert not dist.is_initialized()
    info = distributed.process_info()
    assert info["process_count"] == 1 and info["process_index"] == 0 and info["global_devices"] == 1


def test_ranks_join_one_group(ranks):
    for r, res in enumerate(ranks):
        assert bool(res["joined"]) and int(res["process_index"]) == r
        assert int(res["process_count"]) == WORLD and int(res["global_devices"]) == WORLD
        assert int(res["mesh_size"]) == WORLD


def test_every_rank_returns_the_same(ranks):
    skip = {"process_index", "halo"}
    for res in ranks[1:]:
        for key, val in ranks[0].items():
            if key not in skip:
                np.testing.assert_array_equal(res[key], val, err_msg=key)


def test_world_of_one_without_a_launcher():
    """make_mesh in a process with no group starts a world of one; the
    distributed BA there equals ba_solve bit for bit."""
    mesh = make_mesh(device="cpu")
    try:
        assert mesh.size() == 1 and distributed.process_info()["process_count"] == 1
        with pytest.raises(ValueError):
            make_mesh((2,), device="cpu")
        problem = from_jax(_problems()["dense"], "cpu")
        opts = BAOptions(max_iterations=8, damping=1e-6, huber_delta=1e9)
        got = TBA.make_distributed_ba(mesh, CAM, opts)(problem)
        want = TBA.ba_solve(problem, CAM, opts)
        for f in ("rot", "trans", "points"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# Front-end
# --------------------------------------------------------------------------


def test_batched_frontend_equals_single_device_and_jax(inputs, rank0):
    frames = inputs["frames"]
    topts = DetectorOptions(**W.FRONTEND)
    feats = detect_good_features_batch(torch.from_numpy(frames), "harris", 30, topts)
    words, dvalid = brief_compute(torch.from_numpy(frames), feats.uv, feats.valid)
    np.testing.assert_array_equal(rank0["fe_uv"], feats.uv.numpy())
    np.testing.assert_array_equal(rank0["fe_response"], feats.response.numpy())
    np.testing.assert_array_equal(rank0["fe_valid"], feats.valid.numpy())
    np.testing.assert_array_equal(rank0["fe_words"], words.numpy())
    np.testing.assert_array_equal(rank0["fe_dvalid"], dvalid.numpy())
    assert rank0["fe_valid"].sum(1).min() >= 10

    jf, jw, jv = JF.make_batched_frontend(_jax_mesh("data"), "harris", 30, JDetectorOptions(**W.FRONTEND))(
        jnp.asarray(frames))
    np.testing.assert_array_equal(rank0["fe_valid"], np.asarray(jf.valid))
    np.testing.assert_array_equal(rank0["fe_uv"], _valid_uv(jf))
    np.testing.assert_allclose(rank0["fe_response"], np.asarray(jf.response), rtol=1e-5)
    np.testing.assert_array_equal(words_to_numpy(torch.from_numpy(rank0["fe_words"])), np.asarray(jw))
    np.testing.assert_array_equal(rank0["fe_dvalid"], np.asarray(jv))


def test_two_frame_matcher_equals_single_device_and_jax(inputs, rank0):
    a = inputs["frames"]
    b = np.roll(a, 2, axis=2)
    topts = DetectorOptions(**W.MATCHER)
    fa = detect_good_features_batch(torch.from_numpy(a), "fast", 40, topts)
    fb = detect_good_features_batch(torch.from_numpy(b), "fast", 40, topts)
    wa, va = brief_compute(torch.from_numpy(a), fa.uv, fa.valid)
    wb, vb = brief_compute(torch.from_numpy(b), fb.uv, fb.valid)
    m = match_hamming(wa, va, wb, vb)
    for key, want in (("tf_uv_a", fa.uv), ("tf_valid_a", fa.valid), ("tf_uv_b", fb.uv), ("tf_valid_b", fb.valid),
                      ("tf_index", m.index), ("tf_distance", m.distance), ("tf_valid", m.valid)):
        np.testing.assert_array_equal(rank0[key], want.numpy(), err_msg=key)
    counts = rank0["tf_valid"].sum(1)
    assert (counts >= 1).all() and counts.sum() >= 24, counts  # tests/test_parallel.py's bounds

    jfa, jfb, jm = JF.make_two_frame_matcher(_jax_mesh("data"), "fast", 40, JDetectorOptions(**W.MATCHER))(
        jnp.asarray(a), jnp.asarray(b))
    for key, want in (("tf_uv_a", _valid_uv(jfa)), ("tf_valid_a", jfa.valid), ("tf_uv_b", _valid_uv(jfb)),
                      ("tf_valid_b", jfb.valid),
                      ("tf_index", jm.index), ("tf_distance", jm.distance), ("tf_valid", jm.valid)):
        np.testing.assert_array_equal(rank0[key], np.asarray(want), err_msg=key)


def test_batch_must_divide_by_the_data_axis(ranks):
    """6 frames over 4 ranks: refused, as JAX's sharding refuses them."""
    assert all(bool(res["uneven_batch_refused"]) for res in ranks)


@pytest.mark.parametrize("kind", ["harris", "shi_tomasi"])
def test_row_sharded_response_equals_single_device_and_jax(inputs, rank0, kind):
    image, mask = inputs["image"], inputs["mask"]
    thr = 30.0
    gate = KT.harris_response if kind == "harris" else KT.shi_tomasi_response
    want = gate(torch.from_numpy(image), torch.from_numpy(mask), DetectorOptions(min_valid_response=thr)).numpy()
    np.testing.assert_array_equal(rank0[f"rows_{kind}"], want)
    assert (want > 0).sum() > 100

    jrun = JF.make_row_sharded_response(_jax_mesh("space"), kind, JDetectorOptions(min_valid_response=thr))
    jwant = np.asarray(jrun(jnp.asarray(image), jnp.asarray(mask)))
    raw = (KT.harris_response_raw if kind == "harris" else KT.shi_tomasi_response_raw)
    sub = HarrisOptions() if kind == "harris" else ShiTomasiOptions()
    got_raw = raw(torch.from_numpy(image).to(torch.float32), sub).numpy()
    atol = 1e-5 * np.abs(got_raw).max()
    flip = (rank0[f"rows_{kind}"] > 0) != (jwant > 0)
    assert np.all(np.abs(got_raw[flip] - thr) <= 1e-5 * thr + atol)
    np.testing.assert_allclose(rank0[f"rows_{kind}"][~flip], jwant[~flip], rtol=1e-5, atol=atol)


def test_row_sharded_map_equals_whole_image(inputs, rank0):
    image = inputs["image"].astype(np.float32)
    want = KT.box_sum(torch.from_numpy(image), 2).numpy()
    np.testing.assert_array_equal(rank0["rows_box_sum"], want)
    jwant = jax.jit(jax_row_sharded_map(lambda x: KJ.box_sum(x, 2), _jax_mesh("space"), halo=2))(jnp.asarray(image))
    np.testing.assert_array_equal(rank0["rows_box_sum"], np.asarray(jwant))


def test_exchange_halo_on_a_ramp(ranks):
    rows, halo = W.HALO_ROWS, W.HALO
    for r, res in enumerate(ranks):
        got = res["halo"][:, 0]
        own = r * rows + np.arange(rows) + 1.0
        above = (r * rows - halo + np.arange(halo) + 1.0) if r > 0 else np.zeros(halo)
        below = ((r + 1) * rows + np.arange(halo) + 1.0) if r < WORLD - 1 else np.zeros(halo)
        np.testing.assert_array_equal(got, np.concatenate([above, own, below]))
        assert res["halo"].shape == (rows + 2 * halo, W.HALO_COLS)


# --------------------------------------------------------------------------
# Distributed bundle adjustment
# --------------------------------------------------------------------------


@pytest.mark.parametrize("key,opts", [("dense", W.BA_DENSE), ("dense2", W.BA_DENSE_2), ("gated", W.BA_GATED)],
                         ids=["dense", "dense_two_fixed", "gated"])
def test_distributed_matches_single_device(inputs, rank0, key, opts):
    """tests/test_slam.py:139 (64 points, seed 5), and the outlier problem
    of test_robust_to_outliers with a landmark count that pads (MAD gates
    over all ranks, consensus re-landmarking per rank).  Against JAX's
    make_distributed_ba within BA_JAX_RTOL where the gauge is fixed: the
    noise-free problem under one fixed camera has a free scale, so there
    only its cost is bounded (below 1e-3, tests/test_slam.py:106)."""
    problem = _problem(inputs, "dense" if key == "dense2" else key)
    single = TBA.ba_solve(from_jax(problem, "cpu"), CAM, BAOptions(**opts))
    jdist = JBA.make_distributed_ba(_jax_mesh("data"), CAM, JBAOptions(**opts))(problem)
    for f in ("rot", "trans", "points"):
        _assert_close(rank0[f"{key}_{f}"], getattr(single, f).numpy(), BA_DIST_RTOL, f"{key} {f} against ba_solve")
        if key != "dense":
            _assert_close(rank0[f"{key}_{f}"], np.asarray(getattr(jdist, f)), BA_JAX_RTOL, f"{key} {f} against JAX")
    assert rank0[f"{key}_points"].shape == (problem.points.shape[0], 3)
    solved = single._replace(**{f: torch.from_numpy(rank0[f"{key}_{f}"]) for f in ("rot", "trans", "points")})
    if key == "gated":  # the landmarks whose observations were not corrupted
        keep = torch.arange(GATED_LANDMARKS) % 13 != 0
        solved = solved._replace(points=solved.points[keep], obs_cam=solved.obs_cam[keep], obs_uv=solved.obs_uv[keep])
    cost = float(TBA.reprojection_cost(solved, CAM, BAOptions(huber_delta=1e9)))
    print(f"{key}: cost {cost:.4g}")
    assert cost < (1e-3 if key != "gated" else 0.1), cost


@pytest.mark.parametrize("n_cams", CG_CAMS)
def test_camera_sharded_cg_converges(inputs, rank0, n_cams):
    """tests/test_slam.py:160-190 at 4 ranks and 96 CG iterations: the
    cost falls below 1e-2 and lands within 1e-2 of the dense solve's and of
    JAX's camera-sharded solve's.  (The noise-free problem leaves the scale
    free under one fixed camera, so states are compared by their cost.)"""
    key = f"cg{n_cams}"
    jproblem = _problem(inputs, key)
    problem = from_jax(jproblem, "cpu")
    opts = BAOptions(**W.BA_CG)
    solved = problem._replace(**{f: torch.from_numpy(rank0[f"{key}_{f}"]) for f in ("rot", "trans", "points")})
    c0 = float(TBA.reprojection_cost(problem, CAM, opts))
    c1 = float(TBA.reprojection_cost(solved, CAM, opts))
    cd = float(TBA.reprojection_cost(TBA.ba_solve(problem, CAM, opts), CAM, opts))
    jsolver = JBA.make_distributed_ba(_jax_mesh("data"), CAM, JBAOptions(**W.BA_CG), camera_shard=True,
                                      cg_iterations=W.CG_ITERATIONS)
    cj = float(JBA.reprojection_cost(jsolver(jproblem), CAM, JBAOptions(**W.BA_CG)))
    print(f"C = {n_cams}: cost {c0:.4g} -> {c1:.4g} (dense {cd:.4g}, JAX camera-sharded {cj:.4g})")
    assert c0 > 1.0 and c1 < 1e-2
    assert abs(c1 - cd) < 1e-2 and abs(c1 - cj) < 1e-2
