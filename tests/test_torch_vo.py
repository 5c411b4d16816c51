"""PyTorch port of the sequence layer and the fused chunked VO
(feature_detector_tpu/slam/sequence.py, vo_fused.py) against the JAX
package, on the CPU.

Tolerances, each measured on these inputs (listed in CHANGES.md too):

- renderer images, TUM/EuRoC text, quaternions, tracks, sanitised poses:
  exactly equal;
- scan front-end: validity, descriptor words, descriptor validity and
  carry links exactly equal; positions within FE_UV_ATOL px and responses
  within FE_RESP_RTOL (XLA fuses the Harris arithmetic and rounds in
  another order); a feature whose Harris response lies within rounding of
  min_valid_response is excused and counted (none on these frames);
- chunk solver given the same tracks and JAX's Gumbel draws: rotations
  within CHUNK_ROT_ATOL, camera centers and points within CHUNK_CENTER_ATOL
  and CHUNK_POINT_ATOL of the chunk's own scale (a chunk's monocular scale
  is its init pair's baseline, and the two candidate init pairs may tie,
  so either package may keep the other one);
- the whole VO on 13 frames: both packages' ATE under 3% of the span.
"""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_detector_tpu.core.config import BAOptions as JBAOptions
from feature_detector_tpu.core.config import BriefOptions as JBriefOptions
from feature_detector_tpu.core.config import DetectorOptions as JDetectorOptions
from feature_detector_tpu.slam import sequence as JS
from feature_detector_tpu.slam import vo_fused as JV
from feature_detector_tpu.slam.evaluate import ate_rmse as jax_ate
from feature_detector_tpu_torch.core.config import BAOptions, BriefOptions, DetectorOptions, MatcherOptions
from feature_detector_tpu_torch.slam import sequence as TS
from feature_detector_tpu_torch.slam import vo_fused as TV
from feature_detector_tpu_torch.slam.evaluate import ate_rmse
from tests.test_torch_slam import ransac_draws

FE_UV_ATOL = 1e-4  # px (measured 3.1e-5)
FE_RESP_RTOL = 1e-5
CHUNK_ROT_ATOL = 1e-4  # measured 1.4e-5
CHUNK_CENTER_ATOL = 1e-4  # of the chunk's scale (measured 1.6e-5)
CHUNK_POINT_ATOL = 1e-2  # of the chunk's scale (measured 5.1e-3)
ATE_SPAN_SHARE = 0.03  # tests/test_sequence.py's bound
VO_DET = dict(min_feature_distance=10, min_valid_response=20.0, max_features=256, subpixel=True)


def sequence(n_frames, seed=3, n_landmarks=300, motion="lateral"):
    return TS.make_synthetic_sequence(n_frames=n_frames, n_landmarks=n_landmarks, seed=seed, motion=motion,
                                      angle_step=0.03)


def span_share(positions, seq):
    ate = float(ate_rmse(positions, seq.trajectory.positions, with_scale=True))
    span = float(np.linalg.norm(seq.trajectory.positions.max(0) - seq.trajectory.positions.min(0)))
    return ate, ate / span


@pytest.fixture(scope="module")
def seq13():
    return sequence(13)


@pytest.fixture(scope="module")
def port_vo13(seq13):
    return TS.run_visual_odometry_chunked(seq13.images, seq13.cam, device="cpu")


@pytest.fixture(scope="module")
def jax_vo13(seq13):
    return JS.run_visual_odometry_chunked(seq13.images, JS.Pinhole(*seq13.cam))


# --------------------------------------------------------------------------
# Host code: renderer, files, quaternions, tracks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("motion", ["lateral", "arc"])
def test_renderer_equals_jax(motion):
    want = JS.make_synthetic_sequence(n_frames=5, n_landmarks=120, seed=7, motion=motion, angle_step=0.05)
    got = TS.make_synthetic_sequence(n_frames=5, n_landmarks=120, seed=7, motion=motion, angle_step=0.05)
    np.testing.assert_array_equal(got.images, want.images)
    for field in ("rotations_wc", "translations_wc", "landmarks"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    np.testing.assert_array_equal(got.trajectory.positions, want.trajectory.positions)
    assert tuple(got.cam) == tuple(want.cam)
    assert got.images.std() > 10


def test_quaternions_equal_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(20, 4))
    np.testing.assert_array_equal(TS.quat_to_rot(q), JS.quat_to_rot(q))
    rots = JS.quat_to_rot(q)
    half_turns = np.stack([np.diag(d).astype(np.float32) for d in ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])])
    for r in (rots, half_turns):
        np.testing.assert_array_equal(TS.rot_to_quat(r), JS.rot_to_quat(r))


@pytest.mark.parametrize("fmt", ["tum", "euroc"])
def test_trajectory_files_same_text(tmp_path, fmt):
    traj = sequence(6).trajectory
    save = {"tum": (TS.save_tum_trajectory, JS.save_tum_trajectory),
            "euroc": (TS.save_euroc_groundtruth, JS.save_euroc_groundtruth)}[fmt]
    load = {"tum": (TS.load_tum_trajectory, JS.load_tum_trajectory),
            "euroc": (TS.load_euroc_groundtruth, JS.load_euroc_groundtruth)}[fmt]
    paths = [os.path.join(tmp_path, f"{who}.txt") for who in ("port", "jax")]
    save[0](paths[0], traj)
    save[1](paths[1], JS.Trajectory(traj.timestamps, traj.rotations, traj.positions))
    texts = [io.open(p).read() for p in paths]
    assert texts[0] == texts[1] and texts[0].count("\n") == 7
    back_t, back_j = load[0](paths[0]), load[1](paths[0])
    for field in ("timestamps", "rotations", "positions"):
        np.testing.assert_array_equal(getattr(back_t, field), getattr(back_j, field))


def test_associate_equals_jax():
    rng = np.random.default_rng(1)
    a = np.sort(rng.uniform(0, 10, 50))
    b = np.sort(rng.uniform(0, 10, 70))
    for got, want in zip(TS.associate(a, b, 0.05), JS.associate(a, b, 0.05)):
        np.testing.assert_array_equal(got, want)


def test_tracks_and_sanitised_poses_equal_jax():
    rng = np.random.default_rng(2)
    n_frames, n_feats = 9, 40
    pairs = []
    for off in (1, 1, 2, 3):  # a repeated offset: edges that contradict earlier ones
        for f in range(n_frames - off):
            idx = rng.integers(-1, n_feats, n_feats)
            pairs.append((f, f + off, idx))
    got = TS.build_tracks_conflict_free(pairs, n_frames, n_feats)
    assert got == JS.build_tracks_conflict_free(pairs, n_frames, n_feats) and len(got) > 50
    rot = np.repeat(np.eye(3, dtype=np.float32)[None], 6, 0) * rng.uniform(0.5, 1, (6, 1, 1)).astype(np.float32)
    tr = rng.normal(size=(6, 3)).astype(np.float32)
    rot[0, 1, 1] = np.nan
    tr[3, 0] = np.inf
    tr[4, 2] = np.nan
    for got, want in zip(TS.sanitize_chunk_poses(rot, tr, 5), JS.sanitize_chunk_poses(rot, tr, 5)):
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# Scan front-end and chunk solver
# --------------------------------------------------------------------------


def _near_threshold(images, uv, thr, rel=1e-4):
    """Slots whose Harris response at their integer pixel sits within
    ``rel`` of ``thr`` (where the two packages' rounding may disagree)."""
    from feature_detector_tpu_torch.kernels.detect import harris_response_raw
    from feature_detector_tpu_torch.core.config import HarrisOptions

    raw = harris_response_raw(torch.from_numpy(images).to(torch.float32), HarrisOptions()).numpy()
    x = np.clip(uv[..., 0].astype(np.int32), 0, images.shape[2] - 1)
    y = np.clip(uv[..., 1].astype(np.int32), 0, images.shape[1] - 1)
    vals = raw[np.arange(len(images))[:, None], y, x]
    return np.abs(vals - thr) <= rel * thr


def test_scan_frontend_equals_jax():
    seq = sequence(6)
    fe = JS.scan_frontend_jit("harris", 200, JDetectorOptions(**VO_DET), JBriefOptions(upright=True))
    jf, jw, jv, jl = fe(jnp.asarray(seq.images))
    tf, tw, tv, tl = TS.scan_frontend(seq.images, "harris", 200, DetectorOptions(**VO_DET), BriefOptions(upright=True),
                                      device="cpu")
    juv, tuv = np.asarray(jf.uv), tf.uv.numpy()
    differ = (
        (np.asarray(jf.valid) != tf.valid.numpy())
        | (np.abs(juv - tuv) > FE_UV_ATOL).any(-1)
        | (np.asarray(jw).view(np.int32) != tw.numpy()).any(-1)
        | (np.asarray(jv) != tv.numpy())
    )
    differ[1:] |= np.asarray(jl) != tl.numpy()
    excused = _near_threshold(seq.images, juv, VO_DET["min_valid_response"])
    assert not (differ & ~excused).any(), np.argwhere(differ & ~excused)[:10]
    print(f"scan front-end, 6 frames: {int(differ.sum())} slots differ, all excused")
    assert not differ.any()  # no excusal was needed on these frames
    both = np.asarray(jf.valid) & tf.valid.numpy()
    jr, tr = np.asarray(jf.response)[both], tf.response.numpy()[both]
    print(f"scan front-end: positions {np.abs(juv - tuv).max():.3g} px, responses "
          f"{(np.abs(tr - jr) / np.abs(jr)).max():.3g} relative")
    np.testing.assert_allclose(tf.response.numpy()[both], np.asarray(jf.response)[both], rtol=FE_RESP_RTOL)
    assert (tl.numpy() >= 0).sum() > 200 and int(tf.valid.sum()) == 6 * 200


def _chunk_inputs(seq):
    tf, tw, tv, tl = TS.scan_frontend(seq.images, "harris", 200, DetectorOptions(**VO_DET), BriefOptions(upright=True),
                                      device="cpu")
    uv_np = tf.uv.numpy()
    n = len(seq.images)
    pairs = TV.match_and_gate(tw, tv, uv_np, tf.valid.numpy(), tl.numpy(), seq.cam,
                              MatcherOptions(ratio=0.85, max_distance=80), TV.match_offsets_for(n))
    tracks = TS.build_tracks_conflict_free(pairs, n, 256)
    return TV.chunk_problems(tracks, uv_np, TV.chunk_starts(n, 12, 5), 12, 512)


def test_chunk_solver_equals_jax_given_its_draws(seq13, jax_vo13):
    """Both solvers on the same chunk problems (13 frames: two chunks) with
    JAX's RANSAC draws; compared up to each chunk's monocular scale."""
    track_uv, track_has = _chunk_inputs(seq13)
    opts = dict(max_iterations=10, huber_delta=2.0, gate_px=3.0, gate_rounds=1)
    want = JV._chunk_solver_jit(JS.Pinhole(*seq13.cam), 12, 15, 2, JBAOptions(**opts), 3.0)(
        jnp.asarray(track_uv), jnp.asarray(track_has))
    want = [np.asarray(x) for x in want]
    got = TV.solve_chunks(torch.from_numpy(track_uv), torch.from_numpy(track_has), seq13.cam, 15, 2,
                          BAOptions(**opts), 3.0, gumbel=torch.from_numpy(ransac_draws(0, 64, 512)))
    got = [x.numpy() for x in got]
    np.testing.assert_array_equal(got[3], want[3])  # has_pt
    np.testing.assert_array_equal(got[4], want[4])  # chunk ok
    np.testing.assert_allclose(got[0], want[0], atol=CHUNK_ROT_ATOL)
    centers = lambda r, t: -np.einsum("kfji,kfj->kfi", r, t)
    cg, cw = centers(got[0], got[1]), centers(want[0], want[1])
    for k in range(len(cg)):
        sg = np.linalg.norm(cg[k], axis=1).max()
        sw = np.linalg.norm(cw[k], axis=1).max()
        hp = want[3][k]
        point_diff = np.abs(got[2][k][hp] / sg - want[2][k][hp] / sw).max()
        print(f"chunk {k}: rotations {np.abs(got[0][k] - want[0][k]).max():.3g}, centers "
              f"{np.abs(cg[k] / sg - cw[k] / sw).max():.3g} and points {point_diff:.3g} of the chunk's scale")
        np.testing.assert_allclose(cg[k] / sg, cw[k] / sw, atol=CHUNK_CENTER_ATOL)
        np.testing.assert_allclose(got[2][k][hp] / sg, want[2][k][hp] / sw, atol=CHUNK_POINT_ATOL)
    assert want[4].all() and want[3].sum() > 300


# --------------------------------------------------------------------------
# The whole VO
# --------------------------------------------------------------------------


def test_vo_13_frames_both_within_3pct_of_span(seq13, port_vo13, jax_vo13):
    assert len(port_vo13.trajectory) == 13 and np.isfinite(port_vo13.trajectory.positions).all()
    port_ate, port_share = span_share(port_vo13.trajectory.positions, seq13)
    jax_share = float(jax_ate(jnp.asarray(jax_vo13.trajectory.positions), jnp.asarray(seq13.trajectory.positions),
                              with_scale=True)) / float(np.linalg.norm(np.ptp(seq13.trajectory.positions, 0)))
    print(f"13-frame VO: port ATE {port_ate:.6f} m ({100 * port_share:.4f}% of span), "
          f"JAX {100 * jax_share:.4f}% of span; tracks port {port_vo13.num_tracks}, JAX {jax_vo13.num_tracks}")
    assert port_share < ATE_SPAN_SHARE and jax_share < ATE_SPAN_SHARE
    assert port_vo13.problem is not None and port_vo13.points.shape[1] == 3 and len(port_vo13.points) > 100


def test_vo_blank_frames_degrade_gracefully():
    cam = TS.Pinhole(fx=288.0, fy=288.0, cx=160.0, cy=120.0)
    res = TV.run_visual_odometry_fused(np.full((14, 240, 320), 57, np.uint8), cam, device="cpu")
    assert len(res.trajectory) == 14 and np.isfinite(res.trajectory.positions).all()
    assert res.num_tracks == 0


def test_vo_short_sequence_direct_entry():
    """n < chunk: one whole-sequence chunk (tests/test_sequence.py's bound)."""
    seq = sequence(10)
    res = TV.run_visual_odometry_fused(seq.images, seq.cam, device="cpu")
    assert span_share(res.trajectory.positions, seq)[1] < 0.05


def test_vo_entry_rules(seq13):
    """The fused path is the default; ``legacy=True`` runs the short-window
    VO (for n <= chunk one ``run_visual_odometry`` call, with the keyword
    arguments it takes); both need a card unless asked for the CPU."""
    if not torch.cuda.is_available():
        for legacy in (False, True):
            with pytest.raises(RuntimeError):
                TS.run_visual_odometry_chunked(seq13.images, seq13.cam, legacy=legacy)  # cuda by default
    stages = {}
    res = TS.run_visual_odometry_chunked(seq13.images[:8], seq13.cam, device="cpu", pose_graph=False,
                                         local_ba_window=6, stage_seconds=stages)
    assert np.isfinite(res.trajectory.positions).all()
    assert set(stages) == {"frontend", "match_gate", "tracks", "chunk_solve", "compose", "pose_graph", "global_ba"}
    legacy_stages = {}
    res = TS.run_visual_odometry_chunked(seq13.images[:6], seq13.cam, legacy=True, device="cpu", pose_graph=False,
                                         local_ba_window=6, stage_seconds=legacy_stages)
    assert len(res.trajectory) == 6 and np.isfinite(res.trajectory.positions).all() and res.num_tracks > 20
    assert set(legacy_stages) == {"frontend", "match_gate", "tracks", "init", "pnp", "triangulate", "local_ba",
                                  "global_ba"}
