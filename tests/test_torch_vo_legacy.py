"""PyTorch port of the legacy short-window VO (feature_detector_tpu/slam/
sequence.py: run_visual_odometry, the incremental and batch front-ends, the
pair gate, the track graph, the init pair, legacy=True) against the JAX
package, on the CPU.

The JAX side runs one 5-frame ``run_visual_odometry`` (seed 7, 140
landmarks; a module fixture, mostly compilation) and the stages before its
first BA on the same frames; everything else is the port's, held to the
bounds of tests/test_sequence.py.  Tolerances, each measured on these
inputs (listed in CHANGES.md too):

- tracks from the same pair matches, the init pair's j and seed tracks:
  exactly equal;
- incremental and batch front-ends: validity, descriptor words, descriptor
  validity and carry links exactly equal; positions within FE_UV_ATOL px
  and responses within FE_RESP_RTOL, as tests/test_torch_vo.py holds the
  scan front-end;
- Hamming matches given JAX's front-end output: equal; the gated pair
  matches given JAX's RANSAC draws too: equal but on at most
  PAIR_FLIP_PAIRS pair, where the two-view init picks another of its
  candidates, and at most PAIR_FLIPS entries (measured: 1 pair, 5 entries);
- the init pair's pose given JAX's tracks and draws: INIT_POSE_ATOL
  (measured 2.6e-6 on R, 4.8e-6 on t);
- the whole VO with JAX's draws against JAX's trajectory: VO_JAX_ATE_M
  after Sim(3) alignment (measured 2.0e-5 m; the port's BA solves in
  float64, JAX's state is float32, and every windowed BA feeds the next
  frame's PnP prior), the same number of tracks;
- the whole VO with the port's draws: ATE under tests/test_sequence.py's
  bounds (0.05 m on 5 frames, 0.06 m on 16).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_detector_tpu.core.config import BriefOptions as JBriefOptions
from feature_detector_tpu.core.config import DetectorOptions as JDetectorOptions
from feature_detector_tpu.core.config import MatcherOptions as JMatcherOptions
from feature_detector_tpu.slam import sequence as JS
from feature_detector_tpu_torch.core.config import BAOptions, BriefOptions, DetectorOptions, MatcherOptions
from feature_detector_tpu_torch.core.types import Features
from feature_detector_tpu_torch.frontend.detector import detect_good_features
from feature_detector_tpu_torch.match.hamming import match_hamming
from feature_detector_tpu_torch.slam import geometry as TG
from feature_detector_tpu_torch.slam import sequence as TS
from feature_detector_tpu_torch.slam.ba import ba_solve
from feature_detector_tpu_torch.slam.evaluate import ate_rmse
from tests.test_torch_slam import ransac_draws

FE_UV_ATOL = 1e-4  # px
FE_RESP_RTOL = 1e-5
PAIR_FLIP_PAIRS = 1
PAIR_FLIPS = 8
INIT_POSE_ATOL = 1e-4
VO_JAX_ATE_M = 2e-4
ATE_5_FRAMES_M = 0.05  # tests/test_sequence.py:175-192
ATE_16_FRAMES_M = 0.06  # tests/test_sequence.py:222-237
MESH_POS_ATOL = 5e-2  # tests/test_sequence.py:322-340
PAD_POSE_ATOL = 1e-5
VO_DET = dict(min_feature_distance=10, min_valid_response=20.0, max_features=256, subpixel=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's VO is a host loop of small ops: on one thread it runs
    beside the other test workers without oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=8)
def _jax_draws(seed, rounds, n, device):
    return torch.from_numpy(ransac_draws(seed, rounds, n)).to(device)


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's RANSACs take JAX's Gumbel draws."""
    monkeypatch.setattr(TG, "ransac_gumbel", lambda seed, rounds, n, device: _jax_draws(seed, rounds, n,
                                                                                          str(device)))


def arc(seed, n_frames=5, n_landmarks=140, **kw):
    return TS.make_synthetic_sequence(n_frames=n_frames, n_landmarks=n_landmarks, seed=seed, **kw)


def ate(positions, seq):
    return float(ate_rmse(positions, seq.trajectory.positions, with_scale=True))


@pytest.fixture(scope="module")
def seq7():
    return arc(7)


@pytest.fixture(scope="module")
def jax_run(seq7):
    """JAX's 5-frame VO and the stages before its first BA, on the same
    frames (the front-end and pair jits are warm after the VO)."""
    cam = JS.Pinhole(*seq7.cam)
    vo = JS.run_visual_odometry(seq7.images, cam)
    det = JDetectorOptions(**VO_DET)
    feats, words, dvalid, links = JS.run_incremental_frontend(jnp.asarray(seq7.images), "harris", 200, det,
                                                              JBriefOptions())
    uv_np, valid_np = np.asarray(feats.uv), np.asarray(feats.valid)
    n = len(seq7.images)
    match_pairs = JS._match_pairs_jit(JMatcherOptions(ratio=0.85))
    gate = JS._pair_ransac_jit(cam)

    def gated(fa_idx, fb_idx, midx):
        sel = np.clip(midx, 0, None)
        uv_b = uv_np[fb_idx][np.arange(len(fa_idx))[:, None], sel]
        inl = np.asarray(gate(jnp.asarray(uv_np[fa_idx]), jnp.asarray(uv_b),
                              jnp.asarray((midx >= 0) & valid_np[fa_idx])))
        return [(int(fa), int(fb), np.where(inl[k], midx[k], -1)) for k, (fa, fb) in enumerate(zip(fa_idx, fb_idx))]

    pairs, raw = [], []
    for off in (1, 2, 3, 4):
        m = match_pairs(words[:-off], dvalid[:-off], words[off:], dvalid[off:])
        midx = np.where(np.asarray(m.valid), np.asarray(m.index), -1)
        raw.append((off, midx))
        pairs += gated(np.arange(n - off), np.arange(off, n), midx)
    pairs += gated(np.asarray([l[0] for l in links]), np.asarray([l[1] for l in links]), np.stack([l[2] for l in links]))
    tracks = JS._build_tracks(pairs, n, 256)
    init = JS._pick_init_pair(tracks, uv_np, cam, n, 256)
    return {"vo": vo, "fe": (feats, words, dvalid, links), "pairs": pairs, "raw_matches": raw, "tracks": tracks,
            "init": init}


@pytest.fixture(scope="module")
def port_vo7(seq7):
    stages = {}
    res = TS.run_visual_odometry(seq7.images, seq7.cam, device="cpu", stage_seconds=stages)
    return res, stages


def _frontend_differ(jf, jw, jv, tf, tw, tv):
    juv, tuv = np.asarray(jf.uv), tf.uv.numpy()
    differ = (
        (np.asarray(jf.valid) != tf.valid.numpy())
        | (np.abs(juv - tuv) > FE_UV_ATOL).any(-1)
        | (np.asarray(jw).view(np.int32) != tw.numpy()).any(-1)
        | (np.asarray(jv) != tv.numpy())
    )
    both = np.asarray(jf.valid) & tf.valid.numpy()
    jr, tr = np.asarray(jf.response)[both], tf.response.numpy()[both]
    print(f"positions {np.abs(juv - tuv).max():.3g} px, responses {(np.abs(tr - jr) / np.abs(jr)).max():.3g} relative")
    np.testing.assert_allclose(tr, jr, rtol=FE_RESP_RTOL)
    return differ


# --------------------------------------------------------------------------
# Stages before the first BA
# --------------------------------------------------------------------------


def test_incremental_frontend_equals_jax(seq7, jax_run):
    jf, jw, jv, jl = jax_run["fe"]
    tf, tw, tv, tl = TS.run_incremental_frontend(seq7.images, "harris", 200, DetectorOptions(**VO_DET),
                                                 BriefOptions(), device="cpu")
    differ = _frontend_differ(jf, jw, jv, tf, tw, tv)
    assert not differ.any(), np.argwhere(differ)[:10]
    assert [(a, b) for a, b, _ in tl] == [(a, b) for a, b, _ in jl] == [(f, f + 1) for f in range(4)]
    for (_, _, got), (_, _, want) in zip(tl, jl):
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)


def test_incremental_frontend_carries_tracks(seq7):
    """Every link carries at least 15 features, to valid slots
    (tests/test_sequence.py:196-220)."""
    feats, _, _, links = TS.run_incremental_frontend(seq7.images, "harris", 200, DetectorOptions(**VO_DET),
                                                     BriefOptions(), device="cpu")
    valid = feats.valid.numpy()
    assert len(links) == len(seq7.images) - 1
    carried = [int((m >= 0).sum()) for _, _, m in links]
    print(f"carried per link: {carried}")
    for (fa, fb, m), c in zip(links, carried):
        assert c >= 15, (fa, c)
        assert valid[fb][m[m >= 0]].all()


def test_batch_frontend_equals_jax_and_per_frame(seq7):
    det = DetectorOptions(**VO_DET)
    jf, jw, jv = JS._batch_frontend_jit("harris", 200, JDetectorOptions(**VO_DET), JBriefOptions())(
        jnp.asarray(seq7.images))
    tf, tw, tv = TS.batch_frontend(seq7.images, "harris", 200, det, BriefOptions(), device="cpu")
    differ = _frontend_differ(jf, jw, jv, tf, tw, tv)
    assert not differ.any(), np.argwhere(differ)[:10]
    # Per frame, the batch equals detect_good_features with no existing features.
    for f in range(len(seq7.images)):
        one = detect_good_features(torch.from_numpy(seq7.images[f]), Features.empty(256, "cpu"), "harris", 200, det)
        for k in ("uv", "response", "valid"):
            assert torch.equal(getattr(one, k), getattr(tf, k)[f]), (f, k)


def test_pair_matches_equal_jax_given_its_draws(seq7, jax_run, jax_draws):
    """JAX's front-end output through the port's matcher and pair gate.
    The Hamming matches are equal; the gate's inlier masks are equal on
    every pair but at most PAIR_FLIP_PAIRS, where the two-view init's
    selection among its 8 refined candidates picks another one (measured:
    pair (0, 4), the widest, 5 of its entries; the port's pose there is
    0.88 rad from the one JAX's unbatched two_view_init picks on the same
    pair, and that one is not the pose JAX's batched gate picks either)."""
    jf, jw, jv, jl = jax_run["fe"]
    words = torch.from_numpy(np.asarray(jw).view(np.int32))
    dvalid = torch.from_numpy(np.asarray(jv))
    for off, want in jax_run["raw_matches"]:
        m = match_hamming(words[:-off], dvalid[:-off], words[off:], dvalid[off:], MatcherOptions(ratio=0.85))
        np.testing.assert_array_equal(torch.where(m.valid, m.index, -1).numpy(), want)
    got = TS._pair_matches(words, dvalid, np.asarray(jf.uv), np.asarray(jf.valid), jl, seq7.cam,
                           MatcherOptions(ratio=0.85))
    want = jax_run["pairs"]
    assert [(a, b) for a, b, _ in got] == [(a, b) for a, b, _ in want]
    per_pair = {(a, b): int((g != w).sum()) for (a, b, g), (_, _, w) in zip(got, want) if (g != w).any()}
    kept = sum(int((w >= 0).sum()) for _, _, w in want)
    print(f"gated pair matches: {sum(per_pair.values())} of {kept} kept entries differ, in pairs {per_pair}")
    assert len(per_pair) <= PAIR_FLIP_PAIRS and sum(per_pair.values()) <= PAIR_FLIPS


@pytest.mark.parametrize("case", ["jax_pairs", "random_pairs"])
def test_build_tracks_equals_jax(jax_run, case):
    if case == "jax_pairs":
        pairs, n_frames, n_feats = jax_run["pairs"], 5, 256
    else:
        # Per frame a shuffled view of 30 points: most matches are right,
        # some missing, some wrong (which merge tracks into conflicts).
        rng = np.random.default_rng(3)
        n_frames, n_feats = 7, 30
        slot_of = np.stack([rng.permutation(n_feats) for _ in range(n_frames)])  # slot_of[f, point]
        pairs = []
        for off in (1, 2, 1):
            for f in range(n_frames - off):
                idx = np.full(n_feats, -1, np.int64)
                idx[slot_of[f]] = slot_of[f + off]
                idx[rng.random(n_feats) < 0.2] = -1
                wrong = rng.random(n_feats) < 0.05
                idx[wrong] = rng.integers(0, n_feats, int(wrong.sum()))
                pairs.append((f, f + off, idx))
    got = TS._build_tracks(pairs, n_frames, n_feats)
    want = JS._build_tracks(pairs, n_frames, n_feats)
    assert got == want and len(got) >= 10
    if case == "jax_pairs":
        assert got == jax_run["tracks"]


def test_pick_init_pair_equals_jax_given_its_draws(seq7, jax_run, jax_draws):
    jf = jax_run["fe"][0]
    j, r, t, seed_pairs = TS._pick_init_pair(jax_run["tracks"], np.asarray(jf.uv), seq7.cam, 5, 256, device="cpu")
    wj, wr, wt, wseed = jax_run["init"]
    print(f"init pair (0, {j}): {len(seed_pairs)} seed tracks; R {np.abs(r - wr).max():.3g}, t {np.abs(t - wt).max():.3g}")
    assert j == wj
    assert [p[0] for p in seed_pairs] == [p[0] for p in wseed]
    np.testing.assert_allclose(r, wr, atol=INIT_POSE_ATOL)
    np.testing.assert_allclose(t, wt, atol=INIT_POSE_ATOL)


def test_pick_init_pair_raises_without_support():
    uv = np.zeros((3, 256, 2), np.float32)
    with pytest.raises(ValueError, match="two-view initialization failed"):
        TS._pick_init_pair([[(0, 0), (2, 0)]], uv, TS.Pinhole(288.0, 288.0, 160.0, 120.0), 3, 256, device="cpu")


# --------------------------------------------------------------------------
# The whole VO
# --------------------------------------------------------------------------


def test_vo_with_jax_draws_near_jax(seq7, jax_run, jax_draws):
    res = TS.run_visual_odometry(seq7.images, seq7.cam, device="cpu")
    want = jax_run["vo"]
    d = float(ate_rmse(res.trajectory.positions, want.trajectory.positions, with_scale=True))
    print(f"5-frame VO with JAX's draws: {res.num_tracks} tracks (JAX {want.num_tracks}), {d:.3g} m from JAX's "
          f"trajectory after Sim(3) alignment; ATE port {ate(res.trajectory.positions, seq7):.4g}, "
          f"JAX {ate(want.trajectory.positions, seq7):.4g} m")
    assert res.num_tracks == want.num_tracks
    assert d < VO_JAX_ATE_M


@pytest.mark.parametrize("seed", [5, 7, 8])
def test_vo_ate_own_draws(seed, seq7, port_vo7):
    """tests/test_sequence.py:175-192, with the port's own draws."""
    if seed == 7:
        res, stages = port_vo7
        print("stage seconds:", {k: round(v, 3) for k, v in stages.items()})
        seq = seq7
    else:
        seq = arc(seed)
        res = TS.run_visual_odometry(seq.images, seq.cam, device="cpu")
    got = ate(res.trajectory.positions, seq)
    print(f"seed {seed}: ATE {got:.4g} m, {res.num_tracks} tracks, mean track length {res.mean_track_length:.3g}")
    assert res.num_tracks > 20
    assert got < ATE_5_FRAMES_M


def test_vo_batch_frontend(seq7):
    res = TS.run_visual_odometry(seq7.images, seq7.cam, incremental=False, device="cpu")
    got = ate(res.trajectory.positions, seq7)
    print(f"batch front-end: ATE {got:.4g} m, {res.num_tracks} tracks")
    assert np.isfinite(res.trajectory.positions).all() and res.num_tracks > 20
    assert got < ATE_5_FRAMES_M


def test_vo_16_frames():
    """tests/test_sequence.py:222-237."""
    seq = arc(3, n_frames=16, n_landmarks=250, angle_step=0.03)
    res = TS.run_visual_odometry(seq.images, seq.cam, max_track_obs=12, device="cpu")
    got = ate(res.trajectory.positions, seq)
    print(f"16 frames: ATE {got:.4g} m, {res.num_tracks} tracks")
    assert got < ATE_16_FRAMES_M


def test_chunked_legacy_14_lateral_frames():
    """tests/test_sequence.py:305-320: every frame gets a finite pose."""
    seq = arc(3, n_frames=14, n_landmarks=300, motion="lateral", angle_step=0.03)
    res = TS.run_visual_odometry_chunked(seq.images, seq.cam, chunk=8, overlap=4, legacy=True, max_track_obs=12,
                                         device="cpu")
    span = float(np.linalg.norm(np.ptp(seq.trajectory.positions, 0)))
    print(f"legacy chunked, 14 frames: ATE {ate(res.trajectory.positions, seq):.4g} m of a {span:.3g} m span, "
          f"{res.num_tracks} tracks")
    assert len(res.trajectory) == 14 and res.rotations_wc.shape == (14, 3, 3)
    assert np.isfinite(res.trajectory.positions).all()


def test_vo_over_a_mesh_of_one(seq7, port_vo7):
    """tests/test_sequence.py:322-340 on an in-process world of one."""
    import torch.distributed as dist

    from feature_detector_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    try:
        res = TS.run_visual_odometry(seq7.images, seq7.cam, mesh=mesh)
    finally:
        dist.destroy_process_group()
    single = port_vo7[0].trajectory.positions
    print(f"mesh of one: positions within {np.abs(res.trajectory.positions - single).max():.3g} of one device")
    np.testing.assert_allclose(res.trajectory.positions, single, atol=MESH_POS_ATOL)
    assert ate(res.trajectory.positions, seq7) < ATE_5_FRAMES_M


def test_padded_camera_does_not_move(seq7, port_vo7):
    """local_ba pads cameras to multiples of 8: a camera with no
    observations keeps its pose bit for bit (its rows get only the absolute
    1e-6 damping, and its right-hand side is 0), and the observed cameras
    solve as without the padding."""
    prob = port_vo7[0].problem
    n_cams = prob.rot.shape[0]
    pad = 8 - n_cams % 8
    rng = np.random.default_rng(0)
    r_pad = torch.from_numpy(np.linalg.qr(rng.normal(size=(pad, 3, 3)))[0].astype(np.float32))
    t_pad = torch.from_numpy(rng.normal(size=(pad, 3)).astype(np.float32))
    padded = prob._replace(rot=torch.cat([prob.rot, r_pad]), trans=torch.cat([prob.trans, t_pad]))
    opts = BAOptions(max_iterations=10, huber_delta=2.0, gate_px=3.0, gate_rounds=1)
    got = ba_solve(padded, seq7.cam, opts, num_fixed=1)
    alone = ba_solve(prob, seq7.cam, opts, num_fixed=1)
    assert torch.equal(got.rot[n_cams:], padded.rot[n_cams:])
    assert torch.equal(got.trans[n_cams:], padded.trans[n_cams:])
    assert not torch.equal(got.rot[1:n_cams], padded.rot[1:n_cams])  # the observed cameras did move
    diff = max(float((got.rot[:n_cams] - alone.rot).abs().max()), float((got.trans[:n_cams] - alone.trans).abs().max()))
    print(f"padded against unpadded solve: poses within {diff:.3g}")
    assert diff <= PAD_POSE_ATOL
