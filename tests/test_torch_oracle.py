"""The port's numpy oracles (feature_detector_tpu_torch/oracle) against the
JAX package's, and the port's CPU paths against the port's oracles, on the
CPU.

1. Every oracle function of the port gives exactly the JAX oracle's output
   on seeded frames (``tests/torch_port_inputs.py``) and seeded heatmaps:
   the copies are faithful.
2. The port's detectors, BRIEF, Hamming matcher, LSD and NN
   post-processing against the port's oracles, as tests/test_detectors.py,
   test_brief.py, test_lsd.py and test_nn_detector.py hold the JAX package
   against its own (those read the absent example images; these run on
   synthetic frames), with their tolerances and excusals:
   - Harris / Shi-Tomasi maps rtol 1e-5, atol 1e-3; FAST maps, NMS pixels,
     masks, picks, sparsify status, Hamming distances, LSD validity and
     every NN selection exact;
   - gather BRIEF bits equal but for near-ties of the two reads (|I1 - I2|
     < 0.05, at most max(2, 0.5%) of the bits); default BRIEF against the
     binned oracle at most 0.5% of the bits (a steering bin flipped by
     float32 against float64 atan2 at a boundary);
   - LSD norms rtol 1e-5 and angles rtol 1e-4 / atol 1e-5 where valid;
     every oracle line of the synthetic bars within 4 px of a detected one,
     counts within [0.5x, 2x + 1].
"""

import types

import numpy as np
import pytest
import torch

import feature_detector_tpu.core.config as JC
import feature_detector_tpu_torch.core.config as TC
from feature_detector_tpu.oracle import brief as JOB
from feature_detector_tpu.oracle import detectors as JOD
from feature_detector_tpu.oracle import lsd as JOL
from feature_detector_tpu.oracle import nn_postproc as JON
from feature_detector_tpu_torch.core.types import Features, words_to_numpy
from feature_detector_tpu_torch.frontend import nn_detector as NN
from feature_detector_tpu_torch.frontend.descriptor import compute_descriptors
from feature_detector_tpu_torch.frontend.detector import detect_good_features, sparsify_features
from feature_detector_tpu_torch.frontend.line_detector import detect_good_lines
from feature_detector_tpu_torch.kernels import detect as K
from feature_detector_tpu_torch.kernels import lsd as KL
from feature_detector_tpu_torch.kernels.nn_ops import sample_descriptor_grid
from feature_detector_tpu_torch.match.hamming import hamming_distance_matrix
from feature_detector_tpu_torch.oracle import brief as TOB
from feature_detector_tpu_torch.oracle import detectors as TOD
from feature_detector_tpu_torch.oracle import lsd as TOL
from feature_detector_tpu_torch.oracle import nn_postproc as TON
from tests.torch_port_inputs import synth_frame

PACKAGES = {
    "jax": types.SimpleNamespace(det=JOD, brief=JOB, lsd=JOL, nn=JON, C=JC),
    "port": types.SimpleNamespace(det=TOD, brief=TOB, lsd=TOL, nn=TON, C=TC),
}
FRAME = synth_frame(0)  # 120 x 160
FRAME2 = synth_frame(1)


def _hole_mask(shape):
    mask = np.ones(shape, np.int32)
    mask[40:60, 50:90] = 0
    return mask


def _uv(n, seed, h=120, w=160, margin=25):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(margin, w - margin, n), rng.uniform(margin, h - margin, n)], -1).astype(np.float32)


def _heatmap(seed, h=96, w=128):
    rng = np.random.default_rng(seed)
    hm = rng.random((h, w)).astype(np.float32) * 0.2
    ys, xs = rng.integers(5, h - 5, 40), rng.integers(5, w - 5, 40)
    hm[ys, xs] = 0.5 + rng.random(40).astype(np.float32) * 0.5
    return hm


def _nms_candidates(seed, rows=96, cols=128, k=64):
    rng = np.random.default_rng(seed)
    kpts = np.stack([rng.integers(0, cols, k), rng.integers(0, rows, k)], 1).astype(np.int32)
    scores = np.sort(rng.random(k).astype(np.float32))[::-1].copy()
    scores[-10:] = 0.0
    return kpts, scores


def bars_image(h=120, w=160):
    """Bright straight bars on a dark background (tests/test_lsd.py)."""
    img = np.full((h, w), 30, np.uint8)
    img[20:24, 10:150] = 220
    img[40:110, 80:84] = 220
    for i in range(60):
        img[30 + i, 10 + i : 14 + i] = 220
    return img


SEED_FEATURES = [(float(i * 15), float(j * 15)) for i in range(1, 6) for j in range(1, 6)]
DETECT_CASES = {
    "harris": lambda C: (C.DetectorOptions(min_feature_distance=20, min_valid_response=30.0, max_features=256),
                         C.HarrisOptions()),
    "shi_tomasi": lambda C: (C.DetectorOptions(min_feature_distance=20, min_valid_response=40.0, max_features=256),
                             C.ShiTomasiOptions()),
    "fast": lambda C: (C.DetectorOptions(min_feature_distance=20, min_valid_response=10.0, max_features=256),
                       C.FastOptions()),
}

# name: fn(package namespace) -> oracle output
ORACLE_CASES = {
    "harris_response_map": lambda p: p.det.harris_response_map(
        FRAME, _hole_mask(FRAME.shape), p.C.DetectorOptions(min_valid_response=30.0), p.C.HarrisOptions()),
    "shi_tomasi_response_map": lambda p: p.det.shi_tomasi_response_map(
        FRAME, np.ones(FRAME.shape, np.int32), p.C.DetectorOptions(min_valid_response=40.0), p.C.ShiTomasiOptions()),
    "fast_response_map": lambda p: p.det.fast_response_map(FRAME, _hole_mask(FRAME.shape), p.C.FastOptions()),
    "nms4_candidates": lambda p: p.det.nms4_candidates(p.det.harris_response_map(
        FRAME, np.ones(FRAME.shape, np.int32), p.C.DetectorOptions(min_valid_response=30.0), p.C.HarrisOptions()),
        30.0, 2),
    "fast_candidates": lambda p: p.det.fast_candidates(
        p.det.fast_response_map(FRAME, np.ones(FRAME.shape, np.int32), p.C.FastOptions()), 10.0),
    "make_mask": lambda p: p.det.make_mask((60, 110), [(2.0, 3.0), (100.0, 50.0)], 5),
    **{f"detect_good_features_{kind}": (lambda kind: lambda p: p.det.detect_good_features(
        FRAME, 50, kind, *DETECT_CASES[kind](p.C)))(kind) for kind in DETECT_CASES},
    "detect_good_features_incremental": lambda p: p.det.detect_good_features(
        FRAME, 60, "harris", p.C.DetectorOptions(min_feature_distance=10, min_valid_response=30.0),
        p.C.HarrisOptions(), existing=list(SEED_FEATURES)),
    "sparsify_features": lambda p: p.det.sparsify_features(
        np.random.default_rng(0).uniform(0, 150, (80, 2)).astype(np.float32), 120, 160, 1, 0,
        list(np.random.default_rng(1).integers(1, 3, 80)), p.C.DetectorOptions()),
    "brief_compute": lambda p: p.brief.compute(FRAME, _uv(32, 0), p.C.BriefOptions(method="gather")),
    "brief_compute_128": lambda p: p.brief.compute(FRAME2, _uv(8, 3), p.C.BriefOptions(length=128, method="gather")),
    "brief_compute_binned": lambda p: p.brief.compute_binned(FRAME, _uv(48, 1, margin=19), p.C.BriefOptions()),
    "brief_pack_and_hamming": lambda p: p.brief.hamming_distance(
        p.brief.pack_bits(p.brief.compute(FRAME, _uv(16, 2), p.C.BriefOptions(method="gather"))[0]),
        p.brief.pack_bits(p.brief.compute(FRAME2, _uv(16, 2), p.C.BriefOptions(method="gather"))[0])),
    "lsd_angle_map": lambda p: p.lsd.line_level_angle_map(FRAME, p.C.LineDetectorOptions()),
    "lsd_min_region_size": lambda p: [p.lsd.min_region_size(r, c, p.C.LineDetectorOptions())
                                      for r, c in ((480, 752), (120, 160))],
    "lsd_detect_lines_bars": lambda p: p.lsd.detect_lines(bars_image(), p.C.LineDetectorOptions()),
    "lsd_detect_lines_scene": lambda p: p.lsd.detect_lines(FRAME2, p.C.LineDetectorOptions()),
    "nn_create_mask": lambda p: p.nn.create_mask(
        (96, 128), [(20.0, 30.0), (100.0, 50.0)], p.C.NNDetectorOptions(max_number_of_detected_features=64)),
    "nn_select_features": lambda p: p.nn.select_features(
        _heatmap(0), [], p.C.NNDetectorOptions(max_number_of_detected_features=64)),
    "nn_select_features_existing": lambda p: p.nn.select_features(
        _heatmap(1), [(32.0, 32.0), (64.0, 48.0)], p.C.NNDetectorOptions(max_number_of_detected_features=64)),
    "nn_sample_descriptors": lambda p: p.nn.sample_descriptors(
        np.random.default_rng(2).random((12, 16, 32)).astype(np.float32),
        [(3.5, 9.0), (100.0, 60.0), (127.9, 95.9), (0.0, 0.0)]),
    "nn_direct_select": lambda p: p.nn.direct_select(
        *_nms_candidates(3), [(30.0, 40.0)],
        p.C.NNDetectorOptions(max_number_of_detected_features=32, min_feature_distance=6), 96, 128),
}


def _assert_same(got, want, path="out"):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_oracle_copy_equals_jax_oracle(case):
    want = ORACLE_CASES[case](PACKAGES["jax"])
    got = ORACLE_CASES[case](PACKAGES["port"])
    _assert_same(got, want)


# --------------------------------------------------------------------------
# The port's CPU paths against the port's oracles
# --------------------------------------------------------------------------


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("kind", ["harris", "shi_tomasi", "fast", "harris_masked"])
def test_response_maps_match_oracle(kind):
    mask = _hole_mask(FRAME.shape) if kind == "harris_masked" else np.ones(FRAME.shape, np.int32)
    if kind in ("harris", "harris_masked"):
        opts, sub = TC.DetectorOptions(min_valid_response=30.0), TC.HarrisOptions()
        want = TOD.harris_response_map(FRAME, mask, opts, sub)
        got = K.harris_response(_t(FRAME), _t(mask), opts, sub).numpy()
    elif kind == "shi_tomasi":
        opts, sub = TC.DetectorOptions(min_valid_response=40.0), TC.ShiTomasiOptions()
        want = TOD.shi_tomasi_response_map(FRAME, mask, opts, sub)
        got = K.shi_tomasi_response(_t(FRAME), _t(mask), opts, sub).numpy()
    else:
        want = TOD.fast_response_map(FRAME, mask, TC.FastOptions())
        got = K.fast_response(_t(FRAME), _t(mask), TC.FastOptions()).numpy()
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    if kind == "harris_masked":
        assert got[40:60, 50:90].max() == 0.0 and (want > 0).sum() > 20


def test_nms4_matches_oracle():
    opts = TC.DetectorOptions(min_valid_response=30.0)
    resp = TOD.harris_response_map(FRAME, np.ones(FRAME.shape, np.int32), opts, TC.HarrisOptions())
    want_resp, want_px = TOD.nms4_candidates(resp, 30.0, 2)
    got = K.nms4(_t(resp), 30.0, 2).numpy()
    ys, xs = np.nonzero(got)
    np.testing.assert_array_equal(np.stack([xs, ys], -1), want_px)
    np.testing.assert_allclose(got[ys, xs], want_resp, rtol=1e-6)


@pytest.mark.parametrize("case", ["clamped_at_borders", "invalid_ignored"])
def test_suppression_mask_matches_oracle(case):
    if case == "clamped_at_borders":
        shape, uv, valid, r = (60, 110), [[2.0, 3.0], [100.0, 50.0]], [True, True], 5
    else:
        shape, uv, valid, r = (64, 64), [[20.0, 20.0], [40.0, 40.0]], [True, False], 3
    got = K.make_suppression_mask(shape, torch.tensor(uv), torch.tensor(valid), r).numpy()
    want = TOD.make_mask(shape, [tuple(p) for p, v in zip(uv, valid) if v], r)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(DETECT_CASES) + ["incremental"])
@pytest.mark.parametrize("seed", [0, 2])
def test_detect_matches_oracle(kind, seed):
    frame = synth_frame(seed)
    if kind == "incremental":
        opts = TC.DetectorOptions(min_feature_distance=10, min_valid_response=30.0, max_features=256)
        want = TOD.detect_good_features(frame, 60, "harris", opts, TC.HarrisOptions(), existing=list(SEED_FEATURES))
        existing = Features.from_numpy(np.array(SEED_FEATURES, np.float32), 256, device="cpu")
        got = detect_good_features(_t(frame), existing, "harris", 60, opts, TC.HarrisOptions())
    else:
        opts, sub = DETECT_CASES[kind](TC)
        want = TOD.detect_good_features(frame, 50, kind, opts, sub)
        got = detect_good_features(_t(frame), Features.empty(256, "cpu"), kind, 50, opts, sub)
    uv, _ = got.to_numpy()
    assert len(uv) == len(want) and len(want) >= 5
    np.testing.assert_array_equal(uv, np.asarray(want, np.float32))


def test_sparsify_matches_oracle():
    rng = np.random.default_rng(0)
    feats = rng.uniform(0, 150, (80, 2)).astype(np.float32)
    status = rng.integers(1, 3, 80).astype(np.int32)
    want = TOD.sparsify_features(feats, 120, 160, 1, 0, list(status), TC.DetectorOptions())
    status_in = torch.zeros(128, dtype=torch.int32)
    status_in[:80] = _t(status)
    got = sparsify_features(Features.from_numpy(feats, 128, device="cpu"), status_in, 120, 160, 1, 0,
                            TC.DetectorOptions()).numpy()[:80]
    np.testing.assert_array_equal(got, np.asarray(want))


def _unpack(words, length):
    return np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")[:, :length]


def _near_tie(image, uv, i, j, opts):
    """The oracle's two reads of test j at feature i are within 0.05."""
    x, y = float(uv[i][0]), float(uv[i][1])
    d = np.arange(-opts.half_patch_size, opts.half_patch_size + 1, dtype=np.float32)
    dxg, dyg = np.meshgrid(d, d, indexing="xy")
    vals = TOB.bilinear(image, y + dyg, x + dxg)
    m10, m01 = float((dxg * vals).sum()), float((dyg * vals).sum())
    st, ct = m01 / np.hypot(m10, m01), m10 / np.hypot(m10, m01)
    p = TOB.BRIEF_PATTERN[j].astype(np.float32)
    v1 = TOB.bilinear(image, st * p[0] + ct * p[1] + y, ct * p[0] - st * p[1] + x)
    v2 = TOB.bilinear(image, st * p[2] + ct * p[3] + y, ct * p[2] - st * p[3] + x)
    return abs(float(v1) - float(v2)) < 0.05


def _brief_centres(case):
    if case == "detected_corners":
        opts = TC.DetectorOptions(min_feature_distance=20, min_valid_response=20.0, max_features=64)
        return FRAME, np.asarray(TOD.detect_good_features(FRAME, 10, "harris", opts), np.float32)
    return (FRAME, _uv(32, 0)) if case == "random_centres" else (FRAME2, _uv(8, 3))


@pytest.mark.parametrize("case", ["random_centres", "length_128", "detected_corners"])
def test_brief_gather_matches_oracle(case):
    image, uv = _brief_centres(case)
    opts = TC.BriefOptions(method="gather", length=128 if case != "random_centres" else 256)
    want_bits, want_valid = TOB.compute(image, uv, opts)
    d = compute_descriptors(_t(image), Features.from_numpy(uv, 64, device="cpu"), opts)
    got_words, got_valid = words_to_numpy(d.words)[: len(uv)], d.valid.numpy()[: len(uv)]
    np.testing.assert_array_equal(got_valid, want_valid)
    mism = _unpack(got_words, opts.length) != want_bits
    print(f"gather BRIEF, {case}: {int(mism.sum())} of {mism.size} bits differ")
    assert all(_near_tie(image, uv, i, j, opts) for i, j in zip(*np.nonzero(mism)))
    assert mism.sum() <= max(2, 0.005 * want_bits.size)


@pytest.mark.parametrize("case", ["integer_centres", "subpixel_centres", "length_128", "detected_corners"])
def test_brief_default_matches_binned_oracle(case):
    if case == "integer_centres":
        image, uv, opts = FRAME, np.rint(_uv(48, 1, margin=19)), TC.BriefOptions()
    elif case == "subpixel_centres":
        image, uv, opts = FRAME, np.array([[60.4, 50.6], [100.5, 70.2]], np.float32), TC.BriefOptions()
    elif case == "length_128":
        image, uv, opts = FRAME2, np.rint(_uv(16, 2, margin=19)), TC.BriefOptions(length=128)
    else:
        (image, uv), opts = _brief_centres(case), TC.BriefOptions()
    want_bits, want_valid = TOB.compute_binned(image, uv, opts)
    d = compute_descriptors(_t(image), Features.from_numpy(uv, max(64, len(uv)), device="cpu"), opts)
    np.testing.assert_array_equal(d.valid.numpy()[: len(uv)], want_valid)
    mism = (_unpack(words_to_numpy(d.words)[: len(uv)], opts.length) != want_bits).sum()
    print(f"default BRIEF, {case}: {int(mism)} of {want_bits.size} bits differ")
    assert mism <= 0.005 * want_bits.size


def test_hamming_distance_matches_oracle():
    rng = np.random.default_rng(0)
    wa = rng.integers(0, 2**32, size=(16, 8), dtype=np.uint32)
    wb = rng.integers(0, 2**32, size=(24, 8), dtype=np.uint32)
    got = hamming_distance_matrix(_t(wa.view(np.int32)), _t(wb.view(np.int32)), torch.ones(16, dtype=torch.bool),
                                  torch.ones(24, dtype=torch.bool)).numpy()
    np.testing.assert_array_equal(got, TOB.hamming_distance(wa, wb))


@pytest.mark.parametrize("seed", [0, 1])
def test_lsd_angle_map_matches_oracle(seed):
    frame = synth_frame(seed)
    opts = TC.LineDetectorOptions()
    wn, wa, wv = TOL.line_level_angle_map(frame, opts)
    gn, ga, gv = (x.numpy() for x in KL.line_level_angle_map(_t(frame), opts))
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gn[wv], wn[wv], rtol=1e-5)
    np.testing.assert_allclose(ga[wv], wa[wv], rtol=1e-4, atol=1e-5)
    for r, c in ((480, 752), (120, 160)):
        assert KL.min_region_size(r, c, opts) == TOL.min_region_size(r, c, opts)


def endpoint_set_distance(a, b):
    """Min over endpoint orderings of the larger endpoint distance."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    d1 = max(np.hypot(*(a[:2] - b[:2])), np.hypot(*(a[2:] - b[2:])))
    d2 = max(np.hypot(*(a[:2] - b[2:])), np.hypot(*(a[2:] - b[:2])))
    return min(d1, d2)


def test_lsd_synthetic_bars_match_oracle():
    img = bars_image()
    want = TOL.detect_lines(img, TC.LineDetectorOptions())
    segs = detect_good_lines(_t(img), 10, TC.LineDetectorOptions()).to_numpy()
    assert len(want) > 0
    for w in want:
        assert min(endpoint_set_distance(w, g) for g in segs) < 4.0, (w, segs)
    assert 0.5 * len(want) <= len(segs) <= 2.0 * len(want) + 1


def test_nn_mask_and_sampling_match_oracle():
    opts = TC.NNDetectorOptions(max_number_of_detected_features=64)
    existing = [(20.0, 30.0), (100.0, 50.0)]
    f = Features.from_numpy(np.array(existing, np.float32), 64, device="cpu")
    np.testing.assert_array_equal(NN.create_nn_mask((96, 128), f.uv, f.valid, opts).numpy(),
                                  TON.create_mask((96, 128), existing, opts))
    dm = np.random.default_rng(2).random((12, 16, 32)).astype(np.float32)
    feats = [(3.5, 9.0), (100.0, 60.0), (127.9, 95.9), (0.0, 0.0)]
    got = sample_descriptor_grid(_t(dm), torch.tensor(feats)).numpy()
    np.testing.assert_allclose(got, TON.sample_descriptors(dm, feats), atol=1e-6)


@pytest.mark.parametrize("existing", [[], [(32.0, 32.0), (64.0, 48.0)]], ids=["fresh", "existing"])
def test_nn_selection_matches_oracle(existing):
    opts = TC.NNDetectorOptions(max_number_of_detected_features=64)
    hm = _heatmap(len(existing))
    want = TON.select_features(hm, list(existing), opts)
    f = Features.from_numpy(np.array(existing, np.float32).reshape(-1, 2), 64, device="cpu")
    uv, _ = NN.select_features_from_heatmap(_t(hm), f, opts).to_numpy()
    assert len(uv) == len(want)
    np.testing.assert_array_equal(uv, np.asarray(want, np.float32))


def test_nn_direct_select_matches_oracle():
    opts = TC.NNDetectorOptions(max_number_of_detected_features=32, min_feature_distance=6)
    kpts, scores = _nms_candidates(3)
    descs = np.random.default_rng(4).random((len(kpts), 16)).astype(np.float32)
    existing = [(30.0, 40.0)]
    got_f, got_d = NN.directly_select_features(_t(kpts), _t(scores), _t(descs),
                                               Features.from_numpy(np.array(existing, np.float32), 32, device="cpu"),
                                               opts, 96, 128)
    picked = TON.direct_select(kpts, scores, existing, opts, 96, 128)
    uv, _ = got_f.to_numpy()
    np.testing.assert_array_equal(uv, np.concatenate([np.array(existing, np.float32), kpts[picked].astype(np.float32)]))
    gd = got_d.numpy()
    assert (gd[0] == 0).all()
    np.testing.assert_array_equal(gd[1: 1 + len(picked)], descs[picked])
