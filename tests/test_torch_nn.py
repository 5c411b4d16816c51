"""The port's NN serving path against the JAX package on the CPU: SuperPoint
and DISK forward passes on the packaged weights and on a ``model.init``
tree, both carried across by ``core/convert.py``; the post-processing
(mask, heatmap selection, descriptor sampling, NMS head, direct selection),
exactly given the same maps; and ``NNFeaturePointDetector.detect`` for all
four model types.  The tests that need the card are in test_torch_gpu.py.

Tolerances, measured on these inputs:

- float32 forward: heat 1e-5 / desc 1e-4 (SuperPoint), 1e-4 / 1e-3 (DISK),
  as ``tests/test_convert.py`` holds torch against Flax; the port reads
  within 3e-6.
- bfloat16 forward on both sides: bf16 convs round in another order on
  each side (XLA's CPU convolution against oneDNN's), and the differences
  grow through the layers; the trained heads' peaked softmax widens them.
  SuperPoint: heat 2e-2, desc 6e-3 (measured up to 1.03e-2 and 2.3e-3);
  DISK, nine layers with InstanceNorm: heat 6e-2, desc 3e-2 (measured up
  to 2.6e-2 and 1.1e-2).
- Descriptor sampling: ``DESC_ATOL`` (XLA's CPU compiler may fuse the
  four-product sum into multiply-adds; the port rounds each product).
- Features, responses, validity, keypoints and scores: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import feature_detector_tpu.core.config as JC
from feature_detector_tpu.core.types import Features as JFeatures
from feature_detector_tpu.frontend import nn_detector as JN
from feature_detector_tpu.models.disk import Disk as JDisk
from feature_detector_tpu.models.superpoint import SuperPoint as JSuperPoint
from feature_detector_tpu.models.superpoint import nms_head as jax_nms_head
from feature_detector_tpu.oracle import nn_postproc as oracle
from feature_detector_tpu_torch.core.config import NNModelType
from feature_detector_tpu_torch.core.convert import disk_state_from_flax, from_jax, superpoint_state_from_flax
from feature_detector_tpu_torch.core.types import Features
from feature_detector_tpu_torch.frontend import nn_detector as TN
from feature_detector_tpu_torch.kernels.greedy import greedy_select
from feature_detector_tpu_torch.models.disk import Disk
from feature_detector_tpu_torch.models.superpoint import SuperPoint, nms_head
from feature_detector_tpu_torch.models.weights import DISK_SYNTH, SUPERPOINT_SYNTH, load_params_npz
from tests.torch_port_inputs import synth_frame

DESC_ATOL = 1e-6

# model: (Flax class, port class, state converter, packaged archive, channels, H, W)
MODELS = {
    "superpoint": (JSuperPoint, SuperPoint, superpoint_state_from_flax, SUPERPOINT_SYNTH, 1, 64, 96),
    "disk": (JDisk, Disk, disk_state_from_flax, DISK_SYNTH, 3, 32, 48),
}
# (model, dtype): (heat atol, desc atol)
FORWARD_TOL = {
    ("superpoint", "float32"): (1e-5, 1e-4), ("superpoint", "bfloat16"): (2e-2, 6e-3),
    ("disk", "float32"): (1e-4, 1e-3), ("disk", "bfloat16"): (6e-2, 3e-2),
}


def _tree(model: str, weights: str):
    jcls, _, _, path, c, h, w = MODELS[model]
    if weights == "packaged":
        return load_params_npz(path)
    tree = jcls().init(jax.random.PRNGKey(3), jnp.zeros((1, h, w, c), jnp.float32))
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weights", ["packaged", "init"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_forward_equals_flax(model, weights, dtype):
    jcls, tcls, to_state, _, c, h, w = MODELS[model]
    tree = _tree(model, weights)
    x = np.random.default_rng(5).uniform(size=(2, h, w, c)).astype(np.float32)
    jheat, jdesc = jcls(dtype=getattr(jnp, dtype)).apply(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    net = tcls(dtype=getattr(torch, dtype))
    net.load_state_dict(to_state(tree))
    with torch.no_grad():
        heat, desc = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert heat.dtype == desc.dtype == torch.float32
    assert heat.shape == np.asarray(jheat).shape and desc.shape == np.asarray(jdesc).shape
    heat_tol, desc_tol = FORWARD_TOL[model, dtype]
    np.testing.assert_allclose(heat.numpy(), np.asarray(jheat), atol=heat_tol, rtol=0)
    np.testing.assert_allclose(desc.numpy(), np.asarray(jdesc), atol=desc_tol, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(desc.numpy(), axis=-1), 1.0, atol=1e-5)


def test_state_conversion_layout():
    tree = load_params_npz(SUPERPOINT_SYNTH)
    state = superpoint_state_from_flax(tree)
    k = tree["params"]["conv1b"]["Conv_0"]["kernel"]  # HWIO
    np.testing.assert_array_equal(state["conv1b.weight"].numpy()[5, 7, 0, 2], k[0, 2, 7, 5])
    assert state["convPb.weight"].shape == (65, 256, 1, 1)
    dstate = disk_state_from_flax(load_params_npz(DISK_SYNTH))
    assert "down_0.gate.weight" not in dstate and dstate["up_3.gate.weight"].shape == (80,)
    assert set(dstate) == set(Disk().state_dict())
    with pytest.raises(ValueError):
        SuperPoint()(torch.zeros((1, 1, 60, 96)))
    with pytest.raises(ValueError):
        Disk()(torch.zeros((1, 3, 64, 88)))


def _assert_features_equal(got: Features, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.uv.numpy(), np.asarray(want.uv))
    np.testing.assert_array_equal(got.response.numpy(), np.asarray(want.response))


def _heatmap(seed, h=96, w=128, ties=False):
    rng = np.random.default_rng(seed)
    hm = rng.random((h, w)).astype(np.float32) * 0.2
    ys, xs = rng.integers(0, h, 60), rng.integers(0, w, 60)
    hm[ys, xs] = 0.5 + rng.random(60).astype(np.float32) * 0.5
    if ties:
        hm = np.round(hm * 8) / 8  # plateaus of exactly equal values
    return hm.astype(np.float32)


# Existing features: none, interior, fractional, at the border.
EXISTING = {
    "none": [],
    "interior": [(32.0, 32.0), (64.0, 48.0)],
    "fractional_and_border": [(20.5, 30.7), (0.4, 95.6), (127.0, 3.2), (70.99, 0.0)],
}


def _options(**kw):
    kw = {"max_number_of_detected_features": 64, **kw}
    return JC.NNDetectorOptions(**kw), from_jax(JC.NNDetectorOptions(**kw))


def _existing(uv, capacity=64):
    arr = np.array(uv, np.float32).reshape(-1, 2)
    return JFeatures.from_numpy(arr, capacity), Features.from_numpy(arr, capacity, device="cpu")


@pytest.mark.parametrize("existing", sorted(EXISTING))
def test_create_nn_mask_equals_jax(existing):
    jopts, topts = _options(invalid_boundary=5)
    jf, tf = _existing(EXISTING[existing])
    want = np.asarray(JN.create_nn_mask((96, 128), jf.uv, jf.valid, jopts))
    got = TN.create_nn_mask((96, 128), tf.uv, tf.valid, topts)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, oracle.create_mask((96, 128), EXISTING[existing], jopts))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "plateaus"])
@pytest.mark.parametrize("existing", sorted(EXISTING))
def test_select_features_from_heatmap_equals_jax(existing, ties):
    jopts, topts = _options(min_feature_distance=6)
    hm = _heatmap(1, ties=ties)
    jf, tf = _existing(EXISTING[existing])
    want = JN.select_features_from_heatmap(jnp.asarray(hm), jf, jopts)
    got = TN.select_features_from_heatmap(torch.from_numpy(hm), tf, topts)
    _assert_features_equal(got, want)
    assert int(got.count) > len(EXISTING[existing]) + 10
    if not ties:
        oracle_uv = np.asarray(oracle.select_features(hm, list(EXISTING[existing]), jopts), np.float32)
        np.testing.assert_array_equal(got.to_numpy()[0], oracle_uv)


def test_sample_descriptor_grid_equals_jax():
    dm = np.random.default_rng(2).normal(size=(12, 16, 32)).astype(np.float32)
    uv = np.array([
        (3.5, 9.0), (100.0, 60.0), (127.9, 95.9), (0.0, 0.0),
        (5.0, -0.5), (-0.5, 5.0), (-7.9, -7.9), (-8.0, 4.0),  # rows / cols in (-1, 0) read cell 0
        (120.0, 87.99), (119.99, 88.0), (112.0, 88.0), (88.0, 112.0),  # last row and column
        (37.25, 61.125), (13.0, 77.0),
    ], np.float32)
    want = np.asarray(JN.sample_descriptor_grid(jnp.asarray(dm), jnp.asarray(uv)))
    got = TN.sample_descriptor_grid(torch.from_numpy(dm), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, want, atol=DESC_ATOL, rtol=0)
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (got[4:7] != 0).all() and (got[7] == 0).all()
    np.testing.assert_allclose(got, oracle.sample_descriptors(dm, [tuple(p) for p in uv]), atol=DESC_ATOL)


def _isolated_peaks():
    hm = np.zeros((96, 128), np.float32)
    for v, u, s in ((20, 24, 0.9), (60, 80, 0.8), (40, 100, 0.7)):
        hm[v, u] = s
    return hm


def _suppressed_neighbour():
    hm = np.zeros((64, 64), np.float32)
    hm[30, 30], hm[31, 32], hm[30, 50] = 0.9, 0.8, 0.7
    return hm


def _flat_ties():
    """Equal plateaus: every pixel of a flat region is its own local max."""
    hm = np.full((48, 64), 0.02, np.float32)
    hm[10:14, 10:14] = 0.5
    hm[30, 5:60:7] = 0.5
    hm[40:44, 40:60] = 0.25
    return hm


NMS_MAPS = {
    "isolated_peaks": (_isolated_peaks, 16),
    "suppressed_neighbour": (_suppressed_neighbour, 8),
    "flat_ties": (_flat_ties, 64),
    "random_plateaus": (lambda: _heatmap(3, 64, 96, ties=True), 256),
}


@pytest.mark.parametrize("case", sorted(NMS_MAPS))
def test_nms_head_equals_jax(case):
    make, k = NMS_MAPS[case]
    hm = make()
    hc, wc = hm.shape[0] // 8, hm.shape[1] // 8
    dm = np.random.default_rng(0).random((hc, wc, 32)).astype(np.float32)
    jk, js, jd = jax_nms_head(jnp.asarray(hm), jnp.asarray(dm), k=k, min_response=0.01)
    tk, ts, td = nms_head(torch.from_numpy(hm), torch.from_numpy(dm), k=k, min_response=0.01)
    assert tk.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=DESC_ATOL, rtol=0)
    assert int((ts > 0).sum()) >= 2


def _candidates(rng, rows, cols, k, levels=None):
    """Distinct pixels in descending score order, equal scores in row-major
    order (the order nms_head emits), with a zero-score tail."""
    flat = rng.choice(rows * cols, k, replace=False)
    scores = rng.random(k).astype(np.float32) if levels is None else rng.choice(np.float32(levels), k)
    scores[-k // 8:] = 0.0
    order = np.lexsort((flat, -scores))
    flat, scores = flat[order], scores[order]
    kpts = np.stack([flat % cols, flat // cols], 1).astype(np.int32)
    return kpts, scores.astype(np.float32)


# name: (capacity, min distance, boundary, existing uv, score levels or None)
DIRECT_CASES = {
    "plain": (32, 6, 3, [], None),
    "fractional_existing": (32, 6, 3, [(30.5, 40.5), (64.7, 20.2), (6.5, 90.0)], None),
    "capacity_exhausted": (12, 4, 3, [(50.0, 50.0)], None),
    "wide_band": (48, 5, 20, [], None),
    "equal_scores": (48, 5, 3, [(10.25, 10.75)], [0.25, 0.5, 0.5, 0.75]),
}


@pytest.mark.parametrize("case", sorted(DIRECT_CASES))
def test_directly_select_features_equals_jax_and_oracle(case):
    capacity, r, b, existing, levels = DIRECT_CASES[case]
    rows, cols = 96, 128
    kpts, scores = _candidates(np.random.default_rng(7), rows, cols, 200, levels)
    descs = np.random.default_rng(8).normal(size=(200, 16)).astype(np.float32)
    jopts, topts = _options(max_number_of_detected_features=capacity, min_feature_distance=r, invalid_boundary=b)
    jf, tf = _existing(existing, capacity)
    want_f, want_d = JN.directly_select_features(jnp.asarray(kpts), jnp.asarray(scores), jnp.asarray(descs),
                                                 jf, jopts, rows, cols)
    before = greedy_select.launches
    got_f, got_d = TN.directly_select_features(torch.from_numpy(kpts), torch.from_numpy(scores),
                                               torch.from_numpy(descs), tf, topts, rows, cols)
    assert greedy_select.launches == before  # CPU tensors take the plain version
    _assert_features_equal(got_f, want_f)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    picked = oracle.direct_select(kpts, scores, existing, jopts, rows, cols)
    n = len(existing)
    np.testing.assert_array_equal(got_f.to_numpy()[0][n:], kpts[picked].astype(np.float32))
    np.testing.assert_array_equal(got_d.numpy()[n : n + len(picked)], descs[picked])
    assert len(picked) >= 5
    if case == "capacity_exhausted":
        assert int(got_f.count) == capacity


FRAME_H, FRAME_W = 128, 160  # 120 rows is no multiple of DISK's 16


@pytest.fixture(scope="module")
def frame():
    return synth_frame(31, FRAME_H, FRAME_W)


@pytest.mark.parametrize("model_type", list(NNModelType), ids=lambda t: t.name.lower())
def test_detect_equals_jax(frame, model_type):
    """Packaged weights, bf16 on both sides: the port's maps within the
    bf16 forward tolerance; its post-processing fed JAX's own maps gives
    JAX's features exactly (descriptors within DESC_ATOL); an incremental
    call keeps the prefix."""
    kw = dict(max_image_rows=FRAME_H, max_image_cols=FRAME_W, model_type=JC.NNModelType[model_type.name])
    jopts, topts = JC.NNDetectorOptions(**kw), from_jax(JC.NNDetectorOptions(**kw))
    jdet = JN.NNFeaturePointDetector(jopts)
    jdet.initialize()
    want_f, want_d = jdet.detect(jnp.asarray(frame))
    heat, desc = jdet._apply(jdet.params, jdet._pre(jnp.asarray(frame)))
    jheat, jdesc = heat[0], desc[0]
    if jdesc.shape[0] == FRAME_H:  # DISK: pooled as the JAX detector pools
        jdesc = jax.lax.reduce_window(jdesc, 0.0, jax.lax.add, (8, 8, 1), (8, 8, 1), "VALID") / 64.0
    jheat, jdesc = np.asarray(jheat), np.asarray(jdesc)

    det = TN.NNFeaturePointDetector(topts, device="cpu")
    assert det.initialize()
    heatmap, desc_map = det.maps(frame)
    model = "superpoint" if "SUPERPOINT" in model_type.name else "disk"
    heat_tol, desc_tol = FORWARD_TOL[model, "bfloat16"]
    np.testing.assert_allclose(heatmap.numpy(), jheat, atol=heat_tol, rtol=0)
    np.testing.assert_allclose(desc_map.numpy(), jdesc, atol=desc_tol, rtol=0)

    got_f, got_d = TN.postprocess(torch.from_numpy(jheat), torch.from_numpy(np.asarray(jdesc, np.float32)),
                                  Features.empty(240, "cpu"), topts)
    _assert_features_equal(got_f, want_f)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=DESC_ATOL, rtol=0)
    assert int(got_f.count) >= 8

    feats, descs = det.detect(frame)
    assert feats.uv.shape == (240, 2) and descs.shape == (240, 256 if model == "superpoint" else 128)
    n = int(feats.count) // 2
    keep = torch.arange(240) < n
    existing = Features(feats.uv * keep[:, None], feats.response * keep, feats.valid & keep)
    inc, _ = det.detect(np.roll(frame, 3, axis=1), existing)
    assert torch.equal(inc.uv[:n], existing.uv[:n]) and bool(inc.valid[:n].all()) and int(inc.count) > n
    new = inc.uv[n : int(inc.count)]
    assert not ((new[:, None, :] - existing.uv[None, :n, :]).abs() <= topts.min_feature_distance).all(-1).any()
