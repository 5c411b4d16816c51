"""The port's slice end to end against the JAX package on the CPU: detect
(FAST, greedy selection) -> steered BRIEF -> cross-checked Hamming, plus the
incremental path with JAX-detected features carried across and the import
boundary.  The tests that need the card are in test_torch_gpu.py."""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import feature_detector_tpu.core.config as JC
from feature_detector_tpu.core.types import Features as JFeatures
from feature_detector_tpu.frontend.detector import detect_good_features as jax_detect
from feature_detector_tpu.frontend.detector import detect_good_features_batch as jax_detect_batch
from feature_detector_tpu.frontend.detector import sparsify_features as jax_sparsify
from feature_detector_tpu.kernels.brief import brief_compute as jax_brief
from feature_detector_tpu.match.hamming import match_hamming as jax_match
from feature_detector_tpu_torch.core import config as TC
from feature_detector_tpu_torch.core.convert import from_jax
from feature_detector_tpu_torch.core.types import Features, words_to_numpy
from feature_detector_tpu_torch.frontend.descriptor import compute_descriptors, compute_descriptors_float
from feature_detector_tpu_torch.frontend.detector import (
    detect_good_features,
    detect_good_features_batch,
    sparsify_features,
)
from feature_detector_tpu_torch.match.hamming import match_hamming
from tests.torch_port_inputs import synth_stack

OPTS = dict(min_feature_distance=10, min_valid_response=10.0, max_features=64)


def _assert_features_equal(got: Features, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.uv.numpy(), np.asarray(want.uv))
    np.testing.assert_array_equal(got.response.numpy(), np.asarray(want.response))


@pytest.fixture(scope="module")
def frames():
    a = synth_stack((20, 21, 22))
    return a, np.roll(a, 3, axis=2)


def test_slice_end_to_end_equals_jax(frames):
    frames_a, frames_b = frames
    jopts, topts = JC.DetectorOptions(**OPTS), TC.DetectorOptions(**OPTS)
    words, valids = {}, {}
    for key, stack in (("a", frames_a), ("b", frames_b)):
        want = jax_detect_batch(jnp.asarray(stack), "fast", 40, jopts, use_pallas=True)
        got = detect_good_features_batch(torch.from_numpy(stack), "fast", 40, topts)
        _assert_features_equal(got, want)
        assert got.count.min() >= 10
        d = compute_descriptors(torch.from_numpy(stack), got)
        for i in range(len(stack)):
            ww, wv = jax_brief(jnp.asarray(stack[i]), want.uv[i], want.valid[i], JC.BriefOptions())
            np.testing.assert_array_equal(words_to_numpy(d.words[i]), np.asarray(ww))
            np.testing.assert_array_equal(d.valid[i].numpy(), np.asarray(wv))
        words[key], valids[key] = d.words, d.valid
    got_m = match_hamming(words["a"], valids["a"], words["b"], valids["b"])
    total = 0
    for i in range(len(frames_a)):
        want_m = jax_match(jnp.asarray(words_to_numpy(words["a"][i])), jnp.asarray(valids["a"][i].numpy()),
                           jnp.asarray(words_to_numpy(words["b"][i])), jnp.asarray(valids["b"][i].numpy()),
                           JC.MatcherOptions())
        np.testing.assert_array_equal(got_m.index[i].numpy(), np.asarray(want_m.index))
        np.testing.assert_array_equal(got_m.distance[i].numpy(), np.asarray(want_m.distance))
        np.testing.assert_array_equal(got_m.valid[i].numpy(), np.asarray(want_m.valid))
        total += int(got_m.valid[i].sum())
    assert total >= 10
    # Batch detection equals per-frame detection from empty.
    for i in range(len(frames_a)):
        one = detect_good_features(torch.from_numpy(frames_a[i]), Features.empty(64, "cpu"), "fast", 40, topts)
        batch = detect_good_features_batch(torch.from_numpy(frames_a[i : i + 1]), "fast", 40, topts)
        np.testing.assert_array_equal(one.uv.numpy(), batch.uv[0].numpy())
        np.testing.assert_array_equal(one.valid.numpy(), batch.valid[0].numpy())


@pytest.mark.parametrize(
    "kind,opt_kw",
    [("fast", {}), ("harris", {"min_valid_response": 30.0}), ("shi_tomasi", {"min_valid_response": 40.0}),
     ("fast", {"subpixel": True})],
    ids=["fast", "harris", "shi_tomasi", "fast_subpixel"],
)
def test_incremental_with_jax_existing(frames, kind, opt_kw):
    """Half of a JAX detection, carried across by core/convert.py, seeds the
    port's incremental re-detect; the result equals the JAX package's."""
    frame = frames[0][0]
    later = frames[1][0]
    jopts = JC.DetectorOptions(**{**OPTS, **opt_kw})
    first = jax_detect(jnp.asarray(frame), JFeatures.empty(64), kind, 30, jopts)
    n = int(np.asarray(first.valid).sum()) // 2
    keep = np.arange(64) < n
    existing = JFeatures(uv=first.uv * keep[:, None], response=first.response * keep, valid=first.valid & keep)
    want = jax_detect(jnp.asarray(later), existing, kind, 50, jopts)
    topts = from_jax(jopts)
    assert topts == TC.DetectorOptions(**{**OPTS, **opt_kw})
    got = detect_good_features(torch.from_numpy(later), from_jax(existing, "cpu"), kind, 50, topts)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    if opt_kw.get("subpixel"):
        np.testing.assert_allclose(got.uv.numpy(), np.asarray(want.uv), atol=1e-5, rtol=0)
    else:
        np.testing.assert_array_equal(got.uv.numpy(), np.asarray(want.uv))
    rtol = 0 if kind == "fast" else 1e-5  # Harris/Shi-Tomasi values: see test_torch_detect
    np.testing.assert_allclose(got.response.numpy(), np.asarray(want.response), rtol=rtol)
    assert n >= 3 and int(got.count) > n
    # compute_descriptors_float is the +/-1 unpacking of the words.
    fl = compute_descriptors_float(torch.from_numpy(later), got).numpy()
    assert set(np.unique(fl)) <= {-1.0, 0.0, 1.0}


def test_sparsify_equals_jax(frames):
    frame = frames[0][1]
    opts = JC.DetectorOptions(**{**OPTS, "grid_filter_row_divide_number": 4, "grid_filter_col_divide_number": 5})
    f = jax_detect(jnp.asarray(frame), JFeatures.empty(64), "fast", 60, opts)
    uv = np.asarray(f.uv).copy()
    uv[5] = (170.0, 10.0)  # out of the grid
    status = np.random.default_rng(0).integers(0, 3, 64).astype(np.int32)
    jf = JFeatures(uv=jnp.asarray(uv), response=f.response, valid=f.valid)
    want = np.asarray(jax_sparsify(jf, jnp.asarray(status), 120, 160, 1, 2, opts))
    got = sparsify_features(from_jax(jf, "cpu"), torch.from_numpy(status), 120, 160, 1, 2, from_jax(opts))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != status).any()


def test_option_and_container_conversion():
    cfg = JC.FrontendConfig(
        detector=JC.DetectorOptions(max_features=99), brief=JC.BriefOptions(upright=True),
        nn=JC.NNDetectorOptions(model_type=JC.NNModelType.DISK_NMS),
    )
    got = from_jax(cfg)
    assert got.detector.max_features == 99 and got.brief.upright
    assert got.nn.model_type is TC.NNModelType.DISK_NMS
    assert dataclasses.asdict(got)["matcher"] == dataclasses.asdict(cfg)["matcher"]
    with pytest.raises(TypeError):
        from_jax(object())


PORT_ONLY_MODULES = ("chip_smoke", "tests.torch_dist_worker", "tests.test_torch_gpu")  # import nothing of JAX


def test_port_imports_no_jax():
    """Every module of the port, found by walking the package, and the
    scripts and test helpers that run where JAX is absent, import neither
    JAX, Flax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import feature_detector_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        f"names += {list(PORT_ONLY_MODULES)!r}\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'feature_detector_tpu')]\n"
        "print(len(names), bad)\nsys.exit(1 if bad or len(names) < 50 else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_device_rule():
    from feature_detector_tpu_torch.core.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            detect_good_features_batch(np.zeros((1, 40, 40), np.uint8), "fast", 4, TC.DetectorOptions())
