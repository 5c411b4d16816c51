"""Tests of the port that need a CUDA card (marked ``gpu``); each skips
without one.  Run them on the card with

    python -m pytest -m gpu tests/test_torch_gpu.py

This file imports nothing of the JAX package, so it also runs where flax is
not installed; the card's results are held against the port's CPU path,
which the other tests/test_torch_*.py files hold against the JAX package.
"""

import numpy as np
import pytest
import torch

from feature_detector_tpu_torch.core.config import DetectorOptions
from feature_detector_tpu_torch.core.types import Features
from feature_detector_tpu_torch.frontend.descriptor import compute_descriptors
from feature_detector_tpu_torch.frontend.detector import detect_good_features, detect_good_features_batch
from feature_detector_tpu_torch.kernels.detect import greedy_select_ref
from feature_detector_tpu_torch.kernels.greedy import greedy_select
from feature_detector_tpu_torch.match.hamming import match_hamming
from feature_detector_tpu_torch.models.synth_data import scene_uint8, synth_scene

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_greedy_kernel_equals_ref(cuda):
    rng = np.random.default_rng(1)
    maps = rng.random((6, 96, 150), np.float32)
    maps[maps < 0.7] = 0.0
    maps[:, 40, 10:20] = 2.0  # ties in a row
    maps[2] = 0.0
    n_stop = torch.tensor([40, 5, 40, 0, 40, 17], dtype=torch.int32, device=cuda)
    cand = torch.from_numpy(maps).to(cuda)
    before = greedy_select.launches
    got = greedy_select(cand, 40, n_stop, 6)
    torch.cuda.synchronize()
    assert greedy_select.launches == before + 1
    want = greedy_select_ref(cand, 40, n_stop, 6)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    one = greedy_select(cand[0], 40, 40, 6)
    for g, w in zip(one, want):
        assert torch.equal(g, w[0])
    assert torch.equal(cand.cpu(), torch.from_numpy(maps))  # the caller's map is untouched


def test_greedy_wrapper_rejects_bad_input(cuda):
    with pytest.raises(TypeError):
        greedy_select(torch.zeros((8, 8), dtype=torch.float64, device=cuda), 2, 2, 1)
    with pytest.raises(ValueError):
        greedy_select(torch.zeros((8, 16), device=cuda).t(), 2, 2, 1)
    with pytest.raises(ValueError):
        greedy_select(torch.zeros((2, 8, 8), device=cuda), 2, torch.zeros(3, dtype=torch.int32, device=cuda), 1)


def test_slice_on_card_equals_cpu(cuda):
    frames = np.stack([scene_uint8(synth_scene(np.random.default_rng(s), 120, 160, rich_background=True)[0])
                       for s in (20, 21, 22)])
    opts = DetectorOptions(min_feature_distance=10, min_valid_response=10.0, max_features=64)
    out = {}
    for dev in ("cpu", cuda):
        a = torch.from_numpy(frames).to(dev)
        b = torch.roll(a, 3, dims=2)
        fa = detect_good_features_batch(a, "fast", 40, opts)
        fb = detect_good_features_batch(b, "fast", 40, opts)
        da, db = compute_descriptors(a, fa), compute_descriptors(b, fb)
        m = match_hamming(da.words, da.valid, db.words, db.valid)
        inc = detect_good_features(b[0], Features(fa.uv[0], fa.response[0], fa.valid[0] & (torch.arange(64, device=dev) < 5)),
                                   "fast", 40, opts)
        out[str(dev)] = [t.cpu() for t in (fa.uv, fa.valid, fb.uv, da.words, da.valid, db.words, m.index,
                                           m.distance, m.valid, inc.uv, inc.valid)]
    for g, w in zip(out["cuda"], out["cpu"]):
        assert torch.equal(g, w)
    assert int(out["cpu"][1].sum()) >= 30
