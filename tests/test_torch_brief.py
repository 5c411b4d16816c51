"""Steered BRIEF of the port against the JAX package's default path
(brief_compute_mxu), bit for bit, on the CPU.

The one excusal: torch's and XLA's float32 atan2 may differ by an ulp, so a
feature whose theta * bins / 2pi lies within 1e-4 of a half-integer may land
in the neighbouring steering bin; only such features are excused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_detector_tpu.core.config import BriefOptions
from feature_detector_tpu.kernels.brief import brief_compute_mxu
from feature_detector_tpu.oracle.brief_pattern import BRIEF_PATTERN as JAX_PATTERN
from feature_detector_tpu_torch.core import config as TC
from feature_detector_tpu_torch.core.convert import brief_pattern_from_numpy
from feature_detector_tpu_torch.core.types import words_to_numpy
from feature_detector_tpu_torch.kernels.brief import brief_compute
from feature_detector_tpu_torch.kernels.brief_pattern import BRIEF_PATTERN
from tests.torch_port_inputs import synth_stack

H, W = 120, 160


@pytest.fixture(scope="module")
def frames():
    f = synth_stack((4, 5, 6))
    f[2, 60:100, 100:150] = 77  # a flat block: zero moment there
    return f


def _centres(seed, n=40):
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1).astype(np.float32)
    # Border cases around the bound of 19 and the clip to [18, size-19],
    # half-integers (round half to even) and the flat block's centre.
    extra = [[18, 60], [19, 60], [W - 19, 60], [W - 18, 60], [80, 18.5], [80, H - 19.5],
             [40.5, 50.5], [41.5, 51.5], [125, 80], [0, 0]]
    uv = np.concatenate([uv, np.asarray(extra, np.float32)])
    valid = np.ones(len(uv), bool)
    valid[3] = valid[-1] = False
    return uv, valid


def _near_bin_boundary(image, uv, bins):
    """Features whose theta * bins / 2pi is within 1e-4 of a half-integer
    (theta from the same integer moments, in float64)."""
    img = image.astype(np.int64)
    x = np.clip(np.round(uv[:, 0]).astype(np.int64), 18, W - 19)
    y = np.clip(np.round(uv[:, 1]).astype(np.int64), 18, H - 19)
    d = np.arange(-8, 9)
    out = np.zeros(len(uv), bool)
    for i in range(len(uv)):
        p = img[y[i] - 8 : y[i] + 9, x[i] - 8 : x[i] + 9]
        m10, m01 = (p * d[None, :]).sum(), (p * d[:, None]).sum()
        t = np.arctan2(m01, m10) * bins / (2 * np.pi)
        out[i] = abs(abs(t - np.floor(t)) - 0.5) < 1e-4
    return out


def _blurred(image, sigma):
    """The JAX package's blurred image (what both sides sample)."""
    from feature_detector_tpu.kernels.brief import _preblur

    return np.asarray(_preblur(jnp.asarray(image, jnp.float32), sigma))


def _check(frames, opts_kw, seed):
    jopts, topts = BriefOptions(**opts_kw), TC.BriefOptions(**opts_kw)
    uv, valid = _centres(seed)
    ub = np.broadcast_to(uv, (len(frames),) + uv.shape).copy()
    vb = np.broadcast_to(valid, (len(frames),) + valid.shape).copy()
    got_w, got_v = brief_compute(torch.from_numpy(frames), torch.from_numpy(ub), torch.from_numpy(vb), topts)
    got_w = words_to_numpy(got_w)
    excused = 0
    for i, f in enumerate(frames):
        want_w, want_v = brief_compute_mxu(jnp.asarray(f), jnp.asarray(uv), jnp.asarray(valid), jopts)
        want_w, want_v = np.asarray(want_w), np.asarray(want_v)
        np.testing.assert_array_equal(got_v.numpy()[i], want_v)
        assert want_w.dtype == np.uint32 and want_v.sum() >= 20
        differ = (got_w[i] != want_w).any(axis=1)
        if differ.any():
            bins = 1 if jopts.upright else jopts.steer_bins
            boundary = _near_bin_boundary(_blurred(f, jopts.blur_sigma), uv, bins)
            assert not (differ & ~boundary).any(), np.nonzero(differ & ~boundary)
            excused += int(differ.sum())
        # One frame alone gives the same words as its row of the batch.
        one_w, one_v = brief_compute(torch.from_numpy(f), torch.from_numpy(uv), torch.from_numpy(valid), topts)
        np.testing.assert_array_equal(words_to_numpy(one_w), got_w[i])
        np.testing.assert_array_equal(one_v.numpy(), got_v.numpy()[i])
    return got_w, got_v.numpy(), excused


@pytest.mark.parametrize(
    "opts_kw",
    [{}, {"upright": True}, {"blur_sigma": 2.0}, {"length": 128}],
    ids=["steered", "upright", "blur2", "length128"],
)
def test_words_equal_jax_mxu(frames, opts_kw):
    words, valid, excused = _check(frames, opts_kw, seed=11)
    assert excused <= 1
    assert not words[~valid].any()  # invalid rows are all zero


def test_border_and_flat_patch_invalid(frames):
    uv, valid = _centres(12)
    _, got_v = brief_compute(torch.from_numpy(frames[2]), torch.from_numpy(uv), torch.from_numpy(valid), TC.BriefOptions())
    got_v = got_v.numpy()
    n = len(uv) - 10
    assert not got_v[n + 0]  # x = 18 < 19
    assert got_v[n + 1] and got_v[n + 2]  # x = 19 and x = cols - 19
    assert not got_v[n + 3]  # x = cols - 18
    assert not got_v[n + 8]  # the flat block's centre has zero moment
    assert not got_v[-1]  # an empty slot


def test_blur_reaches_the_reads(frames):
    """blur_sigma must change the words (it was once a silent no-op in the
    JAX package's MXU path)."""
    uv, valid = _centres(13)
    args = (torch.from_numpy(frames[0]), torch.from_numpy(uv), torch.from_numpy(valid))
    w0, v0 = brief_compute(*args, TC.BriefOptions())
    w2, v2 = brief_compute(*args, TC.BriefOptions(blur_sigma=2.0))
    both = (v0 & v2).numpy()
    assert both.sum() >= 10
    assert not np.array_equal(w0.numpy()[both], w2.numpy()[both])


def test_pattern_copy_and_gather_path():
    np.testing.assert_array_equal(brief_pattern_from_numpy(JAX_PATTERN).numpy(), BRIEF_PATTERN)
    with pytest.raises(NotImplementedError):
        brief_compute(torch.zeros((40, 40), dtype=torch.uint8), torch.zeros((1, 2)), torch.ones(1, dtype=torch.bool),
                      TC.BriefOptions(method="gather"))


def test_preblur_differs_from_xla_only_by_rare_rounding():
    """The blur's float sums run in another order than XLA's convolution,
    so a pixel whose blurred value sits within an ulp of a half-integer may
    round the other way (ROADMAP queue 3).  Pin how rare and how small."""
    from feature_detector_tpu.kernels.brief import _preblur as jax_preblur
    from feature_detector_tpu_torch.kernels.brief import _preblur

    frames = synth_stack((10, 11), 240, 320)
    got = _preblur(torch.from_numpy(frames).to(torch.float32), 2.0).numpy()
    for i, f in enumerate(frames):
        want = np.asarray(jax_preblur(jnp.asarray(f, jnp.float32), 2.0))
        diff = np.abs(got[i] - want)
        assert diff.max() <= 1.0
        assert (diff > 0).sum() <= 1e-4 * diff.size
