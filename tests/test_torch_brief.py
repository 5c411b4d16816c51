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
    img = np.tile(np.arange(40, dtype=np.uint8) * 5, (40, 1))  # a horizontal ramp
    words, valid = brief_compute(torch.from_numpy(img), torch.tensor([[20.0, 20.0], [5.0, 5.0]]),
                                 torch.ones(2, dtype=torch.bool), TC.BriefOptions(method="gather"))
    assert words.shape == (2, 8) and valid.tolist() == [True, False]
    assert words[0].any() and not words[1].any()


GATHER_EPS = 1e-3  # |v1 - v2| below which a gather bit may differ from the JAX package's


def _jax_gather_reads(image, uv, opts):
    """The JAX package's two bilinear reads (v1, v2) of every test, computed
    as its brief_compute_gather computes them, for the excusal rule."""
    import jax

    from feature_detector_tpu.kernels.brief import K_ZERO_FLOAT, _preblur, bilinear_sample

    @jax.jit
    def reads(image, uv):
        img = _preblur(image.astype(jnp.float32), opts.blur_sigma)
        rows, cols = image.shape
        half = opts.half_patch_size
        mb = max(19.0, 2.0 * half)
        xs, ys = jnp.clip(uv[:, 0], mb, cols - mb), jnp.clip(uv[:, 1], mb, rows - mb)
        d = np.arange(-half, half + 1, dtype=np.float32)
        dxg, dyg = (jnp.asarray(g.reshape(-1)) for g in np.meshgrid(d, d, indexing="xy"))
        if opts.upright:
            sin_t, cos_t = jnp.zeros_like(xs), jnp.ones_like(xs)
        else:
            patch = bilinear_sample(img, ys[:, None] + dyg[None, :], xs[:, None] + dxg[None, :])
            m10, m01 = jnp.sum(dxg[None, :] * patch, axis=1), jnp.sum(dyg[None, :] * patch, axis=1)
            m = jnp.sqrt(m01 * m01 + m10 * m10)
            m_safe = jnp.where(m >= K_ZERO_FLOAT, m, 1.0)
            sin_t, cos_t = m01 / m_safe, m10 / m_safe
        pat = jnp.asarray(JAX_PATTERN[: opts.length].astype(np.float32))
        c, s = cos_t[:, None], sin_t[:, None]
        v1 = bilinear_sample(img, s * pat[:, 0] + c * pat[:, 1] + ys[:, None], c * pat[:, 0] - s * pat[:, 1] + xs[:, None])
        v2 = bilinear_sample(img, s * pat[:, 2] + c * pat[:, 3] + ys[:, None], c * pat[:, 2] - s * pat[:, 3] + xs[:, None])
        return v1, v2

    return [np.asarray(v) for v in reads(jnp.asarray(image), jnp.asarray(uv))]


def _bits(words, length):
    return ((words[..., None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(*words.shape[:-1], -1)[..., :length]


@pytest.mark.parametrize(
    "opts_kw",
    [{}, {"upright": True}, {"blur_sigma": 2.0}, {"length": 128}],
    ids=["steered", "upright", "blur2", "length128"],
)
def test_gather_words_equal_jax(frames, opts_kw):
    """The continuous-angle path against the JAX package's brief_compute_gather
    on float centres (a batch, and each frame alone).  Valid flags are
    equal; a bit may differ only where JAX's own reads lie within
    GATHER_EPS of each other (float sums in another order)."""
    from feature_detector_tpu.kernels.brief import brief_compute_gather

    jopts, topts = BriefOptions(**opts_kw), TC.BriefOptions(method="gather", **opts_kw)
    uv, valid = _centres(21)
    uv[5:8] = [[125.3, 80.7], [110.9, 70.2], [140.5, 95.5]]  # fractional centres in the flat block
    ub = np.broadcast_to(uv, (len(frames),) + uv.shape).copy()
    vb = np.broadcast_to(valid, (len(frames),) + valid.shape).copy()
    got_w, got_v = brief_compute(torch.from_numpy(frames), torch.from_numpy(ub), torch.from_numpy(vb), topts)
    got_w = words_to_numpy(got_w)
    excused = 0
    for i, f in enumerate(frames):
        want_w, want_v = brief_compute_gather(jnp.asarray(f), jnp.asarray(uv), jnp.asarray(valid), jopts)
        want_w, want_v = np.asarray(want_w), np.asarray(want_v)
        np.testing.assert_array_equal(got_v.numpy()[i], want_v)
        assert want_v.sum() >= 20
        differ = _bits(got_w[i], jopts.length) != _bits(want_w, jopts.length)
        if differ.any():
            v1, v2 = _jax_gather_reads(f, uv, jopts)
            close = np.abs(v1 - v2) < GATHER_EPS
            assert not (differ & ~close).any(), np.argwhere(differ & ~close)
            excused += int(differ.sum())
        one_w, one_v = brief_compute(torch.from_numpy(f), torch.from_numpy(uv), torch.from_numpy(valid), topts)
        np.testing.assert_array_equal(words_to_numpy(one_w), got_w[i])
        np.testing.assert_array_equal(one_v.numpy(), got_v.numpy()[i])
    print(f"gather bits excused (|v1 - v2| < {GATHER_EPS}): {excused}")
    assert not got_w[~got_v.numpy()].any()


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
