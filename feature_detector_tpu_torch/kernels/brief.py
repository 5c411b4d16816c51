"""Steered BRIEF in PyTorch, with the semantics of the JAX package's default
path (``brief_compute_mxu``, feature_detector_tpu/kernels/brief.py:141).

On the TPU that path is a chain of one-hot and +/-1 matrix products, a form
chosen because gathers are slow there.  On the GPU a gather is the natural
form, so this module reads the pixels it needs directly; the bits are the
same:

- centres are rounded half-to-even; ``in_border`` uses a bound of 19 and
  centres are clipped to [18, size-19] so that every read stays inside;
- the steering angle comes from integer moments over the centred 17x17
  window, quantised to ``steer_bins`` (a single bin when upright); a zero
  moment makes the descriptor invalid;
- rotated test offsets are ``np.rint`` of the rotated pattern, precomputed
  per bin;
- bit = I(p2) > I(p1), packed so that bit j of word w is test 32w+j; words
  are int32 tensors holding the uint32 bits; invalid rows are all zero.

``brief_compute_gather`` is the JAX package's continuous-angle path: float
centres, a steering angle from bilinear moments over the
(2 half_patch_size + 1)^2 window, and bilinear reads of the rotated pattern.
Its float sums run in another order than XLA's, so a bit whose two reads lie
within float32 rounding of each other may differ from the JAX package's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.config import BriefOptions
from ..utils import trace
from .brief_pattern import BRIEF_PATTERN

K_ZERO_FLOAT = 1e-10
PATCH_HALF = 18  # rotated, rounded offsets stay within +/-18
MOMENT_HALF = 8  # centred 17x17 intensity-centroid window


@functools.lru_cache(maxsize=8)
def _rotated_offsets(length: int, bins: int) -> np.ndarray:
    """[bins, length, 4] int64 (p1x, p1y, p2x, p2y): the pattern rotated by
    2*pi*b/bins and rounded to pixels, as ``_build_sampling_matrix`` builds it."""
    pat = BRIEF_PATTERN[:length].astype(np.float64)
    out = np.zeros((bins, length, 4), np.int64)
    for b in range(bins):
        theta = 2.0 * np.pi * b / bins
        c, s = np.cos(theta), np.sin(theta)
        out[b, :, 0] = np.rint(c * pat[:, 0] - s * pat[:, 1])
        out[b, :, 1] = np.rint(s * pat[:, 0] + c * pat[:, 1])
        out[b, :, 2] = np.rint(c * pat[:, 2] - s * pat[:, 3])
        out[b, :, 3] = np.rint(s * pat[:, 2] + c * pat[:, 3])
    if np.abs(out).max() > PATCH_HALF:
        raise ValueError("rotated BRIEF offsets exceed the 37x37 patch")
    return out


@functools.lru_cache(maxsize=8)
def _gauss_kernel(sigma: float) -> np.ndarray:
    radius = int(np.ceil(2.5 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-x * x / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _preblur(img_f32: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with zero ("SAME") padding over the last two
    dims, rounded to integers.  Written as shifted multiply-adds, so no
    convolution library (and no TF32) is involved."""
    if sigma <= 0.0:
        return img_f32
    k = [float(v) for v in _gauss_kernel(sigma)]
    r = (len(k) - 1) // 2
    rows, cols = img_f32.shape[-2:]
    p = torch.nn.functional.pad(img_f32, (r, r, 0, 0))
    x = sum(k[t] * p[..., :, t : t + cols] for t in range(len(k)))
    p = torch.nn.functional.pad(x, (0, 0, r, r))
    x = sum(k[t] * p[..., t : t + rows, :] for t in range(len(k)))
    return torch.round(x)


def _pack_words(bits: torch.Tensor, opts: BriefOptions) -> torch.Tensor:
    """[..., length] {0,1} -> [..., words] int32 with the uint32 bits:
    bit j of word w = test 32*w+j.  Packed in int64, then wrapped to int32."""
    lead = bits.shape[:-1]
    padded = torch.zeros((*lead, opts.words * 32), dtype=torch.int64, device=bits.device)
    padded[..., : opts.length] = bits.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (padded.view(*lead, opts.words, 32) << shifts).sum(dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def brief_compute_mxu(
    image: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    opts: BriefOptions = BriefOptions(),
):
    """Steered BRIEF with integer centres, binned angles and rounded offsets.

    Args:
      image: [H, W] or [B, H, W] uint8.
      uv: [N, 2] or [B, N, 2] f32 (x, y).
      valid: [N] or [B, N] bool slot occupancy.

    Returns (words [.., N, opts.words] int32, desc_valid [.., N] bool).  The
    name is the JAX package's; here the reads are gathers.
    """
    single = image.dim() == 2
    if single:
        image, uv, valid = image[None], uv[None], valid[None]
    img = _preblur(image.to(torch.float32), opts.blur_sigma)
    bsz, rows, cols = img.shape
    n = uv.shape[-2]
    dev = img.device
    length, bins = opts.length, (1 if opts.upright else opts.steer_bins)

    x = torch.round(uv[..., 0]).to(torch.int32)
    y = torch.round(uv[..., 1]).to(torch.int32)
    max_bound = int(max(19, 2 * opts.half_patch_size))
    in_border = (x >= max_bound) & (x <= cols - max_bound) & (y >= max_bound) & (y <= rows - max_bound)
    xs = torch.clamp(x, PATCH_HALF, cols - PATCH_HALF - 1).to(torch.int64)
    ys = torch.clamp(y, PATCH_HALF, rows - PATCH_HALF - 1).to(torch.int64)
    flat = img.reshape(bsz, rows * cols)
    base = ys * cols + xs  # [B, N]

    def read(offsets: torch.Tensor) -> torch.Tensor:
        # offsets [B, N, K] flat pixel offsets from each centre -> values [B, N, K]
        idx = (base[..., None] + offsets).reshape(bsz, -1)
        return flat.gather(1, idx).reshape(offsets.shape)

    if opts.upright:
        ok_moment = torch.ones((bsz, n), dtype=torch.bool, device=dev)
        bin_idx = torch.zeros((bsz, n), dtype=torch.int64, device=dev)
    else:
        d = torch.arange(-MOMENT_HALF, MOMENT_HALF + 1, device=dev)
        dyg, dxg = torch.meshgrid(d, d, indexing="ij")
        win = read((dyg * cols + dxg).reshape(1, 1, -1).expand(bsz, n, -1)).to(torch.int32)
        m10 = (win * dxg.reshape(-1).to(torch.int32)).sum(-1, dtype=torch.int32).to(torch.float32)
        m01 = (win * dyg.reshape(-1).to(torch.int32)).sum(-1, dtype=torch.int32).to(torch.float32)
        norm = torch.sqrt(m10 * m10 + m01 * m01)
        ok_moment = norm >= K_ZERO_FLOAT
        theta = torch.atan2(m01, m10)
        scale = float(np.float32(bins / (2.0 * np.pi)))
        bin_idx = torch.remainder(torch.round(theta * scale).to(torch.int32), bins).to(torch.int64)

    offs = torch.as_tensor(_rotated_offsets(length, bins), device=dev)[bin_idx]  # [B, N, L, 4]
    v1 = read(offs[..., 1] * cols + offs[..., 0])
    v2 = read(offs[..., 3] * cols + offs[..., 2])
    desc_valid = valid & in_border & ok_moment
    bits = (v2 > v1) & desc_valid[..., None]
    words = _pack_words(bits, opts)
    if single:
        return words[0], desc_valid[0]
    return words, desc_valid


def bilinear_sample(image_f32: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear sample at float (row, col) coordinates of an [H, W] image
    (``ys``, ``xs`` of any shape) or a [B, H, W] stack (``ys``, ``xs`` of
    shape [B, ...]).  Callers keep the reads inside (the 19-px BRIEF
    border); indices are clipped anyway."""
    single = image_f32.dim() == 2
    img = image_f32[None] if single else image_f32
    if single:
        ys, xs = ys[None], xs[None]
    bsz, rows, cols = img.shape
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, rows - 2)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, cols - 2)
    wy = ys - y0.to(torch.float32)
    wx = xs - x0.to(torch.float32)
    flat = img.reshape(bsz, rows * cols)
    base = (y0 * cols + x0).reshape(bsz, -1)

    def at(offset: int) -> torch.Tensor:
        return flat.gather(1, base + offset).reshape(ys.shape)

    # v00 (1-wy)(1-wx) + v01 (1-wy) wx + v10 wy (1-wx) + v11 wy wx, with the
    # three fused multiply-adds that XLA's CPU compiler forms for it (the
    # same bits on 200k random reads): a flat patch then reads the same
    # values as in the JAX package, and so gets the same zero moment.
    uy, ux = 1 - wy, 1 - wx
    out = _fma(at(cols + 1) * wy, wx, _fma(at(cols) * wy, ux, _fma(at(0) * uy, ux, at(1) * uy * wx)))
    return out[0] if single else out


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding (float64 holds ``a * b``
    exactly)."""
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)


def brief_compute_gather(
    image: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    opts: BriefOptions = BriefOptions(),
):
    """Continuous-angle steered BRIEF with bilinear reads (the JAX package's
    reference-parity path, ``brief_compute_gather``).

    Args:
      image: [H, W] or [B, H, W] uint8.
      uv: [N, 2] or [B, N, 2] f32 (x, y).
      valid: [N] or [B, N] bool slot occupancy.

    Returns (words [.., N, opts.words] int32, desc_valid [.., N] bool).
    desc_valid is False for empty slots, out-of-border features and
    zero-moment patches; their words are all zero.
    """
    single = image.dim() == 2
    if single:
        image, uv, valid = image[None], uv[None], valid[None]
    img = _preblur(image.to(torch.float32), opts.blur_sigma)
    rows, cols = img.shape[-2:]
    dev = img.device
    half = opts.half_patch_size

    x, y = uv[..., 0], uv[..., 1]
    max_bound = max(19.0, 2.0 * half)
    in_border = (x >= max_bound) & (x <= cols - max_bound) & (y >= max_bound) & (y <= rows - max_bound)
    # Clamp centres so that the reads of rejected features stay inside.
    xs = torch.clamp(x, max_bound, cols - max_bound)
    ys = torch.clamp(y, max_bound, rows - max_bound)

    if opts.upright:
        ok_moment = torch.ones_like(valid)
        sin_t = torch.zeros_like(xs)
        cos_t = torch.ones_like(xs)
    else:
        # Intensity-centroid orientation over the (2*half+1)^2 window
        # (descriptor_brief.cpp:20-35), row-major as np.meshgrid "xy" gives it.
        d = torch.arange(-half, half + 1, dtype=torch.float32, device=dev)
        dyg, dxg = (g.reshape(-1) for g in torch.meshgrid(d, d, indexing="ij"))
        patch = bilinear_sample(img, ys[..., None] + dyg, xs[..., None] + dxg)
        m10 = (dxg * patch).sum(-1)
        m01 = (dyg * patch).sum(-1)
        m = torch.sqrt(m01 * m01 + m10 * m10)
        ok_moment = m >= np.float32(K_ZERO_FLOAT)
        m_safe = torch.where(ok_moment, m, 1.0)
        sin_t = m01 / m_safe
        cos_t = m10 / m_safe

    # Rotate the test pairs and sample (descriptor_brief.cpp:38-47).
    pat = torch.as_tensor(BRIEF_PATTERN[: opts.length].astype(np.float32), device=dev)
    c, s = cos_t[..., None], sin_t[..., None]
    p1x = c * pat[:, 0] - s * pat[:, 1] + xs[..., None]
    p1y = s * pat[:, 0] + c * pat[:, 1] + ys[..., None]
    p2x = c * pat[:, 2] - s * pat[:, 3] + xs[..., None]
    p2y = s * pat[:, 2] + c * pat[:, 3] + ys[..., None]
    v1 = bilinear_sample(img, p1y, p1x)
    v2 = bilinear_sample(img, p2y, p2x)

    desc_valid = valid & in_border & ok_moment
    words = _pack_words((v1 < v2) & desc_valid[..., None], opts)
    if single:
        return words[0], desc_valid[0]
    return words, desc_valid


def brief_compute(
    image: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    opts: BriefOptions = BriefOptions(),
):
    """Steered-BRIEF dispatch on ``opts.method``: "mxu" (the default,
    integer centres and binned angles) or "gather" (continuous angle,
    bilinear reads)."""
    with trace.span("frontend.describe"):
        if opts.method == "mxu":
            return brief_compute_mxu(image, uv, valid, opts)
        if opts.method == "gather":
            return brief_compute_gather(image, uv, valid, opts)
    raise ValueError(f"unknown BRIEF method: {opts.method!r}")
