"""Classical corner detection in PyTorch: responses, candidates, masks and the
plain greedy selection.

Counterparts of ``feature_detector_tpu/kernels/detect.py``, function by
function, giving the same values.  Every map function takes ``[..., H, W]``
(a batch dimension written out instead of ``vmap``).  These are plain tensor
ops; the one hand kernel of this stage is the greedy selection in
``kernels/greedy.py``, whose plain version ``greedy_select_ref`` lives here.

Exactness notes:

- FAST works in int64: ring masks and the ``x &= x << 1`` run count need
  32-bit unsigned shifts, which PyTorch's uint32 lacks on the CPU.  Its
  response and candidate maps equal the JAX package's exactly.
- ``box_sum`` is written as shifted adds, not a convolution: cuDNN runs
  float32 convolutions in TF32 by default, which would round integer
  gradient products; shifted adds are exact for them (sums < 2^24).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.config import DetectorOptions, FastOptions, HarrisOptions, ShiTomasiOptions

# FAST circle offsets (dcol, drow), feature_point_fast_detector.cpp:7-8.
_FAST_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def box_sum(x: torch.Tensor, half: int) -> torch.Tensor:
    """(2*half+1)^2 zero-padded box sum over the last two dims, as shifted
    adds (separable: rows, then columns)."""
    rows, cols = x.shape[-2:]
    patch = 2 * half + 1
    p = F.pad(x, (half, half, half, half))
    h = sum(p[..., :, k : k + cols] for k in range(patch))
    return sum(h[..., k : k + rows, :] for k in range(patch))


def central_gradients(image_f32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients, zero on the 1-px border
    (feature_point_harris_detector.cpp:36-37)."""
    img = image_f32
    ix = torch.zeros_like(img)
    iy = torch.zeros_like(img)
    ix[..., 1:-1, 1:-1] = img[..., 1:-1, 2:] - img[..., 1:-1, :-2]
    iy[..., 1:-1, 1:-1] = img[..., 2:, 1:-1] - img[..., :-2, 1:-1]
    return ix, iy


def _interior_mask(shape, bound: int, device) -> torch.Tensor:
    rows, cols = shape[-2:]
    m = torch.zeros((rows, cols), dtype=torch.bool, device=device)
    m[bound : rows - bound, bound : cols - bound] = True
    return m


def harris_response_raw(img_f32: torch.Tensor, sub: HarrisOptions) -> torch.Tensor:
    """Pure-stencil Harris response (no border/threshold/mask gating)."""
    half = sub.half_patch_size
    patch = 2 * half + 1
    inv_cnt2 = float(torch.tensor((1.0 / (patch * patch)) ** 2, dtype=torch.float32))
    ix, iy = central_gradients(img_f32)
    sxx = box_sum(ix * ix, half)
    syy = box_sum(iy * iy, half)
    sxy = box_sum(ix * iy, half)
    tr = sxx + syy
    alpha = float(torch.tensor(sub.alpha, dtype=torch.float32))
    return (sxx * syy - sxy * sxy - alpha * tr * tr) * inv_cnt2


def shi_tomasi_response_raw(img_f32: torch.Tensor, sub: ShiTomasiOptions) -> torch.Tensor:
    """Pure-stencil largest-eigenvalue response (quirk Q3 preserved)."""
    half = sub.half_patch_size
    patch = 2 * half + 1
    inv_cnt = float(torch.tensor(1.0 / (patch * patch), dtype=torch.float32))
    ix, iy = central_gradients(img_f32)
    a = box_sum(ix * ix, half) * inv_cnt
    c = box_sum(iy * iy, half) * inv_cnt
    b = box_sum(ix * iy, half) * inv_cnt
    common = torch.sqrt((a - c) * (a - c) + 4.0 * b * b)
    return (a + c + common) * 0.5


def _gate(res: torch.Tensor, image: torch.Tensor, mask: torch.Tensor, bound: int,
          threshold: float) -> torch.Tensor:
    region = _interior_mask(image.shape, bound, image.device)
    keep = region & (mask != 0) & (res > threshold)
    return torch.where(keep, res, torch.zeros((), dtype=res.dtype, device=res.device))


def harris_response(
    image: torch.Tensor,
    mask: torch.Tensor,
    opts: DetectorOptions = DetectorOptions(),
    sub: HarrisOptions = HarrisOptions(),
) -> torch.Tensor:
    """Harris response map with threshold/mask gating
    (feature_point_harris_detector.cpp:66-118)."""
    res = harris_response_raw(image.to(torch.float32), sub)
    return _gate(res, image, mask, sub.half_patch_size + 1, opts.min_valid_response)


def shi_tomasi_response(
    image: torch.Tensor,
    mask: torch.Tensor,
    opts: DetectorOptions = DetectorOptions(),
    sub: ShiTomasiOptions = ShiTomasiOptions(),
) -> torch.Tensor:
    """Largest-eigenvalue response map
    (feature_point_shi_tomas_detector.cpp:66-118, quirk Q3 preserved)."""
    res = shi_tomasi_response_raw(image.to(torch.float32), sub)
    return _gate(res, image, mask, sub.half_patch_size + 1, opts.min_valid_response)


def _max_run(b16: torch.Tensor) -> torch.Tensor:
    """Longest circular run of set bits in a 16-bit ring pattern (int64):
    double the pattern into 32 bits and count the ``x &= x << 1`` rounds
    that leave it non-zero.  Bit 31 shifted to bit 32 is cleared by the
    ``&``, so int64 gives the uint32 result."""
    x = b16 | (b16 << 16)
    n = torch.zeros_like(x)
    for _ in range(16):
        n += (x != 0).to(n.dtype)
        x = x & (x << 1)
    return n


def fast_response(
    image: torch.Tensor,
    mask: torch.Tensor,
    sub: FastOptions = FastOptions(),
) -> torch.Tensor:
    """FAST segment-test arc length per pixel (feature_point_fast_detector.cpp:11-81);
    the reference's scan-order tie-break offset is dropped (Q2), as in the
    JAX package."""
    img = image.to(torch.int64)
    rows, cols = img.shape[-2:]
    bound = 3
    pad = F.pad(img, (bound, bound, bound, bound))
    hi = img + sub.min_pixel_diff_value
    lo = img - sub.min_pixel_diff_value
    b_pos = torch.zeros_like(img)
    b_neg = torch.zeros_like(img)
    for k, (dc, dr) in enumerate(_FAST_CIRCLE):
        ring_k = pad[..., bound + dr : bound + dr + rows, bound + dc : bound + dc + cols]
        b_pos |= (ring_k > hi).to(torch.int64) << k
        b_neg |= (ring_k < lo).to(torch.int64) << k

    # Pre-check: compass indices 4, 8, 12 share a sign
    # (feature_point_fast_detector.cpp:20-42).
    if sub.n >= 12:
        compass = (1 << 4) | (1 << 8) | (1 << 12)
        precheck = ((b_pos & compass) == compass) | ((b_neg & compass) == compass)
    else:
        precheck = torch.ones_like(img, dtype=torch.bool)

    best = torch.maximum(_max_run(b_pos), _max_run(b_neg))
    keep = _interior_mask(image.shape, bound, image.device) & precheck & (mask != 0)
    return torch.where(keep, best, torch.zeros_like(best)).to(torch.float32)


def nms4(response: torch.Tensor, threshold: float, bound: int) -> torch.Tensor:
    """Strict 4-neighbour NMS candidate map
    (feature_point_harris_detector.cpp:120-137)."""
    res = response
    up = F.pad(res, (0, 0, 1, 0))[..., :-1, :]
    down = F.pad(res, (0, 0, 0, 1))[..., 1:, :]
    left = F.pad(res, (1, 0, 0, 0))[..., :, :-1]
    right = F.pad(res, (0, 1, 0, 0))[..., :, 1:]
    keep = (res > threshold) & (res > up) & (res > down) & (res > left) & (res > right)
    keep &= _interior_mask(res.shape, bound, res.device)
    return torch.where(keep, res, torch.zeros_like(res))


def fast_candidates(response: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST candidate map: response >= threshold (inclusive, divergence Q2)."""
    return torch.where((response >= threshold) & (response > 0), response, torch.zeros_like(response))


def make_suppression_mask(
    shape: Tuple[int, int],
    uv: torch.Tensor,
    valid: torch.Tensor,
    radius: int,
) -> torch.Tensor:
    """int32 mask, 0 inside the clipped (2r+1)^2 square around each valid
    feature and 1 elsewhere (feature_point_detector.cpp:76-98).

    ``uv`` [..., N, 2] gives a mask [..., H, W].  Feature indicators are
    scattered with an amax reduction: invalid slots sit at uv=(0,0) and may
    share a pixel with a valid feature, and a plain ``index_put_`` would
    leave the winner undefined.  The dilation is a (2r+1) max pool.
    """
    rows, cols = shape[-2:]
    lead = uv.shape[:-2]
    n = uv.shape[-2]
    y = torch.clamp(uv[..., 1].to(torch.int32), 0, rows - 1).to(torch.int64)
    x = torch.clamp(uv[..., 0].to(torch.int32), 0, cols - 1).to(torch.int64)
    flat = (y * cols + x).reshape(-1, n)
    ind = torch.zeros((flat.shape[0], rows * cols), dtype=torch.int32, device=uv.device)
    ind.scatter_reduce_(1, flat, valid.reshape(-1, n).to(torch.int32), reduce="amax")
    hit = F.max_pool2d(
        ind.view(-1, 1, rows, cols).to(torch.float32),
        kernel_size=2 * radius + 1, stride=1, padding=radius,
    )
    return (1 - hit.to(torch.int32)).reshape(*lead, rows, cols)


def greedy_select_ref(cand_map: torch.Tensor, max_picks: int, n_stop, radius: int):
    """Greedy response-ordered selection with square suppression: the plain
    PyTorch version of the greedy kernel, a port of ``greedy_select_lax``
    (feature_point_detector.cpp:54-74).

    Args:
      cand_map: [H, W] or [B, H, W] f32 candidate responses (0 = none).
      max_picks: trip count (capacity).
      n_stop: picks still wanted, an int or a [B] int tensor.
      radius: suppression half-size.

    Each pick takes the global maximum, first in row-major order; it is
    taken if ``val > 0`` and ``i < n_stop``, and zeroes the clipped
    (2r+1)^2 square around it.  Returns (uv [.., P, 2] f32, resp [.., P]
    f32, valid [.., P] bool); untaken slots are 0.
    """
    single = cand_map.dim() == 2
    m = (cand_map[None] if single else cand_map).to(torch.float32).clone()
    b, rows, cols = m.shape
    dev = m.device
    stop = torch.as_tensor(n_stop, dtype=torch.int64, device=dev).reshape(-1).expand(b)
    row_idx = torch.arange(rows, device=dev).view(1, rows, 1)
    col_idx = torch.arange(cols, device=dev).view(1, 1, cols)
    uv = torch.zeros((b, max_picks, 2), dtype=torch.float32, device=dev)
    resp = torch.zeros((b, max_picks), dtype=torch.float32, device=dev)
    valid = torch.zeros((b, max_picks), dtype=torch.bool, device=dev)
    for i in range(max_picks):
        flat = torch.argmax(m.view(b, -1), dim=1)  # first maximum
        val = m.view(b, -1).gather(1, flat[:, None])[:, 0]
        y = flat // cols
        x = flat % cols
        take = (val > 0) & (i < stop)
        uv[:, i, 0] = torch.where(take, x.to(torch.float32), 0.0)
        uv[:, i, 1] = torch.where(take, y.to(torch.float32), 0.0)
        resp[:, i] = torch.where(take, val, 0.0)
        valid[:, i] = take
        in_sq = ((row_idx - y.view(b, 1, 1)).abs() <= radius) & (
            (col_idx - x.view(b, 1, 1)).abs() <= radius
        )
        m = torch.where(take.view(b, 1, 1) & in_sq, 0.0, m)
    if single:
        return uv[0], resp[0], valid[0]
    return uv, resp, valid


def subpixel_refine(response: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Subpixel corner localization: 2D quadratic fit of the response map
    around each pick.  response [..., H, W], uv [..., N, 2], valid [..., N];
    returns refined uv; invalid slots and non-concave fits keep their integer
    position."""
    rows, cols = response.shape[-2:]
    lead = uv.shape[:-2]
    n = uv.shape[-2]
    r2 = response.reshape(-1, rows * cols)
    x = torch.clamp(uv[..., 0].to(torch.int32), 1, cols - 2).reshape(-1, n).to(torch.int64)
    y = torch.clamp(uv[..., 1].to(torch.int32), 1, rows - 2).reshape(-1, n).to(torch.int64)

    def w(dy, dx):
        return r2.gather(1, (y + dy) * cols + (x + dx)).reshape(*lead, n)

    c, l, r, u, d = w(0, 0), w(0, -1), w(0, 1), w(-1, 0), w(1, 0)
    gx = (r - l) * 0.5
    gy = (d - u) * 0.5
    hxx = r + l - 2.0 * c
    hyy = d + u - 2.0 * c
    hxy = (w(1, 1) - w(1, -1) - w(-1, 1) + w(-1, -1)) * 0.25
    det = hxx * hyy - hxy * hxy
    safe = det.abs() > 1e-12
    det_s = torch.where(safe, det, torch.ones_like(det))
    dx = -(hyy * gx - hxy * gy) / det_s
    dy = -(hxx * gy - hxy * gx) / det_s
    ok = valid & safe & (hxx < 0) & (det > 0) & (dx.abs() <= 0.75) & (dy.abs() <= 0.75)
    out_x = uv[..., 0] + torch.where(ok, dx, torch.zeros_like(dx))
    out_y = uv[..., 1] + torch.where(ok, dy, torch.zeros_like(dy))
    return torch.stack([out_x, out_y], dim=-1)
