"""LSD line-segment detection in PyTorch: angle map, region flood, and the
rectangle fit.

Counterpart of ``feature_detector_tpu/kernels/lsd.py``, function by function:

1. ``line_level_angle_map``: gradient norm, level-line angle and validity on
   the (rows-1, cols-1) grid (feature_line_detector.cpp:56-97);
2. ``propagate_labels_meanangle``: angle-gated region growing as stencil
   sweeps.  Its default schedule, ("R", propagation_steps), is the
   path-running-mean flood of ``kernels/lsd_flood.py``: the CUDA kernel for
   tensors on the card, its plain version on the CPU.  The other schedule
   steps ("S", "J", "L", "M") and the pairwise ``propagate_labels`` are plain
   torch;
3. ``fit_lines``: per-region inertia rectangles, filters and the top
   ``max_lines`` by gradient weight (feature_line_detector.cpp:163-228).

The JAX package shapes the fit for a TPU (one-hot products, no gathers).
Here the fit gathers and scatters directly, with these rules:

- deterministic on the card: counts are int64 sums; per-region sums of
  weights and of cos/sin are exact fixed-point int64 sums rounded once to
  float32 (``_segment_sum``); the moments are one float64 matrix product;
  extents are scatter maxima, which do not depend on order.  So the sums
  are closer to exact than the JAX package's float32 ones and differ from
  them by a few ulps;
- ``lax.top_k`` puts the lower index first on ties: a stable descending sort
  does the same (``_top_k``).

Labels equal the JAX package's exactly when both get the same maps;
endpoints and rectangle fields agree within float32 rounding
(tests/test_torch_lsd.py states the tolerances).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core.config import LineDetectorOptions
from .lsd_flood import (
    PI,
    SHIFTS,
    TWO_PI,
    angle_diff,
    f32,
    initial_state,
    labels_of,
    propagate_running,
    running_sweeps,
    sentinel,
    shift,
)

NORM_FRAC_BITS = 24  # every nonzero gradient norm is a float32 >= 0.5: a multiple of 2^-24
UNIT_FRAC_BITS = 40  # cos/sin: exact for |v| >= 2^-16; 360k of them stay below 2^63


def line_level_angle_map(
    image: torch.Tensor, opts: LineDetectorOptions
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradient norm / level-line angle / validity on the (rows-1, cols-1)
    grid; valid region rows/cols in [1, dim-3] (feature_line_detector.cpp:56-97).

    gx and gy are half-integers, so the norm is the correctly rounded root
    of an exact sum, as XLA's; the angle is float32 atan2, which may differ
    from XLA's by an ulp."""
    img = image.to(torch.float32)
    rows, cols = image.shape[-2:]
    ad = img[..., 1:, 1:] - img[..., :-1, :-1]
    bc = img[..., :-1, 1:] - img[..., 1:, :-1]
    gx = (ad + bc) * 0.5
    gy = (ad - bc) * 0.5
    # torch's vectorised float32 sqrt on the CPU is not always correctly
    # rounded; the float64 root of the (exact) float32 sum, rounded once, is.
    norm = torch.sqrt((gx * gx + gy * gy).to(torch.float64)).to(torch.float32)

    rr = torch.arange(rows - 1, device=img.device)[:, None]
    cc = torch.arange(cols - 1, device=img.device)[None, :]
    interior = (rr >= 1) & (rr < rows - 2) & (cc >= 1) & (cc < cols - 2)
    valid = interior & (norm > f32(opts.min_valid_gradient_norm))
    angle = torch.where(valid, torch.atan2(gx, -gy), 0.0)
    norm = torch.where(interior, norm, 0.0)
    return norm, angle, valid


def min_region_size(rows: int, cols: int, opts: LineDetectorOptions) -> int:
    """NFA-style minimum region size (feature_line_detector.cpp:17-20)."""
    p = opts.min_tolerance_angle_residual_in_rad / math.pi
    log_nt = (
        5.0 * (math.log10(float(cols)) + math.log10(float(rows))) / 2.0
        + math.log10(11.0)
    )
    return int(-log_nt / math.log10(p))


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int, frac_bits: int) -> torch.Tensor:
    """Per-segment sums of float32 ``values`` [N, ...] into ``n`` segments,
    the same bits on any device and in any order: each value is rounded to a
    multiple of 2^-frac_bits (exact for the values the callers give), summed
    as int64, and the sum rounded to float32 once."""
    q = torch.round(values.to(torch.float64) * 2.0**frac_bits).to(torch.int64)
    sums = torch.zeros((n, *values.shape[1:]), dtype=torch.int64, device=values.device)
    sums.index_add_(0, ids, q)
    return (sums.to(torch.float64) * 2.0**-frac_bits).to(torch.float32)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest values, the lower index first on ties."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x.flatten()[idx]`` with idx clipped into range, keeping idx's shape."""
    return x.reshape(-1)[idx.clamp(0, x.numel() - 1).to(torch.int64)]


def _seed_sweeps(angle, valid, state, n_sweeps: int, tol: float):
    """("S", n): seed-angle stencil sweeps over (priority, seed, gate angle)."""
    big = sentinel(angle.shape)
    pri, seed, gang = state
    for _ in range(n_sweeps):
        best_p, best_s, best_g = pri, seed, gang
        for dr, dc in SHIFTS:
            n_pri = shift(pri, dr, dc, -1.0)
            n_seed = shift(seed, dr, dc, big)
            n_gang = shift(gang, dr, dc, 0.0)
            gate = valid & (n_seed < big) & (angle_diff(angle, n_gang).abs() <= tol)
            better = gate & ((n_pri > best_p) | ((n_pri == best_p) & (n_seed < best_s)))
            best_p = torch.where(better, n_pri, best_p)
            best_s = torch.where(better, n_seed, best_s)
            best_g = torch.where(better, n_gang, best_g)
        pri, seed, gang = best_p, best_s, best_g
    return pri, seed, gang


def propagate_labels_meanangle(
    norm: torch.Tensor,
    angle: torch.Tensor,
    valid: torch.Tensor,
    opts: LineDetectorOptions,
    schedule: Tuple = None,
) -> torch.Tensor:
    """Seeded region growing as a priority flood; int32 labels (seed flat
    index; -1 where invalid).

    ``schedule`` is a sequence of steps: ("S", n) seed-angle sweeps, ("R", n)
    path-running-mean sweeps (the kernel on the card), ("J",) gated
    absorption jump, ("L",) ungated pointer jump, ("M",) component-mean gate
    refresh.  The default is ("R", opts.propagation_steps), run from the
    initial state by ``propagate_running``."""
    tol = f32(opts.min_tolerance_angle_residual_in_rad)
    if schedule is None:
        return propagate_running(norm, angle, valid, opts.propagation_steps, tol)
    big = sentinel(angle.shape)
    pri0, seed0, gang0, ones = initial_state(norm, angle, valid)

    def jump(state):
        """seed <- seed[seed], accepted only where the new seed's own angle
        passes the pixel's gate; priority and gate angle come from the new
        seed's initial values."""
        pri, seed, gang = state
        s2 = torch.where(seed < big, _take(seed, seed), big)
        g2, p2 = _take(gang0, s2), _take(pri0, s2)
        ok = (s2 < big) & (angle_diff(angle, g2).abs() <= tol)
        return torch.where(ok, p2, pri), torch.where(ok, s2, seed), torch.where(ok, g2, gang)

    def jump_lite(state):
        """Ungated pointer doubling; priority and gate angle left stale."""
        pri, seed, gang = state
        s2 = _take(seed, seed)
        return pri, torch.where((seed < big) & (s2 < big), s2, seed), gang

    def refresh_mean(state):
        """Gate angle <- circular mean angle of the pixel's component."""
        pri, seed, gang = state
        n_seg = seed.numel()
        cs = torch.stack([torch.where(valid, torch.cos(angle), 0.0).reshape(-1),
                          torch.where(valid, torch.sin(angle), 0.0).reshape(-1)], -1)
        ids = torch.where(seed < big, seed, n_seg).reshape(-1).to(torch.int64)
        sums = _segment_sum(cs, ids, n_seg + 1, UNIT_FRAC_BITS)
        mean = torch.atan2(sums[:, 1], sums[:, 0])
        return pri, seed, torch.where(seed < big, _take(mean, seed), gang)

    state = (pri0, seed0, gang0)
    for step in schedule:
        if step[0] == "S":
            state = _seed_sweeps(angle, valid, state, step[1], tol)
        elif step[0] == "R":
            # Running-mean sweeps carry a 4th field, the path length, from 1.
            state = running_sweeps(angle, valid, (*state, ones), step[1], tol)[:3]
        elif step[0] == "J":
            state = jump(state)
        elif step[0] == "L":
            state = jump_lite(state)
        elif step[0] == "M":
            state = refresh_mean(state)
        else:
            raise ValueError(f"unknown schedule step {step!r}")
    return labels_of(state[1], valid)


def propagate_labels(angle: torch.Tensor, valid: torch.Tensor, opts: LineDetectorOptions) -> torch.Tensor:
    """Angle-gated 8-neighbour connected components (pairwise gate), with
    pointer jumping.  int32 labels (min member flat index per component; -1
    where invalid).  Runs until no label changes, at most
    ``opts.propagation_steps`` sweeps; each sweep reads back one flag."""
    tol = f32(opts.min_tolerance_angle_residual_in_rad)
    g_rows, g_cols = angle.shape
    big = sentinel(angle.shape)
    flat = torch.arange(g_rows * g_cols, dtype=torch.int32, device=angle.device).reshape(g_rows, g_cols)
    labels = torch.where(valid, flat, big)
    edges = [
        valid & shift(valid, dr, dc, False) & (angle_diff(angle, shift(angle, dr, dc, 0.0)).abs() <= tol)
        for dr, dc in SHIFTS
    ]
    for _ in range(opts.propagation_steps):
        new = labels
        for edge, (dr, dc) in zip(edges, SHIFTS):
            new = torch.minimum(new, torch.where(edge, shift(labels, dr, dc, big), big))
        jumped = torch.where(new < big, torch.minimum(new, _take(new, new.clamp(0, big - 2))), big)
        changed = bool((jumped != labels).any())
        labels = jumped
        if not changed:
            break
    return torch.where(valid, labels, -1)


def fit_lines(
    labels: torch.Tensor,
    norm: torch.Tensor,
    angle: torch.Tensor,
    valid: torch.Tensor,
    image_shape: Tuple[int, int],
    opts: LineDetectorOptions,
):
    """Region labels -> rectangles -> filtered line segments (fixed capacity).

    Returns (endpoints [max_lines, 4], line_valid [max_lines], rectangles
    dict), sorted by descending region weight.  Shapes are fixed, so nothing
    here waits for the card.
    """
    rows, cols = image_shape
    g_rows, g_cols = norm.shape
    n_seg = g_rows * g_cols
    dev = norm.device
    tol = f32(opts.min_tolerance_angle_residual_in_rad)

    # Valid-pixel compaction: the labelled pixels, in raster order, into a
    # fixed buffer of max_fit_pixels; pixels beyond it are dropped from the
    # fit (a capacity bound, as in the JAX package).
    lab = labels.reshape(-1)
    occupied = lab >= 0
    seg_full = torch.where(occupied, lab, n_seg).to(torch.int64)
    m_cap = int(opts.max_fit_pixels)
    pos = torch.cumsum(occupied.to(torch.int64), 0) - 1
    slot = torch.where(occupied & (pos < m_cap), pos, m_cap)
    cidx = torch.zeros(m_cap + 1, dtype=torch.int64, device=dev)
    cidx = cidx.scatter(0, slot, torch.arange(n_seg, dtype=torch.int64, device=dev))[:m_cap]
    n_compact = torch.clamp(pos[-1] + 1, max=m_cap)
    cvalid = torch.arange(m_cap, device=dev) < n_compact
    seg_ids = torch.where(cvalid, seg_full[cidx], n_seg)
    w_flat = torch.where(cvalid, torch.where(valid, norm, 0.0).reshape(-1)[cidx], 0.0)

    # Per-label pixel count and gradient weight; the top K become candidates.
    cnt_full = torch.zeros(n_seg + 1, dtype=torch.int64, device=dev)
    cnt_full = cnt_full.index_add_(0, seg_ids, cvalid.to(torch.int64))[:-1]
    sumw_full = _segment_sum(w_flat, seg_ids, n_seg + 1, NORM_FRAC_BITS)[:-1]
    msize = min_region_size(rows, cols, opts)
    k = min(n_seg, max(256, 2 * opts.max_lines))
    cand_score = torch.where(cnt_full >= msize, sumw_full, -1.0)
    cand_w, cand = _top_k(cand_score, k)
    cand_live = cand_w > 0

    # Moments in coordinates centred on the grid's middle: one [K, M] float64
    # product of the membership matrix with float32 per-pixel features.
    x0, y0 = 0.5 * (g_cols - 1), 0.5 * (g_rows - 1)
    xs = torch.where(cvalid, (cidx % g_cols).to(torch.float32) - x0, 0.0)
    ys = torch.where(cvalid, (cidx // g_cols).to(torch.float32) - y0, 0.0)
    ang_c = angle.reshape(-1)[cidx]
    feats = torch.stack(
        [w_flat, w_flat * xs, w_flat * ys, w_flat * xs * xs, w_flat * ys * ys, w_flat * xs * ys,
         torch.where(cvalid, torch.cos(ang_c), 0.0), torch.where(cvalid, torch.sin(ang_c), 0.0)],
        dim=-1,
    )
    member = (seg_ids[None, :] == cand[:, None]).to(torch.float64)
    moments = (member @ feats.to(torch.float64)).to(torch.float32)  # [K, 8]
    sum_w = moments[:, 0]
    inv_w = 1.0 / torch.clamp(sum_w, min=f32(1e-12))
    cx = moments[:, 1] * inv_w
    cy = moments[:, 2] * inv_w
    ixx = moments[:, 4] - sum_w * cy * cy
    iyy = moments[:, 3] - sum_w * cx * cx
    ixy = -(moments[:, 5] - sum_w * cx * cy)
    region_angle = torch.atan2(moments[:, 7], moments[:, 6])
    cnt = cnt_full[cand].to(torch.float32)

    # Inertia axis (feature_line_detector.cpp:178-198).
    smallest = 0.5 * (ixx + iyy - torch.sqrt((ixx - iyy) ** 2 + 4.0 * ixy * ixy))
    rect_angle = torch.where(
        ixx.abs() > iyy.abs(),
        torch.atan2(smallest - ixx, ixy),
        torch.atan2(ixy, smallest - iyy),
    )
    flip = angle_diff(rect_angle, region_angle).abs() > tol
    flipped = rect_angle + PI
    flipped = torch.where(flipped >= PI, flipped - TWO_PI, flipped)
    rect_angle = torch.where(flip, flipped, rect_angle)
    dvx = torch.cos(rect_angle)
    dvy = torch.sin(rect_angle)

    # Extents along and across the axis, ranges including 0
    # (feature_line_detector.cpp:204-217): per-candidate scatter maxima over
    # the member pixels.  "+ 0.0" turns -0 into +0, so the maxima do not
    # depend on the order of the scatter.
    rank_of = torch.full((n_seg + 1,), k, dtype=torch.int64, device=dev)
    rank_of[cand] = torch.arange(k, device=dev)
    rank = rank_of[seg_ids]
    r = rank.clamp(max=k - 1)
    dx = xs - cx[r]
    dy = ys - cy[r]
    proj_l = dx * dvx[r] + dy * dvy[r]
    proj_w = -dx * dvy[r] + dy * dvx[r]

    def member_max(vals):
        out = torch.full((k + 1,), f32(-3e38), dtype=torch.float32, device=dev)
        return out.scatter_reduce_(0, rank, vals + 0.0, reduce="amax", include_self=True)[:k]

    lmax = torch.clamp(member_max(proj_l), min=0.0)
    lmin = -torch.clamp(member_max(-proj_l), min=0.0)
    wmax = torch.clamp(member_max(proj_w), min=0.0)
    wmin = -torch.clamp(member_max(-proj_w), min=0.0)

    raw_length = lmax - lmin
    length = torch.clamp(raw_length, min=1.0)
    width = torch.clamp(wmax - wmin, min=1.0)
    area = raw_length * width
    inlier_ratio = cnt / torch.clamp(area, min=f32(1e-12))

    # Filters (feature_line_detector.cpp:17-20,40) + degenerate-moment rule Q6.
    ok = (
        cand_live
        & (cnt >= msize)
        & (sum_w > 0)
        & (ixx != 0)
        & (iyy != 0)
        & (ixy != 0)
        & (length >= f32(opts.min_valid_line_length_in_pixel))
        & (inlier_ratio >= f32(opts.max_tolerance_inlier_ratio))
    )

    score = torch.where(ok, sum_w, -1.0)
    top_score, top = _top_k(score, opts.max_lines)
    line_valid = top_score > 0
    top_label = cand[top].to(torch.int32)

    # Back to pixel coordinates (+ the reference's +0.5 px offset).
    sx = (cx + lmin * dvx)[top] + x0 + 0.5
    sy = (cy + lmin * dvy)[top] + y0 + 0.5
    ex = (cx + lmax * dvx)[top] + x0 + 0.5
    ey = (cy + lmax * dvy)[top] + y0 + 0.5
    endpoints = torch.where(line_valid[:, None], torch.stack([sx, sy, ex, ey], dim=-1), 0.0)

    # The fitted rectangle of each selected line (RectangleParam,
    # feature_line_detector.h:27-38), with its region label and pixel count.
    rectangles = {
        "center": torch.stack([cx[top] + x0, cy[top] + y0], dim=-1),
        "angle": rect_angle[top],
        "length": length[top],
        "width": width[top],
        "inlier_ratio": inlier_ratio[top],
        "pixel_count": cnt[top],
        "label": top_label,
        "valid": line_valid,
    }
    return endpoints, line_valid, rectangles


def _lines_impl(
    norm: torch.Tensor,
    angle: torch.Tensor,
    valid: torch.Tensor,
    image_shape: Tuple[int, int],
    opts: LineDetectorOptions,
):
    """Flood then fit: (endpoints, line_valid, labels grid, rectangles)."""
    labels = propagate_labels_meanangle(norm, angle, valid, opts)
    endpoints, line_valid, rectangles = fit_lines(labels, norm, angle, valid, image_shape, opts)
    return endpoints, line_valid, labels, rectangles


def detect_lines_from_maps(
    norm: torch.Tensor,
    angle: torch.Tensor,
    valid: torch.Tensor,
    image_shape: Tuple[int, int],
    opts: LineDetectorOptions,
):
    """(endpoints [max_lines, 4], line_valid [max_lines]): the detection path."""
    endpoints, line_valid, _, _ = _lines_impl(norm, angle, valid, image_shape, opts)
    return endpoints, line_valid


def detect_lines_with_state(
    norm: torch.Tensor,
    angle: torch.Tensor,
    valid: torch.Tensor,
    image_shape: Tuple[int, int],
    opts: LineDetectorOptions,
):
    """Full-introspection path: (endpoints, line_valid, labels, rectangles)."""
    return _lines_impl(norm, angle, valid, image_shape, opts)
