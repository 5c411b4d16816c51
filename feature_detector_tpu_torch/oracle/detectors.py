"""NumPy oracle for the classical point detectors.

The port's copy of ``feature_detector_tpu/oracle/detectors.py``: plain numpy,
independent of both packages' kernels.  It re-encodes — from behavioral
analysis, not translation — the exact semantics of the reference detectors,
so the port's detectors (on the CPU and on the card) can be held against
golden values:

- greedy mask-suppression selection: feature_point_detector.cpp:54-98
- FAST segment-test response:        feature_point_fast_detector.cpp:11-98
- Harris response + 4-neighbor NMS:  feature_point_harris_detector.cpp:17-137
- Shi-Tomasi (lambda_max) variant:   feature_point_shi_tomas_detector.cpp:66-137
- grid sparsify:                     feature_point_detector.cpp:27-52

Documented divergence (SURVEY.md Q2): the reference adds a +1e-5*k tie-break
offset to FAST responses keyed on mask-scan order; the oracle instead uses the
pure integer arc length with (response desc, row-major) ordering, and treats
the demo thresholds inclusively (``response >= threshold``) to match the
reference's ``int + epsilon > threshold`` acceptance.
"""

from __future__ import annotations

import numpy as np

from ..core.config import DetectorOptions, FastOptions, HarrisOptions, ShiTomasiOptions

# FAST 16-pixel Bresenham circle as (dcol, drow), index order matching
# feature_point_fast_detector.cpp:7-8.
FAST_CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)


def draw_rectangle_in_mask(mask: np.ndarray, row: int, col: int, radius: int) -> None:
    """Zero a clamped (2r+1)^2 square (feature_point_detector.cpp:76-88)."""
    rows, cols = mask.shape
    r0, r1 = max(0, row - radius), min(rows - 1, row + radius)
    c0, c1 = max(0, col - radius), min(cols - 1, col + radius)
    mask[r0 : r1 + 1, c0 : c1 + 1] = 0


def make_mask(shape, features, radius: int) -> np.ndarray:
    """Suppression mask seeded by existing features
    (feature_point_detector.cpp:12-16, 90-98; float coords truncate to int)."""
    mask = np.ones(shape, dtype=np.int32)
    for x, y in features:
        draw_rectangle_in_mask(mask, int(y), int(x), radius)
    return mask


def harris_response_map(
    image: np.ndarray, mask: np.ndarray, opts: DetectorOptions, sub: HarrisOptions
) -> np.ndarray:
    """Harris response map with threshold/mask gating applied.

    Equivalent closed form of the reference's separable sliding-window passes
    (feature_point_harris_detector.cpp:17-118): central-difference gradients on
    the interior (zero on the 1-px border), 3x3 (patch) box sums of the
    gradient products, response (SxxSyy - Sxy^2 - a tr^2)/cnt^2 on the interior
    [bound, dim-bound) with bound = half+1.  The reference's trace pre-check is
    mathematically redundant (lambda_max <= 0.21 tr^2 bound) and is omitted.
    """
    img = image.astype(np.float32)
    rows, cols = img.shape
    half = sub.half_patch_size
    patch = 2 * half + 1
    inv_cnt2 = (1.0 / (patch * patch)) ** 2

    ix = np.zeros_like(img)
    iy = np.zeros_like(img)
    ix[1:-1, 1:-1] = img[1:-1, 2:] - img[1:-1, :-2]
    iy[1:-1, 1:-1] = img[2:, 1:-1] - img[:-2, 1:-1]

    sxx = _box_sum(ix * ix, half)
    syy = _box_sum(iy * iy, half)
    sxy = _box_sum(ix * iy, half)

    tr = sxx + syy
    res = (sxx * syy - sxy * sxy - sub.alpha * tr * tr) * inv_cnt2

    out = np.zeros_like(img)
    bound = half + 1
    region = np.zeros_like(img, dtype=bool)
    region[bound : rows - bound, bound : cols - bound] = True
    keep = region & (mask != 0) & (res > opts.min_valid_response)
    out[keep] = res[keep]
    return out


def shi_tomasi_response_map(
    image: np.ndarray, mask: np.ndarray, opts: DetectorOptions, sub: ShiTomasiOptions
) -> np.ndarray:
    """Largest-eigenvalue response (feature_point_shi_tomas_detector.cpp:66-118;
    the reference labels this Shi-Tomasi but computes lambda_max — preserved)."""
    img = image.astype(np.float32)
    rows, cols = img.shape
    half = sub.half_patch_size
    patch = 2 * half + 1
    inv_cnt = 1.0 / (patch * patch)

    ix = np.zeros_like(img)
    iy = np.zeros_like(img)
    ix[1:-1, 1:-1] = img[1:-1, 2:] - img[1:-1, :-2]
    iy[1:-1, 1:-1] = img[2:, 1:-1] - img[:-2, 1:-1]

    a = _box_sum(ix * ix, half) * inv_cnt
    c = _box_sum(iy * iy, half) * inv_cnt
    b = _box_sum(ix * iy, half) * inv_cnt
    common = np.sqrt((a - c) * (a - c) + 4.0 * b * b)
    res = (a + c + common) * 0.5

    out = np.zeros_like(img)
    bound = half + 1
    region = np.zeros_like(img, dtype=bool)
    region[bound : rows - bound, bound : cols - bound] = True
    keep = region & (mask != 0) & (res > opts.min_valid_response)
    out[keep] = res[keep]
    return out


def _box_sum(x: np.ndarray, half: int) -> np.ndarray:
    """(2*half+1)^2 box sum with zero padding."""
    patch = 2 * half + 1
    padded = np.pad(x, half)
    c = np.cumsum(np.cumsum(padded, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    return (
        c[patch:, patch:] - c[:-patch, patch:] - c[patch:, :-patch] + c[:-patch, :-patch]
    )


def nms4_candidates(response: np.ndarray, threshold: float, bound: int):
    """Strict 4-neighbor NMS (feature_point_harris_detector.cpp:120-137).

    Returns (responses, pixels[col,row]) of surviving candidates in row-major
    scan order.
    """
    rows, cols = response.shape
    res = response
    keep = np.zeros_like(res, dtype=bool)
    r = slice(bound, rows - bound)
    c = slice(bound, cols - bound)
    center = res[r, c]
    keep[r, c] = (
        (center > threshold)
        & (center > res[r, bound - 1 : cols - bound - 1])
        & (center > res[r, bound + 1 : cols - bound + 1])
        & (center > res[bound - 1 : rows - bound - 1, c])
        & (center > res[bound + 1 : rows - bound + 1, c])
    )
    ys, xs = np.nonzero(keep)
    return res[ys, xs], np.stack([xs, ys], axis=-1)


def fast_response_map(image: np.ndarray, mask: np.ndarray, sub: FastOptions) -> np.ndarray:
    """FAST segment-test arc-length response for every interior pixel
    (feature_point_fast_detector.cpp:11-81), without the scan-order offset
    (documented divergence Q2).  Masked pixels get response 0
    (feature_point_fast_detector.cpp:85-96 only evaluates masked-in pixels).
    """
    img = image.astype(np.int32)
    rows, cols = img.shape
    bound = 3

    interior = img[bound : rows - bound, bound : cols - bound]
    h, w = interior.shape
    ring = np.empty((16, h, w), dtype=np.int32)
    for i, (dc, dr) in enumerate(FAST_CIRCLE):
        ring[i] = img[bound + dr : bound + dr + h, bound + dc : bound + dc + w]

    hi = interior + sub.min_pixel_diff_value
    lo = interior - sub.min_pixel_diff_value
    cls = np.zeros((16, h, w), dtype=np.int8)
    cls[ring > hi[None]] = 1
    cls[ring < lo[None]] = -1

    # Pre-check (kN >= 12): the reference scans compass points 0,4,8,12 with
    # mutually-resetting counters and tests the FINAL counts
    # (feature_point_fast_detector.cpp:20-42), so it passes only when the run
    # reaches the last compass point: indices 4,8,12 must share one sign.
    if sub.n >= 12:
        compass = cls[[0, 4, 8, 12]]
        ok = np.zeros((h, w), dtype=bool)
        for sign in (1, -1):
            s = compass == sign
            ok |= s[1] & s[2] & s[3]
        precheck = ok
    else:
        precheck = np.ones((h, w), dtype=bool)

    # Max wrap-around run of identical nonzero class over the doubled ring,
    # capped at 16 (feature_point_fast_detector.cpp:54-80: two passes without
    # resetting counters across the wrap).
    best = np.zeros((h, w), dtype=np.int32)
    for sign in (1, -1):
        s = (cls == sign).astype(np.int32)
        run = np.zeros((h, w), dtype=np.int32)
        m = np.zeros((h, w), dtype=np.int32)
        for k in range(32):
            run = np.where(s[k % 16] == 1, run + 1, 0)
            m = np.maximum(m, run)
        best = np.maximum(best, np.minimum(m, 16))

    resp = np.zeros((rows, cols), dtype=np.float32)
    resp[bound : rows - bound, bound : cols - bound] = np.where(precheck, best, 0)
    resp[mask == 0] = 0.0
    return resp


def fast_candidates(response: np.ndarray, threshold: float):
    """Candidates: interior pixels with response >= threshold (inclusive to
    mirror the reference's int+epsilon > threshold, divergence Q2)."""
    keep = response >= threshold
    keep &= response > 0
    ys, xs = np.nonzero(keep)
    return response[ys, xs], np.stack([xs, ys], axis=-1)


def select_good_features(
    responses: np.ndarray,
    pixels: np.ndarray,
    mask: np.ndarray,
    needed_num: int,
    min_distance: int,
    existing: list | None = None,
):
    """Greedy response-ordered selection with square suppression
    (feature_point_detector.cpp:54-74).  Ties break by row-major scan order
    (stable sort; divergence Q2 w.r.t. the reference's unstable std::sort).

    ``existing`` features are appended-to, reference-style (Q9).
    Returns the full feature list (existing + new), as float (x, y) pairs.
    """
    features = list(existing) if existing else []
    mask = mask.copy()
    order = np.argsort(-responses, kind="stable")
    for idx in order:
        x, y = int(pixels[idx][0]), int(pixels[idx][1])
        if mask[y, x]:
            features.append((float(x), float(y)))
            if len(features) >= needed_num:
                return features
            draw_rectangle_in_mask(mask, y, x, min_distance)
    return features


def detect_good_features(
    image: np.ndarray,
    needed_num: int,
    kind: str,
    opts: DetectorOptions,
    sub=None,
    existing: list | None = None,
):
    """Full DetectGoodFeatures pipeline (feature_point_detector.cpp:7-25)."""
    existing = existing or []
    mask = make_mask(image.shape, existing, opts.min_feature_distance)
    if kind == "harris":
        sub = sub or HarrisOptions()
        resp = harris_response_map(image, mask, opts, sub)
        responses, pixels = nms4_candidates(
            resp, opts.min_valid_response, sub.half_patch_size + 1
        )
    elif kind == "shi_tomasi":
        sub = sub or ShiTomasiOptions()
        resp = shi_tomasi_response_map(image, mask, opts, sub)
        responses, pixels = nms4_candidates(
            resp, opts.min_valid_response, sub.half_patch_size + 1
        )
    elif kind == "fast":
        sub = sub or FastOptions()
        resp = fast_response_map(image, mask, sub)
        responses, pixels = fast_candidates(resp, opts.min_valid_response)
    else:
        raise ValueError(kind)
    return select_good_features(
        responses, pixels, mask, needed_num, opts.min_feature_distance, existing
    )


def sparsify_features(
    features,
    image_rows: int,
    image_cols: int,
    status_need_filter: int,
    status_after_filter: int,
    status,
    opts: DetectorOptions,
):
    """Grid filter (feature_point_detector.cpp:27-52), including its
    integer-division grid-step and first-wins cell semantics."""
    features = np.asarray(features, dtype=np.float32).reshape(-1, 2)
    status = list(status)
    if len(status) != len(features):
        status = [1] * len(features)
    grid_rows = opts.grid_filter_row_divide_number
    grid_cols = opts.grid_filter_col_divide_number
    grid_row_step = image_rows / (grid_rows - 1)
    grid_col_step = image_cols / (grid_cols - 1)
    mask = np.ones((grid_rows, grid_cols), dtype=np.int32)
    for i, (x, y) in enumerate(features):
        row = int(y / grid_row_step)
        col = int(x / grid_col_step)
        if row < 0 or row > grid_rows - 1 or col < 0 or col > grid_cols - 1:
            status[i] = status_after_filter
            continue
        if mask[row, col] and status[i] == status_need_filter:
            mask[row, col] = 0
        elif not mask[row, col] and status[i] == status_need_filter:
            status[i] = status_after_filter
    return status
