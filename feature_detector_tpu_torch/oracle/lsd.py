"""NumPy oracle for the LSD line-segment detector.

The port's copy of ``feature_detector_tpu/oracle/lsd.py`` (plain numpy).
Faithful sequential re-encoding of FeatureLineDetector
(feature_line_detector.cpp:12-228): 2x2 diagonal gradients and level-line
angles, gradient-norm-ordered seeds, BFS region growing with a running
circular-mean region angle, inertia rectangle fit, and the length /
inlier-ratio filters.  The reference's benign top-row init bug (Q7) and the
degenerate-moment early-return (Q6) are documented where relevant.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np

from ..core.config import LineDetectorOptions


def angle_diff(a: float, b: float) -> float:
    """Wrapped angle difference in (-pi, pi] (Slam_Utility AngleDiffInRad)."""
    d = a - b
    while d > math.pi:
        d -= 2.0 * math.pi
    while d < -math.pi:
        d += 2.0 * math.pi
    return d


def line_level_angle_map(image: np.ndarray, opts: LineDetectorOptions):
    """Gradient norm / level-line angle maps on the (rows-1, cols-1) grid,
    valid only for rows/cols in [1, dim-3] (feature_line_detector.cpp:56-97:
    the loop runs rows 1..rows-3 inclusive and the grid border stays invalid).

    Returns (norm, angle, valid) float32/bool arrays of shape (rows-1, cols-1).
    """
    img = image.astype(np.int32)
    rows, cols = img.shape
    g_rows, g_cols = rows - 1, cols - 1
    norm = np.zeros((g_rows, g_cols), dtype=np.float32)
    angle = np.zeros((g_rows, g_cols), dtype=np.float32)
    valid = np.zeros((g_rows, g_cols), dtype=bool)

    # pixel_ad = I[r+1,c+1] - I[r,c]; pixel_bc = I[r,c+1] - I[r+1,c]
    ad = img[1:, 1:] - img[:-1, :-1]
    bc = img[:-1, 1:] - img[1:, :-1]
    gx = (ad + bc).astype(np.float32) / 2.0
    gy = (ad - bc).astype(np.float32) / 2.0
    n = np.sqrt(gx * gx + gy * gy)

    # Interior: rows 1..rows-3, cols 1..cols-3 (loop bounds `< dim - 2`).
    rsl = slice(1, rows - 2)
    csl = slice(1, cols - 2)
    norm[rsl, csl] = n[rsl, csl]
    v = n[rsl, csl] > opts.min_valid_gradient_norm
    valid[rsl, csl] = v
    with np.errstate(invalid="ignore"):
        angle[rsl, csl] = np.where(v, np.arctan2(gx[rsl, csl], -gy[rsl, csl]), 0.0)
    return norm, angle, valid


def min_region_size(rows: int, cols: int, opts: LineDetectorOptions) -> int:
    """NFA-style minimum region size (feature_line_detector.cpp:17-20)."""
    p = opts.min_tolerance_angle_residual_in_rad / math.pi
    log_nt = 5.0 * (math.log10(float(cols)) + math.log10(float(rows))) / 2.0 + math.log10(11.0)
    return int(-log_nt / math.log10(p))


def grow_region(seed, norm, angle, valid, used, opts: LineDetectorOptions):
    """BFS region grow from a seed with running circular-mean angle
    (feature_line_detector.cpp:99-154).  Mutates ``used`` for accepted pixels.
    Returns (member list [(row, col)], region_angle).

    NB the seed itself is never appended to region.pixels in the reference —
    only accepted candidates are; reproduced exactly.
    """
    tol = opts.min_tolerance_angle_residual_in_rad
    sr, sc = seed
    occupied = {(sr, sc)}
    region_angle = float(angle[sr, sc])
    sum_dx = math.cos(region_angle)
    sum_dy = math.sin(region_angle)
    members = []
    queue = deque()

    def try_add(r, c):
        if (r, c) not in occupied and not used[r, c] and valid[r, c]:
            occupied.add((r, c))
            queue.append((r, c))

    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr or dc:
                try_add(sr + dr, sc + dc)

    while queue:
        r, c = queue.popleft()
        if abs(angle_diff(region_angle, float(angle[r, c]))) > tol:
            continue
        sum_dx += math.cos(float(angle[r, c]))
        sum_dy += math.sin(float(angle[r, c]))
        region_angle = math.atan2(sum_dy, sum_dx)
        members.append((r, c))
        used[r, c] = True
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if dr or dc:
                    try_add(r + dr, c + dc)
    return members, region_angle


def region_to_rectangle(members, region_angle, norm, opts: LineDetectorOptions):
    """Inertia rectangle fit (feature_line_detector.cpp:163-228).  Returns a
    dict or None when degenerate (zero weight / zero moment, quirk Q6 — the
    zero-length rect is filtered out downstream either way)."""
    w = np.array([norm[r, c] for r, c in members], dtype=np.float32)
    xs = np.array([c for r, c in members], dtype=np.float32)
    ys = np.array([r for r, c in members], dtype=np.float32)
    sum_w = float(w.sum())
    if sum_w == 0:
        return None
    cx = float((xs * w).sum()) / sum_w
    cy = float((ys * w).sum()) / sum_w

    dx = xs - cx
    dy = ys - cy
    ixx = float((dy * dy * w).sum())
    iyy = float((dx * dx * w).sum())
    ixy = -float((dx * dy * w).sum())
    if ixx == 0 or iyy == 0 or ixy == 0:
        return None
    smallest = 0.5 * (ixx + iyy - math.sqrt((ixx - iyy) ** 2 + 4.0 * ixy * ixy))
    if abs(ixx) > abs(iyy):
        rect_angle = math.atan2(smallest - ixx, ixy)
    else:
        rect_angle = math.atan2(ixy, smallest - iyy)
    if abs(angle_diff(rect_angle, region_angle)) > opts.min_tolerance_angle_residual_in_rad:
        rect_angle += math.pi
        if rect_angle >= math.pi:
            rect_angle -= 2.0 * math.pi
    dvx, dvy = math.cos(rect_angle), math.sin(rect_angle)

    proj_l = dx * dvx + dy * dvy
    proj_w = -dx * dvy + dy * dvx
    lmin = min(0.0, float(proj_l.min()))
    lmax = max(0.0, float(proj_l.max()))
    wmin = min(0.0, float(proj_w.min()))
    wmax = max(0.0, float(proj_w.max()))

    length = lmax - lmin
    width = max(wmax - wmin, 1.0)
    area = (lmax - lmin) * width
    return {
        "start": (cx + lmin * dvx, cy + lmin * dvy),
        "end": (cx + lmax * dvx, cy + lmax * dvy),
        "center": (cx, cy),
        "length": max(length, 1.0),
        "width": width,
        "angle": rect_angle,
        "inlier_ratio": len(members) / area if area > 0 else 0.0,
    }


def detect_lines(image: np.ndarray, opts: LineDetectorOptions | None = None):
    """Full pipeline (feature_line_detector.cpp:12-54).  Returns a list of
    (x1, y1, x2, y2) with the +0.5 px compensation applied."""
    opts = opts or LineDetectorOptions()
    rows, cols = image.shape
    norm, angle, valid = line_level_angle_map(image, opts)
    min_size = min_region_size(rows, cols, opts)

    ys, xs = np.nonzero(valid)
    order = np.argsort(-norm[ys, xs], kind="stable")
    used = np.zeros_like(valid)

    lines = []
    for idx in order:
        r, c = int(ys[idx]), int(xs[idx])
        if used[r, c]:
            continue
        members, region_angle = grow_region((r, c), norm, angle, valid, used, opts)
        if len(members) < min_size:
            for mr, mc in members:
                used[mr, mc] = False
            continue
        rect = region_to_rectangle(members, region_angle, norm, opts)
        if rect is None:
            continue
        if (
            rect["length"] < opts.min_valid_line_length_in_pixel
            or rect["inlier_ratio"] < opts.max_tolerance_inlier_ratio
        ):
            continue
        x1, y1 = rect["start"]
        x2, y2 = rect["end"]
        lines.append((x1 + 0.5, y1 + 0.5, x2 + 0.5, y2 + 0.5))
    return lines
