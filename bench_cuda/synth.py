"""Synthetic scenes made from a seed, in numpy: the benchmark's frozen copy
of ``synth_scene`` and its helpers.

The traffic generator (``bench_cuda/frames.py``) builds every frame from
these scenes.  The copy keeps the frames fixed when the program's own
generator changes.  ``synth_scene`` returns ``(image [H, W] float32 in
[0, 1], corners [N, 2] float32 (u, v))``; ``scene_uint8`` scales an image to
uint8.
"""

from __future__ import annotations

from typing import List

import numpy as np


def _grid(h: int, w: int):
    v, u = np.mgrid[0:h, 0:w]
    return u.astype(np.float32), v.astype(np.float32)


def _seg_dist(u, v, a, b):
    """Distance from every pixel to segment a-b ([2] arrays)."""
    d = b - a
    l2 = float(d @ d) + 1e-9
    t = np.clip(((u - a[0]) * d[0] + (v - a[1]) * d[1]) / l2, 0.0, 1.0)
    pu = a[0] + t * d[0]
    pv = a[1] + t * d[1]
    return np.hypot(u - pu, v - pv)


def _draw_segment(img, u, v, a, b, value, width):
    img[_seg_dist(u, v, np.asarray(a, np.float32), np.asarray(b, np.float32)) <= width] = value


def _fill_convex(img, u, v, pts, value):
    """Fill a convex polygon given CCW vertices [K, 2]."""
    inside = np.ones(img.shape, bool)
    k = len(pts)
    for i in range(k):
        a, b = pts[i], pts[(i + 1) % k]
        inside &= (b[0] - a[0]) * (v - a[1]) - (b[1] - a[1]) * (u - a[0]) >= 0
    img[inside] = value


def _rand_convex(rng, h, w, n_min=3, n_max=6):
    """Random convex polygon: sorted angles around a center."""
    k = int(rng.integers(n_min, n_max + 1))
    cx = rng.uniform(0.2 * w, 0.8 * w)
    cy = rng.uniform(0.2 * h, 0.8 * h)
    radius = rng.uniform(0.08, 0.22) * min(h, w)
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    # Drop near-duplicate angles (degenerate, corner-less edges).
    keep = np.concatenate([[True], np.diff(ang) > 0.35])
    ang = ang[keep]
    if len(ang) < 3:
        return None
    r = radius * rng.uniform(0.7, 1.3, len(ang))
    pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], -1).astype(np.float32)
    return pts


def _smooth_noise(rng: np.random.Generator, h: int, w: int, scale: int) -> np.ndarray:
    """Corner-free smooth random field in [-1, 1]: low-res noise upsampled
    by repetition, then Gaussian-blurred so the blocky repetition corners
    vanish (scipy's separable filter)."""
    from scipy.ndimage import gaussian_filter

    small = rng.normal(0, 1, ((h + scale - 1) // scale + 2, (w + scale - 1) // scale + 2))
    big = np.repeat(np.repeat(small, scale, 0), scale, 1)[:h, :w]
    big = gaussian_filter(big, sigma=max(1.0, 0.6 * scale))
    m = np.abs(big).max() + 1e-9
    return (big / m).astype(np.float32)


def synth_scene(rng: np.random.Generator, h: int = 120, w: int = 160,
                rich_background: bool = False):
    """One synthetic scene: background gradient + noise, a few filled convex
    polygons, a few thick line segments, optionally a checkerboard patch.

    Corner labels: polygon vertices, segment endpoints, checkerboard inner
    crossings — the analytically-known corner set.

    ``rich_background`` adds corner-FREE smooth texture fields to the
    background so a detector trained on these scenes learns to score
    textured-but-cornerless regions low — the score-informativeness failure
    mode of the first DISK training round (VERDICT r4 weak #5: detections
    saturated the cap with background ranked alongside true corners).
    """
    u, v = _grid(h, w)
    gu = rng.uniform(-1, 1)
    gv = rng.uniform(-1, 1)
    img = 0.35 + 0.25 * (gu * u / w + gv * v / h) + rng.normal(0, 0.02, (h, w))
    img = img.astype(np.float32)
    if rich_background:
        for _ in range(int(rng.integers(1, 4))):
            scale = int(rng.integers(3, 9))
            amp = float(rng.uniform(0.05, 0.22))
            img += amp * _smooth_noise(rng, h, w, scale)
    corners: List[np.ndarray] = []

    for _ in range(int(rng.integers(2, 5))):
        pts = _rand_convex(rng, h, w)
        if pts is None:
            continue
        val = float(rng.uniform(0, 1))
        if abs(val - float(np.median(img))) < 0.2:
            val = (val + 0.5) % 1.0
        _fill_convex(img, u, v, pts, val)
        corners.append(pts)

    for _ in range(int(rng.integers(1, 4))):
        a = rng.uniform([0, 0], [w - 1, h - 1]).astype(np.float32)
        b = rng.uniform([0, 0], [w - 1, h - 1]).astype(np.float32)
        if np.hypot(*(b - a)) < 0.2 * min(h, w):
            continue
        _draw_segment(img, u, v, a, b, float(rng.uniform(0, 1)), rng.uniform(1.0, 2.5))
        corners.append(np.stack([a, b]))

    if rng.uniform() < 0.5:
        # Checkerboard patch: rows x cols cells of size s, axis-aligned.
        s = int(rng.integers(8, 16))
        nr, nc = int(rng.integers(2, 4)), int(rng.integers(2, 4))
        oy = int(rng.integers(0, max(1, h - nr * s)))
        ox = int(rng.integers(0, max(1, w - nc * s)))
        hi, lo = float(rng.uniform(0.6, 1.0)), float(rng.uniform(0.0, 0.4))
        for i in range(nr):
            for j in range(nc):
                val = hi if (i + j) % 2 == 0 else lo
                img[oy + i * s : oy + (i + 1) * s, ox + j * s : ox + (j + 1) * s] = val
        xs = ox + s * np.arange(nc + 1)
        ys = oy + s * np.arange(nr + 1)
        cross = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2).astype(np.float32)
        corners.append(cross)

    # Light blur (3x3 binomial) + sensor noise.
    k = np.array([0.25, 0.5, 0.25], np.float32)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    img = img + rng.normal(0, 0.01, (h, w)).astype(np.float32)
    img = np.clip(img, 0.0, 1.0).astype(np.float32)

    if corners:
        cs = np.concatenate(corners, 0)
        inb = (cs[:, 0] >= 2) & (cs[:, 0] < w - 2) & (cs[:, 1] >= 2) & (cs[:, 1] < h - 2)
        cs = cs[inb]
    else:
        cs = np.zeros((0, 2), np.float32)
    return img, cs


def scene_uint8(img: np.ndarray) -> np.ndarray:
    """[0, 1] float image -> uint8, clipped."""
    return np.clip(img * 255, 0, 255).astype(np.uint8)

