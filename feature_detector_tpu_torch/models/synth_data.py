"""Synthetic scenes made from a seed, in numpy.

The port's own copy of ``synth_scene`` and its helpers from
``feature_detector_tpu/models/synth_data.py``, so that frames can be made
without the JAX package.  Every generator returns ``(image [H, W] float32 in
[0, 1], corners [N, 2] float32 (u, v))``; ``scene_uint8`` scales an image to
uint8 as the tests of the JAX package do.  ``tile_edge_ties`` makes
candidate maps for the seams of a tiled greedy-selection kernel.

The training half (``random_homography``, ``apply_homography``,
``cell_labels``, ``make_batch``) makes the batches of
``models/train_superpoint.py`` and ``models/train_disk.py``: pure numpy, so
the same ``np.random.Generator`` gives the JAX package's arrays bit for bit.
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


def tile_edge_ties(rng: np.random.Generator, shape, tile: int, signed_frame: int | None = None) -> np.ndarray:
    """Candidate maps ``[B, H, W]`` float32 for the seams of a greedy
    selection that keys ``tile``-px tiles (H >= 4 tile, W >= 8 tile): 5% of
    the pixels hold 0.5, and ten pixels of every frame hold the maximum 3.0,
    on both sides of tile edges, in three corners and far apart, so that
    row-major order decides among them.  Frame ``signed_frame``, if given,
    has its first 30 rows negated and the next 10 set to -0."""
    _, h, w = shape
    t = tile
    m = np.where(rng.random(shape) < 0.05, 0.5, 0.0).astype(np.float32)
    for y, x in ((t - 1, t - 1), (t - 1, t), (t, t - 1), (t, t), (40, 3 * t - 1), (40, 3 * t),
                 (0, w - 1), (h - 1, 0), (h - 1, w - 1), (4 * t - 1, 8 * t - 1)):
        m[:, y, x] = 3.0
    if signed_frame is not None:
        m[signed_frame, :30] = -m[signed_frame, :30]
        m[signed_frame, 30:40] = -0.0
    return m


def random_homography(rng: np.random.Generator, h: int, w: int,
                      max_angle: float = 0.35, max_scale: float = 0.25,
                      max_shift: float = 0.12, max_persp: float = 5e-4) -> np.ndarray:
    """Random homography [3, 3] float32 mapping (u, v) pixel coordinates,
    centred on the image: rotation, scale, shift and a little perspective."""
    ang = rng.uniform(-max_angle, max_angle)
    sc = 1.0 + rng.uniform(-max_scale, max_scale)
    ca, sa = np.cos(ang) * sc, np.sin(ang) * sc
    tu = rng.uniform(-max_shift, max_shift) * w
    tv = rng.uniform(-max_shift, max_shift) * h
    pu = rng.uniform(-max_persp, max_persp)
    pv = rng.uniform(-max_persp, max_persp)
    c = np.array([w / 2.0, h / 2.0], np.float32)
    T1 = np.array([[1, 0, -c[0]], [0, 1, -c[1]], [0, 0, 1]], np.float32)
    A = np.array([[ca, -sa, tu], [sa, ca, tv], [pu, pv, 1.0]], np.float32)
    T2 = np.array([[1, 0, c[0]], [0, 1, c[1]], [0, 0, 1]], np.float32)
    return (T2 @ A @ T1).astype(np.float32)


def apply_homography(H: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """[N, 2] (u, v) -> warped (u, v)."""
    x = np.concatenate([uv, np.ones((len(uv), 1), uv.dtype)], 1) @ H.T
    return x[:, :2] / np.maximum(np.abs(x[:, 2:]), 1e-9) * np.sign(x[:, 2:])


def cell_labels(corners: np.ndarray, h: int, w: int, cell: int = 8) -> np.ndarray:
    """65-way cell labels [H/8, W/8] int32: the position in its cell of a
    corner, (v % 8) * 8 + u % 8, or 64 (the dustbin) for an empty cell; the
    last corner of a cell wins.  SuperPoint's detector target."""
    hc, wc = h // cell, w // cell
    lab = np.full((hc, wc), cell * cell, np.int32)
    for cu, cv in corners:
        ui, vi = int(cu), int(cv)
        if 0 <= ui < wc * cell and 0 <= vi < hc * cell:
            lab[vi // cell, ui // cell] = (vi % cell) * cell + (ui % cell)
    return lab


def make_batch(rng: np.random.Generator, batch: int, h: int, w: int, rich_background: bool = False) -> dict:
    """One training batch of numpy arrays:

    - ``image`` [B, H, W] float32, the frames A;
    - ``label_a`` [B, H/8, W/8] int32, their 65-way cell labels;
    - ``H_ab`` [B, 3, 3] float32, the homography from A's pixels to B's;
    - ``label_b`` [B, H/8, W/8] int32, the labels in the warped frame B.

    The trainers warp A into B themselves (``train_superpoint.warp_bilinear``).
    """
    imgs = np.zeros((batch, h, w), np.float32)
    lab_a = np.zeros((batch, h // 8, w // 8), np.int32)
    lab_b = np.zeros((batch, h // 8, w // 8), np.int32)
    Hs = np.zeros((batch, 3, 3), np.float32)
    for b in range(batch):
        img, cs = synth_scene(rng, h, w, rich_background=rich_background)
        Hm = random_homography(rng, h, w)
        imgs[b] = img
        Hs[b] = Hm
        lab_a[b] = cell_labels(cs, h, w)
        lab_b[b] = cell_labels(apply_homography(Hm, cs) if len(cs) else cs, h, w)
    return {"image": imgs, "label_a": lab_a, "label_b": lab_b, "H_ab": Hs}
