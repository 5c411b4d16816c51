"""Plain NumPy reference of the classical front-end: FAST-12 response and
candidates, greedy response-ordered selection with square suppression,
steered BRIEF with binned angles, and cross-checked Hamming matching.

The semantics are those of the port's numpy oracles (the reference's
FeaturePointDetector, FAST detector and BriefDescriptor), written again here
vectorised so that a sample of a run's pairs is checked in seconds.  It
imports nothing of the program.

``steer_dtype`` is the precision of the steering angle: ``"float64"`` for
the reference, ``"bfloat16"`` for the control (the moments, the angle and
its scaling to bins each rounded to bfloat16), the step below the float32
that the configuration states.
"""

from __future__ import annotations

import numpy as np

from .brief_pattern import BRIEF_PATTERN

# FAST 16-pixel Bresenham circle as (dcol, drow), the reference's index order.
FAST_CIRCLE = np.array([(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
                        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)])
BIG = 1 << 20  # Hamming distance of a pair with an invalid side
MOMENT_HALF = 8  # 17x17 intensity-centroid window
BORDER = 19  # a descriptor needs this margin
NEAR_BIN = 1e-4  # an angle this close (in bins) to a rounding boundary may round either way in float32
_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


def fast_response(image: np.ndarray, n: int = 12, min_diff: int = 15) -> np.ndarray:
    """FAST arc length (the longest run of ring pixels all brighter than the
    centre + ``min_diff`` or all darker than the centre - ``min_diff``,
    around the wrapping ring, capped at 16) of every pixel 3 or more pixels
    from the border, 0 elsewhere; for ``n >= 12`` the compass pre-check
    (ring indices 4, 8 and 12 share a sign) gates it."""
    img = image.astype(np.int32)
    rows, cols = img.shape
    b = 3
    centre = img[b:rows - b, b:cols - b]
    h, w = centre.shape
    pos = np.zeros((h, w), np.uint64)
    neg = np.zeros((h, w), np.uint64)
    for k, (dc, dr) in enumerate(FAST_CIRCLE):
        ring = img[b + dr:b + dr + h, b + dc:b + dc + w]
        pos |= (ring > centre + min_diff).astype(np.uint64) << np.uint64(k)
        neg |= (ring < centre - min_diff).astype(np.uint64) << np.uint64(k)

    def longest_run(bits):
        x = bits | (bits << np.uint64(16))  # the ring twice: runs across index 0
        run = np.zeros((h, w), np.int32)
        for _ in range(16):
            run += x != 0
            x = x & (x << np.uint64(1))
        return run

    best = np.maximum(longest_run(pos), longest_run(neg))
    if n >= 12:
        compass = np.uint64((1 << 4) | (1 << 8) | (1 << 12))
        best = np.where(((pos & compass) == compass) | ((neg & compass) == compass), best, 0)
    out = np.zeros((rows, cols), np.float32)
    out[b:rows - b, b:cols - b] = best
    return out


def select(response: np.ndarray, threshold: float, needed: int, radius: int, capacity: int):
    """Greedy selection: candidates (response >= threshold and > 0) in
    descending response, ties in row-major order; each pick zeroes the
    clipped (2r+1)^2 square around it.  Returns (uv [capacity, 2] float32
    (x, y), response [capacity] float32, valid [capacity] bool), the picks
    as a prefix and zeros after it."""
    rows, cols = response.shape
    ys, xs = np.nonzero((response >= threshold) & (response > 0))
    vals = response[ys, xs]
    order = np.argsort(-vals, kind="stable")
    mask = np.ones((rows, cols), bool)
    uv = np.zeros((capacity, 2), np.float32)
    resp = np.zeros(capacity, np.float32)
    valid = np.zeros(capacity, bool)
    n = 0
    for i in order:
        y, x = int(ys[i]), int(xs[i])
        if not mask[y, x]:
            continue
        uv[n] = (x, y)
        resp[n] = vals[i]
        valid[n] = True
        n += 1
        if n >= min(needed, capacity):
            break
        mask[max(0, y - radius):y + radius + 1, max(0, x - radius):x + radius + 1] = False
    return uv, resp, valid


def rotated_offsets(length: int, bins: int) -> np.ndarray:
    """[bins, length, 4] int64 (p1x, p1y, p2x, p2y): the pattern rotated by
    2 pi b / bins and rounded to pixels."""
    pat = BRIEF_PATTERN[:length].astype(np.float64)
    theta = 2.0 * np.pi * np.arange(bins) / bins
    c, s = np.cos(theta)[:, None], np.sin(theta)[:, None]
    return np.rint(np.stack([c * pat[:, 0] - s * pat[:, 1], s * pat[:, 0] + c * pat[:, 1],
                             c * pat[:, 2] - s * pat[:, 3], s * pat[:, 2] + c * pat[:, 3]], -1)).astype(np.int64)


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def brief(image: np.ndarray, uv: np.ndarray, valid: np.ndarray, length: int = 256, bins: int = 30,
          steer_dtype: str = "float64"):
    """Steered BRIEF of one frame: integer centres (uv rounded half to even),
    intensity-centroid moments over the 17x17 window, the angle rounded to
    ``bins`` bins, the rotated pattern rounded to pixels, bit = I(p1) <
    I(p2).  Returns (words [N, length / 32] uint32, desc_valid [N] bool,
    near [N] bool: the angle lies within NEAR_BIN of a bin's rounding
    boundary, where float32 arithmetic may round it either way)."""
    rows, cols = image.shape
    img = image.astype(np.int64)
    x = np.rint(uv[:, 0]).astype(np.int64)
    y = np.rint(uv[:, 1]).astype(np.int64)
    ok = valid & (x >= BORDER) & (x <= cols - BORDER) & (y >= BORDER) & (y <= rows - BORDER)
    xs, ys = np.where(ok, x, BORDER), np.where(ok, y, BORDER)
    d = np.arange(-MOMENT_HALF, MOMENT_HALF + 1)
    win = img[ys[:, None, None] + d[None, :, None], xs[:, None, None] + d[None, None, :]]
    m10 = (win * d[None, None, :]).sum((1, 2)).astype(np.float64)
    m01 = (win * d[None, :, None]).sum((1, 2)).astype(np.float64)
    ok &= np.hypot(m10, m01) >= 1e-10
    t = np.arctan2(m01, m10) * bins / (2.0 * np.pi)
    if steer_dtype == "bfloat16":  # each step of the angle rounded to bfloat16
        theta = _round_bf16(np.arctan2(_round_bf16(m01), _round_bf16(m10)))
        t = _round_bf16(theta * _round_bf16(np.float32(bins / (2.0 * np.pi)))).astype(np.float64)
    elif steer_dtype != "float64":
        raise ValueError(f"unknown steer_dtype {steer_dtype!r}")
    near = np.abs(t - np.floor(t) - 0.5) < NEAR_BIN
    b = np.mod(np.rint(t).astype(np.int64), bins)
    offs = rotated_offsets(length, bins)[b]  # [N, length, 4]
    v1 = img[ys[:, None] + offs[..., 1], xs[:, None] + offs[..., 0]]
    v2 = img[ys[:, None] + offs[..., 3], xs[:, None] + offs[..., 2]]
    bits = (v1 < v2) & ok[:, None]
    return pack_bits(bits), ok, near & ok


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """[N, L] bool -> [N, L / 32] uint32, bit j of word w = test 32 w + j."""
    n, length = bits.shape
    grouped = bits.reshape(n, length // 32, 32).astype(np.uint64)
    return (grouped << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def match(words_a, valid_a, words_b, valid_b, max_distance: int = 64, cross_check: bool = True):
    """Per A slot the nearest B by Hamming distance (the first index wins a
    tie), kept when within ``max_distance`` and, with ``cross_check``, when
    that B's nearest A is this slot.  Returns (index [Na] int32, -1 when
    unmatched; distance [Na] int32, BIG when unmatched; valid [Na] bool)."""
    x = words_a[:, None, :] ^ words_b[None, :, :]
    d = _POPCOUNT8[x.view(np.uint8)].reshape(len(words_a), len(words_b), -1).sum(-1)
    d = np.where(valid_a[:, None] & valid_b[None, :], d, BIG)
    best_j = d.argmin(1)
    best = d[np.arange(len(d)), best_j]
    ok = valid_a & (best <= max_distance)
    if cross_check:
        ok &= d.argmin(0)[best_j] == np.arange(len(d))
    return (np.where(ok, best_j, -1).astype(np.int32), np.where(ok, best, BIG).astype(np.int32), ok)


def frame(image: np.ndarray, det: dict, brief_opts: dict, steer_dtype: str = "float64"):
    """Detection and description of one frame by the configuration's
    ``detector`` and ``brief`` sections: (uv, response, valid, words,
    desc_valid, near)."""
    resp = fast_response(image, det["fast_n"], det["fast_min_pixel_diff"])
    uv, r, v = select(resp, det["min_valid_response"], det["max_features"], det["min_feature_distance"],
                      det["max_features"])
    words, dvalid, near = brief(image, uv, v, brief_opts["length"], brief_opts["steer_bins"], steer_dtype)
    return uv, r, v, words, dvalid, near
