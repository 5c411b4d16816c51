"""NumPy oracle for the steered-BRIEF descriptor.

The port's copy of ``feature_detector_tpu/oracle/brief.py`` (plain numpy;
the test pattern is the port's ``kernels/brief_pattern.py``).  Encodes the behavior of BriefDescriptor::ComputeForOneFeature
(descriptor_brief.cpp:8-50): border rejection at 19 px, intensity-centroid
orientation over the (2*half+1)^2 patch, rotation of the 256 OpenCV test pairs,
and bit = I(p1) < I(p2).

Float-coordinate pixel reads use bilinear interpolation (decision Q1 in
SURVEY.md: the reference's GetPixelValueNoCheck float overload lives outside
the snapshot; bilinear is standard ORB practice and what we standardize on).
"""

from __future__ import annotations

import numpy as np

from ..core.config import BriefOptions
from ..kernels.brief_pattern import BRIEF_PATTERN

K_ZERO_FLOAT = 1e-10


def bilinear(image: np.ndarray, y, x):
    """Bilinear sample at float (row=y, col=x); no bounds check (callers stay
    inside the 19-px border, mirroring GetPixelValueNoCheck)."""
    img = image.astype(np.float32)
    y0 = np.floor(y).astype(np.int32)
    x0 = np.floor(x).astype(np.int32)
    wy = np.asarray(y, dtype=np.float32) - y0
    wx = np.asarray(x, dtype=np.float32) - x0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )


def compute_one(image: np.ndarray, uv, opts: BriefOptions):
    """Returns (bits[length] uint8, valid).  Out-of-border features keep the
    all-zero descriptor with valid=False (quirk Q5: the reference silently
    leaves them zero)."""
    x, y = float(uv[0]), float(uv[1])
    rows, cols = image.shape
    length = opts.length
    bits = np.zeros(length, dtype=np.uint8)

    max_bound = max(19.0, 2.0 * opts.half_patch_size)
    if x < max_bound or x > cols - max_bound or y < max_bound or y > rows - max_bound:
        return bits, False

    half = opts.half_patch_size
    dxs = np.arange(-half, half + 1, dtype=np.float32)
    dys = np.arange(-half, half + 1, dtype=np.float32)
    dxg, dyg = np.meshgrid(dxs, dys, indexing="xy")
    vals = bilinear(image, y + dyg, x + dxg)
    m10 = float(np.sum(dxg * vals))
    m01 = float(np.sum(dyg * vals))
    m = np.sqrt(m01 * m01 + m10 * m10)
    if m < K_ZERO_FLOAT:
        return bits, False
    sin_t, cos_t = m01 / m, m10 / m

    pat = BRIEF_PATTERN[:length].astype(np.float32)
    p1x = cos_t * pat[:, 0] - sin_t * pat[:, 1] + x
    p1y = sin_t * pat[:, 0] + cos_t * pat[:, 1] + y
    p2x = cos_t * pat[:, 2] - sin_t * pat[:, 3] + x
    p2y = sin_t * pat[:, 2] + cos_t * pat[:, 3] + y
    v1 = bilinear(image, p1y, p1x)
    v2 = bilinear(image, p2y, p2x)
    bits[:] = (v1 < v2).astype(np.uint8)
    return bits, True


def compute_one_binned(image: np.ndarray, uv, opts: BriefOptions):
    """Scalar oracle for the default descriptor path (kernels/brief.py:
    brief_compute_mxu): integer-rounded center, integer-pixel centroid
    moments, steering angle quantized to opts.steer_bins (OpenCV ORB
    practice), rotated offsets rounded to integer pixels, raw u8 reads."""
    x, y = int(np.rint(uv[0])), int(np.rint(uv[1]))
    rows, cols = image.shape
    length = opts.length
    bits = np.zeros(length, dtype=np.uint8)

    max_bound = max(19, 2 * opts.half_patch_size)
    if x < max_bound or x > cols - max_bound or y < max_bound or y > rows - max_bound:
        return bits, False

    img = image.astype(np.float64)
    half = 8
    dxs = np.arange(-half, half + 1)
    dxg, dyg = np.meshgrid(dxs, dxs, indexing="xy")
    vals = img[y + dyg, x + dxg]
    m10 = float((dxg * vals).sum())
    m01 = float((dyg * vals).sum())
    if np.hypot(m10, m01) < K_ZERO_FLOAT:
        return bits, False
    bins = opts.steer_bins
    b = int(np.rint(np.arctan2(m01, m10) * bins / (2.0 * np.pi))) % bins
    theta = 2.0 * np.pi * b / bins
    c, s = np.cos(theta), np.sin(theta)

    pat = BRIEF_PATTERN[:length].astype(np.float64)
    p1x = np.rint(c * pat[:, 0] - s * pat[:, 1]).astype(np.int64) + x
    p1y = np.rint(s * pat[:, 0] + c * pat[:, 1]).astype(np.int64) + y
    p2x = np.rint(c * pat[:, 2] - s * pat[:, 3]).astype(np.int64) + x
    p2y = np.rint(s * pat[:, 2] + c * pat[:, 3]).astype(np.int64) + y
    bits[:] = (image[p1y, p1x] < image[p2y, p2x]).astype(np.uint8)
    return bits, True


def compute_binned(image: np.ndarray, pixel_uv, opts: BriefOptions | None = None):
    """Batch loop for the binned semantics (the default path)."""
    opts = opts or BriefOptions()
    out = np.zeros((len(pixel_uv), opts.length), dtype=np.uint8)
    valid = np.zeros(len(pixel_uv), dtype=bool)
    for i, uv in enumerate(pixel_uv):
        out[i], valid[i] = compute_one_binned(image, uv, opts)
    return out, valid


def compute(image: np.ndarray, pixel_uv, opts: BriefOptions | None = None):
    """Batch loop (descriptor.h:28-40).  Returns (bits[N, length], valid[N])."""
    opts = opts or BriefOptions()
    out = np.zeros((len(pixel_uv), opts.length), dtype=np.uint8)
    valid = np.zeros(len(pixel_uv), dtype=bool)
    for i, uv in enumerate(pixel_uv):
        out[i], valid[i] = compute_one(image, uv, opts)
    return out, valid


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack [N, L] {0,1} into [N, L/32] uint32, bit j of word w = test 32*w+j."""
    n, length = bits.shape
    words = (length + 31) // 32
    padded = np.zeros((n, words * 32), dtype=np.uint64)
    padded[:, :length] = bits
    shifts = np.arange(32, dtype=np.uint64)
    grouped = padded.reshape(n, words, 32)
    return (grouped << shifts[None, None, :]).sum(axis=-1).astype(np.uint32)


def hamming_distance(packed_a: np.ndarray, packed_b: np.ndarray) -> np.ndarray:
    """[Na, W] x [Nb, W] -> [Na, Nb] Hamming distance matrix."""
    x = packed_a[:, None, :] ^ packed_b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1).astype(np.int32)
