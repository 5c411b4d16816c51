"""Host-side image IO: decoding to grayscale uint8 arrays, saving, drawing.

Counterpart of ``feature_detector_tpu/io/images.py``.  Decoding needs PIL and
raises without it, as the JAX package's does.  ``save_image`` writes with
PIL when it is present and otherwise encodes the PNG itself with the
standard library (``zlib``, ``struct``): 8-bit grayscale, RGB or RGBA, one
IDAT chunk, every row with filter 0.  ``read_png`` reads such a file back
without PIL, and ``png_size`` checks any 8-bit PNG's header and data size.  Drawing works on uint8 RGB arrays in place.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

try:
    from PIL import Image as _PILImage

    _HAVE_PIL = True
except ImportError:
    _HAVE_PIL = False

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type (gray, RGB, RGBA)
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


def load_gray(path: str) -> np.ndarray:
    """An image file as HxW uint8 grayscale (luminance for colour inputs,
    as Visualizor2D::LoadImage)."""
    if not _HAVE_PIL:
        raise RuntimeError("PIL unavailable; cannot decode images")
    img = _PILImage.open(path)
    if img.mode != "L":
        img = img.convert("L")
    return np.asarray(img, dtype=np.uint8)


def load_rgb(path: str) -> np.ndarray:
    """An image file as HxWx3 uint8 RGB."""
    if not _HAVE_PIL:
        raise RuntimeError("PIL unavailable; cannot decode images")
    return np.asarray(_PILImage.open(path).convert("RGB"), dtype=np.uint8)


def _as_uint8(array) -> np.ndarray:
    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    if arr.ndim not in (2, 3) or (arr.ndim == 3 and arr.shape[2] not in (3, 4)):
        raise ValueError(f"cannot save an image of shape {arr.shape}")
    return np.ascontiguousarray(arr)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_png(array) -> bytes:
    """A uint8 HxW, HxWx3 or HxWx4 array (other dtypes clipped to [0, 255])
    as the bytes of a PNG file, with the standard library only."""
    arr = _as_uint8(array)
    h, w = arr.shape[:2]
    channels = 1 if arr.ndim == 2 else arr.shape[2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * channels)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[channels], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _parse_png(path: str):
    """(width, height, channels, image data) of an 8-bit, not interlaced
    PNG; the signature, chunk CRCs, header and the size of the decompressed
    image data are checked, and anything else raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {color}, interlace {interlace})")
    channels = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (1 + w * channels):
        raise ValueError(f"{path}: {len(raw)} bytes of image data for {w}x{h}x{channels}")
    return w, h, channels, raw


def png_size(path: str):
    """(width, height, channels) of an 8-bit PNG whose header, CRCs and
    image data size check out (any row filters), with the standard library
    only."""
    return _parse_png(path)[:3]


def read_png(path: str) -> np.ndarray:
    """A PNG written by ``encode_png`` (8-bit, filter 0 on every row) as
    HxW or HxWxC uint8, with the standard library only; ValueError for
    anything else."""
    w, h, channels, raw = _parse_png(path)
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows with a filter other than 0")
    img = rows[:, 1:].reshape(h, w, channels)
    return img[..., 0].copy() if channels == 1 else img.copy()


def save_image(path: str, array) -> None:
    """Writes a uint8 image (other dtypes clipped to [0, 255]) to ``path``:
    through PIL when it is present, else as a PNG encoded here."""
    arr = _as_uint8(array)
    if _HAVE_PIL:
        _PILImage.fromarray(arr).save(path)
        return
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def to_rgb(gray: np.ndarray) -> np.ndarray:
    """uint8 HxW -> uint8 HxWx3 (ImagePainter::ConvertUint8ToRgb)."""
    return np.repeat(gray[..., None], 3, axis=-1).copy()


def draw_solid_circle(rgb: np.ndarray, x: int, y: int, radius: int, color) -> None:
    """A filled circle (ImagePainter::DrawSolidCircle), clipped to the
    image; a circle wholly outside draws nothing."""
    h, w = rgb.shape[:2]
    y0, y1 = max(0, y - radius), min(h, y + radius + 1)
    x0, x1 = max(0, x - radius), min(w, x + radius + 1)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    m = (yy - y) ** 2 + (xx - x) ** 2 <= radius * radius
    rgb[y0:y1, x0:x1][m] = color


def draw_line(rgb: np.ndarray, x1: float, y1: float, x2: float, y2: float, color) -> None:
    """A line sampled at twice its length in pixels
    (ImagePainter::DrawBressenhanLine)."""
    n = int(max(abs(x2 - x1), abs(y2 - y1), 1)) * 2 + 1
    xs = np.linspace(x1, x2, n).round().astype(int)
    ys = np.linspace(y1, y2, n).round().astype(int)
    h, w = rgb.shape[:2]
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    rgb[ys[keep], xs[keep]] = color


CYAN = (0, 255, 255)
RED = (255, 0, 0)
GREEN = (0, 255, 0)
YELLOW = (255, 255, 0)
