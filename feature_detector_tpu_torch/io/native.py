"""ctypes bindings of the native host engine (``native/fd_host.cpp``).

Counterpart of ``feature_detector_tpu/io/native.py``, which cannot be
imported without JAX.  The engine is a single-thread CPU implementation of
FAST with greedy selection, steered BRIEF, Hamming matching and LSD, for
latency-critical single frames on the host and as a fast CPU reference.  It
is built on demand with ``make -C native``; every entry point raises when
the library cannot be built or loaded (``available()`` says which).  It
needs numpy and the port's own BRIEF pattern
(``kernels/brief_pattern.py``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

from ..kernels.brief_pattern import BRIEF_PATTERN

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                         "native", "libfd_host.so")
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        subprocess.run(["make", "-C", os.path.dirname(_LIB_PATH)], check=True, capture_output=True)
    lib = ctypes.CDLL(_LIB_PATH)
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c = ctypes.c_int
    lib.fd_fast_detect.restype = c
    lib.fd_fast_detect.argtypes = [u8p, c, c, c, c, ctypes.c_float, c, f32p, c, c, f32p, f32p, c]
    lib.fd_brief_compute.restype = None
    lib.fd_brief_compute.argtypes = [u8p, c, c, f32p, c, i16p, c, c, u32p, u8p]
    lib.fd_hamming_match.restype = None
    lib.fd_hamming_match.argtypes = [u32p, u8p, c, u32p, u8p, c, c, c, c, i32p, i32p]
    lib.fd_lsd_detect.restype = c
    lib.fd_lsd_detect.argtypes = [u8p, c, c, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                  f32p, c]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def fast_detect(
    image: np.ndarray,
    needed_num: int,
    min_response: float = 0.1,
    min_distance: int = 15,
    n_threshold: int = 12,
    diff: int = 15,
    existing: Optional[np.ndarray] = None,
    max_out: int = 1024,
) -> Tuple[np.ndarray, np.ndarray]:
    """FAST detection and greedy selection.  Returns (uv [N, 2], response
    [N]) of the new features only; ``existing`` features seed the
    suppression mask (reference quirk Q9)."""
    lib = _load()
    image = np.ascontiguousarray(image, np.uint8)
    ex = np.ascontiguousarray(existing if existing is not None else np.zeros((0, 2)), np.float32).reshape(-1, 2)
    out_uv = np.zeros((max_out, 2), np.float32)
    out_resp = np.zeros(max_out, np.float32)
    n = lib.fd_fast_detect(image, image.shape[0], image.shape[1], n_threshold, diff, ctypes.c_float(min_response),
                           min_distance, np.ascontiguousarray(ex), len(ex), needed_num, out_uv, out_resp, max_out)
    return out_uv[:n].copy(), out_resp[:n].copy()


def brief_compute(image: np.ndarray, uv: np.ndarray, length: int = 256,
                  half_patch: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Steered BRIEF.  Returns (words [N, length / 32] uint32, valid [N] bool)."""
    lib = _load()
    image = np.ascontiguousarray(image, np.uint8)
    uv = np.ascontiguousarray(uv, np.float32).reshape(-1, 2)
    n = len(uv)
    out_words = np.zeros((n, (length + 31) // 32), np.uint32)
    out_valid = np.zeros(n, np.uint8)
    lib.fd_brief_compute(image, image.shape[0], image.shape[1], uv, n,
                         np.ascontiguousarray(BRIEF_PATTERN, np.int16), length, half_patch, out_words, out_valid)
    return out_words, out_valid.astype(bool)


def lsd_detect(
    image: np.ndarray,
    min_grad_norm: float = 20.0,
    tol_rad: float = 22.5 * np.pi / 180.0,
    min_length: float = 20.0,
    min_inlier_ratio: float = 0.6,
    max_out: int = 1024,
) -> np.ndarray:
    """LSD line segments (the single-thread CPU engine).  Returns [N, 4]
    float32 (x1, y1, x2, y2)."""
    lib = _load()
    image = np.ascontiguousarray(image, np.uint8)
    out = np.zeros((max_out, 4), np.float32)
    n = lib.fd_lsd_detect(image, image.shape[0], image.shape[1], ctypes.c_float(min_grad_norm),
                          ctypes.c_float(tol_rad), ctypes.c_float(min_length), ctypes.c_float(min_inlier_ratio),
                          out, max_out)
    return out[:n].copy()


def hamming_match(
    words_a: np.ndarray, valid_a: np.ndarray,
    words_b: np.ndarray, valid_b: np.ndarray,
    max_distance: int = 64, cross_check: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (index [Na] int32, -1 where unmatched; distance [Na] int32)."""
    lib = _load()
    wa = np.ascontiguousarray(words_a, np.uint32)
    wb = np.ascontiguousarray(words_b, np.uint32)
    va = np.ascontiguousarray(valid_a, np.uint8)
    vb = np.ascontiguousarray(valid_b, np.uint8)
    na, words = wa.shape
    out_index = np.zeros(na, np.int32)
    out_dist = np.zeros(na, np.int32)
    lib.fd_hamming_match(wa, va, na, wb, vb, wb.shape[0], words, max_distance, 1 if cross_check else 0,
                         out_index, out_dist)
    return out_index, out_dist
