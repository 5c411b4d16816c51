"""FAST detection maps: the hand CUDA kernel and its wrapper.

``csrc/fast.cu`` replaces no Pallas kernel: the JAX package computes FAST as
jnp ops (``feature_detector_tpu/kernels/detect.py:124``).  On the card it
takes the uint8 stack to the float32 candidate map that the greedy
selection reads, and on request the response map, in one launch, equal bit
for bit to the plain chain ``detect.fast_response`` +
``detect.fast_candidates``.

A CUDA tensor launches the kernel; a CPU tensor takes the plain chain.
Nothing else: there is no fallback from one to the other.
``fast_maps.launches`` counts kernel launches (tests, ``chip_smoke.py`` and
``trace.summary()`` read it).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.config import FastOptions
from ..utils import trace
from . import _build
from .detect import fast_candidates, fast_response

TILE_ROWS = 32  # tile of csrc/fast.cu: a grid row of blocks covers 32 rows


def _library() -> ctypes.CDLL:
    lib = _build.load("fast")
    fn = lib.fd_fast_maps
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    return lib


def _check(image: torch.Tensor, mask) -> None:
    if not isinstance(image, torch.Tensor) or image.dtype != torch.uint8:
        raise TypeError(f"fast_maps: image must be a uint8 tensor, got {getattr(image, 'dtype', type(image))}")
    if image.dim() not in (2, 3):
        raise ValueError(f"fast_maps: image must be [H, W] or [B, H, W], got {tuple(image.shape)}")
    if image.numel() == 0:
        raise ValueError(f"fast_maps: empty image {tuple(image.shape)}")
    if not image.is_contiguous():
        raise ValueError("fast_maps: image must be contiguous")
    if mask is None:
        return
    if not isinstance(mask, torch.Tensor) or mask.dtype != torch.int32:
        raise TypeError(f"fast_maps: mask must be an int32 tensor, got {getattr(mask, 'dtype', type(mask))}")
    if tuple(mask.shape) not in (tuple(image.shape[-2:]), tuple(image.shape)):
        raise ValueError(f"fast_maps: mask {tuple(mask.shape)} is neither [H, W] nor the image's "
                         f"{tuple(image.shape)}")
    if not mask.is_contiguous():
        raise ValueError("fast_maps: mask must be contiguous")
    if mask.device != image.device:
        raise ValueError(f"fast_maps: mask on {mask.device}, image on {image.device}")


def _launch(image: torch.Tensor, mask, sub: FastOptions, threshold: float, want_response: bool):
    rows, cols = image.shape[-2:]
    if rows * cols >= 2**31 or rows > 65535 * TILE_ROWS:
        raise ValueError(f"fast_maps: a frame of {rows}x{cols} pixels is too large for the kernel")
    batch = image.numel() // (rows * cols)
    dev = image.device
    cand = torch.empty(image.shape, dtype=torch.float32, device=dev)
    resp = torch.empty(image.shape, dtype=torch.float32, device=dev) if want_response else None
    # Against uint8 values any difference beyond 256 compares as 256 does; only n >= 12 matters.
    diff = max(-256, min(256, int(sub.min_pixel_diff_value)))
    mask_stride = 0 if mask is None or mask.dim() == 2 else rows * cols
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fd_fast_maps(image.data_ptr(), None if mask is None else mask.data_ptr(), mask_stride,
                               cand.data_ptr(), None if resp is None else resp.data_ptr(),
                               batch, rows, cols, int(sub.n >= 12), diff, float(threshold), stream)
    if err != 0:
        raise RuntimeError(f"fast_maps kernel launch failed: cudaError {err}")
    fast_maps.launches += 1
    return cand, resp


def fast_maps(image: torch.Tensor, mask, sub: FastOptions, threshold: float, want_response: bool):
    """FAST over a ``[H, W]`` or ``[B, H, W]`` uint8 image.

    ``mask``: None (every pixel may respond), or an int32 ``[H, W]`` mask
    (broadcast over the batch) or one of the image's shape; pixels where it
    is 0 respond 0.  Returns (candidate map, response map or None), float32
    of the image's shape: the response where it is ``>= threshold`` and
    ``> 0``, else 0, and the response itself when ``want_response``.  Equal
    bit for bit to ``detect.fast_candidates(detect.fast_response(...),
    threshold)``.  On the card a call is one kernel launch.
    """
    _check(image, mask)
    if image.device.type == "cuda":
        return _launch(image, mask, sub, threshold, want_response)
    if image.device.type == "cpu":
        if mask is None:
            mask = torch.ones(image.shape[-2:], dtype=torch.int32)
        resp = fast_response(image, mask, sub)
        return fast_candidates(resp, threshold), resp if want_response else None
    raise ValueError(f"fast_maps: unsupported device {image.device}")


fast_maps.launches = 0
trace.count_launches("fast_maps", fast_maps)
