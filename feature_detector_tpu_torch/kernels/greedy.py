"""Greedy response-ordered selection: the hand CUDA kernel and its wrapper.

Counterpart of ``feature_detector_tpu/kernels/greedy_pallas.py``: one source,
``csrc/greedy.cu``, replaces both Pallas kernels there (``_kernel_batched``
for a frame stack and ``_kernel`` for one frame, launched with B = 1).  A
call is two launches: a pass over every map that keys each 16x16 tile, then
one pick chain per frame.

A CUDA tensor launches the kernels; a CPU tensor takes the plain version
``detect.greedy_select_ref``.  Nothing else: there is no fallback from one to
the other.  ``greedy_select.launches`` counts kernel launches (tests,
``chip_smoke.py`` and ``trace.summary()`` read it).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from . import _build
from .detect import greedy_select_ref

GREEDY_TILE = 16  # tile side of csrc/greedy.cu


def _library() -> ctypes.CDLL:
    lib = _build.load("greedy")
    fn = lib.fd_greedy_select
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    lib.fd_greedy_workspace_bytes.restype = ctypes.c_longlong
    lib.fd_greedy_workspace_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def _launch(cand: torch.Tensor, max_picks: int, n_stop, radius: int):
    if cand.dtype != torch.float32:
        raise TypeError(f"greedy_select: candidate map must be float32, got {cand.dtype}")
    if cand.dim() not in (2, 3):
        raise ValueError(f"greedy_select: candidate map must be [H, W] or [B, H, W], got {tuple(cand.shape)}")
    if not cand.is_contiguous():
        raise ValueError("greedy_select: candidate map must be contiguous")
    if max_picks < 1 or radius < 0:
        raise ValueError(f"greedy_select: need max_picks >= 1 and radius >= 0, got {max_picks}, {radius}")
    single = cand.dim() == 2
    maps = cand[None] if single else cand
    b, rows, cols = maps.shape
    if b == 0 or rows == 0 or cols == 0:
        raise ValueError(f"greedy_select: empty candidate map {tuple(cand.shape)}")
    if rows * cols >= 2**32 - 1:
        raise ValueError(f"greedy_select: a frame of {rows}x{cols} pixels has no 32-bit flat index")
    dev = cand.device
    if isinstance(n_stop, torch.Tensor):
        if n_stop.device != dev:
            raise ValueError(f"greedy_select: n_stop on {n_stop.device}, map on {dev}")
        if n_stop.numel() not in (1, b):
            raise ValueError(f"greedy_select: n_stop must be a scalar or [{b}], got {tuple(n_stop.shape)}")
        stop = n_stop.to(torch.int32).reshape(-1).expand(b).contiguous()
    else:
        stop = torch.full((b,), int(n_stop), dtype=torch.int32, device=dev)
    out = torch.zeros((b, max_picks, 4), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        ws = torch.empty((b * lib.fd_greedy_workspace_bytes(rows, cols) // 8,), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fd_greedy_select(maps.data_ptr(), stop.data_ptr(), ws.data_ptr(), out.data_ptr(),
                                   b, rows, cols, max_picks, radius, stream)
    if err != 0:
        raise RuntimeError(f"greedy_select kernel launch failed: cudaError {err}")
    greedy_select.launches += 2
    uv, resp, valid = out[..., 0:2], out[..., 2], out[..., 3] > 0.5
    if single:
        return uv[0], resp[0], valid[0]
    return uv, resp, valid


def greedy_select(cand: torch.Tensor, max_picks: int, n_stop, radius: int):
    """Greedy selection over ``[H, W]`` or ``[B, H, W]`` f32 candidate maps.

    ``n_stop`` is an int or a ``[B]`` int32 tensor (picks still wanted per
    frame).  Returns (uv [.., max_picks, 2] f32 (x, y), resp [.., max_picks]
    f32, valid [.., max_picks] bool), equal bit for bit to
    ``greedy_select_ref`` and to the JAX package's ``greedy_select_lax``.

    Candidate maps must be finite (responses are finite by construction);
    entries <= 0 are never picked.  On the card a call is two kernel
    launches and a frame must hold fewer than 2^32 - 1 pixels.
    """
    with trace.span("kernels.greedy_select"):
        if cand.device.type == "cuda":
            return _launch(cand, max_picks, n_stop, radius)
        if cand.device.type == "cpu":
            return greedy_select_ref(cand, max_picks, n_stop, radius)
    raise ValueError(f"greedy_select: unsupported device {cand.device}")


greedy_select.launches = 0
trace.count_launches("greedy_select", greedy_select)
