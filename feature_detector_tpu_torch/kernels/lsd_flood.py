"""LSD region flood: the hand CUDA kernel, its plain version, and the stencil
helpers that ``kernels/lsd.py`` shares.

Counterpart of ``feature_detector_tpu/kernels/lsd_pallas.py``: the kernel
``csrc/lsd_flood.cu`` replaces its Pallas kernel ``_sweep_kernel``.  One
"path-running-mean" sweep (``sweep_running`` in
``feature_detector_tpu/kernels/lsd.py``) updates four state planes on the
gradient grid:

- ``pri``  f32, the priority (gradient norm) of the pixel's seed, -1 if none;
- ``seed`` int32, the seed's flat index, ``big = rows * cols + 1`` if none;
- ``gang`` f32, the gate angle: the running mean of the level-line angles
  along the path from the seed;
- ``cnt``  f32, that path's length.

Each valid pixel looks at its 8 neighbours in ``SHIFTS`` order and adopts the
best one whose gate angle is within ``tol`` of its own angle (wrapped to
[-pi, pi]): higher priority first, then lower seed.  On adoption the gate
angle moves by d / m towards the pixel's angle and m = cnt + 1.  Sweeps are
Jacobi: each reads only the previous sweep's state.

A CUDA tensor launches the kernel, one launch per ``SWEEPS_PER_LAUNCH``
sweeps over 32x32 tiles (``FLOOD_TILE``) that hold a halo as wide as their
sweep count; tiles without a valid pixel are skipped.  A CPU tensor takes the
plain version ``running_sweeps_ref``.  There is no fallback from one to the
other.  ``propagate_running.launches`` counts kernel launches (tests,
``chip_smoke.py`` and ``trace.summary()`` read it).

Float32 throughout, as in the JAX package: pi, 2 pi and ``tol`` are rounded
to float32 before any comparison, so a difference of exactly float32(pi) is
not wrapped.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import trace
from . import _build

SWEEPS_PER_LAUNCH = 16  # K of csrc/lsd_flood.cu
FLOOD_TILE = 32  # tile side of csrc/lsd_flood.cu
SHIFTS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))
PI = float(np.float32(math.pi))
TWO_PI = float(np.float32(2.0 * math.pi))

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def f32(x: float) -> float:
    """``x`` rounded to float32, as JAX rounds a Python float next to a
    float32 array."""
    return float(np.float32(x))


def shift(x: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """``out[r, c] = x[r + dr, c + dc]`` over the last two dims, ``fill``
    outside the grid."""
    rows, cols = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    return p[..., 1 + dr : 1 + dr + rows, 1 + dc : 1 + dc + cols]


def wrap(d: torch.Tensor) -> torch.Tensor:
    """An angle difference brought into [-pi, pi] by one turn of float32(2 pi)."""
    d = torch.where(d > PI, d - TWO_PI, d)
    return torch.where(d < -PI, d + TWO_PI, d)


def angle_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return wrap(a - b)


def sentinel(shape) -> int:
    """The seed index that means "no seed": one past the grid's last index."""
    return shape[-2] * shape[-1] + 1


def initial_state(norm: torch.Tensor, angle: torch.Tensor, valid: torch.Tensor) -> State:
    """Every valid pixel its own seed, with its norm as priority, its angle as
    gate angle and a path length of 1; invalid pixels hold the sentinels."""
    g_rows, g_cols = angle.shape
    flat = torch.arange(g_rows * g_cols, dtype=torch.int32, device=angle.device).reshape(g_rows, g_cols)
    return (
        torch.where(valid, norm, -1.0),
        torch.where(valid, flat, sentinel(angle.shape)),
        torch.where(valid, angle, 0.0),
        torch.ones_like(norm),
    )


def running_sweeps_ref(angle: torch.Tensor, valid: torch.Tensor, state: State, n_sweeps: int, tol: float) -> State:
    """The plain version: ``n_sweeps`` sweeps as torch ops, one sweep at a
    time (``sweep_running``, feature_detector_tpu/kernels/lsd.py:156-188)."""
    big = sentinel(angle.shape)
    tol = f32(tol)
    pri, seed, gang, cnt = state
    for _ in range(n_sweeps):
        pp, ps = F.pad(pri, (1, 1, 1, 1), value=-1.0), F.pad(seed, (1, 1, 1, 1), value=big)
        pg, pc = F.pad(gang, (1, 1, 1, 1), value=0.0), F.pad(cnt, (1, 1, 1, 1), value=1.0)
        rows, cols = angle.shape
        best_p, best_s, best_g, best_m = pri, seed, gang, cnt
        for dr, dc in SHIFTS:
            win = (slice(1 + dr, 1 + dr + rows), slice(1 + dc, 1 + dc + cols))
            n_pri, n_seed, n_gang, n_cnt = pp[win], ps[win], pg[win], pc[win]
            d = angle_diff(angle, n_gang)
            gate = valid & (n_seed < big) & (d.abs() <= tol)
            better = gate & ((n_pri > best_p) | ((n_pri == best_p) & (n_seed < best_s)))
            m = n_cnt + 1.0
            g_new = wrap(n_gang + d / m)
            best_p = torch.where(better, n_pri, best_p)
            best_s = torch.where(better, n_seed, best_s)
            best_g = torch.where(better, g_new, best_g)
            best_m = torch.where(better, m, best_m)
        pri, seed, gang, cnt = best_p, best_s, best_g, best_m
    return pri, seed, gang, cnt


def _library() -> ctypes.CDLL:
    lib = _build.load("lsd_flood")
    fn = lib.fd_lsd_flood
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    return lib


_PLANE_DTYPES = (("angle", torch.float32), ("valid", torch.bool), ("pri", torch.float32),
                 ("seed", torch.int32), ("gang", torch.float32), ("cnt", torch.float32))


def _launch_sweeps(angle: torch.Tensor, valid: torch.Tensor, state: State, n_sweeps: int, tol: float) -> State:
    planes = (angle, valid, *state)
    if angle.dim() != 2 or angle.numel() == 0:
        raise ValueError(f"lsd flood: planes must be a non-empty [rows, cols] grid, got {tuple(angle.shape)}")
    if angle.numel() >= 2**31 - 1:
        raise ValueError(f"lsd flood: grid {tuple(angle.shape)} too large for int32 seed indices")
    for (name, dtype), t in zip(_PLANE_DTYPES, planes):
        if t.dtype != dtype:
            raise TypeError(f"lsd flood: {name} must be {dtype}, got {t.dtype}")
        if t.shape != angle.shape:
            raise ValueError(f"lsd flood: {name} has shape {tuple(t.shape)}, angle {tuple(angle.shape)}")
        if t.device != angle.device:
            raise ValueError(f"lsd flood: {name} on {t.device}, angle on {angle.device}")
        if not t.is_contiguous():
            raise ValueError(f"lsd flood: {name} must be contiguous")
    if n_sweeps < 0:
        raise ValueError(f"lsd flood: n_sweeps must be >= 0, got {n_sweeps}")
    if n_sweeps == 0:
        return state
    rows, cols = angle.shape
    n_launches = -(-n_sweeps // SWEEPS_PER_LAUNCH)
    buf_a = tuple(torch.empty_like(s) for s in state)
    buf_b = tuple(torch.empty_like(s) for s in state) if n_launches > 1 else buf_a
    lib = _library()
    with torch.cuda.device(angle.device):
        stream = torch.cuda.current_stream(angle.device).cuda_stream
        err = lib.fd_lsd_flood(*(t.data_ptr() for t in (*planes, *buf_a, *buf_b)),
                               rows, cols, n_sweeps, f32(tol), stream)
    if err != 0:
        raise RuntimeError(f"lsd flood kernel launch failed: cudaError {err}")
    propagate_running.launches += n_launches
    # Launch j writes buffer A when j is even, B when odd.
    return buf_a if n_launches % 2 == 1 else buf_b


def running_sweeps(angle: torch.Tensor, valid: torch.Tensor, state: State, n_sweeps: int, tol: float) -> State:
    """``n_sweeps`` path-running-mean sweeps of ``state``; the kernel for CUDA
    tensors (ceil(n_sweeps / SWEEPS_PER_LAUNCH) launches), the plain version
    for CPU tensors.  The caller's state is not modified."""
    if angle.device.type == "cuda":
        return _launch_sweeps(angle, valid, state, n_sweeps, tol)
    if angle.device.type == "cpu":
        return running_sweeps_ref(angle, valid, state, n_sweeps, tol)
    raise ValueError(f"lsd flood: unsupported device {angle.device}")


def labels_of(seed: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Seed flat indices as int32 region labels, -1 where invalid or unseeded."""
    return torch.where(valid & (seed < sentinel(seed.shape)), seed, -1)


def propagate_running(norm: torch.Tensor, angle: torch.Tensor, valid: torch.Tensor,
                      total_sweeps: int, tol: float) -> torch.Tensor:
    """The path-running-mean flood from the initial state: int32 labels (seed
    flat index on the original grid, -1 where invalid), equal to
    ``propagate_running_pallas`` and to the JAX package's ("R", n) schedule.
    Exactly ``total_sweeps`` sweeps run."""
    state = initial_state(norm, angle, valid)
    _, seed, _, _ = running_sweeps(angle, valid, state, total_sweeps, tol)
    return labels_of(seed, valid)


propagate_running.launches = 0
trace.count_launches("propagate_running", propagate_running)
