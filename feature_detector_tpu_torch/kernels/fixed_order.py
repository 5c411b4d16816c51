"""Fixed-order contraction (K4) and dense solve (K5): the hand CUDA kernels
and their plain versions.

They replace no Pallas kernel.  ``csrc/fixed_order.cu`` was added so that a
float32 problem's bits do not depend on how many problems share its batch:
cuBLAS, torch's reductions and cuSOLVER pick their algorithm, and so their
rounding, by the batch's size.  Here the order of every sum depends only on
the problem's own shape (the source says which), and the plain versions
below repeat that order in elementwise torch ops, which round each element
alone on the CPU and on the card.

- ``fixed_contract(a, c)``: ``a @ c`` for [..., M, K] and [..., K, N]
  float32, batch axes broadcast; ``fixed_sum(x)``: the sum over the last
  axis.  One launch of K4 each.
- ``fixed_lu_solve(a, b)``: ``a^-1 b`` for [..., n, n] and [..., n]
  float32, n <= LU_MAX_N, by LU with partial pivoting (the first row of
  largest magnitude); a singular system gives inf/NaN and does not raise.
  One launch of K5.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``contract_ref``, ``sum_ref``, ``lu_solve_ref``).  There is no fallback from
one to the other.  The kernels read their operands as the strided views
they are (transposed, broadcast, up to ``MAX_BATCH_DIMS`` batch axes after
``batch_layout`` merges them), so a call copies nothing and launches one
kernel.  ``fixed_contract.launches`` counts K4's launches (both
entry points), ``fixed_lu_solve.launches`` K5's (tests, ``chip_smoke.py``
and ``trace.summary()`` read them).
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils import trace
from . import _build

SERIAL_MAX_K = 16  # kSerialMaxK of csrc/fixed_order.cu: one serial sum an output at and below it
LANES = 32  # kLanes: above it, 32 strided partial sums folded pairwise
LU_MAX_N = 104  # kLuMaxN
MAX_BATCH_DIMS = 8  # kMaxBatchDims: batch axes a launch takes, after batch_layout merges them


def lanes(k: int) -> int:
    """The number of partial sums K4 keeps for a sum over ``k`` terms."""
    return 1 if k <= SERIAL_MAX_K else LANES


GROUP_TERMS = 1 << 20  # terms the plain version forms with one elementwise product


def _ordered_sum(term: Callable[[int, int], torch.Tensor], k: int, n_out: int) -> torch.Tensor:
    """K4's order over ``k`` terms for ``n_out`` outputs, where ``term(lo,
    hi)`` gives terms lo..hi-1 on a new last axis: serial for k <=
    SERIAL_MAX_K; else LANES strided partial sums (a term past k is +0),
    folded by halves.  Terms are formed a group of steps at a time, about
    GROUP_TERMS at once; the sums run step by step."""
    p = lanes(k)
    steps = -(-k // p)
    per_group = max(1, GROUP_TERMS // max(n_out * p, 1))
    acc = None
    for first in range(0, steps, per_group):
        lo, hi = first * p, min((first + per_group) * p, k)
        t = term(lo, hi)
        if (hi - lo) % p:
            t = F.pad(t, (0, p - (hi - lo) % p))
        for i in range(0, t.shape[-1], p):
            acc = t[..., i:i + p] if acc is None else acc + t[..., i:i + p]
    h = p // 2
    while h:
        acc = acc[..., :h] + acc[..., h:2 * h]
        h //= 2
    return acc[..., 0]


def contract_ref(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fixed_contract``: [..., M, K] @ [..., K, N] in
    K4's order, elementwise (so also inside ``torch.func`` transforms)."""
    k = a.shape[-1]
    if k == 0:
        return _zeros_product(a, c)
    ct = c.transpose(-1, -2).contiguous()
    n_out = torch.broadcast_shapes(a.shape[:-2], c.shape[:-2]).numel() * a.shape[-2] * c.shape[-1]
    return _ordered_sum(lambda lo, hi: a[..., :, None, lo:hi] * ct[..., None, :, lo:hi], k, n_out)


def sum_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fixed_sum``: [..., K] -> [...] in K4's order."""
    k = x.shape[-1]
    if k == 0:
        return x.new_zeros(x.shape[:-1])
    return _ordered_sum(lambda lo, hi: x[..., lo:hi], k, x.numel() // k)


def lu_solve_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fixed_lu_solve``: K5's elimination, column by
    column, in torch ops."""
    batch, n = torch.broadcast_shapes(a.shape[:-2], b.shape[:-1]), a.shape[-1]
    m = a.expand(*batch, n, n).reshape(-1, n, n).clone()
    x = b.expand(*batch, n).reshape(-1, n).clone()
    rows = torch.arange(m.shape[0], device=a.device)
    for j in range(n):
        p = j + torch.argmax(m[:, j:, j].abs(), dim=-1)  # the first largest; a NaN counts as largest
        row_j, row_p = m[rows, j].clone(), m[rows, p].clone()
        m[rows, j], m[rows, p] = row_p, row_j
        x_j, x_p = x[rows, j].clone(), x[rows, p].clone()
        x[rows, j], x[rows, p] = x_p, x_j
        if j + 1 < n:
            lower = m[:, j + 1:, j] / m[:, j:j + 1, j]
            m[:, j + 1:, j + 1:] = m[:, j + 1:, j + 1:] - lower[:, :, None] * m[:, j:j + 1, j + 1:]
            x[:, j + 1:] = x[:, j + 1:] - lower * x[:, j:j + 1]
    for j in range(n - 1, -1, -1):
        x[:, j] = x[:, j] / m[:, j, j]
        if j:
            x[:, :j] = x[:, :j] - m[:, :j, j] * x[:, j:j + 1]
    return x.reshape(*batch, n)


def _zeros_product(a, c):
    batch = torch.broadcast_shapes(a.shape[:-2], c.shape[:-2])
    return a.new_zeros(*batch, a.shape[-2], c.shape[-1])


def batch_layout(shape: Sequence[int], *strides: Sequence[int]) -> Tuple[List[int], List[List[int]]]:
    """The batch axes ``shape`` of operands with the given strides, merged
    into as few axes as keep each operand a strided view: axes of size 1
    go, and an axis joins the next one where every operand's stride on it
    is the next one's stride times its size.  Returns (sizes, one stride
    list per operand), innermost last.  A contiguous output over ``shape``
    is contiguous over the merged axes in the same order."""
    sizes: List[int] = []
    merged: List[List[int]] = [[] for _ in strides]
    for i, size in enumerate(shape):
        if size == 1:
            continue
        step = [st[i] for st in strides]
        if sizes and all(m[-1] == s * size for m, s in zip(merged, step)):
            sizes[-1] *= size
            for m, s in zip(merged, step):
                m[-1] = s
        else:
            sizes.append(size)
            for m, s in zip(merged, step):
                m.append(s)
    return sizes, merged


# A launch's parameters as csrc/fixed_order.cu reads them: 64-bit integers, the head then the batch axes.
_PARAMS = {"fd_fixed_contract": struct.Struct(f"{9 + 3 * MAX_BATCH_DIMS}q"),
           "fd_fixed_lu_solve": struct.Struct(f"{6 + 3 * MAX_BATCH_DIMS}q")}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("fixed_order")
    for name in _PARAMS:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_char_p, ctypes.c_void_p]
    return lib


def _check(name: str, *xs: torch.Tensor) -> None:
    device = xs[0].device
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: float32 operands only, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name}: operands on {[str(x.device) for x in xs]}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {device}")


def _launch(entry: str, device: torch.device, ptrs: tuple, params: bytes) -> None:
    """One launch of ``entry`` on ``device``'s current stream.  The library
    launches on the current card: the wrapper makes ``device`` current where
    it is not."""
    fn = getattr(_library(), entry)
    if device.index == torch.cuda.current_device():
        err = fn(*ptrs, params, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = fn(*ptrs, params, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")


def _broadcast_strides(shape: Sequence[int], stride: Sequence[int], batch: Sequence[int]) -> List[int]:
    """An operand's strides over the batch axes ``batch`` when its own batch
    axes ``shape`` (strides ``stride``) broadcast to them: 0 where it is
    broadcast."""
    lead = len(batch) - len(shape)
    return [0] * lead + [st if size == b else 0 for size, st, b in zip(shape, stride, batch[lead:])]


def _pack(entry: str, head: list, batch: Sequence[int], s0: Sequence[int], s1: Sequence[int]) -> bytes:
    """A launch's parameters as csrc/fixed_order.cu reads them: ``head`` with
    the batch count first, then the batch axes merged by ``batch_layout``."""
    sizes, (m0, m1) = batch_layout(batch, s0, s1)
    if len(sizes) > MAX_BATCH_DIMS:
        raise ValueError(f"{entry}: {len(sizes)} batch axes after merging, the kernel takes {MAX_BATCH_DIMS}")
    pad = [0] * (MAX_BATCH_DIMS - len(sizes))
    return _PARAMS[entry].pack(math.prod(sizes), *head, len(sizes), *sizes, *pad, *m0, *pad, *m1, *pad)


def _check_outputs(name: str, count: int) -> None:
    if count >= 2 ** 31:
        raise ValueError(f"{name}: {count} outputs, the kernel takes fewer than 2^31")


# The plans depend on shapes and strides alone, and a VO run makes some 80 distinct calls many times over: they
# are kept, so that a call spends its host time on the launch.
@functools.lru_cache(maxsize=4096)
def _contract_plan(a_shape: tuple, a_stride: tuple, c_shape: tuple, c_stride: tuple) -> Tuple[tuple, bytes]:
    """(output shape, launch parameters) of K4 on a [..., M, K] @ c [..., K, N]."""
    batch = tuple(torch.broadcast_shapes(a_shape[:-2], c_shape[:-2]))
    (m, k), n = a_shape[-2:], c_shape[-1]
    _check_outputs("fixed_contract", math.prod(batch) * m * n)
    sa = _broadcast_strides(a_shape[:-2], a_stride[:-2], batch)
    sc = _broadcast_strides(c_shape[:-2], c_stride[:-2], batch)
    return (*batch, m, n), _pack("fd_fixed_contract", [m, n, k, *a_stride[-2:], *c_stride[-2:]], batch, sa, sc)


@functools.lru_cache(maxsize=4096)
def _sum_plan(shape: tuple, stride: tuple) -> bytes:
    """Launch parameters of K4 summing x [..., K] over K: the innermost output
    axis (after merging) is K4's M, the others its batch."""
    _check_outputs("fixed_sum", math.prod(shape[:-1]))
    sizes, (sx,) = batch_layout(shape[:-1], stride[:-1])
    m, sam = (sizes.pop(), sx.pop()) if sizes else (1, 0)
    return _pack("fd_fixed_contract", [m, 1, shape[-1], sam, stride[-1], 0, 0], sizes, sx, [0] * len(sx))


@functools.lru_cache(maxsize=4096)
def _solve_plan(a_shape: tuple, a_stride: tuple, b_shape: tuple, b_stride: tuple) -> Tuple[tuple, bytes]:
    """(output shape, launch parameters) of K5 on a [..., n, n] and b [..., n]."""
    n = a_shape[-1]
    batch = tuple(torch.broadcast_shapes(a_shape[:-2], b_shape[:-1]))
    sa = _broadcast_strides(a_shape[:-2], a_stride[:-2], batch)
    sb = _broadcast_strides(b_shape[:-1], b_stride[:-1], batch)
    return (*batch, n), _pack("fd_fixed_lu_solve", [n, *a_stride[-2:], b_stride[-1]], batch, sa, sb)


def fixed_contract(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a @ c`` for float32 [..., M, K] and [..., K, N] (batch axes
    broadcast), each output summed in K4's order over k.  Equal bit for bit
    to ``contract_ref``, and the same for a problem whatever the batch."""
    _check("fixed_contract", a, c)
    if a.dim() < 2 or c.dim() < 2 or a.shape[-1] != c.shape[-2]:
        raise ValueError(f"fixed_contract: shapes {tuple(a.shape)} @ {tuple(c.shape)}")
    if a.device.type == "cpu":
        return contract_ref(a, c)
    if a.shape[-1] == 0:
        return _zeros_product(a, c)
    out_shape, params = _contract_plan(a.shape, a.stride(), c.shape, c.stride())
    out = a.new_empty(out_shape)
    if out.numel():
        _launch("fd_fixed_contract", a.device, (a.data_ptr(), c.data_ptr(), out.data_ptr()), params)
        fixed_contract.launches += 1
    return out


def fixed_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of float32 ``x`` [..., K] over its last axis, in K4's order."""
    _check("fixed_sum", x)
    if x.dim() < 1:
        raise ValueError("fixed_sum: a scalar has no axis to sum")
    if x.device.type == "cpu":
        return sum_ref(x)
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape[:-1])
    out = x.new_empty(x.shape[:-1])
    if out.numel():
        _launch("fd_fixed_contract", x.device, (x.data_ptr(), None, out.data_ptr()), _sum_plan(x.shape, x.stride()))
        fixed_contract.launches += 1
    return out


def fixed_lu_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a x = b for float32 [..., n, n] a and [..., n] b (batch axes
    broadcast), n <= LU_MAX_N, by K5's LU; equal bit for bit to
    ``lu_solve_ref``, and the same for a system whatever the batch."""
    _check("fixed_lu_solve", a, b)
    n = a.shape[-1]
    if a.dim() < 2 or a.shape[-2] != n or b.dim() < 1 or b.shape[-1] != n:
        raise ValueError(f"fixed_lu_solve: shapes {tuple(a.shape)}, {tuple(b.shape)}")
    if not 1 <= n <= LU_MAX_N:
        raise ValueError(f"fixed_lu_solve: n = {n}, the kernel takes 1 <= n <= {LU_MAX_N}")
    if a.device.type == "cpu":
        return lu_solve_ref(a, b)
    out_shape, params = _solve_plan(a.shape, a.stride(), b.shape, b.stride())
    x = a.new_empty(out_shape)
    if x.numel():
        _launch("fd_fixed_lu_solve", a.device, (a.data_ptr(), b.data_ptr(), x.data_ptr()), params)
        fixed_lu_solve.launches += 1
    return x


fixed_contract.launches = 0
fixed_lu_solve.launches = 0
trace.count_launches("fixed_contract", fixed_contract)
trace.count_launches("fixed_lu_solve", fixed_lu_solve)
