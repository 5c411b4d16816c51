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
one to the other.  ``fixed_contract.launches`` counts K4's launches (both
entry points), ``fixed_lu_solve.launches`` K5's.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from . import _build

SERIAL_MAX_K = 16  # kSerialMaxK of csrc/fixed_order.cu: one serial sum an output at and below it
LANES = 32  # kLanes: above it, 32 strided partial sums folded pairwise
LU_MAX_N = 104  # kLuMaxN


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


def _library() -> ctypes.CDLL:
    lib = _build.load("fixed_order")
    fn = lib.fd_fixed_contract
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int] + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    fn = lib.fd_fixed_lu_solve
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + \
        [ctypes.c_longlong] * 5 + [ctypes.c_void_p]
    return lib


def _check(name: str, *xs: torch.Tensor) -> None:
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: float32 operands only, got {x.dtype}")
    if len({x.device for x in xs}) != 1:
        raise ValueError(f"{name}: operands on {[str(x.device) for x in xs]}")
    if xs[0].device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {xs[0].device}")


def _launch_contract(a: torch.Tensor, c: Optional[torch.Tensor], out_shape) -> torch.Tensor:
    """K4 on [B, M, K] ``a`` and [B, K, N] ``c`` (or None: N = 1), each a
    strided view; returns [B, M, N] reshaped to ``out_shape``."""
    n_batch, m, k = a.shape
    n = 1 if c is None else c.shape[-1]
    if k > SERIAL_MAX_K:  # a warp reads 32 consecutive k: hand it k-contiguous operands
        if a.stride(-1) != 1:
            a = a.contiguous()
        if c is not None and c.stride(-2) != 1:
            c = c.transpose(-1, -2).contiguous().transpose(-1, -2)
    out = torch.empty((n_batch, m, n), dtype=torch.float32, device=a.device)
    if out.numel():
        cs = (0, 0, 0) if c is None else c.stride()
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = _library().fd_fixed_contract(a.data_ptr(), None if c is None else c.data_ptr(), out.data_ptr(),
                                               n_batch, m, n, k, *a.stride(), *cs, stream)
        if err != 0:
            raise RuntimeError(f"fixed_contract kernel launch failed: cudaError {err}")
        fixed_contract.launches += 1
    return out.reshape(out_shape)


def fixed_contract(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a @ c`` for float32 [..., M, K] and [..., K, N] (batch axes
    broadcast), each output summed in K4's order over k.  Equal bit for bit
    to ``contract_ref``, and the same for a problem whatever the batch."""
    _check("fixed_contract", a, c)
    if a.dim() < 2 or c.dim() < 2 or a.shape[-1] != c.shape[-2]:
        raise ValueError(f"fixed_contract: shapes {tuple(a.shape)} @ {tuple(c.shape)}")
    if a.device.type == "cpu":
        return contract_ref(a, c)
    batch = torch.broadcast_shapes(a.shape[:-2], c.shape[:-2])
    (m, k), n = a.shape[-2:], c.shape[-1]
    if k == 0:
        return _zeros_product(a, c)
    return _launch_contract(a.expand(*batch, m, k).reshape(-1, m, k), c.expand(*batch, k, n).reshape(-1, k, n),
                            (*batch, m, n))


def fixed_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of float32 ``x`` [..., K] over its last axis, in K4's order."""
    _check("fixed_sum", x)
    if x.dim() < 1:
        raise ValueError("fixed_sum: a scalar has no axis to sum")
    if x.device.type == "cpu":
        return sum_ref(x)
    k = x.shape[-1]
    if k == 0:
        return x.new_zeros(x.shape[:-1])
    return _launch_contract(x.reshape(-1, 1, k), None, x.shape[:-1])


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
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-1])
    am = a.expand(*batch, n, n).reshape(-1, n, n)
    bm = b.expand(*batch, n).reshape(-1, n)
    x = torch.empty(bm.shape, dtype=torch.float32, device=a.device)
    if x.numel():
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = _library().fd_fixed_lu_solve(am.data_ptr(), bm.data_ptr(), x.data_ptr(), am.shape[0], n,
                                               *am.stride(), *bm.stride(), stream)
        if err != 0:
            raise RuntimeError(f"fixed_lu_solve kernel launch failed: cudaError {err}")
        fixed_lu_solve.launches += 1
    return x.reshape(*batch, n)


fixed_contract.launches = 0
fixed_lu_solve.launches = 0
