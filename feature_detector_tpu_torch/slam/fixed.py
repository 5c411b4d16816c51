"""Products, sums and small dense solves whose float32 bits do not depend on
the batch.

The SLAM solvers call these in place of ``@``, ``einsum``, ``.sum``,
``vector_norm`` and ``linalg.solve``.  Inside ``with batch_invariant():``
(the fused VO's chunk solver, ``vo_fused.solve_chunks``, and everything it
calls), float32 operands go to K4 (``kernels/fixed_order.py:fixed_contract``
and ``fixed_sum``) and K5 (``fixed_lu_solve``, systems of at most
``LU_MAX_N`` unknowns): a problem rounds the same whether it is solved alone
or among many, so a rank of a mesh gets the same bits for its share of the
chunks as one device for the whole batch.  Inside ``torch.func`` transforms
(the forward-mode Jacobians of ``lie.jacfwd``) a contraction runs as K4's
plain version, which is elementwise and gives the kernel's bits.

Everywhere else, and for float64 (the global BA), these are the library's
``@``, ``einsum``, ``sum``, ``vector_norm`` and ``solve_ex``, as before.
Integer and boolean sums are exact and stay ``Tensor.sum``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Sequence, Union

import torch

from ..kernels.fixed_order import LU_MAX_N, contract_ref, fixed_contract, fixed_lu_solve, fixed_sum, sum_ref

_ON = contextvars.ContextVar("batch_invariant", default=False)


@contextlib.contextmanager
def batch_invariant():
    """Route the float32 products, sums and solves of the enclosed code
    through K4 and K5."""
    token = _ON.set(True)
    try:
        yield
    finally:
        _ON.reset(token)


def _traced(*xs: torch.Tensor) -> bool:
    return any(torch._C._functorch.is_functorch_wrapped_tensor(x) for x in xs)


def _fixed(*xs: torch.Tensor) -> bool:
    return _ON.get() and all(x.dtype == torch.float32 for x in xs)


def matmul(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a @ c`` for [..., M, K] and [..., K, N]."""
    if not _fixed(a, c):
        return a @ c
    return contract_ref(a, c) if _traced(a, c) else fixed_contract(a, c)


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a x`` for [..., M, K] and [..., K]."""
    return matmul(a, x[..., None])[..., 0]


def sum(x: torch.Tensor, dim: Union[int, Sequence[int]], keepdim: bool = False) -> torch.Tensor:
    """``x.sum(dim)``; over several axes the terms run in row-major order."""
    if not _fixed(x):
        return x.sum(dim, keepdim=keepdim)
    dims = sorted(d % x.dim() for d in ((dim,) if isinstance(dim, int) else dim))
    flat = x.movedim(dims, list(range(x.dim() - len(dims), x.dim()))).flatten(x.dim() - len(dims))
    out = sum_ref(flat) if _traced(x) else fixed_sum(flat)
    for d in dims if keepdim else ():
        out = out.unsqueeze(d)
    return out


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a x = b for [..., n, n] a and [..., n] b.  A singular system
    gives inf/NaN instead of raising, as ``jnp.linalg.solve`` does."""
    n = a.shape[-1]
    if _fixed(a, b) and n <= LU_MAX_N:
        return fixed_lu_solve(a, b)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-1])
    return torch.linalg.solve_ex(a.expand(*batch, n, n), b.expand(*batch, n)[..., None])[0][..., 0]


def _aligned(x: torch.Tensor, letters: str, target: str) -> torch.Tensor:
    """x [..., *letters] -> [..., *target]: axes permuted, size 1 where
    ``target`` has a letter that x lacks."""
    lead = x.dim() - len(letters)
    x = x.permute(*range(lead), *(lead + letters.index(t) for t in target if t in letters))
    for i, t in enumerate(target):
        if t not in letters:
            x = x.unsqueeze(lead + i)
    return x


def einsum(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(spec, *ops)`` for specs of the form
    ``"...ab,...bc->...ac"``: every operand and the output start with
    ``...``; with three operands, the one with the fewest letters (all held
    by another) is multiplied into the first that holds them, elementwise.  In float32, one K4 contraction whose k
    runs over the summed letters in the order the first operand lists
    them."""
    if not _fixed(*ops):
        return torch.einsum(spec, *ops)
    ins, out = spec.replace(" ", "").split("->")
    ins = [s.removeprefix("...") for s in ins.split(",")]
    out = out.removeprefix("...")
    ops, ins = list(ops), list(ins)
    while len(ops) > 2:  # fold a weight operand into one that holds all its letters
        i = min((i for i, s in enumerate(ins) if any(j != i and set(s) <= set(t) for j, t in enumerate(ins))),
                key=lambda i: len(ins[i]))
        w, lw = ops.pop(i), ins.pop(i)
        j = next(j for j, t in enumerate(ins) if set(lw) <= set(t))
        ops[j] = ops[j] * _aligned(w, lw, ins[j])
    (la, lc), (a, c) = ins, ops
    batch = "".join(t for t in la if t in lc and t in out)
    m = "".join(t for t in la if t not in lc)
    n = "".join(t for t in lc if t not in la)
    k = "".join(t for t in la if t in lc and t not in out)
    if any(t not in out for t in m + n):
        raise ValueError(f"fixed.einsum: {spec!r} sums a letter of one operand only")
    a = _aligned(a, la, batch + m + k)
    c = _aligned(c, lc, batch + k + n)
    lead = a.dim() - len(batch + m + k)
    sizes = lambda x, start, letters: list(x.shape[start:start + len(letters)])
    ms = sizes(a, lead + len(batch), m)
    ns = sizes(c, c.dim() - len(n), n)
    a = a.flatten(a.dim() - len(k)) if k else a.unsqueeze(-1)
    a = a.flatten(a.dim() - 1 - len(m), a.dim() - 2) if m else a.unsqueeze(-2)
    c = c.flatten(c.dim() - len(n)) if n else c.unsqueeze(-1)
    c = c.flatten(c.dim() - 1 - len(k), c.dim() - 2) if k else c.unsqueeze(-2)
    r = matmul(a, c)  # [..., *batch, M, N]
    r = r.reshape(*r.shape[:-2], *ms, *ns)
    got = batch + m + n
    lead = r.dim() - len(got)
    return r.permute(*range(lead), *(lead + got.index(t) for t in out))


def norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """The Euclidean norm over the last axis (``linalg.vector_norm``)."""
    if not _fixed(x):
        return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)
    return torch.sqrt(sum(x * x, -1, keepdim=keepdim))
