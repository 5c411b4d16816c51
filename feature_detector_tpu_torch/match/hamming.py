"""Bitpacked Hamming matcher: XOR and popcount over 32-bit descriptor words.

Counterpart of ``feature_detector_tpu/match/hamming.py``.  The JAX package
computes the distance as a +/-1 matrix product, a TPU choice; here it is
integer XOR and popcount, with a leading batch dimension allowed on every
argument.  Words are int32 tensors holding uint32 bits.
"""

from __future__ import annotations

import torch

from ..core.config import MatcherOptions
from ..core.types import BIG, Matches
from ..utils import trace


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR bit count of the low 32 bits of an int64 tensor."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distance_matrix(
    words_a: torch.Tensor, words_b: torch.Tensor,
    valid_a: torch.Tensor, valid_b: torch.Tensor,
) -> torch.Tensor:
    """[..., Na, W] x [..., Nb, W] -> [..., Na, Nb] int32; a pair with an
    invalid row or column gets the sentinel ``1 << 20``.  Accumulates one
    word at a time, so no [..., Na, Nb, W] tensor is built."""
    a = words_a.to(torch.int64)
    b = words_b.to(torch.int64)
    d = None
    for w in range(a.shape[-1]):
        pc = _popcount32(a[..., :, None, w] ^ b[..., None, :, w]).to(torch.int32)
        d = pc if d is None else d + pc
    both = valid_a[..., :, None] & valid_b[..., None, :]
    return torch.where(both, d, torch.full_like(d, BIG))


def _first_index_of_min(d: torch.Tensor, dim: int):
    """(min, smallest index achieving it) along ``dim``."""
    best = d.amin(dim=dim, keepdim=True)
    n = d.shape[dim]
    shape = [1] * d.dim()
    shape[dim] = n
    iota = torch.arange(n, dtype=torch.int32, device=d.device).view(shape)
    idx = torch.where(d == best, iota, torch.full_like(iota, n)).amin(dim=dim)
    return best.squeeze(dim), idx


def match_hamming(
    words_a: torch.Tensor,
    valid_a: torch.Tensor,
    words_b: torch.Tensor,
    valid_b: torch.Tensor,
    opts: MatcherOptions = MatcherOptions(),
) -> Matches:
    """Match descriptor set A against B: per A-slot the nearest B (first
    index wins a tie), gated by ``max_distance``, the ratio test against the
    second best when ``ratio < 1`` and the mutual cross-check."""
    with trace.span("match.hamming"):
        d = hamming_distance_matrix(words_a, words_b, valid_a, valid_b)
        na, nb = d.shape[-2:]
        best, best_j = _first_index_of_min(d, -1)
        is_best = torch.arange(nb, dtype=torch.int32, device=d.device) == best_j[..., None]
        second = torch.where(is_best, torch.full_like(d, BIG), d).amin(dim=-1)

        ok = valid_a & (best <= opts.max_distance)
        if opts.ratio < 1.0:
            ok &= best.to(torch.float32) < opts.ratio * second.to(torch.float32)
        if opts.cross_check:
            _, best_i_for_b = _first_index_of_min(d, -2)
            bi_of_bj = best_i_for_b.gather(-1, best_j.to(torch.int64))
            ok &= bi_of_bj == torch.arange(na, dtype=torch.int32, device=d.device)

        return Matches(
            index=torch.where(ok, best_j, torch.full_like(best_j, -1)),
            distance=torch.where(ok, best, torch.full_like(best, BIG)),
            valid=ok,
        )
