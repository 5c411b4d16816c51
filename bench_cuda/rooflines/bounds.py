"""Least times of the port's kernels: frozen copies of the bound functions
of ``chip_smoke.py``.  Each counts the work that the inputs need, whatever
implements it: every input byte read once and every output byte written
once, or the operations at the float32 peak, the larger of the two."""

from __future__ import annotations

from . import peaks


def greedy_bound_ms(batch: int, rows: int, cols: int, picks: int) -> float:
    """Greedy selection (K1 for a batch, K2 for one frame): read each
    float32 candidate map once and each frame's budget, write each output
    slot once (uv as two float32, the response and the valid flag as 4
    bytes each: 16 bytes a slot), or one comparison per map element."""
    nbytes = greedy_bytes(batch, rows, cols, picks)
    ops = batch * rows * cols
    return 1e3 * max(nbytes / peaks.BYTES_PER_S, ops / peaks.F32_OPS_PER_S)


def greedy_bytes(batch: int, rows: int, cols: int, picks: int) -> int:
    """Bytes of ``greedy_bound_ms``: the maps, the budgets, the slots."""
    return batch * rows * cols * 4 + batch * 4 + batch * picks * 4 * 4


def fixed_bound(nbytes: int, ops: int):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the float32 operations over its peak."""
    t_bytes, t_ops = nbytes / peaks.BYTES_PER_S, ops / peaks.F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


FLOOD_OPS_PER_VISIT = 20  # float32 operations per valid pixel, neighbour and sweep of the LSD region flood (K3)


def flood_bound(n_pixels: int, n_valid: int, sweeps: int):
    """Least time for ``sweeps`` sweeps of K3's region flood: read the
    angle, validity and the four state planes once and write the state once
    (37 bytes a pixel), or FLOOD_OPS_PER_VISIT float32 operations per valid
    pixel, neighbour and sweep.  Returns (ms, "bytes" or "operations")."""
    t_bytes = 37 * n_pixels / peaks.BYTES_PER_S
    t_ops = sweeps * n_valid * 8 * FLOOD_OPS_PER_VISIT / peaks.F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
