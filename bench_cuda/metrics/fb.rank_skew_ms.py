"""Rank skew on four cards: for each profiled step and each rank, the device ms from the end of
the previous step's ``parallel.two_frame`` span (its last all-gather, which released every rank)
to the end of this step's ``parallel.local`` span (the rank's own work); a step's skew is the
largest less the smallest over the ranks; the median over the steps that every rank timed.

Every rank reads it, in the same order as every other metric, and makes the same two
all-gathers whatever it recorded (the count, then its list padded with NaN), so that no rank
waits on one that returned early.  A world of one makes none and gives None."""

import math

from bench_cuda.program_spans import calls, records

CHAIN_GAP_NS = 5_000_000  # steps in one profiled segment follow within microseconds; a segment's edge takes far longer


def step_values(recs) -> list:
    """Per recorded ``parallel.two_frame`` call, in order: the device ms from
    the previous call's end to this call's local end, NaN where the previous
    call is not its neighbour in one profiled segment or a span took no
    event pair."""
    steps = calls(recs, "parallel.two_frame")
    out = []
    for prev, cur in zip([None] + steps[:-1], steps):
        value = math.nan
        local = [s for s in cur if s.name == "parallel.local"]
        if prev is not None and local and local[0].end_event is not None:
            top_prev = next(s for s in prev if s.parent is None)
            top_cur = next(s for s in cur if s.parent is None)
            if top_prev.end_event is not None and top_cur.start_ns - top_prev.end_ns < CHAIN_GAP_NS:
                value = top_prev.end_event.elapsed_time(local[0].end_event)
        out.append(value)
    return out


def read(run):
    if run.world == 1:
        return None
    import numpy as np
    import torch
    import torch.distributed as dist

    recs = records()
    if recs is None or not dist.is_initialized():  # the same on every rank: one checkout, one group
        return None
    mine = step_values(recs)
    count = torch.tensor([len(mine)], dtype=torch.int64, device=run.device)
    counts = [torch.zeros_like(count) for _ in range(run.world)]
    dist.all_gather(counts, count)
    n = max(1, max(int(c.item()) for c in counts))
    padded = torch.full((n,), math.nan, dtype=torch.float64, device=run.device)
    padded[:len(mine)] = torch.tensor(mine, dtype=torch.float64)
    parts = [torch.empty_like(padded) for _ in range(run.world)]
    dist.all_gather(parts, padded)
    table = torch.stack(parts).cpu().numpy()  # [ranks, steps]
    timed = np.isfinite(table).all(axis=0)
    if not timed.any():
        return None
    return float(np.median(table[:, timed].max(axis=0) - table[:, timed].min(axis=0)))
