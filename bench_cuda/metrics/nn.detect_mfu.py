"""The whole NN step's share of the card's bf16 peak: the forward FLOPs of
one frame (counted from the configuration's widths, rooflines/flops.py)
times the frames of the profiled segment, over its seconds, over the
peak, in %."""

from bench_cuda.rooflines.flops import disk_forward_flop
from bench_cuda.rooflines.peaks import BF16_FLOP_PER_S


def read(run):
    if not run.trace.get("window_s"):
        return None
    flop = disk_forward_flop(run.config)
    return 100.0 * flop * run.trace["frames"] / run.trace["window_s"] / BF16_FLOP_PER_S
