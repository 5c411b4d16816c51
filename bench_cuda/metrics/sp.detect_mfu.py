"""The whole SuperPoint stream step's share of the card's bf16 peak, as ``nn.detect_mfu`` for
DISK: SuperPoint's forward FLOPs of one frame (rooflines/superglue.py, about 61.2 GFLOP at
752x480) times the frames of the profiled segment, over its seconds, over the peak, in %."""

from bench_cuda.rooflines.peaks import BF16_FLOP_PER_S
from bench_cuda.rooflines.superglue import superpoint_forward_flop


def read(run):
    if not run.trace.get("window_s"):
        return None
    flop = superpoint_forward_flop(run.config["rows"], run.config["cols"])
    return 100.0 * flop * run.trace["frames"] / run.trace["window_s"] / BF16_FLOP_PER_S
