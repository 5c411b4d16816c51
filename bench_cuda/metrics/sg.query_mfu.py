"""The whole query step's share of the card's bf16 peak: SuperPoint's forward FLOPs and the mean
query's GNN FLOPs at the valid keypoint counts (rooflines/superglue.py) times the queries of the
profiled segment, over its seconds, over the peak, in %."""

from bench_cuda.rooflines.peaks import BF16_FLOP_PER_S


def read(run):
    if not run.trace.get("window_s") or "sg_gnn_flop" not in run.extra:
        return None
    flop = run.extra["sp_flop"] + run.extra["sg_gnn_flop"]
    return 100.0 * flop * run.trace["frames"] / run.trace["window_s"] / BF16_FLOP_PER_S
