"""SuperGlue's GNN against the card's bf16 peak: the FLOPs of the mean query's GNN layers at the
valid keypoint counts (rooflines/superglue.py, taken at set-up over the mix's queries) over the
device ms of ``sg.gnn_ms``, in %."""

from bench_cuda.rooflines.peaks import BF16_FLOP_PER_S
from bench_cuda.program_spans import median_per_call, records


def read(run):
    ms = median_per_call(records(), "match.superglue", {"models.superglue_gnn"}, "device")
    flop = run.extra.get("sg_gnn_flop")
    if not ms or flop is None:
        return None
    return 100.0 * flop / (ms / 1e3) / BF16_FLOP_PER_S
