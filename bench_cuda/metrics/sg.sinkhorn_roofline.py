"""Sinkhorn against its roofline: the least time of the mean query's passes (the couplings of
its pairs at the valid counts read and written once, or 3 float32 operations a coupling each
half-pass at the float32 peak, the larger; rooflines/superglue.py) over the device ms of
``sg.sinkhorn_ms``, in %."""

from bench_cuda.program_spans import median_per_call, records
from bench_cuda.rooflines.superglue import sinkhorn_bound_ms


def read(run):
    ms = median_per_call(records(), "match.superglue", {"models.superglue_sinkhorn"}, "device")
    cells = run.extra.get("sg_cells")
    if not ms or cells is None:
        return None
    return 100.0 * sinkhorn_bound_ms(cells, run.config["superglue"]["sinkhorn_iterations"]) / ms
