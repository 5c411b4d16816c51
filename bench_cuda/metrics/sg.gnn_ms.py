"""SuperGlue's GNN: device ms a query in the program's ``models.superglue_gnn`` span (the 18
layers over both sides of the 16 pairs, the final projection and the scores), the median over
the profiled ``match.superglue`` calls, one a query."""

from bench_cuda.program_spans import median_per_call, records


def read(run):
    return median_per_call(records(), "match.superglue", {"models.superglue_gnn"}, "device")
