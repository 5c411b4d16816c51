"""SuperGlue's optimal transport: device ms a query in the program's ``models.superglue_sinkhorn``
span (the couplings, the marginals and every Sinkhorn pass over the 16 pairs), the median over
the profiled ``match.superglue`` calls, one a query."""

from bench_cuda.program_spans import median_per_call, records


def read(run):
    return median_per_call(records(), "match.superglue", {"models.superglue_sinkhorn"}, "device")
