"""FAST's response and candidate maps: device ms a step in the program's ``kernels.fast`` spans,
the median over the profiled calls that hold them, times the calls of that kind a step makes: two
``frontend.detect_batch`` calls on one card, one ``parallel.two_frame`` (both detect calls) on each
rank of four (rank 0's)."""

from bench_cuda.program_spans import median_per_call, records

STEP_CALLS = {"frontend.detect_batch": 2, "parallel.two_frame": 1}  # top-level calls a step of pipelines/fast_brief.py


def read(run):
    recs = records()
    for top, per_step in STEP_CALLS.items():
        ms = median_per_call(recs, top, {"kernels.fast"}, "device", per_step)
        if ms is not None:
            return ms
    return None
