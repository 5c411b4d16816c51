"""NN post-processing on the host: host ms a frame in the program's ``frontend.nn_pool`` and
``frontend.nn_postprocess`` spans (the work that ``nn.postprocess_ms`` covers), the median over
the profiled ``frontend.nn_detect`` calls, one a frame."""

from bench_cuda.program_spans import median_per_call, records


def read(run):
    return median_per_call(records(), "frontend.nn_detect", {"frontend.nn_pool", "frontend.nn_postprocess"}, "host")
