"""NN forward on the host: host ms a frame in the program's ``models.forward`` span (how long the
host takes to launch the U-Net), the median over the profiled ``frontend.nn_detect`` calls, one a
frame."""

from bench_cuda.program_spans import median_per_call, records


def read(run):
    return median_per_call(records(), "frontend.nn_detect", {"models.forward"}, "host")
