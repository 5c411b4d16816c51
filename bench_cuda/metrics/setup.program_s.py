"""The program's set-up: seconds in this process's top-level ``setup.*`` spans (kernel builds
and loads, the NN's weights and warm-up forward, joining the process group), which the program
records on the host clock whether or not it traces; rank 0's on four cards.  On a checkout's
first run ``setup.kernel_load`` holds nvcc's build of the kernels (seconds); later runs of the
same checkout find them built and only load them (milliseconds)."""

from bench_cuda.program_spans import records


def read(run):
    recs = records()
    setup = [s.host_ms() for s in recs or () if s.parent is None and s.name.startswith("setup.")]
    return sum(setup) / 1e3 if setup else None
