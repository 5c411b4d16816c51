"""Multi-device exchange (parallel/frontend.py and mesh.py all-gathers):
device ms a step of the NCCL kernels on this rank (rank 0), from the
profiled segment."""


def read(run):
    if run.world == 1:
        return None
    ms, n = run.kernel_ms("nccl", "Nccl")
    return ms / run.trace["calls"] if n else None
