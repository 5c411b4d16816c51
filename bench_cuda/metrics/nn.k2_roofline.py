"""K2 (greedy selection on one frame's map): its least time (bytes at the
HBM peak, rooflines/bounds.py) times its calls, over its device time, in %,
from the profiled segment.  A call is two launches (tile keys, then picks)."""

from bench_cuda.rooflines.bounds import greedy_bound_ms


def read(run):
    ms, _ = run.kernel_ms("tile_keys_kernel", "pick_kernel")
    _, calls = run.kernel_ms("pick_kernel")
    if not run.trace.get("complete") or not calls or ms <= 0:
        return None
    cfg = run.config
    bound = greedy_bound_ms(1, cfg["rows"], cfg["cols"], cfg["detector"]["max_number_of_detected_features"])
    return 100.0 * bound * calls / ms
