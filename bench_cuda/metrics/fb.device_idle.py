"""Device: the share of the profiled segment in which no operation ran on
the card (rank 0's on four cards), in %."""


def read(run):
    if not run.trace.get("window_s") or run.trace.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
