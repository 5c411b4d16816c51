"""Hamming matching: device ms a step between CUDA events recorded around match_hamming in each
step of the --trace 1 run's window."""


def read(run):
    ms = run.span_ms.get("fb.match")
    return None if ms is None else ms / run.window["calls"]
