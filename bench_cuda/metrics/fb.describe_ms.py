"""Steered BRIEF: device ms a step between CUDA events recorded around both compute_descriptors
calls of each step of the --trace 1 run's window."""


def read(run):
    ms = run.span_ms.get("fb.describe")
    return None if ms is None else ms / run.window["calls"]
