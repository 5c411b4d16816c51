"""Detector front-end (FAST and K1): device ms a step between CUDA events recorded around both
detect_good_features_batch calls of each step of the --trace 1 run's window."""


def read(run):
    ms = run.span_ms.get("fb.detect")
    return None if ms is None else ms / run.window["calls"]
