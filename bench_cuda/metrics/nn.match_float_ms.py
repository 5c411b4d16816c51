"""Float matching: device ms a frame between CUDA events recorded around match_float, over the
--trace 1 run's window."""


def read(run):
    ms = run.span_ms.get("nn.match")
    return None if ms is None else ms / run.window["frames"]
