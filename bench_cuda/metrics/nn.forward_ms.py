"""NN forward: device ms a frame between CUDA events recorded by forward pre- and post-hooks on
the detector's model, over the --trace 1 run's window."""


def read(run):
    ms = run.span_ms.get("nn.forward")
    return None if ms is None else ms / run.window["frames"]
