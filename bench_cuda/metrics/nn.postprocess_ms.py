"""NN post-processing (selection through K2, descriptor sampling): device ms
a frame of the detect span less the forward span, over the --trace 1 run's
window."""


def read(run):
    detect, forward = run.span_ms.get("nn.detect"), run.span_ms.get("nn.forward")
    if detect is None or forward is None:
        return None
    return (detect - forward) / run.window["frames"]
