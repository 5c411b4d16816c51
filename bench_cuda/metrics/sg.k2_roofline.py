"""K2 in a query step (the query's SuperPoint selection over up to 1,024
keypoints), read as ``nn.k2_roofline`` reads it in a stream cell: its least
time times its calls, over its device time, in %.  A metric of its own
because the query cell reports ``frames_per_s``, not a stream's frame time."""

from bench_cuda.harness import load_metric


def read(run):
    return load_metric("nn.k2_roofline").read(run)
