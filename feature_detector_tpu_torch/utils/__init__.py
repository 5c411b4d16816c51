"""Utilities of the PyTorch/CUDA port: logging, timers, the tracer, checkpoints, numeric checks, recovery."""
