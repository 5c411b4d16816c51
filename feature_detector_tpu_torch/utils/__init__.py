"""Utilities of the PyTorch/CUDA port: logging, timers, checkpoints, numeric checks, recovery."""
