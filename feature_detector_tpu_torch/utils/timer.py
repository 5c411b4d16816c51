"""Timing: the reference's TickTock, and timers that wait for the card.

Counterpart of ``feature_detector_tpu/utils/timer.py``.  CUDA calls return
before the card has finished, so ``time_jitted`` times the card with CUDA
events between ``torch.cuda.synchronize`` calls; on the CPU it reads
``time.perf_counter``.  Named spans are ``utils/trace.py``'s.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import torch

from ..core.device import DeviceLike, resolve_device


class TickTock:
    """TickTock::TockTickInMillisecond equivalent: reading the timer also
    restarts it."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def tick(self) -> None:
        self._t0 = time.perf_counter()

    def tock_tick_in_millisecond(self) -> float:
        now = time.perf_counter()
        ms = (now - self._t0) * 1e3
        self._t0 = now
        return ms

    def tock_in_millisecond(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3


def _device_of(args, device: DeviceLike) -> torch.device:
    """``device`` if given, else the device of the first tensor argument,
    else ``resolve_device(None)`` (the card)."""
    if device is not None:
        return resolve_device(device)
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(None)


def time_jitted(fn: Callable, *args, iters: int = 10, warmup: int = 1,
                device: DeviceLike = None) -> Tuple[float, float]:
    """Times ``fn(*args)``: returns (first call in ms, steady-state ms per
    call).  The first call holds one-time costs (kernel builds, cuDNN
    autotuning); after ``warmup`` calls in all, ``iters`` calls run
    back to back and timed as a whole.  On the card (``device``, or the
    device of the first tensor argument) the times are CUDA events'
    between synchronisations; on the CPU, ``perf_counter``'s."""
    dev = _device_of(args, device)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn(*args)
        first_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(max(warmup - 1, 0)):
            fn(*args)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return first_ms, (time.perf_counter() - t0) * 1e3 / iters

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    fn(*args)
    end.record()
    torch.cuda.synchronize(dev)
    first_ms = start.elapsed_time(end)
    for _ in range(max(warmup - 1, 0)):
        fn(*args)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize(dev)
    return first_ms, start.elapsed_time(end) / iters

