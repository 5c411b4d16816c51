"""The port's tracer: named spans at its layer boundaries, on the
profiler's clock.

A span records its name, the name of the span that encloses it, the id of
its top-level span (shared by every span of one call into the program), its
host start and end from ``time.time_ns()`` (CLOCK_REALTIME, the clock that
kineto stamps ``torch.profiler`` events with, so that a span and the
profiler's events can be joined by time), and, where it times the device, a
pair of ``torch.cuda.Event`` on the current stream for the device time
between its edges.  Nothing is synchronised when a span opens or closes:
device times are read when ``Span.device_ms`` or ``summary()`` asks.

    with trace.span("frontend.nn_detect"):   # host times while recording
        ...
    with trace.span("kernels.fast", device=True):   # and the device's under a profile
        ...
    with trace.setup_span("setup.kernel_load"):   # always records, host clock only
        ...

``span`` records after ``enable()``, every span with an event pair on the
card, and while a ``torch.profiler`` profile is active.  Under a profile
CUPTI's callbacks make an event pair cost tens of microseconds of host time
against a few for the host clock alone, so there only the spans opened with
``device=True`` take the pair: those on device-bound paths, where the host
runs far ahead of the card.  Otherwise ``span`` returns one shared no-op
context after a check of two flags.  ``setup_span`` is for work that runs
once a process (kernel builds, weights, joining a process group), which
records whatever the switch says.  Spans are not ``record_function``
ranges: they add no event to the profiler's trace.

Closed spans wait in a bounded buffer (``CAPACITY`` spans; the oldest go
first, counted by ``dropped()``).  ``spans()`` lists them; ``summary()``
gives calls, host ms and device ms per span name, the launch counters that
the hand kernels' modules register (``count_launches``) and the counters of
work that the paths add to with ``count`` (pairs, keypoints, iterations),
which count whatever the switch says.  The tracer is one per process, like
the counters.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16  # spans kept; a DISK frame records about 10, a classical step about 8

_enabled = False
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_top_ids = itertools.count()
_local = threading.local()  # each thread's stack of open spans
_counters: dict = {}  # launch counter name -> the function whose ``launches`` it reads
_totals: dict = {}  # work counter name -> its total: an int, or a 0-d tensor on the device it counts on


class _NoSpan:
    """The context ``span`` hands back while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class Span:
    """One recorded span; also the context manager that records it."""

    __slots__ = ("name", "parent", "top", "start_ns", "end_ns", "start_event", "end_event", "_device", "_stream")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.parent = None  # the enclosing span's name
        self.top = None  # the id of the top-level span
        self.start_ns = self.end_ns = None
        self.start_event = self.end_event = None
        self._device = device
        self._stream = None

    def __enter__(self):
        stack = _stack()
        if stack:
            self.parent, self.top = stack[-1].name, stack[-1].top
        else:
            self.top = next(_top_ids)
        stack.append(self)
        self.start_ns = time.time_ns()
        if self._device and torch.cuda.is_initialized():
            # Looked up once: ``current_stream()`` costs about as much as an event record.
            self._stream = torch.cuda.current_stream()
            self.start_event = torch.cuda.Event(enable_timing=True)
            self.start_event.record(self._stream)
        return self

    def __exit__(self, *exc):
        global _dropped
        if self.start_event is not None:
            self.end_event = torch.cuda.Event(enable_timing=True)
            self.end_event.record(self._stream)
            self._stream = None
        self.end_ns = time.time_ns()
        _stack().pop()
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1
        _buffer.append(self)
        return False

    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def device_ms(self):
        """Device ms between the span's edges, or None where it took no event
        pair.  The device must have passed the end event (synchronise first)."""
        return None if self.end_event is None else self.start_event.elapsed_time(self.end_event)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, device: bool = False):
    """A span of the hot path: after ``enable()`` it records with an event
    pair on the card; while a ``torch.profiler`` profile is active it
    records, with the pair only where ``device`` asks; else the shared
    no-op context."""
    if _enabled:
        return Span(name, True)
    if _profiler._is_profiler_enabled:
        return Span(name, device)
    return _NO_SPAN


def setup_span(name: str) -> Span:
    """A span of once-a-process set-up: recorded whatever the switch says,
    on the host clock only."""
    return Span(name, False)


def enable() -> None:
    """Record hot-path spans, each with an event pair on the card, with no
    profiler running."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def count_launches(name: str, fn) -> None:
    """Registers a hand kernel's launch counter, ``fn.launches``, which
    ``summary()`` reads where it lives (the kernel modules call this when
    they are imported)."""
    _counters[name] = fn


def count(name: str, value=1) -> None:
    """Adds ``value`` to the work counter ``name``: an int, or a 0-d
    integer tensor, which is added on its own device so that counting waits
    for nothing.  Counts whether or not anything records; ``counters()``
    reads the totals."""
    _totals[name] = _totals.get(name, 0) + value


def counters() -> dict:
    """The work counters' totals as ints (reading a total kept on the card
    waits for it)."""
    return {name: int(v) for name, v in _totals.items()}


def spans() -> list:
    """The recorded spans, oldest first, each closed."""
    return list(_buffer)


def dropped() -> int:
    """Spans dropped because the buffer was full."""
    return _dropped


def clear() -> None:
    """Forgets every recorded span and the count of dropped ones; the
    buffer takes ``CAPACITY`` anew."""
    global _buffer, _dropped
    _buffer = collections.deque(maxlen=CAPACITY)
    _dropped = 0


def summary() -> dict:
    """For an operator: per span name its calls, host ms and device ms
    (None where no call took an event pair), summed over the buffer; the
    spans dropped; the registered launch counters of the kernel modules
    imported so far; the work counters.  Waits for the card first, since device times exist
    only once it has passed the spans' end events."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    by_name: dict = {}
    for s in list(_buffer):
        row = by_name.setdefault(s.name, {"calls": 0, "host_ms": 0.0, "device_ms": None})
        row["calls"] += 1
        row["host_ms"] += s.host_ms()
        ms = s.device_ms()
        if ms is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + ms
    return {"spans": by_name, "dropped": _dropped,
            "launches": {name: fn.launches for name, fn in _counters.items()}, "counters": counters()}
