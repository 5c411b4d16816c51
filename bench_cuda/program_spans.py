"""The program's own spans, as the per-layer readers take them.

The port records them itself (``feature_detector_tpu_torch/utils/trace.py``)
while a ``torch.profiler`` profile is active: host times on every span, and
device times on the spans of device-bound paths that ask for them.  In a
``--trace 1`` run they cover the harness's profiled segments: the segment of
device activity alone (up to three times), then the short one that profiles
the host's ops too, where the profiler slows the host most.  A reader takes
only the calls of the segments before that last one (segments are told
apart by the host's pause between them), the median over those top-level
calls of each call's summed span time, then scales it to a step or a frame.
A checkout whose program has no tracer, or a run that recorded nothing (the
CPU), gives None.
"""

from __future__ import annotations

import statistics

SEGMENT_GAP_NS = 50_000_000  # calls in one profiled segment follow within milliseconds; stopping a profile takes far longer


def records():
    """The program's recorded spans, or None where its program has no tracer."""
    try:
        from feature_detector_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.spans()


def segments(recs: list) -> list:
    """The top-level spans of the hot path (not ``setup.*``), oldest first,
    split where the host paused more than SEGMENT_GAP_NS between one and the
    next: a list a segment."""
    out = []
    hot = (s for s in recs if s.parent is None and not s.name.startswith("setup."))
    for s in sorted(hot, key=lambda s: s.start_ns):
        if not out or s.start_ns - out[-1][-1].end_ns > SEGMENT_GAP_NS:
            out.append([])
        out[-1].append(s)
    return out


def calls(recs: list, top: str) -> list:
    """The spans of each call whose top-level span is named ``top``, a list
    a call, in the order the calls began; of every segment but the last
    where there are several (the last profiles the host's ops too)."""
    segs = segments(recs)
    kept = segs[:-1] if len(segs) > 1 else segs
    tops = [s for seg in kept for s in seg if s.name == top]
    groups: dict = {s.top: [] for s in tops}
    for s in recs:
        if s.top in groups:
            groups[s.top].append(s)
    return [groups[s.top] for s in tops]


def median_per_call(recs, top: str, names, clock: str, calls_per_unit: float = 1.0):
    """The median over calls of ``top`` that hold a span named in ``names``
    of those spans' summed ms on ``clock`` ("device": None where a span has
    no device time; or "host"), times ``calls_per_unit`` (the calls of that
    kind a step or a frame makes); None where there is none."""
    if not recs:
        return None
    sums = []
    for group in calls(recs, top):
        times = [s.device_ms() if clock == "device" else s.host_ms() for s in group if s.name in names]
        if times and None not in times:
            sums.append(sum(times))
    return statistics.median(sums) * calls_per_unit if sums else None
