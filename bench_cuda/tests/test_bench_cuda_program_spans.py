"""CPU tests of the readers of the program's own spans (``program_spans.py``
and the five ``metrics/*.py`` that read it) on hand-made span records: the
median over top-level calls, the scaling to a step or a frame, the profiled
segment of the host's ops left out, None where the spans are absent, and the
rank skew's collectives (none at a world of one; the same on every rank
whatever each recorded, on two gloo ranks).

    python -m pytest bench_cuda/tests/test_bench_cuda_program_spans.py -q
"""

from __future__ import annotations

import math
import multiprocessing
import os
import socket
import types

import pytest

from bench_cuda import harness, program_spans

NEW = ("fb.fast_ms", "fb.rank_skew_ms", "nn.forward_host_ms", "nn.postprocess_host_ms", "setup.program_s")


class Event:
    """A CUDA event's stand-in: a device time in ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


class Rec:
    """A span record's stand-in, with the fields and methods the readers use."""

    def __init__(self, name, parent, top, host, device=None):
        self.name, self.parent, self.top = name, parent, top
        self.start_ns, self.end_ns = int(host[0] * 1e6), int(host[1] * 1e6)
        self.start_event = self.end_event = None
        if device is not None:
            self.start_event, self.end_event = Event(device[0]), Event(device[1])

    def host_ms(self):
        return (self.end_ns - self.start_ns) / 1e6

    def device_ms(self):
        return None if self.end_event is None else self.start_event.elapsed_time(self.end_event)


def run_of(world=1, device="cpu"):
    return types.SimpleNamespace(world=world, device=device)


def read(name, recs, monkeypatch, run=None):
    monkeypatch.setattr(program_spans, "records", lambda: recs)
    return harness.load_metric(name).read(run or run_of())


def nn_frame(top, t0, forward, pool, cand, select, sample, host_forward=1.0, host_post=0.5):
    """One ``frontend.nn_detect`` call's spans; device ms given per span."""
    d = t0
    out = [Rec("models.forward", "frontend.nn_detect", top, (t0, t0 + host_forward), (d, d + forward))]
    d += forward
    out.append(Rec("frontend.nn_pool", "frontend.nn_detect", top, (t0 + 1, t0 + 1.1), (d, d + pool)))
    d += pool
    post = [Rec("frontend.nn_candidates", "frontend.nn_postprocess", top, (t0 + 1.1, t0 + 1.2), (d, d + cand)),
            Rec("kernels.greedy_select", "frontend.nn_postprocess", top, (t0 + 1.2, t0 + 1.3),
                (d + cand, d + cand + select)),
            Rec("kernels.nn_sample", "frontend.nn_postprocess", top, (t0 + 1.3, t0 + 1.4),
                (d + cand + select, d + cand + select + sample))]
    out += post
    out.append(Rec("frontend.nn_postprocess", "frontend.nn_detect", top, (t0 + 1.1, t0 + 1.1 + host_post),
                   (d, d + cand + select + sample)))
    out.append(Rec("frontend.nn_detect", None, top, (t0, t0 + 2), (t0, d + cand + select + sample)))
    return out


def test_the_new_metrics_are_found_and_listed_for_their_cells():
    bench = harness.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert all(entries[n]["source"] == "program_span" and "workloads" in entries[n] for n in NEW)
    assert entries["setup.program_s"]["workloads"] == ["fast_brief.b64", "disk.stream", "fast_brief.b64x4"]
    for n in NEW:
        assert callable(harness.load_metric(n).read)


def test_every_reader_gives_none_without_spans_or_without_a_tracer(monkeypatch):
    for recs in (None, []):
        for n in NEW:
            assert read(n, recs, monkeypatch, run_of(world=1)) is None, n


def test_nn_readers_take_the_median_over_frames(monkeypatch):
    recs = []
    for i, (fwd, cand, sel, samp, host_fwd) in enumerate([(5.0, 0.2, 0.3, 0.1, 2.0), (6.0, 0.4, 0.5, 0.3, 3.0),
                                                          (50.0, 9.0, 9.0, 9.0, 40.0)]):
        recs += nn_frame(i, 10.0 * i, fwd, 0.05, cand, sel, samp, host_forward=host_fwd, host_post=0.5 + i)
    recs.append(Rec("match.float", None, 9, (40, 41), (40, 41)))  # another top-level call: not read
    assert read("nn.forward_host_ms", recs, monkeypatch) == pytest.approx(3.0)
    # frontend.nn_pool's 0.1 host ms plus frontend.nn_postprocess's 0.5 + i
    assert read("nn.postprocess_host_ms", recs, monkeypatch) == pytest.approx(0.1 + 1.5)


def test_readers_leave_out_the_last_profiled_segment(monkeypatch):
    """The harness's last segment profiles the host's ops too: its calls
    are left out wherever an earlier segment recorded some; set-up spans,
    recorded long before, start no segment of their own."""
    recs = [Rec("setup.nn_initialize", None, 100, (-5000, -4000))]
    for i, host_fwd in enumerate([2.0, 3.0, 4.0]):  # the first segment
        recs += nn_frame(i, 10.0 * i, 5.0, 0.05, 0.2, 0.3, 0.1, host_forward=host_fwd)
    for i, host_fwd in enumerate([20.0, 30.0, 40.0]):  # the host's ops too, after a pause
        recs += nn_frame(10 + i, 1000.0 + 50.0 * i, 5.0, 0.05, 0.2, 0.3, 0.1, host_forward=host_fwd)
    segs = program_spans.segments(recs)
    assert [len(s) for s in segs] == [3, 3]
    assert read("nn.forward_host_ms", recs, monkeypatch) == pytest.approx(3.0)
    only_one = [r for r in recs if r.top >= 10]  # a single segment is read whole
    assert read("nn.forward_host_ms", only_one, monkeypatch) == pytest.approx(30.0)


def test_fast_scales_to_a_step_on_one_card_and_on_four(monkeypatch):
    one = []
    for i, fast in enumerate([30.0, 40.0, 38.0, 39.0]):  # two detect calls a step
        one += [Rec("kernels.fast", "frontend.detect_batch", i, (i, i + 0.1), (0, fast)),
                Rec("kernels.greedy_select", "frontend.detect_batch", i, (i, i + 0.1), (fast, fast + 0.3)),
                Rec("frontend.detect_batch", None, i, (i, i + 0.2), (0, fast + 0.3))]
    assert read("fb.fast_ms", one, monkeypatch) == pytest.approx(2 * 38.5)
    four = []
    for i, (fa, fb) in enumerate([(30.0, 31.0), (40.0, 41.0), (35.0, 36.0)]):  # one matcher call a step
        four += [Rec("kernels.fast", "frontend.detect_batch", i, (i, i + 0.1), (0, fa)),
                 Rec("kernels.fast", "frontend.detect_batch", i, (i, i + 0.1), (fa, fa + fb)),
                 Rec("parallel.two_frame", None, i, (i, i + 0.5), (0, 90))]
    assert read("fb.fast_ms", four, monkeypatch) == pytest.approx(71.0)
    host_only = [Rec("kernels.fast", "frontend.detect_batch", 0, (0, 1)), Rec("frontend.detect_batch", None, 0, (0, 1))]
    assert read("fb.fast_ms", host_only, monkeypatch) is None  # no device time recorded


def test_setup_sums_the_top_level_setup_spans_in_seconds(monkeypatch):
    recs = [Rec("setup.kernel_load", None, 0, (0, 1500)), Rec("setup.nn_initialize", None, 1, (2000, 2500)),
            Rec("setup.kernel_load", "kernels.greedy_select", 2, (3000, 3100)),  # nested: inside another's time
            Rec("frontend.nn_detect", None, 3, (4000, 9000))]
    assert read("setup.program_s", recs, monkeypatch) == pytest.approx(2.0)


def two_frame_steps(offset_ms, local_ms, gap_ms=0.001, steps=4):
    """One rank's ``parallel.two_frame`` calls: each starts ``gap_ms`` of
    host time after the last; on the device, local work of ``local_ms[i]``
    after the previous step's gathers end, then three gathers of 1 ms."""
    recs, host, dev = [], 0.0, offset_ms
    for i in range(steps):
        start = dev
        recs.append(Rec("parallel.local", "parallel.two_frame", i, (host, host + 0.5), (start, start + local_ms[i])))
        g = start + local_ms[i] + 0.5  # the exchange waits for the slowest rank
        for k in range(3):
            recs.append(Rec("parallel.gather", "parallel.two_frame", i, (host + 0.5, host + 0.6), (g, g + 1.0)))
            g += 1.0
        recs.append(Rec("parallel.two_frame", None, i, (host, host + 1.0), (start, g)))
        host += 1.0 + gap_ms[i] if isinstance(gap_ms, list) else 1.0 + gap_ms
        dev = g
    return recs


def test_rank_skew_step_values_chain_only_neighbouring_steps():
    skew = harness.load_metric("fb.rank_skew_ms")
    vals = skew.step_values(two_frame_steps(0.0, [10.0, 12.0, 11.0, 13.0]))
    assert math.isnan(vals[0]) and vals[1:] == pytest.approx([12.0, 11.0, 13.0])
    # a profiled segment's edge: the third step starts 50 ms of host time after the second ends
    vals = skew.step_values(two_frame_steps(0.0, [10.0, 12.0, 11.0, 13.0], gap_ms=[0.001, 50.0, 0.001, 0.001]))
    assert math.isnan(vals[0]) and math.isnan(vals[2]) and vals[1] == pytest.approx(12.0)


def test_rank_skew_makes_no_collective_at_a_world_of_one(monkeypatch):
    import torch.distributed as dist

    def refuse(*args, **kwargs):
        raise AssertionError("a collective at a world of one")

    monkeypatch.setattr(dist, "all_gather", refuse)
    assert read("fb.rank_skew_ms", two_frame_steps(0.0, [10.0] * 4), monkeypatch, run_of(world=1)) is None


def _rank(rank, port, recorded, out):
    """One gloo rank: the rank skew's reader on this rank's hand-made spans."""
    import torch.distributed as dist

    os.environ["OMP_NUM_THREADS"] = "1"
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
    try:
        program_spans.records = lambda: recorded
        out.put((rank, harness.load_metric("fb.rank_skew_ms").read(run_of(world=2))))
    finally:
        dist.destroy_process_group()


def run_two_ranks(recorded: list) -> dict:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, recorded[r], out)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(out.get(timeout=120) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    return got


def test_rank_skew_over_two_gloo_ranks():
    fast = two_frame_steps(0.0, [10.0, 10.0, 10.0, 10.0, 10.0], steps=5)
    slow = two_frame_steps(0.0, [10.0, 12.0, 11.0, 14.0, 12.0], steps=5)
    # per step: 2, 1, 4, 2 ms apart; the first step has no predecessor
    assert run_two_ranks([fast, slow]) == {0: pytest.approx(2.0), 1: pytest.approx(2.0)}
    # a rank that recorded nothing still makes both all-gathers: no rank waits, both read None
    assert run_two_ranks([fast, []]) == {0: None, 1: None}
