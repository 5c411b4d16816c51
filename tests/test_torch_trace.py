"""The port's tracer (``utils/trace.py``): off, it records nothing and hands
back one shared no-op; under ``torch.profiler`` (or after ``enable()``) its
spans nest, share a top-level id, lie on the profiler's clock and add no
event to the profiler's trace; under a profile only the spans that ask time
the device, after ``enable()`` every one; set-up spans record whatever the
switch says; the buffer keeps its bound; the summary reads the launch
counters that kernel modules register.  Then the spans that the port's paths open, on
the CPU at a small size, and on the card (``gpu``; skips without one).

This file imports nothing of the JAX package, so it also runs on the card's
machine: ``python -m pytest tests/test_torch_trace.py`` checks the clock on
that machine's torch.
"""

import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from feature_detector_tpu_torch.core.config import (
    BriefOptions,
    DetectorOptions,
    FastOptions,
    MatcherOptions,
    NNDetectorOptions,
    NNModelType,
)
from feature_detector_tpu_torch.frontend.detector import detect_good_features_batch
from feature_detector_tpu_torch.frontend.nn_detector import NNFeaturePointDetector
from feature_detector_tpu_torch.kernels.brief import brief_compute
from feature_detector_tpu_torch.match.hamming import match_hamming
from feature_detector_tpu_torch.models.synth_data import scene_uint8, synth_scene
from feature_detector_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def scenes(n, rows, cols, seed=3):
    return torch.from_numpy(np.stack([
        scene_uint8(synth_scene(np.random.default_rng(seed + i), rows, cols, rich_background=True)[0])
        for i in range(n)]))


def tree(records):
    """{name: (parent, top)} of each record; names recorded once."""
    names = [s.name for s in records]
    assert len(names) == len(set(names)), names
    return {s.name: (s.parent, s.top) for s in records}


def test_off_records_nothing_and_hands_back_one_no_op():
    first, second = trace.span("frontend.nn_detect"), trace.span("match.float")
    assert first is second and not isinstance(first, trace.Span)
    with first as entered:
        torch.ones(3).sum()
    assert entered is None
    assert trace.spans() == [] and trace.dropped() == 0


def records(name="a", device=False):
    """Whether ``span`` hands back a recording span."""
    return isinstance(trace.span(name, device), trace.Span)


def test_the_switch_follows_the_profiler_and_enable():
    assert not autograd_profiler._is_profiler_enabled and not records()
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled and records() and records(device=True)
    assert not autograd_profiler._is_profiler_enabled and not records() and not records(device=True)
    trace.enable()
    assert records()
    trace.disable()
    assert not records()


def test_under_a_profile_only_the_spans_that_ask_time_the_device():
    with profile(activities=[ProfilerActivity.CPU]):
        assert not trace.span("frontend.nn_detect")._device and trace.span("kernels.fast", device=True)._device
    trace.enable()  # an operator's trace times every span
    assert trace.span("frontend.nn_detect")._device and trace.span("kernels.fast", device=True)._device


def test_spans_nest_share_a_top_id_and_stop_with_the_profile():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("a"):
            with trace.span("a.b"):
                with trace.span("a.b.c"):
                    torch.ones(4).sum()
            with trace.span("a.d"):
                pass
        with trace.span("e"):
            pass
    with trace.span("after"):
        pass
    recs = trace.spans()
    assert [s.name for s in recs] == ["a.b.c", "a.b", "a.d", "a", "e"]  # in the order they closed
    t = tree(recs)
    assert t["a"][0] is None and t["a.b"][0] == "a" and t["a.b.c"][0] == "a.b" and t["a.d"][0] == "a"
    assert t["a"][1] == t["a.b"][1] == t["a.b.c"][1] == t["a.d"][1] != t["e"][1]
    outer, inner = recs[3], recs[1]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert all(s.device_ms() is None and s.host_ms() >= 0 for s in recs)  # no card: host clock only


def test_host_times_lie_on_the_profilers_clock():
    a = torch.randn(300, 300)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with trace.span("match.float"):
                a @ a
    spans = trace.spans()
    mms = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mms) == 3 and len(spans) == 3
    for s, e in zip(spans, sorted(mms, key=lambda e: e.start_ns())):
        assert s.start_ns <= e.start_ns() <= e.end_ns() <= s.end_ns, (s.start_ns, e.start_ns(), e.end_ns(), s.end_ns)
    # Another clock would not hold the op: monotonic time is years away from the profiler's stamps.
    assert abs(mms[0].start_ns() - time.monotonic_ns()) > 10**15


def test_no_span_appears_among_the_profilers_events():
    names = {"frontend.nn_detect", "models.forward", "kernels.greedy_select"}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("frontend.nn_detect"):
            with trace.span("models.forward"):
                torch.randn(64, 64).relu()
            with trace.span("kernels.greedy_select"):
                torch.randn(64).sort()
    events = list(prof.profiler.kineto_results.events())
    assert events and {s.name for s in trace.spans()} == names
    assert not [e.name() for e in events if e.is_user_annotation() or e.name() in names]


def test_setup_spans_record_with_the_tracer_off():
    with trace.setup_span("setup.kernel_load"):
        with trace.span("kernels.greedy_select"):  # off: not recorded
            pass
    (rec,) = trace.spans()
    assert rec.name == "setup.kernel_load" and rec.parent is None and rec.device_ms() is None
    assert rec.end_ns >= rec.start_ns


def test_the_buffer_keeps_its_bound_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 4)
    trace.clear()
    trace.enable()
    for i in range(7):
        with trace.span(f"s{i}"):
            pass
    assert [s.name for s in trace.spans()] == ["s3", "s4", "s5", "s6"] and trace.dropped() == 3
    assert trace.summary()["dropped"] == 3
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


def test_summary_sums_by_name_and_reads_the_registered_launch_counters(monkeypatch):
    from feature_detector_tpu_torch.kernels import fast, fixed_order, greedy, lsd_flood

    monkeypatch.setattr(greedy.greedy_select, "launches", greedy.greedy_select.launches + 5)
    trace.enable()
    for _ in range(3):
        with trace.span("match.hamming"):
            pass
    with trace.span("match.float"):
        pass
    out = trace.summary()
    assert out["spans"]["match.hamming"]["calls"] == 3 and out["spans"]["match.float"]["calls"] == 1
    assert out["spans"]["match.hamming"]["device_ms"] is None
    assert out["launches"] == {"greedy_select": greedy.greedy_select.launches,
                               "propagate_running": lsd_flood.propagate_running.launches,
                               "fixed_contract": fixed_order.fixed_contract.launches,
                               "fixed_lu_solve": fixed_order.fixed_lu_solve.launches,
                               "fast_maps": fast.fast_maps.launches}


def fast_step(imgs_a, imgs_b):
    opts, sub = DetectorOptions(min_feature_distance=8, min_valid_response=10.0, max_features=40), FastOptions()
    fa = detect_good_features_batch(imgs_a, "fast", 40, opts, sub)
    fb = detect_good_features_batch(imgs_b, "fast", 40, opts, sub)
    wa, va = brief_compute(imgs_a, fa.uv, fa.valid, BriefOptions())
    wb, vb = brief_compute(imgs_b, fb.uv, fb.valid, BriefOptions())
    return match_hamming(wa, va, wb, vb, MatcherOptions())


def test_the_classical_paths_spans():
    imgs = scenes(2, 64, 96)
    trace.enable()
    fast_step(imgs, imgs.roll(2, -1))
    recs = trace.spans()
    names = [s.name for s in recs]
    assert names == ["kernels.fast", "kernels.greedy_select", "frontend.detect_batch"] * 2 + [
        "frontend.describe", "frontend.describe", "match.hamming"]
    assert all(s.parent == "frontend.detect_batch" for s in recs if s.name.startswith("kernels."))
    assert len({s.top for s in recs}) == 5  # two detect calls, two describe calls, one match


def test_the_nn_paths_spans():
    opts = NNDetectorOptions(max_image_rows=64, max_image_cols=96, model_type=NNModelType.DISK_HEATMAP)
    det = NNFeaturePointDetector(opts, device="cpu", dtype=torch.float32)
    det.initialize()
    (init,) = trace.spans()
    assert init.name == "setup.nn_initialize" and init.parent is None
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        det.detect(scenes(1, 64, 96)[0])
    t = tree(trace.spans())
    assert t == {"models.forward": ("frontend.nn_detect", t["frontend.nn_detect"][1]),
                 "frontend.nn_pool": ("frontend.nn_detect", t["frontend.nn_detect"][1]),
                 "frontend.nn_candidates": ("frontend.nn_postprocess", t["frontend.nn_detect"][1]),
                 "kernels.greedy_select": ("frontend.nn_postprocess", t["frontend.nn_detect"][1]),
                 "kernels.nn_sample": ("frontend.nn_postprocess", t["frontend.nn_detect"][1]),
                 "frontend.nn_postprocess": ("frontend.nn_detect", t["frontend.nn_detect"][1]),
                 "frontend.nn_detect": (None, t["frontend.nn_detect"][1])}


def test_the_frame_parallel_matchers_spans():
    import torch.distributed as dist

    from feature_detector_tpu_torch.parallel.frontend import make_two_frame_matcher
    from feature_detector_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")  # a world of one, in this process
    try:
        opts = DetectorOptions(min_feature_distance=8, min_valid_response=10.0, max_features=40)
        matcher = make_two_frame_matcher(mesh, "fast", 40, opts, FastOptions())
        imgs = scenes(2, 64, 96)
        trace.enable()
        matcher(imgs, imgs.roll(2, -1))
    finally:
        dist.destroy_process_group()
    recs = trace.spans()
    assert len({s.top for s in recs}) == 1
    top = [s for s in recs if s.parent is None]
    assert [s.name for s in top] == ["parallel.two_frame"]
    assert [s.name for s in recs if s.parent == "parallel.two_frame"] == ["parallel.local"] + ["parallel.gather"] * 9
    local = next(s for s in recs if s.name == "parallel.local")
    assert all(local.end_ns <= s.start_ns for s in recs if s.name == "parallel.gather")
    assert [s.name for s in recs if s.parent == "parallel.local"] == [
        "frontend.detect_batch", "frontend.detect_batch", "frontend.describe", "frontend.describe", "match.hamming"]


@pytest.mark.gpu
def test_on_the_card_spans_time_the_device_and_add_no_annotation():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda")
    imgs = scenes(4, 480, 752).to(cuda)
    fast_step(imgs, imgs.roll(2, -1))  # builds and loads K1 before the profile
    torch.cuda.synchronize()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fast_step(imgs, imgs.roll(2, -1))
        torch.cuda.synchronize()
    recs = trace.spans()
    names = {s.name for s in recs}
    assert names == {"frontend.detect_batch", "kernels.fast", "kernels.greedy_select", "frontend.describe",
                     "match.hamming"}
    for s in recs:  # under a profile only FAST's span asks for the device
        assert (s.device_ms() > 0) if s.name == "kernels.fast" else (s.device_ms() is None)
    events = list(prof.profiler.kineto_results.events())
    assert not [e.name() for e in events if e.is_user_annotation() or e.name() in names]
    mms = [e for e in events if e.name() == "aten::bitwise_xor" and e.device_type() == torch.autograd.DeviceType.CPU]
    hamming = [s for s in recs if s.name == "match.hamming"][0]
    assert mms and all(hamming.start_ns <= e.start_ns() and e.end_ns() <= hamming.end_ns for e in mms)
    trace.clear()
    trace.enable()  # every span times the device
    fast_step(imgs, imgs.roll(2, -1))
    recs = trace.spans()
    torch.cuda.synchronize()
    assert all(s.device_ms() > 0 for s in recs)
    fast = sum(s.device_ms() for s in recs if s.name == "kernels.fast")
    detect = sum(s.device_ms() for s in recs if s.name == "frontend.detect_batch")
    assert 0 < fast < detect
    assert trace.summary()["launches"]["greedy_select"] > 0
