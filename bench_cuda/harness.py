"""The machinery every cell shares: finding entries by name, the measured
window, CUDA-event spans, the profiled segment, the result line and the
check for modules of the JAX package.

A pipeline (``pipelines/<name>.py``) drives the program for one kind of
configuration and gives these functions, each taking the ``Run``:
``setup(run)`` returns its state after the warm-up; ``step(run, state)``
does one unit of the mix's work (a step of pairs or a frame) and returns
the frames it finished; ``end_to_end(run, state)`` gives the end-to-end
metrics of the window; ``outputs(run, state)`` moves the sampled outputs of
the window to the host; ``check(run, outputs)`` compares them with the
plain reference and returns ``{name: (value, limit)}``; ``control(run,
outputs)`` puts the control in the program's place (``bench_cuda.control``
only).  Its ``TRACE_LAUNCHES`` gives the launches that one call makes of
the kernels a per-layer metric reads, by a part of their names, so that a
trace that lacks some is taken again.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "feature_detector_tpu")
TRACE_SEGMENT_S = 2.0  # host seconds of work profiled for the idle share and the kernels' device time
GAP_SEGMENT_S = 0.3  # host seconds of work profiled with the host's ops, for the idle gaps
GAPS_LABELLED = 200  # the longest gaps of that segment, labelled by the host op in progress
TOP = 10  # entries of each breakdown list
NAME_CHARS = 160  # a kernel's name in the breakdown is cut to this length


def process_start_epoch() -> float:
    """The wall-clock time at which this process started (Linux)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return btime + start_ticks / os.sysconf("SC_CLK_TCK")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration file of ``name``, as BENCHMARK.json places it."""
    with open(root / find(bench["configs"], name, "configuration")["file"]) as f:
        return json.load(f)


def load_pipeline(name: str):
    return importlib.import_module(f"bench_cuda.pipelines.{name}")


def load_metric(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, whose
    ``read(run)`` gives the value, or None where it finds nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_cuda.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics, or with ``trace`` its per-layer ones.  An entry with a
    ``workloads`` key belongs to the cells it lists; one without it to
    every cell (an end-to-end one) or to every cell that reports the
    end-to-end metric it moves (a per-layer one)."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if ((workload in m["workloads"]) if "workloads" in m else (m["moves"] in names))]


def forbidden_modules(names=None) -> list:
    """Top-level names among ``names`` (by default ``sys.modules``) that are
    JAX's or the JAX package's, compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules if names is None else names)} & set(FORBIDDEN))


class Spans:
    """CUDA-event spans by name, recorded on the current stream, in a
    ``--trace 1`` run only; ``ms(name)`` sums them once the device is done."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events: dict = {}
        self._open: dict = {}

    def begin(self, name: str) -> None:
        if self.enabled:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._open[name] = ev

    def end(self, name: str) -> None:
        if self.enabled:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.setdefault(name, []).append((self._open.pop(name), ev))

    @contextlib.contextmanager
    def span(self, name: str):
        self.begin(name)
        yield
        self.end(name)

    def ms(self, name: str):
        pairs = self.events.get(name)
        return None if not pairs else sum(s.elapsed_time(e) for s, e in pairs)

    def clear(self) -> None:
        self.events.clear()
        self._open.clear()


class Run:
    """One run of one cell: its arguments, entries, spans, window and trace."""

    def __init__(self, args, bench: dict, workload: dict, config: dict, mix: dict, rank: int = 0, world: int = 1):
        self.root = Path(args.root)
        self.args, self.bench, self.workload, self.config, self.mix = args, bench, workload, config, mix
        self.seed, self.seconds, self.trace_on = args.seed, args.seconds, bool(args.trace)
        self.rank, self.world = rank, world
        self.device = None  # the run's torch.device, set before the pipeline's set-up
        self.spans = Spans(False)  # on in a --trace 1 run on the card
        self.window: dict = {}
        self.trace: dict = {}
        self.extra: dict = {}
        self.rate = None  # calls a second of the latest loop, rank 0's decides

    def sync(self) -> None:
        """Waits for the card (nothing to wait for on the CPU)."""
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize()

    def bcast(self, value: float) -> float:
        """Rank 0's ``value`` on every rank: one broadcast over the ranks'
        own group, for the few decisions that every rank has to share."""
        if self.world == 1:
            return value
        import torch
        import torch.distributed as dist

        t = torch.tensor([float(value)], dtype=torch.float64, device=self.device)
        dist.broadcast(t, 0)
        return float(t[0])

    def loop(self, fn, seconds: float, min_calls: int = 1) -> tuple:
        """Calls ``fn`` back to back, then synchronises.  One rank stops once
        it has spent ``seconds`` of host time and made ``min_calls`` calls.
        Several ranks make a number of calls fixed before the loop, so that
        each makes the same steps with no exchange of the harness's own
        among the calls: rank 0's rate in the latest loop times ``seconds``;
        with no rate yet (the warm-up), ``min_calls`` calls to warm every
        shape, then as many again for the rate.  Returns (calls, the frames
        that the calls returned, seconds from start to the end of the
        device's work, the wall-clock time of the start)."""
        if self.world == 1:
            return self._calls(fn, None, seconds, min_calls)
        if self.rate is None:
            self._calls(fn, min_calls)
            return self._calls(fn, min_calls)
        return self._calls(fn, self.calls_for(seconds, min_calls))

    def _calls(self, fn, count, seconds: float = 0.0, min_calls: int = 1) -> tuple:
        """``count`` calls of ``fn``, or with None as many as ``seconds`` and
        ``min_calls`` ask; sets ``rate``."""
        self.sync()
        started, t0 = time.time(), time.perf_counter()
        calls = frames = 0
        while (calls < count) if count is not None else (calls < min_calls or time.perf_counter() - t0 < seconds):
            frames += fn()
            calls += 1
        self.sync()
        elapsed = time.perf_counter() - t0
        self.rate = calls / elapsed
        return calls, frames, elapsed, started

    def measure(self, fn) -> None:
        """The measured window: ``fn`` back to back for ``--seconds``."""
        calls, frames, seconds, started = self.loop(fn, self.seconds)
        self.window.update(calls=calls, frames=frames, seconds=seconds, start_epoch=started)

    def calls_for(self, seconds: float, least: int = 3) -> int:
        """Calls that take about ``seconds`` at rank 0's rate in the latest
        loop, at least ``least``."""
        return int(self.bcast(max(least, round(self.rate * seconds))))

    def profile(self, fn, launches: dict) -> None:
        """The profiled segment after the window: ``fn`` for about
        TRACE_SEGMENT_S under torch.profiler (device activity only), taken
        again, up to three times in all, while the trace lacks a launch that
        the calls made (CUPTI now and then hands back an empty trace, or one
        without some kernels): ``launches`` gives, for kernels whose names
        contain a key, the launches of one call.  Then a short segment with
        the host's ops, for the idle gaps."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        n = self.calls_for(TRACE_SEGMENT_S)
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                frames = sum(fn() for _ in range(n))
                torch.cuda.synchronize()
                window_s = time.perf_counter() - t0
            dev = device_events(prof)
            kernels: dict = {}
            for name, _, dur in dev:
                k = kernels.setdefault(name, [0.0, 0])
                k[0] += dur / 1e6
                k[1] += 1
            whole = bool(dev) and all(sum(c for k, (_, c) in kernels.items() if needle in k) == per * n
                                      for needle, per in launches.items())
            if self.bcast(whole):
                break
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
        self.trace.update(complete=whole, calls=n, frames=frames, window_s=window_s, busy_s=busy_seconds(dev),
                          kernels=kernels, device_ops=[[name[:NAME_CHARS], ms / 1e3] for name, (ms, _) in top])
        n_gap = self.calls_for(GAP_SEGMENT_S)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_gap):
                fn()
            torch.cuda.synchronize()
        self.trace["idle_gaps"] = idle_gaps(prof)

    def kernel_ms(self, *needles: str) -> tuple:
        """(device ms, launches) in the profiled segment of the kernels whose
        names contain one of ``needles``."""
        hits = [v for k, v in self.trace.get("kernels", {}).items() if any(n in k for n in needles)]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)


def device_events(prof) -> list:
    """(name, start ns, duration ns) of every device event of a finished
    torch.profiler run, from the raw trace."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def merged(intervals) -> list:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(dev: list) -> float:
    """Seconds in which some device event ran (their union)."""
    return sum(e - s for s, e in merged((s, s + d) for _, s, d in dev)) / 1e9


def idle_gaps(prof) -> list:
    """The GAPS_LABELLED longest gaps between device activity in a trace
    with the host's ops, summed by what the host was doing when each gap
    began (the outermost and the innermost host op in progress), the TOP
    largest sums as [[label, seconds], ...]."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        (dev if e.device_type() == cuda else host).append((e.start_ns(), e.end_ns(), e.name()))
    busy = merged((s, e) for s, e, _ in dev)
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1]) for i in range(len(busy) - 1)), reverse=True)
    if not host:
        return []
    hs = np.array([h[0] for h in host], np.int64)
    he = np.array([h[1] for h in host], np.int64)
    sums: dict = {}
    for length, at in gaps[:GAPS_LABELLED]:
        live = np.nonzero((hs <= at) & (he >= at))[0]
        if len(live):
            dur = he[live] - hs[live]
            label = f"{host[live[dur.argmax()]][2]} / {host[live[dur.argmin()]][2]}"
        else:
            label = "host between torch ops"
        sums[label] = sums.get(label, 0.0) + length / 1e9
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]]


def nvidia_smi(query: str = "name,power.limit") -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {err}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict, checks: dict,
                breakdown: dict | None = None) -> str:
    """The contract's last line; ``checks`` ({name: (value, limit)}) comes
    last."""
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return json.dumps(out)


def print_checks(checks: dict) -> None:
    """Each number compared beside its limit, as the last lines of stderr."""
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr, flush=True)
