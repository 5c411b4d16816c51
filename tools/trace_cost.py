"""The tracer's cost when it is on: the ``--trace 0`` window of benchmark
cells run with ``utils/trace.py``'s ``enable()`` and without it, in turns,
on one CUDA card.

    python tools/trace_cost.py [--cells disk.stream fast_brief.b64] [--pairs 3]
                               [--seconds 20] [--seed 3950000001] [--out FILE]

Each run is a fresh process of ``python -m bench_cuda.run`` (this script
with ``--child on|off`` in front of the run's arguments).  A cell's pairs
share a seed each and alternate which side runs first (off, on; on, off;
...).  Prints one JSON line: per cell, each side's runs, the median and
the quartile spread (the quartiles' distance over the median, as
``statistics.quantiles`` gives them) of every end-to-end metric, the
median over the "on" runs of the span readers' values and of the device
split of the NN post-processing (read with no profiler running, where
every span times the device), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


SPAN_METRICS = ("fb.fast_ms", "nn.forward_host_ms", "nn.postprocess_host_ms")  # span readers that need no process group
# Device ms a frame of the NN post-processing's parts, per ``frontend.nn_detect`` call.
NN_DEVICE_SPLIT = {"nn.candidates_ms": {"frontend.nn_candidates"}, "nn.select_ms": {"kernels.greedy_select"},
                   "nn.sample_ms": {"frontend.nn_pool", "kernels.nn_sample"}}


def child(side: str, argv: list) -> int:
    """One run; with the tracer on, then the span readers' values and the NN
    device split over the calls the run made (warm-up, window and check),
    with no profiler, as a ``spans`` line on stderr."""
    sys.path.insert(0, str(ROOT))
    from bench_cuda import harness, program_spans, run
    from feature_detector_tpu_torch.utils import trace

    if side == "on":
        trace.enable()
    rc = run.main(argv)
    if side == "on":
        values = {n: harness.load_metric(n).read(None) for n in SPAN_METRICS}
        recs = program_spans.records()
        values.update({n: program_spans.median_per_call(recs, "frontend.nn_detect", names, "device")
                       for n, names in NN_DEVICE_SPLIT.items()})
        print("spans", json.dumps({k: v for k, v in values.items() if v is not None}), file=sys.stderr, flush=True)
    return rc


def one_run(cell: str, side: str, seed: int, seconds: float) -> tuple:
    """(the run's result line, its span readers' values or None)."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child", side, "--workload", cell, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", "0"]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        raise RuntimeError(f"{cell} {side} seed {seed}: exit {p.returncode}\n{p.stderr[-3000:]}")
    spans = [json.loads(line[6:]) for line in p.stderr.splitlines() if line.startswith("spans ")]
    return json.loads(p.stdout.strip().splitlines()[-1]), (spans[-1] if spans else None)


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", nargs="+", default=["disk.stream", "fast_brief.b64"])
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=3950000001)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    report = {}
    for cell in args.cells:
        runs, spans = {"off": [], "on": []}, []
        for i in range(args.pairs):
            for side in (("off", "on") if i % 2 == 0 else ("on", "off")):
                line, read = one_run(cell, side, args.seed + i, args.seconds)
                if not line["correct"]:
                    raise RuntimeError(f"{cell} {side} seed {args.seed + i}: correct is false: {line['checks']}")
                runs[side].append({k: v["value"] for k, v in line["metrics"].items()})
                if read:
                    spans.append(read)
                report["device"] = line["device"]["power_limit"]
                print(cell, side, args.seed + i, json.dumps(runs[side][-1]), read, file=sys.stderr, flush=True)
        names = sorted(runs["off"][0])
        report[cell] = {side: {"runs": r, **{n: {"median": statistics.median(x[n] for x in r),
                                                 "spread": spread([x[n] for x in r])} for n in names}}
                        for side, r in runs.items()}
        report[cell]["spans_on"] = {n: statistics.median(x[n] for x in spans) for n in (spans[0] if spans else ())}
    text = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        sys.exit(child(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
