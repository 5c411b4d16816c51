"""The readings that the limits of ``correct`` are set from: the program's
numbers on many seeds, and the control's, the plain reference put in the
program's place one precision below the configuration's.

    python3 -m bench_cuda.control --workload <name> --seconds 3 --seeds 1 2 3 ... --control-seeds 1 2 3

For each seed of ``--seeds`` a whole run of the cell (set-up, a window of
``--seconds``, the sampled outputs, the check) in this process; for each
seed of ``--control-seeds`` the control on the same sampled inputs, judged
by the same check.  A cell whose mix spans several ranks gives only the
control's readings, on the pairs that its check samples (its program
readings come from its own runs).  Prints one JSON line a reading and last
a summary: per number, the program's largest reading and the control's
least.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import frames
from .harness import ROOT, Run, find, load_benchmark, load_config, load_pipeline
from .run import parse, run_one


def pair_inputs(run) -> list:
    """The inputs of the pairs that a full window's check samples, with no
    program run: for a mix over several ranks, whose outputs carry no
    descriptor words."""
    from .pipelines import fast_brief

    a, b = frames.pair_pool(run.mix, run.seed, run.config["rows"], run.config["cols"], run.device)
    return [{"image_a": a[k, j].cpu().numpy(), "image_b": b[k, j].cpu().numpy()}
            for k, j in fast_brief.sample(run, list(range(run.mix["pool"])))]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--root", default=str(ROOT))
    args = p.parse_args(argv)
    root = Path(args.root)
    bench = load_benchmark(root)
    workload = find(bench["workloads"], args.workload, "workload")
    config = load_config(bench, workload["config"], root)
    mix = frames.load_mix(workload["traffic"], root)
    pipe = load_pipeline(config["pipeline"])
    import torch

    readings = {"program": {}, "control": {}}

    def emit(side, seed, checks):
        print(json.dumps({"workload": args.workload, "seed": seed, "side": side, "checks": checks}), flush=True)
        for k, v in checks.items():
            readings[side].setdefault(k, []).append(v)

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        run_args = parse(["--workload", args.workload, "--seed", str(seed), "--seconds", str(args.seconds),
                          "--device", args.device, "--root", args.root])
        if mix.get("ranks", 1) > 1:
            run = Run(run_args, bench, workload, config, mix)
            run.device = torch.device(args.device)
            outs = pair_inputs(run)
            ctrl = pipe.control(run, outs)
        else:
            rec = run_one(run_args, bench, workload, config, mix, keep=True)
            run, outs = rec["run"], rec["outputs"]
            if seed in args.seeds:
                emit("program", seed, {k: v for k, (v, _) in rec["checks"].items()})
            ctrl = pipe.control(run, outs) if seed in args.control_seeds else None
            if "widest" in run.extra:
                print(json.dumps({"seed": seed, "side": "program", "widest": run.extra["widest"]}), flush=True)
        if ctrl is not None:
            emit("control", seed, {k: v for k, (v, _) in pipe.check(run, ctrl).items()})
            if "widest" in run.extra:
                print(json.dumps({"seed": seed, "side": "control", "widest": run.extra["widest"]}), flush=True)
        del outs, ctrl
        if args.device == "cuda":
            torch.cuda.empty_cache()
    summary = {k: {"program_max": max(readings["program"].get(k, [float("nan")])),
                   "control_min": min(readings["control"].get(k, [float("nan")]))}
               for k in set(readings["program"]) | set(readings["control"])}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
