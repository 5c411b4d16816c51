"""Runs one cell of ``BENCHMARK.json`` once and prints the result line.

    python3 -m bench_cuda.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (the process's start to the window's: imports, the CUDA context,
kernel builds on a checkout's first run, frames and weights from the seed,
the warm-up of every shape the cell uses), then the measured window of
``--seconds``, then with ``--trace 1`` the profiled segment, then the check
of the window's sampled outputs against the plain reference.  The last line
of stdout is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit); the last lines of stderr
repeat the checks.  It exits non-zero and prints no result where the card
or the cards the cell asks for are missing, where the program cannot be
imported, or where a module of JAX or of the JAX package is loaded once the
window has closed.

A cell whose mix has ``ranks`` > 1 starts one process a card (this module
with ``--rank``), which join over NCCL at a free localhost port; rank 0's
metrics and check make the result, with the fullest card's memory peak and
the cards' mean busy time.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import frames
from .harness import (
    ROOT,
    Run,
    cell_metrics,
    find,
    forbidden_modules,
    load_benchmark,
    load_config,
    load_metric,
    load_pipeline,
    nvidia_smi,
    print_checks,
    process_start_epoch,
    result_line,
)

RANK_WALL_S = 330  # a rank that has not ended by then is stopped, and the run fails
HOST_THREADS = 4  # torch's host threads a process: one process with few threads loads the host steadily


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Set by the launcher for each rank of a multi-card cell.
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    # The harness's own tests run it on the CPU at a small size: no look for a card.
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--root", default=str(ROOT), help=argparse.SUPPRESS)
    return p.parse_args(argv)


def run_one(args, bench: dict, workload: dict, config: dict, mix: dict, keep: bool = False) -> dict:
    """One process's run (the whole cell, or one rank of it): set-up, the
    window, the trace, the sampled outputs and, on rank 0, the check.
    Returns its record; with ``keep`` also the ``Run`` and the outputs."""
    import torch

    rank = args.rank or 0
    run = Run(args, bench, workload, config, mix, rank, args.world)
    cuda = args.device == "cuda"
    if cuda and args.world > 1:
        torch.cuda.set_device(rank)
    run.device = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    run.spans.enabled = run.trace_on and cuda
    pipe = load_pipeline(config["pipeline"])
    state = pipe.setup(run)
    run.measure(lambda: pipe.step(run, state))
    rec = {"window_start_epoch": run.window["start_epoch"], "attempted": run.window["frames"],
           "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
           "device_name": torch.cuda.get_device_name(run.device) if cuda else "cpu"}
    if not run.trace_on:
        rec["metrics"] = pipe.end_to_end(run, state)
    else:
        run.span_ms = {name: run.spans.ms(name) for name in run.spans.events}
        run.spans.enabled = False
        if cuda:
            run.profile(lambda: pipe.step(run, state), pipe.TRACE_LAUNCHES)
            rec.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"],
                       breakdown={"device_ops": run.trace["device_ops"], "idle_gaps": run.trace["idle_gaps"]})
        values = {m["name"]: load_metric(m["name"]).read(run) for m in cell_metrics(bench, workload["name"], True)}
        rec["metrics"] = {k: v for k, v in values.items() if v is not None}
    outs = pipe.outputs(run, state) if rank == 0 else None
    del state
    gc.collect()
    if args.world > 1:
        import torch.distributed as dist

        run.bcast(0)
        dist.destroy_process_group()
    if cuda:
        torch.cuda.empty_cache()
    rec["checks"] = pipe.check(run, outs) if rank == 0 else {}
    rec["forbidden"] = forbidden_modules()  # last: what the outputs and the check loaded counts
    if keep:
        rec.update(run=run, outputs=outs)
    return rec


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(args, world: int, entry: str):
    """Starts ``world`` processes of ``entry``, one a card, and waits for
    them.  Returns their records in rank order, or None when one failed or
    outlived RANK_WALL_S (then every rank is stopped)."""
    out = tempfile.mkdtemp(prefix="bench_cuda_ranks_")
    port = free_port()
    base = [sys.executable, "-m", entry, "--workload", args.workload, "--seed", str(args.seed),
            "--seconds", str(args.seconds), "--trace", str(args.trace), "--device", args.device,
            "--root", args.root, "--world", str(world), "--port", str(port), "--out", out]
    procs = [subprocess.Popen(base + ["--rank", str(r)], cwd=ROOT, stdout=sys.stderr) for r in range(world)]
    deadline = time.monotonic() + RANK_WALL_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    try:
        if any(p.returncode != 0 for p in procs):
            print(f"bench_cuda: rank exit codes {[p.returncode for p in procs]}", file=sys.stderr)
            return None
        records = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                records.append(json.load(f))
        return records
    finally:
        shutil.rmtree(out, ignore_errors=True)


def emit(args, bench: dict, records: list, started: float) -> int:
    """Prints the checks (stderr) and the result line (stdout) of rank 0's
    record with the other ranks' memory peak and busy time."""
    found = sorted(set(forbidden_modules()).union(*(r["forbidden"] for r in records)))
    if found:
        print(f"bench_cuda: modules of JAX or of the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    first = records[0]
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    values = dict(first["metrics"])
    if not args.trace:
        values["setup_s"] = first["window_start_epoch"] - started
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items()}
    cuda = args.device == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": first["device_name"],
              "count": len(records),
              "memory_peak_bytes": max(r["memory_peak_bytes"] for r in records),
              "power_limit": nvidia_smi() if cuda else "none"}
    if args.trace and cuda:
        device["busy_s"] = sum(r["busy_s"] for r in records) / len(records)
        device["window_s"] = first["window_s"]
    checks = first["checks"]
    failed = sum(1 for v, lim in checks.values() if v > lim)
    print_checks(checks)
    print(result_line(failed == 0, first["attempted"], failed, metrics, device, checks,
                      first.get("breakdown") if args.trace and cuda else None), flush=True)
    return 0


def main(argv=None, entry: str = "bench_cuda.run") -> int:
    """``entry``: the module that the ranks of a multi-card cell run."""
    started = process_start_epoch()
    args = parse(argv)
    root = Path(args.root)
    bench = load_benchmark(root)
    workload = find(bench["workloads"], args.workload, "workload")
    config = load_config(bench, workload["config"], root)
    mix = frames.load_mix(workload["traffic"], root)
    world = mix.get("ranks", 1)

    import torch

    torch.set_num_threads(HOST_THREADS)
    if args.device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]):
        print(f"bench_cuda: {workload['name']} needs {workload['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if args.rank is not None:
        rec = run_one(args, bench, workload, config, mix)
        if rec["forbidden"]:
            print(f"bench_cuda: rank {args.rank} loaded modules of JAX or of the JAX package: {rec['forbidden']}",
                  file=sys.stderr)
            return 3
        with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
            json.dump(rec, f)
        return 0
    if world > 1:
        records = launch(args, world, entry)
        if records is None:
            return 1
    else:
        records = [run_one(args, bench, workload, config, mix)]
    return emit(args, bench, records, started)


if __name__ == "__main__":
    sys.exit(main())
