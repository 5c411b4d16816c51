"""Times K4 (``fixed_contract``, ``fixed_sum``) and K5 (``fixed_lu_solve``)
of a checkout on one CUDA card at the fused VO's largest calls, and compares
two checkouts on the same card.

    python tools/fixed_order_times.py                      # this checkout
    python tools/fixed_order_times.py --root DIR           # the checkout at DIR
    python tools/fixed_order_times.py --against DIR [--out FILE]

With ``--against``, the script runs itself in a fresh process for each
side in the order DIR, this, this, DIR (a checkout of another commit, such
as the parent unpacked with ``git archive``), each process building its
checkout's kernels into that checkout's ``build/``, and prints one JSON line
with every run and, per shape, the two sides' mean call and device times.

Shapes (the bench VO's, PERF.md section 4): the reduced camera system
[34, 72, 1536] @ [34, 1536, 72] with c n-contiguous as the chunk solver
hands it, and a rank's [10, ...] share of it on four cards; a camera's block
[408, 6, 1024, 6]; a landmark's block [17408, 3, 24] @ [17408, 24, 3] with a
m-contiguous; the largest sum [17, 2, 512, 158, 12] over 12; 34 and 10
systems of 72 and 408 of 6 for K5.  The library's call on the same operands
(``torch.matmul``, ``sum``, ``torch.linalg.solve_ex``) is timed beside each.
Call time: CUDA events over 50 calls after a warm-up, wrapper included.
Device time: every CUDA kernel a call launches, from torch.profiler.
Operands are float32 normals from seed 0 (systems diagonally dominant).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ITERS = 50
PROFILED_ITERS = 10


def _time(torch, fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.25:  # the card raises its clocks under load
        fn()
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_ITERS):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    return {"ms": start.elapsed_time(end) / ITERS,
            "device_ms": sum(e.duration_ns() for e in events) / 1e6 / PROFILED_ITERS,
            "kernels_per_call": len(events) / PROFILED_ITERS}


def measure(root: Path) -> dict:
    """One side: this process imports the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import torch

    from feature_detector_tpu_torch.kernels import fixed_order as FO

    if not torch.cuda.is_available():
        raise SystemExit("fixed_order_times: needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    randn = lambda *shape: torch.randn(*shape, generator=g).to(dev)

    def systems(batch, n):
        return randn(batch, n, n) + 2 * n * torch.eye(n, device=dev), randn(batch, n)

    cases = {
        "k4_reduced_system_34": (FO.fixed_contract, torch.matmul, (randn(34, 72, 1536), randn(34, 1536, 72))),
        "k4_reduced_system_10": (FO.fixed_contract, torch.matmul, (randn(10, 72, 1536), randn(10, 1536, 72))),
        "k4_camera_block_408": (FO.fixed_contract, torch.matmul, (randn(408, 6, 1024), randn(408, 1024, 6))),
        "k4_landmark_block_17408": (FO.fixed_contract, torch.matmul,
                                    (randn(17408, 24, 3).transpose(-1, -2), randn(17408, 24, 3))),
        "k4_sum_17x2x512x158x12": (FO.fixed_sum, lambda x: x.sum(-1), (randn(17, 2, 512, 158, 12),)),
        "k5_34x72": (FO.fixed_lu_solve, lambda a, b: torch.linalg.solve_ex(a, b[..., None]), systems(34, 72)),
        "k5_10x72": (FO.fixed_lu_solve, lambda a, b: torch.linalg.solve_ex(a, b[..., None]), systems(10, 72)),
        "k5_408x6": (FO.fixed_lu_solve, lambda a, b: torch.linalg.solve_ex(a, b[..., None]), systems(408, 6)),
    }
    out = {"root": str(root), "card": torch.cuda.get_device_name(0), "torch": torch.__version__, "shapes": {}}
    for name, (kernel, library, args) in cases.items():
        out["shapes"][name] = {**_time(torch, lambda: kernel(*args)),
                               "library": _time(torch, lambda: library(*args))}
    return out


def compare(other: Path, out_file) -> dict:
    here = Path(__file__).resolve().parents[1]
    runs = []
    for side, root in (("other", other), ("this", here), ("this", here), ("other", other)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--root", str(root)],
                              capture_output=True, text=True, cwd=root, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"fixed_order_times: the {side} side ({root}) failed:\n{proc.stderr[-4000:]}")
        runs.append({"side": side, **json.loads(proc.stdout.strip().splitlines()[-1])})
    mean = lambda side, name, key: sum(r["shapes"][name][key] for r in runs if r["side"] == side) / 2
    summary = {name: {f"{side}_{key}": mean(side, name, key) for side in ("this", "other")
                      for key in ("ms", "device_ms", "kernels_per_call")}
               for name in runs[0]["shapes"]}
    for name in summary:
        summary[name]["library_ms"] = sum(r["shapes"][name]["library"]["ms"] for r in runs) / len(runs)
    result = {"this": str(here), "other": str(other), "order": [r["side"] for r in runs], "summary": summary,
              "runs": runs}
    if out_file:
        Path(out_file).parent.mkdir(parents=True, exist_ok=True)
        Path(out_file).write_text(json.dumps(result, indent=1))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--against", type=Path, help="another checkout to compare with, on the same card")
    ap.add_argument("--out", help="also write the comparison's JSON here")
    args = ap.parse_args(argv)
    if args.against:
        result = compare(args.against.resolve(), args.out)
        print(json.dumps(result["summary"]))
    else:
        print(json.dumps(measure(args.root.resolve())))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONDONTWRITEBYTECODE", "1")
    sys.exit(main())
