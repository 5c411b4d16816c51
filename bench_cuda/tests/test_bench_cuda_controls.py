"""The comparison that decides ``correct`` fails where it has to: the
control (the plain reference one precision below the configuration's, in
the program's place) and whole runs with the timed path broken underneath
(``faults.py``), on the CPU at small sizes.

    python -m pytest bench_cuda/tests/test_bench_cuda_controls.py -q
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import pytest
import torch

from bench_cuda import frames, harness
from bench_cuda.run import parse, run_one
from bench_cuda.tests.test_bench_cuda_harness import last_json, run_cell, tiny_root


def control_checks(root: Path, workload: str, seed: int, seconds: float = 0.3) -> tuple:
    """(the program's checks, the control's checks) of one in-process run."""
    bench = harness.load_benchmark(root)
    w = harness.find(bench["workloads"], workload, "workload")
    cfg = harness.load_config(bench, w["config"], root)
    mix = frames.load_mix(w["traffic"], root)
    args = parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--device", "cpu",
                  "--root", str(root)])
    torch.set_num_threads(2)
    rec = run_one(args, bench, w, cfg, mix, keep=True)
    pipe = harness.load_pipeline(cfg["pipeline"])
    return rec["checks"], pipe.check(rec["run"], pipe.control(rec["run"], rec["outputs"]))


def failing(checks: dict) -> list:
    return [k for k, (v, lim) in checks.items() if v > lim]


@pytest.mark.parametrize("seed", [3000000019, 5])
def test_disk_control_fails_and_the_program_passes(tmp_path, seed):
    # 128x160: at the test's smallest size float8's gaps stay under the limits set at 752x480
    root = tiny_root(tmp_path)
    cfg = json.loads((root / "bench_cuda/configs/tiny_disk.json").read_text())
    (root / "bench_cuda/configs/tiny_disk.json").write_text(json.dumps(dict(cfg, rows=128, cols=160)))
    program, control = control_checks(root, "disk.stream", seed)
    assert failing(program) == []
    assert "desc_err" in failing(control)


def eight_scene_root(path: Path) -> Path:
    """The small root with 240x320 pairs, each of the 8 pairs of a step
    from its own scene: enough distinct features that the control's about
    1% of steering angles that land in another bin show."""
    root = tiny_root(path)
    cfg = json.loads((root / "bench_cuda/configs/tiny_fast.json").read_text())
    (root / "bench_cuda/configs/tiny_fast.json").write_text(json.dumps(dict(cfg, rows=240, cols=320)))
    for name in ("tiny_pairs", "tiny_pairs4"):
        mix = json.loads((root / f"bench_cuda/traffic/{name}.json").read_text())
        (root / f"bench_cuda/traffic/{name}.json").write_text(json.dumps(dict(mix, scenes=8, pool=1)))
    return root


@pytest.mark.parametrize("seed", [3000000023, 3000000029, 11])
def test_fast_brief_control_fails_and_the_program_passes(tmp_path, seed):
    program, control = control_checks(eight_scene_root(tmp_path), "fast_brief.b64", seed)
    assert failing(program) == []
    assert {"word_diff", "match_diff"} <= set(failing(control))


def test_fast_brief_control_over_ranks_fails_on_the_matches(tmp_path, capsys):
    from bench_cuda import control

    control.main(["--workload", "fast_brief.b64x4", "--control-seeds", "3000000023", "11", "--device", "cpu",
                  "--root", str(eight_scene_root(tmp_path))])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert all(x["checks"]["match_diff"] > 0 for x in lines if x.get("side") == "control")


@pytest.mark.parametrize("workload, fault", [
    ("fast_brief.b64", "half_batch"),
    ("fast_brief.b64", "altered_match"),
    ("fast_brief.b64", "altered_word"),
    ("disk.stream", "altered_feature"),
    ("disk.stream", "altered_desc"),
    ("fast_brief.b64x4", "exchange"),
    ("fast_brief.b64x4", "half_batch"),
    ("fast_brief.b64x4", "altered_match"),
])
def test_a_broken_timed_path_is_not_correct(tmp_path, workload, fault):
    env = dict(os.environ, BENCH_CUDA_FAULT=fault)
    rc, out, err = run_cell(tiny_root(tmp_path), workload, env=env, module="bench_cuda.tests.faults")
    assert rc == 0, err[-3000:]
    line = last_json(out)
    assert line["correct"] is False and line["failed"] >= 1


@pytest.mark.parametrize("seed", [3000000031, 13])
def test_a_heatmap_fault_in_one_region_is_caught_by_the_tiles(tmp_path, seed):
    # 128x160 frames: the 16x16 patch is 1.25% of a frame, so the mean over whole frames stays in its limit
    root = tiny_root(tmp_path)
    cfg = json.loads((root / "bench_cuda/configs/tiny_disk.json").read_text())
    (root / "bench_cuda/configs/tiny_disk.json").write_text(json.dumps(dict(cfg, rows=128, cols=160)))
    env = dict(os.environ, BENCH_CUDA_FAULT="heat_patch")
    rc, out, err = run_cell(root, "disk.stream", env=env, module="bench_cuda.tests.faults", seed=seed)
    assert rc == 0, err[-3000:]
    line = last_json(out)
    assert line["correct"] is False
    checks = {k: (c["value"], c["limit"]) for k, c in line["checks"].items()}
    assert failing(checks) == ["heat_tile_err"]


@pytest.mark.parametrize("workload", ["fast_brief.b64", "fast_brief.b64x4"])
def test_a_module_of_jax_loaded_by_the_check_leaves_no_result(tmp_path, workload):
    env = dict(os.environ, BENCH_CUDA_FAULT="lazy_jax")
    rc, out, err = run_cell(tiny_root(tmp_path), workload, env=env, module="bench_cuda.tests.faults")
    assert rc != 0
    assert '"correct"' not in out
    assert "jax" in err
