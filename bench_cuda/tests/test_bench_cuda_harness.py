"""CPU tests of the benchmark harness: discovery by name, the contract's
names and units, the result line, the roofline and FLOP arithmetic, the
references against the port at a small size, the check for modules of the
JAX package, and a cell added by files and entries alone.

    python -m pytest bench_cuda/tests -q

The runs here use ``--device cpu`` (the harness then skips its look for a
card) on small configurations written into a temporary checkout root.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_cuda import frames, harness
from bench_cuda.reference import disk as ref_disk
from bench_cuda.reference import fast_brief as ref_fb
from bench_cuda.rooflines import bounds, flops

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY_CELLS = {"fast_brief.b64": ("tiny_fast", "tiny_pairs", 1), "disk.stream": ("tiny_disk", "tiny_stream", 1),
              "fast_brief.b64x4": ("tiny_fast", "tiny_pairs4", 4)}


def tiny_root(path: Path, copy_package: bool = False) -> Path:
    """A checkout root holding BENCHMARK.json with the benchmark's cells on
    small configurations (96x128 pairs, a 64x96 stream) and their data
    files; with ``copy_package`` the package too."""
    cfg_dir, mix_dir = path / "bench_cuda" / "configs", path / "bench_cuda" / "traffic"
    if copy_package:
        shutil.copytree(REPO / "bench_cuda", path / "bench_cuda", ignore=shutil.ignore_patterns("__pycache__"))
    cfg_dir.mkdir(parents=True, exist_ok=True)
    mix_dir.mkdir(parents=True, exist_ok=True)
    fast = json.loads((REPO / "bench_cuda/configs/fast_brief_752x480.json").read_text())
    fast.update(name="tiny_fast", rows=96, cols=128)
    disk = json.loads((REPO / "bench_cuda/configs/disk_752x480.json").read_text())
    disk.update(name="tiny_disk", rows=64, cols=96, weights=str(REPO / disk["weights"]))
    (cfg_dir / "tiny_fast.json").write_text(json.dumps(fast))
    (cfg_dir / "tiny_disk.json").write_text(json.dumps(disk))
    pairs = dict(kind="pairs", pairs=8, ranks=1, scenes=2, pool=2, col_shift=3, noise=3, check_pairs=8)
    (mix_dir / "tiny_pairs.json").write_text(json.dumps(pairs))
    (mix_dir / "tiny_pairs4.json").write_text(json.dumps(dict(pairs, ranks=4)))
    (mix_dir / "tiny_stream.json").write_text(json.dumps(dict(kind="stream", scenes=2, frames_per_scene=3, shift=2,
                                                              check_frames=4)))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"] = [dict(name=n, source="test", file=f"bench_cuda/configs/{n}.json", reduced=[], why="test")
                        for n in ("tiny_fast", "tiny_disk")]
    bench["workloads"] = [dict(name=w, config=c, traffic=t, chips=k, why="test") for w, (c, t, k) in TINY_CELLS.items()]
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path


def run_cell(root: Path, workload: str, *extra, cwd: Path = REPO, env=None, module="bench_cuda.run", seed=3000000007):
    """(exit code, stdout, stderr) of one CPU run of ``workload`` under ``root``."""
    cmd = [sys.executable, "-m", module, "--workload", workload, "--seed", str(seed), "--seconds", "0.5",
           "--device", "cpu", "--root", str(root), *extra]
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="1")
    p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=600, env=env)
    return p.returncode, p.stdout, p.stderr


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


# Discovery and the contract's form.

def test_every_entry_is_found_by_name():
    for cfg in BENCH["configs"]:
        c = harness.load_config(BENCH, cfg["name"], REPO)
        assert c["name"] == cfg["name"]
        pipe = harness.load_pipeline(c["pipeline"])
        for fn in ("setup", "step", "end_to_end", "outputs", "check", "control"):
            assert callable(getattr(pipe, fn))
    for w in BENCH["workloads"]:
        assert frames.load_mix(w["traffic"], REPO)["kind"] in ("pairs", "stream")
    for m in BENCH["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)


def test_names_units_and_keys_follow_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("bench_cuda/") and (REPO / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for text in [e[k] for key in ("configs", "workloads") for e in BENCH[key] for k in ("why", "source") if k in e] \
            + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        reported = {m["name"] for m in harness.cell_metrics(BENCH, w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        per_layer = harness.cell_metrics(BENCH, w["name"], True)
        assert per_layer and all(m["moves"] in reported and m["moves"] in e2e for m in per_layer)
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert [w["name"] for w in four] == ["fast_brief.b64x4"]
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


# Arithmetic of the yardstick, against hand counts.

def test_greedy_bytes_and_bounds_by_hand():
    # K1: 64 float32 maps of 752x480, 64 budgets, 64 x 200 slots of 16 bytes.
    assert bounds.greedy_bytes(64, 480, 752, 200) == 64 * 480 * 752 * 4 + 64 * 4 + 64 * 200 * 16 == 92_610_816
    assert bounds.greedy_bound_ms(64, 480, 752, 200) == pytest.approx(92_610_816 / 3.35e12 * 1e3)
    # K2: one map of 752x480 and 240 slots.
    assert bounds.greedy_bytes(1, 480, 752, 240) == 480 * 752 * 4 + 4 + 240 * 16 == 1_447_684
    assert bounds.greedy_bound_ms(1, 480, 752, 240) == pytest.approx(1_447_684 / 3.35e12 * 1e3)


def test_flood_and_fixed_bounds_by_hand():
    # K3 on 752x480: 37 bytes a pixel against 20 operations a valid pixel, neighbour and sweep.
    ms, by = bounds.flood_bound(480 * 752, 100_000, 256)
    assert by == "operations" and ms == pytest.approx(256 * 100_000 * 8 * 20 / 67e12 * 1e3)
    ms, by = bounds.flood_bound(480 * 752, 10, 1)
    assert by == "bytes" and ms == pytest.approx(37 * 480 * 752 / 3.35e12 * 1e3)
    # K4 on [34, 72, 1536] @ [34, 1536, 72]: both operands and the product in float32 bind it (PERF.md: 0.009190 ms).
    ms, by = bounds.fixed_bound(4 * (2 * 34 * 72 * 1536 + 34 * 72 * 72), 2 * 34 * 72 * 72 * 1536)
    assert by == "bytes" and ms == pytest.approx(0.009190, rel=1e-3)


def test_disk_flops_by_hand_and_by_hooks():
    cfg = harness.load_config(BENCH, "disk_752x480", REPO)
    per_pixel = (2 * 25 * (3 * 16 + 16 * 32 / 4 + 32 * 64 / 16 + 64 * 64 / 64 + 64 * 64 / 256
                           + 128 * 64 / 64 + 128 * 64 / 16 + 96 * 64 / 4 + 80 * 129))
    assert per_pixel == 644_000
    assert flops.disk_forward_flop(cfg) == 644_000 * 480 * 752
    from feature_detector_tpu_torch.models.disk import Disk

    small = dict(cfg, rows=32, cols=48)
    counted = flops.conv_forward_flop(Disk(dtype=torch.float32).eval(), torch.zeros(1, 3, 32, 48))
    assert counted == flops.disk_forward_flop(small)


# The references against the port on the CPU.

def test_fast_brief_reference_equals_the_port():
    from feature_detector_tpu_torch.frontend.descriptor import compute_descriptors
    from feature_detector_tpu_torch.frontend.detector import detect_good_features_batch
    from feature_detector_tpu_torch.match.hamming import match_hamming
    from bench_cuda.pipelines.fast_brief import _options

    cfg = harness.load_config(BENCH, "fast_brief_752x480", REPO)
    opts, sub, bopts, mopts = _options(cfg)
    imgs = frames.scenes(11, 2, 120, 160)
    pair = np.stack([imgs[0], np.roll(imgs[0], 3, 1)])
    f = detect_good_features_batch(torch.from_numpy(pair), "fast", 200, opts, sub, device="cpu")
    d = compute_descriptors(torch.from_numpy(pair), f, bopts, device="cpu")
    m = match_hamming(d.words[:1], d.valid[:1], d.words[1:], d.valid[1:], mopts)
    res = [ref_fb.frame(im, cfg["detector"], cfg["brief"]) for im in pair]
    for i, (uv, r, v, w, dv, near) in enumerate(res):
        assert (f.uv[i].numpy() == uv).all() and (f.response[i].numpy() == r).all() and (f.valid[i].numpy() == v).all()
        assert ((d.words[i].numpy().view(np.uint32) != w).any(1) & ~near).sum() == 0
        assert (d.valid[i].numpy() == dv).all()
    idx, dist, ok = ref_fb.match(res[0][3], res[0][4], res[1][3], res[1][4])
    assert ok.sum() >= 3
    for got, want in ((m.index, idx), (m.distance, dist), (m.valid, ok)):
        assert (got[0].numpy() == want).all()


def test_disk_reference_equals_the_port_in_float32():
    from feature_detector_tpu_torch.frontend.nn_detector import postprocess
    from feature_detector_tpu_torch.core.config import NNDetectorOptions, NNModelType
    from feature_detector_tpu_torch.core.types import Features
    from feature_detector_tpu_torch.models.disk import Disk
    from feature_detector_tpu_torch.core.convert import disk_state_from_flax

    tree = ref_disk.load_npz(str(REPO / "feature_detector_tpu/models/weights/disk_synth.npz"))
    model = Disk(dtype=torch.float32)
    model.load_state_dict(disk_state_from_flax(tree))
    img = frames.scenes(5, 1, 64, 96)[0]
    x = torch.from_numpy(img).float().div(255)[None, None].expand(1, 3, 64, 96)
    with torch.no_grad():
        heat, desc = model(x)
    rheat, rdesc = ref_disk.forward(ref_disk.Weights(tree, "cpu"), torch.from_numpy(img))
    assert torch.equal(heat[0], rheat) and torch.allclose(desc[0], rdesc, atol=1e-6)
    opts = NNDetectorOptions(max_image_rows=64, max_image_cols=96, model_type=NNModelType.DISK_HEATMAP)
    pooled = torch.nn.functional.avg_pool2d(desc[0].permute(2, 0, 1)[None], 8)[0].permute(1, 2, 0)
    feats, d = postprocess(heat[0], pooled, Features.empty(240, device="cpu"), opts)
    uv, valid = ref_disk.select(heat[0].numpy(), 240, 15, 3, 0.1)
    assert valid.sum() > 3 and (feats.uv.numpy() == uv).all() and (feats.valid.numpy() == valid).all()
    assert np.abs(d.numpy() - ref_disk.sample(pooled.numpy(), uv, valid)).max() == 0


def test_control_precisions_round_as_stated():
    # bfloat16 keeps 8 significant bits, ties to even; float8 e4m3 convolutions move the heatmap.
    assert list(ref_fb._round_bf16(np.float32([1.0, 257.0, 259.0, 1e6]))) == [1.0, 256.0, 260.0, 999424.0]
    tree = ref_disk.load_npz(str(REPO / "feature_detector_tpu/models/weights/disk_synth.npz"))
    w = ref_disk.Weights(tree, "cpu")
    small = torch.from_numpy(frames.scenes(5, 1, 64, 96)[0])
    h32, _ = ref_disk.forward(w, small)
    h8, _ = ref_disk.forward(w, small, "fp8")
    assert (h8 - h32).abs().mean() > 0.005  # the program's bfloat16 reads about 0.001 here


# The result line and the runs.

def test_each_tiny_cell_runs_and_prints_the_contract_line(tmp_path):
    root = tiny_root(tmp_path)
    for workload in TINY_CELLS:
        rc, out, err = run_cell(root, workload)
        assert rc == 0, err[-3000:]
        line = last_json(out)
        assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(line)[-1] == "checks"
        assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
        reported = {m["name"] for m in harness.cell_metrics(BENCH, workload, False)}
        assert set(line["metrics"]) == reported
        assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        assert line["device"]["count"] == TINY_CELLS[workload][2]
        tail = err.strip().splitlines()[-len(line["checks"]):]
        assert all(t.startswith("check ") for t in tail)


def test_no_module_of_jax_is_loaded_and_names_compare_whole(tmp_path):
    port = ["feature_detector_tpu_torch", "feature_detector_tpu_torch.models.disk", "jax_like", "flaxen.x"]
    assert harness.forbidden_modules(port) == []
    assert harness.forbidden_modules(port + ["jax.numpy", "feature_detector_tpu.models", "flax"]) == [
        "feature_detector_tpu", "flax", "jax"]
    code = ("import sys; from bench_cuda import run, harness; "
            f"rc = run.main(['--workload', 'fast_brief.b64', '--seed', '5', '--seconds', '0.3', '--device', 'cpu', "
            f"'--root', {str(tiny_root(tmp_path))!r}]); print(harness.forbidden_modules(), rc)")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.stdout.strip().splitlines()[-1] == "[] 0", p.stderr[-2000:]


def test_only_the_benchmark_files_fail_without_a_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "bench_cuda", tmp_path / "bench_cuda", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for device in ("cpu", "cuda"):
        p = subprocess.run([sys.executable, "-m", "bench_cuda.run", "--workload", "fast_brief.b64", "--seed", "1",
                            "--seconds", "1", "--trace", "0", "--device", device], cwd=tmp_path,
                           capture_output=True, text=True, timeout=300, env=env)
        assert p.returncode != 0
        assert '"correct"' not in p.stdout


def test_a_cell_metric_and_mix_are_added_by_files_and_entries_alone(tmp_path):
    root = tiny_root(tmp_path, copy_package=True)
    pkg = root / "bench_cuda"
    (pkg / "traffic" / "dummy_pairs.json").write_text(json.dumps(
        dict(kind="pairs", pairs=4, ranks=1, scenes=1, pool=3, col_shift=5, noise=0, check_pairs=4)))
    cfg = json.loads((pkg / "configs" / "tiny_fast.json").read_text())
    (pkg / "configs" / "dummy_fast.json").write_text(json.dumps(dict(cfg, name="dummy_fast", rows=80, cols=112)))
    (pkg / "metrics" / "dummy.frames_per_call.py").write_text(
        '"""Frames a call of the window."""\n\n\ndef read(run):\n'
        '    return run.window["frames"] / run.window["calls"]\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="dummy_fast", source="test", file="bench_cuda/configs/dummy_fast.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="dummy.cell", config="dummy_fast", traffic="dummy_pairs", chips=1, why="test"))
    bench["per_layer"].append(dict(name="dummy.frames_per_call", unit="frames", better="higher",
                                   source="program_counter", layer="test", moves="frames_per_s",
                                   workloads=["dummy.cell"]))
    bench["end_to_end"][0]["workloads"].append("dummy.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(REPO)]))
    rc, out, err = run_cell(root, "dummy.cell", cwd=root, env=env)
    assert rc == 0, err[-3000:]
    assert set(last_json(out)["metrics"]) == {"frames_per_s", "setup_s"} and last_json(out)["correct"]
    rc, out, err = run_cell(root, "dummy.cell", "--trace", "1", cwd=root, env=env)
    assert rc == 0, err[-3000:]
    assert last_json(out)["metrics"] == {"dummy.frames_per_call": {"value": 8.0, "unit": "frames"}}


@pytest.mark.gpu
def test_cells_run_on_the_card(tmp_path):
    """On the card: each one-card cell at the small size, then the same
    with ``--trace 1`` (the per-layer readers and the breakdown)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = tiny_root(tmp_path)
    for workload in ("fast_brief.b64", "disk.stream"):
        for trace in ("0", "1"):
            p = subprocess.run([sys.executable, "-m", "bench_cuda.run", "--workload", workload, "--seed", "9",
                                "--seconds", "1", "--trace", trace, "--root", str(root)], cwd=REPO,
                               capture_output=True, text=True, timeout=600)
            assert p.returncode == 0, p.stderr[-3000:]
            line = last_json(p.stdout)
            assert line["correct"] and line["device"]["platform"] == "gpu"
            if trace == "1":
                assert line["device"]["busy_s"] > 0 and "breakdown" in line
