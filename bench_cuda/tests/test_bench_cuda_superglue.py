"""CPU tests of the SuperPoint and SuperGlue cells (``pipelines/sp_superglue.py``):
the pipeline and its readers at a small size, the references against the
port, the work counts by hand, and the faults that must make ``correct``
false.

    python -m pytest bench_cuda/tests/test_bench_cuda_superglue.py -q

The small configuration keeps SuperPoint and SuperGlue whole (18 layers,
100 Sinkhorn passes: the float8 control's gap grows with depth) and cuts the
frames to 96x128, the capacity to 160 keypoints (more than such a frame
gives, so that every pair pads) and the map to 2 scenes of 3 views.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_cuda import frames, harness
from bench_cuda.pipelines import sp_superglue
from bench_cuda.reference import disk as ref_disk
from bench_cuda.reference import superglue as ref_sg
from bench_cuda.reference import superpoint as ref_sp
from bench_cuda.rooflines import bounds, flops, superglue as work
from bench_cuda.run import parse, run_one
from bench_cuda.tests.test_bench_cuda_harness import BENCH, REPO, last_json, run_cell, tiny_root

CELLS = {"superpoint.stream": ("tiny_sp", "tiny_stream"), "superglue.query16": ("tiny_sp", "tiny_query")}


def sp_root(path: Path) -> Path:
    """The harness tests' small root with the two cells on a small
    SuperPoint and SuperGlue configuration."""
    root = tiny_root(path)
    cfg = json.loads((REPO / "bench_cuda/configs/superpoint_superglue_752x480.json").read_text())
    cfg.update(name="tiny_sp", rows=96, cols=128, weights=str(REPO / cfg["weights"]))
    cfg["detector"] = dict(cfg["detector"], max_number_of_detected_features=160)
    (root / "bench_cuda/configs/tiny_sp.json").write_text(json.dumps(cfg))
    mix = json.loads((REPO / "bench_cuda/traffic/query16.json").read_text())
    mix.update(scenes=2, views=3, query_views=[1], check_queries=2)
    (root / "bench_cuda/traffic/tiny_query.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="tiny_sp", source="test", file="bench_cuda/configs/tiny_sp.json", reduced=[],
                                 why="test"))
    bench["workloads"] += [dict(name=w, config=c, traffic=t, chips=1, why="test") for w, (c, t) in CELLS.items()]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def in_process(root: Path, workload: str, seed: int = 3000000011, seconds: float = 0.3, trace: int = 0) -> dict:
    bench = harness.load_benchmark(root)
    w = harness.find(bench["workloads"], workload, "workload")
    cfg = harness.load_config(bench, w["config"], root)
    mix = frames.load_mix(w["traffic"], root)
    args = parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--device", "cpu",
                  "--root", str(root), "--trace", str(trace)])
    torch.set_num_threads(4)
    return run_one(args, bench, w, cfg, mix, keep=True)


def failing(checks: dict) -> list:
    return [k for k, (v, lim) in checks.items() if v > lim]


# The contract's entries.

def test_the_new_entries_are_found_and_report_what_the_contract_asks():
    cfg = harness.load_config(BENCH, "superpoint_superglue_752x480", REPO)
    assert harness.load_pipeline(cfg["pipeline"]) is sp_superglue and cfg["reduced"] == []
    assert frames.load_mix("query16", REPO)["kind"] == "query"
    want = {"superpoint.stream": {"stream_frame_ms_mean", "stream_frame_ms_p95", "setup_s"},
            "superglue.query16": {"frames_per_s", "setup_s"}}
    layer = {"superpoint.stream": {"sp.detect_mfu", "setup.program_s", "nn.forward_ms", "nn.postprocess_ms",
                                   "nn.k2_roofline", "nn.match_float_ms", "nn.device_idle", "nn.forward_host_ms",
                                   "nn.postprocess_host_ms"},
             "superglue.query16": {"sg.gnn_ms", "sg.sinkhorn_ms", "sg.gnn_mfu", "sg.sinkhorn_roofline", "sg.query_mfu",
                                   "sg.k2_roofline", "setup.program_s"}}
    for cell in CELLS:
        assert {m["name"] for m in harness.cell_metrics(BENCH, cell, False)} == want[cell]
        assert {m["name"] for m in harness.cell_metrics(BENCH, cell, True)} == layer[cell]
        assert harness.find(BENCH["workloads"], cell, "workload")["chips"] == 1


# The work counts, by hand and by hooks.

def test_superpoint_flops_by_hand_and_by_hooks():
    per_pixel = (2 * 9 * (64 + 64 * 64) + 2 * 9 * 2 * 64 * 64 / 4 + 2 * 9 * (64 * 128 + 128 * 128) / 16
                 + 2 * 9 * 2 * 128 * 128 / 64 + (2 * 9 * 128 * 256 * 2 + 2 * 256 * 65 + 2 * 256 * 256) / 64)
    assert per_pixel == 169_608
    assert work.superpoint_forward_flop(480, 752) == 169_608 * 480 * 752  # 61.2 GFLOP
    from feature_detector_tpu_torch.models.superpoint import SuperPoint

    counted = flops.conv_forward_flop(SuperPoint(dtype=torch.float32).eval(), torch.zeros(1, 1, 32, 48))
    assert counted == work.superpoint_forward_flop(32, 48)


def test_gnn_and_sinkhorn_work_by_hand():
    cfg = harness.load_config(BENCH, "superpoint_superglue_752x480", REPO)["superglue"]
    # At 1,024 keypoints a side: 18 layers of two sides of 20 n d^2 + 4 n m d, about 87 GFLOP a pair.
    side = 20 * 1024 * 256 ** 2 + 4 * 1024 * 1024 * 256
    assert work.gnn_flop(1024, 1024, cfg) == 18 * 2 * side == pytest.approx(86.97e9, rel=1e-3)
    # Unequal counts: self layers attend within a side, cross layers across.
    assert work.gnn_layer_flop(3, 5, 8, "self") == 20 * 8 * 8 * 8 + 4 * 8 * (9 + 25)
    assert work.gnn_layer_flop(3, 5, 8, "cross") == 20 * 8 * 8 * 8 + 8 * 8 * 15
    # Sinkhorn over 16 pairs of 1,025 x 1,025: 3 operations a coupling each half-pass bind it, 0.15 ms.
    cells = 16 * 1025 * 1025
    assert work.sinkhorn_bound_ms(cells, 100) == pytest.approx(3 * 2 * 100 * cells / 67e12 * 1e3)
    assert work.sinkhorn_bound_ms(cells, 100) == pytest.approx(0.1505, rel=1e-3)
    assert work.sinkhorn_bound_ms(cells, 1) == pytest.approx(2 * 4 * cells / 3.35e12 * 1e3)


# The references against the port.

def test_superpoint_reference_equals_the_port_in_float32():
    from feature_detector_tpu_torch.core.config import NNDetectorOptions, NNModelType
    from feature_detector_tpu_torch.core.convert import superpoint_state_from_flax
    from feature_detector_tpu_torch.core.types import Features
    from feature_detector_tpu_torch.frontend.nn_detector import postprocess
    from feature_detector_tpu_torch.models.superpoint import SuperPoint

    tree = ref_disk.load_npz(str(REPO / "feature_detector_tpu/models/weights/superpoint_synth.npz"))
    model = SuperPoint(dtype=torch.float32)
    model.load_state_dict(superpoint_state_from_flax(tree))
    img = frames.scenes(5, 1, 96, 128)[0]
    with torch.no_grad():
        heat, desc = model(torch.from_numpy(img).float().div(255)[None, None])
    rheat, rdesc = ref_sp.forward(ref_sp.Weights(tree, "cpu"), torch.from_numpy(img))
    assert torch.allclose(heat[0], rheat, atol=1e-6) and torch.allclose(desc[0], rdesc, atol=1e-5)
    opts = NNDetectorOptions(max_image_rows=96, max_image_cols=128, max_number_of_detected_features=96,
                             min_feature_distance=4, min_response=0.005, model_type=NNModelType.SUPERPOINT_NMS)
    feats, d = postprocess(heat[0], desc[0], Features.empty(96, device="cpu"), opts)
    uv_c, scores_c = ref_sp.nms_head(heat[0].numpy(), 0.005)
    uv, valid, picked = ref_sp.select(uv_c, scores_c, 96, 128, 96, 4, 3)
    assert valid.sum() > 20 and (feats.uv.numpy() == uv).all() and (feats.valid.numpy() == valid).all()
    assert (feats.response.numpy()[valid] == scores_c[picked]).all()
    assert np.abs(d.numpy() - ref_disk.sample(desc[0].numpy(), uv, valid)).max() < 1e-6


def test_superglue_reference_equals_the_port_and_the_oracle():
    from feature_detector_tpu_torch.core.config import SuperGlueOptions
    from feature_detector_tpu_torch.core.types import Features
    from feature_detector_tpu_torch.match.superglue import SuperGlueMatcher
    from feature_detector_tpu_torch.models.superglue import SuperGlue
    from feature_detector_tpu_torch.models.weights import init_superglue_state
    from feature_detector_tpu_torch.oracle import superglue as oracle

    cfg = dict(harness.load_config(BENCH, "superpoint_superglue_752x480", REPO)["superglue"],
               gnn_layers=["self", "cross"], sinkhorn_iterations=20)
    opts = SuperGlueOptions(gnn_layers=tuple(cfg["gnn_layers"]), sinkhorn_iterations=20, image_rows=96, image_cols=128)
    state = init_superglue_state(SuperGlue(opts), torch.Generator().manual_seed(77))
    rng = np.random.default_rng(1)
    m, n = 12, 17
    uv = rng.uniform(0, [128, 96], (m + n, 2)).astype(np.float32)
    sc = rng.uniform(0, 1, m + n).astype(np.float32)
    de = rng.normal(size=(m + n, 256)).astype(np.float32)
    de /= np.linalg.norm(de, axis=1, keepdims=True)
    de[m:m + 8], uv[m:m + 8] = de[:8], uv[:8] + 1  # shared keypoints, so that there are matches
    t = lambda x: torch.from_numpy(x)
    pair = (t(uv[:m]), t(sc[:m]), t(de[:m]), t(uv[m:]), t(sc[m:]), t(de[m:]))
    tensors = ref_sg.to_device(state, "cpu")
    z = ref_sg.forward(tensors, cfg, 96, 128, *pair)
    oz, omatch = oracle.superglue(tensors, *pair, 96, 128, tuple(cfg["gnn_layers"]), 4, 20, 0.2)
    assert torch.equal(z, oz)
    index, near = ref_sg.select(z.numpy(), 0.2)
    assert (index == omatch.numpy()).all() and (index >= 0).sum() >= 4
    sg = SuperGlueMatcher(opts, device="cpu", dtype=torch.float32)
    sg.initialize(state)
    zs = []
    sg.model.register_forward_hook(lambda mod, args, out: zs.append(out))
    ones = lambda k: torch.ones(k, dtype=torch.bool)
    out = sg.match_batch(Features(pair[0], pair[1], ones(m)), pair[2], Features(pair[3][None], pair[4][None], ones(n)[None]),
                         pair[5][None])
    assert (zs[0][0] - z).abs().max() <= 1e-5 * z.abs().max()
    assert (out.index[0].numpy() == index).all()


# The pipeline and its readers.

@pytest.mark.parametrize("workload", list(CELLS))
def test_each_cell_runs_and_prints_the_contract_line(tmp_path, workload):
    root = sp_root(tmp_path)
    rc, out, err = run_cell(root, workload)
    assert rc == 0, err[-3000:]
    line = last_json(out)
    assert line["correct"] is True and line["attempted"] > 0, line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in harness.cell_metrics(BENCH, workload, False)}
    checks = set(line["checks"])
    if workload == "superglue.query16":
        assert checks == {"heat_err", "heat_tile_err", "desc_err", "select_diff", "assign_err", "assign_pair_err",
                          "match_diff", "iters_diff"}
        assert "check-note match_diff excused" in err
    else:
        assert checks == {"heat_err", "heat_tile_err", "desc_err", "select_diff", "match_diff"}


def test_the_query_run_counts_and_the_readers_read(tmp_path):
    from feature_detector_tpu_torch.match.superglue import SuperGlueMatcher  # noqa: F401 (the counters' module)

    root = sp_root(tmp_path)
    rec = in_process(root, "superglue.query16")
    run, outs = rec["run"], rec["outputs"]
    assert rec["checks"]["iters_diff"] == (0, 0) and len(outs) == 2
    for o in outs:
        counted, expected = o["iters"]
        assert counted == expected > 0 and expected % 100 == 0
        assert len(o["assign"]) == 3 and all(z.shape == (o["valid"].sum() + 1, len(db["uv"]) + 1)
                                            for z, db in zip(o["assign"], o["db"]))
    # The readers find nothing to read on the CPU (no profiled segment), and say so with None.
    for name in ("sg.gnn_ms", "sg.sinkhorn_ms", "sg.gnn_mfu", "sg.sinkhorn_roofline", "sg.query_mfu", "sg.k2_roofline",
                 "sp.detect_mfu"):
        assert harness.load_metric(name).read(run) is None
    # With a profiled segment and spans to read, they read the work the set-up counted.
    q_counts, db_counts = run.extra["sg_keypoints"]
    cfg = run.config["superglue"]
    gnn = np.mean([sum(work.gnn_flop(q_counts[p], n, cfg) for n in db_counts[p % 2]) for p in range(len(q_counts))])
    assert run.extra["sg_gnn_flop"] == pytest.approx(gnn) and gnn > 0
    run.trace.update(window_s=2.0, frames=10)
    want = 100 * (run.extra["sp_flop"] + gnn) * 10 / 2.0 / 989e12
    assert harness.load_metric("sg.query_mfu").read(run) == pytest.approx(want)
    # K2 of the query's selection: one call (two launches) a step, at the configuration's capacity.
    run.trace.update(complete=True, kernels={"pick_kernel<true>": (0.5, 10), "tile_keys_kernel": (0.1, 10)})
    want = 100 * bounds.greedy_bound_ms(1, 96, 128, 160) * 10 / 0.6
    assert harness.load_metric("sg.k2_roofline").read(run) == pytest.approx(want) and want < 100


# The faults that the comparison must catch.

def _no_key_mask(monkeypatch):
    from feature_detector_tpu_torch.models import superglue as model

    real = model.SuperGlue.gnn_forward
    monkeypatch.setattr(model.SuperGlue, "gnn_forward", lambda self, x, key_ok: real(self, x, torch.ones_like(key_ok)))


def _sinkhorn_20(monkeypatch):
    from feature_detector_tpu_torch.models import superglue as model

    real = model.log_optimal_transport
    monkeypatch.setattr(model, "log_optimal_transport", lambda *a: real(*a[:-1], 20))


def _sinkhorn_20_counted_100(monkeypatch):
    """20 passes run while the counter reads the 100 asked for: only the
    assignment, against the reference's 100 passes, can show it."""
    from feature_detector_tpu_torch.models import superglue as model
    from feature_detector_tpu_torch.utils import trace

    real = model.log_optimal_transport

    def short(*a):
        z = real(*a[:-1], 20)
        trace.count("superglue.sinkhorn_iterations", a[-1] - 20)
        return z

    monkeypatch.setattr(model, "log_optimal_transport", short)


def _altered_match(monkeypatch):
    from feature_detector_tpu_torch.core.types import Matches
    from feature_detector_tpu_torch.match import superglue as matcher

    real = matcher.SuperGlueMatcher.match_batch

    def altered(self, *args):
        m = real(self, *args)
        index = m.index.clone()
        index[:, 0] = (index[:, 0] + 1) % index.shape[-1]
        return Matches(index=index, distance=m.distance, valid=m.valid)

    monkeypatch.setattr(matcher.SuperGlueMatcher, "match_batch", altered)


def _heat_patch(monkeypatch):
    from feature_detector_tpu_torch.models import superpoint

    real = superpoint.SuperPoint.forward

    def patched(self, x, return_logits=False):
        heat, desc = real(self, x, return_logits)
        heat = heat.clone()
        heat[:, 40:56, 40:56] = 1.0 - heat[:, 40:56, 40:56]
        return heat, desc

    monkeypatch.setattr(superpoint.SuperPoint, "forward", patched)


@pytest.mark.parametrize("fault,caught", [(_no_key_mask, {"assign_err", "assign_pair_err"}),
                                          (_sinkhorn_20, {"iters_diff", "assign_err", "assign_pair_err"}),
                                          (_sinkhorn_20_counted_100, {"assign_err", "assign_pair_err"}),
                                          (_altered_match, {"match_diff"}),
                                          (_heat_patch, {"heat_tile_err"})],
                         ids=["key_mask_dropped", "sinkhorn_20_passes", "sinkhorn_20_passes_counted_100",
                              "altered_match", "heat_patch"])
def test_each_fault_makes_correct_false(tmp_path, monkeypatch, fault, caught):
    root = sp_root(tmp_path)
    fault(monkeypatch)
    rec = in_process(root, "superglue.query16")
    assert caught <= set(failing(rec["checks"])), rec["checks"]


def test_the_program_passes_and_the_control_fails(tmp_path):
    root = sp_root(tmp_path)
    rec = in_process(root, "superglue.query16")
    pipe = sp_superglue
    assert failing(rec["checks"]) == []
    ctrl = pipe.check(rec["run"], pipe.control(rec["run"], rec["outputs"]))
    assert {"heat_err", "assign_err"} <= set(failing(ctrl)), ctrl
