"""SuperPoint and SuperGlue, by the mix's ``kind``.

- ``stream``: one camera's stream as ``pipelines/nn_stream.py`` runs it
  (each frame one ``NNFeaturePointDetector.detect`` with SuperPoint's NMS
  head, then ``match_float`` against the previous frame), checked against
  ``reference/superpoint.py``.
- ``query``: relocalisation against a map.  At set-up ``scenes`` scenes are
  each seen in ``views`` views (scene i rolled ``shift * t`` pixels down
  and right, t = 0 ... views - 1), detected once; their features and
  descriptors stay on the card.  The queries are each scene's views at
  ``query_views`` rolled ``query_shift`` pixels more, with sensor noise
  uniform in [-noise, noise] grey levels drawn on the device from the seed;
  position p is scene ``p % scenes`` at view ``query_views[p // scenes]``.
  A step takes the next query, closed loop: ``detect``, then one
  ``SuperGlueMatcher.match_batch`` against its scene's views, one masked
  pair a view, ended by ``torch.cuda.synchronize()``; ``frames_per_s``
  counts query frames.

Weights: SuperPoint's from the configuration's archive, SuperGlue's seeded
from ``--seed`` by the program's own generator
(``models/weights.py:init_superglue_state``), each handed to the program and
to the reference alike.  The program's SuperGlue module is imported first in
a query set-up, so a checkout without it fails at once.

The query check (``check_queries`` positions drawn from the seed, each the
latest step at its position): the query's detection as the stream's
(heatmap, descriptors, selection); ``assign_err`` the mean gap between the
program's log-assignment and the float32 reference's on the program's own
keypoints and descriptors, over every valid row and column with the
dustbins of every checked pair, and ``assign_pair_err`` the largest such
mean over one pair, which a fault confined to the pair with the fewest
keypoints moves where the pooled mean dilutes it (both read the passes
that ran, whatever the counter says: 20 passes leave the assignment far
from the 100-pass reference's); ``match_diff`` matches
unlike the reference's mutual argmax and threshold on the program's own
assignment, near ties excused (their count printed), and any match of a
padded slot; ``iters_diff`` the gap between the program's
``superglue.sinkhorn_iterations`` counter and ``sinkhorn_iterations`` times
the ``match_batch`` calls of the run.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import frames
from ..reference import disk as ref_disk
from ..reference import sp_sg_control as control_ref
from ..reference import superglue as ref_sg
from ..reference import superpoint as ref_sp
from ..rooflines import superglue as work
from . import nn_stream

WARMUP_S = 1.0  # host seconds of steps before the window, at least one pass over every frame or query
TRACE_LAUNCHES = {"tile_keys_kernel": 1, "pick_kernel": 1}  # K2's launches a step: one selection
# Limits of the float numbers (PERF.md section 2), each about the geometric mean of the program's
# largest reading over 13 seeds of each cell on the card and the float8 control's least over 4: the
# program's bfloat16 SuperPoint and GNN against the float32 references.
HEAT_ERR_LIMIT = 6e-4  # mean |heatmap gap| (a softmax over 65 cells, most pixels near 0): program <= 1.9e-4, control >= 1.76e-3
HEAT_TILE_LIMIT = 2e-3  # the largest 32x32 tile mean of that gap: program <= 7.6e-4, control >= 4.68e-3
DESC_ERR_LIMIT = 0.065  # RMS distance of unit descriptors: program <= 0.034, control >= 0.123
ASSIGN_ERR_LIMIT = 0.022  # mean |log-assignment gap| over the checked pairs' valid entries and dustbins: <= 0.0085, >= 0.0586
ASSIGN_PAIR_LIMIT = 0.036  # the largest such mean over one pair: program <= 0.0161, control >= 0.0796


def setup(run) -> dict:
    return _setup_query(run) if run.mix["kind"] == "query" else _setup_stream(run)


def step(run, state) -> int:
    return state["step"](run, state)


def end_to_end(run, state) -> dict:
    if run.mix["kind"] == "query":
        return {"frames_per_s": run.window["frames"] / run.window["seconds"]}
    return nn_stream.end_to_end(run, state)


def outputs(run, state) -> list:
    return _outputs_query(run, state) if run.mix["kind"] == "query" else nn_stream.outputs(run, state)


def check(run, outs: list) -> dict:
    return _check_query(run, outs) if run.mix["kind"] == "query" else _check_detection(run, outs, True)


def control(run, outs: list) -> list:
    """The controls of ``reference/sp_sg_control.py`` in the program's
    place: SuperPoint with float8 convolutions, whose selection and
    descriptors follow from its own maps, and in a query cell SuperGlue
    with a float8 GNN on those keypoints."""
    import torch

    m = run.config["matcher"]
    w = ref_sp.Weights(ref_disk.load_npz(str(run.root / run.config["weights"])), run.device)
    ctrl = []
    for o in outs:
        heat, desc_map = control_ref.superpoint(w, torch.from_numpy(o["image"]).to(run.device))
        heat = heat.cpu().numpy()
        uv, valid, scores = _select(run, heat)
        desc = ref_disk.sample(desc_map.cpu().numpy(), uv, valid)
        c = dict(o, heat=heat, uv=uv, valid=valid, desc=desc, response=scores)
        if run.mix["kind"] == "query":
            c["assign"] = [control_ref.superglue(_sg_state(run), run.config["superglue"], *_frame_size(run),
                                                 *_pair_tensors(run, c, db)).cpu().numpy() for db in o["db"]]
            c["match_index"] = [ref_sg.select(z, run.config["superglue"]["match_threshold"])[0] for z in c["assign"]]
            c["padded_matches"] = 0
        else:
            c["match_index"], _ = ref_disk.match(o["prev_desc"], o["prev_valid"], desc, valid, m["min_similarity"])
        ctrl.append(c)
    return ctrl


# The program's detector, shared by both kinds.

def _detector(run):
    import torch

    from feature_detector_tpu_torch.core.config import NNDetectorOptions, NNModelType
    from feature_detector_tpu_torch.frontend.nn_detector import NNFeaturePointDetector

    cfg, d = run.config, run.config["detector"]
    opts = NNDetectorOptions(invalid_boundary=d["invalid_boundary"], min_feature_distance=d["min_feature_distance"],
                             max_image_rows=cfg["rows"], max_image_cols=cfg["cols"],
                             max_number_of_detected_features=d["max_number_of_detected_features"],
                             min_response=d["min_response"], model_type=NNModelType[d["model_type"]],
                             compute_descriptors=d["compute_descriptors"])
    det = NNFeaturePointDetector(opts, device=run.device, dtype=getattr(torch, cfg["dtype"]))
    det.initialize(ref_disk.load_npz(str(run.root / cfg["weights"])))
    return det


def _setup_stream(run) -> dict:
    state = nn_stream.setup(run)
    state["step"] = nn_stream.step
    return state


def _frame_size(run) -> tuple:
    return run.config["rows"], run.config["cols"]


def _sg_options(run):
    from feature_detector_tpu_torch.core.config import SuperGlueOptions

    cfg, sg_cfg = run.config, run.config["superglue"]
    return SuperGlueOptions(descriptor_dim=sg_cfg["descriptor_dim"], keypoint_encoder=tuple(sg_cfg["keypoint_encoder"]),
                            gnn_layers=tuple(sg_cfg["gnn_layers"]), num_heads=sg_cfg["num_heads"],
                            sinkhorn_iterations=sg_cfg["sinkhorn_iterations"],
                            match_threshold=sg_cfg["match_threshold"], image_rows=cfg["rows"], image_cols=cfg["cols"])


def _seeded_weights(run) -> dict:
    """SuperGlue's weights drawn from ``--seed`` by the program's generator
    (CPU tensors under the public names), for the program and the reference."""
    if "sg_weights" not in run.extra:
        import torch

        from feature_detector_tpu_torch.models.superglue import SuperGlue
        from feature_detector_tpu_torch.models.weights import init_superglue_state

        gen = torch.Generator().manual_seed(run.seed)
        run.extra["sg_weights"] = init_superglue_state(SuperGlue(_sg_options(run)), gen)
    return run.extra["sg_weights"]


def _sg_state(run) -> dict:
    """The seeded weights on the run's device, as the reference takes them."""
    if "sg_state" not in run.extra:
        run.extra["sg_state"] = ref_sg.to_device(_seeded_weights(run), run.device)
    return run.extra["sg_state"]


def query_layout(mix: dict, seed: int, rows: int, cols: int, device):
    """(database frames ``[scenes, views, rows, cols]``, queries
    ``[positions, rows, cols]``), uint8 on ``device`` (module docstring)."""
    import torch

    s = torch.from_numpy(frames.scenes(seed, mix["scenes"], rows, cols)).to(device)
    shift = mix["shift"]
    db = torch.stack([torch.stack([torch.roll(s[i], (shift * t, shift * t), (0, 1)) for t in range(mix["views"])])
                      for i in range(mix["scenes"])])
    q = torch.stack([torch.roll(s[i], (shift * t + mix["query_shift"],) * 2, (0, 1))
                     for t in mix["query_views"] for i in range(mix["scenes"])])
    if mix["noise"]:
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        noise = torch.randint(-mix["noise"], mix["noise"] + 1, q.shape, generator=g, device=device, dtype=torch.int16)
        q = (q.to(torch.int16) + noise).clamp_(0, 255).to(torch.uint8)
    return db, q


def _setup_query(run) -> dict:
    import torch

    from feature_detector_tpu_torch.match.superglue import SuperGlueMatcher  # first: a checkout without it stops here
    from feature_detector_tpu_torch.core.types import Features
    from feature_detector_tpu_torch.utils import trace

    cfg, mix = run.config, run.mix
    sg_cfg = cfg["superglue"]
    det = _detector(run)
    sg = SuperGlueMatcher(_sg_options(run), device=run.device, dtype=getattr(torch, cfg["dtype"]))
    sg.initialize(_seeded_weights(run))
    db_frames, queries = query_layout(mix, run.seed, cfg["rows"], cfg["cols"], run.device)
    with torch.no_grad():
        found = [[det.detect(f) for f in views] for views in db_frames]
        db_feats = Features(*(torch.stack([torch.stack([getattr(f, k) for f, _ in views]) for views in found])
                              for k in ("uv", "response", "valid")))
        db_desc = torch.stack([torch.stack([d for _, d in views]) for views in found])
        q_counts = [int(det.detect(q)[0].valid.sum()) for q in queries]
    del found, db_frames
    db_counts = db_feats.valid.sum(-1).cpu().numpy()
    n_scenes = mix["scenes"]
    # The work of the mean query (rooflines/superglue.py), at the valid counts.
    gnn = [sum(work.gnn_flop(q_counts[p], int(n), sg_cfg) for n in db_counts[p % n_scenes]) for p in range(len(queries))]
    cells = [sum((q_counts[p] + 1) * (int(n) + 1) for n in db_counts[p % n_scenes]) for p in range(len(queries))]
    run.extra.update(sg_gnn_flop=float(np.mean(gnn)), sg_cells=float(np.mean(cells)),
                     sp_flop=work.superpoint_forward_flop(cfg["rows"], cfg["cols"]),
                     sg_keypoints=(q_counts, db_counts.tolist()))
    state = {"i": 0, "det": det, "sg": sg, "queries": queries, "db_feats": db_feats, "db_desc": db_desc,
             "kept": {}, "heat": None, "z": None, "calls": 0, "step": _step_query}
    rng = np.random.default_rng([run.seed, 2])
    state["checked"] = set(rng.choice(len(queries), min(mix["check_queries"], len(queries)), replace=False).tolist())

    def keep_heat(module, args, out):
        state["heat"] = out[0][0]

    def keep_assign(module, args, out):
        state["z"] = out

    det.model.register_forward_hook(keep_heat)
    sg.model.register_forward_hook(keep_assign)
    state["iters_start"] = trace.counters().get("superglue.sinkhorn_iterations", 0)
    run.loop(lambda: step(run, state), WARMUP_S, min_calls=len(queries))
    return state


def _step_query(run, state) -> int:
    """One query: detect, match against its scene's views, synchronise."""
    import torch

    pos = state["i"] % len(state["queries"])
    state["i"] += 1
    scene = pos % run.mix["scenes"]
    with torch.no_grad():
        feats, desc = state["det"].detect(state["queries"][pos])
        db = state["db_feats"]
        matches = state["sg"].match_batch(feats, desc, type(db)(db.uv[scene], db.response[scene], db.valid[scene]),
                                          state["db_desc"][scene])
    state["calls"] += 1
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    if pos in state["checked"]:
        state["kept"][pos] = (state["heat"], feats, desc, matches, state["z"])
    return 1


def _outputs_query(run, state) -> list:
    """The checked queries' frames and the program's outputs, on the host:
    per pair the valid block (rows and columns of valid slots, then the
    dustbin) of its log-assignment."""
    from feature_detector_tpu_torch.utils import trace

    iterations = run.config["superglue"]["sinkhorn_iterations"]
    counted = trace.counters().get("superglue.sinkhorn_iterations", 0) - state["iters_start"]
    db = state["db_feats"]
    out = []
    for pos in sorted(state["kept"]):
        heat, feats, desc, matches, z = state["kept"][pos]
        scene = pos % run.mix["scenes"]
        valid = feats.valid.cpu().numpy()
        rows = np.append(np.flatnonzero(valid), z.shape[1] - 1)
        pairs, assign = [], []
        for j in range(db.valid.shape[1]):
            dv = db.valid[scene, j].cpu().numpy()
            cols = np.append(np.flatnonzero(dv), z.shape[2] - 1)
            assign.append(z[j].cpu().numpy()[np.ix_(rows, cols)])
            pairs.append({"uv": db.uv[scene, j].cpu().numpy()[dv], "response": db.response[scene, j].cpu().numpy()[dv],
                          "desc": state["db_desc"][scene, j].float().cpu().numpy()[dv]})
        index = matches.index.cpu().numpy()
        out.append({"image": state["queries"][pos].cpu().numpy(), "heat": heat.float().cpu().numpy(),
                    "uv": feats.uv.cpu().numpy(), "valid": valid, "response": feats.response.cpu().numpy(),
                    "desc": desc.float().cpu().numpy(), "db": pairs, "assign": assign,
                    "match_index": [index[j][valid] for j in range(len(pairs))],
                    "padded_matches": int((index[:, ~valid] >= 0).sum()),
                    "iters": (counted, iterations * state["calls"])})
    return out


def _select(run, heat: np.ndarray):
    """The reference's NMS head and selection on ``heat``: (uv, valid, the
    kept candidates' scores in their slots)."""
    d = run.config["detector"]
    uv_c, scores_c = ref_sp.nms_head(heat, d["min_response"])
    uv, valid, picked = ref_sp.select(uv_c, scores_c, *heat.shape, d["max_number_of_detected_features"],
                                      d["min_feature_distance"], d["invalid_boundary"])
    scores = np.zeros(len(uv), np.float32)
    scores[:len(picked)] = scores_c[picked]
    return uv, valid, scores


def _check_detection(run, outs: list, with_matches: bool) -> dict:
    """The detection's numbers, as ``disk.stream``'s check takes them, and
    with ``with_matches`` the stream's ``match_diff`` against float
    matching of the program's descriptors."""
    import torch

    m = run.config["matcher"]
    w = ref_sp.Weights(ref_disk.load_npz(str(run.root / run.config["weights"])), run.device)
    heat_sum = heat_n = heat_tile = desc_sq = desc_n = 0.0
    select = matches = 0
    for o in outs:
        heat, desc_map = ref_sp.forward(w, torch.from_numpy(o["image"]).to(run.device))
        heat, desc_map = heat.cpu().numpy(), desc_map.cpu().numpy()
        gap = np.abs(o["heat"].astype(np.float64) - heat)
        heat_sum, heat_n = heat_sum + gap.sum(), heat_n + gap.size
        heat_tile = max(heat_tile, float(nn_stream.tile_means(gap).max()))
        dist = np.linalg.norm(o["desc"].astype(np.float64) - ref_disk.sample(desc_map, o["uv"], o["valid"]), axis=1)
        desc_sq, desc_n = desc_sq + (dist[o["valid"]] ** 2).sum(), desc_n + o["valid"].sum()
        uv, valid, _ = _select(run, o["heat"])
        select += int(((o["uv"] != uv).any(1) | (o["valid"] != valid)).sum())
        if with_matches:
            index, near = ref_disk.match(o["prev_desc"], o["prev_valid"], o["desc"], o["valid"], m["min_similarity"])
            matches += int(((o["match_index"] != index) & ~near).sum())
    out = {"heat_err": (float(heat_sum / max(heat_n, 1)), HEAT_ERR_LIMIT), "heat_tile_err": (heat_tile, HEAT_TILE_LIMIT),
           "desc_err": (float(np.sqrt(desc_sq / max(desc_n, 1))), DESC_ERR_LIMIT), "select_diff": (select, 0)}
    if with_matches:
        out["match_diff"] = (matches, 0)
    return out


def _pair_tensors(run, o: dict, db: dict) -> tuple:
    """One pair's inputs of the reference on the run's device: the query's
    valid keypoints, scores and descriptors, then the database view's."""
    import torch

    v = o["valid"]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(run.device)
    return (t(o["uv"][v]), t(o["response"][v]), t(o["desc"][v]), t(db["uv"]), t(db["response"]), t(db["desc"]))


def _check_query(run, outs: list) -> dict:
    out = _check_detection(run, outs, False)
    sg_cfg = run.config["superglue"]
    gap_sum = gap_n = pair_worst = 0.0
    matches = excused = iters = 0
    for o in outs:
        for db, z, index in zip(o["db"], o["assign"], o["match_index"]):
            want = ref_sg.forward(_sg_state(run), sg_cfg, *_frame_size(run), *_pair_tensors(run, o, db)).cpu().numpy()
            gap = np.abs(z.astype(np.float64) - want)
            gap_sum, gap_n = gap_sum + gap.sum(), gap_n + gap.size
            pair_worst = max(pair_worst, float(gap.mean()))
            ref_index, near = ref_sg.select(z, sg_cfg["match_threshold"])
            matches += int(((index != ref_index) & ~near).sum())
            excused += int(near.sum())
        matches += o["padded_matches"]
        iters += abs(o["iters"][0] - o["iters"][1])
    print(f"check-note match_diff excused {excused} near ties (< 1e-6)", file=sys.stderr, flush=True)
    run.extra["excused"] = excused
    out.update(assign_err=(float(gap_sum / max(gap_n, 1)), ASSIGN_ERR_LIMIT), assign_pair_err=(pair_worst, ASSIGN_PAIR_LIMIT),
               match_diff=(matches, 0), iters_diff=(iters, 0))
    return out
