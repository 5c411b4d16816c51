"""A learned detector on one camera's stream: each frame one
``NNFeaturePointDetector.detect`` call, then ``match_float`` against the
previous frame's descriptors, each frame timed on the host around work that
ends in ``torch.cuda.synchronize()``.

The weights come from the configuration's archive, read with numpy and
handed to ``initialize(params)`` and to the reference alike.  Forward hooks
on the detector's model time the forward (``--trace 1``) and keep the
heatmap of each stream position's latest frame.  Once the window has
closed ``check_frames`` of those positions, drawn from the seed, are held
against ``reference/disk.py``: the heatmap against
the float32 forward (TF32 off), the descriptors against the float32 maps'
pooled and sampled at the program's features, the selection against the
reference's selection on the program's own heatmap, and the matches against
the reference's matching of the program's descriptors.
"""

from __future__ import annotations

import time

import numpy as np

from .. import frames
from ..reference import disk as ref

WARMUP_S = 1.0  # host seconds of frames before the window, at least one pass over the pool
TRACE_LAUNCHES = {"tile_keys_kernel": 1, "pick_kernel": 1}  # K2's launches a frame: one selection
# Limits of the three forward numbers, set from the readings in PERF.md (section 2): above the
# largest that a dozen seeds of the program gave, below the least that the float8 control gave.
HEAT_ERR_LIMIT = 0.015
HEAT_TILE_LIMIT = 0.1
DESC_ERR_LIMIT = 0.075
TILE = 32  # side of the square tiles whose mean heatmap gap ``heat_tile_err`` takes the largest of


def setup(run) -> dict:
    import torch

    from feature_detector_tpu_torch.core.config import NNDetectorOptions, NNModelType
    from feature_detector_tpu_torch.frontend.nn_detector import NNFeaturePointDetector
    from feature_detector_tpu_torch.match.float_matcher import FloatMatcherOptions, match_float

    cfg, mix = run.config, run.mix
    d, m = cfg["detector"], cfg["matcher"]
    opts = NNDetectorOptions(invalid_boundary=d["invalid_boundary"], min_feature_distance=d["min_feature_distance"],
                             max_image_rows=cfg["rows"], max_image_cols=cfg["cols"],
                             max_number_of_detected_features=d["max_number_of_detected_features"],
                             min_response=d["min_response"], model_type=NNModelType[d["model_type"]],
                             compute_descriptors=d["compute_descriptors"])
    mopts = FloatMatcherOptions(metric=m["metric"], min_similarity=m["min_similarity"],
                                cross_check=m["cross_check"], ratio=m["ratio"])
    tree = ref.load_npz(str(run.root / cfg["weights"]))
    det = NNFeaturePointDetector(opts, device=run.device, dtype=getattr(torch, cfg["dtype"]))
    det.initialize(tree)
    pool = frames.stream_pool(mix, run.seed, cfg["rows"], cfg["cols"], run.device)
    state = {"i": 0, "pool": pool, "latency": [], "kept": {}, "heat": None}
    spans = run.spans

    def pre(module, args):
        spans.begin("nn.forward")

    def post(module, args, out):
        spans.end("nn.forward")
        state["heat"] = out[0][0]

    det.model.register_forward_pre_hook(pre)
    det.model.register_forward_hook(post)

    def one_frame(image, prev):
        with spans.span("nn.detect"):
            feats, desc = det.detect(image)
        with spans.span("nn.match"):
            matches = match_float(prev[0], prev[1], desc, feats.valid, mopts)
        return feats, desc, matches

    state["run_frame"] = one_frame
    feats, desc = det.detect(pool[-1])
    state["prev"] = (desc, feats.valid)
    run.loop(lambda: step(run, state), WARMUP_S, min_calls=len(pool))
    run.spans.clear()
    state["latency"].clear()
    state["kept"].clear()
    return state


def step(run, state) -> int:
    """One frame: detect, match against the previous frame, synchronise."""
    import torch

    pos = state["i"] % len(state["pool"])
    state["i"] += 1
    t0 = time.perf_counter()
    feats, desc, matches = state["run_frame"](state["pool"][pos], state["prev"])
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    state["latency"].append(time.perf_counter() - t0)
    state["kept"][pos] = (state["heat"], feats, desc, matches) + state["prev"]
    state["prev"] = (desc, feats.valid)
    return 1


def end_to_end(run, state) -> dict:
    lat = np.asarray(state["latency"]) * 1e3
    return {"stream_frame_ms_mean": 1e3 * run.window["seconds"] / run.window["frames"],
            "stream_frame_ms_p95": float(np.percentile(lat, 95))}


def outputs(run, state) -> list:
    """The checked frames and the program's outputs, on the host: the
    latest frame of ``check_frames`` stream positions that the window ran,
    drawn from the seed."""
    rng = np.random.default_rng([run.seed, 2])
    kept = sorted(state["kept"])
    out = []
    for pos in sorted(rng.choice(kept, min(run.mix["check_frames"], len(kept)), replace=False)):
        heat, feats, desc, matches, prev_desc, prev_valid = state["kept"][pos]
        out.append({"image": state["pool"][pos].cpu().numpy(), "heat": heat.float().cpu().numpy(),
                    "uv": feats.uv.cpu().numpy(), "valid": feats.valid.cpu().numpy(),
                    "desc": desc.float().cpu().numpy(), "match_index": matches.index.cpu().numpy(),
                    "prev_desc": prev_desc.float().cpu().numpy(), "prev_valid": prev_valid.cpu().numpy()})
    return out


def _reference_maps(run, outs: list, precision: str) -> list:
    """(heatmap, pooled descriptor map) of each checked frame by the
    reference at ``precision``, on the run's device."""
    import torch

    w = ref.Weights(ref.load_npz(str(run.root / run.config["weights"])), run.device)
    maps = []
    for o in outs:
        heat, desc = ref.forward(w, torch.from_numpy(o["image"]).to(run.device), precision)
        maps.append((heat.cpu().numpy(), ref.pooled(desc)))
        del heat, desc
    return maps


def control(run, outs: list) -> list:
    """The control in the program's place: the reference with float8
    convolutions, the step below the configuration's bfloat16; its
    selection, descriptors and matches follow from its own maps."""
    d, m = run.config["detector"], run.config["matcher"]
    ctrl = []
    for o, (heat, pooled) in zip(outs, _reference_maps(run, outs, "fp8")):
        uv, valid = ref.select(heat, d["max_number_of_detected_features"], d["min_feature_distance"],
                               d["invalid_boundary"], d["min_response"])
        desc = ref.sample(pooled, uv, valid)
        index, _ = ref.match(o["prev_desc"], o["prev_valid"], desc, valid, m["min_similarity"])
        ctrl.append(dict(o, heat=heat, uv=uv, valid=valid, desc=desc, match_index=index))
    return ctrl


def tile_means(gap: np.ndarray, tile: int = TILE) -> np.ndarray:
    """The mean of ``gap`` over each ``tile`` x ``tile`` square of the frame;
    the squares at the right and bottom edges hold what is left."""
    h, w = gap.shape
    rows, cols = -(-h // tile), -(-w // tile)
    total, count = np.zeros((rows * tile, cols * tile)), np.zeros((rows * tile, cols * tile))
    total[:h, :w], count[:h, :w] = gap, 1
    return (total.reshape(rows, tile, cols, tile).sum((1, 3))
            / count.reshape(rows, tile, cols, tile).sum((1, 3)))


def check(run, outs: list) -> dict:
    """Numbers compared: ``heat_err`` the mean gap between the program's
    heatmap and the float32 reference's over every pixel of the checked
    frames; ``heat_tile_err`` the largest mean of that gap over one TILE x
    TILE square of one checked frame, which a fault confined to a region
    moves where the mean over whole frames dilutes it; ``desc_err`` the root mean square of the distance between the
    program's descriptors and the reference's maps sampled at the program's
    features, over the valid ones; ``select_diff`` feature slots unlike the
    reference's selection on the program's heatmap (exact); ``match_diff``
    slots matched otherwise than the reference's matching of the program's
    descriptors, but for decisions that rest on a near tie (exact).  The
    largest gaps, which one steep pixel of the sigmoid sets, are kept in
    ``run.extra["widest"]`` for the look, not compared."""
    d, m = run.config["detector"], run.config["matcher"]
    heat_sum = heat_n = heat_tile = desc_sq = desc_n = 0.0
    widest = {"heat": 0.0, "desc": 0.0}
    select = matches = 0
    for o, (heat, pooled) in zip(outs, _reference_maps(run, outs, "float32")):
        gap = np.abs(o["heat"].astype(np.float64) - heat)
        heat_sum, heat_n = heat_sum + gap.sum(), heat_n + gap.size
        heat_tile = max(heat_tile, float(tile_means(gap).max()))
        dist = np.linalg.norm(o["desc"].astype(np.float64) - ref.sample(pooled, o["uv"], o["valid"]), axis=1)
        desc_sq, desc_n = desc_sq + (dist[o["valid"]] ** 2).sum(), desc_n + o["valid"].sum()
        widest = {"heat": max(widest["heat"], float(gap.max())), "desc": max(widest["desc"], float(dist.max()))}
        uv, valid = ref.select(o["heat"], d["max_number_of_detected_features"], d["min_feature_distance"],
                               d["invalid_boundary"], d["min_response"])
        select += int(((o["uv"] != uv).any(1) | (o["valid"] != valid)).sum())
        index, near = ref.match(o["prev_desc"], o["prev_valid"], o["desc"], o["valid"], m["min_similarity"])
        matches += int(((o["match_index"] != index) & ~near).sum())
    run.extra["widest"] = widest
    return {"heat_err": (float(heat_sum / max(heat_n, 1)), HEAT_ERR_LIMIT),
            "heat_tile_err": (heat_tile, HEAT_TILE_LIMIT),
            "desc_err": (float(np.sqrt(desc_sq / max(desc_n, 1))), DESC_ERR_LIMIT),
            "select_diff": (select, 0), "match_diff": (matches, 0)}
