"""The classical front-end: FAST, greedy selection, steered BRIEF and
cross-checked Hamming matching of frame pairs, driven through the port's
public entry points.

One rank: a step is ``detect_good_features_batch`` on both frame stacks,
``compute_descriptors`` on both and ``match_hamming``.  Several ranks: a
step is ``parallel/frontend.py:make_two_frame_matcher`` on the whole batch,
each rank taking its block and every rank returning the whole batch through
all-gathers.  The outputs of each pool batch's last step in the window are
kept, and a sample of their pairs, drawn from the seed with the same number
from each quarter of the batch (each rank's block on four ranks), is held
against ``reference/fast_brief.py`` once the window has closed.
"""

from __future__ import annotations

import numpy as np

from .. import frames
from ..reference import fast_brief as ref

WARMUP_S = 1.0  # host seconds of steps before the window, at least one pass over the pool
TRACE_LAUNCHES = {"tile_keys_kernel": 2, "pick_kernel": 2}  # K1's launches a step: two detect calls on each rank


def _options(cfg: dict):
    from feature_detector_tpu_torch.core.config import BriefOptions, DetectorOptions, FastOptions, MatcherOptions

    d, b, m = cfg["detector"], cfg["brief"], cfg["matcher"]
    return (DetectorOptions(min_feature_distance=d["min_feature_distance"],
                            min_valid_response=d["min_valid_response"], max_features=d["max_features"]),
            FastOptions(n=d["fast_n"], min_pixel_diff_value=d["fast_min_pixel_diff"]),
            BriefOptions(length=b["length"], half_patch_size=b["half_patch_size"], method=b["method"],
                         steer_bins=b["steer_bins"], upright=b["upright"], blur_sigma=b["blur_sigma"]),
            MatcherOptions(max_distance=m["max_distance"], cross_check=m["cross_check"], ratio=m["ratio"]))


def setup(run) -> dict:
    import torch

    from feature_detector_tpu_torch.frontend.descriptor import compute_descriptors
    from feature_detector_tpu_torch.frontend.detector import detect_good_features_batch
    from feature_detector_tpu_torch.match.hamming import match_hamming

    cfg, mix = run.config, run.mix
    opts, sub, bopts, mopts = _options(cfg)
    picks = cfg["detector"]["max_features"]
    state = {"k": 0, "last": {}}
    if run.world > 1:
        from feature_detector_tpu_torch.parallel.distributed import global_data_mesh, initialize
        from feature_detector_tpu_torch.parallel.frontend import make_two_frame_matcher

        initialize(coordinator_address=f"localhost:{run.args.port}", num_processes=run.world,
                   process_id=run.rank, local_device_ids=[run.rank], device=run.device.type)
        mesh = global_data_mesh(device=run.device.type)
        matcher = make_two_frame_matcher(mesh, "fast", picks, opts, sub, bopts, mopts)
        state["run_step"] = lambda ja, jb: matcher(ja, jb)
        dev = torch.device("cuda", run.rank) if run.device.type == "cuda" else run.device
    else:
        spans = run.spans

        def one_card(ja, jb):
            with spans.span("fb.detect"):
                fa = detect_good_features_batch(ja, "fast", picks, opts, sub)
                fb = detect_good_features_batch(jb, "fast", picks, opts, sub)
            with spans.span("fb.describe"):
                da = compute_descriptors(ja, fa, bopts)
                db = compute_descriptors(jb, fb, bopts)
            with spans.span("fb.match"):
                m = match_hamming(da.words, da.valid, db.words, db.valid, mopts)
            return fa, fb, m, da, db

        state["run_step"] = one_card
        dev = run.device
    state["a"], state["b"] = frames.pair_pool(mix, run.seed, cfg["rows"], cfg["cols"], dev)
    run.loop(lambda: step(run, state), WARMUP_S, min_calls=mix["pool"])
    run.spans.clear()
    state["last"].clear()
    return state


def step(run, state) -> int:
    """One step: every pair of the next pool batch; keeps its outputs."""
    k = state["k"] % run.mix["pool"]
    state["k"] += 1
    state["last"][k] = state["run_step"](state["a"][k], state["b"][k])
    return 2 * run.mix["pairs"]


def end_to_end(run, state) -> dict:
    return {"frames_per_s": run.window["frames"] / run.window["seconds"]}


def sample(run, kept: list) -> list:
    """(pool batch, pair) of the pairs checked: ``check_pairs`` drawn from
    the seed, as many from each quarter of the batch, each from a pool batch
    that the window ran."""
    rng = np.random.default_rng([run.seed, 1])
    pairs, quarter = run.mix["pairs"], run.mix["pairs"] // 4
    per = run.mix["check_pairs"] // 4
    return [(int(rng.choice(kept)), int(q * quarter + j))
            for q in range(4) for j in rng.choice(quarter, per, replace=False)]


def outputs(run, state) -> list:
    """The sampled pairs' frames and the program's outputs, on the host."""
    def host(t, j):
        return t[j].cpu().numpy()

    out = []
    for k, j in sample(run, sorted(state["last"])):
        fa, fb, m, *desc = state["last"][k]
        o = {"image_a": host(state["a"][k], j), "image_b": host(state["b"][k], j)}
        for side, f in (("a", fa), ("b", fb)):
            o.update({f"uv_{side}": host(f.uv, j), f"response_{side}": host(f.response, j),
                      f"valid_{side}": host(f.valid, j)})
        o.update(match_index=host(m.index, j), match_distance=host(m.distance, j), match_valid=host(m.valid, j))
        if desc:  # one rank: the words too (the matcher over ranks returns none)
            for side, d in zip("ab", desc):
                o[f"words_{side}"] = host(d.words, j).view(np.uint32)
                o[f"desc_valid_{side}"] = host(d.valid, j)
        out.append(o)
    return out


def control(run, outs: list) -> list:
    """The control in the program's place: the reference with the steering
    angle worked out in bfloat16, the step below the configuration's float32."""
    cfg = run.config
    ctrl = []
    for o in outs:
        c = dict(o)
        res = {side: ref.frame(o[f"image_{side}"], cfg["detector"], cfg["brief"], "bfloat16") for side in "ab"}
        for side, (uv, r, v, w, dv, _) in res.items():
            c.update({f"uv_{side}": uv, f"response_{side}": r, f"valid_{side}": v})
            if f"words_{side}" in o:
                c.update({f"words_{side}": w, f"desc_valid_{side}": dv})
        idx, dist, ok = ref.match(res["a"][3], res["a"][4], res["b"][3], res["b"][4],
                                  cfg["matcher"]["max_distance"], cfg["matcher"]["cross_check"])
        c.update(match_index=idx, match_distance=dist, match_valid=ok)
        ctrl.append(c)
    return ctrl


def check(run, outs: list) -> dict:
    """Numbers compared, each an exact count with the limit 0:
    ``feat_diff`` feature slots (uv, response, validity) unlike the
    reference's; ``word_diff`` descriptors (words or validity) unlike the
    reference's, but for those whose angle lies within NEAR_BIN of a bin's
    rounding boundary (one rank; the matcher over ranks returns no words);
    ``match_diff`` matched slots (index, distance, validity) unlike the
    reference's matching, which takes the program's words at those excused
    descriptors (over ranks, a pair with one is left out of this count)."""
    cfg = run.config
    feat = words = matches = 0
    for o in outs:
        res = {side: ref.frame(o[f"image_{side}"], cfg["detector"], cfg["brief"]) for side in "ab"}
        usable = True
        for side, (uv, r, v, w, dv, near) in res.items():
            feat += int(((o[f"uv_{side}"] != uv).any(1) | (o[f"response_{side}"] != r)
                         | (o[f"valid_{side}"] != v)).sum())
            if f"words_{side}" in o:
                words += int((((o[f"words_{side}"] != w).any(1) | (o[f"desc_valid_{side}"] != dv)) & ~near).sum())
                w[near] = o[f"words_{side}"][near]
                dv[near] = o[f"desc_valid_{side}"][near]
            else:
                usable &= not near.any()
        if usable:
            idx, dist, ok = ref.match(res["a"][3], res["a"][4], res["b"][3], res["b"][4],
                                      cfg["matcher"]["max_distance"], cfg["matcher"]["cross_check"])
            matches += int(((o["match_index"] != idx) | (o["match_distance"] != dist)
                            | (o["match_valid"] != ok)).sum())
    checks = {"feat_diff": (feat, 0)}
    if "words_a" in outs[0]:
        checks["word_diff"] = (words, 0)
    checks["match_diff"] = (matches, 0)
    return checks
