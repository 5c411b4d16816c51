"""The VO port against the JAX package on the 120-frame bench sequence, on
the CPU: a study, not a test (it takes about five minutes a seed).

    JAX_PLATFORMS=cpu python -m tests.test_torch_vo_study [--seeds 1 2 7] [--detail]

Prints one JSON object:

- ``ate_share_of_span_by_seed``: for each seed, the whole VO's ATE over the
  span for the JAX package, the port with its own RANSAC draws, the port
  with JAX's draws, and the port with its chunk solver's BA in float64
  (``chunk_ba_f64``: each chunk's LM solved in float64 as the global BA is,
  in place of float32 with one refinement step);

With ``--detail`` (at the last seed) also:

- ``chunk_ate_share``: each chunk's solution (the same chunk problems, JAX's
  draws, both solvers) against ground truth, as ATE over the chunk's span;
- ``ba_perturbation``: the global BA problem of the port's run, solved
  before and after a 1e-5 px change of its observations, by the JAX
  package's ``ba_solve`` (float64 solves over float32 state) and by the
  port's (float64 throughout): the largest rotation change and the largest
  center change over the span.

The bench sequence is ``bench.py:275-276``'s: 120 frames at 240x320, 900
landmarks, lateral motion, ``angle_step=0.03``, seeds 1, 2 and 7 by default.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from feature_detector_tpu.core.config import BAOptions as JBAOptions
from feature_detector_tpu.slam import ba as JBA
from feature_detector_tpu.slam import sequence as JS
from feature_detector_tpu.slam import vo_fused as JV
from feature_detector_tpu_torch.core.config import BAOptions, BriefOptions, DetectorOptions, MatcherOptions
from feature_detector_tpu_torch.slam import ba as TBA
from feature_detector_tpu_torch.slam import geometry as TG
from feature_detector_tpu_torch.slam import sequence as TS
from feature_detector_tpu_torch.slam import vo_fused as TV
from feature_detector_tpu_torch.slam.evaluate import ate_rmse

FRAMES, LANDMARKS = 120, 900
SEEDS = (1, 2, 7)  # the reference's seeds (feature_detector_tpu/slam/vo_fused.py:40-41)
CHUNK, OVERLAP = 12, 5
PERTURB_PX = 1e-5


def jax_draws(seed: int, rounds: int, n: int, device="cpu") -> torch.Tensor:
    keys = jax.random.split(jax.random.PRNGKey(seed), rounds)
    return torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(keys))).to(device)


def share(positions, truth) -> float:
    return float(ate_rmse(positions, truth, with_scale=True)) / float(np.linalg.norm(np.ptp(truth, 0)))


def centers(rot, trans):
    return -np.einsum("...ji,...j->...i", np.asarray(rot, np.float64), np.asarray(trans, np.float64))


def bench_sequence(seed: int):
    return TS.make_synthetic_sequence(n_frames=FRAMES, n_landmarks=LANDMARKS, seed=seed, motion="lateral",
                                      angle_step=0.03)


def chunk_ba_f64(problem, cam, opts, num_fixed=None, dense_frames=False, f64=False):
    """The chunk solver's BA, solved in float64 (as ``ba_solve`` does)."""
    return TBA._ba_solve_impl(problem, cam, opts, num_fixed, dense_frames, f64=True)


def ate_shares(seq) -> dict:
    """The whole VO's ATE over the span: JAX, the port with its own draws,
    with JAX's draws, and with the chunk solver's BA in float64."""
    truth = seq.trajectory.positions
    out = {"jax": share(JS.run_visual_odometry_chunked(seq.images, JS.Pinhole(*seq.cam)).trajectory.positions, truth),
           "port": share(TS.run_visual_odometry_chunked(seq.images, seq.cam, device="cpu").trajectory.positions,
                         truth)}
    own_draws, own_solver = TG.ransac_gumbel, TV._ba_solve_impl
    TG.ransac_gumbel = jax_draws
    try:
        out["port_with_jax_draws"] = share(
            TS.run_visual_odometry_chunked(seq.images, seq.cam, device="cpu").trajectory.positions, truth)
    finally:
        TG.ransac_gumbel = own_draws
    TV._ba_solve_impl = chunk_ba_f64
    try:
        out["port_chunk_ba_f64"] = share(
            TS.run_visual_odometry_chunked(seq.images, seq.cam, device="cpu").trajectory.positions, truth)
    finally:
        TV._ba_solve_impl = own_solver
    return out


def detail(seq) -> dict:
    """Each chunk's solution by both solvers, and the global BA's
    sensitivity to a tiny change of its observations."""
    truth = seq.trajectory.positions
    span = float(np.linalg.norm(np.ptp(truth, 0)))
    out = {}
    port = TS.run_visual_odometry_chunked(seq.images, seq.cam, device="cpu")
    own_draws = TG.ransac_gumbel
    TG.ransac_gumbel = jax_draws
    try:
        # The same chunk problems (the port's front-end, JAX's draws) through both chunk solvers.
        det = DetectorOptions(min_feature_distance=10, min_valid_response=20.0, max_features=256, subpixel=True)
        feats, words, dvalid, links = TS.scan_frontend(seq.images, "harris", 200, det, BriefOptions(upright=True),
                                                       device="cpu")
        uv = feats.uv.numpy()
        pairs = TV.match_and_gate(words, dvalid, uv, feats.valid.numpy(), links.numpy(), seq.cam,
                                  MatcherOptions(ratio=0.85, max_distance=80), TV.match_offsets_for(FRAMES))
        tracks = TS.build_tracks_conflict_free(pairs, FRAMES, det.max_features)
        starts = TV.chunk_starts(FRAMES, CHUNK, OVERLAP)
        track_uv, track_has = TV.chunk_problems(tracks, uv, starts, CHUNK, 512)
    finally:
        TG.ransac_gumbel = own_draws
    opts = dict(max_iterations=10, huber_delta=2.0, gate_px=3.0, gate_rounds=1)
    want = JV._chunk_solver_jit(JS.Pinhole(*seq.cam), CHUNK, 15, 2, JBAOptions(**opts), 3.0)(
        jnp.asarray(track_uv), jnp.asarray(track_has))
    got = TV.solve_chunks(torch.from_numpy(track_uv), torch.from_numpy(track_has), seq.cam, 15, 2,
                          BAOptions(**opts), 3.0, gumbel=jax_draws(0, 64, 512))
    out["chunk_ate_share"] = {
        who: [share(centers(r[k], t[k]), truth[s:s + CHUNK]) for k, s in enumerate(starts)]
        for who, (r, t) in (("jax", (np.asarray(want[0]), np.asarray(want[1]))),
                            ("port", (got[0].numpy(), got[1].numpy())))
    }
    out["chunk_starts"] = starts

    # The global BA problem of the port's run, before and after a tiny change of its observations.
    prob = port.problem
    noise = np.random.default_rng(0).normal(0, PERTURB_PX, tuple(prob.obs_uv.shape)).astype(np.float32)
    ba_kw = dict(max_iterations=12, huber_delta=2.0, gate_px=3.0, gate_rounds=2)  # the VO's global BA
    jp = JBA.BAProblem(*[jnp.asarray(x.numpy()) for x in prob])
    solved = {
        "jax": [JBA.ba_solve(p, JS.Pinhole(*seq.cam), JBAOptions(**ba_kw))
                for p in (jp, jp._replace(obs_uv=jp.obs_uv + jnp.asarray(noise)))],
        "port": [TBA.ba_solve(p, seq.cam, BAOptions(**ba_kw))
                 for p in (prob, prob._replace(obs_uv=prob.obs_uv + torch.from_numpy(noise)))],
    }
    out["ba_perturbation"] = {"perturbation_px": PERTURB_PX}
    for who, (a, b) in solved.items():
        moved = np.abs(centers(a.rot, a.trans) - centers(b.rot, b.trans)).max()
        out["ba_perturbation"][who] = {"rot_max_change": float(np.abs(np.asarray(a.rot) - np.asarray(b.rot)).max()),
                                       "center_max_change_over_span": float(moved) / span}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--detail", action="store_true", help="chunk and global-BA detail at the last seed")
    args = ap.parse_args()
    out = {"frames": FRAMES, "landmarks": LANDMARKS, "ate_share_of_span_by_seed": {}, "span_m": {}}
    for seed in args.seeds:
        seq = bench_sequence(seed)
        out["span_m"][seed] = float(np.linalg.norm(np.ptp(seq.trajectory.positions, 0)))
        out["ate_share_of_span_by_seed"][seed] = ate_shares(seq)
        print(json.dumps({"seed": seed, **out["ate_share_of_span_by_seed"][seed]}), flush=True)
    if args.detail:
        out.update(detail(bench_sequence(args.seeds[-1])))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
