#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, detect (FAST, greedy selection) -> steered
BRIEF -> cross-checked Hamming matching, on a batch of 64 frame pairs at
752x480 with 200 features, the single-frame incremental re-detect path, and
the LSD line detector (``detect_good_lines``, budget 100, default options) on
8 scenes at 752x480, and the NN serving path (``NNFeaturePointDetector.detect``
for SuperPoint and DISK, heatmap and NMS types, on the packaged weights in
bfloat16, default ``NNDetectorOptions``: 240 features, r = 15) on 8 scenes
at 640x480 with float matching, and the fused chunked visual odometry
(``run_visual_odometry_chunked``, default options) on the 120-frame bench
sequence at 240x320, all on the card.  It builds every CUDA kernel of these
paths from the sources in the checkout (FAST K6, greedy selection, the LSD
region flood, and the chunk solver's fixed-order contraction K4 and LU solve
K5), holds each against its plain PyTorch version on the card (FAST on the
main path's frames and the incremental frame with its mask, both maps; greedy
selection also on the VO's own candidate maps, K4 and K5 on the VO's largest calls and
on one call of every distinct shape and stride signature of the VO run,
under torch.profiler: one kernel a call, no copy; their summed device time
over a profiled VO run), shows through the launch
counters that each path went through its kernels, checks the outputs
against the port's CPU run (the NN post-processing fed the card's maps; the
bfloat16 forward the path runs, and a float32 forward with TF32 off, each
against the CPU's; the VO's scan front-end over 8 frames and its global BA
problem), checks the VO's ATE, compares the card's chunk solutions with the
CPU's on the same chunk problems, checks that the 17 chunks solved in blocks
of 5 and of 1 are the whole batch's bits, and times it all with CUDA events (each
kernel's own device time also with torch.profiler).  Then the multi-device
paths on an NCCL world of one (phase ``multi``): the frame-parallel
front-end and two-frame matcher on the main path's frames, the row-sharded
Harris response, the distributed BA on the VO's global problem (dense and
camera-sharded) and the VO over the mesh (its chunk batch split over the
mesh), each held against the one-device result, with the greedy, K4 and K5
launches counted.  Then training (phase ``train``):
SuperPoint (batch 32, 120x160) and DISK (batch 16, 128x160) for 22 bfloat16
steps each on ``make_batch`` batches (rendered in worker processes), timed by CUDA events and profiled, each first held in float32
against the CPU's step; the trained SuperPoint through the npz format into
``NNFeaturePointDetector.detect`` (greedy launches counted); a data-parallel
step on an NCCL world of one against the one-device step, bit for bit; a
``ResilientLoop`` that rolls back an injected NaN.  Last the demos (phase
``demo``): ``app/demo.py``'s five demos on synthetic scenes, their PNGs read
back, the greedy and flood launches counted.  Then the legacy short-window VO
(phase ``legacy``): ``run_visual_odometry`` on a 16-frame arc at 240x320 with
the incremental front-end (greedy twice a frame) and the batch front-end (one
batched greedy call), its ATE against the reference's bound, stage times and
busy share, the incremental front-end on the card against the CPU, and
``run_visual_odometry_chunked(legacy=True)`` on 30 lateral frames.  Last the
card against the numpy oracles (phase ``oracle``): detection of each kind,
greedy selection, BRIEF, the LSD angle map and lines, and SuperPoint's
heatmap selection, each held against ``feature_detector_tpu_torch/oracle``.

    python3 chip_smoke.py --world 4

runs instead the multi-device paths on four cards, one process and one card
a rank, through ``parallel/distributed.py:initialize`` (NCCL): each rank
holds K1 and K2 against their plain version on its card, computes every
path's one-card result there (held against rank 0's), runs the
frame-parallel front-end and matcher, the row-sharded Harris response, the
distributed BA (dense, camera-sharded, and the JAX multi-chip entry's seam
case of 5 cameras), the VO over the mesh (each rank solves 5 of the 17
chunks padded to 20; its trajectory is one card's, bit for bit) and the
data-parallel SuperPoint step over the four ranks and holds each against
one card, counts K1, K2, K4 and K5 a rank (K4 and K5 also held against their
plain version on the rank's largest calls and on every call signature of its
VO run), and times each path on one
card and over the four.  A rank that
fails, or the wall limit, stops every rank and the run prints no result.

One JSON line per phase.  Before the last line: one JSON object describing
every kernel, then the card's name and power limit as nvidia-smi gives them.
The last line is ``{"ok": true, "device": {...}}``.  Any failed phase raises
and the script exits non-zero without that line; so does a machine where
``torch.cuda.is_available()`` is false.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np

BATCH, ROWS, COLS, PICKS, RADIUS = 64, 480, 752, 200, 20
SCENES = 8  # 8 scenes x 8 row shifts = 64 frames
MAIN_DETECTOR = dict(min_feature_distance=RADIUS, min_valid_response=10.0, max_features=PICKS)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
SOURCE = "feature_detector_tpu_torch/kernels/csrc/greedy.cu"
FAST_SOURCE = "feature_detector_tpu_torch/kernels/csrc/fast.cu"
FAST_KERNELS = ("fast_kernel",)
LSD_SOURCE = "feature_detector_tpu_torch/kernels/csrc/lsd_flood.cu"
FIXED_SOURCE = "feature_detector_tpu_torch/kernels/csrc/fixed_order.cu"
FIXED_REPLACES = ("none (added for the chunk solver: batch-invariant arithmetic, "
                  "feature_detector_tpu_torch/slam/fixed.py)")
FIXED_KERNELS = {"fixed_contract": ("contract_serial", "contract_tiled"),
                 "fixed_lu_solve": ("lu_solve_block", "lu_solve_warp")}
FIXED_RANK_SHARE = 10  # a rank's share of the 34 chunk problems on four cards (5 chunks x 2 init pairs)
PEAK_F32_SEPARATE_OPS_PER_S = 33.5e12  # H100 SXM float32 multiplies or adds without FMA: half the FMA rate
LSD_BUDGET = 100
LSD_SWEEPS_ODD = 330  # a sweep count that is no multiple of the sweeps per launch
SEAM_ROWS, SEAM_COLS = 97, 151  # a map size that is no multiple of any tile
FLOOD_OPS_PER_VISIT = 20  # float32 operations per valid pixel, neighbour and sweep (lsd_flood.cu)
ANGLE_ATOL = 5e-7  # two float32 ulps at pi: the card's atan2 against the CPU's
ENDPOINT_ATOL = 1e-3  # px, as in tests/test_torch_lsd.py
NN_ROWS, NN_COLS = 480, 640  # the frame size of the JAX bench's NN rows (bench.py:219-243)
NN_DESC_ATOL = 1e-6  # descriptors of the card's post-processing against the CPU's, given the same maps
NN_F32_HEAT_ATOL, NN_F32_DESC_ATOL = 1e-4, 1e-3  # float32 forward, card (no TF32) against CPU
# bfloat16 forward, card against CPU, (heat, desc): the port's bf16 tolerances against Flax (tests/test_torch_nn.py)
NN_BF16_ATOL = {"superpoint": (2e-2, 6e-3), "disk": (6e-2, 3e-2)}
NN_SELF_DIST = 1e-3  # L2 distance of a self-match: cosine 1 within float32 rounding
GREEDY_KERNELS = ("tile_keys_kernel", "pick_kernel")


def fast_bound_ms(pixels: int, want_response: bool) -> float:
    """Least time for FAST: read each uint8 pixel once and write one float32
    map (two with the response map), in bytes at the HBM peak."""
    return 1e3 * pixels * (1 + 4 * (1 + want_response)) / PEAK_BYTES_PER_S
NN_TOP_KERNELS = 6  # kernels listed by device time per detect call
# The VO bench sequence (bench.py:275-276): 120 frames at 240x320, 900 landmarks, seed 7.
VO_FRAMES, VO_LANDMARKS, VO_SEED = 120, 900, 7
VO_CHECK_FRAMES = 8  # scan front-end on the card against the CPU over these first frames
VO_TIMED_RUNS = 2
VO_ATE_SPAN_SHARE = 0.03  # tests/test_sequence.py:274
VO_K2_FRAMES = (0, 3, 7)  # the VO candidate maps K2 is held against its plain version on
VO_HARRIS_REL = 1e-4  # a feature whose Harris response is within this of the threshold may flip
VO_BA_POSE_ATOL = 1e-4  # global BA (solved in float64) on the card against the CPU: rotations, centers / span
VO_BA_POINT_ATOL = 1e-3  # the same for points, relative to the span
VO_TOP_KERNELS = 8
VO_ATE_SHARE_LIBRARY = 0.01104  # the VO's ATE over the span on an H100 when the chunk solver used cuBLAS and cuSOLVER
VO_CHUNK_BLOCKS = (5, 1)  # the chunk batch solved in blocks of these sizes against the whole batch, bit for bit
# The card's chunk solutions against the CPU's on the same chunk problems and draws, per chunk up to its
# monocular scale: rotations, and camera centers and points over the chunk's largest center distance.
VO_CHUNK_ROT_ATOL, VO_CHUNK_CENTER_ATOL, VO_CHUNK_POINT_ATOL = 1e-3, 1e-3, 1e-2
# Multi phase, world of one: the distributed BA against ba_solve on the card (rotations in rad, centers and
# points over the span).  Dense: the global BA's card-against-CPU tolerances (each all-reduce of a world of
# one is the identity, so equality is expected).  Camera-sharded: 64 CG iterations a LM step stop short of
# the dense solve, and for a few landmarks the consensus gate then keeps other observations, which moves
# those points far; so the cameras, the median point, the share of points within 1e-2 of the span and the
# cost (at most 10% above ba_solve's) are held.
MULTI_BA_DENSE_ATOL = {"rot": VO_BA_POSE_ATOL, "center": VO_BA_POSE_ATOL, "point": VO_BA_POINT_ATOL}
MULTI_BA_CG_TOL = {"rot": 1e-2, "center": 1e-2, "point_median": 1e-3, "points_within_1e-2": 0.95, "cost": 0.1}
MULTI_VO_POS_ATOL = 1e-4  # the VO over a mesh of one against phase vo's run, positions over the span
# Train phase: the widths of the JAX package's train() defaults (train_superpoint.py:192, train_disk.py:127).
TRAIN_MODELS = {
    "superpoint": {"batch": 32, "rows": 120, "cols": 160, "rich_background": False},
    "disk": {"batch": 16, "rows": 128, "cols": 160, "rich_background": True},
}
TRAIN_STEPS, TRAIN_WARMUP = 20, 2
TRAIN_SEED = 0
TRAIN_LR = 1e-3
TRAIN_CHECK_FRAMES = 4  # the float32 card-vs-CPU first step runs on the first frames of the first batch
TRAIN_LOSS_RTOL = 1e-5  # tests/test_torch_train.py
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-4, 1e-6  # tests/test_torch_train.py, per element; on a norm: + atol sqrt(n)
TRAIN_ZERO_GRAD_SHARE = 1e-4  # a gradient that is 0 in exact arithmetic, against the total gradient norm
TRAIN_TOP_KERNELS = 6
RESILIENT_STEPS, RESILIENT_SAVE_EVERY, RESILIENT_NAN_STEP = 6, 2, 3
# Demo phase: 2 greedy launches per detect call (points: 3 kinds x warm-up and timed call + 2 incremental calls).
DEMO_SEED = 40
DEMO_VO_FRAMES = 30
DEMO_K2 = {"points": 16, "descriptor": 4, "lines": 0, "nn": 4, "vo": 2 * DEMO_VO_FRAMES}
DEMO_PNGS = 14
# The multi-card run (--world N, one process and one card a rank): timed repeats of each path on one card and
# over the world, each call after a barrier, after WORLD_WARMUP calls; the parent's wall limit.
WORLD_REPS = {"fast": 10, "ba": 3, "vo": 2, "train": 8, "collective": 20}
WORLD_WARMUP = 2
WORLD_WALL_S = 900.0
# The camera-sharded seam case of the JAX package's multi-chip entry (__graft_entry__.py:120-162).  Its data
# are noise-free and two LM steps take its cost from 0.264 to about 6e-7, so the camera-sharded cost is held
# within GRAFT_CG_COST_SHARE of the initial cost of one card's, not relative to one card's near-zero cost
# (JAX's own camera-sharded solve ends 2.5e-7 from the port's dense one on the CPU: 0.94e-6 of the initial).
GRAFT_CAMS, GRAFT_MAX_ITERATIONS, GRAFT_CG_ITERATIONS, GRAFT_CG_COST_SHARE = 5, 2, 24, 2e-6
# A float32 gradient whose elements part from the one-card step's by more than TRAIN_GRAD_RTOL / ATOL is held
# against the float64 gradient as tests/test_torch_gpu.py holds the card's cuDNN gradients.
ROUNDING_FACTOR, CARD_GRAD_SCALE_TOL = 2.0, 2e-4


# Legacy phase: the short-window VO (run_visual_odometry) on tests/test_sequence.py:222-237's 16-frame arc,
# with its ATE bound, and run_visual_odometry_chunked(legacy=True) on the 30-frame lateral sequence of
# tests/test_sequence.py:251-254 through the entry's own chunking; the incremental front-end on the card
# against the CPU on the 5-frame arc of tests/test_sequence.py:172-173.
LEGACY_FRAMES, LEGACY_LANDMARKS, LEGACY_SEED, LEGACY_MAX_TRACK_OBS = 16, 250, 3, 12
LEGACY_ATE_M = 0.06
LEGACY_CHUNKED_FRAMES, LEGACY_CHUNKED_LANDMARKS, LEGACY_CHUNK, LEGACY_OVERLAP = 30, 500, 12, 5
LEGACY_FE_FRAMES, LEGACY_FE_LANDMARKS, LEGACY_FE_SEED = 5, 140, 7
LEGACY_K2_FRAME = 3  # the incremental front-end's top-up map K2 is held against its plain version on
LEGACY_TOP_KERNELS = 6
# Oracle phase: one 752x480 scene per detector kind (the main path's detector options; Harris and
# Shi-Tomasi at the thresholds of tests/test_detectors.py), 120x160 tiles of it (the oracle tests' size),
# and the 120x160 bars image of tests/test_lsd.py:14-21.
ORACLE_SCENE_SEEDS = {"fast": 0, "harris": 1, "shi_tomasi": 2}
ORACLE_THRESHOLDS = {"fast": 10.0, "harris": 30.0, "shi_tomasi": 40.0}
ORACLE_TILES = ((0, 0), (120, 160), (240, 320), (360, 592))
ORACLE_TILE_PICKS = 50
ORACLE_LINE_PX = 4.0  # every oracle line within 4 px of a detected one (tests/test_lsd.py:49-60)
ORACLE_BRIEF_TIE = 0.05  # a gather BRIEF bit may differ where the oracle's two reads are this close


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def nvidia_smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup_s: float = 0.25) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` calls, by CUDA events,
    after calling it for at least ``warmup_s`` seconds: the card lowers its
    clocks while idle (between phases the host works alone) and takes a
    while under load to raise them again."""
    t0 = time.perf_counter()
    while True:
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 >= warmup_s:
            break
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled(torch, fn, attempts: int = 3, complete=bool) -> tuple:
    """(device ms by kernel name, kernels by name, CUDA-event ms) of one call
    of ``fn`` under torch.profiler, from the raw trace
    (``traced_device_ms``).  A trace whose kernel counts are not
    ``complete`` (by default: that hold no device event at all) is taken
    again, up to ``attempts`` calls in all: CUPTI now and then hands back an
    empty trace, or one that lacks some kernels."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
        per_kernel, counts = traced_device_ms(torch, prof)
        if complete(counts):
            break
    return per_kernel, counts, start.elapsed_time(end)


def kernel_times(torch, fn, iters: int) -> dict:
    """Device time per call, in ms, of every kernel that ``fn`` runs, by
    name, from a torch.profiler trace of ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    per_kernel, _, _ = profiled(torch, lambda: [fn() for _ in range(iters)])
    return {name: ms / iters for name, ms in per_kernel.items() if ms > 0}


def device_ms(torch, fn, kernels, iters: int) -> float:
    """Device time per call, in ms, of the CUDA kernels whose names contain
    one of ``kernels``.  A call's CUDA-event time also holds the host's gaps
    when the host enqueues more slowly than the card runs."""
    total = sum(ms for name, ms in kernel_times(torch, fn, iters).items() if any(k in name for k in kernels))
    check(total > 0, f"the profiler saw no device time of {kernels}")
    return total


def traced_device_ms(torch, prof) -> tuple:
    """Device time in ms and count of every kernel (and copy) of a finished
    torch.profiler run, by name, summed from the raw trace.  It equals
    ``key_averages``' device totals, without the event tree that
    ``key_averages`` builds first (a minute on a run of 250,000 kernels)."""
    cuda = torch.autograd.DeviceType.CUDA
    ms, counts = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            ms[e.name()] = ms.get(e.name(), 0.0) + e.duration_ns() / 1e6
            counts[e.name()] = counts.get(e.name(), 0) + 1
    return ms, counts

def greedy_bound_ms(batch: int, rows: int, cols: int, picks: int) -> float:
    """Least time for greedy selection: read each map once, write each
    output slot once (bytes), or one comparison per map element (f32 ops)."""
    nbytes = batch * rows * cols * 4 + batch * 4 + batch * picks * 4 * 4
    ops = batch * rows * cols
    return 1e3 * max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S)


def flood_bound(n_pixels: int, n_valid: int, sweeps: int):
    """Least time for ``sweeps`` flood sweeps: read the angle, validity and
    the four state planes once and write the state once (37 bytes a pixel),
    or FLOOD_OPS_PER_VISIT float32 operations per valid pixel, neighbour and
    sweep.  Returns (ms, "bytes" or "operations")."""
    t_bytes = 37 * n_pixels / PEAK_BYTES_PER_S
    t_ops = sweeps * n_valid * 8 * FLOOD_OPS_PER_VISIT / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def equal_norm_maps(torch, dev, rows: int, cols: int, seed: int = 5):
    """A flood input where norms take three values (ties everywhere) and
    angles sit near +-pi (wrapping) or drift slowly; 70% valid."""
    rng = np.random.default_rng(seed)
    norm = rng.choice(np.float32([25.0, 30.0, 40.0]), (rows, cols)).astype(np.float32)
    valid = rng.random((rows, cols)) < 0.7
    angle = np.where(np.arange(cols)[None, :] < cols // 2, np.pi - 0.1, 0.4) + rng.uniform(-0.3, 0.3, (rows, cols))
    angle = np.where(angle > np.pi, angle - 2 * np.pi, angle)
    angle = np.where(valid, angle, 0.0).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (norm, angle, valid)]


def lsd_phase(torch, dev, scenes, smi: str):
    """The LSD path on the card: the flood kernel against its plain version,
    ``detect_good_lines`` on every scene with the launch count, agreement
    with the CPU run, repeatability and times.  Emits one JSON line and
    returns the kernel's entry of the kernels line."""
    from feature_detector_tpu_torch.core.config import LineDetectorOptions
    from feature_detector_tpu_torch.frontend.line_detector import detect_good_lines, detect_good_lines_with_state
    from feature_detector_tpu_torch.kernels.lsd import fit_lines, line_level_angle_map, propagate_labels_meanangle
    from feature_detector_tpu_torch.kernels.lsd_flood import (
        FLOOD_TILE,
        SWEEPS_PER_LAUNCH,
        initial_state,
        labels_of,
        propagate_running,
        running_sweeps,
        running_sweeps_ref,
    )

    opts = LineDetectorOptions()
    tol, sweeps = opts.min_tolerance_angle_residual_in_rad, opts.propagation_steps
    frames = [torch.from_numpy(sc).to(dev) for sc in scenes]
    shape = tuple(frames[0].shape)
    maps = [line_level_angle_map(f, opts) for f in frames]

    # Kernel against plain on the card (launches not counted): every plane
    # of the state equal bit for bit.
    max_err = 0.0
    per_launch = SWEEPS_PER_LAUNCH
    checks = []

    def check_flood(norm, angle, valid, n: int, what: str) -> None:
        nonlocal max_err
        state = initial_state(norm, angle, valid)
        got = running_sweeps(angle, valid, state, n, tol)
        torch.cuda.synchronize()
        want = running_sweeps_ref(angle, valid, state, n, tol)
        check(all(torch.equal(g, w) for g, w in zip(got, want)), f"lsd flood kernel != plain: {what}")
        err = (labels_of(got[1], valid) - labels_of(want[1], valid)).abs().max()
        max_err = max(max_err, float(err), *(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want)))
        checks.append(what)

    for i, m in enumerate(maps):
        check_flood(*m, sweeps, f"scene {i} x {sweeps}")
    check_flood(*equal_norm_maps(torch, dev, *maps[0][0].shape), sweeps, f"equal norms x {sweeps}")
    # The seams of the tiled design: sweep counts around the sweeps per
    # launch, a grid that is no multiple of a tile.
    for n in (0, 1, per_launch - 1, per_launch, per_launch + 1, LSD_SWEEPS_ODD):
        check_flood(*maps[0], n, f"scene 0 x {n}")
    check_flood(*equal_norm_maps(torch, dev, SEAM_ROWS, SEAM_COLS), 33, f"equal norms {SEAM_ROWS}x{SEAM_COLS} x 33")

    # The path itself, counted.
    propagate_running.launches = 0
    lines = [detect_good_lines(f, LSD_BUDGET, opts) for f in frames]
    torch.cuda.synchronize()
    launches = propagate_running.launches
    per_call = -(-sweeps // per_launch)
    check(launches == len(frames) * per_call,
          f"LSD path launched the flood kernel {launches} times, not {len(frames)} x {per_call}")
    per_frame = [int(l.count) for l in lines]
    check(all(bool(torch.isfinite(l.endpoints).all()) and l.endpoints.shape == (opts.max_lines, 4) for l in lines),
          "LSD endpoints finite, [max_lines, 4]")
    check(min(per_frame) >= 5, f"too few lines per frame: {per_frame}")

    # One frame against the port's CPU run.
    t0 = time.perf_counter()
    card = detect_good_lines_with_state(frames[0], opts)
    cn, ca, cv = line_level_angle_map(frames[0].cpu(), opts)
    check(torch.equal(cv, card.valid.cpu()) and torch.equal(cn, card.norm.cpu()), "angle map: valid/norm differ from the CPU")
    angle_diff = (ca - card.angle.cpu()).abs()
    check(float(angle_diff.max()) <= ANGLE_ATOL, f"angle map differs from the CPU by {float(angle_diff.max())}")
    card_maps = [t.cpu() for t in (card.norm, card.angle, card.valid)]
    cpu_labels = propagate_labels_meanangle(*card_maps, opts)
    check(torch.equal(cpu_labels, card.labels.cpu()), "CPU plain flood on the card's maps != the card's labels")
    cpu_ends, cpu_valid, _ = fit_lines(cpu_labels, *card_maps, shape, opts)
    end_err = float((cpu_ends - card.lines.endpoints.cpu()).abs().max())
    check(torch.equal(cpu_valid, card.lines.valid.cpu()) and end_err <= ENDPOINT_ATOL,
          f"CPU fit of the card's labels: lines differ (max endpoint error {end_err})")
    cpu_seconds = time.perf_counter() - t0

    # Two card runs are identical.
    again = [detect_good_lines(f, LSD_BUDGET, opts) for f in frames]
    card2 = detect_good_lines_with_state(frames[0], opts)
    check(all(torch.equal(a.endpoints, l.endpoints) and torch.equal(a.valid, l.valid) for a, l in zip(again, lines))
          and torch.equal(card2.labels, card.labels)
          and all(torch.equal(card2.rects[k], card.rects[k]) for k in card.rects), "two card runs differ")

    # Times.
    n0, a0, v0 = maps[0]
    st0 = initial_state(n0, a0, v0)
    labels0 = card.labels
    none_valid = torch.zeros_like(v0)
    st_none = initial_state(n0, a0, none_valid)
    times = {
        "flood_kernel_ms": cuda_ms(torch, lambda: running_sweeps(a0, v0, st0, sweeps, tol), 20),
        "flood_kernel_ms_one_launch": cuda_ms(torch, lambda: running_sweeps(a0, v0, st0, per_launch, tol), 50),
        "flood_kernel_ms_no_valid_pixel": cuda_ms(torch, lambda: running_sweeps(a0, none_valid, st_none, sweeps, tol), 20),
        "flood_device_ms": device_ms(torch, lambda: running_sweeps(a0, v0, st0, sweeps, tol), ("flood_tiles",), 10),
        "flood_plain_ms": cuda_ms(torch, lambda: running_sweeps_ref(a0, v0, st0, sweeps, tol), 2),
        "angle_map_ms": cuda_ms(torch, lambda: line_level_angle_map(frames[0], opts), 20),
        "flood_stage_ms": cuda_ms(torch, lambda: propagate_running(n0, a0, v0, sweeps, tol), 20),
        "fit_stage_ms": cuda_ms(torch, lambda: fit_lines(labels0, n0, a0, v0, shape, opts), 20),
    }
    torch.cuda.reset_peak_memory_stats()
    times["detect_good_lines_ms_per_frame"] = cuda_ms(
        torch, lambda: [detect_good_lines(f, LSD_BUDGET, opts) for f in frames], 3) / len(frames)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    t0 = time.perf_counter()
    for f in frames:
        detect_good_lines(f, LSD_BUDGET, opts)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / len(frames) * 1e3
    n_valid = int(v0.sum())
    bound_ms, bound_by = flood_bound(v0.numel(), n_valid, sweeps)
    t = FLOOD_TILE
    pad = torch.nn.functional.pad(v0.to(torch.int32), (0, -v0.shape[1] % t, 0, -v0.shape[0] % t))
    tile_live = pad.reshape(pad.shape[0] // t, t, pad.shape[1] // t, t).sum((1, 3)) > 0
    emit("lsd", card=smi, rows=shape[0], cols=shape[1], frames=len(frames), budget=LSD_BUDGET, sweeps=sweeps,
         sweeps_per_launch=per_launch, flood_launches=launches, lines_per_frame=per_frame, valid_pixels_frame0=n_valid,
         flood_tiles_frame0=tile_live.numel(), flood_tiles_live_frame0=int(tile_live.sum()),
         flood_tiles_live_share_frame0=float(tile_live.float().mean()), kernel_checks=checks,
         kernel_max_abs_err=max_err, angle_max_abs_diff_vs_cpu=float(angle_diff.max()),
         angle_pixels_differing_vs_cpu=int((angle_diff > 0).sum()), labels_equal_cpu_flood=True,
         endpoint_max_abs_err_vs_cpu_fit=end_err,
         cpu_check_seconds=cpu_seconds, two_runs_identical=True, **times,
         detect_good_lines_wall_ms_per_frame=wall_ms, peak_memory_mib=peak_mib,
         flood_bound_ms=bound_ms, flood_bound_by=bound_by, library_call="none")
    return {"name": "lsd_flood (propagate_running)", "route": "cuda", "source": LSD_SOURCE,
            "replaces": "feature_detector_tpu/kernels/lsd_pallas.py:56",
            "launches": launches, "max_abs_err": max_err,
            "ms": times["flood_kernel_ms"], "device_ms": times["flood_device_ms"], "plain_ms": times["flood_plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def nn_phase(torch, dev, smi):
    """The NN serving path on the card, for each of the four model types on
    the packaged weights in bf16: ``NNFeaturePointDetector.detect`` on every
    scene (two greedy launches a call, counted) and one incremental call;
    the CPU post-processing fed the card's maps; the bf16 and an f32 forward
    against the CPU's; greedy selection against its plain version on the path's
    candidate maps; float matching; times.  Emits one JSON line per type and
    returns the greedy kernel's NN-path numbers."""
    from feature_detector_tpu_torch.core.config import NNDetectorOptions, NNModelType
    from feature_detector_tpu_torch.core.types import Features
    from feature_detector_tpu_torch.frontend.nn_detector import (
        NMS_TYPES,
        NNFeaturePointDetector,
        heatmap_candidates,
        nms_candidates,
        postprocess,
    )
    from feature_detector_tpu_torch.kernels.detect import greedy_select_ref
    from feature_detector_tpu_torch.kernels.greedy import greedy_select
    from feature_detector_tpu_torch.match.float_matcher import match_float
    from feature_detector_tpu_torch.models.superpoint import nms_head
    from feature_detector_tpu_torch.models.synth_data import scene_uint8, synth_scene

    cpu = torch.device("cpu")
    scenes = [scene_uint8(synth_scene(np.random.default_rng(s), NN_ROWS, NN_COLS, rich_background=True)[0])
              for s in range(SCENES)]
    frames = [torch.from_numpy(sc).to(dev) for sc in scenes]
    shifted = torch.from_numpy(np.roll(scenes[0], 3, axis=1)).to(dev)
    k2 = {"launches": 0, "max_abs_err": 0.0, "ms": {}, "device_ms": {}, "plain_ms": {}}
    f32, bf16 = {}, {}
    for t in NNModelType:
        opts = NNDetectorOptions(max_image_rows=NN_ROWS, max_image_cols=NN_COLS, model_type=t)
        cap, r = opts.max_number_of_detected_features, opts.min_feature_distance
        family = "superpoint" if "SUPERPOINT" in t.name else "disk"
        det = NNFeaturePointDetector(opts, device=dev)
        det.initialize()
        empty = Features.empty(cap, dev)

        # The path, counted: one detect call per scene.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        greedy_select.launches = 0
        outs = [det.detect(f) for f in frames]
        torch.cuda.synchronize()
        launches = greedy_select.launches
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        check(launches == 2 * len(frames), f"{t.name}: {launches} greedy launches for {len(frames)} detect calls, not 2 each")
        k2["launches"] += launches
        counts = [int(f.count) for f, _ in outs]
        check(all(bool(torch.isfinite(f.uv).all() and torch.isfinite(f.response).all() and torch.isfinite(d).all())
                  and d.shape[0] == cap for f, d in outs), f"{t.name}: features finite, capacity {cap}")
        check(min(counts) >= 5, f"{t.name}: too few features per frame: {counts}")

        # One incremental call: half of scene 0's features on its 3-column shift.
        fa, da = outs[0]
        n = counts[0] // 2
        keep = torch.arange(cap, device=dev) < n
        existing = Features(fa.uv * keep[:, None], fa.response * keep, fa.valid & keep)
        greedy_select.launches = 0
        inc, _ = det.detect(shifted, existing)
        torch.cuda.synchronize()
        check(greedy_select.launches == 2, f"{t.name}: incremental call launched greedy {greedy_select.launches} times")
        n_inc = int(inc.count)
        check(torch.equal(inc.uv[:n], existing.uv[:n]) and bool(inc.valid[:n].all()) and n_inc > n,
              f"{t.name}: existing prefix kept, new features added")
        new_uv, old_uv = inc.uv[n:n_inc].cpu().numpy(), existing.uv[:n].cpu().numpy()
        check(not (np.abs(new_uv[:, None, :] - old_uv[None, :, :]) <= r).all(-1).any(),
              f"{t.name}: a new pick falls inside an existing square")

        # The CPU post-processing fed the card's maps gives the card's output.
        desc_err = 0.0
        for img, ex in ((frames[0], empty), (frames[1], empty), (shifted, existing)):
            heat, dmap = det.maps(img)
            card_f, card_d = postprocess(heat, dmap, ex, opts)
            cpu_f, cpu_d = postprocess(heat.cpu(), dmap.cpu(), ex.to(cpu), opts)
            check(all(torch.equal(getattr(card_f, k).cpu(), getattr(cpu_f, k)) for k in ("uv", "response", "valid")),
                  f"{t.name}: CPU post-processing of the card's maps gives other features")
            desc_err = max(desc_err, float((card_d.cpu() - cpu_d).abs().max()))
        check(desc_err <= NN_DESC_ATOL, f"{t.name}: descriptors differ from the CPU's by {desc_err}")

        # The forward on the card against the CPU's on scene 0, once per model: float32 with TF32
        # off, and bfloat16 (the path's own maps, from the detector above).
        if family not in f32:
            card32 = NNFeaturePointDetector(opts, device=dev, dtype=torch.float32)
            cpu32 = NNFeaturePointDetector(opts, device="cpu", dtype=torch.float32)
            cpu16 = NNFeaturePointDetector(opts, device="cpu")
            card32.initialize()
            cpu32.initialize()
            cpu16.initialize()
            (gh, gd), (ch, cd) = card32.maps(frames[0]), cpu32.maps(scenes[0])
            f32[family] = {"heat_max_abs_err": float((gh.cpu() - ch).abs().max()),
                           "desc_max_abs_err": float((gd.cpu() - cd).abs().max())}
            check(f32[family]["heat_max_abs_err"] <= NN_F32_HEAT_ATOL and f32[family]["desc_max_abs_err"] <= NN_F32_DESC_ATOL,
                  f"{family}: float32 forward on the card differs from the CPU's: {f32[family]}")
            (gh, gd), (ch, cd) = det.maps(frames[0]), cpu16.maps(scenes[0])
            heat_atol, desc_atol = NN_BF16_ATOL[family]
            bf16[family] = {"heat_max_abs_err": float((gh.cpu() - ch).abs().max()),
                            "desc_max_abs_err": float((gd.cpu() - cd).abs().max()),
                            "heat_atol": heat_atol, "desc_atol": desc_atol}
            emit("nn_forward_vs_cpu", card=smi, model=family, float32=f32[family], bfloat16=bf16[family])
            check(bf16[family]["heat_max_abs_err"] <= heat_atol and bf16[family]["desc_max_abs_err"] <= desc_atol,
                  f"{family}: bfloat16 forward on the card differs from the CPU's: {bf16[family]}")
            del card32, cpu32, cpu16

        # Greedy kernel against its plain version on the path's candidate maps (not counted).
        def candidates(img):
            heat, dmap = det.maps(img)
            if t in NMS_TYPES:
                kpts, scores, _ = nms_head(heat, dmap, min_response=opts.min_response)
                return nms_candidates(kpts, scores, empty, opts, NN_ROWS, NN_COLS)[0]
            return heatmap_candidates(heat, empty, opts)

        cands = [candidates(f) for f in frames]
        for cand in cands[:2]:
            got = greedy_select(cand, cap, cap, r)
            torch.cuda.synchronize()
            want = greedy_select_ref(cand, cap, cap, r)
            check(all(torch.equal(g, w) for g, w in zip(got, want)), f"{t.name}: greedy kernel != plain on the NN map")
            k2["max_abs_err"] = max(k2["max_abs_err"], max_abs_err(torch, got, want))
        positives = [int((c > 0).sum()) for c in cands]
        cand0 = cands[0]

        # Float matching: scene 0 against its 3-column shift, and itself.
        fb, db = det.detect(shifted)
        m = match_float(da, fa.valid, db, fb.valid)
        n_match = int(m.count)
        check(n_match >= 5, f"{t.name}: {n_match} float matches between a frame and its shift")
        ok = m.valid
        moved = (fb.uv[m.index.clamp(min=0).long()] - fa.uv - torch.tensor([3.0, 0.0], device=dev)).abs().amax(1)
        describable = fa.valid & (da.norm(dim=1) > 0)
        me = match_float(da, describable, da, describable)
        self_ok = (torch.equal(me.valid, describable)
                   and torch.equal(me.index[describable], torch.arange(cap, device=dev, dtype=torch.int32)[describable])
                   and float(me.distance[describable].max()) <= NN_SELF_DIST)
        check(self_ok, f"{t.name}: self-match of every describable feature at cosine 1")

        # Times.
        heat0, dmap0 = det.maps(frames[0])
        x8 = torch.cat([det.preprocess(f) for f in frames])
        times = {
            "forward_ms": cuda_ms(torch, lambda: det.maps(frames[0]), 20),
            "postprocess_ms": cuda_ms(torch, lambda: postprocess(heat0, dmap0, empty, opts), 20),
            "greedy_ms": cuda_ms(torch, lambda: greedy_select(cand0, cap, cap, r), 50),
            "greedy_device_ms": device_ms(torch, lambda: greedy_select(cand0, cap, cap, r), GREEDY_KERNELS, 20),
            "greedy_plain_ms": cuda_ms(torch, lambda: greedy_select_ref(cand0, cap, cap, r), 2),
            "detect_ms_per_frame": cuda_ms(torch, lambda: [det.detect(f) for f in frames], 3) / len(frames),
            "match_float_ms_per_pair": cuda_ms(torch, lambda: match_float(da, fa.valid, db, fb.valid), 20),
        }
        with torch.no_grad():
            torch.cuda.reset_peak_memory_stats()
            times["forward_ms_b8"] = cuda_ms(torch, lambda: det.model(x8), 5)
            peak_b8_mib = torch.cuda.max_memory_allocated() / 2**20
        t0 = time.perf_counter()
        for f in frames:
            det.detect(f)
        torch.cuda.synchronize()
        times["detect_wall_ms_per_frame"] = (time.perf_counter() - t0) / len(frames) * 1e3
        # Where a detect call's device time goes; the rest of its time the card idles.
        per_kernel = kernel_times(torch, lambda: det.detect(frames[0]), 10)
        times["detect_device_busy_ms"] = sum(per_kernel.values())
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:NN_TOP_KERNELS]
        for key in ("ms", "device_ms", "plain_ms"):
            k2[key][t.name] = times["greedy_" + key]
        emit("nn", card=smi, model_type=t.name, rows=NN_ROWS, cols=NN_COLS, frames=len(frames), dtype="bfloat16",
             greedy_launches=launches, incremental_greedy_launches=2, features_per_frame=counts,
             features_per_frame_mean=float(np.mean(counts)), positive_candidates_per_frame=positives,
             positive_candidates_per_frame_mean=float(np.mean(positives)), incremental_existing=n,
             incremental_total=n_inc, cpu_postprocess_features_exact=True, cpu_postprocess_desc_max_abs_err=desc_err,
             f32_forward_vs_cpu=f32[family], bf16_forward_vs_cpu=bf16[family], greedy_exact_on_nn_maps=True, float_matches=n_match,
             float_matches_at_the_shift=int((ok & (moved <= 1.0)).sum()), self_matches=int(me.count),
             describable=int(describable.sum()), **times, detect_kernels_per_call=len(per_kernel),
             detect_top_kernels_ms=[[name[:90], ms] for name, ms in top], peak_memory_mib_detect=peak_mib,
             peak_memory_mib_forward_b8=peak_b8_mib)
        del det, outs, x8
        torch.cuda.empty_cache()
    k2["bound_ms"] = greedy_bound_ms(1, NN_ROWS, NN_COLS, NNDetectorOptions().max_number_of_detected_features)
    return k2


def vo_phase(torch, dev, smi):
    """The fused chunked VO on the card at the bench's size: one cold run
    (counted: two greedy launches a frame), timed runs with per-stage times,
    ATE, a profiler run (busy share, top kernels), the scan front-end on the
    card against the CPU's, K2 against its plain version on the VO's own
    candidate maps, the global BA problem solved on the card and on the CPU,
    the chunk solutions on both, and the RANSAC draws on both.  Emits one
    JSON line and returns K2's VO-path numbers and what phase ``multi``
    holds its VO and BA against."""
    import inspect

    from feature_detector_tpu_torch.core.config import BriefOptions, DetectorOptions, HarrisOptions
    from feature_detector_tpu_torch.core.types import Features
    from feature_detector_tpu_torch.frontend.detector import detection_maps
    from feature_detector_tpu_torch.kernels import fixed_order as FO
    from feature_detector_tpu_torch.kernels.detect import greedy_select_ref, harris_response_raw
    from feature_detector_tpu_torch.kernels.greedy import greedy_select
    from feature_detector_tpu_torch.slam import geometry
    from feature_detector_tpu_torch.slam.ba import BAProblem, ba_solve
    from feature_detector_tpu_torch.slam.evaluate import ate_rmse
    from feature_detector_tpu_torch.slam.sequence import (
        make_synthetic_sequence,
        run_visual_odometry_chunked,
        scan_frontend,
    )
    from feature_detector_tpu_torch.slam.vo_fused import run_visual_odometry_fused

    t0 = time.perf_counter()
    seq = make_synthetic_sequence(n_frames=VO_FRAMES, n_landmarks=VO_LANDMARKS, seed=VO_SEED, motion="lateral",
                                  angle_step=0.03)
    render_s = time.perf_counter() - t0
    imgs = torch.from_numpy(seq.images).to(dev)
    det = DetectorOptions(min_feature_distance=10, min_valid_response=20.0, max_features=256, subpixel=True)
    brief = BriefOptions(upright=True)  # the fused VO's defaults
    gt = seq.trajectory.positions
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))

    # Cold run, counted: every frame's top-up detection is one greedy call; the chunk solver's products, sums and
    # solves go through K4 and K5 (the largest call of each is kept for the kernel checks below).
    torch.cuda.synchronize()
    greedy_select.launches = FO.fixed_contract.launches = FO.fixed_lu_solve.launches = 0
    t0 = time.perf_counter()
    with largest_fixed_calls(torch) as fixed_calls, chunk_blocks() as blocks:
        res = run_visual_odometry_chunked(imgs, seq.cam)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = greedy_select.launches
    fixed_launches = {"contract": FO.fixed_contract.launches, "lu_solve": FO.fixed_lu_solve.launches}
    check(launches == 2 * VO_FRAMES, f"VO path launched the greedy kernels {launches} times, not 2 x {VO_FRAMES}")
    check(all(v > 0 for v in fixed_launches.values()), f"VO path launched K4/K5 {fixed_launches} times")
    pos = res.trajectory.positions
    check(len(res.trajectory) == VO_FRAMES and pos.shape == (VO_FRAMES, 3) and bool(np.isfinite(pos).all()),
          "VO trajectory: finite, one pose a frame")
    ate = float(ate_rmse(pos, gt, with_scale=True))
    check(ate <= VO_ATE_SPAN_SHARE * span, f"VO ATE {ate} m is over {VO_ATE_SPAN_SHARE:.0%} of the {span} m span")

    # Timed runs.
    runs = []
    for _ in range(VO_TIMED_RUNS):
        stages = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        r = run_visual_odometry_chunked(imgs, seq.cam, stage_seconds=stages)
        end.record()
        torch.cuda.synchronize()
        runs.append({"wall_s": time.perf_counter() - t0, "event_s": start.elapsed_time(end) / 1e3, "stages_s": stages,
                     "peak_memory_mib": torch.cuda.max_memory_allocated() / 2**20,
                     "ate_m": float(ate_rmse(r.trajectory.positions, gt, with_scale=True))})
    check(all(run["ate_m"] <= VO_ATE_SPAN_SHARE * span for run in runs), f"timed VO runs' ATE: {runs}")

    # One run under the profiler: the card's busy time against the run's event time.
    per_kernel, counts, prof_event_ms = profiled(torch, lambda: run_visual_odometry_chunked(imgs, seq.cam))
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:VO_TOP_KERNELS]
    check(busy_ms > 0, "the profiler saw no device time on the VO path")
    ours = lambda entry, name: any(k in name for k in FIXED_KERNELS[entry])
    fixed_run = {key: {"device_ms": sum(ms for name, ms in per_kernel.items() if ours(entry, name)),
                       "kernels": sum(n for name, n in counts.items() if ours(entry, name))}
                 for key, entry in (("contract", "fixed_contract"), ("lu_solve", "fixed_lu_solve"))}

    # The scan front-end on the card against the CPU's over the first frames.
    card_fe = scan_frontend(imgs[:VO_CHECK_FRAMES], "harris", 200, det, brief)
    cpu_fe = scan_frontend(seq.images[:VO_CHECK_FRAMES], "harris", 200, det, brief, device="cpu")
    raw = harris_response_raw(torch.from_numpy(seq.images[:VO_CHECK_FRAMES]).to(torch.float32), HarrisOptions()).numpy()
    (cf, cw, cv, cl), (pf, pw, pv, pl) = [(f, w.cpu().numpy(), v.cpu().numpy(), l.cpu().numpy()) for f, w, v, l in
                                          (card_fe, cpu_fe)]
    frames_equal, excused, first_diff = 0, 0, None
    for f in range(VO_CHECK_FRAMES):
        differ = ((cf.uv[f].cpu() != pf.uv[f]).any(-1) | (cf.response[f].cpu() != pf.response[f])
                  | (cf.valid[f].cpu() != pf.valid[f])).numpy() | (cw[f] != pw[f]).any(-1) | (cv[f] != pv[f])
        if f > 0:
            differ |= cl[f - 1] != pl[f - 1]
        if not differ.any():
            frames_equal += 1
            continue
        uv = np.concatenate([cf.uv[f].cpu().numpy()[differ], pf.uv[f].numpy()[differ]])
        x = np.clip(uv[:, 0].astype(np.int64), 0, raw.shape[2] - 1)
        y = np.clip(uv[:, 1].astype(np.int64), 0, raw.shape[1] - 1)
        near = np.abs(raw[f, y, x] - det.min_valid_response) <= VO_HARRIS_REL * det.min_valid_response
        check(bool(near.all()), f"VO scan front-end: frame {f} differs from the CPU at features off the threshold")
        excused, first_diff = int(differ.sum()), f
        break  # the carry step feeds every later frame from this one

    # K2 against its plain version on the VO's own candidate maps (not counted).
    saved = greedy_select.launches
    k2_err, k2_ms, k2_dev_ms, k2_plain_ms = 0.0, [], [], []
    for f in VO_K2_FRAMES:
        n_carried = int((card_fe[3][f - 1] >= 0).sum()) if f > 0 else 0
        keep = torch.arange(det.max_features, device=dev) < n_carried
        fr = card_fe[0]
        prefix = Features(fr.uv[f] * keep[:, None], fr.response[f] * keep, fr.valid[f] & keep)
        cand, _ = detection_maps(imgs[f], prefix, "harris", det)
        stop = torch.tensor([200 - n_carried], dtype=torch.int32, device=dev)
        got = greedy_select(cand, 200, stop, det.min_feature_distance)
        torch.cuda.synchronize()
        want = greedy_select_ref(cand, 200, stop, det.min_feature_distance)
        check(all(torch.equal(g, w) for g, w in zip(got, want)), f"greedy kernel != plain on VO frame {f}'s map")
        k2_err = max(k2_err, max_abs_err(torch, got, want))
        k2_ms.append(cuda_ms(torch, lambda: greedy_select(cand, 200, stop, det.min_feature_distance), 50))
        k2_dev_ms.append(device_ms(torch, lambda: greedy_select(cand, 200, stop, det.min_feature_distance),
                                   GREEDY_KERNELS, 20))
        k2_plain_ms.append(cuda_ms(torch, lambda: greedy_select_ref(cand, 200, stop, det.min_feature_distance), 2))
    greedy_select.launches = saved

    # The run's global BA problem solved on the card and on the CPU (float64 solves).
    prob = res.problem
    cpu_prob = BAProblem(*[x.cpu() for x in prob])
    ba_opts = inspect.signature(run_visual_odometry_fused).parameters["ba_opts"].default
    t0 = time.perf_counter()
    card_ba = ba_solve(prob, seq.cam, ba_opts)
    torch.cuda.synchronize()
    card_ba_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_ba = ba_solve(cpu_prob, seq.cam, ba_opts)
    cpu_ba_s = time.perf_counter() - t0
    centers = lambda p: -torch.einsum("fji,fj->fi", p.rot.cpu(), p.trans.cpu())
    ba_err = {
        "rot_max_abs_err": float((card_ba.rot.cpu() - cpu_ba.rot).abs().max()),
        "center_max_abs_err_over_span": float((centers(card_ba) - centers(cpu_ba)).abs().max()) / span,
    }
    has = (prob.obs_cam.cpu() >= 0).sum(1) >= 2
    ba_err["point_max_abs_err_over_span"] = float((card_ba.points.cpu() - cpu_ba.points)[has].abs().max()) / span
    ba_ok = (ba_err["rot_max_abs_err"] <= VO_BA_POSE_ATOL and ba_err["center_max_abs_err_over_span"] <= VO_BA_POSE_ATOL
             and ba_err["point_max_abs_err_over_span"] <= VO_BA_POINT_ATOL)

    # The card's chunk solutions against the CPU's: the chunk problems of the
    # card's own front-end, solved on both with the same draws; and on the
    # card in blocks against the whole batch.
    chunk_cmp = vo_chunks_card_vs_cpu(torch, dev, seq, imgs)

    # K4 and K5 against their plain versions on the VO's largest calls and on one call of every distinct
    # signature (not counted).
    fixed_entries, fixed_exact = fixed_kernel_entries(torch, fixed_calls, fixed_launches, "the fused VO's chunk solver")
    fixed_sigs = fixed_signature_checks(torch, fixed_calls["signatures"])

    # The RANSAC draws: CPU generator, copied to the card.
    draws_equal = all(torch.equal(geometry.ransac_gumbel(0, r, n, dev).cpu(), geometry.ransac_gumbel(0, r, n, "cpu"))
                      for r, n in ((48, det.max_features), (64, 512)))

    mean = lambda key: float(np.mean([run[key] for run in runs]))
    stage_means = {k: float(np.mean([run["stages_s"][k] for run in runs])) for k in runs[0]["stages_s"]}
    emit("vo", card=smi, frames=VO_FRAMES, rows=int(seq.images.shape[1]), cols=int(seq.images.shape[2]),
         landmarks=VO_LANDMARKS, seed=VO_SEED, render_s=render_s, cold_run_s=cold_s,
         frames_per_s_wall=VO_FRAMES / mean("wall_s"), frames_per_s_events=VO_FRAMES / mean("event_s"),
         runs=runs, stage_s_mean=stage_means, ate_m=ate, span_m=span, ate_share_of_span=ate / span,
         ate_share_of_span_library_solver=VO_ATE_SHARE_LIBRARY, chunk_blocks_cold_run=blocks,
         fixed_launches=fixed_launches, fixed_exact=fixed_exact, fixed_profiled_run=fixed_run,
         fixed_signatures=fixed_sigs,
         num_tracks=res.num_tracks, mean_track_length=res.mean_track_length, points=int(len(res.points)),
         global_ba_tracks_padded=int(prob.points.shape[0]), greedy_launches=launches,
         profiled_run_event_ms=prof_event_ms, device_busy_ms=busy_ms, device_busy_share=busy_ms / prof_event_ms,
         device_kernels=sum(counts.values()), top_kernels_ms=[[name[:90], ms, counts[name]] for name, ms in top],
         frontend_frames_checked=VO_CHECK_FRAMES, frontend_frames_equal=frames_equal,
         frontend_excused_near_threshold=excused, frontend_first_differing_frame=first_diff,
         k2_exact_on_vo_maps=list(VO_K2_FRAMES), global_ba_card_vs_cpu=ba_err,
         global_ba_tolerance={"pose": VO_BA_POSE_ATOL, "point": VO_BA_POINT_ATOL}, global_ba_card_s=card_ba_s,
         global_ba_cpu_s=cpu_ba_s, ransac_draws_equal=draws_equal, chunks_card_vs_cpu=chunk_cmp)
    check(ba_ok, f"global BA on the card differs from the CPU's: {ba_err}")
    check(draws_equal, "RANSAC draws differ between the card and the CPU")
    check(all(fixed_exact.values()), f"K4/K5 != plain on the VO's largest calls: {fixed_exact}")
    check_fixed_signatures(fixed_sigs, check, "the VO")
    check(all(chunk_cmp["chunk_blocks_equal"].values()),
          f"chunks solved in blocks differ from the whole batch: {chunk_cmp['chunk_blocks_equal']}")
    k2 = {"launches": launches, "max_abs_err": k2_err, "ms": float(np.mean(k2_ms)),
          "device_ms": float(np.mean(k2_dev_ms)), "plain_ms": float(np.mean(k2_plain_ms)),
          "bound_ms": greedy_bound_ms(1, int(seq.images.shape[1]), int(seq.images.shape[2]), 200),
          "maps": [f"frame {f}" for f in VO_K2_FRAMES]}
    run = {"seq": seq, "imgs": imgs, "result": res, "ate_m": ate, "span_m": span, "ba_opts": ba_opts,
           "global_ba_card": card_ba, "frames_per_s_wall": VO_FRAMES / mean("wall_s"),
           "chunk_solve_s": stage_means["chunk_solve"]}
    return k2, run, fixed_entries


@contextlib.contextmanager
def largest_fixed_calls(torch):
    """While open, the SLAM layer's K4 and K5 calls (``slam/fixed.py``) keep
    a copy of the operands of their largest call each: "contract" by
    multiply-adds, "sum" by terms, "lu_solve" by systems x n^3; and under
    "signatures", of the first call of every distinct (entry, shapes,
    strides), laid out as the call's own operands were.  Yields the dict
    they fill."""
    from feature_detector_tpu_torch.slam import fixed as SF

    kept = {"signatures": {}}
    names = {"contract": "fixed_contract", "sum": "fixed_sum", "lu_solve": "fixed_lu_solve"}
    work = {"contract": lambda a, c: math.prod(torch.broadcast_shapes(a.shape[:-2], c.shape[:-2])) * a.shape[-2]
            * a.shape[-1] * c.shape[-1],
            "sum": lambda x: x.numel(),
            "lu_solve": lambda a, b: math.prod(torch.broadcast_shapes(a.shape[:-2], b.shape[:-1])) * a.shape[-1] ** 3}
    saved = {key: getattr(SF, name) for key, name in names.items()}

    def spy(key):
        def call(*args):
            w = work[key](*args)
            if w > kept.get(key, (0,))[0]:
                kept[key] = (w, tuple(x.clone() for x in args))
            sig = (key, *((tuple(x.shape), tuple(x.stride())) for x in args))
            if sig not in kept["signatures"]:
                kept["signatures"][sig] = tuple(strided_copy(torch, x) for x in args)
            return saved[key](*args)
        return call

    for key, name in names.items():
        setattr(SF, name, spy(key))
    try:
        yield kept
    finally:
        for key, name in names.items():
            setattr(SF, name, saved[key])


def check_fixed_signatures(sigs: dict, expect, path: str) -> None:
    """Every replayed K4/K5 signature equal to its plain version, at most one
    K4/K5 kernel a call and no other kernel.  (The trace may drop a few
    kernels of a session, so it is held to at most one a call, and to some.)"""
    expect(sigs["exact"] == sigs["signatures"], f"K4/K5 != plain on {path}'s call signatures: {sigs['differing']}")
    expect(0 < sigs["fixed_kernels"] <= sigs["signatures"] and sigs["other_kernels"] == 0,
           f"K4/K5 wrappers on {path}'s signatures: {sigs['fixed_kernels']} kernels for {sigs['signatures']} calls, "
           f"others {sigs['other_kernel_names']}")


def strided_copy(torch, x):
    """A copy of ``x`` with its shape and strides (broadcast axes and gaps
    included): the span of storage it reads, cloned, viewed the same way."""
    if x.numel() == 0:
        return x.clone()
    span = 1 + sum((n - 1) * st for n, st in zip(x.shape, x.stride()))
    flat = x.as_strided((span,), (1,), x.storage_offset()).clone()
    return flat.as_strided(x.shape, x.stride(), 0)


def fixed_signature_checks(torch, signatures: dict) -> dict:
    """Replays one call of every distinct K4/K5 signature a run kept
    (``largest_fixed_calls``) through the wrappers, once each under
    torch.profiler, and holds each result against its plain version bit for
    bit.  Counts the CUDA kernels of the replay: one K4 or K5 kernel a call,
    and the others the wrappers launched (copies), which should be none.
    The launch counters are left as they were."""
    from feature_detector_tpu_torch.kernels import fixed_order as FO

    wrapper = {"contract": FO.fixed_contract, "sum": FO.fixed_sum, "lu_solve": FO.fixed_lu_solve}
    plain = {"contract": FO.contract_ref, "sum": FO.sum_ref, "lu_solve": FO.lu_solve_ref}
    saved = FO.fixed_contract.launches, FO.fixed_lu_solve.launches
    for sig, args in signatures.items():
        wrapper[sig[0]](*args)
    ours = tuple(k for names in FIXED_KERNELS.values() for k in names)
    count_ours = lambda counts: sum(n for name, n in counts.items() if any(k in name for k in ours))
    got = {}
    _, counts, _ = profiled(torch, lambda: got.update({sig: wrapper[sig[0]](*args) for sig, args in signatures.items()}),
                            complete=lambda counts: count_ours(counts) == len(signatures))
    fixed_kernels = count_ours(counts)
    others = {name[:90]: n for name, n in counts.items() if not any(k in name for k in ours)}
    differing = [str(sig) for sig, args in signatures.items() if not same_bits(torch, got[sig], plain[sig[0]](*args))]
    FO.fixed_contract.launches, FO.fixed_lu_solve.launches = saved
    by_entry = {key: sum(sig[0] == key for sig in signatures) for key in wrapper}
    return {"signatures": len(signatures), "by_entry": by_entry, "exact": len(signatures) - len(differing),
            "differing": differing[:8], "fixed_kernels": fixed_kernels, "other_kernels": sum(others.values()),
            "other_kernel_names": others}


@contextlib.contextmanager
def chunk_blocks():
    """While open, records how many chunk problems each call of the fused
    VO's ``solve_chunks`` is handed.  Yields the list."""
    from feature_detector_tpu_torch.slam import vo_fused

    solve, blocks = vo_fused.solve_chunks, []

    def counted(track_uv, *args, **kwargs):
        blocks.append(int(track_uv.shape[0]))
        return solve(track_uv, *args, **kwargs)

    vo_fused.solve_chunks = counted
    try:
        yield blocks
    finally:
        vo_fused.solve_chunks = solve


def same_bits(torch, got, want) -> bool:
    """Equal bit for bit (the sign of a zero included), a NaN equal to a NaN."""
    if got.shape != want.shape:
        return False
    return bool(((got.view(torch.int32) == want.view(torch.int32)) | (got.isnan() & want.isnan())).all())


def fixed_bound(nbytes: int, ops: int):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the float32 operations over its peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def traced_kernel_ms(torch, calls: dict, iters: int) -> dict:
    """For each name of ``calls`` (name -> (fn, kernel names)), the device
    time per call, in ms, of the CUDA kernels whose names contain one of its
    kernel names, from the raw trace of one torch.profiler session that
    makes ``iters`` calls of each fn in turn (``traced_device_ms``); None
    where the trace holds none of them."""
    for fn, _ in calls.values():
        fn()
    seen = lambda counts: all(sum(c for k, c in counts.items() if any(n in k for n in kernels)) >= iters
                              for _, kernels in calls.values())
    per_kernel, _, _ = profiled(torch, lambda: [fn() for fn, _ in calls.values() for _ in range(iters)],
                                complete=seen)
    out = {}
    for name, (_, kernels) in calls.items():
        total = sum(ms for k, ms in per_kernel.items() if any(n in k for n in kernels))
        out[name] = total / iters if total > 0 else None
    if None in out.values():
        print(f"chip_smoke: a kernel of {calls.keys()} is missing from the trace, which holds {sorted(per_kernel)[:8]}",
              file=sys.stderr, flush=True)
    return out


def fixed_kernel_entries(torch, calls: dict, launches: dict, path: str) -> tuple:
    """K4 and K5 against their plain versions, bit for bit, on the operands
    of the largest calls ``largest_fixed_calls`` kept on ``path``, and
    timed there (kernel, plain version, and one PyTorch call computing the
    same function as yardstick: ``torch.matmul``, ``torch.sum``,
    ``torch.linalg.solve_ex``; the port never calls them there); and on a
    rank's share of them (the first FIXED_RANK_SHARE problems).  Returns
    (the two kernel-line entries, whether every comparison held)."""
    from feature_detector_tpu_torch.kernels import fixed_order as FO

    a, c = calls["contract"][1]
    (x,) = calls["sum"][1]
    s, rhs = calls["lu_solve"][1]
    got, want = FO.fixed_contract(a, c), FO.contract_ref(a, c)
    got_sum, want_sum = FO.fixed_sum(x), FO.sum_ref(x)
    got_lu, want_lu = FO.fixed_lu_solve(s, rhs), FO.lu_solve_ref(s, rhs)
    torch.cuda.synchronize()
    exact = {"contract": same_bits(torch, got, want), "sum": same_bits(torch, got_sum, want_sum),
             "lu_solve": same_bits(torch, got_lu, want_lu)}
    err = lambda g, w: float((g - w).abs().nan_to_num(0.0).max()) if g.numel() else 0.0
    saved = FO.fixed_contract.launches, FO.fixed_lu_solve.launches
    batch = math.prod(torch.broadcast_shapes(a.shape[:-2], c.shape[:-2]))
    (m, k), n = a.shape[-2:], c.shape[-1]
    k4_ops = 2 * batch * m * n * k
    k4_bound = fixed_bound(4 * (a.numel() + c.numel() + got.numel()), k4_ops)
    n_sys, n_lu = math.prod(torch.broadcast_shapes(s.shape[:-2], rhs.shape[:-1])), s.shape[-1]
    k5_bound = fixed_bound(4 * (s.numel() + rhs.numel() + got_lu.numel()), n_sys * (2 * n_lu ** 3 // 3 + 2 * n_lu ** 2))
    lib_solve = lambda: torch.linalg.solve_ex(s, rhs[..., None])
    dev_ms = traced_kernel_ms(torch, {"contract": (lambda: FO.fixed_contract(a, c), FIXED_KERNELS["fixed_contract"]),
                                      "lu_solve": (lambda: FO.fixed_lu_solve(s, rhs), FIXED_KERNELS["fixed_lu_solve"])},
                              10)
    # A rank's share on four cards: the first FIXED_RANK_SHARE problems, laid out as the whole call's.
    share = FIXED_RANK_SHARE
    k4_batch, k5_batch = torch.broadcast_shapes(a.shape[:-2], c.shape[:-2]), torch.broadcast_shapes(s.shape[:-2],
                                                                                                    rhs.shape[:-1])
    a_r = a.expand(*k4_batch, m, k).flatten(0, -3)[:share]
    c_r = c.expand(*k4_batch, k, n).flatten(0, -3)[:share]
    s_r = s.expand(*k5_batch, n_lu, n_lu).flatten(0, -3)[:share]
    rhs_r = rhs.expand(*k5_batch, n_lu).flatten(0, -2)[:share]
    share_exact = (same_bits(torch, FO.fixed_contract(a_r, c_r), FO.contract_ref(a_r, c_r))
                   and same_bits(torch, FO.fixed_lu_solve(s_r, rhs_r), FO.lu_solve_ref(s_r, rhs_r)))
    exact["rank_share"] = share_exact
    k4 = {"name": "fixed_contract (K4)", "route": "cuda", "source": FIXED_SOURCE, "replaces": FIXED_REPLACES,
          "launches": launches["contract"], "max_abs_err": max(err(got, want), err(got_sum, want_sum)),
          "ms": cuda_ms(torch, lambda: FO.fixed_contract(a, c), 20),
          "device_ms": dev_ms["contract"],
          "plain_ms": cuda_ms(torch, lambda: FO.contract_ref(a, c), 3),
          "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
          "library_ms": cuda_ms(torch, lambda: torch.matmul(a, c), 20),
          "no_fma_bound_ms": 1e3 * k4_ops / PEAK_F32_SEPARATE_OPS_PER_S,
          "shape": {"a": list(a.shape), "c": list(c.shape)}, "strides": {"a": list(a.stride()), "c": list(c.stride())},
          "path": path,
          "rank_share": {"problems": share, "ms": cuda_ms(torch, lambda: FO.fixed_contract(a_r, c_r), 20),
                         "library_ms": cuda_ms(torch, lambda: torch.matmul(a_r, c_r), 20),
                         "bound_ms": fixed_bound(4 * (a_r.numel() + c_r.numel() + share * m * n),
                                                 2 * share * m * n * k)[0]},
          "largest_sum": {"shape": list(x.shape), "ms": cuda_ms(torch, lambda: FO.fixed_sum(x), 20),
                          "plain_ms": cuda_ms(torch, lambda: FO.sum_ref(x), 3),
                          "library_ms": cuda_ms(torch, lambda: x.sum(-1), 20),
                          "bound_ms": fixed_bound(4 * (x.numel() + got_sum.numel()), x.numel())[0]}}
    k5 = {"name": "fixed_lu_solve (K5)", "route": "cuda", "source": FIXED_SOURCE, "replaces": FIXED_REPLACES,
          "launches": launches["lu_solve"], "max_abs_err": err(got_lu, want_lu),
          "ms": cuda_ms(torch, lambda: FO.fixed_lu_solve(s, rhs), 20),
          "device_ms": dev_ms["lu_solve"],
          "plain_ms": cuda_ms(torch, lambda: FO.lu_solve_ref(s, rhs), 2),
          "bound_ms": k5_bound[0], "bound_by": k5_bound[1], "library_ms": cuda_ms(torch, lib_solve, 20),
          "shape": {"a": list(s.shape), "b": list(rhs.shape)}, "path": path,
          "rank_share": {"systems": share, "ms": cuda_ms(torch, lambda: FO.fixed_lu_solve(s_r, rhs_r), 20),
                         "library_ms": cuda_ms(torch, lambda: torch.linalg.solve_ex(s_r, rhs_r[..., None]), 20)},
          "note": "latency-bound: n dependent pivot steps, each a 64-bit key reduction and one block barrier"}
    FO.fixed_contract.launches, FO.fixed_lu_solve.launches = saved
    return (k4, k5), exact


def vo_chunk_starts() -> list:
    """The fused VO's chunk starts on the bench sequence (default chunk and
    overlap): 17 chunks at 120 frames."""
    import inspect

    from feature_detector_tpu_torch.slam.vo_fused import chunk_starts, run_visual_odometry_fused

    d = {k: v.default for k, v in inspect.signature(run_visual_odometry_fused).parameters.items()}
    return chunk_starts(VO_FRAMES, d["chunk"], d["overlap"])


def vo_chunk_problems(torch, seq, imgs) -> tuple:
    """The fused VO's chunk problems (default options) from the scan
    front-end on ``imgs``' device: (track_uv, track_has, the remaining
    arguments of ``solve_chunks``, the chunk starts, the chunk length)."""
    import inspect

    from feature_detector_tpu_torch.core.config import DetectorOptions
    from feature_detector_tpu_torch.slam.sequence import build_tracks_conflict_free, scan_frontend
    from feature_detector_tpu_torch.slam.vo_fused import (
        chunk_problems,
        chunk_starts,
        match_and_gate,
        match_offsets_for,
        run_visual_odometry_fused,
    )

    d = {k: v.default for k, v in inspect.signature(run_visual_odometry_fused).parameters.items()}
    det = DetectorOptions(min_feature_distance=10, min_valid_response=20.0, max_features=256, subpixel=True)
    n = len(seq.images)
    feats, words, dvalid, links = scan_frontend(imgs, d["detector_kind"], d["needed_features"], det,
                                                d["brief_opts"])
    uv_np = feats.uv.cpu().numpy()
    pairs = match_and_gate(words, dvalid, uv_np, feats.valid.cpu().numpy(), links.cpu().numpy(), seq.cam,
                           d["match_opts"], match_offsets_for(n))
    tracks = build_tracks_conflict_free(pairs, n, det.max_features)
    starts = chunk_starts(n, d["chunk"], d["overlap"])
    track_uv, track_has = chunk_problems(tracks, uv_np, starts, d["chunk"], d["max_tracks_per_chunk"])
    args = (seq.cam, d["min_corr"], d["n_rounds"], d["chunk_ba_opts"], d["gate_px"])
    return track_uv, track_has, args, starts, d["chunk"]


def chunk_agreement(seq, starts, chunk: int, a, b) -> list:
    """The card's and the CPU's chunk solutions (numpy tuples from
    ``solve_chunks``) on the same problems, per chunk: has_pt, ok and the chosen init pair
    equal, and the largest differences of rotations, camera centers and
    points, the last two over the chunk's largest center distance (each
    solution is up to its monocular scale), and each solution's ATE
    against the ground truth over the chunk's span."""
    from feature_detector_tpu_torch.slam.evaluate import ate_rmse

    centers = lambda r, t: -np.einsum("kfji,kfj->kfi", r, t)
    ca, cb = centers(a[0], a[1]), centers(b[0], b[1])
    per_chunk = []
    for k in range(len(starts)):
        sa, sb = np.linalg.norm(ca[k], axis=1).max(), np.linalg.norm(cb[k], axis=1).max()
        hp = b[3][k] & a[3][k]
        rot = float(np.abs(a[0][k] - b[0][k]).max())
        cen = float(np.abs(ca[k] / sa - cb[k] / sb).max())
        pts = float(np.abs(a[2][k][hp] / sa - b[2][k][hp] / sb).max()) if hp.any() else 0.0
        same = bool((a[3][k] == b[3][k]).all() and a[4][k] == b[4][k] and a[5][k] == b[5][k])
        within = same and rot <= VO_CHUNK_ROT_ATOL and cen <= VO_CHUNK_CENTER_ATOL and pts <= VO_CHUNK_POINT_ATOL
        # Each solution's own error: Sim(3)-aligned RMSE of its centers against the ground truth, over the
        # chunk's span.
        gt = seq.trajectory.positions[starts[k]:starts[k] + chunk]
        gt_span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
        ate = lambda c: float(ate_rmse(c, gt, with_scale=True)) / gt_span
        per_chunk.append({"chunk": k, "same_points_ok_init_pair": same, "same_ok": bool(a[4][k] == b[4][k]),
                          "rot": rot, "center_over_scale": cen, "point_over_scale": pts, "within": within,
                          "card_ate_over_span": ate(ca[k]), "cpu_ate_over_span": ate(cb[k])})
    return per_chunk


def vo_chunks_card_vs_cpu(torch, dev, seq, imgs) -> dict:
    """The fused VO's chunk problems, from the card's scan front-end, solved
    by ``solve_chunks`` on the card and on the CPU (the same RANSAC draws:
    CPU generator), held chunk by chunk (``chunk_agreement``).  A
    measurement of where the card's run and the CPU's part, not a check:
    the chunk solver runs in float32, and a few chunks of this sequence
    sit between two basins.  Then on the card in blocks of each
    VO_CHUNK_BLOCKS size against the whole batch (``chunk_blocks_equal``,
    which the caller checks)."""
    from feature_detector_tpu_torch.slam.vo_fused import solve_chunks

    track_uv, track_has, args, starts, chunk = vo_chunk_problems(torch, seq, imgs)
    t0 = time.perf_counter()
    card = [x.cpu().numpy() for x in solve_chunks(torch.from_numpy(track_uv).to(dev),
                                                  torch.from_numpy(track_has).to(dev), *args)]
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = [x.numpy() for x in solve_chunks(torch.from_numpy(track_uv), torch.from_numpy(track_has), *args)]
    cpu_s = time.perf_counter() - t0
    per_chunk = chunk_agreement(seq, starts, chunk, card, cpu)
    # The same problems on the card in blocks (padded with empty problems to a multiple of the block, as the
    # mesh pads them), against the whole batch, bit for bit.
    tu, th = torch.from_numpy(track_uv).to(dev), torch.from_numpy(track_has).to(dev)
    blocks_equal, block_s = {}, {}
    for block in VO_CHUNK_BLOCKS:
        pad = -len(tu) % block
        pu = torch.cat([tu, tu.new_zeros((pad, *tu.shape[1:]))])
        ph = torch.cat([th, th.new_zeros((pad, *th.shape[1:]))])
        t0 = time.perf_counter()
        parts = [solve_chunks(pu[i:i + block], ph[i:i + block], *args) for i in range(0, len(pu), block)]
        got = [torch.cat(p)[:len(tu)].cpu().numpy() for p in zip(*parts)]
        block_s[block] = time.perf_counter() - t0
        blocks_equal[block] = all(np.array_equal(g, w, equal_nan=g.dtype.kind == "f") for g, w in zip(got, card))
    return {"chunks": len(per_chunk), "within": sum(c["within"] for c in per_chunk),
            "tolerance": {"rot": VO_CHUNK_ROT_ATOL, "center": VO_CHUNK_CENTER_ATOL, "point": VO_CHUNK_POINT_ATOL},
            "card_solve_s": card_s, "cpu_solve_s": cpu_s, "per_chunk": per_chunk,
            "chunk_blocks_equal": blocks_equal, "chunk_block_solve_s": block_s}


def multi_phase(torch, dev, smi, main: dict, vo: dict):
    """The multi-device paths on an NCCL world of one, started in this
    process: the frame-parallel front-end and two-frame matcher on the main
    path's frames (K1, counted), the row-sharded Harris response on one
    frame, the distributed BA on the VO's global problem (dense and
    camera-sharded), and the VO over the mesh (K2, counted), each held
    against the one-device result of the phases before; K1 and K2 against
    their plain version on this path's maps.  Emits one JSON line and
    returns K1's and K2's numbers on this path."""
    import torch.distributed as dist

    from feature_detector_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    mesh = make_mesh(device="cuda")  # no process group yet: a world of one over NCCL
    try:
        return _multi_paths(torch, dev, smi, mesh, main, vo, t_phase)
    finally:
        dist.destroy_process_group()


def _multi_paths(torch, dev, smi, mesh, main: dict, vo: dict, t_phase: float):
    import torch.distributed as dist

    from feature_detector_tpu_torch.core.config import BAOptions, DetectorOptions
    from feature_detector_tpu_torch.core.types import Features
    from feature_detector_tpu_torch.frontend.detector import detection_maps
    from feature_detector_tpu_torch.kernels import fixed_order as FO
    from feature_detector_tpu_torch.kernels.detect import (
        fast_candidates,
        fast_response,
        greedy_select_ref,
        harris_response,
    )
    from feature_detector_tpu_torch.kernels.greedy import greedy_select
    from feature_detector_tpu_torch.parallel.frontend import (
        make_batched_frontend,
        make_row_sharded_response,
        make_two_frame_matcher,
    )
    from feature_detector_tpu_torch.parallel.mesh import make_mesh, shard_leading
    from feature_detector_tpu_torch.slam.ba import make_distributed_ba, reprojection_cost
    from feature_detector_tpu_torch.slam.evaluate import ate_rmse
    from feature_detector_tpu_torch.slam.sequence import run_visual_odometry_chunked

    backend, world = dist.get_backend(), dist.get_world_size()
    check(backend == "nccl" and world == 1, f"multi phase: a {backend} world of {world}, not NCCL of one")
    ja, jb, opts, bopts, mopts = main["ja"], main["jb"], main["opts"], main["bopts"], main["mopts"]
    picks = opts.max_features
    out = {"card": smi, "backend": backend, "world": world}

    # Frame-parallel detect + describe (K1, counted), against the main path's batch on the card.
    frontend = make_batched_frontend(mesh, "fast", picks, opts, brief_opts=bopts)
    torch.cuda.synchronize()
    greedy_select.launches = 0
    feats, words, dvalid = frontend(ja)
    torch.cuda.synchronize()
    k1_frontend = greedy_select.launches
    check(k1_frontend == 2, f"batched front-end launched the greedy kernels {k1_frontend} times, not 2")
    fa, da = main["fa"], main["da"]
    check(all(torch.equal(g, w) for g, w in ((feats.uv, fa.uv), (feats.response, fa.response), (feats.valid, fa.valid),
                                           (words, da.words), (dvalid, da.valid))),
          "batched front-end over the mesh differs from the main path's batch")
    out["batched_frontend_ms"] = cuda_ms(torch, lambda: frontend(ja), 5)

    # Two-frame matcher (K1, counted): features and matches equal to the main path's.
    matcher = make_two_frame_matcher(mesh, "fast", picks, opts, brief_opts=bopts, matcher_opts=mopts)
    torch.cuda.synchronize()
    greedy_select.launches = 0
    ma_f, mb_f, mm = matcher(ja, jb)
    torch.cuda.synchronize()
    k1_matcher = greedy_select.launches
    check(k1_matcher == 4, f"two-frame matcher launched the greedy kernels {k1_matcher} times, not 2 x 2")
    m, fb = main["m"], main["fb"]
    check(torch.equal(ma_f.uv, fa.uv) and torch.equal(mb_f.uv, fb.uv) and torch.equal(mb_f.valid, fb.valid),
          "two-frame matcher's features differ from the main path's")
    check(all(torch.equal(getattr(mm, k), getattr(m, k)) for k in ("index", "distance", "valid")),
          "two-frame matcher's matches differ from the main path's")
    out["two_frame_matcher_ms"] = cuda_ms(torch, lambda: matcher(ja, jb), 5)
    out["matches_per_pair"] = float(mm.valid.sum(1).float().mean())

    # K1 against its plain version on this path's maps (this rank's block; not counted).
    ones = torch.ones(ja.shape[1:], dtype=torch.int32, device=dev)
    cand = fast_candidates(fast_response(shard_leading(ja, mesh, "data"), ones), opts.min_valid_response)
    got = greedy_select(cand, picks, picks, opts.min_feature_distance)
    torch.cuda.synchronize()
    want = greedy_select_ref(cand, picks, picks, opts.min_feature_distance)
    check(all(torch.equal(g, w) for g, w in zip(got, want)), "K1 != plain on the batched front-end's maps")
    k1_err = max_abs_err(torch, got, want)

    # Row-sharded Harris on one frame against the whole-frame response.
    space = make_mesh((1,), ("space",), device="cuda")
    ropts = DetectorOptions(min_valid_response=30.0)
    rows = make_row_sharded_response(space, "harris", ropts)
    frame, fmask = ja[0], torch.ones(ja.shape[1:], dtype=torch.int32, device=dev)
    check(torch.equal(rows(frame, fmask), harris_response(frame, fmask, ropts)),
          "row-sharded Harris differs from harris_response")
    out["row_sharded_harris_ms"] = cuda_ms(torch, lambda: rows(frame, fmask), 20)
    out["harris_response_ms"] = cuda_ms(torch, lambda: harris_response(frame, fmask, ropts), 20)

    # The distributed BA on the VO's global problem against ba_solve on the card.
    seq, prob, ba_opts, span = vo["seq"], vo["result"].problem, vo["ba_opts"], vo["span_m"]
    card_ba = vo["global_ba_card"]
    has = (prob.obs_cam >= 0).sum(1) >= 2
    cost = lambda p: float(reprojection_cost(p, seq.cam, BAOptions(huber_delta=1e9)))
    ba = {}
    for form, solver in (("dense", make_distributed_ba(mesh, seq.cam, ba_opts)),
                         ("camera_shard", make_distributed_ba(mesh, seq.cam, ba_opts, camera_shard=True))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solver(prob)
        torch.cuda.synchronize()
        ba[form] = {"seconds": time.perf_counter() - t0, **ba_agreement(torch, sol, card_ba, span, has, cost)}
    ba["tolerance"] = {"dense": MULTI_BA_DENSE_ATOL, "camera_shard": MULTI_BA_CG_TOL}
    out["global_ba"] = ba
    check(dense_ba_ok(ba["dense"]), f"distributed BA (dense) differs from ba_solve on the card: {ba['dense']}")
    check(cg_ba_ok(ba["camera_shard"]),
          f"distributed BA (camera-sharded) parts from ba_solve on the card: {ba['camera_shard']}")

    # The VO over the mesh (K2, K4 and K5 counted) against phase vo's run: the chunk batch split over the
    # mesh (a world of one: one block of every chunk).
    imgs = vo["imgs"]
    torch.cuda.synchronize()
    greedy_select.launches = FO.fixed_contract.launches = FO.fixed_lu_solve.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    stages = {}
    t0 = time.perf_counter()
    start.record()
    with chunk_blocks() as blocks:
        res = run_visual_odometry_chunked(imgs, seq.cam, mesh=mesh, stage_seconds=stages)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    k2_vo = greedy_select.launches
    fixed_vo = {"contract": FO.fixed_contract.launches, "lu_solve": FO.fixed_lu_solve.launches}
    n_chunks = len(vo_chunk_starts())
    check(k2_vo == 2 * VO_FRAMES, f"VO over the mesh launched the greedy kernels {k2_vo} times, not 2 x {VO_FRAMES}")
    pos, want_pos = res.trajectory.positions, vo["result"].trajectory.positions
    check(pos.shape == want_pos.shape and bool(np.isfinite(pos).all()), "VO over the mesh: finite, one pose a frame")
    gt = seq.trajectory.positions
    ate = float(ate_rmse(pos, gt, with_scale=True))
    pos_err = float(np.abs(pos - want_pos).max()) / span
    out["vo"] = {"frames_per_s_wall": VO_FRAMES / wall_s,
                 "frames_per_s_events": VO_FRAMES / (start.elapsed_time(end) / 1e3),
                 "phase_vo_frames_per_s_wall": vo["frames_per_s_wall"], "ate_m": ate, "phase_vo_ate_m": vo["ate_m"],
                 "ate_share_of_span": ate / span, "position_max_abs_err_over_span": pos_err,
                 "tolerance_over_span": MULTI_VO_POS_ATOL, "greedy_launches": k2_vo,
                 "bitwise": bool(np.array_equal(pos, want_pos)), "chunk_blocks": blocks, "chunks": n_chunks,
                 "chunk_solve_s": stages["chunk_solve"], "phase_vo_chunk_solve_s": vo["chunk_solve_s"],
                 "fixed_launches": fixed_vo}
    check(pos_err <= MULTI_VO_POS_ATOL, f"VO over the mesh parts from phase vo's run by {pos_err} of the span")
    check(out["vo"]["bitwise"], "VO over the mesh differs from phase vo's run")
    check(blocks == [n_chunks], f"VO over a mesh of one: chunk blocks {blocks}, not [{n_chunks}]")
    check(all(v > 0 for v in fixed_vo.values()), f"VO over the mesh launched K4/K5 {fixed_vo} times")
    check(f"{ate:.4f}" == f"{vo['ate_m']:.4f}", f"VO over the mesh: ATE {ate:.4f} m, phase vo {vo['ate_m']:.4f} m")

    # K2 against its plain version on the VO's first top-up map (not counted).
    det = DetectorOptions(min_feature_distance=10, min_valid_response=20.0, max_features=256, subpixel=True)
    cand2, _ = detection_maps(imgs[0], Features.empty(det.max_features, dev), "harris", det)
    got = greedy_select(cand2, 200, 200, det.min_feature_distance)
    torch.cuda.synchronize()
    want = greedy_select_ref(cand2, 200, 200, det.min_feature_distance)
    check(all(torch.equal(g, w) for g, w in zip(got, want)), "K2 != plain on the VO's frame-0 map")
    k2_err = max_abs_err(torch, got, want)

    out["seconds"] = time.perf_counter() - t_phase
    emit("multi", greedy_launches_batched_frontend=k1_frontend, greedy_launches_two_frame_matcher=k1_matcher, **out)
    return ({"launches_batched_frontend": k1_frontend, "launches_two_frame_matcher": k1_matcher, "max_abs_err": k1_err},
            {"launches_vo_over_mesh": k2_vo, "max_abs_err": k2_err}, fixed_vo)


def _render_batch(job):
    """One training batch (``make_batch``), in a worker process: job =
    (model index, batch index, batch, rows, cols, rich background)."""
    from feature_detector_tpu_torch.models.synth_data import make_batch

    k, i, batch, rows, cols, rich = job
    return make_batch(np.random.default_rng([TRAIN_SEED, k, i]), batch, rows, cols, rich_background=rich)


def render_training_batches() -> dict:
    """TRAIN_WARMUP + TRAIN_STEPS batches per model, rendered by a pool of
    worker processes (the host's numpy rendering takes about 20 s of one
    core).  The pool runs inside phase ``train`` alone, so that it takes no
    host time from the earlier phases' measurements."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    jobs = [(k, i, cfg["batch"], cfg["rows"], cfg["cols"], cfg["rich_background"])
            for k, cfg in enumerate(TRAIN_MODELS.values()) for i in range(TRAIN_WARMUP + TRAIN_STEPS)]
    with ProcessPoolExecutor(min(8, os.cpu_count() or 1), mp_context=multiprocessing.get_context("spawn")) as pool:
        out = list(pool.map(_render_batch, jobs))
    n = TRAIN_WARMUP + TRAIN_STEPS
    return {name: out[k * n:(k + 1) * n] for k, name in enumerate(TRAIN_MODELS)}


def conv_step_flop(torch, model, batch: int, channels: int, rows: int, cols: int) -> float:
    """Floating-point operations of the convolutions in one training step:
    the forward of both frames of ``batch`` samples (2 x in_channels x
    kernel area per output element, counted by forward hooks), times 3 for
    the backward's input and weight gradients."""
    total = [0]

    def hook(mod, inp, out):
        total[0] += 2 * out.numel() * mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            model(torch.zeros((batch, channels, rows, cols), device=next(model.parameters()).device))
    finally:
        for h in handles:
            h.remove()
    return 3.0 * 2 * total[0]


def train_model(torch, dev, name: str, batches: list) -> tuple:
    """One model of phase ``train``: the float32 first step on the card
    against the CPU's, then TRAIN_WARMUP + TRAIN_STEPS bfloat16 steps
    timed by CUDA events, and one profiled step.  Returns (its JSON fields,
    the trained model)."""
    from feature_detector_tpu_torch.models import train_disk, train_superpoint
    from feature_detector_tpu_torch.models.disk import Disk, normalised_biases
    from feature_detector_tpu_torch.models.superpoint import SuperPoint
    from feature_detector_tpu_torch.models.weights import init_state

    cls, module = {"superpoint": (SuperPoint, train_superpoint), "disk": (Disk, train_disk)}[name]
    cfg = TRAIN_MODELS[name]

    # The float32 first step on the card (TF32 off) and on the CPU: same parameters, same frames.
    check_batch = {k: v[:TRAIN_CHECK_FRAMES] for k, v in batches[0].items()}
    f32 = {}
    for where, device in (("cpu", "cpu"), ("card", dev)):
        m = init_state(cls(dtype=torch.float32), torch.Generator().manual_seed(TRAIN_SEED)).to(device)
        loss, aux = module.make_train_step(m, train_superpoint.adam(m, TRAIN_LR))(check_batch)
        f32[where] = {"loss": float(loss), "det": float(aux["det"]), "desc": float(aux["desc"]),
                      "grad_norms": {n: float(p.grad.norm()) for n, p in m.named_parameters()},
                      "numel": {n: p.numel() for n, p in m.named_parameters()}}
    zero = normalised_biases(m) if name == "disk" else set()
    total = float(np.sqrt(sum(v * v for v in f32["cpu"]["grad_norms"].values())))
    worst = {"loss_rel": 0.0, "grad_norm_excess": -1.0}
    for key in ("loss", "det", "desc"):
        rel = abs(f32["card"][key] - f32["cpu"][key]) / abs(f32["cpu"][key])
        worst["loss_rel"] = max(worst["loss_rel"], rel)
        check(rel <= TRAIN_LOSS_RTOL, f"{name}: the card's float32 {key} {f32['card'][key]} against the CPU's "
              f"{f32['cpu'][key]}")
    for n, want in f32["cpu"]["grad_norms"].items():
        got = f32["card"]["grad_norms"][n]
        if n in zero:
            check(max(got, want) <= TRAIN_ZERO_GRAD_SHARE * total, f"{name}: {n}'s gradient is 0 in exact "
                  f"arithmetic, read {got} (card) and {want} (CPU) against a total norm of {total}")
            continue
        tol = TRAIN_GRAD_RTOL * want + TRAIN_GRAD_ATOL * np.sqrt(f32["cpu"]["numel"][n])
        worst["grad_norm_excess"] = max(worst["grad_norm_excess"], abs(got - want) - tol)
        check(abs(got - want) <= tol, f"{name}: gradient norm of {n}: card {got}, CPU {want}")

    # bfloat16 training, the JAX package's train() widths.
    model = init_state(cls(dtype=torch.bfloat16), torch.Generator().manual_seed(TRAIN_SEED)).to(dev)
    step = module.make_train_step(model, train_superpoint.adam(model, TRAIN_LR))
    losses = [step(b)[0] for b in batches[:TRAIN_WARMUP]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = []
    for b in batches[TRAIN_WARMUP:]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(b)[0])
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    step_ms = [s.elapsed_time(e) for s, e in events]
    losses = [float(x) for x in losses]
    check(bool(np.isfinite(losses).all()), f"{name}: non-finite training loss {losses}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last5 < first5, f"{name}: the mean of the last 5 losses {last5} is not below the first 5's {first5}")

    # One step under the profiler: the kernels a step runs and the card's busy share.
    step_ms_by_kernel, step_counts, event_ms = profiled(torch, lambda: step(batches[-1]))
    per_kernel = {k: (ms, step_counts[k]) for k, ms in step_ms_by_kernel.items() if ms > 0}
    busy_ms = sum(ms for ms, _ in per_kernel.values())
    check(busy_ms > 0, f"{name}: the profiler saw no device time in a training step")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:TRAIN_TOP_KERNELS]
    mean_ms = float(np.mean(step_ms))
    flop = conv_step_flop(torch, model, cfg["batch"], 1 if name == "superpoint" else 3, cfg["rows"], cfg["cols"])
    bound_ms = 1e3 * flop / PEAK_BF16_OPS_PER_S
    fields = dict(device_busy_share_of_mean_step=busy_ms / mean_ms, step_conv_tflop=flop / 1e12,
                  step_bound_ms=bound_ms, step_bound_by="operations", step_bound_share=bound_ms / mean_ms,model=name, batch=cfg["batch"], rows=cfg["rows"], cols=cfg["cols"], dtype="bfloat16",
                  steps_timed=len(step_ms), warmup_steps=TRAIN_WARMUP, step_ms_mean=mean_ms,
                  step_ms_median=float(np.median(step_ms)), step_ms_min=float(np.min(step_ms)),
                  step_ms_max=float(np.max(step_ms)), samples_per_s=cfg["batch"] / (mean_ms / 1e3),
                  peak_memory_mib=peak_mib, loss_first=losses[0], loss_last=losses[-1],
                  loss_mean_first5=first5, loss_mean_last5=last5, losses=losses,
                  profiled_step_event_ms=event_ms, device_busy_ms=busy_ms, device_busy_share=busy_ms / event_ms,
                  kernels_per_step=sum(c for _, c in per_kernel.values()),
                  top_kernels_ms=[[k[:90], ms, c] for k, (ms, c) in top],
                  f32_check_frames=TRAIN_CHECK_FRAMES, f32_loss_card=f32["card"]["loss"], f32_loss_cpu=f32["cpu"]["loss"],
                  f32_loss_max_rel_diff=worst["loss_rel"], f32_grad_norm_max_excess=worst["grad_norm_excess"],
                  f32_zero_gradient_params=len(zero))
    return fields, model


def _dp_step(torch, dev, state: dict, batch: dict, mesh):
    """One bfloat16 SuperPoint step from ``state`` with a fresh Adam, with or
    without ``mesh``: (loss, det, desc, parameters, gradients)."""
    from feature_detector_tpu_torch.models.superpoint import SuperPoint
    from feature_detector_tpu_torch.models.train_superpoint import adam, make_train_step

    m = SuperPoint(dtype=torch.bfloat16).to(dev)
    m.load_state_dict(state)
    loss, aux = make_train_step(m, adam(m, TRAIN_LR), mesh=mesh)(batch)
    return ([loss, aux["det"], aux["desc"]], {n: p.detach().clone() for n, p in m.named_parameters()},
            {n: p.grad.clone() for n, p in m.named_parameters()})


def resilient_run(torch, dev, state: dict, batches: list, ckpt_dir: str) -> dict:
    """A ResilientLoop of RESILIENT_STEPS SuperPoint steps whose step
    RESILIENT_NAN_STEP, the first time, sees a frame of NaN: the window
    turns non-finite, rolls back to its checkpoint and replays."""
    import copy

    from feature_detector_tpu_torch.models.superpoint import SuperPoint
    from feature_detector_tpu_torch.models.train_superpoint import adam, make_train_step
    from feature_detector_tpu_torch.utils.checkpoint import CheckpointManager
    from feature_detector_tpu_torch.utils.recovery import ResilientLoop

    model = SuperPoint(dtype=torch.bfloat16).to(dev)
    model.load_state_dict(state)
    opt = adam(model, TRAIN_LR)
    step = make_train_step(model, opt)
    poisoned = []

    def step_fn(st, s):
        model.load_state_dict(st["model"])
        opt.load_state_dict(st["opt"])
        b = batches[s % len(batches)]
        if s == RESILIENT_NAN_STEP and not poisoned:
            poisoned.append(s)
            b = {**b, "image": np.full_like(b["image"], np.nan)}
        step(b)
        return {"model": {k: v.detach().clone() for k, v in model.state_dict().items()},
                "opt": copy.deepcopy(opt.state_dict())}

    init = {"model": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "opt": copy.deepcopy(opt.state_dict())}
    loop = ResilientLoop(ckpt_dir, save_every=RESILIENT_SAVE_EVERY, max_retries=2)
    t = time.perf_counter()
    final = loop.run(init, step_fn, RESILIENT_STEPS)
    seconds = time.perf_counter() - t
    restored = CheckpointManager(ckpt_dir).restore(final)
    check(poisoned == [RESILIENT_NAN_STEP] and loop.rollbacks == 1,
          f"ResilientLoop: {loop.rollbacks} rollbacks for the NaN at step {RESILIENT_NAN_STEP}")
    on_card = all(v.device.type == dev.type for v in (*restored["model"].values(), *final["model"].values()))
    check(on_card, "ResilientLoop: restored tensors are not on the card")
    check(all(bool(torch.isfinite(v).all()) for v in final["model"].values()), "ResilientLoop: non-finite result")
    check(all(torch.equal(restored["model"][k], v) for k, v in final["model"].items()),
          "ResilientLoop: the last checkpoint differs from the final state")
    return {"steps": RESILIENT_STEPS, "save_every": RESILIENT_SAVE_EVERY, "nan_at_step": RESILIENT_NAN_STEP,
            "rollbacks": loop.rollbacks, "restored_on": str(next(iter(restored["model"].values())).device),
            "seconds": seconds}


def train_phase(torch, dev, smi) -> dict:
    """The training path on the card (phase ``train``): SuperPoint and DISK
    at the JAX package's train() widths in bfloat16, each first held in
    float32 against the CPU; the SuperPoint result saved as npz, loaded by
    the serving path and run through ``NNFeaturePointDetector.detect`` (K2,
    counted); one data-parallel step on an NCCL world of one against the
    one-device step, bit for bit; a ResilientLoop that rolls back a NaN.
    Emits one JSON line per model and one for the rest; returns K2's
    numbers on this path."""
    import tempfile

    import torch.distributed as dist

    from feature_detector_tpu_torch.core.config import NNDetectorOptions, NNModelType
    from feature_detector_tpu_torch.core.convert import flax_tree_from_superpoint_state
    from feature_detector_tpu_torch.frontend.nn_detector import NNFeaturePointDetector
    from feature_detector_tpu_torch.kernels.greedy import greedy_select
    from feature_detector_tpu_torch.models import weights
    from feature_detector_tpu_torch.models.synth_data import scene_uint8, synth_scene
    from feature_detector_tpu_torch.models.train_superpoint import save_params_npz
    from feature_detector_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    batches = render_training_batches()
    render_s = time.perf_counter() - t_phase
    trained = {}
    for name in TRAIN_MODELS:
        fields, trained[name] = train_model(torch, dev, name, batches[name])
        emit("train", card=smi, batch_render_s=render_s, **fields)
    sp_state = {k: v.detach().clone() for k, v in trained["superpoint"].state_dict().items()}
    del trained
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # The trained weights through the npz format into the serving path (K2, counted).
        path = f"{tmp}/superpoint_trained.npz"
        save_params_npz(path, flax_tree_from_superpoint_state(sp_state))
        tree = weights.load_params_npz(path)
        opts = NNDetectorOptions(max_image_rows=NN_ROWS, max_image_cols=NN_COLS,
                                 model_type=NNModelType.SUPERPOINT_HEATMAP)
        det = NNFeaturePointDetector(opts, device=dev)
        det.initialize(params=tree)
        scene = scene_uint8(synth_scene(np.random.default_rng(TRAIN_SEED), NN_ROWS, NN_COLS, rich_background=True)[0])
        frame = torch.from_numpy(scene).to(dev)
        greedy_select.launches = 0
        feats, desc = det.detect(frame)
        torch.cuda.synchronize()
        detect_launches = greedy_select.launches
        check(detect_launches == 2, f"detect on the trained weights launched greedy {detect_launches} times, not 2")
        check(bool(torch.isfinite(feats.uv).all() and torch.isfinite(desc).all()), "detect on the trained weights")
        n_feats = int(feats.count)

        # One data-parallel step on an NCCL world of one against the one-device step, bit for bit.
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            mesh = make_mesh(device=dev.type)
            try:
                dp = _dp_step(torch, dev, sp_state, batches["superpoint"][0], mesh)
            finally:
                dist.destroy_process_group()
            one = _dp_step(torch, dev, sp_state, batches["superpoint"][0], None)
        finally:
            torch.backends.cudnn.deterministic = False
        dp_equal = (all(torch.equal(a, b) for a, b in zip(dp[0], one[0]))
                    and all(torch.equal(dp[i][k], one[i][k]) for i in (1, 2) for k in one[1]))
        check(dp_equal, "make_train_step(mesh=...) on a world of one differs from the one-device step")

        resilient = resilient_run(torch, dev, sp_state, batches["superpoint"], f"{tmp}/ckpt")
    emit("train_tools", card=smi, trained_npz_detect={"greedy_launches": detect_launches, "features": n_feats,
                                                     "rows": NN_ROWS, "cols": NN_COLS},
         data_parallel_world_of_one_equal_bitwise=dp_equal, resilient_loop=resilient,
         seconds=time.perf_counter() - t_phase)
    return {"launches": detect_launches, "path": "NNFeaturePointDetector.detect on the freshly trained SuperPoint"}


def demo_phase(torch, dev, smi) -> tuple:
    """The demos on the card (phase ``demo``): ``demo_points``,
    ``demo_descriptor`` and ``demo_lines`` on a synthetic 752x480 scene,
    ``demo_nn`` on a 640x480 one and ``demo_vo`` on 30 frames, each writing
    its PNGs to a temporary directory, with the K2 and K3 launches of each
    counted.  Every PNG is read back (header and image data).  Emits one
    JSON line; returns K2's and K3's numbers on this path."""
    import os
    import tempfile

    from feature_detector_tpu_torch.app import demo
    from feature_detector_tpu_torch.io.images import png_size
    from feature_detector_tpu_torch.kernels.greedy import greedy_select
    from feature_detector_tpu_torch.kernels.lsd_flood import propagate_running
    from feature_detector_tpu_torch.models.synth_data import scene_uint8, synth_scene

    t_phase = time.perf_counter()
    img = scene_uint8(synth_scene(np.random.default_rng(DEMO_SEED), ROWS, COLS, rich_background=True)[0])
    img2 = scene_uint8(synth_scene(np.random.default_rng(DEMO_SEED + 1), NN_ROWS, NN_COLS, rich_background=True)[0])
    demos = {
        "points": lambda out: demo.demo_points(img, out, dev),
        "descriptor": lambda out: demo.demo_descriptor(img, out, dev),
        "lines": lambda out: demo.demo_lines(img, out, dev),
        "nn": lambda out: demo.demo_nn(img2, out, dev),
        "vo": lambda out: demo.demo_vo(out, n_frames=DEMO_VO_FRAMES, device=dev),
    }
    results, k2, k3, seconds, pngs = {}, {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as out:
        for name, fn in demos.items():
            greedy_select.launches = 0
            propagate_running.launches = 0
            t = time.perf_counter()
            results[name] = fn(out)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t
            k2[name], k3[name] = greedy_select.launches, propagate_running.launches
            for path in results[name]["written"]:
                check(os.path.exists(path), f"demo {name} did not write {path}")
                w, h, c = png_size(path)
                check(w > 0 and h > 0 and c in (1, 3, 4), f"demo {name}: {path} reads as {w}x{h}x{c}")
                pngs[os.path.basename(path)] = [w, h, c]
    for name, want in DEMO_K2.items():
        check(k2[name] == want, f"demo {name} launched greedy {k2[name]} times, not {want}")
    check(k3["lines"] > 0 and k3["lines"] % 3 == 0, f"demo lines launched the flood {k3['lines']} times")
    check(sum(k3.values()) == k3["lines"], f"the flood ran outside demo lines: {k3}")
    check(len(pngs) == DEMO_PNGS, f"the demos wrote {len(pngs)} distinct PNGs, not {DEMO_PNGS}")
    vo = results["vo"]
    emit("demo", card=smi, rows=ROWS, cols=COLS, nn_rows=NN_ROWS, nn_cols=NN_COLS, vo_frames=DEMO_VO_FRAMES,
         counts={k: r["counts"] for k, r in results.items()}, ms={k: r["ms"] for k, r in results.items()},
         seconds=seconds, greedy_launches=k2, flood_launches=k3, pngs=pngs, vo_ate_m=vo["ate_m"],
         vo_ate_share_of_span=vo["ate_m"] / vo["span_m"], phase_seconds=time.perf_counter() - t_phase)
    return ({"launches": sum(k2.values()), "per_demo": k2},
            {"launches": k3["lines"], "demo": "demo_lines"})


def legacy_phase(torch, dev, smi) -> tuple:
    """The legacy short-window VO on the card (phase ``legacy``):
    ``run_visual_odometry`` on the 16-frame arc at 240x320 with its
    defaults (incremental front-end, Harris 200 in 256 slots; K2 twice a
    frame, counted) in a cold and a timed run with stage seconds, a
    profiled run (busy share), and once with the batch front-end (K1, one
    call); ``run_incremental_frontend`` on the card against the CPU; and
    ``run_visual_odometry_chunked(legacy=True)`` on the 30-frame lateral
    sequence (K2 twice a chunk frame).  K1 and K2 against their plain
    versions on the path's own maps.  Emits one JSON line; returns K1's and
    K2's numbers on this path."""
    from feature_detector_tpu_torch.core.config import BriefOptions, DetectorOptions, HarrisOptions
    from feature_detector_tpu_torch.core.types import Features
    from feature_detector_tpu_torch.frontend.detector import detection_maps
    from feature_detector_tpu_torch.kernels.detect import greedy_select_ref, harris_response_raw
    from feature_detector_tpu_torch.kernels.greedy import greedy_select
    from feature_detector_tpu_torch.slam.evaluate import ate_rmse
    from feature_detector_tpu_torch.slam.sequence import (
        make_synthetic_sequence,
        run_incremental_frontend,
        run_visual_odometry,
        run_visual_odometry_chunked,
    )

    t_phase = time.perf_counter()
    seq = make_synthetic_sequence(n_frames=LEGACY_FRAMES, n_landmarks=LEGACY_LANDMARKS, seed=LEGACY_SEED,
                                  angle_step=0.03)
    imgs = torch.from_numpy(seq.images).to(dev)
    gt = seq.trajectory.positions
    n = LEGACY_FRAMES

    def run(**kw):
        stages = {}
        torch.cuda.synchronize()
        greedy_select.launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        res = run_visual_odometry(imgs, seq.cam, max_track_obs=LEGACY_MAX_TRACK_OBS, stage_seconds=stages, **kw)
        end.record()
        torch.cuda.synchronize()
        pos = res.trajectory.positions
        check(pos.shape == (n, 3) and bool(np.isfinite(pos).all()), f"legacy VO {kw}: finite, one pose a frame")
        return res, {"wall_s": time.perf_counter() - t0, "event_s": start.elapsed_time(end) / 1e3, "stages_s": stages,
                     "greedy_launches": greedy_select.launches,
                     "ate_m": float(ate_rmse(pos, gt, with_scale=True)), "num_tracks": res.num_tracks}

    res, cold = run()
    _, timed = run()
    for r in (cold, timed):
        check(r["greedy_launches"] == 2 * n, f"legacy VO launched greedy {r['greedy_launches']} times, not 2 x {n}")
        check(r["ate_m"] < LEGACY_ATE_M, f"legacy VO ATE {r['ate_m']} m, bound {LEGACY_ATE_M} m")
    _, batch = run(incremental=False)
    check(batch["greedy_launches"] == 2, f"legacy VO, batch front-end: {batch['greedy_launches']} greedy launches, not 2")
    check(batch["ate_m"] < LEGACY_ATE_M, f"legacy VO, batch front-end: ATE {batch['ate_m']} m")

    # One run under the profiler: the card's busy time against the run's event time.
    t0 = time.perf_counter()
    per_kernel, counts, prof_event_ms = profiled(
        torch, lambda: run_visual_odometry(imgs, seq.cam, max_track_obs=LEGACY_MAX_TRACK_OBS))
    profile_s = time.perf_counter() - t0
    busy_ms = sum(per_kernel.values())
    check(busy_ms > 0, "the profiler saw no device time on the legacy VO path")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:LEGACY_TOP_KERNELS]

    # The incremental front-end on the card against the CPU (steered BRIEF, the VO's detector options).
    fe_seq = make_synthetic_sequence(n_frames=LEGACY_FE_FRAMES, n_landmarks=LEGACY_FE_LANDMARKS, seed=LEGACY_FE_SEED)
    det = DetectorOptions(min_feature_distance=10, min_valid_response=20.0, max_features=256, subpixel=True)
    card_fe = run_incremental_frontend(torch.from_numpy(fe_seq.images).to(dev), "harris", 200, det, BriefOptions())
    cpu_fe = run_incremental_frontend(fe_seq.images, "harris", 200, det, BriefOptions(), device="cpu")
    raw = harris_response_raw(torch.from_numpy(fe_seq.images).to(torch.float32), HarrisOptions()).numpy()
    fe_equal, fe_excused = 0, 0
    for f in range(LEGACY_FE_FRAMES):
        cf, pf = card_fe[0], cpu_fe[0]
        differ = ((cf.uv[f].cpu() != pf.uv[f]).any(-1) | (cf.response[f].cpu() != pf.response[f])
                  | (cf.valid[f].cpu() != pf.valid[f])).numpy()
        differ |= (card_fe[1][f].cpu().numpy() != cpu_fe[1][f].numpy()).any(-1)
        differ |= card_fe[2][f].cpu().numpy() != cpu_fe[2][f].numpy()
        if f > 0:
            differ |= card_fe[3][f - 1][2] != cpu_fe[3][f - 1][2]
        if not differ.any():
            fe_equal += 1
            continue
        uv = np.concatenate([cf.uv[f].cpu().numpy()[differ], pf.uv[f].numpy()[differ]])
        x = np.clip(uv[:, 0].astype(np.int64), 0, raw.shape[2] - 1)
        y = np.clip(uv[:, 1].astype(np.int64), 0, raw.shape[1] - 1)
        near = np.abs(raw[f, y, x] - det.min_valid_response) <= VO_HARRIS_REL * det.min_valid_response
        check(bool(near.all()), f"incremental front-end: frame {f} differs from the CPU at features off the threshold")
        fe_excused = int(differ.sum())
        break  # the carry step feeds every later frame from this one

    # The legacy chunked entry on the 30-frame lateral sequence.
    lat = make_synthetic_sequence(n_frames=LEGACY_CHUNKED_FRAMES, n_landmarks=LEGACY_CHUNKED_LANDMARKS,
                                  seed=LEGACY_SEED, motion="lateral", angle_step=0.03)
    lat_imgs = torch.from_numpy(lat.images).to(dev)
    stages = {}
    torch.cuda.synchronize()
    greedy_select.launches = 0
    t0 = time.perf_counter()
    chunked = run_visual_odometry_chunked(lat_imgs, lat.cam, chunk=LEGACY_CHUNK, overlap=LEGACY_OVERLAP, legacy=True,
                                          stage_seconds=stages)
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    step = LEGACY_CHUNK - LEGACY_OVERLAP
    chunk_frames = sum(min(s0 + LEGACY_CHUNK, LEGACY_CHUNKED_FRAMES) - s0
                       for s0 in range(0, LEGACY_CHUNKED_FRAMES - LEGACY_OVERLAP, step))
    chunked_launches = greedy_select.launches
    check(chunked_launches == 2 * chunk_frames,
          f"legacy chunked VO launched greedy {chunked_launches} times, not 2 x {chunk_frames} chunk frames")
    lat_pos = chunked.trajectory.positions
    check(lat_pos.shape == (LEGACY_CHUNKED_FRAMES, 3) and bool(np.isfinite(lat_pos).all()),
          "legacy chunked VO: finite, one pose a frame")
    lat_span = float(np.linalg.norm(np.ptp(lat.trajectory.positions, 0)))
    lat_ate = float(ate_rmse(lat_pos, lat.trajectory.positions, with_scale=True))

    # K1 and K2 against their plain versions on the path's own maps (not counted).
    saved = greedy_select.launches
    empty = Features.empty(det.max_features, dev)
    k1_maps = torch.stack([detection_maps(imgs[f], empty, "harris", det)[0] for f in range(n)])
    k1_call = lambda: greedy_select(k1_maps, 200, 200, det.min_feature_distance)
    got = k1_call()
    torch.cuda.synchronize()
    want = greedy_select_ref(k1_maps, 200, 200, det.min_feature_distance)
    check(all(torch.equal(g, w) for g, w in zip(got, want)), "K1 != plain on the legacy batch front-end's maps")
    k1 = {"launches": batch["greedy_launches"], "max_abs_err": max_abs_err(torch, got, want), "ms": cuda_ms(torch, k1_call, 20),
          "device_ms": device_ms(torch, k1_call, GREEDY_KERNELS, 10),
          "plain_ms": cuda_ms(torch, lambda: greedy_select_ref(k1_maps, 200, 200, det.min_feature_distance), 2),
          "bound_ms": greedy_bound_ms(n, int(seq.images.shape[1]), int(seq.images.shape[2]), 200),
          "maps": f"batch front-end, {n} frames"}
    fe16 = run_incremental_frontend(imgs, "harris", 200, det, BriefOptions())
    f = LEGACY_K2_FRAME
    n_carried = int((fe16[3][f - 1][2] >= 0).sum())
    keep = torch.arange(det.max_features, device=dev) < n_carried
    fr = fe16[0]
    prefix = Features(fr.uv[f] * keep[:, None], fr.response[f] * keep, fr.valid[f] & keep)
    cand, _ = detection_maps(imgs[f], prefix, "harris", det)
    stop = torch.tensor([200 - n_carried], dtype=torch.int32, device=dev)
    k2_call = lambda: greedy_select(cand, 200, stop, det.min_feature_distance)
    got = k2_call()
    torch.cuda.synchronize()
    want = greedy_select_ref(cand, 200, stop, det.min_feature_distance)
    check(all(torch.equal(g, w) for g, w in zip(got, want)), f"K2 != plain on legacy frame {f}'s top-up map")
    k2 = {"launches": cold["greedy_launches"], "chunked_launches": chunked_launches,
          "max_abs_err": max_abs_err(torch, got, want), "ms": cuda_ms(torch, k2_call, 50),
          "device_ms": device_ms(torch, k2_call, GREEDY_KERNELS, 20),
          "plain_ms": cuda_ms(torch, lambda: greedy_select_ref(cand, 200, stop, det.min_feature_distance), 2),
          "bound_ms": greedy_bound_ms(1, int(seq.images.shape[1]), int(seq.images.shape[2]), 200),
          "maps": f"top-up of frame {f} ({n_carried} carried)"}
    greedy_select.launches = saved

    emit("legacy", card=smi, frames=n, rows=int(seq.images.shape[1]), cols=int(seq.images.shape[2]),
         landmarks=LEGACY_LANDMARKS, seed=LEGACY_SEED, cold=cold, timed=timed, batch_frontend=batch,
         frames_per_s_wall=n / timed["wall_s"], frames_per_s_events=n / timed["event_s"],
         ate_m=timed["ate_m"], ate_bound_m=LEGACY_ATE_M, profiled_run_event_ms=prof_event_ms, profile_s=profile_s,
         device_busy_ms=busy_ms,
         device_busy_share=busy_ms / prof_event_ms, device_kernels=sum(counts.values()),
         top_kernels_ms=[[name[:90], ms, counts[name]] for name, ms in top],
         incremental_frontend_frames=LEGACY_FE_FRAMES, incremental_frontend_frames_equal_cpu=fe_equal,
         incremental_frontend_excused_near_threshold=fe_excused,
         chunked={"frames": LEGACY_CHUNKED_FRAMES, "landmarks": LEGACY_CHUNKED_LANDMARKS, "chunk": LEGACY_CHUNK,
                  "overlap": LEGACY_OVERLAP, "seconds": chunked_s, "frames_per_s": LEGACY_CHUNKED_FRAMES / chunked_s,
                  "stages_s": stages, "greedy_launches": chunked_launches, "chunk_frames": chunk_frames,
                  "ate_m": lat_ate, "span_m": lat_span, "ate_share_of_span": lat_ate / lat_span,
                  "num_tracks": chunked.num_tracks},
         phase_seconds=time.perf_counter() - t_phase)
    return k1, k2


def bars_image(rows: int = 120, cols: int = 160) -> np.ndarray:
    """Bright straight bars on a dark background (tests/test_lsd.py:14-21)."""
    img = np.full((rows, cols), 30, np.uint8)
    img[20:24, 10:150] = 220
    img[40:110, 80:84] = 220
    for i in range(60):
        img[30 + i, 10 + i : 14 + i] = 220
    return img


def endpoint_set_distance(a, b) -> float:
    """The larger endpoint distance of two segments, under the better of the
    two endpoint pairings (tests/test_lsd.py)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    d1 = max(np.hypot(*(a[:2] - b[:2])), np.hypot(*(a[2:] - b[2:])))
    d2 = max(np.hypot(*(a[:2] - b[2:])), np.hypot(*(a[2:] - b[:2])))
    return float(min(d1, d2))


def brief_near_tie(image: np.ndarray, uv, i: int, j: int, opts) -> bool:
    """Whether the BRIEF oracle's two reads of test j at feature i are
    within ORACLE_BRIEF_TIE of each other (tests/test_brief.py)."""
    from feature_detector_tpu_torch.oracle import brief as OB

    x, y = float(uv[i][0]), float(uv[i][1])
    d = np.arange(-opts.half_patch_size, opts.half_patch_size + 1, dtype=np.float32)
    dxg, dyg = np.meshgrid(d, d, indexing="xy")
    vals = OB.bilinear(image, y + dyg, x + dxg)
    m10, m01 = float((dxg * vals).sum()), float((dyg * vals).sum())
    st, ct = m01 / np.hypot(m10, m01), m10 / np.hypot(m10, m01)
    p = OB.BRIEF_PATTERN[j].astype(np.float32)
    v1 = OB.bilinear(image, st * p[0] + ct * p[1] + y, ct * p[0] - st * p[1] + x)
    v2 = OB.bilinear(image, st * p[2] + ct * p[3] + y, ct * p[2] - st * p[3] + x)
    return abs(float(v1) - float(v2)) < ORACLE_BRIEF_TIE


def oracle_phase(torch, dev, smi) -> dict:
    """The card against the numpy oracles (phase ``oracle``), the first
    reference independent of both packages: ``detect_good_features`` for
    each detector kind at 752x480 and on 120x160 tiles (K2), greedy
    selection at B = 8 (K1) and B = 1 against ``select_good_features``,
    default and gather BRIEF, the LSD angle map, ``detect_good_lines`` (K3)
    on the bars image, and SuperPoint's heatmap selection.  FAST goes
    through the whole oracle at 752x480; Harris and Shi-Tomasi there through
    the oracle's NMS and selection fed the card's response map, since the
    oracle's float32 cumulative box sums lose digits over a whole 752x480
    frame (their gap to the card's map is reported), and through the whole
    oracle on the tiles.  Emits one JSON line; returns each kernel's
    launches on this path."""
    from feature_detector_tpu_torch.core.config import (
        BriefOptions,
        DetectorOptions,
        LineDetectorOptions,
        NNDetectorOptions,
        NNModelType,
    )
    from feature_detector_tpu_torch.core.types import Features, words_to_numpy
    from feature_detector_tpu_torch.frontend.descriptor import compute_descriptors
    from feature_detector_tpu_torch.frontend.detector import _default_sub, detect_good_features
    from feature_detector_tpu_torch.frontend.line_detector import detect_good_lines
    from feature_detector_tpu_torch.frontend.nn_detector import NNFeaturePointDetector, select_features_from_heatmap
    from feature_detector_tpu_torch.kernels import detect as KD
    from feature_detector_tpu_torch.kernels.greedy import greedy_select
    from feature_detector_tpu_torch.kernels.lsd import line_level_angle_map
    from feature_detector_tpu_torch.kernels.lsd_flood import propagate_running
    from feature_detector_tpu_torch.models.synth_data import scene_uint8, synth_scene
    from feature_detector_tpu_torch.oracle import brief as OB
    from feature_detector_tpu_torch.oracle import detectors as OD
    from feature_detector_tpu_torch.oracle import lsd as OL
    from feature_detector_tpu_torch.oracle import nn_postproc as ON

    t_phase = time.perf_counter()
    scene = lambda seed, rows=ROWS, cols=COLS: scene_uint8(synth_scene(np.random.default_rng(seed), rows, cols,
                                                                       rich_background=True)[0])
    greedy_select.launches = 0
    propagate_running.launches = 0
    k1_launches = 0
    out = {"detect": {}}
    ones = np.ones((ROWS, COLS), np.int32)

    # Detection, each kind: picks equal to the oracle's.
    fast_uv = None
    for kind, seed in ORACLE_SCENE_SEEDS.items():
        img = scene(seed)
        opts = DetectorOptions(min_feature_distance=RADIUS, min_valid_response=ORACLE_THRESHOLDS[kind],
                               max_features=256)
        sub = _default_sub(kind)
        card = detect_good_features(torch.from_numpy(img).to(dev), Features.empty(256, dev), kind, PICKS, opts)
        got = card.to_numpy()[0]
        entry = {"picks": len(got)}
        if kind == "fast":
            want = OD.detect_good_features(img, PICKS, kind, opts, sub)
            fast_uv = got
        else:
            respond = KD.harris_response if kind == "harris" else KD.shi_tomasi_response
            resp = respond(torch.from_numpy(img).to(dev), torch.from_numpy(ones).to(dev), opts, sub).cpu().numpy()
            responses, pixels = OD.nms4_candidates(resp, opts.min_valid_response, sub.half_patch_size + 1)
            want = OD.select_good_features(responses, pixels, ones, PICKS, opts.min_feature_distance)
            oracle_map = (OD.harris_response_map if kind == "harris" else OD.shi_tomasi_response_map)(
                img, ones, opts, sub)
            live = (oracle_map > 0) | (resp > 0)
            rel = np.abs(resp - oracle_map)[live] / np.maximum(np.abs(oracle_map[live]), 1e-3)
            entry.update(full_frame_through="the oracle's NMS and selection on the card's response map",
                         card_map_vs_oracle_map_rel_p99=float(np.quantile(rel, 0.99)),
                         card_map_vs_oracle_map_abs_max=float(np.abs(resp - oracle_map).max()))
        check(len(got) == len(want) and np.array_equal(got, np.asarray(want, np.float32).reshape(-1, 2)),
              f"oracle: {kind} picks at {ROWS}x{COLS} differ from the oracle's")
        tiles_equal = 0
        for r0, c0 in ORACLE_TILES:
            tile = np.ascontiguousarray(img[r0:r0 + 120, c0:c0 + 160])
            want_t = OD.detect_good_features(tile, ORACLE_TILE_PICKS, kind, opts, sub)
            got_t = detect_good_features(torch.from_numpy(tile).to(dev), Features.empty(256, dev), kind,
                                         ORACLE_TILE_PICKS, opts).to_numpy()[0]
            check(len(got_t) == len(want_t) and np.array_equal(got_t, np.asarray(want_t, np.float32).reshape(-1, 2)),
                  f"oracle: {kind} picks on the 120x160 tile at ({r0}, {c0}) differ from the oracle's")
            tiles_equal += 1
        entry["tiles_equal"] = tiles_equal
        out["detect"][kind] = entry

    # Greedy selection at B = 8 (K1) and B = 1 (K2) against select_good_features.
    frames = torch.from_numpy(np.stack([scene(s) for s in range(8)])).to(dev)
    cand = KD.fast_candidates(KD.fast_response(frames, torch.ones((ROWS, COLS), dtype=torch.int32, device=dev)),
                              10.0)
    before = greedy_select.launches
    uv_b, _, valid_b = greedy_select(cand, PICKS, PICKS, RADIUS)
    torch.cuda.synchronize()
    k1_launches += greedy_select.launches - before
    uv_1, _, valid_1 = greedy_select(cand[0], PICKS, PICKS, RADIUS)
    cand_np = cand.cpu().numpy()
    for b in range(8):
        ys, xs = np.nonzero(cand_np[b] > 0)
        want = np.asarray(OD.select_good_features(cand_np[b][ys, xs], np.stack([xs, ys], -1), ones, PICKS, RADIUS),
                          np.float32).reshape(-1, 2)
        check(np.array_equal(uv_b[b][valid_b[b]].cpu().numpy(), want), f"oracle: K1 frame {b} differs from the oracle")
        if b == 0:
            check(np.array_equal(uv_1[valid_1].cpu().numpy(), want), "oracle: K2 differs from the oracle")
    out["greedy"] = {"k1_batch": 8, "k2_frames": 1, "picks_per_frame": valid_b.sum(1).tolist()}

    # BRIEF on the FAST scene's features: default against the binned oracle, gather against the bilinear one.
    img = scene(ORACLE_SCENE_SEEDS["fast"])
    feats = Features.from_numpy(fast_uv, 256, device=dev)
    brief = {}
    for method, oracle_fn in (("mxu", OB.compute_binned), ("gather", OB.compute)):
        opts = BriefOptions(method=method)
        d = compute_descriptors(torch.from_numpy(img).to(dev), feats, opts)
        want_bits, want_valid = oracle_fn(img, fast_uv, opts)
        words = words_to_numpy(d.words)[: len(fast_uv)]
        bits = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")[:, :opts.length]
        check(np.array_equal(d.valid.cpu().numpy()[: len(fast_uv)], want_valid), f"oracle: BRIEF {method} validity")
        mism = bits != want_bits
        if method == "mxu":
            excused = near_bin_boundary(img, fast_uv)
            check(not mism[~excused].any(), "oracle: default BRIEF differs off a steering-bin boundary")
        else:
            check(all(brief_near_tie(img, fast_uv, i, j, opts) for i, j in zip(*np.nonzero(mism))),
                  "oracle: gather BRIEF differs where the two reads are not a near-tie")
        check(mism.sum() <= max(2, 0.005 * mism.size), f"oracle: BRIEF {method}: {int(mism.sum())} bits differ")
        brief[method] = {"features": len(fast_uv), "bits_differing": int(mism.sum()), "bits": int(mism.size)}
    out["brief"] = brief

    # LSD: the angle map, and detect_good_lines (K3) on the bars image.
    lopts = LineDetectorOptions()
    gn, ga, gv = (x.cpu().numpy() for x in line_level_angle_map(torch.from_numpy(img).to(dev), lopts))
    wn, wa, wv = OL.line_level_angle_map(img, lopts)
    check(np.array_equal(gv, wv) and np.array_equal(gn, wn), "oracle: LSD validity or norms differ")
    angle_err = float(np.abs(ga - wa).max())
    check(angle_err <= ANGLE_ATOL, f"oracle: LSD angles differ by {angle_err}")
    bars = bars_image()
    want_lines = OL.detect_lines(bars, lopts)
    segs = detect_good_lines(torch.from_numpy(bars).to(dev), 10, lopts).to_numpy()
    dists = [min(endpoint_set_distance(w, g) for g in segs) for w in want_lines]
    check(len(want_lines) > 0 and max(dists) < ORACLE_LINE_PX
          and 0.5 * len(want_lines) <= len(segs) <= 2 * len(want_lines) + 1,
          f"oracle: bars' lines {segs.tolist()} against the oracle's {want_lines}")
    recall = []
    for s in range(3):
        sc = scene(s)
        w = OL.detect_lines(sc, lopts)
        g = detect_good_lines(torch.from_numpy(sc).to(dev), LSD_BUDGET, lopts).to_numpy()
        recall.append(sum(1 for x in w if len(g) and min(endpoint_set_distance(x, y) for y in g) < ORACLE_LINE_PX)
                      / max(len(w), 1))
    out["lsd"] = {"angle_pixels_differing": int((ga != wa).sum()), "angle_max_abs_diff": angle_err,
                  "valid_and_norm_equal": True, "bars_lines": len(segs), "bars_oracle_lines": len(want_lines),
                  "bars_max_endpoint_px": max(dists), "scene_recall_at_4px": recall}

    # SuperPoint's heatmap selection against the NN oracle.
    nopts = NNDetectorOptions(max_image_rows=NN_ROWS, max_image_cols=NN_COLS,
                              model_type=NNModelType.SUPERPOINT_HEATMAP)
    det = NNFeaturePointDetector(nopts, device=dev)
    det.initialize()
    heat, _ = det.maps(torch.from_numpy(scene(0, NN_ROWS, NN_COLS)).to(dev))
    got = select_features_from_heatmap(heat, Features.empty(nopts.max_number_of_detected_features, dev),
                                       nopts).to_numpy()[0]
    want = np.asarray(ON.select_features(heat.float().cpu().numpy(), [], nopts), np.float32).reshape(-1, 2)
    check(np.array_equal(got, want), "oracle: SuperPoint heatmap selection differs from the oracle's")
    out["nn"] = {"model": "superpoint_heatmap", "features": len(got)}

    torch.cuda.synchronize()
    launches = {"k1": k1_launches, "k2": greedy_select.launches - k1_launches, "k3": propagate_running.launches}
    check(all(v > 0 for v in launches.values()), f"oracle phase: a kernel was not launched: {launches}")
    emit("oracle", card=smi, rows=ROWS, cols=COLS, **out, launches=launches,
         phase_seconds=time.perf_counter() - t_phase)
    return launches


def max_abs_err(torch, got, want) -> float:
    return max(float((g.to(torch.float32) - w.to(torch.float32)).abs().max()) for g, w in zip(got, want))


def near_bin_boundary(image: np.ndarray, uv: np.ndarray, bins: int = 30) -> np.ndarray:
    """Features whose steering angle * bins / 2pi lies within 1e-4 of a
    half-integer, where the card's and the CPU's float32 atan2 may round to
    different bins."""
    img = image.astype(np.int64)
    x = np.clip(np.round(uv[:, 0]).astype(np.int64), 18, image.shape[1] - 19)
    y = np.clip(np.round(uv[:, 1]).astype(np.int64), 18, image.shape[0] - 19)
    d = np.arange(-8, 9)
    out = np.zeros(len(uv), bool)
    for i in range(len(uv)):
        p = img[y[i] - 8 : y[i] + 9, x[i] - 8 : x[i] + 9]
        t = np.arctan2((p * d[:, None]).sum(), (p * d[None, :]).sum()) * bins / (2 * np.pi)
        out[i] = abs(abs(t - np.floor(t)) - 0.5) < 1e-4
    return out


def main_frames() -> tuple:
    """The main path's frames: 8 seeded scenes at 752x480, frames_a = each
    scene at 8 row shifts (64 frames), frames_b = frames_a shifted 3
    columns.  Returns (scenes, frames_a, frames_b)."""
    from feature_detector_tpu_torch.models.synth_data import scene_uint8, synth_scene

    scenes = [scene_uint8(synth_scene(np.random.default_rng(s), ROWS, COLS, rich_background=True)[0])
              for s in range(SCENES)]
    frames_a = np.stack([np.roll(sc, i, axis=0) for sc in scenes for i in range(BATCH // SCENES)])
    return scenes, frames_a, np.roll(frames_a, 3, axis=2)


def greedy_checks(torch, dev) -> tuple:
    """K1 and K2 against their plain version on the card at main-path
    shapes (dense maps with ties and an all-zero frame, per-frame budgets),
    then at the seams of the tiled design and on a 1080x1920 frame.  Emits
    one line per case; returns (max_abs_err by batch, the dense maps)."""
    from feature_detector_tpu_torch.kernels.detect import greedy_select_ref
    from feature_detector_tpu_torch.kernels.greedy import GREEDY_TILE, greedy_select
    from feature_detector_tpu_torch.models.synth_data import tile_edge_ties

    rng = np.random.default_rng(0)
    dense = np.round(rng.random((BATCH, ROWS, COLS), np.float32) * 16) / 16  # many ties
    dense[dense < 0.25] = 0.0
    dense[5] = 0.0
    stops = rng.integers(0, PICKS + 1, BATCH).astype(np.int32)
    stops[:4] = (PICKS, 0, 1, PICKS)
    dense_t = torch.from_numpy(dense).to(dev)
    stops_t = torch.from_numpy(stops).to(dev)
    errs = {}
    for b, cand, n_stop in ((BATCH, dense_t, stops_t), (1, dense_t[0], PICKS)):
        got = greedy_select(cand, PICKS, n_stop, RADIUS)
        torch.cuda.synchronize()
        want = greedy_select_ref(cand, PICKS, n_stop, RADIUS)
        check(all(torch.equal(g, w) for g, w in zip(got, want)), f"greedy kernel != plain at B={b}")
        errs[b] = max_abs_err(torch, got, want)
        picks = got[2].reshape(-1, PICKS).sum(1).cpu().numpy()
        if b == BATCH:
            check(picks[0] == PICKS and picks[1] == 0 and picks[5] == 0, "dense picks per frame")
        emit("kernel_check", kernel="greedy_select", batch=b, shape=list(cand.shape), picks=PICKS,
             radius=RADIUS, exact=True, max_abs_err=errs[b], picks_taken_mean=float(picks.mean()))

    # The seams of the tiled design: a map that is no multiple of a tile,
    # equal maxima on both sides of tile edges and far apart, -0 and
    # negative entries, radii 0, 1, 20 and wider than a tile.
    seam = tile_edge_ties(rng, (3, SEAM_ROWS, SEAM_COLS), GREEDY_TILE, signed_frame=1)
    seam_t = torch.from_numpy(seam).to(dev)
    for r in (RADIUS, 0, 1, 25):
        got = greedy_select(seam_t, 40, 40, r)
        torch.cuda.synchronize()
        want = greedy_select_ref(seam_t, 40, 40, r)
        check(all(torch.equal(g, w) for g, w in zip(got, want)), f"greedy kernel != plain on the seam map, r={r}")
    emit("kernel_check", kernel="greedy_select", batch=3, shape=list(seam.shape), picks=40, radii=[RADIUS, 0, 1, 25],
         case="tile-edge ties, negatives and -0", exact=True, picks_taken=want[2].sum(1).tolist())
    # A 1080x1920 frame: the pick chain's state no longer fits in shared
    # memory and lives in the global workspace.
    large = torch.from_numpy(np.where(rng.random((1080, 1920)) < 0.01, rng.random((1080, 1920)), 0).astype(np.float32)).to(dev)
    got = greedy_select(large, 30, 30, RADIUS)
    torch.cuda.synchronize()
    want = greedy_select_ref(large, 30, 30, RADIUS)
    check(all(torch.equal(g, w) for g, w in zip(got, want)), "greedy kernel != plain on a 1080x1920 frame")
    emit("kernel_check", kernel="greedy_select", batch=1, shape=list(large.shape), picks=30, radius=RADIUS,
         case="state in the global workspace", exact=True, picks_taken=int(want[2].sum()))
    return errs, dense_t


# --------------------------------------------------------------------------
# The multi-card run: python3 chip_smoke.py --world N
# --------------------------------------------------------------------------


def run_ranks(argv_of, world: int, logdir, wall_s: float) -> list:
    """Starts ``world`` processes ``argv_of(rank)`` at once, each in a
    session of its own with COORDINATOR_ADDRESS (a free localhost port),
    NUM_PROCESSES, PROCESS_ID and LOCAL_RANK set and its output in
    ``logdir/rank{r}.out`` and ``.err``, and waits for them.  When one
    exits non-zero, or ``wall_s`` seconds pass, the rest are killed: a rank
    that fails leaves the others waiting in a collective.  Returns the exit
    codes in rank order, None for a rank that was killed."""
    import os
    import signal
    import socket

    logdir.mkdir(parents=True, exist_ok=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    try:
        for r in range(world):
            rank_env = {**os.environ, "COORDINATOR_ADDRESS": f"localhost:{port}",
                        "NUM_PROCESSES": str(world), "PROCESS_ID": str(r), "LOCAL_RANK": str(r)}
            with open(logdir / f"rank{r}.out", "w") as out, open(logdir / f"rank{r}.err", "w") as err:
                procs.append(subprocess.Popen(argv_of(r), env=rank_env, stdout=out, stderr=err,
                                              start_new_session=True))
        deadline = time.monotonic() + wall_s
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.2)
        return [p.poll() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            p.wait()


def world_main(world: int) -> int:
    """The parent of the multi-card run: checks that ``world`` cards are
    visible, builds the kernels once, starts one rank per card
    (``rank_main``), and prints rank 0's lines, one line per rank, the
    kernel line, the cards' name and power limit and the last line only
    when every rank exited 0."""
    import os
    import signal
    from pathlib import Path

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    n_cards = torch.cuda.device_count()
    if n_cards < world:
        raise RuntimeError(f"chip_smoke --world {world}: {n_cards} CUDA device(s) visible, {world} needed")
    from feature_detector_tpu_torch.kernels import _build

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))  # the ranks are killed on the way out
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    cards = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    kind = torch.cuda.get_device_name(0)
    emit("world_device", name=kind, count=n_cards, world=world, cards=cards, torch=torch.__version__,
         cuda=torch.version.cuda, host_cores=len(os.sched_getaffinity(0)), nvidia_smi=smi)
    # One build before any rank starts: the ranks only load the libraries.
    t = time.perf_counter()
    report = _build.build(ptxas_verbose=True)
    emit("world_build", seconds=time.perf_counter() - t, kernels={k: v["seconds"] for k, v in report.items()})

    logdir = Path(__file__).resolve().parent / "build" / "chip_smoke_world"
    script = str(Path(__file__).resolve())
    codes = run_ranks(lambda r: [sys.executable, script, "--world", str(world), "--rank-process"], world, logdir,
                      WORLD_WALL_S)
    if any(c != 0 for c in codes):
        bad = next((r for r, c in enumerate(codes) if c not in (None, 0)), None)
        what = f"rank {bad} exited {codes[bad]}" if bad is not None else f"the {WORLD_WALL_S} s wall limit passed"
        print(f"chip_smoke FAILED: {what}; exit codes {codes} (None: killed)", file=sys.stderr)
        for r in ([bad] if bad is not None else range(world)):
            for ext in ("err", "out"):
                print(f"--- rank {r} {ext} (tail) ---\n{(logdir / f'rank{r}.{ext}').read_text()[-3000:]}",
                      file=sys.stderr)
        return 1
    results = []
    for r in range(world):
        lines = (logdir / f"rank{r}.out").read_text().splitlines()
        last = [ln for ln in lines if ln.startswith('{"rank_result"')]
        if len(last) != 1:
            print(f"chip_smoke FAILED: rank {r} exited 0 without its result line", file=sys.stderr)
            return 1
        if r == 0:
            print("\n".join(ln for ln in lines if ln != last[0]))
        results.append(json.loads(last[0])["rank_result"])
    for res in results:
        emit("world_rank", **{k: v for k, v in res.items() if k not in ("kernels", "scaling")})
    emit("world_scaling", card=smi, world=world, **results[0]["scaling"], seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": results[0]["kernels"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": world}}))
    return 0


def spread(xs) -> dict:
    return {"median": float(np.median(xs)), "min": float(np.min(xs)), "max": float(np.max(xs)), "n": len(xs)}


def rep_times(torch, fn, reps: int, warmup: int = WORLD_WARMUP, barrier=None) -> dict:
    """``fn``'s time per call over ``reps`` calls after ``warmup`` calls:
    CUDA-event ms and host wall ms, each call started after ``barrier()``
    (all ranks at once) and ended by a synchronize.  Every rank makes the
    same number of calls, so their collectives pair up."""
    for _ in range(warmup):
        fn()
    events, wall = [], []
    for _ in range(reps):
        if barrier is not None:
            barrier()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        events.append(start.elapsed_time(end))
    return {"event_ms": spread(events), "wall_ms": spread(wall)}


def profiled_call(torch, fn, on: bool):
    """One call of ``fn``; under torch.profiler when ``on`` (the other ranks
    make the same call unprofiled).  Returns None, or the call's event ms,
    the device's busy ms and share, and the NCCL kernels' device ms by name
    and their share of the busy time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    if not on:
        fn()
        torch.cuda.synchronize()
        return None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    event_ms = start.elapsed_time(end)
    per_kernel, counts = traced_device_ms(torch, prof)
    busy = sum(per_kernel.values())
    check(busy > 0, "the profiler saw no device time")
    nccl = {k: v for k, v in per_kernel.items() if "nccl" in k.lower()}
    return {"event_ms": event_ms, "busy_ms": busy, "busy_share": busy / event_ms, "kernels": sum(counts.values()),
            "nccl_ms": sum(nccl.values()), "nccl_share_of_busy": sum(nccl.values()) / busy,
            "nccl_kernels": [[k[:80], v, counts[k]] for k, v in sorted(nccl.items(), key=lambda kv: -kv[1])]}


def rank0_value(torch, x):
    """Rank 0's value of ``x`` (the same shape and dtype on every rank), by
    an NCCL broadcast."""
    import torch.distributed as dist

    shape = torch.tensor(list(x.shape), dtype=torch.int64, device=x.device)
    shape0 = shape.clone()
    dist.broadcast(shape0, 0)
    check(torch.equal(shape, shape0), f"rank {dist.get_rank()}: a result of shape {tuple(x.shape)}, rank 0's "
          f"{tuple(shape0.tolist())}")
    y = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous().clone()
    dist.broadcast(y, 0)
    return y.to(torch.bool) if x.dtype == torch.bool else y


def graft_seam_problem(n_ranks: int):
    """The camera-sharded seam case of the JAX package's multi-chip entry
    (``__graft_entry__.py:120-162``): 5 cameras (30 reduced rows, no
    multiple of the rank count), 8 points a rank seen by 3 consecutive
    cameras each, observations projected from the truth and points moved
    by 0.02.  Returns (problem as numpy arrays, camera)."""
    from feature_detector_tpu_torch.slam.camera import Pinhole

    n_cams, n_pts, deg = GRAFT_CAMS, 8 * n_ranks, 3
    rs = np.random.default_rng(0)
    pts = rs.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    rots = np.broadcast_to(np.eye(3, dtype=np.float32), (n_cams, 3, 3)).copy()
    trans = np.stack([np.array([0.2 * i, 0.0, 0.0], np.float32) for i in range(n_cams)])
    cam = Pinhole(fx=100.0, fy=100.0, cx=24.0, cy=16.0)
    obs_cam = np.stack([np.arange(deg, dtype=np.int32) + (l % (n_cams - deg + 1)) for l in range(n_pts)])
    pc = np.einsum("ldij,lj->ldi", rots[obs_cam], pts) + trans[obs_cam]
    obs_uv = np.stack([cam.fx * pc[..., 0] / pc[..., 2] + cam.cx, cam.fy * pc[..., 1] / pc[..., 2] + cam.cy],
                      -1).astype(np.float32)
    points = pts + rs.normal(size=pts.shape).astype(np.float32) * 0.02
    return (rots, trans, points, obs_cam, obs_uv), cam


def ba_agreement(torch, sol, want, span: float, has, cost) -> dict:
    """A BA solution against the one-card ``want``: rotations (rad), camera
    centers and points over ``span`` (points seen twice), and both costs."""
    centers = lambda p: -torch.einsum("fji,fj->fi", p.rot, p.trans)
    point_err = (sol.points - want.points)[has].norm(dim=1) / span
    return {"rot_max_abs_err": float((sol.rot - want.rot).abs().max()),
            "center_max_abs_err_over_span": float((centers(sol) - centers(want)).abs().max()) / span,
            "point_max_err_over_span": float(point_err.max()),
            "point_median_err_over_span": float(point_err.median()),
            "points_within_1e-2_of_span": float((point_err <= 1e-2).float().mean()),
            "cost": cost(sol), "cost_one_card": cost(want),
            "bitwise": all(torch.equal(getattr(sol, f), getattr(want, f)) for f in ("rot", "trans", "points"))}


def dense_ba_ok(e: dict) -> bool:
    return (e["rot_max_abs_err"] <= MULTI_BA_DENSE_ATOL["rot"]
            and e["center_max_abs_err_over_span"] <= MULTI_BA_DENSE_ATOL["center"]
            and e["point_max_err_over_span"] <= MULTI_BA_DENSE_ATOL["point"])


def cg_ba_ok(e: dict, initial_cost: float = None) -> bool:
    """MULTI_BA_CG_TOL; the cost at most 10% above one card's, or, where
    the problem's ``initial_cost`` is given (a noise-free problem, whose
    cost converges to about 0), within GRAFT_CG_COST_SHARE of it."""
    cost_ok = (e["cost"] <= (1 + MULTI_BA_CG_TOL["cost"]) * e["cost_one_card"] if initial_cost is None
               else abs(e["cost"] - e["cost_one_card"]) <= GRAFT_CG_COST_SHARE * initial_cost)
    return (e["rot_max_abs_err"] <= MULTI_BA_CG_TOL["rot"]
            and e["center_max_abs_err_over_span"] <= MULTI_BA_CG_TOL["center"]
            and e["point_median_err_over_span"] <= MULTI_BA_CG_TOL["point_median"]
            and e["points_within_1e-2_of_span"] >= MULTI_BA_CG_TOL["points_within_1e-2"] and cost_ok)


def grads_agreement(got: dict, want: dict, ref64) -> dict:
    """Float32 gradients against the one-card step's, as the repo's tests
    hold a data-parallel step: every element within TRAIN_GRAD_RTOL /
    TRAIN_GRAD_ATOL; a parameter whose elements part by more is held as
    ``tests/test_torch_gpu.py`` holds the card's cuDNN gradients, against
    the float64 gradients ``ref64()``: its largest distance from them at
    most ROUNDING_FACTOR times the one-card step's or CARD_GRAD_SCALE_TOL
    of the largest float64 element.  Returns the parameters that needed the
    float64 rule and those that failed it."""
    rounded, failed = [], []
    ref = None
    for name, w in want.items():
        g = got[name]
        if bool(((g - w).abs() <= TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * w.abs()).all()):
            continue
        ref = ref or ref64()
        r = ref[name]
        far_got, far_want = float((g.double() - r).abs().max()), float((w.double() - r).abs().max())
        bound = max(ROUNDING_FACTOR * far_want, CARD_GRAD_SCALE_TOL * float(r.abs().max()))
        (rounded if far_got <= bound else failed).append([name, far_got, far_want, bound])
    return {"by_float64_rule": rounded, "failed": failed}


def rank_main(world: int) -> int:
    """One rank of the multi-card run: joins the group through the port's
    own start-up (``parallel/distributed.py:initialize``, from the
    environment the parent set: NCCL on ``cuda:LOCAL_RANK``), runs
    ``world_rank`` and prints its result as the last line."""
    import os

    import torch
    import torch.distributed as dist

    from feature_detector_tpu_torch.parallel import distributed
    from feature_detector_tpu_torch.parallel.mesh import mesh_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cores = len(os.sched_getaffinity(0))
    torch.set_num_threads(max(1, cores // world))
    t0 = time.perf_counter()
    joined = distributed.initialize()
    init_s = time.perf_counter() - t0
    rank, local = dist.get_rank(), int(os.environ["LOCAL_RANK"])
    info = distributed.process_info()
    try:
        check(joined and dist.get_backend() == "nccl" and dist.get_world_size() == world,
              f"rank {rank}: joined {joined}, a {dist.get_backend()} world of {dist.get_world_size()}")
        mesh = distributed.global_data_mesh()
        dev = mesh_device(mesh)
        check(mesh.size() == world and dev.index == local,
              f"rank {rank}: a mesh of {mesh.size()} on {dev}, LOCAL_RANK {local}")
        out = world_rank(torch, dev, mesh, rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    out.update(initialize_s=init_s, host_cores=cores, torch_threads=torch.get_num_threads(), process_info=info)
    print(json.dumps({"rank_result": out}), flush=True)
    return 0


def world_rank(torch, dev, mesh, rank: int, world: int) -> dict:
    """The work of one rank: (1) K1 and K2 against their plain version on
    this rank's card; (2) every path's one-card result on this card (the
    main-path batch, Harris, ``ba_solve`` on the VO's global problem and
    on the seam case, the VO, a float32 SuperPoint step), held against
    rank 0's; (3) every multi-device path at this world held against the
    one-card result, with K1's and K2's launches counted; (4) each path's
    time on one card and over the world, by CUDA events after a barrier,
    and one profiled call of each (rank 0; the VO on every rank).  Returns
    this rank's summary, the kernel line and the scaling table."""
    import inspect

    import torch.distributed as dist

    from feature_detector_tpu_torch.core.config import BAOptions, BriefOptions, DetectorOptions, MatcherOptions
    from feature_detector_tpu_torch.core.types import Features
    from feature_detector_tpu_torch.frontend.detector import detect_good_features_batch, detection_maps
    from feature_detector_tpu_torch.kernels import fixed_order as FO
    from feature_detector_tpu_torch.kernels.brief import brief_compute
    from feature_detector_tpu_torch.kernels.detect import (
        fast_candidates,
        fast_response,
        greedy_select_ref,
        harris_response,
    )
    from feature_detector_tpu_torch.kernels.greedy import greedy_select
    from feature_detector_tpu_torch.match.hamming import match_hamming
    from feature_detector_tpu_torch.models.superpoint import SuperPoint
    from feature_detector_tpu_torch.models.synth_data import make_batch
    from feature_detector_tpu_torch.models.train_superpoint import adam, make_train_step
    from feature_detector_tpu_torch.models.weights import init_state
    from feature_detector_tpu_torch.parallel.frontend import (
        make_batched_frontend,
        make_row_sharded_response,
        make_two_frame_matcher,
    )
    from feature_detector_tpu_torch.parallel.mesh import gather_leading, make_mesh, shard_leading
    from feature_detector_tpu_torch.slam.ba import BAProblem, ba_solve, make_distributed_ba, reprojection_cost
    from feature_detector_tpu_torch.slam.evaluate import ate_rmse
    from feature_detector_tpu_torch.slam.sequence import make_synthetic_sequence, run_visual_odometry_chunked
    from feature_detector_tpu_torch.slam.vo_fused import run_visual_odometry_fused

    lead = rank == 0
    t_rank = time.perf_counter()
    wemit = lambda phase, **fields: emit(f"world_{phase}", rank=rank, **fields)
    # Every broadcast is made before any comparison: a rank that stopped at its first mismatch would leave
    # the others' broadcasts unpaired.
    same_as_rank0 = lambda xs: all([torch.equal(x, rank0_value(torch, x)) for x in xs])
    failed = []  # checks are held at the end, so that every rank makes the same collectives

    def expect(cond: bool, what: str) -> None:
        if not cond:
            failed.append(what)
            print(f"chip_smoke: {what}", file=sys.stderr, flush=True)

    out = {"rank": rank, "device": str(dev), "name": torch.cuda.get_device_name(dev)}

    # 1. K1 and K2 against their plain version on this rank's card.
    errs, _ = greedy_checks(torch, dev)

    # 2. One card: every path on this card alone, held against rank 0's.
    t = time.perf_counter()
    _, frames_a, frames_b = main_frames()
    ja, jb = torch.from_numpy(frames_a).to(dev), torch.from_numpy(frames_b).to(dev)
    opts, bopts, mopts = DetectorOptions(**MAIN_DETECTOR), BriefOptions(), MatcherOptions()

    def detect_describe(x):
        f = detect_good_features_batch(x, "fast", PICKS, opts)
        return (f, *brief_compute(x, f.uv, f.valid, bopts))

    def pair_matcher():
        (fa, wa, va), (fb, wb, vb) = detect_describe(ja), detect_describe(jb)
        return fa, fb, match_hamming(wa, va, wb, vb, mopts)

    fa, wa, va = detect_describe(ja)
    fb, wb, vb = detect_describe(jb)
    m = match_hamming(wa, va, wb, vb, mopts)
    frame, fmask = ja[0], torch.ones(ja.shape[1:], dtype=torch.int32, device=dev)
    ropts = DetectorOptions(min_valid_response=30.0)
    harris = harris_response(frame, fmask, ropts)

    seq = make_synthetic_sequence(n_frames=VO_FRAMES, n_landmarks=VO_LANDMARKS, seed=VO_SEED, motion="lateral",
                                  angle_step=0.03)
    imgs = torch.from_numpy(seq.images).to(dev)
    gt = seq.trajectory.positions
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    torch.cuda.synchronize()
    greedy_select.launches = 0
    stages_one_cold = {}
    vo_one = run_visual_odometry_chunked(imgs, seq.cam, stage_seconds=stages_one_cold)
    torch.cuda.synchronize()
    k2_one = greedy_select.launches
    expect(k2_one == 2 * VO_FRAMES, f"rank {rank}: the one-card VO launched K2 {k2_one} times, not 2 x {VO_FRAMES}")
    ate_one = float(ate_rmse(vo_one.trajectory.positions, gt, with_scale=True))
    expect(ate_one <= VO_ATE_SPAN_SHARE * span, f"rank {rank}: one-card VO ATE {ate_one} m of a {span} m span")

    # The global BA problem of rank 0's run, so that every rank solves the same problem.
    prob = BAProblem(*(rank0_value(torch, x) for x in vo_one.problem))
    ba_opts = inspect.signature(run_visual_odometry_fused).parameters["ba_opts"].default
    ba_one = ba_solve(prob, seq.cam, ba_opts)
    has = (prob.obs_cam >= 0).sum(1) >= 2
    cost_on = lambda cam: (lambda p: float(reprojection_cost(p, cam, BAOptions(huber_delta=1e9))))
    graft_np, graft_cam = graft_seam_problem(world)
    graft = BAProblem(*(torch.from_numpy(x).to(dev) for x in graft_np))
    graft_opts = BAOptions(max_iterations=GRAFT_MAX_ITERATIONS)
    graft_one = ba_solve(graft, graft_cam, graft_opts)
    graft_has = (graft.obs_cam >= 0).sum(1) >= 2
    graft_centers = -np.einsum("fji,fj->fi", graft_np[0], graft_np[1])
    graft_span = float(np.linalg.norm(graft_centers.max(0) - graft_centers.min(0)))

    # One float32 SuperPoint step at the global batch (TF32 off, cuDNN deterministic).
    cfg = TRAIN_MODELS["superpoint"]
    batch_np = make_batch(np.random.default_rng([TRAIN_SEED, 0, 0]), cfg["batch"], cfg["rows"], cfg["cols"],
                          rich_background=cfg["rich_background"])
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    state = init_state(SuperPoint(dtype=torch.float32), torch.Generator().manual_seed(TRAIN_SEED)).state_dict()

    def sp_step(dtype, step_mesh):
        model = SuperPoint(dtype=dtype).to(dev)
        model.load_state_dict(state)
        loss, aux = make_train_step(model, adam(model, TRAIN_LR), mesh=step_mesh)(batch)
        return (torch.stack([loss, aux["det"], aux["desc"]]).detach(),
                {n: p.grad.detach().clone() for n, p in model.named_parameters()},
                {n: p.detach().clone() for n, p in model.named_parameters()})

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    loss_one, grads_one, params_one = sp_step(torch.float32, None)
    ref64 = lambda: {n: g.double() for n, g in sp_step(torch.float64, None)[1].items()}

    # Rank k's one-card results against rank 0's.
    vs0 = {"main_path_exact": same_as_rank0([fa.uv, fa.response, fa.valid, wa, va, fb.uv, fb.response, fb.valid,
                                             wb, vb, m.index, m.distance, m.valid]),
           "harris_exact": same_as_rank0([harris])}
    pos_one = torch.from_numpy(vo_one.trajectory.positions).to(dev)
    pos0 = rank0_value(torch, pos_one)
    ate0 = float(rank0_value(torch, torch.tensor([ate_one], dtype=torch.float64, device=dev)))
    vs0["vo_position_max_abs_err_over_span"] = float((pos_one - pos0).abs().max()) / span
    vs0["vo_bitwise"] = bool(torch.equal(pos_one, pos0))
    vs0["ate_m"], vs0["rank0_ate_m"] = ate_one, ate0
    ba0 = ba_one._replace(**{f: rank0_value(torch, getattr(ba_one, f)) for f in ("rot", "trans", "points")})
    vs0["ba_solve"] = ba_agreement(torch, ba_one, ba0, span, has, cost_on(seq.cam))
    g0 = graft_one._replace(**{f: rank0_value(torch, getattr(graft_one, f)) for f in ("rot", "trans", "points")})
    vs0["ba_solve_graft"] = ba_agreement(torch, graft_one, g0, graft_span, graft_has, cost_on(graft_cam))
    loss0 = rank0_value(torch, loss_one)
    grads0 = {n: rank0_value(torch, g) for n, g in grads_one.items()}
    vs0["train_f32_loss_rel"] = float(((loss_one - loss0).abs() / loss0.abs()).max())
    vs0["train_f32_bitwise"] = bool(torch.equal(loss_one, loss0)) and all(torch.equal(grads_one[n], grads0[n])
                                                                         for n in grads0)
    vs0["train_f32_grads"] = grads_agreement(grads_one, grads0, ref64)
    wemit("one_card", seconds=time.perf_counter() - t, vo_ate_m=ate_one, vo_ate_share_of_span=ate_one / span,
          greedy_launches_vo=k2_one, against_rank0=vs0)
    expect(vs0["main_path_exact"] and vs0["harris_exact"], f"rank {rank}: one-card front-end or Harris != rank 0's")
    expect(vs0["vo_position_max_abs_err_over_span"] <= MULTI_VO_POS_ATOL and f"{ate_one:.4f}" == f"{ate0:.4f}",
          f"rank {rank}: one-card VO parts from rank 0's: {vs0}")
    expect(dense_ba_ok(vs0["ba_solve"]) and dense_ba_ok(vs0["ba_solve_graft"]),
          f"rank {rank}: one-card ba_solve parts from rank 0's: {vs0['ba_solve']}, {vs0['ba_solve_graft']}")
    expect(vs0["train_f32_loss_rel"] <= TRAIN_LOSS_RTOL and not vs0["train_f32_grads"]["failed"],
          f"rank {rank}: one-card float32 step parts from rank 0's: {vs0['train_f32_grads']}")

    # 3. Every multi-device path at this world against the one-card result.
    t = time.perf_counter()
    res = {}
    frontend = make_batched_frontend(mesh, "fast", PICKS, opts, brief_opts=bopts)
    torch.cuda.synchronize()
    greedy_select.launches = 0
    feats, words, dvalid = frontend(ja)
    torch.cuda.synchronize()
    k1_frontend = greedy_select.launches
    expect(k1_frontend == 2, f"rank {rank}: the front-end launched K1 {k1_frontend} times, not 2")
    expect(all(torch.equal(g, w) for g, w in ((feats.uv, fa.uv), (feats.response, fa.response),
                                           (feats.valid, fa.valid), (words, wa), (dvalid, va))),
          f"rank {rank}: the frame-parallel front-end differs from one card's")

    matcher = make_two_frame_matcher(mesh, "fast", PICKS, opts, brief_opts=bopts, matcher_opts=mopts)
    torch.cuda.synchronize()
    greedy_select.launches = 0
    ma_f, mb_f, mm = matcher(ja, jb)
    torch.cuda.synchronize()
    k1_matcher = greedy_select.launches
    expect(k1_matcher == 4, f"rank {rank}: the two-frame matcher launched K1 {k1_matcher} times, not 2 x 2")
    expect(all(torch.equal(getattr(g, k), getattr(w, k)) for g, w in ((ma_f, fa), (mb_f, fb))
              for k in ("uv", "response", "valid"))
          and all(torch.equal(getattr(mm, k), getattr(m, k)) for k in ("index", "distance", "valid")),
          f"rank {rank}: the two-frame matcher differs from one card's")
    res["matches_per_pair"] = float(mm.valid.sum(1).float().mean())

    # K1 against its plain version on this rank's block of the front-end's maps (not counted).
    ones = torch.ones(ja.shape[1:], dtype=torch.int32, device=dev)
    block = shard_leading(ja, mesh, "data")
    cand = fast_candidates(fast_response(block, ones), opts.min_valid_response)
    saved = greedy_select.launches
    got = greedy_select(cand, PICKS, PICKS, RADIUS)
    torch.cuda.synchronize()
    want = greedy_select_ref(cand, PICKS, PICKS, RADIUS)
    expect(all(torch.equal(g, w) for g, w in zip(got, want)), f"rank {rank}: K1 != plain on this rank's block")
    k1 = {"max_abs_err": max(errs[BATCH], max_abs_err(torch, got, want)),
          "ms": cuda_ms(torch, lambda: greedy_select(cand, PICKS, PICKS, RADIUS), 20),
          "device_ms": device_ms(torch, lambda: greedy_select(cand, PICKS, PICKS, RADIUS), GREEDY_KERNELS, 10),
          "plain_ms": cuda_ms(torch, lambda: greedy_select_ref(cand, PICKS, PICKS, RADIUS), 3)}
    greedy_select.launches = saved

    # Row-sharded Harris: ROWS / world rows a rank, halos from one or two neighbours.
    space = make_mesh((world,), ("space",), device=dev.type)
    rows_fn = make_row_sharded_response(space, "harris", ropts)
    slab_img, slab_mask = shard_leading(frame, space, "space"), shard_leading(fmask, space, "space")
    expect(torch.equal(gather_leading(rows_fn(slab_img, slab_mask), space, "space"), harris),
          f"rank {rank}: row-sharded Harris differs from harris_response")
    res["row_sharded_rows_per_rank"] = int(slab_img.shape[0])

    # The distributed BA: the VO's global problem (dense and camera-sharded) and the seam case.
    dense_ba = make_distributed_ba(mesh, seq.cam, ba_opts)
    cg_ba = make_distributed_ba(mesh, seq.cam, ba_opts, camera_shard=True)
    graft_dense = make_distributed_ba(mesh, graft_cam, graft_opts)
    graft_cg = make_distributed_ba(mesh, graft_cam, graft_opts, camera_shard=True,
                                   cg_iterations=GRAFT_CG_ITERATIONS)
    ba = {"dense": ba_agreement(torch, dense_ba(prob), ba_one, span, has, cost_on(seq.cam)),
          "camera_shard": ba_agreement(torch, cg_ba(prob), ba_one, span, has, cost_on(seq.cam)),
          "graft_dense": ba_agreement(torch, graft_dense(graft), graft_one, graft_span, graft_has,
                                      cost_on(graft_cam)),
          "graft_camera_shard": ba_agreement(torch, graft_cg(graft), graft_one, graft_span, graft_has,
                                             cost_on(graft_cam))}
    ba["graft_initial_cost"] = cost_on(graft_cam)(graft)
    res["ba"] = ba
    expect(dense_ba_ok(ba["dense"]) and dense_ba_ok(ba["graft_dense"]),
          f"rank {rank}: the dense distributed BA parts from ba_solve: {ba['dense']}, {ba['graft_dense']}")
    expect(cg_ba_ok(ba["camera_shard"]) and cg_ba_ok(ba["graft_camera_shard"], ba["graft_initial_cost"]),
          f"rank {rank}: the camera-sharded BA parts from ba_solve: {ba['camera_shard']}, {ba['graft_camera_shard']}")

    # The VO over the mesh (K2, K4 and K5 counted) against one card's: this rank solves its block of the chunk
    # batch (padded with empty problems to a multiple of the world); the largest K4 and K5 calls are kept.
    torch.cuda.synchronize()
    greedy_select.launches = FO.fixed_contract.launches = FO.fixed_lu_solve.launches = 0
    stages_cold = {}
    with largest_fixed_calls(torch) as fixed_calls, chunk_blocks() as blocks:
        vo_mesh = run_visual_odometry_chunked(imgs, seq.cam, mesh=mesh, stage_seconds=stages_cold)
    torch.cuda.synchronize()
    k2_mesh = greedy_select.launches
    fixed_mesh = {"contract": FO.fixed_contract.launches, "lu_solve": FO.fixed_lu_solve.launches}
    n_chunks = len(vo_chunk_starts())
    expect(k2_mesh == 2 * VO_FRAMES, f"rank {rank}: the VO over the mesh launched K2 {k2_mesh} times, not 2 x {VO_FRAMES}")
    expect(blocks == [-(-n_chunks // world)], f"rank {rank}: solve_chunks was handed {blocks} chunk problems, not "
           f"[{-(-n_chunks // world)}] of {n_chunks} padded to {-(-n_chunks // world) * world}")
    expect(all(v > 0 for v in fixed_mesh.values()), f"rank {rank}: the VO over the mesh launched K4/K5 {fixed_mesh}")
    pos = vo_mesh.trajectory.positions
    expect(pos.shape == (VO_FRAMES, 3) and bool(np.isfinite(pos).all()), f"rank {rank}: VO over the mesh not finite")
    ate_mesh = float(ate_rmse(pos, gt, with_scale=True))
    pos_err = float(np.abs(pos - vo_one.trajectory.positions).max()) / span
    ranks_agree = same_as_rank0([torch.from_numpy(pos).to(dev)])
    res["vo"] = {"ate_m": ate_mesh, "ate_share_of_span": ate_mesh / span, "one_card_ate_m": ate_one,
                 "position_max_abs_err_over_span": pos_err, "tolerance_over_span": MULTI_VO_POS_ATOL,
                 "bitwise": bool(np.array_equal(pos, vo_one.trajectory.positions)), "greedy_launches": k2_mesh,
                 "ranks_bitwise": ranks_agree, "stages_cold_s": stages_cold, "chunk_blocks": blocks,
                 "chunks": n_chunks, "chunk_solve_s": stages_cold["chunk_solve"],
                 "one_card_chunk_solve_s": stages_one_cold["chunk_solve"], "fixed_launches": fixed_mesh}
    expect(ate_mesh <= VO_ATE_SPAN_SHARE * span, f"rank {rank}: VO over the mesh: ATE {ate_mesh} m of {span} m")
    expect(ranks_agree, f"rank {rank}: the VO over the mesh differs from rank 0's")
    expect(pos_err <= MULTI_VO_POS_ATOL, f"rank {rank}: the VO over the mesh parts from one card's: {res['vo']}")
    expect(res["vo"]["bitwise"], f"rank {rank}: the VO over the mesh is not one card's, bit for bit")
    fixed_entries, fixed_exact = fixed_kernel_entries(torch, fixed_calls, fixed_mesh, "the VO over the mesh")
    res["fixed_exact"] = fixed_exact
    expect(all(fixed_exact.values()), f"rank {rank}: K4/K5 != plain on the VO's largest calls: {fixed_exact}")
    res["fixed_signatures"] = fixed_signature_checks(torch, fixed_calls["signatures"])
    check_fixed_signatures(res["fixed_signatures"], expect, f"rank {rank}'s VO over the mesh")

    # The collectives alone, all ranks after a barrier: the dense BA's packed system (float64, n6^2 + n6 + 1
    # values), the camera-sharded CG's all-gather of a block of rows, SuperPoint's flat float32 gradient.
    n6 = 6 * int(prob.rot.shape[0])
    n_grad = sum(g.numel() for g in grads_one.values())
    collectives = {}
    for name, numel, dtype, gather in (("all_reduce_ba_system", n6 * n6 + n6 + 1, torch.float64, False),
                                       ("all_gather_cg_rows", -(-n6 // world), torch.float64, True),
                                       ("all_reduce_gradient", n_grad, torch.float32, False)):
        x = torch.ones(numel, dtype=dtype, device=dev)
        parts = [torch.empty_like(x) for _ in range(world)]
        call = (lambda x=x, parts=parts: dist.all_gather(parts, x)) if gather else (lambda x=x: dist.all_reduce(x))
        t_c = rep_times(torch, call, WORLD_REPS["collective"], WORLD_WARMUP, dist.barrier)
        nbytes = numel * x.element_size()
        ms = t_c["event_ms"]["median"]
        # NCCL's bus rate: an all-reduce moves 2 (n - 1) / n of the buffer a rank, an all-gather (n - 1) of it.
        moved = nbytes * (2 * (world - 1) / world if not gather else world - 1)
        collectives[name] = {"bytes_a_rank": nbytes, **t_c, "bus_gb_per_s": moved / (ms / 1e3) / 1e9}

    # K2 against its plain version on the VO's frame-0 top-up map (not counted).
    det = DetectorOptions(min_feature_distance=10, min_valid_response=20.0, max_features=256, subpixel=True)
    cand2, _ = detection_maps(imgs[0], Features.empty(det.max_features, dev), "harris", det)
    saved = greedy_select.launches
    got = greedy_select(cand2, 200, 200, det.min_feature_distance)
    torch.cuda.synchronize()
    want = greedy_select_ref(cand2, 200, 200, det.min_feature_distance)
    expect(all(torch.equal(g, w) for g, w in zip(got, want)), f"rank {rank}: K2 != plain on the VO's frame-0 map")
    k2 = {"max_abs_err": max(errs[1], max_abs_err(torch, got, want)),
          "ms": cuda_ms(torch, lambda: greedy_select(cand2, 200, 200, det.min_feature_distance), 50),
          "device_ms": device_ms(torch, lambda: greedy_select(cand2, 200, 200, det.min_feature_distance),
                                 GREEDY_KERNELS, 20),
          "plain_ms": cuda_ms(torch, lambda: greedy_select_ref(cand2, 200, 200, det.min_feature_distance), 2)}
    greedy_select.launches = saved

    # The data-parallel float32 step at the same global batch against one card's.
    loss_w, grads_w, params_w = sp_step(torch.float32, mesh)
    torch.backends.cudnn.deterministic = False
    train = {"loss_rel": float(((loss_w - loss_one).abs() / loss_one.abs()).max()),
             "batch_per_rank": cfg["batch"] // world,
             "ranks_bitwise": same_as_rank0([loss_w, *grads_w.values(), *params_w.values()]),
             "grads": grads_agreement(grads_w, grads_one, ref64)}
    res["train_f32"] = train
    expect(train["ranks_bitwise"], f"rank {rank}: the data-parallel step's gradients or parameters differ from "
          "rank 0's")
    expect(train["loss_rel"] <= TRAIN_LOSS_RTOL and not train["grads"]["failed"],
          f"rank {rank}: the data-parallel float32 step parts from one card's: {train}")
    wemit("paths", seconds=time.perf_counter() - t, greedy_launches_frontend=k1_frontend,
          greedy_launches_matcher=k1_matcher, k1=k1, k2=k2, collectives=collectives, **res)

    # 4. Times: one card against the world on the same work (strong), and at one card's work a rank (weak).
    t = time.perf_counter()
    barrier = dist.barrier
    reps = WORLD_REPS
    times, prof = {}, {}

    def one_card_alone(fn, r, warmup=WORLD_WARMUP):
        """Rank 0 times ``fn`` while the other ranks wait at a barrier: the
        host-paced paths then have the host to themselves, as on one card."""
        t_one = rep_times(torch, fn, r, warmup) if lead else None
        barrier()
        return t_one

    def both(name, one_fn, world_fn, r, warmup=WORLD_WARMUP, profile=True):
        times[name] = {"one_card": one_card_alone(one_fn, r, warmup),
                       "world": rep_times(torch, world_fn, r, warmup, barrier)}
        if profile:
            prof[name] = profiled_call(torch, world_fn, lead)

    both("frontend", lambda: detect_describe(ja), lambda: frontend(ja), reps["fast"])
    both("two_frame_matcher", pair_matcher, lambda: matcher(ja, jb), reps["fast"])
    both("row_sharded_harris", lambda: harris_response(frame, fmask, ropts), lambda: rows_fn(slab_img, slab_mask),
         reps["fast"])
    both("ba_dense", lambda: ba_solve(prob, seq.cam, ba_opts), lambda: dense_ba(prob), reps["ba"], 1)
    times["ba_camera_shard"] = {"one_card": times["ba_dense"]["one_card"],
                                "world": rep_times(torch, lambda: cg_ba(prob), reps["ba"], 1, barrier)}
    prof["ba_camera_shard"] = profiled_call(torch, lambda: cg_ba(prob), lead)
    both("ba_graft_dense", lambda: ba_solve(graft, graft_cam, graft_opts), lambda: graft_dense(graft), reps["fast"])
    times["ba_graft_camera_shard"] = {"one_card": times["ba_graft_dense"]["one_card"],
                                      "world": rep_times(torch, lambda: graft_cg(graft), reps["fast"],
                                                         WORLD_WARMUP, barrier)}
    stages_one, stages_mesh = {}, {}
    both("vo", lambda: run_visual_odometry_chunked(imgs, seq.cam, stage_seconds=stages_one),
         lambda: run_visual_odometry_chunked(imgs, seq.cam, mesh=mesh, stage_seconds=stages_mesh), reps["vo"], 0,
         profile=False)
    # The VO's busy share on every rank: these paths are host-paced.
    vo_busy = prof["vo"] = profiled_call(torch, lambda: run_visual_odometry_chunked(imgs, seq.cam, mesh=mesh), True)

    # bfloat16 SuperPoint steps: the global batch on one card and over the world (strong), and the same
    # batch a rank over the world (weak).
    bstate = init_state(SuperPoint(dtype=torch.bfloat16), torch.Generator().manual_seed(TRAIN_SEED)).state_dict()

    def bf16_step(step_batch, step_mesh):
        model = SuperPoint(dtype=torch.bfloat16).to(dev)
        model.load_state_dict(bstate)
        step = make_train_step(model, adam(model, TRAIN_LR), mesh=step_mesh)
        return lambda: step(step_batch)

    weak_batch = {k: torch.cat([v] * world) for k, v in batch.items()}
    both("train_bf16", bf16_step(batch, None), bf16_step(batch, mesh), reps["train"])
    times["train_bf16_weak"] = {"one_card": times["train_bf16"]["one_card"],
                                "world": rep_times(torch, bf16_step(weak_batch, mesh), reps["train"], WORLD_WARMUP,
                                                   barrier)}
    prof["train_bf16_weak"] = profiled_call(torch, bf16_step(weak_batch, mesh), lead)

    # The front-end at one card's 64 frames a rank: the main batch on every rank's block.
    weak_frames = torch.cat([ja] * world)
    wf, ww, wv = frontend(weak_frames)
    expect(all(torch.equal(g, torch.cat([w] * world)) for g, w in ((wf.uv, fa.uv), (wf.valid, fa.valid), (ww, wa),
                                                                 (wv, va))),
          f"rank {rank}: the front-end at {BATCH} frames a rank differs from one card's batch")
    times["frontend_weak"] = {"one_card": times["frontend"]["one_card"],
                              "world": rep_times(torch, lambda: frontend(weak_frames), reps["fast"], WORLD_WARMUP,
                                                 barrier)}
    prof["frontend_weak"] = profiled_call(torch, lambda: frontend(weak_frames), lead)

    median = lambda name, side: times[name][side]["event_ms"]["median"]
    strong = {name: {"one_card_ms": median(name, "one_card"), "world_ms": median(name, "world"),
                     "speedup": median(name, "one_card") / median(name, "world")}
              for name in times if lead and not name.endswith("_weak")}
    weak = {name: {"one_card_ms": median(name, "one_card"), "world_ms": median(name, "world"),
                   "efficiency": median(name, "one_card") / median(name, "world")}
            for name in times if lead and name.endswith("_weak")}
    per_rank_steps = lambda st: {k: v / reps["vo"] for k, v in st.items()}
    wemit("times", seconds=time.perf_counter() - t, times=times, profiled=prof, vo_busy=vo_busy,
          vo_stage_s_one_card=per_rank_steps(stages_one), vo_stage_s_world=per_rank_steps(stages_mesh))

    out.update(greedy_launches_frontend=k1_frontend, greedy_launches_matcher=k1_matcher,
               greedy_launches_vo=k2_mesh, vo_chunk_blocks=blocks, vo_chunk_solve_s=stages_cold["chunk_solve"],
               vo_one_card_chunk_solve_s=stages_one_cold["chunk_solve"], vo_fixed_launches=fixed_mesh,
               vo_ate_share_of_span=ate_mesh / span,
               vo_position_max_abs_err_over_span=pos_err, vo_bitwise=res["vo"]["bitwise"],
               vo_busy_share=vo_busy["busy_share"], vo_busy_ms=vo_busy["busy_ms"],
               vo_event_ms=vo_busy["event_ms"], vo_nccl_share_of_busy=vo_busy["nccl_share_of_busy"],
               train_f32_loss_rel=train["loss_rel"], seconds=time.perf_counter() - t_rank)
    check(not failed, f"rank {rank}: {len(failed)} check(s) failed: " + "; ".join(failed))
    out["scaling"] = {"strong": strong, "weak": weak, "times": times, "profiled_rank0": prof,
                      "collectives": collectives}
    out["kernels"] = [
        {"name": "greedy_select (batch)", "route": "cuda", "source": SOURCE,
         "replaces": "feature_detector_tpu/kernels/greedy_pallas.py:145", "launches": k1_frontend,
         "launches_two_frame_matcher": k1_matcher, "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "device_ms": k1["device_ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": greedy_bound_ms(BATCH // world, ROWS, COLS, PICKS), "bound_by": "bytes", "library_ms": None,
         "shape_per_rank": [BATCH // world, ROWS, COLS], "world": world},
        {"name": "greedy_select (single frame)", "route": "cuda", "source": SOURCE,
         "replaces": "feature_detector_tpu/kernels/greedy_pallas.py:35", "launches": k2_mesh,
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"], "device_ms": k2["device_ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": greedy_bound_ms(1, int(seq.images.shape[1]), int(seq.images.shape[2]), 200),
         "bound_by": "bytes", "library_ms": None, "path": "the VO over the mesh", "world": world},
        *({**e, "world": world} for e in fixed_entries),
    ]
    return out


def single_card_main() -> int:
    """The run on one card (no arguments): every phase, then the kernel
    line, the card's name and power limit, and the last line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2

    from feature_detector_tpu_torch.core.config import BriefOptions, DetectorOptions, FastOptions, MatcherOptions
    from feature_detector_tpu_torch.core.types import Features
    from feature_detector_tpu_torch.frontend.descriptor import compute_descriptors
    from feature_detector_tpu_torch.frontend.detector import detect_good_features, detect_good_features_batch
    from feature_detector_tpu_torch.kernels import _build
    from feature_detector_tpu_torch.kernels.detect import (
        fast_candidates,
        fast_response,
        greedy_select_ref,
        make_suppression_mask,
    )
    from feature_detector_tpu_torch.kernels.fast import fast_maps
    from feature_detector_tpu_torch.kernels.greedy import greedy_select
    from feature_detector_tpu_torch.match.hamming import match_hamming

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # 1. Device.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi)

    # 2. Build every kernel from the sources in the checkout.
    t = time.perf_counter()
    report = _build.build(ptxas_verbose=True)
    emit("build", seconds=time.perf_counter() - t,
         kernels={k: {"nvcc_seconds": v["seconds"],
                      "ptxas": [ln.strip() for ln in v["log"].splitlines() if "Used" in ln or "spill" in ln]}
                  for k, v in report.items()})

    # 3. Kernel against its plain version on the card, at main-path shapes,
    #    at the tiled design's seams and on a large frame.
    errs, dense_t = greedy_checks(torch, dev)

    # 4. Main path: 64 frame pairs from 8 seeded scenes.
    t = time.perf_counter()
    scenes, frames_a, frames_b = main_frames()
    emit("frames", shape=list(frames_a.shape), seconds=time.perf_counter() - t)
    opts = DetectorOptions(**MAIN_DETECTOR)
    bopts, mopts = BriefOptions(), MatcherOptions()
    ja = torch.from_numpy(frames_a).to(dev)
    jb = torch.from_numpy(frames_b).to(dev)

    def pipeline():
        fa = detect_good_features_batch(ja, "fast", PICKS, opts)
        fb = detect_good_features_batch(jb, "fast", PICKS, opts)
        da = compute_descriptors(ja, fa, bopts)
        db = compute_descriptors(jb, fb, bopts)
        return fa, fb, da, db, match_hamming(da.words, da.valid, db.words, db.valid, mopts)

    greedy_select.launches = 0
    fast_maps.launches = 0
    fa, fb, da, db, m = pipeline()
    torch.cuda.synchronize()
    batch_launches, fast_launches = greedy_select.launches, fast_maps.launches
    check(batch_launches == 4, f"main path launched the greedy kernels {batch_launches} times, not 2 x 2")
    check(fast_launches == 2, f"main path launched the FAST kernel {fast_launches} times, not 2")
    check(fa.uv.shape == (BATCH, PICKS, 2) and da.words.shape == (BATCH, PICKS, 8), "output shapes")
    check(bool(torch.isfinite(fa.uv).all() and torch.isfinite(fa.response).all()), "finite features")
    kpts = fa.count.float().mean().item()
    check(kpts > 10, f"too few keypoints per frame: {kpts}")
    self_m = match_hamming(da.words, da.valid, da.words, da.valid, mopts)
    check(bool(torch.equal(self_m.valid, da.valid)), "self-match: every describable feature matches")
    check(bool((self_m.distance[da.valid] == 0).all()), "self-match distance 0")
    emit("main_path", batch=BATCH, rows=ROWS, cols=COLS, greedy_launches=batch_launches, fast_launches=fast_launches,
         keypoints_per_frame=kpts, describable_per_frame=da.count.float().mean().item(),
         matches_per_pair=m.count.float().mean().item(),
         self_matches=int(self_m.count.sum()), describable=int(da.count.sum()))

    # The card's output against the port's CPU run (plain versions) on two pairs.
    excused = 0
    cpu = torch.device("cpu")
    for i in (0, 9):
        ca = detect_good_features_batch(torch.from_numpy(frames_a[i : i + 1]), "fast", PICKS, opts)
        cb = detect_good_features_batch(torch.from_numpy(frames_b[i : i + 1]), "fast", PICKS, opts)
        for got, want in ((fa, ca), (fb, cb)):
            check(all(torch.equal(getattr(got, k)[i].to(cpu), getattr(want, k)[0]) for k in ("uv", "response", "valid")),
                  f"features of frame {i} differ from the CPU run")
        cda = compute_descriptors(torch.from_numpy(frames_a[i : i + 1]), ca, bopts)
        cdb = compute_descriptors(torch.from_numpy(frames_b[i : i + 1]), cb, bopts)
        for got, want, frame, feats in ((da, cda, frames_a[i], ca), (db, cdb, frames_b[i], cb)):
            differ = (got.words[i].cpu() != want.words[0]).any(1).numpy() | (got.valid[i].cpu() != want.valid[0]).numpy()
            near = near_bin_boundary(frame, feats.uv[0].numpy())
            check(not (differ & ~near).any(), f"descriptors of frame {i} differ from the CPU run")
            excused += int(differ.sum())
        if excused == 0:
            cm = match_hamming(cda.words, cda.valid, cdb.words, cdb.valid, mopts)
            check(all(torch.equal(getattr(m, k)[i].cpu(), getattr(cm, k)[0]) for k in ("index", "distance", "valid")),
                  f"matches of pair {i} differ from the CPU run")
    emit("cpu_agreement", pairs=[0, 9], features_exact=True, bin_boundary_excused=excused)

    # 5. Incremental path: one frame, half of an earlier detection as existing.
    n_half = int(fa.count[0]) // 2
    keep = torch.arange(PICKS, device=dev) < n_half
    existing = Features(uv=fa.uv[0] * keep[:, None], response=fa.response[0] * keep, valid=fa.valid[0] & keep)
    frame1 = jb[0]
    greedy_select.launches = 0
    fast_maps.launches = 0
    inc = detect_good_features(frame1, existing, "fast", PICKS, opts)
    torch.cuda.synchronize()
    single_launches = greedy_select.launches
    check(single_launches == 2, f"incremental path launched the greedy kernels {single_launches} times, not 2")
    inc_fast_launches = fast_maps.launches
    check(inc_fast_launches == 1, f"incremental path launched the FAST kernel {inc_fast_launches} times, not 1")
    check(bool(torch.equal(inc.uv[:n_half], existing.uv[:n_half]) and inc.valid[:n_half].all()), "existing prefix kept")
    n_total = int(inc.count)
    new_uv = inc.uv[n_half:n_total].cpu().numpy()
    old_uv = existing.uv[:n_half].cpu().numpy()
    inside = (np.abs(new_uv[:, None, :] - old_uv[None, :, :]) <= RADIUS).all(-1)
    check(n_total > n_half and not inside.any(), "new picks fall outside every existing square")
    cpu_inc = detect_good_features(frame1.cpu(), existing.to("cpu"), "fast", PICKS, opts)
    check(all(torch.equal(getattr(inc, k).cpu(), getattr(cpu_inc, k)) for k in ("uv", "response", "valid")),
          "incremental result differs from the CPU run")
    emit("incremental_path", existing=n_half, total=n_total, greedy_launches=single_launches,
         fast_launches=inc_fast_launches)

    # Kernels against plain on the paths' own inputs and candidate maps
    # (not counted): K6 on the main path's frames (no mask) and on the
    # incremental frame with its suppression mask, both maps, one launch a
    # call; then K1 on the plain chain's candidate maps.
    sub, thr = FastOptions(), opts.min_valid_response
    ones = torch.ones((ROWS, COLS), dtype=torch.int32, device=dev)
    resp_batch = fast_response(ja, ones, sub)
    cand_batch = fast_candidates(resp_batch, thr)
    mask1 = make_suppression_mask((ROWS, COLS), existing.uv, existing.valid, RADIUS)
    resp_one = fast_response(frame1, mask1, sub)
    cand_one = fast_candidates(resp_one, thr)
    fast_maps.launches = 0
    k6_b = fast_maps(ja, None, sub, thr, True)
    k6_b_cand_only = fast_maps(ja, None, sub, thr, False)
    k6_1 = fast_maps(frame1, mask1, sub, thr, True)
    torch.cuda.synchronize()
    check(fast_maps.launches == 3, f"three fast_maps calls made {fast_maps.launches} launches")
    check(k6_b_cand_only[1] is None, "fast_maps wrote a response map that was not asked for")
    for (got_c, got_r), want_c, want_r, what in ((k6_b, cand_batch, resp_batch, "the main path's frames"),
                                                 (k6_1, cand_one, resp_one, "the incremental frame")):
        check(torch.equal(got_c, want_c) and torch.equal(got_r, want_r), f"K6 != plain chain on {what}")
    check(torch.equal(k6_b_cand_only[0], cand_batch), "K6 (candidate map only) != plain chain on the main path")
    k6_err = max_abs_err(torch, (*k6_b, *k6_1), (cand_batch, resp_batch, cand_one, resp_one))
    stop_one = torch.tensor([PICKS - n_half], dtype=torch.int32, device=dev)
    got_b = greedy_select(cand_batch, PICKS, PICKS, RADIUS)
    want_b = greedy_select_ref(cand_batch, PICKS, PICKS, RADIUS)
    got_1 = greedy_select(cand_one, PICKS, stop_one, RADIUS)
    want_1 = greedy_select_ref(cand_one, PICKS, stop_one, RADIUS)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got_b, want_b)), "kernel != plain on the main path's maps")
    check(all(torch.equal(g, w) for g, w in zip(got_1, want_1)), "kernel != plain on the incremental map")
    errs[BATCH] = max(errs[BATCH], max_abs_err(torch, got_b, want_b))
    errs[1] = max(errs[1], max_abs_err(torch, got_1, want_1))

    # 6. Times (CUDA events, after a warm-up).  One block runs each frame's
    # pick chain, so the batch lasts as long as its longest chain: the frame
    # with the most picks is also timed alone.
    picks_b64 = got_b[2].sum(1)
    positives = (cand_batch > 0).sum((1, 2)).float()
    busiest = int(picks_b64.argmax())
    clocks = "clocks.sm,clocks.max.sm,power.draw"
    clocks_before = nvidia_smi_line(clocks)
    times = {
        "greedy_ms_b64": cuda_ms(torch, lambda: greedy_select(cand_batch, PICKS, PICKS, RADIUS), 20),
        "greedy_plain_ms_b64": cuda_ms(torch, lambda: greedy_select_ref(cand_batch, PICKS, PICKS, RADIUS), 3),
        "greedy_ms_b1": cuda_ms(torch, lambda: greedy_select(cand_one, PICKS, stop_one, RADIUS), 50),
        "greedy_plain_ms_b1": cuda_ms(torch, lambda: greedy_select_ref(cand_one, PICKS, stop_one, RADIUS), 5),
        "greedy_ms_b64_dense_200_picks": cuda_ms(torch, lambda: greedy_select(dense_t, PICKS, PICKS, RADIUS), 5),
        "greedy_ms_b1_dense_200_picks": cuda_ms(torch, lambda: greedy_select(dense_t[0], PICKS, PICKS, RADIUS), 10),
        "greedy_ms_b1_busiest_frame": cuda_ms(torch, lambda: greedy_select(cand_batch[busiest], PICKS, PICKS, RADIUS), 10),
    }
    times["greedy_device_ms_b64"] = device_ms(torch, lambda: greedy_select(cand_batch, PICKS, PICKS, RADIUS), GREEDY_KERNELS, 10)
    times["greedy_device_ms_b1"] = device_ms(torch, lambda: greedy_select(cand_one, PICKS, stop_one, RADIUS), GREEDY_KERNELS, 20)
    def fast_b64():
        return fast_maps(ja, None, sub, thr, False)

    def fast_b1():
        return fast_maps(frame1, mask1, sub, thr, False)

    times.update({
        "fast_ms_b64": cuda_ms(torch, fast_b64, 50),
        "fast_device_ms_b64": device_ms(torch, fast_b64, FAST_KERNELS, 10),
        "fast_ms_b64_with_response": cuda_ms(torch, lambda: fast_maps(ja, None, sub, thr, True), 50),
        "fast_plain_ms_b64": cuda_ms(torch, lambda: fast_candidates(fast_response(ja, ones, sub), thr), 2),
        "fast_ms_b1": cuda_ms(torch, fast_b1, 50),
        "fast_device_ms_b1": device_ms(torch, fast_b1, FAST_KERNELS, 20),
        "fast_plain_ms_b1": cuda_ms(torch, lambda: fast_candidates(fast_response(frame1, mask1, sub), thr), 5),
    })
    detect_ms = cuda_ms(torch, lambda: detect_good_features_batch(ja, "fast", PICKS, opts), 10)
    describe_ms = cuda_ms(torch, lambda: compute_descriptors(ja, fa, bopts), 10)
    match_ms = cuda_ms(torch, lambda: match_hamming(da.words, da.valid, db.words, db.valid, mopts), 10)
    torch.cuda.reset_peak_memory_stats()
    pipe_ms = cuda_ms(torch, pipeline, 10)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    t0 = time.perf_counter()
    for _ in range(5):
        pipeline()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 5 * 1e3
    emit("times", card=smi, sm_clock_max_clock_power_before=clocks_before,
         sm_clock_max_clock_power_after=nvidia_smi_line(clocks), **times,
         greedy_picks_per_frame_b64_mean=float(picks_b64.float().mean()),
         greedy_picks_per_frame_b64_max=int(picks_b64.max()),
         positive_candidates_per_frame_b64_mean=float(positives.mean()),
         positive_candidates_per_frame_b64_max=int(positives.max()),
         detect_ms_per_frame=detect_ms / BATCH, describe_ms_per_frame=describe_ms / BATCH,
         match_ms_per_pair=match_ms / BATCH, pipeline_ms_per_step=pipe_ms,
         pipeline_frames_per_s=2 * BATCH / (pipe_ms / 1e3),
         pipeline_wall_frames_per_s=2 * BATCH / (wall_ms / 1e3), peak_memory_mib=peak_mib,
         library_call="none")

    lsd_kernel = lsd_phase(torch, dev, scenes, smi)
    nn_k2 = nn_phase(torch, dev, smi)
    vo_k2, vo_run, (k4, k5) = vo_phase(torch, dev, smi)
    multi_k1, multi_k2, multi_fixed = multi_phase(
        torch, dev, smi, {"ja": ja, "jb": jb, "opts": opts, "bopts": bopts, "mopts": mopts, "fa": fa, "fb": fb,
                          "da": da, "m": m}, vo_run)
    train_k2 = train_phase(torch, dev, smi)
    demo_k2, demo_k3 = demo_phase(torch, dev, smi)
    legacy_k1, legacy_k2 = legacy_phase(torch, dev, smi)
    oracle_launches = oracle_phase(torch, dev, smi)
    lsd_kernel["demo_path"] = demo_k3
    lsd_kernel["oracle_path"] = {"launches": oracle_launches["k3"], "path": "detect_good_lines against the LSD oracle"}

    kernels = [
        {"name": "greedy_select (batch)", "route": "cuda", "source": SOURCE,
         "replaces": "feature_detector_tpu/kernels/greedy_pallas.py:145",
         "launches": batch_launches, "max_abs_err": errs[BATCH],
         "ms": times["greedy_ms_b64"], "device_ms": times["greedy_device_ms_b64"], "plain_ms": times["greedy_plain_ms_b64"],
         "bound_ms": greedy_bound_ms(BATCH, ROWS, COLS, PICKS), "bound_by": "bytes", "library_ms": None,
         "multi_path": multi_k1, "legacy_path": legacy_k1,
         "oracle_path": {"launches": oracle_launches["k1"], "path": "greedy_select at B = 8 against the oracle"}},
        {"name": "greedy_select (single frame)", "route": "cuda", "source": SOURCE,
         "replaces": "feature_detector_tpu/kernels/greedy_pallas.py:35",
         "launches": single_launches, "max_abs_err": errs[1],
         "ms": times["greedy_ms_b1"], "device_ms": times["greedy_device_ms_b1"], "plain_ms": times["greedy_plain_ms_b1"],
         "bound_ms": greedy_bound_ms(1, ROWS, COLS, PICKS), "bound_by": "bytes", "library_ms": None,
         "nn_path": nn_k2, "vo_path": vo_k2, "multi_path": multi_k2, "train_path": train_k2,
         "demo_path": demo_k2, "legacy_path": legacy_k2,
         "oracle_path": {"launches": oracle_launches["k2"], "path": "detect, tiles, B = 1 and NN selection against the oracles"}},
        lsd_kernel,
        {**k4, "multi_path": {"launches": multi_fixed["contract"], "path": "the VO over a mesh of one"}},
        {**k5, "multi_path": {"launches": multi_fixed["lu_solve"], "path": "the VO over a mesh of one"}},
        {"name": "fast_maps (K6)", "route": "cuda", "source": FAST_SOURCE,
         "replaces": "none: the JAX package's FAST is jnp ops (feature_detector_tpu/kernels/detect.py:124)",
         "launches": fast_launches, "max_abs_err": k6_err,
         "ms": times["fast_ms_b64"], "device_ms": times["fast_device_ms_b64"], "plain_ms": times["fast_plain_ms_b64"],
         "bound_ms": fast_bound_ms(ja.numel(), False), "bound_by": "bytes", "library_ms": None,
         "with_response": {"ms": times["fast_ms_b64_with_response"], "bound_ms": fast_bound_ms(ja.numel(), True)},
         "single_frame": {"launches": inc_fast_launches, "ms": times["fast_ms_b1"],
                          "device_ms": times["fast_device_ms_b1"], "plain_ms": times["fast_plain_ms_b1"],
                          "bound_ms": fast_bound_ms(frame1.numel(), False),
                          "path": "detect_good_features on one frame with the suppression mask"}},
    ]
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on the card(s).")
    ap.add_argument("--world", type=int, default=1,
                    help="1 (default): every phase on one card; N > 1: the multi-device paths on N cards, one "
                         "process each, held against one card")
    ap.add_argument("--rank-process", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.world < 1:
        ap.error("--world must be at least 1")
    if args.rank_process:
        return rank_main(args.world)
    if args.world > 1:
        return world_main(args.world)
    return single_card_main()


if __name__ == "__main__":
    sys.exit(main())
