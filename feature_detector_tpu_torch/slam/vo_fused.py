"""Fused chunked visual odometry, on one device or over a mesh.

Counterpart of ``feature_detector_tpu/slam/vo_fused.py``:

1. front-end: the scan front-end over the whole sequence
   (``sequence.scan_frontend``), greedy selection (K2) on the card;
2. match + gate: Hamming matching at frame offsets 1..4 and powers of two,
   every pair as one batch, then one batched epipolar RANSAC gate over all
   pairs (carry links included);
3. tracks: the conflict-rejecting union-find on the host;
4. chunk solves: every overlapping chunk is a fixed-shape problem (two-view
   init on the widest in-chunk pair, pose interpolation, rounds of PnP per
   frame, midpoint re-triangulation and bundle adjustment), and all chunks,
   each from two candidate init pairs, run as one batch of tensor
   operations (``solve_chunks``);
5. compose: Sim(3) handoff over the overlap frames (host);
6. pose graph over per-chunk relative-pose edges;
7. global BA over the merged tracks, PnP re-registration of every frame,
   and a final BA.

Precision as in the JAX package off the TPU: the chunk solver's BA solves
in float32 with one refinement step, the global BA in float64; products
never run in TF32 (the entry refuses it).  The RANSAC draws come from a CPU
``torch.Generator`` (``geometry.ransac_gumbel``), the same on every device.
The chunk solver's float32 products, sums and dense solves go through
``fixed.py`` (K4 and K5 on the card): a chunk's solution depends on its own
problem only, not on how many chunks share its batch.

With ``mesh`` (a ``DeviceMesh``, one rank per device) the chunk batch is
split over the mesh's ``data`` axis, as the JAX package splits it: padded
with empty chunk problems (zero tracks, so ``chunk_ok`` is False) to a
multiple of the ranks, each rank solves its block, and an all-gather brings
every block to every rank.  The global BA runs landmark-sharded
(``ba.make_distributed_ba``).  Every other stage runs replicated on every
rank, the same on each (the RANSAC draws come from the CPU generator), so
each rank returns one device's result, bit for bit.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import BAOptions, BriefOptions, DetectorOptions, MatcherOptions
from ..core.device import DeviceLike, as_tensor
from ..match.hamming import match_hamming
from ..parallel.mesh import gather_leading, mesh_device, shard_leading
from ..utils.log import report_warn
from . import fixed, geometry
from .ba import BAProblem, _ba_solve_impl, _poses_per_obs, ba_solve, check_no_tf32, make_distributed_ba
from .camera import Pinhole
from .lie import eye3, rotate, so3_exp, so3_log
from .linalg3 import solve3
from .pose_graph import PoseGraph, pose_graph_solve
from .sequence import Trajectory, VOResult, build_tracks_conflict_free, sanitize_chunk_poses, scan_frontend


# --------------------------------------------------------------------------
# Midpoint triangulation over the BAProblem observation layout
# --------------------------------------------------------------------------


def midpoint_triangulate(rot, trans, obs_cam, obs_uv, cam: Pinhole, gate_px: float, dense_frames: bool = False):
    """Per-track multiview midpoint triangulation with a consensus refit.

    rot [..., C, 3, 3] / trans [..., C, 3] world->camera, obs_cam [..., L, D]
    (-1 = empty), obs_uv [..., L, D, 2].  Fit on all observations, gate by
    reprojection (< gate_px, positive depth), refit on the inliers, keep the
    refit where it keeps the support.  ``dense_frames``: slot d is camera d.
    Returns (points [..., L, 3], obs_ok [..., L, D], has_pt [..., L]).
    """
    valid = obs_cam >= 0
    R, t = _poses_per_obs(rot, trans, obs_cam, dense_frames)
    rt = R.transpose(-1, -2)
    centers = -rotate(rt, t)
    rx = (obs_uv[..., 0] - cam.cx) / cam.fx
    ry = (obs_uv[..., 1] - cam.cy) / cam.fy
    rays_w = rotate(rt, torch.stack([rx, ry, torch.ones_like(rx)], -1))
    rays_w = rays_w / torch.clamp_min(fixed.norm(rays_w, keepdim=True), 1e-12)
    eye = eye3(obs_uv)
    m = eye - rays_w[..., :, None] * rays_w[..., None, :]
    mc = rotate(m, centers)

    def fit(w):
        a = fixed.sum(m * w[..., None, None], -3) + 1e-6 * eye
        return solve3(a, fixed.sum(mc * w[..., None], -2))

    def gate(pts):
        pc = rotate(R, pts[..., :, None, :]) + t
        z = torch.clamp_min(pc[..., 2], 1e-6)
        u = cam.fx * pc[..., 0] / z + cam.cx
        v = cam.fy * pc[..., 1] / z + cam.cy
        rn = torch.hypot(u - obs_uv[..., 0], v - obs_uv[..., 1])
        return valid & (rn < gate_px) & (pc[..., 2] > 1e-6)

    pts = fit(valid.to(obs_uv.dtype))
    ok = gate(pts)
    pts2 = fit(ok.to(obs_uv.dtype))
    ok2 = gate(pts2)
    better = ok2.sum(-1) >= ok.sum(-1)
    pts = torch.where(better[..., None], pts2, pts)
    ok = torch.where(better[..., None], ok2, ok)
    return pts, ok, ok.sum(-1) >= 2


# --------------------------------------------------------------------------
# Chunk solver: every chunk, from two init pairs, as one batch
# --------------------------------------------------------------------------


@fixed.batch_invariant()
def solve_chunks(track_uv, track_has, cam: Pinhole, min_corr: int, n_rounds: int, ba_opts: BAOptions,
                 gate_px: float, gumbel: Optional[torch.Tensor] = None):
    """Solve a stack of fixed-shape chunk problems.

    Each chunk: track_uv [K, L, F, 2], track_has [K, L, F], at most one
    observation per frame per track.  Per chunk, from the widest pair (0, j)
    with at least 3 * min_corr shared tracks (A) and the widest with at
    least min_corr (B): two-view init, poses interpolated from it, then
    ``n_rounds`` of [robust PnP per frame, midpoint re-triangulation, BA
    with dense frame slots in float32]; the solution with the smaller
    truncated reprojection score over all the chunk's observations wins.
    ``gumbel`` [64, L]: the two-view RANSAC's noise (drawn from seed 0 when
    absent).  Returns per chunk (rot [K, F, 3, 3], trans [K, F, 3], points
    [K, L, 3], has_pt [K, L], ok [K], j* [K]).  Runs under
    ``fixed.batch_invariant``: a chunk's outputs are the same bits whatever
    the other chunks of the batch (an empty problem, zero tracks, gives
    ``ok`` False).
    """
    K, L, F = track_has.shape
    dev = track_uv.device
    iota_f = torch.arange(F, device=dev)
    # A wide pair with few correspondences is the classic two-view trap:
    # prefer a strong consensus (A), hedge with the widest minimal one (B).
    counts = (track_has[..., :1] & track_has).sum(-2)  # [K, F]

    def widest(th):
        ok = (counts >= th) & (iota_f > 0)
        return torch.clamp_min(torch.where(ok, iota_f, 0).amax(-1), 1), ok.any(-1)

    j_a, ok_a = widest(3 * min_corr)
    j_b, chunk_ok = widest(min_corr)
    j_a = torch.where(ok_a, j_a, j_b)
    jstar = torch.stack([j_a, j_b], 1)  # [K, 2]: both candidates as a batch axis
    uv = track_uv[:, None].expand(K, 2, L, F, 2)
    has = track_has[:, None].expand(K, 2, L, F)
    obs_cam_all = torch.where(has, iota_f.to(torch.int32), -1)

    uv0 = uv[..., 0, :]
    uvj = torch.gather(uv, -2, jstar[:, :, None, None, None].expand(K, 2, L, 1, 2))[..., 0, :]
    pv = has[..., 0] & torch.gather(has, -1, jstar[:, :, None, None].expand(K, 2, L, 1))[..., 0]
    if gumbel is None:
        gumbel = geometry.ransac_gumbel(0, 64, L, dev)
    r_j, t_j, pts, inl = geometry.two_view_init(uv0, uvj, pv, cam, gumbel=gumbel)

    # Geodesic pose interpolation 0 -> j*, linear extrapolation after.
    w_full = so3_log(r_j)
    c_full = -rotate(r_j.transpose(-1, -2), t_j)
    a = iota_f.to(torch.float32) / jstar[..., None].to(torch.float32)  # [K, 2, F]
    rots = so3_exp(a[..., None] * w_full[..., None, :])
    trans = -rotate(rots, a[..., None] * c_full[..., None, :])
    at_j = (iota_f == jstar[..., None])
    rots = torch.where(at_j[..., None, None], r_j[..., None, :, :], rots)
    trans = torch.where(at_j[..., None], t_j[..., None, :], trans)
    has_pt = pv & inl
    first = iota_f == 0
    uv_f = uv.transpose(-3, -2)  # [K, 2, F, L, 2]
    has_f = has.transpose(-2, -1)  # [K, 2, F, L]

    for _ in range(n_rounds):
        # Robust PnP per frame against the map, frame 0 pinned.
        r_new, t_new = geometry.pnp_solve(rots, trans, pts[..., None, :, :].expand(K, 2, F, L, 3), uv_f,
                                          has_f & has_pt[..., None, :], cam, iters=15, gate_px=gate_px)
        rots = torch.where(first[:, None, None], eye3(r_new), r_new)
        trans = torch.where(first[:, None], 0.0, t_new)
        pts, obs_ok, has_pt = midpoint_triangulate(rots, trans, obs_cam_all, uv, cam, gate_px, dense_frames=True)
        problem = BAProblem(rots, trans, pts, torch.where(obs_ok, obs_cam_all, -1), uv)
        solved = _ba_solve_impl(problem, cam, ba_opts, dense_frames=True)
        rots, trans, pts = solved.rot, solved.trans, solved.points

    # Selection score: truncated mean reprojection over all in-chunk
    # observations (a wrong basin must truncate the many it cannot explain).
    pts_f, _, _ = midpoint_triangulate(rots, trans, obs_cam_all, uv, cam, gate_px, dense_frames=True)
    pc = rotate(rots[..., None, :, :, :], pts_f[..., :, None, :]) + trans[..., None, :, :]  # [K, 2, L, F, 3]
    z = torch.clamp_min(pc[..., 2], 1e-6)
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    r2 = (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2
    tau2 = (2.0 * gate_px) ** 2
    score = fixed.sum(torch.where(has, torch.clamp_max(r2, tau2), 0.0), (-2, -1)) / torch.clamp_min(
        has.sum((-2, -1)), 1)
    pick_a = (score[:, 0] <= score[:, 1]) | (j_a == j_b)
    rots, trans, pts, has_pt = (torch.where(pick_a.reshape(K, *([1] * (x.dim() - 2))), x[:, 0], x[:, 1])
                                for x in (rots, trans, pts, has_pt))
    return rots, trans, pts, has_pt, chunk_ok, torch.where(pick_a, j_a, j_b)


# --------------------------------------------------------------------------
# Sim(3) handoff alignment (host)
# --------------------------------------------------------------------------


def reliable_frame_prefix(c_loc: np.ndarray, collapse_ratio: float = 0.3) -> np.ndarray:
    """Per-frame reliability mask for one chunk's local camera centers: a
    frozen tail (consecutive-center steps collapsed below ``collapse_ratio``
    of the chunk's median step) is unreliable, so composition leaves those
    frames to the other chunk covering them."""
    n = len(c_loc)
    steps = np.linalg.norm(np.diff(c_loc, axis=0), axis=1)
    med = float(np.median(steps)) if len(steps) else 0.0
    rel = np.ones(n, bool)
    if med <= 1e-12:
        return rel  # wholly degenerate chunk: handled by the scale guards
    ok = steps >= collapse_ratio * med
    j = len(ok)
    while j > 0 and not ok[j - 1]:
        j -= 1
    rel[j + 1:] = False
    return rel


def sim3_align_overlap(rots_g, centers_g, rot_l, c_loc, shared_g, shared_l, s, chunk, prev_sc):
    """Align a chunk onto the composed trajectory over its shared frames.

    Rotation = chordal mean of R_glob^T R_loc, scale = ratio of summed
    consecutive-center distances (the previous handoff's scale when the
    overlap motion has collapsed on either side), translation = residual
    mean.  Returns (rot_a, t_a, sc_a): c_glob = sc_a rot_a c_loc + t_a,
    R_glob = R_loc rot_a^T.
    """
    M = np.zeros((3, 3), np.float64)
    for fg, fl in zip(shared_g, shared_l):
        M += rots_g[fg].T @ rot_l[fl]
    if np.isfinite(M).all() and np.linalg.norm(M) > 1e-9:
        U, _, Vt = np.linalg.svd(M)
        rot_a = (U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt).astype(np.float32)
    else:
        report_warn("chunked VO: degenerate overlap rotation at chunk start %d — using identity alignment", s)
        rot_a = np.eye(3, dtype=np.float32)
    cl = np.stack([c_loc[fl] for fl in shared_l])
    cgl = centers_g[shared_g]
    d_loc = np.linalg.norm(np.diff(cl, axis=0), axis=1).sum()
    d_glob = np.linalg.norm(np.diff(cgl, axis=0), axis=1).sum()
    sc_a = float(d_glob / max(d_loc, 1e-9))
    n_int = max(len(shared_g) - 1, 1)
    typ_loc = float(np.median(np.linalg.norm(np.diff(c_loc, axis=0), axis=1)))
    g_lo = max(0, s - chunk)
    g_steps = np.linalg.norm(np.diff(centers_g[g_lo:s + 1], axis=0), axis=1)
    typ_glob = float(np.median(g_steps)) if len(g_steps) else 0.0
    bad_loc = d_loc < 0.2 * typ_loc * n_int
    bad_glob = typ_glob > 0 and d_glob < 0.2 * typ_glob * n_int
    if not np.isfinite(sc_a) or bad_loc or bad_glob:
        report_warn(
            "chunked VO: degenerate overlap (d_loc=%.3g/typ %.3g, d_glob=%.3g/typ %.3g) at chunk start %d — "
            "reusing previous scale %.3g", d_loc, typ_loc, d_glob, typ_glob, s, prev_sc,
        )
        sc_a = prev_sc
    t_a = (cgl - sc_a * cl @ rot_a.T).mean(0).astype(np.float32)
    return rot_a, t_a, sc_a


# --------------------------------------------------------------------------
# Pose-graph refinement over the composed trajectory
# --------------------------------------------------------------------------


def _pose_graph_refine(rots_g, centers_g, chunk_rots, chunk_centers, chunk_scales, chunk_ok, starts, rel_k=None,
                       pg_iterations: int = 8, device: DeviceLike = None):
    """SE(3) pose graph over frames: each chunk adds edges at offsets 1 and
    2 between its reliable frames, its centers scaled into the composed
    gauge; nodes are camera-to-world poses."""
    ei, ej, er, et = [], [], [], []
    for k, s in enumerate(starts):
        if not chunk_ok[k]:
            continue
        fc = chunk_rots.shape[1]
        r_cw = np.transpose(chunk_rots[k], (0, 2, 1))
        c = chunk_centers[k] * chunk_scales[k]
        rel = rel_k[k] if rel_k is not None else np.ones(fc, bool)
        for off in (1, 2):
            for fa in range(fc - off):
                fb = fa + off
                if not (rel[fa] and rel[fb]):
                    continue
                ra, ta = r_cw[fa].T, -r_cw[fa].T @ c[fa]
                ei.append(s + fa)
                ej.append(s + fb)
                er.append(ra @ r_cw[fb])
                et.append(ra @ c[fb] + ta)
    if not ei:
        return rots_g, centers_g
    f32 = lambda x: as_tensor(np.ascontiguousarray(x, np.float32), device)
    graph = PoseGraph(
        rot=f32(np.transpose(rots_g, (0, 2, 1))), trans=f32(centers_g),
        edge_i=as_tensor(np.asarray(ei, np.int32), device), edge_j=as_tensor(np.asarray(ej, np.int32), device),
        edge_rot=f32(np.stack(er)), edge_trans=f32(np.stack(et)),
    )
    solved = pose_graph_solve(graph, BAOptions(max_iterations=pg_iterations, damping=1e-6, num_fixed_cameras=1))
    r_cw = solved.rot.cpu().numpy()
    c = solved.trans.cpu().numpy()
    if not (np.isfinite(r_cw).all() and np.isfinite(c).all()):
        report_warn("chunked VO: pose-graph refinement diverged — skipped")
        return rots_g, centers_g
    return np.transpose(r_cw, (0, 2, 1)), c


# --------------------------------------------------------------------------
# Global stage: per-frame PnP against the whole map
# --------------------------------------------------------------------------


def _global_pnp(rot, trans, pts, has_pt, obs_cam, obs_uv, cam: Pinhole, gate_px: float):
    """Robust PnP re-registration of every frame against the global map
    (frame 0 pinned): a frame whose pose froze or drifted during the chunk
    solves re-solves from the adjusted structure."""
    F = rot.shape[0]
    has = obs_cam[None, :, :] == torch.arange(F, dtype=obs_cam.dtype, device=obs_cam.device)[:, None, None]
    has_f = has.any(-1) & has_pt[None, :]  # [F, L]
    d_idx = has.to(torch.int32).argmax(-1)  # [F, L]: the first slot of each frame
    uv_f = torch.gather(obs_uv[None].expand(F, *obs_uv.shape), 2,
                        d_idx[..., None, None].expand(*d_idx.shape, 1, 2))[:, :, 0]
    r2, t2 = geometry.pnp_solve(rot, trans, pts[None].expand(F, *pts.shape), uv_f, has_f, cam, iters=15,
                                gate_px=gate_px)
    first = torch.arange(F, device=rot.device) == 0
    return torch.where(first[:, None, None], rot, r2), torch.where(first[:, None], trans, t2)


# --------------------------------------------------------------------------
# Host-side layouts
# --------------------------------------------------------------------------


def chunk_starts(n: int, chunk: int, overlap: int) -> List[int]:
    step = max(1, chunk - overlap)
    starts = list(range(0, max(n - chunk, 0) + 1, step))
    if starts[-1] != n - chunk:
        starts.append(n - chunk)
    return starts


def chunk_problems(tracks, uv_np: np.ndarray, starts: List[int], chunk: int, max_tracks: int):
    """Each chunk's tracks (those with >= 2 observations inside it, longest
    first, at most ``max_tracks``) as track_uv [K, L, chunk, 2] and
    track_has [K, L, chunk]."""
    K = len(starts)
    track_uv = np.zeros((K, max_tracks, chunk, 2), np.float32)
    track_has = np.zeros((K, max_tracks, chunk), bool)
    for k, s in enumerate(starts):
        cand = []
        for tr in tracks:
            obs = [(f - s, i) for f, i in tr if s <= f < s + chunk]
            if len(obs) >= 2:
                cand.append(obs)
        cand.sort(key=len, reverse=True)
        for l, obs in enumerate(cand[:max_tracks]):
            for fl, i in obs:
                track_uv[k, l, fl] = uv_np[s + fl, i]
                track_has[k, l, fl] = True
    return track_uv, track_has


def global_observations(good, uv_np: np.ndarray, max_obs: int):
    """The merged tracks as a BA layout padded to a multiple of 1024 tracks:
    (obs_cam [Lp, D] int32, obs_uv [Lp, D, 2]); a track longer than D keeps
    D observations spread over its whole span."""
    Lp = ((len(good) + 1023) // 1024) * 1024
    obs_cam = np.full((Lp, max_obs), -1, np.int32)
    obs_uv = np.zeros((Lp, max_obs, 2), np.float32)
    for l, tr in enumerate(good):
        obs = tr
        if len(obs) > max_obs:
            idx = np.unique(np.round(np.linspace(0, len(obs) - 1, max_obs)).astype(int))
            obs = [obs[i] for i in idx]
        for d, (f, i) in enumerate(obs):
            obs_cam[l, d] = f
            obs_uv[l, d] = uv_np[f, i]
    return obs_cam, obs_uv


def match_offsets_for(n: int) -> Tuple[int, ...]:
    """Offsets 1..4, then powers of two up to max(16, n / 8)."""
    offs = [1, 2, 3, 4]
    o = 8
    while o <= max(16, n // 8):
        offs.append(o)
        o *= 2
    return tuple(offs)


def match_and_gate(words, dvalid, uv_np, valid_np, links_np, cam: Pinhole, match_opts: MatcherOptions,
                   match_offsets: Tuple[int, ...]):
    """Every frame pair's matches, most trustworthy first (the carry links,
    then descriptor matches at ascending offset), each gated by one batched
    epipolar RANSAC over all pairs.  Returns [(fa, fb, index [N] or -1)]."""
    n, capacity = uv_np.shape[:2]
    dev = words.device
    edges: List[Tuple[int, int, np.ndarray]] = [(f, f + 1, links_np[f]) for f in range(n - 1)]
    for off in match_offsets:
        if n <= off:
            continue
        m = match_hamming(words[:-off], dvalid[:-off], words[off:], dvalid[off:], match_opts)
        midx = torch.where(m.valid, m.index, -1).cpu().numpy()
        edges.extend((f, f + off, midx[f]) for f in range(n - off))
    fa_idx = np.asarray([e[0] for e in edges], np.int64)
    fb_idx = np.asarray([e[1] for e in edges], np.int64)
    midx_all = np.stack([e[2] for e in edges]) if edges else np.zeros((0, capacity), np.int64)
    pair_matches: List[Tuple[int, int, np.ndarray]] = []
    if edges:
        sel = np.clip(midx_all, 0, None)
        uv_a_all = uv_np[fa_idx]
        uv_b_all = uv_np[fb_idx][np.arange(len(edges))[:, None], sel]
        pv_all = (midx_all >= 0) & valid_np[fa_idx]
        inlier = geometry.epipolar_inlier_gate(as_tensor(uv_a_all, dev), as_tensor(uv_b_all, dev),
                                               as_tensor(pv_all, dev), cam).cpu().numpy()
        pair_matches = [(int(fa_idx[k]), int(fb_idx[k]), np.where(inlier[k], midx_all[k], -1))
                        for k in range(len(edges))]
    return pair_matches


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------


def run_visual_odometry_fused(
    images,
    cam: Pinhole,
    chunk: int = 12,
    overlap: int = 5,
    detector_kind: str = "harris",
    needed_features: int = 200,
    det_opts: Optional[DetectorOptions] = None,
    # Upright descriptors without pre-blur (see the JAX package for the A/B).
    brief_opts: BriefOptions = BriefOptions(upright=True),
    match_opts: MatcherOptions = MatcherOptions(ratio=0.85, max_distance=80),
    ba_opts: BAOptions = BAOptions(max_iterations=12, huber_delta=2.0, gate_px=3.0, gate_rounds=2),
    chunk_ba_opts: BAOptions = BAOptions(max_iterations=10, huber_delta=2.0, gate_px=3.0, gate_rounds=1),
    max_track_obs: int = 8,
    max_tracks_per_chunk: int = 512,
    n_rounds: int = 2,
    min_corr: int = 15,
    gate_px: float = 3.0,
    pose_graph: bool = True,
    global_ba: bool = True,
    match_offsets: Optional[Tuple[int, ...]] = None,
    mesh=None,
    device: DeviceLike = None,
    stage_seconds: Optional[dict] = None,
) -> VOResult:
    """Fused chunked VO (see the module docstring); returns a VOResult
    covering every input frame.  Runs on ``device`` (``cuda`` unless
    ``images`` is a CPU tensor or ``device="cpu"``); raises without a card.
    With ``mesh``, every rank calls this with the same arguments, runs on
    its own device and returns the same result.  ``stage_seconds``, when
    given, receives each stage's host seconds (every stage ends by copying
    its result to the host)."""
    if mesh is not None and device is None:
        device = mesh_device(mesh)
    imgs = as_tensor(images, device)
    dev = imgs.device
    if mesh is not None and dev != mesh_device(mesh):
        raise ValueError(f"images on {dev}, but this rank's mesh device is {mesh_device(mesh)}")
    check_no_tf32(dev)
    t_mark = [time.perf_counter()]

    def mark(stage):
        now = time.perf_counter()
        if stage_seconds is not None:
            stage_seconds[stage] = stage_seconds.get(stage, 0.0) + now - t_mark[0]
        t_mark[0] = now

    if det_opts is None:
        det_opts = DetectorOptions(min_feature_distance=10, min_valid_response=20.0, max_features=256, subpixel=True)
    n = imgs.shape[0]
    # A single whole-sequence chunk when n <= chunk.
    if n <= chunk:
        chunk, overlap = n, 0
    if match_offsets is None:
        match_offsets = match_offsets_for(n)
    capacity = det_opts.max_features

    # --- 1. front-end ------------------------------------------------------
    feats, words, dvalid, links = scan_frontend(imgs, detector_kind, needed_features, det_opts, brief_opts)
    uv_np = feats.uv.cpu().numpy()
    valid_np = feats.valid.cpu().numpy()
    links_np = links.cpu().numpy()
    mark("frontend")

    # --- 2. matching + epipolar gate: carry links first, then descriptor
    # matches at ascending offset (the track graph's trust order) ---------
    pair_matches = match_and_gate(words, dvalid, uv_np, valid_np, links_np, cam, match_opts, match_offsets)
    mark("match_gate")

    # --- 3. global track graph (host) ----------------------------------------
    tracks = build_tracks_conflict_free(pair_matches, n, capacity)
    mark("tracks")

    # --- 4. chunk problems, solved as one batch or a block a rank -----------
    starts = chunk_starts(n, chunk, overlap)
    K = len(starts)
    track_uv_k, track_has_k = chunk_problems(tracks, uv_np, starts, chunk, max_tracks_per_chunk)
    track_uv_t, track_has_t = as_tensor(track_uv_k, dev), as_tensor(track_has_k, dev)
    if mesh is not None:
        track_uv_t = shard_leading(track_uv_t, mesh, "data", 0.0)
        track_has_t = shard_leading(track_has_t, mesh, "data", False)
    solved_k = solve_chunks(track_uv_t, track_has_t, cam, min_corr, n_rounds, chunk_ba_opts, gate_px)
    if mesh is not None:
        solved_k = [gather_leading(x, mesh, "data")[:K] for x in solved_k]
    c_rots, c_trans, c_pts, c_haspt, c_ok, _ = (x.cpu().numpy() for x in solved_k)
    c_ok = c_ok.copy()
    mark("chunk_solve")

    # --- 5. Sim(3) composition over overlap frames (host) -------------------
    rots_g = np.zeros((n, 3, 3), np.float32)
    centers_g = np.zeros((n, 3), np.float32)
    have = np.zeros(n, bool)
    chunk_scales = np.ones(K, np.float32)
    san_rots = np.zeros_like(c_rots)
    san_centers = np.zeros((K, chunk, 3), np.float32)
    rel_k = np.ones((K, chunk), bool)
    all_points = []
    prev_sc = 1.0
    for k, s in enumerate(starts):
        rot_l, tr_l = sanitize_chunk_poses(c_rots[k], c_trans[k], s)
        c_loc = -np.einsum("fji,fj->fi", rot_l, tr_l)
        san_rots[k] = rot_l
        san_centers[k] = c_loc
        rel = reliable_frame_prefix(c_loc)
        rel_k[k] = rel
        if not c_ok[k]:
            report_warn("chunked VO: chunk at start %d failed init — holding last composed pose for its new "
                        "frames", s)
            last = np.where(have)[0]
            r_hold = rots_g[last[-1]] if len(last) else np.eye(3, dtype=np.float32)
            c_hold = centers_g[last[-1]] if len(last) else np.zeros(3, np.float32)
            for fl in range(chunk):
                f = s + fl
                if not have[f]:
                    rots_g[f], centers_g[f], have[f] = r_hold, c_hold, True
            chunk_scales[k] = prev_sc
            continue
        if k == 0 or not have[s]:
            rot_a = np.eye(3, dtype=np.float32)
            t_a = np.zeros(3, np.float32)
            sc_a = 1.0
        else:
            shared_g = [f for f in range(s, s + chunk) if have[f]]
            shared_l = [f - s for f in shared_g]
            rot_a, t_a, sc_a = sim3_align_overlap(rots_g, centers_g, rot_l, c_loc, shared_g, shared_l, s, chunk,
                                                  prev_sc)
            # Overlap consistency: a chunk whose aligned overlap centers
            # disagree with the composed trajectory by more than a typical
            # step is a bad solve; its new frames get constant velocity.
            aligned = sc_a * np.stack([c_loc[fl] for fl in shared_l]) @ rot_a.T + t_a
            resid = np.linalg.norm(aligned - centers_g[shared_g], axis=1)
            g_lo = max(0, s - chunk)
            steps_g = np.linalg.norm(np.diff(centers_g[g_lo:s + 1], axis=0), axis=1)
            typ = float(np.median(steps_g)) if len(steps_g) else 0.0
            if typ > 0 and float(np.median(resid)) > typ:
                report_warn(
                    "chunked VO: chunk at start %d inconsistent with composed trajectory (median overlap "
                    "residual %.3g vs typical step %.3g) — constant-velocity fallback", s,
                    float(np.median(resid)), typ,
                )
                c_ok[k] = False
                last = int(np.where(have)[0][-1])
                v = centers_g[last] - centers_g[last - 1] if last > 0 else np.zeros(3, np.float32)
                for f in range(s, s + chunk):
                    if not have[f]:
                        rots_g[f] = rots_g[last]
                        centers_g[f] = centers_g[last] + (f - last) * v
                        have[f] = True
                chunk_scales[k] = prev_sc
                continue
        prev_sc = sc_a
        chunk_scales[k] = sc_a
        if not rel.all():
            report_warn("chunked VO: chunk at start %d has a frozen tail (%d frames) — leaving those frames to the "
                        "overlapping chunk", s, int((~rel).sum()))
        for fl in range(chunk):
            f = s + fl
            if have[f] or not rel[fl]:
                continue
            rots_g[f] = rot_l[fl] @ rot_a.T
            centers_g[f] = sc_a * rot_a @ c_loc[fl] + t_a
            have[f] = True
        pts_k = c_pts[k][c_haspt[k]]
        if len(pts_k):
            all_points.append(pts_k * sc_a @ rot_a.T + t_a)

    # Frames every covering chunk deemed unreliable: constant velocity.
    if not have.all():
        report_warn("chunked VO: %d frames unfilled after composition — constant-velocity fill", int((~have).sum()))
        for f in range(n):
            if have[f]:
                continue
            last = f - 1
            while last >= 0 and not have[last]:
                last -= 1
            if last < 0:
                rots_g[f] = np.eye(3, dtype=np.float32)
                centers_g[f] = 0.0
            else:
                v = centers_g[last] - centers_g[last - 1] if last > 0 else np.zeros(3, np.float32)
                rots_g[f] = rots_g[last]
                centers_g[f] = centers_g[last] + (f - last) * v
            have[f] = True
    mark("compose")

    # --- 6. pose-graph refinement -------------------------------------------
    if pose_graph and K > 1:
        rots_g, centers_g = _pose_graph_refine(rots_g, centers_g, san_rots, san_centers, chunk_scales, c_ok, starts,
                                               rel_k, device=dev)
    mark("pose_graph")
    trans_g = -np.einsum("fij,fj->fi", rots_g, centers_g)

    # --- 7. global BA over merged tracks -------------------------------------
    points = np.concatenate(all_points) if all_points else np.zeros((0, 3), np.float32)
    mean_len = 0.0
    problem = solved = None
    good = [tr for tr in tracks if len(tr) >= 2]
    if global_ba and good:
        if mesh is None:
            solve_ba = lambda p: ba_solve(p, cam, ba_opts)
        else:
            solve_ba = make_distributed_ba(mesh, cam, ba_opts)
        obs_cam_np, obs_uv_np = global_observations(good, uv_np, max_track_obs)
        oc = as_tensor(obs_cam_np, dev)
        ouv = as_tensor(obs_uv_np, dev)
        r0 = as_tensor(np.ascontiguousarray(rots_g, np.float32), dev)
        t0 = as_tensor(np.ascontiguousarray(trans_g, np.float32), dev)
        pts0, obs_ok, _ = midpoint_triangulate(r0, t0, oc, ouv, cam, 4.0 * gate_px)
        problem = BAProblem(rot=r0, trans=t0, points=pts0, obs_cam=torch.where(obs_ok, oc, -1), obs_uv=ouv)
        solved = solve_ba(problem)
        # PnP re-registration of every frame against the adjusted map, then
        # re-triangulation and a final solve.
        pts1, ok1, hp1 = midpoint_triangulate(solved.rot, solved.trans, oc, ouv, cam, 4.0 * gate_px)
        r_p, t_p = _global_pnp(solved.rot, solved.trans, pts1, hp1, torch.where(ok1, oc, -1), ouv, cam, gate_px)
        pts2, ok2, has_pt = midpoint_triangulate(r_p, t_p, oc, ouv, cam, 4.0 * gate_px)
        solved = solve_ba(problem._replace(rot=r_p, trans=t_p, points=pts2, obs_cam=torch.where(ok2, oc, -1)))
        r_s = solved.rot.cpu().numpy()
        t_s = solved.trans.cpu().numpy()
        p_s = solved.points.cpu().numpy()
        if np.isfinite(r_s).all() and np.isfinite(t_s).all():
            rots_g, trans_g = r_s, t_s
            centers_g = -np.einsum("fji,fj->fi", rots_g, trans_g)
            keep = has_pt.cpu().numpy() & np.isfinite(p_s).all(axis=1)
            points = p_s[keep]
        else:
            report_warn("chunked VO: global BA diverged — keeping pose-graph trajectory")
        mean_len = float(np.mean([min(len(tr), max_track_obs) for tr in good]))
    mark("global_ba")

    traj = Trajectory(
        timestamps=np.arange(n, dtype=np.float64) * 0.1,
        rotations=np.transpose(rots_g, (0, 2, 1)),
        positions=centers_g,
    )
    return VOResult(
        trajectory=traj,
        rotations_wc=rots_g,
        translations_wc=trans_g,
        points=points,
        num_tracks=len(tracks),
        mean_track_length=mean_len,
        problem=problem,
        solved=solved,
    )
