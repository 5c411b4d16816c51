"""Schur-complement bundle adjustment on one device.

Counterpart of the single-device part of ``feature_detector_tpu/slam/ba.py``:
a fixed-shape problem layout (each landmark carries up to ``D``
observations, ``obs_cam`` -1 where empty), per-landmark 3x3 elimination in
closed form, a dense reduced camera system, Huber IRLS with Levenberg-
Marquardt damping and accept/reject on the true Huber objective, camera 0
frozen for the gauge, and MAD clipping plus consensus re-landmarking rounds
for gross outliers.  Every tensor may carry leading batch axes (the fused
VO solves all its chunks as one batch).

Precision, per call site: ``ba_solve`` (the VO's global BA) runs the
whole solve in float64 and rounds the result to float32.  The JAX package
off the TPU runs only the dense solves, the 3x3 inverses and the cost sums
in float64, over float32 state and products; on the bench's global problem
that leaves LM's accept/reject and gating decisions hanging on float32
rounding (a 1e-5 px change of the observations moves a rotation by 1.5e-3
rad there, by 2.1e-7 rad here: ``tests/test_torch_vo_study.py``), and an H100's
solve equals the CPU's (``chip_smoke.py``).  ``_ba_solve_impl``
called directly (the chunk solver) runs in float32 with one step of
iterative refinement of each solve, as the JAX package does there; there
(``fixed.batch_invariant``) its products, sums and solves go through K4
and K5, so a problem's bits do not depend on how many problems share the
batch.
The VO entry refuses TF32 matmuls on the card.

``make_distributed_ba`` is the multi-device solver: landmarks split over a
mesh axis, one all-reduce of the reduced camera system and the cost per LM
iteration, or with ``camera_shard`` the system's rows reduce-scattered and
solved by distributed conjugate gradients.  It solves in float64 too.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..core.config import BAOptions
from ..core.device import as_tensor
from ..parallel.mesh import axis_group, axis_index, axis_size, gather_leading, mesh_device, shard_leading
from . import fixed
from .camera import Pinhole, huber_weight, project, projection_jacobian
from .fixed import solve
from .lie import eye3, hat, rotate, se3_update
from .linalg3 import inv3, solve3


class BAProblem(NamedTuple):
    """Fixed-shape BA problem (leading batch axes allowed).

    rot:      [C, 3, 3]  world->camera rotations
    trans:    [C, 3]     world->camera translations
    points:   [L, 3]     landmark positions (world)
    obs_cam:  [L, D]     int32 camera index per observation slot, -1 = empty
    obs_uv:   [L, D, 2]  observed pixels
    """

    rot: torch.Tensor
    trans: torch.Tensor
    points: torch.Tensor
    obs_cam: torch.Tensor
    obs_uv: torch.Tensor


def check_no_tf32(device: torch.device) -> None:
    """Refuse to run the SLAM solvers on the card with TF32 matmuls: their
    float32 products (normal equations, epipolar systems) must keep every
    mantissa bit, whatever a global flag says elsewhere."""
    if torch.device(device).type == "cuda" and (
        torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "the SLAM solvers need full float32 matmuls: set torch.backends.cuda.matmul.allow_tf32 = False "
            "and torch.set_float32_matmul_precision('highest')"
        )


def take_cams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-camera rows x [..., C, *rest] gathered at idx [..., L, D] (in
    range) -> [..., L, D, *rest]."""
    batch = idx.shape[:-2]
    c, rest = x.shape[len(batch)], x.shape[len(batch) + 1:]
    flat = x.reshape(-1, c, *rest)
    fidx = idx.reshape(flat.shape[0], -1).long()
    rows = torch.arange(flat.shape[0], device=x.device)[:, None]
    return flat[rows, fidx].reshape(*idx.shape, *rest)


def _poses_per_obs(rot, trans, obs_cam, dense_frames: bool):
    """Each observation's camera pose: (R [..., L, D, 3, 3], t [..., L, D, 3]).
    ``dense_frames``: slot d is camera d, so the poses broadcast."""
    if dense_frames:
        lead = obs_cam.shape
        return rot[..., None, :, :, :].expand(*lead, 3, 3), trans[..., None, :, :].expand(*lead, 3)
    idx = torch.clamp(obs_cam, 0, rot.shape[-3] - 1)
    return take_cams(rot, idx), take_cams(trans, idx)


def _per_landmark_blocks(rot, trans, points, obs_cam, obs_uv, cam: Pinhole, opts: BAOptions, obs_w=None,
                         dense_frames: bool = False):
    """Per-landmark residuals and Jacobian blocks.

    ``obs_w`` [..., L, D] is an extra 0/1 gate weight.  Returns (valid
    [..., L, D], r [..., L, D, 2], Jc [..., L, D, 2, 6], Jp [..., L, D, 2, 3],
    w [..., L, D]).
    """
    valid = obs_cam >= 0
    R, t = _poses_per_obs(rot, trans, obs_cam, dense_frames)
    p = rotate(R, points[..., :, None, :]) + t
    r = project(p, cam) - obs_uv
    jpi = projection_jacobian(p, cam)
    # Left perturbation: dp/dtheta = -[p]x, dp/dt = I, dp/dX = R.
    jc = torch.cat([-fixed.matmul(jpi, hat(p)), jpi], dim=-1)
    jp = fixed.matmul(jpi, R)
    w = huber_weight(fixed.sum(r * r, -1), opts.huber_delta) * valid
    if obs_w is not None:
        w = w * obs_w
    return valid, r, jc, jp, w


def _scatter_pairs(vals: torch.Tensor, row: torch.Tensor, col: torch.Tensor, n: int) -> torch.Tensor:
    """Sum blocks vals [..., M, 6, 6] into [..., n, 6, n, 6] at (row, col) [..., M]."""
    batch = vals.shape[:-3]
    flat = vals.reshape(-1, vals.shape[-3], 36)
    key = (row * n + col).reshape(flat.shape[0], -1).long()
    out = torch.zeros(flat.shape[0], n * n, 36, dtype=vals.dtype, device=vals.device)
    out.scatter_add_(1, key[..., None].expand(-1, -1, 36), flat)
    return out.reshape(*batch, n, n, 6, 6).transpose(-3, -2)


def _scatter_rows(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Sum vals [..., M, 6] into [..., n, 6] at idx [..., M]."""
    batch = vals.shape[:-2]
    flat = vals.reshape(-1, vals.shape[-2], 6)
    key = idx.reshape(flat.shape[0], -1).long()
    out = torch.zeros(flat.shape[0], n, 6, dtype=vals.dtype, device=vals.device)
    out.scatter_add_(1, key[..., None].expand(-1, -1, 6), flat)
    return out.reshape(*batch, n, 6)


def _assemble(rot, trans, points, obs_cam, obs_uv, cam, opts, n_cams, obs_w=None, dense_frames: bool = False):
    """Normal equations with the landmarks eliminated.

    Returns (S [..., 6C, 6C] reduced camera system, b [..., 6C] reduced
    RHS, Hpp_inv [..., L, 3, 3], b_p [..., L, 3], W [..., L, D, 6, 3],
    valid, cam_idx) for the back-substitution.
    """
    valid, r, jc, jp, w = _per_landmark_blocks(rot, trans, points, obs_cam, obs_uv, cam, opts, obs_w, dense_frames)
    sw = torch.sqrt(w)
    jc = jc * sw[..., None, None]
    jp = jp * sw[..., None, None]
    rw = r * sw[..., None]

    # Landmark blocks, damped relative to their trace.
    hpp = fixed.einsum("...ldki,...ldkj->...lij", jp, jp)
    tr = hpp[..., 0, 0] + hpp[..., 1, 1] + hpp[..., 2, 2]
    hpp = hpp + (opts.damping * tr + 1e-5)[..., None, None] * eye3(hpp)
    bp = -fixed.einsum("...ldki,...ldk->...li", jp, rw)
    hpp_inv = inv3(hpp)

    bc_blk = -fixed.einsum("...ldki,...ldk->...ldi", jc, rw)
    wmat = fixed.einsum("...ldki,...ldkj->...ldij", jc, jp)  # Jc^T Jp
    y = fixed.matmul(wmat, hpp_inv[..., :, None, :, :])
    vf = valid.to(jc.dtype)
    yb = rotate(y, bp[..., :, None, :])
    L, D = obs_cam.shape[-2:]
    if dense_frames:
        # Slot d is camera d: the scatter collapses to sums over landmarks,
        # one contraction over (landmark, 3) per block of S.
        yv, wv = y * vf[..., None, None], wmat * vf[..., None, None]
        s = -fixed.einsum("...ldij,...lekj->...diek", yv, wv)
        s.diagonal(0, -4, -2).add_(fixed.einsum("...ldki,...ldkj,...ld->...dij", jc, jc, vf).movedim(-3, -1))
        b = fixed.einsum("...ldi,...ld->...di", bc_blk - yb, vf)
        cam_idx = torch.arange(D, dtype=torch.int32, device=obs_cam.device).expand(obs_cam.shape)
    else:
        hcc_blk = fixed.einsum("...ldki,...ldkj->...ldij", jc, jc)
        pair = fixed.einsum("...ldij,...lekj->...ldeik", y, wmat)  # [..., L, D, D, 6, 6]
        pair_valid = vf[..., :, None] * vf[..., None, :]
        cam_idx = torch.clamp(obs_cam, 0, n_cams - 1)
        batch = obs_cam.shape[:-2]
        d_idx = cam_idx[..., :, :, None].expand(*batch, L, D, D).reshape(*batch, L * D * D)
        e_idx = cam_idx[..., :, None, :].expand(*batch, L, D, D).reshape(*batch, L * D * D)
        diag_idx = cam_idx.reshape(*batch, L * D)
        blocks = torch.cat([(hcc_blk * vf[..., None, None]).reshape(*batch, L * D, 6, 6),
                            (-pair * pair_valid[..., None, None]).reshape(*batch, L * D * D, 6, 6)], dim=-3)
        s = _scatter_pairs(blocks, torch.cat([diag_idx, d_idx], -1), torch.cat([diag_idx, e_idx], -1), n_cams)
        b = _scatter_rows(((bc_blk - yb) * vf[..., None]).reshape(*batch, L * D, 6), diag_idx, n_cams)
    n6 = 6 * n_cams
    return s.reshape(*s.shape[:-4], n6, n6), b.reshape(*b.shape[:-2], n6), hpp_inv, bp, wmat, valid, cam_idx


def _apply_dx(rot, trans, points, dx_cam, hpp_inv, bp, wmat, valid, cam_idx, dense_frames: bool):
    """SE(3) pose update and landmark back-substitution from a solved
    dx_cam: dp = Hpp^-1 (bp - W^T dx_cam(observers))."""
    if dense_frames:
        wtd = fixed.einsum("...ldij,...di->...lj", wmat * valid[..., None, None], dx_cam)
    else:
        wtd = fixed.einsum("...ldij,...ldi->...lj", wmat * valid[..., None, None], take_cams(dx_cam, cam_idx))
    rot2, trans2 = se3_update(rot, trans, dx_cam)
    return rot2, trans2, points + rotate(hpp_inv, bp - wtd)


def _solve_and_update(rot, trans, points, S, b, hpp_inv, bp, wmat, valid, cam_idx, opts, lam, n_fixed=None,
                      dense_frames: bool = False):
    n_cams = rot.shape[-3]
    # Gauge: the first n_fixed cameras' rows and columns become identity.
    if n_fixed is None:
        n_fixed = max(1, min(opts.num_fixed_cameras, n_cams))
    k = 6 * min(max(int(n_fixed), 1), n_cams)
    gauge = torch.arange(6 * n_cams, device=S.device) < k
    S = torch.where(gauge[:, None] | gauge[None, :], 0.0, S)
    diag = S.diagonal(dim1=-2, dim2=-1)
    S.diagonal(dim1=-2, dim2=-1).copy_(torch.where(gauge, 1.0, diag))
    b = torch.where(gauge, 0.0, b)
    # Levenberg-Marquardt diagonal-relative damping plus an absolute jitter.
    diag = S.diagonal(dim1=-2, dim2=-1).clone()
    S.diagonal(dim1=-2, dim2=-1).add_(lam[..., None] * diag + 1e-6)

    dx = solve(S, b)
    if S.dtype == torch.float32:
        dx = dx + solve(S, b - rotate(S, dx))  # one step of iterative refinement
    dx_cam = dx.to(rot.dtype).reshape(*dx.shape[:-1], n_cams, 6)
    return (*_apply_dx(rot, trans, points, dx_cam, hpp_inv, bp, wmat, valid, cam_idx, dense_frames), dx_cam)


def reprojection_cost(problem: BAProblem, cam: Pinhole, opts: BAOptions) -> torch.Tensor:
    valid, r, _, _, w = _per_landmark_blocks(
        problem.rot, problem.trans, problem.points, problem.obs_cam, problem.obs_uv, cam, opts)
    return fixed.sum(fixed.sum(r * r, -1) * w, (-2, -1)) / torch.clamp_min(valid.sum((-2, -1)), 1)


def _residuals(rot, trans, points, obs_cam, obs_uv, cam, dense_frames: bool):
    R, t = _poses_per_obs(rot, trans, obs_cam, dense_frames)
    return project(rotate(R, points[..., :, None, :]) + t, cam) - obs_uv


def _cost(rot, trans, points, obs_cam, obs_uv, cam, opts, obs_w=None, dense_frames: bool = False):
    """The true Huber objective, the function the IRLS step minimizes."""
    r = _residuals(rot, trans, points, obs_cam, obs_uv, cam, dense_frames)
    r2 = fixed.sum(r * r, -1)
    rn = torch.sqrt(torch.clamp_min(r2, 1e-12))
    d = opts.huber_delta
    rho = torch.where(rn <= d, r2, 2.0 * d * rn - d * d)
    mask = (obs_cam >= 0).to(rho.dtype)
    if obs_w is not None:
        mask = mask * obs_w
    return fixed.sum(rho * mask, (-2, -1))


def _residual_norms(rot, trans, points, obs_cam, obs_uv, cam, dense_frames: bool = False):
    r = _residuals(rot, trans, points, obs_cam, obs_uv, cam, dense_frames)
    return torch.sqrt(torch.clamp_min(fixed.sum(r * r, -1), 1e-12)), obs_cam >= 0


def _masked_median(x, mask):
    """Median of x[mask] over the last two axes, by sort."""
    s = torch.sort(torch.where(mask, x, float("inf")).flatten(-2), dim=-1).values
    n = torch.clamp_min(mask.flatten(-2).sum(-1), 1)
    lo = torch.gather(s, -1, torch.clamp_min((n - 1) // 2, 0)[..., None])[..., 0]
    hi = torch.gather(s, -1, (n // 2)[..., None])[..., 0]
    return 0.5 * (lo + hi)


def _mad_cutoff(rn, mask, k):
    med = _masked_median(rn, mask)
    mad = _masked_median((rn - med[..., None, None]).abs(), mask)
    return med + k * 1.4826 * mad


def _mad_gate(rn, mask, k):
    """0/1 mask keeping residual norms within median + k 1.4826 MAD."""
    return (rn <= (_mad_cutoff(rn, mask, k) + 1e-3)[..., None, None]).to(torch.float32)


def _relandmark(rot, trans, points, obs_cam, obs_uv, cam: Pinhole, gate_px, dense_frames: bool = False):
    """Per-landmark consensus re-estimation and observation gating.

    Hypotheses: midpoint triangulations from every observation pair, every
    leave-one-out subset and the full set, plus the current point; each is
    scored by its inliers within ``gate_px`` (scalar or [...]), ties to the
    smaller mean inlier residual, then to the current point; the winner is
    refit on its consensus set when that keeps its support.  Returns
    (new_points [..., L, 3], obs_w [..., L, D] 0/1).
    """
    L, D = obs_cam.shape[-2:]
    valid = obs_cam >= 0
    gate = torch.as_tensor(gate_px, dtype=points.dtype, device=points.device)
    gate = gate.reshape(gate.shape + (1, 1, 1))  # [..., 1, 1, 1] against [..., L, H, D]
    R, t = _poses_per_obs(rot, trans, obs_cam, dense_frames)
    centers = -rotate(R.transpose(-1, -2), t)
    rx = (obs_uv[..., 0] - cam.cx) / cam.fx
    ry = (obs_uv[..., 1] - cam.cy) / cam.fy
    rays_w = rotate(R.transpose(-1, -2), torch.stack([rx, ry, torch.ones_like(rx)], -1))
    rays_w = rays_w / torch.clamp_min(fixed.norm(rays_w, keepdim=True), 1e-12)

    # Midpoint normal equations: sum_d (I - r_d r_d^T) x = sum_d (I - r_d r_d^T) c_d.
    eye = eye3(points)
    m = (eye - rays_w[..., :, None] * rays_w[..., None, :]) * valid[..., None, None]
    mc = rotate(m, centers)
    n_valid = valid.sum(-1)

    def tri(a, rhs):
        return solve3(a + 1e-6 * eye, rhs)

    hyp_pair = tri(m[..., :, None, :, :] + m[..., None, :, :, :], mc[..., :, None, :] + mc[..., None, :, :])
    not_self = ~torch.eye(D, dtype=torch.bool, device=obs_cam.device)
    pair_ok = (valid[..., :, None] & valid[..., None, :] & not_self).flatten(-2)
    a_full = fixed.sum(m, -3)
    rhs_full = fixed.sum(mc, -2)
    hyp_loo = tri(a_full[..., None, :, :] - m, rhs_full[..., None, :] - mc)
    loo_ok = valid & ((n_valid[..., None] - 1) >= 2)
    hyp_full = tri(a_full, rhs_full)[..., None, :]
    full_ok = (n_valid >= 2)[..., None]

    # The current point goes last, so only the tie bonus below prefers it.
    hyp = torch.cat([hyp_pair.flatten(-3, -2), hyp_loo, hyp_full, points[..., None, :]], dim=-2)  # [..., L, H, 3]
    hyp_ok = torch.cat([pair_ok, loo_ok, full_ok, torch.ones_like(full_ok)], dim=-1)
    H = hyp.shape[-2]

    rc = R[..., :, None, :, :, :]  # [..., L, 1, D, 3, 3]

    def score_of(h, ok):
        hh = h[..., :, :, None, :]  # [..., L, H', 1, 3]
        pc = hh[..., 0:1] * rc[..., 0] + hh[..., 1:2] * rc[..., 1] + hh[..., 2:3] * rc[..., 2] + t[..., :, None, :, :]
        z = torch.clamp_min(pc[..., 2], 1e-6)
        du = cam.fx * pc[..., 0] / z + cam.cx - obs_uv[..., None, :, 0]
        dv = cam.fy * pc[..., 1] / z + cam.cy - obs_uv[..., None, :, 1]
        rn = torch.sqrt(du * du + dv * dv + 1e-12)
        inl = (rn < gate) & valid[..., None, :] & (pc[..., 2] > 1e-6)
        n_inl = inl.sum(-1)
        mean_in = fixed.sum(torch.where(inl, rn, 0.0), -1) / torch.clamp_min(n_inl, 1)
        score = n_inl.to(rn.dtype) - 1e-3 * torch.clamp(mean_in / gate[..., 0], 0.0, 1.0)
        return inl, n_inl, torch.where(ok, score, -1.0)

    inl, n_inl, score = score_of(hyp, hyp_ok)
    # The bonus exceeds the tie-break's whole range: an equally supported
    # hypothesis never displaces the current point.
    score = torch.cat([score[..., : H - 1], score[..., H - 1:] + 2e-3], dim=-1)
    best = torch.argmax(score, dim=-1)
    win_pt = torch.gather(hyp, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    win_inl = torch.gather(inl, -2, best[..., None, None].expand(*best.shape, 1, D))[..., 0, :]
    win_n = torch.gather(n_inl, -1, best[..., None])[..., 0]

    # Consensus refit from all the winner's inlier rays, kept when its
    # support does not drop.
    mw = m * win_inl[..., None, None]
    refit = tri(fixed.sum(mw, -3), fixed.sum(rotate(mw, centers), -2))
    r_inl, r_n, _ = score_of(refit[..., None, :], torch.ones_like(full_ok))
    r_inl, r_n = r_inl[..., 0, :], r_n[..., 0]
    use_refit = r_n >= win_n
    new_pts = torch.where(use_refit[..., None], refit, win_pt)
    obs_w = torch.where(use_refit[..., None], r_inl, win_inl)
    # A landmark with fewer than 2 consensus observations is frozen.
    enough = obs_w.sum(-1) >= 2
    obs_w = obs_w & enough[..., None]
    new_pts = torch.where(enough[..., None], new_pts, points)
    return new_pts, obs_w.to(points.dtype)


def ba_solve(problem: BAProblem, cam: Pinhole, opts: BAOptions = BAOptions(), num_fixed: Optional[int] = None
             ) -> BAProblem:
    """Bundle adjustment solved in float64, returned in float32.
    ``num_fixed`` overrides ``opts.num_fixed_cameras``."""
    check_no_tf32(problem.rot.device)
    return _ba_solve_impl(problem, cam, opts, num_fixed, f64=True)


def _ba_solve_impl(problem: BAProblem, cam: Pinhole, opts: BAOptions, num_fixed: Optional[int] = None,
                   dense_frames: bool = False, f64: bool = False) -> BAProblem:
    """Levenberg-Marquardt with outlier-gating rounds.

    Each round runs ``max_iterations`` LM iterations (accept/reject on the
    true Huber objective; a rejected step raises lambda).  With
    ``gate_px > 0`` every round starts with a MAD clip of the residuals, and
    ``gate_rounds`` consensus re-landmarking rounds follow the first, which
    then run plain Gauss-Newton on the gated observations.  ``f64``: solve
    in float64 and return the input's dtype; otherwise everything runs in
    the input's dtype, and float32 solves get one refinement step.
    """
    out_dtype = problem.rot.dtype
    if f64:
        problem = problem._replace(**{k: getattr(problem, k).to(torch.float64)
                                      for k in ("rot", "trans", "points", "obs_uv")})
    obs_cam, obs_uv = problem.obs_cam, problem.obs_uv
    n_cams = problem.rot.shape[-3]

    def lm_round(rot, trans, points, obs_w, ropts):
        cost = _cost(rot, trans, points, obs_cam, obs_uv, cam, ropts, obs_w, dense_frames)
        lam = torch.full(cost.shape, ropts.damping, dtype=cost.dtype, device=cost.device)
        for _ in range(ropts.max_iterations):
            out = _assemble(rot, trans, points, obs_cam, obs_uv, cam, ropts, n_cams, obs_w, dense_frames)
            rot2, trans2, points2, _ = _solve_and_update(rot, trans, points, *out, ropts, lam, num_fixed,
                                                         dense_frames)
            new_cost = _cost(rot2, trans2, points2, obs_cam, obs_uv, cam, ropts, obs_w, dense_frames)
            accept = new_cost < cost
            rot = torch.where(accept[..., None, None, None], rot2, rot)
            trans = torch.where(accept[..., None, None], trans2, trans)
            points = torch.where(accept[..., None, None], points2, points)
            lam = torch.clamp(torch.where(accept, lam * ropts.damping_down, lam * ropts.damping_up), 1e-9, 1e3)
            cost = torch.where(accept, new_cost, cost)
        return rot, trans, points

    def run_round(rot, trans, points, obs_w, ropts):
        # MAD clip from the round's starting state, folded into its weights.
        if opts.gate_px > 0 and opts.mad_clip > 0:
            rn, valid = _residual_norms(rot, trans, points, obs_cam, obs_uv, cam, dense_frames)
            obs_w = obs_w * _mad_gate(rn, valid & (obs_w > 0), opts.mad_clip)
        return lm_round(rot, trans, points, obs_w, ropts)

    def annealed_gate(rot, trans, points, obs_w):
        # max(gate_px, MAD cutoff): looser than the cameras' current mutual
        # consistency, annealing to gate_px as the solve converges.
        rn, valid = _residual_norms(rot, trans, points, obs_cam, obs_uv, cam, dense_frames)
        return torch.clamp_min(_mad_cutoff(rn, valid & (obs_w > 0), opts.mad_clip), opts.gate_px)

    gn_opts = dataclasses.replace(opts, huber_delta=1e12)
    rot, trans, points = problem.rot, problem.trans, problem.points
    obs_w = torch.ones(obs_cam.shape, dtype=torch.float32, device=obs_cam.device)
    rot, trans, points = run_round(rot, trans, points, obs_w, opts)
    if opts.gate_px > 0:
        for _ in range(opts.gate_rounds):
            gate = annealed_gate(rot, trans, points, obs_w)
            points, obs_w = _relandmark(rot, trans, points, obs_cam, obs_uv, cam, gate, dense_frames)
            rot, trans, points = run_round(rot, trans, points, obs_w, gn_opts)
    return problem._replace(rot=rot.to(out_dtype), trans=trans.to(out_dtype), points=points.to(out_dtype),
                            obs_uv=problem.obs_uv.to(out_dtype))


# --------------------------------------------------------------------------
# Multi-device solver
# --------------------------------------------------------------------------


def _gauge_damp_rows(S_rows, b_rows, row0: int, n6: int, lam, n_fixed: int):
    """Gauge fix and LM damping on a row block of the reduced camera system.

    The arithmetic of ``_solve_and_update`` (the first ``n_fixed`` cameras'
    rows and columns become identity, diagonal times (1 + lam) plus 1e-6)
    on rows ``row0 ...`` only, so the system can stay reduce-scattered.
    ``S_rows`` is [rows, n6p], both axes padded to the rank multiple n6p;
    a padding row (global index >= n6) gets a unit diagonal, so the Jacobi
    preconditioner stays finite and CG leaves its component at 0.
    Returns (S_rows, b_rows, diagonal).
    """
    rows, cols = S_rows.shape
    k = 6 * n_fixed
    col_idx = torch.arange(cols, device=S_rows.device)
    row_idx = row0 + torch.arange(rows, device=S_rows.device)
    fixed_r, pad_r = row_idx < k, row_idx >= n6
    S0 = torch.where(fixed_r[:, None] | (col_idx < k)[None, :] | pad_r[:, None], 0.0, S_rows)
    is_diag = col_idx[None, :] == row_idx[:, None]
    diag = torch.where(fixed_r | pad_r, 1.0, (S0 * is_diag).sum(1)) * (1.0 + lam) + 1e-6
    return torch.where(is_diag, diag[:, None], S0), torch.where(fixed_r | pad_r, 0.0, b_rows), diag


def _cg_solve_sharded(S_rows, b_rows, diag_rows, mesh, axis: str, iters: int):
    """Jacobi-preconditioned CG on the row-sharded reduced system.

    Each rank holds a row block; the matvec is the local [rows, n6p] @
    [n6p] product and one all-gather, the only collective of an iteration.
    Every scalar comes from replicated vectors, so all ranks walk the same
    iterates.  Runs exactly ``iters`` iterations; returns x [n6p].
    """
    gather = lambda v: gather_leading(v, mesh, axis)
    b = gather(b_rows)
    m_inv = 1.0 / gather(diag_rows)
    x = torch.zeros_like(b)
    r = b
    z = m_inv * r
    p = z
    rz = torch.dot(r, z)
    for _ in range(iters):
        ap = gather(S_rows @ p)
        alpha = rz / torch.clamp_min(torch.dot(p, ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * ap
        z = m_inv * r
        rz_new = torch.dot(r, z)
        p = z + rz_new / torch.clamp_min(rz, 1e-20) * p
        rz = rz_new
    return x


def make_distributed_ba(mesh, cam: Pinhole, opts: BAOptions = BAOptions(), axis: str = "data",
                        camera_shard: bool = False, cg_iterations: int = 64):
    """Landmark-sharded bundle adjustment over the ``axis`` ranks of a mesh.

    Every rank passes the whole problem and gets the whole solution back
    (poses replicated, points gathered), solved in float64 and returned in
    float32 like ``ba_solve``.  Landmarks pad to a multiple of the axis with
    empty observations.  Each rank eliminates its landmarks; the reduced
    camera system, its right-hand side and the cost go through ONE
    all-reduce per LM iteration, and the accepted state's system is carried,
    so a rejected step costs no collective.  The MAD gates read the global
    residual distribution (an all-gather of one norm per observation); the
    consensus re-landmarking is local to each landmark's rank.

    ``camera_shard=True``: the reduced system's rows (both axes padded to
    the rank multiple) are reduce-scattered instead, and the camera step is
    ``cg_iterations`` of distributed Jacobi-preconditioned CG, so no rank
    holds the whole system.  For camera counts in the hundreds; the dense
    path is exact and faster for small windows.

    Returns fn(problem) -> problem.
    """
    n_dev = axis_size(mesh, axis)
    group = axis_group(mesh, axis)

    def all_sum(x):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    def run(problem: BAProblem) -> BAProblem:
        dev = mesh_device(mesh)
        check_no_tf32(dev)
        problem = BAProblem(*(as_tensor(x, dev) for x in problem))
        out_dtype = problem.rot.dtype
        f64 = lambda x: x.to(torch.float64)
        L = problem.points.shape[0]
        rot, trans = f64(problem.rot), f64(problem.trans)
        points = shard_leading(f64(problem.points), mesh, axis, 0.0)
        obs_cam = shard_leading(problem.obs_cam, mesh, axis, -1)
        obs_uv = shard_leading(f64(problem.obs_uv), mesh, axis, 0.0)
        n_cams = rot.shape[0]
        n6 = 6 * n_cams
        n_fixed = max(1, min(opts.num_fixed_cameras, n_cams))
        damping = lambda ropts: torch.tensor(ropts.damping, dtype=torch.float64, device=dev)

        def step_lam(accept, lam, ropts):
            return torch.clamp(torch.where(accept, lam * ropts.damping_down, lam * ropts.damping_up), 1e-9, 1e3)

        def lm_round_dense(rot, trans, points, obs_w, ropts):
            def assemble(rot, trans, points):
                S, b, hpp_inv, bp, wmat, valid, cam_idx = _assemble(rot, trans, points, obs_cam, obs_uv, cam, ropts,
                                                                    n_cams, obs_w)
                cost = _cost(rot, trans, points, obs_cam, obs_uv, cam, ropts, obs_w)
                packed = all_sum(torch.cat([S.reshape(-1), b, cost.reshape(1)]))
                return packed[:n6 * n6].reshape(n6, n6), packed[n6 * n6:-1], (hpp_inv, bp, wmat, valid, cam_idx), \
                    packed[-1]

            S, b, aux, cost = assemble(rot, trans, points)
            lam = damping(ropts)
            for _ in range(ropts.max_iterations):
                rot2, trans2, points2, _ = _solve_and_update(rot, trans, points, S, b, *aux, ropts, lam, n_fixed)
                S2, b2, aux2, cost2 = assemble(rot2, trans2, points2)
                accept = cost2 < cost
                pick = lambda new, old: torch.where(accept, new, old)
                rot, trans, points = pick(rot2, rot), pick(trans2, trans), pick(points2, points)
                S, b = pick(S2, S), pick(b2, b)
                aux = tuple(pick(x2, x) for x2, x in zip(aux2, aux))
                lam = step_lam(accept, lam, ropts)
                cost = pick(cost2, cost)
            return rot, trans, points

        def lm_round_cg(rot, trans, points, obs_w, ropts):
            n6p = -(-n6 // n_dev) * n_dev
            rows = n6p // n_dev
            row0 = axis_index(mesh, axis) * rows

            def cost_of(rot, trans, points):
                return all_sum(_cost(rot, trans, points, obs_cam, obs_uv, cam, ropts, obs_w).reshape(1))[0]

            cost = cost_of(rot, trans, points)
            lam = damping(ropts)
            for _ in range(ropts.max_iterations):
                S, b, hpp_inv, bp, wmat, valid, cam_idx = _assemble(rot, trans, points, obs_cam, obs_uv, cam, ropts,
                                                                    n_cams, obs_w)
                system = torch.zeros((n6p, n6p + 1), dtype=S.dtype, device=dev)
                system[:n6, :n6] = S
                system[:n6, n6p] = b
                local = torch.empty((rows, n6p + 1), dtype=S.dtype, device=dev)
                dist.reduce_scatter(local, list(system.chunk(n_dev)), op=dist.ReduceOp.SUM, group=group)
                S_loc, b_loc, diag = _gauge_damp_rows(local[:, :n6p], local[:, n6p], row0, n6, lam, n_fixed)
                dx = _cg_solve_sharded(S_loc, b_loc, diag, mesh, axis, cg_iterations)
                rot2, trans2, points2 = _apply_dx(rot, trans, points, dx[:n6].reshape(n_cams, 6), hpp_inv, bp, wmat,
                                                  valid, cam_idx, False)
                cost2 = cost_of(rot2, trans2, points2)
                accept = cost2 < cost
                pick = lambda new, old: torch.where(accept, new, old)
                rot, trans, points = pick(rot2, rot), pick(trans2, trans), pick(points2, points)
                lam = step_lam(accept, lam, ropts)
                cost = pick(cost2, cost)
            return rot, trans, points

        lm_round = lm_round_cg if camera_shard else lm_round_dense

        def global_cutoff(rot, trans, points, obs_w):
            # The MAD cutoff over every rank's residual norms.
            rn, valid = _residual_norms(rot, trans, points, obs_cam, obs_uv, cam)
            mask = valid & (obs_w > 0)
            return rn, _mad_cutoff(gather_leading(rn, mesh, axis), gather_leading(mask, mesh, axis), opts.mad_clip)

        def run_round(rot, trans, points, obs_w, ropts):
            if opts.gate_px > 0 and opts.mad_clip > 0:
                rn, cutoff = global_cutoff(rot, trans, points, obs_w)
                obs_w = obs_w * (rn <= cutoff + 1e-3).to(torch.float32)
            return lm_round(rot, trans, points, obs_w, ropts)

        gn_opts = dataclasses.replace(opts, huber_delta=1e12)
        obs_w = torch.ones(obs_cam.shape, dtype=torch.float32, device=dev)
        rot, trans, points = run_round(rot, trans, points, obs_w, opts)
        if opts.gate_px > 0:
            for _ in range(opts.gate_rounds):
                gate = torch.clamp_min(global_cutoff(rot, trans, points, obs_w)[1], opts.gate_px)
                points, obs_w = _relandmark(rot, trans, points, obs_cam, obs_uv, cam, gate)
                rot, trans, points = run_round(rot, trans, points, obs_w, gn_opts)
        points = gather_leading(points, mesh, axis)[:L]
        return problem._replace(rot=rot.to(out_dtype), trans=trans.to(out_dtype), points=points.to(out_dtype))

    return run
