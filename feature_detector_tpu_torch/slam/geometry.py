"""Multi-view geometry: triangulation, two-view pose, epipolar gating, PnP.

Counterpart of ``feature_detector_tpu/slam/geometry.py``, function by
function.  Where the JAX package vmaps a per-problem function, these take
leading batch axes: every argument broadcasts over ``...``, and a RANSAC's
rounds or a two-view init's candidates are one more batch axis, so a batch
of problems runs as one chain of tensor operations whatever its size.

Random draws: the RANSACs draw their hypotheses as the top 8 of Gumbel noise
over the valid slots.  The noise is an argument, ``gumbel`` [rounds, n];
without it, ``ransac_gumbel`` draws it from a CPU ``torch.Generator`` seeded
with ``seed`` and copies it to the device, so the card and the CPU see the
same hypotheses.  (The JAX package draws with ``jax.random`` instead; its
draws can be handed in through ``gumbel``.)

Products, sums and small dense solves go through ``fixed.py``: inside
``fixed.batch_invariant`` (the chunk solver) a float32 problem gives the
same bits whatever the batch it is solved in.  The eigen- and
singular-value decompositions stay the library's batched calls.

Decompositions: eigenvector and singular-vector signs differ between
LAPACK and cuSOLVER; everything downstream of them here is sign-invariant
(the essential matrix is defined up to sign, and the decomposition fixes
its factors' signs by determinant).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import fixed
from .camera import Pinhole, projection_jacobian
from .fixed import solve
from .lie import eye3, hat, jacfwd, rotate, so3_exp
from .linalg3 import det3, solve3

_TOP_K = 8  # hypotheses refined by two_view_init


# --------------------------------------------------------------------------
# Decompositions that, like XLA's, never raise
# --------------------------------------------------------------------------


_LINALG_BATCH = 2048  # matrices per batched eigh/SVD call (cuSOLVER's batched calls reject larger ones)


def _finite_or_nan(x: torch.Tensor, fn):
    """``fn`` of [..., n, n] matrices, in batches of at most _LINALG_BATCH; a
    matrix with a non-finite entry gives NaN outputs (LAPACK would fail on
    it and torch would raise)."""
    bad = ~torch.isfinite(x).all(-1).all(-1)
    flat = torch.where(bad[..., None, None], torch.zeros_like(x), x).reshape(-1, *x.shape[-2:])
    parts = [fn(flat[i:i + _LINALG_BATCH]) for i in range(0, max(flat.shape[0], 1), _LINALG_BATCH)]
    outs = [torch.cat(o).reshape(*bad.shape, *o[0].shape[1:]) for o in zip(*parts)]
    return tuple(torch.where(bad.reshape(bad.shape + (1,) * (o.dim() - bad.dim())), float("nan"), o) for o in outs)


def eigh(x: torch.Tensor):
    return _finite_or_nan(x, torch.linalg.eigh)


def svd(x: torch.Tensor):
    return _finite_or_nan(x, torch.linalg.svd)


# --------------------------------------------------------------------------
# Random hypotheses
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _gumbel_on(seed: int, rounds: int, n: int, device: str) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((rounds, n), generator=gen, dtype=torch.float32)
    g = -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(torch.float32).tiny)))
    return g.to(device)


def ransac_gumbel(seed: int, rounds: int, n: int, device) -> torch.Tensor:
    """Gumbel noise [rounds, n] drawn on the CPU from ``torch.Generator``
    seeded with ``seed``, copied to ``device`` (cached; do not modify)."""
    return _gumbel_on(int(seed), int(rounds), int(n), str(torch.device(device)))


def _hypothesis_weights(valid: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """[..., n] valid, [rounds, n] noise -> [..., rounds, n] 0/1 weights of
    each round's 8 samples: the top 8 of noise over the valid slots, without
    replacement (invalid slots only when fewer than 8 are valid)."""
    logits = torch.where(valid, 0.0, float("-inf"))
    g = gumbel + logits[..., None, :]
    sel = torch.argsort(-g, dim=-1, stable=True)[..., :8]
    w = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    return w.scatter(-1, sel, 1.0)


# --------------------------------------------------------------------------
# Triangulation and the essential matrix
# --------------------------------------------------------------------------


def backproject(uv: torch.Tensor, cam: Pinhole) -> torch.Tensor:
    """Pixel -> normalized camera ray (z=1). uv [..., 2] -> [..., 3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def triangulate(rot_a, trans_a, rot_b, trans_b, uv_a, uv_b, cam: Pinhole):
    """Linear (DLT) two-view triangulation, batched over matches.

    Poses are world->camera: p_cam = R p_world + t.  rot_* [..., 3, 3],
    trans_* [..., 3], uv_* [..., N, 2] pixels.  Inhomogeneous DLT (w = 1)
    through the closed-form 3x3 normal equations, scale-normalized before
    the Cramer solve.  Returns (points [..., N, 3] world, depths_ok [..., N]).
    """
    ray_a = backproject(uv_a, cam)
    ray_b = backproject(uv_b, cam)
    pa = torch.cat([rot_a, trans_a[..., None]], dim=-1)[..., None, :, :]  # [..., 1, 3, 4]
    pb = torch.cat([rot_b, trans_b[..., None]], dim=-1)[..., None, :, :]
    a = torch.stack(
        torch.broadcast_tensors(
            ray_a[..., 0, None] * pa[..., 2, :] - pa[..., 0, :],
            ray_a[..., 1, None] * pa[..., 2, :] - pa[..., 1, :],
            ray_b[..., 0, None] * pb[..., 2, :] - pb[..., 0, :],
            ray_b[..., 1, None] * pb[..., 2, :] - pb[..., 1, :],
        ),
        dim=-2,
    )  # [..., N, 4, 4]
    m = a[..., :3]
    c = a[..., 3]
    mt = m.transpose(-1, -2)
    ata = fixed.matmul(mt, m)
    tr = ata[..., 0, 0] + ata[..., 1, 1] + ata[..., 2, 2]
    ata = ata + (1e-9 * tr + 1e-20)[..., None, None] * eye3(ata)
    s = torch.clamp_min(ata.abs().amax(dim=(-2, -1)), 1e-20)
    pts = -solve3(ata / s[..., None, None], rotate(mt, c) / s[..., None])
    za = fixed.sum(rot_a[..., None, 2, :] * pts, -1) + trans_a[..., None, 2]
    zb = fixed.sum(rot_b[..., None, 2, :] * pts, -1) + trans_b[..., None, 2]
    return pts, (za > 1e-6) & (zb > 1e-6)


def _epipolar_design(xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Rows kron(xb, xa) of the constraint xb^T E xa = 0: [..., N, 9]."""
    return (xb[..., :, None] * xa[..., None, :]).flatten(-2)


def _weighted_normal(a: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """A^T W A for design rows a [..., N, 9] and weights [..., M, N]
    (M weightings of the same rows): [..., M, 9, 9]."""
    outer = (a[..., :, None] * a[..., None, :]).flatten(-2)  # [..., N, 81]
    return fixed.matmul(weight, outer).unflatten(-1, (9, 9))


def _essential_from_normal(ata: torch.Tensor) -> torch.Tensor:
    """Smallest eigenvector of A^T W A, projected onto the essential
    manifold (two equal singular values, third zero)."""
    _, vecs = eigh(ata)
    e = vecs[..., :, 0].unflatten(-1, (3, 3))
    u, s, vt = svd(e)
    sigma = (s[..., 0] + s[..., 1]) / 2.0
    d = torch.stack([sigma, sigma, torch.zeros_like(sigma)], dim=-1)
    return fixed.matmul(u * d[..., None, :], vt)


def essential_from_matches(uv_a, uv_b, weight, cam: Pinhole) -> torch.Tensor:
    """Weighted normalized 8-point essential matrix: uv_* [..., N, 2],
    weight [..., N] -> [..., 3, 3] (defined up to sign)."""
    a = _epipolar_design(backproject(uv_a, cam), backproject(uv_b, cam))
    return _essential_from_normal(_weighted_normal(a, weight[..., None, :])[..., 0, :, :])


def decompose_essential(e, uv_a, uv_b, weight, cam: Pinhole):
    """Relative pose (R, t) of camera B w.r.t. camera A (identity) from E,
    ||t|| = 1.  The winner among the 4 decompositions has the most weighted
    points passing cheirality in both views (the first on a tie)."""
    u, _, vt = svd(e)
    u = u * torch.sign(det3(u))[..., None, None]
    vt = vt * torch.sign(det3(vt))[..., None, None]
    w = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=e.dtype, device=e.device)
    r1 = fixed.matmul(fixed.matmul(u, w), vt)
    r2 = fixed.matmul(fixed.matmul(u, w.T), vt)
    t = u[..., :, 2]
    cands_r = torch.stack([r1, r1, r2, r2], dim=-3)  # [..., 4, 3, 3]
    cands_t = torch.stack([t, -t, t, -t], dim=-2)
    eye = eye3(e)
    _, ok = triangulate(eye, torch.zeros(3, dtype=e.dtype, device=e.device), cands_r, cands_t,
                        uv_a[..., None, :, :], uv_b[..., None, :, :], cam)
    scores = fixed.sum(ok * weight[..., None, :], -1)  # [..., 4]
    best = torch.argmax(scores, dim=-1)
    pick_r = torch.gather(cands_r, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3))[..., 0, :, :]
    pick_t = torch.gather(cands_t, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    return pick_r, pick_t


def _sampson_d2(e, xa, xb):
    """Squared Sampson epipolar distance in normalized coordinates."""
    exa = fixed.matmul(xa, e.transpose(-1, -2))  # [..., N, 3] = E xa
    etxb = fixed.matmul(xb, e)  # [..., N, 3] = E^T xb
    num = torch.square(fixed.sum(xb * exa, -1))
    den = exa[..., 0] ** 2 + exa[..., 1] ** 2 + etxb[..., 0] ** 2 + etxb[..., 1] ** 2
    return num / torch.clamp_min(den, 1e-12)


def _tangent_basis(t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 2] orthonormal basis of the plane orthogonal to unit t."""
    seed = eye3(t)[torch.argmin(t.abs(), dim=-1)]
    b1 = seed - t * fixed.sum(seed * t, -1, keepdim=True)
    b1 = b1 / torch.clamp_min(fixed.norm(b1, keepdim=True), 1e-12)
    b2 = torch.linalg.cross(t, b1, dim=-1)
    return torch.stack([b1, b2], dim=-1)


def _unit(t: torch.Tensor) -> torch.Tensor:
    return t / torch.clamp_min(fixed.norm(t, keepdim=True), 1e-12)


def _perturbed(r, t, basis, dp):
    """(exp(dp[:3]) R, unit(t + B dp[3:5])): the SO(3) x S^2 update."""
    return fixed.matmul(so3_exp(dp[..., :3]), r), _unit(t + rotate(basis, dp[..., 3:5]))


# --------------------------------------------------------------------------
# Two-view refinement
# --------------------------------------------------------------------------


def refine_relative_pose(rot, trans, uv_a, uv_b, weight, cam: Pinhole, iterations: int = 10):
    """Gauss-Newton refinement of (R, t) on SO(3) x S^2 minimizing the
    weighted, Huber-clipped signed Sampson error."""
    xa = backproject(uv_a, cam)
    xb = backproject(uv_b, cam)
    sigma = 2.0 / cam.fx
    r, t = rot, trans
    for _ in range(iterations):
        basis = _tangent_basis(t)

        def residual(delta, r=r, t=t, basis=basis):
            r2, t2 = _perturbed(r, t, basis, delta)
            e = fixed.matmul(hat(t2), r2)
            exa = fixed.matmul(xa, e.transpose(-1, -2))
            etxb = fixed.matmul(xb, e)
            den = exa[..., 0] ** 2 + exa[..., 1] ** 2 + etxb[..., 0] ** 2 + etxb[..., 1] ** 2
            s = fixed.sum(xb * exa, -1) * torch.rsqrt(den + 1e-18)
            hub = torch.clamp_max(sigma / torch.clamp_min(s.abs(), 1e-12), 1.0)
            return s * torch.sqrt(hub) * weight

        zero = torch.zeros(t.shape[:-1] + (5,), dtype=t.dtype, device=t.device)
        j = jacfwd(residual, zero)  # [..., N, 5]
        r0 = residual(zero)
        jt = j.transpose(-1, -2)
        h = fixed.matmul(jt, j) + 1e-9 * torch.eye(5, dtype=j.dtype, device=j.device)
        delta = -solve(h, rotate(jt, r0))
        r, t = _perturbed(r, t, basis, delta)
    return r, t


def refine_relative_pose_reproj(rot, trans, uv_a, uv_b, weight, cam: Pinhole, iterations: int = 15,
                                sigma_px: float = 2.0):
    """Robust two-view bundle: (R, t on S^2) and per-point log-depths along
    the A rays by Cauchy-weighted reprojection error in view B, the depths
    Schur-eliminated in closed form; Levenberg-Marquardt with a fixed trip
    count, masked by ``weight``."""
    xa = backproject(uv_a, cam)
    s2 = sigma_px * sigma_px
    eye = eye3(rot)
    zero3 = torch.zeros(3, dtype=rot.dtype, device=rot.device)
    pts, _ = triangulate(eye, zero3, rot, trans, uv_a, uv_b, cam)
    logz = torch.log(torch.clamp(pts[..., 2], 1e-2, 1e4))

    def residuals(r, t, logz):
        z = torch.exp(torch.clamp(logz, -6.0, 10.0))
        pc = fixed.matmul(xa * z[..., None], r.transpose(-1, -2)) + t[..., None, :]
        zz = torch.clamp_min(pc[..., 2], 1e-6)
        u = cam.fx * pc[..., 0] / zz + cam.cx
        v = cam.fy * pc[..., 1] / zz + cam.cy
        return torch.stack([u, v], -1) - uv_b

    def robust_cost(r, t, logz):
        res = residuals(r, t, logz)
        e2 = fixed.sum(res * res, -1)
        return fixed.sum(weight * s2 * torch.log1p(e2 / s2), -1)

    r, t = rot, trans
    lam = torch.full(t.shape[:-1], 1e-3, dtype=torch.float32, device=t.device)
    cost = robust_cost(r, t, logz)
    eye5 = torch.eye(5, dtype=t.dtype, device=t.device)
    for _ in range(iterations):
        basis = _tangent_basis(t)

        def res_param(dp, dz, r=r, t=t, basis=basis, logz=logz):
            r2, t2 = _perturbed(r, t, basis, dp)
            return residuals(r2, t2, logz + dz)

        zp = torch.zeros(t.shape[:-1] + (5,), dtype=t.dtype, device=t.device)
        zz = torch.zeros_like(logz)
        jp = jacfwd(lambda dp: res_param(dp, zz), zp)  # [..., N, 2, 5]
        jz = torch.func.jvp(lambda dz: res_param(zp, dz), (zz,), (torch.ones_like(zz),))[1]  # [..., N, 2]
        r0 = res_param(zp, zz)
        e2 = fixed.sum(r0 * r0, -1)
        w = weight / (1.0 + e2 / s2)
        a_ = fixed.einsum("...nki,...n,...nkj->...ij", jp, w, jp)
        bv = fixed.einsum("...nki,...n,...nk->...ni", jp, w, jz)
        dv = fixed.einsum("...nk,...n,...nk->...n", jz, w, jz) + lam[..., None] + 1e-8
        ga = fixed.einsum("...nki,...n,...nk->...i", jp, w, r0)
        gz = fixed.einsum("...nk,...n,...nk->...n", jz, w, r0)
        s_ = a_ + lam[..., None, None] * eye5 - fixed.einsum("...ni,...n,...nj->...ij", bv, 1.0 / dv, bv)
        rhs = -(ga - fixed.einsum("...ni,...n,...n->...i", bv, 1.0 / dv, gz))
        dp = solve(s_, rhs)
        dz = -(gz + fixed.matvec(bv, dp)) / dv
        r2, t2 = _perturbed(r, t, basis, dp)
        lz2 = logz + dz
        c2 = robust_cost(r2, t2, lz2)
        ok = torch.isfinite(c2) & (c2 < cost)
        r = torch.where(ok[..., None, None], r2, r)
        t = torch.where(ok[..., None], t2, t)
        logz = torch.where(ok[..., None], lz2, logz)
        lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 5.0), 1e-8, 1e6)
        cost = torch.where(ok, c2, cost)
    return r, t


# --------------------------------------------------------------------------
# RANSAC: two-view init and the epipolar gate
# --------------------------------------------------------------------------


def _ransac_rounds(uv_a, uv_b, valid, cam, gumbel, tau):
    """Every round's 8-point E and Sampson distances, MLESAC-scored:
    returns (scores [..., R], d2 [..., R, N], design rows, xa, xb)."""
    xa = backproject(uv_a, cam)
    xb = backproject(uv_b, cam)
    a = _epipolar_design(xa, xb)
    e = _essential_from_normal(_weighted_normal(a, _hypothesis_weights(valid, gumbel)))  # [..., R, 3, 3]
    d2 = _sampson_d2(e, xa[..., None, :, :], xb[..., None, :, :])  # [..., R, N]
    score = fixed.sum(torch.where(valid[..., None, :], torch.clamp_min(1.0 - d2 / tau, 0.0), 0.0), -1)
    return score, d2, a, xa, xb


def two_view_init(uv_a, uv_b, valid, cam: Pinhole, iterations: int = 3, ransac_rounds: int = 64, seed: int = 0,
                  cheirality_gate: bool = True, gumbel: Optional[torch.Tensor] = None):
    """Two-view relative pose and structure with RANSAC.

    ``ransac_rounds`` 8-point hypotheses (Gumbel top-8 samples) are scored
    by a truncated quadratic (MLESAC); the 8 best consensus sets each go
    through the refinement chain (IRLS 8-point refit, decomposition, Sampson
    Gauss-Newton, robust reprojection bundle), and the candidate with the
    smallest robust reprojection cost over every valid match wins.  uv_*
    [..., N, 2], valid [..., N]; ``gumbel`` [ransac_rounds, N] (drawn from
    ``seed`` when absent).  Returns (rot_b, trans_b, points [..., N, 3],
    inlier [..., N]).
    """
    n = uv_a.shape[-2]
    if gumbel is None:
        gumbel = ransac_gumbel(seed, ransac_rounds, n, uv_a.device)
    sigma2 = (2.0 / cam.fx) ** 2  # ~2 px in normalized coordinates
    tau = 9.0 * sigma2
    sigma2_px = 4.0  # (2 px)^2 Cauchy scale of the selection objective
    scores, d2_all, a, xa, xb = _ransac_rounds(uv_a, uv_b, valid, cam, gumbel, tau)

    top = torch.argsort(-scores, dim=-1, stable=True)[..., :_TOP_K]  # [..., K]
    d2_top = torch.gather(d2_all, -2, top[..., None].expand(*top.shape, n))
    weight = (valid[..., None, :] & (d2_top < tau)).to(torch.float32)  # [..., K, N]
    xa_k, xb_k = xa[..., None, :, :], xb[..., None, :, :]
    for _ in range(iterations):
        e = _essential_from_normal(_weighted_normal(a, weight))
        d2 = _sampson_d2(e, xa_k, xb_k)
        weight = torch.where(valid[..., None, :] & (d2 < 4.0 * tau), 1.0 / (1.0 + d2 / sigma2), 0.0)
    e = _essential_from_normal(_weighted_normal(a, weight))
    uva_k, uvb_k = uv_a[..., None, :, :], uv_b[..., None, :, :]
    r_c, t_c = decompose_essential(e, uva_k, uvb_k, weight, cam)
    r_c, t_c = refine_relative_pose(r_c, t_c, uva_k, uvb_k, weight, cam)
    r_c, t_c = refine_relative_pose_reproj(r_c, t_c, uva_k, uvb_k, weight, cam)
    eye = eye3(r_c)
    zero3 = torch.zeros(3, dtype=r_c.dtype, device=r_c.device)
    pts_c, _ = triangulate(eye, zero3, r_c, t_c, uva_k, uvb_k, cam)
    pc = fixed.matmul(pts_c, r_c.transpose(-1, -2)) + t_c[..., None, :]
    zz = torch.clamp_min(pc[..., 2], 1e-6)
    res = torch.stack([cam.fx * pc[..., 0] / zz + cam.cx, cam.fy * pc[..., 1] / zz + cam.cy], -1) - uvb_k
    e2 = fixed.sum(res * res, -1)
    cand_cost = fixed.sum(torch.where(valid[..., None, :], sigma2_px * torch.log1p(e2 / sigma2_px), 0.0), -1)
    best = torch.argmin(cand_cost, dim=-1)
    rot_b = torch.gather(r_c, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3))[..., 0, :, :]
    trans_b = torch.gather(t_c, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]

    d2 = _sampson_d2(fixed.matmul(hat(trans_b), rot_b), xa, xb)
    pts, cheir = triangulate(eye, zero3, rot_b, trans_b, uv_a, uv_b, cam)
    inlier = valid & (d2 < 9.0 * sigma2)
    if cheirality_gate:
        # Meaningful only with real parallax (see the JAX package).
        inlier = inlier & cheir
    return rot_b, trans_b, pts, inlier


def epipolar_inlier_gate(uv_a, uv_b, valid, cam: Pinhole, ransac_rounds: int = 48, seed: int = 0,
                         gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Epipolar RANSAC inlier mask without pose recovery: the same Gumbel
    top-8 sampling and MLESAC scoring as ``two_view_init``, then two IRLS
    refits of the best round.  uv_* [..., N, 2], valid [..., N] -> [..., N]."""
    n = uv_a.shape[-2]
    if gumbel is None:
        gumbel = ransac_gumbel(seed, ransac_rounds, n, uv_a.device)
    sigma2 = (2.0 / cam.fx) ** 2
    tau = 9.0 * sigma2
    scores, d2_all, a, xa, xb = _ransac_rounds(uv_a, uv_b, valid, cam, gumbel, tau)
    best = torch.argmax(scores, dim=-1)
    d2_best = torch.gather(d2_all, -2, best[..., None, None].expand(*best.shape, 1, n))[..., 0, :]
    weight = (valid & (d2_best < tau)).to(torch.float32)

    def refit(w):
        return _sampson_d2(_essential_from_normal(_weighted_normal(a, w[..., None, :])[..., 0, :, :]), xa, xb)

    d2 = refit(weight)
    weight = torch.where(valid & (d2 < 4.0 * tau), 1.0 / (1.0 + d2 / sigma2), 0.0)
    return valid & (refit(weight) < tau)


# --------------------------------------------------------------------------
# PnP
# --------------------------------------------------------------------------


def _reproj(rot, trans, points, uv, cam):
    pc = fixed.matmul(points, rot.transpose(-1, -2)) + trans[..., None, :]
    z = torch.clamp_min(pc[..., 2], 1e-6)
    return torch.stack([cam.fx * pc[..., 0] / z + cam.cx, cam.fy * pc[..., 1] / z + cam.cy], -1) - uv


def pnp_refine(rot, trans, points, uv, weight, cam: Pinhole):
    """One Gauss-Newton step of pose-only refinement on SE(3); ``weight``
    [..., N] masks points."""

    def residuals(delta):
        r = fixed.matmul(so3_exp(delta[..., :3]), rot)
        return _reproj(r, trans + delta[..., 3:], points, uv, cam) * weight[..., None]

    zero = torch.zeros(trans.shape[:-1] + (6,), dtype=trans.dtype, device=trans.device)
    jf = jacfwd(residuals, zero).flatten(-3, -2)  # [..., 2N, 6]
    rf = residuals(zero).flatten(-2)
    jt = jf.transpose(-1, -2)
    h = fixed.matmul(jt, jf) + 1e-6 * torch.eye(6, dtype=jf.dtype, device=jf.device)
    delta = -solve(h, rotate(jt, rf))
    return fixed.matmul(so3_exp(delta[..., :3]), rot), trans + delta[..., 3:]


def pnp_solve(rot0, trans0, points, uv, valid, cam: Pinhole, *, iters: int = 20, gate_px: float = 3.0):
    """Robust pose-only solve (motion-only BA): damped LM with Cauchy IRLS.

    Observations beyond max(10 px, 3x the prior's median residual) are
    excluded first; then ``iters`` Levenberg iterations, each accepted or
    rejected on the robust cost.  rot0 [..., 3, 3], trans0 [..., 3],
    points [..., N, 3], uv [..., N, 2], valid [..., N].
    """
    n = uv.shape[-2]
    vf = valid.to(torch.float32)

    def errs(rot, trans):
        r = _reproj(rot, trans, points, uv, cam)
        return r, torch.sqrt(fixed.sum(r * r, -1) + 1e-12)

    _, e0 = errs(rot0, trans0)
    srt = torch.sort(torch.where(valid, e0, float("inf")), dim=-1).values
    cnt = valid.sum(-1)
    mid = torch.gather(srt, -1, torch.clamp(cnt // 2, 0, n - 1)[..., None])[..., 0]
    med = torch.where(cnt > 0, mid, 0.0)
    keep = vf * (e0 < torch.clamp_min(3.0 * med, 10.0)[..., None]).to(torch.float32)
    s2 = gate_px * gate_px
    eye6 = torch.eye(6, dtype=trans0.dtype, device=trans0.device)

    def rho_cost(en):
        return fixed.sum(keep * s2 * torch.log1p(en * en / s2), -1)

    rot, trans = rot0, trans0
    lam = torch.full(trans0.shape[:-1], 1e-3, dtype=torch.float32, device=trans0.device)
    cost = rho_cost(e0)
    for _ in range(iters):
        r, en = errs(rot, trans)
        w = keep / (1.0 + en * en / s2)
        pc = fixed.matmul(points, rot.transpose(-1, -2)) + trans[..., None, :]
        jpi = projection_jacobian(pc, cam)  # [..., N, 2, 3]
        jc = torch.cat([-fixed.matmul(jpi, hat(pc)), jpi], dim=-1)  # [..., N, 2, 6]
        jw = jc * w[..., None, None]
        h = fixed.einsum("...nki,...nkj->...ij", jw, jc)
        g = fixed.einsum("...nki,...nk->...i", jw, r)
        h = h + lam[..., None, None] * torch.diag_embed(h.diagonal(dim1=-2, dim2=-1)) + 1e-6 * eye6
        delta = -solve(h, g)
        rot2, trans2 = fixed.matmul(so3_exp(delta[..., :3]), rot), trans + delta[..., 3:]
        c2 = rho_cost(errs(rot2, trans2)[1])
        ok = torch.isfinite(c2) & (c2 < cost)
        rot = torch.where(ok[..., None, None], rot2, rot)
        trans = torch.where(ok[..., None], trans2, trans)
        lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 5.0), 1e-8, 1e4)
        cost = torch.where(ok, c2, cost)
    return rot, trans
