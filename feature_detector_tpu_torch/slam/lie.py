"""SO(3)/SE(3) operations on batched tensors.

Counterpart of ``feature_detector_tpu/slam/lie.py``: rotations are 3x3
matrices, minimal updates are axis-angle left perturbations, and every
function broadcasts over leading axes.  ``jacfwd`` is the forward-mode
Jacobian the solvers take with respect to such perturbations (the JAX
package's ``jax.jacfwd``), batched over the leading axes.  Products and
norms go through ``fixed.py`` (inside ``fixed.batch_invariant``, K4).
"""

from __future__ import annotations

import torch

from . import fixed

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], -1),
            torch.stack([wz, z, -wx], -1),
            torch.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    norm = fixed.norm(w, keepdim=True)
    theta = torch.clamp_min(norm, _EPS)
    k = hat(w / theta)
    th = theta[..., None]
    eye = eye3(w).expand(k.shape)
    r = eye + torch.sin(th) * k + (1.0 - torch.cos(th)) * fixed.matmul(k, k)
    small = norm[..., None] < 1e-7
    return torch.where(small, eye + hat(w), r)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] axis-angle."""
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos)
    sin = torch.sin(theta)
    w_hat = (r - r.transpose(-1, -2)) * 0.5
    vee = torch.stack([w_hat[..., 2, 1], w_hat[..., 0, 2], w_hat[..., 1, 0]], -1)
    scale = torch.where(sin.abs() < _EPS, torch.ones_like(theta), theta / torch.clamp_min(sin, _EPS))
    return vee * scale[..., None]


def rotate(rot: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R x for [..., 3, 3] and [..., 3]."""
    return fixed.matvec(rot, x)


def se3_apply(rot: torch.Tensor, trans: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """p = R x + t, batched."""
    return rotate(rot, x) + trans


def se3_update(rot, trans, delta):
    """Left-perturbation update: R <- exp(dtheta) R, t <- t + dt.
    delta: [..., 6] = (dtheta, dt)."""
    return fixed.matmul(so3_exp(delta[..., :3]), rot), trans + delta[..., 3:]


def se3_inverse(rot, trans):
    rt = rot.transpose(-1, -2)
    return rt, -rotate(rt, trans)


def se3_compose(r1, t1, r2, t2):
    """(R1, t1) * (R2, t2): first apply 2, then 1."""
    return fixed.matmul(r1, r2), rotate(r1, t2) + t1


def se3_log(rot, trans):
    """[..., 6] = (log R, t): the pose graph's chordal-style residual."""
    return torch.cat([so3_log(rot), trans], dim=-1)


def jacfwd(f, x: torch.Tensor) -> torch.Tensor:
    """Forward-mode Jacobian of ``f`` at ``x`` [..., n] with respect to the
    last axis, batched over the leading ones: ``f`` maps [..., n] to
    [..., *out] elementwise in the batch, and the result is [..., *out, n].
    One ``jvp`` per basis direction, vectorised over the n directions."""
    n = x.shape[-1]
    basis = torch.eye(n, dtype=x.dtype, device=x.device)
    tangents = basis.reshape(n, *([1] * (x.dim() - 1)), n).expand(n, *x.shape)
    cols = torch.func.vmap(lambda t: torch.func.jvp(f, (x,), (t,))[1])(tangents)
    return torch.movedim(cols, 0, -1)
