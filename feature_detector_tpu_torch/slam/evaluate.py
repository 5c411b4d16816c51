"""Trajectory evaluation: ATE / RPE with Umeyama alignment.

Counterpart of ``feature_detector_tpu/slam/evaluate.py``: the TUM-RGBD
protocol (Sturm et al., IROS'12), SE(3)/Sim(3) Umeyama alignment of the
estimate onto ground truth, then RMSE over translational residuals (ATE)
and relative-pose deltas (RPE).  Inputs are [N, 3] / [N, 3, 3] tensors or
numpy arrays, computed in float32 on the tensors' device (numpy arrays on
the CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .linalg3 import det3


class Alignment(NamedTuple):
    rotation: torch.Tensor  # [3, 3]
    translation: torch.Tensor  # [3]
    scale: torch.Tensor  # [] float


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.from_numpy(np.array(x, np.float32))


def umeyama_alignment(source, target, with_scale: bool = False) -> Alignment:
    """Least-squares rigid (or similarity) transform aligning source->target.

    Args: source, target: [N, 3] corresponding point sets.
    Returns (R, t, s) minimizing ||target - (s R source + t)||^2.
    """
    source, target = _f32(source), _f32(target)
    mu_s = source.mean(0)
    mu_t = target.mean(0)
    xs = source - mu_s
    xt = target - mu_t
    cov = xt.T @ xs / source.shape[0]
    u, d, vt = torch.linalg.svd(cov)
    s_fix = torch.where(det3(u) * det3(vt) < 0, -1.0, 1.0)
    diag = torch.stack([torch.ones_like(s_fix), torch.ones_like(s_fix), s_fix])
    rot = (u * diag[None, :]) @ vt
    if with_scale:
        var_s = (xs * xs).sum(1).mean()
        scale = (d * diag).sum() / torch.clamp_min(var_s, 1e-12)
    else:
        scale = torch.ones((), dtype=torch.float32, device=source.device)
    trans = mu_t - (scale * rot) @ mu_s
    return Alignment(rotation=rot, translation=trans, scale=scale)


def ate_rmse(estimate_t, groundtruth_t, align: bool = True, with_scale: bool = False) -> torch.Tensor:
    """Absolute trajectory error (RMSE, meters) over [N, 3] positions."""
    est, gt = _f32(estimate_t), _f32(groundtruth_t)
    if align:
        a = umeyama_alignment(est, gt, with_scale=with_scale)
        est = a.scale * est @ a.rotation.T + a.translation
    err = est - gt
    return torch.sqrt((err * err).sum(1).mean())


def rpe_rmse(est_rot, est_t, gt_rot, gt_t, delta: int = 1):
    """Relative pose error over pose pairs (i, i+delta).

    Args: est_rot/gt_rot [N, 3, 3] world-from-camera rotations, est_t/gt_t
    [N, 3] positions.  Returns (trans_rmse, rot_rmse_rad).
    """

    def rel(rot, t):
        r_i, r_j = rot[:-delta], rot[delta:]
        t_i, t_j = t[:-delta], t[delta:]
        # T_i^-1 * T_j
        r_rel = torch.einsum("nba,nbc->nac", r_i, r_j)
        t_rel = torch.einsum("nba,nb->na", r_i, t_j - t_i)
        return r_rel, t_rel

    er, et = rel(_f32(est_rot), _f32(est_t))
    gr, gt_ = rel(_f32(gt_rot), _f32(gt_t))
    dt = et - gt_
    trans_rmse = torch.sqrt((dt * dt).sum(1).mean())
    dr = torch.einsum("nba,nbc->nac", gr, er)
    cos = torch.clamp((dr.diagonal(dim1=1, dim2=2).sum(1) - 1.0) / 2.0, -1.0, 1.0)
    rot_rmse = torch.sqrt((torch.arccos(cos) ** 2).mean())
    return trans_rmse, rot_rmse
