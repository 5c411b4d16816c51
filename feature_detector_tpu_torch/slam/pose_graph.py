"""Pose-graph optimization over SE(3) relative-pose constraints.

Counterpart of ``feature_detector_tpu/slam/pose_graph.py``: a fixed-shape
edge list, Jacobians by forward-mode differentiation of each edge's
residual with respect to left perturbations of its two poses (batched over
the edges), and dense Gauss-Newton with the gauge fixed at node 0.  Runs in
float32, as the JAX package's does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import BAOptions
from .ba import check_no_tf32
from .geometry import solve
from .lie import jacfwd, se3_compose, se3_inverse, se3_log, se3_update


class PoseGraph(NamedTuple):
    """rot [C, 3, 3], trans [C, 3]; edges i->j with measured relative pose
    T_ij = T_i^-1 T_j: edge_i/edge_j [E] int32 (-1 = padding),
    edge_rot [E, 3, 3], edge_trans [E, 3]."""

    rot: torch.Tensor
    trans: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    edge_rot: torch.Tensor
    edge_trans: torch.Tensor


def _edge_residual(ri, ti, rj, tj, r_ij, t_ij, di, dj):
    """Residual log(T_ij^-1 (T_i d_i)^-1 (T_j d_j)) for perturbations d."""
    ri, ti = se3_update(ri, ti, di)
    rj, tj = se3_update(rj, tj, dj)
    inv_ri, inv_ti = se3_inverse(ri, ti)
    rel_r, rel_t = se3_compose(inv_ri, inv_ti, rj, tj)
    inv_mr, inv_mt = se3_inverse(r_ij, t_ij)
    err_r, err_t = se3_compose(inv_mr, inv_mt, rel_r, rel_t)
    return se3_log(err_r, err_t)


def pose_graph_solve(graph: PoseGraph, opts: BAOptions = BAOptions()) -> PoseGraph:
    check_no_tf32(graph.rot.device)
    n = graph.rot.shape[0]
    valid = (graph.edge_i >= 0) & (graph.edge_j >= 0)
    ei = torch.clamp(graph.edge_i, 0, n - 1).long()
    ej = torch.clamp(graph.edge_j, 0, n - 1).long()
    w = valid.to(torch.float32)
    dev = graph.rot.device
    zero6 = torch.zeros(ei.shape[0], 6, dtype=torch.float32, device=dev)
    k = 6 * max(1, min(opts.num_fixed_cameras, n))
    fixed = torch.arange(6 * n, device=dev) < k

    rot, trans = graph.rot, graph.trans
    for _ in range(opts.max_iterations):
        args = (rot[ei], trans[ei], rot[ej], trans[ej], graph.edge_rot, graph.edge_trans)
        r = _edge_residual(*args, zero6, zero6)
        ji = jacfwd(lambda d: _edge_residual(*args, d, zero6), zero6) * w[:, None, None]
        jj = jacfwd(lambda d: _edge_residual(*args, zero6, d), zero6) * w[:, None, None]
        rv = r * valid[:, None]

        # Normal equations accumulated in float64 and rounded once (the
        # card's scatter-add order then does not matter).
        jit, jjt = ji.transpose(1, 2).double(), jj.transpose(1, 2).double()
        jid, jjd = ji.double(), jj.double()
        blocks = torch.zeros(n * n, 6, 6, dtype=torch.float64, device=dev)  # block (a, b) at a * n + b
        blocks.index_add_(0, torch.cat([ei * n + ei, ej * n + ej, ei * n + ej, ej * n + ei]),
                          torch.cat([jit @ jid, jjt @ jjd, jit @ jjd, jjt @ jid]))
        b = torch.zeros(n, 6, dtype=torch.float64, device=dev)
        rvd = rv.double()[..., None]
        b.index_add_(0, torch.cat([ei, ej]), -torch.cat([jit @ rvd, jjt @ rvd])[..., 0])

        hf = blocks.reshape(n, n, 6, 6).transpose(1, 2).reshape(6 * n, 6 * n).to(torch.float32)
        bf = b.reshape(-1).to(torch.float32)
        hf = torch.where(fixed[:, None] | fixed[None, :], 0.0, hf)
        hf.diagonal().copy_(torch.where(fixed, 1.0, hf.diagonal()))
        bf = torch.where(fixed, 0.0, bf)
        diag = hf.diagonal().clone()
        hf.diagonal().add_(opts.damping * diag + 1e-6)
        dx = solve(hf, bf).reshape(n, 6)
        rot, trans = se3_update(rot, trans, dx)
    return graph._replace(rot=rot, trans=trans)
