"""Plain PyTorch reference of SuperGlue (Sarlin et al., CVPR 2020,
arXiv:1911.11763), one unpadded pair at a time as the public implementation
runs it (magicleap/SuperGluePretrainedNetwork, ``models/superglue.py``,
``default_config``); it imports nothing of the program.

The keypoint encoder (1x1 convolutions 3-32-64-128-256-256, BatchNorm and
ReLU between) on the keypoints normalised by ``0.7 max(W, H)`` about the
frame's centre and their scores, added to the descriptors; 18 GNN layers,
self and cross in turn, ``x += MLP([x | MHA(x, source)])`` with 4 heads
(channel ``c`` in head ``c % 4``) and an MLP 512-512-256; a final 1x1
projection; scores ``<f0, f1> / sqrt(256)`` bordered by the learned dustbin
score; 100 log-domain Sinkhorn passes with marginals ``-log(m + n)`` and
``log(n) - log(m + n)`` / ``log(m) - log(m + n)`` for the dustbins; the
mutual argmax over the non-dustbin block above a matching score of 0.2.
BatchNorm uses its stored statistics (the public model in ``eval()``).  A
pair with no keypoint on a side has nothing to match, as the public early
return.

``forward`` runs in float32 with TF32 off.  Its ``gnn_round`` (applied to
every operand of the GNN's products) is the hook through which
``reference/sp_sg_control.py`` puts the control in the program's place; the
reference leaves it at the identity.  The weights come from the caller, as
a state dict under the public checkpoint's names.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .disk import no_tf32

BN_EPS = 1e-5


def identity(t):
    return t


def layer_names(cfg: dict) -> tuple:
    return tuple(cfg["gnn_layers"])


def to_device(state: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in state.items()}


def _mlp(state, prefix, n_convs, x, r):
    for i in range(n_convs):
        x = F.conv1d(r(x), r(state[f"{prefix}.{3 * i}.weight"]), state[f"{prefix}.{3 * i}.bias"])
        if i < n_convs - 1:
            bn = f"{prefix}.{3 * i + 1}"
            x = F.relu(F.batch_norm(x, state[f"{bn}.running_mean"], state[f"{bn}.running_var"], state[f"{bn}.weight"],
                                    state[f"{bn}.bias"], training=False, eps=BN_EPS))
    return x


def _attention(state, prefix, heads, x, source, r):
    b, d = x.shape[:2]
    q, k, v = [F.conv1d(r(t), r(state[f"{prefix}.proj.{i}.weight"]), state[f"{prefix}.proj.{i}.bias"])
               .view(b, d // heads, heads, -1) for i, t in enumerate((x, source, source))]
    scores = torch.einsum("bdhn,bdhm->bhnm", r(q), r(k)) / (d // heads) ** 0.5
    prob = F.softmax(scores, dim=-1)
    out = torch.einsum("bhnm,bdhm->bdhn", r(prob), r(v)).contiguous().view(b, d, -1)
    return F.conv1d(r(out), r(state[f"{prefix}.merge.weight"]), state[f"{prefix}.merge.bias"])


def log_optimal_transport(scores, alpha, iters: int):
    """The public ``log_optimal_transport`` on ``[1, m, n]`` scores, in
    their dtype."""
    b, m, n = scores.shape
    one = scores.new_tensor(1)
    ms, ns = (m * one).to(scores), (n * one).to(scores)
    couplings = torch.cat([torch.cat([scores, alpha.expand(b, m, 1)], -1), alpha.expand(b, 1, n + 1)], 1)
    norm = -(ms + ns).log()
    log_mu = torch.cat([norm.expand(m), ns.log()[None] + norm])[None]
    log_nu = torch.cat([norm.expand(n), ms.log()[None] + norm])[None]
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v.unsqueeze(1), dim=2)
        v = log_nu - torch.logsumexp(couplings + u.unsqueeze(2), dim=1)
    return couplings + u.unsqueeze(2) + v.unsqueeze(1) - norm


def forward(state: dict, cfg: dict, rows: int, cols: int, kpts0, scores0, desc0, kpts1, scores1, desc1,
            gnn_round=identity) -> torch.Tensor:
    """The log-assignment ``[m + 1, n + 1]`` (float32) of one pair:
    keypoints ``[m, 2]`` / ``[n, 2]`` (x, y) pixels, scores, descriptors
    ``[m, d]`` / ``[n, d]``; ``state`` on the inputs' device."""
    m, n = kpts0.shape[0], kpts1.shape[0]
    if m == 0 or n == 0:
        return scores0.new_zeros((m + 1, n + 1), dtype=torch.float32)
    heads, r = cfg["num_heads"], gnn_round
    n_enc = len(cfg["keypoint_encoder"]) + 1
    size = torch.tensor([cols, rows], dtype=torch.float32, device=kpts0.device)
    with no_tf32(), torch.no_grad():
        d = []
        for k, s, desc in ((kpts0, scores0, desc0), (kpts1, scores1, desc1)):
            kn = (k.float() - size / 2) / (0.7 * max(rows, cols))
            inputs = torch.cat([kn.T[None], s.float()[None, None]], 1)
            d.append(desc.float().T[None] + _mlp(state, "kenc.encoder", n_enc, inputs, identity))
        for layer, name in enumerate(layer_names(cfg)):
            pre = f"gnn.layers.{layer}"
            src = (d[1], d[0]) if name == "cross" else (d[0], d[1])
            delta = [_mlp(state, f"{pre}.mlp", 2, torch.cat([x, _attention(state, f"{pre}.attn", heads, x, s, r)], 1), r)
                     for x, s in zip(d, src)]
            d = [d[0] + delta[0], d[1] + delta[1]]
        md = [F.conv1d(x, state["final_proj.weight"], state["final_proj.bias"]) for x in d]
        scores = torch.einsum("bdn,bdm->bnm", md[0], md[1]) / md[0].shape[1] ** 0.5
        z = log_optimal_transport(scores, state["bin_score"].float(), cfg["sinkhorn_iterations"])
        return z[0].float()


def select(z: np.ndarray, threshold: float, tie: float = 1e-6):
    """The public mutual argmax and threshold on a log-assignment
    ``[m + 1, n + 1]`` (the non-dustbin block).  Returns (index ``[m]``, -1
    for none; near ``[m]`` bool: a decision of this row rests on two entries
    closer than ``tie``, in its row or in its best column, or on an entry
    within ``tie`` of the threshold's log, which float32 rounding may order
    either way)."""
    core = z[:-1, :-1].astype(np.float64)
    m, n = core.shape
    if m == 0 or n == 0:
        return np.full(m, -1, np.int64), np.zeros(m, bool)
    best_j = core.argmax(1)
    best = core[np.arange(m), best_j]
    best_i = core.argmax(0)
    keep = (best_i[best_j] == np.arange(m)) & (np.exp(best) > threshold)

    def close(s):
        top2 = -np.sort(-s, axis=1)[:, :2] if s.shape[1] > 1 else np.concatenate([s, np.full_like(s, -np.inf)], 1)
        with np.errstate(invalid="ignore"):
            gap = top2[:, 0] - top2[:, 1]
        return gap < tie

    near = close(core) | close(core.T)[best_j] | (np.abs(best - np.log(threshold)) < tie)
    return np.where(keep, best_j, -1), near
