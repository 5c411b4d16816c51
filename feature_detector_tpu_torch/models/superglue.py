"""SuperGlue (Sarlin et al., CVPR 2020, arXiv:1911.11763) as a torch
``nn.Module``, batched over pairs whose keypoint counts differ.

Modules and parameter names are those of the public implementation
(magicleap/SuperGluePretrainedNetwork, ``models/superglue.py``), so its
checkpoints load with ``load_state_dict`` as they are: ``kenc.encoder.*``
(1x1 convolutions 3-32-64-128-256-256 with BatchNorm and ReLU between),
``gnn.layers.<i>.attn.proj.<0|1|2>`` (query, key, value) and
``.attn.merge``, ``gnn.layers.<i>.mlp.<0|1|3>`` (512-512-256 with BatchNorm
and ReLU between), ``final_proj`` and ``bin_score``.  A convolution's weight
is ``[out, in, 1]``; the attention splits channel ``c`` into head
``c % num_heads`` at position ``c // num_heads`` (the public ``view(b, dim,
heads, n)``).

The forward takes P pairs at once, side A (``[1 or P, NA]`` slots) and side
B (``[P, NB]``), each padded to its capacity with a validity mask:

- the keypoints, normalised by the image size, and their scores through the
  keypoint encoder, added to the descriptors (float32);
- the GNN layers, self and cross in turn: ``x += MLP([x | MHA(x, source)])``
  for both sides at once, the projections, attention and MLPs in bfloat16
  with float32 accumulation, the residual stream in float32;
- the final projection and the scores ``<f_A, f_B> / sqrt(d)`` (float32);
- log-domain Sinkhorn over the scores bordered by the learned dustbin score,
  with each pair's marginals, ``-log(m + n)`` a slot and ``log(n) - log(m +
  n)`` / ``log(m) - log(m + n)`` for the dustbins (float32).

A padded slot takes part in no valid slot's result: it is no key of any
attention (a key-padding mask), BatchNorm uses its fixed statistics, and its
Sinkhorn marginal is 0, so its row or column stays at ``-inf`` from the
first pass on.  A pair with no valid slot on a side gets a finite result
with nothing to match (the public code returns early there).

``pack()`` derives the compute weights once the parameters are loaded and
on their device: each BatchNorm folded in float32 into the convolution
before it, the projections' output channels ordered head-major (and the
merge's input channels alike) so that heads split without a copy, the three
projections in one matrix, all in the compute dtype but the keypoint
encoder and the final projection.  Call it again after changing the
parameters.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import SuperGlueOptions
from ..utils import trace

KEYPOINT_SCALE = 0.7  # keypoints are divided by 0.7 max(W, H) after centring


def mlp(channels) -> nn.Sequential:
    """The public ``MLP``: 1x1 convolutions with BatchNorm and ReLU between
    them (none after the last)."""
    layers = []
    for i in range(1, len(channels)):
        layers.append(nn.Conv1d(channels[i - 1], channels[i], kernel_size=1, bias=True))
        if i < len(channels) - 1:
            layers += [nn.BatchNorm1d(channels[i]), nn.ReLU()]
    return nn.Sequential(*layers)


class KeypointEncoder(nn.Module):
    def __init__(self, dim: int, layers):
        super().__init__()
        self.encoder = mlp([3, *layers, dim])


class MultiHeadedAttention(nn.Module):
    def __init__(self, num_heads: int, dim: int):
        super().__init__()
        self.merge = nn.Conv1d(dim, dim, kernel_size=1)
        self.proj = nn.ModuleList([nn.Conv1d(dim, dim, kernel_size=1) for _ in range(3)])


class AttentionalPropagation(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.attn = MultiHeadedAttention(num_heads, dim)
        self.mlp = mlp([2 * dim, 2 * dim, dim])


class AttentionalGNN(nn.Module):
    def __init__(self, dim: int, num_heads: int, names):
        super().__init__()
        self.layers = nn.ModuleList([AttentionalPropagation(dim, num_heads) for _ in names])
        self.names = tuple(names)


def _linear(conv: nn.Conv1d) -> Tuple[torch.Tensor, torch.Tensor]:
    return conv.weight[:, :, 0], conv.bias


def fold_mlp(seq: nn.Sequential) -> list:
    """The (weight ``[out, in]``, bias) of each convolution of ``seq`` with
    the BatchNorm after it folded in (eval statistics, float32)."""
    out = []
    mods = list(seq)
    for i, m in enumerate(mods):
        if isinstance(m, nn.Conv1d):
            w, b = (t.float() for t in _linear(m))
            nxt = mods[i + 1] if i + 1 < len(mods) else None
            if isinstance(nxt, nn.BatchNorm1d):
                s = nxt.weight.float() * torch.rsqrt(nxt.running_var.float() + nxt.eps)
                w, b = w * s[:, None], (b - nxt.running_mean.float()) * s + nxt.bias.float()
            out.append((w, b))
    return out


def head_major(num_heads: int, dim: int) -> torch.Tensor:
    """Channel order that puts head h's channels ``h, h + H, ...`` (the
    public layout) side by side: new channel ``h * (dim / H) + j`` is old
    channel ``j * H + h``."""
    dh = dim // num_heads
    return torch.arange(dim).view(dh, num_heads).T.reshape(-1)


def normalize_keypoints(uv: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``(uv - [W/2, H/2]) / (0.7 max(W, H))`` in float32."""
    size = torch.tensor([cols, rows], dtype=torch.float32, device=uv.device)
    return (uv.float() - size / 2) / (KEYPOINT_SCALE * max(rows, cols))


def log_optimal_transport(scores: torch.Tensor, alpha: torch.Tensor, valid_a: torch.Tensor, valid_b: torch.Tensor,
                          iters: int) -> torch.Tensor:
    """Log-domain Sinkhorn over ``scores`` ``[P, NA, NB]`` (float32) bordered
    by the dustbin score ``alpha``, with each pair's marginals from its valid
    counts m (rows) and n (columns): ``-log(m + n)`` a valid slot,
    ``log(n) - log(m + n)`` for the row dustbin and ``log(m) - log(m + n)``
    for the column dustbin, ``-inf`` for a padded slot.  A potential whose
    marginal is ``-inf`` stays ``-inf``, so that padded slots add nothing to
    any sum.  Returns the log-assignment ``[P, NA + 1, NB + 1]`` scaled by
    m + n, as the public ``log_optimal_transport``."""
    p, na, nb = scores.shape
    dev = scores.device
    m = valid_a.sum(1).float()
    n = valid_b.sum(1).float()
    norm = -torch.log(torch.clamp_min(m + n, 1.0))
    ninf = torch.tensor(float("-inf"), device=dev)
    z = torch.cat([torch.cat([scores, alpha.expand(p, na, 1)], 2), alpha.expand(p, 1, nb + 1)], 1)
    log_mu = torch.cat([torch.where(valid_a, norm[:, None], ninf), (torch.log(n) + norm)[:, None]], 1)
    log_nu = torch.cat([torch.where(valid_b, norm[:, None], ninf), (torch.log(m) + norm)[:, None]], 1)
    live_u, live_v = torch.isfinite(log_mu), torch.isfinite(log_nu)
    u = torch.where(live_u, 0.0, ninf)
    v = torch.where(live_v, 0.0, ninf)
    for _ in range(iters):
        u = torch.where(live_u, log_mu - torch.logsumexp(z + v[:, None, :], dim=2), ninf)
        v = torch.where(live_v, log_nu - torch.logsumexp(z + u[:, :, None], dim=1), ninf)
        trace.count("superglue.sinkhorn_iterations")
    return z + u[:, :, None] + v[:, None, :] - norm[:, None, None]


class SuperGlue(nn.Module):
    """The network; ``forward`` gives the log-assignment of P pairs.
    ``dtype``: the GNN's compute dtype (bfloat16 by default)."""

    def __init__(self, opts: SuperGlueOptions = SuperGlueOptions(), dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.opts = opts
        self.dtype = dtype
        d = opts.descriptor_dim
        self.kenc = KeypointEncoder(d, opts.keypoint_encoder)
        self.gnn = AttentionalGNN(d, opts.num_heads, opts.gnn_layers)
        self.final_proj = nn.Conv1d(d, d, kernel_size=1, bias=True)
        self.register_parameter("bin_score", nn.Parameter(torch.tensor(1.0)))
        self._packed = None

    @torch.no_grad()
    def pack(self) -> "SuperGlue":
        """Derives the compute weights from the parameters (module
        docstring).  Returns ``self``."""
        d, heads = self.opts.descriptor_dim, self.opts.num_heads
        order = head_major(heads, d).to(self.bin_score.device)
        layers = []
        for layer in self.gnn.layers:
            qkv = [_linear(c) for c in layer.attn.proj]
            w_qkv = torch.cat([w[order] for w, _ in qkv]).to(self.dtype)
            b_qkv = torch.cat([b[order] for _, b in qkv]).to(self.dtype)
            wm, bm = _linear(layer.attn.merge)
            (w1, b1), (w2, b2) = fold_mlp(layer.mlp)
            layers.append((w_qkv, b_qkv, wm[:, order].to(self.dtype), bm.to(self.dtype),
                           w1.to(self.dtype), b1.to(self.dtype), w2.to(self.dtype), b2.to(self.dtype)))
        wf, bf = _linear(self.final_proj)
        self._packed = {"kenc": fold_mlp(self.kenc.encoder), "layers": layers,
                        "final": (wf.float(), bf.float())}
        return self

    def encode(self, uv: torch.Tensor, score: torch.Tensor, desc: torch.Tensor) -> torch.Tensor:
        """Descriptors plus the keypoint encoding, float32 ``[B, N, d]``."""
        o = self.opts
        x = torch.cat([normalize_keypoints(uv, o.image_rows, o.image_cols), score.float()[..., None]], -1)
        enc = self._packed["kenc"]
        for i, (w, b) in enumerate(enc):
            x = F.linear(x, w, b)
            if i < len(enc) - 1:
                x = F.relu(x)
        return desc.float() + x

    def gnn_forward(self, x: torch.Tensor, key_ok: torch.Tensor) -> torch.Tensor:
        """The GNN layers over both sides stacked as ``[2, P, N, d]``
        (float32 residual stream; ``key_ok`` ``[2, P, N]`` marks the slots
        that attention may read)."""
        _, p, n, d = x.shape
        heads = self.opts.num_heads
        dh = d // heads
        mask_self = key_ok.reshape(2 * p, 1, 1, n)
        mask_cross = key_ok.flip(0).reshape(2 * p, 1, 1, n)
        x = x.reshape(2 * p, n, d)
        for name, (w_qkv, b_qkv, wm, bm, w1, b1, w2, b2) in zip(self.gnn.names, self._packed["layers"]):
            xc = x.to(self.dtype)
            q, k, v = F.linear(xc, w_qkv, b_qkv).split(d, -1)
            if name == "cross":
                k = k.reshape(2, p, n, d).flip(0).reshape(2 * p, n, d)
                v = v.reshape(2, p, n, d).flip(0).reshape(2 * p, n, d)
            q, k, v = (t.reshape(2 * p, n, heads, dh).transpose(1, 2) for t in (q, k, v))
            att = F.scaled_dot_product_attention(q, k, v, attn_mask=mask_cross if name == "cross" else mask_self)
            msg = F.linear(att.transpose(1, 2).reshape(2 * p, n, d), wm, bm)
            h = F.relu(F.linear(torch.cat([xc, msg], -1), w1, b1))
            x = x + F.linear(h, w2, b2).float()
        return x.reshape(2, p, n, d)

    def forward(self, uv_a, score_a, desc_a, valid_a, uv_b, score_b, desc_b, valid_b) -> torch.Tensor:
        """Side A: ``uv_a`` ``[B, NA, 2]`` (x, y) pixels, ``score_a``
        ``[B, NA]``, ``desc_a`` ``[B, NA, d]``, ``valid_a`` ``[B, NA]`` bool,
        with B = 1 (one frame against every B) or P; side B likewise with
        ``[P, NB]``.  Returns the log-assignment ``[P, NA + 1, NB + 1]``
        (float32; row NA and column NB are the dustbins, padded rows and
        columns ``-inf``)."""
        if self._packed is None:
            raise RuntimeError("SuperGlue: call pack() once the parameters are loaded")
        p, na, nb = uv_b.shape[0], uv_a.shape[1], uv_b.shape[1]
        n = max(na, nb)
        valid_a = valid_a.expand(p, na)
        with trace.span("models.superglue_encode"):
            xa = self.encode(uv_a, score_a, desc_a).expand(p, na, -1)
            xb = self.encode(uv_b, score_b, desc_b)
            x = torch.stack([F.pad(xa, (0, 0, 0, n - na)), F.pad(xb, (0, 0, 0, n - nb))])
            ok = torch.stack([F.pad(valid_a, (0, n - na)), F.pad(valid_b, (0, n - nb))])
            # A side with no valid slot lets attention read its first slot, so that no
            # softmax is empty; its pair has nothing to match whatever that slot holds.
            first = torch.arange(n, device=ok.device) == 0
            key_ok = ok | (first & ~ok.any(-1, keepdim=True))
        with trace.span("models.superglue_gnn", device=True):
            x = self.gnn_forward(x, key_ok)
            wf, bf = self._packed["final"]
            mdesc = F.linear(x, wf, bf)
            scores = mdesc[0, :, :na] @ mdesc[1, :, :nb].transpose(1, 2) / math.sqrt(self.opts.descriptor_dim)
        with trace.span("models.superglue_sinkhorn", device=True):
            return log_optimal_transport(scores, self.bin_score.float(), valid_a, valid_b,
                                         self.opts.sinkhorn_iterations)


def select_matches(log_assign: torch.Tensor, threshold: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The public selection on the non-dustbin block of ``log_assign``
    ``[P, NA + 1, NB + 1]``: each A row's best B column, kept when that
    column's best row is this row (mutual) and ``exp`` of the entry exceeds
    ``threshold``.  Returns (index ``[P, NA]`` int64 or -1, the entry
    ``[P, NA]``, kept ``[P, NA]`` bool).  A padded row or column is ``-inf``
    throughout, so it is never kept nor chosen."""
    core = log_assign[:, :-1, :-1]
    best0, idx0 = core.max(2)
    idx1 = core.max(1).indices
    rows = torch.arange(core.shape[1], device=core.device)
    mutual = idx1.gather(1, idx0) == rows[None]
    keep = mutual & (best0.exp() > threshold)
    return torch.where(keep, idx0, -1), best0, keep
