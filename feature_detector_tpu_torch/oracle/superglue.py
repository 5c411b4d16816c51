"""Plain float32 reference of SuperGlue (Sarlin et al., CVPR 2020,
arXiv:1911.11763): one unpadded pair at a time, as the public
implementation runs it (magicleap/SuperGluePretrainedNetwork,
``models/superglue.py``), in plain torch and from a state dict under the
public parameter names.  It imports no other module of the port.

Written from the public code, with these departures:

- it takes one pair's tensors, not the public ``data`` dict, and returns the
  log-assignment ``[m + 1, n + 1]`` beside the matches;
- BatchNorm runs with its stored statistics (the public model in ``eval()``);
- a pair with no keypoint on a side returns an empty assignment with no
  match, where the public code returns its early result;
- float32 products and convolutions run in full float32
  (``allow_tf32`` False for matmul and cuDNN while it runs).

The program (``models/superglue.py``) departs further, by design: it batches
pairs with padding masks, folds each BatchNorm into the convolution before
it and runs the GNN in bfloat16.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BN_EPS = 1e-5  # torch's BatchNorm1d default, which the public model uses


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def mlp(state: dict, prefix: str, n_convs: int, x: torch.Tensor) -> torch.Tensor:
    """The public ``MLP`` on ``x`` ``[1, C, N]``: convolution ``3 i`` then,
    but after the last, BatchNorm ``3 i + 1`` and ReLU."""
    for i in range(n_convs):
        x = F.conv1d(x, state[f"{prefix}.{3 * i}.weight"], state[f"{prefix}.{3 * i}.bias"])
        if i < n_convs - 1:
            bn = f"{prefix}.{3 * i + 1}"
            x = F.batch_norm(x, state[f"{bn}.running_mean"], state[f"{bn}.running_var"], state[f"{bn}.weight"],
                             state[f"{bn}.bias"], training=False, eps=BN_EPS)
            x = F.relu(x)
    return x


def attention(query, key, value):
    dim = query.shape[1]
    scores = torch.einsum("bdhn,bdhm->bhnm", query, key) / dim ** 0.5
    prob = F.softmax(scores, dim=-1)
    return torch.einsum("bhnm,bdhm->bdhn", prob, value)


def multi_head(state: dict, prefix: str, heads: int, x, source):
    b, d = x.shape[:2]
    q, k, v = [F.conv1d(t, state[f"{prefix}.proj.{i}.weight"], state[f"{prefix}.proj.{i}.bias"])
               .view(b, d // heads, heads, -1) for i, t in enumerate((x, source, source))]
    out = attention(q, k, v).contiguous().view(b, d, -1)
    return F.conv1d(out, state[f"{prefix}.merge.weight"], state[f"{prefix}.merge.bias"])


def normalize_keypoints(kpts: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    size = kpts.new_tensor([cols, rows])[None]
    return (kpts - size / 2) / (size.max() * 0.7)


def log_sinkhorn_iterations(z, log_mu, log_nu, iters: int):
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(z + v.unsqueeze(1), dim=2)
        v = log_nu - torch.logsumexp(z + u.unsqueeze(2), dim=1)
    return z + u.unsqueeze(2) + v.unsqueeze(1)


def log_optimal_transport(scores, alpha, iters: int):
    b, m, n = scores.shape
    one = scores.new_tensor(1)
    ms, ns = (m * one).to(scores), (n * one).to(scores)
    bins0 = alpha.expand(b, m, 1)
    bins1 = alpha.expand(b, 1, n)
    alpha = alpha.expand(b, 1, 1)
    couplings = torch.cat([torch.cat([scores, bins0], -1), torch.cat([bins1, alpha], -1)], 1)
    norm = -(ms + ns).log()
    log_mu = torch.cat([norm.expand(m), ns.log()[None] + norm])
    log_nu = torch.cat([norm.expand(n), ms.log()[None] + norm])
    log_mu, log_nu = log_mu[None].expand(b, -1), log_nu[None].expand(b, -1)
    z = log_sinkhorn_iterations(couplings, log_mu, log_nu, iters)
    return z - norm


def select(z: torch.Tensor, threshold: float) -> torch.Tensor:
    """The public mutual argmax and threshold on a log-assignment
    ``[m + 1, n + 1]``: each row's match (-1 for none)."""
    core = z[None, :-1, :-1]
    max0, max1 = core.max(2), core.max(1)
    indices0, indices1 = max0.indices, max1.indices
    mutual0 = torch.arange(core.shape[1])[None] == indices1.gather(1, indices0)
    mscores0 = torch.where(mutual0, max0.values.exp(), core.new_tensor(0))
    valid0 = mutual0 & (mscores0 > threshold)
    return torch.where(valid0, indices0, indices0.new_tensor(-1))[0]


def superglue(state: dict, kpts0, scores0, desc0, kpts1, scores1, desc1, rows: int, cols: int,
              layer_names=("self", "cross") * 9, heads: int = 4, iters: int = 100, threshold: float = 0.2):
    """One pair: keypoints ``[m, 2]`` and ``[n, 2]`` as (x, y) pixels,
    scores ``[m]`` / ``[n]``, descriptors ``[m, d]`` / ``[n, d]``, frames of
    ``rows`` x ``cols``.  ``state``: name -> float32 tensor on the inputs'
    device.  Returns (log-assignment ``[m + 1, n + 1]``, matches ``[m]``:
    the B index or -1)."""
    m, n = kpts0.shape[0], kpts1.shape[0]
    if m == 0 or n == 0:
        return scores0.new_zeros((m + 1, n + 1)), torch.full((m,), -1, dtype=torch.int64)
    n_enc = 1 + max(int(k.split(".")[2]) for k in state if k.startswith("kenc.encoder.")) // 3
    with no_tf32(), torch.no_grad():
        d = [desc0.T[None].float(), desc1.T[None].float()]
        for i, (k, s) in enumerate(((kpts0, scores0), (kpts1, scores1))):
            inputs = torch.cat([normalize_keypoints(k.float(), rows, cols).T[None], s.float()[None, None]], 1)
            d[i] = d[i] + mlp(state, "kenc.encoder", n_enc, inputs)
        for layer, name in enumerate(layer_names):
            pre = f"gnn.layers.{layer}"
            src0, src1 = (d[1], d[0]) if name == "cross" else (d[0], d[1])
            delta = [mlp(state, f"{pre}.mlp", 2, torch.cat([x, multi_head(state, f"{pre}.attn", heads, x, src)], 1))
                     for x, src in ((d[0], src0), (d[1], src1))]
            d = [d[0] + delta[0], d[1] + delta[1]]
        md = [F.conv1d(x, state["final_proj.weight"], state["final_proj.bias"]) for x in d]
        scores = torch.einsum("bdn,bdm->bnm", md[0], md[1]) / md[0].shape[1] ** 0.5
        z = log_optimal_transport(scores, state["bin_score"], iters)[0]
        return z, select(z.cpu(), threshold)
