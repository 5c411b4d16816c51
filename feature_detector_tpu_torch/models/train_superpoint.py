"""Train SuperPoint on synthetic corner scenes.

Counterpart of ``feature_detector_tpu/models/train_superpoint.py``: the
packaged weights (``superpoint_synth.npz``) came out of this loop.  Each
batch (``models/synth_data.make_batch``) holds frames A, their 65-way cell
labels and a homography to frame B; the warp of A into B runs on the device
(``warp_bilinear``).  The loss (``superpoint_loss``) is the 65-way cell
cross-entropy in both frames, plus the SuperPoint hinge on the dot products
of cell descriptors, with correspondences from the known homography.

The step (``make_train_step``) is the JAX package's: Adam, and with a
``mesh`` the batch split over the ranks of one axis.  That loss is the loss
of the whole batch, as under GSPMD: every mean divides by a count over the
whole batch, so the ranks first all-reduce their counts, each divides its
own sums by the global counts, and the gradients are all-reduce-summed
before an Adam step on parameters that are identical on every rank.

CLI:  python -m feature_detector_tpu_torch.models.train_superpoint \\
          --steps 2000 --batch 32 --out superpoint_synth.npz [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.convert import flax_tree_from_superpoint_state
from ..core.device import DeviceLike, as_tensor, resolve_device
from ..parallel.mesh import axis_group, mesh_device, shard_leading
from .superpoint import SuperPoint
from .synth_data import make_batch
from .weights import init_state, load_params_npz

__all__ = ["CELL", "warp_bilinear", "superpoint_loss", "superpoint_loss_terms", "make_train_step",
           "save_params_npz", "load_params_npz", "train", "main"]

CELL = 8
SUPERPOINT_DET_TERMS = 2  # the first two loss terms are the detector's (frames A and B)


def warp_bilinear(images: torch.Tensor, H_ab: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame B sampled from A: ``images`` [B, H, W] float32, ``H_ab``
    [B, 3, 3] mapping A's pixel coordinates to B's.  Returns (warped
    [B, H, W], valid [B, H, W] bool: the source lies in the image).

    As in the JAX package, the bilinear weights come from the unclipped
    floor while the gather clips it to [0, W-2] x [0, H-2]: a source point
    at exactly u = W-1 reads column W-2 with weight 1."""
    bsz, h, w = images.shape
    dev = images.device
    H_ba = torch.linalg.inv(H_ab)
    v, u = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    p = torch.stack([u, v, torch.ones_like(u)], -1).to(torch.float32)  # [H, W, 3]
    q = torch.einsum("bij,hwj->bhwi", H_ba, p)
    z = torch.where(q[..., 2].abs() < 1e-9, 1e-9, q[..., 2])
    src_u = q[..., 0] / z
    src_v = q[..., 1] / z
    u0 = torch.floor(src_u)
    v0 = torch.floor(src_v)
    fu = src_u - u0
    fv = src_v - v0
    valid = (src_u >= 0) & (src_u <= w - 1) & (src_v >= 0) & (src_v <= h - 1)
    u0c = torch.clamp(u0, 0, w - 2).to(torch.int64)
    v0c = torch.clamp(v0, 0, h - 2).to(torch.int64)
    flat = images.reshape(bsz, -1)
    base = (v0c * w + u0c).reshape(bsz, -1)

    def g(off: int) -> torch.Tensor:
        return torch.gather(flat, 1, base + off).reshape(bsz, h, w)

    out = ((1 - fu) * (1 - fv) * g(0) + fu * (1 - fv) * g(1)
           + (1 - fu) * fv * g(w) + fu * fv * g(w + 1))
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=dev)), valid


def _cell_centers(hc: int, wc: int, device: DeviceLike = "cpu") -> torch.Tensor:
    """[hc * wc, 2] (u, v) pixel centres of the 8x8 cells, row-major."""
    v, u = torch.meshgrid(torch.arange(hc, device=device), torch.arange(wc, device=device), indexing="ij")
    return torch.stack([u * CELL + CELL / 2.0, v * CELL + CELL / 2.0], -1).reshape(-1, 2).to(torch.float32)


def cell_correspondence(H_ab: torch.Tensor, hc: int, wc: int) -> torch.Tensor:
    """s [B, Na, Nb] float32: 1 where A-cell n's centre, warped by
    ``H_ab``, lands within one cell (8 px) of B-cell m's centre."""
    centers = _cell_centers(hc, wc, H_ab.device)
    ch = torch.cat([centers, torch.ones((centers.shape[0], 1), dtype=torch.float32, device=H_ab.device)], 1)
    q = torch.einsum("bij,nj->bni", H_ab, ch)
    z = torch.where(q[..., 2:].abs() < 1e-9, 1e-9, q[..., 2:])
    wa = q[..., :2] / z  # [B, Nc, 2]
    d2 = torch.sum((wa[:, :, None, :] - centers[None, None, :, :]) ** 2, -1)  # [B, Na, Nb]
    return (d2 <= float(CELL) ** 2).to(torch.float32)


def superpoint_loss_terms(model: SuperPoint, batch: dict, margin_pos: float = 1.0,
                          margin_neg: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loss of one batch as sums over its elements and the counts they
    are divided by: (sums [4], counts [4]) for the cell cross-entropy of
    frame A (over every cell), of frame B (over cells whose centre has a
    source pixel), and the descriptor hinge's positive and negative pairs.

    batch: image [B, H, W] float32, label_a / label_b [B, H/8, W/8] int,
    H_ab [B, 3, 3] float32, as tensors on the model's device."""
    images, H_ab = batch["image"], batch["H_ab"]
    bsz = images.shape[0]
    warped, valid_px = warp_bilinear(images, H_ab)
    logits_a, desc_a = model(images[:, None], return_logits=True)
    logits_b, desc_b = model(warped[:, None], return_logits=True)
    hc, wc = logits_a.shape[2:]
    ce_a = F.cross_entropy(logits_a, batch["label_a"].to(torch.int64), reduction="none")
    ce_b = F.cross_entropy(logits_b, batch["label_b"].to(torch.int64), reduction="none")
    # B-frame cells whose centre has no source pixel are unlabelled: masked.
    valid_cells = valid_px[:, CELL // 2::CELL, CELL // 2::CELL].to(torch.float32)

    s = cell_correspondence(H_ab, hc, wc)
    da = desc_a.reshape(bsz, -1, desc_a.shape[-1])
    db = desc_b.reshape(bsz, -1, desc_b.shape[-1])
    dot = torch.einsum("bnd,bmd->bnm", da, db)
    zero = torch.zeros((), dtype=dot.dtype, device=dot.device)
    hinge = s * torch.maximum(zero, margin_pos - dot) + (1.0 - s) * torch.maximum(zero, dot - margin_neg)
    sums = torch.stack([ce_a.sum(), (ce_b * valid_cells).sum(), (hinge * s).sum(), (hinge * (1.0 - s)).sum()])
    counts = torch.stack([torch.tensor(float(ce_a.numel()), device=s.device), valid_cells.sum(), s.sum(),
                          (1.0 - s).sum()])
    return sums, counts.detach()


def loss_from_terms(sums: torch.Tensor, counts: torch.Tensor, n_det: int, lambda_d: float):
    """det = the first ``n_det`` sums over their counts, desc = the rest;
    each count at least 1.  Returns (det + lambda_d * desc, {"det", "desc"})."""
    ratio = sums / torch.clamp_min(counts, 1.0)
    det = ratio[:n_det].sum()
    desc = ratio[n_det:].sum()
    return det + lambda_d * desc, {"det": det, "desc": desc}


def superpoint_loss(model: SuperPoint, batch: dict, lambda_d: float = 1.0, margin_pos: float = 1.0,
                    margin_neg: float = 0.2):
    """Detector cross-entropy (both frames) + descriptor hinge (SuperPoint
    eq. 4, positives and negatives balanced).  Returns (loss, {"det",
    "desc"}), scalars that carry gradients."""
    sums, counts = superpoint_loss_terms(model, batch, margin_pos, margin_neg)
    return loss_from_terms(sums, counts, SUPERPOINT_DET_TERMS, lambda_d)


def train_step_of(model: torch.nn.Module, optimizer: torch.optim.Optimizer, terms: Callable, n_det: int,
                  lambda_d: float, mesh=None, axis: str = "data"):
    """The step ``batch -> (loss, {"det", "desc"})`` of the loss ``terms``
    (a function ``(model, batch) -> (sums, counts)``): one optimizer step on
    the model in place.  With ``mesh``, every rank is handed the whole batch
    and takes its block of the leading axis; counts are all-reduced before
    the division and gradients all-reduce-summed after, so the step is that
    of the whole batch.  The returned loss is the whole batch's."""
    device = next(model.parameters()).device
    params = [p for p in model.parameters() if p.requires_grad]
    group = None if mesh is None else axis_group(mesh, axis)
    if mesh is not None and mesh_device(mesh) != device:
        raise ValueError(f"the model lies on {device}, the mesh's device is {mesh_device(mesh)}")

    def step(batch: dict):
        b = {k: as_tensor(v, device) for k, v in batch.items()}
        if mesh is not None:
            b = {k: shard_leading(v, mesh, axis) for k, v in b.items()}
        optimizer.zero_grad()
        sums, counts = terms(model, b)
        if mesh is not None:
            counts = counts.clone()
            dist.all_reduce(counts, group=group)
        loss, aux = loss_from_terms(sums, counts, n_det, lambda_d)
        loss.backward()
        out = torch.stack([loss, aux["det"], aux["desc"]]).detach()
        if mesh is not None:
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            dist.all_reduce(flat, group=group)
            offset = 0
            for p in params:
                p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
                offset += p.numel()
            dist.all_reduce(out, group=group)
        optimizer.step()
        return out[0], {"det": out[1], "desc": out[2]}

    return step


def make_train_step(model: SuperPoint, optimizer: torch.optim.Optimizer, mesh=None, axis: str = "data"):
    """The SuperPoint step ``batch -> (loss, {"det", "desc"})``, updating
    ``model`` in place through ``optimizer``; with ``mesh``, data-parallel
    over its axis ``axis`` (the batch must divide by it)."""
    return train_step_of(model, optimizer, superpoint_loss_terms, SUPERPOINT_DET_TERMS, 1.0, mesh, axis)


def adam(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: the same update, eps outside the root, eps_root 0."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def save_params_npz(path: str, params: dict) -> None:
    """Writes a ``{"params": {...}}`` tree (``core.convert.flax_tree_from_*``)
    as the JAX package's npz: keys ``params/<layer>/.../kernel|bias|alpha``,
    float16 storage."""
    flat = {}

    def walk(node, prefix):
        for key in sorted(node):
            value = node[key]
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}/")
            else:
                flat[f"{prefix}{key}"] = np.asarray(value).astype(np.float16)

    walk(params, "")
    np.savez_compressed(path, **flat)


def train(steps: int = 2000, batch: int = 32, h: int = 120, w: int = 160, lr: float = 1e-3, seed: int = 0,
          out: Optional[str] = None, mesh=None, log_every: int = 100, data_seed: int = 0,
          device: DeviceLike = None):
    """Runs the training loop on ``device`` (the mesh's device with a
    ``mesh``), computing in bfloat16; returns (model, history of (step,
    loss, det, desc))."""
    dev = mesh_device(mesh) if mesh is not None else resolve_device(device)
    model = init_state(SuperPoint(), torch.Generator().manual_seed(seed)).to(dev)
    rng = np.random.default_rng(data_seed)
    step_fn = make_train_step(model, adam(model, lr), mesh=mesh)
    history = []
    t0 = time.time()
    for i in range(steps):
        loss, aux = step_fn(make_batch(rng, batch, h, w))
        if i % log_every == 0 or i == steps - 1:
            l, d, dd = float(loss), float(aux["det"]), float(aux["desc"])
            history.append((i, l, d, dd))
            print(f"step {i:5d}  loss {l:.4f}  det {d:.4f}  desc {dd:.4f}  {(time.time() - t0):.0f}s", flush=True)
    if out:
        save_params_npz(out, flax_tree_from_superpoint_state(model.state_dict()))
        print(f"saved {out}")
    return model, history


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train SuperPoint on synthetic corner scenes.")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", type=str, default=None, help="npz to write the trained parameters to")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev)
    train(steps=args.steps, batch=args.batch, lr=args.lr, out=args.out, device=dev)


if __name__ == "__main__":
    main()
