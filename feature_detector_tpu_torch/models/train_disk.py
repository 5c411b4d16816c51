"""Train DISK on synthetic corner scenes (corner and hinge stand-in).

Counterpart of ``feature_detector_tpu/models/train_disk.py``: the packaged
weights (``disk_synth.npz``) came out of this loop.  The batches and the
homographic warp are SuperPoint's (``models/train_superpoint.py``), adapted
to DISK's full-resolution outputs:

- detector: per-pixel balanced binary cross-entropy of the sigmoid heatmap
  against the known corner map, dilated to a 3x3 plateau, in frame A and in
  the warped frame B (masked to pixels with a source);
- descriptor: the 128-d map 8x8 average-pooled to cells, as the front-end
  samples it, trained with a hardest-negative triplet on cell
  correspondences from the known homography.

CLI:  python -m feature_detector_tpu_torch.models.train_disk \\
          --steps 1500 --batch 16 --out disk_synth.npz [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.convert import flax_tree_from_disk_state
from ..core.device import DeviceLike, resolve_device
from . import train_superpoint as sp
from .disk import Disk
from .synth_data import make_batch
from .weights import init_state

CELL = sp.CELL
DISK_DET_TERMS = 4  # positive and negative pixels of frames A and B
LAMBDA_D = 2.0  # the descriptor term's weight


def labels_to_pixel_map(labels: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The 65-way cell labels [B, H/8, W/8] as a [B, H, W] {0, 1} float32
    corner map: label (v % 8) * 8 + u % 8 marks that pixel of its cell, 64
    (the dustbin) none."""
    bsz, hc, wc = labels.shape
    onehot = F.one_hot(labels.to(torch.int64), CELL * CELL + 1).to(torch.float32)[..., :-1]
    cells = onehot.reshape(bsz, hc, wc, CELL, CELL)  # [B, hc, wc, dv, du]
    return cells.permute(0, 1, 3, 2, 4).reshape(bsz, h, w)


def _smear(tgt: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Dilates the {0, 1} corner map [B, H, W] to (2r+1)^2 plateaus: a max
    over the window, zero outside the image."""
    padded = F.pad(tgt[:, None], (radius, radius, radius, radius), value=0.0)
    return F.max_pool2d(padded, 2 * radius + 1, stride=1)[:, 0]


def disk_loss_terms(model: Disk, batch: dict, margin_neg: float = 0.4,
                    smear_radius: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loss of one batch as sums and the counts they are divided by:
    (sums [5], counts [5]) for the positive and negative pixels of frame A,
    of frame B (pixels with a source), and the triplet hinge over the
    anchor cells that have a positive."""
    images, H_ab = batch["image"], batch["H_ab"]
    bsz, h, w = images.shape
    warped, valid_px = sp.warp_bilinear(images, H_ab)
    rgb = lambda im: im[:, None].expand(bsz, 3, h, w)
    heat_a, desc_a = model(rgb(images))
    heat_b, desc_b = model(rgb(warped))
    tgt_a = _smear(labels_to_pixel_map(batch["label_a"], h, w), smear_radius)
    tgt_b = _smear(labels_to_pixel_map(batch["label_b"], h, w), smear_radius)

    def bce(heat, tgt, px_mask):
        eps = 1e-6
        pos = -torch.log(heat + eps) * tgt
        neg = -torch.log(1.0 - heat + eps) * (1.0 - tgt)
        return ([(pos * px_mask).sum(), (neg * px_mask).sum()],
                [(tgt * px_mask).sum(), ((1.0 - tgt) * px_mask).sum()])

    sa, ca = bce(heat_a, tgt_a, torch.ones_like(tgt_a))
    sb, cb = bce(heat_b, tgt_b, valid_px.to(torch.float32))

    # 8x8-pooled cell descriptors, unit norm, with homography correspondence.
    pool = lambda d: F.avg_pool2d(d.permute(0, 3, 1, 2), CELL).permute(0, 2, 3, 1)
    da, db = pool(desc_a), pool(desc_b)
    hc, wc = da.shape[1:3]
    s = sp.cell_correspondence(H_ab, hc, wc)
    da = da.reshape(bsz, -1, da.shape[-1])
    db = db.reshape(bsz, -1, db.shape[-1])
    floor = torch.tensor(1e-9, dtype=da.dtype, device=da.device)
    da = da / torch.maximum(torch.linalg.vector_norm(da, dim=-1, keepdim=True), floor)
    db = db / torch.maximum(torch.linalg.vector_norm(db, dim=-1, keepdim=True), floor)
    dot = torch.einsum("bnd,bmd->bnm", da, db)
    # Hardest negative per anchor cell; amax splits the gradient among tied
    # maxima, as jnp.max does.
    pos_dot = torch.amax(torch.where(s > 0, dot, -2.0), dim=2)
    neg_dot = torch.amax(torch.where(s > 0, -2.0, dot), dim=2)
    has_pos = (s > 0).any(dim=2).to(torch.float32)
    zero = torch.zeros((), dtype=dot.dtype, device=dot.device)
    trip = torch.maximum(zero, margin_neg + neg_dot - pos_dot) * has_pos
    sums = torch.stack([*sa, *sb, trip.sum()])
    counts = torch.stack([*ca, *cb, has_pos.sum()])
    return sums, counts.detach()


def disk_loss(model: Disk, batch: dict, lambda_d: float = LAMBDA_D, margin_neg: float = 0.4, smear_radius: int = 1):
    """Balanced per-pixel BCE in both frames + lambda_d x the
    hardest-negative triplet on pooled cell descriptors.  Returns (loss,
    {"det", "desc"})."""
    sums, counts = disk_loss_terms(model, batch, margin_neg, smear_radius)
    return sp.loss_from_terms(sums, counts, DISK_DET_TERMS, lambda_d)


def make_train_step(model: Disk, optimizer: torch.optim.Optimizer):
    """The DISK step ``batch -> (loss, {"det", "desc"})`` of ``disk_loss``,
    updating ``model`` in place through ``optimizer``."""
    return sp.train_step_of(model, optimizer, disk_loss_terms, DISK_DET_TERMS, LAMBDA_D)


def train(steps: int = 1500, batch: int = 16, h: int = 128, w: int = 160, lr: float = 1e-3, seed: int = 0,
          out: Optional[str] = None, log_every: int = 50, data_seed: int = 0, device: DeviceLike = None):
    """Runs the training loop on ``device``, computing in bfloat16; one
    thread renders the next batch (corner-free textured backgrounds) while
    the device steps.  Returns (model, history of (step, loss, det, desc))."""
    dev = resolve_device(device)
    model = init_state(Disk(), torch.Generator().manual_seed(seed)).to(dev)
    rng = np.random.default_rng(data_seed)
    step_fn = make_train_step(model, sp.adam(model, lr))
    history = []
    t0 = time.time()
    gen = lambda: make_batch(rng, batch, h, w, rich_background=True)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(gen)
        for i in range(steps):
            b = fut.result()
            if i + 1 < steps:
                fut = pool.submit(gen)
            loss, aux = step_fn(b)
            if i % log_every == 0 or i == steps - 1:
                l, d, dd = float(loss), float(aux["det"]), float(aux["desc"])
                history.append((i, l, d, dd))
                print(f"step {i:5d}  loss {l:.4f}  det {d:.4f}  desc {dd:.4f}  {(time.time() - t0):.0f}s",
                      flush=True)
    if out:
        sp.save_params_npz(out, flax_tree_from_disk_state(model.state_dict()))
        print(f"saved {out}")
    return model, history


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train DISK on synthetic corner scenes.")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", type=str, default=None, help="npz to write the trained parameters to")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev)
    train(steps=args.steps, batch=args.batch, lr=args.lr, out=args.out, device=dev)


if __name__ == "__main__":
    main()
