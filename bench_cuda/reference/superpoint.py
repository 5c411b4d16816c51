"""Plain PyTorch reference of SuperPoint (DeTone et al., CVPRW 2018,
arXiv:1712.07629), its NMS head and the selection after it, written from the
published architecture; it imports nothing of the program.

The network: a VGG encoder of 3x3 convolutions (64, 64 | 64, 64 | 128, 128
| 128, 128 channels, a 2x2 max-pool after each of the first three pairs,
ReLU after each), then two heads at stride 8: ``convPa`` (3x3, 256, ReLU)
and ``convPb`` (1x1, 65 logits, a softmax over the 64 cells of an 8x8 block
and a dustbin, the dustbin dropped and the cells shuffled back to pixels);
``convDa`` (3x3, 256, ReLU) and ``convDb`` (1x1, 256, L2-normalised).  The
input is the grey frame scaled to [0, 1].  The weights are the repository's
packaged Flax tree (``params/<layer>[/Conv_0]/kernel`` HWIO and ``bias``),
read by ``reference/disk.py:load_npz``.

``forward`` runs in float32 with TF32 off (the reference), or with every
convolution's input and weights rounded to float8 e4m3 under a per-tensor
scale (the control: the step below the bfloat16 that the configuration
states).  ``nms_head`` and ``select`` are the detector's NMS-head path:
local maxima over a 9x9 window above the response floor, the best
``k`` by descending score (ties in row-major order), then each kept in
that order unless outside the boundary band or within the radius
(Chebyshev) of one kept before it, up to the capacity.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .disk import _fp8, no_tf32

ENCODER = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b")
POOL_AFTER = ("conv1b", "conv2b", "conv3b")
HEADS = ("convPa", "convPb", "convDa", "convDb")
STRIDE = 8
NMS_RADIUS = 4  # the NMS head's window is (2 NMS_RADIUS + 1)^2
NMS_K = 1024  # candidates the head keeps


class Weights:
    """The tree's convolutions (OIHW) as float32 tensors on ``device``."""

    def __init__(self, tree: dict, device):
        params = tree["params"]
        self.conv = {}
        for name in ENCODER + HEADS:
            leaf = params[name].get("Conv_0", params[name])
            w = torch.from_numpy(np.ascontiguousarray(leaf["kernel"].transpose(3, 2, 0, 1)))
            self.conv[name] = (w.to(device), torch.from_numpy(leaf["bias"]).to(device))


def forward(w: Weights, image_u8: torch.Tensor, precision: str = "float32"):
    """Heatmap ``[H, W]`` and descriptor map ``[H / 8, W / 8, 256]`` (unit
    norm) of one ``[H, W]`` uint8 frame."""
    if precision not in ("float32", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    q = _fp8 if precision == "fp8" else (lambda t: t)

    def conv(name, x):
        kernel, bias = w.conv[name]
        return F.conv2d(q(x), q(kernel), bias, padding=kernel.shape[-1] // 2)

    with no_tf32(), torch.no_grad():
        x = (image_u8.to(torch.float32) / 255.0)[None, None]
        for name in ENCODER:
            x = F.relu(conv(name, x))
            if name in POOL_AFTER:
                x = F.max_pool2d(x, 2)
        logits = conv("convPb", F.relu(conv("convPa", x)))
        heat = F.pixel_shuffle(torch.softmax(logits, 1)[:, :STRIDE * STRIDE], STRIDE)[0, 0]
        desc = conv("convDb", F.relu(conv("convDa", x)))[0]
        desc = desc / desc.norm(dim=0, keepdim=True).clamp_min(1e-12)
        return heat, desc.permute(1, 2, 0)


def nms_head(heatmap: np.ndarray, min_response: float, k: int = NMS_K):
    """The head's candidates: (uv ``[k, 2]`` float32 (x, y), scores ``[k]``,
    0 marking padding), by descending score with row-major ties."""
    rows, cols = heatmap.shape
    t = torch.from_numpy(heatmap)
    local_max = F.max_pool2d(t[None, None], 2 * NMS_RADIUS + 1, stride=1, padding=NMS_RADIUS)[0, 0]
    keep = ((t >= local_max) & (t > min_response)).numpy()
    flat = np.where(keep, heatmap, 0).reshape(-1)
    order = np.argsort(-flat, kind="stable")[:k]
    scores = flat[order]
    uv = np.stack([order % cols, order // cols], 1).astype(np.float32)
    return uv, scores


def select(uv: np.ndarray, scores: np.ndarray, rows: int, cols: int, capacity: int, radius: int, boundary: int):
    """The candidates kept in list order (score above 0, inside the
    boundary band, farther than ``radius`` in both axes from every one kept
    before), up to ``capacity``.  Returns (uv ``[capacity, 2]`` float32,
    valid ``[capacity]`` bool, the kept candidates' indices)."""
    out = np.zeros((capacity, 2), np.float32)
    valid = np.zeros(capacity, bool)
    picked = []
    for i in range(len(uv)):
        if len(picked) >= capacity or scores[i] <= 0:
            continue
        u, v = uv[i]
        if not (boundary <= u < cols - boundary and boundary <= v < rows - boundary):
            continue
        if picked and (np.abs(out[:len(picked)] - uv[i]).max(1) <= radius).any():
            continue
        out[len(picked)] = uv[i]
        valid[len(picked)] = True
        picked.append(i)
    return out, valid, np.asarray(picked, np.int64)
