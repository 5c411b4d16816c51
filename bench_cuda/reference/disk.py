"""Plain PyTorch reference of DISK (Tyszkiewicz et al., NeurIPS 2020), its
detector's post-processing and float matching, written from the published
architecture; it imports nothing of the program.

The U-Net: down blocks of 16, 32, 64, 64 and 64 channels at /1 ... /16,
each after a 2x2 average pool (but the first); up blocks of 64, 64, 64 and
129 channels, each after a nearest 2x upsampling and the concatenation of
the down block of the same scale; every block is one 5x5 convolution,
pre-activated by an affine-free InstanceNorm (eps 1e-5) and a per-channel
PReLU, but the first, which is a bare convolution.  The last block gives
128 descriptor channels, L2-normalised, and a detection logit, through a
sigmoid.  The input is the grey frame scaled to [0, 1] and repeated over
three channels.

``forward`` runs in float32 with TF32 off (the reference), or with every
convolution's input and weights rounded to float8 e4m3 under a per-tensor
scale (the control: the step below the bfloat16 that the configuration
states).  The weights are a Flax parameter tree of numpy arrays (kernels
HWIO), read from the packaged archive by the harness and handed to both
sides.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

DOWN_BLOCKS = ("down_0", "down_1", "down_2", "down_3", "down_4")
UP_BLOCKS = ("up_0", "up_1", "up_2", "up_3")
DESC_DIM = 128
EPS = 1e-5
FP8_MAX = 448.0  # largest float8 e4m3 value


def load_npz(path: str) -> dict:
    """The ``{"params": {...}}`` tree of an npz archive whose keys are
    ``params/<block>/.../<leaf>``, leaves as float32 numpy arrays."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parts, leaf = key.split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = data[key].astype(np.float32)
    return tree


class Weights:
    """The tree's convolutions (OIHW) and PReLU slopes as float32 tensors on
    ``device``."""

    def __init__(self, tree: dict, device):
        params = tree["params"]
        self.conv, self.slope = {}, {}
        for name in DOWN_BLOCKS + UP_BLOCKS:
            leaf = params[name]["conv"]
            w = torch.from_numpy(np.ascontiguousarray(leaf["kernel"].transpose(3, 2, 0, 1)))
            self.conv[name] = (w.to(device), torch.from_numpy(leaf["bias"]).to(device))
            if "gate" in params[name]:
                self.slope[name] = torch.from_numpy(params[name]["gate"]["alpha"]).to(device)


@contextlib.contextmanager
def no_tf32():
    """float32 products and convolutions in full float32 on the card."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def forward(w: Weights, image_u8: torch.Tensor, precision: str = "float32"):
    """Heatmap ``[H, W]`` and descriptor map ``[H, W, 128]`` (unit norm) of
    one ``[H, W]`` uint8 frame."""
    if precision not in ("float32", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    q = _fp8 if precision == "fp8" else (lambda t: t)

    def block(name, x):
        if name in w.slope:
            mean = x.mean((2, 3), keepdim=True)
            x = (x - mean) * torch.rsqrt(((x - mean) ** 2).mean((2, 3), keepdim=True) + EPS)
            x = torch.where(x >= 0, x, w.slope[name].view(1, -1, 1, 1) * x)
        kernel, bias = w.conv[name]
        return F.conv2d(q(x), q(kernel), bias, padding=kernel.shape[-1] // 2)

    with no_tf32(), torch.no_grad():
        x = (image_u8.to(torch.float32) / 255.0)[None, None].expand(1, 3, *image_u8.shape)
        skips = []
        for i, name in enumerate(DOWN_BLOCKS):
            x = block(name, F.avg_pool2d(x, 2) if i else x)
            skips.append(x)
        skips.pop()
        for name in UP_BLOCKS:
            x = block(name, torch.cat([F.interpolate(x, scale_factor=2, mode="nearest"), skips.pop()], 1))
        desc = x[0, :DESC_DIM]
        desc = desc / desc.norm(dim=0, keepdim=True).clamp_min(1e-12)
        return torch.sigmoid(x[0, DESC_DIM]), desc.permute(1, 2, 0)


def pooled(desc_map: torch.Tensor, stride: int = 8) -> np.ndarray:
    """The stride-8 descriptor map ``[H / 8, W / 8, D]`` that the detector
    samples: each 8x8 cell's mean, as float32 numpy."""
    return F.avg_pool2d(desc_map.permute(2, 0, 1)[None], stride)[0].permute(1, 2, 0).cpu().numpy()


def select(heatmap: np.ndarray, capacity: int, radius: int, boundary: int, min_response: float):
    """The heatmap detector's selection: pixels above ``min_response``
    outside the ``boundary`` band, by descending score (ties in row-major
    order), each pick suppressing the clipped (2r+1)^2 square around it, up
    to ``capacity``.  Returns (uv [capacity, 2] float32 (x, y), valid
    [capacity] bool), the picks as a prefix."""
    rows, cols = heatmap.shape
    mask = np.zeros((rows, cols), bool)
    mask[boundary:rows - boundary, boundary:cols - boundary] = True
    ys, xs = np.nonzero((heatmap > min_response) & mask)
    order = np.argsort(-heatmap[ys, xs], kind="stable")
    uv = np.zeros((capacity, 2), np.float32)
    valid = np.zeros(capacity, bool)
    n = 0
    for i in order:
        y, x = int(ys[i]), int(xs[i])
        if not mask[y, x]:
            continue
        uv[n] = (x, y)
        valid[n] = True
        n += 1
        if n >= capacity:
            break
        mask[max(0, y - radius):y + radius + 1, max(0, x - radius):x + radius + 1] = False
    return uv, valid


def sample(desc_map: np.ndarray, uv: np.ndarray, valid: np.ndarray, stride: int = 8) -> np.ndarray:
    """Bilinear descriptors at (u / 8, v / 8) of a ``[Hc, Wc, D]`` map in
    float32; zero outside cells [0, dim - 2] and for invalid slots."""
    hc, wc, _ = desc_map.shape
    row = uv[:, 1] / np.float32(stride)
    col = uv[:, 0] / np.float32(stride)
    ir, ic = row.astype(np.int64), col.astype(np.int64)
    sr, sc = row - np.floor(row), col - np.floor(col)
    ok = valid & (ir >= 0) & (ir < hc - 1) & (ic >= 0) & (ic < wc - 1)
    ir, ic = np.clip(ir, 0, hc - 2), np.clip(ic, 0, wc - 2)
    out = ((1 - sc) * (1 - sr))[:, None] * desc_map[ir, ic] + (sc * (1 - sr))[:, None] * desc_map[ir, ic + 1] \
        + ((1 - sc) * sr)[:, None] * desc_map[ir + 1, ic] + (sc * sr)[:, None] * desc_map[ir + 1, ic + 1]
    return np.where(ok[:, None], out, 0).astype(np.float32)


def match(desc_a, valid_a, desc_b, valid_b, min_similarity: float = 0.0, tie: float = 1e-6):
    """Cosine matching with the mutual cross-check: per A slot the B of the
    largest similarity (the lower index on a tie), kept when at least
    ``min_similarity`` and when that B's best A is this slot.  Returns
    (index [Na], -1 when unmatched; near [Na] bool: a decision of this slot
    rests on two similarities, or a similarity and the floor, closer than
    ``tie``, which float32 rounding may order either way)."""
    def unit(d):
        d = d.astype(np.float64)
        return d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)

    sim = unit(desc_a) @ unit(desc_b).T
    both = valid_a[:, None] & valid_b[None, :]
    sim = np.where(both, sim, -np.inf)
    best_j = sim.argmax(1)
    best = sim[np.arange(len(sim)), best_j]
    best_i = sim.argmax(0)
    ok = valid_a & np.isfinite(best) & (best >= min_similarity) & (best_i[best_j] == np.arange(len(sim)))

    def close(s):
        # the top two of each row closer than ``tie`` but not equal: an exact
        # tie (rows of zeros) is a tie in float32 too, and goes to the lower index
        top2 = -np.sort(-s, axis=1)[:, :2]
        with np.errstate(invalid="ignore"):
            gap = top2[:, 0] - top2[:, 1]
        return (gap > 0) & (gap < tie)

    near = valid_a & np.isfinite(best) & (close(sim) | close(sim.T)[best_j]
                                          | ((best != min_similarity) & (np.abs(best - min_similarity) < tie)))
    return np.where(ok, best_j, -1).astype(np.int32), near
