"""DISK detector/descriptor U-Net as a torch ``nn.Module``.

Counterpart of ``feature_detector_tpu/models/disk.py`` with the same block
names (``down_0`` ... ``down_4``, ``up_0`` ... ``up_3``), so
``core/convert.py`` carries a Flax param tree across.  The published thin
U-Net: down channels (16, 32, 64, 64, 64) at /1 ... /16 with 2x2 average
pooling, up channels (64, 64, 64, D + 1) with nearest 2x upsampling and skip
concatenation, one 5x5 conv per block pre-activated by an affine-free
InstanceNorm and a per-channel PReLU (the stem is a bare conv).  The last
block emits D descriptor channels and one detection logit, at full
resolution.

Layouts: the input is NCHW ``[B, 3, H, W]`` float32 in [0, 1] with H and W
multiples of 16; the outputs are those of the JAX model, heatmap ``[B, H, W]``
and descriptor map ``[B, H, W, D]`` (channels last).

dtype policy: convs and PReLU run in ``dtype`` (default bfloat16) with
float32 parameters cast at use; InstanceNorm computes in float32 and casts
back; the head goes back to float32 before the sigmoid and the
normalisation.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.nn_ops import l2_normalise
from .superpoint import conv

DESC_DIM = 128  # descriptor width of the packaged weights
DOWN = (16, 32, 64, 64, 64)  # channels at /1, /2, /4, /8, /16
UP = (64, 64, 64)  # then DESC_DIM + 1 at full resolution
KERNEL = 5
EPSILON = 1e-5


class InstanceNorm(nn.Module):
    """Affine-free InstanceNorm2d: per sample and channel over H and W, in
    float32, cast back to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=(2, 3), keepdim=True)
        var = ((x32 - mean) ** 2).mean(dim=(2, 3), keepdim=True)
        return ((x32 - mean) * torch.rsqrt(var + EPSILON)).to(x.dtype)


class PReLU(nn.Module):
    """Per-channel PReLU in the input's dtype; ``weight`` holds the float32
    slopes (Flax's ``alpha``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.weight.to(x.dtype).view(1, -1, 1, 1)
        return torch.where(x >= 0, x, a * x)


class ThinConv(nn.Module):
    """One pre-activated conv: [InstanceNorm -> PReLU ->] conv; ``is_first``
    leaves out the norm and the gate."""

    def __init__(self, cin: int, cout: int, is_first: bool = False):
        super().__init__()
        self.is_first = is_first
        if not is_first:
            self.norm = InstanceNorm()
            self.gate = PReLU(cin)
        self.conv = conv(cin, cout, KERNEL)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.is_first:
            x = self.gate(self.norm(x))
        return self.conv(x)


class Disk(nn.Module):
    """Input ``[B, 3, H, W]`` float32 in [0, 1], H and W multiples of 16.
    Returns (heatmap ``[B, H, W]`` float32 in [0, 1], descriptors
    ``[B, H, W, DESC_DIM]`` float32, unit norm)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for i, feats in enumerate(DOWN):
            setattr(self, f"down_{i}", ThinConv(cin, feats, is_first=(i == 0)))
            cin = feats
        for i, feats in enumerate(UP + (DESC_DIM + 1,)):
            setattr(self, f"up_{i}", ThinConv(cin + DOWN[-2 - i], feats))  # skip from down_{3 - i}
            cin = feats

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        scale = 2 ** (len(DOWN) - 1)
        if x.shape[-2] % scale or x.shape[-1] % scale:
            raise ValueError(f"Disk: H and W must be multiples of {scale}, got {tuple(x.shape[-2:])}")
        x = x.to(self.dtype)
        skips = []
        for i in range(len(DOWN)):
            if i > 0:
                x = F.avg_pool2d(x, 2)
            x = getattr(self, f"down_{i}")(x)
            if i < len(DOWN) - 1:
                skips.append(x)
        for i in range(len(UP) + 1):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = getattr(self, f"up_{i}")(torch.cat([x, skips.pop()], dim=1))
        head = x.to(torch.float32)
        desc = l2_normalise(head[:, :DESC_DIM], dim=1).permute(0, 2, 3, 1)
        return torch.sigmoid(head[:, -1]), desc


def normalised_biases(model: Disk) -> set:
    """Names of the conv biases whose every consumer is an InstanceNorm: every
    block's but the head's (the last up block).  The norm subtracts the
    per-channel mean, so their exact gradient is 0 and a float32 gradient
    there is rounding noise."""
    head = f"up_{len(UP)}"
    return {f"{name}.conv.bias" for name, m in model.named_children() if isinstance(m, ThinConv) and name != head}


def preprocess_gray_rgb(image_u8: torch.Tensor) -> torch.Tensor:
    """``[H, W]`` uint8 -> ``[1, 3, H, W]`` float32 in [0, 1], gray
    replicated to RGB."""
    return (image_u8.to(torch.float32) / 255.0)[None, None].expand(1, 3, *image_u8.shape).contiguous()
