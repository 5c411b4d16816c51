"""SuperPoint detector/descriptor backbone as a torch ``nn.Module``.

Counterpart of ``feature_detector_tpu/models/superpoint.py`` with the same
layer names (``conv1a`` ... ``convDb``), so ``core/convert.py`` carries a
Flax param tree across.  A shared VGG encoder (64, 64, 64, 64, 128, 128, 128,
128 channels, three 2x2 max-pools), a 65-channel cell-softmax detector head
decoded by pixel shuffle (8x8 cells + dustbin), and a 256-d descriptor head
at stride 8, L2-normalised.

Layouts: the input is NCHW ``[B, 1, H, W]`` float32 in [0, 1] with H and W
multiples of 8; the outputs are those of the JAX model, heatmap ``[B, H, W]``
and descriptor map ``[B, H/8, W/8, 256]`` (channels last).

dtype policy (Flax's ``dtype`` against ``param_dtype``): parameters are
float32 and are cast to ``dtype`` (default bfloat16) where they are used;
the logits and the descriptor head go back to float32 before the softmax and
the normalisation.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.nn_ops import STRIDE, l2_normalise, sample_descriptor_grid

DESC_DIM = 256  # descriptor width of the packaged weights
NMS_RADIUS = 4  # the NMS head's local-max window is (2 NMS_RADIUS + 1)^2

_ENCODER = (("conv1a", 1, 64), ("conv1b", 64, 64), ("conv2a", 64, 64), ("conv2b", 64, 64),
            ("conv3a", 64, 128), ("conv3b", 128, 128), ("conv4a", 128, 128), ("conv4b", 128, 128))
_POOL_AFTER = ("conv1b", "conv2b", "conv3b")


class Conv(nn.Conv2d):
    """A conv with float32 parameters computed in the input's dtype, "SAME"
    padding for odd kernels.  Built without drawing initial values:
    parameters come from a loaded ``state_dict``, or for training from
    scratch from ``models.weights.init_state``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def conv(cin: int, cout: int, k: int) -> Conv:
    return nn.utils.skip_init(Conv, cin, cout, k, padding=k // 2)


class SuperPoint(nn.Module):
    """Input ``[B, 1, H, W]`` float32 in [0, 1], H and W multiples of 8.
    Returns (heatmap ``[B, H, W]`` float32, descriptors
    ``[B, H/8, W/8, DESC_DIM]`` float32, unit norm)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        for name, cin, cout in _ENCODER:
            setattr(self, name, conv(cin, cout, 3))
        self.convPa = conv(128, 256, 3)
        self.convPb = conv(256, 65, 1)
        self.convDa = conv(128, 256, 3)
        self.convDb = conv(256, DESC_DIM, 1)

    def forward(self, x: torch.Tensor, return_logits: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """``return_logits``: the training output, the raw float32 65-way
        cell logits ``[B, 65, H/8, W/8]`` in place of the heatmap."""
        if x.shape[-2] % 8 or x.shape[-1] % 8:
            raise ValueError(f"SuperPoint: H and W must be multiples of 8, got {tuple(x.shape[-2:])}")
        x = x.to(self.dtype)
        for name, _, _ in _ENCODER:
            x = F.relu(getattr(self, name)(x))
            if name in _POOL_AFTER:
                x = F.max_pool2d(x, 2)
        logits = self.convPb(F.relu(self.convPa(x))).float()
        desc = l2_normalise(self.convDb(F.relu(self.convDa(x))).float(), dim=1).permute(0, 2, 3, 1)
        if return_logits:
            return logits, desc
        # Drop the dustbin; cell channel k = 8i + j goes to pixel (8hc + i, 8wc + j).
        probs = torch.softmax(logits, dim=1)[:, : STRIDE * STRIDE]
        return F.pixel_shuffle(probs, STRIDE)[:, 0], desc


def preprocess_gray(image_u8: torch.Tensor) -> torch.Tensor:
    """``[H, W]`` uint8 -> ``[1, 1, H, W]`` float32 in [0, 1]."""
    return (image_u8.to(torch.float32) / 255.0)[None, None]


def nms_head(
    heatmap: torch.Tensor,
    desc_map: torch.Tensor,
    k: int = 1024,
    min_response: float = 0.005,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The NMS models' three-output head (``*_nms.onnx`` contract): a local
    maximum over the (2 NMS_RADIUS + 1)^2 window ("SAME", -inf outside),
    the response threshold, the k best by descending score with ties in
    row-major order (a stable sort, as ``lax.top_k``), and bilinear
    descriptors at (u / STRIDE, v / STRIDE).

    heatmap ``[H, W]`` float32, desc_map ``[Hc, Wc, D]``.  Returns (keypoints
    int32 ``[k, 2]`` as (u, v), scores ``[k]`` with 0 marking padding,
    descriptors ``[k, D]``).
    """
    h, w = heatmap.shape
    win = 2 * NMS_RADIUS + 1
    local_max = F.max_pool2d(heatmap[None, None], win, stride=1, padding=NMS_RADIUS)[0, 0]
    keep = (heatmap >= local_max) & (heatmap > min_response)
    suppressed = torch.where(keep, heatmap, torch.zeros_like(heatmap))
    scores, flat_idx = torch.sort(suppressed.reshape(-1), descending=True, stable=True)
    scores, flat_idx = scores[:k], flat_idx[:k]
    kpts = torch.stack([flat_idx % w, flat_idx // w], dim=1).to(torch.int32)
    valid = scores > 0.0
    scores = torch.where(valid, scores, torch.zeros_like(scores))
    desc = sample_descriptor_grid(desc_map, kpts.to(torch.float32))
    return kpts, scores, desc * valid[:, None].to(desc.dtype)
