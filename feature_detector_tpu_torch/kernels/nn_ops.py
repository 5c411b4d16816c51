"""Plain tensor ops shared by the NN models, the NN front-end and the float
matcher: L2 normalisation (inline in the JAX models and matcher) and
bilinear descriptor sampling on a stride-8 descriptor map (counterpart of
``sample_descriptor_grid`` in ``feature_detector_tpu/frontend/nn_detector.py``).
"""

from __future__ import annotations

import torch

STRIDE = 8  # pixels per descriptor-map cell, for both models


def l2_normalise(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x / max(||x||, 1e-12)`` along ``dim``."""
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=dim, keepdim=True), 1e-12)


def sample_descriptor_grid(desc_map: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear descriptors at (u / STRIDE, v / STRIDE) of ``desc_map``
    ``[Hc, Wc, D]`` for ``uv`` ``[N, 2]``; rows or columns outside
    [0, dim - 2] give zeros.  The cell index truncates toward zero and the
    fraction is taken from the floor, as the JAX package does, so a row in
    (-1, 0) reads cell 0.  Returns ``[N, D]``."""
    hc, wc, ddim = desc_map.shape
    row = uv[:, 1] / float(STRIDE)
    col = uv[:, 0] / float(STRIDE)
    int_row = row.to(torch.int32)
    int_col = col.to(torch.int32)
    sub_row = row - torch.floor(row)
    sub_col = col - torch.floor(col)
    w00 = (1 - sub_col) * (1 - sub_row)
    w01 = sub_col * (1 - sub_row)
    w10 = (1 - sub_col) * sub_row
    w11 = sub_col * sub_row
    ok = (int_row >= 0) & (int_row < hc - 1) & (int_col >= 0) & (int_col < wc - 1)
    base = (torch.clamp(int_row, 0, hc - 2) * wc + torch.clamp(int_col, 0, wc - 2)).to(torch.int64)
    flat = desc_map.reshape(-1, ddim)
    v = (w00[:, None] * flat[base] + w01[:, None] * flat[base + 1]
         + w10[:, None] * flat[base + wc] + w11[:, None] * flat[base + wc + 1])
    return torch.where(ok[:, None], v, torch.zeros((), dtype=v.dtype, device=v.device))
