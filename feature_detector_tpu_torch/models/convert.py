"""Public PyTorch checkpoints as the port's ``state_dict``.

Counterpart of ``feature_detector_tpu/models/convert.py``.  It maps the
public MagicLeap SuperPoint checkpoint (``superpoint_v1.pth``, layers
``conv1a`` ... ``convDb``) and DISK thin-U-Net state dicts (cvlab-epfl/disk)
onto the port's ``SuperPoint`` and ``Disk``.  Both are torch modules already,
so no layout changes: only the names are mapped and the shapes checked.
Without a downloaded checkpoint the converters are exercised with synthetic
state dicts of the published shapes.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..core.convert import DISK_BLOCKS, SUPERPOINT_LAYERS

DISK_OUT = (16, 32, 64, 64, 64, 64, 64, 64, 129)  # output channels of the nine 5x5 convs
DISK_IN = (3, 16, 32, 64, 64, 128, 128, 96, 80)  # their input channels (skip concatenations included)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)).clone()


def superpoint_from_torch(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A MagicLeap-style SuperPoint state dict (``<layer>.weight`` OIHW and
    ``<layer>.bias``; tensors or numpy arrays) as the ``state_dict`` of the
    port's ``SuperPoint``, float32 on the CPU."""
    out = {}
    for name in SUPERPOINT_LAYERS:
        for leaf in ("weight", "bias"):
            out[f"{name}.{leaf}"] = _f32(state_dict[f"{name}.{leaf}"])
    return out


def disk_from_torch(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A cvlab-epfl/disk thin-U-Net state dict as the ``state_dict`` of the
    port's ``Disk``.

    Public exports differ only in key prefixes, so the mapping is
    positional by shape, as the JAX package's:

    - the 4-D ``*.weight`` tensors, in state-dict order, are the convs of
      down_0 ... down_4, up_0 ... up_3, each with its same-prefix ``*.bias``;
    - the 1-D ``*.weight`` tensors (torch ``nn.PReLU`` slopes), in order,
      are the gates of down_1 ... up_3 (the stem has none).

    Channel counts are checked against the published layout; a mismatch
    raises ``ValueError``."""
    arrays = {k: np.asarray(v) for k, v in state_dict.items()}
    convs = [(k, v) for k, v in arrays.items() if v.ndim == 4]
    alphas = [v for k, v in arrays.items() if v.ndim == 1 and k.endswith("weight")]
    if len(convs) != len(DISK_BLOCKS):
        raise ValueError(f"expected {len(DISK_BLOCKS)} convs, got {len(convs)}")
    if len(alphas) != len(DISK_BLOCKS) - 1:
        raise ValueError(f"expected {len(DISK_BLOCKS) - 1} PReLU gates, got {len(alphas)}")
    out = {}
    for i, (name, (key, w)) in enumerate(zip(DISK_BLOCKS, convs)):
        if w.shape[0] != DISK_OUT[i] or w.shape[1] != DISK_IN[i]:
            raise ValueError(f"{name}: conv {key} has shape {w.shape}, expected [{DISK_OUT[i]}, {DISK_IN[i]}, 5, 5]")
        out[f"{name}.conv.weight"] = _f32(w)
        out[f"{name}.conv.bias"] = _f32(arrays[key[: -len("weight")] + "bias"])
        if i > 0:
            a = alphas[i - 1]
            if a.shape[0] != DISK_IN[i]:
                raise ValueError(f"{name}: gate has {a.shape[0]} params, expected {DISK_IN[i]}")
            out[f"{name}.gate.weight"] = _f32(a)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A ``.pth`` file as a {name: numpy array} dict (read on the CPU, weights
    only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}
