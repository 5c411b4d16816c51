"""The packaged NN weights, read as Flax param trees of numpy arrays.

Counterpart of ``feature_detector_tpu/models/weights.py``.  The two trained
archives live in the JAX package's data directory
(``feature_detector_tpu/models/weights/{superpoint,disk}_synth.npz``, float16)
and are read from there by path with ``np.load``: a data file, not an import,
so the port still imports nothing of the JAX package.  ``core/convert.py``
turns a tree into the port's ``state_dict``.

An archive's keys are ``params/<layer>/.../kernel|bias|alpha`` (the
flattening of ``models/train_superpoint.py:save_params_npz``); the tree comes
back as ``{"params": {...}}`` with float32 leaves.

``init_state`` draws the initial parameters of a model trained from
scratch, with Flax's defaults.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_WEIGHTS_DIR = os.path.join(_REPO_ROOT, "feature_detector_tpu", "models", "weights")
SUPERPOINT_SYNTH = os.path.join(_WEIGHTS_DIR, "superpoint_synth.npz")
DISK_SYNTH = os.path.join(_WEIGHTS_DIR, "disk_synth.npz")


def load_params_npz(path: str) -> dict:
    """Rebuilds the ``{"params": {...}}`` tree of an npz archive, leaves as
    float32 numpy arrays."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key].astype(np.float32)
    return tree


def load_default_superpoint() -> Optional[dict]:
    """The packaged trained SuperPoint tree, or None when the archive is absent."""
    return load_params_npz(SUPERPOINT_SYNTH) if os.path.exists(SUPERPOINT_SYNTH) else None


def load_default_disk() -> Optional[dict]:
    """The packaged trained DISK tree, or None when the archive is absent."""
    return load_params_npz(DISK_SYNTH) if os.path.exists(DISK_SYNTH) else None


TRUNCATED_NORMAL_STD = 0.87962566103423978  # std of a standard normal cut at +-2 (Flax's variance_scaling)
PRELU_INIT = 0.25


@torch.no_grad()
def init_state(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draws ``model``'s parameters in place, as Flax's defaults do:

    - conv kernels ``lecun_normal``: a normal of std
      ``sqrt(1 / fan_in) / 0.87962566``, cut at +-2 std (fan_in = input
      channels x kernel area);
    - biases zero;
    - PReLU slopes (a 1-D ``weight``) 0.25.

    Every value is drawn on the CPU from ``generator`` (a CPU
    ``torch.Generator``), in the order of ``named_parameters``, and copied
    to the parameter's device.  Returns ``model``."""
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.dim() == 1:
            p.fill_(PRELU_INIT)
        elif p.dim() == 4:
            std = (1.0 / (p.shape[1] * p.shape[2] * p.shape[3])) ** 0.5 / TRUNCATED_NORMAL_STD
            draw = torch.empty(p.shape, dtype=torch.float32)
            nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            p.copy_(draw)
        else:
            raise ValueError(f"init_state: no initial value for parameter {name} of shape {tuple(p.shape)}")
    return model
