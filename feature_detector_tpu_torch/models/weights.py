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
scratch, with Flax's defaults.  ``init_superglue_state`` draws SuperGlue's
seeded weights under the public checkpoint's names (no trained SuperGlue
weights are in the repository).
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
SUPERGLUE_FINAL_GAIN = 32.0  # the seeded SuperGlue's final projection, in units of torch's default width


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


@torch.no_grad()
def init_superglue_state(model: nn.Module, generator: torch.Generator) -> dict:
    """Seeded weights for ``models.superglue.SuperGlue`` as torch initialises
    the public model: each 1x1 convolution's weight and bias uniform in
    +-1/sqrt(fan_in), but the last bias of the keypoint encoder and of each
    GNN layer's MLP, which the public code sets to 0; BatchNorm's scale 1,
    shift 0 and eval statistics 0 and 1; ``bin_score`` 1.  The final
    projection's weight is drawn SUPERGLUE_FINAL_GAIN times wider: at torch's
    width the scores of unit descriptors stay within about 0.1 of each
    other, Sinkhorn's plan is flat and nothing passes the match threshold,
    while at this width the scores span several units, as a trained model's
    do, and the seeded network matches about a third of the keypoints of two
    views of one scene.  Every value is drawn on the CPU from ``generator``
    in the order of the state dict.  Returns the state dict (float32 CPU
    tensors, the public names)."""
    zero_bias = {"kenc.encoder.%d.bias" % (len(model.kenc.encoder) - 1)}
    zero_bias |= {"gnn.layers.%d.mlp.%d.bias" % (i, len(layer.mlp) - 1) for i, layer in enumerate(model.gnn.layers)}
    convs = {name for name, m in model.named_modules() if isinstance(m, nn.Conv1d)}
    state = {}
    for name, t in model.state_dict().items():
        owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if owner in convs:
            fan_in = model.get_submodule(owner).weight.shape[1]
            bound = 1.0 / fan_in ** 0.5
            draw = torch.rand(t.shape, generator=generator, dtype=torch.float32) * (2 * bound) - bound
            if name == "final_proj.weight":
                draw = draw * SUPERGLUE_FINAL_GAIN
            state[name] = torch.zeros(t.shape) if name in zero_bias else draw
        elif leaf in ("weight", "running_var"):
            state[name] = torch.ones(t.shape)
        elif leaf in ("bias", "running_mean"):
            state[name] = torch.zeros(t.shape)
        elif leaf == "num_batches_tracked":
            state[name] = torch.zeros((), dtype=torch.int64)
        elif name == "bin_score":
            state[name] = torch.tensor(1.0)
        else:
            raise ValueError(f"init_superglue_state: no initial value for {name} of shape {tuple(t.shape)}")
    return state
