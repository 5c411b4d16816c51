"""Carry state from the JAX package into the port.

The JAX package's containers (``Features``, ``Descriptors``, ``Matches``,
``Lines``), its option dataclasses, its BRIEF pattern table and the Flax
param trees of its NN models become the port's objects.  Arrays are read
through ``np.asarray``, so the JAX objects may hold jax arrays or numpy
arrays: this module never imports JAX.  The incremental re-detect path takes
JAX-detected ``existing`` features through ``from_jax``; the NN models take
their weights through ``superpoint_state_from_flax`` and
``disk_state_from_flax`` (kernels HWIO -> OIHW), and give them back, for
saving, through ``flax_tree_from_superpoint_state`` and
``flax_tree_from_disk_state``; the SLAM tests hand the
JAX package's ``BAProblem``, ``PoseGraph`` and ``Pinhole`` over through
``from_jax`` too.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ..slam.ba import BAProblem
from ..slam.camera import Pinhole
from ..slam.pose_graph import PoseGraph
from . import config as C
from .device import DeviceLike, as_tensor
from .types import Descriptors, Features, Lines, Matches, words_from_numpy

_OPTION_CLASSES = {
    cls.__name__: cls
    for cls in (
        C.DetectorOptions, C.FastOptions, C.HarrisOptions, C.ShiTomasiOptions,
        C.BriefOptions, C.MatcherOptions, C.LineDetectorOptions,
        C.NNDetectorOptions, C.BAOptions, C.FrontendConfig,
    )
}


def features_from_numpy(uv, response, valid, device: DeviceLike = None) -> Features:
    return Features(
        uv=as_tensor(np.asarray(uv, np.float32), device),
        response=as_tensor(np.asarray(response, np.float32), device),
        valid=as_tensor(np.asarray(valid, bool), device),
    )


def options_from_dict(cls, fields: dict):
    """Builds the port's option dataclass ``cls`` from ``dataclasses.asdict``
    output; nested option structs and enum members (matched by name) are
    rebuilt as the port's own types.  Unknown keys raise."""
    kw = {}
    names = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in fields.items():
        if key not in names:
            raise ValueError(f"{cls.__name__} has no field {key!r}")
        default = getattr(cls(), key)
        if dataclasses.is_dataclass(default):
            value = options_from_dict(type(default), value)
        elif isinstance(default, enum.Enum):
            value = type(default)[value.name if isinstance(value, enum.Enum) else value]
        kw[key] = value
    return cls(**kw)


def brief_pattern_from_numpy(table) -> torch.Tensor:
    """A BRIEF pattern table [N, 4] (dcol1, drow1, dcol2, drow2) as an int64
    CPU tensor; the port's kernels sample from their own copy
    (``kernels/brief_pattern.py``), which this lets a caller check against."""
    t = np.asarray(table)
    if t.ndim != 2 or t.shape[1] != 4 or not np.issubdtype(t.dtype, np.integer):
        raise ValueError(f"BRIEF pattern must be an integer [N, 4] table, got {t.dtype} {t.shape}")
    return torch.as_tensor(t.astype(np.int64))


SUPERPOINT_LAYERS = (
    "conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a",
    "conv4b", "convPa", "convPb", "convDa", "convDb",
)
DISK_BLOCKS = ("down_0", "down_1", "down_2", "down_3", "down_4", "up_0", "up_1", "up_2", "up_3")


def _conv_state(prefix: str, leaf) -> dict:
    """A Flax conv leaf {kernel HWIO, bias} as torch ``weight`` (OIHW) and ``bias``."""
    kernel = np.asarray(leaf["kernel"], np.float32)
    if kernel.ndim != 4:
        raise ValueError(f"{prefix}: conv kernel must be HWIO, got shape {kernel.shape}")
    return {
        f"{prefix}.weight": torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))),
        f"{prefix}.bias": torch.from_numpy(np.asarray(leaf["bias"], np.float32).copy()),
    }


def _params(tree) -> dict:
    return tree["params"] if "params" in tree else tree


def superpoint_state_from_flax(tree) -> dict:
    """A Flax param tree of ``models.superpoint.SuperPoint`` (packaged, or
    ``model.init``; leaves numpy or jax arrays) as the ``state_dict`` of the
    port's ``SuperPoint``.  The 3x3 blocks wrap their conv as
    ``<layer>/Conv_0``; the 1x1 heads convPb and convDb are bare convs."""
    params = _params(tree)
    state = {}
    for name in SUPERPOINT_LAYERS:
        leaf = params[name] if name in ("convPb", "convDb") else params[name]["Conv_0"]
        state.update(_conv_state(name, leaf))
    return state


def disk_state_from_flax(tree) -> dict:
    """A Flax param tree of ``models.disk.Disk`` as the ``state_dict`` of the
    port's ``Disk``: ``<block>/conv`` becomes ``<block>.conv`` and the PReLU
    ``<block>/gate/alpha`` the gate's ``weight`` (the stem has no gate)."""
    params = _params(tree)
    state = {}
    for name in DISK_BLOCKS:
        state.update(_conv_state(f"{name}.conv", params[name]["conv"]))
        if "gate" in params[name]:
            state[f"{name}.gate.weight"] = torch.from_numpy(np.asarray(params[name]["gate"]["alpha"], np.float32).copy())
    return state


def _conv_leaf(state, prefix: str) -> dict:
    """The torch ``weight`` (OIHW) and ``bias`` of ``prefix`` as a Flax conv
    leaf {kernel HWIO, bias} of float32 numpy arrays."""
    weight = state[f"{prefix}.weight"].detach().to("cpu", torch.float32).numpy()
    return {"kernel": np.ascontiguousarray(weight.transpose(2, 3, 1, 0)),
            "bias": state[f"{prefix}.bias"].detach().to("cpu", torch.float32).numpy().copy()}


def flax_tree_from_superpoint_state(state) -> dict:
    """The inverse of ``superpoint_state_from_flax``: the port's
    ``SuperPoint`` ``state_dict`` as the ``{"params": {...}}`` tree of
    float32 numpy arrays (kernels HWIO) that the JAX model and
    ``save_params_npz`` take."""
    params = {}
    for name in SUPERPOINT_LAYERS:
        leaf = _conv_leaf(state, name)
        params[name] = leaf if name in ("convPb", "convDb") else {"Conv_0": leaf}
    return {"params": params}


def flax_tree_from_disk_state(state) -> dict:
    """The inverse of ``disk_state_from_flax``: the port's ``Disk``
    ``state_dict`` as the JAX model's ``{"params": {...}}`` tree."""
    params = {}
    for name in DISK_BLOCKS:
        params[name] = {"conv": _conv_leaf(state, f"{name}.conv")}
        if f"{name}.gate.weight" in state:
            params[name]["gate"] = {"alpha": state[f"{name}.gate.weight"].detach().to("cpu", torch.float32).numpy().copy()}
    return {"params": params}


def ba_problem_from_numpy(rot, trans, points, obs_cam, obs_uv, device: DeviceLike = None):
    """A BA problem's arrays (the JAX package's ``BAProblem`` fields) as the
    port's ``slam.ba.BAProblem``."""
    f32 = lambda x: as_tensor(np.asarray(x, np.float32), device)
    return BAProblem(f32(rot), f32(trans), f32(points), as_tensor(np.asarray(obs_cam, np.int32), device), f32(obs_uv))


def pose_graph_from_numpy(rot, trans, edge_i, edge_j, edge_rot, edge_trans, device: DeviceLike = None):
    """A pose graph's arrays (the JAX package's ``PoseGraph`` fields) as the
    port's ``slam.pose_graph.PoseGraph``."""
    f32 = lambda x: as_tensor(np.asarray(x, np.float32), device)
    i32 = lambda x: as_tensor(np.asarray(x, np.int32), device)
    return PoseGraph(f32(rot), f32(trans), i32(edge_i), i32(edge_j), f32(edge_rot), f32(edge_trans))


def from_jax(obj, device: DeviceLike = None):
    """Converts one JAX-package object, by its class name, into the port's
    counterpart: a container (fields through numpy) or an option dataclass
    (through ``dataclasses.asdict``)."""
    name = type(obj).__name__
    if name == "Features":
        return features_from_numpy(obj.uv, obj.response, obj.valid, device)
    if name == "Descriptors":
        return Descriptors(words_from_numpy(obj.words, device), as_tensor(np.asarray(obj.valid, bool), device))
    if name == "Matches":
        return Matches.from_numpy(obj.index, obj.distance, obj.valid, device)
    if name == "Lines":
        return Lines.from_numpy(obj.endpoints, obj.valid, device)
    if name == "BAProblem":
        return ba_problem_from_numpy(*obj, device=device)
    if name == "PoseGraph":
        return pose_graph_from_numpy(*obj, device=device)
    if name == "Pinhole":
        return Pinhole(*(float(v) for v in obj))
    if name in _OPTION_CLASSES and dataclasses.is_dataclass(obj):
        return options_from_dict(_OPTION_CLASSES[name], dataclasses.asdict(obj))
    raise TypeError(f"no port counterpart for {name}")
