"""Carry state from the JAX package into the port.

The JAX package's containers (``Features``, ``Descriptors``, ``Matches``,
``Lines``), its option dataclasses and its BRIEF pattern table become the
port's objects.  Arrays are read through ``np.asarray``, so the JAX objects
may hold jax arrays or numpy arrays: this module never imports JAX.  The
incremental re-detect path takes JAX-detected ``existing`` features through
``from_jax``.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

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
    if name in _OPTION_CLASSES and dataclasses.is_dataclass(obj):
        return options_from_dict(_OPTION_CLASSES[name], dataclasses.asdict(obj))
    raise TypeError(f"no port counterpart for {name}")
