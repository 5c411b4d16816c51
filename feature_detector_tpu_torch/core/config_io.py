"""Config serialisation: FrontendConfig <-> dict / YAML / CLI overrides.

Counterpart of ``feature_detector_tpu/core/config_io.py`` for the port's
option dataclasses (``core/config.py``).  The dataclasses are the schema;
this module is the transport: nested dicts with enum members by name,
unknown keys refused, and dotted-path overrides from the command line
(``detector.max_features=512``).  ``yaml`` is imported only where YAML is
read or written.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Mapping

from .config import FrontendConfig


def config_to_dict(cfg: Any) -> Dict[str, Any]:
    """A config dataclass as nested dicts of scalars (enum members by name)."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: config_to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, enum.Enum):
        return cfg.name
    return cfg


def config_from_dict(data: Mapping[str, Any], cls: type = FrontendConfig) -> Any:
    """``cls`` built from a nested dict; unknown keys raise KeyError."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name, value in data.items():
        default = getattr(cls(), name)
        if dataclasses.is_dataclass(default):
            kwargs[name] = config_from_dict(value, type(default))
        elif isinstance(default, enum.Enum):
            kwargs[name] = type(default)[value] if isinstance(value, str) else type(default)(value)
        else:
            kwargs[name] = value
    return cls(**kwargs)


def load_yaml(path: str, cls: type = FrontendConfig) -> Any:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return config_from_dict(data, cls)


def save_yaml(path: str, cfg: Any) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(config_to_dict(cfg), f, sort_keys=False)


def apply_overrides(cfg: Any, overrides: Mapping[str, Any]) -> Any:
    """Applies dotted-path overrides, {"detector.max_features": 512}.
    String values take the type of the field they replace (bool, int,
    float; enums by name), so CLI ``key=value`` pairs pass through as they
    are.  An unknown path raises KeyError."""
    data = config_to_dict(cfg)
    for path, value in overrides.items():
        parts = path.split(".")
        node = data
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                raise KeyError(f"unknown config path: {path}")
            node = node[p]
        leaf = parts[-1]
        if leaf not in node:
            raise KeyError(f"unknown config path: {path}")
        old = node[leaf]
        if isinstance(value, str) and not isinstance(old, str):
            if isinstance(old, bool):
                value = value.lower() in ("1", "true", "yes", "on")
            elif isinstance(old, int):
                value = int(value)
            elif isinstance(old, float):
                value = float(value)
        node[leaf] = value
    return config_from_dict(data, type(cfg))
