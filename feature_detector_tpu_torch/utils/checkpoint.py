"""Checkpoint and resume for model parameters, optimizer state and SLAM
back-end state.

Counterpart of ``feature_detector_tpu/utils/checkpoint.py``, which writes
orbax checkpoints.  Here a tree (nested dicts, lists and tuples of tensors,
numpy arrays and Python scalars) is one ``torch.save`` file, written
atomically: to a temporary file in the same directory, then ``os.replace``,
so a crash mid-write leaves the previous checkpoint whole.  Numpy leaves are
stored as tensors and files are read with ``weights_only=True``.  Given a
template, a restored tree takes each template leaf's type, dtype and
device: a checkpoint written from the card restores onto the card, or onto
the CPU, as the template says.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _to_storable(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_storable(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _to_storable(v) for k, v in zip(tree._fields, tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_storable(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, np.generic):
        return torch.from_numpy(np.asarray(tree))
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree


def _like(saved: Any, template: Any, path: str = "") -> Any:
    """``saved`` in the structure, types, dtypes and devices of ``template``."""
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(f"checkpoint tree at '{path}' does not match the template's keys")
        return {k: _like(saved[k], v, f"{path}/{k}") for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(**_like(saved, dict(zip(template._fields, template)), path))
    if isinstance(template, (list, tuple)):
        if len(saved) != len(template):
            raise ValueError(f"checkpoint tree at '{path}' has {len(saved)} entries, the template {len(template)}")
        return type(template)(_like(s, t, f"{path}/{i}") for i, (s, t) in enumerate(zip(saved, template)))
    if isinstance(template, torch.Tensor):
        if tuple(saved.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint leaf '{path}' has shape {tuple(saved.shape)}, the template "
                             f"{tuple(template.shape)}")
        return saved.to(device=template.device, dtype=template.dtype)
    if isinstance(template, (np.ndarray, np.generic)):
        return saved.numpy().astype(template.dtype, copy=False).reshape(np.shape(template))
    if isinstance(template, (bool, int, float)) and isinstance(saved, torch.Tensor):
        return type(template)(saved.item())
    return saved


def save_pytree(path: str, tree: Any, *, force: bool = True) -> None:
    """Writes ``tree`` to the file ``path`` atomically.  ``force=False``
    refuses to replace an existing checkpoint (FileExistsError)."""
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        torch.save(_to_storable(tree), tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def restore_pytree(path: str, template: Optional[Any] = None) -> Any:
    """Reads a tree written by ``save_pytree``: with ``template`` (a tree of
    the same structure) in its types, dtypes and devices, else as stored,
    on the CPU."""
    saved = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return saved if template is None else _like(saved, template)


class CheckpointManager:
    """Step-numbered checkpoints ``<directory>/<step>.pt`` with retention of
    the newest ``max_to_keep``, for training loops and BA solves."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def all_steps(self) -> list:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory)) if m)

    def save(self, step: int, tree: Any) -> None:
        save_pytree(self._path(step), tree)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        return restore_pytree(self._path(step), template)

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX package's API."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
