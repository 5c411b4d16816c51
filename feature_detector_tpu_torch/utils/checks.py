"""Numeric checks: non-finite outputs and leaves, anomaly detection.

Counterpart of ``feature_detector_tpu/utils/checks.py``.  The JAX package
wraps a function in ``checkify`` to trap NaN and Inf inside the graph; here
``checked`` checks the outputs of every call (PyTorch raises on an index out
of bounds itself), ``assert_all_finite`` guards a pipeline boundary and
names the leaf at fault, and ``debug_nans`` turns on autograd's anomaly
detection.

Usage:
    checked_step = checked(train_step)          # raises FloatingPointError
    assert_all_finite({"points": pts}, "ba")    # host boundary guard
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch


def tree_leaves_with_path(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) for every leaf of nested dicts, lists, tuples, named
    tuples and dataclasses; a path joins keys and indices with "/"."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))
    else:
        yield prefix, tree
        return
    for key, value in items:
        yield from tree_leaves_with_path(value, f"{prefix}/{key}" if prefix else str(key))


def count_nonfinite(leaf) -> Tuple[int, int]:
    """(non-finite elements, elements) of a floating leaf; (0, 0) otherwise."""
    if isinstance(leaf, torch.Tensor):
        if not leaf.is_floating_point():
            return 0, 0
        return int((~torch.isfinite(leaf)).sum()), leaf.numel()
    if isinstance(leaf, (np.ndarray, np.floating, float)):
        arr = np.asarray(leaf)
        if arr.dtype.kind != "f":
            return 0, 0
        return int((~np.isfinite(arr)).sum()), arr.size
    return 0, 0


def assert_all_finite(tree: Any, name: str = "value") -> None:
    """Raises FloatingPointError naming the first floating leaf of ``tree``
    that holds a NaN or an Inf."""
    for path, leaf in tree_leaves_with_path(tree):
        bad, size = count_nonfinite(leaf)
        if bad:
            raise FloatingPointError(f"{name}: non-finite values (nan or inf) in leaf '{path}' ({bad}/{size} elements)")


def checked(fn: Callable) -> Callable:
    """``fn`` whose every output leaf is checked: a NaN or an Inf raises
    FloatingPointError naming the function and the leaf."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_all_finite(out, getattr(fn, "__name__", "output"))
        return out

    return wrapper


def debug_nans(enable: bool = True) -> None:
    """Autograd's anomaly detection: a backward pass that makes a NaN raises
    with the forward operation that led to it.  Slow, for triage only."""
    torch.autograd.set_detect_anomaly(enable)
