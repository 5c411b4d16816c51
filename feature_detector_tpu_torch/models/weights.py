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
"""

from __future__ import annotations

import os

import numpy as np

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
