"""Seeded inputs shared by the PyTorch-port tests (tests/test_torch_*.py).

Frames are small synthetic scenes made with numpy from a seed, handed to the
JAX package and to the port alike; no test of the port reads image files.
"""

import numpy as np

from feature_detector_tpu.models.synth_data import synth_scene


def synth_frame(seed: int, h: int = 120, w: int = 160, rich_background: bool = True) -> np.ndarray:
    img, _ = synth_scene(np.random.default_rng(seed), h, w, rich_background=rich_background)
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def synth_stack(seeds, h: int = 120, w: int = 160) -> np.ndarray:
    return np.stack([synth_frame(s, h, w) for s in seeds])
