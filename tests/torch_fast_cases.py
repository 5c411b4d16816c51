"""Seeded FAST inputs shared by the CPU tests of ``kernels/fast.py``
(tests/test_torch_detect.py) and its card tests (tests/test_torch_gpu.py).

Numpy and the port only: the card's test file imports nothing of the JAX
package.  A case is ``(image, mask, FastOptions, threshold)``: a uint8
``[B, H, W]`` or ``[H, W]`` image, None or an int32 mask with zeros, and
the candidate threshold.
"""

import numpy as np

from feature_detector_tpu_torch.core.config import FastOptions
from feature_detector_tpu_torch.models.synth_data import scene_uint8, synth_scene

D = FastOptions().min_pixel_diff_value


def _random(rng, shape=(3, 97, 151)):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _at_threshold(rng, shape=(3, 97, 151), p=100):
    """Every pixel p, p +- d or p +- (d + 1): ring pixels sit exactly at
    and one past both thresholds of the pixels that hold p."""
    return rng.choice(np.uint8([p - D - 1, p - D, p, p, p + D, p + D + 1]), shape)


def _extremes(rng, shape=(3, 97, 151)):
    """0 and 255 beside values within d of them: p + d passes 255 and
    p - d falls below 0, which uint8 arithmetic would wrap."""
    return rng.choice(np.uint8([0, 0, 255, 255, D, 255 - D, 128]), shape)


def _scenes(seeds, h, w):
    return np.stack([scene_uint8(synth_scene(np.random.default_rng(s), h, w, rich_background=True)[0])
                     for s in seeds])


def _holes(rng, shape):
    """An int32 mask of ones with a block and scattered pixels of 0."""
    m = (rng.random(shape) > 0.1).astype(np.int32)
    m[..., 10:30, 20:60] = 0
    return m


# name: rng -> (image, mask, FastOptions, threshold)
FAST_CASES = {
    "random": lambda rng: (_random(rng), None, FastOptions(), 10.0),
    "random_n9": lambda rng: (_random(rng), None, FastOptions(n=9), 10.0),
    "flat": lambda rng: (np.full((2, 40, 50), 128, np.uint8), None, FastOptions(), 0.0),
    "ring_at_threshold": lambda rng: (_at_threshold(rng), None, FastOptions(), 9.0),
    "ring_at_threshold_n9": lambda rng: (_at_threshold(rng), None, FastOptions(n=9), 9.5),
    "values_0_and_255": lambda rng: (_extremes(rng), None, FastOptions(), 12.0),
    "scenes": lambda rng: (_scenes((3, 4), 120, 160), None, FastOptions(), 10.0),
    "mask_hw": lambda rng: (_random(rng), _holes(rng, (97, 151)), FastOptions(), 10.0),
    "mask_bhw": lambda rng: (_random(rng), _holes(rng, (3, 97, 151)), FastOptions(n=9), 10.0),
    "frame_hw_mask_hw": lambda rng: (_at_threshold(rng, (97, 151)), _holes(rng, (97, 151)), FastOptions(), 10.0),
    "odd_7x7": lambda rng: (_random(rng, (4, 7, 7)), None, FastOptions(n=9), 1.0),
    "empty_interior_6x6": lambda rng: (_random(rng, (2, 6, 6)), None, FastOptions(n=9), 0.0),
}

# The main path's sizes, run on the card only (the plain chain takes about
# 2 GB of int64 temporaries at B = 64).
FAST_CARD_CASES = {
    "b1_480x752": lambda rng: (_scenes((5,), 480, 752), None, FastOptions(), 10.0),
    "b64_480x752": lambda rng: (np.concatenate([_scenes(range(8), 480, 752)] * 7 + [_random(rng, (8, 480, 752))]),
                                None, FastOptions(), 10.0),
}


def fast_case(name: str):
    cases = {**FAST_CASES, **FAST_CARD_CASES}
    return cases[name](np.random.default_rng(sorted(cases).index(name)))
