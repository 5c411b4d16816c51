"""The traffic generator: frames from the seed, as a mix's parameters say.

A mix (``traffic/<mix>.json``) names its ``kind`` and its sizes:

- ``pairs``: closed-loop steps of ``pairs`` frame pairs (over all ranks).
  ``pool`` batches are made once and cycled, so that no step finds its
  frames in the card's 50 MB L2 cache.  Frame j of batch k is scene
  ``(j // per + k) % scenes`` (``per = pairs // scenes``) rolled down by
  ``j % per + k * per`` rows and right by ``7 k`` columns; its partner is
  the same frame rolled ``col_shift`` more columns (the layout of
  ``chip_smoke.py:main_frames`` for batch 0) with sensor noise, uniform in
  [-noise, noise] grey levels, drawn on the device from the seed, so that
  the two frames of a pair differ as two exposures do.
- ``stream``: one camera; ``scenes`` scenes, each seen in ``frames_per_scene``
  consecutive frames rolled ``shift`` more pixels down and right each time,
  so that neighbours overlap; the stream cycles through them.

Scene i is ``synth_scene`` of ``numpy.random.default_rng([seed, i])``, so a
seed gives the same frames on every rank and in every run, and every seed
the same sizes.  Scenes are made on the host and rolled on the device.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .synth import scene_uint8, synth_scene

def load_mix(name: str, root: Path) -> dict:
    """The parameters of mix ``name`` in the checkout at ``root``."""
    with open(root / "bench_cuda" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def scenes(seed: int, n: int, rows: int, cols: int) -> np.ndarray:
    """``[n, rows, cols]`` uint8 scenes of ``seed`` (rich background)."""
    return np.stack([scene_uint8(synth_scene(np.random.default_rng([seed, i]), rows, cols, rich_background=True)[0])
                     for i in range(n)])


def pair_pool(mix: dict, seed: int, rows: int, cols: int, device):
    """(A, B): ``[pool, pairs, rows, cols]`` uint8 on ``device``."""
    s = torch.from_numpy(scenes(seed, mix["scenes"], rows, cols)).to(device)
    pairs, n_scenes = mix["pairs"], mix["scenes"]
    per = pairs // n_scenes
    a = torch.empty((mix["pool"], pairs, rows, cols), dtype=torch.uint8, device=device)
    for k in range(mix["pool"]):
        for j in range(pairs):
            a[k, j] = torch.roll(s[(j // per + k) % n_scenes], (j % per + k * per, 7 * k), (0, 1))
    b = torch.roll(a, mix["col_shift"], 3)
    if mix["noise"]:
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        noise = torch.randint(-mix["noise"], mix["noise"] + 1, b.shape, generator=g, device=device, dtype=torch.int16)
        b = (b.to(torch.int16) + noise).clamp_(0, 255).to(torch.uint8)
    return a, b


def stream_pool(mix: dict, seed: int, rows: int, cols: int, device) -> torch.Tensor:
    """``[scenes * frames_per_scene, rows, cols]`` uint8 on ``device``, in
    stream order."""
    s = torch.from_numpy(scenes(seed, mix["scenes"], rows, cols)).to(device)
    per, shift = mix["frames_per_scene"], mix["shift"]
    return torch.stack([torch.roll(s[i], (shift * t, shift * t), (0, 1))
                        for i in range(mix["scenes"]) for t in range(per)])
