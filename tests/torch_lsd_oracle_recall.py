"""LSD lines of both packages against the LSD oracle on synthetic scenes, on
the CPU: a study, not a test.

    JAX_PLATFORMS=cpu python -m tests.torch_lsd_oracle_recall [--seeds 0 1 2] [--rows 480 --cols 752]

On each ``synth_scene`` (the scenes of ``chip_smoke.py`` phase ``oracle``:
``rich_background=True``, seeds 0-2 at 752x480) it runs the JAX package's
``detect_good_lines`` (its XLA flood on the CPU), the port's (its plain
flood), and the oracle (``feature_detector_tpu/oracle/lsd.py``), each with
the default ``LineDetectorOptions`` and a budget of 100, and prints one JSON
object: per seed the oracle's line count, each package's line count, and
each package's recall at 4 px (the share of the oracle's lines with a
detected line whose endpoints are within 4 px, under the better endpoint
pairing: ``tests/test_lsd.py:65-77``), and whether the two packages' lines
are the same to 1e-3 px.
"""

import argparse
import json
import time

import jax.numpy as jnp
import numpy as np
import torch

from feature_detector_tpu.core.config import LineDetectorOptions as JLineDetectorOptions
from feature_detector_tpu.frontend.line_detector import detect_good_lines as jax_lines
from feature_detector_tpu.oracle import lsd as oracle
from feature_detector_tpu_torch.core.config import LineDetectorOptions
from feature_detector_tpu_torch.frontend.line_detector import detect_good_lines
from feature_detector_tpu_torch.models.synth_data import scene_uint8, synth_scene

BUDGET = 100
LINE_PX = 4.0


def endpoint_set_distance(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    d1 = max(np.hypot(*(a[:2] - b[:2])), np.hypot(*(a[2:] - b[2:])))
    d2 = max(np.hypot(*(a[:2] - b[2:])), np.hypot(*(a[2:] - b[:2])))
    return float(min(d1, d2))


def recall(want, got) -> float:
    hit = sum(1 for w in want if len(got) and min(endpoint_set_distance(w, g) for g in got) < LINE_PX)
    return hit / max(len(want), 1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--rows", type=int, default=480)
    ap.add_argument("--cols", type=int, default=752)
    args = ap.parse_args(argv)
    out = {"rows": args.rows, "cols": args.cols, "budget": BUDGET, "line_px": LINE_PX, "scenes": {}}
    t0 = time.perf_counter()
    for seed in args.seeds:
        img = scene_uint8(synth_scene(np.random.default_rng(seed), args.rows, args.cols, rich_background=True)[0])
        want = np.asarray(oracle.detect_lines(img, JLineDetectorOptions()), np.float32).reshape(-1, 4)
        jax_segs = np.asarray(jax_lines(jnp.asarray(img), BUDGET, JLineDetectorOptions()).to_numpy()).reshape(-1, 4)
        port_segs = detect_good_lines(torch.from_numpy(img), BUDGET, LineDetectorOptions()).to_numpy().reshape(-1, 4)
        same = jax_segs.shape == port_segs.shape and bool(np.abs(jax_segs - port_segs).max(initial=0.0) <= 1e-3)
        out["scenes"][seed] = {"oracle_lines": len(want), "jax_lines": len(jax_segs), "port_lines": len(port_segs),
                               "jax_recall_at_4px": recall(want, jax_segs),
                               "port_recall_at_4px": recall(want, port_segs), "lines_equal_1e-3_px": same}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
