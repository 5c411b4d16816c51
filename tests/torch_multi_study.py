"""Two studies of the multi-device slice on the CPU; not tests.

    python -m tests.torch_multi_study cg      # about 2 minutes
    python -m tests.torch_multi_study cache   # about 1 minute

``cg``: the port's VO on the 120-frame bench sequence (``bench.py:275-276``:
240x320, 900 landmarks, seed 7) on the CPU; its global BA problem solved by
``ba_solve`` and by ``make_distributed_ba`` on a world of one started in
this process, dense and camera-sharded (64 CG iterations a LM step).
Prints one JSON object: whether the dense solve equals ``ba_solve``, and
for the camera-sharded one the largest rotation difference, the largest
center and point differences over the span, the median point difference,
the share of points within 1e-2 of the span, and both costs.

``cache``: fault 2 of ROADMAP.md §3.  JAX's gated Shi-Tomasi and Harris maps
and its raw Shi-Tomasi map of ``tests/test_torch_detect.py``'s frames,
each computed in a new process: plainly, writing a persistent compile cache
(every compilation cached), reading that cache back, with
``jax_enable_x64`` switched on, and after a ``ba_solve`` under
``_x64_scope``.  Prints whether each equals the plain maps bit for bit, and
whether XLA warned, reading the cache back, that it was compiled for
another machine type.
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

CACHE_MODES = ("plain", "cache_write", "cache_read", "x64", "after_ba")


def cg_study() -> dict:
    import inspect

    import torch

    from feature_detector_tpu_torch.core.config import BAOptions
    from feature_detector_tpu_torch.parallel.mesh import make_mesh
    from feature_detector_tpu_torch.slam.ba import ba_solve, make_distributed_ba, reprojection_cost
    from feature_detector_tpu_torch.slam.sequence import make_synthetic_sequence, run_visual_odometry_chunked
    from feature_detector_tpu_torch.slam.vo_fused import run_visual_odometry_fused

    seq = make_synthetic_sequence(n_frames=120, n_landmarks=900, seed=7, motion="lateral", angle_step=0.03)
    prob = run_visual_odometry_chunked(seq.images, seq.cam, device="cpu").problem
    opts = inspect.signature(run_visual_odometry_fused).parameters["ba_opts"].default
    span = float(np.linalg.norm(np.ptp(seq.trajectory.positions, 0)))
    mesh = make_mesh(device="cpu")
    dense = ba_solve(prob, seq.cam, opts)
    dist_dense = make_distributed_ba(mesh, seq.cam, opts)(prob)
    cg = make_distributed_ba(mesh, seq.cam, opts, camera_shard=True)(prob)
    centers = lambda p: -torch.einsum("fji,fj->fi", p.rot, p.trans)
    has = (prob.obs_cam >= 0).sum(1) >= 2
    point_err = (cg.points - dense.points)[has].norm(dim=1) / span
    cost = lambda p: float(reprojection_cost(p, seq.cam, BAOptions(huber_delta=1e9)))
    torch.distributed.destroy_process_group()
    return {
        "dense_equals_ba_solve": all(torch.equal(a, b) for a, b in zip(dist_dense[:3], dense[:3])),
        "camera_shard": {
            "rot_max_abs_err": float((cg.rot - dense.rot).abs().max()),
            "center_max_abs_err_over_span": float((centers(cg) - centers(dense)).abs().max()) / span,
            "point_max_err_over_span": float(point_err.max()),
            "point_median_err_over_span": float(point_err.median()),
            "points_within_1e-2_of_span": float((point_err <= 1e-2).float().mean()),
            "cost": cost(cg), "cost_ba_solve": cost(dense),
        },
    }


def cache_probe(mode: str, cache_dir: str, out: str) -> None:
    """One process's maps (run with a fresh interpreter per mode)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0 if mode.startswith("cache") else 1.0)
    if mode == "x64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from feature_detector_tpu.core.config import DetectorOptions, HarrisOptions, ShiTomasiOptions
    from feature_detector_tpu.kernels import detect as KJ
    from tests.test_torch_detect import SEEDS
    from tests.torch_port_inputs import synth_stack

    if mode == "after_ba":
        from feature_detector_tpu.core.config import BAOptions
        from feature_detector_tpu.slam import ba as JBA
        from tests.test_slam import CAM, perturb, synthetic_ba

        rng = np.random.default_rng(4)
        JBA.ba_solve(perturb(synthetic_ba(rng), rng), CAM, BAOptions(max_iterations=3))
    frames = synth_stack(SEEDS)
    mask = jnp.ones(frames.shape[1:], jnp.int32)
    maps = []
    for f in frames:
        img = jnp.asarray(f)
        maps.append(KJ.shi_tomasi_response(img, mask, DetectorOptions(min_valid_response=40.0), ShiTomasiOptions()))
        maps.append(KJ.harris_response(img, mask, DetectorOptions(min_valid_response=30.0), HarrisOptions()))
        maps.append(KJ.shi_tomasi_response_raw(img.astype(jnp.float32), ShiTomasiOptions()))
    np.save(out, np.stack([np.asarray(m) for m in maps]))


def cache_study() -> dict:
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    with tempfile.TemporaryDirectory() as tmp:
        stderr = {}
        for mode in CACHE_MODES:
            cache = f"{tmp}/{'plain' if mode == 'plain' else 'shared'}_cache"  # plain: a cache of its own
            stderr[mode] = subprocess.run([sys.executable, "-m", "tests.torch_multi_study", "cache-probe", mode, cache,
                                           f"{tmp}/{mode}.npy"], cwd=root, env=env, check=True, capture_output=True,
                                          text=True).stderr
        plain = np.load(f"{tmp}/plain.npy")
        out = {mode: bool(np.array_equal(np.load(f"{tmp}/{mode}.npy"), plain)) for mode in CACHE_MODES[1:]}
        # Whether XLA's loader, reading back entries compiled on the same machine, named another machine type.
        out["cache_read_machine_type_warning"] = "doesn't match the machine type" in stderr["cache_read"]
        return out


if __name__ == "__main__":
    if sys.argv[1] == "cg":
        print(json.dumps(cg_study()))
    elif sys.argv[1] == "cache":
        print(json.dumps(cache_study()))
    elif sys.argv[1] == "cache-probe":
        cache_probe(*sys.argv[2:5])
    else:
        raise SystemExit(f"unknown study {sys.argv[1]!r}: cg or cache")
