"""One rank of the multi-process tests of the port's parallel package
(tests/test_torch_parallel.py, tests/test_torch_vo_mesh.py,
tests/test_torch_chip_world.py) and of its data-parallel training step
(tests/test_torch_train.py).

    python -m tests.torch_dist_worker CASE WORLD RANK PORT WORKDIR

Joins a gloo group of WORLD ranks through ``parallel.distributed.initialize``
(coordinator localhost:PORT), reads its inputs from WORKDIR/inputs.npz, runs
CASE ("parallel", "vo", "train" or "graft") on a 1-D CPU mesh and writes
what it computed to WORKDIR/rank{RANK}.npz.  It imports nothing of JAX: the tests make the
inputs and compare the results.  ``Ranks`` starts the ranks from a test.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from feature_detector_tpu_torch.core.config import BAOptions, DetectorOptions
from feature_detector_tpu_torch.core.convert import ba_problem_from_numpy
from feature_detector_tpu_torch.kernels.detect import box_sum
from feature_detector_tpu_torch.models.superpoint import SuperPoint
from feature_detector_tpu_torch.models.train_superpoint import adam, make_train_step
from feature_detector_tpu_torch.parallel import distributed
from feature_detector_tpu_torch.parallel.frontend import (
    make_batched_frontend,
    make_row_sharded_response,
    make_two_frame_matcher,
)
from feature_detector_tpu_torch.parallel.halo import exchange_halo, row_sharded_map
from feature_detector_tpu_torch.parallel.mesh import gather_leading, make_mesh, shard_leading
from feature_detector_tpu_torch.slam.ba import make_distributed_ba
from feature_detector_tpu_torch.slam import vo_fused
from feature_detector_tpu_torch.slam.camera import Pinhole
from feature_detector_tpu_torch.slam.sequence import run_visual_odometry_chunked

THREADS = 1  # per rank: the ranks share the host with the test workers
BA_CAM = Pinhole(fx=400.0, fy=400.0, cx=376.0, cy=240.0)  # tests/test_slam.py
FRONTEND = dict(min_feature_distance=10, min_valid_response=30.0, max_features=64)  # tests/test_parallel.py
MATCHER = dict(min_feature_distance=10, min_valid_response=10.0, max_features=64)
BA_DENSE = dict(max_iterations=8, damping=1e-6, huber_delta=1e9)  # tests/test_slam.py:139
BA_DENSE_2 = dict(BA_DENSE, num_fixed_cameras=2)  # noise-free data: fixing two cameras fixes the scale too
BA_GATED = dict(max_iterations=15, damping=1e-4, huber_delta=2.0, gate_px=2.5, gate_rounds=2)
BA_CG = dict(max_iterations=15, damping=1e-6, huber_delta=1e9)  # tests/test_slam.py:160
CG_ITERATIONS = 96
HALO_ROWS, HALO_COLS, HALO = 6, 3, 2
BA_FIELDS = ("rot", "trans", "points", "obs_cam", "obs_uv")


def _problem(inputs, key):
    return ba_problem_from_numpy(*(inputs[f"{key}_{f}"] for f in BA_FIELDS), device="cpu")


def _ba(out, key, solver, problem):
    solved = solver(problem)
    for f in ("rot", "trans", "points"):
        out[f"{key}_{f}"] = getattr(solved, f).numpy()


def run_parallel(mesh, space, inputs, out):
    frames = inputs["frames"]
    feats, words, dvalid = make_batched_frontend(mesh, "harris", 30, DetectorOptions(**FRONTEND))(frames)
    out.update(fe_uv=feats.uv.numpy(), fe_response=feats.response.numpy(), fe_valid=feats.valid.numpy(),
               fe_words=words.numpy(), fe_dvalid=dvalid.numpy())
    try:
        make_batched_frontend(mesh, "harris", 30, DetectorOptions(**FRONTEND))(frames[:6])
        out["uneven_batch_refused"] = np.bool_(False)
    except ValueError:
        out["uneven_batch_refused"] = np.bool_(True)
    fa, fb, m = make_two_frame_matcher(mesh, "fast", 40, DetectorOptions(**MATCHER))(frames, np.roll(frames, 2, axis=2))
    out.update(tf_uv_a=fa.uv.numpy(), tf_valid_a=fa.valid.numpy(), tf_uv_b=fb.uv.numpy(), tf_valid_b=fb.valid.numpy(),
               tf_index=m.index.numpy(), tf_distance=m.distance.numpy(), tf_valid=m.valid.numpy())

    image, mask = torch.from_numpy(inputs["image"]), torch.from_numpy(inputs["mask"])
    opts = DetectorOptions(min_valid_response=30.0)
    for kind in ("harris", "shi_tomasi"):
        slab = make_row_sharded_response(space, kind, opts)(shard_leading(image, space, "space"),
                                                            shard_leading(mask, space, "space"))
        out[f"rows_{kind}"] = gather_leading(slab, space, "space").numpy()
    box = row_sharded_map(lambda x: box_sum(x, 2), space, halo=2)
    out["rows_box_sum"] = gather_leading(box(shard_leading(image, space, "space")), space, "space").numpy()

    rank = dist.get_rank()
    ramp = (rank * HALO_ROWS + torch.arange(HALO_ROWS, dtype=torch.float32))[:, None].expand(HALO_ROWS, HALO_COLS)
    out["halo"] = exchange_halo(ramp + 1.0, HALO, space, "space").numpy()

    _ba(out, "dense", make_distributed_ba(mesh, BA_CAM, BAOptions(**BA_DENSE)), _problem(inputs, "dense"))
    _ba(out, "dense2", make_distributed_ba(mesh, BA_CAM, BAOptions(**BA_DENSE_2)), _problem(inputs, "dense"))
    _ba(out, "gated", make_distributed_ba(mesh, BA_CAM, BAOptions(**BA_GATED)), _problem(inputs, "gated"))
    for c in inputs["cg_cams"]:
        solver = make_distributed_ba(mesh, BA_CAM, BAOptions(**BA_CG), camera_shard=True, cg_iterations=CG_ITERATIONS)
        _ba(out, f"cg{c}", solver, _problem(inputs, f"cg{c}"))


def run_vo(mesh, inputs, out):
    """The VO over the mesh, with the number of chunk problems this rank's
    ``solve_chunks`` calls were handed (``chunk_blocks``)."""
    cam = Pinhole(*(float(v) for v in inputs["cam"]))
    solve, blocks = vo_fused.solve_chunks, []

    def counted(track_uv, *args, **kwargs):
        blocks.append(int(track_uv.shape[0]))
        return solve(track_uv, *args, **kwargs)

    vo_fused.solve_chunks = counted
    try:
        res = run_visual_odometry_chunked(inputs["images"], cam, mesh=mesh)
    finally:
        vo_fused.solve_chunks = solve
    out.update(positions=res.trajectory.positions, rotations_wc=res.rotations_wc,
               translations_wc=res.translations_wc, chunk_blocks=np.asarray(blocks, np.int64))
    _ba(out, "dense", make_distributed_ba(mesh, BA_CAM, BAOptions(**BA_DENSE)), _problem(inputs, "dense"))


def run_graft(mesh, inputs, out):
    """The camera-sharded seam case of the JAX package's multi-chip entry:
    the dense and the camera-sharded distributed BA on problem ``graft``."""
    cam = Pinhole(*(float(v) for v in inputs["cam"]))
    opts = BAOptions(max_iterations=int(inputs["max_iterations"]))
    _ba(out, "dense", make_distributed_ba(mesh, cam, opts), _problem(inputs, "graft"))
    cg = make_distributed_ba(mesh, cam, opts, camera_shard=True, cg_iterations=int(inputs["cg_iterations"]))
    _ba(out, "cg", cg, _problem(inputs, "graft"))


TRAIN_KEYS = ("image", "label_a", "label_b", "H_ab")
TRAIN_LR = 1e-3


def run_train(mesh, inputs, out):
    """One SuperPoint step (float32, Adam) over the mesh from the parameters
    ``param/<name>`` on the batch: the loss, this rank's gradients after
    the all-reduce and its parameters after the step."""
    model = SuperPoint(dtype=torch.float32)
    model.load_state_dict({k[len("param/"):]: torch.from_numpy(v) for k, v in inputs.items() if k.startswith("param/")})
    loss, aux = make_train_step(model, adam(model, TRAIN_LR), mesh=mesh)({k: inputs[k] for k in TRAIN_KEYS})
    out.update(loss=loss.numpy(), det=aux["det"].numpy(), desc=aux["desc"].numpy())
    for name, p in model.named_parameters():
        out[f"grad/{name}"] = p.grad.numpy()
        out[f"param/{name}"] = p.detach().numpy()


def main(case: str, world: int, rank: int, port: int, workdir: str) -> None:
    torch.set_num_threads(THREADS)
    joined = distributed.initialize(f"localhost:{port}", world, rank, device="cpu")
    info = distributed.process_info()
    mesh = distributed.global_data_mesh(device="cpu")
    inputs = dict(np.load(f"{workdir}/inputs.npz"))
    out = {"joined": np.bool_(joined), "process_index": info["process_index"],
           "process_count": info["process_count"], "global_devices": info["global_devices"],
           "mesh_size": mesh.size()}
    try:
        if case == "parallel":
            run_parallel(mesh, make_mesh((world,), ("space",), device="cpu"), inputs, out)
        elif case == "vo":
            run_vo(mesh, inputs, out)
        elif case == "train":
            run_train(mesh, inputs, out)
        elif case == "graft":
            run_graft(mesh, inputs, out)
        else:
            raise ValueError(f"unknown case {case!r}")
    finally:
        dist.destroy_process_group()
    np.savez(f"{workdir}/rank{rank}.npz", **out)


class Ranks:
    """WORLD rank processes of CASE, started at once on ``inputs`` (a dict
    of arrays) in ``workdir``; ``results()`` waits for them and returns each
    rank's arrays, in rank order.  The test process can compute meanwhile.
    A rank that fails stops the others (they would wait in a collective)."""

    def __init__(self, case: str, world: int, inputs: dict, workdir: Path):
        self.workdir = Path(workdir)
        np.savez(self.workdir / "inputs.npz", **inputs)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env = {**os.environ, "OMP_NUM_THREADS": str(THREADS)}
        root = Path(__file__).resolve().parents[1]
        self.procs = []
        for rank in range(world):
            with open(self.workdir / f"rank{rank}.err", "w") as err:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tests.torch_dist_worker", case, str(world), str(rank), str(port),
                     str(self.workdir)], cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=err))

    def results(self, timeout: float = 300.0):
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in self.procs):
                failed = [r for r, p in enumerate(self.procs) if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            codes = [p.poll() for p in self.procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            bad = bad or [r for r, c in enumerate(codes) if c is None]
            if bad:
                err = (self.workdir / f"rank{bad[0]}.err").read_text()
                raise RuntimeError(f"rank {bad[0]} of {len(codes)}: exit codes {codes} (None: still running at "
                                   f"the {timeout} s limit):\n{err[-3000:]}")
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [dict(np.load(self.workdir / f"rank{rank}.npz")) for rank in range(len(self.procs))]


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
