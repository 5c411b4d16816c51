"""The multi-card run of ``chip_smoke.py`` (``--world N``) and the start-up it
drives, on the CPU.

- The parent's launcher (``chip_smoke.run_ranks``): every rank gets the
  environment the JAX package's launcher reads plus LOCAL_RANK; one rank
  that fails, or the wall limit, ends every rank.
- ``python3 chip_smoke.py --world 4`` without a card, and with fewer cards
  than ranks, fails and prints no result.
- ``parallel/distributed.py:initialize`` takes the card from LOCAL_RANK.
- The camera-sharded seam case of the JAX package's multi-chip entry
  (``__graft_entry__.py:120-162``: 5 cameras, 30 reduced rows over 4
  ranks) at 4 gloo ranks, against the one-device solve and JAX's
  ``make_distributed_ba`` on 4 virtual devices.
"""

import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from feature_detector_tpu.core.config import BAOptions as JBAOptions
from feature_detector_tpu.parallel.mesh import make_mesh as jax_make_mesh
from feature_detector_tpu.slam import ba as JBA
from feature_detector_tpu.slam.ba import BAProblem as JBAProblem
from feature_detector_tpu.slam.camera import Pinhole as JPinhole
from feature_detector_tpu_torch.core.config import BAOptions
from feature_detector_tpu_torch.core.convert import ba_problem_from_numpy
from feature_detector_tpu_torch.parallel import distributed
from feature_detector_tpu_torch.slam import ba as TBA
from tests import torch_dist_worker as W

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
BA_DIST_RTOL = 1e-9  # tests/test_torch_parallel.py: the dense distributed BA against ba_solve
BA_JAX_RTOL = 1e-4  # tests/test_torch_slam.py BA_RTOL


def _rank_argv(code):
    return lambda rank: [sys.executable, "-c", code.replace("THIS_RANK", str(rank))]


def test_run_ranks_hands_each_rank_its_place(tmp_path):
    code = ("import os; print(os.environ['COORDINATOR_ADDRESS'], os.environ['NUM_PROCESSES'], "
            "os.environ['PROCESS_ID'], os.environ['LOCAL_RANK'])")
    codes = chip_smoke.run_ranks(_rank_argv(code), WORLD, tmp_path, 60)
    assert codes == [0] * WORLD
    lines = [(tmp_path / f"rank{r}.out").read_text().split() for r in range(WORLD)]
    assert len({ln[0] for ln in lines}) == 1 and lines[0][0].startswith("localhost:")
    assert [ln[1:] for ln in lines] == [[str(WORLD), str(r), str(r)] for r in range(WORLD)]


def test_run_ranks_ends_every_rank_when_one_fails(tmp_path):
    """Rank 2 fails while the others would wait (in a collective, on the
    card): the launcher kills them at once instead of at their timeout."""
    code = "import sys, time; sys.exit(3) if THIS_RANK == 2 else time.sleep(120)"
    t0 = time.monotonic()
    codes = chip_smoke.run_ranks(_rank_argv(code), WORLD, tmp_path, 100)
    assert time.monotonic() - t0 < 60
    assert codes[2] == 3 and all(c is None for r, c in enumerate(codes) if r != 2)


def test_run_ranks_wall_limit(tmp_path):
    t0 = time.monotonic()
    codes = chip_smoke.run_ranks(_rank_argv("import time; time.sleep(120)"), 2, tmp_path, 2)
    assert codes == [None, None] and time.monotonic() - t0 < 60


def test_world_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "chip_smoke.py", "--world", "4"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout, out.stdout + out.stderr


def test_world_run_needs_a_card_a_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: WORLD - 1)
    with pytest.raises(RuntimeError, match=f"{WORLD - 1} CUDA device"):
        chip_smoke.world_main(WORLD)


@pytest.mark.parametrize("local_rank,process_id,want", [("3", 3, 3), (None, 6, 2)], ids=["local_rank", "modulo"])
def test_initialize_takes_the_card_from_the_environment(monkeypatch, local_rank, process_id, want):
    """On the card ``initialize`` makes ``cuda:LOCAL_RANK`` current before
    it joins the NCCL group (NCCL's point-to-point sends need it), else
    ``cuda:(PROCESS_ID % cards)``."""
    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.setdefault("device", i))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend, had_device="device" in calls, **kw))
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert distributed.initialize("localhost:1234", 8, process_id)
    assert calls == {"device": want, "backend": "nccl", "had_device": True, "init_method": "tcp://localhost:1234",
                     "world_size": 8, "rank": process_id}


def _graft_entry_problem(n_devices):
    """``__graft_entry__.py:120-150`` as the JAX package's multi-chip entry
    builds it (a loop per observation)."""
    n_cams, n_pts, deg = 5, 8 * n_devices, 3
    rs = np.random.default_rng(0)
    pts = rs.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    rots = np.broadcast_to(np.eye(3, dtype=np.float32), (n_cams, 3, 3)).copy()
    trans = np.stack([np.array([0.2 * i, 0.0, 0.0], np.float32) for i in range(n_cams)])
    cam = JPinhole(fx=100.0, fy=100.0, cx=24.0, cy=16.0)
    obs_cam = np.stack([np.arange(deg, dtype=np.int32) + (l % (n_cams - deg + 1)) for l in range(n_pts)])
    obs_uv = np.zeros((n_pts, deg, 2), np.float32)
    for l in range(n_pts):
        for d in range(deg):
            c = obs_cam[l, d]
            pc = rots[c] @ pts[l] + trans[c]
            obs_uv[l, d] = [cam.fx * pc[0] / pc[2] + cam.cx, cam.fy * pc[1] / pc[2] + cam.cy]
    points = pts + rs.normal(size=pts.shape).astype(np.float32) * 0.02
    return (rots, trans, points, obs_cam, obs_uv), cam


@pytest.fixture(scope="module")
def graft_ranks(tmp_path_factory):
    arrays, cam = chip_smoke.graft_seam_problem(WORLD)
    inputs = {f"graft_{f}": a for f, a in zip(W.BA_FIELDS, arrays)}
    inputs.update(cam=np.asarray(cam, np.float64), max_iterations=np.int64(chip_smoke.GRAFT_MAX_ITERATIONS),
                  cg_iterations=np.int64(chip_smoke.GRAFT_CG_ITERATIONS))
    return arrays, cam, W.Ranks("graft", WORLD, inputs, tmp_path_factory.mktemp("graft")).results()


def test_graft_seam_problem_is_the_multichip_entrys():
    got, cam = chip_smoke.graft_seam_problem(WORLD)
    want, jcam = _graft_entry_problem(WORLD)
    assert tuple(cam) == tuple(jcam)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("form", ["dense", "cg"])
def test_graft_seam_case_at_four_ranks(graft_ranks, form):
    """30 reduced rows over 4 ranks (the camera-sharded path pads them to
    32).  Every rank returns the same; the dense solve equals ba_solve
    within BA_DIST_RTOL and JAX's dense distributed solve within
    BA_JAX_RTOL; the camera-sharded solve (24 CG iterations) ends within
    chip_smoke.GRAFT_CG_COST_SHARE of the initial cost of the dense solve's
    cost and of JAX's camera-sharded solve's (noise-free data: two LM steps
    take the cost from 0.264 to about 6e-7)."""
    arrays, cam, ranks = graft_ranks
    for r in ranks[1:]:
        for f in ("rot", "trans", "points"):
            np.testing.assert_array_equal(r[f"{form}_{f}"], ranks[0][f"{form}_{f}"])
    opts = BAOptions(max_iterations=chip_smoke.GRAFT_MAX_ITERATIONS)
    problem = ba_problem_from_numpy(*arrays, device="cpu")
    single = TBA.ba_solve(problem, cam, opts)
    jproblem = JBAProblem(*(jnp.asarray(a) for a in arrays))
    jopts = JBAOptions(max_iterations=chip_smoke.GRAFT_MAX_ITERATIONS)
    jmesh, jcam = jax_make_mesh((WORLD,), ("data",)), JPinhole(*cam)
    got = {f: ranks[0][f"{form}_{f}"] for f in ("rot", "trans", "points")}
    solved = problem._replace(**{f: torch.from_numpy(v) for f, v in got.items()})
    cost = lambda p: float(TBA.reprojection_cost(p, cam, opts))
    if form == "dense":
        jsol = JBA.make_distributed_ba(jmesh, jcam, jopts)(jproblem)
        for f, v in got.items():
            want = getattr(single, f).numpy()
            assert np.abs(v - want).max() / max(1.0, np.abs(want).max()) <= BA_DIST_RTOL, f
            jwant = np.asarray(getattr(jsol, f))
            assert np.abs(v - jwant).max() / max(1.0, np.abs(jwant).max()) <= BA_JAX_RTOL, f
    else:
        jsol = JBA.make_distributed_ba(jmesh, jcam, jopts, camera_shard=True,
                                       cg_iterations=chip_smoke.GRAFT_CG_ITERATIONS)(jproblem)
        jcost = float(JBA.reprojection_cost(jsol, jcam, jopts))
        print(f"seam case: cost {cost(problem):.4g} -> {cost(solved):.4g} (dense {cost(single):.4g}, JAX "
              f"camera-sharded {jcost:.4g})")
        assert cost(solved) < cost(problem)
        tol = chip_smoke.GRAFT_CG_COST_SHARE * cost(problem)
        assert abs(cost(solved) - cost(single)) <= tol and abs(cost(solved) - jcost) <= tol
