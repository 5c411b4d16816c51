"""The port's fused chunked VO on 30 frames: the reference's test
(tests/test_sequence.py:241-274, seeds 3 and 5, ATE under 3% of the span)
on one device, and the VO over a mesh of two gloo ranks (each its own
process, tests/torch_dist_worker.py) against it, on the CPU.

Tolerances, each measured on these inputs (listed in CHANGES.md too):

- the two ranks return the same trajectory, bit for bit;
- the sharded run's ATE under 3% of the span, as the reference's
  test_chunked_vo_sharded_over_mesh (tests/test_sequence.py:276-300);
- the two ranks' trajectory against the one-device run's: within 1e-4 of
  the span (each rank solves its block of the chunk batch, and a chunk's
  solution does not depend on its batch; the landmark-sharded global BA
  stays within BA_DIST_RTOL of ba_solve);
- the distributed BA at two ranks against ba_solve: BA_DIST_RTOL of the
  magnitude, as in tests/test_torch_parallel.py.
"""

import functools
import time

import numpy as np
import pytest
import torch

from feature_detector_tpu_torch.core.config import BAOptions
from feature_detector_tpu_torch.slam import ba as TBA
from feature_detector_tpu_torch.slam import sequence as TS
from feature_detector_tpu_torch.slam import vo_fused as TV
from feature_detector_tpu_torch.slam.evaluate import ate_rmse
from tests import torch_dist_worker as W
from tests.test_slam import CAM, perturb, synthetic_ba

WORLD = 2
ATE_SPAN_SHARE = 0.03  # tests/test_sequence.py:274
VO_MESH_POS_ATOL = 1e-4  # chip_smoke.py MULTI_VO_POS_ATOL: the VO over a mesh against one device, over the span
BA_DIST_RTOL = 1e-9


def sequence30(seed):
    return TS.make_synthetic_sequence(n_frames=30, n_landmarks=500, seed=seed, motion="lateral", angle_step=0.03)


def span_share(positions, seq):
    gt = seq.trajectory.positions
    return float(ate_rmse(positions, gt, with_scale=True)) / float(np.linalg.norm(gt.max(0) - gt.min(0)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the two ranks on seed 3, then runs the one-device VO on seeds
    3 and 5 while they work.  Returns (rank results, {seed: (seq, result,
    seconds)}, the ranks' inputs)."""
    seq = sequence30(3)
    rng = np.random.default_rng(5)
    dense = perturb(synthetic_ba(rng, n_pts=64), rng)
    inputs = {"images": seq.images, "cam": np.asarray(tuple(seq.cam), np.float64)}
    inputs.update({f"dense_{f}": np.asarray(getattr(dense, f)) for f in W.BA_FIELDS})
    ranks = W.Ranks("vo", WORLD, inputs, tmp_path_factory.mktemp("vo_ranks"))
    single = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(W.THREADS)  # beside the ranks' threads, within the host's cores
    try:
        for seed in (3, 5):
            s = seq if seed == 3 else sequence30(seed)
            t0 = time.time()
            res = TS.run_visual_odometry_chunked(s.images, s.cam, device="cpu")
            single[seed] = (s, res, time.time() - t0)
    finally:
        torch.set_num_threads(threads)
    return ranks.results(), single, inputs


@pytest.mark.parametrize("seed", [3, 5])
def test_chunked_vo_30_frames(runs, seed):
    """tests/test_sequence.py:241-274 for the port, on the CPU."""
    seq, res, seconds = runs[1][seed]
    assert seconds < 400, "wall budget"
    assert len(res.trajectory) == 30
    assert np.isfinite(res.trajectory.positions).all()
    share = span_share(res.trajectory.positions, seq)
    print(f"seed {seed}: ATE {100 * share:.4f}% of the span, {seconds:.1f} s")
    assert share < ATE_SPAN_SHARE


def test_mesh_is_passed_on_not_dropped(monkeypatch):
    """The chunked entry hands ``mesh`` to the fused path, with no
    "ignored" warning (the VO over a mesh itself runs in the ranks)."""
    warnings, calls = [], []
    monkeypatch.setattr(TS, "report_warn", lambda msg, *args: warnings.append(msg % args))

    @functools.wraps(TV.run_visual_odometry_fused)  # keeps the signature the entry filters by
    def fused(*args, **kwargs):
        calls.append(kwargs)

    monkeypatch.setattr(TV, "run_visual_odometry_fused", fused)
    mesh = object()
    TS.run_visual_odometry_chunked(np.zeros((2, 8, 8), np.uint8), TS.Pinhole(1.0, 1.0, 4.0, 4.0), mesh=mesh,
                                   device="cpu")
    assert calls and calls[0]["mesh"] is mesh
    assert not warnings, warnings


def test_ranks_join_a_world_of_two(runs):
    for r, res in enumerate(runs[0]):
        assert bool(res["joined"]) and int(res["process_index"]) == r
        assert int(res["process_count"]) == WORLD and int(res["global_devices"]) == WORLD


def test_sharded_vo_within_3pct_and_ranks_agree(runs):
    """tests/test_sequence.py:276-300 at two ranks."""
    ranks, single, _ = runs
    seq = single[3][0]
    for key in ("positions", "rotations_wc", "translations_wc"):
        np.testing.assert_array_equal(ranks[1][key], ranks[0][key], err_msg=key)
    pos = ranks[0]["positions"]
    assert pos.shape == (30, 3) and np.isfinite(pos).all()
    share = span_share(pos, seq)
    print(f"sharded over {WORLD} ranks: ATE {100 * share:.4f}% of the span "
          f"(one device {100 * span_share(single[3][1].trajectory.positions, seq):.4f}%)")
    assert share < ATE_SPAN_SHARE


def test_sharded_vo_equals_one_device(runs):
    """Each rank solves only its block of the chunk batch (4 chunks: 2 a
    rank), whose solutions are the same bits as in the whole batch, and the
    global BA's landmark-sharded solve stays within BA_DIST_RTOL of
    ba_solve's: the two ranks' trajectory within VO_MESH_POS_ATOL of the
    span of the one-device run's."""
    ranks, single, _ = runs
    seq, res = single[3][0], single[3][1]
    n_chunks = len(TV.chunk_starts(30, 12, 5))
    for r in range(WORLD):
        assert ranks[r]["chunk_blocks"].tolist() == [-(-n_chunks // WORLD)], (r, ranks[r]["chunk_blocks"])
    gt = seq.trajectory.positions
    err = np.abs(ranks[0]["positions"] - res.trajectory.positions).max() / np.linalg.norm(gt.max(0) - gt.min(0))
    print(f"sharded over {WORLD} ranks against one device: {err:.3g} of the span")
    assert err <= VO_MESH_POS_ATOL


def test_distributed_ba_at_two_ranks(runs):
    ranks, _, inputs = runs
    problem = TBA.BAProblem(*(torch.from_numpy(inputs[f"dense_{f}"]) for f in W.BA_FIELDS))
    want = TBA.ba_solve(problem, CAM, BAOptions(**W.BA_DENSE))
    for f in ("rot", "trans", "points"):
        np.testing.assert_array_equal(ranks[1][f"dense_{f}"], ranks[0][f"dense_{f}"])
        w = getattr(want, f).numpy()
        err = np.abs(ranks[0][f"dense_{f}"] - w).max() / max(1.0, np.abs(w).max())
        print(f"{f}: {err:.3g} of the magnitude")
        assert err <= BA_DIST_RTOL
