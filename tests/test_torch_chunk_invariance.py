"""Batch-size invariance of the port's chunk solver on the CPU: the plain
versions of K4 (``fixed_contract``, ``fixed_sum``) and K5
(``fixed_lu_solve``) and ``solve_chunks`` give a problem the same bits
whatever the batch it is solved in, so the fused VO can split its chunk
batch over a mesh (``slam/vo_fused.py``).  The card's kernels equal these
plain versions bit for bit (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances against float64 (numpy inputs from a seed):

- K4: each output within (r + 1) float32 roundings of sum_k |a_k c_k|, r
  the additions on its path (K - 1 serial, or ceil(K / 32) - 1 + 5 through
  the lanes), the first-order bound of the order the kernel fixes;
- K5: LU with partial pivoting on diagonally dominant systems, within
  LU_ATOL of torch.linalg.solve's float64 solution (measured at most
  6.8e-8 over n = 5, 6, 72 and every batch);
- every slice, every block of chunks and the padded batch: bit for bit.
"""

import numpy as np
import pytest
import torch

from feature_detector_tpu_torch.core.config import BAOptions, BriefOptions, DetectorOptions, MatcherOptions
from feature_detector_tpu_torch.kernels import fixed_order as FO
from feature_detector_tpu_torch.slam import fixed
from feature_detector_tpu_torch.slam import sequence as TS
from feature_detector_tpu_torch.slam import vo_fused as TV

BATCHES = [1, 2, 5, 17, 34]
# (M, K, N) of the chunk solver's contractions: a 3x3 rotation, a landmark's 3x3 block over 12 frames x 2 rows,
# a camera's 6x6 block over 64 landmarks x 2 rows, the reduced system's 72 x 72 block over 128 landmarks x 3
CONTRACT_SHAPES = [(3, 3, 3), (3, 24, 3), (6, 128, 6), (72, 384, 72)]
SUM_LENGTHS = [2, 16, 17, 6144]
LU_SIZES = [5, 6, 72]
LU_ATOL = 1e-6
CHUNK_OPTS = dict(max_iterations=10, huber_delta=2.0, gate_px=3.0, gate_rounds=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the plain versions are many small elementwise ops,
    which gain nothing from threads beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def roundings(k: int) -> int:
    """Float32 roundings on one output's path through K4's order over k."""
    return k if FO.lanes(k) == 1 else -(-k // FO.LANES) + 5


def slices(b: int):
    """Every single problem, and blocks that cut the batch unevenly."""
    return [(i, i + 1) for i in range(b)] + [(0, b), (0, (b + 1) // 2), (b // 3, b)]


@pytest.mark.parametrize("batch", BATCHES)
def test_contract_plain_slices_equal_whole(batch):
    rng = np.random.default_rng(batch)
    for m, k, n in CONTRACT_SHAPES:
        a = rng.standard_normal((batch, m, k)).astype(np.float32)
        c = rng.standard_normal((batch, k, n)).astype(np.float32)
        whole = FO.fixed_contract(torch.from_numpy(a), torch.from_numpy(c))
        for lo, hi in slices(batch):
            part = FO.fixed_contract(torch.from_numpy(a[lo:hi]), torch.from_numpy(c[lo:hi]))
            assert torch.equal(part, whole[lo:hi]), (m, k, n, lo, hi)
        want = a.astype(np.float64) @ c.astype(np.float64)
        scale = np.abs(a).astype(np.float64) @ np.abs(c).astype(np.float64)
        bound = (roundings(k) + 1) * 2.0 ** -24 * scale
        assert (np.abs(whole.numpy() - want) <= bound).all(), (m, k, n)


@pytest.mark.parametrize("batch", BATCHES)
def test_sum_plain_slices_equal_whole(batch):
    rng = np.random.default_rng(100 + batch)
    for k in SUM_LENGTHS:
        x = rng.standard_normal((batch, 3, k)).astype(np.float32)
        whole = FO.fixed_sum(torch.from_numpy(x))
        for lo, hi in slices(batch):
            assert torch.equal(FO.fixed_sum(torch.from_numpy(x[lo:hi])), whole[lo:hi]), (k, lo, hi)
        bound = roundings(k) * 2.0 ** -24 * np.abs(x).astype(np.float64).sum(-1)
        assert (np.abs(whole.numpy() - x.astype(np.float64).sum(-1)) <= bound).all(), k


def _dominant(rng, batch, n):
    a = rng.standard_normal((batch, n, n)).astype(np.float32)
    a[:, np.arange(n), np.arange(n)] += np.float32(2 * n) * np.sign(rng.standard_normal((batch, n))).astype(np.float32)
    return a, rng.standard_normal((batch, n)).astype(np.float32)


@pytest.mark.parametrize("batch", BATCHES)
def test_lu_solve_plain_slices_equal_whole(batch):
    rng = np.random.default_rng(200 + batch)
    for n in LU_SIZES:
        a, b = _dominant(rng, batch, n)
        a[:, 0], a[:, 1] = a[:, 1].copy(), a[:, 0].copy()  # the pivot search has rows to swap
        whole = FO.fixed_lu_solve(torch.from_numpy(a), torch.from_numpy(b))
        for lo, hi in slices(batch):
            part = FO.fixed_lu_solve(torch.from_numpy(a[lo:hi]), torch.from_numpy(b[lo:hi]))
            assert torch.equal(part, whole[lo:hi]), (n, lo, hi)
        want = torch.linalg.solve(torch.from_numpy(a).double(), torch.from_numpy(b).double())
        err = float((whole.double() - want).abs().max())
        print(f"n = {n}: {err:.3g} from float64")
        assert err <= LU_ATOL


def test_lu_solve_plain_singular_gives_nonfinite():
    a = torch.tensor([[[1.0, 2.0], [2.0, 4.0]], [[0.0, 0.0], [0.0, 0.0]]])
    x = FO.fixed_lu_solve(a, torch.ones(2, 2))
    assert not torch.isfinite(x).all(-1).any()
    nan_row = torch.tensor([[[float("nan"), 1.0], [1.0, 1.0]]])
    assert torch.isnan(FO.fixed_lu_solve(nan_row, torch.ones(1, 2))).all()


def test_kernel_wrappers_check_their_input():
    with pytest.raises(TypeError):
        FO.fixed_contract(torch.ones(2, 3, dtype=torch.float64), torch.ones(3, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        FO.fixed_contract(torch.ones(2, 3), torch.ones(2, 2))
    with pytest.raises(ValueError):
        FO.fixed_lu_solve(torch.eye(FO.LU_MAX_N + 1), torch.ones(FO.LU_MAX_N + 1))
    assert FO.fixed_contract(torch.ones(4, 0), torch.ones(0, 2)).eq(0).all()


EINSUMS = {
    "landmark_block": ("...ldki,...ldkj->...lij", [(2, 7, 12, 2, 3), (2, 7, 12, 2, 3)]),
    "reduced_system": ("...ldij,...lekj->...diek", [(2, 7, 12, 6, 3), (2, 7, 12, 6, 3)]),
    "camera_diagonal": ("...ldki,...ldkj,...ld->...dij", [(2, 7, 12, 2, 6), (2, 7, 12, 2, 6), (2, 7, 12)]),
    "back_substitution": ("...ldij,...di->...lj", [(2, 7, 12, 6, 3), (2, 12, 6)]),
    "refine_schur": ("...ni,...n,...nj->...ij", [(3, 40, 5), (3, 40), (3, 40, 5)]),
    "refine_depth": ("...nk,...n,...nk->...n", [(3, 40, 2), (3, 40), (3, 40, 2)]),
}


@pytest.mark.parametrize("name", sorted(EINSUMS))
def test_fixed_einsum_agrees_with_torch(name):
    """Inside ``batch_invariant``: float32 through K4's plain version
    within 1e-5 of the magnitudes, float64 through torch.einsum itself, bit
    for bit (the global BA stays as it was); outside it, torch.einsum."""
    spec, shapes = EINSUMS[name]
    rng = np.random.default_rng(7)
    ops = [rng.standard_normal(s) for s in shapes]
    with fixed.batch_invariant():
        got = fixed.einsum(spec, *(torch.from_numpy(o).float() for o in ops)).double()
        f64 = [torch.from_numpy(o) for o in ops]
        assert torch.equal(fixed.einsum(spec, *f64), torch.einsum(spec, *f64))
    want = torch.einsum(spec, *(torch.from_numpy(o).float().double() for o in ops))
    scale = torch.einsum(spec, *(torch.from_numpy(o).float().double().abs() for o in ops))
    assert ((got - want).abs() <= 1e-5 * scale).all()
    f32 = [torch.from_numpy(o).float() for o in ops]
    assert torch.equal(fixed.einsum(spec, *f32), torch.einsum(spec, *f32))  # outside the context: the library


def test_fixed_ops_inside_jacfwd_equal_outside():
    """Inside torch.func transforms the contraction runs as the plain
    version: the primal of a jvp equals the direct call, and the
    derivative is the product rule's."""
    rng = np.random.default_rng(3)
    a, c, da = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((4, 3, 40), (4, 40, 2),
                                                                                       (4, 3, 40)))
    with fixed.batch_invariant():
        out, tangent = torch.func.jvp(lambda x: fixed.matmul(x, c), (a,), (da,))
        assert torch.equal(out, fixed.matmul(a, c))
        assert torch.equal(tangent, fixed.matmul(da, c))
        s, ds = torch.func.jvp(lambda x: fixed.sum(x, (-2, -1)), (a,), (da,))
        assert torch.equal(s, fixed.sum(a, (-2, -1))) and torch.equal(ds, fixed.sum(da, (-2, -1)))


# --------------------------------------------------------------------------
# The chunk solver
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chunks30():
    """The fused VO's chunk problems of tests/test_torch_vo_mesh.py's
    sequence30(3) (4 chunks), and the whole batch's solution."""
    seq = TS.make_synthetic_sequence(n_frames=30, n_landmarks=500, seed=3, motion="lateral", angle_step=0.03)
    det = DetectorOptions(min_feature_distance=10, min_valid_response=20.0, max_features=256, subpixel=True)
    feats, words, dvalid, links = TS.scan_frontend(seq.images, "harris", 200, det, BriefOptions(upright=True),
                                                   device="cpu")
    uv = feats.uv.numpy()
    n = len(seq.images)
    pairs = TV.match_and_gate(words, dvalid, uv, feats.valid.numpy(), links.numpy(), seq.cam,
                              MatcherOptions(ratio=0.85, max_distance=80), TV.match_offsets_for(n))
    tracks = TS.build_tracks_conflict_free(pairs, n, det.max_features)
    track_uv, track_has = TV.chunk_problems(tracks, uv, TV.chunk_starts(n, 12, 5), 12, 512)
    tu, th = torch.from_numpy(track_uv), torch.from_numpy(track_has)
    args = (seq.cam, 15, 2, BAOptions(**CHUNK_OPTS), 3.0)
    return tu, th, args, TV.solve_chunks(tu, th, *args)


@pytest.mark.parametrize("block", [1, 2, 3])
def test_solve_chunks_blocks_equal_whole(chunks30, block):
    tu, th, args, whole = chunks30
    assert tu.shape[0] == 4 and bool(whole[4].all())
    parts = [TV.solve_chunks(tu[i:i + block], th[i:i + block], *args) for i in range(0, 4, block)]
    for name, w, got in zip(("rot", "trans", "points", "has_pt", "ok", "init_pair"), whole, zip(*parts)):
        assert torch.equal(torch.cat(got), w), name


def test_solve_chunks_padded_with_empty_problems_equals_whole(chunks30):
    """The mesh's padding: two empty problems (zero tracks) after the four."""
    tu, th, args, whole = chunks30
    padded = TV.solve_chunks(torch.cat([tu, tu.new_zeros((2, *tu.shape[1:]))]),
                             torch.cat([th, th.new_zeros((2, *th.shape[1:]))]), *args)
    assert not padded[4][4:].any()
    for name, w, got in zip(("rot", "trans", "points", "has_pt", "ok", "init_pair"), whole, padded):
        assert torch.equal(got[:4], w), name
