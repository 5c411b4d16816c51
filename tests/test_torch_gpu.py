"""Tests of the port that need a CUDA card (marked ``gpu``); each skips
without one.  Run them on the card with

    python -m pytest -m gpu tests/test_torch_gpu.py

This file imports nothing of the JAX package, so it also runs where flax is
not installed; the card's results are held against the port's CPU path,
which the other tests/test_torch_*.py files hold against the JAX package.
"""

import numpy as np
import pytest
import torch

from feature_detector_tpu_torch.core.config import (DetectorOptions, FastOptions, LineDetectorOptions, NNDetectorOptions,
                                                    NNModelType)
from feature_detector_tpu_torch.core.types import Features
from feature_detector_tpu_torch.frontend.descriptor import compute_descriptors
from feature_detector_tpu_torch.frontend.detector import detect_good_features, detect_good_features_batch
from feature_detector_tpu_torch.frontend.line_detector import detect_good_lines, detect_good_lines_with_state
from feature_detector_tpu_torch.kernels import detect as KD
from feature_detector_tpu_torch.kernels import fixed_order as FO
from feature_detector_tpu_torch.kernels import lsd_flood as LF
from feature_detector_tpu_torch.kernels.detect import greedy_select_ref
from feature_detector_tpu_torch.kernels.fast import fast_maps
from feature_detector_tpu_torch.kernels.greedy import GREEDY_TILE, greedy_select
from feature_detector_tpu_torch.kernels.lsd import fit_lines, propagate_labels_meanangle
from feature_detector_tpu_torch.frontend.nn_detector import NNFeaturePointDetector, postprocess
from feature_detector_tpu_torch.match.float_matcher import FloatMatcherOptions, match_float
from feature_detector_tpu_torch.match.hamming import match_hamming
from feature_detector_tpu_torch.models.synth_data import scene_uint8, synth_scene, tile_edge_ties
from tests.torch_fast_cases import FAST_CARD_CASES, FAST_CASES, fast_case

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_greedy_kernel_equals_ref(cuda):
    rng = np.random.default_rng(1)
    maps = rng.random((6, 96, 150), np.float32)
    maps[maps < 0.7] = 0.0
    maps[:, 40, 10:20] = 2.0  # ties in a row
    maps[2] = 0.0
    n_stop = torch.tensor([40, 5, 40, 0, 40, 17], dtype=torch.int32, device=cuda)
    cand = torch.from_numpy(maps).to(cuda)
    before = greedy_select.launches
    got = greedy_select(cand, 40, n_stop, 6)
    torch.cuda.synchronize()
    assert greedy_select.launches == before + 2  # the key pass and the pick chains
    want = greedy_select_ref(cand, 40, n_stop, 6)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    one = greedy_select(cand[0], 40, 40, 6)
    for g, w in zip(one, want):
        assert torch.equal(g, w[0])
    assert torch.equal(cand.cpu(), torch.from_numpy(maps))  # the caller's map is untouched


def _tile_edge_ties(rng, signed_frame=None):
    return tile_edge_ties(rng, (3, 97, 151), GREEDY_TILE, signed_frame)


def _signed(rng, shape=(2, 97, 151)):
    """Negative values and -0 beside positive ones."""
    m = rng.choice(np.float32([-2.0, -0.0, 0.0, 0.25, 1.0]), shape).astype(np.float32)
    m[:, :50] = np.where(m[:, :50] > 0, -m[:, :50], m[:, :50])
    return m


# name: (maps [B, H, W], max_picks, n_stop per frame, radius)
GREEDY_SEAMS = {
    "tile_edge_ties_r20": lambda rng: (_tile_edge_ties(rng, signed_frame=1), 30, [30, 30, 30], 20),
    "radius_0": lambda rng: (_tile_edge_ties(rng), 40, [40, 40, 40], 0),
    "radius_1": lambda rng: (_tile_edge_ties(rng), 40, [40, 40, 40], 1),
    "radius_25_wider_than_a_tile": lambda rng: (_tile_edge_ties(rng), 40, [40, 40, 40], 25),
    "signed_and_negative_zero": lambda rng: (_signed(rng), 60, [60, 60], 3),
    "exhausted_and_n_stop_0": lambda rng: (_tile_edge_ties(rng), 40, [40, 0, 3], 20),
    # 1080x1920 keeps the pick chain's state in the global workspace, not in shared memory.
    "large_frame_global_workspace": lambda rng: (
        np.where(rng.random((1, 1080, 1920)) < 0.01, rng.random((1, 1080, 1920)), 0).astype(np.float32),
        30, [30], 20),
    "b64_main_path_size": lambda rng: (
        np.where(rng.random((64, 480, 752)) < 0.02, np.round(rng.random((64, 480, 752)) * 8) / 8, 0).astype(np.float32),
        200, [200] * 64, 20),
}


@pytest.mark.parametrize("case", sorted(GREEDY_SEAMS))
def test_greedy_kernel_seams_equal_ref(cuda, case):
    maps, picks, n_stop, radius = GREEDY_SEAMS[case](np.random.default_rng(11))
    cand = torch.from_numpy(maps).to(cuda)
    stop = torch.tensor(n_stop, dtype=torch.int32, device=cuda)
    before = greedy_select.launches
    got = greedy_select(cand, picks, stop, radius)
    one = greedy_select(cand[0], picks, n_stop[0], radius)
    torch.cuda.synchronize()
    assert greedy_select.launches == before + 4
    want = greedy_select_ref(cand, picks, stop, radius)
    for g, w, o in zip(got, want, one):
        assert torch.equal(g, w) and torch.equal(o, w[0])
    assert bool(want[2].any())


def test_greedy_wrapper_rejects_bad_input(cuda):
    with pytest.raises(TypeError):
        greedy_select(torch.zeros((8, 8), dtype=torch.float64, device=cuda), 2, 2, 1)
    with pytest.raises(ValueError):
        greedy_select(torch.zeros((8, 16), device=cuda).t(), 2, 2, 1)
    with pytest.raises(ValueError):
        greedy_select(torch.zeros((2, 8, 8), device=cuda), 2, torch.zeros(3, dtype=torch.int32, device=cuda), 1)


def _plain_fast(img, mask, sub, thr):
    full = torch.ones(img.shape[-2:], dtype=torch.int32, device=img.device) if mask is None else mask
    resp = KD.fast_response(img, full, sub)
    return KD.fast_candidates(resp, thr), resp


@pytest.mark.parametrize("case", sorted(FAST_CASES) + sorted(FAST_CARD_CASES))
def test_fast_kernel_equals_plain_chain(cuda, case):
    image, mask, sub, thr = fast_case(case)
    img = torch.from_numpy(image).to(cuda)
    m = None if mask is None else torch.from_numpy(mask).to(cuda)
    before = fast_maps.launches
    cand, resp = fast_maps(img, m, sub, thr, True)
    assert fast_maps.launches == before + 1
    cand_only, none = fast_maps(img, m, sub, thr, False)
    torch.cuda.synchronize()
    assert fast_maps.launches == before + 2 and none is None
    want_c, want_r = _plain_fast(img, m, sub, thr)
    assert torch.equal(resp, want_r) and torch.equal(cand, want_c) and torch.equal(cand_only, want_c)
    assert torch.equal(img.cpu(), torch.from_numpy(image))  # the caller's image is untouched


@pytest.mark.parametrize("cols", [752, 152, 151])
def test_fast_kernel_unaligned_rows_equal_plain_chain(cuda, cols):
    """Rows and frames off the 16-byte grid take the kernel's byte loads
    (an image at an odd address, 152 columns) and float stores (151)."""
    rng = np.random.default_rng(cols)
    frames = torch.from_numpy(rng.choice(np.uint8([84, 85, 100, 100, 115, 116]), (3, 50, cols))).to(cuda)
    for img in (frames, torch.empty(frames.numel() + 1, dtype=torch.uint8, device=cuda)[1:].view(frames.shape)):
        img.copy_(frames)
        cand, resp = fast_maps(img, None, FastOptions(), 9.0, True)
        want_c, want_r = _plain_fast(img, None, FastOptions(), 9.0)
        assert torch.equal(cand, want_c) and torch.equal(resp, want_r)
        assert bool((cand > 0).any())


def test_fast_wrapper_rejects_bad_input(cuda):
    img = torch.zeros((2, 20, 24), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        fast_maps(img.float(), None, FastOptions(), 10.0, False)
    with pytest.raises(ValueError):
        fast_maps(torch.zeros((2, 24, 20), dtype=torch.uint8, device=cuda).transpose(1, 2), None, FastOptions(), 10.0,
                  False)
    with pytest.raises(ValueError):
        fast_maps(img, torch.ones((20, 24), dtype=torch.int32), FastOptions(), 10.0, False)  # mask on the CPU
    with pytest.raises(ValueError):
        fast_maps(img, torch.ones((3, 20, 24), dtype=torch.int32, device=cuda), FastOptions(), 10.0, False)


def _fast_launches(fn):
    before = fast_maps.launches
    out = fn()
    return out, fast_maps.launches - before


def test_slice_on_card_equals_cpu(cuda):
    frames = np.stack([scene_uint8(synth_scene(np.random.default_rng(s), 120, 160, rich_background=True)[0])
                       for s in (20, 21, 22)])
    opts = DetectorOptions(min_feature_distance=10, min_valid_response=10.0, max_features=64)
    out = {}
    for dev in ("cpu", cuda):
        a = torch.from_numpy(frames).to(dev)
        b = torch.roll(a, 3, dims=2)
        fa, n_a = _fast_launches(lambda: detect_good_features_batch(a, "fast", 40, opts))
        fb, n_b = _fast_launches(lambda: detect_good_features_batch(b, "fast", 40, opts))
        da, db = compute_descriptors(a, fa), compute_descriptors(b, fb)
        m = match_hamming(da.words, da.valid, db.words, db.valid)
        existing = Features(fa.uv[0], fa.response[0], fa.valid[0] & (torch.arange(64, device=dev) < 5))
        inc, n_inc = _fast_launches(lambda: detect_good_features(b[0], existing, "fast", 40, opts))
        # One FAST launch a detect call on the card (csrc/fast.cu), none on the CPU.
        assert [n_a, n_b, n_inc] == ([1, 1, 1] if dev == cuda else [0, 0, 0])
        out[str(dev)] = [t.cpu() for t in (fa.uv, fa.valid, fb.uv, da.words, da.valid, db.words, m.index,
                                           m.distance, m.valid, inc.uv, inc.valid)]
    for g, w in zip(out["cuda"], out["cpu"]):
        assert torch.equal(g, w)
    assert int(out["cpu"][1].sum()) >= 30


TOL = LineDetectorOptions().min_tolerance_angle_residual_in_rad


def _flood_maps(device, seed=4, h=96, w=150, share=0.7, live=None):
    """Norms from three values (ties everywhere); angles near +-pi on the
    left half (wrapping) and near 0.4 on the right; ``share`` of the pixels
    valid, only inside the ``live`` mask when one is given."""
    rng = np.random.default_rng(seed)
    norm = rng.choice(np.float32([25.0, 30.0, 40.0]), (h, w)).astype(np.float32)
    valid = rng.random((h, w)) < share
    if live is not None:
        valid &= live
    angle = np.where(np.arange(w)[None, :] < w // 2, np.pi - 0.1, 0.4) + rng.uniform(-0.3, 0.3, (h, w))
    angle = np.where(angle > np.pi, angle - 2 * np.pi, angle)
    angle = np.where(valid, angle, 0.0).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (norm, angle, valid)]


def test_lsd_flood_kernel_equals_ref(cuda):
    norm, angle, valid = _flood_maps(cuda)
    state = LF.initial_state(norm, angle, valid)
    kept = [s.clone() for s in state]
    for n in (0, 1, 2, 7, 33):
        before = LF.propagate_running.launches
        got = LF.running_sweeps(angle, valid, state, n, TOL)
        torch.cuda.synchronize()
        assert LF.propagate_running.launches == before + -(-n // LF.SWEEPS_PER_LAUNCH)
        want = LF.running_sweeps_ref(angle, valid, state, n, TOL)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for s, k in zip(state, kept):
        assert torch.equal(s, k)  # the caller's state is untouched
    labels = LF.propagate_running(norm, angle, valid, 40, TOL)
    want = LF.labels_of(LF.running_sweeps_ref(angle, valid, state, 40, TOL)[1], valid)
    assert labels.dtype == torch.int32 and torch.equal(labels, want)
    assert len(torch.unique(labels[valid])) < int(valid.sum())


def test_kernels_on_every_card_equal_ref():
    """K1/K2, K3, K4 and K5 on cuda:3, cuda:0, cuda:2 and cuda:1 in one process:
    each ctypes library carries its own CUDA runtime and must launch on the
    card of the tensors it is given (the wrapper makes that card current),
    not on the first card it saw.  Equal to the plain version on every
    card.  Skips with fewer than four cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    rng = np.random.default_rng(3)
    maps = rng.random((4, 96, 150), np.float32)
    maps[maps < 0.7] = 0.0
    for i in (3, 0, 2, 1):
        dev = torch.device("cuda", i)
        cand = torch.from_numpy(maps).to(dev)
        got = greedy_select(cand, 40, 40, 6)
        torch.cuda.synchronize(dev)
        assert all(g.device == dev for g in got)
        for g, w in zip(got, greedy_select_ref(cand, 40, 40, 6)):
            assert torch.equal(g, w), f"greedy on {dev}"
        norm, angle, valid = _flood_maps(dev)
        state = LF.initial_state(norm, angle, valid)
        got = LF.running_sweeps(angle, valid, state, 33, TOL)
        torch.cuda.synchronize(dev)
        for g, w in zip(got, LF.running_sweeps_ref(angle, valid, state, 33, TOL)):
            assert torch.equal(g, w), f"flood on {dev}"
        for m, k, n in ((72, 1536, 72), (3, 3, 1)):
            a, c = (torch.from_numpy(x).to(dev) for x in _operands(rng, 5, m, k, n))
            got = FO.fixed_contract(a, c)
            assert got.device == dev and torch.equal(got, FO.contract_ref(a, c)), f"K4 on {dev}"
        a, b = (torch.from_numpy(x).to(dev) for x in _systems(rng, 5, 72))
        got = FO.fixed_lu_solve(a, b)
        assert got.device == dev and torch.equal(got, FO.lu_solve_ref(a, b)), f"K5 on {dev}"


# --------------------------------------------------------------------------
# K4 and K5: the chunk solver's fixed-order contraction and LU solve
# --------------------------------------------------------------------------

# (batch, M, K, N) of the fused VO's chunk solver on the bench's 17 chunks x 2 init pairs: the reduced camera
# system, a camera's diagonal block (and PnP's normal matrix), a landmark's block, the back-substitution, a rotation,
# the 8-point normal matrices of 64 RANSAC rounds
FIXED_CONTRACT_SHAPES = {"reduced_system": (34, 72, 1536, 72), "camera_block": (408, 6, 1024, 6),
                         "landmark_block": (17408, 3, 24, 3), "back_substitution": (34, 1536, 72, 1),
                         "rotation": (20000, 3, 3, 1), "weighted_normal": (34, 64, 512, 81)}
FIXED_SUM_SHAPES = {"cost": (34, 6144), "rows": (34 * 512 * 12, 2), "lanes_edge": (100, 17)}
FIXED_LU_SHAPES = {"refine": (272, 5), "pnp": (408, 6), "reduced_system": (34, 72)}


def _operands(rng, batch, m, k, n):
    return rng.standard_normal((batch, m, k)).astype(np.float32), rng.standard_normal((batch, k, n)).astype(np.float32)


def _systems(rng, batch, n):
    a = rng.standard_normal((batch, n, n)).astype(np.float32)
    a[:, np.arange(n), np.arange(n)] += np.float32(2 * n)
    if n > 1:
        a[:, [0, 1]] = a[:, [1, 0]]  # the pivot search has rows to swap
    return a, rng.standard_normal((batch, n)).astype(np.float32)


def _same(got, want) -> bool:
    """Bit for bit (the sign of a zero included), a NaN equal to a NaN."""
    bits = got.view(torch.int32) == want.view(torch.int32)
    return got.shape == want.shape and bool((bits | (got.isnan() & want.isnan())).all())


@pytest.mark.parametrize("name", sorted(FIXED_CONTRACT_SHAPES))
def test_fixed_contract_kernel_equals_ref(cuda, name):
    rng = np.random.default_rng(11)
    a, c = (torch.from_numpy(x).to(cuda) for x in _operands(rng, *FIXED_CONTRACT_SHAPES[name]))
    before = FO.fixed_contract.launches
    got = FO.fixed_contract(a, c)
    torch.cuda.synchronize()
    assert FO.fixed_contract.launches == before + 1
    assert _same(got, FO.contract_ref(a, c))
    # Strided and broadcast operands: a transposed view, and c shared by the batch.
    at = a.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert _same(FO.fixed_contract(at, c[:1]), FO.contract_ref(a, c[:1]))
    assert float((got.double() - a.double() @ c.double()).abs().max()) < 1e-2


# K on both sides of every step of K4's order (the serial bound 16, whole and partial 32-term steps, the staged
# chunk of 64 terms), up to the reduced system's 1536 and the cost's 6144.
FIXED_K = [1, 2, 16, 17, 31, 32, 33, 63, 64, 65, 1536, 6144]
# M x N that are no multiple of any register or block tile.
FIXED_MN = [(1, 1), (1, 72), (3, 3), (5, 5), (6, 6), (71, 73), (72, 72), (73, 71), (81, 1), (5, 81), (81, 81)]
# How each operand lies in memory: contiguous, transposed (the other axis contiguous), strided (every other
# element of a larger tensor), and broadcast (one problem for the whole batch, batch stride 0).
FIXED_LAYOUTS = ["contiguous", "transposed", "strided", "broadcast"]


def _laid_out(x, layout):
    """x [B, R, C] on the card as a view laid out as ``layout``; equal values."""
    if layout == "transposed":
        return x.transpose(-1, -2).contiguous().transpose(-1, -2)
    if layout == "strided":
        wide = torch.zeros((*x.shape[:-1], 2 * x.shape[-1]), dtype=x.dtype, device=x.device)
        wide[..., ::2] = x
        return wide[..., ::2]
    if layout == "broadcast":
        return x[:1].expand_as(x)
    return x


def _signed_operands(rng, batch, m, k, n):
    """Operands with exact zeros of both signs, so that a wrong fold or a
    dropped +0 term shows in the sign of a zero output."""
    a, c = _operands(rng, batch, m, k, n)
    a[..., ::3, :] = -0.0
    c[..., :, ::4] = 0.0
    return a, c


@pytest.mark.parametrize("k", FIXED_K)
def test_fixed_contract_every_k_equals_ref(cuda, k):
    rng = np.random.default_rng(100 + k)
    for batch, m, n in ((2, 72, 72), (3, 5, 5), (1, 3, 1)):
        a, c = (torch.from_numpy(x).to(cuda) for x in _signed_operands(rng, batch, m, k, n))
        got = FO.fixed_contract(a, c)
        torch.cuda.synchronize()
        assert _same(got, FO.contract_ref(a, c)), (batch, m, k, n)


@pytest.mark.parametrize("mn", FIXED_MN, ids=lambda mn: f"{mn[0]}x{mn[1]}")
def test_fixed_contract_every_tile_edge_equals_ref(cuda, mn):
    m, n = mn
    rng = np.random.default_rng(7 * m + n)
    for batch, k in ((2, 24), (1, 100), (3, 1536)):
        a, c = (torch.from_numpy(x).to(cuda) for x in _signed_operands(rng, batch, m, k, n))
        assert _same(FO.fixed_contract(a, c), FO.contract_ref(a, c)), (batch, m, k, n)


@pytest.mark.parametrize("a_layout", FIXED_LAYOUTS)
@pytest.mark.parametrize("c_layout", FIXED_LAYOUTS)
def test_fixed_contract_every_layout_equals_ref(cuda, a_layout, c_layout):
    """Every combination of operand layouts, at K on both paths: bit for bit,
    and one kernel a call (no copy first)."""
    rng = np.random.default_rng(len(a_layout) * 31 + len(c_layout))
    for batch, m, k, n in ((3, 72, 1536, 72), (4, 6, 40, 6), (5, 3, 24, 1), (4, 6, 3, 3)):
        a0, c0 = (torch.from_numpy(x).to(cuda) for x in _operands(rng, batch, m, k, n))
        a, c = _laid_out(a0, a_layout), _laid_out(c0, c_layout)
        before = FO.fixed_contract.launches
        got = FO.fixed_contract(a, c)
        torch.cuda.synchronize()
        assert FO.fixed_contract.launches == before + 1
        assert _same(got, FO.contract_ref(a.contiguous(), c.contiguous())), (batch, m, k, n)


def test_fixed_contract_broadcast_batch_axes_equal_ref(cuda):
    """Batch axes that broadcast and do not merge (the chunk solver's
    [17, 2, 512, 12] against [17, 2, 1, 12]-style operands): one kernel, the
    plain version's bits."""
    rng = np.random.default_rng(21)
    for sa, sc, k in (((2, 2, 5, 4), (2, 2, 1, 4), 40), ((2, 1, 5, 1), (1, 3, 1, 4), 3), ((4, 1, 3), (1, 5, 1), 17)):
        a = torch.from_numpy(rng.standard_normal((*sa, 6, k)).astype(np.float32)).to(cuda)
        c = torch.from_numpy(rng.standard_normal((*sc, k, 3)).astype(np.float32)).to(cuda)
        c = c.transpose(-1, -2).contiguous().transpose(-1, -2)
        before = FO.fixed_contract.launches
        got = FO.fixed_contract(a, c)
        torch.cuda.synchronize()
        assert FO.fixed_contract.launches == before + 1
        assert _same(got, FO.contract_ref(a, c))


def test_fixed_contract_nonfinite_operands_equal_ref(cuda):
    rng = np.random.default_rng(22)
    for k in (5, 40, 1536):
        a, c = _operands(rng, 2, 8, k, 8)
        a[0, 1, :3] = np.inf
        a[1, 2, 7 % k] = -np.inf
        c[0, :, 2] = 0.0  # inf x 0 = NaN
        c[1, 3 % k, 5] = np.nan
        a, c = torch.from_numpy(a).to(cuda), torch.from_numpy(c).to(cuda)
        got = FO.fixed_contract(a, c)
        assert _same(got, FO.contract_ref(a, c))
        assert not torch.isfinite(got).all()


def test_fixed_contract_one_kernel_a_call(cuda):
    """One call on the reduced system's operands, c not k-contiguous (as the
    chunk solver hands it) and a transposed: exactly one CUDA kernel."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(23)
    a, c = (torch.from_numpy(x).to(cuda) for x in _operands(rng, 34, 72, 1536, 72))
    a = a.transpose(-1, -2).contiguous().transpose(-1, -2)
    FO.fixed_contract(a, c)
    torch.cuda.synchronize()
    for _ in range(3):  # CUPTI now and then hands back an empty trace: take it again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            FO.fixed_contract(a, c)
            torch.cuda.synchronize()
        kernels = [e.name() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 1 and "contract_tiled" in kernels[0], kernels


@pytest.mark.parametrize("name", sorted(FIXED_SUM_SHAPES))
def test_fixed_sum_kernel_equals_ref(cuda, name):
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(FIXED_SUM_SHAPES[name]).astype(np.float32)).cuda()
    before = FO.fixed_contract.launches
    got = FO.fixed_sum(x)
    torch.cuda.synchronize()
    assert FO.fixed_contract.launches == before + 1
    assert _same(got, FO.sum_ref(x))
    # The same terms strided (the sum axis not contiguous): one launch, the same bits.
    xt = x.transpose(0, -1).contiguous().transpose(0, -1)
    assert _same(FO.fixed_sum(xt), got)
    assert FO.fixed_contract.launches == before + 2


@pytest.mark.parametrize("name", sorted(FIXED_LU_SHAPES))
def test_fixed_lu_solve_kernel_equals_ref(cuda, name):
    a, b = (torch.from_numpy(x).cuda() for x in _systems(np.random.default_rng(13), *FIXED_LU_SHAPES[name]))
    before = FO.fixed_lu_solve.launches
    got = FO.fixed_lu_solve(a, b)
    torch.cuda.synchronize()
    assert FO.fixed_lu_solve.launches == before + 1
    assert _same(got, FO.lu_solve_ref(a, b))
    want = torch.linalg.solve(a.double(), b.double())
    assert float((got.double() - want).abs().max()) < 1e-4


# n on both sides of the packed (n <= 32, several systems a warp) and the block design (n > 32), up to LU_MAX_N.
FIXED_LU_N = [1, 2, 5, 6, 7, 8, 32, 33, 72, 104]


def _tied_systems(rng, batch, n):
    """Small-integer systems: many pivot candidates of equal magnitude and
    opposite sign; column 0 of system 0 ties rows 1 and 2 above row 0."""
    a = rng.integers(-3, 4, (batch, n, n)).astype(np.float32)
    a[:, np.arange(n), np.arange(n)] += np.float32(n)
    if n >= 3:
        a[0, :3, 0] = (1.0, -(n + 5.0), n + 5.0)
    return a, rng.integers(-5, 6, (batch, n)).astype(np.float32)


@pytest.mark.parametrize("n", FIXED_LU_N)
def test_fixed_lu_solve_every_n_equals_ref(cuda, n):
    rng = np.random.default_rng(200 + n)
    for batch in (1, 3, 41):
        for make in (_systems, _tied_systems):
            a, b = (torch.from_numpy(x).cuda() for x in make(rng, batch, n))
            got = FO.fixed_lu_solve(a, b)
            torch.cuda.synchronize()
            assert _same(got, FO.lu_solve_ref(a, b)), (batch, n, make.__name__)
    # A transposed, broadcast a and a strided b: one launch, the same bits.
    a, b = (torch.from_numpy(x).cuda() for x in _systems(rng, 4, n))
    at = a[:1].transpose(-1, -2).contiguous().transpose(-1, -2).expand_as(a)
    bs = torch.stack([b, b], -1)[..., 0]
    before = FO.fixed_lu_solve.launches
    assert _same(FO.fixed_lu_solve(at, bs), FO.lu_solve_ref(a[:1].expand_as(a).contiguous(), b))
    assert FO.fixed_lu_solve.launches == before + 1


@pytest.mark.parametrize("n", [2, 6, 33, 72])
def test_fixed_lu_solve_nan_pivots_equal_ref(cuda, n):
    """NaN in a pivot column (a NaN is the largest; the first NaN wins), two
    NaNs in one column, a whole NaN row and an exactly singular system."""
    rng = np.random.default_rng(300 + n)
    a, b = _systems(rng, 5, n)
    a[0, n - 1, 0] = np.nan
    a[1, 1, 1], a[1, n - 1, 1] = np.nan, np.nan
    a[2, n // 2] = np.nan
    a[3, 1] = a[3, 0]
    a[4, :, n - 1] = -a[4, :, n - 1]
    a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    got = FO.fixed_lu_solve(a, b)
    torch.cuda.synchronize()
    assert _same(got, FO.lu_solve_ref(a, b))
    assert not torch.isfinite(got[:4]).all()


def test_fixed_lu_solve_kernel_singular(cuda):
    a = torch.tensor([[[1.0, 2.0], [2.0, 4.0]], [[0.0, 0.0], [0.0, 0.0]], [[float("nan"), 1.0], [1.0, 1.0]]]).cuda()
    got = FO.fixed_lu_solve(a, torch.ones(3, 2, device="cuda"))
    assert not torch.isfinite(got).all(-1).any()
    assert _same(got, FO.lu_solve_ref(a, torch.ones(3, 2, device="cuda")))


@pytest.mark.parametrize("block", [5, 1])
def test_fixed_kernels_on_card_blocks_equal_whole(cuda, block):
    """17 problems in blocks of ``block`` against the whole batch, at the
    reduced system's shapes: the same bits."""
    rng = np.random.default_rng(14)
    a, c = (torch.from_numpy(x).cuda() for x in _operands(rng, 17, 72, 1536, 72))
    s, rhs = (torch.from_numpy(x).cuda() for x in _systems(rng, 17, 72))
    x = torch.from_numpy(rng.standard_normal((17, 6144)).astype(np.float32)).cuda()
    whole = FO.fixed_contract(a, c), FO.fixed_sum(x), FO.fixed_lu_solve(s, rhs)
    for i in range(0, 17, block):
        part = (FO.fixed_contract(a[i:i + block], c[i:i + block]), FO.fixed_sum(x[i:i + block]),
                FO.fixed_lu_solve(s[i:i + block], rhs[i:i + block]))
        for p, w in zip(part, whole):
            assert torch.equal(p, w[i:i + block])


def test_solve_chunks_on_card_blocks_equal_whole(cuda):
    """The bench's 17 chunk problems (chip_smoke.py's VO sequence, the
    card's front-end) solved whole, in blocks of 5 and of 1, and padded to
    20 with empty problems: the same bits."""
    import chip_smoke as CS
    from feature_detector_tpu_torch.slam.sequence import make_synthetic_sequence
    from feature_detector_tpu_torch.slam.vo_fused import solve_chunks

    seq = make_synthetic_sequence(n_frames=CS.VO_FRAMES, n_landmarks=CS.VO_LANDMARKS, seed=CS.VO_SEED,
                                  motion="lateral", angle_step=0.03)
    track_uv, track_has, args, _, _ = CS.vo_chunk_problems(torch, seq, torch.from_numpy(seq.images).cuda())
    tu, th = torch.from_numpy(track_uv).cuda(), torch.from_numpy(track_has).cuda()
    assert tu.shape[0] == 17
    whole = solve_chunks(tu, th, *args)
    pu = torch.cat([tu, tu.new_zeros((3, *tu.shape[1:]))])
    ph = torch.cat([th, th.new_zeros((3, *th.shape[1:]))])
    for block in (5, 1):
        parts = [solve_chunks(pu[i:i + block], ph[i:i + block], *args) for i in range(0, 20, block)]
        for w, got in zip(whole, zip(*parts)):
            assert torch.equal(torch.cat(got)[:17], w), block


def _few_live_tiles(h=130, w=200):
    """Valid pixels in three 32-px tiles (one across a tile edge), every other
    tile all invalid."""
    live = np.zeros((h, w), bool)
    live[32:64, 64:96] = live[96:130, 160:200] = live[10:50, 140:150] = True
    return live


FLOOD_GRIDS = {
    "few_live_tiles": lambda dev: _flood_maps(dev, seed=6, h=130, w=200, live=_few_live_tiles()),
    "fully_valid": lambda dev: _flood_maps(dev, seed=7, h=40, w=50, share=1.0),
    "ragged_97x151": lambda dev: _flood_maps(dev, seed=8, h=97, w=151),
}


@pytest.mark.parametrize("grid", sorted(FLOOD_GRIDS))
def test_lsd_flood_tiles_equal_ref(cuda, grid):
    """Every plane bit for bit at sweep counts around the sweeps per launch
    k, with ceil(n / k) launches."""
    norm, angle, valid = FLOOD_GRIDS[grid](cuda)
    state = LF.initial_state(norm, angle, valid)
    k = LF.SWEEPS_PER_LAUNCH
    for n in (0, 1, k - 1, k, k + 1, 33, 330):
        before = LF.propagate_running.launches
        got = LF.running_sweeps(angle, valid, state, n, TOL)
        torch.cuda.synchronize()
        assert LF.propagate_running.launches == before + -(-n // k)
        want = LF.running_sweeps_ref(angle, valid, state, n, TOL)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (grid, n)


def test_lsd_flood_wrapper_rejects_bad_input(cuda):
    a = torch.zeros((8, 8), device=cuda)
    v = torch.ones((8, 8), dtype=torch.bool, device=cuda)
    st = LF.initial_state(a, a, v)
    with pytest.raises(TypeError):
        LF.running_sweeps(a.double(), v, st, 1, TOL)
    with pytest.raises(TypeError):
        LF.running_sweeps(a, v, (st[0], st[1].long(), st[2], st[3]), 1, TOL)
    with pytest.raises(ValueError):
        LF.running_sweeps(a[:4], v, st, 1, TOL)
    with pytest.raises(ValueError):
        LF.running_sweeps(a, v.cpu(), st, 1, TOL)
    with pytest.raises(ValueError):
        LF.running_sweeps(a.t(), v, st, 1, TOL)


def test_lines_on_card_agree_with_cpu(cuda):
    """As chip_smoke.py: the angle maps within a few ulps; the CPU's plain
    flood fed the card's maps gives the card's labels; the CPU's fit of
    those labels gives the card's lines within 1e-3 px; two card runs are
    identical."""
    opts = LineDetectorOptions()
    for seed in (20, 21):
        frame = torch.from_numpy(scene_uint8(synth_scene(np.random.default_rng(seed), 120, 160, rich_background=True)[0]))
        card = detect_good_lines_with_state(frame.to(cuda), opts)
        cpu = detect_good_lines_with_state(frame, opts)
        assert torch.equal(card.valid.cpu(), cpu.valid) and torch.equal(card.norm.cpu(), cpu.norm)
        assert float((card.angle.cpu() - cpu.angle).abs().max()) <= 5e-7
        maps = [t.cpu() for t in (card.norm, card.angle, card.valid)]
        labels = propagate_labels_meanangle(*maps, opts)
        assert torch.equal(labels, card.labels.cpu())
        ends, line_valid, _ = fit_lines(labels, *maps, tuple(frame.shape), opts)
        assert torch.equal(line_valid, card.lines.valid.cpu()) and int(line_valid.sum()) >= 1
        assert float((ends - card.lines.endpoints.cpu()).abs().max()) <= 1e-3
        again = detect_good_lines(frame.to(cuda), 10, opts)
        assert torch.equal(again.endpoints, card.lines.endpoints) and torch.equal(again.valid, card.lines.valid)


@pytest.mark.parametrize("model_type", list(NNModelType), ids=lambda t: t.name.lower())
def test_nn_detect_on_card_equals_cpu_postprocess(cuda, model_type):
    """As chip_smoke.py's NN phase at 128x160: two greedy launches per
    detect call; the CPU post-processing fed the card's maps gives the
    card's features exactly and its descriptors within 1e-6; an
    incremental call keeps the prefix."""
    opts = NNDetectorOptions(max_image_rows=128, max_image_cols=160, model_type=model_type)
    det = NNFeaturePointDetector(opts)
    det.initialize()
    frame = torch.from_numpy(scene_uint8(synth_scene(np.random.default_rng(23), 128, 160, rich_background=True)[0]))
    heat, desc_map = det.maps(frame.to(cuda))
    before = greedy_select.launches
    feats, descs = postprocess(heat, desc_map, Features.empty(240, cuda), opts)
    torch.cuda.synchronize()
    assert greedy_select.launches == before + 2
    cpu_feats, cpu_descs = postprocess(heat.cpu(), desc_map.cpu(), Features.empty(240, "cpu"), opts)
    for k in ("uv", "response", "valid"):
        assert torch.equal(getattr(feats, k).cpu(), getattr(cpu_feats, k))
    assert float((descs.cpu() - cpu_descs).abs().max()) <= 1e-6
    assert int(feats.count) >= 5 and bool(torch.isfinite(descs).all())
    n = int(feats.count) // 2
    keep = torch.arange(240, device=cuda) < n
    existing = Features(feats.uv * keep[:, None], feats.response * keep, feats.valid & keep)
    before = greedy_select.launches
    inc, _ = det.detect(torch.roll(frame, 3, dims=1).to(cuda), existing)
    torch.cuda.synchronize()
    assert greedy_select.launches == before + 2
    assert torch.equal(inc.uv[:n], existing.uv[:n]) and bool(inc.valid[:n].all())


@pytest.mark.parametrize("kw", [{}, {"metric": "l2", "ratio": 0.8}, {"cross_check": False, "min_similarity": 0.5}],
                         ids=["cosine", "l2_ratio", "no_cross_check"])
def test_match_float_on_card_equals_cpu(cuda, kw):
    rng = np.random.default_rng(9)
    a = rng.normal(size=(240, 128)).astype(np.float32)
    b = np.concatenate([a[:150] + 0.3 * rng.normal(size=(150, 128)), rng.normal(size=(90, 128))]).astype(np.float32)
    b[200] = b[3]  # a tie: the lower index wins on both devices
    va, vb = np.arange(240) % 7 != 0, np.arange(240) % 11 != 0
    out = {}
    for dev in ("cpu", cuda):
        m = match_float(torch.from_numpy(a).to(dev), torch.from_numpy(va).to(dev), torch.from_numpy(b).to(dev),
                        torch.from_numpy(vb).to(dev), FloatMatcherOptions(**kw))
        out[str(dev)] = [t.cpu() for t in (m.index, m.distance, m.valid)]
    assert torch.equal(out["cuda"][0], out["cpu"][0]) and torch.equal(out["cuda"][2], out["cpu"][2])
    assert torch.allclose(out["cuda"][1], out["cpu"][1], atol=2e-6, rtol=0)
    assert int(out["cpu"][2].sum()) >= 50


def test_superglue_on_card_within_the_cells_limits(cuda):
    """The first query of ``superglue.query16`` (seed 5) against its scene's
    16 views: 16 pairs at capacity 1,024 from SuperPoint on the card, the
    bf16 program against the float32 reference pair by pair, within the
    cell's limits on the log-assignment's gap, the matches equal but for
    near ties, and the iteration counter at 100 a call."""
    from bench_cuda import frames, harness
    from bench_cuda.pipelines import sp_superglue as pipe
    from bench_cuda.reference import superglue as ref_sg
    from feature_detector_tpu_torch.core.config import SuperGlueOptions
    from feature_detector_tpu_torch.match.superglue import SuperGlueMatcher
    from feature_detector_tpu_torch.models.superglue import SuperGlue
    from feature_detector_tpu_torch.models.weights import init_superglue_state
    from feature_detector_tpu_torch.utils import trace

    cfg = harness.load_config(harness.load_benchmark(), "superpoint_superglue_752x480")
    d, sg_cfg, seed = cfg["detector"], cfg["superglue"], 5
    det = NNFeaturePointDetector(NNDetectorOptions(
        max_image_rows=480, max_image_cols=752, max_number_of_detected_features=d["max_number_of_detected_features"],
        min_feature_distance=d["min_feature_distance"], min_response=d["min_response"],
        model_type=NNModelType.SUPERPOINT_NMS, compute_descriptors=True), device=cuda)
    det.initialize()
    db_frames, queries = pipe.query_layout(frames.load_mix("query16", harness.ROOT), seed, 480, 752, cuda)
    views = [det.detect(f) for f in db_frames[0]]
    db = Features(*(torch.stack([getattr(f, k) for f, _ in views]) for k in ("uv", "response", "valid")))
    db_desc = torch.stack([x for _, x in views])
    qf, qd = det.detect(queries[0])
    state = init_superglue_state(SuperGlue(), torch.Generator().manual_seed(seed))
    sg = SuperGlueMatcher(SuperGlueOptions(), device=cuda)
    sg.initialize(state)
    zs = []
    sg.model.register_forward_hook(lambda mod, args, out: zs.append(out))
    before = trace.counters().get("superglue.sinkhorn_iterations", 0)
    out = sg.match_batch(qf, qd, db, db_desc)
    assert trace.counters()["superglue.sinkhorn_iterations"] - before == 100
    tensors = ref_sg.to_device(state, cuda)
    v = qf.valid
    rows = torch.cat([torch.nonzero(v)[:, 0], torch.tensor([1024], device=cuda)])
    gaps, sizes, entries, matched = [], [], 0, 0
    for j in range(16):
        dv = db.valid[j]
        cols = torch.cat([torch.nonzero(dv)[:, 0], torch.tensor([1024], device=cuda)])
        want = ref_sg.forward(tensors, sg_cfg, 480, 752, qf.uv[v], qf.response[v], qd[v], db.uv[j][dv],
                              db.response[j][dv], db_desc[j][dv])
        got = zs[0][j][rows][:, cols]
        gaps.append(float((got - want).abs().mean()))
        sizes.append(got.numel())
        entries += got.numel()
        index, near = ref_sg.select(got.cpu().numpy(), sg_cfg["match_threshold"])
        assert ((out.index[j][v].cpu().numpy() != index) & ~near).sum() == 0
        assert not bool(out.valid[j][~v].any())
        matched += int((index >= 0).sum())
    pooled = sum(g * n for g, n in zip(gaps, sizes)) / entries
    assert int(v.sum()) >= 500 and matched >= 100
    assert pooled <= pipe.ASSIGN_ERR_LIMIT and max(gaps) <= pipe.ASSIGN_PAIR_LIMIT, gaps


# --------------------------------------------------------------------------
# The fused chunked VO (slam/)
# --------------------------------------------------------------------------

VO_BA_POSE_ATOL = 1e-4  # global BA (solved in float64), card against CPU: rotations, centers / span
VO_BA_POINT_ATOL = 1e-3  # points / span


def _vo_sequence(n_frames):
    from feature_detector_tpu_torch.slam.sequence import make_synthetic_sequence

    return make_synthetic_sequence(n_frames=n_frames, n_landmarks=300, seed=3, motion="lateral", angle_step=0.03)


def _harris_near_threshold(image, uv, thr, rel=1e-4):
    """Whether each (x, y) of ``uv`` sits on a pixel of ``image`` whose raw
    Harris response is within ``rel`` of the threshold ``thr``."""
    from feature_detector_tpu_torch.core.config import HarrisOptions
    from feature_detector_tpu_torch.kernels.detect import harris_response_raw

    raw = harris_response_raw(torch.from_numpy(image).to(torch.float32), HarrisOptions()).numpy()
    x = np.clip(uv[:, 0].astype(np.int64), 0, image.shape[1] - 1)
    y = np.clip(uv[:, 1].astype(np.int64), 0, image.shape[0] - 1)
    return np.abs(raw[y, x] - thr) <= rel * thr


@pytest.mark.parametrize("kind", ["harris", "fast"])
def test_scan_frontend_on_card_equals_cpu(cuda, kind):
    """Features, words, validity and carry links equal.  Harris: a
    difference is allowed only at a feature whose response sits at the
    threshold, and then the later frames (fed by the carry step) are not
    compared.  FAST: integer responses leave no such tie, so every frame is
    equal, and each frame's maps come from K6 (frame 0 one launch, every
    later frame two: the carry step's response map and the top-up)."""
    from feature_detector_tpu_torch.core.config import BriefOptions
    from feature_detector_tpu_torch.slam.sequence import scan_frontend

    seq = _vo_sequence(6)
    thr = {"harris": 20.0, "fast": 10.0}[kind]
    det = DetectorOptions(min_feature_distance=10, min_valid_response=thr, max_features=256, subpixel=True)
    out = {}
    for dev in ("cpu", cuda):
        fast_maps.launches = 0
        f, w, v, l = scan_frontend(torch.from_numpy(seq.images).to(dev), kind, 200, det, BriefOptions(upright=True))
        out[str(dev)] = [t.cpu().numpy() for t in (f.uv, f.response, f.valid, w, v)] + [l.cpu().numpy()]
        out[str(dev) + "_fast_launches"] = fast_maps.launches
    card, cpu = out["cuda"], out["cpu"]
    for fr in range(len(seq.images)):
        differ = ((card[0][fr] != cpu[0][fr]).any(-1) | (card[1][fr] != cpu[1][fr]) | (card[2][fr] != cpu[2][fr])
                  | (card[3][fr] != cpu[3][fr]).any(-1) | (card[4][fr] != cpu[4][fr]))
        if fr > 0:
            differ |= card[5][fr - 1] != cpu[5][fr - 1]
        if kind == "fast":
            assert not differ.any(), f"frame {fr}"
        elif differ.any():
            uv = np.concatenate([card[0][fr][differ], cpu[0][fr][differ]])
            assert _harris_near_threshold(seq.images[fr], uv, det.min_valid_response).all()
            break
    assert int(cpu[2].sum()) == 6 * 200
    assert out["cpu_fast_launches"] == 0
    assert out["cuda_fast_launches"] == (1 + 2 * 5 if kind == "fast" else 0)
    if kind == "fast":
        assert (cpu[5] >= 0).sum() > 0  # the carry step kept some features


@pytest.fixture(scope="module")
def vo13_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from feature_detector_tpu_torch.slam.sequence import run_visual_odometry_chunked

    seq = _vo_sequence(13)
    greedy_select.launches = 0
    res = run_visual_odometry_chunked(torch.from_numpy(seq.images).cuda(), seq.cam)
    torch.cuda.synchronize()
    return seq, res, greedy_select.launches


def test_vo_on_card_within_3pct_of_span(vo13_on_card):
    from feature_detector_tpu_torch.slam.evaluate import ate_rmse

    seq, res, _ = vo13_on_card
    pos = res.trajectory.positions
    assert pos.shape == (13, 3) and np.isfinite(pos).all()
    span = float(np.linalg.norm(np.ptp(seq.trajectory.positions, 0)))
    assert float(ate_rmse(pos, seq.trajectory.positions, with_scale=True)) < 0.03 * span


def test_vo_launches_k2_twice_a_frame(vo13_on_card):
    assert vo13_on_card[2] == 2 * 13


def test_global_ba_on_card_equals_cpu(vo13_on_card):
    import inspect

    from feature_detector_tpu_torch.slam.ba import BAProblem, ba_solve
    from feature_detector_tpu_torch.slam.vo_fused import run_visual_odometry_fused

    seq, res, _ = vo13_on_card
    opts = inspect.signature(run_visual_odometry_fused).parameters["ba_opts"].default
    card = ba_solve(res.problem, seq.cam, opts)
    cpu = ba_solve(BAProblem(*[x.cpu() for x in res.problem]), seq.cam, opts)
    span = float(np.linalg.norm(np.ptp(seq.trajectory.positions, 0)))
    centers = lambda p: -torch.einsum("fji,fj->fi", p.rot.cpu(), p.trans.cpu())
    assert float((card.rot.cpu() - cpu.rot).abs().max()) <= VO_BA_POSE_ATOL
    assert float((centers(card) - centers(cpu)).abs().max()) <= VO_BA_POSE_ATOL * span
    has = (res.problem.obs_cam.cpu() >= 0).sum(1) >= 2
    assert float((card.points.cpu() - cpu.points)[has].abs().max()) <= VO_BA_POINT_ATOL * span


# --------------------------------------------------------------------------
# Multi-device paths (parallel/, make_distributed_ba, the VO's mesh) on an
# NCCL world of one, started in this process
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from feature_detector_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cuda")
    assert dist.get_backend() == "nccl"
    yield mesh
    dist.destroy_process_group()


def test_batched_frontend_world_of_one_equals_batch(card_mesh):
    from feature_detector_tpu_torch.kernels.brief import brief_compute
    from feature_detector_tpu_torch.parallel.frontend import make_batched_frontend

    frames = torch.from_numpy(np.stack([scene_uint8(synth_scene(np.random.default_rng(s), 120, 160, True)[0])
                                        for s in range(4)])).cuda()
    opts = DetectorOptions(min_feature_distance=10, min_valid_response=10.0, max_features=64)
    greedy_select.launches = 0
    feats, words, dvalid = make_batched_frontend(card_mesh, "fast", 40, opts)(frames)
    torch.cuda.synchronize()
    assert greedy_select.launches == 2  # one batched selection: K1's two launches
    want = detect_good_features_batch(frames, "fast", 40, opts)
    want_w, want_v = brief_compute(frames, want.uv, want.valid)
    for got, ref in ((feats.uv, want.uv), (feats.valid, want.valid), (words, want_w), (dvalid, want_v)):
        assert torch.equal(got, ref)
    assert int(feats.valid.sum()) > 20


def test_row_sharded_response_world_of_one_equals_whole(card_mesh):
    from feature_detector_tpu_torch.kernels.detect import harris_response
    from feature_detector_tpu_torch.parallel.frontend import make_row_sharded_response
    from feature_detector_tpu_torch.parallel.mesh import make_mesh

    space = make_mesh((1,), ("space",), device="cuda")
    image = torch.from_numpy(scene_uint8(synth_scene(np.random.default_rng(9), 240, 320, True)[0])).cuda()
    mask = torch.ones(image.shape, dtype=torch.int32, device="cuda")
    opts = DetectorOptions(min_valid_response=30.0)
    got = make_row_sharded_response(space, "harris", opts)(image, mask)
    assert torch.equal(got, harris_response(image, mask, opts))


def test_distributed_ba_world_of_one_on_card(card_mesh, vo13_on_card):
    """Dense: equal to ba_solve bit for bit (each all-reduce of a world of
    one is the identity).  Camera-sharded CG: the same cost within 1%."""
    import inspect

    from feature_detector_tpu_torch.core.config import BAOptions
    from feature_detector_tpu_torch.slam.ba import ba_solve, make_distributed_ba, reprojection_cost
    from feature_detector_tpu_torch.slam.vo_fused import run_visual_odometry_fused

    seq, res, _ = vo13_on_card
    opts = inspect.signature(run_visual_odometry_fused).parameters["ba_opts"].default
    want = ba_solve(res.problem, seq.cam, opts)
    got = make_distributed_ba(card_mesh, seq.cam, opts)(res.problem)
    for f in ("rot", "trans", "points"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    cg = make_distributed_ba(card_mesh, seq.cam, opts, camera_shard=True)(res.problem)
    cost = lambda p: float(reprojection_cost(p, seq.cam, BAOptions(huber_delta=1e9)))
    assert abs(cost(cg) - cost(want)) <= 1e-2 * cost(want)


def test_vo_over_a_mesh_of_one_equals_one_device(card_mesh, vo13_on_card):
    from feature_detector_tpu_torch.slam.sequence import run_visual_odometry_chunked

    seq, res, _ = vo13_on_card
    greedy_select.launches = 0
    got = run_visual_odometry_chunked(torch.from_numpy(seq.images).cuda(), seq.cam, mesh=card_mesh)
    torch.cuda.synchronize()
    assert greedy_select.launches == 2 * 13
    np.testing.assert_array_equal(got.trajectory.positions, res.trajectory.positions)


# --------------------------------------------------------------------------
# Training and its tooling on the card
# --------------------------------------------------------------------------

TRAIN_LOSS_RTOL = 1e-5  # tests/test_torch_train.py
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-4, 1e-6
CARD_GRAD_SCALE_TOL = 2e-4
ROUNDING_FACTOR = 2.0  # tests/test_torch_train.py
ZERO_GRAD_SHARE = 1e-6  # tests/test_torch_train.py's ROUNDING_SHARE


def _train_step_grads(model_name, device, dtype=torch.float32, seed=0):
    """One step of ``make_train_step`` from ``init_state(seed)`` (float32
    parameters, computed in ``dtype``) on a 64x80 batch of two: (loss, aux,
    gradients by name in float64 on the CPU)."""
    from feature_detector_tpu_torch.models import train_disk, train_superpoint
    from feature_detector_tpu_torch.models.disk import Disk
    from feature_detector_tpu_torch.models.superpoint import SuperPoint
    from feature_detector_tpu_torch.models.synth_data import make_batch
    from feature_detector_tpu_torch.models.weights import init_state

    cls, module = (SuperPoint, train_superpoint) if model_name == "superpoint" else (Disk, train_disk)
    model = init_state(cls(dtype=dtype), torch.Generator().manual_seed(seed)).to(device)
    batch = make_batch(np.random.default_rng(seed), 2, 64, 80, rich_background=model_name == "disk")
    loss, aux = module.make_train_step(model, train_superpoint.adam(model, 1e-3))(batch)
    return float(loss), {k: float(v) for k, v in aux.items()}, {n: p.grad.double().cpu() for n, p in model.named_parameters()}


def _elements_close(got, want) -> bool:
    return bool(((got - want).abs() <= TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * want.abs()).all())


@pytest.mark.parametrize("model_name", ["superpoint", "disk"])
def test_train_step_on_card_equals_cpu(cuda, model_name, monkeypatch):
    """The card's first step against the CPU's on the same batch and
    parameters, TF32 off, with two witnesses that the card computes the
    CPU's function:

    - float64 compute, card against CPU: every gradient element within rtol
      1e-4 / atol 1e-6;
    - float32 with cuDNN off (PyTorch's own CUDA convolutions): every element
      within the same tolerance of the float64 gradient;
    - float32 through cuDNN, as training runs: the loss within rtol 1e-5;
      each gradient element within rtol 1e-4 / atol 1e-6 of the CPU's, or
      else the parameter's largest distance from the float64 gradient at
      most ROUNDING_FACTOR times the CPU's float32 one or CARD_GRAD_SCALE_TOL
      of its largest element.  cuDNN's float32 weight gradient of DISK's
      5x5 head reads 7.5e-5 from float64 (9.4e-5 of its largest element)
      with the default and the deterministic algorithms alike,
      where cuDNN off reads 4.2e-7 and the CPU 6.0e-7; SuperPoint's conv1b
      reads 2.5e-4 of its largest on the card and the CPU alike (8.6e-6);
      a gradient that is 0 in exact arithmetic (``normalised_biases``)
      within ZERO_GRAD_SHARE of the total gradient norm on both.
    ``-s`` prints each reading (its relative worst parameter leaves out
    those zero-gradient biases)."""
    from feature_detector_tpu_torch.models.disk import Disk, normalised_biases

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    _, _, cpu64 = _train_step_grads(model_name, "cpu", torch.float64)
    _, _, card64 = _train_step_grads(model_name, cuda, torch.float64)
    with monkeypatch.context() as m:
        m.setattr(torch.backends.cudnn, "enabled", False)
        _, _, plain32 = _train_step_grads(model_name, cuda)
    with monkeypatch.context() as m:
        m.setattr(torch.backends.cudnn, "deterministic", True)
        _, _, det32 = _train_step_grads(model_name, cuda)
    loss, aux, grads = _train_step_grads(model_name, cuda)
    cpu_loss, cpu_aux, cpu_grads = _train_step_grads(model_name, "cpu")
    far = lambda g: {n: float((g[n] - cpu64[n]).abs().max()) for n in cpu64}
    scale = {n: float(r.abs().max()) for n, r in cpu64.items()}
    zero = normalised_biases(Disk()) if model_name == "disk" else set()
    worst = lambda d: max(set(d) - zero, key=lambda n: d[n] / scale[n])
    far_card, far_cpu = far(grads), far(cpu_grads)
    for what, d in (("card float64", far(card64)), ("card float32, cuDNN off", far(plain32)),
                    ("card float32, cuDNN", far_card), ("card float32, cuDNN deterministic", far(det32)),
                    ("CPU float32", far_cpu)):
        n = worst(d)
        print(f"{model_name} {what}: from the CPU's float64 at most {max(d.values()):.3g}; relative worst {n} "
              f"{d[n]:.3g} on a largest {scale[n]:.3g}")

    for name, want in cpu64.items():
        assert _elements_close(card64[name], want), f"float64 {name}"
        assert _elements_close(plain32[name], want), f"float32 with cuDNN off {name}"
    np.testing.assert_allclose(loss, cpu_loss, rtol=TRAIN_LOSS_RTOL)
    for k in aux:
        np.testing.assert_allclose(aux[k], cpu_aux[k], rtol=TRAIN_LOSS_RTOL)
    total = float(torch.sqrt(sum((g * g).sum() for g in cpu_grads.values())))
    for name, want in cpu_grads.items():
        got = grads[name]
        if name in zero:
            assert max(float(got.abs().max()), float(want.abs().max())) <= ZERO_GRAD_SHARE * total, name
        elif not _elements_close(got, want):
            bound = max(ROUNDING_FACTOR * far_cpu[name], CARD_GRAD_SCALE_TOL * scale[name])
            assert far_card[name] <= bound, f"{name}: {far_card[name]} from float64 (CPU {far_cpu[name]}) on a " \
                f"largest gradient of {scale[name]}"


def test_checkpoint_round_trip_onto_cuda(cuda, tmp_path):
    from feature_detector_tpu_torch.utils.checkpoint import CheckpointManager, restore_pytree, save_pytree

    tree = {"w": torch.randn(3, 4, device=cuda), "b": torch.ones(4, dtype=torch.bfloat16, device=cuda),
            "step": torch.tensor(7, dtype=torch.int32), "host": np.arange(3.0)}
    path = str(tmp_path / "ckpt")
    save_pytree(path, tree)
    back = restore_pytree(path, template=tree)
    assert back["w"].is_cuda and back["b"].is_cuda and not back["step"].is_cuda
    assert torch.equal(back["w"], tree["w"]) and back["b"].dtype == torch.bfloat16
    on_cpu = restore_pytree(path, template={**tree, "w": tree["w"].cpu(), "b": tree["b"].cpu()})
    assert not on_cpu["w"].is_cuda and torch.equal(on_cpu["w"], tree["w"].cpu())
    assert not restore_pytree(path)["w"].is_cuda  # no template: as stored, on the CPU
    with CheckpointManager(str(tmp_path / "mgr"), max_to_keep=1) as mgr:
        mgr.save(5, tree)
        assert mgr.restore(tree)["w"].device == tree["w"].device


def test_save_image_without_pil(monkeypatch, tmp_path):
    """The standard-library PNG path (the card's host has no PIL), forced
    here, read back by ``read_png``."""
    from feature_detector_tpu_torch.io import images

    monkeypatch.setattr(images, "_HAVE_PIL", False)
    for arr in (np.arange(35, dtype=np.uint8).reshape(5, 7), np.random.default_rng(0).integers(0, 256, (6, 4, 3))):
        path = str(tmp_path / "x.png")
        images.save_image(path, arr)
        assert np.array_equal(images.read_png(path), np.asarray(arr, np.uint8))


# --------------------------------------------------------------------------
# The legacy short-window VO on the card
# --------------------------------------------------------------------------


def _arc5():
    from feature_detector_tpu_torch.slam.sequence import make_synthetic_sequence

    return make_synthetic_sequence(n_frames=5, n_landmarks=140, seed=7)  # tests/test_sequence.py:172-173


def test_incremental_frontend_on_card_equals_cpu(cuda):
    """``run_incremental_frontend`` (steered BRIEF, the legacy VO's detector
    options): features, words, validity and links equal to the CPU's; a
    difference is allowed only at a feature whose Harris response sits at
    the threshold, and then the later frames are not compared."""
    from feature_detector_tpu_torch.core.config import BriefOptions
    from feature_detector_tpu_torch.slam.sequence import run_incremental_frontend

    seq = _arc5()
    det = DetectorOptions(min_feature_distance=10, min_valid_response=20.0, max_features=256, subpixel=True)
    out = {}
    for dev in ("cpu", cuda):
        f, w, v, links = run_incremental_frontend(torch.from_numpy(seq.images).to(dev), "harris", 200, det,
                                                  BriefOptions())
        out[str(dev)] = [t.cpu().numpy() for t in (f.uv, f.response, f.valid, w, v)] + [[m for _, _, m in links]]
    card, cpu = out["cuda"], out["cpu"]
    for fr in range(len(seq.images)):
        differ = ((card[0][fr] != cpu[0][fr]).any(-1) | (card[1][fr] != cpu[1][fr]) | (card[2][fr] != cpu[2][fr])
                  | (card[3][fr] != cpu[3][fr]).any(-1) | (card[4][fr] != cpu[4][fr]))
        if fr > 0:
            differ |= card[5][fr - 1] != cpu[5][fr - 1]
        if differ.any():
            uv = np.concatenate([card[0][fr][differ], cpu[0][fr][differ]])
            assert _harris_near_threshold(seq.images[fr], uv, det.min_valid_response).all()
            break
    assert all((m >= 0).sum() >= 15 for m in cpu[5])


@pytest.mark.parametrize("incremental", [True, False], ids=["incremental", "batch"])
def test_legacy_vo_on_card(cuda, incremental):
    """The 5-frame arc (tests/test_sequence.py:175-192): ATE under 0.05 m;
    K2 twice a frame on the incremental front-end, K1 once (two launches)
    on the batch one."""
    from feature_detector_tpu_torch.slam.evaluate import ate_rmse
    from feature_detector_tpu_torch.slam.sequence import run_visual_odometry_chunked

    seq = _arc5()
    greedy_select.launches = 0
    res = run_visual_odometry_chunked(torch.from_numpy(seq.images).to(cuda), seq.cam, legacy=True,
                                      incremental=incremental)
    torch.cuda.synchronize()
    assert greedy_select.launches == (2 * 5 if incremental else 2)
    assert res.num_tracks > 20 and np.isfinite(res.trajectory.positions).all()
    assert float(ate_rmse(res.trajectory.positions, seq.trajectory.positions, with_scale=True)) < 0.05


# --------------------------------------------------------------------------
# The card against the numpy oracles (feature_detector_tpu_torch/oracle)
# --------------------------------------------------------------------------

ORACLE_OPTS = {  # the main path's FAST options; Harris and Shi-Tomasi at tests/test_detectors.py's thresholds
    "fast": DetectorOptions(min_feature_distance=20, min_valid_response=10.0, max_features=256),
    "harris": DetectorOptions(min_feature_distance=20, min_valid_response=30.0, max_features=256),
    "shi_tomasi": DetectorOptions(min_feature_distance=20, min_valid_response=40.0, max_features=256),
}


def _scene(seed, rows=480, cols=752):
    return scene_uint8(synth_scene(np.random.default_rng(seed), rows, cols, rich_background=True)[0])


@pytest.mark.parametrize("kind", sorted(ORACLE_OPTS))
def test_detect_on_card_equals_oracle(cuda, kind):
    """752x480: FAST through the whole oracle; Harris and Shi-Tomasi through
    the oracle's NMS and selection fed the card's response map (the
    oracle's float32 cumulative box sums lose digits over a whole 752x480
    frame), and through the whole oracle on 120x160 tiles."""
    from feature_detector_tpu_torch.frontend.detector import _default_sub
    from feature_detector_tpu_torch.kernels import detect as KD
    from feature_detector_tpu_torch.oracle import detectors as OD

    img = _scene(sorted(ORACLE_OPTS).index(kind))
    opts, sub = ORACLE_OPTS[kind], _default_sub(kind)
    got = detect_good_features(torch.from_numpy(img).to(cuda), Features.empty(256, cuda), kind, 200, opts).to_numpy()[0]
    ones = np.ones(img.shape, np.int32)
    if kind == "fast":
        want = OD.detect_good_features(img, 200, kind, opts, sub)
    else:
        respond = KD.harris_response if kind == "harris" else KD.shi_tomasi_response
        resp = respond(torch.from_numpy(img).to(cuda), torch.from_numpy(ones).to(cuda), opts, sub).cpu().numpy()
        want = OD.select_good_features(*OD.nms4_candidates(resp, opts.min_valid_response, sub.half_patch_size + 1),
                                       ones, 200, opts.min_feature_distance)
    np.testing.assert_array_equal(got, np.asarray(want, np.float32).reshape(-1, 2))
    for r0, c0 in ((0, 0), (120, 160), (240, 320), (360, 592)):
        tile = np.ascontiguousarray(img[r0:r0 + 120, c0:c0 + 160])
        got_t = detect_good_features(torch.from_numpy(tile).to(cuda), Features.empty(256, cuda), kind, 50,
                                     opts).to_numpy()[0]
        np.testing.assert_array_equal(got_t, np.asarray(OD.detect_good_features(tile, 50, kind, opts, sub),
                                                        np.float32).reshape(-1, 2))


def test_greedy_on_card_equals_oracle_selection(cuda):
    """K1 at B = 8 and K2 against ``select_good_features`` on the FAST
    candidates of 8 scenes at 752x480 (200 picks, r = 20)."""
    from feature_detector_tpu_torch.kernels import detect as KD
    from feature_detector_tpu_torch.oracle import detectors as OD

    frames = torch.from_numpy(np.stack([_scene(s) for s in range(8)])).to(cuda)
    cand = KD.fast_candidates(KD.fast_response(frames, torch.ones((480, 752), dtype=torch.int32, device=cuda)), 10.0)
    uv, _, valid = greedy_select(cand, 200, 200, 20)
    uv1, _, valid1 = greedy_select(cand[0], 200, 200, 20)
    cand_np = cand.cpu().numpy()
    ones = np.ones((480, 752), np.int32)
    for b in range(8):
        ys, xs = np.nonzero(cand_np[b] > 0)
        want = np.asarray(OD.select_good_features(cand_np[b][ys, xs], np.stack([xs, ys], -1), ones, 200, 20),
                          np.float32).reshape(-1, 2)
        np.testing.assert_array_equal(uv[b][valid[b]].cpu().numpy(), want)
        if b == 0:
            np.testing.assert_array_equal(uv1[valid1].cpu().numpy(), want)


def _brief_near_tie(image, uv, i, j, opts):
    """The BRIEF oracle's two reads of test j at feature i within 0.05."""
    from feature_detector_tpu_torch.oracle import brief as OB

    x, y = float(uv[i][0]), float(uv[i][1])
    d = np.arange(-opts.half_patch_size, opts.half_patch_size + 1, dtype=np.float32)
    dxg, dyg = np.meshgrid(d, d, indexing="xy")
    vals = OB.bilinear(image, y + dyg, x + dxg)
    m10, m01 = float((dxg * vals).sum()), float((dyg * vals).sum())
    st, ct = m01 / np.hypot(m10, m01), m10 / np.hypot(m10, m01)
    p = OB.BRIEF_PATTERN[j].astype(np.float32)
    v1 = OB.bilinear(image, st * p[0] + ct * p[1] + y, ct * p[0] - st * p[1] + x)
    v2 = OB.bilinear(image, st * p[2] + ct * p[3] + y, ct * p[2] - st * p[3] + x)
    return abs(float(v1) - float(v2)) < 0.05


def _steer_bin_boundary(image, uv, bins=30):
    """Features whose steering angle sits within 1e-4 of a bin boundary."""
    img = image.astype(np.int64)
    d = np.arange(-8, 9)
    out = np.zeros(len(uv), bool)
    xs = np.clip(np.round(uv[:, 0]).astype(np.int64), 18, image.shape[1] - 19)  # the clip of kernels/brief.py
    ys = np.clip(np.round(uv[:, 1]).astype(np.int64), 18, image.shape[0] - 19)
    for i, (x, y) in enumerate(zip(xs, ys)):
        p = img[y - 8:y + 9, x - 8:x + 9]
        t = np.arctan2((p * d[:, None]).sum(), (p * d[None, :]).sum()) * bins / (2 * np.pi)
        out[i] = abs(abs(t - np.floor(t)) - 0.5) < 1e-4
    return out


@pytest.mark.parametrize("method", ["mxu", "gather"])
def test_brief_on_card_equals_oracle(cuda, method):
    """Default BRIEF against the binned oracle (a feature at a steering-bin
    boundary excused), gather BRIEF against the bilinear one (near-ties of
    the two reads excused); at most max(2, 0.5%) of the bits either way."""
    from feature_detector_tpu_torch.core.config import BriefOptions
    from feature_detector_tpu_torch.core.types import words_to_numpy
    from feature_detector_tpu_torch.oracle import brief as OB

    img = _scene(0)
    uv = detect_good_features(torch.from_numpy(img).to(cuda), Features.empty(256, cuda), "fast", 200,
                              ORACLE_OPTS["fast"]).to_numpy()[0]
    opts = BriefOptions(method=method)
    d = compute_descriptors(torch.from_numpy(img).to(cuda), Features.from_numpy(uv, 256, device=cuda), opts)
    want_bits, want_valid = (OB.compute_binned if method == "mxu" else OB.compute)(img, uv, opts)
    words = words_to_numpy(d.words)[: len(uv)]
    mism = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")[:, :opts.length] != want_bits
    np.testing.assert_array_equal(d.valid.cpu().numpy()[: len(uv)], want_valid)
    if method == "mxu":
        assert not mism[~_steer_bin_boundary(img, uv)].any()
    else:
        assert all(_brief_near_tie(img, uv, i, j, opts) for i, j in zip(*np.nonzero(mism)))
    assert mism.sum() <= max(2, 0.005 * mism.size) and len(uv) > 20


def test_lsd_angle_map_on_card_equals_oracle(cuda):
    """Validity and norms equal; angles within two float32 ulps at pi (the
    card's atan2 against numpy's, as against the CPU's)."""
    from feature_detector_tpu_torch.kernels.lsd import line_level_angle_map
    from feature_detector_tpu_torch.oracle import lsd as OL

    img = _scene(1)
    opts = LineDetectorOptions()
    gn, ga, gv = (x.cpu().numpy() for x in line_level_angle_map(torch.from_numpy(img).to(cuda), opts))
    wn, wa, wv = OL.line_level_angle_map(img, opts)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gn, wn)
    assert float(np.abs(ga - wa).max()) <= 5e-7


def test_lines_on_card_match_oracle(cuda):
    """The bars of tests/test_lsd.py:49-60: every oracle line within 4 px of
    a detected one, counts within [0.5x, 2x + 1]."""
    from feature_detector_tpu_torch.oracle import lsd as OL

    img = np.full((120, 160), 30, np.uint8)
    img[20:24, 10:150] = 220
    img[40:110, 80:84] = 220
    for i in range(60):
        img[30 + i, 10 + i:14 + i] = 220
    want = np.asarray(OL.detect_lines(img, LineDetectorOptions()), np.float32)
    segs = detect_good_lines(torch.from_numpy(img).to(cuda), 10, LineDetectorOptions()).to_numpy()
    for w in want:
        dist = [min(max(np.hypot(*(w[:2] - g[:2])), np.hypot(*(w[2:] - g[2:]))),
                    max(np.hypot(*(w[:2] - g[2:])), np.hypot(*(w[2:] - g[:2])))) for g in segs]
        assert min(dist) < 4.0
    assert 0.5 * len(want) <= len(segs) <= 2 * len(want) + 1


def test_nn_heatmap_selection_on_card_equals_oracle(cuda):
    """SuperPoint's heatmap (packaged weights, bf16, 640x480) selected on
    the card equals ``nn_postproc.select_features`` on the same map."""
    from feature_detector_tpu_torch.frontend.nn_detector import select_features_from_heatmap
    from feature_detector_tpu_torch.oracle import nn_postproc as ON

    opts = NNDetectorOptions(max_image_rows=480, max_image_cols=640, model_type=NNModelType.SUPERPOINT_HEATMAP)
    det = NNFeaturePointDetector(opts, device=cuda)
    det.initialize()
    heat, _ = det.maps(torch.from_numpy(_scene(0, 480, 640)).to(cuda))
    got = select_features_from_heatmap(heat, Features.empty(opts.max_number_of_detected_features, cuda),
                                       opts).to_numpy()[0]
    want = np.asarray(ON.select_features(heat.float().cpu().numpy(), [], opts), np.float32).reshape(-1, 2)
    np.testing.assert_array_equal(got, want)
    assert len(got) > 5
