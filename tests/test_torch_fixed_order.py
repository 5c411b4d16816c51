"""The order of operations of K4 (``fixed_contract``, ``fixed_sum``) and K5
(``fixed_lu_solve``), pinned by a numpy emulation written independently of
torch and of ``kernels/fixed_order.py``: the emulation's float32 bits must
equal the plain versions' (``contract_ref``, ``sum_ref``, ``lu_solve_ref``),
which the card's kernels equal bit for bit (``tests/test_torch_gpu.py``,
``chip_smoke.py``).  A redesign of the kernels cannot drift from the order
without failing here or on the card.

The emulation, in numpy float32 (one rounding an operation, no FMA):

- K4 over K terms t_k: K <= 16, acc = t_0 then acc += t_k in order; K > 16,
  partial p = t_p, then += t_{p + 32 s} for s = 1 .. ceil(K / 32) - 1, a
  term past K being +0, then the partials fold: p += p + 16, 8, 4, 2, 1.
- K5: for each column j, the pivot is the first row at or below j of
  largest |a_ij| (a NaN is the largest, the first NaN wins), rows j and p
  swap (with b), then every row i > j updates a_ik -= (a_ij / a_jj) a_jk
  over k > j and b_i -= (a_ij / a_jj) b_j; back substitution from the last
  column: x_j /= a_jj, x_i -= a_ij x_j for i < j.

Everything is compared bit for bit: the sign of a zero counts, a NaN equals
a NaN.  Shapes: the chunk solver's calls at batch 1-2, and the edges of the
order (K on both sides of 16, 32, 64), at sizes that run in seconds.
"""

import numpy as np
import pytest
import torch

from feature_detector_tpu_torch.kernels import fixed_order as FO

F32 = np.float32
SERIAL_MAX_K, LANES = 16, 32  # the order's constants, restated: a change to either must fail here


def np_order(term, k: int):
    """K4's tree over terms ``term(i)`` (float32 arrays), i < k."""
    if k <= SERIAL_MAX_K:
        acc = term(0)
        for i in range(1, k):
            acc = acc + term(i)
        return acc
    zero = np.zeros_like(term(0))  # +0
    at = lambda i: term(i) if i < k else zero
    steps = -(-k // LANES)
    partials = []
    for p in range(LANES):
        acc = at(p)
        for s in range(1, steps):
            acc = acc + at(p + LANES * s)
        partials.append(acc)
    h = LANES // 2
    while h:
        partials = [partials[p] + partials[p + h] for p in range(h)]
        h //= 2
    return partials[0]


def np_contract(a: np.ndarray, c: np.ndarray) -> np.ndarray:
    with np.errstate(all="ignore"):
        return np_order(lambda i: a[..., :, i, None] * c[..., None, i, :], a.shape[-1])


def np_sum(x: np.ndarray) -> np.ndarray:
    with np.errstate(all="ignore"):
        return np_order(lambda i: x[..., i], x.shape[-1])


def np_pivot(col: np.ndarray) -> int:
    """The first index of largest magnitude; a NaN is the largest, the
    first NaN wins."""
    p, best = 0, abs(col[0])
    for i in range(1, len(col)):
        v = abs(col[i])
        if not np.isnan(best) and (np.isnan(v) or v > best):
            p, best = i, v
    return p


def np_lu_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    n = a.shape[-1]
    batch = np.broadcast_shapes(a.shape[:-2], b.shape[:-1])
    mats = np.broadcast_to(a, (*batch, n, n)).reshape(-1, n, n)
    rhs = np.broadcast_to(b, (*batch, n)).reshape(-1, n)
    out = np.empty_like(rhs)
    with np.errstate(all="ignore"):
        for s in range(len(mats)):
            m, x = mats[s].copy(), rhs[s].copy()
            for j in range(n):
                p = j + np_pivot(m[j:, j])
                m[[j, p]], x[[j, p]] = m[[p, j]], x[[p, j]]
                for i in range(j + 1, n):
                    l = m[i, j] / m[j, j]
                    m[i, j + 1:] = m[i, j + 1:] - l * m[j, j + 1:]
                    x[i] = x[i] - l * x[j]
            for j in range(n - 1, -1, -1):
                x[j] = x[j] / m[j, j]
                x[:j] = x[:j] - m[:j, j] * x[j]
            out[s] = x
    return out.reshape(*batch, n)


def same_bits(got, want) -> bool:
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    if got.shape != want.shape:
        return False
    return bool(((got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))).all())


def ref_contract(a, c):
    return FO.contract_ref(torch.from_numpy(a), torch.from_numpy(c)).numpy()


def operands(rng, batch, m, k, n):
    return rng.standard_normal((batch, m, k)).astype(F32), rng.standard_normal((batch, k, n)).astype(F32)


# (batch, M, K, N) of the chunk solver's calls (the census of a VO run), at batch 1-2: the reduced system, a
# camera's block, a landmark's block, the back-substitution, the weighted 8-point normal matrix, PnP's
# rows, a rotation.
CENSUS_CONTRACT = {"reduced_system": (2, 72, 1536, 72), "camera_block": (2, 6, 1024, 6),
                   "landmark_block": (2, 3, 24, 3), "back_substitution": (1, 1536, 72, 1),
                   "weighted_normal": (1, 64, 512, 81), "pnp_rows": (2, 5, 1024, 5), "rotation": (2, 3, 3, 3),
                   "camera_rows": (2, 6, 3, 3)}
CENSUS_SUM = {"cost": (2, 6144), "rows": (3, 2), "frames": (4, 12), "landmarks": (2, 512), "lanes_edge": (5, 17)}
CENSUS_LU = {"refine": (2, 5), "pnp": (2, 6), "reduced_system": (2, 72)}
EDGE_K = [1, 2, 16, 17, 31, 32, 33, 64, 65]


@pytest.mark.parametrize("name", sorted(CENSUS_CONTRACT))
def test_contract_order_equals_plain(name):
    a, c = operands(np.random.default_rng(1), *CENSUS_CONTRACT[name])
    assert same_bits(np_contract(a, c), ref_contract(a, c))


@pytest.mark.parametrize("k", EDGE_K)
def test_contract_order_edges_equal_plain(k):
    """Signed zeros, ±inf and NaN operands at K on both sides of each step
    of the order."""
    rng = np.random.default_rng(10 + k)
    a, c = operands(rng, 2, 5, k, 4)
    a[0, 0] = -0.0  # every term of row 0 is ±0
    a[0, 1, ::2] = 0.0
    c[1, :, 0] = -0.0
    a[1, 2, k // 2] = np.inf
    c[1, k - 1, 1] = -np.inf
    c[0, 0, 3] = np.nan
    a[1, 4, 0] = -np.inf
    c[1, 0, 2] = 0.0  # -inf x 0 = NaN
    assert same_bits(np_contract(a, c), ref_contract(a, c))


@pytest.mark.parametrize("k", EDGE_K)
def test_contract_negative_zero_outputs(k):
    """A row of -0 against positive columns: every term is -0.  The serial
    order keeps -0; the lanes keep it only when K fills whole steps, since a
    term past K is +0 and -0 + +0 is +0."""
    a = np.full((1, 2, k), -0.0, F32)
    c = np.ones((1, k, 3), F32)
    want_negative = k <= SERIAL_MAX_K or k % LANES == 0
    got = np_contract(a, c)
    assert bool(np.all(got == 0)) and bool(np.all(np.signbit(got) == want_negative))
    assert same_bits(got, ref_contract(a, c))


@pytest.mark.parametrize("name", sorted(CENSUS_SUM))
def test_sum_order_equals_plain(name):
    x = np.random.default_rng(2).standard_normal(CENSUS_SUM[name]).astype(F32)
    assert same_bits(np_sum(x), FO.sum_ref(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("k", EDGE_K)
def test_sum_order_edges_equal_plain(k):
    rng = np.random.default_rng(20 + k)
    x = rng.standard_normal((4, k)).astype(F32)
    x[0] = -0.0
    x[1, k // 2] = np.inf
    x[2, 0], x[2, -1] = np.inf, -np.inf
    x[3, k - 1] = np.nan
    got = np_sum(x)
    assert same_bits(got, FO.sum_ref(torch.from_numpy(x)).numpy())
    assert bool(np.signbit(got[0])) == (k <= SERIAL_MAX_K or k % LANES == 0)


def systems(rng, batch, n):
    a = rng.standard_normal((batch, n, n)).astype(F32)
    a[:, np.arange(n), np.arange(n)] += F32(2 * n)
    if n > 1:
        a[:, [0, 1]] = a[:, [1, 0]]
    return a, rng.standard_normal((batch, n)).astype(F32)


def ref_lu(a, b):
    return FO.lu_solve_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()


@pytest.mark.parametrize("name", sorted(CENSUS_LU))
def test_lu_order_equals_plain(name):
    a, b = systems(np.random.default_rng(3), *CENSUS_LU[name])
    assert same_bits(np_lu_solve(a, b), ref_lu(a, b))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 33])
def test_lu_order_ties_equal_plain(n):
    """Small-integer systems, so that many pivot candidates tie in
    magnitude with opposite signs; the first (lower) row must win."""
    rng = np.random.default_rng(30 + n)
    a = rng.integers(-2, 3, (4, n, n)).astype(F32)
    b = rng.integers(-3, 4, (4, n)).astype(F32)
    if n >= 3:
        a[0, :3, 0] = (1.0, -4.0, 4.0)  # rows 1 and 2 tie above row 0
        a[1, :, 0] = 0.0  # a zero column: the first row is the pivot, the system singular
    assert same_bits(np_lu_solve(a, b), ref_lu(a, b))


def test_lu_tie_picks_the_first_row():
    """Opposite-sign ties choose differently with different bits: the first
    row at or below the diagonal is the pivot (the reference's argmax)."""
    a = np.array([[[1.0, 3.0, 1.0], [-4.0, 1.0, 2.0], [4.0, 1.0, 1.0 / 3.0]]], F32)
    b = np.array([[1.0, 0.1, 0.7]], F32)
    assert np_pivot(a[0, :, 0]) == 1
    swapped = a[:, [0, 2, 1]], b[:, [0, 2, 1]]  # the same system with the tied rows in the other order
    assert same_bits(np_lu_solve(a, b), ref_lu(a, b))
    assert same_bits(np_lu_solve(*swapped), ref_lu(*swapped))


@pytest.mark.parametrize("n", [2, 5, 6])
def test_lu_order_nan_pivots_equal_plain(n):
    """A NaN in a pivot column (the largest), two NaNs in one column (the
    first wins), a NaN row, an exactly singular system and ±inf."""
    rng = np.random.default_rng(40 + n)
    a, b = systems(rng, 5, n)
    a[0, n - 1, 0] = np.nan
    a[1, 0, 1], a[1, n - 1, 1] = np.nan, np.nan
    a[2, n // 2] = np.nan
    a[3, 1] = a[3, 0]
    a[4, 0, n - 1] = np.inf
    assert np_pivot(np.array([1.0, np.nan, 5.0, np.nan], F32)) == 1
    got = np_lu_solve(a, b)
    assert same_bits(got, ref_lu(a, b))
    assert not np.isfinite(got[:4]).all()


def test_lu_order_broadcast_equals_plain():
    rng = np.random.default_rng(50)
    a, b = systems(rng, 1, 6)
    b = rng.standard_normal((3, 6)).astype(F32)
    assert same_bits(np_lu_solve(a, b), ref_lu(a, b))


def _offsets(shape, strides):
    """Each operand's element offset of every batch index, row-major."""
    idx = np.indices(shape).reshape(len(shape), int(np.prod(shape)))
    return [np.tensordot(np.asarray(st, np.int64), idx, 1) for st in strides]


def _merged_offsets(sizes, merged, count):
    flat = np.arange(count)
    out = [np.zeros(count, np.int64) for _ in merged]
    for axis in range(len(sizes) - 1, -1, -1):
        r, flat = flat % sizes[axis], flat // sizes[axis]
        for o, st in zip(out, merged):
            o += r * st[axis]
    return out


# (batch shape, one stride tuple per operand): the chunk solver's broadcast batches (a stride 0 between
# strided axes), a transposed batch, contiguous batches that merge whole, size-1 axes.
LAYOUTS = [((4, 2, 512, 12), (216, 108, 0, 9), (3072, 1536, 3, 0)),
           ((4, 2, 12, 512), (3072, 1536, 0, 3), (216, 108, 9, 0)),
           ((4, 2, 8), (80, 40, 5), (16, 8, 1)),
           ((17, 2, 512, 158), (1941504, 970752, 1896, 12), (0, 0, 0, 0)),
           ((3, 1, 5), (5, 99, 1), (0, 7, 0)),
           ((2, 3), (1, 2), (3, 1)),
           ((1, 1), (4, 4), (0, 0)),
           ((), (), ())]


@pytest.mark.parametrize("case", range(len(LAYOUTS)))
def test_batch_layout_keeps_every_offset(case):
    """The wrapper's merge of batch axes addresses every problem of every
    operand where the unmerged view does, in the output's row-major order."""
    shape, *strides = LAYOUTS[case]
    sizes, merged = FO.batch_layout(shape, *strides)
    count = int(np.prod(shape))
    assert int(np.prod(sizes)) == count and len(sizes) <= FO.MAX_BATCH_DIMS
    for want, got in zip(_offsets(shape, strides), _merged_offsets(sizes, merged, count)):
        assert np.array_equal(want, got)
    assert len(sizes) <= len([s for s in shape if s != 1])


def test_batch_layout_merges_contiguous_and_broadcast_axes():
    assert FO.batch_layout((4, 2, 8), (80, 40, 5), (16, 8, 1)) == ([64], [[5], [1]])
    assert FO.batch_layout((4, 2, 512, 12), (216, 108, 0, 9), (3072, 1536, 3, 0)) == \
        ([8, 512, 12], [[108, 0, 9], [1536, 3, 0]])


def _decode(params: bytes, head: int):
    """A launch's parameters as csrc/fixed_order.cu reads them: (head values,
    batch sizes, the two operands' batch strides)."""
    values = list(np.frombuffer(params, np.int64))
    nd = int(values[head])
    axes = values[head + 1:]
    m = FO.MAX_BATCH_DIMS
    return values[:head], axes[:nd], axes[m:m + nd], axes[2 * m:2 * m + nd]


@pytest.mark.parametrize("case", ["broadcast", "transposed"])
def test_contract_plan_addresses_every_problem(case):
    """K4's launch parameters, decoded, address each problem's operands
    where torch's broadcast view does, with no copy: the expanded views'
    batch offsets, in the output's row-major order."""
    if case == "broadcast":
        a, c = torch.zeros(2, 1, 5, 6, 40), torch.zeros(1, 3, 5, 40, 3).transpose(-1, -2).contiguous().transpose(-1, -2)
    else:
        a, c = torch.zeros(4, 40, 6).transpose(-1, -2), torch.zeros(40, 3)
    out_shape, params = FO._contract_plan(a.shape, a.stride(), c.shape, c.stride())
    batch = torch.broadcast_shapes(a.shape[:-2], c.shape[:-2])
    assert out_shape == (*batch, 6, 3)
    head, sizes, sa, sc = _decode(params, 8)
    assert head == [int(np.prod(batch)), 6, 3, 40, *a.stride()[-2:], *c.stride()[-2:]]
    ea, ec = a.expand(*batch, 6, 40), c.expand(*batch, 40, 3)
    count = int(np.prod(batch))
    want = _offsets(tuple(batch), [ea.stride()[:-2], ec.stride()[:-2]])
    for w, g in zip(want, _merged_offsets(sizes, [sa, sc], count)):
        assert np.array_equal(w, g)


def test_sum_and_solve_plans_address_every_problem():
    x = torch.zeros(3, 4, 5, 12).transpose(0, 2)  # [5, 4, 3, 12], the output axes not mergeable
    head, sizes, sx, _ = _decode(FO._sum_plan(x.shape, x.stride()), 8)
    n_batch, m, n, k, sam, sak = head[:6]
    assert (m, n, k, sak) == (3, 1, 12, x.stride(-1)) and sam == x.stride(2) and n_batch == 20
    want = _offsets((5, 4), [x.stride()[:2]])[0]
    assert np.array_equal(_merged_offsets(sizes, [sx], 20)[0], want)
    a, b = torch.zeros(1, 6, 6), torch.zeros(7, 6)[::2]
    out_shape, params = FO._solve_plan(a.shape, a.stride(), b.shape, b.stride())
    head, sizes, sa, sb = _decode(params, 5)
    assert out_shape == (4, 6) and head == [4, 6, 6, 1, 1] and sizes == [4] and sa == [0] and sb == [12]
