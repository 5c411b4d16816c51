"""Plain greedy selection of the port against the JAX package's lax loop and
both Pallas kernels (interpret mode on the CPU).  Every output slot is
compared exactly: uv, response and validity."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_detector_tpu.kernels.detect import greedy_select_lax
from feature_detector_tpu.kernels.greedy_pallas import greedy_select_pallas, greedy_select_pallas_batch
from feature_detector_tpu_torch.kernels.detect import greedy_select_ref
from feature_detector_tpu_torch.kernels.greedy import greedy_select


def _assert_same(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w))


def _sparse(rng, shape, keep=0.3):
    m = rng.random(shape, np.float32)
    m[m < 1.0 - keep] = 0.0
    return m


def _ties(shape):
    m = np.zeros(shape, np.float32)
    m[5, 5] = m[5, 30] = m[20, 5] = m[20, 30] = 1.0
    m[10, 20] = m[10, 21] = 0.5  # equal neighbours inside one square
    return m


def _budget():
    m = np.zeros((40, 70), np.float32)
    m[10, 10] = 3.0
    m[12, 12] = 2.0  # suppressed by the first pick (radius 5)
    m[30, 50] = 1.0
    return m


def _signed(rng):
    """Negative entries and -0 beside positive ones: only values > 0 are taken."""
    m = rng.choice(np.float32([-3.0, -0.5, -0.0, 0.0, 0.25, 1.0]), (30, 50)).astype(np.float32)
    m[:10] = -np.abs(m[:10])  # rows of only negatives and -0
    return m


def _far_ties():
    """Equal maxima far apart in different rows and columns: row-major order
    decides (a later row at a smaller column loses to an earlier row)."""
    m = np.zeros((40, 70), np.float32)
    m[30, 2] = m[5, 65] = m[5, 40] = m[17, 0] = m[39, 69] = 2.0
    m[20, 30] = 1.0
    return m


CASES = {
    "random_sparse": lambda rng: (_sparse(rng, (60, 90)), 32, 32, 5),
    "random_dense_quantised": lambda rng: (np.round(rng.random((48, 80), np.float32) * 4) / 4, 24, 24, 3),
    "ties": lambda rng: (_ties((24, 48)), 6, 6, 3),
    "budget": lambda rng: (_budget(), 8, 1, 5),
    "exhaustion": lambda rng: (_budget(), 8, 8, 5),
    "empty": lambda rng: (np.zeros((30, 40), np.float32), 4, 4, 2),
    "n_stop_zero": lambda rng: (_sparse(rng, (30, 40)), 4, 0, 2),
    "radius_zero": lambda rng: (_sparse(rng, (20, 30)), 12, 12, 0),
    "signed_and_negative_zero": lambda rng: (_signed(rng), 40, 40, 2),
    "far_ties_row_major": lambda rng: (_far_ties(), 8, 8, 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ref_equals_lax_and_pallas(case):
    cand, picks, n_stop, radius = CASES[case](np.random.default_rng(7))
    got = greedy_select_ref(torch.from_numpy(cand), picks, n_stop, radius)
    lax = greedy_select_lax(jnp.asarray(cand), picks, jnp.int32(n_stop), radius)
    _assert_same(got, lax)
    pal = greedy_select_pallas(jnp.asarray(cand), picks, jnp.int32(n_stop), radius)
    _assert_same(got, pal)
    # The wrapper takes the plain version for a CPU tensor.
    _assert_same(greedy_select(torch.from_numpy(cand), picks, n_stop, radius), lax)


def test_batch_with_per_frame_n_stop_equals_pallas_batch_and_per_frame():
    rng = np.random.default_rng(3)
    maps = _sparse(rng, (5, 48, 80), keep=0.2)
    maps[3] = 0.0  # an empty frame stops at once
    maps[1, 10, 10:14] = 5.0  # ties in one row
    n_stop = np.array([16, 3, 0, 16, 9], np.int32)
    got = greedy_select_ref(torch.from_numpy(maps), 16, torch.from_numpy(n_stop), 5)
    want = greedy_select_pallas_batch(jnp.asarray(maps), 16, jnp.asarray(n_stop), 5)
    _assert_same(got, want)
    assert got[2].sum(axis=1).tolist() == [16, 3, 0, 0, 9]
    for i in range(5):
        one = greedy_select_lax(jnp.asarray(maps[i]), 16, jnp.int32(n_stop[i]), 5)
        _assert_same([g[i] for g in got], one)
        single = greedy_select_ref(torch.from_numpy(maps[i]), 16, int(n_stop[i]), 5)
        _assert_same(single, [g[i] for g in got])
    # A scalar n_stop applies to every frame.
    _assert_same(
        greedy_select(torch.from_numpy(maps), 16, 16, 5),
        greedy_select_pallas_batch(jnp.asarray(maps), 16, jnp.int32(16), 5),
    )


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        greedy_select(torch.zeros((4, 4), device="meta"), 2, 2, 1)
