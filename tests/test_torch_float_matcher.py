"""The port's float-descriptor matcher against the JAX package's on the CPU:
cosine and L2, ratio test, cross-check on and off, invalid rows and tied
similarities.  Indices and validity are compared exactly; distances within
2e-6 (the port forms the similarities as a float64 product rounded once,
JAX as a float32 product)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_detector_tpu.match.float_matcher import FloatMatcherOptions as JOptions
from feature_detector_tpu.match.float_matcher import match_float as jax_match_float
from feature_detector_tpu_torch.match.float_matcher import FloatMatcherOptions, match_float

DIST_ATOL = 2e-6


def _descs(rng, n, d=64):
    return rng.normal(size=(n, d)).astype(np.float32)


def _pair(rng, na=48, nb=40, d=64, noise=0.3):
    """B holds noisy copies of part of A, shuffled, plus distractors; not
    normalised (the matcher normalises)."""
    a = _descs(rng, na, d)
    b = _descs(rng, nb, d)
    src = rng.permutation(na)[: nb // 2]
    b[: nb // 2] = a[src] * rng.uniform(0.5, 2.0) + noise * _descs(rng, nb // 2, d)
    return a, b[rng.permutation(nb)]


def _ties(rng):
    """Duplicated rows in B (equal similarities: the lower index wins) and
    duplicated rows in A (the cross-check keeps only the first)."""
    a, b = _pair(rng, 24, 20)
    b[7] = b[3]
    b[12] = b[3]
    a[5] = a[2]
    a[9] = b[3] * 4.0  # equal cosine to three B rows
    return a, b


def _invalid(n, stride, offset=0):
    v = np.ones(n, bool)
    v[offset::stride] = False
    return v


# name: (inputs from rng, valid_a, valid_b, options kwargs)
CASES = {
    "cosine_cross_check": (_pair, None, None, {}),
    "cosine_no_cross_check": (_pair, None, None, {"cross_check": False}),
    "cosine_min_similarity": (_pair, None, None, {"min_similarity": 0.6}),
    "l2_max_distance": (_pair, None, None, {"metric": "l2", "max_distance": 0.9, "cross_check": False}),
    "l2_ratio_cross_check": (_pair, None, None, {"metric": "l2", "ratio": 0.8}),
    "cosine_ratio_no_cross_check": (_pair, None, None, {"ratio": 0.7, "cross_check": False}),
    "invalid_rows": (_pair, _invalid(48, 3), _invalid(40, 4, 1), {"ratio": 0.9}),
    "no_valid_b": (_pair, None, np.zeros(40, bool), {}),
    "tied_similarities": (_ties, None, None, {}),
    "tied_similarities_no_cross_check": (_ties, None, None, {"cross_check": False, "ratio": 0.95}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_match_float_equals_jax(case):
    make, valid_a, valid_b, kw = CASES[case]
    a, b = make(np.random.default_rng(4))
    valid_a = np.ones(len(a), bool) if valid_a is None else valid_a
    valid_b = np.ones(len(b), bool) if valid_b is None else valid_b
    want = jax_match_float(jnp.asarray(a), jnp.asarray(valid_a), jnp.asarray(b), jnp.asarray(valid_b), JOptions(**kw))
    got = match_float(torch.from_numpy(a), torch.from_numpy(valid_a), torch.from_numpy(b), torch.from_numpy(valid_b),
                      FloatMatcherOptions(**kw))
    assert got.index.dtype == torch.int32 and got.distance.dtype == torch.float32
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.distance.numpy(), np.asarray(want.distance), atol=DIST_ATOL, rtol=0)
    if case.startswith("tied"):
        assert int(got.index[9]) in (-1, 3)  # never the later duplicates 7 or 12
    if case != "no_valid_b":
        assert int(got.valid.sum()) >= 3


def test_self_match_and_options():
    a = _descs(np.random.default_rng(6), 32)
    valid = torch.ones(32, dtype=torch.bool)
    m = match_float(torch.from_numpy(a), valid, torch.from_numpy(a), valid)
    np.testing.assert_array_equal(m.index.numpy(), np.arange(32))
    np.testing.assert_allclose(m.distance.numpy(), 0.0, atol=1e-3)
    with pytest.raises(ValueError):
        match_float(torch.from_numpy(a), valid, torch.from_numpy(a), valid, FloatMatcherOptions(metric="hamming"))
