"""Hamming matcher of the port against the JAX package: index, distance and
validity exactly equal, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_detector_tpu.core.config import MatcherOptions
from feature_detector_tpu.match.hamming import hamming_distance_matrix as jax_distance
from feature_detector_tpu.match.hamming import match_hamming as jax_match
from feature_detector_tpu_torch.core import config as TC
from feature_detector_tpu_torch.core.types import words_from_numpy
from feature_detector_tpu_torch.match.hamming import hamming_distance_matrix, match_hamming


def _words(rng, n, flips_from=None, max_flips=40):
    """Random uint32 words, or copies of ``flips_from`` rows with a few bits flipped."""
    if flips_from is None:
        return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    src = flips_from[rng.integers(0, len(flips_from), n)].copy()
    bits = np.unpackbits(src.view(np.uint8), axis=1, bitorder="little")
    for i in range(n):
        k = rng.integers(0, max_flips)
        bits[i, rng.choice(256, k, replace=False)] ^= 1
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


def _case(seed, na, nb):
    rng = np.random.default_rng(seed)
    wb = _words(rng, nb)
    wa = _words(rng, na, flips_from=wb)
    wa[1] = wa[0]  # two A rows with the same nearest B
    wb[2] = wb[3]  # a tie between two B columns
    va = rng.random(na) > 0.15
    vb = rng.random(nb) > 0.15
    return wa, va, wb, vb


def _assert_match_equal(got, want):
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    np.testing.assert_array_equal(got.distance.numpy(), np.asarray(want.distance))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


OPTIONS = {
    "default": {},
    "max_distance": {"max_distance": 12},
    "ratio": {"ratio": 0.8},
    "no_cross_check": {"cross_check": False},
    "all_gates": {"max_distance": 30, "ratio": 0.9, "cross_check": True},
}


@pytest.mark.parametrize("na,nb", [(20, 31), (300, 300)])
@pytest.mark.parametrize("opt", sorted(OPTIONS))
def test_match_equals_jax(na, nb, opt):
    wa, va, wb, vb = _case(na + nb, na, nb)
    want = jax_match(jnp.asarray(wa), jnp.asarray(va), jnp.asarray(wb), jnp.asarray(vb), MatcherOptions(**OPTIONS[opt]))
    got = match_hamming(words_from_numpy(wa, "cpu"), torch.from_numpy(va), words_from_numpy(wb, "cpu"),
                        torch.from_numpy(vb), TC.MatcherOptions(**OPTIONS[opt]))
    _assert_match_equal(got, want)
    assert got.valid.sum() > 3


def test_distance_matrix_equals_jax_and_batch():
    wa, va, wb, vb = _case(5, 17, 23)
    want = np.asarray(jax_distance(jnp.asarray(wa), jnp.asarray(wb), jnp.asarray(va), jnp.asarray(vb)))
    got = hamming_distance_matrix(words_from_numpy(wa, "cpu"), words_from_numpy(wb, "cpu"),
                                  torch.from_numpy(va), torch.from_numpy(vb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # A leading batch dimension gives each pair its own matrix and matches.
    cases = [_case(s, 17, 23) for s in (6, 7, 8)]
    stack = [np.stack([c[k] for c in cases]) for k in range(4)]
    got_b = match_hamming(words_from_numpy(stack[0], "cpu"), torch.from_numpy(stack[1]),
                          words_from_numpy(stack[2], "cpu"), torch.from_numpy(stack[3]))
    for i, (wa, va, wb, vb) in enumerate(cases):
        want = jax_match(jnp.asarray(wa), jnp.asarray(va), jnp.asarray(wb), jnp.asarray(vb))
        np.testing.assert_array_equal(got_b.index[i].numpy(), np.asarray(want.index))
        np.testing.assert_array_equal(got_b.distance[i].numpy(), np.asarray(want.distance))
        np.testing.assert_array_equal(got_b.valid[i].numpy(), np.asarray(want.valid))


def test_all_invalid_and_identity():
    rng = np.random.default_rng(9)
    w = _words(rng, 12)
    none = np.zeros(12, bool)
    for va, vb in ((none, ~none), (~none, none)):
        want = jax_match(jnp.asarray(w), jnp.asarray(va), jnp.asarray(w), jnp.asarray(vb))
        got = match_hamming(words_from_numpy(w, "cpu"), torch.from_numpy(va), words_from_numpy(w, "cpu"), torch.from_numpy(vb))
        _assert_match_equal(got, want)
        assert not got.valid.any()
    got = match_hamming(words_from_numpy(w, "cpu"), torch.from_numpy(~none), words_from_numpy(w, "cpu"),
                        torch.from_numpy(~none), TC.MatcherOptions(max_distance=0))
    np.testing.assert_array_equal(got.index.numpy(), np.arange(12))
    assert (got.distance.numpy() == 0).all()
