"""PyTorch port of kernels/detect.py against the JAX package, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_detector_tpu.core.config import DetectorOptions, HarrisOptions, ShiTomasiOptions
from feature_detector_tpu.kernels import detect as KJ
from feature_detector_tpu_torch.core import config as TC
from feature_detector_tpu_torch.kernels import detect as KT
from feature_detector_tpu_torch.kernels.fast import fast_maps
from tests.torch_fast_cases import FAST_CASES, fast_case
from tests.torch_port_inputs import synth_stack

SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def frames():
    return synth_stack(SEEDS)


def _ones(shape):
    return np.ones(shape, np.int32)


def test_fast_response_and_candidates_exact(frames):
    mask = _ones(frames.shape[1:])
    mask[40:60, 50:90] = 0  # a masked-out block reaches the gating too
    for thr in (10.0, 12.0):
        got_r = KT.fast_response(torch.from_numpy(frames), torch.from_numpy(mask))
        got_c = KT.fast_candidates(got_r, thr).numpy()
        for i, f in enumerate(frames):
            want_r = np.asarray(KJ.fast_response(jnp.asarray(f), jnp.asarray(mask)))
            np.testing.assert_array_equal(got_r[i].numpy(), want_r)
            want_c = np.asarray(KJ.fast_candidates(jnp.asarray(want_r), thr))
            np.testing.assert_array_equal(got_c[i], want_c)
        assert (got_c > 0).sum() > 20


@pytest.mark.parametrize("n", [9, 12])
def test_fast_arc_length_option(frames, n):
    f = frames[0]
    mask = _ones(f.shape)
    want = np.asarray(KJ.fast_response(jnp.asarray(f), jnp.asarray(mask), KJ.FastOptions(n=n)))
    got = KT.fast_response(torch.from_numpy(f), torch.from_numpy(mask), TC.FastOptions(n=n)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("want_response", [False, True], ids=["cand", "cand_and_resp"])
@pytest.mark.parametrize("case", sorted(FAST_CASES))
def test_fast_maps_on_cpu_is_the_plain_chain(case, want_response):
    image, mask, sub, thr = fast_case(case)
    img = torch.from_numpy(image)
    m = None if mask is None else torch.from_numpy(mask)
    before = fast_maps.launches
    cand, resp = fast_maps(img, m, sub, thr, want_response)
    assert fast_maps.launches == before  # the CPU launches nothing
    want_r = KT.fast_response(img, torch.ones(image.shape[-2:], dtype=torch.int32) if m is None else m, sub)
    want_c = KT.fast_candidates(want_r, thr)
    assert cand.dtype == torch.float32 and cand.shape == img.shape
    assert torch.equal(cand, want_c)
    if want_response:
        assert torch.equal(resp, want_r)
    else:
        assert resp is None


def test_fast_maps_cases_reach_every_gate():
    """The shared cases hold candidates, responses below the threshold and
    pixels that the mask turns off."""
    for case in ("random", "ring_at_threshold", "scenes", "mask_hw"):
        image, mask, sub, thr = fast_case(case)
        cand, resp = fast_maps(torch.from_numpy(image), None, sub, thr, True)
        assert bool((cand > 0).any()) and bool(((resp > 0) & (cand == 0)).any()), case
        if mask is not None:
            assert bool((resp[..., torch.from_numpy(mask) == 0] > 0).any()), case


@pytest.mark.parametrize("bad", ["float32_image", "int32_image", "transposed_image", "mask_hw_too_wide",
                                 "mask_of_another_batch", "int64_mask"])
def test_fast_maps_rejects_bad_input(bad):
    img = torch.zeros((3, 20, 24), dtype=torch.uint8)
    mask = None
    if bad == "float32_image":
        img = img.float()
    elif bad == "int32_image":
        img = img.int()
    elif bad == "transposed_image":
        img = torch.zeros((3, 24, 20), dtype=torch.uint8).transpose(1, 2)
    elif bad == "mask_hw_too_wide":
        mask = torch.ones((20, 25), dtype=torch.int32)
    elif bad == "mask_of_another_batch":
        mask = torch.ones((2, 20, 24), dtype=torch.int32)
    elif bad == "int64_mask":
        mask = torch.ones((20, 24), dtype=torch.int64)
    with pytest.raises((TypeError, ValueError)):
        fast_maps(img, mask, TC.FastOptions(), 10.0, False)


def test_nms4_exact_on_jax_response(frames):
    opts = DetectorOptions(min_valid_response=30.0)
    for f in frames:
        resp = np.array(KJ.harris_response(jnp.asarray(f), jnp.asarray(_ones(f.shape)), opts))
        want = np.asarray(KJ.nms4(jnp.asarray(resp), 30.0, 2))
        got = KT.nms4(torch.from_numpy(resp), 30.0, 2).numpy()
        np.testing.assert_array_equal(got, want)
        assert (want > 0).sum() > 5


@pytest.mark.parametrize("kind", ["harris", "shi_tomasi"])
def test_response_maps_allclose(frames, kind):
    """Raw maps agree to rtol 1e-5; the float products are rounded in
    another order than XLA's, so a value that cancels to near zero gets an
    absolute allowance of 1e-5 of the map's largest magnitude.  The gated
    maps may differ only at pixels whose raw value sits at the threshold."""
    thr = 30.0 if kind == "harris" else 40.0
    jopts, topts = DetectorOptions(min_valid_response=thr), TC.DetectorOptions(min_valid_response=thr)
    if kind == "harris":
        jraw, traw = KJ.harris_response_raw, KT.harris_response_raw
        jgate, tgate = KJ.harris_response, KT.harris_response
        jsub, tsub = HarrisOptions(), TC.HarrisOptions()
    else:
        jraw, traw = KJ.shi_tomasi_response_raw, KT.shi_tomasi_response_raw
        jgate, tgate = KJ.shi_tomasi_response, KT.shi_tomasi_response
        jsub, tsub = ShiTomasiOptions(), TC.ShiTomasiOptions()
    mask = _ones(frames.shape[1:])
    got_raw = traw(torch.from_numpy(frames).to(torch.float32), tsub).numpy()
    got = tgate(torch.from_numpy(frames), torch.from_numpy(mask), topts, tsub).numpy()
    for i, f in enumerate(frames):
        want_raw = np.asarray(jraw(jnp.asarray(f, jnp.float32), jsub))
        atol = 1e-5 * np.abs(want_raw).max()
        np.testing.assert_allclose(got_raw[i], want_raw, rtol=1e-5, atol=atol)
        want = np.asarray(jgate(jnp.asarray(f), jnp.asarray(mask), jopts, jsub))
        flip = (got[i] > 0) != (want > 0)
        assert np.all(np.abs(want_raw[flip] - thr) <= 1e-5 * thr + atol)
        keep = ~flip
        np.testing.assert_allclose(got[i][keep], want[keep], rtol=1e-5, atol=atol)


def test_box_sum_and_gradients_exact(frames):
    f = frames[1].astype(np.float32)
    ix_j, iy_j = KJ.central_gradients(jnp.asarray(f))
    ix_t, iy_t = KT.central_gradients(torch.from_numpy(f))
    np.testing.assert_array_equal(ix_t.numpy(), np.asarray(ix_j))
    np.testing.assert_array_equal(iy_t.numpy(), np.asarray(iy_j))
    prod = np.array(ix_j * iy_j)
    for half in (1, 2):
        np.testing.assert_array_equal(
            KT.box_sum(torch.from_numpy(prod), half).numpy(), np.asarray(KJ.box_sum(jnp.asarray(prod), half))
        )


def test_suppression_mask_exact():
    """A valid feature at (0, 0) beside invalid slots, which also sit at
    (0, 0): the amax scatter must keep the valid one."""
    shape = (60, 90)
    uv = np.array([[0, 0], [0, 0], [45.7, 30.2], [89, 59], [10, 50], [0, 0]], np.float32)
    for valid in (
        np.array([True, False, True, True, False, False]),
        np.array([False, True, True, False, True, False]),
        np.zeros(6, bool),
    ):
        for r in (0, 3, 7):
            want = np.asarray(KJ.make_suppression_mask(shape, jnp.asarray(uv), jnp.asarray(valid), r))
            got = KT.make_suppression_mask(shape, torch.from_numpy(uv), torch.from_numpy(valid), r)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
    # Batched: one mask per frame.
    uvb = np.stack([uv, uv[::-1].copy()])
    vb = np.stack([valid, valid[::-1].copy()])
    got_b = KT.make_suppression_mask(shape, torch.from_numpy(uvb), torch.from_numpy(vb), 5).numpy()
    for i in range(2):
        want = np.asarray(KJ.make_suppression_mask(shape, jnp.asarray(uvb[i]), jnp.asarray(vb[i]), 5))
        np.testing.assert_array_equal(got_b[i], want)


def test_subpixel_refine_allclose(frames):
    f = frames[2]
    resp = np.array(KJ.harris_response(jnp.asarray(f), jnp.asarray(_ones(f.shape)), DetectorOptions(min_valid_response=30.0)))
    cand = np.asarray(KJ.nms4(jnp.asarray(resp), 30.0, 2))
    ys, xs = np.nonzero(cand)
    uv = np.stack([xs, ys], -1).astype(np.float32)[:24]
    uv = np.concatenate([uv, [[0, 0], [159, 119]]]).astype(np.float32)  # edge clipping
    valid = np.ones(len(uv), bool)
    valid[-3] = False
    want = np.asarray(KJ.subpixel_refine(jnp.asarray(resp), jnp.asarray(uv), jnp.asarray(valid)))
    got = KT.subpixel_refine(torch.from_numpy(resp), torch.from_numpy(uv), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(want - uv).max() > 0  # some fits moved
