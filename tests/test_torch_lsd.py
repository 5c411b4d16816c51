"""LSD line detection of the port against the JAX package on the CPU.

On the CPU the JAX package's flood runs its XLA stencil loop (the Pallas
kernel only runs on a TPU), and the port's runs its plain version, the
counterpart of the CUDA kernel.  Tolerances and why:

- angle map: validity and norm exactly equal (gx, gy are half-integers, so
  the norm is the correctly rounded root of an exact sum); the angle within
  ANGLE_ATOL, since float32 atan2 may differ by an ulp between torch and
  XLA.  So labels are compared exactly when both sides get the same maps;
- labels: exactly equal, for every schedule step and sweep count;
- line fit: the JAX package sums the moments in float32, the port in
  float64, so endpoints and rectangle fields agree within the tolerances
  below; lines are matched by region label.  A line that one side keeps and
  the other drops is excused only by the degenerate-moment rule
  (ixx, iyy, ixy != 0): on a nearly axis-aligned region the inertia terms
  cancel to near zero and float32 rounding decides.  Excusals are counted
  and printed, and the bars image must need none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import feature_detector_tpu.core.config as JC
from feature_detector_tpu.frontend.line_detector import detect_good_lines as jax_detect_lines
from feature_detector_tpu.kernels import lsd as JK
from feature_detector_tpu.oracle import lsd as oracle
from feature_detector_tpu_torch.core import config as TC
from feature_detector_tpu_torch.core.convert import from_jax
from feature_detector_tpu_torch.frontend.line_detector import detect_good_lines, detect_good_lines_with_state
from feature_detector_tpu_torch.kernels import lsd as TK
from feature_detector_tpu_torch.kernels.lsd_flood import propagate_running
from tests.test_lsd import endpoint_set_distance, synthetic_lines_image
from tests.torch_port_inputs import synth_frame

ANGLE_ATOL = 5e-7  # two float32 ulps at pi
ENDPOINT_ATOL = 1e-3  # px
RECT_ATOL = {"center": 1e-3, "angle": 2e-4, "length": 1e-3, "width": 1e-3, "inlier_ratio": 1e-3}
DEGENERATE_REL = 1e-4  # |ixx|, |iyy| or |ixy| below this share of ixx + iyy


def _image(name):
    if name == "bars":
        return synthetic_lines_image()
    return synth_frame(int(name[len("scene"):]))


def _equal_norm_maps(seed=3, h=90, w=130):
    """Random maps where norms take three values (ties everywhere) and
    angles sit near +-pi (wrapping) or drift slowly; 70% valid."""
    rng = np.random.default_rng(seed)
    norm = rng.choice(np.float32([25.0, 30.0, 40.0]), (h, w)).astype(np.float32)
    valid = rng.random((h, w)) < 0.7
    angle = np.where(np.arange(w)[None, :] < w // 2, np.pi - 0.05, 0.3).astype(np.float64)
    angle = angle + rng.choice([-0.25, -0.1, 0.0, 0.1, 0.25], (h, w)) + np.linspace(0, 0.6, h)[:, None]
    angle = np.where(angle > np.pi, angle - 2 * np.pi, angle).astype(np.float32)
    return norm, np.where(valid, angle, 0.0).astype(np.float32), valid


def _jax_maps(img, opts=JC.LineDetectorOptions()):
    return [np.array(x) for x in JK.line_level_angle_map(jnp.asarray(img), opts)]


def _maps(name):
    if name == "equal_norms":
        return _equal_norm_maps()
    return _jax_maps(_image(name))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("name", ["bars", "scene0", "scene1", "scene2"])
def test_angle_map_equals_jax(name):
    img = _image(name)
    jn, ja, jv = _jax_maps(img)
    tn, ta, tv = (x.numpy() for x in TK.line_level_angle_map(torch.from_numpy(img), TC.LineDetectorOptions()))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=ANGLE_ATOL)
    assert jv.sum() > 300


def test_min_region_size_equals_jax():
    for shape in ((480, 752), (120, 160)):
        assert TK.min_region_size(*shape, TC.LineDetectorOptions()) == JK.min_region_size(*shape, JC.LineDetectorOptions())


@pytest.mark.parametrize("sweeps", [0, 1, 7, 256, 330])
@pytest.mark.parametrize("name", ["bars", "scene1", "equal_norms"])
def test_flood_labels_equal_jax(name, sweeps):
    """The plain flood (what the kernel is held to on the card) against the
    JAX package's ("R", n) schedule, both fed the same maps."""
    norm, angle, valid = _maps(name)
    jopts = JC.LineDetectorOptions(propagation_steps=sweeps)
    want = np.asarray(JK.propagate_labels_meanangle(jnp.asarray(norm), jnp.asarray(angle), jnp.asarray(valid), jopts))
    got = propagate_running(*_t(norm, angle, valid), sweeps, jopts.min_tolerance_angle_residual_in_rad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if sweeps == 0:
        np.testing.assert_array_equal(want[valid], np.flatnonzero(valid))
    else:
        assert len(np.unique(want[valid])) < valid.sum()  # regions did grow


SCHEDULES = {
    "S": (("S", 12),),
    "S_J": (("S", 8), ("J",), ("S", 8), ("J",)),
    "S_L": (("S", 6), ("L",), ("L",), ("S", 4)),
    "S_M_R": (("S", 10), ("M",), ("S", 10), ("M",), ("R", 5)),
    "R_M_R": (("R", 20), ("M",), ("R", 20)),
}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("name", ["bars", "scene0", "equal_norms"])
def test_schedule_labels_equal_jax(name, schedule):
    norm, angle, valid = _maps(name)
    sched = SCHEDULES[schedule]
    want = np.asarray(JK.propagate_labels_meanangle(
        jnp.asarray(norm), jnp.asarray(angle), jnp.asarray(valid), JC.LineDetectorOptions(), sched))
    got = TK.propagate_labels_meanangle(*_t(norm, angle, valid), TC.LineDetectorOptions(), sched)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("steps", [3, 256])
@pytest.mark.parametrize("name", ["bars", "scene1", "equal_norms"])
def test_pairwise_components_equal_jax(name, steps):
    _, angle, valid = _maps(name)
    want = np.asarray(JK.propagate_labels(jnp.asarray(angle), jnp.asarray(valid), JC.LineDetectorOptions(propagation_steps=steps)))
    got = TK.propagate_labels(*_t(angle, valid), TC.LineDetectorOptions(propagation_steps=steps))
    np.testing.assert_array_equal(got.numpy(), want)


def _degenerate(labels, norm, label):
    """Whether region ``label``'s weighted central moments (float64) put
    ixx, iyy or ixy within DEGENERATE_REL of zero."""
    rr, cc = np.nonzero(labels == label)
    w = norm[rr, cc].astype(np.float64)
    cx, cy = (w * cc).sum() / w.sum(), (w * rr).sum() / w.sum()
    ixx, iyy = (w * (rr - cy) ** 2).sum(), (w * (cc - cx) ** 2).sum()
    ixy = (w * (cc - cx) * (rr - cy)).sum()
    return min(abs(ixx), abs(iyy), abs(ixy)) <= DEGENERATE_REL * (ixx + iyy)


def _compare_lines(img, norm, angle, valid, opts_kw=None):
    """Port's detect_lines_with_state against JAX's on the same maps; returns
    the excusals by name."""
    opts_kw = opts_kw or {}
    je, jv, jl, jr = JK.detect_lines_with_state(
        jnp.asarray(norm), jnp.asarray(angle), jnp.asarray(valid), img.shape, JC.LineDetectorOptions(**opts_kw))
    te, tv, tl, tr = TK.detect_lines_with_state(*_t(norm, angle, valid), img.shape, TC.LineDetectorOptions(**opts_kw))
    je, jv, jl = np.asarray(je), np.asarray(jv), np.asarray(jl)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tr["valid"].numpy(), tv.numpy())
    assert not te.numpy()[~tv.numpy()].any()

    jlab = {int(l): i for i, l in enumerate(np.asarray(jr["label"])) if jv[i]}
    tlab = {int(l): i for i, l in enumerate(tr["label"].numpy()) if tv[i]}
    excused = {"degenerate_moment": 0}
    for label in set(jlab) ^ set(tlab):
        assert _degenerate(jl, norm, label), f"line of region {label} kept on one side only"
        excused["degenerate_moment"] += 1
    for label in set(jlab) & set(tlab):
        i, k = jlab[label], tlab[label]
        np.testing.assert_allclose(te.numpy()[k], je[i], rtol=0, atol=ENDPOINT_ATOL)
        assert tr["pixel_count"][k].item() == float(np.asarray(jr["pixel_count"])[i])
        for field, atol in RECT_ATOL.items():
            np.testing.assert_allclose(tr[field].numpy()[k], np.asarray(jr[field])[i], rtol=0, atol=atol, err_msg=field)
    print(f"lines: jax {len(jlab)}, port {len(tlab)}, excused {excused}")
    return excused, len(jlab)


@pytest.mark.parametrize("name", ["bars", "scene0", "scene1", "scene2", "scene3", "scene5"])
def test_detect_lines_with_state_equals_jax(name):
    img = _image(name)
    excused, n_lines = _compare_lines(img, *_jax_maps(img))
    assert n_lines >= 2
    if name == "bars":
        assert sum(excused.values()) == 0


def test_fit_capacity_and_max_lines_equal_jax():
    """A fit buffer smaller than the labelled pixels, and fewer line slots
    than lines, cut both sides the same way."""
    img = synth_frame(1)
    n_pix = int(_jax_maps(img)[2].sum())
    excused, n_lines = _compare_lines(img, *_jax_maps(img), {"max_fit_pixels": n_pix // 2, "max_lines": 4})
    assert n_lines == 4 and sum(excused.values()) == 0


def test_detect_good_lines_end_to_end():
    opts = TC.LineDetectorOptions()
    img = synthetic_lines_image()
    empty = detect_good_lines(torch.from_numpy(img), 0, opts)
    assert empty.endpoints.shape == (opts.max_lines, 4) and int(empty.count) == 0

    # Recall against the sequential reference, as tests/test_lsd.py asks of
    # the JAX package: every oracle line within 4 px, count within +-50%.
    want = oracle.detect_lines(img, JC.LineDetectorOptions())
    segs = detect_good_lines(img, 10, opts, device="cpu").to_numpy()
    assert len(want) > 0
    for wline in want:
        assert min(endpoint_set_distance(wline, g) for g in segs) < 4.0, (wline, segs)
    assert 0.5 * len(want) <= len(segs) <= 2.0 * len(want) + 1

    # The whole entry point against the JAX package's on scenes.
    for seed in (0, 2):
        frame = synth_frame(seed)
        got = detect_good_lines(torch.from_numpy(frame), 100, opts).to_numpy()
        jl = jax_detect_lines(jnp.asarray(frame), 100, JC.LineDetectorOptions())
        ref = np.asarray(jl.endpoints)[np.asarray(jl.valid)]
        assert len(got) == len(ref) >= 2
        for line in ref:
            assert min(np.abs(g - line).max() for g in got) <= ENDPOINT_ATOL


def test_state_introspection():
    img = synthetic_lines_image()
    opts = TC.LineDetectorOptions()
    state = detect_good_lines_with_state(torch.from_numpy(img), opts)
    norm, angle, valid = state.pixels()
    assert norm.shape == (img.shape[0] - 1, img.shape[1] - 1) == angle.shape == valid.shape
    sp = state.sorted_pixels()
    assert len(sp) == int(valid.sum())
    assert (np.diff(norm.numpy()[sp[:, 0], sp[:, 1]]) <= 0).all()
    rects = state.rectangles()
    nv = state.lines.valid.numpy()
    np.testing.assert_array_equal(rects["valid"].numpy(), nv)
    assert (rects["length"].numpy()[nv] >= opts.min_valid_line_length_in_pixel).all()
    assert (rects["inlier_ratio"].numpy()[nv] >= opts.max_tolerance_inlier_ratio).all()
    for label in rects["label"].numpy()[nv]:
        assert (state.labels == int(label)).any()
    plain = detect_good_lines(torch.from_numpy(img), 10, opts)
    assert torch.equal(plain.endpoints, state.lines.endpoints) and torch.equal(plain.valid, state.lines.valid)


def test_options_and_lines_from_jax():
    jopts = JC.LineDetectorOptions(max_lines=64, propagation_steps=100, max_fit_pixels=4096)
    topts = from_jax(jopts)
    assert topts == TC.LineDetectorOptions(max_lines=64, propagation_steps=100, max_fit_pixels=4096)
    jl = jax_detect_lines(jnp.asarray(synthetic_lines_image()), 10, jopts)
    tl = from_jax(jl, "cpu")
    np.testing.assert_array_equal(tl.endpoints.numpy(), np.asarray(jl.endpoints))
    np.testing.assert_array_equal(tl.valid.numpy(), np.asarray(jl.valid))
    assert int(tl.count) == int(np.asarray(jl.valid).sum()) >= 3


def test_lines_default_to_the_card():
    if torch.cuda.is_available():
        assert detect_good_lines(synthetic_lines_image(), 10).endpoints.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            detect_good_lines(synthetic_lines_image(), 10)
