"""PyTorch port of the tooling (utils/{timer,checkpoint,checks,recovery},
core/config_io, io/{images,visualize,native}, app/demo) on the CPU.

The cases mirror the JAX package's tests/test_checkpoint.py,
tests/test_recovery.py, tests/test_config_io.py and tests/test_visualize.py
one for one (names kept), with torch tensors in place of jax arrays and the
port's config in place of the JAX package's.  The native engine is held
against the JAX package's own wrapper (``feature_detector_tpu/io/native.py``)
on seeded frames, exactly.  ``save_image`` is held to PIL's decoding, and
its standard-library path to ``read_png``.  The demo's ``main`` runs on PNGs
that the test writes.
"""

import os

import numpy as np
import pytest
import torch

from feature_detector_tpu.core import config as JC
from feature_detector_tpu.core import config_io as JIO
from feature_detector_tpu.io import native as jax_native
from feature_detector_tpu_torch.core import config_io as TIO
from feature_detector_tpu_torch.core.config import FrontendConfig, NNModelType
from feature_detector_tpu_torch.io import images, native, visualize
from feature_detector_tpu_torch.models.superpoint import SuperPoint
from feature_detector_tpu_torch.models.weights import init_state
from feature_detector_tpu_torch.slam.ba import BAProblem
from feature_detector_tpu_torch.utils import timer
from feature_detector_tpu_torch.utils.checkpoint import CheckpointManager, restore_pytree, save_pytree
from feature_detector_tpu_torch.utils.checks import assert_all_finite, checked, debug_nans
from feature_detector_tpu_torch.utils.recovery import ResilientLoop, default_health, devices_alive
from tests.torch_port_inputs import synth_frame

# --------------------------------------------------------------------------
# utils/checkpoint.py (tests/test_checkpoint.py)
# --------------------------------------------------------------------------


def test_pytree_roundtrip(tmp_path):
    tree = {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": torch.ones(4, dtype=torch.bfloat16),
        "step": torch.tensor(7, dtype=torch.int32),
        "host": np.arange(3, dtype=np.float64),
    }
    path = str(tmp_path / "ckpt")
    save_pytree(path, tree)
    back = restore_pytree(path, template=tree)
    assert back["b"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree["w"])
    assert int(back["step"]) == 7
    assert isinstance(back["host"], np.ndarray) and np.array_equal(back["host"], tree["host"])
    with pytest.raises(FileExistsError):
        save_pytree(path, tree, force=False)
    assert [p.name for p in tmp_path.iterdir()] == ["ckpt"]  # no temporary file left
    with pytest.raises(ValueError):
        restore_pytree(path, template={"w": tree["w"]})


def test_model_params_roundtrip(tmp_path):
    params = init_state(SuperPoint(), torch.Generator().manual_seed(0)).state_dict()
    path = str(tmp_path / "sp")
    save_pytree(path, params)
    back = restore_pytree(path, template=params)
    assert list(back) == list(params)
    for k in params:
        assert torch.equal(back[k], params[k])


def test_manager_latest_and_retention(tmp_path):
    tree = {"x": torch.zeros(3)}
    with CheckpointManager(str(tmp_path / "mgr"), max_to_keep=2) as mgr:
        assert mgr.latest_step() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore(tree)
        for step in range(4):
            mgr.save(step, {"x": torch.full((3,), float(step))})
        assert mgr.latest_step() == 3
        back = mgr.restore(tree)
        assert torch.equal(back["x"], torch.full((3,), 3.0))
        # Retention: the oldest steps dropped.
        assert mgr.all_steps() == [2, 3]
        assert torch.equal(mgr.restore(tree, step=2)["x"], torch.full((3,), 2.0))


def test_ba_state_roundtrip(tmp_path):
    problem = BAProblem(
        rot=torch.eye(3).expand(2, 3, 3).clone(),
        trans=torch.zeros((2, 3)),
        points=torch.ones((5, 3)),
        obs_cam=torch.zeros((5, 2), dtype=torch.int32),
        obs_uv=torch.zeros((5, 2, 2)),
    )
    path = str(tmp_path / "ba")
    save_pytree(path, problem._asdict())
    back = restore_pytree(path, template=problem._asdict())
    assert torch.equal(back["points"], problem.points)
    save_pytree(path, problem)  # a named tuple restores as one
    back = restore_pytree(path, template=problem)
    assert isinstance(back, BAProblem) and back.obs_cam.dtype == torch.int32


# --------------------------------------------------------------------------
# utils/checks.py and utils/recovery.py (tests/test_recovery.py)
# --------------------------------------------------------------------------


class TestChecks:
    def test_checked_passes_clean_fn(self):
        f = checked(lambda x: torch.sqrt(x) * 2.0)
        out = f(torch.tensor([1.0, 4.0]))
        np.testing.assert_allclose(out.numpy(), [2.0, 4.0])

    def test_checked_traps_nan(self):
        f = checked(lambda x: torch.sqrt(x))
        with pytest.raises(FloatingPointError, match="nan"):
            f(torch.tensor([-1.0]))

    def test_assert_all_finite(self):
        assert_all_finite({"a": torch.ones(3), "n": [np.ones(2), 3]}, "ok")
        with pytest.raises(FloatingPointError, match="bad/x"):
            assert_all_finite({"bad": {"x": torch.tensor([1.0, float("inf")])}}, "ba")
        with pytest.raises(FloatingPointError, match="l/1"):
            assert_all_finite({"l": [np.zeros(1), np.array([np.nan])]}, "ba")

    def test_devices_alive(self):
        assert devices_alive("cpu") is True
        if not torch.cuda.is_available():
            assert devices_alive() is False  # the card is the default, and there is none

    def test_debug_nans(self):
        debug_nans(True)
        try:
            assert torch.is_anomaly_enabled()
        finally:
            debug_nans(False)
        assert not torch.is_anomaly_enabled()


class TestResilientLoop:
    def test_straight_run_and_resume(self, tmp_path):
        calls = []

        def step(state, s):
            calls.append(s)
            return {"w": state["w"] + 1.0, "step": torch.tensor(s + 1)}

        loop = ResilientLoop(str(tmp_path / "ck"), save_every=4)
        out = loop.run({"w": torch.zeros(2), "step": torch.tensor(0)}, step, 10)
        assert float(out["w"][0]) == 10.0

        # A fresh loop over the same directory resumes, not restarts.
        calls.clear()
        loop2 = ResilientLoop(str(tmp_path / "ck"), save_every=4)
        out2 = loop2.run({"w": torch.zeros(2), "step": torch.tensor(0)}, step, 12)
        assert float(out2["w"][0]) == 12.0
        assert min(calls) == 10  # only the tail re-ran

    def test_crash_rolls_back_and_completes(self, tmp_path):
        crashed = {"done": False}

        def step(state, s):
            if s == 6 and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("injected device failure")
            return {"w": state["w"] + 1.0}

        loop = ResilientLoop(str(tmp_path / "ck"), save_every=4, max_retries=2)
        out = loop.run({"w": torch.zeros(1)}, step, 10)
        assert float(out["w"][0]) == 10.0  # replayed window, exact result
        assert loop.rollbacks == 1

    def test_nonfinite_state_rolls_back(self, tmp_path):
        poisoned = {"done": False}

        def step(state, s):
            if s == 5 and not poisoned["done"]:
                poisoned["done"] = True
                return {"w": state["w"] * float("nan")}
            return {"w": state["w"] + 1.0}

        loop = ResilientLoop(str(tmp_path / "ck"), save_every=3, max_retries=2)
        out = loop.run({"w": torch.zeros(1)}, step, 9)
        assert float(out["w"][0]) == 9.0

    def test_deterministic_failure_surfaces(self, tmp_path):
        def step(state, s):
            if s == 5:
                raise RuntimeError("permanent fault")
            return {"w": state["w"] + 1.0}

        loop = ResilientLoop(str(tmp_path / "ck"), save_every=3, max_retries=2)
        with pytest.raises(RuntimeError, match="permanent fault"):
            loop.run({"w": torch.zeros(1)}, step, 9)

    def test_default_health(self):
        assert default_health({"a": torch.ones(2), "n": 3})
        assert not default_health({"a": torch.tensor([float("nan")])})
        assert not default_health([np.array([np.inf])])


# --------------------------------------------------------------------------
# core/config_io.py (tests/test_config_io.py), against the JAX package's
# --------------------------------------------------------------------------


def test_dict_roundtrip():
    cfg = FrontendConfig()
    data = TIO.config_to_dict(cfg)
    assert data["detector"]["min_feature_distance"] == 15
    assert data["nn"]["model_type"] == "SUPERPOINT_HEATMAP"
    assert TIO.config_from_dict(data) == cfg
    assert data == JIO.config_to_dict(JC.FrontendConfig())


def test_yaml_roundtrip(tmp_path):
    cfg = FrontendConfig(
        detector=FrontendConfig().detector.replace(max_features=512),
        nn=FrontendConfig().nn.replace(model_type=NNModelType.DISK_NMS),
    )
    p = str(tmp_path / "cfg.yaml")
    TIO.save_yaml(p, cfg)
    back = TIO.load_yaml(p)
    assert back == cfg
    assert back.nn.model_type is NNModelType.DISK_NMS
    # The JAX package reads the port's file, and the other way round.
    assert JIO.config_to_dict(JIO.load_yaml(p)) == TIO.config_to_dict(cfg)
    JIO.save_yaml(p, JIO.load_yaml(p))
    assert TIO.load_yaml(p) == cfg


def test_unknown_key_rejected():
    with pytest.raises(KeyError):
        TIO.config_from_dict({"detector": {"min_feature_distance": 10}, "bogus": {}})


def test_overrides():
    overrides = {
        "detector.max_features": "512",
        "harris.alpha": "0.05",
        "matcher.cross_check": "false",
        "nn.model_type": "DISK_HEATMAP",
    }
    out = TIO.apply_overrides(FrontendConfig(), overrides)
    assert out.detector.max_features == 512
    assert out.harris.alpha == pytest.approx(0.05)
    assert out.matcher.cross_check is False
    assert out.nn.model_type is NNModelType.DISK_HEATMAP
    assert TIO.config_to_dict(out) == JIO.config_to_dict(JIO.apply_overrides(JC.FrontendConfig(), overrides))


def test_override_unknown_path():
    with pytest.raises(KeyError):
        TIO.apply_overrides(FrontendConfig(), {"detector.nope": 1})
    with pytest.raises(KeyError):
        TIO.apply_overrides(FrontendConfig(), {"detector.max_features.x": 1})


# --------------------------------------------------------------------------
# io/visualize.py (tests/test_visualize.py) and the two repaired faults
# --------------------------------------------------------------------------


@pytest.fixture
def headless(monkeypatch):
    monkeypatch.setenv("FD_NO_DISPLAY", "1")
    monkeypatch.setattr(visualize, "_INTERACTIVE", None)
    visualize.close_all()
    yield
    visualize.close_all()


def test_headless_show_records_windows_in_order(headless):
    gray = np.full((8, 12), 7, np.uint8)
    rgb = np.zeros((8, 12, 3), np.uint8)
    visualize.show_image("fast features", gray)
    visualize.show_image("lsd lines", rgb)
    wins = visualize.windows()
    assert list(wins) == ["fast features", "lsd lines"]
    assert wins["fast features"].shape == (8, 12)
    visualize.show_image("fast features", rgb)  # re-show updates in place
    assert list(visualize.windows()) == ["fast features", "lsd lines"]
    assert visualize.windows()["fast features"].ndim == 3


def test_headless_png_tee_and_waitkey_noop(headless, tmp_path):
    img = np.arange(64, dtype=np.uint8).reshape(8, 8)
    visualize.show_image("Harris detected features", img, out_dir=str(tmp_path))
    assert (tmp_path / "harris_detected_features.png").exists()
    assert visualize.wait_key(0) == -1
    assert visualize.wait_key(5) == -1
    visualize.close_all()
    assert visualize.windows() == {}


def test_demo_show_flag_headless(headless, tmp_path):
    images.save_image(str(tmp_path / "a.png"), np.zeros((4, 4, 3), np.uint8))
    visualize.show_image("a", images.load_rgb(str(tmp_path / "a.png")))
    assert "a" in visualize.windows()


@pytest.mark.parametrize("backend, interactive", [
    ("QtAgg", True), ("TkAgg", True), ("GTK4Agg", True), ("WXAgg", True), ("MacOSX", True),
    ("agg", False), ("pdf", False), ("svg", False), ("cairo", False), ("template", False),
])
def test_backend_classified_by_exact_name(monkeypatch, backend, interactive):
    """ADVICE.md:3: GUI backends whose names end in "agg" are interactive."""
    import matplotlib

    monkeypatch.delenv("FD_NO_DISPLAY", raising=False)
    monkeypatch.setenv("DISPLAY", ":0")
    monkeypatch.setattr(visualize, "_INTERACTIVE", None)
    monkeypatch.setattr(matplotlib, "get_backend", lambda: backend)
    assert visualize.interactive_available() is interactive


@pytest.mark.parametrize("env, platform, present", [
    ({"WAYLAND_DISPLAY": "wayland-0"}, "linux", True), ({"DISPLAY": ":1"}, "linux", True),
    ({}, "darwin", True), ({}, "linux", False),
])
def test_display_evidence(monkeypatch, env, platform, present):
    """ADVICE.md:4: Wayland and macOS count as a display."""
    for var in ("DISPLAY", "WAYLAND_DISPLAY", "FD_NO_DISPLAY"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(visualize.sys, "platform", platform)
    monkeypatch.setattr(visualize.os, "name", "posix")
    assert visualize.display_present() is present


# --------------------------------------------------------------------------
# io/images.py: PNG with and without PIL
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7, 9), (6, 5, 3), (4, 4, 4)])
@pytest.mark.parametrize("pil", [True, False])
def test_save_image_decodes(tmp_path, monkeypatch, shape, pil):
    arr = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    monkeypatch.setattr(images, "_HAVE_PIL", pil)
    path = str(tmp_path / "x.png")
    images.save_image(path, arr)
    from PIL import Image

    assert np.array_equal(np.asarray(Image.open(path)), arr)
    assert images.png_size(path) == (shape[1], shape[0], 1 if len(shape) == 2 else shape[2])
    if not pil:
        assert np.array_equal(images.read_png(path), arr)
        with pytest.raises(RuntimeError):
            images.load_gray(path)  # decoding stays on PIL


def test_read_png_refuses_damage(tmp_path):
    path = tmp_path / "x.png"
    data = bytearray(images.encode_png(np.zeros((3, 3), np.uint8)))
    data[-20] ^= 1  # inside IDAT: its CRC no longer holds
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        images.read_png(str(path))


def test_draw_functions():
    rgb = images.to_rgb(np.zeros((20, 20), np.uint8))
    images.draw_solid_circle(rgb, 10, 10, 2, images.RED)
    images.draw_line(rgb, 0, 0, 19, 19, images.GREEN)
    assert (rgb[10, 8] == images.RED).all() and (rgb[0, 0] == images.GREEN).all() and (rgb[5, 5] == images.GREEN).all()
    assert (rgb[0, 19] == 0).all()
    before = rgb.copy()
    images.draw_solid_circle(rgb, 10, 40, 2, images.RED)  # wholly outside: nothing drawn
    assert np.array_equal(rgb, before)


# --------------------------------------------------------------------------
# io/native.py against the JAX package's wrapper
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def native_lib():
    if not native.available():
        pytest.skip("the native library cannot be built here (make -C native)")
    return native


@pytest.mark.parametrize("seed", [0, 1])
def test_native_equals_jax_wrapper(native_lib, seed):
    frame = synth_frame(60 + seed)
    rng = np.random.default_rng(seed)
    got = native_lib.fast_detect(frame, 50, min_response=10.0, min_distance=20)
    want = jax_native.fast_detect(frame, 50, min_response=10.0, min_distance=20)
    assert len(got[0]) >= 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    existing = np.array([(30.0, 30.0), (80.0, 60.0)], np.float32)
    for g, w in zip(native_lib.fast_detect(frame, 40, 10.0, 10, existing=existing),
                    jax_native.fast_detect(frame, 40, 10.0, 10, existing=existing)):
        np.testing.assert_array_equal(g, w)
    uv = np.stack([rng.uniform(25, 135, 16), rng.uniform(25, 95, 16)], -1).astype(np.float32)
    for g, w in zip(native_lib.brief_compute(frame, uv), jax_native.brief_compute(frame, uv)):
        np.testing.assert_array_equal(g, w)
    wa = rng.integers(0, 2**32, (20, 8), dtype=np.uint32)
    wb = rng.integers(0, 2**32, (30, 8), dtype=np.uint32)
    va, vb = rng.random(20) < 0.9, rng.random(30) < 0.9
    for g, w in zip(native_lib.hamming_match(wa, va, wb, vb, max_distance=128),
                    jax_native.hamming_match(wa, va, wb, vb, max_distance=128)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(native_lib.lsd_detect(frame), jax_native.lsd_detect(frame))


# --------------------------------------------------------------------------
# utils/timer.py
# --------------------------------------------------------------------------


def test_ticktock_and_time_jitted():
    t = timer.TickTock()
    assert t.tock_in_millisecond() >= 0.0
    first = t.tock_tick_in_millisecond()
    assert first >= 0.0 and t.tock_in_millisecond() <= first + 1e3
    calls = []
    first_ms, steady_ms = timer.time_jitted(lambda x: calls.append(1) or x + 1, torch.zeros(3), iters=4, warmup=2)
    assert len(calls) == 1 + 1 + 4 and first_ms >= 0.0 and steady_ms >= 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            timer.time_jitted(lambda: None)  # no tensor argument: the card, which is absent


# --------------------------------------------------------------------------
# app/demo.py
# --------------------------------------------------------------------------


DEMO_PNGS = {
    "points": {"fast_features.png", "harris_features.png", "shi_tomasi_features.png", "harris_incremental.png"},
    "descriptor": {"brief_matches.png"},
    "lines": {"lsd_lines.png", "lsd_norm.png", "lsd_validity.png", "lsd_angle.png", "lsd_regions.png",
              "lsd_rectangles.png"},
    "nn": {"superpoint_heatmap_features.png", "disk_heatmap_features.png"},
    "vo": {"vo_trajectory.png"},
}


@pytest.fixture(scope="module")
def demo_run(tmp_path_factory):
    """``main`` once with every demo (``--demo all``, the default) on PNGs
    the test wrote (120x160); the VO on 8 frames and one intra-op thread,
    since its many small CPU ops slow tenfold or more when the test
    workers' threads outnumber the cores.  Returns (--out, the results)."""
    from feature_detector_tpu_torch.app import demo

    d = tmp_path_factory.mktemp("demo_in")
    images.save_image(str(d / "a.png"), synth_frame(70))
    images.save_image(str(d / "b.png"), synth_frame(71))
    out = d / "out"
    full_vo = demo.demo_vo

    def short_vo(out_dir, device=None):
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return full_vo(out_dir, n_frames=8, device=device)
        finally:
            torch.set_num_threads(n)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(demo, "demo_vo", short_vo)
        results = demo.main(["--image", str(d / "a.png"), "--image2", str(d / "b.png"), "--device", "cpu",
                             "--out", str(out)])
    return out, results


@pytest.mark.parametrize("which", sorted(DEMO_PNGS))
def test_demo_main_writes_every_png(demo_run, which):
    """Each demo's PNGs, and nothing else, in ``--out``, each decodable."""
    from PIL import Image

    out, results = demo_run
    assert set(results) == set(DEMO_PNGS)
    assert sorted(os.listdir(out)) == sorted(set().union(*DEMO_PNGS.values()))
    written = results[which]["written"]
    assert {os.path.basename(p) for p in written} == DEMO_PNGS[which]
    for p in written:
        assert Image.open(p).size[0] > 0
    counts = results[which]["counts"]
    assert all(v > 0 for v in counts.values()), counts
    if which == "points":
        assert counts["harris_incremental"] > counts["harris"] - 20  # the seeded grid stays


@pytest.mark.parametrize("which", ["points", "nn"])
def test_demo_main_runs_one_demo(which, tmp_path):
    """``--demo`` picks one demo; the images are required."""
    from feature_detector_tpu_torch.app import demo

    d = tmp_path / "in"
    d.mkdir()
    images.save_image(str(d / "a.png"), synth_frame(70))
    images.save_image(str(d / "b.png"), synth_frame(71))
    out = tmp_path / "out"
    results = demo.main(["--image", str(d / "a.png"), "--image2", str(d / "b.png"), "--device", "cpu",
                         "--out", str(out), "--demo", which])
    assert set(results) == {which} and sorted(os.listdir(out)) == sorted(DEMO_PNGS[which])
    with pytest.raises(SystemExit):
        demo.main(["--device", "cpu"])


def test_demo_vo_short_sequence(demo_run):
    from PIL import Image

    result = demo_run[1]["vo"]
    assert [os.path.basename(p) for p in result["written"]] == ["vo_trajectory.png"]
    assert Image.open(result["written"][0]).size == (640, 480)
    assert result["counts"]["frames"] == 8
    assert result["ate_m"] < 0.05 * result["span_m"] and result["counts"]["tracks"] > 50
