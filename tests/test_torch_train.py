"""PyTorch port of the training path (models/synth_data.py's training half,
models/train_superpoint.py, models/train_disk.py, models/convert.py, the npz
format) against the JAX package, on the CPU.

Both sides compute in float32 (``SuperPoint(dtype=float32)``, ``Disk(...)``)
from JAX's initial parameters carried across (``core/convert.py``), on
batches from ``make_batch`` with a seeded numpy generator at 64x80.
Tolerances, each measured on these inputs (listed in CHANGES.md too):

- ``make_batch``: equal bit for bit;
- ``warp_bilinear``: values within WARP_ATOL (both packages invert H_ab in
  float32 through different LU codes: measured 4.7e-6), validity equal
  except where the float64 source lies within 1e-4 px of the border; the
  clipped edge column and row read exactly as JAX's;
- losses (each package warping with its own code): loss, det and desc
  within rtol 1e-5;
- gradients, given the same warped frames: every element within rtol 1e-4
  and atol 1e-6 of JAX's; where a parameter's two float32 gradients part by
  more, both must be float32 roundings of the port's float64 gradient: JAX's
  within ROUNDING_SHARE (1e-6) of the total gradient norm of it, which holds
  the port's float64 loss to JAX, and the port's at most twice as far as
  JAX's.  Where sums cancel or the exact gradient is 0 (DISK's conv biases,
  which an InstanceNorm follows) both packages read rounding noise: on these
  inputs DISK's down_0 bias gradients are 1.5e-6 apart on a largest 1.6e-6,
  the port 3.4e-7 and JAX 1.6e-6 (7.5e-8 of the total norm 21.6) from the
  port's float64 (printed with ``-s``);
- one Adam step from the same gradients: parameters within atol 1e-6 of
  optax.adam's;
- the data-parallel step at 2 and 4 gloo ranks: the loss within rtol 1e-5
  and the gradients within the gradient tolerance above of the one-device
  step on the whole batch; every rank's parameters equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from feature_detector_tpu.models import convert as JC
from feature_detector_tpu.models import synth_data as JSD
from feature_detector_tpu.models import train_disk as JTD
from feature_detector_tpu.models import train_superpoint as JTS
from feature_detector_tpu.models.disk import Disk as JDisk
from feature_detector_tpu.models.superpoint import SuperPoint as JSuperPoint
from feature_detector_tpu_torch.core.convert import (
    disk_state_from_flax,
    flax_tree_from_disk_state,
    flax_tree_from_superpoint_state,
    superpoint_state_from_flax,
)
from feature_detector_tpu_torch.models import convert as TC
from feature_detector_tpu_torch.models import synth_data as TSD
from feature_detector_tpu_torch.models import train_disk as TTD
from feature_detector_tpu_torch.models import train_superpoint as TTS
from feature_detector_tpu_torch.models import weights as TW
from feature_detector_tpu_torch.models.disk import Disk
from feature_detector_tpu_torch.models.superpoint import SuperPoint
from tests import torch_dist_worker as W
from tests.test_convert import synthetic_disk_state, synthetic_superpoint_state

H, W_ = 64, 80
WARP_ATOL = 2e-5
BORDER_PX = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
ROUNDING_FACTOR = 2.0
ROUNDING_SHARE = 1e-6
ADAM_ATOL = 1e-6
LR = 1e-3

MODELS = {
    # name: (JAX model, JAX loss, port model, port loss, to state, from state, make_batch kw, input channels)
    "superpoint": (JSuperPoint, JTS.superpoint_loss, SuperPoint, TTS.superpoint_loss, superpoint_state_from_flax,
                   flax_tree_from_superpoint_state, dict(), 1),
    "disk": (JDisk, JTD.disk_loss, Disk, TTD.disk_loss, disk_state_from_flax, flax_tree_from_disk_state,
             dict(rich_background=True), 3),
}


# JAX's warp, compiled once per batch shape (the fixture's and the edge test's share one).
jax_warp = jax.jit(JTS.warp_bilinear)


def batch_of(seed: int, n: int, **kw) -> dict:
    return JSD.make_batch(np.random.default_rng(seed), n, H, W_, **kw)


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def flat(tree) -> dict:
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=sorted(MODELS))
def jax_run(request):
    """JAX's initial parameters, loss and gradients (jitted) and its warp of
    one batch, per model."""
    name = request.param
    jmodel_cls, jloss, _, _, to_state, _, kw, ch = MODELS[name]
    batch = batch_of(11, 2, **kw)
    model = jmodel_cls(dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W_, ch)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, aux), grads = jax.jit(jax.value_and_grad(lambda p: jloss(model, p, jb), has_aux=True))(params)
    warped, valid = jax_warp(jb["image"], jb["H_ab"])
    return dict(name=name, batch=batch, params=params, loss=float(loss), det=float(aux["det"]),
                desc=float(aux["desc"]), grads=to_state(grads), warp=(np.asarray(warped), np.asarray(valid)))


def port_grads(name: str, params, batch: dict, dtype=torch.float32, warp=None, monkeypatch=None):
    """The port's loss, aux and gradients by parameter name; ``warp``: the
    warped frames to use in place of the port's own warp."""
    _, _, model_cls, loss_fn, to_state, _, _, _ = MODELS[name]
    if warp is not None:
        monkeypatch.setattr(TTS, "warp_bilinear",
                            lambda im, h: (torch.tensor(warp[0], dtype=im.dtype), torch.tensor(warp[1])))
    model = model_cls(dtype=dtype)
    model.load_state_dict(to_state(params))
    loss, aux = loss_fn(model, tensors(batch))
    loss.backward()
    if warp is not None:
        monkeypatch.undo()
    return loss.item(), {k: v.item() for k, v in aux.items()}, {n: p.grad.clone() for n, p in model.named_parameters()}


def assert_grads_close(got: dict, want: dict, ref64: dict = None, what: str = ""):
    """Every element within GRAD_RTOL / GRAD_ATOL of ``want`` (JAX's).  A
    parameter whose two float32 gradients part by more must be two float32
    roundings of the port's float64 gradient ``ref64``: JAX's within
    ROUNDING_SHARE of the total gradient norm of it, which holds the float64
    reference (the port's loss) to JAX, and the port's at most
    ROUNDING_FACTOR times as far as JAX's."""
    total = np.sqrt(sum(np.square(np.asarray(w, np.float64)).sum() for w in want.values()))
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        g = got[name].numpy().astype(np.float64)
        if (np.abs(g - w) <= GRAD_ATOL + GRAD_RTOL * np.abs(w)).all():
            continue
        assert ref64 is not None, f"{what} {name}: float32 gradients part by {np.abs(g - w).max()}"
        r = ref64[name].numpy().astype(np.float64)
        d_got, d_want = np.abs(g - r).max(), np.abs(w - r).max()
        print(f"{what} {name}: float32 gradients {np.abs(g - w).max():.3g} apart on a largest {np.abs(w).max():.3g}; "
              f"from the port's float64: port {d_got:.3g}, JAX {d_want:.3g} = {d_want / total:.3g} of the total "
              f"norm {total:.4g}")
        assert d_want <= ROUNDING_SHARE * total, f"{what} {name}: JAX {d_want} from the port's float64"
        assert d_got <= ROUNDING_FACTOR * d_want, f"{what} {name}: {d_got} from float64, JAX {d_want}"


# --------------------------------------------------------------------------
# Batches and the warp
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rich", [False, True])
def test_make_batch_equal_bit_for_bit(rich):
    want = JSD.make_batch(np.random.default_rng(3), 3, H, W_, rich_background=rich)
    got = TSD.make_batch(np.random.default_rng(3), 3, H, W_, rich_background=rich)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    rng = np.random.default_rng(4)
    np.testing.assert_array_equal(TSD.random_homography(rng, H, W_), JSD.random_homography(np.random.default_rng(4), H, W_))
    uv = rng.uniform(0, 60, (20, 2)).astype(np.float32)
    Hm = TSD.random_homography(rng, H, W_)
    np.testing.assert_array_equal(TSD.apply_homography(Hm, uv), JSD.apply_homography(Hm, uv))
    np.testing.assert_array_equal(TSD.cell_labels(uv, H, W_), JSD.cell_labels(uv, H, W_))


def test_warp_bilinear_matches_jax():
    batch = batch_of(5, 4)
    want_w, want_v = (np.asarray(x) for x in jax_warp(jnp.asarray(batch["image"]), jnp.asarray(batch["H_ab"])))
    got_w, got_v = (x.numpy() for x in TTS.warp_bilinear(*(torch.from_numpy(batch[k]) for k in ("image", "H_ab"))))
    # The float64 source of every pixel: validity may differ only within BORDER_PX of the border.
    H_ba = np.linalg.inv(batch["H_ab"].astype(np.float64))
    v, u = np.mgrid[0:H, 0:W_]
    q = np.einsum("bij,hwj->bhwi", H_ba, np.stack([u, v, np.ones_like(u)], -1).astype(np.float64))
    su, sv = q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]
    near = np.minimum.reduce([np.abs(su), np.abs(su - (W_ - 1)), np.abs(sv), np.abs(sv - (H - 1))]) < BORDER_PX
    assert not ((got_v != want_v) & ~near).any()
    both = got_v & want_v
    assert both.mean() > 0.5
    np.testing.assert_allclose(got_w[both], want_w[both], atol=WARP_ATOL)
    assert (got_w[~got_v] == 0).all()


def test_warp_bilinear_clipped_edge_reads_as_jax():
    """Identity and a whole-pixel shift: sources at exactly u = W-1 and
    v = H-1 read column W-2 and row H-2 with weight 1, as in JAX."""
    img = np.random.default_rng(0).random((2, H, W_), np.float32)
    Hs = np.stack([np.eye(3, dtype=np.float32), np.array([[1, 0, -3], [0, 1, 2], [0, 0, 1]], np.float32)])
    want_w, want_v = (np.asarray(x) for x in jax_warp(jnp.asarray(img), jnp.asarray(Hs)))
    got_w, got_v = (x.numpy() for x in TTS.warp_bilinear(torch.from_numpy(img), torch.from_numpy(Hs)))
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(got_w[0, :-1, W_ - 1], img[0, :-1, W_ - 2])
    np.testing.assert_array_equal(got_w[0, H - 1, :-1], img[0, H - 2, :-1])
    assert got_w[0, H - 1, W_ - 1] == img[0, H - 2, W_ - 2]


def test_cell_labels_to_pixel_map_and_smear():
    labels = batch_of(6, 2)["label_a"]
    want = np.asarray(JTD._smear(JTD.labels_to_pixel_map(jnp.asarray(labels), H, W_), 1))
    got = TTD._smear(TTD.labels_to_pixel_map(torch.from_numpy(labels), H, W_), 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 0.5


# --------------------------------------------------------------------------
# Losses, gradients and the optimizer
# --------------------------------------------------------------------------


def test_loss_matches_jax(jax_run):
    loss, aux, _ = port_grads(jax_run["name"], jax_run["params"], jax_run["batch"])
    np.testing.assert_allclose(loss, jax_run["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux["det"], jax_run["det"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux["desc"], jax_run["desc"], rtol=LOSS_RTOL)


def test_gradients_match_jax(jax_run, monkeypatch):
    name, params, batch, warp = jax_run["name"], jax_run["params"], jax_run["batch"], jax_run["warp"]
    loss, _, got = port_grads(name, params, batch, warp=warp, monkeypatch=monkeypatch)
    np.testing.assert_allclose(loss, jax_run["loss"], rtol=LOSS_RTOL)
    _, _, ref64 = port_grads(name, params, batch, dtype=torch.float64, warp=warp, monkeypatch=monkeypatch)
    want = {k: v.numpy() for k, v in jax_run["grads"].items()}
    assert set(got) == set(want)
    assert_grads_close(got, want, ref64, name)


def test_adam_step_equals_optax(jax_run):
    """torch.optim.Adam (``adam``) from the same gradients: optax.adam's
    update, twice."""
    name, params = jax_run["name"], jax_run["params"]
    _, _, model_cls, _, to_state, from_state, _, _ = MODELS[name]
    model = model_cls(dtype=torch.float32)
    model.load_state_dict(to_state(params))
    opt = TTS.adam(model, LR)
    tx = optax.adam(LR)

    @jax.jit
    def adam_step(g, state, p):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    state, jp = tx.init(params), params
    grads_tree = _grads_tree(jax_run)
    for step in range(2):  # the second step from other gradients
        g = jax.tree.map(lambda x: jnp.asarray(x) * (1.0 + step), grads_tree)
        jp, state = adam_step(g, state, jp)
        port_g = to_state(g)
        for n, p in model.named_parameters():
            p.grad = port_g[n].clone()
        opt.step()
    got, want = flat(from_state(model.state_dict())), flat(jp)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ADAM_ATOL, err_msg=k)


def _grads_tree(jax_run):
    """JAX's gradients as its param tree (numpy leaves)."""
    _, _, _, _, _, from_state, _, _ = MODELS[jax_run["name"]]
    return from_state(jax_run["grads"])


def test_make_train_step_runs_and_descends():
    """Two float32 steps on one batch from Flax's default initial values
    (``init_state``): finite losses that fall, parameters that move."""
    model = TW.init_state(SuperPoint(dtype=torch.float32), torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = TTS.make_train_step(model, TTS.adam(model, LR))
    batch = batch_of(12, 1)
    losses = [float(step(batch)[0]) for _ in range(2)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(not torch.equal(before[n], p) for n, p in model.named_parameters())


@pytest.mark.parametrize("cls", [SuperPoint, Disk])
def test_init_state_draws_flax_defaults(cls):
    a = TW.init_state(cls(), torch.Generator().manual_seed(3))
    b = TW.init_state(cls(), torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q)
        if name.endswith("bias"):
            assert not p.any()
        elif p.dim() == 1:
            assert (p == 0.25).all()
        else:
            std = (1.0 / p[0].numel()) ** 0.5 / TW.TRUNCATED_NORMAL_STD
            assert p.abs().max() <= 2 * std
            if p.numel() > 5000:
                np.testing.assert_allclose(float(p.std()), (1.0 / p[0].numel()) ** 0.5, rtol=0.05)


# --------------------------------------------------------------------------
# The data-parallel step
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dp_inputs():
    model = SuperPoint(dtype=torch.float32)
    jparams = jax.jit(JSuperPoint(dtype=jnp.float32).init)(jax.random.PRNGKey(1), jnp.zeros((1, H, W_, 1)))
    model.load_state_dict(superpoint_state_from_flax(jparams))
    batch = batch_of(13, 4)
    one = SuperPoint(dtype=torch.float32)
    one.load_state_dict(model.state_dict())
    loss, aux = TTS.make_train_step(one, TTS.adam(one, W.TRAIN_LR))(batch)
    inputs = {**batch, **{f"param/{k}": v.numpy() for k, v in model.state_dict().items()}}
    single = dict(loss=float(loss), det=float(aux["det"]), desc=float(aux["desc"]),
                  grads={n: p.grad.clone() for n, p in one.named_parameters()},
                  params={n: p.detach().clone() for n, p in one.named_parameters()})
    return inputs, single


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_step_equals_one_device(dp_inputs, world, tmp_path):
    inputs, single = dp_inputs
    # The shards' counts differ, so per-shard means would not give the whole batch's loss.
    valid_cells = [TTS.warp_bilinear(torch.from_numpy(inputs["image"][i:i + 1]), torch.from_numpy(inputs["H_ab"][i:i + 1]))[1]
                   [:, 4::8, 4::8].sum().item() for i in range(4)]
    assert len(set(valid_cells)) > 1
    ranks = W.Ranks("train", world, inputs, tmp_path).results()
    for r in ranks[1:]:
        for k in ranks[0]:
            if k.startswith(("param/", "grad/")):
                np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    got = ranks[0]
    np.testing.assert_allclose(float(got["loss"]), single["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got["det"]), single["det"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got["desc"]), single["desc"], rtol=LOSS_RTOL)
    want = {n: g.numpy() for n, g in single["grads"].items()}
    assert_grads_close({n: torch.from_numpy(got[f"grad/{n}"]) for n in want}, want, what=f"world {world}")


# --------------------------------------------------------------------------
# The npz format, the CLI and the checkpoint converters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MODELS))
def test_npz_round_trip_both_ways(name, tmp_path):
    jmodel_cls, _, model_cls, _, to_state, from_state, _, ch = MODELS[name]
    model = TW.init_state(model_cls(dtype=torch.float32), torch.Generator().manual_seed(2))
    path = str(tmp_path / "port.npz")
    TTS.save_params_npz(path, from_state(model.state_dict()))
    with np.load(path) as f:
        assert all(f[k].dtype == np.float16 and k.startswith("params/") for k in f.files)
    # The port's file through the port's loader: the float16-rounded model, the same forward.
    back = model_cls(dtype=torch.float32)
    back.load_state_dict(to_state(TW.load_params_npz(path)))
    rounded = model_cls(dtype=torch.float32)
    rounded.load_state_dict({k: v.half().float() for k, v in model.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(0).random((1, ch, H, W_), np.float32))
    with torch.no_grad():
        for a, b in zip(back(x), rounded(x)):
            assert torch.equal(a, b)
    # The port's file through JAX's loader, and JAX's file through the port's.
    jtree = JTS.load_params_npz(path)
    want = flat(from_state(rounded.state_dict()))
    got = flat(jtree)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    jparams = jax.jit(jmodel_cls(dtype=jnp.float32).init)(jax.random.PRNGKey(4), jnp.zeros((1, H, W_, ch)))
    jpath = str(tmp_path / "jax.npz")
    JTS.save_params_npz(jpath, jparams)
    got = flat(TW.load_params_npz(jpath))
    for k, v in flat(jparams).items():
        np.testing.assert_array_equal(got[k], v.astype(np.float16).astype(np.float32))


@pytest.mark.parametrize("module", [TTS, TTD])
def test_train_writes_a_loadable_npz(module, tmp_path):
    """``train`` at a small size on the CPU: logged history, finite losses,
    an npz the serving path loads."""
    out = str(tmp_path / "w.npz")
    model, history = module.train(steps=2, batch=2, h=32, w=48, out=out, log_every=1, device="cpu")
    assert [h[0] for h in history] == [0, 1] and np.isfinite(np.asarray(history)).all()
    tree = TW.load_params_npz(out)
    to_state = superpoint_state_from_flax if module is TTS else disk_state_from_flax
    fresh = type(model)()
    fresh.load_state_dict(to_state(tree))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(), v.half().float().numpy())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_converters_match_jax_forward(name):
    """A published-shape state dict through the port's converter and the
    JAX package's, then each package's forward in float32."""
    rng = np.random.default_rng(9)
    if name == "superpoint":
        sd, jconv, tconv, jcls, tcls, ch = synthetic_superpoint_state(rng), JC.superpoint_from_torch, \
            TC.superpoint_from_torch, JSuperPoint, SuperPoint, 1
    else:
        sd = synthetic_disk_state(rng)
        for k in sd:
            if k.endswith("gate.weight"):
                sd[k] = rng.uniform(0.1, 0.4, sd[k].shape).astype(np.float32)
        sd, jconv, tconv, jcls, tcls, ch = sd, JC.disk_from_torch, TC.disk_from_torch, JDisk, Disk, 3
    model = tcls(dtype=torch.float32)
    model.load_state_dict(tconv(sd))
    x = rng.uniform(size=(1, 32, 48, ch)).astype(np.float32)
    want = jax.jit(jcls(dtype=jnp.float32).apply)(jconv(sd), jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
    if name == "disk":
        bad = dict(sd)
        bad.pop("unet.path_up.3.conv.1.weight")
        with pytest.raises(ValueError):
            tconv(bad)
