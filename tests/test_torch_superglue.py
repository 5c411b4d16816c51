"""The port's SuperGlue (``models/superglue.py``, ``match/superglue.py``)
against its plain float32 reference (``oracle/superglue.py``, one unpadded
pair at a time, as the public code runs it), on the CPU with seeded
weights: at a small size and at the published widths, batched pairs with
padding against each pair alone, Sinkhorn's marginals, the public
checkpoint's names and head layout, and the spans and counters.

This file imports nothing of the JAX package.  Float32 throughout, so the
tolerances are float32 rounding.  The seeded network's scores reach about
75 (its final projection is drawn wide, ``models/weights.py``), where
float32's spacing is 7.6e-6, so the log-assignment is held within 1e-5 of
its largest entry: the two sides sum in other orders and differ by about
5e-7 of it, all of it from the scores (Sinkhorn alone gives the same bits).
"""

import numpy as np
import pytest
import torch

from feature_detector_tpu_torch.core.config import SuperGlueOptions
from feature_detector_tpu_torch.core.types import Features
from feature_detector_tpu_torch.match.superglue import SuperGlueMatcher
from feature_detector_tpu_torch.models import weights as W
from feature_detector_tpu_torch.models.superglue import SuperGlue, head_major, log_optimal_transport
from feature_detector_tpu_torch.oracle import superglue as oracle
from feature_detector_tpu_torch.utils import trace

ROWS, COLS = 60, 80
SMALL = SuperGlueOptions(descriptor_dim=64, num_heads=2, gnn_layers=("self", "cross") * 2, sinkhorn_iterations=20,
                         image_rows=ROWS, image_cols=COLS)
PUBLISHED = SuperGlueOptions(image_rows=ROWS, image_cols=COLS)
ASSIGN_RTOL = 1e-5  # of the largest entry of the log-assignment (module docstring)


def matcher(opts, seed=3):
    m = SuperGlueMatcher(opts, device="cpu", dtype=torch.float32)
    m.initialize(W.init_superglue_state(SuperGlue(opts), torch.Generator().manual_seed(seed)))
    return m


def frame_pair(rng, m, n, d, shared):
    """Keypoints, scores and unit descriptors of two frames, the first
    ``shared`` of B being A's moved by a pixel with a little noise on the
    descriptor (so that the seeded network finds matches), as numpy."""
    uv_a = rng.uniform(0, [COLS, ROWS], (m, 2)).astype(np.float32)
    uv_b = rng.uniform(0, [COLS, ROWS], (n, 2)).astype(np.float32)
    da = rng.normal(size=(m, d)).astype(np.float32)
    db = rng.normal(size=(n, d)).astype(np.float32)
    uv_b[:shared] = uv_a[:shared] + 1
    db[:shared] = da[:shared] + 0.2 * rng.normal(size=(shared, d)).astype(np.float32)
    unit = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)
    return (uv_a, rng.uniform(0, 1, m).astype(np.float32), unit(da),
            uv_b, rng.uniform(0, 1, n).astype(np.float32), unit(db))


def padded(uv, score, desc, capacity):
    """Features ``[capacity]`` and descriptors with the valid slots first."""
    k = len(uv)
    pad = lambda x: np.concatenate([x, np.zeros((capacity - k,) + x.shape[1:], x.dtype)])
    valid = np.arange(capacity) < k
    return (Features(torch.from_numpy(pad(uv)), torch.from_numpy(pad(score)), torch.from_numpy(valid)),
            torch.from_numpy(pad(desc)))


def stack(feats):
    return Features(*(torch.stack([getattr(f, k) for f in feats]) for k in ("uv", "response", "valid")))


def run_batch(m, query, dbs, capacity):
    """(log-assignments, Matches) of ``query`` against ``dbs`` (each
    (uv, score, desc)) padded to ``capacity``."""
    qf, qd = padded(*query, capacity)
    pads = [padded(*db, capacity) for db in dbs]
    zs = []
    hook = m.model.register_forward_hook(lambda mod, args, out: zs.append(out))
    try:
        out = m.match_batch(qf, qd, stack([f for f, _ in pads]), torch.stack([d for _, d in pads]))
    finally:
        hook.remove()
    return zs[0], out


def reference(m, query, db):
    state = {k: v.float() for k, v in m.model.state_dict().items()}
    o = m.opts
    return oracle.superglue(state, *(torch.from_numpy(x) for x in query + db), o.image_rows, o.image_cols,
                            o.gnn_layers, o.num_heads, o.sinkhorn_iterations, o.match_threshold)


def close(got, want):
    return (got - want).abs().max() <= ASSIGN_RTOL * want.abs().max()


def valid_block(z, m, n):
    """Rows of the m valid slots and the dustbin, columns likewise."""
    rows = list(range(m)) + [z.shape[0] - 1]
    cols = list(range(n)) + [z.shape[1] - 1]
    return z[rows][:, cols]


@pytest.mark.parametrize("opts,m,n,shared,capacity", [(SMALL, 37, 53, 25, 64), (PUBLISHED, 32, 32, 24, 32)],
                         ids=["small", "published_widths"])
def test_port_equals_the_reference(opts, m, n, shared, capacity):
    sg = matcher(opts)
    rng = np.random.default_rng(11)
    pair = frame_pair(rng, m, n, opts.descriptor_dim, shared)
    z, out = run_batch(sg, pair[:3], [pair[3:]], capacity)
    rz, rmatch = reference(sg, pair[:3], pair[3:])
    assert close(valid_block(z[0], m, n), rz)
    assert torch.equal(out.index[0, :m].long(), rmatch)
    assert (rmatch >= 0).sum() >= 5  # the seeded network matches: the selection is exercised
    assert not out.valid[0, m:].any()
    kept = out.valid[0, :m]
    assert close(out.distance[0, :m][kept], -rz[:m][kept, rmatch[kept]])


def test_padding_changes_no_valid_slot_and_gets_no_match():
    sg = matcher(SMALL)
    rng = np.random.default_rng(5)
    d = SMALL.descriptor_dim
    query = frame_pair(rng, 29, 1, d, 0)[:3]
    dbs = []
    for n, shared in ((41, 20), (13, 9), (0, 0)):
        full = frame_pair(rng, 29, n, d, shared)
        q_uv, q_s, q_d = query
        db = list(full[3:])
        db[0][:shared], db[2][:shared] = q_uv[:shared] + 1, q_d[:shared]
        dbs.append(tuple(db))
    z, out = run_batch(sg, query, dbs, 48)
    assert torch.isfinite(z[:2]).any() and not torch.isnan(z).any()
    for p, db in enumerate(dbs):
        n = len(db[0])
        assert not out.valid[p, 29:].any() and not (out.index[p, 29:] >= 0).any()
        if n == 0:
            assert not out.valid[p].any()
            continue
        z_alone, out_alone = run_batch(sg, query, [db], max(29, n))
        assert close(valid_block(z[p], 29, n), valid_block(z_alone[0], 29, n))
        assert torch.equal(out.index[p, :29], out_alone.index[0, :29])
        assert out.valid[p].sum() > 0
    # An empty query against frames with keypoints: nothing to match, nothing undefined.
    empty = tuple(x[:0] for x in query)
    z, out = run_batch(sg, empty, dbs[:2], 48)
    assert not out.valid.any() and not torch.isnan(z).any()


def test_sinkhorn_meets_each_pairs_marginals():
    g = torch.Generator().manual_seed(2)
    p, na, nb = 3, 40, 50
    scores = 2 * torch.randn(p, na, nb, generator=g)  # 100 passes meet these within 1e-5; peakier scores converge slower
    valid_a = torch.arange(na)[None] < torch.tensor([40, 17, 3])[:, None]
    valid_b = torch.arange(nb)[None] < torch.tensor([22, 50, 9])[:, None]
    z = log_optimal_transport(scores, torch.tensor(1.0), valid_a, valid_b, 100)
    plan = z.exp()  # scaled by m + n: valid rows and columns sum to 1, the dustbins to n and m
    m, n = valid_a.sum(1), valid_b.sum(1)
    rows = torch.cat([valid_a.float(), n[:, None].float()], 1)
    cols = torch.cat([valid_b.float(), m[:, None].float()], 1)
    assert torch.allclose(plan.sum(2), rows, rtol=1e-4, atol=1e-4)
    assert torch.allclose(plan.sum(1), cols, rtol=1e-4, atol=1e-4)
    assert (plan[:, :na][~valid_a] == 0).all() and (plan.transpose(1, 2)[:, :nb][~valid_b] == 0).all()


def public_names(layers: int = 18) -> dict:
    """The public checkpoint's parameter names and shapes at the published widths."""
    names = {}
    widths = [3, 32, 64, 128, 256, 256]
    for i in range(5):
        names[f"kenc.encoder.{3 * i}.weight"] = (widths[i + 1], widths[i], 1)
        names[f"kenc.encoder.{3 * i}.bias"] = (widths[i + 1],)
        if i < 4:
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                names[f"kenc.encoder.{3 * i + 1}.{leaf}"] = (widths[i + 1],)
            names[f"kenc.encoder.{3 * i + 1}.num_batches_tracked"] = ()
    for layer in range(layers):
        pre = f"gnn.layers.{layer}"
        for conv in ["attn.merge"] + [f"attn.proj.{i}" for i in range(3)]:
            names[f"{pre}.{conv}.weight"], names[f"{pre}.{conv}.bias"] = (256, 256, 1), (256,)
        names[f"{pre}.mlp.0.weight"], names[f"{pre}.mlp.0.bias"] = (512, 512, 1), (512,)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            names[f"{pre}.mlp.1.{leaf}"] = (512,)
        names[f"{pre}.mlp.1.num_batches_tracked"] = ()
        names[f"{pre}.mlp.3.weight"], names[f"{pre}.mlp.3.bias"] = (256, 512, 1), (256,)
    names["final_proj.weight"], names["final_proj.bias"] = (256, 256, 1), (256,)
    names["bin_score"] = ()
    return names


def test_state_dict_has_the_public_names_and_head_layout():
    model = SuperGlue()
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == public_names()
    # Head h holds channels h, h + H, h + 2H, ... (the public view(b, dim, heads, n)).
    assert head_major(4, 8).tolist() == [0, 4, 1, 5, 2, 6, 3, 7]
    # A state dict of numpy arrays without the BatchNorm counters, as a converted checkpoint may be, loads.
    seeded = W.init_superglue_state(model, torch.Generator().manual_seed(1))
    as_numpy = {k: v.numpy() for k, v in seeded.items() if not k.endswith("num_batches_tracked")}
    other = SuperGlueMatcher(SuperGlueOptions(), device="cpu", dtype=torch.float32)
    other.initialize({k: v.astype(np.float16) if v.ndim > 1 else v for k, v in as_numpy.items()})
    assert other.model.final_proj.weight.dtype == torch.float32
    assert all(torch.equal(other.model.state_dict()[k], seeded[k].half().float() if seeded[k].ndim > 1 else seeded[k])
               for k in as_numpy)
    # The same seed gives the same weights; the published last biases are zero.
    again = W.init_superglue_state(SuperGlue(), torch.Generator().manual_seed(1))
    assert all(torch.equal(seeded[k], again[k]) for k in seeded)
    assert not seeded["kenc.encoder.12.bias"].any() and not seeded["gnn.layers.17.mlp.3.bias"].any()


def test_checkpoint_file_loads(tmp_path):
    seeded = W.init_superglue_state(SuperGlue(SMALL), torch.Generator().manual_seed(4))
    path = tmp_path / "superglue_small.pth"
    torch.save(seeded, path)
    a, b = SuperGlueMatcher(SMALL, device="cpu", dtype=torch.float32), matcher(SMALL, seed=4)
    a.initialize(str(path))
    c = SuperGlueMatcher(SMALL, device="cpu", dtype=torch.float32)
    c.initialize()  # seeded weights from a fixed seed
    assert torch.equal(c.model.final_proj.weight, matcher(SMALL, seed=0).model.final_proj.weight)
    assert all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values()))


@pytest.fixture
def fresh_tracer():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def test_spans_and_counters(fresh_tracer):
    sg = matcher(SMALL)
    rng = np.random.default_rng(8)
    query = frame_pair(rng, 21, 1, SMALL.descriptor_dim, 0)[:3]
    dbs = [frame_pair(rng, 1, n, SMALL.descriptor_dim, 0)[3:] for n in (30, 7)]
    assert [s.name for s in trace.spans()] == ["setup.superglue_initialize"]
    trace.clear()
    before = trace.counters()
    trace.enable()
    run_batch(sg, query, dbs, 32)
    trace.disable()
    recs = {s.name: s for s in trace.spans()}
    assert set(recs) == {"match.superglue", "models.superglue_encode", "models.superglue_gnn",
                         "models.superglue_sinkhorn", "match.superglue_select"}
    assert recs["match.superglue"].parent is None
    assert all(recs[k].parent == "match.superglue" for k in recs if k != "match.superglue")
    assert len({s.top for s in recs.values()}) == 1
    after = trace.summary()["counters"]
    delta = {k: after[k] - before.get(k, 0) for k in after}
    assert delta == {"superglue.pairs": 2, "superglue.keypoints": 2 * 21 + 30 + 7, "superglue.slots": 2 * 2 * 32,
                     "superglue.sinkhorn_iterations": SMALL.sinkhorn_iterations}
    assert set(trace.summary()["spans"]) == set(recs)
