"""Which operations of the port's chunk solver round differently when the
chunk batch is smaller.  The fused VO splits its chunk batch over a mesh
(``slam/vo_fused.py``), which holds only if no operation does: the solver's
float32 products, sums and solves go through K4 and K5 (``slam/fixed.py``)
for that reason, and this probe shows what is left.

    python -m tests.torch_chunk_batch_probe [--cpu] [--frames N] [--ks 5 1] [--blocks 5 1]

Builds the fused VO's chunk problems of the bench sequence (``--frames``
frames, 17 chunks at 120), solves them with ``solve_chunks`` as one batch
and in blocks of each ``--blocks`` size (padded with empty problems), and
prints how many chunks are the same bits.  Then solves them once more under
a torch dispatch mode that reruns every aten op whose tensor arguments carry
the chunk batch on one of their first two axes on the first k chunks' slice
(each ``--ks``) and prints every op site whose output differs, bit for bit,
from the same slice of the whole batch's: the same inputs, a smaller batch.
Ops inside ``torch.func`` transforms (counted under "skipped") and ops
that take the batch size as an argument are not probed; the blocks above
cover them.  The card by default (builds the kernels for the
front-end); ``--cpu`` on the CPU.  Imports nothing of JAX.
"""

import argparse
import collections
import json
import sys
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

NOT_PROBED = ("rand", "uniform", "normal", "exponential", "bernoulli", "multinomial", "_local_scalar_dense", "empty",
              "zeros", "ones", "full", "arange", "linspace", "scalar_tensor", "lift_fresh")
_TRANSFORM_DEPTH = [0]


def _counted(fn, returns_function: bool):
    """``fn`` (a torch.func transform) marking the time its function runs."""

    def enter(call):
        def run(*a, **kw):
            _TRANSFORM_DEPTH[0] += 1
            try:
                return call(*a, **kw)
            finally:
                _TRANSFORM_DEPTH[0] -= 1

        return run

    return (lambda *a, **kw: enter(fn(*a, **kw))) if returns_function else enter(fn)


def _site() -> str:
    for fr in reversed(traceback.extract_stack()[:-3]):
        if "feature_detector_tpu_torch" in fr.filename:
            return f"{fr.filename.split('feature_detector_tpu_torch/')[-1]}:{fr.lineno} {fr.line.strip()[:110]}"
    return "?"


class BatchProbe(TorchDispatchMode):
    """Reruns each op on the first ``k`` of ``n`` chunks' slices and records
    the op sites whose outputs differ from the whole batch's slice."""

    def __init__(self, n: int, ks):
        super().__init__()
        self.n, self.ks = n, ks
        self.differs = collections.OrderedDict()
        self.probed = 0
        self.skipped = collections.Counter()

    def _axis(self, x):
        if isinstance(x, torch.Tensor) and x.device.type != "meta":
            for d in range(min(2, x.dim())):
                if x.shape[d] >= self.n and x.shape[d] % self.n == 0:
                    return d
        return None

    def _cut(self, x, k: int, mutable: bool):
        d = self._axis(x)
        if d is not None:
            y = x.narrow(d, 0, k * (x.shape[d] // self.n))
            return y.clone(memory_format=torch.preserve_format) if mutable else y
        return x.clone() if isinstance(x, torch.Tensor) and mutable else x

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        flat, _ = tree_flatten((args, kwargs))
        tensors = [x for x in flat if isinstance(x, torch.Tensor)]
        sizes = [x for x in flat if isinstance(x, int) and not isinstance(x, bool)]
        if _TRANSFORM_DEPTH[0] > 0:
            self.skipped["inside torch.func"] += 1
            return func(*args, **kwargs)
        if (not any(self._axis(t) is not None for t in tensors) or any(s in name for s in NOT_PROBED)
                or any(v >= self.n and v % self.n == 0 for v in sizes)):
            return func(*args, **kwargs)
        mutable = func._schema.is_mutable
        small_args = {k: tree_map(lambda x: self._cut(x, k, mutable), (args, kwargs)) for k in self.ks}
        out = func(*args, **kwargs)
        outs, _ = tree_flatten(out)
        self.probed += 1
        for k in self.ks:
            a, kw = small_args[k]
            try:
                small, _ = tree_flatten(func(*a, **kw))
            except Exception:
                self.skipped[f"raised: {name}"] += 1
                continue
            for o, s in zip(outs, small):
                if not isinstance(o, torch.Tensor) or not isinstance(s, torch.Tensor) or "meta" in (
                        o.device.type, s.device.type):
                    continue
                d = self._axis(o)
                if d is None or s.dim() != o.dim() or s.shape[d] != k * (o.shape[d] // self.n):
                    self.skipped[f"shape: {name}"] += 1
                    continue
                ref = o.narrow(d, 0, s.shape[d])
                if ref.shape != s.shape:
                    self.skipped[f"shape: {name}"] += 1
                    continue
                same = ((ref == s) | (ref.isnan() & s.isnan())).all() if ref.is_floating_point() else (ref == s).all()
                if not bool(same):
                    e = self.differs.setdefault((k, name, _site()), {"n": 0, "max_abs": 0.0,
                                                                     "shapes": [list(t.shape) for t in tensors][:4]})
                    e["n"] += 1
                    if ref.is_floating_point():
                        e["max_abs"] = max(e["max_abs"], float((ref.double() - s.double()).abs().nan_to_num(0).max()))
        return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--ks", type=int, nargs="+", default=[5, 1])
    ap.add_argument("--blocks", type=int, nargs="*", default=[5, 1])
    args = ap.parse_args(argv)
    import chip_smoke as CS
    from feature_detector_tpu_torch.slam.sequence import make_synthetic_sequence
    from feature_detector_tpu_torch.slam.vo_fused import solve_chunks

    dev = torch.device("cpu" if args.cpu else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not args.cpu:
        from feature_detector_tpu_torch.kernels import _build

        _build.build()
        print(CS.nvidia_smi_line(), flush=True)
    seq = make_synthetic_sequence(n_frames=args.frames, n_landmarks=CS.VO_LANDMARKS, seed=CS.VO_SEED, motion="lateral",
                                  angle_step=0.03)
    track_uv, track_has, solve_args, _, _ = CS.vo_chunk_problems(torch, seq, torch.from_numpy(seq.images).to(dev))
    tu, th = torch.from_numpy(track_uv).to(dev), torch.from_numpy(track_has).to(dev)
    n = tu.shape[0]
    print(json.dumps({"chunks": n, "track_uv": list(tu.shape)}), flush=True)
    whole = [x.cpu() for x in solve_chunks(tu, th, *solve_args)]
    for b in args.blocks:
        padded = -(-n // b) * b
        pu = torch.cat([tu, tu.new_zeros((padded - n, *tu.shape[1:]))])
        ph = torch.cat([th, th.new_zeros((padded - n, *th.shape[1:]))])
        outs = [solve_chunks(pu[i:i + b], ph[i:i + b], *solve_args) for i in range(0, padded, b)]
        got = [torch.cat([o[j].cpu() for o in outs])[:n] for j in range(len(whole))]
        same = sum(all(torch.equal(g[c], w[c]) for g, w in zip(got, whole)) for c in range(n))
        print(json.dumps({"block": b, "chunks_bitwise_to_one_batch": same, "of": n}), flush=True)
    vmap, jvp = torch.func.vmap, torch.func.jvp
    torch.func.vmap, torch.func.jvp = _counted(vmap, True), _counted(jvp, False)
    try:
        t0 = time.perf_counter()
        probe = BatchProbe(n, args.ks)
        with probe:
            solve_chunks(tu, th, *solve_args)
    finally:
        torch.func.vmap, torch.func.jvp = vmap, jvp
    print(json.dumps({"probe_s": time.perf_counter() - t0, "ops_probed": probe.probed,
                      "skipped": dict(probe.skipped)}), flush=True)
    for (k, name, site), e in probe.differs.items():
        print(json.dumps({"k": k, "op": name, "site": site, **e}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
