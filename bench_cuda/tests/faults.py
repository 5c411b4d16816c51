"""Runs the benchmark with the timed path broken underneath, for the tests
that see ``correct`` come out false.

    BENCH_CUDA_FAULT=<fault> python -m bench_cuda.tests.faults <bench_cuda.run arguments>

The fault is applied to the program's module before the run's set-up, in
this process and, through the environment, in every rank it starts:

- ``half_batch``: detection covers the first half of each frame stack and
  leaves the rest empty;
- ``altered_match``: the first slot of every pair's matches is altered
  where the matcher produces it;
- ``altered_word``: one bit of the first descriptor of every frame flips;
- ``exchange``: the all-gathers between ranks are left out (each rank's
  block stands in for every rank's);
- ``altered_feature``: the NN detector's first feature moves one pixel;
- ``altered_desc``: the NN detector's first descriptor is altered;
- ``heat_patch``: DISK's heatmap is inverted in one 16x16 patch where the
  model produces it, a fault that the mean over whole frames dilutes;
- ``lazy_jax``: the check loads a module named ``jax`` once the window has
  closed (a stand-in, as a lazy import in the outputs or the check would).
"""

from __future__ import annotations

import os
import sys
import types

import torch


def _half_batch():
    from feature_detector_tpu_torch.core.types import Features
    from feature_detector_tpu_torch.frontend import detector
    from feature_detector_tpu_torch.parallel import frontend

    real = detector.detect_good_features_batch

    def half(images, *args, **kw):
        f = real(images[: len(images) // 2], *args, **kw)
        pad = len(images) - len(f.uv)
        return Features(*(torch.cat([x, torch.zeros((pad, *x.shape[1:]), dtype=x.dtype, device=x.device)])
                          for x in (f.uv, f.response, f.valid)))

    detector.detect_good_features_batch = half
    frontend.detect_good_features_batch = half


def _altered_match():
    from feature_detector_tpu_torch.core.types import Matches
    from feature_detector_tpu_torch.match import hamming
    from feature_detector_tpu_torch.parallel import frontend

    real = hamming.match_hamming

    def altered(*args, **kw):
        m = real(*args, **kw)
        index = m.index.clone()
        index[..., 0] = (index[..., 0] + 1) % index.shape[-1]
        return Matches(index=index, distance=m.distance, valid=m.valid)

    hamming.match_hamming = altered
    frontend.match_hamming = altered


def _altered_word():
    from feature_detector_tpu_torch.core.types import Descriptors
    from feature_detector_tpu_torch.frontend import descriptor

    real = descriptor.compute_descriptors

    def altered(*args, **kw):
        d = real(*args, **kw)
        words = d.words.clone()
        words[..., 0, 0] ^= 1
        return Descriptors(words=words, valid=d.valid)

    descriptor.compute_descriptors = altered


def _exchange():
    from feature_detector_tpu_torch.parallel import frontend, mesh

    def local_only(x, m, axis="data"):
        return torch.cat([x] * mesh.axis_size(m, axis))

    frontend.gather_leading = local_only


def _nn(alter):
    from feature_detector_tpu_torch.frontend.nn_detector import NNFeaturePointDetector

    real = NNFeaturePointDetector.detect

    def detect(self, *args, **kw):
        feats, desc = real(self, *args, **kw)
        return alter(feats, desc)

    NNFeaturePointDetector.detect = detect


def _altered_feature():
    from feature_detector_tpu_torch.core.types import Features

    def alter(feats, desc):
        uv = feats.uv.clone()
        uv[0, 0] += 1
        return Features(uv=uv, response=feats.response, valid=feats.valid), desc

    _nn(alter)


def _altered_desc():
    def alter(feats, desc):
        desc = desc.clone()
        desc[0] = -desc[0]
        return feats, desc

    _nn(alter)


def _heat_patch():
    from feature_detector_tpu_torch.models.disk import Disk

    real = Disk.forward

    def forward(self, x):
        heat, desc = real(self, x)
        heat = heat.clone()
        heat[:, 8:24, 40:56] = 1 - heat[:, 8:24, 40:56]
        return heat, desc

    Disk.forward = forward


def _lazy_jax():
    from bench_cuda.pipelines import fast_brief, nn_stream

    for pipe in (fast_brief, nn_stream):
        def check(run, outs, real=pipe.check):
            sys.modules.setdefault("jax", types.ModuleType("jax"))
            return real(run, outs)

        pipe.check = check


FAULTS = {"half_batch": _half_batch, "altered_match": _altered_match, "altered_word": _altered_word,
          "exchange": _exchange, "altered_feature": _altered_feature, "altered_desc": _altered_desc, "heat_patch": _heat_patch,
          "lazy_jax": _lazy_jax}


def main(argv=None) -> int:
    from bench_cuda import run

    FAULTS[os.environ["BENCH_CUDA_FAULT"]]()
    return run.main(argv, entry="bench_cuda.tests.faults")


if __name__ == "__main__":
    sys.exit(main())
