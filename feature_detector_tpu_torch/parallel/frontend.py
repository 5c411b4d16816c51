"""Multi-device front-end: frame-parallel and row-sharded detection.

Counterpart of ``feature_detector_tpu/parallel/frontend.py``.

- Frame parallelism (``make_batched_frontend``, ``make_two_frame_matcher``):
  every rank takes its contiguous block of the frame batch, runs the port's
  batched detector on it (one greedy-selection launch pair, the CUDA kernel
  K1 on the card) and BRIEF, and the blocks are all-gathered, so every rank
  returns the whole batch.  The batch must divide by the ``data`` axis, as
  the JAX package's sharding requires.
- Row sharding (``make_row_sharded_response``): one image's rows split over
  the ``space`` axis; each rank computes the gated Harris or Shi-Tomasi
  response of its slab after a halo exchange, gated with global row
  indices, so the slabs put together equal the single-device map.
  Selection stays global (a suppression square can cross slab borders).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core.config import BriefOptions, DetectorOptions, HarrisOptions, MatcherOptions, ShiTomasiOptions
from ..core.device import as_tensor
from ..core.types import Features, Matches
from ..frontend.detector import detect_good_features_batch
from ..kernels import detect as K
from ..kernels.brief import brief_compute
from ..match.hamming import match_hamming
from ..utils import trace
from .halo import exchange_halo
from .mesh import axis_index, axis_size, gather_leading, mesh_device, shard_leading


def _gather_features(f: Features, mesh: DeviceMesh, axis: str) -> Features:
    return Features(*(gather_leading(x, mesh, axis) for x in (f.uv, f.response, f.valid)))


def make_batched_frontend(
    mesh: DeviceMesh,
    kind: str = "harris",
    needed_num: int = 200,
    opts: DetectorOptions = DetectorOptions(),
    sub=None,
    brief_opts: BriefOptions = BriefOptions(),
    data_axis: str = "data",
):
    """Frame-parallel detect + describe.

    Returns fn(images [B, H, W] uint8, the same on every rank) ->
    (Features [B, N], words [B, N, W], desc_valid [B, N]) on this rank's
    device, the whole batch on every rank.
    """

    def run(images) -> Tuple[Features, torch.Tensor, torch.Tensor]:
        local = shard_leading(as_tensor(images, mesh_device(mesh)), mesh, data_axis)
        feats = detect_good_features_batch(local, kind, needed_num, opts, sub)
        words, dvalid = brief_compute(local, feats.uv, feats.valid, brief_opts)
        return (_gather_features(feats, mesh, data_axis), gather_leading(words, mesh, data_axis),
                gather_leading(dvalid, mesh, data_axis))

    return run


def make_row_sharded_response(
    mesh: DeviceMesh,
    kind: str = "harris",
    opts: DetectorOptions = DetectorOptions(),
    sub=None,
    space_axis: str = "space",
):
    """Row-sharded gated response.

    Returns fn(image slab [H / n, W] uint8, mask slab [H / n, W] int32) ->
    this rank's slab of the gated response map (rank i holds rows
    i H / n ... (i + 1) H / n).  Equal to ``harris_response`` /
    ``shi_tomasi_response`` of the whole image, slab by slab.
    """
    if kind == "harris":
        sub = sub or HarrisOptions()
        raw = lambda img: K.harris_response_raw(img, sub)
    elif kind == "shi_tomasi":
        sub = sub or ShiTomasiOptions()
        raw = lambda img: K.shi_tomasi_response_raw(img, sub)
    else:
        raise ValueError(kind)
    bound = sub.half_patch_size + 1
    halo = bound + 1  # gradient radius 1 + box radius + slack

    def run(local_img, local_mask) -> torch.Tensor:
        dev = mesh_device(mesh)
        local_img = as_tensor(local_img, dev)
        local_mask = as_tensor(local_mask, dev)
        rows, cols = local_img.shape
        n, i = axis_size(mesh, space_axis), axis_index(mesh, space_axis)
        padded = exchange_halo(local_img.to(torch.float32), halo, mesh, space_axis)
        res = raw(padded)[halo:halo + rows]
        g_row = i * rows + torch.arange(rows, device=dev)[:, None]
        g_col = torch.arange(cols, device=dev)[None, :]
        region = (g_row >= bound) & (g_row < n * rows - bound) & (g_col >= bound) & (g_col < cols - bound)
        keep = region & (local_mask != 0) & (res > opts.min_valid_response)
        return torch.where(keep, res, torch.zeros((), dtype=res.dtype, device=dev))

    return run


def make_two_frame_matcher(
    mesh: DeviceMesh,
    kind: str = "fast",
    needed_num: int = 200,
    opts: DetectorOptions = DetectorOptions(),
    sub=None,
    brief_opts: BriefOptions = BriefOptions(),
    matcher_opts: MatcherOptions = MatcherOptions(),
    data_axis: str = "data",
):
    """Frame-pair pipeline: detect and describe both frames of each pair,
    then cross-checked Hamming matching; pairs split over ``data_axis``.

    Returns fn(images_a [B, H, W], images_b [B, H, W]) -> (Features A,
    Features B, Matches), each [B, ...], the whole batch on every rank.
    """

    def run(images_a, images_b) -> Tuple[Features, Features, Matches]:
        with trace.span("parallel.two_frame", device=True):
            with trace.span("parallel.local", device=True):
                dev = mesh_device(mesh)
                la = shard_leading(as_tensor(images_a, dev), mesh, data_axis)
                lb = shard_leading(as_tensor(images_b, dev), mesh, data_axis)
                fa = detect_good_features_batch(la, kind, needed_num, opts, sub)
                fb = detect_good_features_batch(lb, kind, needed_num, opts, sub)
                wa, va = brief_compute(la, fa.uv, fa.valid, brief_opts)
                wb, vb = brief_compute(lb, fb.uv, fb.valid, brief_opts)
                m = match_hamming(wa, va, wb, vb, matcher_opts)
            return (_gather_features(fa, mesh, data_axis), _gather_features(fb, mesh, data_axis),
                    Matches(*(gather_leading(x, mesh, data_axis) for x in (m.index, m.distance, m.valid))))

    return run
