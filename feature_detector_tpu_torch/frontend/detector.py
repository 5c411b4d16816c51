"""Classical point-detector front-end.

Counterpart of ``feature_detector_tpu/frontend/detector.py``: the same entry
points, arguments and fixed-capacity outputs.  Existing features seed the
suppression mask and new detections are appended after them (incremental
re-detection, quirk Q9).  FAST goes through ``kernels.fast.fast_maps`` and
the greedy selection through ``kernels.greedy.greedy_select``: the CUDA
kernels for tensors on the card, their plain versions for CPU tensors.

Entry points run on ``cuda`` unless handed CPU tensors or ``device="cpu"``.
"""

from __future__ import annotations

import torch

from ..core.config import DetectorOptions, FastOptions, HarrisOptions, ShiTomasiOptions
from ..core.device import DeviceLike, as_tensor
from ..core.types import Features
from ..kernels import detect as K
from ..kernels.fast import fast_maps
from ..kernels.greedy import greedy_select
from ..utils import trace


def _default_sub(kind: str):
    subs = {"harris": HarrisOptions(), "shi_tomasi": ShiTomasiOptions(), "fast": FastOptions()}
    if kind not in subs:
        raise ValueError(f"unknown detector kind: {kind}")
    return subs[kind]


def _candidate_map(image, mask, kind: str, opts, sub):
    """Returns (candidate map for selection, raw response map for subpixel;
    FAST gives None for the latter unless ``opts.subpixel``).  ``mask`` None
    gates no pixel."""
    if kind == "fast":
        return fast_maps(image, mask, sub, opts.min_valid_response, want_response=opts.subpixel)
    if mask is None:
        mask = torch.ones(image.shape[-2:], dtype=torch.int32, device=image.device)
    if kind == "harris":
        resp = K.harris_response(image, mask, opts, sub)
        return K.nms4(resp, opts.min_valid_response, sub.half_patch_size + 1), resp
    if kind == "shi_tomasi":
        resp = K.shi_tomasi_response(image, mask, opts, sub)
        return K.nms4(resp, opts.min_valid_response, sub.half_patch_size + 1), resp
    raise ValueError(f"unknown detector kind: {kind}")


def detect_good_features(
    image,
    existing: Features,
    kind: str,
    needed_num: int,
    opts: DetectorOptions = DetectorOptions(),
    sub=None,
    device: DeviceLike = None,
) -> Features:
    """DetectGoodFeatures (feature_point_detector.cpp:7-25), fixed-shape.

    Args:
      image: [H, W] uint8 (tensor or numpy array).
      existing: already-detected features of capacity ``opts.max_features``
        (``Features.empty(opts.max_features)`` for a fresh detection), on
        the image's device.
      kind: "harris" | "shi_tomasi" | "fast".
      needed_num: total feature budget (existing + new).

    Returns Features of capacity ``opts.max_features``: the existing prefix
    followed by the new picks.
    """
    image = as_tensor(image, device)
    capacity = opts.max_features
    if existing.capacity != capacity:
        raise ValueError(f"existing capacity {existing.capacity} != opts.max_features {capacity}")
    cand, raw_resp = detection_maps(image, existing, kind, opts, sub)

    n_stop = torch.clamp(needed_num - existing.count, min=0).to(torch.int32).reshape(1)
    # A zero budget returns no new features (documented divergence from the
    # reference); max_picks >= 1 keeps shapes non-empty.
    max_picks = max(1, min(needed_num, capacity))
    new_uv, new_resp, new_valid = greedy_select(cand, max_picks, n_stop, opts.min_feature_distance)
    if opts.subpixel:
        new_uv = K.subpixel_refine(raw_resp, new_uv, new_valid)
    return append_after_existing(existing, new_uv, new_resp, new_valid)


def detection_maps(image: torch.Tensor, existing: Features, kind: str, opts: DetectorOptions = DetectorOptions(),
                   sub=None):
    """The maps ``detect_good_features`` computes before its greedy
    selection: (candidate map [H, W] f32, raw response for the subpixel
    fit, None for FAST without the fit), with the existing features'
    squares suppressed."""
    sub = _default_sub(kind) if sub is None else sub
    mask = K.make_suppression_mask(image.shape, existing.uv, existing.valid, opts.min_feature_distance)
    return _candidate_map(image, mask, kind, opts, sub)


def append_after_existing(existing: Features, new_uv, new_resp, new_valid) -> Features:
    """The new picks ``[P, ...]`` written after the existing prefix (Q9):
    slot ``count + j`` takes pick ``j``, slots past the last pick are
    invalid."""
    capacity, max_picks = existing.capacity, new_uv.shape[0]
    n_existing = existing.count
    idx = torch.arange(capacity, device=new_uv.device)
    rel = idx - n_existing
    src = torch.clamp(rel, 0, max_picks - 1)
    src_ok = rel < max_picks
    from_new = idx >= n_existing
    uv = torch.where(from_new[:, None], new_uv[src], existing.uv)
    resp = torch.where(from_new & src_ok, new_resp[src], existing.response)
    valid = torch.where(from_new, new_valid[src] & src_ok, existing.valid)
    return Features(uv=uv, response=resp, valid=valid)


def detect_good_features_batch(
    images,
    kind: str,
    needed_num: int,
    opts: DetectorOptions = DetectorOptions(),
    sub=None,
    device: DeviceLike = None,
) -> Features:
    """Fresh (no existing features) detection over a [B, H, W] uint8 stack.

    Per frame the same as ``detect_good_features(im, Features.empty(..), ..)``;
    the greedy selection of the whole stack is one kernel launch.
    """
    sub = _default_sub(kind) if sub is None else sub
    with trace.span("frontend.detect_batch"):
        images = as_tensor(images, device)
        capacity = opts.max_features
        with trace.span(f"kernels.{kind}", device=True):
            cand, raw_resp = _candidate_map(images, None, kind, opts, sub)
        max_picks = max(1, min(needed_num, capacity))
        new_uv, new_resp, new_valid = greedy_select(cand, max_picks, needed_num, opts.min_feature_distance)
        if opts.subpixel:
            new_uv = K.subpixel_refine(raw_resp, new_uv, new_valid)
        pad = capacity - max_picks
        if pad:
            new_uv = torch.nn.functional.pad(new_uv, (0, 0, 0, pad))
            new_resp = torch.nn.functional.pad(new_resp, (0, pad))
            new_valid = torch.nn.functional.pad(new_valid, (0, pad))
        return Features(uv=new_uv, response=new_resp, valid=new_valid)


def sparsify_features(
    features: Features,
    status: torch.Tensor,
    image_rows: int,
    image_cols: int,
    status_need_filter: int,
    status_after_filter: int,
    opts: DetectorOptions = DetectorOptions(),
) -> torch.Tensor:
    """Grid filter (feature_point_detector.cpp:27-52): the first feature (by
    slot order) to claim a grid cell keeps its status; later claimants with
    ``status_need_filter`` get ``status_after_filter``.  Out-of-grid valid
    features are filtered whatever their status."""
    grid_rows = opts.grid_filter_row_divide_number
    grid_cols = opts.grid_filter_col_divide_number
    grid_row_step = image_rows / (grid_rows - 1)
    grid_col_step = image_cols / (grid_cols - 1)

    n = features.uv.shape[0]
    row = (features.uv[:, 1] / grid_row_step).to(torch.int32)
    col = (features.uv[:, 0] / grid_col_step).to(torch.int32)
    in_grid = (row >= 0) & (row <= grid_rows - 1) & (col >= 0) & (col <= grid_cols - 1)
    cell = (torch.clamp(row, 0, grid_rows - 1) * grid_cols + torch.clamp(col, 0, grid_cols - 1)).to(torch.int64)

    needs = status == status_need_filter
    slot = torch.arange(n, dtype=torch.int32, device=status.device)
    claim_slot = torch.where(needs & in_grid & features.valid, slot, torch.full_like(slot, n))
    first_claim = torch.full((grid_rows * grid_cols,), n, dtype=torch.int32, device=status.device)
    first_claim.scatter_reduce_(0, cell, claim_slot, reduce="amin")
    is_first = first_claim[cell] == slot

    after = torch.full_like(status, status_after_filter)
    out = torch.where(features.valid & needs & (~in_grid | ~is_first), after, status)
    return torch.where(features.valid & ~in_grid, after, out)
