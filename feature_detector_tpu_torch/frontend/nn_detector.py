"""NN feature-point detector front-end (SuperPoint / DISK).

Counterpart of ``feature_detector_tpu/frontend/nn_detector.py`` for the four
``NNModelType``s: the model's forward pass (``models/superpoint.py``,
``models/disk.py``), then the post-processing, both on the detector's device.

- Heatmap types: candidates above ``min_response`` outside the mask (3-px
  boundary band and the existing features' squares), greedy selection, and
  bilinear descriptor sampling at (u/8, v/8) with zeros at the map border.
- NMS types: the model's top-K head (``models.superpoint.nms_head``), then
  greedy selection over its candidate list in score order, each candidate
  kept unless it lies in the boundary band, within ``min_feature_distance``
  (Chebyshev) of a feature already kept, or past the capacity.

Both go through ``kernels.greedy.greedy_select``: the CUDA kernel for maps on
the card, its plain version for CPU maps.  Existing features stay in their
slots and the new ones are appended after them (incremental re-detection).

Entry points run on ``cuda`` unless handed CPU tensors or ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.config import NNDetectorOptions, NNModelType
from ..core.convert import disk_state_from_flax, superpoint_state_from_flax
from ..core.device import DeviceLike, as_tensor, resolve_device
from ..core.types import Features
from ..kernels.detect import make_suppression_mask
from ..kernels.greedy import greedy_select
from ..kernels.nn_ops import STRIDE, sample_descriptor_grid
from ..models import weights as W
from ..models.disk import Disk, preprocess_gray_rgb
from ..models.superpoint import SuperPoint, nms_head, preprocess_gray
from ..utils import trace
from .detector import append_after_existing

NMS_TYPES = (NNModelType.SUPERPOINT_NMS, NNModelType.DISK_NMS)


def create_nn_mask(shape: Tuple[int, int], existing_uv: torch.Tensor, existing_valid: torch.Tensor,
                   opts: NNDetectorOptions) -> torch.Tensor:
    """int32 mask: 0 in the ``invalid_boundary`` band and inside each valid
    existing feature's clipped (2r+1)^2 square, 1 elsewhere."""
    rows, cols = shape
    mask = make_suppression_mask(shape, existing_uv, existing_valid, opts.min_feature_distance)
    b = opts.invalid_boundary
    if b:
        rr = torch.arange(rows, device=mask.device)[:, None]
        cc = torch.arange(cols, device=mask.device)[None, :]
        border = (rr < b) | (rr >= rows - b) | (cc < b) | (cc >= cols - b)
        mask = torch.where(border, torch.zeros_like(mask), mask)
    return mask


def _check_capacity(existing: Features, opts: NNDetectorOptions) -> int:
    capacity = opts.max_number_of_detected_features
    if existing.capacity != capacity:
        raise ValueError(f"existing capacity {existing.capacity} != max_number_of_detected_features {capacity}")
    return capacity


def heatmap_candidates(heatmap: torch.Tensor, existing: Features, opts: NNDetectorOptions) -> torch.Tensor:
    """The heatmap types' candidate map for greedy selection: the heatmap
    where it exceeds ``min_response`` outside the mask, 0 elsewhere."""
    with trace.span("frontend.nn_candidates"):
        mask = create_nn_mask(tuple(heatmap.shape), existing.uv, existing.valid, opts)
        return torch.where((heatmap > opts.min_response) & (mask != 0), heatmap, torch.zeros_like(heatmap))


def select_features_from_heatmap(heatmap: torch.Tensor, existing: Features, opts: NNDetectorOptions) -> Features:
    """Candidates above ``min_response`` outside the mask, picked greedily
    (one ``greedy_select`` call) and appended after ``existing``."""
    capacity = _check_capacity(existing, opts)
    n_stop = torch.clamp(capacity - existing.count, min=0).to(torch.int32).reshape(1)
    cand = heatmap_candidates(heatmap, existing, opts)
    new_uv, new_resp, new_valid = greedy_select(cand, capacity, n_stop, opts.min_feature_distance)
    return append_after_existing(existing, new_uv, new_resp, new_valid)


def nms_candidates(kpts: torch.Tensor, scores: torch.Tensor, existing: Features, opts: NNDetectorOptions,
                   rows: int, cols: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The NMS types' candidate map for greedy selection: each candidate's
    score at its pixel unless its score is <= 0, it lies outside the
    ``invalid_boundary`` band or within ``min_feature_distance`` of a valid
    existing feature (JAX's float test on the existing uv, not the
    truncated suppression mask).  Returns (score map ``[rows, cols]``
    float32, owner ``[rows * cols]``: the first such candidate of each
    pixel, clamped to K - 1 where there is none)."""
    with trace.span("frontend.nn_candidates"):
        r, b = opts.min_feature_distance, opts.invalid_boundary
        k = kpts.shape[0]
        u = kpts[:, 0].to(torch.float32)
        v = kpts[:, 1].to(torch.float32)
        inb = (u >= b) & (u < cols - b) & (v >= b) & (v < rows - b)
        near = (existing.valid[None, :]
                & ((existing.uv[None, :, 0] - u[:, None]).abs() <= r)
                & ((existing.uv[None, :, 1] - v[:, None]).abs() <= r))
        ok = (scores > 0) & inb & ~near.any(dim=1)
        flat = torch.where(ok, kpts[:, 1].to(torch.int64) * cols + kpts[:, 0].to(torch.int64), 0)
        owner = torch.full((rows * cols,), k, dtype=torch.int64, device=scores.device)
        owner.scatter_reduce_(0, flat, torch.where(ok, torch.arange(k, device=scores.device), k), reduce="amin")
        owned = owner < k
        owner = torch.clamp(owner, max=k - 1)
        score_map = torch.where(owned, scores[owner], torch.zeros((), dtype=scores.dtype, device=scores.device))
        return score_map.view(rows, cols), owner


def directly_select_features(
    kpts: torch.Tensor,
    scores: torch.Tensor,
    descs: torch.Tensor,
    existing: Features,
    opts: NNDetectorOptions,
    rows: int,
    cols: int,
) -> Tuple[Features, torch.Tensor]:
    """The NMS types' selection over the head's candidates (int32 ``kpts``
    ``[K, 2]`` as (u, v), ``scores`` ``[K]``, ``descs`` ``[K, D]``), kept in
    list order unless a candidate has score <= 0, lies outside the
    ``invalid_boundary`` band, is within ``min_feature_distance`` (Chebyshev)
    of a valid existing feature or of a candidate kept before it, or comes
    after the capacity is full.

    The list must be in descending score order with equal scores in
    row-major order of their pixels, as ``nms_head`` emits it.  Then the
    loop equals one greedy selection: the candidates left after the score,
    band and existing-feature tests are scattered into a score map (the
    first of a pixel owns it; a later one there would fall in its square),
    and greedy selection picks by descending value with row-major ties and
    suppresses the (2r+1)^2 square around each pick, which is the Chebyshev
    test for pixel candidates.  A candidate that is not kept suppresses
    nothing in either form.  So the NMS types run the same kernel as the
    heatmap types, with no loop over candidates.

    Returns (Features ``[capacity]``, descriptors ``[capacity, D]``): the
    existing slots keep zero descriptors, each new slot its candidate's.
    """
    capacity = _check_capacity(existing, opts)
    dev = scores.device
    score_map, owner = nms_candidates(kpts, scores, existing, opts, rows, cols)
    n_stop = (capacity - existing.count).to(torch.int32).reshape(1)
    new_uv, new_resp, new_valid = greedy_select(score_map, capacity, n_stop, opts.min_feature_distance)
    picked = owner[new_uv[:, 1].to(torch.int64) * cols + new_uv[:, 0].to(torch.int64)]

    rel = torch.arange(capacity, device=dev) - existing.count
    src = torch.clamp(rel, 0, capacity - 1)
    take = (rel >= 0) & new_valid[src]
    feats = Features(
        uv=torch.where(take[:, None], new_uv[src], existing.uv),
        response=torch.where(take, new_resp[src], existing.response),
        valid=take | existing.valid,
    )
    dout = torch.where(take[:, None], descs[picked[src]], torch.zeros((), dtype=descs.dtype, device=dev))
    return feats, dout


def detect_with_descriptors(heatmap: torch.Tensor, desc_map: torch.Tensor, existing: Features,
                            opts: NNDetectorOptions) -> Tuple[Features, torch.Tensor]:
    """The heatmap types' post-processing: select, then sample descriptors
    for every valid (existing and new) feature.  Returns (Features,
    descriptors ``[capacity, D]``)."""
    feats = select_features_from_heatmap(heatmap, existing, opts)
    with trace.span("kernels.nn_sample"):
        desc = sample_descriptor_grid(desc_map, feats.uv)
        return feats, desc * feats.valid[:, None].to(desc.dtype)


def postprocess(heatmap: torch.Tensor, desc_map: torch.Tensor, existing: Features,
                opts: NNDetectorOptions) -> Tuple[Features, torch.Tensor]:
    """Features and descriptors of one frame from its heatmap ``[H, W]`` and
    stride-8 descriptor map ``[H/8, W/8, D]``, by ``opts.model_type``."""
    with trace.span("frontend.nn_postprocess"):
        if opts.model_type in NMS_TYPES:
            kpts, scores, descs = nms_head(heatmap, desc_map, min_response=opts.min_response)
            rows, cols = heatmap.shape
            return directly_select_features(kpts, scores, descs, existing, opts, rows, cols)
        return detect_with_descriptors(heatmap, desc_map, existing, opts)


class NNFeaturePointDetector:
    """Session-like wrapper of one NN model (NNFeaturePointDetector).

    ``initialize()`` loads the weights (the packaged trained archive unless
    a Flax param tree is given) and runs one warm-up forward pass at
    (``max_image_rows``, ``max_image_cols``); ``preprocess`` then holds the
    model's uint8 -> NCHW float input step.  ``dtype`` is the models'
    compute dtype (bfloat16 by default, as the JAX models).
    """

    def __init__(self, opts: NNDetectorOptions = NNDetectorOptions(), device: DeviceLike = None,
                 dtype: torch.dtype = torch.bfloat16):
        self.opts = opts
        self.device = resolve_device(device)
        self.dtype = dtype
        self.model = None

    def initialize(self, params: Optional[dict] = None) -> bool:
        """``params``: a Flax param tree of numpy arrays (as
        ``models.weights.load_params_npz`` returns); the packaged archive
        when None, and FileNotFoundError when that is absent."""
        if self.opts.model_type in (NNModelType.SUPERPOINT_HEATMAP, NNModelType.SUPERPOINT_NMS):
            model, self.preprocess, channels = SuperPoint(dtype=self.dtype), preprocess_gray, 1
            path, to_state = W.SUPERPOINT_SYNTH, superpoint_state_from_flax
        else:
            model, self.preprocess, channels = Disk(dtype=self.dtype), preprocess_gray_rgb, 3
            path, to_state = W.DISK_SYNTH, disk_state_from_flax
        with trace.setup_span("setup.nn_initialize"):
            if params is None:
                params = W.load_params_npz(path)
            model.load_state_dict(to_state(params))
            self.model = model.to(self.device).eval()
            with torch.no_grad():
                self.model(torch.zeros((1, channels, self.opts.max_image_rows, self.opts.max_image_cols),
                                       device=self.device))
        return True

    def maps(self, image_u8) -> Tuple[torch.Tensor, torch.Tensor]:
        """The forward pass of one ``[H, W]`` uint8 image: heatmap ``[H, W]``
        and the stride-8 descriptor map ``[H/8, W/8, D]`` (a full-resolution
        map, DISK's, is average-pooled 8x8 first)."""
        if self.model is None:
            raise RuntimeError("NNFeaturePointDetector used before initialize()")
        image = as_tensor(image_u8, self.device)
        x = self.preprocess(image)
        with trace.span("models.forward"), torch.no_grad():
            heat, desc = self.model(x)
        desc_map = desc[0]
        if desc_map.shape[0] == image.shape[0]:
            with trace.span("frontend.nn_pool"):
                desc_map = F.avg_pool2d(desc_map.permute(2, 0, 1)[None], STRIDE)[0].permute(1, 2, 0)
        return heat[0], desc_map

    def detect(self, image_u8, existing: Optional[Features] = None) -> Tuple[Features, torch.Tensor]:
        """DetectGoodFeaturesWithDescriptor: (Features ``[capacity]``,
        descriptors ``[capacity, D]``) of one ``[H, W]`` uint8 image, the
        new features appended after ``existing``."""
        with trace.span("frontend.nn_detect"):
            heatmap, desc_map = self.maps(image_u8)
            if existing is None:
                existing = Features.empty(self.opts.max_number_of_detected_features, device=self.device)
            return postprocess(heatmap, desc_map, existing, self.opts)
