"""Descriptor front-end: describe and match.

Counterpart of ``feature_detector_tpu/frontend/descriptor.py``.  Every
function takes one frame or a [B, ...] stack.
"""

from __future__ import annotations

import torch

from ..core.config import BriefOptions, MatcherOptions
from ..core.device import DeviceLike, as_tensor
from ..core.types import Descriptors, Features, Matches
from ..kernels.brief import brief_compute
from ..match.hamming import match_hamming


def compute_descriptors(
    image, features: Features, opts: BriefOptions = BriefOptions(), device: DeviceLike = None
) -> Descriptors:
    image = as_tensor(image, device)
    words, valid = brief_compute(image, features.uv, features.valid, opts)
    return Descriptors(words=words, valid=valid)


def compute_descriptors_float(
    image, features: Features, opts: BriefOptions = BriefOptions(), device: DeviceLike = None
) -> torch.Tensor:
    """Dense float overload (descriptor.h:43-62): bits map to +/-1.0.

    Returns [..., capacity, opts.length] float32; border-failed features keep
    all-zero rows (quirk Q5).
    """
    d = compute_descriptors(image, features, opts, device)
    words = d.words.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    pm1 = bits.flatten(-2).to(torch.float32) * 2.0 - 1.0
    pm1 = pm1[..., : opts.length]
    return torch.where(d.valid[..., None], pm1, torch.zeros_like(pm1))


def describe_and_match(
    image_a,
    features_a: Features,
    image_b,
    features_b: Features,
    brief_opts: BriefOptions = BriefOptions(),
    matcher_opts: MatcherOptions = MatcherOptions(),
    device: DeviceLike = None,
) -> Matches:
    """Describe both feature sets and Hamming-match A against B."""
    da = compute_descriptors(image_a, features_a, brief_opts, device)
    db = compute_descriptors(image_b, features_b, brief_opts, device)
    return match_hamming(da.words, da.valid, db.words, db.valid, matcher_opts)
