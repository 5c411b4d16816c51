"""Dense float-descriptor matcher (cosine / L2) for the NN detectors.

Counterpart of ``feature_detector_tpu/match/float_matcher.py``: the same
options, nearest neighbour by cosine similarity (descriptors are normalised,
so L2^2 = 2 - 2 cos and both metrics share the product), a ratio test on L2
distances against the second best, and a mutual-best cross-check.

The JAX package computes the similarity matrix at ``Precision.HIGHEST``.
Here the product runs in float64 and is rounded once to float32, so it
never depends on ``torch.backends.cuda.matmul.allow_tf32``; a float32
product on the card would run in TF32 when that flag is set.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.types import Matches
from ..kernels.nn_ops import l2_normalise
from ..utils import trace


@dataclasses.dataclass(frozen=True)
class FloatMatcherOptions:
    """Matching thresholds for float descriptors."""

    metric: str = "cosine"  # "cosine" | "l2"
    min_similarity: float = 0.0  # cosine floor; ignored for "l2"
    max_distance: float = float("inf")  # L2 ceiling; ignored for "cosine"
    cross_check: bool = True
    ratio: float = 1.0  # Lowe ratio on L2 distances; 1.0 disables.


def _l2_of_cos(c: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(2.0 - 2.0 * c, 0.0))


def match_float(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    opts: FloatMatcherOptions = FloatMatcherOptions(),
) -> Matches:
    """Matches set A ``[Na, D]`` against set B ``[Nb, D]`` (float
    descriptors, normalised here; ``valid_*`` bool).  Returns per A slot the
    best B index (-1 when unmatched), its L2 distance (inf when unmatched)
    and a validity flag.  Ties go to the lower index.
    """
    if opts.metric not in ("cosine", "l2"):
        raise ValueError(f"unknown metric: {opts.metric}")
    with trace.span("match.float"):
        a = l2_normalise(desc_a.to(torch.float32), dim=-1)
        b = l2_normalise(desc_b.to(torch.float32), dim=-1)
        sim = (a.double() @ b.double().T).to(torch.float32)
        neg_inf = torch.tensor(float("-inf"), device=sim.device)
        sim = torch.where(valid_a[:, None] & valid_b[None, :], sim, neg_inf)

        na, nb = sim.shape
        best = sim.amax(dim=1)
        best_j = torch.argmax(sim, dim=1)
        is_best = torch.arange(nb, device=sim.device)[None, :] == best_j[:, None]
        second = torch.where(is_best, neg_inf, sim).amax(dim=1)

        ok = valid_a & torch.isfinite(best)
        dist = _l2_of_cos(best)
        if opts.metric == "cosine":
            ok &= best >= opts.min_similarity
        else:
            ok &= dist <= opts.max_distance
        if opts.ratio < 1.0:
            d2 = _l2_of_cos(second)
            ok &= dist <= opts.ratio * torch.where(torch.isfinite(d2), d2, torch.inf)
        if opts.cross_check:
            best_i = torch.argmax(sim, dim=0)
            ok &= best_i[best_j] == torch.arange(na, device=sim.device)

        return Matches(
            index=torch.where(ok, best_j, -1).to(torch.int32),
            distance=torch.where(ok, dist, torch.inf).to(torch.float32),
            valid=ok,
        )
