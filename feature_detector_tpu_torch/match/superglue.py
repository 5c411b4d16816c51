"""SuperGlue matching: one frame's features against P frames' in one batched
call of the learned matcher (``models/superglue.py``).

The inputs are what ``NNFeaturePointDetector.detect`` returns, padded to
its capacity: the query's ``Features`` ``[NA]`` and descriptors
``[NA, d]``, the P database frames' ``Features`` ``[P, NB]`` and
descriptors ``[P, NB, d]``.  Validity comes from ``Features.valid``, the
image size from the options.  ``match_batch`` returns ``Matches``
``[P, NA]`` as ``match_float`` gives them for one pair: per query slot the
database slot it matches (-1 for none), the match's distance, here the
negative log of its matching score (inf for none), and a validity flag.  A
padded slot gets no match and changes no other slot's.

Work counters (``utils.trace.count``): ``superglue.pairs``,
``superglue.keypoints`` (valid slots of both sides, each pair's query slots
counted once a pair), ``superglue.slots`` (the slots the GNN computes,
padding included) and ``superglue.sinkhorn_iterations``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.config import SuperGlueOptions
from ..core.device import DeviceLike, resolve_device
from ..core.types import Features, Matches
from ..models import weights as W
from ..models.superglue import SuperGlue, select_matches
from ..utils import trace

SEED = 0  # the seeded weights' generator seed when no weights are given


class SuperGlueMatcher:
    """Session-like wrapper of one SuperGlue network.  ``dtype`` is the
    GNN's compute dtype (bfloat16 by default; the rest runs in float32)."""

    def __init__(self, opts: SuperGlueOptions = SuperGlueOptions(), device: DeviceLike = None,
                 dtype: torch.dtype = torch.bfloat16):
        self.opts = opts
        self.device = resolve_device(device)
        self.dtype = dtype
        self.model: Optional[SuperGlue] = None

    def initialize(self, params: Union[dict, str, None] = None) -> bool:
        """``params``: a state dict under the public checkpoint's names
        (tensors or numpy arrays), or the path of a checkpoint that
        ``torch.load`` reads (the published ``superglue_indoor.pth``);
        seeded weights (``models.weights.init_superglue_state``) when None:
        no trained SuperGlue weights are in the repository.  Loading casts
        each entry to its parameter's dtype."""
        with trace.setup_span("setup.superglue_initialize"):
            model = SuperGlue(self.opts, dtype=self.dtype)
            if params is None:
                params = W.init_superglue_state(model, torch.Generator().manual_seed(SEED))
            elif isinstance(params, str):
                params = torch.load(params, map_location="cpu", weights_only=True)
            model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
            self.model = model.to(self.device).eval().pack()
        return True

    @torch.no_grad()
    def match_batch(self, query_feats: Features, query_desc: torch.Tensor, db_feats: Features,
                    db_desc: torch.Tensor) -> Matches:
        """Matches ``[P, NA]`` of the query against each of the P database
        frames (module docstring)."""
        if self.model is None:
            raise RuntimeError("SuperGlueMatcher used before initialize()")
        with trace.span("match.superglue"):
            p, nb = db_feats.valid.shape
            na = query_feats.valid.shape[-1]
            z = self.model(query_feats.uv[None], query_feats.response[None], query_desc[None], query_feats.valid[None],
                           db_feats.uv, db_feats.response, db_desc, db_feats.valid)
            with trace.span("match.superglue_select"):
                index, best, keep = select_matches(z, self.opts.match_threshold)
                out = Matches(index=torch.where(keep, index, -1).to(torch.int32),
                              distance=torch.where(keep, -best, torch.inf).to(torch.float32), valid=keep)
            trace.count("superglue.pairs", p)
            trace.count("superglue.keypoints", query_feats.valid.sum() * p + db_feats.valid.sum())
            trace.count("superglue.slots", 2 * p * max(na, nb))
            return out
