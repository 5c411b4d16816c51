"""The controls of the SuperPoint and SuperGlue cells: the plain references
put in the program's place one precision below the configuration's, for
``bench_cuda.control`` to read against the limits of ``correct``.

- SuperPoint: every convolution's input and weights rounded to float8 e4m3
  under a per-tensor scale (the configuration states bfloat16).
- SuperGlue: every operand of the GNN's products (projections, attention,
  MLPs) rounded to float8 e4m3 likewise (the configuration states
  bfloat16); the keypoint encoder, the final projection, the scores and
  Sinkhorn stay in float32 as stated.

The benchmark's own runs never run a control.
"""

from __future__ import annotations

import torch

from . import superglue as ref_sg
from . import superpoint as ref_sp
from .disk import _fp8


def superpoint(w: ref_sp.Weights, image_u8: torch.Tensor):
    """Heatmap and descriptor map of SuperPoint with float8 convolutions."""
    return ref_sp.forward(w, image_u8, "fp8")


def superglue(state: dict, cfg: dict, rows: int, cols: int, *pair) -> torch.Tensor:
    """The log-assignment of one pair with the GNN's products in float8."""
    return ref_sg.forward(state, cfg, rows, cols, *pair, gnn_round=_fp8)
