"""Work of the SuperPoint and SuperGlue cells, counted from shapes and valid
keypoint counts, so that it reads the same whatever implements it: padded
slots that a batched program computes are not counted.

- SuperPoint's forward: 2 x input channels x kernel area FLOPs for every
  output element of every convolution.
- A SuperGlue GNN layer, for m keypoints on side A and n on side B at
  width d: each side's query projection, merge and MLP (512-512-256) cost
  ``2 d^2 + 2 d^2 + 12 d^2`` a keypoint, its key and value projections
  ``4 d^2`` a keypoint of its source, and attention ``4 d`` a (query, key)
  pair.  So a self layer costs ``20 (m + n) d^2 + 4 (m^2 + n^2) d`` and a
  cross layer ``20 (m + n) d^2 + 8 m n d``; at m = n both are
  ``2 (20 n d^2 + 4 n m d)``, two sides of ``20 n d^2 + 4 n m d``.
- Sinkhorn's least time for ``iters`` passes over P pairs of
  ``(m + 1)(n + 1)`` couplings: the couplings read once and the
  log-assignment written once (float32), or 3 float32 operations a coupling
  each half-pass (an add, an exp, a sum) at the float32 peak, the larger.
"""

from __future__ import annotations

from . import peaks

# SuperPoint at its published widths: (input channels, output channels, kernel, scale as a power of 2).
SUPERPOINT_CONVS = (
    (1, 64, 3, 0), (64, 64, 3, 0), (64, 64, 3, 1), (64, 64, 3, 1), (64, 128, 3, 2), (128, 128, 3, 2),
    (128, 128, 3, 3), (128, 128, 3, 3), (128, 256, 3, 3), (256, 65, 1, 3), (128, 256, 3, 3), (256, 256, 1, 3),
)
SINKHORN_OPS = 3  # float32 operations a coupling each half-pass


def superpoint_forward_flop(rows: int, cols: int) -> float:
    """Forward FLOPs of one ``rows`` x ``cols`` frame (about 169,600 a pixel
    at 752x480: 61.2 GFLOP)."""
    return float(sum(2 * cin * cout * k * k * (rows >> s) * (cols >> s) for cin, cout, k, s in SUPERPOINT_CONVS))


def gnn_layer_flop(m: int, n: int, d: int, kind: str) -> float:
    """FLOPs of one GNN layer of ``kind`` ("self" or "cross") over both sides."""
    attention = 4 * d * (m * m + n * n) if kind == "self" else 8 * d * m * n
    return float(20 * (m + n) * d * d + attention)


def gnn_flop(m: int, n: int, cfg: dict) -> float:
    """FLOPs of every GNN layer of the configuration's ``superglue`` block
    for one pair."""
    return sum(gnn_layer_flop(m, n, cfg["descriptor_dim"], kind) for kind in cfg["gnn_layers"])


def sinkhorn_bound_ms(cells: int, iters: int) -> float:
    """Least ms for ``iters`` passes over ``cells`` couplings in all pairs."""
    t_bytes = 2 * 4 * cells / peaks.BYTES_PER_S
    t_ops = SINKHORN_OPS * 2 * iters * cells / peaks.F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops)
