"""Closed-form 3x3 linear algebra on batched tensors.

Counterpart of ``feature_detector_tpu/slam/linalg3.py``: determinant,
adjugate, inverse and solve by cofactors, elementwise over leading axes.
The callers damp their matrices, so the cofactor forms are as accurate as
an LU here, and on the card they are a few fused elementwise kernels where a
batched LU would be a library call per stage.
"""

from __future__ import annotations

import torch

from . import fixed


def det3(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [...] determinant."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def adjugate3(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] adjugate (transposed cofactor matrix)."""
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c02 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c10 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c20 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c21 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    return torch.stack(
        [
            torch.stack([c00, c01, c02], -1),
            torch.stack([c10, c11, c12], -1),
            torch.stack([c20, c21, c22], -1),
        ],
        -2,
    )


def _safe_det(m: torch.Tensor, eps: float) -> torch.Tensor:
    d = det3(m)
    tiny = torch.where(d < 0, torch.full_like(d, -eps), torch.full_like(d, eps))
    return torch.where(d.abs() < eps, tiny, d)


def inv3(m: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """[..., 3, 3] inverse via adjugate/determinant (callers damp m)."""
    return adjugate3(m) / _safe_det(m, eps)[..., None, None]


def solve3(m: torch.Tensor, b: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Solve m x = b for [..., 3, 3] m and [..., 3] b (Cramer via adjugate)."""
    return fixed.matvec(adjugate3(m), b) / _safe_det(m, eps)[..., None]
