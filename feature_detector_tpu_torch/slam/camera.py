"""Pinhole camera model and the reprojection Jacobians of BA.

Counterpart of ``feature_detector_tpu/slam/camera.py``; the intrinsics are
plain Python floats, so the same ``Pinhole`` serves every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pinhole(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float


def project(p_cam: torch.Tensor, cam: Pinhole) -> torch.Tensor:
    """[..., 3] camera-frame points -> [..., 2] pixels."""
    z = torch.clamp_min(p_cam[..., 2], 1e-6)
    return torch.stack([cam.fx * p_cam[..., 0] / z + cam.cx, cam.fy * p_cam[..., 1] / z + cam.cy], -1)


def projection_jacobian(p_cam: torch.Tensor, cam: Pinhole) -> torch.Tensor:
    """d pixel / d p_cam: [..., 2, 3]."""
    x, y = p_cam[..., 0], p_cam[..., 1]
    z = torch.clamp_min(p_cam[..., 2], 1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    zr = torch.zeros_like(z)
    row0 = torch.stack([cam.fx * iz, zr, -cam.fx * x * iz2], -1)
    row1 = torch.stack([zr, cam.fy * iz, -cam.fy * y * iz2], -1)
    return torch.stack([row0, row1], -2)


def huber_weight(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight for the Huber loss given squared residual norm."""
    r = torch.sqrt(torch.clamp_min(r2, 1e-12))
    return torch.where(r <= delta, torch.ones_like(r), delta / r)
