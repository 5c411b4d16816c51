"""Row-sharded image processing with halo exchange.

Counterpart of ``feature_detector_tpu/parallel/halo.py``: one image's rows
split over the ``space`` axis of a mesh, each rank holding one slab.  A
stencil of radius at most ``halo`` runs on its slab after the ``halo``
boundary rows of each neighbour slab arrive (point-to-point sends between
neighbour ranks, where the JAX package uses ``ppermute``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import axis_group, axis_index, axis_size


def exchange_halo(local_rows: torch.Tensor, halo: int, mesh: DeviceMesh, axis: str = "space") -> torch.Tensor:
    """``local_rows`` [rows, C] framed by ``halo`` rows of each neighbour:
    returns [rows + 2 halo, C].  The first rank gets zeros above, the last
    zeros below (the detectors' zero-gradient border)."""
    rows = local_rows.shape[0]
    if not 0 < halo <= rows:
        raise ValueError(f"exchange_halo: need 0 < halo <= slab rows, got halo {halo} for {rows} rows")
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    group = axis_group(mesh, axis)
    x = local_rows.contiguous()
    from_above = torch.zeros((halo, *x.shape[1:]), dtype=x.dtype, device=x.device)
    from_below = torch.zeros_like(from_above)
    ops = []
    # My top rows go up (the upper neighbour's bottom halo), my bottom rows down.
    if i > 0:
        up = dist.get_global_rank(group, i - 1)
        ops += [dist.P2POp(dist.isend, x[:halo].contiguous(), up, group),
                dist.P2POp(dist.irecv, from_above, up, group)]
    if i < n - 1:
        down = dist.get_global_rank(group, i + 1)
        ops += [dist.P2POp(dist.isend, x[rows - halo:].contiguous(), down, group),
                dist.P2POp(dist.irecv, from_below, down, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([from_above, x, from_below])


def row_sharded_map(fn: Callable[[torch.Tensor], torch.Tensor], mesh: DeviceMesh, halo: int, axis: str = "space"):
    """Lift an [H, W] -> [H, W] stencil of radius <= ``halo`` to a function
    of this rank's slab [H / n, W] (as float32) returning its slab of the
    output.  ``fn`` must not depend on the position in the image and must
    accept the zero rows beyond the image border (true of the gradient and
    box-sum responses, whose border band is gated to zero anyway)."""

    def wrapped(local: torch.Tensor) -> torch.Tensor:
        padded = exchange_halo(local.to(torch.float32), halo, mesh, axis)
        return fn(padded)[halo:halo + local.shape[0]]

    return wrapped
