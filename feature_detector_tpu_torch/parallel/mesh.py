"""Device meshes over the process group, and the leading-axis share of a
rank.

Counterpart of ``feature_detector_tpu/parallel/mesh.py``.  The JAX package
drives every device from one controller over a ``Mesh``; here each device
has its own rank running the same program (SPMD), and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions:

- ``data``: frames, chunks or landmarks split across ranks;
- ``space``: the rows of one image split across ranks, with halos
  (``halo.py``).

Collectives run on NCCL for CUDA tensors and on gloo for CPU tensors,
chosen from the mesh's device; a process group of the other kind is refused,
never used as a fallback.  Callers hand every rank the whole input: a rank
takes its block with ``shard_leading`` and the blocks come back together
with ``gather_leading``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.device import DeviceLike, resolve_device
from ..utils import trace


def backend_for(device_type: str) -> str:
    """The collective backend of a device type: NCCL on the card, gloo on
    the CPU."""
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device type {device_type!r}")


def make_mesh(axis_sizes: Optional[Sequence[int]] = None, axis_names=("data",),
              device: DeviceLike = None) -> DeviceMesh:
    """A mesh over every rank of the default process group.

    make_mesh() -> 1-D ``data`` mesh over the world;
    make_mesh((2, 2), ("data", "space")) -> a 2 x 2 mesh.

    ``device``: ``cuda`` (the default) or ``cpu``.  Without a process group
    the call starts a world of one in this process (an in-process store), so
    a single-device program needs no launcher.  Raises ``ValueError`` when
    the mesh asks for more ranks than the world has, or for fewer: every
    rank runs the program, so every rank belongs to the mesh.
    """
    dev = resolve_device(device)
    backend = backend_for(dev.type)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None else torch.cuda.current_device())
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()!r}; a {dev.type} mesh needs {backend!r}")
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (world,)
    axis_sizes, axis_names = tuple(int(s) for s in axis_sizes), tuple(axis_names)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} axis sizes for {len(axis_names)} axis names")
    n = math.prod(axis_sizes)
    if n > world:
        raise ValueError(f"need {n} devices, have {world}")
    if n < world:
        raise ValueError(f"a mesh of {n} devices in a world of {world}: every rank must belong to the mesh")
    return init_device_mesh(dev.type, axis_sizes, mesh_dim_names=axis_names)


def _dim(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return names.index(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(_dim(mesh, axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's position along ``axis``."""
    return mesh.get_local_rank(_dim(mesh, axis))


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(_dim(mesh, axis))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_leading(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data", pad_value=None) -> torch.Tensor:
    """This rank's contiguous block of the leading axis of ``x`` (the same
    ``x`` on every rank).  The axis must divide by the mesh axis, unless
    ``pad_value`` is given: then the leading axis is first padded with it
    to the next multiple."""
    n = axis_size(mesh, axis)
    rows = x.shape[0]
    if rows % n:
        if pad_value is None:
            raise ValueError(f"leading axis {rows} does not divide by the {n} ranks of mesh axis {axis!r}")
        pad = torch.full((n - rows % n, *x.shape[1:]), pad_value, dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad])
    per = x.shape[0] // n
    i = axis_index(mesh, axis)
    return x[i * per:(i + 1) * per]


def gather_leading(x_local: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """Every rank's block of the leading axis, in rank order, on every rank
    (an all-gather; the blocks must have equal shapes)."""
    with trace.span("parallel.gather"):
        n = axis_size(mesh, axis)
        x = x_local.to(torch.uint8) if x_local.dtype == torch.bool else x_local
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=axis_group(mesh, axis))
        out = torch.cat(parts)
        return out.to(torch.bool) if x_local.dtype == torch.bool else out
