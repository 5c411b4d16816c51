"""Multi-process start-up: ``initialize`` and the global mesh.

Counterpart of ``feature_detector_tpu/parallel/distributed.py``.  Every
process calls ``initialize``; it joins the default process group over a TCP
store at the coordinator's address, one rank per device.  Arguments default
from the same environment as the JAX package's launcher:
COORDINATOR_ADDRESS (host:port), NUM_PROCESSES and PROCESS_ID.  A
single-process caller gets a no-op, so the same program runs on one host
and on many.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..core.device import DeviceLike, resolve_device
from ..utils import trace
from .mesh import backend_for, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    device: DeviceLike = None,
) -> bool:
    """Join the process group of ``num_processes`` ranks.

    Returns True when this process joined a group, False for the
    single-process no-op (one process, or no coordinator).  The backend
    follows ``device``: NCCL for ``cuda`` (the default), gloo for ``cpu``.
    On the card this rank uses ``cuda:local_device_ids[0]``, by default
    ``cuda:LOCAL_RANK`` or ``cuda:(process_id % device count)``.
    """
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return False
    if dist.is_initialized():
        raise RuntimeError("initialize: this process already belongs to a process group")
    with trace.setup_span("setup.join"):
        dev = resolve_device(device)
        if dev.type == "cuda":
            if local_device_ids:
                index = int(local_device_ids[0])
            else:
                index = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
            torch.cuda.set_device(index)
        dist.init_process_group(backend_for(dev.type), init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    return True


def global_data_mesh(axis: str = "data", device: DeviceLike = None):
    """1-D mesh over every rank of every process."""
    return make_mesh(None, (axis,), device)


def process_info() -> dict:
    """This process's place in the group (a world of one without a group);
    one device per rank."""
    grouped = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if grouped else 0,
        "process_count": dist.get_world_size() if grouped else 1,
        "local_devices": 1,
        "global_devices": dist.get_world_size() if grouped else 1,
    }
