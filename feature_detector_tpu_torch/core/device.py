"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller hands them CPU tensors or asks
for ``device="cpu"``.  There is no fallback: asking for CUDA on a machine
without a usable card raises, so a run never continues on the CPU unseen.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Raises if a CUDA device is asked for and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is false; "
            "pass CPU tensors or device='cpu' to run on the CPU"
        )
    return dev


def as_tensor(x, device: DeviceLike = None, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A tensor stays on its own device unless ``device`` is given; anything
    else (numpy arrays, lists) goes to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        if device is not None:
            x = x.to(resolve_device(device))
        return x if dtype is None else x.to(dtype)
    arr = np.asarray(x)
    if not arr.flags.writeable:  # e.g. a view of a JAX array; torch wants to own writable memory
        arr = arr.copy()
    return torch.as_tensor(arr, dtype=dtype, device=resolve_device(device))
