"""Fixed-capacity feature containers as dataclasses of tensors.

Counterparts of ``feature_detector_tpu/core/types.py`` with the same fields
and layouts.  Every field may carry leading batch dimensions ([B, N, ...]).

- ``uv`` is (x, y) pixel coordinates;
- descriptor words are ``[N, W]`` 32-bit words, bit j of word w is test
  32w+j.  PyTorch has no usable uint32 arithmetic on every backend, so the
  words are held as int32 with the same 32 bits; ``to_numpy`` and
  ``from_numpy`` convert through numpy's ``view(np.uint32)``;
- ``Matches.index`` is -1 when unmatched, and the distance sentinel is
  ``BIG`` = 1 << 20.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import DeviceLike, as_tensor, resolve_device

BIG = 1 << 20


def _count(valid: torch.Tensor) -> torch.Tensor:
    return valid.to(torch.int32).sum(dim=-1, dtype=torch.int32)


@dataclasses.dataclass
class Features:
    """uv [..., N, 2] f32 (x, y); response [..., N] f32 (0 where invalid);
    valid [..., N] bool, the valid slots forming a prefix."""

    uv: torch.Tensor
    response: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.uv.shape[-2]

    @property
    def count(self) -> torch.Tensor:
        return _count(self.valid)

    @staticmethod
    def empty(capacity: int, device: DeviceLike = None) -> "Features":
        dev = resolve_device(device)
        return Features(
            uv=torch.zeros((capacity, 2), dtype=torch.float32, device=dev),
            response=torch.zeros((capacity,), dtype=torch.float32, device=dev),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        )

    @staticmethod
    def from_numpy(uv, capacity: int, response=None, device: DeviceLike = None) -> "Features":
        """The first ``capacity`` rows of ``uv`` (and ``response``) become
        valid slots, as the JAX package's ``Features.from_numpy`` does."""
        uv = np.asarray(uv, dtype=np.float32).reshape(-1, 2)
        n = min(len(uv), capacity)
        out_uv = np.zeros((capacity, 2), np.float32)
        out_uv[:n] = uv[:n]
        out_resp = np.zeros((capacity,), np.float32)
        if response is not None:
            out_resp[:n] = np.asarray(response, np.float32).reshape(-1)[:n]
        valid = np.zeros((capacity,), bool)
        valid[:n] = True
        return Features(
            uv=as_tensor(out_uv, device),
            response=as_tensor(out_resp, device),
            valid=as_tensor(valid, device),
        )

    def to_numpy(self):
        """Returns (uv[count, 2], response[count]) of one frame as numpy arrays."""
        valid = self.valid.cpu().numpy()
        return self.uv.cpu().numpy()[valid], self.response.cpu().numpy()[valid]

    def to(self, device: DeviceLike) -> "Features":
        dev = resolve_device(device)
        return Features(self.uv.to(dev), self.response.to(dev), self.valid.to(dev))


@dataclasses.dataclass
class Lines:
    """Line segments: endpoints [..., N, 4] f32 = (x1, y1, x2, y2); valid [..., N]."""

    endpoints: torch.Tensor
    valid: torch.Tensor

    @property
    def count(self) -> torch.Tensor:
        return _count(self.valid)

    @staticmethod
    def empty(capacity: int, device: DeviceLike = None) -> "Lines":
        dev = resolve_device(device)
        return Lines(
            endpoints=torch.zeros((capacity, 4), dtype=torch.float32, device=dev),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        )

    @staticmethod
    def from_numpy(endpoints, valid=None, device: DeviceLike = None) -> "Lines":
        endpoints = np.asarray(endpoints, np.float32).reshape(-1, 4)
        valid = np.ones(len(endpoints), bool) if valid is None else np.asarray(valid, bool)
        return Lines(as_tensor(endpoints, device), as_tensor(valid, device))

    def to_numpy(self):
        valid = self.valid.cpu().numpy()
        return self.endpoints.cpu().numpy()[valid]


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 descriptor words -> numpy uint32 with the same bits."""
    return words.cpu().numpy().astype(np.int32, copy=False).view(np.uint32)


def words_from_numpy(words, device: DeviceLike = None) -> torch.Tensor:
    """numpy uint32 (or int32) descriptor words -> int32 tensor, same bits."""
    w = np.ascontiguousarray(np.asarray(words))
    if w.dtype not in (np.uint32, np.int32):
        raise TypeError(f"descriptor words must be uint32 or int32, got {w.dtype}")
    return as_tensor(w.view(np.int32), device)


@dataclasses.dataclass
class Descriptors:
    """Packed binary descriptors: words [..., N, W] int32 (uint32 bits) + valid [..., N]."""

    words: torch.Tensor
    valid: torch.Tensor

    @property
    def count(self) -> torch.Tensor:
        return _count(self.valid)

    @staticmethod
    def empty(capacity: int, num_words: int = 8, device: DeviceLike = None) -> "Descriptors":
        dev = resolve_device(device)
        return Descriptors(
            words=torch.zeros((capacity, num_words), dtype=torch.int32, device=dev),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        )

    @staticmethod
    def from_numpy(words, valid, device: DeviceLike = None) -> "Descriptors":
        return Descriptors(words_from_numpy(words, device), as_tensor(np.asarray(valid, bool), device))

    def to_numpy(self):
        """Returns (words uint32 [..., N, W], valid [..., N]) as numpy arrays."""
        return words_to_numpy(self.words), self.valid.cpu().numpy()


@dataclasses.dataclass
class Matches:
    """For each A-slot an index into B (-1 when unmatched), its distance
    (``BIG`` when unmatched) and a validity flag; all [..., Na]."""

    index: torch.Tensor
    distance: torch.Tensor
    valid: torch.Tensor

    @property
    def count(self) -> torch.Tensor:
        return _count(self.valid)

    @staticmethod
    def empty(capacity: int, device: DeviceLike = None) -> "Matches":
        dev = resolve_device(device)
        return Matches(
            index=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
            distance=torch.full((capacity,), BIG, dtype=torch.int32, device=dev),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        )

    @staticmethod
    def from_numpy(index, distance, valid, device: DeviceLike = None) -> "Matches":
        return Matches(
            index=as_tensor(np.asarray(index, np.int32), device),
            distance=as_tensor(np.asarray(distance), device),
            valid=as_tensor(np.asarray(valid, bool), device),
        )

    def to_numpy(self):
        """Returns (index, distance, valid) as numpy arrays."""
        return self.index.cpu().numpy(), self.distance.cpu().numpy(), self.valid.cpu().numpy()
