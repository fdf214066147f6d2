"""The ranks of one multi-device run, driven by one host process.

The JAX package runs its distributed driver as one single-controller SPMD
program: a ``shard_map`` over a device mesh inside one process, whose
collectives (``psum``, ``pmax``, ``ppermute``) the compiler lowers.  The
port keeps that shape.  A run has ``n`` ranks, given as a list of torch
devices with one entry per rank; the list may repeat a device.  Each rank
owns its own :class:`~repro_torch.core.region_store.RegionState` on its
device, and one host loop drives every rank, phase by phase.  The
collectives become plain tensor operations over the per-rank values:

- ``psum`` / ``pmax``: the per-rank tensors are gathered to the first
  rank's device and summed (or maxed) in rank order;
- ``ppermute``: ``Tensor.to(dst_device, non_blocking=True)``, which between
  two GPUs is a peer-to-peer copy.

Why not ``torch.distributed``: NCCL refuses two ranks on one GPU, so a
multi-process port could run the redistribution on a one-card machine only
at one rank, where the ring schedule is empty.  With one host process,
rank ``r`` goes on ``devices[r]``; :func:`cuda_devices` places ``n`` ranks as
``cuda:(r mod device_count)``, so four ranks share one card and the same
code spreads over four cards where there are four.  On one card the ranks
time-share it: a run there shows correctness and overhead, not scaling.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.adaptive import resolve_device
from repro_torch.core.region_store import RegionState, state_from_numpy


def rank_device(device) -> torch.device:
    """The device of one rank, checked by :func:`adaptive.resolve_device`
    (CUDA must be present if asked for); a bare ``"cuda"`` becomes
    ``cuda:0``, so that ranks compare by device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def to_device(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small host array on ``device`` without making the host wait: staged
    in pinned memory and copied asynchronously on a CUDA device."""
    t = torch.as_tensor(np.asarray(values), dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def copy_to(a: np.ndarray, device) -> torch.Tensor:
    """A copy of host array ``a`` on ``device``, never a view of it (on the
    CPU ``torch.as_tensor`` would share ``a``'s memory)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


def cuda_devices(n_ranks: int) -> list[torch.device]:
    """``n_ranks`` ranks over the visible GPUs: rank r on cuda:(r mod count).

    Raises when no CUDA device is present.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=['cpu'] * n to run the "
            "ranks on the CPU"
        )
    count = torch.cuda.device_count()
    return [torch.device("cuda", r % count) for r in range(n_ranks)]


class Ranks:
    """The device of every rank, and the collectives over per-rank tensors."""

    def __init__(self, devices: Sequence):
        if len(devices) < 1:
            raise ValueError("a run needs at least one rank")
        self.devices = [rank_device(d) for d in devices]
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"ranks must share one device type, got {self.devices}")

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def gather(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-rank tensors of one shape, stacked on the first rank's device."""
        return torch.stack([t.to(self.first, non_blocking=True) for t in tensors])

    def psum(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum of the per-rank tensors, added in rank order, on the first
        rank's device."""
        moved = [t.to(self.first, non_blocking=True) for t in tensors]
        total = moved[0]
        for t in moved[1:]:
            total = total + t
        return total

    def pmax(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """Elementwise maximum of the per-rank tensors, on the first rank's
        device."""
        return torch.amax(self.gather(tensors), dim=0)

    def ppermute(
        self, tensors: Sequence[torch.Tensor], perm: Sequence[tuple[int, int]]
    ) -> list[torch.Tensor]:
        """Route ``tensors[src]`` to rank ``dst`` for every ``(src, dst)``.

        ``perm`` must be a bijection on the ranks (as ``jax.lax.ppermute``
        requires of a full permutation).  A tensor that stays on its device
        is not copied.
        """
        out: list = [None] * self.n
        for src, dst in perm:
            out[dst] = tensors[src].to(self.devices[dst], non_blocking=True)
        if any(t is None for t in out):
            raise ValueError(f"permutation {perm} does not cover {self.n} ranks")
        return out

    def states_from_stacked(self, arrays: Mapping[str, np.ndarray]) -> list[RegionState]:
        """Per-rank states from arrays with a leading rank axis, one per field
        of :class:`RegionState` (the JAX package's stacked ``RegionState``,
        as numpy arrays, gives the same per-rank states)."""
        return [
            state_from_numpy({k: np.asarray(v)[r] for k, v in arrays.items()}, dev)
            for r, dev in enumerate(self.devices)
        ]
