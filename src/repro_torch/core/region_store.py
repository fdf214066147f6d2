"""Fixed-capacity Structure-of-Arrays region store.

The region population is a fixed-capacity SoA store plus an ``active``
mask, the layout PAGANI keeps resident on the GPU.  Active regions are kept
contiguous in ``[0, n_active)`` and sorted by descending error
(``core.split``), so each iteration works on a leading *window* of the
arrays, sized from a geometric ladder of powers of two
(:func:`window_ladder` / :func:`select_window`), not on all ``capacity``
slots.

Float reductions over the store go through :func:`tree_sum`, a pairwise
sum over a power-of-two length.  Padding with zeros adds exact zeros at
every level, so a sum over any window that holds all the non-zero rows is
bit-identical to the sum over the whole store, on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Pairwise sum over the last axis; ``(..., n) -> (...)``.

    The length is padded with zeros to a power of two and halved until one
    column is left, so the order of additions depends only on the position
    of each element: trailing zeros never change the result.
    """
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def masked_sums(mask: torch.Tensor, *values: torch.Tensor) -> torch.Tensor:
    """``(sum(where(mask, v, 0)) for v in values)`` as one ``(len(values),)``
    tensor, through :func:`tree_sum`."""
    stacked = torch.stack([torch.where(mask, v, torch.zeros_like(v)) for v in values])
    return tree_sum(stacked)


@dataclasses.dataclass
class RegionState:
    """One device's region population + finalised accumulators."""

    centers: torch.Tensor  # (C, d)
    halfw: torch.Tensor  # (C, d)
    est: torch.Tensor  # (C,)   degree-7 estimate
    err: torch.Tensor  # (C,)   heuristic error estimate
    axis: torch.Tensor  # (C,)   int32 split axis
    active: torch.Tensor  # (C,)   bool
    fresh: torch.Tensor  # (C,)   bool: needs (re-)evaluation
    fin_integral: torch.Tensor  # ()  accumulated finalised integral
    fin_error: torch.Tensor  # ()  accumulated finalised error
    n_evals: torch.Tensor  # ()  integrand-evaluation counter, state dtype
    it: torch.Tensor  # ()  int32 iteration counter
    overflowed: torch.Tensor  # () bool: capacity pressure was ever hit

    @property
    def capacity(self) -> int:
        return self.centers.shape[0]

    @property
    def d(self) -> int:
        return self.centers.shape[1]

    def global_estimates(
        self, window: int | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(integral, error) combining finalised + active contributions.

        ``window`` reduces over the leading rows only; every active slot
        lies in ``[0, n_active)``, so any ``window >= n_active`` gives the
        full reduction bit for bit (see :func:`tree_sum`).
        """
        w = self.capacity if window is None else window
        s = masked_sums(self.active[:w], self.est[:w], self.err[:w])
        return self.fin_integral + s[0], self.fin_error + s[1]


FIELDS = tuple(f.name for f in dataclasses.fields(RegionState))


def empty_state(capacity: int, d: int, dtype: torch.dtype, device) -> RegionState:
    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return RegionState(
        centers=z((capacity, d)),
        halfw=z((capacity, d)),
        est=z((capacity,)),
        err=z((capacity,)),
        axis=z((capacity,), torch.int32),
        active=z((capacity,), torch.bool),
        fresh=z((capacity,), torch.bool),
        fin_integral=z(()),
        fin_error=z(()),
        n_evals=z(()),
        it=z((), torch.int32),
        overflowed=z((), torch.bool),
    )


def uniform_partition(
    lo: np.ndarray, hi: np.ndarray, n_boxes: int
) -> tuple[np.ndarray, np.ndarray]:
    """Bisect [lo, hi] into ``n_boxes`` (power of two) equal boxes.

    Axes are cycled in round-robin order, so the partition stays as cubic as
    possible: the paper's "initial uniform partition".  Returns (centers,
    halfw) as float64 arrays of shape (n_boxes, d).
    """
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    d = lo.shape[0]
    if n_boxes < 1 or n_boxes & (n_boxes - 1):
        raise ValueError("n_boxes must be a power of two")
    boxes = [(lo.copy(), hi.copy())]
    level = 0
    while len(boxes) < n_boxes:
        axis = level % d
        nxt = []
        for blo, bhi in boxes:
            mid = 0.5 * (blo[axis] + bhi[axis])
            left_hi = bhi.copy()
            left_hi[axis] = mid
            right_lo = blo.copy()
            right_lo[axis] = mid
            nxt.append((blo, left_hi))
            nxt.append((right_lo, bhi))
        boxes = nxt
        level += 1
    centers = np.stack([0.5 * (b[0] + b[1]) for b in boxes])
    halfw = np.stack([0.5 * (b[1] - b[0]) for b in boxes])
    return centers, halfw


def init_state(
    capacity: int,
    lo: np.ndarray,
    hi: np.ndarray,
    n_init: int,
    dtype: torch.dtype,
    device,
) -> RegionState:
    """Fresh state holding the initial uniform partition."""
    lo = np.asarray(lo, np.float64)
    centers, halfw = uniform_partition(lo, hi, n_init)
    st = empty_state(capacity, lo.shape[0], dtype, device)
    st.centers[:n_init] = torch.as_tensor(centers, dtype=dtype, device=device)
    st.halfw[:n_init] = torch.as_tensor(halfw, dtype=dtype, device=device)
    st.active[:n_init] = True
    st.fresh[:n_init] = True
    return st


def stacked_empty_state(
    n: int, capacity: int, d: int, dtype: torch.dtype, device
) -> RegionState:
    """Empty store with a leading ``(n,)`` axis on every field.

    The batch service keeps one sub-store per problem slot; each slice along
    the leading axis is a store of its own and keeps the active-window
    invariant on its own.
    """
    one = empty_state(capacity, d, dtype, "meta")
    return RegionState(
        **{
            k: torch.zeros((n,) + getattr(one, k).shape, dtype=getattr(one, k).dtype,
                           device=device)
            for k in FIELDS
        }
    )


def write_slot(stacked: RegionState, slot: int, single: RegionState) -> RegionState:
    """Overwrite slice ``slot`` of a stacked store with a single store, in place.

    ``slot`` is a host integer; an index outside the stack raises (the JAX
    package's scatter would drop it silently).  ``single`` may live on
    another device than ``stacked``.
    """
    n = stacked.centers.shape[0]
    if not 0 <= int(slot) < n:
        raise IndexError(f"slot {slot} out of range [0, {n})")
    for k in FIELDS:
        getattr(stacked, k)[slot].copy_(getattr(single, k), non_blocking=True)
    return stacked


def to_device(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small host array on ``device`` without making the host wait: staged
    in pinned memory and copied asynchronously on a CUDA device."""
    t = torch.as_tensor(np.asarray(values), dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def state_from_numpy(arrays: Mapping[str, np.ndarray], device) -> RegionState:
    """Build a state from numpy arrays, one per field of :class:`RegionState`.

    Carries a state across packages: the leaves of the JAX package's
    ``RegionState`` as numpy arrays give the same state here.
    """
    missing = set(FIELDS) - set(arrays)
    if missing:
        raise KeyError(f"state arrays missing fields {sorted(missing)}")
    return RegionState(
        **{k: torch.as_tensor(np.array(arrays[k]), device=device) for k in FIELDS}
    )


def state_to_numpy(state: RegionState) -> dict[str, np.ndarray]:
    """The state's fields as numpy arrays (inverse of :func:`state_from_numpy`)."""
    return {k: getattr(state, k).cpu().numpy() for k in FIELDS}


def window_ladder(capacity: int, min_window: int = 256) -> tuple[int, ...]:
    """Geometric ladder of power-of-two window sizes up to ``capacity``.

    Each rung doubles the previous one; the top rung is always exactly
    ``capacity``, so a full store degrades to the full-capacity path.
    """
    if capacity < 1 or capacity & (capacity - 1):
        raise ValueError("capacity must be a positive power of two")
    w = max(1, min(min_window, capacity))
    w = 1 << (w - 1).bit_length()  # round up to a power of two
    ladder = []
    while w < capacity:
        ladder.append(w)
        w <<= 1
    ladder.append(capacity)
    return tuple(ladder)


def select_window(ladder: tuple[int, ...], n_active: int) -> int:
    """Smallest ladder rung that covers ``n_active`` contiguous rows.

    A left searchsorted, clamped to the top rung; ``n_active == 0`` selects
    the smallest rung.
    """
    ix = int(np.searchsorted(np.asarray(ladder), n_active, side="left"))
    return ladder[min(ix, len(ladder) - 1)]


def check_invariants(state: RegionState, lo, hi, atol: float = 1e-12) -> None:
    """Host-side structural checks (used by tests, not in the hot path)."""
    c = state.centers.cpu().numpy()
    h = state.halfw.cpu().numpy()
    act = state.active.cpu().numpy()
    if not np.all(h[act] > 0):
        raise AssertionError("active region with non-positive halfwidth")
    if not np.all(c[act] - h[act] >= np.asarray(lo) - atol):
        raise AssertionError("region below domain")
    if not np.all(c[act] + h[act] <= np.asarray(hi) + atol):
        raise AssertionError("region above domain")
    fresh = state.fresh.cpu().numpy()
    if np.any(fresh & ~act):
        raise AssertionError("fresh flag set on inactive slot")
    # active-window invariant: actives contiguous at the front of the store
    if np.any(act[int(act.sum()):]):
        raise AssertionError("active slots not contiguous")
