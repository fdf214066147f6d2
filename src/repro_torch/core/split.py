"""Fused filter + split + compaction (the paper's fused GPU stage).

One sort-based pass that (i) folds finalised regions into the scalar
accumulators, (ii) compacts survivors to the front ordered by descending
error, and (iii) splits as many survivors as capacity allows along their
assigned axes: child A replaces the parent row, child B is appended after
the survivor block.

**Windowed advance.**  Both entry points take an optional ``window`` so the
sort, the gathers and the child writes run on the leading ``window`` rows
only.  The caller owes two guarantees, free under the active-window
invariant (every active slot lives in ``[0, n_active)``):

- every active slot is inside the window;
- ``window >= min(2 * n_active, capacity)`` (post-split the population can
  double, and under capacity pressure the child block reaches ``capacity``).

The capacity scalars (the ``3C//4`` forced-finalise limit and the split
budget ``k = min(n_act, C - n_act)``) stay defined against the full
capacity ``C``.  The sort is stable and the sums go through ``tree_sum``,
so a windowed advance is bit-identical to the full one.

The store's arrays are updated in place: the JAX package returns new
buffers and donates the old ones, which comes to the same thing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.region_store import RegionState, masked_sums
from repro_torch.telemetry.core import NULL


def survivor_sort_perm(err: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Permutation compacting active slots to the front by descending error.

    Sorts along the last axis (leading axes are problems of a stacked
    store).  Freed/inactive slots sink to the back.  The sort is stable, as
    ``jnp.argsort`` is, so equal keys keep their relative order.
    """
    big = torch.finfo(err.dtype).max
    key = torch.where(active, -err, torch.full_like(err, big))
    return torch.sort(key, dim=-1, stable=True).indices


def _window(state: RegionState, window: Optional[int]) -> int:
    w = state.capacity if window is None else int(window)
    if not 0 < w <= state.capacity:
        raise ValueError(f"window {w} outside (0, {state.capacity}]")
    return w


def next_population(n_remaining: int, capacity: int) -> int:
    """Active count after a split of ``n_remaining`` survivors (host ints).

    The same arithmetic as :func:`classify_split_compact`: survivors past
    ``3C//4`` are force-finalised, then ``k = min(n, C - n)`` of them split.
    """
    n = min(n_remaining, 3 * capacity // 4)
    return n + min(n, capacity - n)


# The window-sized fields the advance rewrites, and the per-problem scalars.
ROWS = ("centers", "halfw", "est", "err", "axis", "active", "fresh")
SCALARS = ("fin_integral", "fin_error", "overflowed")


def _compact_rows(rows: dict, scalars: dict, finalize_mask: torch.Tensor) -> tuple[dict, dict]:
    """Fold the finalised rows into the accumulators and sort the survivors
    to the front by descending error: the six gathers of :data:`ROWS` but
    ``fresh``, which the split rewrites."""
    act_w = rows["active"]
    fin = finalize_mask & act_w
    fin_sums = masked_sums(fin, rows["est"], rows["err"])
    fin_integral = scalars["fin_integral"] + fin_sums[0]
    fin_error = scalars["fin_error"] + fin_sums[1]
    active = act_w & ~fin

    perm = survivor_sort_perm(rows["err"], active)

    def take(x):
        index = perm if x.ndim == 2 else perm[..., None]
        return torch.take_along_dim(x, index, dim=1)

    rows = {name: take(rows[name]) for name in ("centers", "halfw", "est", "err", "axis")}
    rows["active"] = take(active)
    return rows, dict(fin_integral=fin_integral, fin_error=fin_error,
                      overflowed=scalars["overflowed"])


def _split_rows(capacity: int, rows: dict, scalars: dict) -> tuple[dict, dict]:
    """Force-finalise past ``3C//4`` and split the leading survivors of
    compacted rows: child A in the parent's row, child B after the block."""
    C = capacity
    centers, halfw, est, err, axis, active = (
        rows[name] for name in ("centers", "halfw", "est", "err", "axis", "active"))
    w = active.shape[1]
    n_act = torch.sum(active, dim=1)
    idx = torch.arange(w, device=active.device)[None, :]

    # Graceful degradation under memory pressure: if the store is nearly
    # full, force-finalise the lowest-error tail so splitting can always
    # make progress; their error estimates are folded into the
    # accumulators, so the global bound stays honest.
    limit = 3 * C // 4
    forced = active & (idx >= limit)
    forced_sums = masked_sums(forced, est, err)
    fin_integral = scalars["fin_integral"] + forced_sums[0]
    fin_error = scalars["fin_error"] + forced_sums[1]
    active = active & ~forced
    n_act = torch.clamp(n_act, max=limit)

    k = torch.minimum(n_act, C - n_act)  # regions we can split (+1 slot each)
    overflowed = scalars["overflowed"] | (k < n_act) | torch.any(forced, dim=1)
    n_act, k = n_act[:, None], k[:, None]

    split_row = idx < k  # rows being split (highest error first)

    d = centers.shape[-1]
    onehot = torch.arange(d, device=axis.device) == axis[..., None]
    h_half = torch.where(onehot, 0.5 * halfw, halfw)
    # children tile the parent exactly: centres at c -+ h/2 along the axis
    shift = torch.where(onehot, h_half, torch.zeros_like(h_half))
    child_a_centers = centers - shift
    child_b_centers = centers + shift

    # Child A overwrites the parent row.
    new_centers = torch.where(split_row[..., None], child_a_centers, centers)
    new_halfw = torch.where(split_row[..., None], h_half, halfw)

    # Child B of parent row i lands in row n_act + k - 1 - i (reversed
    # error order, as in the JAX package).  Written as a gather: row r of
    # [n_act, n_act + k) takes parent n_act + k - 1 - r; other rows keep
    # their values, so no out-of-range scatter is needed.
    child_b = (idx >= n_act) & (idx < n_act + k)
    src = torch.clamp(n_act + k - 1 - idx, 0, w - 1)[..., None]
    new_centers = torch.where(
        child_b[..., None], torch.take_along_dim(child_b_centers, src, dim=1), new_centers
    )
    new_halfw = torch.where(
        child_b[..., None], torch.take_along_dim(h_half, src, dim=1), new_halfw
    )

    active = active | (idx < n_act + k)
    fresh = split_row | child_b
    # Invalidate stale values on fresh rows so masked reductions stay exact.
    est = torch.where(fresh, torch.zeros_like(est), est)
    err = torch.where(fresh, torch.zeros_like(err), err)
    axis = torch.where(fresh, torch.zeros_like(axis), axis)
    fresh = fresh & active

    rows = dict(
        centers=new_centers, halfw=new_halfw, est=est, err=err, axis=axis,
        active=active, fresh=fresh,
    )
    scalars = dict(fin_integral=fin_integral, fin_error=fin_error, overflowed=overflowed)
    return rows, scalars


def stage_spans(recorder) -> dict:
    """The keyword arguments that give :func:`classify_split_compact` its
    stage spans on ``recorder``: none when telemetry is off, so that the
    call is then the three-argument one that stand-ins for the advance
    (planted faults, test spies) take."""
    return {"recorder": recorder} if recorder.enabled else {}


def split_compact_rows(
    capacity: int, rows: dict, scalars: dict, finalize_mask: torch.Tensor
) -> tuple[dict, dict]:
    """The advance over a leading problem axis: ``(S, w, ...)`` rows.

    ``rows`` holds the fields of :data:`ROWS` over the leading ``w`` rows of
    S stores (``centers`` and ``halfw`` ``(S, w, d)``, the rest ``(S, w)``),
    ``scalars`` the fields of :data:`SCALARS` as ``(S,)``, and
    ``finalize_mask`` is ``(S, w)``.  Every problem is advanced on its own,
    by batched torch operations over the problem axis: the per-problem counts
    are ``(S,)`` tensors compared against ``idx[None, :]``, the gathers run
    along dim 1.  Returns new ``(rows, scalars)``.  A single store is the
    ``S = 1`` case (:func:`classify_split_compact`).
    """
    rows, scalars = _compact_rows(rows, scalars, finalize_mask)
    return _split_rows(capacity, rows, scalars)


def classify_split_compact(
    state: RegionState,
    finalize_mask: torch.Tensor,
    window: Optional[int] = None,
    recorder=NULL,
) -> RegionState:
    """Apply the classifier verdict, then split every surviving region.

    Under capacity pressure only the top-(free slots) regions by error are
    split; the rest stay active-but-unsplit.  ``overflowed`` records that
    pressure was ever hit.  ``finalize_mask`` has shape ``(window,)``
    (``(capacity,)`` when ``window`` is ``None``).  The single-store case of
    :func:`split_compact_rows`.  ``recorder`` gets a ``core.compact`` span
    (the fold of the finalised rows, the survivor sort and the gathers) and
    a ``core.split`` span (the forced finalise, the children and the
    write-back into the store).
    """
    w = _window(state, window)
    rows = {name: getattr(state, name)[:w][None] for name in ROWS}
    scalars = {name: getattr(state, name)[None] for name in SCALARS}
    with recorder.span("core.compact"):
        rows, scalars = _compact_rows(rows, scalars, finalize_mask[None])
    with recorder.span("core.split"):
        rows, scalars = _split_rows(state.capacity, rows, scalars)
        # In place on the leading window; the tail is all-inactive and
        # fresh-free by the window contract.
        for name in ROWS:
            getattr(state, name)[:w] = rows[name][0]
    return dataclasses.replace(state, **{name: scalars[name][0] for name in SCALARS})


def compact(state: RegionState, window: Optional[int] = None) -> RegionState:
    """Compact actives to the front by descending error (no split), in place.

    Every active slot must already sit inside ``window``.
    """
    w = _window(state, window)
    perm = survivor_sort_perm(state.err[:w], state.active[:w])
    for name in ("centers", "halfw", "est", "err", "axis", "active", "fresh"):
        arr = getattr(state, name)
        arr[:w] = arr[:w][perm]
    return state
