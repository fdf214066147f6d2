"""Decentralised cyclic load redistribution (the paper's §3 contribution).

Pairing: at iteration ``t`` every rank pairs with the rank at ring distance
``s = schedule[t mod len(schedule)]``, the paper's "cyclic round-robin
policy".  The schedule front-loads power-of-two strides (see
:func:`make_schedule`).  The JAX package dispatches the round through
``lax.switch`` on the device's iteration counter; here the host knows the
counter, so the round is picked by a host index (:func:`round_shift`), on
the counter before the driver bumps it.

Transfer protocol of one round (:func:`redistribute`), on the per-rank
states of :mod:`repro_torch.core.ranks`, with every count on the device:

  phase 1 (stats):   each rank's ``[n_rows, free, surplus, deficit]`` (int64,
                     on its device) goes to its upstream and its downstream
                     partner through ``Ranks.ppermute``, so donors see their
                     receiver's room and receivers know what is coming; the
                     fair share comes from ``Ranks.psum`` of the counts.
  phase 2 (payload): the donor's tail window ``[n_rows - n_send, n_rows)``
                     (centres ++ half-widths only: the paper transfers
                     "subregion coordinates rather than full data
                     structures") goes to the receiver's device as a fixed
                     ``(cap, 2d)`` block, zeroed past ``n_send``; the
                     receiver splices it in after its own rows and marks it
                     fresh, so it is evaluated again there.

The round reads nothing back, so the distributed driver can run several
iterations per host read.  :func:`round_counts` is the same arithmetic on
host integers.

A transfer happens only from donor to receiver (a rank with surplus never
has a deficit, so at most one direction of a pair is live).  The tail
window holds the children of the largest-error parents (see
``split.classify_split_compact``), so removing it keeps the occupied block
contiguous without another compaction.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.ranks import Ranks
from repro_torch.core.region_store import RegionState


def make_schedule(n_devices: int, max_len: int = 8) -> tuple[int, ...]:
    """Ring-shift schedule: powers of two first, then the remaining strides
    in ascending order, up to ``max_len`` entries."""
    if n_devices <= 1:
        return ()
    shifts: list[int] = []
    s = 1
    while s < n_devices and len(shifts) < max_len:
        shifts.append(s)
        s <<= 1
    s = 3
    while len(shifts) < min(n_devices - 1, max_len):
        if s < n_devices and s not in shifts:
            shifts.append(s)
        s += 1
    return tuple(shifts)


def ring_perms(n: int, shift: int) -> tuple[list, list]:
    """The two permutations of one cyclic round at ring distance ``shift``:
    ``down`` routes rank ``i``'s data to ``i - shift`` (so every rank sees
    its downstream partner ``i + shift``), ``up`` routes to ``i + shift``
    (the payload direction: donor ``i`` feeds ``i + shift``)."""
    down = [(i, (i - shift) % n) for i in range(n)]
    up = [(i, (i + shift) % n) for i in range(n)]
    return down, up


def check_ring_invariants(n_devices: int) -> None:
    """Assert the schedule and permutation invariants of an ``n_devices`` ring.

    Every shift of :func:`make_schedule` is a nonzero ring distance below
    ``n_devices``, with no duplicates, and each of its :func:`ring_perms`
    directions is a bijection on ranks, the two mutually inverse.  The
    trivial ring (``n_devices <= 1``) has an empty schedule.
    """
    schedule = make_schedule(n_devices)
    if n_devices <= 1:
        assert schedule == (), schedule
        return
    assert len(set(schedule)) == len(schedule), schedule
    ranks = list(range(n_devices))
    for shift in schedule:
        assert 0 < shift < n_devices, (shift, n_devices)
        down, up = ring_perms(n_devices, shift)
        for perm in (down, up):
            assert sorted(s for s, _ in perm) == ranks, perm
            assert sorted(d for _, d in perm) == ranks, perm
        assert {(d, s) for s, d in down} == set(up), (down, up)


def _permute(values: Sequence, perm) -> list:
    out = [None] * len(values)
    for src, dst in perm:
        out[dst] = values[src]
    return out


def exchange_pair_stats(stats: Sequence, n_devices: int, shift: int) -> tuple[list, list]:
    """Phase-1 stats swap of a cyclic round, on per-rank host values.

    Returns ``(down_stats, up_stats)``: on rank ``i``, ``down_stats[i]`` is
    the stats of its receiver ``i + shift`` and ``up_stats[i]`` that of its
    donor ``i - shift``.
    """
    down, up = ring_perms(n_devices, shift)
    return _permute(stats, down), _permute(stats, up)


def round_shift(schedule: Sequence[int], it: int) -> int:
    """The ring distance of round ``it`` (the pre-bump iteration counter)."""
    return schedule[it % len(schedule)]


def round_counts(
    n_rows: Sequence[int], shift: int, cap: int, limit: int
) -> tuple[list[int], list[int]]:
    """Regions each rank sends and receives in one round: ``(n_send, n_recv)``.

    ``n_rows`` are the per-rank live counts; the fair share is
    ``[total // n, ceil(total / n)]``, a rank never fills past ``limit``,
    and ``cap`` bounds one message.
    """
    n = len(n_rows)
    total = sum(n_rows)
    fair_lo = total // n
    fair_hi = -(-total // n)
    stats = [
        (r, max(limit - r, 0), max(r - fair_hi, 0), max(fair_lo - r, 0))
        for r in n_rows
    ]
    down_stats, up_stats = exchange_pair_stats(stats, n, shift)
    n_send, n_recv = [], []
    for (_, free, surplus, deficit), down, up in zip(stats, down_stats, up_stats):
        _, down_free, _, down_deficit = down
        up_surplus = up[2]
        n_send.append(min(cap, surplus, down_deficit, down_free))
        n_recv.append(min(cap, up_surplus, deficit, free))
    return n_send, n_recv


def redistribute(
    states: list[RegionState],
    ranks: Ranks,
    *,
    schedule: Sequence[int],
    cap: int,
    limit: int,
    it: int,
    n_rows: Sequence[torch.Tensor],
) -> tuple[list[RegionState], list[torch.Tensor], list[torch.Tensor]]:
    """One redistribution round over the per-rank states, in place.

    ``it`` is the iteration counter before the driver bumps it; ``n_rows``
    the per-rank live counts as int64 tensors, each on its rank's device.
    Nothing is read back: every count and size stays on the device.
    Returns the states, each rank's live count after the round and the
    regions each rank sent, as int64 tensors on the ranks' devices.
    """
    n_rows = list(n_rows)
    n = ranks.n
    if n <= 1 or not schedule:
        return states, n_rows, [torch.zeros_like(r) for r in n_rows]
    shift = round_shift(schedule, it)
    down, up = ring_perms(n, shift)

    # --- phase 1: stats both ways -------------------------------------------
    total = ranks.psum(n_rows)
    fair = torch.stack([total // n, -(-total // n)])  # [fair_lo, fair_hi]
    stats = []
    for rows, dev in zip(n_rows, ranks.devices):
        fair_lo, fair_hi = fair.to(dev, non_blocking=True).unbind()
        # [n_rows, free, surplus, deficit]; n_rows >= 0 already
        stats.append(torch.stack([rows, limit - rows, rows - fair_hi, fair_lo - rows]).clamp(min=0))
    down_stats = ranks.ppermute(stats, down)
    up_stats = ranks.ppermute(stats, up)

    # --- phase 2: payload (coordinates only), donor i -> i + shift ----------
    # Every rank sends the same number of rows (cap, or C if smaller: no
    # more can be live), zeroed past its n_send, so no shape depends on the
    # counts.  The rows are read at (n_rows - n_send + j) mod C: the sent
    # ones are where the reference's clamped positions are, and the same
    # read gives the receiver's splice its old rows.
    aranges: dict = {}
    plans, payload = [], []
    for st, rows, own, ds, us in zip(states, n_rows, stats, down_stats, up_stats):
        C = st.capacity
        # n_send = min(cap, surplus, down_free, down_deficit),
        # n_recv = min(cap, up_surplus, free, deficit)
        room = torch.stack([ds, own])[:, 1::2].amin(1)
        offer = torch.stack([own, us])[:, 2]
        n_send, n_recv = torch.minimum(offer, room).clamp(max=cap).unbind()
        dev = st.centers.device
        if dev not in aranges:
            aranges[dev] = torch.arange(min(cap, C), device=dev)
        j = aranges[dev]
        base = rows - n_send
        dest = (base + j) % C
        coords = torch.cat([st.centers.index_select(0, dest), st.halfw.index_select(0, dest)], 1)
        sent = j < n_send
        payload.append(torch.where(sent[:, None], coords, 0.0))
        plans.append((j, base, dest, coords, sent, n_send, n_recv))
    incoming = ranks.ppermute(payload, up)

    # --- retire the sent window, splice the received one ---------------------
    # Both are rows base + j (a rank sends or receives, never both), written
    # at (base + j) mod C: distinct positions, so the write is deterministic.
    # A row neither sent nor received gets its old value back, and a
    # received row past the store is dropped.
    after, moved = [], []
    for st, (j, base, dest, coords, sent, n_send, n_recv), got in zip(
        states, plans, incoming
    ):
        C, d = st.capacity, st.d
        kept = torch.minimum(n_recv, C - base)
        recv = j < kept
        new = torch.where(recv[:, None], got, coords)
        st.centers.index_copy_(0, dest, new[:, :d])
        st.halfw.index_copy_(0, dest, new[:, d:])
        for field in ("est", "err", "axis"):
            t = getattr(st, field)
            t.index_copy_(0, dest, t.index_select(0, dest).masked_fill(recv, 0))
        keep = ~sent
        for field in ("active", "fresh"):
            t = getattr(st, field)
            t.index_copy_(0, dest, t.index_select(0, dest) & keep | recv)
        after.append(base + kept)
        moved.append(n_send)
    return states, after, moved


def balance_stats(n_rows: Sequence[int]) -> tuple[int, float, float]:
    """(max, mean, imbalance) of per-rank live counts, the idle-time proxy
    of the Fig. 4b benchmark (idle ~ 1 - mean / max)."""
    biggest = max(n_rows)
    mean = sum(n_rows) / len(n_rows)
    imb = 1.0 - mean / max(biggest, 1) if biggest > 0 else 0.0
    return biggest, mean, imb
