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

  phase 1 (stats):   every rank's live count is gathered (``Ranks.gather``)
                     and copied to each other rank's device; from them each
                     rank computes the fair share and the
                     ``[n_rows, free, surplus, deficit]`` of itself, of its
                     receiver and of its donor, so donors see their
                     receiver's room and receivers know what is coming (the
                     JAX package's psum and two ppermutes of the stats).
  phase 2 (payload): the donor's tail window ``[n_rows - n_send, n_rows)``
                     (centres ++ half-widths only: the paper transfers
                     "subregion coordinates rather than full data
                     structures") goes to the receiver's device as a fixed
                     ``(cap, 2d)`` block, zeroed past ``n_send``; the
                     receiver splices it in after its own rows and marks it
                     fresh, so it is evaluated again there.

Each rank's part is two steps, pack (plan and payload) and splice: on the
card two CUDA kernels (``kernels/csrc/redistribute_round.cu``), on the CPU
their plain versions (``kernels/ref.py``), with the same bits.

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
from repro_torch.kernels import redistribute_round as round_kernels
from repro_torch.kernels.ref import round_pack_ref, round_splice_ref


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

    The counts are gathered once and copied to each other rank's device;
    then every rank packs (its plan and payload), the payloads move one
    ring step along ``up``, and every rank splices.  On CUDA states pack
    and splice are the kernels of :mod:`repro_torch.kernels.redistribute_round`
    (two launches a rank); on CPU states, their plain versions.
    """
    n_rows = list(n_rows)
    n = ranks.n
    if n <= 1 or not schedule:
        return states, n_rows, [torch.zeros_like(r) for r in n_rows]
    shift = round_shift(schedule, it)
    _, up = ring_perms(n, shift)
    if states[0].centers.device.type == "cuda":
        pack, splice = round_kernels.round_pack, round_kernels.round_splice
    else:
        pack, splice = round_pack_ref, round_splice_ref

    counts = {ranks.first: ranks.gather(n_rows)}
    plans, payload = [], []
    for r, st in enumerate(states):
        dev = st.centers.device
        if dev not in counts:
            counts[dev] = counts[ranks.first].to(dev, non_blocking=True)
        plan, block = pack(counts[dev], r, shift, cap, limit, st.centers, st.halfw)
        plans.append(plan)
        payload.append(block)
    incoming = ranks.ppermute(payload, up)

    after, moved = [], []
    for st, plan, got in zip(states, plans, incoming):
        a, k = splice(plan, got, st.centers, st.halfw, st.est, st.err, st.axis, st.active,
                      st.fresh)
        after.append(a)
        moved.append(k)
    return states, after, moved


def balance_stats(n_rows: Sequence[int]) -> tuple[int, float, float]:
    """(max, mean, imbalance) of per-rank live counts, the idle-time proxy
    of the Fig. 4b benchmark (idle ~ 1 - mean / max)."""
    biggest = max(n_rows)
    mean = sum(n_rows) / len(n_rows)
    imb = 1.0 - mean / max(biggest, 1) if biggest > 0 else 0.0
    return biggest, mean, imb
