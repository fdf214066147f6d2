"""Decentralised cyclic load redistribution (the paper's §3 contribution).

Pairing: at iteration ``t`` every rank pairs with the rank at ring distance
``s = schedule[t mod len(schedule)]``, the paper's "cyclic round-robin
policy".  The schedule front-loads power-of-two strides (see
:func:`make_schedule`).  The JAX package dispatches the round through
``lax.switch`` on the device's iteration counter; here the host knows the
counter, so the round is picked by a host index (:func:`round_shift`), on
the counter before the driver bumps it.

The round (:func:`redistribute`), on the per-rank states of
:mod:`repro_torch.core.ranks`, with every count on the device:

  plan:     from every rank's live count after the split, each rank
            computes the fair share and the ``[n_rows, free, surplus,
            deficit]`` of itself, of its receiver and of its donor, so
            donors see their receiver's room and receivers know what is
            coming (the JAX package's psum and two ppermutes of the stats);
  transfer: the donor's tail window ``[n_rows - n_send, n_rows)``
            (centres and half-widths only: the paper transfers "subregion
            coordinates rather than full data structures") is written into
            the receiver's store after its own rows, marked fresh so that
            it is evaluated again there, and retired on the donor.

A rank never both sends and receives in one round: ``n_send > 0`` needs a
surplus (count above ``ceil(total / n)``), ``n_recv > 0`` a deficit (below
``total // n``).  So in a round a donor's rows are only read and a
receiver's only written, and every rank on one device runs its part of the
round at once, each receiver reading its donor's rows where they lie.  On
the card that is one CUDA kernel a device a round
(``kernels/csrc/redistribute_round.cu``, ``redistribute_round``), which
reads the ranks' counts through their pointers; only a donor whose
receiver lives on another device packs its window into a fixed ``(min(cap,
C), 2d)`` block first (``redistribute_pack``, one launch a device), which
one copy moves to the receiver's device.  On the CPU the same round is the
kernels' plain versions (``kernels/ref.py::round_ref``, one call a round,
and ``round_pack_ref``), with the same bits.  ``chip_smoke.py`` phase 3b
holds the kernels to the plain versions bit for bit on
``gm_perf.py::round_grid``, with every donor local and with every other
donor staged.

The round reads nothing back, so the distributed driver can run several
iterations per host read.  :func:`round_counts` is the same arithmetic on
host integers.  The tail window holds the children of the largest-error
parents (see ``split.classify_split_compact``), so removing it keeps the
occupied block contiguous without another compaction.
"""

from __future__ import annotations

import operator
import weakref
from typing import Optional, Sequence

import torch

from repro_torch.core.ranks import Ranks
from repro_torch.core.region_store import RegionState
from repro_torch.kernels import redistribute_round as round_kernels
from repro_torch.kernels.ref import round_pack_ref, round_ref


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


class _PlainKernels:
    """The round kernels' plain versions behind the methods of
    ``round_kernels.RoundKernels``, for CPU stores."""

    def round(self, *args):
        return round_ref(*args)

    def pack(self, *args):
        return round_pack_ref(*args)


class RoundPlan:
    """The rounds of one run: its ranks grouped by device (``groups``, by
    default one group per device), one kernels object a group, and the
    fixed blocks through which a donor feeds a receiver of another group.

    A call is one round: at most one pack launch a group that has a donor
    whose receiver is in another group, one copy a such donor, then one
    round launch a group.  With one group nothing is packed or copied and
    the counts are read where they are.
    """

    def __init__(self, devices: Sequence, groups: Optional[Sequence[Sequence[int]]] = None):
        devices = list(devices)
        if groups is None:
            by_device: dict = {}
            for r, dev in enumerate(devices):
                by_device.setdefault(dev, []).append(r)
            groups = list(by_device.values())
        self.groups = [list(g) for g in groups]
        self.group_of = [0] * len(devices)  # each rank's group
        self.slot = [0] * len(devices)  # each rank's index in its group
        for g, ranks in enumerate(self.groups):
            for i, r in enumerate(ranks):
                self.group_of[r], self.slot[r] = g, i
        if sorted(r for g in self.groups for r in g) != list(range(len(devices))):
            raise ValueError(f"groups {groups} do not partition {len(devices)} ranks")
        cuda = devices[0].type == "cuda"
        self.kernels = [round_kernels.RoundKernels() if cuda else _PlainKernels()
                        for _ in self.groups]
        self._blocks = None  # ((P, dtype), outgoing per rank, incoming per rank)

    def __call__(self, ranks: Ranks, stores, n_rows, shift: int, cap: int, limit: int):
        n = len(stores)
        if len(self.groups) == 1:
            sources = [(r - shift) % n for r in range(n)]
            return self.kernels[0].round(n_rows, range(n), shift, cap, limit, stores, sources)

        group_of = self.group_of
        gathered = ranks.gather(n_rows)  # (n,) on the first rank's device
        counts = []
        for rs in self.groups:
            dev = ranks.devices[rs[0]]
            counts.append(gathered if dev == ranks.first
                          else gathered.to(dev, non_blocking=True))
        crossing = [u for u in range(n) if group_of[u] != group_of[(u + shift) % n]]
        incoming = None
        if crossing:
            outgoing, incoming = self._staging(ranks, stores, cap)
            for g, rs in enumerate(self.groups):
                donors = [u for u in rs if group_of[(u + shift) % n] != g]
                if donors:
                    self.kernels[g].pack(counts[g], donors, shift, cap, limit,
                                         [stores[u][:2] for u in donors],
                                         [outgoing[u] for u in donors])
            for u in crossing:
                incoming[(u + shift) % n].copy_(outgoing[u], non_blocking=True)
        after, moved = [None] * n, [None] * n
        for g, rs in enumerate(self.groups):
            sources = [incoming[r] if group_of[(r - shift) % n] != g
                       else self.slot[(r - shift) % n] for r in rs]
            a, m = self.kernels[g].round(counts[g], rs, shift, cap, limit,
                                         [stores[r] for r in rs], sources)
            for r, x, y in zip(rs, a, m):
                after[r], moved[r] = x, y
        return after, moved

    def _staging(self, ranks: Ranks, stores, cap: int):
        """Each rank's outgoing and incoming ``(min(cap, C), 2d)`` block on
        its device, made once for the run (views of one buffer a group)."""
        C, d = stores[0][0].shape
        key = (min(cap, C), stores[0][0].dtype)
        if self._blocks is None or self._blocks[0] != key:
            outgoing, incoming = [None] * len(stores), [None] * len(stores)
            for rs in self.groups:
                for blocks in (outgoing, incoming):
                    buf = torch.zeros((len(rs), key[0], 2 * d), dtype=key[1],
                                      device=ranks.devices[rs[0]])
                    for i, r in enumerate(rs):
                        blocks[r] = buf[i]
            self._blocks = (key, outgoing, incoming)
        return self._blocks[1], self._blocks[2]


_store_fields = operator.attrgetter(*round_kernels.FIELDS)

# each run's plan, made at its first round and dropped with its Ranks
_PLANS: "weakref.WeakKeyDictionary[Ranks, RoundPlan]" = weakref.WeakKeyDictionary()


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
    regions each rank sent, as int64 tensors on the ranks' devices (fresh
    each round: the counts after the round are the next iteration's).

    The run's :class:`RoundPlan` (made at its first round) groups the
    ranks by device: on the card one ``redistribute_round`` launch a
    device, each receiver reading its donor's rows in place or, for a
    donor on another device, the block that donor packed; on the CPU one
    ``round_ref`` call.
    """
    n_rows = list(n_rows)
    n = ranks.n
    if n <= 1 or not schedule:
        return states, n_rows, [torch.zeros_like(r) for r in n_rows]
    plan = _PLANS.get(ranks)
    if plan is None:
        plan = _PLANS[ranks] = RoundPlan(ranks.devices)
    stores = [_store_fields(st) for st in states]
    after, moved = plan(ranks, stores, n_rows, round_shift(schedule, it), cap, limit)
    return states, after, moved


def balance_stats(n_rows: Sequence[int]) -> tuple[int, float, float]:
    """(max, mean, imbalance) of per-rank live counts, the idle-time proxy
    of the Fig. 4b benchmark (idle ~ 1 - mean / max)."""
    biggest = max(n_rows)
    mean = sum(n_rows) / len(n_rows)
    imb = 1.0 - mean / max(biggest, 1) if biggest > 0 else 0.0
    return biggest, mean, imb
