"""The port's cyclic redistribution against the JAX package's.

The reference round runs in this process: ``jax.vmap`` with an axis name
gives ``redistribute``'s ``psum`` and ``ppermute`` a rank axis on one CPU
device, so no device count has to be forced.  The port's round runs on
``["cpu"] * n`` ranks from the same arrays; every array must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import redistribution as jred
from repro.core.region_store import RegionState as JState
from repro_torch.core import redistribution as tred
from repro_torch.core.ranks import Ranks, cuda_devices
from repro_torch.core.region_store import FIELDS
from repro_torch.kernels.redistribute_round import FIELDS as ROUND_FIELDS

_C = 64  # store capacity per rank
_D = 2
_CAP = 8  # message cap per round
_LIMIT = 3 * _C // 4


def _stacked_arrays(n, counts, it, seed, capacity=_C):
    """Seeded per-rank states as tests/test_redistribution.py builds them."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.1, 0.9, (n, capacity, _D))
    halfw = rng.uniform(0.01, 0.1, (n, capacity, _D))
    est = rng.uniform(-1.0, 1.0, (n, capacity))
    err = rng.uniform(1e-6, 1.0, (n, capacity))
    active = np.zeros((n, capacity), bool)
    for dev, cnt in enumerate(counts):
        active[dev, :cnt] = True
    return {
        "centers": centers,
        "halfw": halfw,
        "est": np.where(active, est, 0.0),
        "err": np.where(active, err, 0.0),
        "axis": rng.integers(0, _D, (n, capacity)).astype(np.int32),
        "active": active,
        "fresh": active & (rng.uniform(size=(n, capacity)) < 0.5),
        "fin_integral": np.zeros(n),
        "fin_error": np.zeros(n),
        "n_evals": np.zeros(n),
        "it": np.full(n, it, np.int32),
        "overflowed": np.zeros(n, bool),
    }


_JAX_ROUNDS: dict = {}


def _jax_round(arrays, n, cap, limit):
    key = (n, cap, limit)
    fn = _JAX_ROUNDS.get(key)
    if fn is None:
        schedule = jred.make_schedule(n)
        fn = jax.jit(
            jax.vmap(
                lambda s: jred.redistribute(
                    s, axis_name="dev", n_devices=n, schedule=schedule, cap=cap,
                    limit=limit,
                ),
                axis_name="dev",
            )
        )
        _JAX_ROUNDS[key] = fn
    out = fn(JState(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    return {k: np.asarray(getattr(out, k)) for k in FIELDS}


def _port_round(arrays, n, cap, limit, it, n_rows="given", sent=None):
    """The port's round on the per-rank states of ``arrays``: the fields
    after it and the live counts it returns (read here, after the round).
    ``n_rows="given"`` passes the live counts as int64 tensors made on the
    host, ``"summed"`` sums them from the states with torch; ``sent``
    collects the regions each rank sent."""
    ranks = Ranks(["cpu"] * n)
    states = ranks.states_from_stacked(arrays)
    if n_rows == "given":
        rows = [torch.tensor(int(c)) for c in arrays["active"].sum(axis=1)]
    else:
        rows = [st.active.sum() for st in states]
    states, after, moved = tred.redistribute(
        states, ranks, schedule=tred.make_schedule(n), cap=cap, limit=limit,
        it=it, n_rows=rows,
    )
    assert all(t.dtype == torch.int64 and t.dim() == 0 for t in after + moved)
    if sent is not None:
        sent.extend(int(k) for k in moved)
    got = {k: np.stack([getattr(s, k).numpy() for s in states]) for k in FIELDS}
    return got, [int(a) for a in after]


def _counts(n, seed):
    """Per-rank live counts: random, with an empty and a full-to-limit rank."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, _LIMIT + 1, n)
    counts[seed % n] = 0
    counts[(seed + 1) % n] = _LIMIT if seed % 3 else _C
    return counts.tolist()


@pytest.mark.parametrize("it", range(13))
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_round_matches_reference_bit_for_bit(n, it):
    seed = 1000 * n + it
    arrays = _stacked_arrays(n, _counts(n, seed), it, seed)
    ref = _jax_round(arrays, n, _CAP, _LIMIT)
    got, after = _port_round(arrays, n, _CAP, _LIMIT, it)
    for k in FIELDS:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the counts the round returns are those of the reference's result
    assert after == ref["active"].sum(axis=1).tolist()


@pytest.mark.parametrize("it", range(13))
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_device_counts_match_host_arithmetic(n, it):
    """The round's counts and sizes, computed on the device, against the
    same arithmetic on host integers (``round_counts``) and the reference's
    result: each rank's new count, and the regions it sent, which its
    partner's count gains."""
    seed = 1000 * n + it
    counts = _counts(n, seed)
    arrays = _stacked_arrays(n, counts, it, seed)
    sent = []
    got, after = _port_round(arrays, n, _CAP, _LIMIT, it, sent=sent)
    ref = _jax_round(arrays, n, _CAP, _LIMIT)
    shift = tred.round_shift(tred.make_schedule(n), it)
    n_send, n_recv = tred.round_counts(counts, shift, _CAP, _LIMIT)
    assert sent == n_send
    assert n_recv == [n_send[(r - shift) % n] for r in range(n)]
    assert after == [c - k + m for c, k, m in zip(counts, n_send, n_recv)]
    assert after == ref["active"].sum(axis=1).tolist()
    assert sum(max(c - a, 0) for c, a in zip(counts, after)) == sum(sent)
    # the full rank (seeds with seed % 3 == 0) takes nothing
    full = (seed + 1) % n
    assert n_recv[full] == 0 and after[full] <= counts[full]


def test_round_work_does_not_depend_on_counts():
    """The round enqueues the same operations on the same shapes whatever
    the counts are, a rank that moves nothing included: nothing about the
    work depends on a value the host would have to read."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Trace(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            shapes = [tuple(o.shape) for o in (out if isinstance(out, (tuple, list)) else [out])
                      if isinstance(o, torch.Tensor)]
            self.ops.append((str(func), shapes))
            return out

    for groups in (None, [[0, 1], [2, 3]]):  # one device; two, donors packed
        traces = []
        for counts in ([40, 0, 5, 10], [12, 12, 12, 12], [0, 0, 0, 0], [48, 48, 0, 64]):
            ranks = Ranks(["cpu"] * 4)
            states = ranks.states_from_stacked(_stacked_arrays(4, counts, 0, 3))
            plan = tred.RoundPlan(ranks.devices, groups)
            stores = [tuple(getattr(st, f) for f in ROUND_FIELDS) for st in states]
            with Trace() as trace:
                plan(ranks, stores, [st.active.sum() for st in states], 1, _CAP, _LIMIT)
                tred.redistribute(states, ranks, schedule=tred.make_schedule(4), cap=_CAP,
                                  limit=_LIMIT, it=0, n_rows=[st.active.sum() for st in states])
            traces.append(trace.ops)
        assert all(t == traces[0] for t in traces[1:])


def test_cpu_states_take_the_plain_round(monkeypatch):
    """On CPU states the round is one call of the round kernel's plain
    version a round, for every rank (they share the CPU), with no pack and
    never a kernel wrapper; the wrappers themselves refuse CPU tensors (the
    caller picks the plain version)."""
    from repro_torch.kernels import redistribute_round as rk

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran on CPU states")

    monkeypatch.setattr(rk.RoundKernels, "round", refuse)
    monkeypatch.setattr(rk.RoundKernels, "pack", refuse)
    calls = []
    for name in ("round_ref", "round_pack_ref"):
        plain = getattr(tred, name)
        monkeypatch.setattr(tred, name, lambda *a, plain=plain, name=name: calls.append(name)
                            or plain(*a))
    arrays = _stacked_arrays(4, [40, 0, 5, 10], 0, 3)
    got, after = _port_round(arrays, 4, 16, 48, 0)
    assert after == [27, 13, 5, 10]
    assert calls == ["round_ref"]
    monkeypatch.undo()

    states = Ranks(["cpu"] * 2).states_from_stacked(_stacked_arrays(2, [40, 0], 0, 3))
    stores = [tuple(getattr(st, f) for f in ROUND_FIELDS) for st in states]
    counts = [torch.tensor(40), torch.tensor(0)]
    sources = [1, 0]  # each rank's donor, by its index in stores
    with pytest.raises(ValueError, match="CUDA tensors"):
        rk.RoundKernels().round(counts, [0, 1], 1, _CAP, _LIMIT, stores, sources)
    block = torch.zeros((_CAP, 2 * _D), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rk.RoundKernels().pack(counts, [0], 1, _CAP, _LIMIT, [stores[0][:2]], [block])
    assert rk.launch_count("round") == rk.launch_count("pack") == 0


def test_plain_pack_and_splice_follow_the_plan():
    """The plain round's counts are ``round_counts``' arithmetic (the count
    after the round and the rows sent); the plain pack's block holds the
    donor's tail rows and zeros after them; the received rows are the
    donor's tail, fresh, with est, err and axis cleared."""
    counts = [40, 0, 5, 10]
    arrays = _stacked_arrays(4, counts, 0, 3)
    states = Ranks(["cpu"] * 4).states_from_stacked(arrays)
    stores = [tuple(getattr(st, f) for f in ROUND_FIELDS) for st in states]
    n_send, n_recv = tred.round_counts(counts, 1, 16, 48)
    t = [torch.tensor(c) for c in counts]
    blocks = [torch.full((16, 2 * _D), np.nan, dtype=torch.float64) for _ in range(4)]
    tred.round_pack_ref(t, range(4), 1, 16, 48, [s[:2] for s in stores], blocks)
    for r, block in enumerate(blocks):
        sent = slice(counts[r] - n_send[r], counts[r])
        want = np.concatenate([arrays["centers"][r][sent], arrays["halfw"][r][sent]], 1)
        np.testing.assert_array_equal(block[:n_send[r]].numpy(), want)
        assert not block[n_send[r]:].any()
    sources = [(r - 1) % 4 for r in range(4)]
    after, moved = tred.round_ref(t, range(4), 1, 16, 48, stores, sources)
    assert [int(k) for k in moved] == n_send == [13, 0, 0, 0]
    assert [int(a) for a in after] == [c - k + m for c, k, m in zip(counts, n_send, n_recv)]
    assert after[0].data_ptr() + 16 == after[1].data_ptr()  # views of one (4, 2) tensor
    got = states[1]
    np.testing.assert_array_equal(got.centers[:13].numpy(), arrays["centers"][0][27:40])
    assert got.fresh[:13].all() and got.active[:13].all() and not got.est[:13].any()
    assert not states[0].active[27:40].any() and not states[0].fresh[27:40].any()


def _sources(stores, n, shift, staged, blocks):
    """Each rank's receive source: its donor's index in the stores, or the
    donor's staged block where the donor is in ``staged``."""
    return [blocks[(r - shift) % n] if (r - shift) % n in staged else (r - shift) % n
            for r in range(n)]


@pytest.mark.parametrize("it", range(13))
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_staged_route_matches_local_route(n, it):
    """The same round with every other donor packed into a block
    (``round_pack_ref``) and read from it, against every donor read in
    place: every field and count equal, and the blocks hold what the donors
    sent."""
    seed = 1000 * n + it
    counts = _counts(n, seed)
    arrays = _stacked_arrays(n, counts, it, seed)
    shift = tred.round_shift(tred.make_schedule(n), it)
    t = [torch.tensor(c) for c in counts]
    results = []
    for staged in (set(), set(range(1, n, 2))):
        states = Ranks(["cpu"] * n).states_from_stacked(arrays)
        stores = [tuple(getattr(st, f) for f in ROUND_FIELDS) for st in states]
        blocks = {u: torch.zeros((_CAP, 2 * _D), dtype=torch.float64) for u in staged}
        if staged:
            tred.round_pack_ref(t, sorted(staged), shift, _CAP, _LIMIT,
                                [stores[u][:2] for u in sorted(staged)],
                                [blocks[u] for u in sorted(staged)])
        after, moved = tred.round_ref(t, range(n), shift, _CAP, _LIMIT, stores,
                                      _sources(stores, n, shift, staged, blocks))
        results.append(({k: np.stack([getattr(s, k).numpy() for s in states]) for k in FIELDS},
                        [int(a) for a in after], [int(m) for m in moved]))
    (local, after, moved), (staged, after_s, moved_s) = results
    assert (after, moved) == (after_s, moved_s)
    for k in FIELDS:
        np.testing.assert_array_equal(local[k], staged[k], err_msg=k)
    ref = _jax_round(arrays, n, _CAP, _LIMIT)
    for k in FIELDS:
        np.testing.assert_array_equal(staged[k], ref[k], err_msg=k)


@pytest.mark.parametrize("it", range(13))
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_grouped_plan_matches_one_group(n, it):
    """The driver's round with the ranks split into two groups (as over two
    devices: the counts gathered and copied, the donors whose receiver is
    in the other group packed, their blocks copied across), against the
    one-group round: every field and count equal."""
    seed = 1000 * n + it
    arrays = _stacked_arrays(n, _counts(n, seed), it, seed)
    ref, after_ref = _port_round(arrays, n, _CAP, _LIMIT, it)
    ranks = Ranks(["cpu"] * n)
    states = ranks.states_from_stacked(arrays)
    plan = tred.RoundPlan(ranks.devices, groups=[list(range(0, n, 2)), list(range(1, n, 2))])
    stores = [tuple(getattr(st, f) for f in ROUND_FIELDS) for st in states]
    rows = [torch.tensor(int(c)) for c in arrays["active"].sum(axis=1)]
    shift = tred.round_shift(tred.make_schedule(n), it)
    after, moved = plan(ranks, stores, rows, shift, _CAP, _LIMIT)
    assert [int(a) for a in after] == after_ref
    assert [int(m) for m in moved] == tred.round_counts(
        arrays["active"].sum(axis=1).tolist(), shift, _CAP, _LIMIT)[0]
    for k in FIELDS:
        np.testing.assert_array_equal(np.stack([getattr(s, k).numpy() for s in states]), ref[k],
                                      err_msg=k)


@pytest.mark.parametrize("cap", [8, 100])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_no_rank_both_sends_and_receives(n, cap):
    """What lets one launch run every rank of a device with no barrier: in
    ``round_counts``, at every shift, no rank sends and receives in the same
    round, and each rank receives what its donor sends.  Random counts in a
    store of 64 rows with an empty rank, one at the round's limit and one
    full to the store, at a message cap below and above the store."""
    rng = np.random.default_rng(100 * n + cap)
    limit = 3 * _C // 4
    for trial in range(300):
        counts = rng.integers(0, _C + 1, n)
        counts[trial % n] = 0
        counts[(trial + 1) % n] = limit
        if n > 2:
            counts[(trial + 2) % n] = _C
        for shift in range(1, n):
            n_send, n_recv = tred.round_counts(counts.tolist(), shift, cap, limit)
            assert not any(k > 0 and m > 0 for k, m in zip(n_send, n_recv)), (counts, shift)
            assert n_recv == [n_send[(r - shift) % n] for r in range(n)]


def test_round_reads_counts_when_not_given():
    arrays = _stacked_arrays(4, [40, 0, 5, 10], 0, 3)
    got, after = _port_round(arrays, 4, 16, 48, 0, n_rows="summed")
    ref = _jax_round(arrays, 4, 16, 48)
    assert after == [27, 13, 5, 10] == ref["active"].sum(axis=1).tolist()
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_round_counts_follow_directions():
    # rank 0 donates to rank (0 + shift); its donor is rank (0 - shift)
    n_rows = [40, 0, 5, 10]
    n_send, n_recv = tred.round_counts(n_rows, 1, 16, 48)
    assert (n_send, n_recv) == ([13, 0, 0, 0], [0, 13, 0, 0])
    n_send, n_recv = tred.round_counts(n_rows, 2, 16, 48)
    # fair share [13, 14]: rank 0 feeds rank 2 (deficit 8)
    assert (n_send, n_recv) == ([8, 0, 0, 0], [0, 0, 8, 0])
    # the message cap and the receiver's room bound a transfer
    assert tred.round_counts([40, 0], 1, 4, 48) == ([4, 0], [0, 4])
    assert tred.round_counts([60, 46], 1, 16, 48) == ([2, 0], [0, 2])
    assert tred.round_counts([60, 48], 1, 16, 48) == ([0, 0], [0, 0])


@pytest.mark.parametrize("n", range(1, 18))
def test_schedule_and_perms_match_reference(n):
    assert tred.make_schedule(n) == jred.make_schedule(n)
    for max_len in (1, 3, 4, 8, 20):
        assert tred.make_schedule(n, max_len) == jred.make_schedule(n, max_len)
    for shift in tred.make_schedule(n):
        assert tred.ring_perms(n, shift) == jred.ring_perms(n, shift)
    tred.check_ring_invariants(n)


def test_schedule_caps_match_reference():
    for n in (1 << 10, 1 << 12, 1 << 13):
        for max_len in (4, 8):
            assert tred.make_schedule(n, max_len) == jred.make_schedule(n, max_len)
    assert tred.make_schedule(6) == (1, 2, 4, 3, 5)
    assert tred.make_schedule(0) == tred.make_schedule(1) == ()


def test_exchange_pair_stats_directions():
    stats = [(r, 0, 0, 0) for r in range(5)]
    down, up = tred.exchange_pair_stats(stats, 5, 2)
    assert [s[0] for s in down] == [2, 3, 4, 0, 1]  # receiver i + shift
    assert [s[0] for s in up] == [3, 4, 0, 1, 2]  # donor i - shift


def test_balance_stats_matches_reference():
    from repro.core.redistribution import balance_stats

    for rows in ([5, 5, 5, 5], [40, 0, 5, 10], [0, 0, 0], [7]):
        big, mean, imb = jax.vmap(
            lambda r: balance_stats(r, "dev", len(rows)), axis_name="dev"
        )(jnp.asarray(rows, jnp.int32))
        got = tred.balance_stats(rows)
        assert got == (int(big[0]), float(mean[0]), float(imb[0]))


def _coord_multiset(arrays):
    rows = np.concatenate([arrays["centers"], arrays["halfw"]], axis=-1)[arrays["active"]]
    return sorted(map(tuple, rows))


@given(
    n=st.sampled_from([2, 3, 4, 8]),
    counts_seed=st.integers(0, 2**31 - 1),
    it=st.integers(0, 12),
)
@settings(max_examples=40, deadline=None)
def test_transfer_round_invariants(n, counts_seed, it):
    """The checks of tests/test_redistribution.py, on the port's round."""
    rng = np.random.default_rng(counts_seed)
    counts = rng.integers(0, _LIMIT + 1, n).tolist()
    arrays = _stacked_arrays(n, counts, it, counts_seed)
    before = _coord_multiset(arrays)
    out, after = _port_round(arrays, n, _CAP, _LIMIT, it)
    act, fresh, err = out["active"], out["fresh"], out["err"]
    new_counts = act.sum(axis=1)
    assert new_counts.tolist() == after
    assert int(new_counts.sum()) == sum(counts)
    assert _coord_multiset(out) == before
    for dev in range(n):
        m = int(new_counts[dev])
        assert not act[dev, m:].any(), (dev, counts, new_counts)
        if m > counts[dev]:
            assert m <= _LIMIT, (dev, counts, new_counts)
            moved = np.zeros(_C, bool)
            moved[counts[dev]:m] = True
            assert fresh[dev][moved].all() and not err[dev][moved].any()
        keep = min(m, counts[dev])
        np.testing.assert_array_equal(out["est"][dev, :keep], arrays["est"][dev, :keep])


def test_ranks_collectives():
    ranks = Ranks(["cpu"] * 3)
    vals = [torch.tensor([1.0, 5.0]), torch.tensor([2.0, 1.0]), torch.tensor([4.0, 3.0])]
    assert ranks.psum(vals).tolist() == [7.0, 9.0]
    assert ranks.pmax(vals).tolist() == [4.0, 5.0]
    assert ranks.gather(vals).tolist() == [[1.0, 5.0], [2.0, 1.0], [4.0, 3.0]]
    with pytest.raises(ValueError, match="at least one rank"):
        Ranks([])


def test_ranks_on_cuda_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Ranks(["cuda"] * 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_devices(4)


def test_states_from_stacked_round_trips():
    arrays = _stacked_arrays(3, [3, 0, 7], 5, 11)
    states = Ranks(["cpu"] * 3).states_from_stacked(arrays)
    for r, s in enumerate(states):
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(s, k).numpy(), arrays[k][r])
    assert FIELDS == tuple(f.name for f in dataclasses.fields(JState))
