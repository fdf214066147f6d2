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


def _port_round(arrays, n, cap, limit, it, n_rows="host"):
    ranks = Ranks(["cpu"] * n)
    states = ranks.states_from_stacked(arrays)
    rows = arrays["active"].sum(axis=1).tolist() if n_rows == "host" else None
    states, after = tred.redistribute(
        states, ranks, schedule=tred.make_schedule(n), cap=cap, limit=limit,
        it=it, n_rows=rows,
    )
    got = {k: np.stack([getattr(s, k).numpy() for s in states]) for k in FIELDS}
    return got, after


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
    # the host's transfer sizes agree with the device's result
    assert after == ref["active"].sum(axis=1).tolist()


def test_round_reads_counts_when_not_given():
    arrays = _stacked_arrays(4, [40, 0, 5, 10], 0, 3)
    got, after = _port_round(arrays, 4, 16, 48, 0, n_rows=None)
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
    _, up = tred.ring_perms(3, 1)
    out = ranks.ppermute(vals, up)
    assert [t.tolist() for t in out] == [[4.0, 3.0], [1.0, 5.0], [2.0, 1.0]]
    with pytest.raises(ValueError, match="does not cover"):
        ranks.ppermute(vals, [(0, 1), (1, 0)])
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
