"""The one generator: the same stream for a seed, the same pool for every seed."""

import itertools

from qbench import files, traffic

GAUSS8 = files.load_json(files.HERE / "configs" / "gauss8.json")
BIG = 2**31 + 12345  # the driver's seeds pass 32 signed bits
# a drawn mix: u per axis from a range, two tolerances striped over the pool
DRAWN = {"kind": "solve_loop", "pool": 24, "pool_seed": 3, "theta": {"u": [0.2, 0.8]},
         "rel_tol": [1e-3, 1e-7], "warmup": 2}


def _first(traffic_file, seed, n):
    return list(itertools.islice(traffic.problems(traffic_file, GAUSS8, seed), n))


def test_stream_repeats_per_seed_and_differs_between_seeds():
    assert _first(DRAWN, BIG, 200) == _first(DRAWN, BIG, 200)
    assert _first(DRAWN, BIG, 200) != _first(DRAWN, BIG + 1, 200)


def test_every_round_is_the_whole_pool():
    n = DRAWN["pool"]
    pool = traffic.pool(DRAWN, GAUSS8)
    order = list(itertools.islice(traffic.order(n, BIG), 3 * n))
    for r in range(3):
        assert sorted(order[r * n:(r + 1) * n]) == list(range(n))
    first_round = _first(DRAWN, BIG, n)
    assert sorted(map(str, first_round)) == sorted(map(str, pool))


def test_pool_is_the_same_for_every_seed_and_in_its_ranges():
    pool = traffic.pool(DRAWN, GAUSS8)
    assert pool == traffic.pool(DRAWN, GAUSS8) and len(pool) == DRAWN["pool"]
    for j, p in enumerate(pool):
        assert p["theta"]["a"] == GAUSS8["theta"]["a"]  # a field the file does not range
        assert len(p["theta"]["u"]) == 8 and all(0.2 <= u <= 0.8 for u in p["theta"]["u"])
        assert p["rel_tol"] == DRAWN["rel_tol"][j % 2] and p["d"] == 8
    assert traffic.warmup_problems(DRAWN, GAUSS8) == pool[:2]


def test_solve_loop_problem_is_fixed():
    single = files.load_json(files.HERE / "traffic" / "single.json")
    a, b = _first(single, 1, 2), _first(single, BIG, 2)
    assert a == b and a[0]["theta"] == GAUSS8["theta"]
    assert a[0]["rel_tol"] == GAUSS8["quadrature"]["rel_tol"]
    assert traffic.warmup_problems(single, GAUSS8) == a[:1]
