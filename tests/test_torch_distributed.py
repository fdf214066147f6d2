"""The port's multi-rank driver on four CPU ranks against the JAX driver.

The reference runs in a subprocess with four forced host devices (the
suite's own process has already initialised JAX with one), on the cases of
``repro.core.dist_selftest``, with and without redistribution.  The port
runs the same cases on ``["cpu"] * 4`` ranks from this process.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core.config import QuadratureConfig as JConfig
from repro_torch.core import adaptive as tad
from repro_torch.core import distributed as tdist
from repro_torch.core import integrands as tint
from repro_torch.core import redistribution as tred
from repro_torch.core.config import QuadratureConfig as TConfig
from repro_torch.core.ranks import Ranks
from repro_torch.core.region_store import FIELDS
from repro_torch.telemetry import MemorySink, Recorder

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# dist_selftest's cases: (integrand, d, rel_tol), capacity 2^13
CASES = [("f4", 4, 1e-6), ("f2", 3, 1e-6), ("f6", 3, 1e-5), ("f1", 4, 1e-6)]
POLICIES = ["ring", "off"]

_REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=" + sys.argv[1]
import jax
jax.config.update("jax_enable_x64", True)
from repro.core.config import QuadratureConfig
from repro.core.distributed import integrate_distributed
from repro.telemetry import MemorySink, Recorder
assert len(jax.devices()) == int(sys.argv[1])
out = {}
for key, kw in json.loads(sys.argv[2]).items():
    sink = MemorySink()
    r = integrate_distributed(QuadratureConfig(**kw), recorder=Recorder(sinks=(sink,)))
    out[key] = dict(
        executed=[e["executed"] for e in sink.events
                  if e["kind"] == "span_end" and e["name"] == "dist.dispatch"],
        I=r.integral, eps=r.error, status=r.status, iters=r.iterations,
        n_evals=r.n_evals, evals_per_device=r.evals_per_device.tolist(),
        mean_imbalance=r.mean_imbalance(),
        history=[[h[0], h[3], h[5]] for h in r.history])
print("RESULT_JSON:" + json.dumps(out))
"""


def _fields(name, d, tol, policy, **kw):
    return {**dict(d=d, integrand=name, rel_tol=tol, capacity=1 << 13, max_iters=200,
                   redistribution=policy), **kw}


def _config(name, d, tol, policy, **kw):
    return TConfig(**_fields(name, d, tol, policy, **kw))


def _run_reference(n_devices, configs):
    """The JAX driver at ``n_devices`` forced host devices, in a subprocess,
    on ``{key: QuadratureConfig fields}``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(n_devices), json.dumps(configs)],
        capture_output=True, text=True, timeout=900, cwd=ROOT, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT_JSON:")]
    return json.loads(line[-1][len("RESULT_JSON:"):])


@pytest.fixture(scope="module")
def reference():
    return _run_reference(4, {
        f"{name}-{policy}": _fields(name, d, tol, policy)
        for name, d, tol in CASES
        for policy in POLICIES
    })


def _executed(events):
    """The ``executed`` count of each ``dist.dispatch`` span, in order."""
    return [e["executed"] for e in events
            if e["kind"] == "span_end" and e["name"] == "dist.dispatch"]


@pytest.fixture(scope="module")
def port_runs():
    """Each case's result at the default K = 4, and its dispatches'
    ``executed`` counts (the recorder changes no bit)."""
    out = {}
    for name, d, tol in CASES:
        for policy in POLICIES:
            sink = MemorySink()
            res = tdist.integrate_distributed(
                _config(name, d, tol, policy), devices=["cpu"] * 4,
                recorder=Recorder(sinks=(sink,)),
            )
            out[f"{name}-{policy}"] = res, _executed(sink.events)
    return out


@pytest.fixture(scope="module")
def port(port_runs):
    return {key: res for key, (res, _) in port_runs.items()}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name,d,tol", CASES)
def test_matches_reference_driver(reference, port_runs, name, d, tol, policy):
    ref = reference[f"{name}-{policy}"]
    got, executed = port_runs[f"{name}-{policy}"]
    exact = tint.get(name).exact(d)
    assert got.status == ref["status"] == "converged", (got.summary(), ref)
    assert abs(got.integral - exact) / abs(exact) <= 10 * tol
    assert abs(got.integral - ref["I"]) <= ref["eps"]
    assert got.iterations == ref["iters"]
    assert got.n_evals == ref["n_evals"]
    assert got.evals_per_device.tolist() == ref["evals_per_device"]
    assert [[h[0], h[3], h[5]] for h in got.history] == ref["history"]
    assert got.n_devices == 4 and len(got.history) == got.iterations
    # one read per fused dispatch, each running the reference's iterations
    assert executed == ref["executed"]
    assert got.host_syncs == len(executed) <= math.ceil(got.iterations / 4) + 1


def test_three_rank_tie_difference_is_bounded():
    """A known difference (ROADMAP, queue 3): at three ranks, f2's mirror
    regions have equal errors in exact arithmetic, and the donor's tail
    window cuts through such ties; the reference's arithmetic rounds them
    apart differently, so other regions of equal error move.  The counts
    then differ; status and iterations do not, and the integral stays
    within the reference's error."""
    fields = _fields("f2", 3, 1e-6, "ring", capacity=1 << 11, message_cap=8)
    ref = _run_reference(3, {"f2": fields})["f2"]

    # record, per round, the relative error gap between the last parent
    # whose children a donor sends and the next one; a dispatch runs on past
    # convergence, so each gap keeps its round's iteration
    survivors, gaps = [], []  # per split: errors of the survivors, sorted
    split, redistribute = tdist.classify_split_compact, tdist.redistribute

    def spy_split(st, fin, window=None):
        w = st.capacity if window is None else window
        live = st.active[:w] & ~fin
        survivors.append(torch.sort(st.err[:w][live], descending=True).values)
        return split(st, fin, window)

    def spy_round(states, ranks, *, schedule, cap, limit, it, n_rows):
        rows = [int(r) for r in n_rows]  # the counts, read on the CPU
        n_send, _ = tred.round_counts(rows, tred.round_shift(schedule, it), cap, limit)
        for r, k in enumerate(n_send):
            errs = survivors[len(survivors) - ranks.n + r]
            if 0 < k < len(errs):
                gaps.append((it, float((errs[k - 1] - errs[k]) / errs[k - 1])))
        return redistribute(states, ranks, schedule=schedule, cap=cap, limit=limit,
                            it=it, n_rows=n_rows)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdist, "classify_split_compact", spy_split)
        mp.setattr(tdist, "redistribute", spy_round)
        got = tdist.integrate_distributed(TConfig(**fields), devices=["cpu"] * 3)
    gaps = [g for it, g in gaps if it < got.iterations]
    # 8 of the 16 cuts fall between parents of exactly equal error, and
    # two more within 1e-14
    assert len(gaps) == 16
    assert sum(g == 0.0 for g in gaps) == 8 and sum(g <= 1e-14 for g in gaps) == 10
    assert got.status == ref["status"] == "converged"
    assert got.iterations == ref["iters"]
    assert abs(got.integral - ref["I"]) <= ref["eps"]
    assert abs(got.n_evals - ref["n_evals"]) <= 0.01 * ref["n_evals"]
    # the active counts agree until the population outgrows half the
    # stores, where each rank splits only its top min(n, C - n) regions, so
    # which regions sit on which rank changes the counts
    same = [a[1] == b[3] for a, b in zip(ref["history"], got.history)]
    first = same.index(False) if False in same else len(same)
    assert first >= 10
    if first < len(same):
        assert ref["history"][first - 1][1] > 3 * (1 << 11) // 2


def test_redistribution_improves_balance(reference, port):
    on = [port[f"{c[0]}-ring"].mean_imbalance() for c in CASES]
    off = [port[f"{c[0]}-off"].mean_imbalance() for c in CASES]
    assert sum(on) <= sum(off) + 0.05, (on, off)
    assert sum(on) == pytest.approx(sum(reference[f"{c[0]}-ring"]["mean_imbalance"] for c in CASES))
    assert sum(off) == pytest.approx(sum(reference[f"{c[0]}-off"]["mean_imbalance"] for c in CASES))
    assert sum(port[f"{c[0]}-ring"].moved for c in CASES) > 0
    assert sum(port[f"{c[0]}-off"].moved for c in CASES) == 0


def test_work_is_distributed(port):
    for key, res in port.items():
        per_dev = res.evals_per_device
        assert min(per_dev) > 0.01 * per_dev.sum() / len(per_dev), (key, per_dev)


def _same_run(got, base):
    assert (got.status, got.integral, got.error, got.iterations, got.n_evals) == (
        base.status, base.integral, base.error, base.iterations, base.n_evals
    )
    assert got.history == base.history and got.moved == base.moved
    np.testing.assert_array_equal(got.evals_per_device, base.evals_per_device)


# a max_iters that cuts every K > 1 mid-block
_CUT = 11


@pytest.fixture(scope="module")
def cut_runs():
    """The runs of :data:`CASES` 0 and 2 cut at :data:`_CUT` iterations,
    at K = 1."""
    return {
        name: tdist.integrate_distributed(
            _config(name, d, tol, "ring", sync_every=1, max_iters=_CUT),
            devices=["cpu"] * 4,
        )
        for name, d, tol in (CASES[0], CASES[2])
    }


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("name,d,tol", [CASES[0], CASES[2]])
def test_results_do_not_depend_on_sync_every(port, cut_runs, monkeypatch, name, d, tol, k):
    """No snapshot lands before a dispatch's read, as when the card lags:
    every dispatch runs its K iterations, and those past the stop are
    discarded."""
    monkeypatch.setattr(tad, "_landed", lambda event: False)
    got = tdist.integrate_distributed(
        _config(name, d, tol, "ring", sync_every=k), devices=["cpu"] * 4
    )
    _same_run(got, port[f"{name}-ring"])
    assert got.host_syncs == math.ceil(got.iterations / k)
    assert got.discarded == got.host_syncs * k - got.iterations
    if k == 1:
        assert got.eval_rows == got.eval_rows_exact
    cut = tdist.integrate_distributed(
        _config(name, d, tol, "ring", sync_every=k, max_iters=_CUT), devices=["cpu"] * 4
    )
    assert cut.status == "max_iters" and cut.iterations == _CUT
    _same_run(cut, cut_runs[name])
    assert cut.host_syncs == math.ceil(_CUT / k)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("name,d,tol", [CASES[0], CASES[2]])
def test_landed_stop_enqueues_nothing_after_it(port, monkeypatch, name, d, tol, k):
    """Every snapshot lands at once: the iteration after the stop is never
    begun, so nothing is discarded, at any K."""
    monkeypatch.setattr(tad, "_landed", lambda event: True)
    got = tdist.integrate_distributed(
        _config(name, d, tol, "ring", sync_every=k), devices=["cpu"] * 4
    )
    _same_run(got, port[f"{name}-ring"])
    assert got.discarded == 0
    assert got.host_syncs == math.ceil(got.iterations / k)


# stages the driver enqueues per iteration on four ranks: each rank's
# evaluate, each rank's split, the round
_STAGES = 4 + 4 + 1


@pytest.mark.parametrize(
    "late,discarded",
    [(0, 0), (1, 1), (4, 1), (8, 1), (_STAGES, 1)],
    ids=["at-once", "after-rank-0", "before-advance", "before-round", "after-next-iteration"],
)
@pytest.mark.parametrize("name,d,tol", [CASES[0], CASES[2]])
def test_abandoned_iteration_is_never_read(port, monkeypatch, name, d, tol, late, discarded):
    """The stop's snapshot lands ``late`` stages into the next iteration
    (none landing before): that iteration is abandoned at the next check,
    nothing more is enqueued, and it counts as discarded once begun.  Every
    state is poisoned with NaN from the stop on; the result does not move,
    so nothing of an abandoned or discarded iteration is read."""
    base = port[f"{name}-ring"]
    stop_it = base.iterations - 1
    k = next(k for k in (8, 7, 6, 5) if stop_it % k != k - 1)  # stop and next in one dispatch
    log = []
    landed_after = _STAGES * (stop_it + 1) + late
    monkeypatch.setattr(tad, "_landed", lambda event: len(log) >= landed_after)

    def poison(st):
        for field in ("centers", "halfw", "est", "err", "fin_integral", "fin_error"):
            getattr(st, field).fill_(float("nan"))

    make_eval_step, split, redistribute = (
        tdist.make_eval_step, tdist.classify_split_compact, tdist.redistribute)

    def spy_eval(cfg, rule, window=None):
        step = make_eval_step(cfg, rule, window=window)

        def run(st):
            if len(log) >= _STAGES * (stop_it + 1):
                poison(st)
            log.append("eval")
            return step(st)
        return run

    def spy_split(st, fin, window=None):
        log.append("split")
        return split(st, fin, window)

    def spy_round(*args, **kwargs):
        log.append("round")
        return redistribute(*args, **kwargs)

    monkeypatch.setattr(tdist, "make_eval_step", spy_eval)
    monkeypatch.setattr(tdist, "classify_split_compact", spy_split)
    monkeypatch.setattr(tdist, "redistribute", spy_round)
    got = tdist.integrate_distributed(
        _config(name, d, tol, "ring", sync_every=k), devices=["cpu"] * 4
    )
    _same_run(got, base)
    assert got.discarded == discarded
    assert len(log) == landed_after


@pytest.mark.parametrize("name,d,tol", [CASES[0], CASES[2]])
def test_grown_windows_give_the_same_bits(port, monkeypatch, name, d, tol):
    """No count copy lands inside a dispatch, as when the host runs ahead of
    the card: every window is sized from the bound grown since the
    dispatch's start."""
    monkeypatch.setattr(tad, "_landed", lambda event: False)
    got = tdist.integrate_distributed(
        _config(name, d, tol, "ring", sync_every=7), devices=["cpu"] * 4
    )
    _same_run(got, port[f"{name}-ring"])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name,d,tol", [CASES[0], CASES[2]])
def test_grown_bounds_cover_the_counts(monkeypatch, name, d, tol, policy):
    """With no count copy landing, every rank's grown bound covers its live
    count at every iteration run; with rounds it is tighter than doubling
    plus a full message a rank an iteration."""
    monkeypatch.setattr(tad, "_landed", lambda event: False)
    seen = []
    iterate = tdist._iterate

    def spy(cfg, rule, ranks, states, counts, bounds, it, **kw):
        seen.append((it, list(bounds), [int(c) for c in counts]))
        return iterate(cfg, rule, ranks, states, counts, bounds, it, **kw)

    monkeypatch.setattr(tdist, "_iterate", spy)
    k = 7
    cfg = _config(name, d, tol, policy, sync_every=k)
    got = tdist.integrate_distributed(cfg, devices=["cpu"] * 4)
    assert got.status == "converged" and len(seen) == got.iterations + got.discarded
    loose = tight = 0
    for it, bounds, counts in seen:
        assert all(c <= b <= cfg.capacity for b, c in zip(bounds, counts)), (it, bounds, counts)
        if it % k:  # a grown bound: compare it with doubling plus a message
            prev = next(b for i, b, _ in seen if i == it - 1)
            cap = cfg.message_cap if policy == "ring" else 0
            loose += sum(min(2 * b + cap, cfg.capacity) for b in prev)
            tight += sum(bounds)
    assert tight < loose if policy == "ring" else tight == loose
    assert got.eval_rows > got.eval_rows_exact


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("policy", POLICIES)
def test_grow_bounds_cover_every_round(seed, policy):
    """For counts under their bounds, split to at most twice each, the
    counts after any round of the schedule are under ``grow_bounds``;
    one rank starts empty, so it receives more than twice its bound."""
    rng = np.random.default_rng(seed)
    n = 3 + seed % 4
    cfg = _config("f4", 4, 1e-6, policy, message_cap=int(rng.integers(1, 600)))
    C = cfg.capacity
    bounds = [int(b) for b in rng.integers(0, C // 2, n)]
    bounds[seed % n] = 0
    post = [int(rng.integers(min(b, C), min(2 * b, C) + 1)) for b in bounds]
    grown = tdist.grow_bounds(bounds, cfg)
    schedule = tred.make_schedule(n)
    for it in range(len(schedule)):
        after = post
        if policy == "ring":
            n_send, n_recv = tred.round_counts(
                post, tred.round_shift(schedule, it), cfg.message_cap, tdist._round_limit(C))
            after = [p - s + r for p, s, r in zip(post, n_send, n_recv)]
        assert all(a <= g <= C for a, g in zip(after, grown)), (it, post, after, grown)
    if policy == "ring":
        assert max(a - 2 * b for a, b in zip(after, bounds)) > 0


def test_no_host_read_inside_a_dispatch(monkeypatch):
    """Inside an iteration nothing reads a tensor's value: no item, no
    conversion to a Python number or truth value, no nonzero or boolean
    mask; the one read of each dispatch is a tolist of its snapshots."""
    inside, reads = [], []

    def refuse(name, orig):
        def method(self, *args, **kwargs):
            assert not inside, f"host read inside an iteration: {name}"
            return orig(self, *args, **kwargs)
        return method

    for name in ("item", "__bool__", "__int__", "__float__", "__index__", "nonzero",
                 "numpy", "cpu", "masked_select"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch, "nonzero", refuse("torch.nonzero", torch.nonzero))

    def no_mask(name, orig):
        def method(self, idx, *args):
            for i in idx if isinstance(idx, tuple) else (idx,):
                assert not (isinstance(i, torch.Tensor) and i.dtype == torch.bool), name
            return orig(self, idx, *args)
        return method

    for name in ("__getitem__", "__setitem__"):
        monkeypatch.setattr(torch.Tensor, name, no_mask(name, getattr(torch.Tensor, name)))
    tolist = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist", lambda self: reads.append(1) or tolist(self))
    iterate = tdist._iterate

    def counted(*args, **kwargs):
        inside.append(1)
        try:
            return iterate(*args, **kwargs)
        finally:
            inside.pop()

    monkeypatch.setattr(tdist, "_iterate", counted)
    got = tdist.integrate_distributed(_config("f6", 3, 1e-5, "ring"), devices=["cpu"] * 4)
    assert got.status == "converged" and got.moved > 0
    assert len(reads) == got.host_syncs == math.ceil(got.iterations / 4)


@pytest.mark.parametrize("n_ranks", [1, 2, 3, 4, 8])
def test_initial_partition_matches_reference(n_ranks):
    ref = jdist._stacked_initial_state(
        JConfig(d=3, integrand="f4", capacity=1 << 10), n_ranks, np.float64
    )
    states, counts = tdist._initial_states(
        TConfig(d=3, integrand="f4", capacity=1 << 10), Ranks(["cpu"] * n_ranks),
        torch.float64,
    )
    for r, st in enumerate(states):
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(st, k).numpy(), np.asarray(getattr(ref, k))[r])
        assert counts[r] == int(st.active.sum())


def test_without_devices_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TConfig(d=2, capacity=1 << 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.integrate_distributed(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist.integrate_distributed(cfg, devices=["cuda"] * 2)


def test_selftest_runs_on_cpu_ranks():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.dist_selftest", "4", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.splitlines()[-1][len("RESULT_JSON:"):])
    assert out["n_devices"] == 4 and len(out["cases"]) == len(CASES)
    for case in out["cases"]:
        assert case["dist"]["status"] == case["single"]["status"] == "converged"
        rel = abs(case["dist"]["I"] - case["single"]["I"]) / abs(case["exact"])
        assert rel <= 4 * case["rel_tol"], case


@pytest.mark.parametrize(
    "args",
    [
        ["--devices", "4", "--integrand", "f6", "--d", "3", "--rel-tol", "1e-4"],
        ["--devices", "4", "--integrand", "f6", "--d", "3", "--rel-tol", "1e-4",
         "--sync-every", "1"],
        ["--device-loop", "--integrand", "f4", "--d", "3", "--rel-tol", "1e-6"],
        ["--rule", "gauss_kronrod", "--integrand", "f4", "--d", "2", "--rel-tol", "1e-8"],
    ],
    ids=["devices", "devices-sync-every-1", "device-loop", "gauss-kronrod"],
)
def test_cli_paths_on_cpu(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.integrate", *args,
         "--capacity", "8192", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert "[converged]" in lines[0]
    if "--devices" in args:
        assert lines[1].startswith("devices=4 mean_imbalance=")
        # one host read per --sync-every iterations (default 4)
        k = int(args[args.index("--sync-every") + 1]) if "--sync-every" in args else 4
        iters = int(lines[0].split("iters=")[1].split()[0])
        assert int(lines[1].split("host_syncs=")[1]) == math.ceil(iters / k)
    assert lines[-1].startswith("exact=")
    assert float(lines[-1].split("true_rel_err=")[1]) <= 5 * float(args[args.index("--rel-tol") + 1])
