"""The port's multi-rank driver on four CPU ranks against the JAX driver.

The reference runs in a subprocess with four forced host devices (the
suite's own process has already initialised JAX with one), on the cases of
``repro.core.dist_selftest``, with and without redistribution.  The port
runs the same cases on ``["cpu"] * 4`` ranks from this process.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core.config import QuadratureConfig as JConfig
from repro_torch.core import distributed as tdist
from repro_torch.core import integrands as tint
from repro_torch.core import redistribution as tred
from repro_torch.core.config import QuadratureConfig as TConfig
from repro_torch.core.ranks import Ranks
from repro_torch.core.region_store import FIELDS

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
assert len(jax.devices()) == int(sys.argv[1])
out = {}
for key, kw in json.loads(sys.argv[2]).items():
    r = integrate_distributed(QuadratureConfig(**kw))
    out[key] = dict(
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


@pytest.fixture(scope="module")
def port():
    return {
        f"{name}-{policy}": tdist.integrate_distributed(
            _config(name, d, tol, policy), devices=["cpu"] * 4
        )
        for name, d, tol in CASES
        for policy in POLICIES
    }


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name,d,tol", CASES)
def test_matches_reference_driver(reference, port, name, d, tol, policy):
    ref, got = reference[f"{name}-{policy}"], port[f"{name}-{policy}"]
    exact = tint.get(name).exact(d)
    assert got.status == ref["status"] == "converged", (got.summary(), ref)
    assert abs(got.integral - exact) / abs(exact) <= 10 * tol
    assert abs(got.integral - ref["I"]) <= ref["eps"]
    assert got.iterations == ref["iters"]
    assert got.n_evals == ref["n_evals"]
    assert got.evals_per_device.tolist() == ref["evals_per_device"]
    assert [[h[0], h[3], h[5]] for h in got.history] == ref["history"]
    assert got.n_devices == 4 and len(got.history) == got.iterations
    # one stacked read per iteration, and one at the end
    assert got.host_syncs == got.iterations + 1


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
    # whose children a donor sends and the next one
    survivors, gaps = [], []  # per split: errors of the survivors, sorted
    split, redistribute = tdist.classify_split_compact, tdist.redistribute

    def spy_split(st, fin, window=None):
        w = st.capacity if window is None else window
        live = st.active[:w] & ~fin
        survivors.append(torch.sort(st.err[:w][live], descending=True).values)
        return split(st, fin, window)

    def spy_round(states, ranks, *, schedule, cap, limit, it, n_rows):
        n_send, _ = tred.round_counts(n_rows, tred.round_shift(schedule, it), cap, limit)
        for r, k in enumerate(n_send):
            errs = survivors[len(survivors) - ranks.n + r]
            if 0 < k < len(errs):
                gaps.append(float((errs[k - 1] - errs[k]) / errs[k - 1]))
        return redistribute(states, ranks, schedule=schedule, cap=cap, limit=limit,
                            it=it, n_rows=n_rows)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdist, "classify_split_compact", spy_split)
        mp.setattr(tdist, "redistribute", spy_round)
        got = tdist.integrate_distributed(TConfig(**fields), devices=["cpu"] * 3)
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


@pytest.mark.parametrize("name,d,tol", [CASES[0], CASES[2]])
def test_results_do_not_depend_on_sync_every(port, name, d, tol):
    base = port[f"{name}-ring"]
    for k in (1, 4):
        got = tdist.integrate_distributed(
            _config(name, d, tol, "ring", sync_every=k), devices=["cpu"] * 4
        )
        assert (got.integral, got.error, got.iterations, got.n_evals) == (
            base.integral, base.error, base.iterations, base.n_evals
        )
        assert got.history == base.history
        np.testing.assert_array_equal(got.evals_per_device, base.evals_per_device)


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
        ["--device-loop", "--integrand", "f4", "--d", "3", "--rel-tol", "1e-6"],
        ["--rule", "gauss_kronrod", "--integrand", "f4", "--d", "2", "--rel-tol", "1e-8"],
    ],
    ids=["devices", "device-loop", "gauss-kronrod"],
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
    assert lines[-1].startswith("exact=")
    assert float(lines[-1].split("true_rel_err=")[1]) <= 5 * float(args[args.index("--rel-tol") + 1])
