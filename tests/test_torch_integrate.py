"""End to end: the port's integrate() on the CPU vs the JAX package's, and
the port's CLI."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from repro.core import adaptive as jad
from repro.core import integrands as jint
from repro.core.config import QuadratureConfig as JConfig
from repro_torch.core import adaptive as tad
from repro_torch.core import region_store as trs
from repro_torch.core.config import QuadratureConfig as TConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [
    # (integrand, d, rel_tol, capacity, classifier)
    ("f4", 3, 1e-6, 1 << 12, "robust"),
    ("f1", 3, 1e-6, 1 << 13, "robust"),
    ("f6", 3, 1e-4, 1 << 13, "robust"),
    ("f2", 3, 1e-6, 1 << 13, "aggressive"),
    ("genz_gaussian:6,4:0.3,0.7", 2, 1e-6, 1 << 13, "robust"),
]


def port_config(cfg: JConfig) -> TConfig:
    fields = dataclasses.asdict(cfg)
    fields.pop("use_kernel")
    fields.pop("interpret")
    return TConfig(**fields)


@pytest.mark.parametrize("name,d,rel_tol,capacity,classifier", CASES)
def test_integrate_matches_reference(name, d, rel_tol, capacity, classifier):
    jc = JConfig(d=d, integrand=name, rel_tol=rel_tol, capacity=capacity,
                 classifier=classifier)
    ref = jad.integrate(jc)
    got = tad.integrate(port_config(jc), device="cpu")
    exact = jint.get(name).exact(d)
    assert got.status == ref.status == "converged", (got.summary(), ref.summary())
    assert abs(got.integral - ref.integral) <= ref.error
    assert abs(got.integral - exact) / abs(exact) <= 5 * rel_tol
    assert got.iterations == ref.iterations
    assert got.n_evals == ref.n_evals
    assert got.n_active == ref.n_active
    assert got.overflowed == ref.overflowed


def test_callback_once_per_evaluate_step():
    calls = []
    cfg = TConfig(d=2, integrand="f4", rel_tol=1e-6, capacity=1 << 10)
    res = tad.integrate(cfg, callback=lambda *a: calls.append(a), device="cpu")
    assert res.status == "converged"
    assert len(calls) == res.iterations + 1
    assert [c[0] for c in calls] == list(range(res.iterations + 1))
    assert calls[-1][1] == res.integral and calls[-1][2] == res.error


def test_capacity_pressure_matches_reference():
    jc = JConfig(d=5, integrand="f2", rel_tol=1e-9, capacity=256, n_init=8, max_iters=30)
    ref = jad.integrate(jc)
    got = tad.integrate(port_config(jc), device="cpu")
    assert got.overflowed and ref.overflowed
    assert (got.status, got.iterations, got.n_evals) == (ref.status, ref.iterations, ref.n_evals)


def test_state_invariants_after_steps():
    cfg = TConfig(d=3, integrand="f4", rel_tol=1e-5, capacity=1 << 12).validate()
    cfg, lo, hi, total_volume, rule, state = tad._setup(cfg, None, torch.device("cpu"))
    ev = tad.make_eval_step(cfg, rule)
    adv = tad.make_advance_step(cfg, total_volume, hi - lo)
    for _ in range(8):
        state = adv(ev(state))
    trs.check_invariants(state, lo, hi)
    assert int(state.it) == 8


def test_cli_cpu_smoke():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.integrate", "--integrand", "f4",
         "--d", "3", "--rel-tol", "1e-6", "--capacity", "4096", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert "[converged]" in lines[0]
    assert lines[1].startswith("exact=")
    assert float(lines[1].split("true_rel_err=")[1]) <= 5e-6
