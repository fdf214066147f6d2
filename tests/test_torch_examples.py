"""The port's three quadrature examples, run in process on the CPU.

``examples/torch_{quickstart,distributed_quadrature,batch_service}.py``
are the JAX examples' programs on ``repro_torch``; each ``main(device=
"cpu")`` finishes in seconds.  Each result is held to its bar: the true
relative error within 5 rel_tol on one device, 10 rel_tol over ranks, and
the service's 10 max(error, budget).
"""

import os
import runpy

import pytest

_EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _main(name):
    return runpy.run_path(os.path.join(_EXAMPLES, name))["main"]


def test_quickstart(capsys):
    out = _main("torch_quickstart.py")(device="cpu")
    for case in ("f4", "banana"):
        assert out[case]["result"].status == "converged"
        assert out[case]["true_rel_err"] <= 5 * out[case]["rel_tol"], case
    assert "custom banana, d=2" in capsys.readouterr().out


def test_banana_reference_value():
    exact = runpy.run_path(os.path.join(_EXAMPLES, "torch_quickstart.py"))["banana_exact"]()
    assert exact == pytest.approx(0.4287206694209, abs=1e-12)


def test_distributed_quadrature(capsys):
    out = _main("torch_distributed_quadrature.py")(device="cpu")
    for redis in ("ring", "off"):
        res = out[redis]["result"]
        assert res.status == "converged" and res.n_devices == 8
        assert out[redis]["true_rel_err"] <= 10 * out[redis]["rel_tol"]
    assert out["ring"]["mean_imbalance"] < out["off"]["mean_imbalance"]
    assert "redistribution=off" in capsys.readouterr().out


def test_batch_service(capsys):
    out = _main("torch_batch_service.py")(device="cpu")
    assert len(out["batch"]) == len(out["served"]) == 24
    assert all(r.status == "converged" for r in out["batch"] + out["served"])
    assert out["worst_vs_bar"] <= 10
    for a, b in zip(out["batch"], out["served"]):
        assert (a.integral, a.n_evals) == (b.integral, b.n_evals)
    assert "integrate_batch: 24 problems" in capsys.readouterr().out
