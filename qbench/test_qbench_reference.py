"""The reference's exact values against quadrature of the closed forms."""

import math

import numpy as np
import pytest

from qbench import reference


def _gauss_legendre(f, n=200):
    x, w = np.polynomial.legendre.leggauss(n)
    t = 0.5 * (x + 1.0)
    return float(np.sum(0.5 * w * f(t)))


@pytest.mark.parametrize("a,u", [([25.0] * 8, [0.5] * 8), ([5.0] * 8, [0.5] * 8),
                                 ([3.0, 10.0, 7.5], [0.2, 0.8, 0.41])])
def test_genz_gaussian_against_a_product_of_1d_quadratures(a, u):
    want = math.prod(_gauss_legendre(lambda t, ai=ai, ui=ui: np.exp(-(ai * (t - ui)) ** 2))
                     for ai, ui in zip(a, u))
    got = reference.exact("genz_gaussian", len(a), {"a": a, "u": u})
    assert got == pytest.approx(want, rel=1e-13)


def test_theta_of_the_wrong_length_is_refused():
    with pytest.raises(ValueError):
        reference.exact("genz_gaussian", 3, {"a": [1.0, 2.0], "u": [0.5, 0.5]})


def test_reference_agrees_with_the_ports_own_exact_values():
    from repro_torch.core.integrands import PARAM_REGISTRY, f4_exact

    theta = {"a": [25.0] * 8, "u": [0.5] * 8}
    port = PARAM_REGISTRY["genz_gaussian"].exact(8, {k: np.asarray(v) for k, v in theta.items()})
    assert reference.exact("genz_gaussian", 8, theta) == pytest.approx(port, rel=1e-15)
    assert reference.exact("genz_gaussian", 8, theta) == pytest.approx(f4_exact(8), rel=1e-14)


def test_judge_numbers():
    ok = dict(status="converged", integral=1.0 + 1e-9, exact=1.0, rel_tol=1e-6)
    cap = dict(status="capacity", integral=1.1, exact=1.0, rel_tol=1e-6)
    limits = {"failed_share": 0.5, "worst_err_over_tol": 1}
    got = reference.judge([ok, cap], limits)
    assert got["failed_share"]["value"] == 0.5
    assert got["worst_err_over_tol"]["value"] == pytest.approx(1e-3)  # capacity left out
    assert reference.passes(got)
    assert not reference.passes(reference.judge([ok, cap], dict(limits, failed_share=0.0)))
    far = dict(ok, integral=1.01)
    assert reference.judge([far], limits)["worst_err_over_tol"]["value"] == pytest.approx(1e4)
    assert not reference.passes(reference.judge([], limits))
    nan = reference.judge([dict(ok, integral=float("nan"))], limits)
    assert nan["worst_err_over_tol"]["value"] == math.inf
