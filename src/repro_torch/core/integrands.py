"""Benchmark integrands (the paper's f1-f7), parameterized families and exacts.

Integrands use the SoA convention: ``f(x)`` receives coordinates of shape
``(d, N)`` and returns values of shape ``(N,)``.

Every registry entry carries a ``kernel_id``: the integer that names its
device function in ``kernels/csrc/integrands.cuh``.  The CUDA kernel cannot
inline a Python callable, so only entries with a kernel id run on the card.
The torch functions here are the plain versions of those device functions:
each reduction over the ``d`` axes is a left-to-right loop
(:func:`~repro_torch.core.genz_malik.row_sum`), in the order the device
functions add and multiply.

Exact values are analytic over [0, 1]^d.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.genz_malik import row_prod, row_sum


@dataclasses.dataclass(frozen=True)
class Integrand:
    name: str
    fn: Callable[[torch.Tensor], torch.Tensor]  # (d, N) -> (N,)
    exact: Callable[[int], float]  # exact integral over [0,1]^d
    description: str = ""
    smooth: bool = True
    kernel_id: Optional[int] = None  # device function id; None = torch only


@dataclasses.dataclass(frozen=True)
class ParamIntegrand:
    """A family of integrands ``f(x; theta)`` sharing one domain.

    ``fn`` takes the SoA coordinates ``(d, N)`` plus a dict of per-axis
    coefficient leaves (see ``theta_fields``).  ``exact(d, theta)`` is the
    analytic reference, ``sample_theta(d, rng)`` draws a problem instance
    from a numpy generator.
    """

    name: str
    fn: Callable[[torch.Tensor, Any], torch.Tensor]  # ((d, N), theta) -> (N,)
    exact: Callable[[int, Any], float]
    sample_theta: Callable[[int, np.random.Generator], dict]
    theta_fields: tuple[str, ...]  # positional order for spec strings
    description: str = ""
    kernel_id: Optional[int] = None
    # theta value from which the GM evaluate makes a lane's results NaN
    # (repro_torch.service.faults.nan_family); None = never
    nan_sentinel: Optional[float] = None


def _axis_coeff(x: torch.Tensor, start: int = 1) -> torch.Tensor:
    """Per-axis coefficient ``start + axis`` as a ``(d, 1)`` column."""
    return torch.arange(x.shape[0], dtype=x.dtype, device=x.device)[:, None] + float(
        start
    )


# --- f1: oscillatory ---------------------------------------------------------


def f1(x: torch.Tensor) -> torch.Tensor:
    i = _axis_coeff(x)
    return torch.cos(row_sum(i * x))


def f1_exact(d: int) -> float:
    # cos(sum i x_i) = Re prod_k exp(i k x_k); each 1-D factor integrates to
    # (exp(i k) - 1) / (i k).
    p = complex(1.0, 0.0)
    for k in range(1, d + 1):
        p *= (np.exp(1j * k) - 1.0) / (1j * k)
    return float(p.real)


# --- f2: product peak --------------------------------------------------------

_F2_B2 = 50.0**-2


def f2(x: torch.Tensor) -> torch.Tensor:
    t = x - 0.5
    return row_prod(1.0 / (_F2_B2 + t * t))


def f2_exact(d: int) -> float:
    b = 0.02
    one_dim = (2.0 / b) * math.atan(0.5 / b)
    return float(one_dim**d)


# --- f3: corner peak ---------------------------------------------------------


def f3(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[0]
    i = _axis_coeff(x)
    base = 1.0 + row_sum(i * x)
    # a full exponent tensor keeps torch on its general pow (no special case
    # for small integer exponents), as the device function calls pow()
    return torch.pow(base, torch.full_like(base, -(d + 1.0)))


def f3_exact(d: int) -> float:
    # Inclusion-exclusion (Genz): 1/(d! prod c_i) sum_{v in {0,1}^d}
    #   (-1)^|v| / (1 + c . v),   c_i = i.
    c = list(range(1, d + 1))
    total = 0.0
    for mask in range(2**d):
        s = 1.0
        bits = 0
        for i in range(d):
            if (mask >> i) & 1:
                s += c[i]
                bits += 1
        total += (-1.0) ** bits / s
    return float(total / (math.factorial(d) * math.prod(c)))


# --- f4: Gaussian ------------------------------------------------------------


def f4(x: torch.Tensor) -> torch.Tensor:
    t = x - 0.5
    return torch.exp(-(25.0**2) * row_sum(t * t))


def f4_exact(d: int) -> float:
    one_dim = math.sqrt(math.pi) / 25.0 * math.erf(12.5)
    return float(one_dim**d)


# --- f5: C0 (kink) -----------------------------------------------------------


def f5(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-10.0 * row_sum(torch.abs(x - 0.5)))


def f5_exact(d: int) -> float:
    one_dim = 0.2 * (1.0 - math.exp(-5.0))
    return float(one_dim**d)


# --- f6: discontinuous -------------------------------------------------------


def f6(x: torch.Tensor) -> torch.Tensor:
    i = _axis_coeff(x)  # 1-based axis index
    cut = (3.0 + i) / 10.0
    inside = torch.all(x <= cut, dim=0)
    val = torch.exp(row_sum((i + 4.0) * x))
    return torch.where(inside, val, torch.zeros_like(val))


def f6_exact(d: int) -> float:
    p = 1.0
    for i in range(1, d + 1):
        c = i + 4.0
        u = min(1.0, (3.0 + i) / 10.0)
        p *= (math.exp(c * u) - 1.0) / c
    return float(p)


# --- f7: polynomial ridge ----------------------------------------------------

_F7_POW = 11


def _pow11(s: torch.Tensor) -> torch.Tensor:
    """s**11 as the square-and-multiply chain XLA's integer_pow emits."""
    s2 = s * s
    s3 = s * s2
    s4 = s2 * s2
    s8 = s4 * s4
    return s3 * s8


def f7(x: torch.Tensor) -> torch.Tensor:
    return _pow11(row_sum(x * x))


@lru_cache(maxsize=None)
def _f7_dp(j: int, p: int) -> float:
    # F(j, p) = sum_{|k| = p over j dims} p!/prod(k!) prod E[x^{2 k_i}],
    # with E[x^{2k}] = 1/(2k+1) on [0,1].
    if j == 0:
        return 1.0 if p == 0 else 0.0
    total = 0.0
    for k in range(p + 1):
        total += math.comb(p, k) * (1.0 / (2 * k + 1)) * _f7_dp(j - 1, p - k)
    return total


def f7_exact(d: int) -> float:
    return float(_f7_dp(d, _F7_POW))


# --- parameterized families (Genz + monomial) --------------------------------


def _col(theta_leaf, x: torch.Tensor) -> torch.Tensor:
    """Theta leaf (d,) -> column (d, 1) in the coordinate dtype and device.

    Leaves that already carry a lane axis, ``(d, 1)`` or ``(d, N)``, pass
    through (the plain kernel version feeds theta as ``(d, N)`` rows), and
    so do ``(d, P, 1)`` leaves against ``(d, P, N)`` coordinates (the VEGAS
    pool's P problems, one theta each).  Any other length raises: a theta of
    the wrong length would otherwise broadcast in the integrand while
    ``exact`` truncates to d.
    """
    arr = torch.as_tensor(theta_leaf, dtype=x.dtype, device=x.device)
    if arr.ndim == 2 and arr.shape[0] == x.shape[0] and arr.shape[1] in (1, x.shape[1]):
        return arr
    if arr.ndim == 3 == x.ndim and arr.shape[:2] == x.shape[:2] and arr.shape[2] == 1:
        return arr
    if tuple(arr.shape) != (x.shape[0],):
        raise ValueError(
            f"theta leaf has shape {tuple(arr.shape)}, expected ({x.shape[0]},) "
            f"(or a broadcast ({x.shape[0]}, N)) for a d={x.shape[0]} problem"
        )
    return arr[:, None]


def _genz_gaussian_fn(x: torch.Tensor, theta) -> torch.Tensor:
    t = _col(theta["a"], x) * (x - _col(theta["u"], x))
    return torch.exp(-row_sum(t * t))


def _genz_gaussian_exact(d: int, theta) -> float:
    a = np.asarray(theta["a"], np.float64)
    u = np.asarray(theta["u"], np.float64)
    p = 1.0
    for ai, ui in zip(a[:d], u[:d]):
        p *= (
            math.sqrt(math.pi)
            / (2.0 * ai)
            * (math.erf(ai * (1.0 - ui)) + math.erf(ai * ui))
        )
    return float(p)


def _genz_gaussian_sample(d: int, rng: np.random.Generator) -> dict:
    return {"a": rng.uniform(3.0, 10.0, d), "u": rng.uniform(0.2, 0.8, d)}


def _genz_product_peak_fn(x: torch.Tensor, theta) -> torch.Tensor:
    a = _col(theta["a"], x)
    t = x - _col(theta["u"], x)
    return row_prod(1.0 / (1.0 / (a * a) + t * t))


def _genz_product_peak_exact(d: int, theta) -> float:
    a = np.asarray(theta["a"], np.float64)
    u = np.asarray(theta["u"], np.float64)
    p = 1.0
    for ai, ui in zip(a[:d], u[:d]):
        p *= ai * (math.atan(ai * (1.0 - ui)) + math.atan(ai * ui))
    return float(p)


def _genz_product_peak_sample(d: int, rng: np.random.Generator) -> dict:
    return {"a": rng.uniform(3.0, 10.0, d), "u": rng.uniform(0.2, 0.8, d)}


def _monomial_fn(x: torch.Tensor, theta) -> torch.Tensor:
    return row_prod(torch.pow(x, _col(theta["p"], x)))


def _monomial_exact(d: int, theta) -> float:
    p = np.asarray(theta["p"], np.float64)
    return float(np.prod(1.0 / (p[:d] + 1.0)))


def _monomial_sample(d: int, rng: np.random.Generator) -> dict:
    return {"p": rng.integers(0, 5, d).astype(np.float64)}


PARAM_REGISTRY: dict[str, ParamIntegrand] = {
    "genz_gaussian": ParamIntegrand(
        "genz_gaussian",
        _genz_gaussian_fn,
        _genz_gaussian_exact,
        _genz_gaussian_sample,
        ("a", "u"),
        "exp(-sum a_i^2 (x_i - u_i)^2)",
        kernel_id=7,
    ),
    "genz_product_peak": ParamIntegrand(
        "genz_product_peak",
        _genz_product_peak_fn,
        _genz_product_peak_exact,
        _genz_product_peak_sample,
        ("a", "u"),
        "prod 1 / (a_i^-2 + (x_i - u_i)^2)",
        kernel_id=8,
    ),
    "monomial": ParamIntegrand(
        "monomial",
        _monomial_fn,
        _monomial_exact,
        _monomial_sample,
        ("p",),
        "prod x_i^{p_i}",
        kernel_id=9,
    ),
}


def get_param(name: str) -> ParamIntegrand:
    try:
        return PARAM_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown integrand family {name!r}; known: {sorted(PARAM_REGISTRY)}"
        ) from None


def bind(family: ParamIntegrand, theta) -> Integrand:
    """Freeze one theta into a plain :class:`Integrand` (torch only).

    The bound function closes over theta, so it has no kernel id; the
    drivers route family specs to the kernel as (family, theta) instead
    (see ``core.rules.make_rule``).
    """
    label = ",".join(
        np.array2string(np.asarray(theta[k]), precision=3, separator=",")
        for k in family.theta_fields
    )

    def exact(d: int) -> float:
        for k in family.theta_fields:
            n = np.asarray(theta[k]).shape[0]
            if n != d:
                raise ValueError(
                    f"{family.name}: theta field {k!r} has length {n} "
                    f"but the problem is d={d}"
                )
        return family.exact(d, theta)

    return Integrand(
        name=f"{family.name}:{label}",
        fn=lambda x: family.fn(x, theta),
        exact=exact,
        description=family.description,
    )


def parse_spec(spec: str) -> tuple[ParamIntegrand, dict]:
    """Parse ``family:v,v,..[:v,v,..]`` into ``(family, theta)``.

    One colon-separated group of comma-separated floats per theta field, in
    ``theta_fields`` order: ``genz_gaussian:5,5:0.3,0.7`` is the d=2
    Gaussian with a=(5,5), u=(0.3,0.7); ``monomial:2,0,3`` is x^2 z^3.
    """
    family_name, _, rest = spec.partition(":")
    family = get_param(family_name)
    if not rest:
        raise ValueError(
            f"family {family_name!r} needs theta groups "
            f"{family.theta_fields} — e.g. {family_name!r} + ':' + "
            "one comma-separated float list per field"
        )
    groups = rest.split(":")
    if len(groups) != len(family.theta_fields):
        raise ValueError(
            f"{spec!r}: expected {len(family.theta_fields)} theta group(s) "
            f"{family.theta_fields}, got {len(groups)}"
        )
    try:
        theta = {
            k: np.asarray([float(v) for v in g.split(",")], np.float64)
            for k, g in zip(family.theta_fields, groups)
        }
    except ValueError:
        raise ValueError(f"{spec!r}: theta groups must be comma-separated floats")
    sizes = {v.shape[0] for v in theta.values()}
    if len(sizes) != 1:
        raise ValueError(f"{spec!r}: theta groups must have equal length, got {sizes}")
    return family, theta


def to_spec(family: ParamIntegrand, theta) -> str:
    """The spec string of ``(family, theta)``, inverse of :func:`parse_spec`
    bit for bit (each float is written as its ``repr``)."""
    groups = (
        ",".join(repr(float(v)) for v in np.asarray(theta[k], np.float64).reshape(-1))
        for k in family.theta_fields
    )
    return ":".join([family.name, *groups])


def from_spec(spec: str) -> Integrand:
    """Bind a family spec string (see :func:`parse_spec`) into an Integrand."""
    family, theta = parse_spec(spec)
    return bind(family, theta)


REGISTRY: dict[str, Integrand] = {
    "f1": Integrand("f1", f1, f1_exact, "oscillatory cos(sum i x_i)", kernel_id=0),
    "f2": Integrand("f2", f2, f2_exact, "product peak at x=1/2", kernel_id=1),
    "f3": Integrand("f3", f3, f3_exact, "corner peak", kernel_id=2),
    "f4": Integrand("f4", f4, f4_exact, "sharp isotropic Gaussian", kernel_id=3),
    "f5": Integrand("f5", f5, f5_exact, "C0 kink at x=1/2", smooth=False, kernel_id=4),
    "f6": Integrand(
        "f6", f6, f6_exact, "discontinuous exponential", smooth=False, kernel_id=5
    ),
    "f7": Integrand("f7", f7, f7_exact, "(sum x^2)^11 polynomial ridge", kernel_id=6),
}


def get(name: str) -> Integrand:
    """Resolve an integrand name: fixed registry entry or family spec string."""
    if name in REGISTRY:
        return REGISTRY[name]
    if ":" in name:
        return from_spec(name)
    raise KeyError(
        f"unknown integrand {name!r}; known: {sorted(REGISTRY)} plus "
        f"family specs {sorted(PARAM_REGISTRY)} (e.g. 'genz_gaussian:5,5:0.3,0.7')"
    )
