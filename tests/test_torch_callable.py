"""User integrands on the GM rule's torch route.

A torch callable has no ``kernel_id``, so ``GenzMalikRule`` evaluates it
with ``core/genz_malik.py::gm_eval_reference`` (route ``"torch"``) on any
device; the JAX package evaluates it with its own ``gm_eval_reference``
(``use_kernel=False``).  The two runs give the same status, iterations and
evaluations, the integral within rtol 1e-12 and the error within
1e-12 * |I|.  The route is chosen by the integrand's type alone: a registry
integrand still goes to ``kernels/ops.py``, which refuses a callable on
the card.
"""

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import QuadratureConfig as JConfig, integrate as jintegrate  # noqa: E402
from repro_torch.core import rules  # noqa: E402
from repro_torch.core.adaptive import integrate, integrate_device  # noqa: E402
from repro_torch.core.config import QuadratureConfig  # noqa: E402
from repro_torch.core.distributed import integrate_distributed  # noqa: E402
from repro_torch.core.integrands import REGISTRY  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.telemetry import MemorySink, Recorder  # noqa: E402


def banana_j(x):
    return jnp.exp(-5.0 * (x[1] - x[0] ** 2) ** 2 - (1.0 - x[0]) ** 2)


def banana_t(x):
    return torch.exp(-5.0 * (x[1] - x[0] ** 2) ** 2 - (1.0 - x[0]) ** 2)


def f4_j(x):
    return jnp.exp(-625.0 * jnp.sum((x - 0.5) ** 2, axis=0))


def f4_t(x):
    return torch.exp(-625.0 * sum((x[k] - 0.5) ** 2 for k in range(x.shape[0])))


@pytest.mark.parametrize(
    "fj,ft,d,rel_tol",
    [(banana_j, banana_t, 2, 1e-8), (f4_j, f4_t, 3, 1e-6)],
    ids=["banana", "f4"],
)
def test_callable_matches_the_jax_plain_route(fj, ft, d, rel_tol):
    fields = dict(d=d, rel_tol=rel_tol, capacity=1 << 13)
    ref = jintegrate(JConfig(use_kernel=False, **fields), integrand=fj)
    res = integrate(QuadratureConfig(**fields), ft, device="cpu")
    assert (res.status, res.iterations, res.n_evals) == (ref.status, ref.iterations, ref.n_evals)
    assert res.status == "converged"
    np.testing.assert_allclose(res.integral, ref.integral, rtol=1e-12)
    assert abs(res.error - ref.error) <= 1e-12 * abs(ref.integral)


def test_every_driver_takes_a_callable():
    """integrate, integrate_device and integrate_distributed on a callable
    f4 take the registry f4's path."""
    cfg = QuadratureConfig(d=3, rel_tol=1e-6, capacity=1 << 12)
    for run in (
        lambda f: integrate(cfg, f, device="cpu"),
        lambda f: integrate_device(cfg, f, device="cpu"),
        lambda f: integrate_distributed(cfg, f, devices=["cpu"] * 2),
    ):
        mine, registry = run(f4_t), run(REGISTRY["f4"])
        assert (mine.status, mine.iterations, mine.n_evals) == (
            registry.status, registry.iterations, registry.n_evals)
        np.testing.assert_allclose(mine.integral, registry.integral, rtol=1e-12)


def test_route_follows_the_integrands_type():
    cfg = QuadratureConfig(d=2)
    assert rules.make_rule(cfg).route == "kernel"
    assert rules.make_rule(QuadratureConfig(d=2, integrand="genz_gaussian:5,5:0.3,0.7")).route \
        == "kernel"
    assert rules.make_rule(cfg, banana_t).route == "torch"
    assert rules.make_rule(QuadratureConfig(d=2, rule="gauss_kronrod")).route == "torch"
    with pytest.raises(ValueError, match="a callable takes none"):
        rules.make_rule(cfg, banana_t, theta={"a": np.ones(2)})
    rule = rules.make_rule(cfg, banana_t)
    c = torch.full((4, 2), 0.5, dtype=torch.float64)
    with pytest.raises(ValueError, match="no theta_cols"):
        rule.eval_batch(c, c, theta_cols=torch.ones((4, 1), dtype=torch.float64))


def test_torch_route_never_reaches_the_kernel_wrapper(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the torch route reached kernels/ops.py")

    c = torch.as_tensor(np.random.default_rng(0).uniform(0.2, 0.8, (64, 3)))
    h = torch.full((64, 3), 0.05, dtype=torch.float64)
    registry = rules.make_rule(QuadratureConfig(d=3)).eval_batch(c, h)
    monkeypatch.setattr(rules.kernel_ops, "genz_malik_eval", refuse)
    mine = rules.make_rule(QuadratureConfig(d=3), f4_t).eval_batch(c, h)
    assert all(torch.equal(a, b) for a, b in zip(mine, registry))
    with pytest.raises(AssertionError, match="torch route"):
        rules.make_rule(QuadratureConfig(d=3)).eval_batch(c, h)


class _OnCard:
    """Stands in for a (B, d) float64 CUDA tensor (this build of torch has
    none): ``ops.genz_malik_eval`` decides on the device before it reads
    any value."""

    device = torch.device("cuda")
    dtype = torch.float64
    shape = (8, 3)

    @property
    def T(self):
        return self

    def contiguous(self):
        return self


def test_kernel_wrapper_refuses_a_callable_on_the_card():
    with pytest.raises(ValueError, match="cannot inline a Python callable"):
        ops.genz_malik_eval(f4_t, _OnCard(), _OnCard())


def test_block_split_keeps_the_bits(monkeypatch):
    rng = np.random.default_rng(3)
    c = torch.as_tensor(rng.uniform(0.1, 0.9, (1000, 3)))
    h = torch.as_tensor(rng.uniform(0.01, 0.1, (1000, 3)))
    assert rules.region_block(5) == (1 << 25) // 5 and rules.region_block(1 << 26) == 1
    whole = rules.GenzMalikRule(3, f4_t).eval_batch(c, h)
    calls = []
    plain = rules.gm_eval_reference
    monkeypatch.setattr(rules, "gm_eval_reference", lambda *a: calls.append(1) or plain(*a))
    for block in (1, 7, 999, 1000, 4096):
        monkeypatch.setattr(rules, "BLOCK_ELEMS", 3 * block)
        calls.clear()
        split = rules.GenzMalikRule(3, f4_t).eval_batch(c, h)
        assert len(calls) == -(-1000 // block), block
        assert all(torch.equal(a, b) for a, b in zip(whole, split)), block


def test_route_in_the_eval_span():
    sink = MemorySink()
    integrate(QuadratureConfig(d=2, rel_tol=1e-6, capacity=1 << 9), banana_t, device="cpu",
              recorder=Recorder(sinks=(sink,)))
    ends = [e for e in sink.events if e["name"] == "core.eval" and e["kind"] == "span_end"]
    assert ends and {e["route"] for e in ends} == {"torch"}
