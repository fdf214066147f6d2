"""The CUDA GM kernel and the port's main path on the card.

These tests need a CUDA device and nvcc; without them they skip.  They
import neither JAX nor the JAX package, so on the GPU machine they run
without the suite's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import adaptive
from repro_torch.core import integrands
from repro_torch.core import rules
from repro_torch.core.config import QuadratureConfig
from repro_torch.kernels import genz_malik_eval as gm_kernel
from repro_torch.kernels import ops
from repro_torch.kernels.ref import genz_malik_eval_soa_ref

pytestmark = pytest.mark.gpu

ENTRIES = sorted(integrands.REGISTRY) + sorted(integrands.PARAM_REGISTRY)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(name, d, b, seed, dtype=torch.float64, device="cpu"):
    rng = np.random.default_rng(seed)
    centers = torch.as_tensor(rng.uniform(0.1, 0.9, (b, d)), dtype=dtype, device=device)
    halfw = torch.as_tensor(rng.uniform(0.01, 0.1, (b, d)), dtype=dtype, device=device)
    if name in integrands.PARAM_REGISTRY:
        entry = integrands.PARAM_REGISTRY[name]
        return entry, centers, halfw, entry.sample_theta(d, rng)
    return integrands.REGISTRY[name], centers, halfw, None


def _plain(entry, centers, halfw, theta):
    """The plain version on the same (CUDA) tensors."""
    ct, ht = centers.T.contiguous(), halfw.T.contiguous()
    if theta is None:
        i7, i5, i3, diffs = genz_malik_eval_soa_ref(entry.fn, ct, ht)
    else:
        leaves = [torch.as_tensor(theta[k], dtype=ct.dtype, device=ct.device)
                  for k in entry.theta_fields]
        rows = torch.cat(leaves)[:, None].expand(-1, ct.shape[1])
        sizes = [leaf.shape[0] for leaf in leaves]

        def fn(x, r):
            return entry.fn(x, dict(zip(entry.theta_fields, r.split(sizes))))

        i7, i5, i3, diffs = genz_malik_eval_soa_ref(fn, ct, ht, rows)
    return i7, i5, i3, diffs.T


@pytest.mark.parametrize("d", [1, 2, 3, 5, 8, 13])
@pytest.mark.parametrize("name", ENTRIES)
def test_kernel_matches_plain_version(cuda, name, d):
    entry, c, h, theta = _inputs(name, d, 257, seed=d, device=cuda)
    before = gm_kernel.launch_count()
    got = ops.genz_malik_eval(entry, c, h, theta=theta)
    torch.cuda.synchronize()
    assert gm_kernel.launch_count() == before + 1
    ref = _plain(entry, c, h, theta)
    for g, r in zip(got[:3], ref[:3]):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-300)
    torch.testing.assert_close(
        got[3], ref[3], rtol=1e-8, atol=float(ref[3].abs().max()) * 1e-10 + 1e-14
    )


@pytest.mark.parametrize("name", ["f1", "f4", "genz_gaussian"])
def test_kernel_float32(cuda, name):
    """float32 against the float64 plain version at rtol 1e-3, with an
    absolute floor of 1e-4 of the largest mean value |estimate| / volume
    times the region's volume (estimates that cancel to near zero keep no
    relative accuracy in float32), plus float32's smallest normal (f4's
    tails underflow)."""
    entry, c, h, theta = _inputs(name, 5, 1000, seed=1, device=cuda)
    ref = _plain(entry, c, h, theta)[0]
    got = ops.genz_malik_eval(entry, c.float(), h.float(), theta=theta)[0]
    assert got.dtype == torch.float32
    vol = torch.prod(2.0 * h, dim=1)
    atol = 1e-4 * (ref.abs() / vol).max() * vol + torch.finfo(torch.float32).tiny
    assert bool(torch.all((got.double() - ref).abs() <= 1e-3 * ref.abs() + atol))


@pytest.mark.parametrize("block", [32, 64, 128, 512])
def test_kernel_block_sizes(cuda, block):
    entry, c, h, theta = _inputs("f3", 3, 192, seed=11, device=cuda)
    got = ops.genz_malik_eval(entry, c, h, block_regions=block)
    ref = _plain(entry, c, h, theta)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-12, atol=0)


def test_kernel_wrapper_refuses_bad_inputs(cuda):
    c = torch.full((3, 64), 0.5, device=cuda)
    with pytest.raises(TypeError):
        gm_kernel.genz_malik_eval_soa(3, c.half(), c.half())
    with pytest.raises(ValueError, match="contiguous"):
        gm_kernel.genz_malik_eval_soa(3, c.T.contiguous().T, c.T.contiguous().T)
    big = torch.full((17, 4), 0.5, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="d <= 16"):
        gm_kernel.genz_malik_eval_soa(3, big, big)
    with pytest.raises(ValueError, match="theta rows"):
        gm_kernel.genz_malik_eval_soa(7, c.double(), c.double())
    with pytest.raises(ValueError, match="cannot inline"):
        ops.genz_malik_eval(lambda x: x[0], c.T.double(), c.T.double())


@pytest.mark.parametrize(
    "name,d,rel_tol", [("f4", 3, 1e-6), ("f6", 3, 1e-4), ("genz_gaussian:6,4:0.3,0.7", 2, 1e-6)]
)
def test_integrate_on_card_matches_cpu(cuda, name, d, rel_tol):
    cfg = QuadratureConfig(d=d, integrand=name, rel_tol=rel_tol, capacity=1 << 13)
    before = gm_kernel.launch_count()
    steps = []
    on_card = adaptive.integrate(cfg, callback=lambda *a: steps.append(a))
    assert gm_kernel.launch_count() - before == len(steps) == on_card.iterations + 1
    on_cpu = adaptive.integrate(cfg, device="cpu")
    assert on_card.status == on_cpu.status == "converged"
    assert (on_card.iterations, on_card.n_evals) == (on_cpu.iterations, on_cpu.n_evals)
    assert abs(on_card.integral - on_cpu.integral) <= 1e-12 * abs(on_cpu.integral)


def test_user_callable_refused_on_card(cuda):
    """The GM kernel refuses a callable; a callable with a theta is refused
    outright, a bare one runs on the rule's torch route with no GM launch."""
    cfg = QuadratureConfig(d=2, capacity=1 << 8)
    with pytest.raises(ValueError, match="a callable takes none"):
        rules.make_rule(cfg, lambda x: x[0], theta={"a": np.ones(2)})
    before = gm_kernel.launch_count()
    on_card = adaptive.integrate(cfg, lambda x: x[0] * x[1])
    assert gm_kernel.launch_count() == before
    on_cpu = adaptive.integrate(cfg, lambda x: x[0] * x[1], device="cpu")
    assert (on_card.status, on_card.iterations, on_card.n_evals) == (
        on_cpu.status, on_cpu.iterations, on_cpu.n_evals)
    assert abs(on_card.integral - 0.25) <= 1e-12


def test_round_kernels_match_plain_version(cuda):
    """The redistribution round's kernels against their plain versions on
    the CPU, bit for bit, over chip_smoke.py phase 3b's grid
    (gm_perf.round_grid): each case with every donor read in place (one
    round launch), then with every other donor packed into a block and read
    from it (one pack and one round launch)."""
    from repro_torch.kernels import redistribute_round as rk
    from repro_torch.launch.gm_perf import round_grid, round_vs_plain

    before = {k: rk.launch_count(k) for k in rk.KERNELS}
    moved = 0
    cases = list(round_grid())
    for case in cases:
        for staged in (False, True):
            err, rows = round_vs_plain(*case, staged=staged)
            assert err == 0.0, (case, staged)
            moved += rows
    assert moved > 0
    assert rk.launch_count("round") - before["round"] == 2 * len(cases)
    assert rk.launch_count("pack") - before["pack"] == len(cases)


@pytest.mark.parametrize("sync_every", [1, 4])
def test_distributed_on_card_matches_cpu(cuda, sync_every):
    """Four ranks on the card (the round's kernels) against four CPU ranks
    (their plain versions): the same iterations, evaluations, history and
    regions moved; one round launch a round (the four ranks share the
    card), and no pack."""
    from repro_torch.core.distributed import integrate_distributed
    from repro_torch.kernels import redistribute_round as rk

    cfg = QuadratureConfig(d=3, integrand="f6", rel_tol=1e-5, capacity=1 << 13,
                           sync_every=sync_every)
    rk.reset_launch_count()
    on_card = integrate_distributed(cfg, devices=[cuda] * 4)
    rounds, packs = rk.launch_count("round"), rk.launch_count("pack")
    on_cpu = integrate_distributed(cfg, devices=["cpu"] * 4)
    assert on_card.status == on_cpu.status == "converged"
    assert (on_card.iterations, on_card.n_evals, on_card.moved) == (
        on_cpu.iterations, on_cpu.n_evals, on_cpu.moved)
    assert [h[3] for h in on_card.history] == [h[3] for h in on_cpu.history]
    assert on_card.moved > 0
    assert on_card.iterations <= rounds <= on_card.iterations + on_card.discarded
    assert packs == 0