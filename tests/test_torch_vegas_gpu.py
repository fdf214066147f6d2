"""The VEGAS sums kernel and the VEGAS path on the card.

These tests need a CUDA device and nvcc; without them they skip.  They
import neither JAX nor the JAX package, so on the GPU machine they run
without the suite's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_vegas_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.config import QuadratureConfig
from repro_torch.kernels import vegas_sums as vs
from repro_torch.mc import integrate_vegas, integrate_vegas_distributed
from repro_torch.mc import stratified

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(d, n, total, m, problems, dtype, seed):
    """n samples of each problem; counts over the iteration's total."""
    rng = np.random.default_rng(seed)
    counts = stratified.allocate_counts(
        torch.as_tensor(rng.uniform(size=(problems, m)) ** 3), total, 4)
    w = torch.as_tensor(rng.normal(size=(problems, n)), dtype=dtype)
    y = torch.as_tensor(rng.uniform(size=(d, problems, n)), dtype=dtype)
    return w, y, torch.cumsum(counts, dim=-1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize(
    "d,n,m,problems,shard0,n_shards",
    [(3, 8192, 64, 1, 0, 8), (5, 3 * 2500, 243, 2, 1, 3), (10, 1 << 16, 1024, 4, 0, 8),
     (2, 96, 9, 3, 5, 3)],
)
def test_sums_kernel_equals_plain_version_on_the_cpu(cuda, d, n, m, problems, shard0, n_shards,
                                                     dtype):
    """Bit for bit: both add in the same fixed order."""
    ns = n // n_shards
    w, y, cum = _inputs(d, n, (shard0 + n_shards) * ns, m, problems, dtype, seed=d + n)
    before = vs.launch_count()
    got = vs.vegas_sums(w.to(cuda), y.to(cuda), cum.to(cuda), 64, shard0, ns)
    torch.cuda.synchronize()
    assert vs.launch_count() == before + 1
    for g, r in zip(got, vs.vegas_sums_ref(w, y, cum, 64, shard0, ns)):
        assert torch.equal(g.cpu(), r)


def test_vegas_same_bits_run_to_run_and_over_ranks(cuda):
    cfg = QuadratureConfig(d=6, integrand="f4", rel_tol=1e-3, backend="vegas",
                           mc_samples=1 << 16, mc_max_iters=20)
    a = integrate_vegas(cfg)
    b = integrate_vegas(cfg)
    four = integrate_vegas_distributed(cfg, devices=[cuda] * 4)
    for r in (b, four):
        assert (r.integral, r.error, r.iterations, r.n_evals) == (
            a.integral, a.error, a.iterations, a.n_evals)
