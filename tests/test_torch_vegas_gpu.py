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
from repro_torch.launch.gm_perf import SUMS_HARD_CASES, bits_equal, sums_hard_case
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


_SHAPES = [(3, 8192, 64, 1, 0, 8), (5, 3 * 2500, 243, 2, 1, 3), (10, 1 << 16, 1024, 4, 0, 8),
           (2, 96, 9, 3, 5, 3)]
# (d, n, cubes, problems, shard0, shards) at 64 bins in both types, then
# the inputs of gm_perf.SUMS_HARD_CASES (by name)
_CASES = [(dtype, shape) for dtype in (torch.float64, torch.float32) for shape in _SHAPES]
_CASES += list(SUMS_HARD_CASES)


@pytest.mark.parametrize("case", _CASES, ids=lambda c: c if isinstance(c, str) else
                         f"{str(c[0]).split('.')[-1]}-" + "-".join(map(str, c[1])))
def test_sums_kernel_equals_plain_version_on_the_cpu(cuda, case):
    """Bit for bit: both add in the same fixed order."""
    if isinstance(case, str):
        w, y, cum, nb, shard0, ns = sums_hard_case(case, cuda)
    else:
        dtype, (d, n, m, problems, shard0, n_shards) = case
        ns, nb = n // n_shards, 64
        w, y, cum = (t.to(cuda) for t in _inputs(d, n, (shard0 + n_shards) * ns, m, problems,
                                                  dtype, seed=d + n))
    before = vs.launch_count()
    got = vs.vegas_sums(w, y, cum, nb, shard0, ns)
    torch.cuda.synchronize()
    assert vs.launch_count() == before + 1
    for g, r in zip(got, vs.vegas_sums_ref(w.cpu(), y.cpu(), cum.cpu(), nb, shard0, ns)):
        assert bits_equal(g.cpu(), r)


def test_vegas_same_bits_run_to_run_and_over_ranks(cuda):
    cfg = QuadratureConfig(d=6, integrand="f4", rel_tol=1e-3, backend="vegas",
                           mc_samples=1 << 16, mc_max_iters=20)
    a = integrate_vegas(cfg)
    b = integrate_vegas(cfg)
    four = integrate_vegas_distributed(cfg, devices=[cuda] * 4)
    for r in (b, four):
        assert (r.integral, r.error, r.iterations, r.n_evals) == (
            a.integral, a.error, a.iterations, a.n_evals)
