"""The service's fault injection and snapshots on the card.

The NaN sentinel of ``service/faults.py::nan_family`` reaches the CUDA GM
kernel's outputs only through the evaluate's sentinel route (the kernel
runs the base family's ``kernel_id``); these tests hold that route on the
card.  They need a CUDA device and nvcc, and skip without them.  They
import neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_faults_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.config import QuadratureConfig
from repro_torch.core.integrands import get_param
from repro_torch.kernels import genz_malik_eval as gm_kernel
from repro_torch.kernels import ops
from repro_torch.service import BatchEngine, BatchScheduler, QuadRequest
from repro_torch.service.faults import NAN_SENTINEL, nan_family, poison_theta

pytestmark = pytest.mark.gpu

FAMILY = get_param("genz_gaussian")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(**kw):
    return QuadratureConfig(**dict(dict(d=3, integrand="genz_gaussian", rel_tol=1e-5,
                                        capacity=1 << 11, batch_slots=4, sync_every=4), **kw))


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return [QuadRequest(req_id=i, theta=FAMILY.sample_theta(3, rng)) for i in range(n)]


def _vals(results):
    return {r.req_id: (r.integral.hex(), r.error.hex(), r.status, r.iterations, r.n_evals)
            for r in results}


def test_poisoned_request_ends_nonfinite_on_the_card(cuda):
    reqs = _requests(6)
    clean = _vals(BatchScheduler(_cfg(), FAMILY, devices=[cuda]).serve(list(reqs)))
    poisoned = reqs[:3] + [QuadRequest(req_id=90, theta=poison_theta(reqs[1].theta))] + reqs[3:]
    gm_kernel.reset_launch_count()
    sched = BatchScheduler(_cfg(), nan_family(FAMILY), devices=[cuda])
    vals = _vals(sched.serve(poisoned))
    assert gm_kernel.launch_count() > 0
    assert vals.pop(90)[2] == "nonfinite"
    assert vals == clean
    assert sched.last_stats["quarantines"] == 1


@pytest.mark.parametrize("name", ["genz_gaussian", "monomial"])
def test_sentinel_route_through_the_kernel(cuda, name):
    family = get_param(name)
    marked = dataclasses.replace(family, nan_sentinel=NAN_SENTINEL)
    rng = np.random.default_rng(4)
    d, lanes, slots = 3, 300, 5
    centers = torch.as_tensor(rng.uniform(0.1, 0.9, (slots * lanes, d)), device=cuda)
    centers[lanes:2 * lanes] = 0.5  # corners at x = 1 on every axis
    halfw = torch.full((slots * lanes, d), 0.5, dtype=torch.float64, device=cuda)
    thetas = [family.sample_theta(d, rng) for _ in range(slots)]
    thetas[1] = poison_theta(thetas[1])
    cols = torch.as_tensor(np.stack(
        [np.concatenate([t[k] for k in family.theta_fields]) for t in thetas], 1), device=cuda)
    before = gm_kernel.launch_count()
    got = ops.genz_malik_eval(marked, centers, halfw, theta_cols=cols)
    clean = ops.genz_malik_eval(family, centers, halfw, theta_cols=cols)
    assert gm_kernel.launch_count() - before == 2
    bad = torch.zeros(slots * lanes, dtype=torch.bool, device=cuda)
    bad[lanes:2 * lanes] = True
    for g, c in zip(got, clean):
        assert bool(torch.isnan(g[bad]).all())
        assert torch.equal(g[~bad], c[~bad])


def test_snapshot_round_trip_on_the_card(cuda):
    """to_host copies (a later run does not change it), and place puts the
    bits back on any rank count."""
    cfg = _cfg(batch_slots=4)
    eng = BatchEngine(cfg, devices=[cuda] * 2)
    state = eng.init()
    for s, req in enumerate(_requests(4, seed=2)):
        state = eng.admit(state, s, req.theta)
    state = eng.run(state, 2, 0)[0]
    host = eng.to_host(state)
    frozen = {k: v.copy() for k, v in host.items()}
    eng.run(state, 2, 2)
    for other in (1, 4):
        twin = BatchEngine(cfg, devices=[cuda] * other)
        back = twin.to_host(twin.place(host))
        for k in frozen:
            np.testing.assert_array_equal(host[k], frozen[k], err_msg=k)
            np.testing.assert_array_equal(back[k], frozen[k], err_msg=k)
