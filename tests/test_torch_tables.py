"""The CUDA kernel's arithmetic, transcribed in torch, against the plain
version on the CPU: every integrand split into term / fold / finish, the
per-axis term tables and the left-to-right fold per node
(kernels/ref.py::genz_malik_eval_soa_tables_ref) give the plain version's
results bit for bit.  Also the launcher's block choice, the build's units
and the parser of its -Xptxas -v report."""

import numpy as np
import pytest
import torch

from repro_torch.core import integrands
from repro_torch.kernels import build
from repro_torch.kernels import genz_malik_eval as gm_kernel
from repro_torch.kernels.ref import (
    DECOMPOSITIONS,
    genz_malik_eval_soa_ref,
    genz_malik_eval_soa_tables_ref,
)

torch.set_num_threads(1)

ENTRIES = sorted(integrands.REGISTRY) + sorted(integrands.PARAM_REGISTRY)


def _entry(name):
    return integrands.REGISTRY.get(name) or integrands.PARAM_REGISTRY[name]


def _case(name, d, b, dtype, seed, per_lane=False):
    """SoA inputs, the plain version's callable and the theta rows, as
    kernels/ops.py builds them (a broadcast view) or one theta per lane."""
    rng = np.random.default_rng(seed)
    centers = torch.as_tensor(rng.uniform(0.1, 0.9, (d, b)), dtype=dtype)
    halfw = torch.as_tensor(rng.uniform(0.01, 0.1, (d, b)), dtype=dtype)
    entry = _entry(name)
    if name in integrands.REGISTRY:
        return entry, centers, halfw, entry.fn, None
    fields = entry.theta_fields
    if per_lane:
        thetas = [entry.sample_theta(d, rng) for _ in range(b)]
        rows = torch.as_tensor(
            np.stack([np.concatenate([t[k] for k in fields]) for t in thetas], axis=1),
            dtype=dtype,
        )
    else:
        theta = entry.sample_theta(d, rng)
        rows = torch.as_tensor(np.concatenate([theta[k] for k in fields]), dtype=dtype)
        rows = rows[:, None].expand(-1, b)

    def fn(x, r):
        return entry.fn(x, dict(zip(fields, r.split(d))))

    return entry, centers, halfw, fn, rows


def _assert_equal(got, ref):
    for g, r, label in zip(got, ref, ("i7", "i5", "i3", "diffs")):
        assert g.dtype == r.dtype and g.shape == r.shape, label
        assert torch.equal(g, r), (label, float((g - r).abs().max()))


def test_every_kernel_id_has_a_decomposition():
    ids = {_entry(n).kernel_id for n in ENTRIES}
    assert ids == set(DECOMPOSITIONS) == set(range(10))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("name", ENTRIES)
def test_tables_match_plain_version(name, d, dtype):
    entry, c, h, fn, rows = _case(name, d, 67, dtype, seed=100 * d + len(name))
    got = genz_malik_eval_soa_tables_ref(entry.kernel_id, c, h, rows)
    _assert_equal(got, genz_malik_eval_soa_ref(fn, c, h, rows))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [2, 5])
@pytest.mark.parametrize("name", sorted(integrands.PARAM_REGISTRY))
def test_tables_match_plain_version_per_lane_theta(name, d, dtype):
    entry, c, h, fn, rows = _case(name, d, 33, dtype, seed=d, per_lane=True)
    assert rows.stride(1) != 0 and not bool((rows == rows[:, :1]).all())
    got = genz_malik_eval_soa_tables_ref(entry.kernel_id, c, h, rows)
    _assert_equal(got, genz_malik_eval_soa_ref(fn, c, h, rows))


def test_f6_outside_the_box_is_zero_and_inside_is_exact():
    """f6's flag rides in the term as NaN; regions that straddle the box
    edge put some nodes outside and some inside."""
    d, b = 3, 64
    rng = np.random.default_rng(7)
    c = torch.as_tensor(rng.uniform(0.3, 0.7, (d, b)))
    h = torch.as_tensor(rng.uniform(0.05, 0.3, (d, b)))
    got = genz_malik_eval_soa_tables_ref(5, c, h)
    ref = genz_malik_eval_soa_ref(integrands.REGISTRY["f6"].fn, c, h)
    _assert_equal(got, ref)
    assert bool(torch.all(torch.isfinite(got[0])))


@pytest.mark.parametrize("block", [0, 1, 32, 64, 128, 256, 512])
def test_block_choice(block):
    """Every power of two up to the kernel's __launch_bounds__ launches at
    every d (the tables are in registers, so no d needs shared memory);
    0 means the default, chosen by a block sweep on the card."""
    assert gm_kernel.resolve_block(block) == (block or gm_kernel.DEFAULT_BLOCK)
    assert gm_kernel.MAX_BLOCK == 512


@pytest.mark.parametrize("block", [1024, 96, 3, -64])
def test_block_choice_refuses(block):
    with pytest.raises(ValueError, match="block_regions"):
        gm_kernel.resolve_block(block)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN2gm14gm_eval_kernelIdLi5E2F4EEvPKT_S4_S4_xxPS2_S5_S5_S5_xNS_6ConstsIS2_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN2gm14gm_eval_kernelIdLi5E2F4EEvPKT_S4_S4_xxPS2_S5_S5_S5_xNS_6ConstsIS2_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN2gm14gm_eval_kernelIfLi16E12GenzGaussianEEvPKT_S4_S4_xxPS2_S5_S5_S5_xNS_6ConstsIS2_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN2gm14gm_eval_kernelIfLi16E12GenzGaussianEEvPKT_S4_S4_xxPS2_S5_S5_S5_xNS_6ConstsIS2_EE
    0 bytes stack frame, 48 bytes spill stores, 52 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 128 bytes smem
"""


def test_ptxas_report_reads_type_integrand_and_dimension():
    assert build.ptxas_report(PTXAS_LOG) == {
        ("float64", "F4", 5): (126, 0, 0, 0),
        ("float32", "GenzGaussian", 16): (128, 48, 52, 128),
    }


def test_build_units_cover_every_type_and_dimension(monkeypatch, tmp_path):
    """One nvcc -c per translation unit: the dispatcher, and each (type, D)
    of the kernel exactly once."""
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    cmds = build.compile_commands("genz_malik_eval", tmp_path)
    assert len(cmds) == 1 + 2 * gm_kernel.MAX_D
    pairs = set()
    for cmd, obj in cmds:
        assert "-c" in cmd and "-fmad=false" in cmd and "arch=compute_90a,code=sm_90a" in cmd
        defines = [a for a in cmd if a.startswith("-DGM_")]
        if defines:
            pairs.add(tuple(defines))
    assert len(pairs) == 2 * gm_kernel.MAX_D
    assert len({obj for _, obj in cmds}) == len(cmds)


@pytest.mark.parametrize("chunk", [3, 64])
@pytest.mark.parametrize("d", [3, 7])
@pytest.mark.parametrize(
    "name, per_lane",
    [(n, False) for n in ENTRIES] + [(n, True) for n in sorted(integrands.PARAM_REGISTRY)],
)
def test_corner_chunk_keeps_the_plain_version(name, per_lane, d, chunk):
    """Corners evaluated ``chunk`` at a time (theta rows tiled over them)
    and added one at a time in order give one corner a call's results."""
    entry, c, h, fn, rows = _case(name, d, 67, torch.float64, seed=d + chunk, per_lane=per_lane)
    got = genz_malik_eval_soa_ref(fn, c, h, rows, corner_chunk=chunk)
    _assert_equal(got, genz_malik_eval_soa_ref(fn, c, h, rows))
