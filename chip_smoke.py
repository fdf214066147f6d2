"""Chip smoke run of the PyTorch/CUDA port: build, check, drive, time.

    python3 chip_smoke.py

Needs one CUDA device (an H100: the kernels are built for sm_90a) and nvcc.
Phases, each of which passes or raises (a failure exits nonzero):

1. device: name, count, versions, nvidia-smi name and power limit;
2. build: nvcc on the port's CUDA sources, one process per translation
   unit, all at once, and the build's seconds; each kernel instantiation's
   registers, spills and shared memory, by working type, integrand and
   dimension D.  Float64 instantiations at D <= 8 must not spill;
3. kernel vs its plain PyTorch version, on the card, for every integrand
   and family over d in {1,2,3,5,8,13} x B in {1, 257, 65536}, every other
   d up to 16 at B = 257 (fewer integrands above 13, where the plain
   version is slow), block sizes, and a per-lane theta (one theta per
   region); float64
   at the bars of tests/test_kernels.py and within 1e-14 relative, float32
   against the float64 plain version;
4. main path: repro_torch.core.adaptive.integrate on the card at capacity
   2^22 in float64, three cases, each of which must converge to its exact
   value in the iterations and evaluations recorded for it, with one
   kernel launch per evaluate step;
5. device loop: repro_torch.core.adaptive.integrate_device on the same
   three cases, bit-equal to phase 4's integrate (integral, error,
   iterations, evaluations), with its host syncs and wall time beside
   integrate's;
6. distributed: repro_torch.core.distributed.integrate_distributed on four
   ranks (rank r on cuda:(r mod device count): on one card they share
   it), capacity 2^22 per rank, float64; each case converges, agrees with
   phase 4's single-device run, spreads the work over every rank, and
   takes the iterations and evaluations recorded for it, with one kernel
   launch per rank per iteration;
7. the Gauss-Kronrod rule (torch operations) on the card, with the
   iterations and evaluations of the same run on the CPU;
8. timings with CUDA events at the main path's window size: the kernel
   wrapper on SoA inputs, the same through kernels/ops.py (with the
   layout change the main path makes), and the plain version; beside them
   two bounds (see _bounds).

It ends with one JSON line per kernel summary and, last, the device line.
"""

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the three main-path cases, the (integrand, d) timed at B = TIMED_B, and
# the helpers that gm_perf.py's measurements share with this script
from repro_torch.launch.gm_perf import (  # noqa: E402
    MAIN_CASES, TIMED, TIMED_B, card, inputs, soa, time_ms,
)

# H100 SXM peaks (NVIDIA data sheet): FP64 outside the tensor cores (an FMA
# counted as two operations), HBM3.
PEAK_FP64_FLOPS = 34e12
PEAK_HBM_BYTES = 3.35e12
# FP64 lanes per SM on Hopper: each issues one add, multiply or FMA per clock
FP64_LANES_PER_SM = 64

# (iterations, n_evals) of each MAIN_CASES run, exact: the kernel's
# redesign keeps its results, so the adaptive run takes the same path
EXPECTED_PATH = {"f4": (29, 392709984), "genz_gaussian": (25, 10851868416), "f6": (27, 1713618)}
# distributed cases: (integrand, d, rel_tol, redistribution), four ranks,
# capacity 2^22 per rank (each GPU holds its own store, as in the paper)
DIST_CASES = [
    ("f4", 5, 1e-7, "ring"),
    (MAIN_CASES[1][0], 8, 1e-5, "ring"),  # the theta path on every rank
    ("f6", 5, 1e-4, "ring"),
    ("f6", 5, 1e-4, "off"),
]
DIST_RANKS = 4
DIST_CAPACITY = 1 << 22
# (iterations, n_evals, evaluations per rank) of each distributed case,
# exact: recorded from the first run on the card
EXPECTED_DIST = {
    "f4-ring": (30, 392709984, [98177496] * 4),
    "genz_gaussian-ring": (23, 18534438144, [4633609536] * 4),
    "f6-ring": (28, 1713618, [423615, 428637, 419430, 441936]),
    "f6-off": (28, 1713618, [59706, 298902, 316386, 1038624]),
}
# Gauss-Kronrod on the card: (integrand, d, rel_tol), capacity 2^13; the
# f3 case of tests/test_eval_window.py, and one that refines five times.
# (iterations, n_evals) are those of the port's CPU run.
GK_CASES = [("f3", 3, 1e-7), ("f4", 2, 1e-8)]
EXPECTED_GK = {"f3": (0, 27000), "f4": (5, 14400)}
# float64 kernel vs plain version: the bar of tests/test_kernels.py, and the
# parity the kernel keeps (it repeats the plain version's operations)
RTOL64 = 1e-12
PARITY64 = 1e-14


def log(msg=""):
    print(msg, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    smi = card()
    log(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    return smi


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build_all()
    seconds = time.perf_counter() - t0
    units = sum(len(build.LIBRARIES[name]) for name in built)
    log(f"build: {sorted(built)}, {units} translation units, in {seconds:.1f} s")
    report = {}  # (dtype, integrand) -> {D: (registers, spill stores, spill loads, smem)}
    for lib in built.values():
        for (dtype, name, d), row in build.ptxas_report(lib.log).items():
            report.setdefault((dtype, name), {})[d] = row
    assert len(report) == 20 and all(len(v) == 16 for v in report.values()), sorted(report)
    log("  registers / spill bytes (stores+loads) / static shared bytes, D = 1..16:")
    for (dtype, name), by_d in sorted(report.items()):
        row = [by_d[d] for d in range(1, 17)]
        log(f"  {dtype} {name:<16} regs {' '.join(f'{r[0]:3d}' for r in row)}")
        log(f"  {'':<24} spill {' '.join(f'{r[1] + r[2]:3d}' for r in row)}"
            f"  smem {' '.join(str(r[3]) for r in row)}")
    spilled = [(dtype, name, d) for (dtype, name), by_d in report.items()
               for d, r in by_d.items() if dtype == "float64" and d <= 8 and r[1] + r[2]]
    assert not spilled, f"float64 instantiations at D <= 8 spill: {spilled}"


def _plain(entry, centers, halfw, theta):
    """The plain PyTorch version on the same CUDA tensors."""
    from repro_torch.kernels.ref import genz_malik_eval_soa_ref

    ct, ht, rows = soa(entry, centers, halfw, theta)
    if rows is None:
        return genz_malik_eval_soa_ref(entry.fn, ct, ht)
    d = ct.shape[0]  # every family's theta fields are (d,) leaves

    def fn(x, r):
        return entry.fn(x, dict(zip(entry.theta_fields, r.split(d))))

    return genz_malik_eval_soa_ref(fn, ct, ht, rows)


def _kernel(entry, centers, halfw, theta, block=0):
    from repro_torch.kernels import ops

    i7, i5, i3, diffs = ops.genz_malik_eval(entry, centers, halfw, theta=theta,
                                            block_regions=block)
    return i7, i5, i3, diffs.T


def _check64(got, ref, what):
    """The bars of tests/test_kernels.py, and the kernel's parity with the
    plain version (PARITY64); returns the largest relative error."""
    worst = 0.0
    for g, r, label in zip(got[:3], ref[:3], ("i7", "i5", "i3")):
        torch.testing.assert_close(g, r, rtol=RTOL64, atol=1e-300, msg=lambda m: f"{what} {label}: {m}")
        rel = float(((g - r).abs() / r.abs().clamp_min(1e-300)).max())
        assert rel <= PARITY64, f"{what} {label}: relative error {rel:.3e} > {PARITY64}"
        worst = max(worst, rel)
    dmax = float(ref[3].abs().max())
    torch.testing.assert_close(got[3], ref[3], rtol=1e-8, atol=dmax * 1e-10 + 1e-14,
                               msg=lambda m: f"{what} diffs: {m}")
    return worst


def _check32(got, ref32, ref64, halfw, what):
    """float32: the kernel against the float32 plain version (same
    arithmetic, so overflow to inf/nan in the same places), then against the
    float64 plain version at rtol 1e-3 wherever float32 stayed finite.

    The absolute floor of the second check is 1e-4 of the batch's largest
    mean value |estimate| / volume, times the region's volume, plus
    float32's smallest normal: float32 rounds the integrand's argument (f1
    at d=13 takes cos of ~45, to ~3e-6), so an estimate that cancels to
    near zero keeps no relative accuracy, and f4's far tails underflow.
    Returns the largest error as a share of its bar, and the count of
    estimates that overflowed in float32 (f2 and f6 at d=13 exceed its
    range at some nodes)."""
    worst, n_overflow = 0.0, 0
    tiny = torch.finfo(torch.float32).tiny
    vol = torch.prod(2.0 * halfw, dim=1)
    for g, r32, r, label in zip(got[:3], ref32[:3], ref64[:3], ("i7", "i5", "i3")):
        assert g.dtype == torch.float32
        finite = torch.isfinite(r32)
        top = float(r32[finite].abs().max()) if bool(finite.any()) else 0.0
        torch.testing.assert_close(g, r32, rtol=1e-5, atol=1e-6 * top + tiny, equal_nan=True,
                                   msg=lambda m: f"{what} float32 plain {label}: {m}")
        n_overflow += int((~finite).sum())
        g, r, v = g.double()[finite], r[finite], vol[finite]
        if g.numel() == 0:
            continue
        atol = 1e-4 * float((r.abs() / v).max()) * v + tiny
        share = (g - r).abs() / (1e-3 * r.abs() + atol)
        assert float(share.max()) <= 1.0, f"{what} float32 {label}: {float(share.max())} of the bar"
        worst = max(worst, float(share.max()))
    return worst, n_overflow


def _per_lane(name, d, b, rng, dtype):
    """A family with one theta per region: materialised (n_theta, B) rows
    (lane stride 1), the kernel's per-lane route."""
    from repro_torch.core import integrands

    entry = integrands.PARAM_REGISTRY[name]
    c = torch.as_tensor(rng.uniform(0.1, 0.9, (d, b)), dtype=dtype, device="cuda")
    h = torch.as_tensor(rng.uniform(0.01, 0.1, (d, b)), dtype=dtype, device="cuda")
    thetas = [entry.sample_theta(d, rng) for _ in range(b)]
    rows = torch.as_tensor(
        np.stack([np.concatenate([t[k] for k in entry.theta_fields]) for t in thetas], axis=1),
        dtype=dtype, device="cuda")
    return entry, c, h, rows


def _check_per_lane(rng):
    from repro_torch.kernels import genz_malik_eval as gm_kernel
    from repro_torch.kernels.ref import genz_malik_eval_soa_ref
    from repro_torch.core import integrands

    worst = 0.0
    for d in (1, 3, 8, 12):
        for name in sorted(integrands.PARAM_REGISTRY):
            entry, c, h, rows = _per_lane(name, d, 257, rng, torch.float64)
            assert rows.stride(1) == 1 and not bool((rows == rows[:, :1]).all())

            def fn(x, r, entry=entry, d=d):
                return entry.fn(x, dict(zip(entry.theta_fields, r.split(d))))

            got = gm_kernel.genz_malik_eval_soa(entry.kernel_id, c, h, rows)
            worst = max(worst, _check64(got, genz_malik_eval_soa_ref(fn, c, h, rows),
                                        f"{name} d={d} per-lane theta"))
            got32 = gm_kernel.genz_malik_eval_soa(entry.kernel_id, c.float(), h.float(), rows.float())
            ref32 = genz_malik_eval_soa_ref(fn, c.float(), h.float(), rows.float())
            for g, r in zip(got32[:3], ref32[:3]):
                torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6 * float(r.abs().max()) + 1e-38,
                                           msg=lambda m: f"{name} d={d} per-lane float32: {m}")
    return worst, 2 * 4 * len(integrands.PARAM_REGISTRY)


def phase_kernel_vs_plain():
    from repro_torch.core import integrands
    from repro_torch.kernels import genz_malik_eval as gm_kernel

    names = sorted(integrands.REGISTRY) + sorted(integrands.PARAM_REGISTRY)
    rng = np.random.default_rng(0)
    before = gm_kernel.launch_count()
    worst64 = worst32 = 0.0
    n_checks = overflowed = 0
    t0 = time.perf_counter()
    swept = (1, 2, 3, 5, 8, 13)
    cases = [(d, b, names) for d in swept for b in (1, 257, 65536)]
    # every other d at B = 257; above 13 the plain version's 2^d corners
    # take seconds per call (one launch per operation per node), so fewer
    # integrands bound it there: a sum, the NaN flag, a product and theta
    # at d=14, a sum with and without theta at d=15 and 16
    deep = {14: ["f4", "f6", "genz_gaussian", "monomial"],
            15: ["f4", "genz_gaussian"], 16: ["f4", "genz_gaussian"]}
    cases += [(d, 257, deep.get(d, names)) for d in range(1, 17) if d not in swept]
    for d, b, these in cases:
        for name in these:
            entry, c, h, theta = inputs(name, d, b, rng)
            ref = _plain(entry, c, h, theta)
            got = _kernel(entry, c, h, theta)
            worst64 = max(worst64, _check64(got, ref, f"{name} d={d} B={b} float64"))
            got32 = _kernel(entry, c.float(), h.float(), theta)
            ref32 = _plain(entry, c.float(), h.float(), theta)
            share, n_overflow = _check32(got32, ref32, ref, h, f"{name} d={d} B={b}")
            worst32 = max(worst32, share)
            overflowed += n_overflow
            n_checks += 2
    # block sizes: d=3 without spills, d=12 at the smallest and largest
    # block, and d=16, where ptxas spills most, at 512 threads
    blocks = [(block, 3, names) for block in (32, 64, 128, 512)]
    blocks += [(block, 12, names) for block in (32, 512)]
    for block, d, these in blocks + [(512, 16, ["f4"])]:
        for name in these:
            entry, c, h, theta = inputs(name, d, 192 if d < 16 else 600, rng)
            worst64 = max(worst64, _check64(_kernel(entry, c, h, theta, block),
                                            _plain(entry, c, h, theta),
                                            f"{name} d={d} block={block}"))
            n_checks += 1
    worst_lane, n_lane = _check_per_lane(rng)
    worst64 = max(worst64, worst_lane)
    n_checks += n_lane
    torch.cuda.synchronize()
    launched = gm_kernel.launch_count() - before
    assert launched == n_checks, (launched, n_checks)
    log(f"kernel vs plain: {n_checks} checks passed in {time.perf_counter() - t0:.1f} s "
        f"(d = 1..16, broadcast and per-lane theta); largest relative error float64 "
        f"{worst64:.3e} (bars {RTOL64:g} and {PARITY64:g}); "
        f"largest float32 error {worst32:.3f} of its bar; {overflowed} float32 "
        f"estimates overflowed in both the kernel and the plain version")


def phase_main_path():
    from repro_torch.core import adaptive
    from repro_torch.core import integrands
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.region_store import select_window
    from repro_torch.kernels import genz_malik_eval as gm_kernel

    total = 0
    rows = []
    for name, d, rel_tol, capacity in MAIN_CASES:
        cfg = QuadratureConfig(d=d, integrand=name, rel_tol=rel_tol, capacity=capacity)
        ladder = adaptive.eval_ladder(cfg)
        windows = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gm_kernel.reset_launch_count()
        t0 = time.perf_counter()
        res = adaptive.integrate(
            cfg, callback=lambda it, i, e, n: windows.append(select_window(ladder, n)),
            device="cuda",
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gm_kernel.launch_count()
        exact = integrands.get(name).exact(d)
        rel = abs(res.integral - exact) / abs(exact)
        row = dict(
            case=name.split(":")[0], d=d, rel_tol=rel_tol, capacity=capacity,
            status=res.status, wall_s=wall, iterations=res.iterations,
            n_evals=res.n_evals, evals_per_s=res.n_evals / wall,
            largest_window=max(windows), eval_steps=len(windows),
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            launches=launches, integral=res.integral, error=res.error,
            exact=exact, true_rel_err=rel, host_syncs=res.host_syncs,
        )
        log(json.dumps(row))
        assert res.status == "converged", row
        assert rel <= 5 * rel_tol, row
        assert launches == len(windows) > 0, row
        assert (res.iterations, int(res.n_evals)) == EXPECTED_PATH[row["case"]], row
        total += launches
        rows.append(row)
    return total, rows


def _timed(fn):
    """(result, wall seconds) of ``fn()``, on the host clock between two
    device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_device_loop(main_rows):
    """integrate_device on the main-path cases: the same bits as phase 4."""
    from repro_torch.core import adaptive
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.kernels import genz_malik_eval as gm_kernel

    total = 0
    for (name, d, rel_tol, capacity), main in zip(MAIN_CASES, main_rows):
        cfg = QuadratureConfig(d=d, integrand=name, rel_tol=rel_tol, capacity=capacity)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gm_kernel.reset_launch_count()
        res, wall = _timed(lambda: adaptive.integrate_device(cfg, device="cuda"))
        launches = gm_kernel.launch_count()
        peak = torch.cuda.max_memory_allocated()
        # walls of the two drivers in turns, warm
        turns = {"integrate": [], "integrate_device": []}
        for _ in range(2):
            for driver, walls in turns.items():
                walls.append(_timed(lambda: getattr(adaptive, driver)(cfg, device="cuda"))[1])
        k = cfg.sync_every
        # every block runs k evaluate steps; the last one's tail is discarded
        steps = math.ceil((res.iterations + 1) / k) * k
        row = dict(
            case=main["case"], d=d, driver="integrate_device", sync_every=k,
            status=res.status, wall_s=wall, host_syncs=res.host_syncs,
            integrate_host_syncs=main["host_syncs"], walls_in_turns=turns,
            iterations=res.iterations, n_evals=res.n_evals, eval_steps=steps,
            launches=launches, max_memory_allocated=peak,
        )
        log(json.dumps(row))
        assert res.status == "converged", row
        assert (res.integral, res.error, res.iterations, res.n_evals) == (
            main["integral"], main["error"], main["iterations"], main["n_evals"]), row
        assert res.host_syncs <= math.ceil(res.iterations / k) + 2, row
        assert launches == steps, row
        total += launches
    return total


def phase_distributed(main_rows):
    """Four ranks through the CUDA GM kernel, against phase 4's runs."""
    from repro_torch.core import integrands
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.distributed import integrate_distributed
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.kernels import genz_malik_eval as gm_kernel

    single = {row["case"]: row for row in main_rows}
    devices = cuda_devices(DIST_RANKS)
    total = 0
    imbalance = {}
    for name, d, rel_tol, policy in DIST_CASES:
        cfg = QuadratureConfig(d=d, integrand=name, rel_tol=rel_tol,
                               capacity=DIST_CAPACITY, redistribution=policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gm_kernel.reset_launch_count()
        res, wall = _timed(lambda: integrate_distributed(cfg, devices=devices))
        launches = gm_kernel.launch_count()
        case = name.split(":")[0]
        exact = integrands.get(name).exact(d)
        rel = abs(res.integral - exact) / abs(exact)
        mean_share = res.n_evals / DIST_RANKS
        row = dict(
            case=case, d=d, rel_tol=rel_tol, redistribution=policy, ranks=DIST_RANKS,
            devices=[str(x) for x in devices], capacity_per_rank=cfg.capacity,
            status=res.status, wall_s=wall, iterations=res.iterations,
            n_evals=res.n_evals, evals_per_s=res.n_evals / wall,
            evals_per_rank=res.evals_per_device.tolist(),
            share_of_mean=(res.evals_per_device / mean_share).tolist(),
            mean_imbalance=res.mean_imbalance(), regions_moved=res.moved,
            host_syncs=res.host_syncs, launches=launches,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            integral=res.integral, error=res.error, exact=exact, true_rel_err=rel,
            single_integral=single[case]["integral"],
        )
        log(json.dumps(row))
        assert res.status == "converged", row
        assert rel <= 10 * rel_tol, row
        assert abs(res.integral - single[case]["integral"]) <= 4 * rel_tol * abs(exact), row
        assert min(res.evals_per_device) > 0.01 * mean_share, row
        assert launches == res.iterations * DIST_RANKS > 0, row
        got = (res.iterations, int(res.n_evals), [int(x) for x in res.evals_per_device])
        assert got == EXPECTED_DIST[f"{case}-{policy}"], (got, row)
        imbalance[(case, policy)] = res.mean_imbalance()
        total += launches
    assert imbalance[("f6", "ring")] <= imbalance[("f6", "off")] + 0.05, imbalance
    return total


def phase_gauss_kronrod():
    """The GK rule's torch operations on the card, against the CPU run."""
    from repro_torch.core import adaptive
    from repro_torch.core import integrands
    from repro_torch.core.config import QuadratureConfig

    for name, d, rel_tol in GK_CASES:
        cfg = QuadratureConfig(d=d, integrand=name, rel_tol=rel_tol, capacity=1 << 13,
                               rule="gauss_kronrod", max_iters=200)
        res, wall = _timed(lambda: adaptive.integrate(cfg, device="cuda"))
        cpu = adaptive.integrate(cfg, device="cpu")
        exact = integrands.get(name).exact(d)
        rel = abs(res.integral - exact) / abs(exact)
        row = dict(case=name, d=d, rel_tol=rel_tol, rule="gauss_kronrod",
                   status=res.status, wall_s=wall, iterations=res.iterations,
                   n_evals=res.n_evals, integral=res.integral, error=res.error,
                   cpu_integral=cpu.integral, exact=exact, true_rel_err=rel)
        log(json.dumps(row))
        assert res.status == cpu.status == "converged", row
        assert rel <= 5 * rel_tol, row
        assert (res.iterations, int(res.n_evals)) == (cpu.iterations, int(cpu.n_evals)) \
            == EXPECTED_GK[name], row
        assert abs(res.integral - cpu.integral) <= cpu.error, row


# FP64 instructions of the two timed integrands in the kernel's table form
# (integrands.cuh): per term x - 0.5, t * t (f4) or x - u, a * t, t * t
# (genz_gaussian); per finish -625 * s, exp (f4) or exp(-s), whose negation
# is an operand modifier (genz_gaussian); exp counted as one instruction.
TERM_INSTR = {"f4": 2, "genz_gaussian": 3}
FINISH_INSTR = {"f4": 2, "genz_gaussian": 1}


def _bounds(name, d, b, sms, clock_hz):
    """Two yardsticks of the kernel's time at ``b`` regions, in ms.

    ``bound_ms`` is the bound of the port's first kernel, kept so that the
    rows of PERF.md compare: the larger of bytes / HBM rate and operations
    / 34 TFLOP/s, with n_nodes(d) * (the plain integrand's per-point work)
    + 4d + 20 operations per region.  Those operations recompute every
    axis's factor at every node, which the table form does not, and the
    rate counts an FMA as two operations while the kernel, built with
    -fmad=false, issues adds and multiplies: it is a shared yardstick, not
    a least time of this kernel.

    ``instr_bound_ms`` is the time of the table form's FP64 instructions at
    the FP64 issue rate (64 lanes per SM at the card's largest SM clock),
    or of the bytes if longer: the 8d coordinates (4d products lambda * h,
    8d adds and subtracts), 9d terms, and per node its d - 1 folds, its
    finish and one add into its group's sum; the scale (d - 1), the fourth
    differences (6d + 1) and the weighted sums (22).  Each exp counts as
    one instruction (``exps`` is their number; the math library takes
    about twenty), and no fold is shared between nodes.
    """
    from repro_torch.core.genz_malik import n_nodes

    nodes = n_nodes(d)
    bytes_moved = (2 * d + 3 + d) * b * 8
    per_point = {"f4": 3 * d + 2, "genz_gaussian": 4 * d + 2}[name]
    ops = (nodes * per_point + 4 * d + 20) * b
    instr = (12 * d + 9 * d * TERM_INSTR[name] + nodes * (d + FINISH_INSTR[name])
             + (d - 1) + (6 * d + 1) + 22) * b
    bytes_ms = bytes_moved / PEAK_HBM_BYTES * 1e3
    ops_ms = ops / PEAK_FP64_FLOPS * 1e3
    return dict(
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        bytes=bytes_moved, ops=ops,
        instr_bound_ms=max(bytes_ms, instr / (sms * FP64_LANES_PER_SM * clock_hz) * 1e3),
        fp64_instr=instr, exps=nodes * b,
    )


def phase_timing():
    from repro_torch.kernels import genz_malik_eval as gm_kernel

    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(1)
    out = []
    for name, d in TIMED:
        entry, c, h, theta = inputs(name, d, TIMED_B, rng)
        ct, ht, rows = soa(entry, c, h, theta)
        before = gm_kernel.launch_count()
        got = _kernel(entry, c, h, theta)
        ref = _plain(entry, c, h, theta)
        _check64(got, ref, f"{name} d={d} B={TIMED_B}")
        max_abs = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        ms = time_ms(lambda: gm_kernel.genz_malik_eval_soa(entry.kernel_id, ct, ht, rows), 50)
        ops_ms = time_ms(lambda: _kernel(entry, c, h, theta), 50)
        plain_ms = time_ms(lambda: _plain(entry, c, h, theta), 20)
        assert gm_kernel.launch_count() - before == 1 + 2 * (3 + 50)
        row = dict(integrand=name, d=d, B=TIMED_B, dtype="float64", ms=ms,
                   ms_via_ops=ops_ms, plain_ms=plain_ms,
                   **_bounds(name, d, TIMED_B, sms, clock_mhz * 1e6),
                   sms=sms, clock_max_mhz=clock_mhz, max_abs_err=max_abs,
                   library_ms=None)
        log("timing: " + json.dumps(row))
        out.append(row)
    return out


def main():
    smi = phase_device()
    phase_build()
    phase_kernel_vs_plain()
    launches, main_rows = phase_main_path()
    launches += phase_device_loop(main_rows)
    launches += phase_distributed(main_rows)
    phase_gauss_kronrod()
    timings = phase_timing()
    t = timings[0]
    kernel = dict(
        name="genz_malik_eval", route="cuda",
        source="src/repro_torch/kernels/csrc/gm_kernel.cuh",
        replaces="src/repro/kernels/genz_malik_eval.py:44",
        launches=launches, max_abs_err=t["max_abs_err"], ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        instr_bound_ms=t["instr_bound_ms"], library_ms=None,
        at=f"{t['integrand']} d={t['d']} B={t['B']} float64",
    )
    log(f"card: {smi}")
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
