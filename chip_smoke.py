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
   version is slow), block sizes, a per-lane theta (one theta per
   region), and the batch service's per-slot theta columns (lanes_per_col
   in {1, 7, 256, 1000}, genz_gaussian and genz_product_peak at d in
   {2, 5, 8}); float64 at the bars of tests/test_kernels.py and within
   1e-14 relative, float32 against the float64 plain version;
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
   two bounds (see _bounds);
9. the batch service (repro_torch.service) at a real size: gm_perf.py's
   SERVICE fleet (192 Gaussians at d = 5, float64, 64 slots of 2^19
   regions, rel_tol 1e-3 / 1e-7 by request parity) on one rank, then on
   four ranks (cuda:(r mod count), 16 slots each, ring migration).  Every
   request ends converged, or evicted with status capacity where its
   regions outgrow the store, within 10 max(error, budget) of its exact
   value; the
   two runs give the same results bit for bit; the first four requests
   equal integrate()'s on their theta and tolerance bit for bit; one GM
   launch per rank per iteration with a live slot; migrations on four
   ranks;
10. the VEGAS backend (repro_torch.mc), gm_perf.py's VEGAS_CASES at a
   high-dimension user's sizes (genz_gaussian d=15 and genz_product_peak
   d=10 at 2^22 samples, f6 d=9 at 2^20; float64, 8 shards).  First the
   sums kernel against its plain version (bit-equal to the plain version's
   sample-order sums on the CPU, NaN where NaN; within 1e-10 of the largest
   finite sum against its index_add_ on the card) at these shapes and at
   gm_perf.py's SUMS_HARD_CASES: one bin per axis, y at and beyond the
   edges and NaN, NaN, +-inf and -0.0 in w, 2 to 65535 bins (one pass and
   digit passes), short and odd shards, unaligned inputs, float32.
   (a) integrate_vegas, each case twice:
   the same bits, converged, within 5 reported errors of the exact value,
   one sums launch per iteration; (b) integrate_vegas_distributed on 2 and
   4 ranks (cuda:(r mod count)): bit-equal to (a), one launch per rank
   per iteration;
11. (a) the VEGAS pool: 64 genz_gaussian requests at d=10 served with
   backend "auto" (16 slots, 2^18 samples, rel_tol 1e-3): every request
   converged or max_iters, within 5 errors of its exact value, n_evals =
   samples x iterations; (b) phase 9's one-rank fleet through
   GracefulScheduler: the requests phase 9 finished are equal to phase
   9's results, the ones it evicted as capacity come back from the VEGAS
   pool with attempts 2, and last_stats counts them as reroutes;
12. the service's resilience (repro_torch.service.checkpoint, faults and
   the scheduler's watchdog) at phase 9's size: (a) the one-rank fleet
   with a ServiceCheckpointer (snapshots of 3.4 GB under build/), crashed
   by crash_at after its second snapshot and after some results, then
   resumed: the union of the results before the crash and after the
   resume equals phase 9's tuple for tuple, with at least one replayed;
   (b) the four-rank fleet with DeviceDown(device=2) lost after a snapshot
   and healed later: one evacuation at least, the ranks shrink to 2 (64
   slots over 3 healthy ranks) and regrow to 4, every request's values
   equal to phase 9's, the evacuated ones marked snapshot or readmit and
   within the phase's error bar; (c) the chaos self-test
   (repro_torch.service.chaos_selftest) at 1, 2 and 4 ranks on the card,
   whose nan_injection is where the NaN sentinel goes through the CUDA GM
   path.  Snapshot bytes, save and restore seconds and the walls are
   logged.

Last, the sums kernel timed at gm_perf.py's SUMS_TIMED shapes (phase 10's
d=15 and f6 cases, phase 11a's pool): per call, its chunk and combine
launches, the plain version, index_add_ alone and the byte bound.
It ends with one JSON line per kernel summary and, last, the device line.
"""

import json
import math
import os
import re
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
    MAIN_CASES, PEAK_FP64_FLOPS, PEAK_HBM_BYTES, SUMS_HARD_CASES, SUMS_TIMED, TIMED, TIMED_B,
    VEGAS_CASES, VEGAS_POOL, bits_equal, card, inputs, pool_thetas, serve_pool, soa,
    sums_hard_case, sums_inputs, time_ms, time_sums, vegas_case,
)

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
    log("  vegas_sums kernels: registers / spill bytes (stores+loads):")
    kernel, spill = None, 0
    for line in built["vegas_sums"].log.splitlines():
        m = re.search(r"Compiling entry function '\S*vegas_sums_(chunks|combine)I([df])(?:Lb([01]))?",
                      line)
        if m:
            path = {None: "", "0": ", one pass", "1": ", digit passes"}[m.group(3)]
            kernel = f"{m.group(1)}<{'double' if m.group(2) == 'd' else 'float'}{path}>"
        elif kernel and "spill stores" in line:
            spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif kernel and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            log(f"  {kernel:<30} regs {regs:>3} spill {spill}")
            kernel = None


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


def _check_theta_cols(rng):
    """The batch service's form: one theta column per slot, read by runs
    of lanes_per_col lanes (a block of 256 threads straddles slots at 7
    and 1000), against the plain version on the same columns."""
    from repro_torch.core import integrands
    from repro_torch.kernels import genz_malik_eval as gm_kernel
    from repro_torch.kernels.ref import genz_malik_eval_soa_ref

    worst, n = 0.0, 0
    for name in ("genz_gaussian", "genz_product_peak"):
        entry = integrands.PARAM_REGISTRY[name]
        for d in (2, 5, 8):
            for lanes in (1, 7, 256, 1000):
                slots = max(3, 600 // lanes)
                c = torch.as_tensor(rng.uniform(0.1, 0.9, (d, slots * lanes)), device="cuda")
                h = torch.as_tensor(rng.uniform(0.01, 0.1, (d, slots * lanes)), device="cuda")
                thetas = [entry.sample_theta(d, rng) for _ in range(slots)]
                cols = torch.as_tensor(np.stack(
                    [np.concatenate([t[k] for k in entry.theta_fields]) for t in thetas], 1),
                    device="cuda")

                def fn(x, r, entry=entry, d=d):
                    return entry.fn(x, dict(zip(entry.theta_fields, r.split(d))))

                what = f"{name} d={d} lanes_per_col={lanes}"
                got = gm_kernel.genz_malik_eval_soa(entry.kernel_id, c, h, cols, lanes_per_col=lanes)
                ref = genz_malik_eval_soa_ref(fn, c, h, cols, lanes_per_col=lanes)
                worst = max(worst, _check64(got, ref, what + " per-slot theta"))
                got32 = gm_kernel.genz_malik_eval_soa(entry.kernel_id, c.float(), h.float(),
                                                      cols.float(), lanes_per_col=lanes)
                ref32 = genz_malik_eval_soa_ref(fn, c.float(), h.float(), cols.float(),
                                                lanes_per_col=lanes)
                for g, r in zip(got32[:3], ref32[:3]):
                    torch.testing.assert_close(
                        g, r, rtol=1e-5, atol=1e-6 * float(r.abs().max()) + 1e-38,
                        msg=lambda m: f"{what} per-slot float32: {m}")
                n += 2
    return worst, n


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
    worst_cols, n_cols = _check_theta_cols(rng)
    worst64 = max(worst64, worst_cols)
    n_checks += n_cols
    torch.cuda.synchronize()
    launched = gm_kernel.launch_count() - before
    assert launched == n_checks, (launched, n_checks)
    log(f"kernel vs plain: {n_checks} checks passed in {time.perf_counter() - t0:.1f} s "
        f"(d = 1..16, broadcast, per-lane and per-slot theta); largest relative error float64 "
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


def phase_service():
    """The batch service's fleet on one rank and on four; see the docstring."""
    from repro_torch.core import adaptive
    from repro_torch.core import integrands
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.kernels import genz_malik_eval as gm_kernel
    from repro_torch.launch.gm_perf import SERVICE, serve_fleet, service_requests
    from repro_torch.service.sharded_selftest import tuples

    family = integrands.PARAM_REGISTRY[SERVICE["integrand"]]
    d = SERVICE["d"]
    requests = service_requests()
    total = 0
    runs = {}
    for n in (1, 4):
        devices = cuda_devices(n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gm_kernel.reset_launch_count()
        (results, sched), wall = _timed(lambda: serve_fleet(devices))
        launches = gm_kernel.launch_count()
        stats = sched.last_stats
        steps = sched.engine.eval_steps.tolist()
        n_evals = sum(r.n_evals for r in results)
        row = dict(
            phase="service", ranks=n, devices=[str(x) for x in devices],
            slots=SERVICE["batch_slots"], capacity_per_slot=SERVICE["capacity"],
            requests=len(results), wall_s=wall, requests_per_s=len(results) / wall,
            n_evals=n_evals, evals_per_s=n_evals / wall, iterations=stats["iterations"],
            dispatches=stats["dispatches"], launches=launches, eval_steps_per_rank=steps,
            migrations=stats["migrations"], max_memory_allocated=torch.cuda.max_memory_allocated(),
            statuses={s: sum(r.status == s for r in results) for s in {r.status for r in results}},
        )
        log(json.dumps(row))
        assert len(results) == len(requests), row
        # one GM launch per rank per iteration in which the rank had a live
        # slot; on one rank every iteration has one
        assert launches == sum(steps) > 0, row
        assert max(steps) <= stats["iterations"], row
        if n == 1:
            assert launches == stats["iterations"], row
        # A request whose regions outgrow its 2^19-row store ends "capacity"
        # (evicted evict_patience iterations after the overflow, as in the
        # JAX service); its best-effort estimate is held to the same bar.
        assert set(row["statuses"]) <= {"converged", "capacity"}, row
        for req, res in zip(requests, results):
            exact = family.exact(d, req.theta)
            budget = max(1e-16, abs(exact) * req.rel_tol)
            assert abs(res.integral - exact) <= 10 * max(res.error, budget), (res, exact)
        runs[n] = results
        total += launches
    assert tuples(runs[1]) == tuples(runs[4]), [
        (a, b) for a, b in zip(tuples(runs[1]), tuples(runs[4])) if a != b][:2]
    assert row["migrations"] > 0, row
    # the first four requests against the single-problem driver on the card
    for req, res in zip(requests[:4], runs[1][:4]):
        cfg = QuadratureConfig(**{**SERVICE, "integrand": integrands.to_spec(family, req.theta),
                                  "rel_tol": req.rel_tol})
        gm_kernel.reset_launch_count()
        single, wall = _timed(lambda: adaptive.integrate(cfg, device="cuda"))
        total += gm_kernel.launch_count()
        log(json.dumps(dict(phase="service_vs_integrate", req_id=req.req_id, rel_tol=req.rel_tol,
                            iterations=single.iterations, n_evals=single.n_evals, wall_s=wall,
                            integral=single.integral, error=single.error)))
        assert (res.integral, res.error, res.status, res.iterations, res.n_evals) == (
            single.integral, single.error, single.status, single.iterations,
            single.n_evals), (res, single)
    return total, runs[1]


# --- the VEGAS backend (phases 10 and 11) -------------------------------------

# vegas_sums against its plain version: at most this share of the largest
# sum apart from the plain version's index_add_ on the card (atomics add in
# another order; ~450 and ~840 units of rounding of float64 and float32);
# bit-equal to the plain version's sample-order sums on the CPU
SUMS_RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def _sums_check(w, y, cum, nb, shard0, ns, what):
    """The kernel against the plain version: bit-equal on a CPU copy, and
    within SUMS_RTOL of the largest finite sum on the card (the infinite
    and NaN sums in the same places: no order changes them); returns the
    largest absolute difference of a finite sum on the card."""
    from repro_torch.kernels import vegas_sums as vs

    got = vs.vegas_sums(w, y, cum, nb, shard0, ns)
    ref = vs.vegas_sums_ref(w, y, cum, nb, shard0, ns)
    cpu = vs.vegas_sums_ref(w.cpu(), y.cpu(), cum.cpu(), nb, shard0, ns)
    worst = 0.0
    for g, r, c, label in zip(got, ref, cpu, ("s1", "s2", "g")):
        assert bits_equal(g.cpu(), c), f"{what} {label}: kernel and CPU plain version differ"
        fin = torch.isfinite(r)
        assert bits_equal(torch.where(fin, 0, g), torch.where(fin, 0, r)), f"{what} {label}"
        if bool(fin.any()):
            err = float((g - r)[fin].abs().max())
            assert err <= SUMS_RTOL[w.dtype] * float(r[fin].abs().max()), f"{what} {label}: {err}"
            worst = max(worst, err)
    return worst


def phase_vegas_kernel_vs_plain():
    """The sums kernel at the shapes of phases 10 and 11, a rank's slice of
    shards, float32, and SUMS_HARD_CASES (both of its paths); with each
    path's plan (shared memory, resident blocks per SM)."""
    from repro_torch.kernels import vegas_sums as vs

    for dtype in (torch.float64, torch.float32):
        for nb in (64, 65535):
            log(f"vegas sums plan nb={nb} {dtype}: {json.dumps(vs.plan(dtype, nb))}")
    rng = np.random.default_rng(2)
    before = vs.launch_count()
    worst, n = 0.0, 0
    t0 = time.perf_counter()
    for d, samples, n_strat, problems in [(15, 1 << 22, 2, 1), (10, 1 << 22, 3, 1),
                                          (9, 1 << 20, 3, 1), (10, 1 << 18, 2, 16), (3, 4096, 4, 3)]:
        w, y, cum = sums_inputs(rng, d, samples, n_strat, problems)
        ns = samples // 8
        worst = max(worst, _sums_check(w, y, cum, 64, 0, ns, f"d={d} N={samples} P={problems}"))
        # the slice of shards 4..5 that rank 2 of 4 reduces
        sl = slice(4 * ns, 6 * ns)
        worst = max(worst, _sums_check(w[:, sl].contiguous(), y[:, :, sl].contiguous(), cum, 64, 4,
                                       ns, f"d={d} N={samples} shards 4-5"))
        n += 2
    w, y, cum = sums_inputs(rng, 5, 8192, 3, 2, torch.float32)
    worst = max(worst, _sums_check(w, y, cum, 16, 0, 1024, "float32"))
    n += 1
    for name in SUMS_HARD_CASES:
        w, y, cum, nb, shard0, ns = sums_hard_case(name, "cuda")
        _sums_check(w, y, cum, nb, shard0, ns, name)
        n += 1
    torch.cuda.synchronize()
    assert vs.launch_count() - before == n, (vs.launch_count() - before, n)
    log(f"vegas sums vs plain: {n} checks passed in {time.perf_counter() - t0:.1f} s "
        f"({len(SUMS_HARD_CASES)} hard cases: {', '.join(SUMS_HARD_CASES)}); bit-equal to the "
        f"plain version on the CPU, largest difference from its index_add_ on the card "
        f"{worst:.3e}")
    return worst


def phase_vegas():
    """Phase 10: integrate_vegas twice per case, then on 2 and 4 ranks."""
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.kernels import vegas_sums as vs
    from repro_torch.mc import integrate_vegas, integrate_vegas_distributed

    total = 0
    rows = []
    for case in VEGAS_CASES:
        cfg, exact = vegas_case(*case)
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            vs.reset_launch_count()
            res, wall = _timed(lambda: integrate_vegas(cfg, device="cuda"))
            runs.append((res, wall, vs.launch_count(), torch.cuda.max_memory_allocated()))
        (res, wall, launches, peak), (again, wall2, _, _) = runs
        sigmas = abs(res.integral - exact) / res.error
        row = dict(
            phase="vegas", case=case[0], d=cfg.d, mc_samples=cfg.mc_samples, rel_tol=cfg.rel_tol,
            status=res.status, iterations=res.iterations, n_evals=res.n_evals,
            chi2_dof=res.chi2_dof, wall_s=[wall, wall2], samples_per_s=res.n_evals / wall2,
            max_memory_allocated=peak, launches=launches,
            host_syncs=res.host_syncs, integral=res.integral, error=res.error, exact=exact,
            true_rel_err=abs(res.integral - exact) / abs(exact), errors_off=sigmas,
        )
        log(json.dumps(row))
        assert (again.integral, again.error, again.iterations, again.n_evals, again.chi2_dof) == (
            res.integral, res.error, res.iterations, res.n_evals, res.chi2_dof), (again, res)
        assert res.status == "converged", row
        assert sigmas <= 5.0, row
        assert launches == res.iterations > 0, row
        total += launches
        for n in (2, 4):
            devices = cuda_devices(n)
            vs.reset_launch_count()
            dist, dwall = _timed(lambda: integrate_vegas_distributed(cfg, devices=devices))
            dl = vs.launch_count()
            log(json.dumps(dict(phase="vegas_ranks", case=case[0], d=cfg.d, ranks=n,
                                devices=[str(x) for x in devices], wall_s=dwall,
                                iterations=dist.iterations, launches=dl,
                                integral=dist.integral, error=dist.error)))
            assert (dist.integral, dist.error, dist.n_evals, dist.iterations, dist.status) == (
                res.integral, res.error, res.n_evals, res.iterations, res.status), (n, dist, res)
            assert dl == n * dist.iterations, (dl, dist.iterations)
            total += dl
        rows.append(row)
    return total, rows


def phase_vegas_pool():
    """Phase 11a: the VEGAS pool's fleet, routed by backend "auto"."""
    from repro_torch.core import integrands
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.kernels import vegas_sums as vs

    family = integrands.PARAM_REGISTRY[VEGAS_POOL["integrand"]]
    d = VEGAS_POOL["d"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vs.reset_launch_count()
    (results, sched, thetas), wall = _timed(lambda: serve_pool(cuda_devices(1)))
    launches = vs.launch_count()
    stats = sched.last_stats
    n_evals = sum(r.n_evals for r in results)
    row = dict(
        phase="vegas_pool", backend=sched.engine.backend, d=d, slots=VEGAS_POOL["batch_slots"],
        mc_samples=VEGAS_POOL["mc_samples"], rel_tol=VEGAS_POOL["rel_tol"],
        requests=len(results), wall_s=wall, requests_per_s=len(results) / wall,
        n_evals=n_evals, evals_per_s=n_evals / wall, iterations=stats["iterations"],
        dispatches=stats["dispatches"], launches=launches,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        statuses={s: sum(r.status == s for r in results) for s in {r.status for r in results}},
        largest_errors_off=max(abs(r.integral - family.exact(d, thetas[r.req_id])) / r.error
                               for r in results),
    )
    log(json.dumps(row))
    assert sched.engine.backend == "vegas" and len(results) == len(thetas), row
    for r in results:
        exact = family.exact(d, thetas[r.req_id])
        assert r.status in ("converged", "max_iters"), r
        assert abs(r.integral - exact) < 5 * r.error, (r, exact)
        assert r.n_evals == VEGAS_POOL["mc_samples"] * r.iterations, r
    # one sums launch per fleet iteration: some slot is live in every one
    assert launches == stats["iterations"] > 0, row
    return launches


def phase_graceful(phase9):
    """Phase 11b: phase 9's one-rank fleet served with graceful=True."""
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.kernels import genz_malik_eval as gm_kernel
    from repro_torch.kernels import vegas_sums as vs
    from repro_torch.launch.gm_perf import SERVICE, service_requests
    from repro_torch.service import serve

    gm_kernel.reset_launch_count()
    vs.reset_launch_count()
    results, wall = _timed(lambda: sorted(
        serve(QuadratureConfig(**SERVICE), service_requests(), devices=cuda_devices(1),
              graceful=True), key=lambda r: r.req_id))
    gm, mc = gm_kernel.launch_count(), vs.launch_count()
    evicted = [p.req_id for p in phase9 if p.status == "capacity"]
    rerouted = [r for r in results if r.attempts > 1]
    row = dict(phase="graceful", requests=len(results), wall_s=wall, gm_launches=gm,
               vegas_launches=mc, evicted_in_phase9=evicted,
               rerouted=[dict(req_id=r.req_id, status=r.status, backend=r.backend,
                              attempts=r.attempts, retried_from=r.retried_from,
                              iterations=r.iterations, integral=r.integral, error=r.error)
                         for r in rerouted])
    log(json.dumps(row))
    assert len(results) == len(phase9), row
    for r, p in zip(results, phase9):
        if p.status == "capacity":
            assert (r.backend, r.attempts, r.retried_from) == ("vegas", 2, "capacity"), r
        else:
            assert r == p, (r, p)
    assert [r.req_id for r in rerouted] == evicted, row
    assert gm > 0 and (mc > 0) == bool(evicted), row
    return gm, mc, len(evicted)


# --- the service's resilience (phase 12) ---------------------------------------

# snapshot cadence of 12a (admission ticks; phase 9's fleet has 49 ticks)
CRASH_EVERY = 16
# snapshot cadence of 12b, and its rank loss: rank 2 of 4 lost LOSS_AFTER
# iterations after the first snapshot, back HEAL_AFTER iterations later
LOSS_EVERY, LOSS_AFTER, HEAL_AFTER = 20, 3, 8


def _snapshot_dir():
    """A fresh directory under the checkout's build/ (gitignored)."""
    import tempfile

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    return tempfile.mkdtemp(prefix="phase12_", dir=os.path.join(HERE, "build"))


def _timed_checkpointer(directory, keep):
    """A ServiceCheckpointer that logs the seconds of its saves and restores."""
    from repro_torch.service import ServiceCheckpointer

    class Timed(ServiceCheckpointer):
        def __init__(self, directory, keep):
            super().__init__(directory, keep=keep)
            self.save_s, self.restore_s = [], []

        def save(self, step, arrays, meta):
            t0 = time.perf_counter()
            super().save(step, arrays, meta)
            self.save_s.append(time.perf_counter() - t0)

        def restore(self, engine, step=None):
            t0 = time.perf_counter()
            out = super().restore(engine, step)
            torch.cuda.synchronize()
            self.restore_s.append(time.perf_counter() - t0)
            return out

        def restore_host(self, like, step=None):
            t0 = time.perf_counter()
            out = super().restore_host(like, step)
            self.restore_s.append(time.perf_counter() - t0)
            return out

    return Timed(directory, keep=keep)


def _snapshot_bytes(ckpt):
    """Bytes of the newest snapshot's arrays file on disk."""
    step = ckpt.manager.latest_step()
    return os.path.getsize(os.path.join(ckpt.manager.dir, f"step_{step:08d}", "arrays.npz"))


def phase_resilience(phase9, smi):
    """Phase 12 (see the docstring); returns the GM and sums launches."""
    import shutil

    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.kernels import genz_malik_eval as gm_kernel
    from repro_torch.kernels import vegas_sums as vs
    from repro_torch.launch.gm_perf import SERVICE, service_requests
    from repro_torch.service import BatchScheduler, chaos_selftest
    from repro_torch.service.faults import DeviceDown, SimulatedCrash, crash_at
    from repro_torch.service.sharded_selftest import tuples

    cfg = QuadratureConfig(**SERVICE)
    want = tuples(phase9)
    finished = sorted({r.finished_at for r in phase9})
    gm = mc = 0
    root = _snapshot_dir()
    try:
        log(f"phase 12: snapshots under {root}, disk free "
            f"{shutil.disk_usage(root).free / 1e9:.1f} GB")

        # --- 12a: crash after the second snapshot, resume --------------------
        ckpt = _timed_checkpointer(os.path.join(root, "a"), keep=1)
        ticks, crash = [], {}

        def hook(it, state, slot_req):
            # once the second snapshot is down, crash at the next iteration
            # at which phase 9 collected a result, so that results land
            # between the snapshot and the crash
            ticks.append(it)
            if len(ticks) + 1 == 2 * CRASH_EVERY:
                crash["at"] = next(f for f in finished if f > it)
            if "at" in crash:
                return crash_at(crash["at"])(it, state, slot_req)
            return None

        gm_kernel.reset_launch_count()
        crashing = BatchScheduler(cfg, devices=cuda_devices(1), checkpointer=ckpt,
                                  checkpoint_every=CRASH_EVERY, on_tick=hook)
        pre = []
        t0 = time.perf_counter()
        try:
            for r in crashing.serve(service_requests()):
                pre.append(r)
        except SimulatedCrash:
            pass
        else:
            raise AssertionError("phase 12a: the crash injector never fired")
        torch.cuda.synchronize()
        crash_wall = time.perf_counter() - t0
        snaps = crashing.last_stats["checkpoints"]
        nbytes = _snapshot_bytes(ckpt)
        resumed = BatchScheduler(cfg, devices=cuda_devices(1), checkpointer=ckpt)
        post, resume_wall = _timed(lambda: list(resumed.serve(service_requests(), resume=True)))
        gm += gm_kernel.launch_count()
        # the copies to the host and back alone, on a fleet of the same size
        # (save_s is the CRC and the write, restore_s the read, the CRC and
        # the copy back)
        engine = resumed.engine
        host, to_host_s = _timed(lambda: engine.to_host(engine.init()))
        _, place_s = _timed(lambda: engine.place(host))
        del host
        by_id = {}
        for r in pre + post:
            t = tuples([r])[0]
            assert by_id.setdefault(r.req_id, t) == t, (by_id[r.req_id], t)
        replayed = len(pre) + len(post) - len(by_id)
        row = dict(phase="resilience_resume", card=smi, snapshots_before_crash=snaps,
                   crash_at=crash["at"], snapshot_step=ckpt.latest_step(),
                   snapshot_bytes=nbytes, save_s=ckpt.save_s, restore_s=ckpt.restore_s,
                   to_host_s=to_host_s, place_s=place_s,
                   crashed_run_wall_s=crash_wall, resumed_wall_s=resume_wall,
                   results_before_crash=len(pre), results_after_resume=len(post),
                   replayed=replayed, launches=gm)
        log(json.dumps(row))
        assert 1 <= snaps <= 2, row
        assert [by_id[k] for k in sorted(by_id)] == want, "phase 12a: the union is not phase 9's"
        assert replayed >= 1, row
        # per region row: centres and half-widths 16 d B, estimate and error
        # 16 B, axis 4 B, two flags 2 B (102 B at d = 5: 3.42 GB in all)
        assert nbytes >= SERVICE["batch_slots"] * SERVICE["capacity"] * (16 * SERVICE["d"] + 22), row

        # --- 12b: rank 2 of 4 lost after a snapshot, healed ------------------
        loss = ticks[LOSS_EVERY - 2] + LOSS_AFTER  # the it of tick LOSS_EVERY, plus
        ckpt = _timed_checkpointer(os.path.join(root, "b"), keep=1)
        gm_kernel.reset_launch_count()
        sched = BatchScheduler(
            cfg, devices=cuda_devices(4), checkpointer=ckpt, checkpoint_every=LOSS_EVERY,
            fault_injector=DeviceDown(device=2, at_tick=loss, restore_at_tick=loss + HEAL_AFTER),
            max_dispatch_retries=1, retry_backoff_s=0.0,
        )
        results, wall = _timed(lambda: sorted(sched.serve(service_requests()),
                                              key=lambda r: r.req_id))
        launches = gm_kernel.launch_count()
        gm += launches
        stats = sched.last_stats
        evacuated = [r for r in results if r.evacuated]
        row = dict(phase="resilience_rank_loss", card=smi, lost_at=loss,
                   healed_at=loss + HEAL_AFTER, wall_s=wall, launches=launches,
                   final_ranks=sched.engine.n_ranks, save_s=ckpt.save_s,
                   restore_s=ckpt.restore_s,
                   **{k: stats[k] for k in ("checkpoints", "dispatch_retries", "evacuations",
                                            "mesh_shrinks", "mesh_regrows", "iterations")},
                   evacuated={kind: sum(r.evacuated == kind for r in evacuated)
                              for kind in ("snapshot", "readmit")})
        log(json.dumps(row))
        assert len(results) == len(phase9), row
        assert stats["evacuations"] >= 1 and stats["mesh_shrinks"] == 1, row
        assert stats["mesh_regrows"] >= 1 and sched.engine.n_ranks == 4, row
        assert chaos_selftest.values(results) == chaos_selftest.values(phase9), [
            (a, b) for a, b in zip(results, phase9) if a.integral != b.integral][:2]
        family, requests = sched.engine.family, service_requests()
        for r in evacuated:
            assert r.evacuated in ("snapshot", "readmit"), r
            exact = family.exact(SERVICE["d"], requests[r.req_id].theta)
            budget = max(1e-16, abs(exact) * requests[r.req_id].rel_tol)
            assert abs(r.integral - exact) <= 10 * max(r.error, budget), (r, exact)
        del results, sched
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # --- 12c: the chaos self-test on the card ---------------------------------
    gm_kernel.reset_launch_count()
    vs.reset_launch_count()
    out, wall = _timed(lambda: chaos_selftest.run(4, "cuda"))
    gm += gm_kernel.launch_count()
    mc += vs.launch_count()
    log(json.dumps(dict(phase="chaos", card=smi, wall_s=wall, gm_launches=gm_kernel.launch_count(),
                        vegas_launches=vs.launch_count(), **out)))
    for scen in out["scenarios"].values():
        # the poisoned requests ended nonfinite on VEGAS after two attempts,
        # the healthy ones equal to the baseline (asserted in the self-test)
        assert scen["nan_injection"]["reroutes"] == 3 and scen["nan_injection"]["healthy_parity"]
    assert out["device_counts"] == [1, 2, 4] and out["elastic_restore"]["union_parity"], out
    return gm, mc


def phase_vegas_timing():
    """The sums kernel at SUMS_TIMED's three shapes (8 shards, 64 bins,
    float64): its time and its two launches', its plain version's,
    index_add_ alone, and the bound (gm_perf.time_sums)."""
    from repro_torch.kernels import vegas_sums as vs

    rows = []
    for label, d, samples, n_strat, problems in SUMS_TIMED:
        w, y, cum = sums_inputs(np.random.default_rng(4), d, samples, n_strat, problems)
        before = vs.launch_count()
        err = _sums_check(w, y, cum, 64, 0, samples // 8, f"timed {label}")
        row = dict(shape=label, **time_sums(w, y, cum, 64, 8), max_abs_err=err)
        # the check, 3 warm-ups and 20 timed calls, 20 profiled calls
        assert vs.launch_count() - before == 1 + 23 + 20, vs.launch_count() - before
        log("timing: " + json.dumps(row))
        rows.append(row)
        del w, y, cum
        torch.cuda.empty_cache()
    return rows


def main():
    smi = phase_device()
    phase_build()
    phase_kernel_vs_plain()
    launches, main_rows = phase_main_path()
    launches += phase_device_loop(main_rows)
    launches += phase_distributed(main_rows)
    phase_gauss_kronrod()
    timings = phase_timing()
    service_launches, phase9 = phase_service()
    launches += service_launches
    phase_vegas_kernel_vs_plain()
    vegas_launches, _ = phase_vegas()
    vegas_launches += phase_vegas_pool()
    gm_graceful, mc_graceful, _ = phase_graceful(phase9)
    launches += gm_graceful
    vegas_launches += mc_graceful
    gm_resilience, mc_resilience = phase_resilience(phase9, smi)
    launches += gm_resilience
    vegas_launches += mc_resilience
    vt, *others = phase_vegas_timing()
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
    sums = dict(
        name="vegas_sums", route="cuda", source="src/repro_torch/kernels/csrc/vegas_sums.cu",
        replaces="src/repro/mc/engine.py:196 (jax.ops.segment_sum; no TPU kernel)",
        launches=vegas_launches, max_abs_err=vt["max_abs_err"], ms=vt["ms"],
        plain_ms=vt["plain_ms"], bound_ms=vt["bound_ms"], bound_by=vt["bound_by"],
        library_ms=vt["library_ms"], chunk_ms=vt["chunk_ms"], combine_ms=vt["combine_ms"],
        at=f"d={vt['d']} N={vt['samples']} float64",
        other_shapes=[{k: r[k] for k in ("shape", "ms", "chunk_ms", "combine_ms", "plain_ms",
                                         "library_ms", "bound_ms", "max_abs_err")}
                      for r in others],
    )
    log(f"card: {smi}")
    log(json.dumps({"kernels": [kernel, sums]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
