"""Chip smoke run of the PyTorch/CUDA port: build, check, drive, time.

    python3 chip_smoke.py

Needs one CUDA device (an H100: the kernels are built for sm_90a) and nvcc.
Phases, each of which passes or raises (a failure exits nonzero):

1. device: name, count, versions, nvidia-smi name and power limit;
2. build: nvcc on the port's CUDA sources, with each kernel
   instantiation's registers, spills and shared memory;
3. kernel vs its plain PyTorch version, on the card, for every integrand
   and family over d in {1,2,3,5,8,13} x B in {1, 257, 65536} and over
   block sizes, float64 at the bars of tests/test_kernels.py and float32
   against the float64 plain version;
4. main path: repro_torch.core.adaptive.integrate on the card at capacity
   2^22 in float64, three cases, each of which must converge to its exact
   value, with one kernel launch per evaluate step;
5. timings with CUDA events at the main path's window size.

It ends with one JSON line per kernel summary and, last, the device line.
"""

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): FP64 outside the tensor cores, HBM3.
PEAK_FP64_FLOPS = 34e12
PEAK_HBM_BYTES = 3.35e12

MAIN_CASES = [
    # (integrand, d, rel_tol, capacity)
    ("f4", 5, 1e-7, 1 << 22),
    # rel_tol 1e-5, one decade above 1e-6: at 1e-6 the 2^22 store fills and
    # the run ends with status "capacity" (PERF.md, PR 11)
    ("genz_gaussian:" + ",".join(["5"] * 8) + ":" + ",".join(["0.5"] * 8), 8, 1e-5, 1 << 22),
    ("f6", 5, 1e-4, 1 << 22),
]
TIMED = [("f4", 5), ("genz_gaussian", 8)]  # (integrand, d) at B = 2^20
TIMED_B = 1 << 20


def log(msg=""):
    print(msg, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    return smi


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build_all()
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    pat = re.compile(r"gm_eval_kernelI([df])(\d+)")
    for lib in built.values():
        name = None
        for line in lib.log.splitlines():
            if "Compiling entry function" in line:
                m = pat.search(line)
                if m:
                    n = int(m.group(2))
                    rest = line[m.end():]
                    name = ("float64 " if m.group(1) == "d" else "float32 ") + rest[:n]
            elif name and "spill stores" in line:
                spills = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            elif name and "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                smem = re.search(r"(\d+) bytes smem", line)
                log(f"  {name:<26} {regs} registers, "
                    + ", ".join(f"{n} B spill {kind}" for n, kind in spills)
                    + f", {smem.group(1) if smem else 0} B shared memory")
                name = None
    return built


def _inputs(name, d, b, rng, device="cuda"):
    from repro_torch.core import integrands

    centers = torch.as_tensor(rng.uniform(0.1, 0.9, (b, d)), device=device)
    halfw = torch.as_tensor(rng.uniform(0.01, 0.1, (b, d)), device=device)
    if name in integrands.PARAM_REGISTRY:
        entry = integrands.PARAM_REGISTRY[name]
        return entry, centers, halfw, entry.sample_theta(d, rng)
    return integrands.REGISTRY[name], centers, halfw, None


def _plain(entry, centers, halfw, theta):
    """The plain PyTorch version on the same CUDA tensors."""
    from repro_torch.kernels.ref import genz_malik_eval_soa_ref

    ct, ht = centers.T.contiguous(), halfw.T.contiguous()
    if theta is None:
        return genz_malik_eval_soa_ref(entry.fn, ct, ht)
    leaves = [torch.as_tensor(theta[k], dtype=ct.dtype, device=ct.device)
              for k in entry.theta_fields]
    rows = torch.cat(leaves)[:, None].expand(-1, ct.shape[1])
    sizes = [leaf.shape[0] for leaf in leaves]

    def fn(x, r):
        return entry.fn(x, dict(zip(entry.theta_fields, r.split(sizes))))

    return genz_malik_eval_soa_ref(fn, ct, ht, rows)


def _kernel(entry, centers, halfw, theta, block=0):
    from repro_torch.kernels import ops

    i7, i5, i3, diffs = ops.genz_malik_eval(entry, centers, halfw, theta=theta,
                                            block_regions=block)
    return i7, i5, i3, diffs.T


def _check64(got, ref, what):
    """The bars of tests/test_kernels.py; returns the largest relative error."""
    worst = 0.0
    for g, r, label in zip(got[:3], ref[:3], ("i7", "i5", "i3")):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-300, msg=lambda m: f"{what} {label}: {m}")
        worst = max(worst, float(((g - r).abs() / r.abs().clamp_min(1e-300)).max()))
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


def phase_kernel_vs_plain():
    from repro_torch.core import integrands
    from repro_torch.kernels import genz_malik_eval as gm_kernel

    names = sorted(integrands.REGISTRY) + sorted(integrands.PARAM_REGISTRY)
    rng = np.random.default_rng(0)
    before = gm_kernel.launch_count()
    worst64 = worst32 = 0.0
    n_checks = overflowed = 0
    t0 = time.perf_counter()
    for d in (1, 2, 3, 5, 8, 13):
        for b in (1, 257, 65536):
            for name in names:
                entry, c, h, theta = _inputs(name, d, b, rng)
                ref = _plain(entry, c, h, theta)
                got = _kernel(entry, c, h, theta)
                worst64 = max(worst64, _check64(got, ref, f"{name} d={d} B={b} float64"))
                got32 = _kernel(entry, c.float(), h.float(), theta)
                ref32 = _plain(entry, c.float(), h.float(), theta)
                share, n_overflow = _check32(got32, ref32, ref, h, f"{name} d={d} B={b}")
                worst32 = max(worst32, share)
                overflowed += n_overflow
                n_checks += 2
    for block in (32, 64, 128, 512):
        for name in names:
            entry, c, h, theta = _inputs(name, 3, 192, rng)
            worst64 = max(worst64, _check64(_kernel(entry, c, h, theta, block),
                                            _plain(entry, c, h, theta),
                                            f"{name} block={block}"))
            n_checks += 1
    torch.cuda.synchronize()
    launched = gm_kernel.launch_count() - before
    assert launched == n_checks, (launched, n_checks)
    log(f"kernel vs plain: {n_checks} checks passed in {time.perf_counter() - t0:.1f} s; "
        f"largest relative error float64 {worst64:.3e} (bar 1e-12); "
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
            exact=exact, true_rel_err=rel,
        )
        log(json.dumps(row))
        assert res.status == "converged", row
        assert rel <= 5 * rel_tol, row
        assert launches == len(windows) > 0, row
        total += launches
        rows.append(row)
    return total, rows


def _time(fn, reps):
    for _ in range(3):  # warm-up
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _ops_per_region(name, d):
    """Least arithmetic per region, counting exp as one operation: every
    node costs the integrand's per-point work, plus the weighted sums."""
    from repro_torch.core.genz_malik import n_nodes

    per_point = {"f4": 3 * d + 2, "genz_gaussian": 4 * d + 2}[name]
    return n_nodes(d) * per_point + 4 * d + 20


def phase_timing():
    from repro_torch.kernels import genz_malik_eval as gm_kernel

    rng = np.random.default_rng(1)
    out = []
    for name, d in TIMED:
        entry, c, h, theta = _inputs(name, d, TIMED_B, rng)
        before = gm_kernel.launch_count()
        got = _kernel(entry, c, h, theta)
        ref = _plain(entry, c, h, theta)
        _check64(got, ref, f"{name} d={d} B={TIMED_B}")
        max_abs = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        ms = _time(lambda: _kernel(entry, c, h, theta), 50)
        plain_ms = _time(lambda: _plain(entry, c, h, theta), 20)
        assert gm_kernel.launch_count() - before == 1 + 3 + 50
        bytes_moved = (2 * d + 3 + d) * TIMED_B * 8
        ops = _ops_per_region(name, d) * TIMED_B
        bytes_ms = bytes_moved / PEAK_HBM_BYTES * 1e3
        ops_ms = ops / PEAK_FP64_FLOPS * 1e3
        row = dict(integrand=name, d=d, B=TIMED_B, dtype="float64", ms=ms,
                   plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   bytes=bytes_moved, ops=ops, max_abs_err=max_abs,
                   library_ms=None)
        log("timing: " + json.dumps(row))
        out.append(row)
    return out


def main():
    smi = phase_device()
    phase_build()
    phase_kernel_vs_plain()
    launches, _ = phase_main_path()
    timings = phase_timing()
    t = timings[0]
    kernel = dict(
        name="genz_malik_eval", route="cuda",
        source="src/repro_torch/kernels/csrc/genz_malik_eval.cu",
        replaces="src/repro/kernels/genz_malik_eval.py:44",
        launches=launches, max_abs_err=t["max_abs_err"], ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=None,
        at=f"{t['integrand']} d={t['d']} B={t['B']} float64",
    )
    log(f"card: {smi}")
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
