"""Measure the fused GM kernel and the main path on the card.

    python src/repro_torch/launch/gm_perf.py time [--cases f4:5,genz_gaussian:8]
        [--batch 1048576] [--blocks 64,128,256,512] [--dtype float64] [--reps 50]
    python src/repro_torch/launch/gm_perf.py ptxas [--sass Li5E2F4]
    python src/repro_torch/launch/gm_perf.py profile [--trace-dir DIR] [--drivers integrate,device,distributed]

``time`` times the kernel wrapper (``kernels.genz_malik_eval.genz_malik_eval_soa``)
with CUDA events on SoA inputs, for each case (integrand:d), batch size and
block size given; by default the two shapes that ``chip_smoke.py`` reports
(f4 d=5 and genz_gaussian d=8, float64, B = 2^20).  It uses only that
wrapper, whose signature has not changed since the port began, so the same
file times another checkout of the package: put that checkout's ``src``
first on ``PYTHONPATH`` and run this file by path.

``ptxas`` builds the kernels and prints each instantiation's registers and
spill bytes by type, integrand and D, from the build's ``-Xptxas -v``
report, with the build's seconds; with ``--sass NAME`` also the SASS opcode
counts (``cuobjdump -sass``) of the kernels whose mangled name contains
NAME (e.g. ``Li5E2F4``).

``profile`` runs the three main-path cases once to build and warm up, once
under the host clock, and once under ``torch.profiler``, and splits the
profiled run's wall time into the GM kernel, the other device work (the
advance: sort, gathers, tree sums, classify) and the time the device sat
idle (host gaps).  ``--drivers`` picks the drivers, each on every case:
``integrate`` (the default), ``device`` (``integrate_device``) and
``distributed`` (``integrate_distributed`` on four ranks over the visible
GPUs, capacity per rank as the case's).

Each result is one JSON line, with the card's name and power limit.
Needs a CUDA device; there is no CPU fallback.  ``chip_smoke.py`` shares the
cases and helpers of this file.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

MAIN_CASES = [
    # (integrand, d, rel_tol, capacity)
    ("f4", 5, 1e-7, 1 << 22),
    # rel_tol 1e-5, one decade above 1e-6: at 1e-6 the 2^22 store fills and
    # the run ends with status "capacity" (PERF.md §4)
    ("genz_gaussian:" + ",".join(["5"] * 8) + ":" + ",".join(["0.5"] * 8), 8, 1e-5, 1 << 22),
    ("f6", 5, 1e-4, 1 << 22),
]
TIMED = [("f4", 5), ("genz_gaussian", 8)]
TIMED_B = 1 << 20
# Device events by kind, first match of a word in the event's name: the GM
# kernel, then the advance's sorts, gathers, copies, reductions (the tree
# sums and the classifier's counts) and, left over, elementwise kernels.
KINDS = [
    ("gm_kernel", ("gm_eval_kernel",)),
    ("sort", ("Sort", "sort")),
    ("gather_index", ("gather", "index")),
    ("copy_fill", ("Memcpy", "Memset", "copy", "Fill")),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
]


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def inputs(name, d, b, rng, device="cuda"):
    """Random regions in the store's AoS layout: (entry, centers (b, d),
    halfw (b, d), theta or None), float64."""
    from repro_torch.core import integrands

    centers = torch.as_tensor(rng.uniform(0.1, 0.9, (b, d)), device=device)
    halfw = torch.as_tensor(rng.uniform(0.01, 0.1, (b, d)), device=device)
    if name in integrands.PARAM_REGISTRY:
        entry = integrands.PARAM_REGISTRY[name]
        return entry, centers, halfw, entry.sample_theta(d, rng)
    return integrands.REGISTRY[name], centers, halfw, None


def soa(entry, centers, halfw, theta):
    """The kernel wrapper's inputs, as kernels/ops.py builds them: SoA
    (d, B) centres and half-widths and, for a family, its theta rows as a
    broadcast view (lane stride 0), in the dtype of ``centers``."""
    ct, ht = centers.T.contiguous(), halfw.T.contiguous()
    if theta is None:
        return ct, ht, None
    rows = torch.cat([torch.as_tensor(theta[k], dtype=ct.dtype, device=ct.device)
                      for k in entry.theta_fields])
    return ct, ht, rows[:, None].expand(-1, ct.shape[1])


def time_ms(fn, reps):
    """Mean ms per call over ``reps`` calls, with CUDA events, after 3 warm-ups."""
    for _ in range(3):
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


def cmd_ptxas(args):
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build_all(("genz_malik_eval",))["genz_malik_eval"]
    seconds = time.perf_counter() - t0
    rows = {}
    for (dtype, name, d), (regs, st, ld, _) in sorted(build.ptxas_report(built.log).items()):
        row = rows.setdefault((dtype, name), dict(dtype=dtype, integrand=name, registers=[],
                                                  spill_bytes=[]))
        row["registers"].append(regs)
        row["spill_bytes"].append(st + ld)
    for row in rows.values():
        print(json.dumps(dict(row, D="1..16", build_s=seconds)), flush=True)
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", str(built.path)], capture_output=True,
                              text=True, check=True).stdout
        for fn in sass.split("Function : ")[1:]:
            name = fn.split("\n", 1)[0].strip()
            if any(want in name for want in args.sass):
                ops = collections.Counter(
                    m.group(1).split(".")[0]
                    for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", fn))
                print(json.dumps(dict(kernel=name, instructions=sum(ops.values()),
                                      opcodes=dict(ops.most_common()))), flush=True)


def cmd_time(args):
    import repro_torch
    from repro_torch.kernels import genz_malik_eval as gm_kernel

    dtype = {"float64": torch.float64, "float32": torch.float32}[args.dtype]
    where = repro_torch.__file__
    smi = card()
    for name, d in args.cases:
        for b in args.batch:
            entry, c, h, theta = inputs(name, d, b, np.random.default_rng(1))
            ct, ht, rows = soa(entry, c.to(dtype), h.to(dtype), theta)
            for block in args.blocks:
                ms = time_ms(lambda: gm_kernel.genz_malik_eval_soa(
                    entry.kernel_id, ct, ht, rows, block_regions=block), args.reps)
                print(json.dumps(dict(integrand=name, d=d, B=b, dtype=args.dtype,
                                      block=block, ms=ms, package=where, card=smi)), flush=True)


def cmd_profile(args):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import adaptive
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.distributed import integrate_distributed
    from repro_torch.core.ranks import cuda_devices

    drivers = {
        "integrate": lambda cfg: adaptive.integrate(cfg, device="cuda"),
        "device": lambda cfg: adaptive.integrate_device(cfg, device="cuda"),
        "distributed": lambda cfg: integrate_distributed(cfg, devices=cuda_devices(4)),
    }
    smi = card()
    for driver, (name, d, rel_tol, capacity) in itertools.product(args.drivers, MAIN_CASES):
        run = drivers[driver]
        cfg = QuadratureConfig(d=d, integrand=name, rel_tol=rel_tol, capacity=capacity)
        run(cfg)  # build, allocate, warm up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(cfg)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the device's own events (kernels, copies, memsets); the aten ops
        # that launch them report the same time again, so they are skipped
        kernels = {}
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA:
                kernels[evt.key] = kernels.get(evt.key, 0.0) + evt.self_device_time_total
        total = sum(kernels.values()) / 1e6
        by_kind = {}
        for key, us in kernels.items():
            kind = next((k for k, words in KINDS if any(w in key for w in words)), "other")
            by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e6
        gm = by_kind.get("gm_kernel", 0.0)
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
        case = name.split(":")[0]
        if args.trace_dir:
            prof.export_chrome_trace(f"{args.trace_dir}/{driver}_{case}_d{d}.json")
        print(json.dumps(dict(
            driver=driver, case=case, d=d, iterations=res.iterations, n_evals=res.n_evals,
            host_syncs=res.host_syncs,
            wall_s=wall_plain, profiled_wall_s=wall, device_busy_s=total,
            gm_kernel_s=gm, other_device_s=total - gm, idle_s=wall - total,
            gm_share=gm / wall, advance_share=(total - gm) / wall,
            idle_share=(wall - total) / wall, device_s_by_kind=by_kind,
            top_kernels=[(k[:80], v / 1e6) for k, v in top], card=smi,
        )), flush=True)
        if total == 0.0:
            raise SystemExit("the profiler recorded no device time")


def _ints(s):
    return [int(v) for v in s.split(",")]


def _drivers(s):
    names = s.split(",")
    unknown = set(names) - {"integrate", "device", "distributed"}
    if unknown:
        raise argparse.ArgumentTypeError(f"unknown drivers {sorted(unknown)}")
    return names


def _cases(s):
    return [(name, int(d)) for name, d in (c.split(":") for c in s.split(","))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("time", help="kernel ms per case, batch size and block size")
    t.add_argument("--cases", type=_cases, default=TIMED, help="integrand:d,...")
    t.add_argument("--batch", type=_ints, default=[TIMED_B], help="regions per launch")
    t.add_argument("--blocks", type=_ints, default=[0],
                   help="threads per block (0 = the wrapper's default)")
    t.add_argument("--dtype", choices=("float64", "float32"), default="float64")
    t.add_argument("--reps", type=int, default=50)
    x = sub.add_parser("ptxas", help="registers and spills of every instantiation")
    x.add_argument("--sass", action="append", default=[],
                   help="print the SASS opcode counts of kernels whose name contains this")
    p = sub.add_parser("profile", help="torch.profiler breakdown of the main path")
    p.add_argument("--trace-dir", default=None, help="write Chrome traces here")
    p.add_argument("--drivers", type=_drivers, default=["integrate"],
                   help="comma-separated: integrate, device, distributed")
    args = ap.parse_args(argv)
    if args.cmd != "ptxas" and not torch.cuda.is_available():
        raise SystemExit("gm_perf: no CUDA device; this tool measures the card only")
    {"time": cmd_time, "ptxas": cmd_ptxas, "profile": cmd_profile}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
