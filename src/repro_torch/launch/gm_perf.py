"""Measure the fused GM kernel and the main path on the card.

    python src/repro_torch/launch/gm_perf.py time [--cases f4:5,genz_gaussian:8]
        [--batch 1048576] [--blocks 64,128,256,512] [--dtype float64] [--reps 50]
    python src/repro_torch/launch/gm_perf.py ptxas [--sass Li5E2F4]
    python src/repro_torch/launch/gm_perf.py profile [--trace-dir DIR] [--drivers integrate,device,distributed,service,vegas]
    python src/repro_torch/launch/gm_perf.py sums [--kernel-only]
    python src/repro_torch/launch/gm_perf.py sums-ablate
    python src/repro_torch/launch/gm_perf.py vegas

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
GPUs, capacity per rank as the case's), ``service`` (the batch service's
one-rank fleet of ``chip_smoke.py`` phase 9, :data:`SERVICE`, in place of
the three cases) and ``vegas`` (``integrate_vegas`` on the first of
:data:`VEGAS_CASES`, with its device time split by stage: sample + map,
integrand, reductions, refine, from the engine's named ranges).

``sums`` times the VEGAS sums kernel (``kernels.vegas_sums.vegas_sums``) at
the three shapes of :data:`SUMS_TIMED`: CUDA events per call, its chunk
and combine launches from ``torch.profiler``, the plain version,
``index_add_`` alone and the bound (:func:`time_sums`).  ``sums-ablate``
times the kernel whole and with its sums, then also its sort, cut out
(:data:`SUMS_ABLATIONS`, copies under ``build/ablate/``).  ``vegas`` runs
``chip_smoke.py`` phase 10a's cases (twice each) and phase 11a's pool and
prints their walls and the bits of their estimates.  Both use only entry
points the package has had since its VEGAS backend came, so, like
``time``, they measure another checkout put first on ``PYTHONPATH``.

Each result is one JSON line, with the card's name and power limit.
Needs a CUDA device; there is no CPU fallback.  ``chip_smoke.py`` shares the
cases and helpers of this file.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
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
# The batch service's fleet (chip_smoke.py phase 9): a parameter sweep of
# 192 Gaussians at d = 5 through 64 slots of 2^19 regions, tolerances
# striped by request index so that some ranks drain and migration fires.
SERVICE = dict(d=5, integrand="genz_gaussian", capacity=1 << 19, batch_slots=64,
               admit_every=1, sync_every=4, eval_window_min=256)
SERVICE_REQUESTS = 192
SERVICE_TOLS = (1e-3, 1e-7)  # rel_tol of even and odd request indices
TIMED_B = 1 << 20
# VEGAS cases of chip_smoke.py phase 10, at a high-dimension user's sizes:
# (integrand, d, mc_samples, rel_tol); a family's theta is sample_theta's
# draw from default_rng(0).  mc_shards 8, mc_max_iters 100, float64.
VEGAS_CASES = [
    ("genz_gaussian", 15, 1 << 22, 1e-4),
    ("genz_product_peak", 10, 1 << 22, 1e-4),
    ("f6", 9, 1 << 20, 1e-3),  # discontinuous: the chi^2 guard
]
# The VEGAS pool's fleet (phase 11a): 64 Gaussians at d = 10, thetas from
# sample_theta with seed 0, served with backend "auto" through 16 slots.
VEGAS_POOL = dict(d=10, integrand="genz_gaussian", backend="auto", batch_slots=16,
                  mc_samples=1 << 18, rel_tol=1e-3, mc_max_iters=60, sync_every=4)
VEGAS_POOL_REQUESTS = 64
# the engine's named ranges (mc/engine.py), in the order of an iteration
VEGAS_STAGES = ("vegas.sample_map", "vegas.integrand", "vegas.reduce", "vegas.refine")
# vegas_sums inputs where a stable in-chunk sort, the radix path (bins above
# 4096) or the unaligned loads could part from the plain version:
# name -> (d, bins, problems, shards given, shard0, samples per shard, cubes,
# dtype, y, w, aligned).  y "uniform", "const" (every sample of an axis in one
# bin) or "edges" (a third of them at 0, -0, 1, below 0, above 1, NaN or a
# bin edge); w "normal" or "nonfinite" (NaN, +-inf and -0.0 among them).
# Every case's cubes cut the iteration at random points (empty cubes too),
# "one_bin" has a single cube: one piece per chunk, the longest serial run.
SUMS_HARD_CASES = {
    "one_bin": (3, 64, 1, 2, 0, 2348, 1, torch.float64, "const", "normal", True),
    "y_edges": (4, 50, 2, 3, 1, 2500, 81, torch.float64, "edges", "normal", True),
    "w_nonfinite": (3, 64, 1, 4, 2, 1000, 27, torch.float64, "uniform", "nonfinite", True),
    "nb2": (5, 2, 1, 2, 0, 3000, 32, torch.float64, "edges", "normal", True),
    "nb300": (6, 300, 3, 2, 0, 4096, 64, torch.float64, "uniform", "normal", True),
    "nb4096": (3, 4096, 1, 2, 1, 2048, 27, torch.float64, "edges", "normal", True),
    "nb5000_radix": (9, 5000, 1, 2, 0, 1536, 512, torch.float64, "edges", "normal", True),
    "nb65535_radix": (2, 65535, 2, 1, 0, 2048, 4, torch.float64, "edges", "nonfinite", True),
    "odd_ns": (3, 64, 2, 3, 3, 777, 27, torch.float64, "edges", "normal", True),
    "unaligned": (4, 64, 1, 2, 0, 2048, 16, torch.float64, "uniform", "normal", False),
    "float32": (5, 50, 2, 2, 1, 3000, 243, torch.float32, "edges", "nonfinite", True),
    "float32_odd": (3, 300, 1, 2, 0, 1030, 27, torch.float32, "const", "normal", True),
}
# vegas_sums at the main path's shapes: (label, d, samples per problem,
# strata per axis, problems), 8 shards, 64 bins, float64: phase 10's first
# case (2^15 cubes), its f6 case (3^9 cubes) and phase 11a's pool (16 slots,
# 2^10 cubes); the strata are choose_n_strat's at mc_min_per_cube 4.
SUMS_TIMED = [
    ("genz_gaussian d=15", 15, 1 << 22, 2, 1),
    ("f6 d=9", 9, 1 << 20, 3, 1),
    ("pool d=10", 10, 1 << 18, 2, 16),
]
# H100 SXM peaks (NVIDIA data sheet): FP64 outside the tensor cores (an FMA
# counted as two operations), HBM3.
PEAK_FP64_FLOPS = 34e12
PEAK_HBM_BYTES = 3.35e12
_Y_EDGES = (0.0, -0.0, 1.0, -0.3, -1e-300, 1.5, 3.0, float("nan"), 1.0 - 2.0**-53, 0.02, 0.5)
# Device events by kind, first match of a word in the event's name: the GM
# kernel, then the advance's sorts, gathers, copies, reductions (the tree
# sums and the classifier's counts) and, left over, elementwise kernels.
KINDS = [
    ("gm_kernel", ("gm_eval_kernel",)),
    ("vegas_sums", ("vegas_sums",)),
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


def service_requests():
    """The fleet's requests: thetas drawn in order from one generator
    seeded 0, rel_tol striped by index."""
    from repro_torch.core.integrands import PARAM_REGISTRY
    from repro_torch.service import QuadRequest

    family = PARAM_REGISTRY[SERVICE["integrand"]]
    rng = np.random.default_rng(0)
    return [
        QuadRequest(req_id=i, theta=family.sample_theta(SERVICE["d"], rng),
                    rel_tol=SERVICE_TOLS[i % 2])
        for i in range(SERVICE_REQUESTS)
    ]


def serve_fleet(devices):
    """Serve the fleet on ``devices`` (one per rank); returns the results
    by req_id and the scheduler."""
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.service import BatchScheduler

    sched = BatchScheduler(QuadratureConfig(**SERVICE), devices=devices)
    results = sorted(sched.serve(service_requests()), key=lambda r: r.req_id)
    return results, sched


def vegas_case(name, d, samples, rel_tol):
    """``(cfg, exact)`` of one of :data:`VEGAS_CASES`."""
    from repro_torch.core import integrands
    from repro_torch.core.config import QuadratureConfig

    if name in integrands.PARAM_REGISTRY:
        family = integrands.PARAM_REGISTRY[name]
        theta = family.sample_theta(d, np.random.default_rng(0))
        spec, exact = integrands.to_spec(family, theta), family.exact(d, theta)
    else:
        spec, exact = name, integrands.REGISTRY[name].exact(d)
    cfg = QuadratureConfig(d=d, integrand=spec, rel_tol=rel_tol, backend="vegas",
                           mc_samples=samples, mc_max_iters=100)
    return cfg, exact


def sums_hard_case(name, device="cpu"):
    """``(w, y, cum, nb, shard0, ns)`` of :data:`SUMS_HARD_CASES` ``name`` on
    ``device``, from a seed; an unaligned case's w and y start one element
    into their storage (so the kernel takes its scalar loads)."""
    d, nb, problems, shards, shard0, ns, m, dtype, ykind, wkind, aligned = SUMS_HARD_CASES[name]
    rng = np.random.default_rng(sorted(SUMS_HARD_CASES).index(name))
    n, total = shards * ns, (shard0 + shards + 1) * ns
    cuts = np.sort(rng.integers(0, total + 1, (problems, m - 1)), axis=1)
    cum = np.concatenate([cuts, np.full((problems, 1), total)], axis=1)
    w = rng.normal(size=(problems, n)) * np.exp(rng.normal(size=(problems, n)))
    if wkind == "nonfinite":
        for v in (float("nan"), float("inf"), float("-inf"), -0.0):
            w.reshape(-1)[rng.choice(w.size, 3, replace=False)] = v
    y = rng.uniform(size=(d, problems, n))
    if ykind == "const":
        y[:] = rng.uniform(size=(d, 1, 1))
    elif ykind == "edges":
        pick = rng.uniform(size=y.shape) < 1 / 3
        y[pick] = rng.choice(_Y_EDGES, size=int(pick.sum()))

    def put(a):
        t = torch.as_tensor(a, dtype=dtype)
        if aligned:
            return t.to(device)
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=device)
        return buf[1:].view(t.shape).copy_(t)

    return put(w), put(y), torch.as_tensor(cum, device=device), nb, shard0, ns


def bits_equal(a, b):
    """Equal bit for bit (so +0 is not -0), NaN where NaN: a NaN's payload
    is the device's own."""
    nan = torch.isnan(a)
    ints = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0, a).view(ints), torch.where(nan, 0, b).view(ints))


def sums_inputs(rng, d, n_samples, n_strat, problems=1, dtype=torch.float64):
    """Inputs of one vegas_sums call on the card: w (P, N), y (d, P, N),
    cum (P, M), with per-cube counts from skewed weights (as adapted counts
    are)."""
    from repro_torch.mc import stratified

    m = n_strat**d
    weights = torch.as_tensor(rng.uniform(size=(problems, m)) ** 3)
    counts = stratified.allocate_counts(weights, n_samples, 4)
    cum = torch.cumsum(counts, dim=-1).cuda()
    w = torch.as_tensor(rng.normal(size=(problems, n_samples)) * np.exp(rng.normal(size=(problems, n_samples))),
                        dtype=dtype, device="cuda")
    y = torch.rand((d, problems, n_samples), dtype=dtype, device="cuda")
    return w, y, cum


def time_sums(w, y, cum, nb, shards, reps=20, kernel_only=False):
    """vegas_sums on whole shards of ``(w, y, cum)``: the kernel's ms per
    call (CUDA events) and its two launches' (torch.profiler's kernel
    durations over ``reps`` calls: names with "chunk" and "combine"), the
    plain version's, the three index_add_ alone on ids computed beforehand
    (the library's part), and the bound: the larger of the bytes read and
    written once over the HBM rate and the FP64 operations over the FP64
    rate.  ``kernel_only``: the kernel's three times alone."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import vegas_sums as vs

    d, (P, N), m = y.shape[0], w.shape, cum.shape[1]
    ns = N // shards
    run = lambda: vs.vegas_sums(w, y, cum, nb, 0, ns)  # noqa: E731
    ms = time_ms(run, reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    split = {"chunk": 0.0, "combine": 0.0}
    for evt in prof.key_averages():
        for part in split:
            if part in evt.key:
                split[part] += evt.self_device_time_total / 1e3 / reps
    if kernel_only:
        return dict(ms=ms, chunk_ms=split["chunk"], combine_ms=split["combine"])
    plain_ms = time_ms(lambda: vs.vegas_sums_ref(w, y, cum, nb, 0, ns), 3)
    index = torch.arange(N, device="cuda")
    row = torch.arange(P, device="cuda")[:, None] * shards + index // ns  # (P, N)
    ids = (row * m + torch.searchsorted(cum, index.expand(P, N).contiguous(), right=True)).reshape(-1)
    b = torch.clamp((y * nb).long(), 0, nb - 1)
    bin_ids = ((row[None] * d + torch.arange(d, device="cuda")[:, None, None]) * nb + b).reshape(-1)
    w1 = w.reshape(-1)
    w2 = w1 * w1
    w2d = w2.expand(d, P * N).reshape(-1)

    def library():
        torch.zeros(P * shards * m, dtype=w.dtype, device="cuda").index_add_(0, ids, w1)
        torch.zeros(P * shards * m, dtype=w.dtype, device="cuda").index_add_(0, ids, w2)
        torch.zeros(P * shards * d * nb, dtype=w.dtype, device="cuda").index_add_(0, bin_ids, w2d)

    library_ms = time_ms(library, 5)
    # read w, y and cum once, write s1, s2 and g once; FP64 operations: a
    # sum and a square-and-sum per sample, and per (axis, sample) the
    # y * nb and the matching bin's square-and-sum
    size = w.element_size()
    bytes_moved = size * (P * N + d * P * N + 2 * P * shards * m + P * shards * d * nb) + 8 * P * m
    ops = 3 * P * N + 3 * d * P * N
    bytes_ms = bytes_moved / PEAK_HBM_BYTES * 1e3
    ops_ms = ops / PEAK_FP64_FLOPS * 1e3
    return dict(d=d, problems=P, samples=N, shards=shards, cubes=m, bins=nb,
                dtype=str(w.dtype).split(".")[-1], ms=ms, chunk_ms=split["chunk"],
                combine_ms=split["combine"], plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", bytes=bytes_moved,
                ops=ops)


def pool_thetas():
    from repro_torch.core.integrands import PARAM_REGISTRY

    family = PARAM_REGISTRY[VEGAS_POOL["integrand"]]
    rng = np.random.default_rng(0)
    return [family.sample_theta(VEGAS_POOL["d"], rng) for _ in range(VEGAS_POOL_REQUESTS)]


def serve_pool(devices):
    """Serve the VEGAS pool's fleet; returns the results by req_id, the
    scheduler and the thetas."""
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.service import BatchScheduler, QuadRequest

    thetas = pool_thetas()
    sched = BatchScheduler(QuadratureConfig(**VEGAS_POOL), devices=devices)
    results = sorted(sched.serve(QuadRequest(req_id=i, theta=t) for i, t in enumerate(thetas)),
                     key=lambda r: r.req_id)
    return results, sched, thetas


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
    from repro_torch.mc import integrate_vegas

    drivers = {
        "integrate": lambda cfg: adaptive.integrate(cfg, device="cuda"),
        "device": lambda cfg: adaptive.integrate_device(cfg, device="cuda"),
        "distributed": lambda cfg: integrate_distributed(cfg, devices=cuda_devices(4)),
    }
    class Fleet:  # the service's run, read like a driver's result
        def __init__(self, devices):
            results, sched = serve_fleet(devices)
            self.iterations = sched.last_stats["iterations"]
            self.n_evals = sum(r.n_evals for r in results)
            self.host_syncs = self.iterations  # one stacked read per iteration

    drivers["service"] = lambda cfg: Fleet(cuda_devices(1))
    drivers["vegas"] = lambda cfg: integrate_vegas(cfg, device="cuda")
    vegas_cfg = vegas_case(*VEGAS_CASES[0])[0]
    own_case = {
        "service": [("service:" + SERVICE["integrand"], SERVICE["d"], None, SERVICE["capacity"])],
        "vegas": [(VEGAS_CASES[0][0], VEGAS_CASES[0][1], None, None)],
    }
    runs = [(driver, case) for driver in args.drivers
            for case in own_case.get(driver, MAIN_CASES)]
    smi = card()
    for driver, (name, d, rel_tol, capacity) in runs:
        run = drivers[driver]
        if driver in own_case:
            cfg = vegas_cfg if driver == "vegas" else None
        else:
            cfg = QuadratureConfig(d=d, integrand=name, rel_tol=rel_tol, capacity=capacity)
        run(cfg)  # build, allocate, warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
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
            # the VEGAS engine's named ranges also appear on the device, as
            # spans: they are not kernels
            if evt.device_type == DeviceType.CUDA and evt.key not in VEGAS_STAGES:
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
            **({"mc_samples": cfg.mc_samples, "peak_bytes": torch.cuda.max_memory_allocated(),
                **_stage_split(prof)} if driver == "vegas" else {}),
        )), flush=True)
        if total == 0.0:
            raise SystemExit("the profiler recorded no device time")


def cmd_sums(args):
    import repro_torch
    from repro_torch.kernels import vegas_sums as vs

    smi = card()
    for label, d, samples, n_strat, problems in SUMS_TIMED:
        w, y, cum = sums_inputs(np.random.default_rng(4), d, samples, n_strat, problems)
        row = dict(shape=label, **time_sums(w, y, cum, 64, 8, kernel_only=args.kernel_only),
                   package=repro_torch.__file__, card=smi)
        if hasattr(vs, "plan"):
            row["plan"] = vs.plan(w.dtype, 64)
        print(json.dumps(row), flush=True)
        del w, y, cum
        torch.cuda.empty_cache()


# Cuts of csrc/vegas_sums.cu that ``sums-ablate`` times beside the whole
# kernel (each gives wrong sums: timing only): name -> [(text, replacement)].
_NO_SUMS = ("    T* prow = partg + i * nb;\n",
            "    T* prow = partg + i * nb;\n    if (nb > 0) {\n      __syncwarp();\n      return;\n    }\n")
SUMS_ABLATIONS = {
    "no_sums": [_NO_SUMS],
    "bins_only": [_NO_SUMS, ("for (int pass = 0; pass < passes; ++pass) {",
                             "for (int pass = 0; pass < passes && nb < 0; ++pass) {")],
}


def cmd_sums_ablate(args):
    """The sums kernel whole and cut (SUMS_ABLATIONS), each in a copy of
    this package under build/ablate/, timed in turns (whole, cuts, cuts
    reversed, whole) by ``sums --kernel-only``."""
    import shutil
    from pathlib import Path

    import repro_torch

    src = Path(repro_torch.__file__).resolve().parents[1]
    dirs = {"whole": src}
    for name, edits in SUMS_ABLATIONS.items():
        copy = src.parent / "build" / "ablate" / name / "src"
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(src, copy, ignore=shutil.ignore_patterns("__pycache__"))
        cu = copy / "repro_torch" / "kernels" / "csrc" / "vegas_sums.cu"
        text = cu.read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"sums-ablate: {name}: {old!r} is not in {cu}")
            text = text.replace(old, new)
        cu.write_text(text)
        dirs[name] = copy
    for name in list(dirs) + list(dirs)[::-1]:
        env = dict(os.environ, PYTHONPATH=str(dirs[name]))
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "sums", "--kernel-only"],
                             env=env, capture_output=True, text=True, check=True).stdout
        for line in out.splitlines():
            print(json.dumps(dict(json.loads(line), cut=name)), flush=True)


def cmd_vegas(args):
    """Phases 10a and 11a's runs: each VEGAS case twice and the pool once,
    with walls and the estimates' bits."""
    import repro_torch
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.mc import integrate_vegas

    smi = card()
    for case in VEGAS_CASES:
        cfg, _ = vegas_case(*case)
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = integrate_vegas(cfg, device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(json.dumps(dict(case=case[0], d=case[1], wall_s=walls, iterations=res.iterations,
                              integral=res.integral.hex(), error=res.error.hex(),
                              package=repro_torch.__file__, card=smi)), flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, sched, _ = serve_pool(cuda_devices(1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bits = "".join(r.integral.hex() + r.error.hex() for r in results)
    print(json.dumps(dict(case="pool", d=VEGAS_POOL["d"], wall_s=wall,
                          iterations=sched.last_stats["iterations"],
                          estimates_sha256=hashlib.sha256(bits.encode()).hexdigest(),
                          package=repro_torch.__file__, card=smi)), flush=True)


def _stage_split(prof):
    """Device seconds of the kernels inside each of the engine's named
    ranges (a kernel belongs to the range whose device span holds its
    midpoint; the ctypes-launched sums kernel has no aten op to be charged
    to, so spans, not op trees, decide), and each range's device span."""
    from torch.autograd import DeviceType

    spans, kernels = [], []
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            item = (evt.time_range.start, evt.time_range.end, evt.name)
            (spans if evt.name in VEGAS_STAGES else kernels).append(item)
    by_stage = dict.fromkeys(VEGAS_STAGES + ("outside",), 0.0)
    for start, end, _ in kernels:
        mid = (start + end) / 2
        stage = next((name for lo, hi, name in spans if lo <= mid <= hi), "outside")
        by_stage[stage] += (end - start) / 1e6
    span_s = dict.fromkeys(VEGAS_STAGES, 0.0)
    for lo, hi, name in spans:
        span_s[name] += (hi - lo) / 1e6
    return {"kernel_s_by_stage": by_stage, "span_s_by_stage": span_s}


def _ints(s):
    return [int(v) for v in s.split(",")]


def _drivers(s):
    names = s.split(",")
    unknown = set(names) - {"integrate", "device", "distributed", "service", "vegas"}
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
    x2 = sub.add_parser("sums", help="vegas_sums at the main path's shapes (SUMS_TIMED)")
    x2.add_argument("--kernel-only", action="store_true",
                    help="the kernel's times alone (no plain version, no index_add_)")
    sub.add_parser("sums-ablate", help="vegas_sums whole and cut (SUMS_ABLATIONS), in turns")
    sub.add_parser("vegas", help="walls and estimate bits of phases 10a and 11a")
    p = sub.add_parser("profile", help="torch.profiler breakdown of the main path")
    p.add_argument("--trace-dir", default=None, help="write Chrome traces here")
    p.add_argument("--drivers", type=_drivers, default=["integrate"],
                   help="comma-separated: integrate, device, distributed, service, vegas")
    args = ap.parse_args(argv)
    if args.cmd != "ptxas" and not torch.cuda.is_available():
        raise SystemExit("gm_perf: no CUDA device; this tool measures the card only")
    {"time": cmd_time, "ptxas": cmd_ptxas, "profile": cmd_profile, "sums": cmd_sums,
     "sums-ablate": cmd_sums_ablate, "vegas": cmd_vegas}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
