"""Measure the fused GM kernel and the main path on the card.

    python src/repro_torch/launch/gm_perf.py time [--cases f4:5,genz_gaussian:8]
        [--batch 1048576] [--blocks 64,128,256,512] [--dtype float64] [--reps 50]
    python src/repro_torch/launch/gm_perf.py ptxas [--sass Li5E2F4]
    python src/repro_torch/launch/gm_perf.py profile [--trace-dir DIR] [--drivers integrate,device,distributed,service,pool,vegas]
        [--sync-every K] [--repeat N]
    python src/repro_torch/launch/gm_perf.py ops [--sync-every K] [--device cuda]
    python src/repro_torch/launch/gm_perf.py interleave --trees DIR,DIR,. [--rounds 3]
        [--repeat 5] [--out build/interleave.jsonl] [--walls-only]
    python src/repro_torch/launch/gm_perf.py sums [--kernel-only]
    python src/repro_torch/launch/gm_perf.py sums-ablate
    python src/repro_torch/launch/gm_perf.py vegas
    python src/repro_torch/launch/gm_perf.py round [--reps 200]

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

``profile`` runs the three main-path cases once to build and warm up,
``--repeat`` times under the host clock, and once under ``torch.profiler``, and splits the
profiled run's wall time into the GM kernel, the other device work (the
advance: sort, gathers, tree sums, classify) and the time the device sat
idle (host gaps).  ``--sync-every K`` sets the device and distributed
drivers' iterations per dispatch; a device or distributed row also gives
the evaluate steps or iterations begun past the stop and discarded, and
their device seconds (:func:`_discarded_split`), a distributed row the
rows evaluated against those of exact windows (:func:`_dispatch_split`).  ``--drivers`` picks the drivers, each on every case:
``integrate`` (the default), ``device`` (``integrate_device``) and
``distributed`` (``integrate_distributed`` on four ranks over the visible
GPUs, on :data:`DIST_CASES`, phase 6's), ``service`` (the batch service's
one-rank fleet of ``chip_smoke.py`` phase 9, :data:`SERVICE`, in place of
the three cases), ``pool`` (the VEGAS pool's fleet of phase 11a,
:data:`VEGAS_POOL`; its ``host_syncs`` are the engine's reads and waits,
and it uses only :func:`serve_pool`'s entry points, so it measures another
checkout put first on ``PYTHONPATH`` with this file run by path) and
``vegas`` (``integrate_vegas`` on the first of
:data:`VEGAS_CASES`, with its device time split by stage: sample + map,
integrand, reductions, refine, from the engine's named ranges).

``ops`` counts the torch operations that ``integrate_distributed``
enqueues per rank and iteration run, by phase (:func:`cmd_ops`): the
host's enqueue is what holds the four-rank walls.  On the CPU the round
is its plain version; ``--device cuda`` counts the card path, the round's
kernel launches (from their counter) included.  It uses only names the
distributed driver has had since its port, so it counts another checkout
put first on ``PYTHONPATH``.  ``interleave`` runs ``profile`` of several
checkouts in turns on one card (:func:`cmd_interleave`): unpack each
earlier tree's ``src`` under the gitignored ``build/`` first, e.g.
``git archive a2d6aa4 src | tar -x -C build/trees/a2d6aa4``.

``round`` times the whole redistribution round as the distributed driver
calls it, on four ranks of one card at ``chip_smoke.py`` phase 6's shape
(:data:`ROUND_TIMED`, :func:`time_round_call`): ms a round by CUDA events,
the host's seconds, the device time and operations a round by name.  It
uses only names the package has had since the round's first port, so it
times another checkout put first on ``PYTHONPATH``.

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
cases and helpers of this file.  The card's rates and name come from
``repro_torch.perf.machine``; a checkout from before that module, put first
on ``PYTHONPATH``, gets the same data-sheet rates from :data:`_H100_SXM`.
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

# The rates of perf/machine.py's h100-sxm preset that this file reads, for a
# parent-vs-change run against a checkout that has no repro_torch.perf (the
# tests hold the two equal).
_H100_SXM = {"fp64_vector_flops": 34e12, "mem_bw": 3.35e12}

try:
    from repro_torch.perf.machine import PRESETS, card
except ImportError:
    PRESETS = {"h100-sxm": _H100_SXM}

    def card() -> str:
        """The cards' names and power limits, as nvidia-smi reports them."""
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()

MAIN_CASES = [
    # (integrand, d, rel_tol, capacity)
    ("f4", 5, 1e-7, 1 << 22),
    # rel_tol 1e-5, one decade above 1e-6: at 1e-6 the 2^22 store fills and
    # the run ends with status "capacity" (PERF.md §4)
    ("genz_gaussian:" + ",".join(["5"] * 8) + ":" + ",".join(["0.5"] * 8), 8, 1e-5, 1 << 22),
    ("f6", 5, 1e-4, 1 << 22),
]
# chip_smoke.py phase 6's cases, the distributed driver's in ``profile``:
# (integrand, d, rel_tol, redistribution), four ranks, capacity 2^22 per
# rank (each GPU holds its own store, as in the paper)
DIST_CASES = [
    ("f4", 5, 1e-7, "ring"),
    (MAIN_CASES[1][0], 8, 1e-5, "ring"),  # the theta path on every rank
    ("f6", 5, 1e-4, "ring"),
    ("f6", 5, 1e-4, "off"),
]
DIST_CAPACITY = 1 << 22
TIMED = [("f4", 5), ("genz_gaussian", 8)]
# The batch service's fleet (chip_smoke.py phase 9): a parameter sweep of
# 192 Gaussians at d = 5 through 64 slots of 2^19 regions, tolerances
# striped by request index so that some ranks drain and migration fires.
SERVICE = dict(d=5, integrand="genz_gaussian", capacity=1 << 19, batch_slots=64,
               admit_every=1, sync_every=4, eval_window_min=256)
SERVICE_REQUESTS = 192
SERVICE_TOLS = (1e-3, 1e-7)  # rel_tol of even and odd request indices
# The Gauss-Kronrod fleet (chip_smoke.py phase 13b): 64 Gaussians at d = 3,
# thetas from sample_theta with default_rng(0), through 16 slots of 2^14.
GK_SERVICE = dict(d=3, integrand="genz_gaussian", rule="gauss_kronrod", rel_tol=1e-8,
                  capacity=1 << 14, batch_slots=16, sync_every=4)
GK_SERVICE_REQUESTS = 64
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
# H100 SXM peaks (NVIDIA data sheet, perf/machine.py's preset): FP64 outside
# the tensor cores (an FMA counted as two operations), HBM3.
PEAK_FP64_FLOPS = PRESETS["h100-sxm"]["fp64_vector_flops"]
PEAK_HBM_BYTES = PRESETS["h100-sxm"]["mem_bw"]
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


def serve_fleet(devices, **change):
    """Serve the fleet on ``devices`` (one per rank), with ``change`` to
    :data:`SERVICE`'s fields (e.g. ``admit_every=4``); returns the results
    by req_id and the scheduler."""
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.service import BatchScheduler

    sched = BatchScheduler(QuadratureConfig(**{**SERVICE, **change}), devices=devices)
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


def sums_hard_case(name, device):
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
    seen = {"chunk": 0, "combine": 0}
    for evt in prof.key_averages():
        for part in split:
            if part in evt.key:
                split[part] += evt.self_device_time_total / 1e3 / reps
                seen[part] += evt.count
    # late in a long process the profiler has been seen to record none of
    # the launches: that is "not measured", not 0 ms
    split = {part: ms if seen[part] else None for part, ms in split.items()}
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


# The redistribution round's kernels against their plain versions
# (chip_smoke.py phase 3b, tests/test_torch_gpu.py): every shift of
# make_schedule(n) at these rank counts, both float types, these d, in
# stores of ROUND_C rows, at a message cap below ROUND_C and one above; each
# case with every donor read in place and with every other donor staged.
ROUND_RANKS = (2, 3, 4, 8)
ROUND_DIMS = (3, 5, 8)
ROUND_C = 64
ROUND_CAPS = (8, 100)
# timed at phase 6's shape: four ranks, message cap 512, 2^22 rows a rank
ROUND_TIMED = dict(ranks=4, cap=512, capacity=1 << 22, dims=(5, 8))
# a store's per-row fields, in the order the round takes them
ROUND_FIELDS = ("centers", "halfw", "est", "err", "axis", "active", "fresh")


def round_stores(counts, C, d, dtype, seed):
    """One store per rank (:data:`ROUND_FIELDS`, CPU tensors of ``C`` rows)
    with ``counts[r]`` live rows on rank r: seeded values, a -0.0 and a NaN
    among the coordinates, half the live rows fresh."""
    rng = np.random.default_rng(seed)
    stores = []
    for k in counts:
        live = np.arange(C) < k
        centers = rng.uniform(0.1, 0.9, (C, d))
        halfw = rng.uniform(0.01, 0.1, (C, d))
        centers[rng.integers(0, C), rng.integers(0, d)] = -0.0
        halfw[rng.integers(0, C), rng.integers(0, d)] = np.nan
        arrays = dict(
            centers=centers, halfw=halfw,
            est=np.where(live, rng.normal(size=C), 0.0),
            err=np.where(live, rng.uniform(1e-6, 1.0, C), 0.0),
            axis=rng.integers(0, d, C).astype(np.int32), active=live,
            fresh=live & (rng.uniform(size=C) < 0.5),
        )
        stores.append({k: torch.from_numpy(v).to(dtype) if v.dtype == np.float64
                       else torch.from_numpy(v) for k, v in arrays.items()})
    return stores


def round_grid():
    """The check grid: ``(n, shift, dtype, d, cap, counts, seed)`` with, in
    every case, an empty rank, a rank full to the round's limit and (from
    three ranks) one full to the store, the rest at random below the limit."""
    from repro_torch.core.redistribution import make_schedule

    limit = 3 * ROUND_C // 4
    for n in ROUND_RANKS:
        for i, shift in enumerate(make_schedule(n)):
            for dtype in (torch.float64, torch.float32):
                for d in ROUND_DIMS:
                    for cap in ROUND_CAPS:
                        seed = ((n * 8 + i) * 2 + (dtype == torch.float32)) * 100 + d * 7 + cap
                        rng = np.random.default_rng(seed)
                        counts = rng.integers(0, limit + 1, n)
                        counts[seed % n] = 0
                        counts[(seed + 1) % n] = limit
                        if n > 2:
                            counts[(seed + 2) % n] = ROUND_C
                        yield n, shift, dtype, d, cap, counts.tolist(), seed


def round_vs_plain(n, shift, dtype, d, cap, counts, seed, C=ROUND_C, device="cuda",
                   staged=False):
    """One round of ``n`` ranks through the kernels on ``device`` and
    through their plain versions on the CPU, from the same stores, all in
    one launch: each rank's store, count after the round and rows sent, bit
    for bit.  ``staged``: every other donor (the odd ranks) is first packed
    into a block (one pack launch, the blocks checked bit for bit too), and
    its receiver reads the block, as a receiver on another device would.
    Returns the largest absolute difference of the blocks and stores (NaN
    against NaN counts 0) and the rows moved."""
    from repro_torch.kernels import redistribute_round as rk
    from repro_torch.kernels.ref import round_pack_ref, round_ref

    limit = 3 * C // 4
    P = min(cap, C)
    plain = round_stores(counts, C, d, dtype, seed)
    card = [{k: v.to(device, copy=True) for k, v in st.items()} for st in plain]
    counts_cpu = [torch.tensor(c, dtype=torch.int64) for c in counts]
    counts_card = [c.to(device, copy=True) for c in counts_cpu]
    worst = [0.0]

    def same(got, want, what):
        got = got.cpu()
        assert got.dtype == want.dtype and got.shape == want.shape, (what, got.shape, want.shape)
        ok = bits_equal(got, want) if got.is_floating_point() else torch.equal(got, want)
        assert ok, (what, n, shift, dtype, d, cap, counts, staged)
        if got.is_floating_point():
            both = torch.isnan(got) & torch.isnan(want)
            diff = torch.where(both, 0.0, got.double() - want.double()).abs()
            worst[0] = max(worst[0], float(diff.max()) if diff.numel() else 0.0)

    def coords(st):
        return st["centers"], st["halfw"]

    kernels = rk.RoundKernels()
    donors = list(range(1, n, 2)) if staged else []
    # NaN where nothing is written, so that a row the pack missed shows
    blocks_card = {u: torch.full((P, 2 * d), float("nan"), dtype=dtype, device=device)
                   for u in donors}
    blocks_plain = {u: torch.full((P, 2 * d), float("nan"), dtype=dtype) for u in donors}
    if donors:
        kernels.pack(counts_card, donors, shift, cap, limit, [coords(card[u]) for u in donors],
                     [blocks_card[u] for u in donors])
        round_pack_ref(counts_cpu, donors, shift, cap, limit, [coords(plain[u]) for u in donors],
                       [blocks_plain[u] for u in donors])
        for u in donors:
            same(blocks_card[u], blocks_plain[u], f"rank {u} block")

    def sources(blocks):  # the donor's block, or its index among the stores
        return [blocks.get((r - shift) % n, (r - shift) % n) for r in range(n)]

    after_k, sent_k = kernels.round(counts_card, range(n), shift, cap, limit,
                                    [tuple(st[f] for f in ROUND_FIELDS) for st in card],
                                    sources(blocks_card))
    after_p, sent_p = round_ref(counts_cpu, range(n), shift, cap, limit,
                                [tuple(st[f] for f in ROUND_FIELDS) for st in plain],
                                sources(blocks_plain))
    same(torch.stack(after_k + sent_k), torch.stack(after_p + sent_p), "counts")
    for r in range(n):
        for f in ROUND_FIELDS:
            same(card[r][f], plain[r][f], f"rank {r} {f}")
    return worst[0], sum(int(k) for k in sent_p)


def round_case(d, dtype=torch.float64, device="cuda"):
    """Four ranks on one device at :data:`ROUND_TIMED`'s shape: ``(ranks,
    states, counts)``, the counts C/2, C/8, C/4, C/4, so that at shift 1
    rank 0 sends a full message to rank 1 and no other rank moves."""
    from repro_torch.core.ranks import Ranks
    from repro_torch.core.region_store import RegionState

    n, C = ROUND_TIMED["ranks"], ROUND_TIMED["capacity"]
    counts = [C // 2, C // 8, C // 4, C // 4]
    gen = torch.Generator(device=device).manual_seed(d)

    def scalar(dt):
        return torch.zeros((), dtype=dt, device=device)

    states = []
    for k in counts:
        live = torch.arange(C, device=device) < k
        states.append(RegionState(
            centers=torch.rand((C, d), generator=gen, dtype=dtype, device=device),
            halfw=torch.rand((C, d), generator=gen, dtype=dtype, device=device) * 0.1,
            est=torch.rand(C, generator=gen, dtype=dtype, device=device) * live,
            err=torch.rand(C, generator=gen, dtype=dtype, device=device) * live,
            axis=torch.randint(0, d, (C,), generator=gen, device=device, dtype=torch.int32),
            active=live, fresh=live & (torch.rand(C, generator=gen, device=device) < 0.5),
            fin_integral=scalar(dtype), fin_error=scalar(dtype), n_evals=scalar(dtype),
            it=scalar(torch.int32), overflowed=scalar(torch.bool)))
    rows = [torch.tensor(k, dtype=torch.int64, device=device) for k in counts]
    return Ranks([device] * n), states, rows


def time_round_call(ranks, states, rows, reps=200):
    """The whole round as the distributed driver calls it
    (``redistribution.redistribute``, shift 1) on :func:`round_case`'s
    states: ms a round by CUDA events over ``reps`` rounds (the host's
    enqueue: the round is host-bound), the host's own seconds for the same
    enqueue, and from ``torch.profiler`` the device time a round and the
    device operations (kernels, copies) a round, by name.  It uses only
    names the package has had since the round's first port, so it times
    another checkout put first on ``PYTHONPATH`` (``round``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.redistribution import make_schedule, redistribute

    n, cap, C = ROUND_TIMED["ranks"], ROUND_TIMED["cap"], ROUND_TIMED["capacity"]
    schedule = make_schedule(n)

    def one():
        return redistribute(states, ranks, schedule=schedule, cap=cap, limit=3 * C // 4, it=0,
                            n_rows=rows)

    ms = time_ms(one, reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        one()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            one()
        torch.cuda.synchronize()
    device = [evt for evt in prof.key_averages() if evt.self_device_time_total > 0]
    return dict(ms=ms, host_ms=host_ms,
                device_us=sum(evt.self_device_time_total for evt in device) / reps,
                device_ops=sum(evt.count for evt in device) / reps,
                device_us_by_name={evt.key: evt.self_device_time_total / reps for evt in device})


def _profiled_us(fn, reps, name):
    """Device µs a call of ``fn`` in the kernels whose name holds ``name``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(evt.self_device_time_total for evt in prof.key_averages()
               if name in evt.key) / reps


def time_round(d, dtype=torch.float64, reps=200):
    """The round at phase 6's shape (:data:`ROUND_TIMED`, four ranks on one
    card, rank 0 sending ``cap`` rows to rank 1): one round first checked
    bit for bit against its plain version on CPU copies of the stores, then
    timed (:func:`time_round_call`), beside the plain version on the card
    (``round_ref``, all four ranks) and the byte bound: the counts and the
    rows this round moves, each read once and written once, at the HBM rate
    (the kernels do no floating-point work).  Also the pack alone, on rank
    0's block (it runs only where a receiver lives on another device), with
    its plain version and bound, and the launch floor: an empty kernel's ms
    a launch (CUDA events) and device µs (torch.profiler) on the same
    stream."""
    from repro_torch.core.redistribution import redistribute, round_counts
    from repro_torch.kernels import redistribute_round as rk
    from repro_torch.kernels.ref import round_pack_ref, round_ref

    n, cap, C = ROUND_TIMED["ranks"], ROUND_TIMED["cap"], ROUND_TIMED["capacity"]
    limit = 3 * C // 4
    P = min(cap, C)
    ranks, states, rows = round_case(d, dtype)
    counts = [int(k) for k in rows]
    n_send, n_recv = round_counts(counts, 1, cap, limit)
    assert n_send == [cap, 0, 0, 0] and n_recv == [0, cap, 0, 0], (n_send, n_recv)
    stores = [tuple(getattr(st, f) for f in ROUND_FIELDS) for st in states]
    plain = [tuple(t.cpu() for t in st) for st in stores]
    before = rk.launch_count("round")
    _, after, sent = redistribute(states, ranks, schedule=(1,), cap=cap, limit=limit, it=0,
                                  n_rows=rows)
    assert rk.launch_count("round") == before + 1
    sources = [(r - 1) % n for r in range(n)]  # each rank's donor
    after_p, sent_p = round_ref([r.cpu() for r in rows], range(n), 1, cap, limit, plain, sources)
    assert torch.equal(torch.stack(after + sent).cpu(), torch.stack(after_p + sent_p))
    for st, st_p in zip(stores, plain):
        for f, t, t_p in zip(ROUND_FIELDS, st, st_p):
            assert (bits_equal if t.is_floating_point() else torch.equal)(t.cpu(), t_p), f
    del plain
    whole = time_round_call(ranks, states, rows, reps)
    # repeated rounds on the same counts write the same values
    plain_ms = time_ms(lambda: round_ref(rows, range(n), 1, cap, limit, stores, sources),
                       reps // 4)
    size = states[0].centers.element_size()
    kept = min(n_recv[1], C - counts[1])
    moves = (8 * n + 16 * n  # the counts read, (after, sent) written
             + kept * 2 * d * size * 2  # the rows received, read and written
             + kept * (2 * size + 4 + 2)  # their est, err, axis, active, fresh
             + n_send[0] * 2)  # the sent rows' active and fresh
    kernel_us = sum(us for name, us in whole["device_us_by_name"].items()
                    if "redistribute_round" in name)
    round_row = dict(ms=whole["ms"], host_ms=whole["host_ms"], kernel_ms=kernel_us / 1e3,
                     device_ms=whole["device_us"] / 1e3, device_ops=whole["device_ops"],
                     plain_ms=plain_ms, bytes=moves, bound_ms=moves / PEAK_HBM_BYTES * 1e3,
                     bound_by="bytes", library_ms=None)

    block = torch.empty((P, 2 * d), dtype=dtype, device="cuda")
    kernels = rk.RoundKernels()
    pack = lambda: kernels.pack(rows, [0], 1, cap, limit, [stores[0][:2]], [block])  # noqa: E731
    pack()
    block_p = torch.empty((P, 2 * d), dtype=dtype)
    round_pack_ref([r.cpu() for r in rows], [0], 1, cap, limit,
                   [tuple(t.cpu() for t in stores[0][:2])], [block_p])
    assert bits_equal(block.cpu(), block_p)
    pack_moves = 8 * n + n_send[0] * 2 * d * size + P * 2 * d * size
    pack_row = dict(ms=time_ms(pack, reps), kernel_ms=_profiled_us(pack, reps, "redistribute_pack")
                    / 1e3,
                    plain_ms=time_ms(lambda: round_pack_ref(rows, [0], 1, cap, limit,
                                                            [stores[0][:2]], [block]), reps // 4),
                    bytes=pack_moves, bound_ms=pack_moves / PEAK_HBM_BYTES * 1e3,
                    bound_by="bytes", library_ms=None)

    floor = lambda: rk.launch_floor("cuda:0")  # noqa: E731
    floor_row = dict(ms=time_ms(floor, reps), kernel_ms=_profiled_us(floor, reps, "launch_floor")
                     / 1e3)
    return dict(d=d, dtype=str(dtype).split(".")[-1], ranks=n, cap=cap, capacity=C,
                rows_moved=n_send[0], round=round_row, pack=pack_row, floor=floor_row,
                device_us_by_name=whole["device_us_by_name"])


def pool_thetas():
    from repro_torch.core.integrands import PARAM_REGISTRY

    family = PARAM_REGISTRY[VEGAS_POOL["integrand"]]
    rng = np.random.default_rng(0)
    return [family.sample_theta(VEGAS_POOL["d"], rng) for _ in range(VEGAS_POOL_REQUESTS)]


def serve_pool(devices, **change):
    """Serve the VEGAS pool's fleet, with ``change`` to :data:`VEGAS_POOL`'s
    fields (e.g. ``admit_every=4``); returns the results by req_id, the
    scheduler and the thetas."""
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.service import BatchScheduler, QuadRequest

    thetas = pool_thetas()
    sched = BatchScheduler(QuadratureConfig(**{**VEGAS_POOL, **change}), devices=devices)
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

    ranks = 4
    drivers = {
        "integrate": lambda cfg: adaptive.integrate(cfg, device="cuda"),
        "device": lambda cfg: adaptive.integrate_device(cfg, device="cuda"),
        "distributed": lambda cfg: integrate_distributed(cfg, devices=cuda_devices(ranks)),
    }
    class Fleet:  # the service's run, read like a driver's result
        def __init__(self, devices):
            results, sched = serve_fleet(devices)
            self.iterations = sched.last_stats["iterations"]
            self.n_evals = sum(r.n_evals for r in results)
            # the host waits on the card once an iteration (a landed row of
            # decisions) and reads once a dispatch
            eng = sched.engine
            self.host_syncs = eng.host_reads + eng.landed_waits

    class Pool:  # the VEGAS pool's run, read like a driver's result
        def __init__(self, devices):
            results, sched, _ = serve_pool(devices)
            self.iterations = sched.last_stats["iterations"]
            self.n_evals = sum(r.n_evals for r in results)
            # the host waits once an iteration and reads once a dispatch; a
            # checkout from before the fused dispatch reads once an iteration
            eng = sched.engine
            self.host_reads = getattr(eng, "host_reads", self.iterations)
            self.landed_waits = getattr(eng, "landed_waits", 0)
            self.host_syncs = self.host_reads + self.landed_waits

    drivers["service"] = lambda cfg: Fleet(cuda_devices(1))
    drivers["pool"] = lambda cfg: Pool(cuda_devices(1))
    drivers["vegas"] = lambda cfg: integrate_vegas(cfg, device="cuda")
    vegas_cfg = vegas_case(*VEGAS_CASES[0])[0]
    # (integrand, d, rel_tol, capacity, redistribution or None)
    own_case = {
        "service": [("service:" + SERVICE["integrand"], SERVICE["d"], None, SERVICE["capacity"],
                     None)],
        "pool": [("pool:" + VEGAS_POOL["integrand"], VEGAS_POOL["d"], None, None, None)],
        "vegas": [(VEGAS_CASES[0][0], VEGAS_CASES[0][1], None, None, None)],
        "distributed": [(name, d, rel_tol, DIST_CAPACITY, policy)
                        for name, d, rel_tol, policy in DIST_CASES],
    }
    runs = [(driver, case) for driver in args.drivers
            for case in own_case.get(driver, [(*c, None) for c in MAIN_CASES])]
    smi = card()
    for driver, (name, d, rel_tol, capacity, policy) in runs:
        run = drivers[driver]
        if driver in ("service", "pool", "vegas"):
            cfg = vegas_cfg if driver == "vegas" else None
        else:
            cfg = QuadratureConfig(d=d, integrand=name, rel_tol=rel_tol, capacity=capacity,
                                   **({"redistribution": policy} if policy else {}),
                                   **({"sync_every": args.sync_every} if args.sync_every else {}))
        run(cfg)  # build, allocate, warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, cpus = [], []
        for _ in range(args.repeat):
            t0, c0 = time.perf_counter(), time.process_time()
            res = run(cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            cpus.append(time.process_time() - c0)
        wall_plain = float(np.median(walls))
        case = name.split(":")[0]
        row = dict(driver=driver, case=case, d=d, redistribution=policy,
                   iterations=res.iterations, n_evals=res.n_evals,
                   host_syncs=res.host_syncs, host_reads=getattr(res, "host_reads", None),
                   landed_waits=getattr(res, "landed_waits", None),
                   wall_s=wall_plain, walls_s=walls, cpus_s=cpus,
                   discarded=getattr(res, "discarded", None), card=smi)
        if args.walls_only:
            print(json.dumps(row), flush=True)
            continue
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = run(cfg)  # the discarded work below is this run's
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
        if args.trace_dir:
            prof.export_chrome_trace(f"{args.trace_dir}/{driver}_{case}_d{d}.json")
        print(json.dumps(dict(
            row, profiled_wall_s=wall, device_busy_s=total,
            gm_kernel_s=gm, other_device_s=total - gm, idle_s=wall - total,
            gm_share=gm / wall, advance_share=(total - gm) / wall,
            idle_share=(wall - total) / wall, device_s_by_kind=by_kind,
            top_kernels=[(k[:80], v / 1e6) for k, v in top],
            **({"mc_samples": cfg.mc_samples, "peak_bytes": torch.cuda.max_memory_allocated(),
                **_stage_split(prof)} if driver == "vegas" else {}),
            **(_discarded_split(prof, res, res.iterations + 1) if driver == "device" else {}),
            **(_dispatch_split(prof, res, ranks, cfg) if driver == "distributed" else {}),
        )), flush=True)
        if total == 0.0:
            raise SystemExit("the profiler recorded no device time")


# ``ops``'s cases: MAIN_CASES' f4 and f6 at a store the CPU runs in seconds
OPS_CASES = [("f4", 5, 1e-7, 1 << 14), ("f6", 5, 1e-4, 1 << 14)]


def cmd_ops(args):
    """Torch operations per rank and iteration run of four ranks, by phase:
    ``round`` (``redistribute``), ``advance`` (``classify`` and
    ``classify_split_compact``) and ``other`` (evaluate around the rule,
    metadata, snapshots).  The GM rule's own operations are left out: on
    the card they are one kernel launch.  On the CPU the round is its plain
    version; with ``--device cuda`` (four ranks on the visible cards) it is
    what the card path enqueues: its torch operations and its kernel
    launches, read from the kernels' counter, one operation each."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core import distributed as dist_mod
    from repro_torch.core import rules
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.ranks import cuda_devices

    try:
        from repro_torch.kernels import redistribute_round as round_kernels
    except ImportError:  # a checkout from before the round's kernels
        round_kernels = None

    phase = ["other"]
    counts = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[phase[-1]] += 1
            return func(*args, **(kwargs or {}))

    def labelled(fn, label):
        def run(*a, **k):
            phase.append(label)
            try:
                return fn(*a, **k)
            finally:
                phase.pop()
        return run

    patches = [(dist_mod, name, label) for name, label in (
        ("redistribute", "round"), ("classify", "advance"), ("classify_split_compact", "advance"))]
    patches.append((rules.GenzMalikRule, "eval_batch", "rule"))
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    for owner, name, label in patches:
        setattr(owner, name, labelled(getattr(owner, name), label))
    devices = ["cpu"] * 4 if args.device == "cpu" else cuda_devices(4)
    try:
        for name, d, rel_tol, capacity in OPS_CASES:
            cfg = QuadratureConfig(d=d, integrand=name, rel_tol=rel_tol, capacity=capacity,
                                   **({"sync_every": args.sync_every} if args.sync_every else {}))
            counts.clear()
            if round_kernels is not None:
                round_kernels.reset_launch_count()
            with Count():
                res = dist_mod.integrate_distributed(cfg, devices=devices)
            # this tree's kernels; a tree from before the round's redesign had a
            # pack and a splice a rank
            names = getattr(round_kernels, "KERNELS", ("pack", "splice")) if round_kernels else ()
            by_kernel = {k: round_kernels.launch_count(k) for k in names}
            launches = sum(by_kernel.values())
            counts["round"] += launches
            run = 4 * (res.iterations + getattr(res, "discarded", 0))
            per = {k: v / run for k, v in counts.items() if k != "rule"}
            print(json.dumps(dict(case=name, d=d, capacity=capacity, device=args.device,
                                  iterations=res.iterations,
                                  discarded=getattr(res, "discarded", None),
                                  ops_per_rank_iteration=sum(per.values()), by_phase=per,
                                  round_kernel_launches=launches / run,
                                  round_launches_by_kernel={k: v / run
                                                            for k, v in by_kernel.items()},
                                  package=dist_mod.__file__,
                                  **({"card": card()} if args.device == "cuda" else {}))),
                  flush=True)
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def cmd_round(args):
    """The whole round at ROUND_TIMED's shapes (:func:`time_round_call`),
    one JSON line a d; runs against another checkout too."""
    import repro_torch

    smi = card()
    for d in ROUND_TIMED["dims"]:
        row = time_round_call(*round_case(d), reps=args.reps)
        print(json.dumps(dict(d=d, ranks=ROUND_TIMED["ranks"], cap=ROUND_TIMED["cap"],
                              capacity=ROUND_TIMED["capacity"], **row,
                              package=repro_torch.__file__, card=smi)), flush=True)
        torch.cuda.empty_cache()


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


# the profile runs of one turn of ``interleave``, each in its own process
INTERLEAVE_RUNS = (
    ("K=1", ("--drivers", "distributed", "--sync-every", "1")),
    ("K=4", ("--drivers", "integrate,device,distributed", "--sync-every", "4")),
)


def cmd_interleave(args):
    """``profile`` of several checkouts in turns, on one card.

    ``--trees`` names checkouts (a directory holding ``src/``; ``.`` is this
    one), each labelled by its directory name.  Their kernels are built
    first, all at once, then each tree counts its operations (``ops
    --device cuda``), then ``--rounds`` turns run :data:`INTERLEAVE_RUNS`
    (``--repeat`` walls a case) for every tree, each in a process of its own
    with that tree's ``src`` on ``PYTHONPATH``, the trees' order reversed
    every other turn.  Every line goes to ``--out`` with its tree, run and
    turn; the last lines are, per tree, run, driver and case, the median and
    range of all walls, and the medians of the host CPU seconds and of the
    discarded work.  ``--walls-only`` skips the operation count and the
    profiled runs, whose trace takes longer than the runs themselves."""
    here = os.path.abspath(__file__)
    trees = [(os.path.basename(os.path.abspath(t)), os.path.abspath(t)) for t in args.trees]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def env(root):
        return dict(os.environ, PYTHONPATH=os.path.join(root, "src"))

    builds = [subprocess.Popen([sys.executable, "-c", "from repro_torch.kernels import build; "
                                "build.build_all()"], env=env(root)) for _, root in trees]
    if any(proc.wait() for proc in builds):
        raise SystemExit("interleave: a tree's kernels did not build")
    rows = []
    with open(args.out, "w") as out:
        def run(label, root, name, turn, argv):
            proc = subprocess.run([sys.executable, here, *argv], env=env(root), cwd=root,
                                  capture_output=True, text=True)
            if proc.returncode:
                raise SystemExit(f"interleave: {label} {name} failed:\n{proc.stderr[-4000:]}")
            for line in proc.stdout.splitlines():
                if line.startswith("{"):
                    row = dict(json.loads(line), tree=label, run=name, turn=turn)
                    rows.append(row)
                    out.write(json.dumps(row) + "\n")
                    out.flush()

        if not args.walls_only:
            for label, root in trees:
                run(label, root, "ops", 0, ["ops", "--device", "cuda"])
        light = ["--walls-only"] if args.walls_only else []
        for turn in range(args.rounds):
            for label, root in trees if turn % 2 == 0 else trees[::-1]:
                for name, argv in INTERLEAVE_RUNS:
                    run(label, root, name, turn,
                        ["profile", *argv, "--repeat", str(args.repeat), *light])
        groups = collections.defaultdict(list)
        for row in rows:
            if "walls_s" in row:
                groups[(row["tree"], row["run"], row["driver"], row["case"],
                        row["redistribution"])].append(row)
        for (label, name, driver, case, policy), group in groups.items():
            walls = [w for row in group for w in row["walls_s"]]
            cpus = [c for row in group for c in row["cpus_s"]]
            summary = dict(
                summary=True, tree=label, run=name, driver=driver, case=case,
                redistribution=policy,
                wall_median_s=float(np.median(walls)), wall_min_s=min(walls),
                wall_max_s=max(walls), walls=len(walls), cpu_median_s=float(np.median(cpus)),
                card=group[0]["card"], iterations=group[0]["iterations"],
                host_syncs=group[0]["host_syncs"],
                **{k: float(np.median([r[k] for r in group])) for k in (
                    "idle_share", "device_busy_s", "discarded", "discarded_device_s",
                    "discarded_gm_s", "eval_rows", "eval_rows_exact")
                   if all(r.get(k) is not None for r in group)})
            out.write(json.dumps(summary) + "\n")
            print(json.dumps(summary), flush=True)


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


def _discarded_split(prof, res, kept):
    """The evaluate steps enqueued past the stop (``discarded``; None for a
    checkout whose driver does not report them) and the device seconds (all
    kernels; the GM kernel) from the first GM launch after the ``kept`` the
    result needed to the end of the run: on one card's stream that tail is
    the discarded work."""
    from torch.autograd import DeviceType

    kernels = sorted((evt.time_range.start, evt.time_range.end, evt.name)
                     for evt in prof.events() if evt.device_type == DeviceType.CUDA)
    gm = [start for start, _, name in kernels if "gm_eval_kernel" in name]
    cut = gm[kept] if len(gm) > kept else float("inf")
    tail = [(end - start, name) for start, end, name in kernels if start >= cut]
    return {"discarded": getattr(res, "discarded", None), "gm_launches": len(gm),
            "discarded_device_s": sum(us for us, _ in tail) / 1e6,
            "discarded_gm_s": sum(us for us, name in tail if "gm_eval_kernel" in name) / 1e6}


def _dispatch_split(prof, res, ranks, cfg):
    """The distributed driver's fused dispatch: K, the iterations begun past
    the stop and discarded, with their device seconds (the ranks share one
    card's stream, so the work after the result's last GM launch is
    theirs; :func:`_discarded_split`), and the rows its evaluate steps
    covered against those of windows sized from the exact counts (None
    where the checkout's driver does not report them)."""
    return {"sync_every": cfg.sync_every, **_discarded_split(prof, res, ranks * res.iterations),
            "eval_rows": getattr(res, "eval_rows", None),
            "eval_rows_exact": getattr(res, "eval_rows_exact", None)}


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
    unknown = set(names) - {"integrate", "device", "distributed", "service", "pool", "vegas"}
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
    r = sub.add_parser("round", help="the whole redistribution round at ROUND_TIMED's shapes")
    r.add_argument("--reps", type=int, default=200)
    o = sub.add_parser("ops", help="torch operations per rank and iteration of the "
                                   "distributed driver, by phase (CPU)")
    o.add_argument("--sync-every", type=int, default=None)
    o.add_argument("--device", choices=("cpu", "cuda"), default="cpu",
                   help="cpu: the round's plain version; cuda: the card path's kernels")
    i = sub.add_parser("interleave", help="profile of several checkouts in turns")
    i.add_argument("--trees", type=lambda v: v.split(","), required=True,
                   help="comma-separated checkout directories, each holding src/")
    i.add_argument("--rounds", type=int, default=3)
    i.add_argument("--repeat", type=int, default=5)
    i.add_argument("--out", default="build/interleave.jsonl")
    i.add_argument("--walls-only", action="store_true",
                   help="no operation count and no profiled runs: walls only")
    p = sub.add_parser("profile", help="torch.profiler breakdown of the main path")
    p.add_argument("--trace-dir", default=None, help="write Chrome traces here")
    p.add_argument("--drivers", type=_drivers, default=["integrate"],
                   help="comma-separated: integrate, device, distributed, service, pool, vegas")
    p.add_argument("--repeat", type=int, default=1,
                   help="unprofiled runs per case; wall_s is their median")
    p.add_argument("--walls-only", action="store_true",
                   help="no profiled run: walls, host CPU seconds, syncs and discards only")
    p.add_argument("--sync-every", type=int, default=None,
                   help="iterations per dispatch of the device and distributed drivers "
                        "(default: the config's)")
    args = ap.parse_args(argv)
    if (args.cmd != "ptxas" and getattr(args, "device", "cuda") == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit("gm_perf: no CUDA device; this tool measures the card only")
    {"time": cmd_time, "ptxas": cmd_ptxas, "profile": cmd_profile, "sums": cmd_sums,
     "sums-ablate": cmd_sums_ablate, "vegas": cmd_vegas, "ops": cmd_ops,
     "interleave": cmd_interleave, "round": cmd_round}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
