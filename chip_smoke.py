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
   1e-14 relative, float32 against the float64 plain version.  The plain
   version takes its 2^d corners PLAIN_CORNER_COLS columns to a call
   (corner_chunk), bit-equal to one corner a call at d <= 8, B = 257;
3b. the redistribution round's kernels (redistribute_round, one launch a
   device over every rank on it; redistribute_pack, for donors whose
   receiver lives on another device) against their plain versions on the
   CPU, bit for bit (every field of the store, the count after the round
   and the rows sent, the packed blocks), over gm_perf.py's round_grid: 2,
   3, 4, 8 ranks on one card, every shift of each schedule, float64 and
   float32, d = 3, 5, 8, an empty rank, ranks full to the round's limit and
   to the store, a message cap above the store; each case twice, with
   every donor read in place and with every other donor packed and read
   from its block.  Then the whole round at phase 6's shape (four ranks,
   cap 512, 2^22 rows a rank, d = 5 and 8): ms a round, host ms, device
   time, beside the plain version on the card, the byte bound, the pack
   alone and an empty kernel's launch (the launch floor);
4. main path: repro_torch.core.adaptive.integrate on the card at capacity
   2^22 in float64, three cases, each of which must converge to its exact
   value in the iterations and evaluations recorded for it, with one
   kernel launch per evaluate step;
5. device loop: repro_torch.core.adaptive.integrate_device on the same
   three cases, bit-equal to phase 4's integrate (integral, error,
   iterations, evaluations), with its host syncs and wall time beside
   integrate's; one kernel launch per evaluate step, from iterations + 1
   to the whole blocks' steps (the loop stops enqueueing at the first
   landed snapshot that shows the stop; the steps past it are discarded);
6. distributed: repro_torch.core.distributed.integrate_distributed on four
   ranks (rank r on cuda:(r mod device count): on one card they share
   it), capacity 2^22 per rank, float64; each case converges, agrees with
   phase 4's single-device run, spreads the work over every rank, and
   takes the iterations and evaluations recorded for it, at sync_every 1
   (one host read per iteration) and 4 (one per fused dispatch of four),
   each twice in turns, with the same results at both; one GM launch per
   rank per evaluate step enqueued, and one round launch per device per
   round, with no pack where every rank shares one card (a dispatch stops
   enqueueing at the first landed snapshot that shows the stop; the
   iterations begun before it are discarded and logged), and one
   synchronising call per dispatch;
7. the Gauss-Kronrod rule (torch operations) on the card, with the
   iterations and evaluations of the same run on the CPU;
8. timings with CUDA events at the main path's window size: the kernel
   wrapper on SoA inputs, the same through kernels/ops.py (with the
   layout change the main path makes), and the plain version; beside them
   two bounds (see _bounds);
9. the batch service (repro_torch.service) at a real size: gm_perf.py's
   SERVICE fleet (192 Gaussians at d = 5, float64, 64 slots of 2^19
   regions, rel_tol 1e-3 / 1e-7 by request parity, admit_every 1,
   sync_every 4) on one rank, then on four ranks (cuda:(r mod count), 16
   slots each, ring migration), then at admit_every 4 with sync_every 1
   and 4 on one rank and on four.  Every request ends converged, or
   evicted with status capacity where its regions outgrow the store,
   within 10 max(error, budget) of its exact value; the runs at one
   admit_every give the same results bit for bit; the first four requests
   equal integrate()'s on their theta and tolerance bit for bit; one GM
   launch per rank per iteration with a live slot (eval_steps); one host
   read per fused dispatch, and at most SERVICE_SYNC_EXTRA more
   synchronising calls a run than dispatches; one wait on a landed row of
   decisions per iteration; migrations on four ranks.  Each run's wall,
   dispatches, iterations per dispatch, reads, waits and peak memory are
   logged;
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
   backend "auto" (16 slots, 2^18 samples, rel_tol 1e-3) at (admit_every,
   sync_every) = (1, 4), (4, 1) and (4, 4): every request converged or
   max_iters, within 5 errors of its exact value, n_evals = samples x
   iterations; one sums launch per fleet iteration; one host read per
   fused dispatch, one wait on a landed row of decisions per iteration,
   and at most VEGAS_POOL_SYNC_EXTRA more synchronising calls a run than
   dispatches; the two admit_every 4 runs the same bit for bit.  Each
   run's wall, dispatches, iterations, reads, waits, synchronising calls,
   launches and peak memory are logged; (b) phase 9's one-rank fleet through
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
   logged;
13. the telemetry recorder (repro_torch.telemetry) and the Gauss-Kronrod
   rule in the service: (a) every driver with a recorder against its
   recorder-off twin, at the sizes above: integrate and integrate_device
   on phase 4's f4 and genz_gaussian cases, phase 6's four ring ranks on
   f6, phase 10's VEGAS genz_gaussian d=15, phase 9's fleet on one rank
   and on four.  Each pair gives the same bits, host syncs and number of
   synchronising calls (torch.cuda.set_sync_debug_mode("warn")); each
   recorded Chrome trace passes the checker (with four rank lanes and a
   service.migrate flow on four ranks); the dist.work_imb gauges average
   to mean_imbalance() within 1e-12; the service.dispatch_wall_s samples
   number the dispatches; the walls on and off are logged.  (b) 64
   genz_gaussian requests at d=3 (thetas from default_rng(0)), rel_tol
   1e-8, rule gauss_kronrod, 16 slots of 2^14 regions, on 1 and on 4
   ranks: all converged, every result bit-equal to integrate() with GK on
   its theta on the card; wall, requests/s and peak memory logged.
   (c) the CLIs in process: launch.integrate with --trace, --metrics,
   --telemetry-summary and --strict, launch.serve_quad on 4 ranks with
   rank 2 lost at iteration 3 and back at 9, --trace, --metrics and
   --strict; both exit 0 and their files pass the telemetry checker.

14. the performance observatory (repro_torch.perf) and the examples: (a)
   the machine file (matmul, saxpy, reduction probes with CUDA events),
   its rates beside the card's name and power limit; (b) the kernel
   catalog at its card-scale configs, every entry logged; the gm_eval
   entries at B = 2^20 count exactly the operations and bytes of the bound
   column that PERF.md's kernel rows have used since the port's first
   kernel (GM_COUNTS), as phase 8's _bounds does, and every entry launched the kernels its kind launches (one
   GM launch per evaluate step); (c) the report from (a), (b) and phase
   13c's serve_quad metrics, with its four sections (files under
   build/perf_torch/); (d) a torch lambda f4 through integrate at phase
   4's f4 case: no GM launch (the rule's torch route), phase 4's status,
   iterations and evaluations, the integral within 1e-12 relative; again
   with the torch route's blocks cut to 2^16 regions (more integrand
   calls, the same bits, no GM launch); the same callable through
   integrate_device (integrate's bits) and four ring
   ranks (phase 6's iterations and evaluations per rank); (e) the
   three examples (examples/torch_*.py) in process, each within its bar,
   and ring's mean imbalance below off's.

15. the LM substrate's serve path (repro_torch.models, repro_torch.serving;
   torch operations, no kernel of the port): (a) deepseek-7b at its
   published widths (6.9 B float32 weights from seed 0) with bfloat16
   activations on cuda:0: 4 prompts of 512 tokens from default_rng(0),
   greedy generate of 32 tokens twice (the same tokens), then a flat
   prefill and 31 decode steps on generate's tokens timed with CUDA
   events, every step's logits and the prefill's held to one model_forward
   over the 543 tokens fed (max |dlogit| <= 5e-2 max |logit|, argmax equal
   where the top-2 gap exceeds twice that), chunked prefill (chunk 128)
   held to flat, the decode steps again in float32 held to a float32
   forward at 1e-3 max |logit|, where two planted faults (every step one
   position late; every step from the prefill's SSM state) must miss at
   some step, and 8 decode steps under torch.profiler split by kind
   (lm_perf.py); prefill s, decode ms per token, tokens/s, peak memory,
   the weights' bytes and a decode step's byte bounds are logged; (b)
   mamba2-370m the same; (c) every architecture's smoke config (hubert's
   forward, internvl2 with its frontend embeddings) on the card against
   the port on the CPU with the same float32 weights, within 1e-4; (d)
   python -m repro_torch.launch.serve at deepseek-7b's full width (4
   prompts of 64 tokens, 16 new), exit 0.  No GM or sums kernel launches.

16. the LM substrate's training path (repro_torch.training, repro_torch.data;
   torch operations, no kernel of the port; lm_perf.py train): (a)
   deepseek-7b at its published widths (d 4096, 32 heads, d_ff 11008,
   vocab 102400) with its depth cut to lm_perf.TRAIN_LAYERS layers, bf16
   activations, the default TrainConfig (the bf16 weight cast) with remat
   full, 2 sequences of 2048 tokens from batch_for_step (seed 0): 2
   warm-up and 4 timed steps on that batch (CUDA events), every loss
   finite and the last below the first, and the same steps run twice the
   same bits (losses, grad norms, every final weight); step time,
   tokens/s, peak memory and the model-FLOP share of 989 TFLOP/s are
   logged; then one forward and backward at 2 x 1024 under remat none,
   full and dots, the same loss and gradients bit for bit, each one's peak
   and time logged; (b) mamba2-370m whole (48 layers) at 4 x 2048 the
   same; (c) every smoke config's train step on the card against the CPU
   in float32 gather (loss within 1e-5, every gradient leaf within 1e-4 of
   its largest entry), the card's gradients twice the same bits, then 5
   steps with a falling loss; (d) 4 steps against 2, a checkpoint, a
   restore and 2 more, bit-equal; (e) python -m repro_torch.launch.train
   on mamba2-370m at full width (20 steps of 4 x 512), and on deepseek-7b
   smoke with microbatches 2, remat dots and bf16_ef twice into one
   checkpoint directory (the second run resumes), each exit 0; (f)
   examples/torch_serve_lm.py and torch_train_lm.py in process.  No GM or
   sums kernel launches.

17. the dry run (repro_torch.launch.dryrun; torch operations on fake
   tensors, no kernel of the port): (a) DRYRUN_CELLS at their published
   widths and a cut depth (the leading dense layers and two periods of the
   layer pattern), each its step traced as a DTensor program over a fake
   process group of 256 or 512 ranks with a cuda DeviceMesh ((16, 16) or
   (2, 16, 16)): the
   train step, the chunked prefill, the encoder forward (hubert), decode
   with deepseek-v2-236b's MLA rank-sharded cache and qwen3-moe's
   sequence-sharded KV cache, the 500k decode; one JSON line per cell, each
   "ok" with per-device bytes, FLOPs and collectives; (b) calibration: two
   programs predicted by the dry run on a (1, 1) mesh, then run for real
   on cuda:0 (max_memory_allocated after reset_peak_memory_stats, above
   what was allocated before their arguments): deepseek-7b at its
   published widths (bf16 weights) prefilling 4 x 512 tokens into a cache
   of 544, and deepseek-7b cut to lm_perf.TRAIN_LAYERS layers taking one
   train step of 2 x 2048 (remat full, the default TrainConfig); each
   predicted peak within CALIBRATION_TOL of the measured one.  No GM or
   sums kernel launches.

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

# the three main-path cases, phase 6's distributed cases, the (integrand,
# d) timed at B = TIMED_B, and the helpers that gm_perf.py's measurements
# share with this script
from repro_torch.launch.gm_perf import (  # noqa: E402
    DIST_CAPACITY, DIST_CASES, MAIN_CASES, PEAK_FP64_FLOPS, PEAK_HBM_BYTES, ROUND_TIMED,
    SUMS_HARD_CASES, SUMS_TIMED, TIMED, TIMED_B, VEGAS_CASES, VEGAS_POOL, bits_equal, card,
    inputs, pool_thetas, round_grid, round_vs_plain, serve_pool, soa, sums_hard_case,
    sums_inputs, time_ms, time_round, time_sums, vegas_case,
)

# FP64 lanes per SM on Hopper: each issues one add, multiply or FMA per clock
FP64_LANES_PER_SM = 64

# (iterations, n_evals) of each MAIN_CASES run, exact: the kernel's
# redesign keeps its results, so the adaptive run takes the same path
EXPECTED_PATH = {"f4": (29, 392709984), "genz_gaussian": (25, 10851868416), "f6": (27, 1713618)}
# (operations, bytes) of the GM kernel's bound at B = 2^20 (TIMED_B), as the
# bound column of PERF.md's kernel rows has counted them since the port's
# first kernel
GM_COUNTS = {("f4", 5): (1699741696, 150994944), ("genz_gaussian", 8): (14350811136, 226492416)}
DIST_RANKS = 4
# iterations per host read of phase 6's runs: the per-iteration read, and
# the default fused dispatch
DIST_SYNC_EVERY = (1, 4)
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
# phase 14's machine file, catalog and report (gitignored)
PERF_DIR = os.path.join(HERE, "build", "perf_torch")
# columns of one call of the plain version's integrand in phase 3 (its
# corner_chunk is this over B)
PLAIN_CORNER_COLS = 2**22
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
    log("  redistribute_round kernels: registers / spill bytes (stores+loads):")
    for line in built["redistribute_round"].log.splitlines():
        m = re.search(r"Compiling entry function '\S*redistribute_(round|pack)I([df])", line)
        if m:
            kernel = f"{m.group(1)}<{'double' if m.group(2) == 'd' else 'float'}>"
        elif kernel and "spill stores" in line:
            spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif kernel and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            log(f"  {kernel:<30} regs {regs:>3} spill {spill}")
            kernel = None


def _corner_chunk(b):
    """Corners a call of the plain version's integrand takes at B = b: its
    launches, most of them the 2^d corners', bound it on the card."""
    return max(1, PLAIN_CORNER_COLS // b)


def _plain(entry, centers, halfw, theta, chunked=True):
    """The plain PyTorch version on the same CUDA tensors."""
    from repro_torch.kernels.ref import genz_malik_eval_soa_ref

    ct, ht, rows = soa(entry, centers, halfw, theta)
    chunk = _corner_chunk(ct.shape[1]) if chunked else 1
    if rows is None:
        return genz_malik_eval_soa_ref(entry.fn, ct, ht, corner_chunk=chunk)
    d = ct.shape[0]  # every family's theta fields are (d,) leaves

    def fn(x, r):
        return entry.fn(x, dict(zip(entry.theta_fields, r.split(d))))

    return genz_malik_eval_soa_ref(fn, ct, ht, rows, corner_chunk=chunk)


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

            chunk = _corner_chunk(c.shape[1])
            got = gm_kernel.genz_malik_eval_soa(entry.kernel_id, c, h, rows)
            worst = max(worst, _check64(got, genz_malik_eval_soa_ref(fn, c, h, rows,
                                                                     corner_chunk=chunk),
                                        f"{name} d={d} per-lane theta"))
            got32 = gm_kernel.genz_malik_eval_soa(entry.kernel_id, c.float(), h.float(), rows.float())
            ref32 = genz_malik_eval_soa_ref(fn, c.float(), h.float(), rows.float(),
                                            corner_chunk=chunk)
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
                chunk = _corner_chunk(c.shape[1])
                got = gm_kernel.genz_malik_eval_soa(entry.kernel_id, c, h, cols, lanes_per_col=lanes)
                ref = genz_malik_eval_soa_ref(fn, c, h, cols, lanes_per_col=lanes,
                                              corner_chunk=chunk)
                worst = max(worst, _check64(got, ref, what + " per-slot theta"))
                got32 = gm_kernel.genz_malik_eval_soa(entry.kernel_id, c.float(), h.float(),
                                                      cols.float(), lanes_per_col=lanes)
                ref32 = genz_malik_eval_soa_ref(fn, c.float(), h.float(), cols.float(),
                                                lanes_per_col=lanes, corner_chunk=chunk)
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
    n_unchunked = 0
    for d, b, these in cases:
        for name in these:
            entry, c, h, theta = inputs(name, d, b, rng)
            ref = _plain(entry, c, h, theta)
            if d <= 8 and b == 257:
                # the plain version's corner chunk changes no bit on the card
                one = _plain(entry, c, h, theta, chunked=False)
                assert all(bits_equal(x, y) for x, y in zip(ref, one)), f"{name} d={d} chunk"
                n_unchunked += 1
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
        f"estimates overflowed in both the kernel and the plain version; the plain version's "
        f"corners {PLAIN_CORNER_COLS} columns a call, bit-equal to one corner a call in "
        f"{n_unchunked} cases")


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
        # at most every block's k evaluate steps; the loop stops enqueueing at
        # the first landed snapshot that shows the stop, so fewer run
        steps = math.ceil((res.iterations + 1) / k) * k
        row = dict(
            case=main["case"], d=d, driver="integrate_device", sync_every=k,
            status=res.status, wall_s=wall, host_syncs=res.host_syncs,
            integrate_host_syncs=main["host_syncs"], walls_in_turns=turns,
            iterations=res.iterations, n_evals=res.n_evals, eval_steps_at_most=steps,
            launches=launches, discarded=res.discarded, max_memory_allocated=peak,
        )
        log(json.dumps(row))
        assert res.status == "converged", row
        assert (res.integral, res.error, res.iterations, res.n_evals) == (
            main["integral"], main["error"], main["iterations"], main["n_evals"]), row
        assert res.host_syncs <= math.ceil(res.iterations / k) + 2, row
        assert res.iterations + 1 <= launches <= steps, row
        assert launches == res.iterations + 1 + res.discarded, row
        total += launches
    return total


def phase_distributed(main_rows, smi):
    """Four ranks through the CUDA GM and round kernels, against phase 4's
    runs, at ``sync_every`` 1 and 4 in turns (1, 4, 1, 4): every run gives
    EXPECTED_DIST's counts and the same results at both; one synchronising
    call per dispatch.  Returns the GM launches and the round's."""
    from repro_torch.core import integrands
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.distributed import integrate_distributed
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.kernels import genz_malik_eval as gm_kernel
    from repro_torch.kernels import redistribute_round as rk

    single = {row["case"]: row for row in main_rows}
    devices = cuda_devices(DIST_RANKS)
    n_devices = len(set(devices))
    total = 0
    rounds = dict.fromkeys(rk.KERNELS, 0)
    imbalance = {}
    for name, d, rel_tol, policy in DIST_CASES:
        case = name.split(":")[0]
        exact = integrands.get(name).exact(d)
        walls = {k: [] for k in DIST_SYNC_EVERY}
        results = {}
        for k in DIST_SYNC_EVERY * 2:
            cfg = QuadratureConfig(d=d, integrand=name, rel_tol=rel_tol, capacity=DIST_CAPACITY,
                                   redistribution=policy, sync_every=k)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            gm_kernel.reset_launch_count()
            rk.reset_launch_count()
            res, wall, sync_calls = _sync_counted(
                lambda: integrate_distributed(cfg, devices=devices))
            launches = gm_kernel.launch_count()
            by_kernel = {k: rk.launch_count(k) for k in rk.KERNELS}
            rel = abs(res.integral - exact) / abs(exact)
            mean_share = res.n_evals / DIST_RANKS
            row = dict(
                case=case, d=d, rel_tol=rel_tol, redistribution=policy, ranks=DIST_RANKS,
                devices=[str(x) for x in devices], capacity_per_rank=cfg.capacity,
                sync_every=k, status=res.status, wall_s=wall, iterations=res.iterations,
                n_evals=res.n_evals, evals_per_s=res.n_evals / wall,
                evals_per_rank=res.evals_per_device.tolist(),
                share_of_mean=(res.evals_per_device / mean_share).tolist(),
                mean_imbalance=res.mean_imbalance(), regions_moved=res.moved,
                host_syncs=res.host_syncs, sync_calls=sync_calls, launches=launches,
                round_launches=by_kernel,
                discarded=res.discarded, eval_rows=res.eval_rows,
                eval_rows_exact=res.eval_rows_exact,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                integral=res.integral, error=res.error, exact=exact, true_rel_err=rel,
                single_integral=single[case]["integral"], card=smi,
            )
            log(json.dumps(row))
            assert res.status == "converged", row
            assert rel <= 10 * rel_tol, row
            assert abs(res.integral - single[case]["integral"]) <= 4 * rel_tol * abs(exact), row
            assert min(res.evals_per_device) > 0.01 * mean_share, row
            # a dispatch stops enqueueing at the first landed snapshot that
            # shows the stop; the iterations begun before it are discarded
            assert res.iterations * DIST_RANKS <= launches <= (
                res.iterations + k - 1) * DIST_RANKS, row
            assert launches <= (res.iterations + res.discarded) * DIST_RANKS, row
            # one round launch a device a round run; a pack only where a
            # donor's receiver lives on another card
            if policy == "off":
                assert by_kernel == dict.fromkeys(rk.KERNELS, 0), row
            else:
                assert res.iterations * n_devices <= by_kernel["round"] <= (
                    res.iterations + res.discarded) * n_devices, row
            if n_devices == 1:
                assert by_kernel["pack"] == 0, row
            assert res.eval_rows >= res.eval_rows_exact, row
            if k == 1:
                assert res.discarded == 0 and res.eval_rows == res.eval_rows_exact, row
            assert res.host_syncs <= math.ceil(res.iterations / k) + 1, row
            assert sync_calls == res.host_syncs, row
            got = (res.iterations, int(res.n_evals), [int(x) for x in res.evals_per_device])
            assert got == EXPECTED_DIST[f"{case}-{policy}"], (got, row)
            key = (res.integral, res.error, res.iterations, res.n_evals,
                   res.evals_per_device.tolist(), res.history, res.moved)
            assert results.setdefault("key", key) == key, row
            walls[k].append(wall)
            imbalance[(case, policy)] = res.mean_imbalance()
            total += launches
            for kernel, count in by_kernel.items():
                rounds[kernel] += count
        log(json.dumps(dict(phase="distributed_walls", case=case, redistribution=policy,
                            walls_s={str(k): w for k, w in walls.items()}, card=smi)))
    assert imbalance[("f6", "ring")] <= imbalance[("f6", "off")] + 0.05, imbalance
    assert rounds["round"] > 0, rounds
    return total, rounds


def phase_round_kernels(smi):
    """Phase 3b: the redistribution round's kernels against their plain
    versions (kernels/ref.py, on the CPU), bit for bit, over gm_perf.py's
    round_grid: 2, 3, 4 and 8 ranks on one card, every shift of their
    schedules, float64 and float32, d = 3, 5, 8, an empty rank, a rank full
    to the round's limit and one full to the store, a message cap below and
    above the store's 64 rows; each case with every donor read in place,
    then with every other donor packed and read from its block.  Then the
    round timed at phase 6's shape (gm_perf.time_round: 4 ranks, cap 512,
    2^22 rows a rank, d = 5 and 8)."""
    from repro_torch.kernels import redistribute_round as rk

    t0 = time.perf_counter()
    cases = checks = moved = 0
    worst = 0.0
    before = {k: rk.launch_count(k) for k in rk.KERNELS}
    for case in round_grid():
        for staged in (False, True):
            err, rows = round_vs_plain(*case, staged=staged)
            worst = max(worst, err)
            moved += rows
            checks += 1
        cases += 1
    launches = {k: rk.launch_count(k) - before[k] for k in rk.KERNELS}
    row = dict(phase="round_kernels", card=smi, cases=cases, checks=checks, rows_moved=moved,
               launches=launches, max_abs_err=worst, wall_s=time.perf_counter() - t0)
    log(json.dumps(row))
    # one round launch a check, one pack launch a staged check
    assert cases == 156 and checks == 312 and moved > 0 and worst == 0.0, row
    assert launches == {"round": 312, "pack": 156}, row
    timings = []
    for d in ROUND_TIMED["dims"]:
        timings.append(time_round(d))
        log("timing: " + json.dumps(dict(phase="round_kernels", card=smi, **timings[-1])))
    torch.cuda.empty_cache()
    return worst, timings


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


def _bounds(name, d, b, sms, clock_hz):
    """Two yardsticks of the kernel's time at ``b`` regions, in ms, from
    the counts of ``repro_torch.perf.catalog.gm_eval_counts``.

    ``bound_ms`` is the bound of the port's first kernel, kept so that the
    rows of PERF.md compare: the larger of bytes / HBM rate and operations
    / 34 TFLOP/s (the FP64 vector rate of the h100-sxm preset), with
    n_nodes(d) * (the plain integrand's per-point work) + 4d + 20 operations
    per region.  Those operations recompute every axis's factor at every
    node, which the table form does not, and the rate counts an FMA as two
    operations while the kernel, built with -fmad=false, issues adds and
    multiplies: it is a shared yardstick, not a least time of this kernel.

    ``instr_bound_ms`` is the time of the table form's FP64 instructions at
    the FP64 issue rate (64 lanes per SM at the card's largest SM clock),
    or of the bytes if longer.  Each exp counts as one instruction
    (``exps`` is their number; the math library takes about twenty), and
    no fold is shared between nodes.
    """
    from repro_torch.perf.catalog import gm_eval_counts

    counts = gm_eval_counts(name, d, b)
    bytes_ms = counts["bytes"] / PEAK_HBM_BYTES * 1e3
    ops_ms = counts["flops"] / PEAK_FP64_FLOPS * 1e3
    return dict(
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        bytes=counts["bytes"], ops=counts["flops"],
        instr_bound_ms=max(bytes_ms, counts["fp64_instr"] / (sms * FP64_LANES_PER_SM * clock_hz) * 1e3),
        fp64_instr=counts["fp64_instr"], exps=counts["transcendentals"],
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
        ref = _plain(entry, c, h, theta, chunked=False)  # timed as the entry points call it
        _check64(got, ref, f"{name} d={d} B={TIMED_B}")
        max_abs = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        ms = time_ms(lambda: gm_kernel.genz_malik_eval_soa(entry.kernel_id, ct, ht, rows), 50)
        ops_ms = time_ms(lambda: _kernel(entry, c, h, theta), 50)
        plain_ms = time_ms(lambda: _plain(entry, c, h, theta, chunked=False), 20)
        assert gm_kernel.launch_count() - before == 1 + 2 * (3 + 50)
        row = dict(integrand=name, d=d, B=TIMED_B, dtype="float64", ms=ms,
                   ms_via_ops=ops_ms, plain_ms=plain_ms,
                   **_bounds(name, d, TIMED_B, sms, clock_mhz * 1e6),
                   sms=sms, clock_max_mhz=clock_mhz, max_abs_err=max_abs,
                   library_ms=None)
        log("timing: " + json.dumps(row))
        out.append(row)
    return out


# Phase 9's bound on synchronising calls a fleet run beyond one a dispatch
# (the engine's one read): the engine's construction copies the fresh
# store's boxes (two) and the domain width to the card, once a device
SERVICE_SYNC_EXTRA = 3


def phase_service():
    """The batch service's fleet on one rank and on four, then at
    admit_every 4 with sync_every 1 and 4 on one rank and on four; see the
    docstring."""
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
    K = SERVICE["sync_every"]
    # (admit_every, sync_every, ranks)
    for admit_every, sync_every, n in [
        (1, K, 1), (1, K, 4), (4, 1, 1), (4, 1, 4), (4, K, 1), (4, K, 4),
    ]:
        devices = cuda_devices(n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gm_kernel.reset_launch_count()
        (results, sched), wall, sync_calls = _sync_counted(lambda: serve_fleet(
            devices, admit_every=admit_every, sync_every=sync_every))
        launches = gm_kernel.launch_count()
        stats, eng = sched.last_stats, sched.engine
        steps = eng.eval_steps.tolist()
        n_evals = sum(r.n_evals for r in results)
        row = dict(
            phase="service", ranks=n, devices=[str(x) for x in devices],
            admit_every=admit_every, sync_every=sync_every,
            slots=SERVICE["batch_slots"], capacity_per_slot=SERVICE["capacity"],
            requests=len(results), wall_s=wall, requests_per_s=len(results) / wall,
            n_evals=n_evals, evals_per_s=n_evals / wall, iterations=stats["iterations"],
            dispatches=stats["dispatches"],
            iterations_per_dispatch=stats["iterations"] / stats["dispatches"],
            host_reads=eng.host_reads, sync_calls=sync_calls, landed_waits=eng.landed_waits,
            host_sync_points=eng.host_reads + eng.landed_waits,
            launches=launches, eval_steps_per_rank=steps,
            migrations=stats["migrations"], max_memory_allocated=torch.cuda.max_memory_allocated(),
            statuses={s: sum(r.status == s for r in results) for s in {r.status for r in results}},
        )
        log(json.dumps(row))
        assert len(results) == len(requests), row
        # one GM launch per rank per iteration in which the rank had a live
        # slot: nothing is enqueued past a dispatch's first finished slot; on
        # one rank every iteration has one
        assert launches == sum(steps) > 0, row
        assert max(steps) <= stats["iterations"], row
        if n == 1:
            assert steps == [stats["iterations"]], row
        # one read a dispatch, whatever it runs, and one wait an iteration
        assert eng.host_reads == stats["dispatches"], row
        assert eng.landed_waits == stats["iterations"], row
        assert sync_calls <= stats["dispatches"] + SERVICE_SYNC_EXTRA * len(set(devices)), row
        # A request whose regions outgrow its 2^19-row store ends "capacity"
        # (evicted evict_patience iterations after the overflow, as in the
        # JAX service); its best-effort estimate is held to the same bar.
        assert set(row["statuses"]) <= {"converged", "capacity"}, row
        for req, res in zip(requests, results):
            exact = family.exact(d, req.theta)
            budget = max(1e-16, abs(exact) * req.rel_tol)
            assert abs(res.integral - exact) <= 10 * max(res.error, budget), (res, exact)
        runs[admit_every, sync_every, n] = tuples(results), results, row
        total += launches
    for admit_every in (1, 4):
        want = [v[0] for k, v in runs.items() if k[0] == admit_every]
        assert all(t == want[0] for t in want), [
            (a, b) for a, b in zip(want[0], want[-1]) if a != b][:2]
    assert runs[1, K, 4][2]["migrations"] > 0
    phase9 = runs[1, K, 1][1]
    # the first four requests against the single-problem driver on the card
    for req, res in zip(requests[:4], phase9[:4]):
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
    return total, phase9


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


# Phase 11a's bound on synchronising calls a pool run beyond one a dispatch
# (the engine's one read): the iterate's construction copies the domain's
# origin and width to the card (two), and init_state makes one (the grid's
# last edge set from a host scalar), for the fresh slot and for the pool
VEGAS_POOL_SYNC_EXTRA = 4


def phase_vegas_pool():
    """Phase 11a: the VEGAS pool's fleet, routed by backend "auto", at
    (admit_every, sync_every) = (1, 4), (4, 1) and (4, 4)."""
    from repro_torch.core import integrands
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.kernels import vegas_sums as vs

    family = integrands.PARAM_REGISTRY[VEGAS_POOL["integrand"]]
    d = VEGAS_POOL["d"]
    total = 0
    runs = {}
    for admit_every, sync_every in [(1, VEGAS_POOL["sync_every"]), (4, 1), (4, 4)]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        vs.reset_launch_count()
        (results, sched, thetas), wall, sync_calls = _sync_counted(lambda: serve_pool(
            cuda_devices(1), admit_every=admit_every, sync_every=sync_every))
        launches = vs.launch_count()
        stats, eng = sched.last_stats, sched.engine
        n_evals = sum(r.n_evals for r in results)
        row = dict(
            phase="vegas_pool", backend=eng.backend, d=d, slots=VEGAS_POOL["batch_slots"],
            mc_samples=VEGAS_POOL["mc_samples"], rel_tol=VEGAS_POOL["rel_tol"],
            admit_every=admit_every, sync_every=sync_every,
            requests=len(results), wall_s=wall, requests_per_s=len(results) / wall,
            n_evals=n_evals, evals_per_s=n_evals / wall, iterations=stats["iterations"],
            dispatches=stats["dispatches"], host_reads=eng.host_reads,
            landed_waits=eng.landed_waits, sync_calls=sync_calls, launches=launches,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            statuses={s: sum(r.status == s for r in results) for s in {r.status for r in results}},
            largest_errors_off=max(abs(r.integral - family.exact(d, thetas[r.req_id])) / r.error
                                   for r in results),
        )
        log(json.dumps(row))
        assert eng.backend == "vegas" and len(results) == len(thetas), row
        for r in results:
            exact = family.exact(d, thetas[r.req_id])
            assert r.status in ("converged", "max_iters"), r
            assert abs(r.integral - exact) < 5 * r.error, (r, exact)
            assert r.n_evals == VEGAS_POOL["mc_samples"] * r.iterations, r
        # one sums launch per fleet iteration: some slot is live in every
        # one, and nothing is enqueued past a dispatch's first finish
        assert launches == stats["iterations"] > 0, row
        # one read a dispatch, whatever it runs, and one wait an iteration
        assert eng.host_reads == stats["dispatches"], row
        assert eng.landed_waits == stats["iterations"], row
        assert sync_calls <= stats["dispatches"] + VEGAS_POOL_SYNC_EXTRA, row
        runs[admit_every, sync_every] = [
            (r.req_id, r.integral.hex(), r.error.hex(), r.status, r.iterations) for r in results]
        total += launches
    assert runs[4, 1] == runs[4, 4], [(a, b) for a, b in zip(runs[4, 1], runs[4, 4]) if a != b][:2]
    return total


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


# --- the recorder and the GK service (phase 13) --------------------------------


def _sync_counted(fn):
    """``(fn(), wall s, synchronising calls)``: the calls are counted by
    ``torch.cuda.set_sync_debug_mode("warn")`` (not its one-time notice on
    first use), the same for either run of a pair, so the walls compare."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out, wall = _timed(fn)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, wall, sum("called a synchronizing" in str(w.message) for w in caught)


def _trace_problems(events, name, **kw):
    """The checker's findings on the Chrome trace of ``events`` (written under
    the gitignored build/ and removed)."""
    from repro_torch.telemetry.check import check_trace
    from repro_torch.telemetry.trace import write_chrome_trace

    path = os.path.join(HERE, "build", f"trace_{name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_chrome_trace(path, events)
    try:
        return check_trace(path, **kw)
    finally:
        os.remove(path)


def phase_telemetry(smi):
    """Phase 13a: every driver with a recorder against its recorder-off twin
    at phase 4-10's sizes: the same bits, host syncs and synchronising
    calls; a trace that passes the checker; the walls on and off."""
    from repro_torch.core import adaptive
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.distributed import integrate_distributed
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.kernels import genz_malik_eval as gm_kernel
    from repro_torch.kernels import vegas_sums as vs
    from repro_torch.launch.gm_perf import SERVICE, service_requests
    from repro_torch.mc import integrate_vegas
    from repro_torch.service import BatchScheduler
    from repro_torch.service.sharded_selftest import tuples
    from repro_torch.telemetry import NULL, MemorySink, Recorder, loadview

    def bits(res):
        return (res.status, res.iterations, res.n_evals, res.integral.hex(), res.error.hex(),
                res.host_syncs)

    def fleet(devices):
        def run(rec):
            sched = BatchScheduler(QuadratureConfig(**SERVICE), devices=devices, recorder=rec)
            return tuples(sched.serve(service_requests())), sched.last_stats
        return run

    main = {c[0].split(":")[0]: c for c in MAIN_CASES}
    cases = []
    for name in ("f4", "genz_gaussian"):
        integrand, d, rel_tol, capacity = main[name]
        cfg = QuadratureConfig(d=d, integrand=integrand, rel_tol=rel_tol, capacity=capacity)
        for driver in ("integrate", "integrate_device"):
            fn = getattr(adaptive, driver)
            cases.append((f"{driver} {name} d={d}", bits, lambda rec, fn=fn, cfg=cfg:
                          fn(cfg, device="cuda", recorder=rec), {}))
    dist_cfg = QuadratureConfig(d=5, integrand="f6", rel_tol=1e-4, capacity=DIST_CAPACITY)
    cases.append(("distributed f6 d=5, 4 ranks ring", bits, lambda rec: integrate_distributed(
        dist_cfg, devices=cuda_devices(DIST_RANKS), recorder=rec), {}))
    vegas_cfg, _ = vegas_case(*VEGAS_CASES[0])
    cases.append(("integrate_vegas genz_gaussian d=15", lambda r: bits(r) + (r.chi2_dof,),
                  lambda rec: integrate_vegas(vegas_cfg, device="cuda", recorder=rec), {}))
    cases.append(("service fleet, 1 rank", lambda r: r, fleet(cuda_devices(1)), {}))
    cases.append(("service fleet, 4 ranks", lambda r: r, fleet(cuda_devices(4)),
                  dict(n_devices=4, expect_flow_name="service.migrate")))

    gm = mc = 0
    for label, key, run, check_kw in cases:
        gm_kernel.reset_launch_count()
        vs.reset_launch_count()
        off, wall_off, syncs_off = _sync_counted(lambda: run(NULL))
        sink = MemorySink()
        rec = Recorder(sinks=(sink,))
        on, wall_on, syncs_on = _sync_counted(lambda: run(rec))
        gm += gm_kernel.launch_count()
        mc += vs.launch_count()
        row = dict(phase="telemetry", case=label, card=smi, wall_off_s=wall_off,
                   wall_on_s=wall_on, overhead=wall_on / wall_off - 1.0, events=len(sink),
                   sync_calls_off=syncs_off, sync_calls_on=syncs_on)
        if "dist.work_imb" in {e["name"] for e in sink.events}:
            row["work_imb_mean"] = loadview.mean_work_imbalance_from_events(sink.events)
            row["mean_imbalance"] = on.mean_imbalance()
            assert abs(row["work_imb_mean"] - row["mean_imbalance"]) <= 1e-12 * max(
                abs(row["mean_imbalance"]), 1e-300), row
        if "service.dispatches" in rec.counters:
            row["dispatches"] = rec.counters["service.dispatches"]
            row["dispatch_wall_p50_s"] = rec.quantile("service.dispatch_wall_s", 0.5)
            assert rec.hists["service.dispatch_wall_s"]["count"] == row["dispatches"], row
            assert rec.counters["service.iterations"] == on[1]["iterations"], row
        problems = _trace_problems(sink.events, label.split()[0], **check_kw)
        log(json.dumps(row))
        assert key(on) == key(off), (label, key(on), key(off))
        assert syncs_on == syncs_off > 0, row
        assert not problems, (label, problems)
    torch.cuda.empty_cache()
    return gm, mc


def phase_gk_service(smi):
    """Phase 13b: the GK fleet on 1 and 4 ranks, every result bit-equal to
    integrate() with GK on its theta on the card."""
    from repro_torch.core import adaptive, integrands
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.launch.gm_perf import GK_SERVICE, GK_SERVICE_REQUESTS
    from repro_torch.service import BatchScheduler, QuadRequest

    family = integrands.PARAM_REGISTRY[GK_SERVICE["integrand"]]
    d = GK_SERVICE["d"]
    rng = np.random.default_rng(0)
    thetas = [family.sample_theta(d, rng) for _ in range(GK_SERVICE_REQUESTS)]
    runs = {}
    for n in (1, 4):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sched = BatchScheduler(QuadratureConfig(**GK_SERVICE), family, devices=cuda_devices(n))
        results, wall = _timed(lambda: sorted(
            sched.serve([QuadRequest(i, t) for i, t in enumerate(thetas)]),
            key=lambda r: r.req_id))
        stats = sched.last_stats
        n_evals = sum(r.n_evals for r in results)
        row = dict(phase="gk_service", card=smi, ranks=n, slots=GK_SERVICE["batch_slots"],
                   capacity_per_slot=GK_SERVICE["capacity"], rel_tol=GK_SERVICE["rel_tol"],
                   requests=len(results), wall_s=wall, requests_per_s=len(results) / wall,
                   n_evals=n_evals, evals_per_s=n_evals / wall, iterations=stats["iterations"],
                   dispatches=stats["dispatches"], migrations=stats["migrations"],
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   statuses={s: sum(r.status == s for r in results)
                             for s in {r.status for r in results}})
        log(json.dumps(row))
        assert row["statuses"] == {"converged": GK_SERVICE_REQUESTS}, row
        for r in results:
            exact = family.exact(d, thetas[r.req_id])
            assert abs(r.integral - exact) <= 10 * max(r.error, 1e-8 * abs(exact)), (r, exact)
        runs[n] = results
    t0 = time.perf_counter()
    for res, theta in zip(runs[1], thetas):
        cfg = QuadratureConfig(**{**GK_SERVICE, "integrand": integrands.to_spec(family, theta)})
        single = adaptive.integrate(cfg, device="cuda")
        for other in (res, runs[4][res.req_id]):
            assert (other.status, other.iterations, other.n_evals, other.integral.hex(),
                    other.error.hex()) == (single.status, single.iterations, single.n_evals,
                                           single.integral.hex(), single.error.hex()), (
                other, single)
    log(json.dumps(dict(phase="gk_service_vs_integrate", requests=len(thetas),
                        wall_s=time.perf_counter() - t0, bit_equal=True)))
    torch.cuda.empty_cache()


def phase_cli(smi):
    """Phase 13c: the CLIs in process with --trace/--metrics/--strict; both
    exit 0 and their files pass the telemetry checker.  Returns the GM
    launches and a copy of serve_quad's metrics JSONL (phase 14's report
    reads it)."""
    import shutil

    from repro_torch.kernels import genz_malik_eval as gm_kernel
    from repro_torch.launch import integrate as integrate_cli
    from repro_torch.launch import serve_quad
    from repro_torch.telemetry.check import main as check_main

    root = os.path.join(HERE, "build", "cli_telemetry")
    os.makedirs(root, exist_ok=True)
    t = {k: os.path.join(root, k) for k in ("i.json", "i.jsonl", "s.json", "s.jsonl")}
    gm_kernel.reset_launch_count()
    try:
        _, wall_i = _timed(lambda: integrate_cli.main([
            "--integrand", "f4", "--d", "5", "--rel-tol", "1e-7", "--capacity", str(1 << 22),
            "--trace", t["i.json"], "--metrics", t["i.jsonl"], "--telemetry-summary",
            "--strict"]))
        assert check_main(["--trace", t["i.json"], "--metrics", t["i.jsonl"]]) == 0
        _, wall_s = _timed(lambda: serve_quad.main([
            "--d", "3", "--n-requests", "32", "--batch-slots", "8", "--devices", "4",
            "--chaos-fail-device", "2:3:9", "--trace", t["s.json"], "--metrics", t["s.jsonl"],
            "--strict", "--quiet"]))
        assert check_main(["--trace", t["s.json"], "--metrics", t["s.jsonl"], "--devices", "4",
                           "--expect-flow-name", "service.evacuate"]) == 0
        sizes = {k: os.path.getsize(v) for k, v in t.items()}
        os.makedirs(PERF_DIR, exist_ok=True)
        metrics = shutil.copy(t["s.jsonl"], os.path.join(PERF_DIR, "serve_quad_metrics.jsonl"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = gm_kernel.launch_count()
    log(json.dumps(dict(phase="cli", card=smi, integrate_wall_s=wall_i, serve_quad_wall_s=wall_s,
                        file_bytes=sizes, gm_launches=launches)))
    assert launches > 0
    return launches, metrics


def _example(name):
    """``main`` of ``examples/<name>.py``, loaded by path."""
    import runpy

    return runpy.run_path(os.path.join(HERE, "examples", name + ".py"))["main"]


def phase_observatory(smi, main_rows, timings, metrics_path):
    """Phase 14: the performance observatory (repro_torch.perf) and the
    three examples on the card; see the docstring.  Returns the GM
    launches of the examples' runs."""
    import contextlib
    import io

    from repro_torch.core import adaptive, rules
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.distributed import integrate_distributed
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.kernels import genz_malik_eval as gm_kernel
    from repro_torch.perf import catalog, machine, report

    os.makedirs(PERF_DIR, exist_ok=True)
    # (a) the machine file
    m = machine.profile_machine(fast=True, device="cuda")
    machine.save_machine(m, os.path.join(PERF_DIR, "machine.json"))
    log(json.dumps(dict(phase="machine", card=smi, peak_flops=m["peak_flops"],
                        matmul_f32_flops=m["probes"]["matmul_f32"]["flops_per_s"],
                        mem_bw=m["mem_bw"], reduce_bw=m["reduce_bw"], ici_bw=m["ici_bw"],
                        matmul_n=m["probes"]["matmul_f64"]["n"],
                        stream_n=m["probes"]["saxpy"]["n"], meta=m["meta"])))
    assert m["meta"]["platform"] == "gpu" and m["peak_flops"] > 0 and m["mem_bw"] > 0

    # (b) the catalog at the card-scale configs
    cat = catalog.build_catalog(m, fast=False, reps=3, device="cuda")
    catalog.save_catalog(cat, os.path.join(PERF_DIR, "kernel_catalog.json"))
    keys = ("kernel", "integrand", "d", "rung", "scan_trips", "flops", "bytes", "measured_s",
            "predicted_s", "roofline_frac", "dominant", "launches")
    for e in cat["entries"]:
        log("catalog: " + json.dumps({k: e.get(k) for k in keys}))
    for t in timings:  # phase 8's _bounds at B = TIMED_B
        e = next(e for e in cat["entries"] if e["kernel"] == "gm_eval"
                 and (e["integrand"], e["d"], e["rung"]) == (t["integrand"], t["d"], t["B"]))
        want = GM_COUNTS[(t["integrand"], t["d"])]
        assert (e["flops"], e["bytes"]) == want == (t["ops"], t["bytes"]), (e, t)
    for e in cat["entries"]:
        gm_launches = {"gm_eval": 1, "advance": 0, "vegas_iterate": 0,
                       "service_dispatch": e["scan_trips"]}[e["kernel"]]
        sums_launches = 1 if e["kernel"] == "vegas_iterate" else 0
        assert e["launches"] == {"genz_malik_eval": gm_launches, "vegas_sums": sums_launches}, e
    torch.cuda.empty_cache()

    # (c) the report, from (a), (b) and phase 13c's metrics JSONL
    md = report.render_markdown(m, cat, report.BENCH_DIR, metrics_path, "cuda")
    with open(os.path.join(PERF_DIR, "PERF_REPORT.md"), "w") as f:
        f.write(md)
    for section in ("## Machine", "## Kernel cost catalog", "## Benchmark trajectory",
                    "## Service latency & idle"):
        assert section in md, section
    assert "service.dispatch_wall_s" in md and "idle fraction" in md

    # (d) a callable f4 through integrate: the torch route, no GM launch;
    # beside it a warm run of the registry f4 (the kernel route)
    f4 = main_rows[0]
    name, d, rel_tol, capacity = MAIN_CASES[0]
    cfg = QuadratureConfig(d=d, integrand=name, rel_tol=rel_tol, capacity=capacity)
    user_f4 = lambda x: torch.exp(-625.0 * sum((x[k] - 0.5) ** 2 for k in range(x.shape[0])))  # noqa: E731
    _, registry_wall = _timed(lambda: adaptive.integrate(cfg, device="cuda"))
    gm_kernel.reset_launch_count()
    plain_calls = []
    plain = rules.gm_eval_reference
    rules.gm_eval_reference = lambda *a: plain_calls.append(1) or plain(*a)
    try:
        res, wall = _timed(lambda: adaptive.integrate(cfg, user_f4, device="cuda"))
        whole_calls = len(plain_calls)
        # the same run with the torch route's blocks cut to 2^16 regions
        rules.BLOCK_ELEMS, block_elems = d << 16, rules.BLOCK_ELEMS
        try:
            blocked, blocked_wall = _timed(lambda: adaptive.integrate(cfg, user_f4, device="cuda"))
        finally:
            rules.BLOCK_ELEMS = block_elems
    finally:
        rules.gm_eval_reference = plain
    blocked_calls = len(plain_calls) - whole_calls
    row = dict(phase="callable_f4", card=smi, d=d, rel_tol=rel_tol, status=res.status,
               iterations=res.iterations, n_evals=res.n_evals, integral=res.integral,
               error=res.error, registry_integral=f4["integral"], registry_error=f4["error"],
               bit_equal=(res.integral, res.error) == (f4["integral"], f4["error"]),
               wall_s=wall, registry_warm_wall_s=registry_wall,
               plain_calls=whole_calls, blocked_calls=blocked_calls,
               blocked_wall_s=blocked_wall, gm_launches=gm_kernel.launch_count())
    log(json.dumps(row))
    assert row["gm_launches"] == 0, row
    assert blocked_calls > whole_calls, row
    assert (blocked.integral, blocked.error, blocked.status, blocked.iterations,
            blocked.n_evals) == (res.integral, res.error, res.status, res.iterations,
                                 res.n_evals), row
    assert (res.status, res.iterations, res.n_evals) == (
        f4["status"], f4["iterations"], f4["n_evals"]), row
    assert abs(res.integral - f4["integral"]) <= 1e-12 * abs(f4["integral"]), row
    # the other drivers take the callable too: integrate_device with
    # integrate's bits, four ring ranks with phase 6's counts
    loop, loop_wall = _timed(lambda: adaptive.integrate_device(cfg, user_f4, device="cuda"))
    dist_cfg = QuadratureConfig(d=d, integrand=name, rel_tol=rel_tol, capacity=DIST_CAPACITY)
    ranks, ranks_wall = _timed(lambda: integrate_distributed(
        dist_cfg, user_f4, devices=cuda_devices(DIST_RANKS)))
    row = dict(phase="callable_f4_drivers", card=smi, device_loop_wall_s=loop_wall,
               device_loop=(loop.status, loop.iterations, loop.n_evals),
               ranks_wall_s=ranks_wall, ranks=(ranks.status, ranks.iterations, ranks.n_evals,
                                               ranks.evals_per_device.tolist()),
               gm_launches=gm_kernel.launch_count())
    log(json.dumps(row))
    assert row["gm_launches"] == 0, row
    assert (loop.integral, loop.error, loop.iterations, loop.n_evals) == (
        res.integral, res.error, res.iterations, res.n_evals), row
    got = (ranks.iterations, int(ranks.n_evals), [int(x) for x in ranks.evals_per_device])
    assert ranks.status == "converged" and got == EXPECTED_DIST["f4-ring"], row

    # (e) the three examples, in process
    gm_kernel.reset_launch_count()
    with contextlib.redirect_stdout(io.StringIO()):
        quick = _example("torch_quickstart")("cuda")
        dist = _example("torch_distributed_quadrature")("cuda")
        batch = _example("torch_batch_service")("cuda")
    launches = gm_kernel.launch_count()
    row = dict(phase="examples", card=smi, gm_launches=launches,
               quickstart={k: v["true_rel_err"] for k, v in quick.items()},
               distributed={k: (v["true_rel_err"], v["mean_imbalance"]) for k, v in dist.items()},
               batch_service=(batch["worst_true_rel_err"], batch["worst_vs_bar"]))
    log(json.dumps(row))
    for case in quick.values():
        assert case["result"].status == "converged", row
        assert case["true_rel_err"] <= 5 * case["rel_tol"], row
    for case in dist.values():
        assert case["result"].status == "converged", row
        assert case["true_rel_err"] <= 10 * case["rel_tol"], row
    assert dist["ring"]["mean_imbalance"] < dist["off"]["mean_imbalance"], row
    assert all(r.status == "converged" for r in batch["batch"] + batch["served"]), row
    assert batch["worst_vs_bar"] <= 10, row
    assert launches > 0
    os.remove(metrics_path)
    return launches


def phase_lm(smi):
    """Phase 15: the LM serve path at full width and the smoke configs on
    the card (lm_perf.py), then the serve CLI at full width; no GM or sums
    launch."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.kernels import genz_malik_eval as gm_kernel
    from repro_torch.kernels import vegas_sums as vs
    from repro_torch.launch import lm_perf

    gm_kernel.reset_launch_count()
    vs.reset_launch_count()
    for arch in lm_perf.SERVE_ARCHS:
        row = lm_perf.serve_case(lm_perf.full_width(arch), device="cuda", **lm_perf.SERVE_SHAPE)
        log(json.dumps(dict(phase="lm_serve", card=smi, **row)))
        torch.cuda.empty_cache()
    for arch in ARCH_IDS:
        log(json.dumps(dict(phase="lm_smoke", card=smi, **lm_perf.smoke_vs_cpu(arch, "cuda"))))
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "deepseek-7b",
           "--batch", "4", "--prompt-len", "64", "--new-tokens", "16"]
    t_cli = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")),
                          capture_output=True, text=True, timeout=600)
    log(json.dumps(dict(phase="lm_cli", card=smi, returncode=proc.returncode,
                        wall_s=time.perf_counter() - t_cli, stdout=proc.stdout.splitlines()[-3:],
                        stderr=proc.stderr.splitlines()[-5:])))
    assert proc.returncode == 0, proc.stderr
    assert gm_kernel.launch_count() == 0 and vs.launch_count() == 0


def phase_lm_train(smi):
    """Phase 16: the LM training path at full width, the remat policies,
    the smoke configs against the CPU, resume, the train CLI and the two LM
    examples (lm_perf.py train); no GM or sums launch."""
    import shutil
    import tempfile

    from repro_torch.kernels import genz_malik_eval as gm_kernel
    from repro_torch.kernels import vegas_sums as vs
    from repro_torch.launch import lm_perf

    gm_kernel.reset_launch_count()
    vs.reset_launch_count()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="lm_train_", dir=os.path.join(HERE, "build"))
    try:
        for row in lm_perf.train_all(smi, os.path.join(work, "resume")):
            log(json.dumps({"phase": row.pop("what"), **row}))
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        base = [sys.executable, "-m", "repro_torch.launch.train"]
        smoke = ["--arch", "deepseek-7b", "--smoke", "--microbatches", "2", "--remat", "dots",
                 "--grad-compression", "bf16_ef", "--ckpt-dir", os.path.join(work, "cli"),
                 "--ckpt-every", "4"]
        runs = [["--arch", "mamba2-370m", "--steps", "20", "--batch", "4", "--seq", "512"],
                smoke + ["--steps", "6"], smoke + ["--steps", "12"]]
        for args in runs:
            t_cli = time.perf_counter()
            proc = subprocess.run(base + args, cwd=HERE, env=env, capture_output=True, text=True,
                                  timeout=600)
            log(json.dumps(dict(phase="lm_train_cli", card=smi, args=args,
                                returncode=proc.returncode, wall_s=time.perf_counter() - t_cli,
                                stdout=proc.stdout.splitlines()[-4:],
                                stderr=proc.stderr.splitlines()[-5:])))
            assert proc.returncode == 0, proc.stderr
        assert "resumed at step 6" in proc.stdout, proc.stdout
        served = _example("torch_serve_lm")(device="cuda")
        trained = _example("torch_train_lm")(device="cuda", ckpt_dir=os.path.join(work, "example"))
        assert served["tokens"].shape == (4, 32)
        assert trained["start"] == 0 and len(trained["losses"]) == 40
        assert all(math.isfinite(x) for x in trained["losses"])
        assert trained["losses"][-1] < trained["losses"][0], trained["losses"]
        log(json.dumps(dict(phase="lm_examples", card=smi, serve_tokens_per_s=served["tokens_per_s"],
                            train_losses=trained["losses"][::5] + trained["losses"][-1:])))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    assert gm_kernel.launch_count() == 0 and vs.launch_count() == 0


# phase 17's cells (arch, shape, multi-pod), at their published widths:
# every step kind, both meshes, a MoE architecture, the MLA decode override
# and the encoder.  Each is traced at a cut depth (_cell_depth).
DRYRUN_CELLS = (
    ("deepseek-7b", "train_4k", False),
    ("hubert-xlarge", "prefill_32k", False),
    ("deepseek-v2-236b", "decode_32k", False),
    ("qwen3-moe-235b-a22b", "decode_32k", True),
    ("mamba2-370m", "long_500k", True),
)
# a predicted peak's largest relative distance from the card's
CALIBRATION_TOL = 0.10


def _calibration_programs():
    """(name, config, shape, build_cell keywords, run) for phase 17b; ``run``
    builds the same program's arguments on cuda:0 and runs it."""
    import dataclasses

    from repro_torch.launch import lm_perf
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models.model import cache_init, model_init, model_prefill
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train import TrainConfig, make_train_step

    serve_cfg = lm_perf.full_width("deepseek-7b")
    train_cfg = dataclasses.replace(serve_cfg, n_layers=lm_perf.TRAIN_LAYERS)
    batch, prompt, cache_len = 4, 512, 544
    rng = np.random.default_rng(0)

    def prefill():
        model = model_init(serve_cfg, 0, device="cuda")
        with torch.no_grad():  # bf16 serving weights, as the dry run deploys them
            for mod in model.modules():
                for name, p in list(mod.named_parameters(recurse=False)):
                    if p.dim() >= 2:
                        setattr(mod, name, torch.nn.Parameter(p.to(torch.bfloat16), requires_grad=False))
        tokens = torch.as_tensor(rng.integers(0, serve_cfg.vocab_size, (batch, prompt)), device="cuda")
        caches = cache_init(serve_cfg, batch, cache_len, device="cuda")

        @torch.no_grad()
        def program():
            return model_prefill(serve_cfg, model, tokens, caches)

        return program

    def train():
        model = model_init(train_cfg, 0, device="cuda")
        tcfg = TrainConfig(remat="full")
        opt = init_opt_state(tcfg.opt, dict(model.named_parameters()))
        data = {k: torch.as_tensor(rng.integers(0, train_cfg.vocab_size, (2, 2048)), device="cuda")
                for k in ("tokens", "labels")}
        step = make_train_step(train_cfg, tcfg)
        return lambda: step(model, opt, data)

    return (
        ("deepseek-7b prefill 4x512 into 544", serve_cfg, ShapeSpec("calibration", prompt, batch, "prefill"),
         dict(cache_len=cache_len), prefill),
        (f"deepseek-7b[{lm_perf.TRAIN_LAYERS} layers] train 2x2048", train_cfg,
         ShapeSpec("calibration", 2048, 2, "train"), dict(microbatches=1, remat="full"), train),
    )


def _cell_depth(cfg):
    """A dry-run cell's depth: the dense layers that lead, then two periods
    of the layer pattern, so every kind of layer is traced, and repeated;
    each layer's trace costs host seconds at the published widths."""
    return cfg.first_k_dense + 2 * cfg.block_pattern_period


def phase_dryrun(smi):
    """Phase 17: (a) DRYRUN_CELLS on fake cuda meshes, (b) the memory
    model's calibration on the card."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import genz_malik_eval as gm_kernel
    from repro_torch.kernels import vegas_sums as vs
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    gm_kernel.reset_launch_count()
    vs.reset_launch_count()
    for arch, shape, multi in DRYRUN_CELLS:
        mb = dryrun.MICROBATCH_DEFAULTS.get(arch, 8)
        depth = _cell_depth(get_config(arch))
        rec = dryrun.run_cell(arch, shape, multi, device="cuda", microbatches=mb, n_layers=depth)
        log(json.dumps(dict(phase="dryrun", card=smi, n_layers=depth, **rec)))
        assert rec["status"] == "ok", rec
        assert rec["flops"] > 0 and rec["collectives"]["count"] > 0, rec
    t_cells = time.perf_counter() - t0
    log(f"phase 17a: {t_cells:.1f} s")

    for name, cfg, shape, kw, run in _calibration_programs():
        mesh = dryrun.fake_mesh((1, 1), ("data", "model"), "cuda")
        predicted = dryrun.trace_cell(cfg, shape, mesh, device="cuda", **kw)["peak_bytes"]
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        program = run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = program()
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - before
        del program, out
        torch.cuda.empty_cache()
        ratio = predicted / measured
        log(json.dumps(dict(phase="dryrun_calibration", card=smi, program=name,
                            predicted_bytes=predicted, measured_bytes=measured, ratio=ratio)))
        assert abs(ratio - 1) <= CALIBRATION_TOL, (name, predicted, measured)
    dist.destroy_process_group()
    assert gm_kernel.launch_count() == 0 and vs.launch_count() == 0


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


def _stopwatch():
    """stamp(label) logs the seconds since the last stamp and since the
    first, so that a run's log shows where its time limit goes."""
    t0 = last = time.perf_counter()

    def stamp(label):
        nonlocal last
        now = time.perf_counter()
        log(f"time: {label} {now - last:.1f} s, {now - t0:.1f} s in all")
        last = now

    return stamp


def main():
    smi = phase_device()
    stamp = _stopwatch()
    phase_build()
    stamp("phase 2 (build)")
    phase_kernel_vs_plain()
    stamp("phase 3 (GM kernel vs plain)")
    round_err, round_timings = phase_round_kernels(smi)
    stamp("phase 3b (round kernels)")
    launches, main_rows = phase_main_path()
    launches += phase_device_loop(main_rows)
    stamp("phases 4-5 (main path, device loop)")
    dist_launches, round_launches = phase_distributed(main_rows, smi)
    launches += dist_launches
    stamp("phase 6 (distributed)")
    phase_gauss_kronrod()
    timings = phase_timing()
    stamp("phases 7-8 (Gauss-Kronrod, GM timing)")
    service_launches, phase9 = phase_service()
    launches += service_launches
    stamp("phase 9 (service)")
    phase_vegas_kernel_vs_plain()
    vegas_launches, _ = phase_vegas()
    vegas_launches += phase_vegas_pool()
    stamp("phases 10-11a (VEGAS)")
    gm_graceful, mc_graceful, _ = phase_graceful(phase9)
    launches += gm_graceful
    vegas_launches += mc_graceful
    gm_resilience, mc_resilience = phase_resilience(phase9, smi)
    launches += gm_resilience
    vegas_launches += mc_resilience
    stamp("phases 11b-12 (graceful, resilience)")
    gm_telemetry, mc_telemetry = phase_telemetry(smi)
    launches += gm_telemetry
    vegas_launches += mc_telemetry
    phase_gk_service(smi)
    cli_launches, metrics_path = phase_cli(smi)
    launches += cli_launches
    stamp("phase 13 (telemetry, GK service, CLI)")
    launches += phase_observatory(smi, main_rows, timings, metrics_path)
    stamp("phase 14 (observatory)")
    phase_lm(smi)
    stamp("phase 15 (LM serve)")
    phase_lm_train(smi)
    stamp("phase 16 (LM train)")
    phase_dryrun(smi)
    stamp("phase 17 (dry run)")
    vt, *others = phase_vegas_timing()
    stamp("sums timing")
    t = timings[0]
    kernel = dict(
        name="genz_malik_eval", route="cuda",
        source="src/repro_torch/kernels/csrc/gm_kernel.cuh",
        replaces="src/repro/kernels/genz_malik_eval.py:46",
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
    t = round_timings[0]
    at = f"d={t['d']} cap={ROUND_TIMED['cap']} C={ROUND_TIMED['capacity']} float64"
    rounds = [
        dict(name="redistribute_round", route="cuda",
             source="src/repro_torch/kernels/csrc/redistribute_round.cu",
             replaces="src/repro/core/redistribution.py:145 (redistribute: stats, counts, "
                      "retire and splice of one round, every rank of a device in one launch; "
                      "XLA, no TPU kernel)",
             launches=round_launches["round"], max_abs_err=round_err,
             **{k: t["round"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "kernel_ms", "host_ms",
                 "device_ms")},
             launch_floor_ms=t["floor"]["ms"], launch_floor_kernel_ms=t["floor"]["kernel_ms"],
             at=f"{at}, four ranks on one card, the whole round",
             other_shapes=[dict(d=x["d"], **x["round"]) for x in round_timings[1:]]),
        dict(name="redistribute_pack", route="cuda",
             source="src/repro_torch/kernels/csrc/redistribute_round.cu",
             replaces="src/repro/core/redistribution.py:192 (redistribute, the payload; XLA, "
                      "no TPU kernel)",
             # it runs only for a donor whose receiver is on another card:
             # phase 6's four ranks share one card, so its count there is 0
             launches=round_launches["pack"], max_abs_err=round_err,
             **{k: t["pack"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "kernel_ms")},
             at=f"{at}, one donor's block",
             other_shapes=[dict(d=x["d"], **x["pack"]) for x in round_timings[1:]]),
    ]
    log(f"card: {smi}")
    log(json.dumps({"kernels": [kernel, sums, *rounds]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
