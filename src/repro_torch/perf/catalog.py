"""Kernel cost catalog: count the work, time the port's own steps, predict.

The port's counterpart of the JAX package's ``repro.perf.catalog``, for the
same four kinds: the GM rule evaluation at each eval-window rung
(``make_eval_step``), the windowed advance at each advance rung
(``make_advance_step``, ``rung // 2`` live regions), the VEGAS iterate
(``mc.engine.make_iterate``) and the batch service's dispatch
(``BatchEngine.run``).  For each, this module

1. builds the JAX catalog's representative input (a region store with the
   window full of random live boxes, a fresh VEGAS state, a fleet admitted
   at tolerances no slot reaches within one dispatch),
2. counts the work's FLOPs and bytes with one documented formula per kind
   (:func:`gm_eval_counts`, :func:`advance_counts`, :func:`vegas_counts`,
   :func:`service_counts`): a function of (kernel, d, rung or samples,
   integrand, dtype) that reads the same work whatever implements it.  The
   JAX catalog reads XLA's ``cost_analysis()``, a function of the compiled
   program; torch has no such count.  Where the work depends on the data
   (the advance's splits, the dispatch's windows) the count is what this
   input needs, read from the run;
3. times the step with CUDA events after a warm call, best of ``reps``, on
   a fresh copy of the input each time (the steps update their state in
   place), and records how many times one call launched the GM kernel and
   the sums kernel (``launch_count()``);
4. predicts ``predicted_s = max(flops / peak_flops, bytes / mem_bw)`` from
   a machine file (:mod:`repro_torch.perf.machine`), as the JAX catalog
   does.  On an H100 ``peak_flops`` is the FP64 tensor-core rate of a
   matmul, which the GM kernel cannot use, so its ``predicted_s`` is
   optimistic by about 2x: ``chip_smoke.py::_bounds`` divides the same
   count by the 34 TFLOP/s vector rate.

``scan_trips``: the dispatch's ``flops`` and ``bytes`` are per executed
iteration (their mean), and ``scan_trips`` is the ``executed`` count of
``BatchEngine.run``, so :func:`predict` scales them exactly as the JAX
catalog scales its scan bodies; every other kind has ``scan_trips = 1``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.adaptive import resolve_device
from repro_torch.core.genz_malik import n_nodes
from repro_torch.perf.machine import DEFAULT_PATH as MACHINE_PATH, resolve_machine

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)

#: default catalog location, next to the machine file it was predicted from
DEFAULT_PATH = os.path.join(_REPO, "results", "perf_torch", "kernel_catalog.json")

#: kernel names the catalog can produce (report + tests key off these)
KERNELS = ("gm_eval", "advance", "vegas_iterate", "service_dispatch")

# --- the counts ----------------------------------------------------------------

#: operations per point of each plain integrand (core/integrands.py), with
#: exp, cos and pow one operation each: per axis its elementwise operations
#: and the one add or multiply that folds it, then the finish.  f4:
#: x - 0.5, t * t, + per axis, then -625 * s and exp; genz_gaussian:
#: x - u, a * t, t * t, + per axis, then the negation and exp.
POINT_OPS: Dict[str, Callable[[int], int]] = {
    "f1": lambda d: 2 * d + 1,  # i * x, +; cos
    "f2": lambda d: 5 * d,  # x - 0.5, t * t, b^2 +, 1 /, *
    "f3": lambda d: 2 * d + 2,  # i * x, +; 1 +, pow
    "f4": lambda d: 3 * d + 2,
    "f5": lambda d: 3 * d + 2,  # x - 0.5, abs, +; -10 *, exp
    "f6": lambda d: 4 * d + 2,  # x <= cut, and, (i + 4) * x, +; exp, select
    "f7": lambda d: 2 * d + 5,  # x * x, +; s^11 by five multiplies
    "genz_gaussian": lambda d: 4 * d + 2,
    "genz_product_peak": lambda d: 7 * d,  # a * a, 1 /, x - u, t * t, +, 1 /, *
    "monomial": lambda d: 2 * d,  # pow, *
}
#: exp, cos or pow per point of each plain integrand
POINT_TRANSCENDENTALS: Dict[str, Callable[[int], int]] = {
    "f1": lambda d: 1, "f2": lambda d: 0, "f3": lambda d: 1, "f4": lambda d: 1,
    "f5": lambda d: 1, "f6": lambda d: 1, "f7": lambda d: 0,
    "genz_gaussian": lambda d: 1, "genz_product_peak": lambda d: 0, "monomial": lambda d: d,
}
#: the GM kernel's table form (kernels/csrc/integrands.cuh): instructions
#: of one term and of the finish, a math-library call counted as one
TERM_INSTR = {"f1": 1, "f2": 4, "f3": 1, "f4": 2, "f5": 2, "f6": 3, "f7": 1,
              "genz_gaussian": 3, "genz_product_peak": 6, "monomial": 1}
FINISH_INSTR = {"f1": 1, "f2": 0, "f3": 2, "f4": 2, "f5": 2, "f6": 3, "f7": 5,
                "genz_gaussian": 1, "genz_product_peak": 0, "monomial": 0}
_ITEM = {"float64": 8, "float32": 4}


def _name(integrand: str) -> str:
    """The registry name of an integrand or of a family spec."""
    return integrand.split(":")[0]


def gm_eval_counts(integrand: str, d: int, b: int, dtype: str = "float64") -> Dict[str, int]:
    """The GM kernel's work on ``b`` regions of dimension ``d``.

    - ``bytes``: (2d + 3 + d) * b * item, the centres and half-widths read
      once and i7, i5, i3 and the d fourth differences written once;
    - ``flops``: n_nodes(d) * the plain integrand's per-point operations
      (:data:`POINT_OPS`) + 4d + 20 per region.  These recompute every
      axis's factor at every node, which the kernel's table form does not,
      and an FMA counts two: a shared yardstick across PRs, not a least
      time of the kernel;
    - ``fp64_instr``: the table form's instructions (of the working type):
      the 8d coordinates (4d products lambda * h, 8d adds and subtracts),
      9d terms, and per node its d - 1 folds, its finish and one add into
      its group's sum; the scale (d - 1), the fourth differences (6d + 1)
      and the weighted sums (22);
    - ``transcendentals``: exp, cos and pow calls of the plain form;
    - ``epilogue_flops`` and ``epilogue_bytes``: what the evaluate step adds
      to the kernel, the two-level error estimate (~25 operations), the
      volume (2d), the largest difference (d) and the axis choice (3d + 2)
      per region, and the est, err and axis written and the active and
      fresh masks read.  They are not in ``flops`` and ``bytes``, which stay
      the kernel's.
    """
    name = _name(integrand)
    nodes = n_nodes(d)
    item = _ITEM[dtype]
    return {
        "bytes": (2 * d + 3 + d) * b * item,
        "flops": (nodes * POINT_OPS[name](d) + 4 * d + 20) * b,
        "fp64_instr": (12 * d + 9 * d * TERM_INSTR[name] + nodes * (d + FINISH_INSTR[name])
                       + (d - 1) + (6 * d + 1) + 22) * b,
        "transcendentals": nodes * POINT_TRANSCENDENTALS[name](d) * b,
        "epilogue_flops": (6 * d + 27) * b,
        "epilogue_bytes": (2 * item + 6) * b,
    }


def advance_counts(d: int, live: int, split: int, dtype: str = "float64") -> Dict[str, int]:
    """A lower bound of one advance (classify, split, compact) over ``live``
    regions of which ``split`` split.

    - ``bytes``: each live region's row read once (centres, half-widths,
      est, err, axis, active, fresh: (2d + 2) * item + 6), each child row
      written once (2 * split rows of the same width), and the sort counted
      as one pass over the live keys (an error read, an index written).
      ``sort_passes`` says so: torch's CUDA radix sort makes 8 passes of 8
      bits over 64-bit keys (16 over a window's keys and indices, read and
      written), which the bound leaves out;
    - ``flops``: per live region the classifier (the volume 2d, the width
      floor 2d, ~10 compares and arithmetic) and the four masked sums of the
      global and finalised estimates, 4d + 14; per split parent 3 (the half
      width and the two centres).
    """
    item = _ITEM[dtype]
    row = (2 * d + 2) * item + 6
    return {
        "bytes": live * row + 2 * split * row + live * (item + 8),
        "flops": (4 * d + 14) * live + 3 * split,
        "sort_passes": 1,
    }


def vegas_counts(integrand: str, d: int, samples: int, bins: int, cubes: int, shards: int,
                 dtype: str = "float64") -> Dict[str, Any]:
    """One VEGAS iteration of ``samples`` points.

    - ``flops``: per sample the stratified draw's y (2d), the map through
      the grid (6d: bin, offset, two edges' difference, the point and the
      Jacobian), the integrand (:data:`POINT_OPS`), the weight (2) and the
      sums (Σw, Σw² and the d per-bin Σw²: d + 3); per cube and per bin ~10
      for the refinement;
    - ``bytes``: the grid and the per-cube weights and counts read, the
      per-shard per-cube Σw and Σw² and per-bin Σw² written, and the new
      grid and weights written.  The uniforms are drawn on the card and
      need never reach memory, so the operations bound the iteration
      (``bound_by``); the port does write them, and its samples' (d, N)
      arrays, which the bound leaves out.
    """
    item = _ITEM[dtype]
    grid = d * (bins + 1) * item
    return {
        "flops": samples * (9 * d + POINT_OPS[_name(integrand)](d) + 5) + 10 * (cubes + d * bins),
        "bytes": 2 * grid + cubes * (2 * item + 8) + shards * (2 * cubes + d * bins) * item,
        "bound_by": "operations",
    }


def service_counts(integrand: str, d: int, iterations: Sequence[Dict[str, int]],
                   dtype: str = "float64") -> Dict[str, Any]:
    """The dispatch: per executed iteration the GM evaluation of the live
    slots' windows (``eval_rows``: each live slot's window at its rank's
    rung) and the advance of their ``live`` regions, ``split`` of which
    split.  Returns the mean per iteration and ``executed``."""
    flops = bytes_ = 0
    for it in iterations:
        gm = gm_eval_counts(integrand, d, it["eval_rows"], dtype)
        adv = advance_counts(d, it["live"], it["split"], dtype)
        flops += gm["flops"] + gm["epilogue_flops"] + adv["flops"]
        bytes_ += gm["bytes"] + gm["epilogue_bytes"] + adv["bytes"]
    n = len(iterations)
    return {"flops": flops / n, "bytes": bytes_ / n, "executed": n}


# --- timing ----------------------------------------------------------------------


def _launches() -> Dict[str, int]:
    from repro_torch.kernels import genz_malik_eval as gm_kernel
    from repro_torch.kernels import vegas_sums as vs

    return {"genz_malik_eval": gm_kernel.launch_count(), "vegas_sums": vs.launch_count()}


def _time_step(step: Callable, prepare: Callable, reps: int, device: torch.device):
    """``(best seconds, launches of one call, last output)`` of
    ``step(prepare())``: one warm call (its launches counted), then
    ``reps`` timed calls, each on a fresh ``prepare()`` made outside the
    timed region.  CUDA events on the card, the host clock on the CPU."""
    before = _launches()
    out = step(prepare())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = {k: v - before[k] for k, v in _launches().items()}
    best = float("inf")
    for _ in range(max(1, reps)):
        arg = prepare()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(arg)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = step(arg)
            best = min(best, time.perf_counter() - t0)
        del arg
    return best, launches, out


def predict(entry: Dict[str, Any], machine: Dict[str, Any]) -> Dict[str, Any]:
    """Attach roofline predictions from ``machine`` to a measured entry.

    Returns a new dict; ``entry`` is not mutated.  ``flops_total`` /
    ``bytes_total`` are the counts scaled by the trip count (see the module
    docstring); ``roofline_frac`` is predicted/measured wall time.
    """
    trips = int(entry.get("scan_trips", 1))
    flops = entry["flops"] * trips
    byts = entry["bytes"] * trips
    compute_s = flops / machine["peak_flops"]
    memory_s = byts / machine["mem_bw"]
    predicted = max(compute_s, memory_s)
    measured = entry["measured_s"]
    return {
        **entry,
        "flops_total": flops,
        "bytes_total": byts,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "predicted_s": predicted,
        "dominant": "compute" if compute_s >= memory_s else "memory",
        "roofline_frac": (predicted / measured) if measured > 0 else 0.0,
        "achieved_gflops": flops / measured / 1e9 if measured > 0 else 0.0,
        "achieved_gbs": byts / measured / 1e9 if measured > 0 else 0.0,
    }


# --- representative inputs -------------------------------------------------------


def _random_store(cfg, device, seed: int = 0):
    """A region store of random boxes in every row, none of them live.

    The JAX catalog's boxes: well inside the unit domain (centres in
    [0.2, 0.8], half-widths in [0.01, 0.1]).  :func:`_with_live` makes the
    leading rows live.
    """
    from repro_torch.core import region_store

    rng = np.random.default_rng(seed)
    C, d = cfg.capacity, cfg.d
    dtype = getattr(torch, cfg.dtype)
    state = region_store.empty_state(C, d, dtype, device)
    state.centers.copy_(torch.as_tensor(rng.uniform(0.2, 0.8, (C, d)), dtype=dtype))
    state.halfw.copy_(torch.as_tensor(rng.uniform(0.01, 0.1, (C, d)), dtype=dtype))
    return state


def _clone(state):
    return dataclasses.replace(
        state, **{f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)}
    )


def _with_live(store, n_active: int):
    """A copy of ``store`` whose leading ``n_active`` rows are live and
    fresh, everything beyond inactive: the compaction invariant's shape."""
    state = _clone(store)
    state.active[:n_active] = True
    state.fresh[:n_active] = True
    return state


def _configs(cfgs) -> list:
    return list(cfgs) if isinstance(cfgs, (list, tuple)) else [cfgs]


def gm_eval_entries(cfg, reps: int, device) -> List[Dict[str, Any]]:
    """GM rule evaluation at every eval-window rung, window full of work."""
    from repro_torch.core.adaptive import eval_ladder, make_eval_step
    from repro_torch.core.rules import make_rule

    rule = make_rule(cfg)
    store = _random_store(cfg, device)
    out = []
    for w in eval_ladder(cfg):
        step = make_eval_step(cfg, rule, window=w)
        measured, launches, _ = _time_step(step, lambda: _with_live(store, w), reps, device)
        counts = gm_eval_counts(cfg.integrand, cfg.d, w, cfg.dtype)
        out.append({
            "kernel": "gm_eval", "d": cfg.d, "rung": w, "scan_trips": 1,
            "measured_s": measured, **counts, "launches": launches,
            "integrand": _name(cfg.integrand), "dtype": cfg.dtype, "route": rule.route,
            "regions": w, "evals_per_region": rule.n_evals_per_region,
        })
    return out


def advance_entries(cfg, reps: int, device) -> List[Dict[str, Any]]:
    """Windowed advance (classify + split + compact) at every advance rung.

    The representative population is ``rung // 2`` live regions, the
    largest count whose doubled advance target the rung still covers; the
    split count is what this population's classification leaves.
    """
    from repro_torch.core.adaptive import (
        advance_ladder, classify_window, make_advance_step, make_eval_step,
    )
    from repro_torch.core.rules import make_rule

    lo = np.asarray(cfg.lo(), np.float64)
    hi = np.asarray(cfg.hi(), np.float64)
    total_volume = float(np.prod(hi - lo))
    rule = make_rule(cfg)
    store = _random_store(cfg, device)
    width = torch.as_tensor(hi - lo, device=device)
    C = cfg.capacity
    out = []
    for w in advance_ladder(cfg):
        n_active = max(w // 2, 1)
        # est/err/axis must hold real rule output for classify to threshold
        state = make_eval_step(cfg, rule, window=w)(_with_live(store, n_active))
        _, _, fin = classify_window(cfg, state, total_volume, width, None if w == C else w)
        survivors = min(n_active - int(fin.sum()), 3 * C // 4)
        split = min(survivors, C - survivors)
        step = make_advance_step(cfg, total_volume, hi - lo, window=w)
        measured, launches, _ = _time_step(step, lambda: _clone(state), reps, device)
        out.append({
            "kernel": "advance", "d": cfg.d, "rung": w, "scan_trips": 1,
            "measured_s": measured, **advance_counts(cfg.d, n_active, split, cfg.dtype),
            "launches": launches, "integrand": _name(cfg.integrand), "dtype": cfg.dtype,
            "regions": n_active, "split": split,
        })
        del state
    return out


def vegas_entries(cfg, reps: int, device) -> List[Dict[str, Any]]:
    """The full VEGAS iterate: sample -> map -> integrand -> reduce -> adapt."""
    from repro_torch.mc import engine as mc_engine

    iterate = mc_engine.make_iterate(cfg, mc_engine.resolve_fn(cfg, None), devices=(device,))
    state = mc_engine.init_state(cfg, device)
    measured, launches, _ = _time_step(iterate, lambda: state, reps, device)
    _, cubes = mc_engine.mc_layout(cfg)
    counts = vegas_counts(cfg.integrand, cfg.d, cfg.mc_samples, cfg.mc_bins, cubes,
                          cfg.mc_shards, cfg.dtype)
    return [{
        "kernel": "vegas_iterate", "d": cfg.d, "rung": None, "scan_trips": 1,
        "measured_s": measured, **counts, "launches": launches,
        "integrand": _name(cfg.integrand), "dtype": cfg.dtype, "samples": cfg.mc_samples,
    }]


def dispatch_entries(cfg, reps: int, device) -> List[Dict[str, Any]]:
    """The batch service's dispatch (``BatchEngine.run``).

    A full fleet is admitted at tolerances no slot can reach within one
    dispatch, so the timed dispatch executes all ``sync_every`` iterations
    (no early exit); each rep times the same dispatch on a freshly admitted
    fleet.  The counts take each iteration's windows and populations from
    the run's own metrics.
    """
    from repro_torch.service.batch_engine import BatchEngine

    engine = BatchEngine(cfg, devices=[device])
    rng = np.random.default_rng(0)
    thetas = [engine.family.sample_theta(cfg.d, rng) for _ in range(engine.n_slots)]
    state = engine.init()

    def admitted():
        for slot, theta in enumerate(thetas):
            engine.admit(state, slot, theta, 1e-14, 1e-30)
        return state

    def run(s):
        return engine.run(s, cfg.sync_every, 0)

    measured, launches, (_, metrics, executed, _) = _time_step(run, admitted, reps, device)
    S, C = engine.slots_per_rank, cfg.capacity
    n_exec = int(executed.sum())
    iterations = []
    for t in range(n_exec):
        live = metrics["n_active"][t] > 0
        rows = sum(int(metrics["window"][t][r]) * int(live[r * S:(r + 1) * S].sum())
                   for r in range(engine.n_ranks))
        # each slot's next population is twice its splits below capacity
        after = metrics["n_active"][t + 1] if t + 1 < n_exec else state.counts
        split = int(sum(a // 2 for a, ok in zip(after, live) if ok and a < C))
        iterations.append({"eval_rows": rows, "live": int(metrics["n_active"][t].sum()),
                           "split": split})
    counts = service_counts(cfg.integrand, cfg.d, iterations, cfg.dtype)
    return [{
        "kernel": "service_dispatch", "d": cfg.d, "rung": None,
        "scan_trips": counts["executed"], "measured_s": measured,
        "flops": counts["flops"], "bytes": counts["bytes"], "executed": counts["executed"],
        "launches": launches, "integrand": _name(cfg.integrand), "dtype": cfg.dtype,
        "slots": engine.n_slots, "devices": engine.n_ranks, "iterations": iterations,
    }]


# --- catalog assembly -------------------------------------------------------------


def default_configs(fast: bool = True) -> Dict[str, Any]:
    """The (kernel kind -> config or configs) grid the catalog sweeps.

    ``fast``: the JAX catalog's reduced shapes, for the CPU and the tests.
    Otherwise the card-scale set, ``PERF.md`` §4's cases: the GM rule and
    the advance on ``f4`` d=5 and ``genz_gaussian`` (a=5, u=0.5) d=8 at
    capacity 2^22; VEGAS on ``genz_gaussian`` d=15 (theta from
    ``sample_theta`` with ``default_rng(0)``) at 2^22 samples; the service
    fleet of 64 slots of 2^19 regions, ``genz_gaussian`` d=5.
    """
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.integrands import PARAM_REGISTRY, to_spec

    if fast:
        cub = QuadratureConfig(d=5, integrand="f4", capacity=1 << 11).validate()
        veg = QuadratureConfig(d=8, integrand="f4", backend="vegas", mc_samples=8192,
                               mc_shards=8).validate()
        svc = QuadratureConfig(d=3, integrand="genz_gaussian", capacity=1 << 9,
                               batch_slots=4, sync_every=4).validate()
        return {"gm_eval": cub, "advance": cub, "vegas_iterate": veg, "service_dispatch": svc}
    gauss = PARAM_REGISTRY["genz_gaussian"]
    cub = [
        QuadratureConfig(d=5, integrand="f4", capacity=1 << 22).validate(),
        QuadratureConfig(d=8, integrand=to_spec(gauss, {"a": [5.0] * 8, "u": [0.5] * 8}),
                         capacity=1 << 22).validate(),
    ]
    theta = gauss.sample_theta(15, np.random.default_rng(0))
    veg = QuadratureConfig(d=15, integrand=to_spec(gauss, theta), backend="vegas",
                           mc_samples=1 << 22, mc_shards=8).validate()
    svc = QuadratureConfig(d=5, integrand="genz_gaussian", capacity=1 << 19, batch_slots=64,
                           admit_every=1, sync_every=4, eval_window_min=256).validate()
    return {"gm_eval": cub, "advance": cub, "vegas_iterate": veg, "service_dispatch": svc}


def build_catalog(
    machine: Dict[str, Any],
    fast: bool = True,
    which: Optional[Sequence[str]] = None,
    reps: Optional[int] = None,
    configs: Optional[Dict[str, Any]] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Measure + predict every requested kernel on ``device``; returns the
    catalog dict.  Raises when the card is asked for and absent."""
    dev = resolve_device(device)
    cfgs = configs or default_configs(fast)
    which = tuple(which) if which else KERNELS
    unknown = set(which) - set(KERNELS)
    if unknown:
        raise ValueError(f"unknown kernels {sorted(unknown)}; known: {KERNELS}")
    n_reps = reps or (3 if fast else 10)
    builders = {
        "gm_eval": gm_eval_entries,
        "advance": advance_entries,
        "vegas_iterate": vegas_entries,
        "service_dispatch": dispatch_entries,
    }
    entries: List[Dict[str, Any]] = []
    for kernel in which:
        for cfg in _configs(cfgs[kernel]):
            entries.extend(predict(e, machine) for e in builders[kernel](cfg, n_reps, dev))
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return {
        "machine": {
            "name": machine.get("name"),
            "source": machine.get("source"),
            "peak_flops": machine["peak_flops"],
            "mem_bw": machine["mem_bw"],
        },
        "device": str(dev),
        "entries": entries,
    }


def save_catalog(catalog: Dict[str, Any], path: str = DEFAULT_PATH) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(catalog, f, indent=1)
        f.write("\n")
    return path


def load_catalog(path: str = DEFAULT_PATH) -> Optional[Dict[str, Any]]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def render_table(entries: Sequence[Dict[str, Any]]) -> str:
    """Markdown table of a catalog's entries (shared with the report)."""
    head = (
        "| kernel | rung | d | GFLOP | MB | measured | predicted | "
        "roofline frac | dominant |\n|---|---|---|---|---|---|---|---|---|"
    )
    rows = [head]
    for e in entries:
        rung = "—" if e.get("rung") is None else str(e["rung"])
        rows.append(
            f"| {e['kernel']} | {rung} | {e['d']} | "
            f"{e['flops_total'] / 1e9:.3f} | {e['bytes_total'] / 1e6:.1f} | "
            f"{e['measured_s'] * 1e3:.2f} ms | {e['predicted_s'] * 1e3:.2f} ms | "
            f"{e['roofline_frac']:.3f} | {e['dominant']} |"
        )
    return "\n".join(rows)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Count, time and predict the port's kernels.")
    ap.add_argument("--out", default=DEFAULT_PATH)
    ap.add_argument(
        "--machine",
        default=None,
        help=f"machine file to predict from (default: {MACHINE_PATH} if "
        "present, else the h100-sxm preset)",
    )
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (card-scale shapes) unless the CPU (reduced shapes) is asked for")
    ap.add_argument("--only", default=None, help=f"comma-separated subset of {KERNELS}")
    args = ap.parse_args(argv)

    machine = resolve_machine(args.machine)
    which = args.only.split(",") if args.only else None
    catalog = build_catalog(machine, fast=args.device == "cpu", which=which, device=args.device)
    path = save_catalog(catalog, args.out)
    print(render_table(catalog["entries"]))
    print(f"\nwrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
