"""Performance report: one document for where the time goes.

The port's counterpart of the JAX package's ``repro.perf.report``.
``python -m repro_torch.perf.report`` renders four sections into
``results/perf_torch/PERF_REPORT.md`` (plus an ``.html`` twin):

1. **Machine**: the port's machine file (peak FLOP/s, memory bandwidth,
   probe details, the card's name and power limit), or the ``h100-sxm``
   data-sheet preset when nothing was measured;
2. **Kernel cost catalog**: predicted-vs-measured roofline fractions per
   (kernel, rung, d) from :mod:`repro_torch.perf.catalog`, whose counts are
   formulas of the work;
3. **Benchmark trajectory**: every provenance-headed results file of the
   port's benchmark directory (``results/perf_torch/benchmarks/``) and its
   ``BENCH_summary.json`` metrics (the hard gate is
   :mod:`repro_torch.perf.regress`).  The port has no benchmark harness
   yet, so the directory is empty and the section says so;
4. **Service latency & idle**: when a telemetry metrics JSONL of the port's
   CLIs is supplied (``--metrics``), p50/p99 of the scheduler's
   per-dispatch wall-time and queue-wait histograms, plus per-rank idle
   fractions from the ``service.n_live`` occupancy timeline
   (:mod:`repro_torch.telemetry.loadview`).

Missing inputs degrade to a note in the section, never an error: the
report renders from whatever this checkout has.  If no catalog exists yet
one is built first on ``--device`` (card-scale shapes on the card, reduced
ones on the CPU).
"""

from __future__ import annotations

import html as html_lib
import json
import os
from typing import Any, Dict, List, Optional

from repro_torch.core.adaptive import resolve_device
from repro_torch.perf import catalog as catalog_lib
from repro_torch.perf import machine as machine_lib

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)
DEFAULT_OUT = os.path.join(_REPO, "results", "perf_torch")
#: the port's benchmark results; ``results/benchmarks/`` holds the JAX
#: package's, taken on the CPU
BENCH_DIR = os.path.join(_REPO, "results", "perf_torch", "benchmarks")

#: scheduler latency histograms the report summarizes
LATENCY_HISTS = ("service.dispatch_wall_s", "service.queue_wait_s")


def _fmt_si(x: Optional[float], unit: str) -> str:
    if x is None:
        return "—"
    for scale, prefix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(x) >= scale:
            return f"{x / scale:.2f} {prefix}{unit}"
    return f"{x:.2f} {unit}"


def machine_section(machine: Dict[str, Any]) -> List[str]:
    out = ["## Machine", ""]
    meta = machine.get("meta", {})
    src = machine.get("source", "unknown")
    if src == "preset":
        out.append(
            f"No measured machine file — using the **{machine.get('name')}**"
            " preset (NVIDIA data-sheet numbers). Run"
            " `python -m repro_torch.perf.machine` to measure the card."
        )
        out.append("")
    else:
        out.append(
            f"Measured on platform `{meta.get('platform')}` "
            f"(`{meta.get('device_kind')}` x {meta.get('device_count')}, "
            f"torch {meta.get('torch_version')}, CUDA {meta.get('cuda_version')}; "
            f"nvidia-smi: `{meta.get('nvidia_smi')}`)."
        )
        out.append("")
    out.append("| term | value | probe |")
    out.append("|---|---|---|")
    probes = machine.get("probes", {})

    def probe_note(key: str) -> str:
        p = probes.get(key)
        if not p:
            return "preset"
        n = p.get("n", p.get("n_per_device"))
        return f"n={n}, best of reps: {p['seconds'] * 1e3:.1f} ms"

    out.append(
        f"| peak FLOP/s ({machine.get('working_dtype', 'f64')}) | "
        f"{_fmt_si(machine['peak_flops'], 'FLOP/s')} | "
        f"{probe_note('matmul_f64')} |"
    )
    if "matmul_f32" in probes:
        out.append(
            f"| peak FLOP/s (float32, reference) | "
            f"{_fmt_si(probes['matmul_f32']['flops_per_s'], 'FLOP/s')} | "
            f"{probe_note('matmul_f32')} |"
        )
    if machine.get("fp64_vector_flops"):
        out.append(
            f"| FP64 vector FLOP/s (the GM kernel's rate) | "
            f"{_fmt_si(machine['fp64_vector_flops'], 'FLOP/s')} | preset |"
        )
    out.append(
        f"| memory bandwidth (saxpy) | {_fmt_si(machine['mem_bw'], 'B/s')} | "
        f"{probe_note('saxpy')} |"
    )
    if machine.get("reduce_bw"):
        out.append(
            f"| read bandwidth (reduction) | "
            f"{_fmt_si(machine['reduce_bw'], 'B/s')} | {probe_note('reduction')} |"
        )
    ici = machine.get("ici_bw")
    out.append(
        f"| inter-device bandwidth | {_fmt_si(ici, 'B/s') if ici else '— (1 device)'} | "
        f"{probe_note('ici_ppermute')} |"
    )
    out.append("")
    return out


def catalog_section(catalog: Dict[str, Any]) -> List[str]:
    out = ["## Kernel cost catalog", ""]
    m = catalog.get("machine", {})
    out.append(
        f"Predicted from machine `{m.get('name')}` "
        f"(peak {_fmt_si(m.get('peak_flops'), 'FLOP/s')}, "
        f"mem {_fmt_si(m.get('mem_bw'), 'B/s')}). FLOPs and bytes are counted"
        " from the work (`repro_torch.perf.catalog`'s formulas); the times are"
        + (" CUDA events on the card" if str(catalog.get("device", "")).startswith("cuda")
           else " the host clock on the CPU")
        + ". `roofline frac` = predicted bound /"
        " measured time (1.0 = at the roofline). The dispatch's per-iteration"
        " counts are scaled by `scan_trips`, the iterations it executed. The"
        " peak FLOP/s is a matmul's (FP64 tensor cores), which the GM kernel"
        " cannot use: its own bound is the FP64 vector rate."
    )
    out.append("")
    out.append(catalog_lib.render_table(catalog["entries"]))
    out.append("")
    return out


def bench_section(bench_dir: str) -> List[str]:
    out = ["## Benchmark trajectory", ""]
    names = sorted(
        f for f in os.listdir(bench_dir) if f.endswith(".json")
    ) if os.path.isdir(bench_dir) else []
    if not names:
        shown = os.path.relpath(bench_dir, _REPO) if bench_dir.startswith(_REPO) else bench_dir
        out.append(
            f"_No results in `{shown}`: the port has no benchmark harness"
            " yet, and this directory stays empty until it has one._"
        )
        out.append("")
        return out
    rows = ["| results file | date | git SHA | platform | device | records |",
            "|---|---|---|---|---|---|"]
    summary = None
    for name in names:
        path = os.path.join(bench_dir, name)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            rows.append(f"| {name} | — | — | — | — | unreadable |")
            continue
        # pre-provenance results files are bare record lists (no meta header)
        meta = data.get("meta", {}) if isinstance(data, dict) else {}
        if name == "BENCH_summary.json" and isinstance(data, dict):
            summary = data
        if isinstance(data, dict):
            records = data.get("records", data.get("metrics"))
        else:
            records = data
        n = len(records) if isinstance(records, (list, dict)) else "?"
        rows.append(
            f"| {name} | {str(meta.get('date'))[:19]} | {meta.get('git_sha')} | "
            f"{meta.get('platform')} | {meta.get('device_kind')} "
            f"x{meta.get('device_count')} | {n} |"
        )
    out.extend(rows)
    out.append("")
    if summary is not None:
        out.append("### Tracked metrics (BENCH_summary.json)")
        out.append("")
        out.append("| metric | wall (us) |")
        out.append("|---|---|")
        for k, v in sorted(summary.get("metrics", {}).items()):
            out.append(f"| {k} | {float(v):.1f} |")
        out.append("")
        out.append(
            "_Gate: `python -m repro_torch.perf.regress baseline.json"
            " candidate.json` (fail > 1.3x, warn > 1.1x)._"
        )
        out.append("")
    else:
        out.append("_No BENCH_summary.json among them._")
        out.append("")
    return out


def telemetry_section(metrics_path: Optional[str]) -> List[str]:
    out = ["## Service latency & idle", ""]
    if not metrics_path:
        out.append(
            "_No metrics JSONL supplied — serve with `python -m"
            " repro_torch.launch.serve_quad --metrics m.jsonl` and re-run with"
            " `--metrics m.jsonl` for dispatch latency and idle fractions._"
        )
        out.append("")
        return out
    from repro_torch.telemetry import quantile
    from repro_torch.telemetry.loadview import (
        hist_values_from_events,
        idle_fraction,
        mean_imbalance,
        occupancy_from_events,
    )
    from repro_torch.telemetry.sinks import read_jsonl

    events = read_jsonl(metrics_path)
    out.append(f"From `{metrics_path}` ({len(events)} events).")
    out.append("")
    out.append("| histogram | count | p50 | p99 | max |")
    out.append("|---|---|---|---|---|")
    for name in LATENCY_HISTS:
        vals = hist_values_from_events(events, name)
        if not vals:
            out.append(f"| {name} | 0 | — | — | — |")
            continue
        out.append(
            f"| {name} | {len(vals)} | {quantile(vals, 0.5) * 1e3:.2f} ms | "
            f"{quantile(vals, 0.99) * 1e3:.2f} ms | {max(vals) * 1e3:.2f} ms |"
        )
    out.append("")

    timeline = occupancy_from_events(events)
    if timeline.iterations:
        # slots/devices ride on the service.start event the scheduler emits
        slots = devices = None
        for e in events:
            if e.get("kind") == "instant" and e.get("name") == "service.start":
                slots, devices = e.get("slots"), e.get("devices")
                break
        if slots and devices:
            spd = int(slots) // int(devices)
            idle = idle_fraction(timeline, spd)
            out.append("| device | idle fraction |")
            out.append("|---|---|")
            for dev, frac in sorted(idle.items()):
                out.append(f"| {dev} | {frac:.3f} |")
            out.append("")
        out.append(
            f"Mean work imbalance (Fig. 4b `1 - mean/max`): "
            f"{mean_imbalance(timeline):.3f} over "
            f"{len(timeline.iterations)} iterations."
        )
        out.append("")
    else:
        out.append("_No `service.n_live` occupancy gauges in this stream._")
        out.append("")
    return out


def render_markdown(
    machine: Dict[str, Any],
    catalog: Dict[str, Any],
    bench_dir: str,
    metrics_path: Optional[str],
    device=None,
) -> str:
    lines: List[str] = ["# Performance report (PyTorch/CUDA port)", ""]
    meta = machine_lib.collect_meta(device)
    lines.append(
        f"_Rendered on platform `{meta.get('platform')}`, torch "
        f"{meta.get('torch_version')}. Regenerate: `python -m repro_torch.perf.report`._"
    )
    lines.append("")
    lines.extend(machine_section(machine))
    lines.extend(catalog_section(catalog))
    lines.extend(bench_section(bench_dir))
    lines.extend(telemetry_section(metrics_path))
    return "\n".join(lines).rstrip() + "\n"


def render_html(markdown: str) -> str:
    """Minimal standalone HTML twin (tables stay readable as markdown)."""
    return (
        "<!DOCTYPE html>\n<html><head><meta charset='utf-8'>"
        "<title>Performance report</title>"
        "<style>body{font-family:monospace;max-width:1100px;margin:2em auto;"
        "white-space:pre-wrap;}</style></head><body>"
        + html_lib.escape(markdown)
        + "</body></html>\n"
    )


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Render the performance report.")
    ap.add_argument("--machine", default=None, help="machine file path")
    ap.add_argument(
        "--catalog",
        default=catalog_lib.DEFAULT_PATH,
        help="kernel catalog path (built on --device if missing)",
    )
    ap.add_argument("--bench-dir", default=BENCH_DIR)
    ap.add_argument(
        "--metrics", default=None, help="telemetry metrics JSONL from a serve run"
    )
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card unless the CPU is asked for")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    machine = machine_lib.resolve_machine(args.machine)
    catalog = catalog_lib.load_catalog(args.catalog)
    if catalog is None:
        print(f"no catalog at {args.catalog} — building one on {device}")
        catalog = catalog_lib.build_catalog(machine, fast=device.type == "cpu", device=device)
        catalog_lib.save_catalog(catalog, args.catalog)

    md = render_markdown(machine, catalog, args.bench_dir, args.metrics, device)
    os.makedirs(args.out, exist_ok=True)
    md_path = os.path.join(args.out, "PERF_REPORT.md")
    html_path = os.path.join(args.out, "PERF_REPORT.html")
    with open(md_path, "w") as f:
        f.write(md)
    with open(html_path, "w") as f:
        f.write(render_html(md))
    print(f"wrote {md_path}")
    print(f"wrote {html_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
