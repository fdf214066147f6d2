"""One run of one cell: find its files by name, drive it, judge it, report.

The cell's entry in ``BENCHMARK.json`` names its configuration and its
traffic; ``configs/<config>.json``, ``traffic/<traffic>.json`` and
``workloads/<cell>.json`` (the limits of the comparison that decides
``correct``) hold the rest.  The traffic's ``kind`` names its driver,
``drivers/<kind>.py``.  Per-layer metrics are ``metrics/<name>.py``, each
with a ``read(run)`` that returns a number or ``None``.
"""

from __future__ import annotations

import math
import subprocess
import types
from typing import Optional, Sequence

from qbench import reference
from qbench.files import HERE, ROOT, load_code, load_json


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_entry(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str, spec: dict) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed there, or, with no
    list, wherever the end-to-end metric it moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in spec["end_to_end"] if m["name"] == metric["moves"])
        return applies(moved, cell, spec)
    return True


def load_metric(name: str):
    return load_code("metrics", name)


def card() -> Optional[str]:
    """The cards' names and power limits, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().replace("\n", "; ") or None


def run_cell(name: str, seed: int, seconds: float, trace: bool, devices: Sequence,
             t_start: float, config: Optional[dict] = None, traffic: Optional[dict] = None):
    """Run cell ``name`` once on ``devices`` (one entry per rank).

    Returns its result line as a dict (``checks`` last) and the driver's
    outcome.  ``config`` and ``traffic`` replace the files' contents (the
    tests run cells at small sizes)."""
    spec = manifest()
    entry = cell_entry(spec, name)
    config = config or load_json(HERE / "configs" / f"{entry['config']}.json")
    traffic = traffic or load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    cell = load_json(HERE / "workloads" / f"{name}.json")
    out = load_code("drivers", traffic["kind"]).run(config, traffic, seed, seconds, list(devices),
                                                    trace)
    window_start = out.t0

    # the comparison, once the window has closed
    answers = [dict(i, exact=reference.exact(i["family"], i["d"], i["theta"])) for i in out.items]
    checks = reference.judge(answers, cell["limits"])
    window = out.items[:out.in_window]
    failed = sum(i["status"] != "converged" for i in window)

    # the end-to-end metrics, in either run: one the window gave no value
    # for (no integral or request converged in it) makes the run not correct
    values = dict(out.e2e, setup_s=window_start - t_start, peak_mem_gb=out.peak_bytes / 1e9)
    e2e = {m["name"]: {"value": values.get(m["name"]), "unit": m["unit"]}
           for m in spec["end_to_end"] if applies(m, name, spec)}
    complete = all(v["value"] is not None for v in e2e.values())
    metrics = {k: v for k, v in e2e.items() if v["value"] is not None}
    if trace:
        run = types.SimpleNamespace(items=window, all_items=out.items, counters=out.counters,
                                    trace=out.trace, config=config, traffic=traffic, cell=name)
        metrics = {}
        for m in spec["per_layer"]:
            if applies(m, name, spec):
                value = load_metric(m["name"]).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    on_gpu = str(devices[0]).startswith("cuda")
    device = {"platform": "gpu" if on_gpu else "cpu", "kind": None, "count": entry["chips"],
              "memory_peak_bytes": out.peak_bytes}
    if on_gpu:
        import torch

        device["kind"] = torch.cuda.get_device_name(0)
        device["card"] = card()
    line = {"correct": reference.passes(checks) and complete, "attempted": len(window),
            "failed": failed, "metrics": metrics, "device": device}
    if trace:
        t = out.trace
        if t is not None:
            busy = [d["busy_s"] for d in t["devices"].values()]
            device["busy_s"] = sum(busy) / len(busy) if busy else 0.0
            device["window_s"] = t["window_s"]
            line["breakdown"] = {"device_ops": [[n, s] for n, s in t["device_ops"]],
                                 "idle_gaps": [[n, s] for n, s in t["idle_gaps"]]}
    # each integral's seconds, as the spread of a window's mean is read from them
    item_s = [i["wall_s"] for i in window if "wall_s" in i]
    if item_s:
        line["item_s"] = item_s
    line["checks"] = checks
    return line, out


def check_lines(line: dict) -> list:
    """The numbers compared, each beside its limit, one per line."""
    return [f"check {k}: {c['value']!r} <= {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}" for k, c in line["checks"].items()]


def json_safe(obj):
    """inf and nan as strings: the result line stays strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj
