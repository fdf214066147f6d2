"""Validate telemetry artifacts (CI smoke checker).

The port's own copy of the JAX package's ``repro.telemetry.check``; either
checker accepts the other package's files.  Usage (exit 0 iff every
requested artifact is well-formed)::

    PYTHONPATH=src python -m repro_torch.telemetry.check \\
        --trace /tmp/t.json --devices 4 --expect-flow \\
        --metrics /tmp/m.jsonl

Checks the structural contracts the rest of the tooling relies on:
Chrome traces must carry the required ``ph``/``ts``/``pid``/``tid`` keys,
balanced ``B``/``E`` span stacks per lane, one named lane per rank, and
(optionally) at least one matched ``s``/``f`` flow pair — migrations,
reroutes, or (with ``--expect-flow-name``) a specific flow such as a
device-loss evacuation.  Metrics files must be one JSON object per line,
each with the recorder's ``kind``/``name``/``ts``/``seq`` envelope.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

PHASES_NEEDING_TS = {"B", "E", "i", "X", "C", "s", "f", "t"}
EVENT_KINDS = {
    "counter",
    "gauge",
    "hist",
    "instant",
    "span_begin",
    "span_end",
    "flow_begin",
    "flow_end",
}


def check_trace(
    path: str,
    n_devices: Optional[int] = None,
    expect_flow: bool = False,
    expect_flow_name: Optional[str] = None,
) -> List[str]:
    """Return a list of problems with the Chrome trace at ``path``."""
    problems: List[str] = []
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        return [f"trace {path}: unreadable ({e})"]
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return [f"trace {path}: no traceEvents array"]

    lane_names: Dict[Any, str] = {}
    stacks: Dict[Any, List[str]] = {}
    flow_starts: Dict[Any, str] = {}
    flow_ends: Dict[Any, str] = {}
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph is None:
            problems.append(f"event {i}: missing 'ph'")
            continue
        if "pid" not in e or "tid" not in e:
            problems.append(f"event {i} (ph={ph}): missing pid/tid")
            continue
        if ph == "M":
            if e.get("name") == "thread_name":
                lane_names[(e["pid"], e["tid"])] = e["args"]["name"]
            continue
        if "ts" not in e:
            problems.append(f"event {i} (ph={ph}, name={e.get('name')}): missing ts")
            continue
        key = (e["pid"], e["tid"])
        if ph == "B":
            stacks.setdefault(key, []).append(e.get("name", "?"))
        elif ph == "E":
            stack = stacks.setdefault(key, [])
            if not stack:
                problems.append(
                    f"event {i}: E for {e.get('name')!r} on lane {key} "
                    "with no open span"
                )
            else:
                stack.pop()
        elif ph == "s":
            flow_starts[e.get("id")] = e.get("name", "?")
        elif ph == "f":
            flow_ends[e.get("id")] = e.get("name", "?")
    for key, stack in stacks.items():
        if stack:
            problems.append(f"lane {key}: unclosed spans {stack}")

    if n_devices is not None:
        names = set(lane_names.values())
        for d in range(n_devices):
            if f"device {d}" not in names:
                problems.append(
                    f"no 'device {d}' lane (found: {sorted(names)})"
                )
    if expect_flow:
        matched = set(flow_starts) & set(flow_ends)
        if not matched:
            problems.append(
                f"no matched s/f flow pair (starts={len(flow_starts)}, "
                f"ends={len(flow_ends)})"
            )
    if expect_flow_name is not None:
        matched_names = {
            flow_starts[i] for i in set(flow_starts) & set(flow_ends)
        }
        if expect_flow_name not in matched_names:
            problems.append(
                f"no matched flow named {expect_flow_name!r} "
                f"(found: {sorted(matched_names)})"
            )
    unmatched = set(flow_starts) ^ set(flow_ends)
    if unmatched:
        problems.append(f"unpaired flow ids: {sorted(unmatched)[:8]}")
    return problems


def check_metrics(path: str) -> List[str]:
    """Return a list of problems with the metrics JSONL at ``path``."""
    problems: List[str] = []
    try:
        fh = open(path, encoding="utf-8")
    except OSError as e:
        return [f"metrics {path}: unreadable ({e})"]
    n = 0
    with fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError as err:
                problems.append(f"line {lineno}: not JSON ({err})")
                continue
            n += 1
            for key in ("kind", "name", "ts", "seq"):
                if key not in e:
                    problems.append(f"line {lineno}: missing {key!r}")
            kind = e.get("kind")
            if kind is not None and kind not in EVENT_KINDS:
                problems.append(f"line {lineno}: unknown kind {kind!r}")
    if n == 0:
        problems.append(f"metrics {path}: no events")
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None, help="Chrome trace JSON to validate")
    ap.add_argument("--metrics", default=None, help="metrics JSONL to validate")
    ap.add_argument(
        "--devices",
        type=int,
        default=None,
        help="require a named lane per device in the trace",
    )
    ap.add_argument(
        "--expect-flow",
        action="store_true",
        help="require >=1 matched s/f flow pair (migration or reroute)",
    )
    ap.add_argument(
        "--expect-flow-name",
        default=None,
        metavar="NAME",
        help="require >=1 matched flow pair with this exact name "
        "(e.g. service.evacuate, service.migrate, service.reroute)",
    )
    args = ap.parse_args(argv)
    if not args.trace and not args.metrics:
        ap.error("nothing to check: pass --trace and/or --metrics")
    problems: List[str] = []
    if args.trace:
        problems += check_trace(
            args.trace,
            n_devices=args.devices,
            expect_flow=args.expect_flow,
            expect_flow_name=args.expect_flow_name,
        )
    if args.metrics:
        problems += check_metrics(args.metrics)
    for p in problems:
        print(f"CHECK FAIL: {p}", file=sys.stderr)
    if not problems:
        checked = " and ".join(
            p for p in (args.trace, args.metrics) if p
        )
        print(f"telemetry check OK: {checked}")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
