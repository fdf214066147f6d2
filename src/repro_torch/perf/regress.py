"""Bench regression gate: compare two ``BENCH_summary.json`` files.

The port's copy of the JAX package's ``repro.perf.regress``: the same
thresholds, exit codes and rows.  ``python -m repro_torch.perf.regress
baseline.json candidate.json`` compares every tracked metric (lower is
better — the summary normalizes each benchmark row to its wall-time column)
with noise-tolerant thresholds:

- ratio > ``--fail-ratio`` (default 1.3x) — **FAIL**, exit 1;
- ratio > ``--warn-ratio`` (default 1.1x) — warn, exit 0;
- ratio < 1 / warn-ratio — reported as an improvement.

Both files must carry a provenance meta header (``platform``,
``device_kind``, ``device_count``, ``torch_version``).  Baseline/candidate
pairs from different *platforms* are rejected outright (exit 2): a cpu
against gpu wall-time ratio is not a regression signal.  The committed JAX
summary (``results/benchmarks/BENCH_summary.json``, platform ``"cpu"``)
against a ``"gpu"`` summary of the card is such a pair, so the card needs
baselines of its own.  Differing device kinds on the same platform (two
card models, two power limits' worth of the same card) only warn, as does
another torch version.

Exit codes: 0 ok/warn, 1 at least one metric regressed past the fail
threshold, 2 the files are unusable (schema or platform mismatch).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

#: default noise-tolerant thresholds (same-machine comparisons)
FAIL_RATIO = 1.3
WARN_RATIO = 1.1


class RegressError(ValueError):
    """Baseline/candidate pair is unusable (schema or platform mismatch)."""


def load_summary(path: str) -> Dict[str, Any]:
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "metrics" not in data or "meta" not in data:
        raise RegressError(
            f"{path} is not a BENCH_summary file: expected "
            '{"meta": {...}, "metrics": {...}}'
        )
    return data


def check_compatible(
    baseline: Dict[str, Any], candidate: Dict[str, Any], allow_mismatch: bool = False
) -> List[str]:
    """Platform guard; returns warning lines, raises on a hard mismatch."""
    warnings: List[str] = []
    b_meta, c_meta = baseline.get("meta", {}), candidate.get("meta", {})
    b_plat, c_plat = b_meta.get("platform"), c_meta.get("platform")
    if b_plat != c_plat and not allow_mismatch:
        raise RegressError(
            f"platform mismatch: baseline ran on {b_plat!r}, candidate on "
            f"{c_plat!r} — wall-time ratios across platforms are not a "
            "regression signal. Re-record the baseline on this platform "
            "or pass --allow-platform-mismatch "
            "if you really want the comparison."
        )
    for key in ("device_kind", "device_count", "torch_version"):
        if b_meta.get(key) != c_meta.get(key):
            warnings.append(
                f"meta drift: {key} baseline={b_meta.get(key)!r} "
                f"candidate={c_meta.get(key)!r} — expect timing noise"
            )
    return warnings


def compare(
    baseline: Dict[str, Any],
    candidate: Dict[str, Any],
    fail_ratio: float = FAIL_RATIO,
    warn_ratio: float = WARN_RATIO,
) -> Tuple[List[Dict[str, Any]], List[str]]:
    """Per-metric comparison rows plus coverage warnings.

    Each row: ``{metric, baseline, candidate, ratio, verdict}`` with verdict
    one of ``fail`` / ``warn`` / ``ok`` / ``improved``.  Metrics present on
    only one side produce coverage warnings, never failures — a renamed or
    newly added benchmark must not block CI, it must be re-baselined.
    """
    b, c = baseline["metrics"], candidate["metrics"]
    rows: List[Dict[str, Any]] = []
    warnings: List[str] = []
    for name in sorted(set(b) | set(c)):
        if name not in c:
            warnings.append(f"metric dropped from candidate: {name}")
            continue
        if name not in b:
            warnings.append(f"new metric (no baseline): {name}")
            continue
        old, new = float(b[name]), float(c[name])
        if old <= 0:
            warnings.append(f"non-positive baseline for {name}: {old}")
            continue
        ratio = new / old
        if ratio > fail_ratio:
            verdict = "fail"
        elif ratio > warn_ratio:
            verdict = "warn"
        elif ratio < 1.0 / warn_ratio:
            verdict = "improved"
        else:
            verdict = "ok"
        rows.append(
            {
                "metric": name,
                "baseline": old,
                "candidate": new,
                "ratio": ratio,
                "verdict": verdict,
            }
        )
    return rows, warnings


def render_rows(rows: List[Dict[str, Any]]) -> str:
    out = [
        "| metric | baseline (us) | candidate (us) | ratio | verdict |",
        "|---|---|---|---|---|",
    ]
    for r in rows:
        mark = {"fail": "**FAIL**", "warn": "warn", "improved": "improved"}.get(
            r["verdict"], "ok"
        )
        out.append(
            f"| {r['metric']} | {r['baseline']:.1f} | {r['candidate']:.1f} | "
            f"{r['ratio']:.2f}x | {mark} |"
        )
    return "\n".join(out)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Compare two BENCH_summary.json files (perf gate)."
    )
    ap.add_argument("baseline")
    ap.add_argument("candidate")
    ap.add_argument("--fail-ratio", type=float, default=FAIL_RATIO)
    ap.add_argument("--warn-ratio", type=float, default=WARN_RATIO)
    ap.add_argument(
        "--allow-platform-mismatch",
        action="store_true",
        help="compare across platforms anyway (ratios are then advisory)",
    )
    args = ap.parse_args(argv)
    if args.fail_ratio < args.warn_ratio:
        ap.error("--fail-ratio must be >= --warn-ratio")

    try:
        baseline = load_summary(args.baseline)
        candidate = load_summary(args.candidate)
        warnings = check_compatible(
            baseline, candidate, allow_mismatch=args.allow_platform_mismatch
        )
    except RegressError as e:
        print(f"regress: {e}")
        return 2

    rows, coverage = compare(
        baseline, candidate, fail_ratio=args.fail_ratio, warn_ratio=args.warn_ratio
    )
    for w in warnings + coverage:
        print(f"warning: {w}")
    if rows:
        print(render_rows(rows))
    n_fail = sum(r["verdict"] == "fail" for r in rows)
    n_warn = sum(r["verdict"] == "warn" for r in rows)
    n_imp = sum(r["verdict"] == "improved" for r in rows)
    print(
        f"\n{len(rows)} metrics compared: {n_fail} failed "
        f"(> {args.fail_ratio:.2f}x), {n_warn} warned "
        f"(> {args.warn_ratio:.2f}x), {n_imp} improved"
    )
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
