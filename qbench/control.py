"""Readings of the comparison that decides ``correct``, for setting limits.

    python3 -m qbench.control --cell <cell> --seeds 1,2,3 --seconds 5 [--dtype float32]

Runs the cell through the harness once per seed, on the CUDA devices the
cell asks for, and prints one JSON line per seed with every number the
comparison computes (and whether the cell's limits pass).  With
``--dtype float32`` the configuration's float64 is replaced by the port's
float32 path: the control, which has to come out not correct.  Run from
the root of a checkout with ``PYTHONPATH=src``.
"""

from __future__ import annotations

import argparse
import copy
import json
import time

from qbench import harness, reference


def readings(cell: str, seeds, seconds: float, dtype=None, devices=None):
    spec = harness.manifest()
    entry = harness.cell_entry(spec, cell)
    config = copy.deepcopy(harness.load_json(harness.HERE / "configs" / f"{entry['config']}.json"))
    if dtype:
        config["quadrature"]["dtype"] = dtype
    if devices is None:
        devices = [f"cuda:{r % entry['chips']}" for r in range(config.get("ranks", 1))]
    every = {"failed_share": 0.0, "worst_err_over_tol": 0.0}
    for seed in seeds:
        t = time.monotonic()
        line, out = harness.run_cell(cell, seed, seconds, False, devices, t, config=config)
        cfg_limits = harness.load_json(harness.HERE / "workloads" / f"{cell}.json")["limits"]
        answers = [dict(i, exact=reference.exact(i["family"], i["d"], i["theta"]))
                   for i in out.items]
        def off(a):
            rel = abs(a["integral"] - a["exact"]) / abs(a["exact"])
            return dict(status=a["status"], rel_tol=a["rel_tol"], rel_err=rel,
                        err_over_tol=rel / a["rel_tol"], claimed=a["error"] / abs(a["exact"]),
                        iterations=a["iterations"], theta=a["theta"])

        worst = sorted(answers, key=lambda a: -abs(a["integral"] - a["exact"]) / abs(a["exact"])
                       / a["rel_tol"])[:3]
        by_status = {}
        for a in answers:
            by_status[a["status"]] = by_status.get(a["status"], 0) + 1
        yield dict(cell=cell, seed=seed, dtype=config["quadrature"]["dtype"],
                   correct=line["correct"], items=len(out.items),
                   statuses=by_status, worst=[off(a) for a in worst],
                   readings={k: v["value"] for k, v in reference.judge(answers, every).items()},
                   limits=cfg_limits, metrics=line["metrics"], wall_s=time.monotonic() - t)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--dtype", default=None)
    args = ap.parse_args(argv)
    for row in readings(args.cell, [int(s) for s in args.seeds.split(",")], args.seconds, args.dtype):
        print(json.dumps(harness.json_safe(row)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
