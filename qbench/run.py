"""Run one cell of the benchmark once and print its result line.

    python3 qbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last: each
number compared beside its limit); the same checks are the last lines of
standard error.  Exits non-zero, printing no result, without enough CUDA
devices for the cell, without the port beside the benchmark, or when the
JAX package or JAX itself was loaded.
"""

import time

T_START = time.monotonic()  # set-up runs from here: imports included

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# modules that must never be loaded, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the run writes stays at a fixed path inside the checkout
    # (the port's own nvcc builds go to build/kernels/ there)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [p for p in sys.path if p not in ("", here)]

    from qbench import harness

    import torch

    entry = harness.cell_entry(harness.manifest(), args.workload)
    chips = entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"qbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    ranks = harness.load_json(harness.HERE / "configs" / f"{entry['config']}.json").get("ranks", 1)
    devices = [f"cuda:{r % chips}" for r in range(ranks)]  # rank r on card r mod chips
    line, _ = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), devices,
                               T_START)
    found = forbidden_modules()
    if found:
        print(f"qbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    text = json.dumps(harness.json_safe(line))
    out = harness.HERE / "out"  # ignored by git: one small file a run
    out.mkdir(exist_ok=True)
    (out / f"{args.workload}.{args.seed}.trace{args.trace}.json").write_text(text + "\n")
    print(text, flush=True)
    for text in harness.check_lines(line):
        print(text, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
