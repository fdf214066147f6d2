"""Machine profiler: micro-benchmark the card into a machine file.

The port's counterpart of the JAX package's ``repro.perf.machine``.  A
*machine file* is the measured half of the roofline model: what the device
sustains, with the same fields as the JAX package's file:

- ``peak_flops``: FLOP/s of a timed dense ``torch.matmul`` in the working
  dtype (float64: the quadrature runs the paper's tolerances in float64;
  a float32 probe is recorded beside it).  On an H100 a float64 matmul runs
  on the FP64 tensor cores, which the GM kernel cannot use: its own FP64
  rate is the vector rate, which the preset records as
  ``fp64_vector_flops``;
- ``mem_bw``: bytes/s of a timed saxpy (``y + 2 x``: two reads and one
  write per element);
- ``reduce_bw``: bytes/s of a timed full reduction (one read per element);
- ``ici_bw``: bytes/s per link of a ring of device-to-device copies over
  the visible cards, when there are two or more, else ``None``.

A probe is a library call on purpose: it measures the machine, not this
repo's work.  Each probe takes the best of ``reps`` timed repetitions after
a warm call, timed with CUDA events on the card; on the CPU (only when the
caller asks, ``device="cpu"``, as the tests do) with the host clock.  The
card's default sizes reach the plateau: a matmul of n = 8192 and streams of
2^27 float64 (1 GiB an array).

:data:`PRESETS` holds the one fallback, ``"h100-sxm"``: NVIDIA's H100 SXM5
data sheet.  It is also the one home of the card's constants that the
kernels' bounds use (``launch/gm_perf.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.adaptive import resolve_device

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)

#: default machine-file location; never ``results/perf/``, which holds the
#: JAX package's files
DEFAULT_PATH = os.path.join(_REPO, "results", "perf_torch", "machine.json")

#: NVIDIA H100 SXM5 data sheet (dense rates, 700 W).  ``peak_flops`` is the
#: FP64 tensor-core rate, because that is what a float64 matmul probe
#: measures; ``fp64_vector_flops`` is the FP64 rate outside the tensor
#: cores (an FMA counted as two operations), the rate of the GM kernel.
PRESETS: Dict[str, Dict[str, Any]] = {
    "h100-sxm": {
        "name": "h100-sxm-preset",
        "source": "preset",
        "peak_flops": 67e12,
        "fp64_vector_flops": 34e12,
        "mem_bw": 3.35e12,
        "reduce_bw": 3.35e12,
        "ici_bw": 450e9,  # NVLink 4, one direction
    },
}

#: (matmul n, stream length) by device type and mode
SIZES = {
    ("cuda", True): (8192, 1 << 27),
    ("cuda", False): (16384, 1 << 28),
    ("cpu", True): (768, 1 << 23),
    ("cpu", False): (1536, 1 << 25),
}


def _best_time(fn: Callable[[], Any], reps: int, device: torch.device) -> float:
    """Best-of-``reps`` seconds of ``fn`` after one warm call: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(max(1, reps)):
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _probe_matmul(n: int, dtype, reps: int, device) -> Dict[str, float]:
    a = torch.ones((n, n), dtype=dtype, device=device)
    b = torch.ones((n, n), dtype=dtype, device=device)
    out = torch.empty((n, n), dtype=dtype, device=device)
    t = _best_time(lambda: torch.matmul(a, b, out=out), reps, device)
    return {"n": n, "seconds": t, "flops_per_s": 2.0 * n**3 / t}


def _probe_saxpy(n: int, dtype, reps: int, device) -> Dict[str, float]:
    x = torch.ones((n,), dtype=dtype, device=device)
    y = torch.ones((n,), dtype=dtype, device=device)
    out = torch.empty((n,), dtype=dtype, device=device)
    t = _best_time(lambda: torch.add(y, x, alpha=2.0, out=out), reps, device)
    itemsize = x.element_size()
    # two operand reads + one result write per element
    return {"n": n, "seconds": t, "bytes_per_s": 3.0 * n * itemsize / t}


def _probe_reduction(n: int, dtype, reps: int, device) -> Dict[str, float]:
    x = torch.ones((n,), dtype=dtype, device=device)
    t = _best_time(lambda: torch.sum(x), reps, device)
    return {"n": n, "seconds": t, "bytes_per_s": n * x.element_size() / t}


def _probe_ici(n: int, dtype, reps: int, device) -> Optional[Dict[str, float]]:
    """A ring of copies: card i sends an ``(n,)`` buffer to card i + 1, all
    at once.  ``None`` with fewer than two cards (and on the CPU).

    Each card sends on a stream of its own: a copy on a card's current
    stream would make that stream wait for the incoming copy (torch orders
    a copy against both cards' current streams), and the ring would run
    one link at a time.  The per-link payload is the whole buffer; the time
    is the host clock between two synchronisations of every card.
    """
    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    count = torch.cuda.device_count()
    src = [torch.ones((n,), dtype=dtype, device=f"cuda:{i}") for i in range(count)]
    dst = [torch.empty((n,), dtype=dtype, device=f"cuda:{i}") for i in range(count)]
    streams = [torch.cuda.Stream(device=i) for i in range(count)]

    def sync():
        for i in range(count):
            torch.cuda.synchronize(i)

    def ring():
        for i in range(count):
            with torch.cuda.stream(streams[i]):
                dst[(i + 1) % count].copy_(src[i], non_blocking=True)

    sync()
    ring()
    sync()
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        ring()
        sync()
        best = min(best, time.perf_counter() - t0)
    itemsize = src[0].element_size()
    return {"n_per_device": n, "devices": count, "seconds": best,
            "bytes_per_s": n * itemsize / best}


def profile_machine(
    fast: bool = True,
    *,
    matmul_n: Optional[int] = None,
    stream_n: Optional[int] = None,
    reps: Optional[int] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Measure ``device`` into a machine dict (see the module docstring).

    ``fast`` picks the smaller of two size sets (:data:`SIZES`); both reach
    the plateau on the card.  The explicit size and rep overrides exist for
    tests.  Raises when the card is asked for and absent.
    """
    dev = resolve_device(device)
    mm_n, st_n = SIZES[(dev.type, fast)]
    mm_n = matmul_n or mm_n
    st_n = stream_n or st_n
    n_reps = reps or (3 if fast else 10)

    f64 = torch.float64
    matmul64 = _probe_matmul(mm_n, f64, n_reps, dev)
    matmul32 = _probe_matmul(mm_n, torch.float32, n_reps, dev)
    saxpy = _probe_saxpy(st_n, f64, n_reps, dev)
    reduction = _probe_reduction(st_n, f64, n_reps, dev)
    ici = _probe_ici(min(st_n, 1 << 24), f64, n_reps, dev)

    return {
        "name": "measured",
        "source": "measured",
        "meta": collect_meta(dev),
        "working_dtype": "float64",
        "peak_flops": matmul64["flops_per_s"],
        "mem_bw": saxpy["bytes_per_s"],
        "reduce_bw": reduction["bytes_per_s"],
        "ici_bw": None if ici is None else ici["bytes_per_s"],
        "probes": {
            "matmul_f64": matmul64,
            "matmul_f32": matmul32,
            "saxpy": saxpy,
            "reduction": reduction,
            "ici_ppermute": ici,
        },
    }


def card() -> str:
    """The cards' names and power limits, as nvidia-smi reports them (one
    line a card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def collect_meta(device=None) -> Dict[str, Any]:
    """Provenance of a machine file: the platform (``"gpu"`` or ``"cpu"``),
    the device's kind and count, the torch and CUDA versions, and the
    cards' name and power limit."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    return {
        "platform": "gpu" if on_card else "cpu",
        "device_kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 1,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "nvidia_smi": card() if on_card else None,
    }


def save_machine(machine: Dict[str, Any], path: str = DEFAULT_PATH) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(machine, f, indent=1)
        f.write("\n")
    return path


def load_machine(path: str = DEFAULT_PATH) -> Optional[Dict[str, Any]]:
    """Load a machine file; ``None`` when absent (callers fall back)."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        machine = json.load(f)
    for key in ("peak_flops", "mem_bw"):
        if key not in machine:
            raise ValueError(
                f"{path} is not a machine file: missing {key!r} "
                "(regenerate with `python -m repro_torch.perf.machine`)"
            )
    return machine


def resolve_machine(path: Optional[str] = None, preset: str = "h100-sxm") -> Dict[str, Any]:
    """The machine terms to predict with: the JAX package's rule.

    An explicit ``path`` must exist (a typo silently falling back to the
    preset would poison every prediction); with no path the default file
    is used when present and the ``preset`` otherwise.
    """
    if path is not None:
        machine = load_machine(path)
        if machine is None:
            raise FileNotFoundError(
                f"machine file {path} not found; generate one with "
                "`python -m repro_torch.perf.machine --out " + path + "`"
            )
        return machine
    machine = load_machine(DEFAULT_PATH)
    if machine is not None:
        return machine
    return dict(PRESETS[preset])


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Micro-benchmark the card into a machine file.")
    ap.add_argument("--out", default=DEFAULT_PATH)
    ap.add_argument("--full", action="store_true", help="larger probe sizes")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card unless the CPU is asked for")
    args = ap.parse_args(argv)

    machine = profile_machine(fast=not args.full, device=args.device)
    path = save_machine(machine, args.out)
    ici = machine["ici_bw"]
    print(f"wrote {path}")
    print(
        f"  {machine['meta']['nvidia_smi'] or machine['meta']['device_kind']}: "
        f"peak_flops = {machine['peak_flops']:.3e} FLOP/s  "
        f"mem_bw = {machine['mem_bw']:.3e} B/s  "
        f"reduce_bw = {machine['reduce_bw']:.3e} B/s  "
        f"ici_bw = {'n/a (1 device)' if ici is None else f'{ici:.3e} B/s'}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
