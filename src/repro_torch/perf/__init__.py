"""Performance observatory of the port: machine probes, a kernel catalog
with counted work, the regression gate and the report.

The port's counterpart of the JAX package's ``repro.perf``, four layers,
each usable alone:

- :mod:`~repro_torch.perf.machine`: micro-benchmark the card into a machine
  file (peak FLOP/s of a timed matmul, memory bandwidth of timed saxpy and
  reduction probes, a ring of copies over the cards), timed with CUDA
  events, plus the ``"h100-sxm"`` data-sheet preset;
- :mod:`~repro_torch.perf.catalog`: time the port's own steps (the GM rule
  evaluation at each window rung, the windowed advance, the VEGAS iterate,
  the batch service's dispatch) and count their FLOPs and bytes with one
  documented formula per kind, then predict a roofline bound from the
  machine file;
- :mod:`~repro_torch.perf.regress`: compare two ``BENCH_summary.json``
  files with noise-tolerant thresholds (the perf gate);
- :mod:`~repro_torch.perf.report`: render the machine file, the catalog,
  the port's benchmark results and a telemetry stream's latency and idle
  views into one markdown/HTML report under ``results/perf_torch/``.

Everything here measures; nothing in this package is on an integration or
serving path.
"""

from repro_torch.perf.machine import (
    PRESETS,
    load_machine,
    profile_machine,
    resolve_machine,
    save_machine,
)

__all__ = [
    "PRESETS",
    "load_machine",
    "profile_machine",
    "resolve_machine",
    "save_machine",
]
