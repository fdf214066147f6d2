"""The benchmark of the PyTorch/CUDA port of the adaptive quadrature system.

One command runs one cell once (see ``README.md``)::

    python3 qbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix, one cell or
one per-layer metric is a file of its own under ``configs/``, ``traffic/``,
``workloads/`` and ``metrics/``, found by the names in ``BENCHMARK.json``;
the code they name is found the same way, under ``drivers/``,
``entries/`` and ``families/``.
The harness imports the port (``repro_torch``) and nothing of the JAX
package.
"""
