"""Nothing the harness runs loads JAX or the JAX package, compared by whole
top-level name (the port's name begins with the JAX package's), and a run
without CUDA prints no result."""

import subprocess
import sys

from qbench import harness

PROBE = r"""
import sys, time
sys.path[:0] = [{root!r}, {src!r}]
from qbench import harness, control, small
for m in harness.manifest()["per_layer"]:
    harness.load_metric(m["name"])
cfg, traffic, devices = small.small("gauss8.single")
line, _ = harness.run_cell("gauss8.single", 7, 0.05, False, devices, time.monotonic(), cfg,
                           traffic)
assert line["correct"], line
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_harness_loads_no_jax_and_no_repro():
    root = str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=root, src=root + "/src")],
                         capture_output=True, text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(out.stdout.split())
    assert "repro_torch" in tops and "qbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops & {"jax", "jaxlib", "flax", "repro"}


def test_run_without_cuda_exits_non_zero_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "qbench/run.py", "--workload", "gauss8.single", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(harness.ROOT),
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
