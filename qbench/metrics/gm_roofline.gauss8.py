"""The least time of the evaluations the integrals needed (qbench/roofline.py) over the GM
kernel's device time."""

from qbench import readers

# the GM kernel, as the profiler names it (gm::gm_eval_kernel<T, D, F>)
KERNEL = "gm_eval_kernel"

SOURCE = "device_trace"
UNIT = "%"
LAYER = "Rule and GM kernel"
MOVES = "solve_s"
WORKLOADS = ['gauss8.single', 'gauss8.device', 'gauss8.ring4']


def read(run):
    return readers.gm_roofline(run, KERNEL)
