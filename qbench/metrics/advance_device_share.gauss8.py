"""Device time of every operation but the GM kernel (the advance's sorts, gathers, copies and
elementwise kernels) over the traced window, per device, averaged over devices."""

from qbench import readers

# the GM kernel, as the profiler names it (gm::gm_eval_kernel<T, D, F>)
KERNEL = "gm_eval_kernel"

SOURCE = "device_trace"
UNIT = "%"
LAYER = "Advance"
MOVES = "solve_s"
WORKLOADS = ['gauss8.single', 'gauss8.device', 'gauss8.ring4']


def read(run):
    return readers.share_without(run, KERNEL)
