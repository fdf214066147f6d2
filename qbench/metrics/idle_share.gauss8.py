"""Per device, 1 - the union of its operations over the traced window; the largest over devices."""

from qbench import readers

SOURCE = "device_trace"
UNIT = "%"
LAYER = "Device"
MOVES = "solve_s"
WORKLOADS = ['gauss8.single', 'gauss8.device', 'gauss8.ring4']


def read(run):
    return readers.idle_share(run)
