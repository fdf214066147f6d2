"""Host reads of the card per iteration in the host loop (AdaptiveResult.host_syncs / iterations)."""

from qbench import readers

SOURCE = "program_counter"
UNIT = "syncs/iter"
LAYER = "Host loop"
MOVES = "solve_s"
WORKLOADS = ['gauss8.single']


def read(run):
    return readers.ratio(run, "host_syncs", "iterations")
