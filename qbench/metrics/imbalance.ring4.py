"""1 - mean/max of the fresh regions per rank, averaged over iterations, then over integrals
(DistributedResult.mean_imbalance())."""

from qbench import readers

SOURCE = "program_counter"
UNIT = "ratio"
LAYER = "Ranks and metadata exchange"
MOVES = "solve_s"
WORKLOADS = ['gauss8.ring4']


def read(run):
    return readers.mean_of(run, "imbalance")
