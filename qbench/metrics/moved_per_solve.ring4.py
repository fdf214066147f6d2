"""Regions the redistribution rounds moved between ranks, per integral (DistributedResult.moved)."""

from qbench import readers

SOURCE = "program_counter"
UNIT = "regions"
LAYER = "Redistribution round"
MOVES = "solve_s"
WORKLOADS = ['gauss8.ring4']


def read(run):
    return readers.mean_of(run, "moved")
