"""Evaluate steps enqueued past the stop and thrown away, per integral (AdaptiveResult.discarded)."""

from qbench import readers

SOURCE = "program_counter"
UNIT = "steps"
LAYER = "Device loop"
MOVES = "solve_s"
WORKLOADS = ['gauss8.device']


def read(run):
    return readers.mean_of(run, "discarded")
