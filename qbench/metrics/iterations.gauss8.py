"""Iterations to converge per integral (each driver's own count), the run's mean."""

from qbench import readers

SOURCE = "program_counter"
UNIT = "iterations"
LAYER = "Advance"
MOVES = "solve_s"
WORKLOADS = ['gauss8.single', 'gauss8.device', 'gauss8.ring4']


def read(run):
    return readers.mean_of(run, "iterations")
