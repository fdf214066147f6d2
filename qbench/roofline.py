"""The yardstick of the Genz-Malik kernel: its work counted from the
problem, and the card's published peaks.

The work is what the run needed, not what the kernel did: the integrand
evaluations the run reports (``n_evals``), as regions of ``n_nodes(d)``
points each.  Per region the operations are the rule's points times the
plain integrand's operations per point (declared in its family's file),
plus 4d + 20 for the rule's sums and the fourth differences; the bytes are the centres and half-widths
read once and i7, i5, i3 and the d fourth differences written once.  An
exp counts as one operation and an FMA as two, against a rate that counts
an FMA as two.  (The same count as the port's own kernel catalog, kept
here so that a change to the program cannot change the yardstick.)
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM, data sheet, dense rates: FP64 outside the tensor cores,
# and HBM3.  They assume the card's full 700 W power limit; the harness
# reports the card's limit beside every run.
PEAK_FP64_FLOPS = 34e12
PEAK_HBM_BYTES_S = 3.35e12

def n_nodes(d: int) -> int:
    """Points of the degree-7 Genz-Malik rule in d dimensions."""
    return 2**d + 2 * d * d + 2 * d + 1


def gm_work(point_ops: int, d: int, n_evals: float, itemsize: int = 8) -> Dict[str, float]:
    """Operations, bytes and the least time (s) of ``n_evals`` evaluations
    of an integrand of ``point_ops`` operations a point (its family's
    ``point_ops(d)``)."""
    regions = n_evals / n_nodes(d)
    ops = regions * (n_nodes(d) * point_ops + 4 * d + 20)
    nbytes = regions * (3 * d + 3) * itemsize
    return {
        "regions": regions,
        "ops": ops,
        "bytes": nbytes,
        "least_s": max(ops / PEAK_FP64_FLOPS, nbytes / PEAK_HBM_BYTES_S),
        "bound_by": "operations" if ops / PEAK_FP64_FLOPS >= nbytes / PEAK_HBM_BYTES_S else "bytes",
    }
