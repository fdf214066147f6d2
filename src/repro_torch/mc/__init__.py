"""VEGAS+ adaptive importance-sampling Monte Carlo backend.

The port of the JAX package's ``repro.mc``: per-axis importance grids with
damped refinement (:mod:`repro_torch.mc.grid`), stratified sampling with
VEGAS+ per-hypercube count adaptation (:mod:`repro_torch.mc.stratified`),
the iteration and weighted-average estimator with a chi^2/dof guard, and
the service pool (:mod:`repro_torch.mc.engine`), and sample shards over
ranks, bit-identical to one rank (:mod:`repro_torch.mc.multi_device`).
Selected by ``QuadratureConfig(backend="vegas")`` (or ``"auto"`` at
``d >= auto_backend_dim``).
"""

from repro_torch.mc.engine import (
    VegasBatchEngine,
    VegasResult,
    VegasState,
    integrate_vegas,
)

__all__ = [
    "VegasBatchEngine",
    "VegasResult",
    "VegasState",
    "integrate_vegas",
    "integrate_vegas_distributed",
]


def __getattr__(name):
    # Lazy, so that ``python -m repro_torch.mc.multi_device`` (the parity
    # self-test) does not import the module it is about to run twice.
    if name == "integrate_vegas_distributed":
        from repro_torch.mc.multi_device import integrate_vegas_distributed

        return integrate_vegas_distributed
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
