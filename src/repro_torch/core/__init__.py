"""Adaptive engine: config, rules, region store, classify, split, drivers.

The JAX package's ``repro.core`` API: :class:`QuadratureConfig`,
:func:`integrate`, :func:`integrate_device`, :func:`integrate_exact_check`,
:func:`make_rule`, :class:`GenzMalikRule`, :class:`GaussKronrodRule`,
:class:`AdaptiveResult` and ``INTEGRANDS`` (the registry).  The names
resolve on first use: the submodules of this package import one another
(and ``repro_torch.service`` and ``repro_torch.mc`` import them), so an
eager import here would run the drivers' imports before the modules they
need.
"""

import importlib

_EXPORTS = {
    "AdaptiveResult": ("repro_torch.core.adaptive", "AdaptiveResult"),
    "GaussKronrodRule": ("repro_torch.core.rules", "GaussKronrodRule"),
    "GenzMalikRule": ("repro_torch.core.rules", "GenzMalikRule"),
    "INTEGRANDS": ("repro_torch.core.integrands", "REGISTRY"),
    "QuadratureConfig": ("repro_torch.core.config", "QuadratureConfig"),
    "integrate": ("repro_torch.core.adaptive", "integrate"),
    "integrate_device": ("repro_torch.core.adaptive", "integrate_device"),
    "integrate_exact_check": ("repro_torch.core.adaptive", "integrate_exact_check"),
    "make_rule": ("repro_torch.core.rules", "make_rule"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    return getattr(importlib.import_module(module), attr)
