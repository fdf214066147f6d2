"""The service's counter schema; it lives in
:mod:`repro_torch.telemetry.stats` and is re-exported here for the imports
that name this module."""

from repro_torch.telemetry.stats import ServiceStats

__all__ = ["ServiceStats"]
