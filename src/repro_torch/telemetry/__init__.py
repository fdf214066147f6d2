"""Observability of the port.  So far the logging convention of the CLIs and
self-tests (:mod:`repro_torch.telemetry.logutil`)."""
