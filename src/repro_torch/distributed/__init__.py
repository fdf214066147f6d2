"""Mesh-aware sharding: the port of :mod:`repro.distributed`."""
