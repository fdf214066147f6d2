"""Adaptive engine: config, rule, region store, classify, split, drivers."""
