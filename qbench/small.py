"""The cells at sizes the CPU tests run in seconds (the same code paths)."""

from __future__ import annotations

import copy

from qbench import harness


def small(cell: str, **quadrature):
    """(config, traffic, devices) of ``cell`` cut to d = 3 and small stores,
    on the CPU, one device entry per rank."""
    entry = harness.cell_entry(harness.manifest(), cell)
    config = copy.deepcopy(harness.load_json(harness.HERE / "configs" / f"{entry['config']}.json"))
    traffic = copy.deepcopy(harness.load_json(harness.HERE / "traffic" / f"{entry['traffic']}.json"))
    q = config["quadrature"]
    q.update(d=3, capacity=1 << 14, max_iters=60, n_init=0)
    q.pop("init_regions_per_device", None)
    if config["theta"]:
        config["theta"] = {k: v[:3] for k, v in config["theta"].items()}
    q.update(quadrature)
    return config, traffic, ["cpu"] * config.get("ranks", 1)
