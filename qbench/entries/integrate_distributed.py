"""The multi-device driver: ``core.distributed.integrate_distributed``, one
rank a device entry, with the configuration's redistribution."""


def solve(cfg, devices, recorder):
    from repro_torch.core import distributed

    return distributed.integrate_distributed(cfg, devices=devices, recorder=recorder)


def record(res):
    """The result's counters that the metrics read."""
    return dict(host_syncs=res.host_syncs, discarded=res.discarded, moved=res.moved,
                imbalance=res.mean_imbalance())
