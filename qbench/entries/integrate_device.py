"""The device loop: ``core.adaptive.integrate_device``, ``sync_every``
iterations a host read, stopped on the landed rows."""


def solve(cfg, devices, recorder):
    from repro_torch.core import adaptive

    return adaptive.integrate_device(cfg, device=devices[0], recorder=recorder)


def record(res):
    """The result's counters that the metrics read."""
    return dict(host_syncs=res.host_syncs, discarded=res.discarded)
