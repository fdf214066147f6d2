"""The host loop: ``core.adaptive.integrate``, one host read an iteration."""


def solve(cfg, devices, recorder):
    from repro_torch.core import adaptive

    return adaptive.integrate(cfg, device=devices[0], recorder=recorder)


def record(res):
    """The result's counters that the metrics read."""
    return dict(host_syncs=res.host_syncs, discarded=res.discarded)
