"""Device idle seconds under the port's set-up spans (core.init, core.partition, dist.init) per
integral, per card: the idle gaps devtrace names by the innermost host span around each gap's
midpoint, summed over cards, over the cards and the integrals of the window."""

# the port's set-up spans (core/adaptive.py, core/distributed.py, core/region_store.py)
SPANS = ("core.init", "core.partition", "dist.init")

SOURCE = "device_trace"
UNIT = "s"
LAYER = "Initial partition"
MOVES = "solve_s"
WORKLOADS = ['gauss8.single', 'gauss8.device', 'gauss8.ring4']


def read(run):
    t = run.trace
    if not (t and t["devices"] and run.items):
        return None
    gaps = dict(t["idle_gaps"])
    if not any(name in gaps for name in SPANS):
        return None  # a program without these spans
    return sum(gaps.get(name, 0.0) for name in SPANS) / len(t["devices"]) / len(run.items)
