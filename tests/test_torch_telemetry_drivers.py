"""Every port driver with a telemetry recorder attached, on the CPU.

The recorder changes no result bit and adds no read: each driver's result
(status, iterations, evaluations, integral and error to the bit) and its
``host_syncs`` are the same with a recorder and without one, also with
every span opened as a range.  The recorded streams carry the JAX package's
names plus the port's stage spans, each driver's exact multiset of them,
the distributed driver's ``dist.work_imb`` gauges average to
``mean_imbalance()``, and the service's counters and event multiset equal
the JAX service's on the config of ``tests/test_telemetry.py``.
"""

import collections
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.adaptive import integrate, integrate_device
from repro_torch.core.config import QuadratureConfig
from repro_torch.core.distributed import integrate_distributed
from repro_torch.core.integrands import get_param
from repro_torch.mc import integrate_vegas, integrate_vegas_distributed
from repro_torch.service import BatchScheduler, GracefulScheduler, QuadRequest
from repro_torch.service.faults import DeviceDown
from repro_torch.service.sharded_selftest import tuples
from repro_torch.telemetry import JsonlSink, MemorySink, Recorder, ServiceStats, quantile
from repro_torch.telemetry import loadview
from repro_torch.telemetry.check import check_metrics, check_trace
from repro_torch.telemetry.trace import write_chrome_trace

torch.set_num_threads(1)

FAMILY = get_param("genz_gaussian")


def _recorded(tmp_path=None, ranges=None):
    """A recorder with a memory sink (and a JSONL sink when a directory is
    given: every attribute must then encode as a host number)."""
    sink = MemorySink()
    sinks = (sink,) if tmp_path is None else (sink, JsonlSink(str(tmp_path / "m.jsonl")))
    return Recorder(sinks=sinks, ranges=ranges), sink


class Ranges:
    """A ``ranges`` hook that logs each range it opens and closes, and
    checks that they close in nesting order."""

    def __init__(self):
        self.log, self.open = [], []

    @contextlib.contextmanager
    def __call__(self, name):
        self.log.append(name)
        self.open.append(name)
        try:
            yield
        finally:
            assert self.open.pop() == name

    def names(self):
        assert not self.open
        return collections.Counter(self.log)


def _spans(events):
    """The span names of a stream, each counted once a span."""
    return collections.Counter(e["name"] for e in events if e["kind"] == "span_end")


def _bits(res):
    return (res.status, res.iterations, res.n_evals, res.integral.hex(), res.error.hex(),
            res.host_syncs)


def _names(events):
    return collections.Counter((e["kind"], e["name"]) for e in events)


# --- the single-problem drivers ------------------------------------------------------


@pytest.mark.parametrize("rule", ["genz_malik", "gauss_kronrod"])
def test_integrate_on_off_bit_parity(rule, tmp_path):
    cfg = QuadratureConfig(d=3 if rule == "genz_malik" else 2, integrand="f4", rel_tol=1e-6,
                           capacity=1 << 11, rule=rule)
    off = integrate(cfg, device="cpu")
    ranges = Ranges()
    rec, sink = _recorded(tmp_path, ranges)
    on = integrate(cfg, device="cpu", recorder=rec)
    rec.close()
    assert _bits(on) == _bits(off)
    assert (on.eval_rows, on.eval_rows_exact) == (off.eval_rows, off.eval_rows_exact)
    names = _names(sink.events)
    evals = names[("span_end", "core.eval")]
    assert evals == names[("instant", "core.iter")] == off.host_syncs - 1
    assert names[("span_end", "core.advance")] == off.iterations
    # one evaluate step a core.eval; a compact and a split an advance; a
    # core.read a host read
    assert _spans(sink.events) == {
        "core.init": 1, "core.partition": 1, "core.eval": evals, "core.rule": evals,
        "core.classify": evals, "core.read": off.host_syncs, "core.advance": off.iterations,
        "core.compact": off.iterations, "core.split": off.iterations}
    assert ranges.names() == _spans(sink.events)
    assert check_metrics(str(tmp_path / "m.jsonl")) == []


def test_integrate_events_match_the_jax_driver():
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.core.adaptive import integrate as jintegrate
    from repro.core.config import QuadratureConfig as JConfig
    from repro.telemetry import MemorySink as JSink, Recorder as JRecorder

    fields = dict(d=2, integrand="f4", rel_tol=1e-7, capacity=1 << 9)
    jsink = JSink()
    jres = jintegrate(JConfig(**fields), recorder=JRecorder(sinks=(jsink,)))
    rec, sink = _recorded()
    res = integrate(QuadratureConfig(**fields), device="cpu", recorder=rec)
    assert (res.status, res.iterations) == (jres.status, jres.iterations)
    # the names both packages emit, each as often; the port's others are
    # exactly its stage spans
    ours, theirs = _names(sink.events), _names(jsink.events)
    assert {k: ours[k] for k in theirs} == theirs
    assert {k for k in ours if k not in theirs} == {
        (kind, name) for kind in ("span_begin", "span_end")
        for name in ("core.init", "core.partition", "core.rule", "core.classify", "core.read",
                     "core.compact", "core.split")}
    it_t = [(e["it"], e["n_active"]) for e in sink.events if e["name"] == "core.iter"]
    it_j = [(e["it"], e["n_active"]) for e in jsink.events if e["name"] == "core.iter"]
    assert it_t == it_j


def test_integrate_device_on_off_bit_parity():
    cfg = QuadratureConfig(d=3, integrand="f4", rel_tol=1e-6, capacity=1 << 11, sync_every=3)
    off = integrate_device(cfg, device="cpu")
    ranges = Ranges()
    rec, sink = _recorded(ranges=ranges)
    on = integrate_device(cfg, device="cpu", recorder=rec)
    assert _bits(on) == _bits(off)
    assert (on.discarded, on.eval_rows, on.eval_rows_exact) == (
        off.discarded, off.eval_rows, off.eval_rows_exact)
    # every snapshot lands at once on the CPU: the loop stops after the
    # evaluate step that converged, and discards none
    steps, advances = off.iterations + 1, off.iterations
    assert off.discarded == 0
    assert _names(sink.events) == {
        (kind, name): n for kind in ("span_begin", "span_end") for name, n in (
            ("core.device_loop", 1), ("core.init", 1), ("core.partition", 1),
            ("core.rule", steps), ("core.classify", steps), ("core.snapshot", steps + advances),
            ("core.compact", advances), ("core.split", advances), ("core.read", off.host_syncs))}
    assert ranges.names() == _spans(sink.events)


def test_integrate_distributed_three_ranks_on_off_bit_parity(tmp_path):
    cfg = QuadratureConfig(d=3, integrand="f6", rel_tol=1e-4, capacity=1 << 11)
    off = integrate_distributed(cfg, devices=["cpu"] * 3)
    ranges = Ranges()
    rec, sink = _recorded(tmp_path, ranges)
    on = integrate_distributed(cfg, devices=["cpu"] * 3, recorder=rec)
    rec.close()
    assert _bits(on) == _bits(off)
    assert on.history == off.history and on.moved == off.moved
    assert (on.discarded, on.eval_rows, on.eval_rows_exact) == (
        off.discarded, off.eval_rows, off.eval_rows_exact)
    # every iteration runs whole (snapshots land at once on the CPU); each
    # stage span covers every rank
    its, syncs = off.iterations, off.host_syncs
    assert off.discarded == 0
    assert _spans(sink.events) == {
        "dist.init": 1, "core.partition": 1, "dist.dispatch": syncs, "dist.read": syncs,
        "dist.eval": its, "dist.exchange": its, "dist.advance": its, "dist.round": its,
        "dist.snapshot": its}
    assert ranges.names() == _spans(sink.events)
    names = _names(sink.events)
    assert names[("gauge", "dist.work_imb")] == names[("instant", "dist.iter")] == off.iterations
    # one span per dispatch, each holding at most sync_every iterations
    executed = [e["executed"] for e in sink.events
                if e["kind"] == "span_end" and e["name"] == "dist.dispatch"]
    assert len(executed) == names[("span_begin", "dist.dispatch")] == off.host_syncs
    assert sum(executed) == off.iterations
    assert all(1 <= k <= cfg.sync_every for k in executed)


def test_distributed_imbalance_telemetry_matches_offline():
    """The mean of the dist.work_imb gauges is mean_imbalance(): the same
    floats, summed in another order (the JAX package's bar)."""
    cfg = QuadratureConfig(d=3, integrand="f6", rel_tol=1e-5, capacity=1 << 12, max_iters=100)
    rec, sink = _recorded()
    res = integrate_distributed(cfg, devices=["cpu"] * 2, recorder=rec)
    assert res.status == "converged" and len(res.history) > 0
    gauges = [e["value"] for e in sink.events if e["name"] == "dist.work_imb"]
    assert gauges == [h[4] for h in res.history]
    assert loadview.mean_work_imbalance_from_events(sink.events) == pytest.approx(
        res.mean_imbalance(), rel=1e-12, abs=1e-15)


@pytest.mark.parametrize("ranks", [1, 2])
def test_vegas_on_off_bit_parity(ranks):
    cfg = QuadratureConfig(d=4, integrand="genz_gaussian:5,5,5,5:0.5,0.5,0.5,0.5",
                           backend="vegas", rel_tol=1e-2, mc_samples=2048, mc_max_iters=30)

    def run(**kw):
        if ranks == 1:
            return integrate_vegas(cfg, device="cpu", **kw)
        return integrate_vegas_distributed(cfg, devices=["cpu"] * ranks, **kw)

    off = run()
    rec, sink = _recorded()
    on = run(recorder=rec)
    assert _bits(on) + (on.chi2_dof,) == _bits(off) + (off.chi2_dof,)
    names = _names(sink.events)
    assert names[("instant", "mc.config")] == 1
    assert names[("span_end", "mc.iterate")] == names[("instant", "mc.iter")] \
        == names[("gauge", "mc.samples_per_s")] == off.iterations


# --- the service ---------------------------------------------------------------------


def _cfg(**kw):
    base = dict(d=2, integrand="genz_gaussian", rel_tol=1e-4, capacity=1 << 9,
                batch_slots=4, max_iters=60, sync_every=4)
    base.update(kw)
    return QuadratureConfig(**base)


def _requests(n, seed=0, family=FAMILY, quad_request=QuadRequest):
    rng = np.random.default_rng(seed)
    return [quad_request(req_id=i, theta=family.sample_theta(2, rng)) for i in range(n)]


@pytest.mark.parametrize("ranks", [1, 2])
def test_scheduler_on_off_bit_parity(ranks, tmp_path):
    devices = ["cpu"] * ranks
    off = BatchScheduler(_cfg(), FAMILY, devices=devices)
    off_t = tuples(off.serve(_requests(6)))
    rec, sink = _recorded(tmp_path)
    on = BatchScheduler(_cfg(), FAMILY, devices=devices, recorder=rec)
    assert tuples(on.serve(_requests(6))) == off_t
    rec.close()
    assert on.last_stats == off.last_stats
    assert rec.counters["service.collections"] == 6
    # every ServiceStats bump reached the recorder
    assert {k: v for k, v in on.last_stats.items() if v} == {
        k.split(".", 1)[1]: v for k, v in rec.counters.items()}
    assert check_metrics(str(tmp_path / "m.jsonl")) == []


def test_graceful_recorder_parity_and_stats_view():
    off_sched = GracefulScheduler(_cfg(), FAMILY, devices=["cpu"])
    off = tuples(off_sched.serve(_requests(5)))
    rec, sink = _recorded()
    on_sched = GracefulScheduler(_cfg(), FAMILY, devices=["cpu"], recorder=rec)
    assert tuples(on_sched.serve(_requests(5))) == off
    assert on_sched.last_stats == off_sched.last_stats
    assert set(on_sched.last_stats) == {f.name for f in dataclasses.fields(ServiceStats)}
    assert any(e["name"] == "service.drain" for e in sink.events)


def test_graceful_reroutes_are_flows(tmp_path):
    cfg = _cfg(capacity=32, rel_tol=1e-7, batch_slots=2, mc_samples=2048, mc_max_iters=20)
    off_sched = GracefulScheduler(cfg, FAMILY, devices=["cpu"])
    off = tuples(off_sched.serve(_requests(2)))
    rec, sink = _recorded()
    on_sched = GracefulScheduler(cfg, FAMILY, devices=["cpu"], recorder=rec)
    assert tuples(on_sched.serve(_requests(2))) == off
    assert on_sched.last_stats == off_sched.last_stats
    n = on_sched.last_stats["reroutes"]
    flows = [e for e in sink.events if e["kind"] == "flow_begin" and e["name"] == "service.reroute"]
    assert n > 0 and len(flows) == n == rec.counters["service.reroutes"]
    assert {e["to_backend"] for e in flows} == {"vegas"}
    # the VEGAS pool records its own build, no eval-window gauge
    builds = [e for e in sink.events if e["kind"] == "span_end" and e["name"] == "engine.build"]
    assert [e["backend"] for e in builds] == ["cubature", "vegas"]
    path = str(tmp_path / "t.json")
    write_chrome_trace(path, sink.events)
    assert check_trace(path, expect_flow_name="service.reroute") == []


@pytest.mark.parametrize("ranks", [1, 2])
def test_scheduler_records_per_rank_occupancy(ranks):
    rec, sink = _recorded()
    sched = BatchScheduler(_cfg(), FAMILY, devices=["cpu"] * ranks, recorder=rec)
    list(sched.serve(_requests(6)))
    tl = loadview.occupancy_from_events(sink.events)
    assert tl.devices == list(range(ranks))
    assert tl.iterations == list(range(1, sched.last_stats["iterations"] + 1))
    per_rank = 4 // ranks
    assert max(max(tl.series(r)) for r in range(ranks)) <= per_rank
    idle = loadview.idle_fraction(tl, slots_per_device=per_rank)
    assert all(0.0 <= idle[r] < 1.0 for r in range(ranks))


def test_scheduler_records_dispatch_latency_histograms():
    rec, sink = _recorded()
    list(BatchScheduler(_cfg(), FAMILY, devices=["cpu"], recorder=rec).serve(_requests(6)))
    wall = loadview.hist_values_from_events(sink.events, "service.dispatch_wall_s")
    wait = loadview.hist_values_from_events(sink.events, "service.queue_wait_s")
    n_dispatch = rec.counters["service.dispatches"]
    assert len(wall) == n_dispatch > 0
    assert len(wait) == n_dispatch - 1
    assert all(v > 0 for v in wall) and all(v >= 0 for v in wait)
    assert rec.quantile("service.dispatch_wall_s", 0.5) == quantile(wall, 0.5)
    assert rec.hists["service.dispatch_wall_s"]["count"] == len(wall)
    spans = [e["name"] for e in sink.events if e["kind"] == "span_end"
             and e["name"] in ("service.compile", "service.dispatch")]
    assert spans == ["service.compile"] + ["service.dispatch"] * (n_dispatch - 1)


def test_rank_loss_on_off_bit_parity_and_evacuation_flows(tmp_path):
    cfg = _cfg(batch_slots=8, capacity=1 << 10, rel_tol=1e-3, max_iters=80)

    def run(recorder=None):
        kw = {} if recorder is None else {"recorder": recorder}
        sched = BatchScheduler(cfg, FAMILY, devices=["cpu"] * 4, retry_backoff_s=0.0,
                               fault_injector=DeviceDown(device=2, at_tick=2, restore_at_tick=6),
                               **kw)
        return sched, tuples(sched.serve(_requests(16)))

    off_sched, off = run()
    rec, sink = _recorded(tmp_path)
    on_sched, on = run(rec)
    rec.close()
    assert on == off and on_sched.last_stats == off_sched.last_stats
    stats = on_sched.last_stats
    assert stats["evacuations"] > 0 and stats["mesh_shrinks"] == stats["mesh_regrows"] == 1
    names = _names(sink.events)
    assert names[("flow_begin", "service.evacuate")] == stats["evacuations"]
    assert names[("instant", "service.device_lost")] == 1
    assert names[("span_end", "service.mesh_shrink")] == names[("span_end", "service.mesh_regrow")] == 1
    assert names[("instant", "service.dispatch_fault")] == stats["dispatch_retries"] + 1
    path = str(tmp_path / "t.json")
    write_chrome_trace(path, sink.events)
    assert check_trace(path, n_devices=4, expect_flow_name="service.evacuate") == []


def test_service_counters_and_events_match_the_jax_service():
    """The config of tests/test_telemetry.py: the same counters and the same
    multiset of (kind, name) pairs as the JAX BatchScheduler's run."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.core.config import QuadratureConfig as JConfig
    from repro.core.integrands import get_param as jget_param
    from repro.service import BatchScheduler as JScheduler, QuadRequest as JRequest
    from repro.telemetry import MemorySink as JSink, Recorder as JRecorder

    fields = dict(d=2, integrand="genz_gaussian", rel_tol=1e-4, capacity=1 << 9,
                  batch_slots=4, max_iters=60, sync_every=4)
    jfam = jget_param("genz_gaussian")
    jsink = JSink()
    jrec = JRecorder(sinks=(jsink,))
    jsched = JScheduler(JConfig(**fields), jfam, recorder=jrec)
    jres = list(jsched.serve(_requests(6, family=jfam, quad_request=JRequest)))
    rec, sink = _recorded()
    sched = BatchScheduler(QuadratureConfig(**fields), FAMILY, devices=["cpu"], recorder=rec)
    res = list(sched.serve(_requests(6)))
    assert [(r.req_id, r.status, r.iterations, r.n_evals) for r in res] == [
        (r.req_id, r.status, r.iterations, r.n_evals) for r in jres]
    assert sched.last_stats == jsched.last_stats
    assert rec.counters == jrec.counters
    assert _names(sink.events) == _names(jsink.events)
    for name in ("service.n_live", "service.window"):
        pick = lambda evs: [(e["lane"], e["it"], e["value"]) for e in evs if e["name"] == name]
        assert pick(sink.events) == pick(jsink.events), name


def test_a_tensor_attribute_raises(tmp_path):
    rec = Recorder(sinks=(JsonlSink(str(tmp_path / "m.jsonl")),))
    with pytest.raises(TypeError, match="torch.Tensor"):
        rec.event("core.iter", integral=torch.tensor(1.0))
