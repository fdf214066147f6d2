"""The port's telemetry modules against the JAX package's.

Every unit case of ``tests/test_telemetry.py`` (recorder, sinks, Chrome
trace, checker, load views, ServiceStats, quantiles) runs against both
packages' ``telemetry`` modules.  Then both ``Recorder``\\ s are driven with
one fake clock and the same calls, and everything derived from the two
streams must be equal dict for dict: the events, the summary tables, the
Chrome traces, the load views and the checker's findings.  A port trace
written by a real CPU run must pass the JAX checker, and the port's sinks
refuse a ``torch.Tensor``.
"""

import dataclasses
import importlib
import json
import types

import numpy as np
import pytest
import torch

PACKAGES = ("repro", "repro_torch")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _telemetry(pkg):
    top = importlib.import_module(f"{pkg}.telemetry")
    ns = types.SimpleNamespace(**{k: getattr(top, k) for k in top.__all__})
    for sub in ("core", "sinks", "trace", "loadview", "check", "stats"):
        setattr(ns, sub, importlib.import_module(f"{pkg}.telemetry.{sub}"))
    return ns


@pytest.fixture(params=PACKAGES)
def tel(request):
    return _telemetry(request.param)


# --- recorder core -----------------------------------------------------------


def test_span_nesting_ordering_and_durations(tel):
    clock = FakeClock()
    sink = tel.MemorySink()
    rec = tel.Recorder(sinks=(sink,), clock=clock)
    with rec.span("outer", lane=None) as outer:
        clock.advance(1.0)
        with rec.span("inner", lane=2, it=7):
            clock.advance(0.5)
        clock.advance(0.25)
        outer["executed"] = 3
    kinds = [(e["kind"], e["name"]) for e in sink.events]
    assert kinds == [
        ("span_begin", "outer"),
        ("span_begin", "inner"),
        ("span_end", "inner"),
        ("span_end", "outer"),
    ]
    begin_outer, begin_inner, end_inner, end_outer = sink.events
    assert begin_outer["depth"] == 0 and begin_inner["depth"] == 1
    assert end_inner["dur"] == 0.5 and end_inner["it"] == 7
    assert end_inner["lane"] == 2
    assert end_outer["dur"] == 1.75
    assert end_outer["executed"] == 3
    assert [e["seq"] for e in sink.events] == [0, 1, 2, 3]
    assert rec.span_totals["outer"] == {"count": 1, "total_s": 1.75}


def test_counters_gauges_hists_aggregate(tel):
    rec = tel.Recorder(sinks=(tel.MemorySink(),), clock=FakeClock())
    rec.count("service.admissions", 2)
    rec.count("service.admissions")
    rec.gauge("service.n_live", 5, lane=1)
    rec.gauge("service.n_live", 3, lane=1)
    rec.observe("dispatch_ms", 4.0)
    rec.observe("dispatch_ms", 6.0)
    assert rec.counters["service.admissions"] == 3
    assert rec.gauges["service.n_live[1]"] == 3
    assert rec.hists["dispatch_ms"] == {"count": 2, "sum": 10.0, "min": 4.0, "max": 6.0}
    table = tel.summary_table(rec)
    assert "service.admissions" in table and "dispatch_ms" in table


def test_null_recorder_is_inert(tel):
    null = tel.NULL
    assert not null.enabled
    null.count("x")
    null.gauge("x", 1)
    with null.span("x") as sp:
        sp["attr"] = 1
    assert null.flow("x", 0, 1) == 0
    with pytest.raises(RuntimeError):
        null.add_sink(tel.MemorySink())


# --- sinks -------------------------------------------------------------------


def test_jsonl_round_trip(tel, tmp_path):
    path = str(tmp_path / "m.jsonl")
    rec = tel.Recorder(sinks=(tel.JsonlSink(path),), clock=FakeClock())
    rec.count("a", 1)
    rec.gauge("b", np.float64(2.5), lane=np.int32(1))  # numpy scalars tolerated
    rec.event("c", note="hi")
    rec.close()
    events = tel.read_jsonl(path)
    assert [e["kind"] for e in events] == ["counter", "gauge", "instant"]
    assert events[1]["value"] == 2.5 and events[1]["lane"] == 1
    assert events[2]["note"] == "hi"
    assert tel.check.check_metrics(path) == []


# --- chrome trace export -----------------------------------------------------


def _synthetic_run_events(tel, clock=None):
    clock = clock or FakeClock()
    sink = tel.MemorySink()
    rec = tel.Recorder(sinks=(sink,), clock=clock)
    rec.event("service.start", backend="cubature")
    for it in range(3):
        with rec.span("service.dispatch", it=it):
            clock.advance(0.01)
        for dev in range(2):
            rec.gauge("service.n_live", 2 - dev, lane=dev, it=it + 1)
    rec.flow("service.migrate", 0, 1, req_id=5)
    rec.count("service.iterations", 3)
    return sink.events


def test_chrome_trace_schema_valid(tel, tmp_path):
    path = str(tmp_path / "trace.json")
    tel.write_chrome_trace(path, _synthetic_run_events(tel))
    assert tel.check.check_trace(path, n_devices=2, expect_flow=True) == []
    events = json.load(open(path))["traceEvents"]
    assert {"M", "B", "E", "i", "C", "s", "f"} <= {e["ph"] for e in events}
    for e in events:
        assert "pid" in e and "tid" in e
        if e["ph"] != "M":
            assert "ts" in e
    opens = {}
    for e in events:
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            opens[key] = opens.get(key, 0) + 1
        elif e["ph"] == "E":
            opens[key] -= 1
    assert all(v == 0 for v in opens.values()), opens


def test_chrome_trace_checker_flags_problems(tel, tmp_path):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": [{"ph": "B", "name": "x", "pid": 1, "tid": 1, "ts": 0}]}, f)
    problems = tel.check.check_trace(path, n_devices=1, expect_flow=True)
    assert any("unclosed" in p for p in problems)
    assert any("device 0" in p for p in problems)
    assert any("flow" in p for p in problems)


def test_checker_expect_flow_name(tel, tmp_path):
    path = str(tmp_path / "trace.json")
    tel.write_chrome_trace(path, _synthetic_run_events(tel))
    assert tel.check.check_trace(path, expect_flow_name="service.migrate") == []
    problems = tel.check.check_trace(path, expect_flow_name="service.evacuate")
    assert any("service.evacuate" in p for p in problems), problems


def test_attrs_cannot_clobber_event_envelope(tel):
    sink = tel.MemorySink()
    rec = tel.Recorder(sinks=(sink,), clock=FakeClock())
    rec.count("c", kind="evil", ts=99)
    rec.gauge("g", 1.0, kind="evil")
    rec.observe("h", 1.0, kind="evil")
    rec.event("i", kind="evil")
    with rec.span("s", kind="evil") as sp:
        sp["kind"] = "evil"
    rec.flow("f", 0, 1, kind="evil", id=-1)
    assert [e["kind"] for e in sink.events] == [
        "counter", "gauge", "hist", "instant", "span_begin", "span_end", "flow_begin", "flow_end",
    ]
    assert [e["name"] for e in sink.events][:1] == ["c"]
    assert sink.events[0]["ts"] == 0.0
    assert sink.events[-1]["id"] == sink.events[-2]["id"] == 1


# --- load views --------------------------------------------------------------


def test_imbalance_matches_dist_step_formula(tel):
    lv = tel.loadview
    assert lv.imbalance([4, 4, 4, 4]) == 0.0
    assert lv.imbalance([8, 0, 0, 0]) == pytest.approx(1 - 2 / 8)
    assert lv.imbalance([0, 0]) == 0.0
    assert lv.imbalance([]) == 0.0


def _occupancy_events():
    events = []
    series = {0: [4, 4, 2], 1: [4, 0, 0]}
    for it in range(3):
        for dev in (0, 1):
            events.append({"kind": "gauge", "name": "service.n_live", "ts": float(it),
                           "seq": len(events), "lane": dev, "value": series[dev][it], "it": it})
    return events


def test_idle_fraction_on_hand_built_timeline(tel):
    lv = tel.loadview
    tl = lv.occupancy_from_events(_occupancy_events())
    assert tl.devices == [0, 1] and tl.iterations == [0, 1, 2]
    assert tl.series(0) == [4, 4, 2] and tl.series(1) == [4, 0, 0]
    idle = lv.idle_fraction(tl, slots_per_device=4)
    assert idle[0] == pytest.approx(1 - 10 / 12)
    assert idle[1] == pytest.approx(1 - 4 / 12)
    imb = lv.imbalance_series(tl)
    assert imb[0] == 0.0
    assert imb[1] == pytest.approx(1 - 2 / 4)
    assert lv.mean_imbalance(tl) == pytest.approx(sum(imb) / 3)


# --- ServiceStats ------------------------------------------------------------


def test_service_stats_add_merge_round_trip(tel):
    a = tel.ServiceStats()
    a.add("admissions", 3)
    a.add("migrations")
    b = tel.ServiceStats(iterations=5, admissions=1)
    a.merge(b)
    assert a.admissions == 4 and a.iterations == 5 and a.migrations == 1
    assert tel.ServiceStats.from_dict(a.as_dict()) == a


def test_service_stats_drift_guard(tel):
    assert tel.ServiceStats.from_dict({"admissions": 2}).admissions == 2
    with pytest.raises(ValueError, match="frobnications"):
        tel.ServiceStats.from_dict({"frobnications": 1})
    with pytest.raises(AttributeError):
        tel.ServiceStats().add("frobnications")


def test_service_stats_elastic_counters_in_schema(tel):
    s = tel.ServiceStats.from_dict(
        {"dispatch_retries": 2, "evacuations": 4, "mesh_shrinks": 1, "mesh_regrows": 1}
    )
    assert (s.dispatch_retries, s.evacuations, s.mesh_shrinks, s.mesh_regrows) == (2, 4, 1, 1)
    merged = tel.ServiceStats()
    merged.merge(s)
    merged.merge(s)
    assert merged.evacuations == 8 and merged.mesh_shrinks == 2
    assert {"dispatch_retries", "evacuations", "mesh_shrinks", "mesh_regrows"} <= set(s.as_dict())


# --- histogram quantiles -----------------------------------------------------


def test_quantile_function(tel):
    quantile = tel.quantile
    assert quantile([], 0.5) == 0.0
    assert quantile([3.0], 0.0) == quantile([3.0], 1.0) == 3.0
    vals = [4.0, 1.0, 3.0, 2.0]
    assert quantile(vals, 0.5) == 2.5
    assert quantile(vals, 0.0) == 1.0 and quantile(vals, 1.0) == 4.0
    assert quantile(vals, 0.25) == 1.75
    with pytest.raises(ValueError):
        quantile(vals, 1.5)


def test_recorder_hist_quantiles_and_summary_columns(tel):
    rec = tel.Recorder(sinks=(tel.MemorySink(),), clock=FakeClock())
    for v in (1.0, 2.0, 3.0, 4.0, 100.0):
        rec.observe("lat_s", v)
    assert rec.quantile("lat_s", 0.5) == 3.0
    assert rec.quantile("missing", 0.5) == 0.0
    qs = rec.hist_quantiles("lat_s")
    assert set(qs) == {0.5, 0.99} and qs[0.99] > qs[0.5]
    table = tel.summary_table(rec)
    assert "p50" in table and "p99" in table
    assert tel.NULL.quantile("lat_s", 0.5) == 0.0
    assert tel.NULL.hist_quantiles("lat_s") == {0.5: 0.0, 0.99: 0.0}


def test_hist_sample_cap_keeps_aggregates_exact(tel):
    cap = tel.core.HIST_SAMPLE_CAP
    rec = tel.Recorder(sinks=(), clock=FakeClock())
    n = cap + 100
    for i in range(n):
        rec.observe("x", float(i))
    assert rec.hists["x"]["count"] == n
    assert rec.hists["x"]["max"] == float(n - 1)
    assert len(rec.hist_samples["x"]) == cap
    assert rec.quantile("x", 1.0) == float(cap - 1)


# --- the two packages side by side -------------------------------------------


def _script(rec, clock):
    """One run's worth of every kind of call, with spans, lanes and flows."""
    rec.event("service.start", backend="cubature", slots=4, devices=2)
    for it in range(4):
        clock.advance(0.003)
        with rec.span("service.admit", it=it) as sp:
            rec.count("service.admissions", 2)
            rec.event("service.admission", lane=it % 2, req_id=it, slot=it, it=it)
            sp["admitted"] = 2
        with rec.span("service.dispatch" if it else "service.compile", it=it, max_steps=4) as sp:
            clock.advance(0.01 * (it + 1))
            with rec.span("core.eval", lane=1, window=256):
                clock.advance(0.002)
            sp["executed"] = 2
        rec.observe("service.dispatch_wall_s", 0.01 * (it + 1), it=it)
        rec.observe("service.queue_wait_s", 0.003, it=it)
        for lane in range(2):
            rec.gauge("service.n_live", (it + lane) % 3, lane=lane, it=it + 1)
        rec.gauge("dist.work_imb", 0.25 * it, it=it)
        rec.gauge("service.window", 256 << it, it=it + 1)
    rec.flow("service.migrate", 0, 1, req_id=3, src_slot=1, dst_slot=2, it=2)
    rec.flow("service.reroute", None, None, req_id=1, from_status="capacity", to_backend="vegas")
    rec.flow("service.evacuate", 1, 0, req_id=2, slot=3, it=3, via="readmit")
    rec.count("service.iterations", 8)
    rec.event("service.drain", it=8, iterations=8, dispatches=4)
    rec.flush()


@pytest.fixture(scope="module")
def both():
    out = {}
    for pkg in PACKAGES:
        tel = _telemetry(pkg)
        clock = FakeClock()
        sink = tel.MemorySink()
        rec = tel.Recorder(sinks=(sink,), clock=clock)
        _script(rec, clock)
        out[pkg] = (tel, rec, list(sink.events))
    return out


def test_same_calls_give_the_same_events_and_aggregates(both):
    (_, jrec, jev), (_, trec, tev) = both["repro"], both["repro_torch"]
    assert tev == jev
    for attr in ("counters", "gauges", "hists", "hist_samples", "span_totals"):
        assert getattr(trec, attr) == getattr(jrec, attr), attr


def test_same_summary_table_and_chrome_trace(both):
    (jtel, jrec, jev), (ttel, trec, tev) = both["repro"], both["repro_torch"]
    assert ttel.summary_table(trec) == jtel.summary_table(jrec)
    assert ttel.to_chrome(tev, process_name="p") == jtel.to_chrome(jev, process_name="p")
    assert ttel.to_chrome([]) == jtel.to_chrome([])


def test_same_load_views(both):
    (jtel, _, jev), (ttel, _, tev) = both["repro"], both["repro_torch"]
    jl, tl = jtel.loadview, ttel.loadview
    jt, tt = jl.occupancy_from_events(jev), tl.occupancy_from_events(tev)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    assert tl.idle_fraction(tt, 2) == jl.idle_fraction(jt, 2)
    assert tl.imbalance_series(tt) == jl.imbalance_series(jt)
    assert tl.mean_imbalance(tt) == jl.mean_imbalance(jt)
    for name in ("service.dispatch_wall_s", "service.queue_wait_s"):
        assert tl.hist_values_from_events(tev, name) == jl.hist_values_from_events(jev, name)
    assert tl.mean_work_imbalance_from_events(tev) == jl.mean_work_imbalance_from_events(jev)
    for work in ([4, 4, 4], [9, 0, 1], [0, 0], []):
        assert tl.imbalance(work) == jl.imbalance(work)


def test_same_checker_findings(both, tmp_path):
    (jtel, _, jev), (ttel, _, tev) = both["repro"], both["repro_torch"]
    paths = {}
    for pkg, tel, events in (("repro", jtel, jev), ("repro_torch", ttel, tev)):
        trace = str(tmp_path / f"{pkg}.json")
        metrics = str(tmp_path / f"{pkg}.jsonl")
        tel.write_chrome_trace(trace, events)
        sink = tel.JsonlSink(metrics)
        for e in events:
            sink.emit(e)
        sink.close()
        paths[pkg] = (trace, metrics)
    assert json.load(open(paths["repro_torch"][0])) == json.load(open(paths["repro"][0]))
    assert ttel.read_jsonl(paths["repro_torch"][1]) == jtel.read_jsonl(paths["repro"][1])
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"traceEvents": [{"ph": "B", "name": "x", "pid": 1, "tid": 1, "ts": 0},
                                   {"ph": "s", "id": 9, "pid": 1, "tid": 1, "ts": 0}]}, f)
    for trace, metrics in (*paths.values(), (bad, bad)):
        for kw in ({}, dict(n_devices=2, expect_flow=True), dict(n_devices=3),
                   dict(expect_flow_name="service.evacuate"), dict(expect_flow_name="nope")):
            assert ttel.check.check_trace(trace, **kw) == jtel.check.check_trace(trace, **kw)
        assert ttel.check.check_metrics(metrics) == jtel.check.check_metrics(metrics)


def test_check_cli_accepts_what_the_jax_checker_accepts(both, tmp_path, capsys):
    from repro.telemetry import check as jcheck
    from repro_torch.telemetry import check as tcheck

    ttel, _, tev = both["repro_torch"]
    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.jsonl")
    ttel.write_chrome_trace(trace, tev)
    sink = ttel.JsonlSink(metrics)
    for e in tev:
        sink.emit(e)
    sink.close()
    argv = ["--trace", trace, "--metrics", metrics, "--devices", "2",
            "--expect-flow-name", "service.migrate"]
    assert tcheck.main(argv) == jcheck.main(argv) == 0
    assert tcheck.main(["--trace", trace, "--expect-flow-name", "nope"]) == 1


def test_port_trace_of_a_cpu_run_passes_the_jax_checker(tmp_path):
    from repro.telemetry.check import check_trace as jcheck_trace
    from repro_torch.core.adaptive import integrate
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.telemetry import MemorySink, Recorder, write_chrome_trace

    sink = MemorySink()
    rec = Recorder(sinks=(sink,))
    res = integrate(QuadratureConfig(d=2, integrand="f4", rel_tol=1e-6, capacity=1 << 10),
                    device="cpu", recorder=rec)
    assert res.status == "converged"
    path = str(tmp_path / "trace.json")
    write_chrome_trace(path, sink.events)
    assert jcheck_trace(path) == []
    assert {e["name"] for e in sink.events} == {"core.eval", "core.iter", "core.advance"}


def test_port_sinks_refuse_a_tensor(tmp_path):
    from repro_torch.telemetry import JsonlSink, MemorySink, Recorder, write_chrome_trace

    rec = Recorder(sinks=(JsonlSink(str(tmp_path / "m.jsonl")),))
    with pytest.raises(TypeError, match="torch.Tensor"):
        rec.gauge("x", torch.tensor(1.0))
    with pytest.raises(TypeError, match="torch.Tensor"):
        rec.event("x", value=torch.zeros(3))
    rec.gauge("x", np.float64(1.0))  # host numbers pass
    sink = MemorySink()
    Recorder(sinks=(sink,)).event("x", value=torch.tensor(2.0))
    path = tmp_path / "t.json"
    with pytest.raises(TypeError, match="torch.Tensor"):
        write_chrome_trace(str(path), sink.events)
    assert not path.exists()
