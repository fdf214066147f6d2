"""The port's performance observatory against tests/test_perf.py's cases.

Machine probes at toy sizes on the CPU, the catalog at tests/test_perf.py's
tiny configs, the regression gate's exit codes (the committed JAX summary
against a "gpu" copy too), the report's sections and CLIs, and parity with
the JAX modules on the same dicts: ``predict``, ``render_table`` and
``regress.compare`` give the same rows.  The numbers of a CPU run are not
asserted, only the structure; the GM counts are pinned to hand counts.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.perf import catalog as jcatalog
from repro.perf import regress as jregress
from repro_torch.core.config import QuadratureConfig
from repro_torch.perf import PRESETS, load_machine, profile_machine, resolve_machine, save_machine
from repro_torch.perf import catalog as catalog_lib
from repro_torch.perf import machine as machine_lib
from repro_torch.perf import regress
from repro_torch.perf import report as report_lib

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SUMMARY = os.path.join(_REPO, "results", "benchmarks", "BENCH_summary.json")


# --- machine profiler --------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_machine():
    # toy probe sizes: the path is real, the wall time is milliseconds
    return profile_machine(fast=True, matmul_n=64, stream_n=1 << 12, reps=1, device="cpu")


def test_profile_machine_shape(tiny_machine):
    m = tiny_machine
    assert m["source"] == "measured"
    assert m["peak_flops"] > 0 and m["mem_bw"] > 0 and m["reduce_bw"] > 0
    assert m["ici_bw"] is None  # the CPU: no ring of cards
    assert m["working_dtype"] == "float64"
    meta = m["meta"]
    assert meta["platform"] == "cpu" and meta["device_count"] == 1
    assert meta["torch_version"] == torch.__version__ and "nvidia_smi" in meta
    assert set(m["probes"]) == {"matmul_f64", "matmul_f32", "saxpy", "reduction", "ici_ppermute"}
    assert m["probes"]["matmul_f64"]["n"] == 64 and m["probes"]["saxpy"]["n"] == 1 << 12


def test_card_default_sizes_reach_the_plateau():
    for fast in (True, False):
        n, stream = machine_lib.SIZES[("cuda", fast)]
        assert n >= 8192 and stream >= 1 << 27


def test_machine_save_load_round_trip(tiny_machine, tmp_path):
    path = str(tmp_path / "machine.json")
    save_machine(tiny_machine, path)
    assert load_machine(path) == json.loads(json.dumps(tiny_machine))


def test_load_machine_rejects_non_machine_file(tmp_path):
    path = str(tmp_path / "bogus.json")
    with open(path, "w") as f:
        json.dump({"metrics": {}}, f)
    with pytest.raises(ValueError, match="not a machine file"):
        load_machine(path)


def test_resolve_machine_explicit_path_must_exist(tmp_path):
    with pytest.raises(FileNotFoundError):
        resolve_machine(str(tmp_path / "nope.json"))


def test_resolve_machine_default_file_then_preset(tiny_machine, tmp_path, monkeypatch):
    monkeypatch.setattr(machine_lib, "DEFAULT_PATH", str(tmp_path / "absent.json"))
    assert resolve_machine() == PRESETS["h100-sxm"]
    path = str(tmp_path / "machine.json")
    save_machine(tiny_machine, path)
    monkeypatch.setattr(machine_lib, "DEFAULT_PATH", path)
    assert resolve_machine()["source"] == "measured"


def test_h100_preset_is_the_one_home_of_the_card_constants():
    """NVIDIA's H100 SXM5 data sheet; launch/gm_perf.py reads its bounds'
    rates from the preset, with the values they always had."""
    from repro_torch.launch import gm_perf

    h100 = PRESETS["h100-sxm"]
    assert set(PRESETS) == {"h100-sxm"}
    assert (h100["peak_flops"], h100["fp64_vector_flops"]) == (67e12, 34e12)
    assert (h100["mem_bw"], h100["ici_bw"]) == (3.35e12, 450e9)
    assert (gm_perf.PEAK_FP64_FLOPS, gm_perf.PEAK_HBM_BYTES) == (34e12, 3.35e12)
    assert all(h100[k] == v for k, v in gm_perf._H100_SXM.items())


def test_gm_perf_loads_without_the_perf_package(monkeypatch):
    """gm_perf.py times an older checkout put first on PYTHONPATH, which
    has no repro_torch.perf: it then reads the same rates."""
    import importlib.util
    import sys

    from repro_torch.launch import gm_perf

    monkeypatch.setitem(sys.modules, "repro_torch.perf.machine", None)
    spec = importlib.util.spec_from_file_location("gm_perf_alone", gm_perf.__file__)
    alone = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(alone)
    assert (alone.PEAK_FP64_FLOPS, alone.PEAK_HBM_BYTES) == (34e12, 3.35e12)
    assert alone.card is not gm_perf.card and callable(alone.card)


def test_default_paths_are_the_ports():
    for path in (machine_lib.DEFAULT_PATH, catalog_lib.DEFAULT_PATH, report_lib.DEFAULT_OUT):
        assert os.path.join("results", "perf_torch") in path
    assert os.path.join("results", "perf_torch") in report_lib.BENCH_DIR


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_machine(matmul_n=8, stream_n=8, reps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        catalog_lib.build_catalog(PRESETS["h100-sxm"], which=["gm_eval"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        machine_lib.main(["--out", str(tmp_path / "m.json")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        report_lib.main(["--out", str(tmp_path / "out")])


def test_machine_cli_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "m.json")
    assert machine_lib.main(["--device", "cpu", "--out", path]) == 0
    m = load_machine(path)
    assert m["probes"]["matmul_f64"]["n"] == machine_lib.SIZES[("cpu", True)][0]
    assert f"wrote {path}" in capsys.readouterr().out


# --- kernel cost catalog -----------------------------------------------------


def _tiny_configs():
    # tests/test_perf.py's tiny configs
    cub = QuadratureConfig(d=3, integrand="f4", capacity=1 << 8).validate()
    veg = QuadratureConfig(d=4, integrand="f4", backend="vegas", mc_samples=2048,
                           mc_shards=8).validate()
    svc = QuadratureConfig(d=2, integrand="genz_gaussian", capacity=1 << 8, batch_slots=4,
                           sync_every=4).validate()
    return {"gm_eval": cub, "advance": cub, "vegas_iterate": veg, "service_dispatch": svc}


@pytest.fixture(scope="module")
def tiny_catalog(tiny_machine):
    return catalog_lib.build_catalog(tiny_machine, fast=True, reps=1, configs=_tiny_configs(),
                                     device="cpu")


def test_catalog_covers_required_kernels(tiny_catalog):
    kernels = {e["kernel"] for e in tiny_catalog["entries"]}
    assert kernels == set(catalog_lib.KERNELS) == set(jcatalog.KERNELS)
    assert tiny_catalog["device"] == "cpu"


def test_catalog_entries_are_roofline_complete(tiny_catalog):
    for e in tiny_catalog["entries"]:
        assert e["flops"] > 0, e["kernel"]
        assert e["bytes"] > 0, e["kernel"]
        assert e["measured_s"] > 0, e["kernel"]
        assert e["predicted_s"] > 0, e["kernel"]
        assert e["roofline_frac"] == pytest.approx(e["predicted_s"] / e["measured_s"])
        assert e["dominant"] in ("compute", "memory")
        assert e["scan_trips"] >= 1
        # the plain versions run on the CPU: no kernel launches
        assert e["launches"] == {"genz_malik_eval": 0, "vegas_sums": 0}


def test_catalog_counts_are_the_formulas(tiny_catalog):
    cfg = _tiny_configs()["gm_eval"]
    gm = [e for e in tiny_catalog["entries"] if e["kernel"] == "gm_eval"]
    assert [e["rung"] for e in gm] == [256]
    for e in gm:
        counts = catalog_lib.gm_eval_counts("f4", cfg.d, e["rung"])
        assert {k: e[k] for k in counts} == counts
        assert e["route"] == "kernel" and e["evals_per_region"] == 33
    for e in tiny_catalog["entries"]:
        if e["kernel"] == "advance":
            assert 0 <= e["split"] <= e["regions"] == e["rung"] // 2
            counts = catalog_lib.advance_counts(cfg.d, e["regions"], e["split"])
            assert {k: e[k] for k in counts} == counts


def test_catalog_scales_dispatch_by_executed_iterations(tiny_catalog):
    disp = [e for e in tiny_catalog["entries"] if e["kernel"] == "service_dispatch"]
    assert disp, "dispatch missing from catalog"
    for e in disp:
        # no slot can converge at 1e-14: every one of sync_every iterations ran
        assert e["scan_trips"] == e["executed"] == len(e["iterations"]) == 4
        assert e["flops_total"] == pytest.approx(e["flops"] * e["scan_trips"])
        assert e["bytes_total"] == pytest.approx(e["bytes"] * e["scan_trips"])
        want = catalog_lib.service_counts("genz_gaussian", 2, e["iterations"])
        assert e["flops_total"] == pytest.approx(want["flops"] * 4)
        for it in e["iterations"]:
            assert it["eval_rows"] >= it["live"] >= it["split"] > 0


def test_catalog_round_trip_and_table(tiny_catalog, tmp_path):
    path = str(tmp_path / "catalog.json")
    catalog_lib.save_catalog(tiny_catalog, path)
    loaded = catalog_lib.load_catalog(path)
    assert loaded["entries"] == json.loads(json.dumps(tiny_catalog["entries"]))
    table = catalog_lib.render_table(loaded["entries"])
    assert "roofline frac" in table
    for k in catalog_lib.KERNELS:
        assert k in table


def test_catalog_cli_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "catalog.json")
    assert catalog_lib.main(["--device", "cpu", "--only", "gm_eval", "--out", path]) == 0
    entries = catalog_lib.load_catalog(path)["entries"]
    assert [e["rung"] for e in entries] == [256, 512, 1024, 2048]  # the fast set's ladder
    assert "gm_eval" in capsys.readouterr().out


def test_catalog_rejects_unknown_kernels(tiny_machine):
    with pytest.raises(ValueError, match="unknown kernels"):
        catalog_lib.build_catalog(tiny_machine, which=["nope"], device="cpu")


def test_card_scale_configs_are_perf_md_cases():
    cfgs = catalog_lib.default_configs(fast=False)
    cub = cfgs["gm_eval"]
    assert [(c.integrand.split(":")[0], c.d, c.capacity) for c in cub] == [
        ("f4", 5, 1 << 22), ("genz_gaussian", 8, 1 << 22)]
    assert cfgs["advance"] is cub
    veg = cfgs["vegas_iterate"]
    assert (veg.integrand.split(":")[0], veg.d, veg.mc_samples) == ("genz_gaussian", 15, 1 << 22)
    svc = cfgs["service_dispatch"]
    assert (svc.batch_slots, svc.capacity, svc.d) == (64, 1 << 19, 5)


# hand counts of the GM kernel's work per region: n(d) = 1 + 4d + 2d(d-1) + 2^d
# nodes (17, 33, 93); f4 3d + 2 and genz_gaussian 4d + 2 operations a point,
# + 4d + 20 a region; (2d + 3 + d) float64 values moved
@pytest.mark.parametrize(
    "name,d,flops,bytes_,instr",
    [
        ("f4", 2, 17 * 8 + 28, 9 * 8, 24 + 36 + 17 * 4 + 1 + 13 + 22),
        ("f4", 3, 33 * 11 + 32, 12 * 8, 36 + 54 + 33 * 5 + 2 + 19 + 22),
        ("f4", 5, 93 * 17 + 40, 18 * 8, 60 + 90 + 93 * 7 + 4 + 31 + 22),
        ("genz_gaussian", 2, 17 * 10 + 28, 9 * 8, 24 + 54 + 17 * 3 + 1 + 13 + 22),
        ("genz_gaussian", 3, 33 * 14 + 32, 12 * 8, 36 + 81 + 33 * 4 + 2 + 19 + 22),
        ("genz_gaussian", 5, 93 * 22 + 40, 18 * 8, 60 + 135 + 93 * 6 + 4 + 31 + 22),
    ],
)
def test_gm_eval_counts_pinned_to_hand_counts(name, d, flops, bytes_, instr):
    b = 1000
    counts = catalog_lib.gm_eval_counts(name, d, b)
    assert counts["flops"] == flops * b
    assert counts["bytes"] == bytes_ * b
    assert counts["fp64_instr"] == instr * b
    assert counts["transcendentals"] == {2: 17, 3: 33, 5: 93}[d] * b
    assert catalog_lib.gm_eval_counts(name, d, b, "float32")["bytes"] == bytes_ * b // 2


@pytest.mark.parametrize(
    "name,d,flops,bytes_",
    [("f4", 5, 1_699_741_696, 150_994_944), ("genz_gaussian", 8, 14_350_811_136, 226_492_416)],
)
def test_gm_eval_counts_at_the_card_shapes(name, d, flops, bytes_):
    """The bound column of PERF.md's kernel rows since the port's first
    kernel: the counts at B = 2^20, unchanged."""
    counts = catalog_lib.gm_eval_counts(name, d, 1 << 20)
    assert (counts["flops"], counts["bytes"]) == (flops, bytes_)


def test_every_integrand_has_a_count():
    from repro_torch.core.integrands import PARAM_REGISTRY, REGISTRY

    names = set(REGISTRY) | set(PARAM_REGISTRY)
    for table in (catalog_lib.POINT_OPS, catalog_lib.POINT_TRANSCENDENTALS,
                  catalog_lib.TERM_INSTR, catalog_lib.FINISH_INSTR):
        assert set(table) == names
    spec = "genz_gaussian:5,5:0.3,0.7"
    assert catalog_lib.gm_eval_counts(spec, 2, 4) == catalog_lib.gm_eval_counts(
        "genz_gaussian", 2, 4)


# --- parity with the JAX modules on the same dicts ---------------------------


def _entries():
    return [
        {"kernel": "gm_eval", "d": 5, "rung": 1024, "scan_trips": 1, "measured_s": 2.5e-4,
         "flops": 1.7e9, "bytes": 1.5e8},
        {"kernel": "advance", "d": 5, "rung": 4096, "scan_trips": 1, "measured_s": 1e-3,
         "flops": 3e5, "bytes": 9e6},
        {"kernel": "service_dispatch", "d": 3, "rung": None, "scan_trips": 3,
         "measured_s": 0.04, "flops": 1.25e8, "bytes": 2.5e7},
    ]


@pytest.mark.parametrize("machine", [PRESETS["h100-sxm"], {"peak_flops": 3e10, "mem_bw": 2e10}])
def test_predict_and_table_match_the_jax_catalog(machine):
    ours = [catalog_lib.predict(e, machine) for e in _entries()]
    theirs = [jcatalog.predict(e, machine) for e in _entries()]
    assert ours == theirs
    assert catalog_lib.render_table(ours) == jcatalog.render_table(theirs)


def _summary(metrics, **meta):
    base_meta = {
        "date": "2026-08-08T00:00:00",
        "git_sha": "deadbee",
        "torch_version": "2.13.0",
        "platform": "gpu",
        "device_kind": "NVIDIA H100 80GB HBM3",
        "device_count": 1,
    }
    base_meta.update(meta)
    return {"meta": base_meta, "metrics": metrics}


@pytest.mark.parametrize(
    "old,new",
    [
        ({"a": 100.0, "b": 5.0}, {"a": 150.0, "b": 5.0}),
        ({"a": 100.0}, {"a": 120.0}),
        ({"kept": 1.0, "dropped": 1.0, "z": -1.0}, {"kept": 0.5, "added": 1.0, "z": 1.0}),
    ],
)
def test_compare_rows_match_the_jax_gate(old, new):
    rows, warnings = regress.compare(_summary(old), _summary(new))
    jrows, jwarnings = jregress.compare(_summary(old), _summary(new))
    assert (rows, warnings) == (jrows, jwarnings)
    assert regress.render_rows(rows) == jregress.render_rows(jrows)
    assert (regress.FAIL_RATIO, regress.WARN_RATIO) == (jregress.FAIL_RATIO, jregress.WARN_RATIO)


# --- regression gate ---------------------------------------------------------


def _write(tmp_path, name, payload):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def test_regress_identical_exits_zero(tmp_path):
    base = _write(tmp_path, "base.json", _summary({"a": 100.0, "b": 5.0}))
    assert regress.main([base, base]) == 0


def test_regress_fails_on_1p5x_slowdown(tmp_path):
    base = _write(tmp_path, "base.json", _summary({"a": 100.0, "b": 5.0}))
    cand = _write(tmp_path, "cand.json", _summary({"a": 150.0, "b": 5.0}))
    assert regress.main([base, cand]) == 1


def test_regress_warn_zone_exits_zero(tmp_path):
    base = _write(tmp_path, "base.json", _summary({"a": 100.0}))
    cand = _write(tmp_path, "cand.json", _summary({"a": 120.0}))
    assert regress.main([base, cand]) == 0
    rows, _ = regress.compare(_summary({"a": 100.0}), _summary({"a": 120.0}))
    assert rows[0]["verdict"] == "warn"


def test_regress_relaxed_thresholds(tmp_path):
    base = _write(tmp_path, "base.json", _summary({"a": 100.0}))
    cand = _write(tmp_path, "cand.json", _summary({"a": 150.0}))
    assert regress.main([base, cand, "--fail-ratio", "10", "--warn-ratio", "3"]) == 0


def test_regress_platform_mismatch_rejected(tmp_path):
    base = _write(tmp_path, "base.json", _summary({"a": 1.0}, platform="cpu"))
    cand = _write(tmp_path, "cand.json", _summary({"a": 1.0}, platform="gpu"))
    assert regress.main([base, cand]) == 2
    with pytest.raises(regress.RegressError, match="platform mismatch"):
        regress.check_compatible(_summary({}, platform="cpu"), _summary({}, platform="gpu"))
    assert regress.main([base, cand, "--allow-platform-mismatch"]) == 0


def test_regress_refuses_the_committed_jax_summary_against_a_card(tmp_path, capsys):
    with open(JAX_SUMMARY) as f:
        jax_summary = json.load(f)
    assert jax_summary["meta"]["platform"] == "cpu"
    card = copy.deepcopy(jax_summary)
    card["meta"].update(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    cand = _write(tmp_path, "card.json", card)
    assert regress.main([JAX_SUMMARY, cand]) == 2
    assert regress.main([cand, JAX_SUMMARY]) == 2
    assert "platform mismatch" in capsys.readouterr().out
    assert regress.main([JAX_SUMMARY, JAX_SUMMARY]) == 0


def test_regress_drift_reads_the_torch_version():
    warnings = regress.check_compatible(
        _summary({}), _summary({}, torch_version="2.14.0", jax_version="0.5"))
    assert len(warnings) == 1 and "torch_version" in warnings[0]


def test_regress_coverage_changes_warn_not_fail():
    rows, warnings = regress.compare(
        _summary({"kept": 1.0, "dropped": 1.0}),
        _summary({"kept": 1.0, "added": 1.0}),
    )
    assert [r["metric"] for r in rows] == ["kept"]
    assert any("dropped" in w for w in warnings)
    assert any("added" in w for w in warnings)


def test_regress_rejects_non_summary_file(tmp_path):
    bogus = _write(tmp_path, "bogus.json", {"records": []})
    with pytest.raises(regress.RegressError, match="not a BENCH_summary"):
        regress.load_summary(bogus)
    assert regress.main([bogus, bogus]) == 2


def test_regress_cli_subprocess(tmp_path):
    base = _write(tmp_path, "base.json", _summary({"a": 100.0}))
    cand = _write(tmp_path, "cand.json", _summary({"a": 150.0}))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(_REPO, "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.perf.regress", base, cand],
        capture_output=True, text=True, timeout=120, cwd=_REPO, env=env,
    )
    assert proc.returncode == 1
    assert "FAIL" in proc.stdout


# --- report ------------------------------------------------------------------


def test_report_renders_all_sections(tiny_machine, tiny_catalog, tmp_path):
    bench_dir = str(tmp_path / "benchmarks")
    os.makedirs(bench_dir)
    with open(os.path.join(bench_dir, "BENCH_summary.json"), "w") as f:
        json.dump(_summary({"eval_window/x": 100.0}), f)
    md = report_lib.render_markdown(tiny_machine, tiny_catalog, bench_dir, None, "cpu")
    for kernel in catalog_lib.KERNELS:
        assert kernel in md
    assert "roofline frac" in md and "host clock on the CPU" in md
    assert "eval_window/x" in md
    for section in ("## Machine", "## Kernel cost catalog", "## Benchmark trajectory",
                    "## Service latency & idle"):
        assert section in md
    assert "torch " + torch.__version__ in md
    assert "gm_eval" in report_lib.render_html(md)


def test_report_says_the_port_has_no_benchmarks_yet(tiny_machine, tiny_catalog, tmp_path):
    md = report_lib.render_markdown(tiny_machine, tiny_catalog, str(tmp_path / "none"), None,
                                    "cpu")
    assert "no benchmark harness yet" in md
    preset = report_lib.render_markdown(PRESETS["h100-sxm"], tiny_catalog, str(tmp_path), None,
                                        "cpu")
    assert "h100-sxm-preset" in preset and "34.00 TFLOP/s" in preset


def test_report_includes_latency_and_idle_from_metrics(tiny_machine, tiny_catalog, tmp_path):
    from repro_torch.core.integrands import get_param
    from repro_torch.service import BatchScheduler, QuadRequest
    from repro_torch.telemetry import JsonlSink, Recorder

    family = get_param("genz_gaussian")
    cfg = QuadratureConfig(d=2, integrand="genz_gaussian", rel_tol=1e-4, capacity=1 << 9,
                           batch_slots=4, max_iters=60, sync_every=4)
    metrics_path = str(tmp_path / "m.jsonl")
    rec = Recorder(sinks=(JsonlSink(metrics_path),))
    rng = np.random.default_rng(0)
    reqs = [QuadRequest(req_id=i, theta=family.sample_theta(2, rng)) for i in range(5)]
    list(BatchScheduler(cfg, family, devices=["cpu"], recorder=rec).serve(reqs))
    rec.close()

    md = report_lib.render_markdown(tiny_machine, tiny_catalog, str(tmp_path / "nobench"),
                                    metrics_path, "cpu")
    assert "service.dispatch_wall_s" in md
    assert "idle fraction" in md
    dispatch_row = next(l for l in md.splitlines() if l.startswith("| service.dispatch_wall_s"))
    assert "ms" in dispatch_row


def test_report_cli_writes_both_files(tiny_machine, tiny_catalog, tmp_path):
    machine_path = str(tmp_path / "machine.json")
    catalog_path = str(tmp_path / "catalog.json")
    save_machine(tiny_machine, machine_path)
    catalog_lib.save_catalog(tiny_catalog, catalog_path)
    out = str(tmp_path / "out")
    rc = report_lib.main([
        "--machine", machine_path, "--catalog", catalog_path,
        "--bench-dir", str(tmp_path / "nobench"), "--out", out, "--device", "cpu",
    ])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "PERF_REPORT.md"))
    assert os.path.exists(os.path.join(out, "PERF_REPORT.html"))
