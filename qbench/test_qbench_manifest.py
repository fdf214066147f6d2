"""BENCHMARK.json against the files it names and the rules on names, units and bounds."""

import json
import re
from pathlib import Path

import pytest

from qbench import files, harness

SPEC = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["per_layer"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "qbench/run.py"]
    assert SPEC["paths"] == ["qbench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    assert len(set(CELLS)) == len(CELLS)
    assert len(set(METRICS + [m["name"] for m in SPEC["end_to_end"]])) == len(METRICS) + len(
        SPEC["end_to_end"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in SPEC["workloads"] + SPEC["configs"]] + [
            c["source"] for c in SPEC["configs"]] + [m["layer"] for m in SPEC["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = harness.cell_entry(SPEC, cell)
    assert entry["chips"] in (1, 4)
    assert (harness.HERE / "configs" / f"{entry['config']}.json").is_file()
    assert (harness.HERE / "traffic" / f"{entry['traffic']}.json").is_file()
    traffic = harness.load_json(harness.HERE / "traffic" / f"{entry['traffic']}.json")
    config = harness.load_json(harness.HERE / "configs" / f"{entry['config']}.json")
    # the code a cell runs is found by name too: its driver, entry and family
    assert callable(files.load_code("drivers", traffic["kind"]).run)
    if "entry" in traffic:
        assert callable(files.load_code("entries", traffic["entry"]).solve)
    assert callable(files.load_code("families", config["family"]).exact)
    limits = harness.load_json(harness.HERE / "workloads" / f"{cell}.json")["limits"]
    assert limits and all(v >= 0 for v in limits.values())
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = [m["name"] for m in SPEC["end_to_end"] if harness.applies(m, cell, SPEC)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(harness.applies(m, cell, SPEC) for m in SPEC["per_layer"])


def test_configs_are_files_under_paths_and_each_used():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"] == f"qbench/configs/{c['name']}.json"
        body = harness.load_json(harness.ROOT / c["file"])
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]


@pytest.mark.parametrize("name", METRICS)
def test_metric_file_declares_what_the_manifest_says(name):
    m = next(x for x in SPEC["per_layer"] if x["name"] == name)
    mod = harness.load_metric(name)
    assert (mod.SOURCE, mod.UNIT, mod.LAYER, mod.MOVES, mod.WORKLOADS) == (
        m["source"], m["unit"], m["layer"], m["moves"], m["workloads"])
    moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert harness.applies(moved, cell, SPEC), (name, cell)
    assert callable(mod.read)


def test_bounds_and_sources():
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_files_under_paths_are_named_from_name_characters():
    for path in Path(harness.HERE).rglob("*"):
        rel = path.relative_to(harness.ROOT).as_posix()
        if "__pycache__" in rel or "/out/" in rel + "/":
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
