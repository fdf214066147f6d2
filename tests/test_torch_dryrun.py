"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.shapes``)
against the JAX package's, and its counters on hand-built DTensor programs.

- ``SHAPES``, ``cell_status`` over 10 x 4 and ``input_specs`` against the
  reference (token ids int64 where the reference's are int32);
- ``cache_logical_axes`` for every architecture's caches;
- the collective counter, ``FlopCounterMode`` and the memory tracker on one
  DTensor matmul over a fake (2, 2) mesh: they see the local shards;
- every architecture's cells at smoke widths, with small shapes of each kind,
  on a fake (2, 2) CPU mesh (``test_torch_dryrun_pod.py``: (2, 2, 2)); the
  argument bytes each trace measures from the storages it built equal the
  count from the port's specs (``tests/dryrun_bytes.py``).
"""

from __future__ import annotations

import functools
import json
import os

import jax
import pytest
import torch
from dryrun_bytes import cell_argument_bytes

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.launch import shapes as jshapes
from repro.models.model import cache_init as jcache_init
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import shapes as tshapes
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models.model import cache_init

# the reference dry run forces 512 host devices through XLA_FLAGS when it is
# imported (this process's JAX is already set up): keep the variable as it was
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

# small shapes of each kind: (name, seq, batch, kind); the names are the
# grid's, so cell_status skips as it does there
SMALL = (
    ShapeSpec("train_4k", 32, 8, "train"),
    ShapeSpec("prefill_32k", 32, 4, "prefill"),
    ShapeSpec("decode_32k", 32, 4, "decode"),
    ShapeSpec("long_500k", 64, 2, "decode"),
)
REF_KEYS = {
    "arch", "shape", "mesh", "status", "lower_s", "compile_s", "flops", "bytes_accessed",
    "collectives", "temp_size_in_bytes", "argument_size_in_bytes", "output_size_in_bytes",
    "alias_size_in_bytes",
}


def test_shape_grid_matches_reference():
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, spec in tshapes.SHAPES.items():
        assert dataclasses_tuple(spec) == dataclasses_tuple(jshapes.SHAPES[name])
    statuses = {}
    for arch in ARCH_IDS:
        for name in tshapes.SHAPES:
            got = tshapes.cell_status(get_config(arch), tshapes.SHAPES[name])
            assert got == jshapes.cell_status(jget_config(arch), jshapes.SHAPES[name]), (arch, name)
            statuses[arch, name] = got
    # 31 runnable cells per mesh: train 10, prefill 10, decode 9, long 2
    assert sum(v is None for v in statuses.values()) == 31


def dataclasses_tuple(spec):
    return (spec.name, spec.seq_len, spec.global_batch, spec.kind)


_INT = {"int32": torch.int64, "float32": torch.float32}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in tshapes.SHAPES:
        shape, jshape = tshapes.SHAPES[name], jshapes.SHAPES[name]
        if jshape.kind == "decode" and not jcfg.has_decode:
            with pytest.raises(ValueError):
                jshapes.input_specs(jcfg, jshape)
            with pytest.raises(ValueError):
                tshapes.input_specs(cfg, shape)
            continue
        ref = jshapes.input_specs(jcfg, jshape)
        got = tshapes.input_specs(cfg, shape)
        assert list(got) == list(ref)
        for k in ref:
            assert tuple(got[k].shape) == tuple(ref[k].shape) and got[k].device.type == "meta"
            assert got[k].dtype == _INT[str(ref[k].dtype)], (k, got[k].dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_match_reference(arch):
    """Every cache entry's logical names; the reference's stacked entries
    carry a leading period axis (named None), which the port's have not."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke_config(arch)
    if not cfg.has_decode:
        return
    ref = jax.eval_shape(functools.partial(jcache_init, jcfg, 2, 16))
    ref_axes = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        names = jdry.cache_logical_axes("/".join(keys), leaf.ndim, {})
        if keys[0] == "layers":
            assert names[0] is None
            names = names[1:]
        ref_axes.setdefault(keys[-1], set()).add(names)
    got_axes = {}
    for i, c in enumerate(cache_init(cfg, 2, 16, device="meta")):
        for n, x in c.items():
            got_axes.setdefault(n, set()).add(tdry.cache_logical_axes(f"{i}/{n}", x.dim(), {}))
    assert got_axes == ref_axes


@pytest.fixture(scope="module")
def mesh22():
    mesh = tdry.fake_mesh((2, 2), ("data", "model"), "cpu")
    yield mesh
    import torch.distributed as dist

    dist.destroy_process_group()


def _matmul(mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    x = DTensor.from_local(torch.empty(64, 32), mesh, [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(16, 16), mesh, [Replicate(), Shard(0)], run_check=False)
    return x, w


def test_counters_see_the_local_shards(mesh22):
    """x (128, 32) batch-sharded over data, w (32, 16) contraction-sharded
    over model: each rank multiplies its (64, 16) slice of x by its (16, 16)
    rows of w, a partial sum over model reduced by one all-reduce of the
    (64, 16) local output (4 KiB, counted twice)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    with FakeTensorMode():
        x, w = _matmul(mesh22)
        cell = tdry.Cell(lambda x, w: (x @ w).redistribute(mesh22, [Shard(0), Replicate()]), (x, w), {})
        rec = tdry.measure(cell)
    assert rec["flops"] == 2 * 64 * 16 * 16  # FlopCounterMode: the local shards' product
    assert rec["collectives"] == {
        "all-reduce": 2 * 64 * 16 * 4, "all-gather": 0, "reduce-scatter": 0, "all-to-all": 0,
        "collective-permute": 0, "count": 1,
    }
    assert rec["argument_size_in_bytes"] == (64 * 32 + 16 * 16) * 4
    # the peak holds the arguments, x's (64, 16) slice and the local output;
    # not the global (128, 16) product DTensor's propagation runs once
    assert 2 * 64 * 16 * 4 <= rec["temp_size_in_bytes"] < 128 * 16 * 4 + 2 * 64 * 16 * 4
    assert rec["output_size_in_bytes"] == 64 * 16 * 4 and rec["alias_size_in_bytes"] == 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_cell_traces_on_a_2x2_mesh(mesh22, arch):
    cfg = get_smoke_config(arch)
    for shape in SMALL:
        if tshapes.cell_status(cfg, shape):
            continue
        rec = tdry.trace_cell(cfg, shape, mesh22, device="cpu", microbatches=2)
        name = shape.name
        assert rec["flops"] > 0, (name, rec)
        assert rec["temp_size_in_bytes"] >= 0 and rec["collectives"]["count"] > 0, (name, rec)
        assert rec["traced_microbatches"] == 1
        # the storages the trace built hold what the specs say, to the byte
        rules = tdry.cell_rules(cfg, shape, mesh22)
        assert rec["argument_size_in_bytes"] == cell_argument_bytes(
            cfg, shape, tsh.mesh_sizes(mesh22), rules
        ), (name, rec)
        if name == "train_4k":
            # the step updates the model and the moments in place
            assert rec["alias_size_in_bytes"] > 0 and rec["microbatches"] == 2


def test_run_cell_record_and_cli(mesh22, tmp_path, monkeypatch, capsys):
    """run_cell's record has the reference's keys; a skipped cell says why;
    the CLI writes one file per cell and skips files that exist."""
    rec = tdry.run_cell("hubert-xlarge", "decode_32k", False, device="cpu")
    assert rec["status"] == "skip" and rec["reason"] == "skip(encoder-only: no decode step)"
    # a failing cell is recorded, not raised
    monkeypatch.setattr(tdry, "get_config", lambda arch: get_smoke_config(arch))
    monkeypatch.setattr(tdry, "SHAPES", {s.name: s for s in SMALL})
    monkeypatch.setattr(tdry, "make_production_mesh", lambda multi_pod, device_type: (
        tdry.fake_mesh((2, 2, 2) if multi_pod else (2, 2),
                       ("pod", "data", "model") if multi_pod else ("data", "model"), device_type)))
    monkeypatch.setattr(tdry, "fake_world", lambda world: None)
    rec = tdry.run_cell("deepseek-7b", "train_4k", False, device="cpu", microbatches=2)
    assert rec["status"] == "ok" and REF_KEYS <= set(rec), set(rec) ^ REF_KEYS
    assert set(rec["collectives"]) == {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                       "collective-permute", "count"}
    out = tmp_path / "dry"
    tdry.main(["--arch", "mamba2-370m", "--shape", "decode_32k", "--mesh", "single",
               "--out", str(out), "--device", "cpu"])
    rec = json.loads((out / "mamba2-370m__decode_32k__single.json").read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    tdry.main(["--arch", "mamba2-370m", "--shape", "decode_32k", "--mesh", "single",
               "--out", str(out), "--device", "cpu"])
    assert "[skip existing] mamba2-370m__decode_32k__single" in capsys.readouterr().out
    fail = tdry.run_cell("deepseek-7b", "train_4k", False, device="cpu", microbatches=3)
    assert fail["status"] == "fail" and "microbatches" in fail["error"]


@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-370m"])
def test_run_cell_cuts_depth(mesh22, monkeypatch, arch):
    """run_cell's n_layers traces the first layers only: one period of the
    layer pattern more costs one period more FLOPs, at the same widths."""
    monkeypatch.setattr(tdry, "get_config", lambda arch: get_smoke_config(arch))
    monkeypatch.setattr(tdry, "SHAPES", {s.name: s for s in SMALL})
    monkeypatch.setattr(tdry, "make_production_mesh", lambda multi_pod, device_type: (
        tdry.fake_mesh((2, 2, 2) if multi_pod else (2, 2),
                       ("pod", "data", "model") if multi_pod else ("data", "model"), device_type)))
    monkeypatch.setattr(tdry, "fake_world", lambda world: None)
    flops = [tdry.run_cell(arch, "train_4k", False, device="cpu", microbatches=2,
                           n_layers=n)["flops"] for n in (1, 2, 3)]
    assert 0 < flops[0] < flops[1] < flops[2], flops
    assert flops[2] - flops[1] == pytest.approx(flops[1] - flops[0], rel=1e-9), flops
