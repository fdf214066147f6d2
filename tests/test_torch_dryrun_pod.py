"""The dry run's cells at smoke widths on a fake (pod=2, data=2, model=2)
CPU mesh: the multi-pod layout, where the batch and the dispatch buffers'
capacity are split over two mesh axes (``test_torch_dryrun.py`` covers the
(2, 2) mesh and the counters).  The dense and SSM architectures here; the
hybrid, MoE, VLM and audio ones in ``test_torch_dryrun_pod_mixed.py``."""

from __future__ import annotations

import pytest
from dryrun_bytes import cell_argument_bytes

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import shapes as tshapes
from repro_torch.launch.shapes import ShapeSpec

SMALL = (
    ShapeSpec("train_4k", 32, 8, "train"),
    ShapeSpec("prefill_32k", 32, 4, "prefill"),
    ShapeSpec("decode_32k", 32, 4, "decode"),
    ShapeSpec("long_500k", 64, 4, "decode"),
)


@pytest.fixture(scope="module")
def mesh222():
    mesh = tdry.fake_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    yield mesh
    import torch.distributed as dist

    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCH_IDS[:5])
def test_every_cell_traces_on_a_2x2x2_mesh(mesh222, arch):
    cfg = get_smoke_config(arch)
    for shape in SMALL:
        if tshapes.cell_status(cfg, shape):
            continue
        # remat "none" here (the (2, 2) file traces "full"): fewer operations
        rec = tdry.trace_cell(cfg, shape, mesh222, device="cpu", microbatches=2, remat="none")
        assert rec["flops"] > 0, (shape.name, rec)
        assert rec["collectives"]["count"] > 0 and rec["temp_size_in_bytes"] >= 0, (shape.name, rec)
        # the storages the trace built hold what the specs say, to the byte
        rules = tdry.cell_rules(cfg, shape, mesh222)
        assert rec["argument_size_in_bytes"] == cell_argument_bytes(
            cfg, shape, tsh.mesh_sizes(mesh222), rules
        ), (shape.name, rec)
