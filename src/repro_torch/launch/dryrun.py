"""Multi-pod dry run: the port of :mod:`repro.launch.dryrun`.

For each (arch x shape x mesh) cell the dry run:
  1. builds the production mesh ((16,16) or (2,16,16)) over a *fake*
     process group (``torch.testing._internal.distributed.fake_pg``: one
     process stands for rank 0 of 256 or 512, and its collectives move
     nothing);
  2. derives parameter/optimizer/cache/batch layouts from the rules engine
     (:mod:`repro_torch.distributed.sharding`) and builds every argument as
     a DTensor of fake tensors (no memory is allocated);
  3. runs the port's own step on them (the train step, the prefill, the
     encoder forward or one decode step) as a DTensor program, proving the
     layouts coherent (no shape mismatch, no unsupported redistribution);
  4. records, per device, what the reference takes from XLA's compile:
     argument, output, alias and temp bytes (a memory tracker over the local
     shards: temp = peak - arguments), FLOPs (``FlopCounterMode`` over the
     local shards) and collective bytes by kind (a dispatch mode over the
     functional collectives: each collective's output bytes, all-reduce
     counted twice, as a ring's reduce-scatter plus all-gather).

The reference compiles a ``lax.scan`` over the microbatches and counts its
body once; here one microbatch's forward and backward are traced, with the
accumulator in place, and then the optimizer (``traced_microbatches``: 1).
Every layer and every prefill chunk is traced (the reference's counts see
each scanned body once).  ``collective-permute`` stays 0: DTensor's
redistributions are all-reduces, all-gathers, reduce-scatters and
all-to-alls, and the port's own collectives are all-reduces.  On a CPU mesh
DTensor runs an all-to-all as an all-gather (its gloo fallback), so the CPU
records count those under ``all-gather``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi|both] [--out results/dryrun_torch]
      [--microbatches N] [--remat full] [--zero1] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.sharding import (
    BATCH_AXES,
    ShardingCtx,
    distribute_model,
    mesh_rules,
    mesh_sizes,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, ShapeSpec, cell_status, input_specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    Model,
    cache_init,
    model_decode,
    model_forward,
    model_prefill,
    model_prefill_chunked,
)
from repro_torch.training.optimizer import OptimizerConfig, apply_updates, init_opt_state
from repro_torch.training.train import TrainConfig, make_train_step, microbatch

# --------------------------------------------------------------------------
# sharding specs
# --------------------------------------------------------------------------

def batch_spec_tree(batch_abstract: dict, ctx: ShardingCtx) -> dict:
    return {k: ctx.spec(v.shape, BATCH_AXES[k]) for k, v in batch_abstract.items()}


def cache_logical_axes(path: str, ndim: int, rules: dict):
    """Logical names for a cache entry (``"<layer>/<name>"``; the leading
    dim may be a stacked period axis, which the port's caches do not have)."""
    if path.endswith("/k") or path.endswith("/v"):
        names = ("batch", "kv_seq", "kv_heads", "head_dim")
    elif path.endswith("c_kv") or path.endswith("k_rope"):
        names = ("batch", "kv_seq", "mla_rank")
    elif path.endswith("ssm"):
        names = ("batch", "ssm_heads", None, None)
    elif path.endswith("conv"):
        names = ("batch", None, "ssm_inner")
    else:
        names = tuple(None for _ in range(ndim))
    if len(names) == ndim - 1:
        names = (None,) + names
    if len(names) != ndim:
        raise ValueError(f"cache entry {path}: names {names} for {ndim} dims")
    return names


def cache_spec_tree(caches: list, ctx: ShardingCtx, rules: dict) -> list:
    """One ``{name: spec}`` per layer's cache."""
    return [
        {n: ctx.spec(x.shape, cache_logical_axes(f"{i}/{n}", x.dim(), rules)) for n, x in c.items()}
        for i, c in enumerate(caches)
    ]


def _dtensor(shape, dtype, spec, ctx: ShardingCtx, device):
    """An uninitialised DTensor of global ``shape`` laid out as ``spec``,
    built from its local shard alone."""
    from torch.distributed.tensor import DTensor

    layout = ctx.placements(spec)
    local = list(shape)
    for axis, p in zip(ctx.sizes, layout):
        if p.is_shard():
            local[p.dim] //= ctx.sizes[axis]
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device=device), ctx.mesh, layout, run_check=False
    )


# --------------------------------------------------------------------------
# the steps
# --------------------------------------------------------------------------


def cell_rules(cfg: ModelConfig, shape: ShapeSpec, mesh, rules: dict | None = None) -> dict:
    """``rules`` with the reference's per-kind overrides for this cell."""
    rules = dict(rules or {})
    model_ways = mesh_sizes(mesh).get("model", 1)
    heads_shardable = (not cfg.use_mla) and cfg.n_kv_heads % model_ways == 0
    if shape.kind == "decode" and cfg.use_mla:
        # shard the MLA latent cache on its RANK dim: the per-token insert
        # stays local and the score contraction pays a small per-block sum
        rules.setdefault("mla_rank", "model")
        rules.setdefault("kv_seq", None)
    elif shape.kind == "decode" and not heads_shardable:
        # sequence-parallel KV cache: KV head counts that do not divide the
        # model axis shard the cache's SEQUENCE dim instead of replicating it
        rules.setdefault("kv_seq", "model")
        rules.setdefault("kv_heads", None)
    if shape.kind != "train":
        # embedding-table rows stay unsharded when serving (gathered rows)
        rules.setdefault("vocab_rows", None)
    return rules


@dataclasses.dataclass
class Cell:
    """``fn(*args)`` runs the cell's step; ``args`` are its DTensor
    arguments (the model, the optimizer state, the batch, the caches), which
    the step updates in place where the reference donates them."""

    fn: Callable
    args: tuple
    rules: dict
    microbatches: int = 1


def build_cell(
    cfg: ModelConfig,
    shape,
    mesh,
    *,
    microbatches: int = 8,
    remat: str = "full",
    zero1: bool = False,
    rules: dict | None = None,
    device="cuda",
    cache_len: int | None = None,
) -> Cell:
    """The cell's step and arguments; call it under a ``FakeTensorMode`` to
    allocate nothing.  ``shape`` is a :class:`ShapeSpec` or a name in
    :data:`SHAPES`; the serving caches hold ``cache_len`` positions (by
    default the shape's sequence)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    rules = cell_rules(cfg, shape, mesh, rules)
    ctx = ShardingCtx(mesh, rules)

    model = Model(cfg, device=device)
    if shape.kind != "train":
        # serving deploys bf16 checkpoints (float32 masters are a training
        # concern); >= 2-D leaves are the weight matrices
        for mod in model.modules():
            for name, p in list(mod.named_parameters(recurse=False)):
                if p.dim() >= 2:
                    setattr(mod, name, nn.Parameter(p.detach().to(torch.bfloat16), requires_grad=False))
    distribute_model(model, mesh, rules)
    batch = {
        k: _dtensor(v.shape, v.dtype, spec, ctx, device)
        for (k, v), spec in zip(
            input_specs(cfg, shape).items(), batch_spec_tree(input_specs(cfg, shape), ctx).values()
        )
    }

    if shape.kind == "train":
        tcfg = TrainConfig(remat=remat, microbatches=microbatches, opt=OptimizerConfig(zero1=zero1))
        with mesh_rules(mesh, rules):
            opt_state = init_opt_state(tcfg.opt, dict(model.named_parameters()))
        # the step count is a host value the schedule reads: a numpy scalar
        # keeps it out of the fake tensor mode
        opt_state["count"] = np.int32(0)
        step = make_train_step(cfg, tcfg)

        def train(model, opt_state, batch):
            with mesh_rules(mesh, rules):
                if microbatches == 1:
                    return step(model, opt_state, batch)
                # the reference's scan body, once: the first microbatch into
                # the float32 accumulator, then the update
                acc = [torch.zeros_like(p, dtype=torch.float32) for p in model.parameters()]
                metrics = step.accumulate(step.differentiated(model), acc, microbatch(batch, microbatches, 0))
                grads = step.named_grads(model, [g.div_(microbatches) for g in acc])
                _, opt_state, opt_metrics = apply_updates(
                    tcfg.opt, dict(model.named_parameters()), grads, opt_state
                )
                return model, opt_state, {**metrics, **opt_metrics}

        return Cell(train, (model, opt_state, batch), rules, microbatches)

    if shape.kind == "prefill" and not cfg.has_decode:  # encoder-only: plain forward

        @torch.no_grad()
        def encode(model, batch):
            with mesh_rules(mesh, rules):
                logits, _ = model_forward(cfg, model, **batch)
                return logits

        return Cell(encode, (model, batch), rules)

    cache_len = cache_len or shape.seq_len
    plain = cache_init(cfg, shape.global_batch, cache_len, device="meta")
    caches = [
        {n: _dtensor(x.shape, x.dtype, spec, ctx, device) for (n, x), spec in zip(c.items(), s.values())}
        for c, s in zip(plain, cache_spec_tree(plain, ctx, rules))
    ]

    if shape.kind == "prefill":
        # long prompts run the chunked (Sarathi-style) prefill so the MoE
        # dispatch / attention working set is bounded by the chunk
        chunk = 4096 if shape.seq_len >= 8192 else None

        @torch.no_grad()
        def prefill(model, batch, caches):
            with mesh_rules(mesh, rules):
                if chunk is not None:
                    return model_prefill_chunked(
                        cfg, model, batch.get("tokens"), caches, chunk, embeds=batch.get("embeds")
                    )
                return model_prefill(cfg, model, batch.get("tokens"), caches, embeds=batch.get("embeds"))

        return Cell(prefill, (model, batch, caches), rules)

    # decode: one token against a full-length cache, at its last position
    pos = cache_len - 1

    @torch.no_grad()
    def decode(model, token, caches):
        with mesh_rules(mesh, rules):
            return model_decode(cfg, model, token, caches, pos)

    return Cell(decode, (model, batch["token"], caches), rules)


# --------------------------------------------------------------------------
# counters
# --------------------------------------------------------------------------

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# dispatcher op name fragments -> kind (functional collectives, c10d's own,
# and DTensor's shard-dim all-to-all)
_OP_KINDS = (
    ("reduce_scatter", "reduce-scatter"),
    ("all_reduce", "all-reduce"),
    ("allreduce", "all-reduce"),
    ("all_gather", "all-gather"),
    ("allgather", "all-gather"),
    ("all_to_all", "all-to-all"),
    ("alltoall", "all-to-all"),
)


def _kind(func) -> str | None:
    if func.namespace not in ("_c10d_functional", "c10d", "_dtensor"):
        return None
    name = func.__name__
    return next((kind for frag, kind in _OP_KINDS if frag in name), None)


def _local_tensors(tree) -> list:
    """Every tensor in a (nested) tuple/list/dict/module, DTensors as their
    local shards."""
    from torch.distributed.tensor import DTensor

    out = []

    def walk(x):
        if isinstance(x, nn.Module):
            for p in x.parameters():
                walk(p)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, DTensor):
            out.append(x.to_local())
        elif isinstance(x, torch.Tensor):
            out.append(x)

    walk(tree)
    return out


def _storages(tensors) -> dict:
    """``{storage key: bytes}`` over the tensors' distinct storages."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in tensors}


# the DTensor function that runs an operation at its global shapes
_PROPAGATION = "_propagate_tensor_meta_non_cached"


def _in_propagation(depth: int = 24) -> bool:
    frame = sys._getframe(2)
    for _ in range(depth):
        if frame is None:
            return False
        if frame.f_code.co_name == _PROPAGATION:
            return True
        frame = frame.f_back
    return False


class CollectiveCounter(TorchDispatchMode):
    """Per-device output bytes of every collective, by kind (all-reduce
    counted twice), and their count.  It defers every DTensor operation to
    DTensor, so it (and the modes entered before it) see the local shards'
    operations, the collectives among them."""

    def __init__(self):
        super().__init__()
        self.bytes = {k: 0 for k in _COLLECTIVES}
        self.bytes["count"] = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if _in_propagation():
            # DTensor's sharding propagation runs each operation it meets for
            # the first time on fake tensors of the global shapes, to learn
            # the output's shape: no device runs that, so the modes beneath
            # this one do not see it either
            from torch._guards import detect_fake_mode
            from torch.utils._python_dispatch import _disable_current_modes

            fake = detect_fake_mode(args)
            with _disable_current_modes(), fake if fake is not None else contextlib.nullcontext():
                return func(*args, **(kwargs or {}))
        out = func(*args, **(kwargs or {}))
        kind = _kind(func)
        if kind is not None:
            outs = out if isinstance(out, (list, tuple)) else [out]
            nbytes = sum(t.numel() * t.element_size() for t in outs if isinstance(t, torch.Tensor))
            self.bytes[kind] += 2 * nbytes if kind == "all-reduce" else nbytes
            self.bytes["count"] += 1
        return out


def measure(cell: Cell) -> dict:
    """Trace ``cell`` once and count, per device, its argument, output, alias
    and temp bytes, its FLOPs and its collective bytes."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    if not hasattr(ShardingPropagator, _PROPAGATION):
        raise RuntimeError(f"this torch's DTensor has no {_PROPAGATION}: the counts would "
                           "include its global-shape propagation")
    arg_locals = _local_tensors(cell.args)
    arg_storages = _storages(arg_locals)
    mem = MemTracker()
    mem.track_external(*arg_locals)
    flops = FlopCounterMode(display=False)
    counter = CollectiveCounter()
    with mem, flops, counter:  # the counter on top: the others see local shards
        out = cell.fn(*cell.args)
    # the mesh's device alone (not the meta tensors a step builds shapes from)
    dev = cell.args[0].device.type
    peak = sum(snap["Total"] for d, snap in mem.get_tracker_snapshot("peak").items()
               if torch.device(d).type == dev)
    out_storages = _storages(_local_tensors(out))
    args_bytes = sum(arg_storages.values())
    return {
        "flops": float(flops.get_total_flops()),
        "bytes_accessed": -1.0,  # not counted (FlopCounterMode counts operations only)
        "collectives": counter.bytes,
        "temp_size_in_bytes": int(peak - args_bytes),
        "argument_size_in_bytes": int(args_bytes),
        "output_size_in_bytes": int(sum(out_storages.values())),
        "alias_size_in_bytes": int(sum(b for k, b in out_storages.items() if k in arg_storages)),
        "peak_bytes": int(peak),
    }


def trace_cell(cfg: ModelConfig, shape, mesh, *, device="cuda", **kw) -> dict:
    """Build and measure one cell on fake tensors: the record's numbers."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    with FakeTensorMode():
        cell = build_cell(cfg, shape, mesh, device=device, **kw)
        t_build = time.time() - t0
        rec = measure(cell)
    rec.update(
        lower_s=round(t_build, 1),  # building the layouts and arguments
        compile_s=round(time.time() - t0 - t_build, 1),  # tracing the step
        microbatches=cell.microbatches,
        traced_microbatches=1,  # a train step traces its first microbatch
    )
    return rec


def fake_world(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks (this
    process is rank 0), replacing a fake group of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs the default process group; a real one is set up")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def fake_mesh(dims: tuple, names: tuple, device="cuda"):
    """A ``DeviceMesh`` of ``dims`` over a fake group of that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    fake_world(int(torch.tensor(dims).prod()))
    return init_device_mesh(device, dims, mesh_dim_names=names)


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------


# Per-arch gradient-accumulation defaults (train_4k), the reference's: more
# microbatches shrink saved activations but re-gather FSDP weights per
# microbatch, so the balance moves with model size.
MICROBATCH_DEFAULTS = {
    "qwen3-32b": 16,
    "jamba-v0.1-52b": 16,
    "qwen3-moe-235b-a22b": 16,
    "deepseek-v2-236b": 16,
}


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, device="cuda",
             n_layers: int | None = None, **kw) -> dict:
    """One cell's record; ``n_layers`` cuts the architecture's depth (its
    widths stay the published ones)."""
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape = SHAPES[shape_name]
    skip = cell_status(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "skip" if skip else "pending",
    }
    if skip:
        rec["reason"] = skip
        return rec
    try:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
        rec.update(trace_cell(cfg, shape, mesh, device=device, **kw), status="ok")
        return rec
    except Exception as e:  # noqa: BLE001 — a failed cell is a reportable bug
        rec.update(status="fail", error=f"{type(e).__name__}: {e}"[:2000])
        return rec


def summary(rec: dict) -> str:
    if rec["status"] != "ok":
        return rec.get("reason", rec.get("error", ""))[:200]
    coll = sum(v for k, v in rec["collectives"].items() if k != "count")
    return (
        f"flops={rec['flops']:.3g} temp={rec['temp_size_in_bytes'] / 2**30:.2f}GiB "
        f"coll={coll / 2**20:.1f}MiB"
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--device", default="cuda", help="the fake meshes' device type (cuda | cpu)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip existing] {tag}")
                    continue
                mb = (
                    MICROBATCH_DEFAULTS.get(arch, args.microbatches)
                    if args.microbatches == 8
                    else args.microbatches
                )
                rec = run_cell(
                    arch,
                    shape,
                    multi,
                    device=args.device,
                    microbatches=mb,
                    remat=args.remat,
                    zero1=args.zero1,
                )
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"[{rec['status']:4}] {tag} " + summary(rec), flush=True)


if __name__ == "__main__":
    main()
