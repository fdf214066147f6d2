"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, on abstract meshes: no device is needed on either side.

- every parameter of the 10 architectures at full width, on the (16, 16)
  and (2, 16, 16) production meshes, under each step kind's rule overrides:
  the port's spec equals the reference's (its stacked period axis removed),
  and the replicate fallbacks are the same;
- the rules engine itself on hypothesis-drawn dims and names;
- the per-device argument bytes of every cell from both sides' specs;
- the DTensor placements a spec turns into, and ``shard`` without a mesh.
"""

from __future__ import annotations

import collections
import functools
import os

import jax
import numpy as np
import pytest
import torch
from dryrun_bytes import cell_argument_bytes
from dryrun_bytes import local_bytes as _local_bytes
from dryrun_bytes import pad as _pad
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsh
from repro.launch import shapes as jshapes
from repro.models.model import cache_init as jcache_init
from repro.models.model import model_init as jmodel_init
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun as tdry
from repro_torch.launch.shapes import SHAPES
from repro_torch.models.model import Model

# the reference dry run forces 512 host devices through XLA_FLAGS when it is
# imported (this process's JAX is already set up): keep the variable as it was
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
KINDS = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


def _mesh(name):
    return AbstractMesh(*MESHES[name])


@functools.cache
def _abstract_params(arch):
    return jax.eval_shape(functools.partial(jmodel_init, jget_config(arch)), jax.random.PRNGKey(0))


def _key(k):
    return getattr(k, "key", getattr(k, "idx", k))


def _port_names(cfg, path):
    """The port's parameter names for one reference leaf: one per layer of a
    stacked leaf (row p of block j is layer first_k_dense + p*period + j)."""
    keys = [str(_key(k)) for k in path]
    if keys[0] == "layers":
        period = cfg.block_pattern_period
        n_scan = (cfg.n_layers - cfg.first_k_dense) // period
        j = int(keys[1][1:])
        rest = ".".join(keys[2:])
        return [f"blocks.{cfg.first_k_dense + p * period + j}.{rest}" for p in range(n_scan)], True
    if keys[0] == "prologue":
        return [f"blocks.{keys[1]}." + ".".join(keys[2:])], False
    return [".".join(keys)], False


class _Recording(jsh.ShardingCtx):
    made: list = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _Recording.made.append(self)


def _ref_specs(monkeypatch, arch, mesh, rules):
    """{port name: reference spec tuple} and the reference's fallbacks, a
    stacked leaf's counted once per layer it holds."""
    cfg = get_config(arch)
    params = _abstract_params(arch)
    monkeypatch.setattr(jsh, "ShardingCtx", _Recording)
    specs, fallbacks = {}, collections.Counter()
    for part in ("layers", None):
        tree = {"layers": params["layers"]} if part else {k: v for k, v in params.items() if k != "layers"}
        _Recording.made = []
        spec_tree = jsh.param_spec_tree(tree, mesh, rules)
        (ctx,) = _Recording.made
        reps = ((cfg.n_layers - cfg.first_k_dense) // cfg.block_pattern_period) if part else 1
        for fb in ctx.fallbacks:
            fallbacks[fb] += reps
        for path, spec in jax.tree_util.tree_leaves_with_path(
            spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
        ):
            names, stacked = _port_names(cfg, path)
            parts = tuple(spec)
            if stacked:
                assert parts[0] is None, (path, spec)
                parts = parts[1:]
            for n in names:
                specs[n] = parts
    return specs, fallbacks


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_parameter_spec_matches_reference(monkeypatch, arch, mesh_name):
    cfg = get_config(arch)
    model = Model(cfg, device="meta")
    sizes = dict(zip(MESHES[mesh_name][1], MESHES[mesh_name][0]))
    seen = set()
    for kind, shape_name in KINDS.items():
        rules = tdry.cell_rules(cfg, SHAPES[shape_name], sizes)
        key = tuple(sorted(rules.items()))
        if key in seen:
            continue
        seen.add(key)
        ref, ref_fallbacks = _ref_specs(monkeypatch, arch, _mesh(mesh_name), rules)
        fallbacks = []
        got = tsh.param_specs(model, sizes, rules, fallbacks=fallbacks)
        assert set(got) == set(ref), set(got) ^ set(ref)
        for name, p in model.named_parameters():
            # a PartitionSpec drops trailing Nones; compare per dim
            assert _pad(got[name], p.dim()) == _pad(ref[name], p.dim()), (kind, name)
        assert collections.Counter(fallbacks) == ref_fallbacks, kind


_NAMES = [None] + sorted(set(jsh.DEFAULT_RULES) | {"heads_flat", "kv_flat", "bogus"})


@settings(max_examples=200, deadline=None)
@given(
    mesh_name=st.sampled_from(list(MESHES)),
    dims_names=st.lists(
        st.tuples(st.sampled_from([1, 2, 3, 8, 16, 24, 32, 48, 512, 1000, 4096]), st.sampled_from(_NAMES)),
        min_size=0, max_size=5,
    ),
    overrides=st.dictionaries(
        st.sampled_from(["kv_seq", "mla_rank", "vocab_rows", "kv_heads", "batch"]),
        st.sampled_from([None, "model", "data", ("pod", "data"), "pod"]),
        max_size=3,
    ),
)
def test_rules_engine_matches_reference(mesh_name, dims_names, overrides):
    dims = tuple(d for d, _ in dims_names)
    names = tuple(n for _, n in dims_names)
    ref_ctx = jsh.ShardingCtx(_mesh(mesh_name), dict(jsh._EXTRA_RULES, **overrides))
    ctx = tsh.ShardingCtx(dict(zip(MESHES[mesh_name][1], MESHES[mesh_name][0])),
                          dict(tsh._EXTRA_RULES, **overrides))
    assert _pad(ctx.spec(dims, names), len(dims)) == _pad(tuple(ref_ctx.spec(dims, names)), len(dims))
    assert ctx.fallbacks == ref_ctx.fallbacks


def test_shard_without_a_context_is_the_identity():
    x = torch.randn(4, 8)
    assert tsh.current_ctx() is None
    assert tsh.shard(x, "batch", "embed") is x
    assert tsh.distribute(x, "batch", "embed") is x
    assert tsh.fsdp_gather(x) is x
    fn = lambda a: a + 1  # noqa: E731
    assert tsh.local(fn, None, None) is fn
    # inside a context a plain (local) tensor is left as it is too
    with tsh.mesh_rules({"data": 2, "model": 2}) as ctx:
        assert tsh.current_ctx() is ctx and tsh.shard(x, "batch", "embed") is x
    assert tsh.current_ctx() is None


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    ctx = tsh.ShardingCtx({"pod": 2, "data": 16, "model": 16})
    spec = ctx.spec((256, 4096, 32), ("batch", "seq", "heads"))
    assert spec == (("pod", "data"), None, "model")
    assert ctx.placements(spec) == (Shard(0), Shard(0), Shard(2))
    assert ctx.placements((None, "data")) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        ctx.placements((("data", "pod"),))
    # a fallback is recorded, as the reference records it
    assert ctx.spec((24,), ("heads",)) == (None,) and ctx.fallbacks == [("heads", 24, 16)]


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_match_reference(arch, mesh_name):
    """Per-device bytes of the parameters (bf16 >= 2-D leaves when serving),
    the optimizer moments, the batch and the caches, from each side's spec
    trees.  The port's token ids are int64 where the reference's are int32,
    so the batch is compared at the reference's integer width."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    mesh = _mesh(mesh_name)
    sizes = dict(zip(MESHES[mesh_name][1], MESHES[mesh_name][0]))
    params = _abstract_params(arch)
    for shape_name in SHAPES:
        shape = SHAPES[shape_name]
        if jshapes.cell_status(jcfg, jshapes.SHAPES[shape_name]):
            continue
        rules = tdry.cell_rules(cfg, shape, sizes)
        serving = shape.kind != "train"

        def width(x, ndim):
            return 2 if serving and ndim >= 2 else x

        def f32(itemsize):  # under the suite's x64 the reference's float32 leaves are float64
            return min(itemsize, 4)

        # the serving cast is taken per layer on both sides: the reference
        # casts its stacked leaves by their stacked rank, which turns the
        # scanned layers' 1-D vectors (norm scales, a_log, ...) to bf16 too
        ref_specs = _leaves(jsh.param_spec_tree(params, mesh, rules))
        ref = sum(_local_bytes(p.shape, width(f32(p.dtype.itemsize), p.ndim - (path[0].key == "layers")), s, sizes)
                  for (path, p), s in zip(jax.tree_util.tree_leaves_with_path(params), ref_specs))
        if shape.kind == "train":  # mu and nu, float32, laid out as the weights
            ref = 3 * ref
        jctx = jsh.ShardingCtx(mesh, rules)
        jbatch = jshapes.input_specs(jcfg, jshapes.SHAPES[shape_name])
        ref += sum(_local_bytes(v.shape, f32(v.dtype.itemsize), jctx.spec(v.shape, jdry._BATCH_AXES[k]), sizes)
                   for k, v in jbatch.items())
        if serving and cfg.has_decode:
            jc = jax.eval_shape(functools.partial(jcache_init, jcfg, shape.global_batch, shape.seq_len))
            jspecs = [s.spec for s in _leaves(jdry.cache_spec_tree(jc, jctx, rules))]
            ref += sum(_local_bytes(x.shape, f32(x.dtype.itemsize), s, sizes)
                       for x, s in zip(jax.tree_util.tree_leaves(jc), jspecs))
        got = cell_argument_bytes(cfg, shape, sizes, rules, int_bytes=4)
        assert got == ref, (shape_name, got, ref)
