"""Per-device argument bytes of a dry-run cell, from the port's spec trees
alone: the parameters (bf16 matrices when serving), the two moments when
training, the batch and the serving caches.

``tests/test_torch_sharding.py`` holds this count against the reference's
spec trees; the dry-run tests hold the bytes a trace measures against it.
"""

from __future__ import annotations

import math

from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun as tdry
from repro_torch.models.model import Model, cache_init


def pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def local_bytes(shape, itemsize, spec, sizes) -> int:
    """Bytes of one device's shard of a ``shape`` tensor laid out as ``spec``."""
    n = 1
    for dim, part in zip(shape, pad(spec, len(shape))):
        axes = (part,) if isinstance(part, str) else tuple(part or ())
        n *= dim // math.prod(sizes[a] for a in axes)
    return n * itemsize


def cell_argument_bytes(cfg, shape, sizes: dict, rules: dict, *, int_bytes: int | None = None) -> int:
    """One device's argument bytes for the cell (``rules``: the cell's, as
    ``dryrun.cell_rules`` gives them).  ``int_bytes``: the width the integer
    inputs are counted at (default: the port's own, int64)."""
    serving = shape.kind != "train"
    model = Model(cfg, device="meta")
    specs = tsh.param_specs(model, sizes, rules)
    params = sum(
        local_bytes(p.shape, 2 if serving and p.dim() >= 2 else p.element_size(), specs[n], sizes)
        for n, p in model.named_parameters()
    )
    total = params if serving else 3 * params  # mu and nu, float32, laid out as the weights
    ctx = tsh.ShardingCtx(sizes, rules)
    batch = tdry.input_specs(cfg, shape)
    total += sum(
        local_bytes(v.shape, int_bytes if int_bytes and not v.is_floating_point() else v.element_size(),
                    spec, sizes)
        for v, spec in zip(batch.values(), tdry.batch_spec_tree(batch, ctx).values())
    )
    if serving and cfg.has_decode:
        caches = cache_init(cfg, shape.global_batch, shape.seq_len, device="meta")
        total += sum(
            local_bytes(x.shape, x.element_size(), s, sizes)
            for c, cs in zip(caches, tdry.cache_spec_tree(caches, ctx, rules))
            for x, s in zip(c.values(), cs.values())
        )
    return total
