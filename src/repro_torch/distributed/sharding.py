"""Mesh-aware sharding rules: the port of :mod:`repro.distributed.sharding`.

One rules table maps *logical* axis names to mesh axes; :func:`shard`
redistributes a DTensor to the layout they give only while a mesh context is
active (:func:`mesh_rules`), so the same model code runs on one device
(plain tensors, the tests) and over a ``DeviceMesh`` (DTensors: the dry run
on a fake process group, or real ranks) unchanged.

A spec is a tuple with one entry per tensor dim: ``None`` (replicated), a
mesh axis name, or a tuple of them (major to minor), the entries of the
reference's ``PartitionSpec``.  :meth:`ShardingCtx.placements` turns it into
DTensor placements, one per mesh dim.

Divisibility fallback: a dimension that does not divide by its mesh-axis
size is replicated instead, and recorded in ``fallbacks``.  DTensor would
accept an uneven shard; the port replicates there, as the reference does.

Regions that DTensor cannot propagate (the attention stream, the SSD scan,
the MoE dispatch, the cache writes) run on the local shards through
:func:`local` (``local_map``'s to_local / from_local, with the gradients
of shared arguments summed) inside a context, and the plain function
outside one.
"""

from __future__ import annotations

import math
import sys
import threading
from contextlib import contextmanager
from typing import Optional

import torch
from torch import nn

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "tokens": ("pod", "data"),  # flattened (B*S) token axis (MoE routing)
    "seq": None,
    "embed": None,  # d_model on ACTIVATIONS: replicated (pure TP residual)
    "fsdp": "data",  # d_model/large dim on PARAMETERS: FSDP over the data
    #                  axis (weights gathered per-layer, grads reduce-
    #                  scattered); without it the >30B-parameter
    #                  architectures' float32 weights alone do not fit one
    #                  device of a 256-device mesh
    "heads": "model",  # attention heads (TP)
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",  # MLP hidden (TP column/row pair)
    "vocab": "model",  # logits/head vocab dim (matmul: shards cleanly)
    "vocab_rows": "model",  # embedding-table ROW dim: gather-accessed;
    #                         serving overrides it to None
    "experts": "model",  # expert parallelism
    "expert_cap": ("pod", "data"),  # dispatch-buffer token-capacity dim
    "ssm_inner": "model",  # mamba d_inner / conv channels
    "ssm_heads": "model",
    "state": None,
    "kv_seq": None,  # KV-cache sequence dim (long-context variant: "model")
    "mla_rank": None,  # MLA latent rank dim (decode: "model")
    "lora": None,
    "zero1": ("pod", "data"),  # optimizer-state sharding (ZeRO-1)
}

# the logical axes of a batch's inputs, by key
BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "loss_mask": ("batch", "seq"),
    "embeds": ("batch", "seq", "embed"),
    "token": ("batch",),
}

_CTX = threading.local()


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` in mesh order, for a ``DeviceMesh`` or anything
    that maps axis names to sizes (a dict, a JAX mesh's ``shape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    shape = getattr(mesh, "shape", mesh)
    return {str(k): int(v) for k, v in dict(shape).items()}


class ShardingCtx:
    def __init__(self, mesh, rules: Optional[dict] = None):
        self.mesh = mesh
        self.sizes = mesh_sizes(mesh)
        self.rules = dict(DEFAULT_RULES, **(rules or {}))
        self.fallbacks: list[tuple[str, int, int]] = []

    def axis_size(self, mesh_axes) -> int:
        if mesh_axes is None:
            return 1
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        return math.prod(self.sizes[a] for a in mesh_axes)

    def spec(self, dims, names) -> tuple:
        """One entry per dim: None, a mesh axis, or a tuple of mesh axes."""
        if len(dims) != len(names):
            raise ValueError(f"{len(dims)} dims {tuple(dims)} but {len(names)} names {names}")
        used: set[str] = set()
        parts = []
        for dim, name in zip(dims, names):
            mesh_axes = self.rules.get(name) if name else None
            if mesh_axes is None:
                parts.append(None)
                continue
            axes = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)
            axes = tuple(a for a in axes if a in self.sizes and a not in used)
            size = math.prod(self.sizes[a] for a in axes) if axes else 1
            if not axes or size <= 1:
                parts.append(None)
                continue
            if dim % size != 0:
                self.fallbacks.append((name or "?", int(dim), size))
                parts.append(None)
                continue
            used.update(axes)
            parts.append(axes[0] if len(axes) == 1 else axes)
        return tuple(parts)

    def placements(self, spec) -> tuple:
        """DTensor placements (one per mesh dim, in mesh order) for a spec:
        a tensor dim on ``("pod", "data")`` is ``Shard(i)`` on both, split
        by pod first, as the reference's major-to-minor order."""
        from torch.distributed.tensor import Replicate, Shard

        order = list(self.sizes)
        on: dict[str, int] = {}
        for i, part in enumerate(spec):
            axes = (part,) if isinstance(part, str) else tuple(part or ())
            if [order.index(a) for a in axes] != sorted(order.index(a) for a in axes):
                raise ValueError(f"spec entry {part} is not in the mesh's order {order}")
            for a in axes:
                on[a] = i
        return tuple(Shard(on[a]) if a in on else Replicate() for a in order)

    def layout(self, dims, names) -> tuple:
        """The placements of a ``dims``-shaped tensor on the logical ``names``."""
        return self.placements(self.spec(dims, names))

    def coordinate(self, axis: str) -> int:
        """This rank's index along a mesh axis (0 on a mesh of sizes only)."""
        get = getattr(self.mesh, "get_local_rank", None)
        return int(get(axis)) if get is not None and axis in self.sizes else 0

    def shard_range(self, layout, dim: int, size: int) -> tuple[int, int]:
        """The global index range ``[lo, hi)`` of this rank's shard of a
        length-``size`` tensor dim ``dim`` laid out as ``layout``."""
        idx, n = 0, 1
        for a in sharded_axes(layout, self, dim):
            idx, n = idx * self.sizes[a] + self.coordinate(a), n * self.sizes[a]
        return idx * (size // n), (idx + 1) * (size // n)


@contextmanager
def mesh_rules(mesh, rules: Optional[dict] = None):
    prev = getattr(_CTX, "ctx", None)
    _CTX.ctx = ShardingCtx(mesh, rules or {})
    try:
        yield _CTX.ctx
    finally:
        _CTX.ctx = prev


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_CTX, "ctx", None)


def bound(fn):
    """``fn`` run inside the current context wherever it is called: a
    rematerialised block is recomputed in the backward, which autograd runs
    on its own thread for a CUDA device, where this thread's context is not
    set.  Without a context, ``fn`` itself."""
    ctx = current_ctx()
    if ctx is None:
        return fn

    def call(*args, **kwargs):
        prev = getattr(_CTX, "ctx", None)
        _CTX.ctx = ctx
        try:
            return fn(*args, **kwargs)
        finally:
            _CTX.ctx = prev

    return call


def _is_dtensor(x) -> bool:
    # no DTensor exists before torch.distributed.tensor is imported, and a
    # path without a mesh never imports it (it adds seconds to a process's
    # start); a dict lookup, not an import, in each per-layer check
    dtensor = sys.modules.get("torch.distributed.tensor")
    return dtensor is not None and isinstance(x, dtensor.DTensor)


def shard(x, *names):
    """Redistribute DTensor ``x`` to the logical axes ``names`` (None =
    replicate); its gradient takes the same layout in the backward, as the
    transpose of the reference's sharding constraint does.  Without a
    context, or given a plain (local) tensor, it returns ``x`` itself."""
    ctx = current_ctx()
    if ctx is None or not _is_dtensor(x):
        return x
    layout = ctx.layout(x.shape, names)
    x = x.redistribute(x.device_mesh, layout)
    return _Pin.apply(x, layout) if x.requires_grad else x


class _Pin(torch.autograd.Function):
    """The identity, whose gradient is redistributed to ``layout``."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if _is_dtensor(grad) and tuple(grad.placements) != tuple(ctx.layout):
            grad = grad.redistribute(grad.device_mesh, ctx.layout)
        return grad, None


def split_heads(t, n_heads: int, name: str):
    """(B, S, n_heads * hd) -> (B, S, n_heads, hd).  Over a mesh the flat
    dim is first laid out as the heads will be (split over the ``name``
    rule's axes where the head count divides them, whole otherwise), since
    a flat shard that splits inside a head cannot be unflattened."""
    b, s, flat = t.shape
    ctx = current_ctx()
    if ctx is not None and _is_dtensor(t):
        spec = ctx.spec((b, s, n_heads), ("batch", "seq", name))
        t = t.redistribute(t.device_mesh, ctx.placements(spec))
    return t.reshape(b, s, n_heads, flat // n_heads)


def merge_heads(t, name: str):
    """(B, S, n_heads, hd) -> (B, S, n_heads * hd).  Over a mesh the flat dim
    keeps the heads' layout, and so does its gradient, which the backward
    unflattens into heads again."""
    b, s, n_heads, hd = t.shape
    flat = t.reshape(b, s, n_heads * hd)
    ctx = current_ctx()
    if ctx is None or not _is_dtensor(flat):
        return flat
    layout = ctx.placements(ctx.spec((b, s, n_heads), ("batch", "seq", name)))
    flat = flat.redistribute(flat.device_mesh, layout)
    return _Pin.apply(flat, layout) if flat.requires_grad else flat


def fsdp_gather(w):
    """A weight gathered over the mesh axes of the ``fsdp`` rule (FSDP: the
    whole weight on each rank of those axes, its tensor-parallel shards
    kept) before a matrix product; the weight itself without a context."""
    ctx = current_ctx()
    if ctx is None or not _is_dtensor(w):
        return w
    axes = ctx.rules.get("fsdp") or ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return w.redistribute(w.device_mesh, replicate_on(w.placements, ctx, *axes))


def layout_of(x):
    """A DTensor's placements; None for anything else."""
    return x.placements if _is_dtensor(x) else None


def replicate_on(layout, ctx: ShardingCtx, *axes) -> tuple:
    """``layout`` with the mesh axes ``axes`` replicated."""
    from torch.distributed.tensor import Replicate

    order = list(ctx.sizes)
    return tuple(Replicate() if order[i] in axes else p for i, p in enumerate(layout))


def sharded_axes(layout, ctx: ShardingCtx, dim: int) -> list:
    """The mesh axes over which tensor dim ``dim`` is sharded in ``layout``."""
    return [a for a, p in zip(ctx.sizes, layout) if p.is_shard(dim)]


def distribute(x, *names):
    """A plain tensor, the same on every rank, as a DTensor on the logical
    axes ``names`` (each rank keeps its own shard; no communication).
    Without a context it returns ``x`` itself."""
    ctx = current_ctx()
    if ctx is None or _is_dtensor(x):
        return x
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, ctx.mesh, ctx.layout(x.shape, names), src_data_rank=None)


def local(fn, out_layouts, in_layouts, summed=None):
    """``fn`` run on the local shards of its DTensor arguments (what
    ``torch.distributed.tensor.experimental.local_map`` does).

    ``in_layouts`` gives each positional argument's placements (None for a
    non-tensor); the arguments are redistributed to them first.
    ``out_layouts`` gives the placements the local outputs are assembled
    with: one layout for one output, a tuple of layouts (or None for a
    non-tensor) for several.  ``summed`` gives, per argument, the mesh axes
    over which its local gradient is only a partial sum (an argument whole
    on every rank of an axis that splits the work: a weight over the batch
    axes, the shared B and C over the heads); its gradient is summed over
    them.  Without a context this is ``fn`` itself.
    """
    ctx = current_ctx()
    if ctx is None:
        return fn
    from torch.distributed.tensor import DTensor, Partial, Placement

    one = bool(out_layouts) and isinstance(out_layouts[0], Placement)
    order = list(ctx.sizes)
    summed = summed or (None,) * len(in_layouts)

    def call(*args):
        if len(args) != len(in_layouts):
            raise ValueError(f"{len(args)} arguments for {len(in_layouts)} layouts")
        mesh, local_args = None, []
        for arg, lay, axes in zip(args, in_layouts, summed):
            if isinstance(arg, DTensor):
                if lay is None:
                    raise ValueError(f"a DTensor argument needs a layout: {arg.placements}")
                mesh = arg.device_mesh
                if tuple(arg.placements) != tuple(lay):
                    arg = arg.redistribute(mesh, tuple(lay))
                grad = tuple(Partial() if order[i] in (axes or ()) else p for i, p in enumerate(lay))
                arg = arg.to_local(grad_placements=grad)
            local_args.append(arg)
        out = fn(*local_args)
        if mesh is None:
            return out
        outs, lays = ((out,), (out_layouts,)) if one else (out, out_layouts)
        wrapped = tuple(
            DTensor.from_local(o, mesh, tuple(lay), run_check=False)
            if isinstance(o, torch.Tensor) and lay is not None else o
            for o, lay in zip(outs, lays)
        )
        return wrapped[0] if one else wrapped

    return call


# --- parameter sharding rules (by name suffix) ---------------------------------

_PARAM_AXES = [
    # (path fragment, logical axes per dim): two-axis (FSDP x TP) sharding
    ("embed/table", ("vocab_rows", "fsdp")),
    ("head/w", ("fsdp", "vocab")),
    ("wq_a", ("fsdp", "lora")),
    ("wq_b", ("lora", "heads_flat")),
    ("w_kv_a", ("fsdp", "lora")),
    ("w_k_b", ("lora", "heads_flat")),
    ("w_v_b", ("lora", "heads_flat")),
    ("wq", ("fsdp", "heads_flat")),
    ("wk", ("fsdp", "kv_flat")),
    ("wv", ("fsdp", "kv_flat")),
    ("wo", ("heads_flat", "fsdp")),
    ("w_gate", None),  # resolved by rank below (dense vs expert)
    ("w_up", None),
    ("w_down", None),
    ("router", ("fsdp", None)),
    ("in_proj", ("fsdp", "ssm_inner")),
    ("out_proj", ("ssm_inner", "fsdp")),
    ("conv_w", (None, "ssm_inner")),
]

# flattened head projections: output dim = heads * head_dim -> shard on model
_EXTRA_RULES = {"heads_flat": "model", "kv_flat": "model"}


def param_logical_axes(path: str, shape: tuple[int, ...]):
    """Logical axes for a parameter, by name and rank heuristics.

    ``path`` is "/"-separated; the port's dotted parameter names
    (``blocks.3.mixer.wq``) are matched as ``blocks/3/mixer/wq``.  The
    fragments are tried in order, so ``wq_a`` wins over ``wq``.
    """
    path = path.replace(".", "/")
    for frag, axes in _PARAM_AXES:
        if path.endswith(frag) or f"/{frag}" in path:
            if axes is not None:
                return axes
            # w_gate / w_up / w_down: dense (2-D) vs expert (3-D).  Expert
            # FFNs put the FSDP axis on the FFN dim, not d_model: d_model is
            # the contraction dim, and sharding it would gather the weights;
            # sharding f keeps the contraction local and the combine a
            # small all-reduce.
            down = path.endswith("w_down") or "/w_down" in path
            if len(shape) == 3:
                return ("experts", "fsdp", None) if down else ("experts", None, "fsdp")
            return ("ff", "fsdp") if down else ("fsdp", "ff")
    return tuple(None for _ in shape)  # norms, scalars: replicated


def param_ctx(mesh, rules: Optional[dict] = None) -> ShardingCtx:
    """The context parameters' specs are taken in (``heads_flat`` and
    ``kv_flat`` on the model axis, then ``rules``)."""
    return ShardingCtx(mesh, dict(_EXTRA_RULES, **(rules or {})))


def param_spec(ctx: ShardingCtx, name: str, shape) -> tuple:
    names = param_logical_axes(name, tuple(shape))
    if len(names) != len(shape):
        names = tuple(None for _ in shape)
    return ctx.spec(tuple(shape), names)


def param_specs(model, mesh, rules: Optional[dict] = None, *, fallbacks: Optional[list] = None):
    """``{name: spec}`` over ``model.named_parameters()`` (the counterpart of
    the reference's ``param_spec_tree``; the port has one module per layer,
    so there is no stacked period axis to strip).  Replicate fallbacks are
    appended to ``fallbacks`` when it is given."""
    ctx = param_ctx(mesh, rules)
    specs = {n: param_spec(ctx, n, p.shape) for n, p in model.named_parameters()}
    if fallbacks is not None:
        fallbacks.extend(ctx.fallbacks)
    return specs


def distribute_model(model, mesh, rules: Optional[dict] = None):
    """Replace every parameter of ``model`` by a DTensor on ``mesh`` with the
    placements of :func:`param_specs`, in place.  Each rank keeps its own
    shard of the weights it holds (no communication): every rank must hold
    the same full weights, as ranks built from one seed do."""
    from torch.distributed.tensor import distribute_tensor

    ctx = param_ctx(mesh, rules)
    for mod_name, mod in model.named_modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            full = f"{mod_name}.{name}" if mod_name else name
            layout = ctx.placements(param_spec(ctx, full, p.shape))
            d = distribute_tensor(p.detach(), mesh, layout, src_data_rank=None)
            setattr(mod, name, nn.Parameter(d, requires_grad=p.requires_grad))
    return model
