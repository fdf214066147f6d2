"""Carry a JAX parameter tree into the port's modules.

The port's module attributes are the reference's dict keys, so a tree of
numpy arrays (``jax.tree.map(np.asarray, params)``) loads by name.  The
reference stacks each period of the layer pattern on a leading axis
(``params["layers"]["b{j}"]``, one row per repeat) and keeps the leading
dense layers under ``params["prologue"]``: row p of block j is layer
``first_k_dense + p * period + j``.  Leaves are rounded to float32 on the
way in (a reference initialised with x64 enabled holds float64 weights,
which it casts to the activation dtype per call).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


def _flatten(tree, prefix: str, out: dict) -> dict:
    for key, value in tree.items():
        if isinstance(value, dict):
            _flatten(value, f"{prefix}{key}.", out)
        else:
            out[f"{prefix}{key}"] = torch.from_numpy(np.array(value))
    return out


def _row(tree: dict, p: int) -> dict:
    """Row ``p`` of every leaf of a stacked parameter tree."""
    return {k: _row(v, p) if isinstance(v, dict) else np.asarray(v)[p] for k, v in tree.items()}


def load_module(module: nn.Module, params: dict) -> nn.Module:
    """Copy a JAX parameter dict into ``module``: every parameter, by name."""
    module.load_state_dict(_flatten(params, "", {}), strict=True)
    return module


def _per_layer(cfg: ModelConfig, params: dict) -> dict:
    """A stacked tree (parameters, or an optimizer moment of them) as the
    port's module tree: ``embed``, ``final_norm``, ``head`` and one
    ``blocks[i]`` per layer."""
    blocks = dict(enumerate(params["prologue"]))
    period = cfg.block_pattern_period
    n_scan = (cfg.n_layers - cfg.first_k_dense) // period
    for p in range(n_scan):
        for j in range(period):
            blocks[cfg.first_k_dense + p * period + j] = _row(params["layers"][f"b{j}"], p)
    tree = {name: params[name] for name in ("embed", "final_norm", "head")}
    tree["blocks"] = {str(i): blk for i, blk in blocks.items()}
    return tree


def from_jax_params(cfg: ModelConfig, params: dict, device) -> Model:
    """A :class:`Model` on ``device`` holding the JAX package's weights."""
    return load_module(Model(cfg, device=torch.device(device)), _per_layer(cfg, params))


def from_jax_opt_state(cfg: ModelConfig, state: dict, device) -> dict:
    """The JAX package's optimizer state (numpy leaves) as the port's:
    ``mu``, ``nu`` (and ``ef``) split into the model's parameter names by
    the same period rows as the weights, float32 on ``device``; ``count``
    an int32 on the host."""
    out = {"count": torch.tensor(int(np.asarray(state["count"])), dtype=torch.int32)}
    for key in ("mu", "nu", "ef"):
        if key in state:
            flat = _flatten(_per_layer(cfg, state[key]), "", {})
            out[key] = {n: t.to(device=device, dtype=torch.float32) for n, t in flat.items()}
    return out
