"""Architecture registry (the port's copy of :mod:`repro.configs`): one
module per assigned architecture.

``get_config(arch_id)`` returns the exact published configuration;
``get_smoke_config(arch_id)`` returns a reduced same-family configuration
for CPU smoke tests (small widths/depths, few experts, tiny vocab).
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "mamba2-370m",
    "deepseek-7b",
    "minitron-4b",
    "mistral-nemo-12b",
    "qwen3-32b",
    "jamba-v0.1-52b",
    "internvl2-2b",
    "qwen3-moe-235b-a22b",
    "deepseek-v2-236b",
    "hubert-xlarge",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.smoke_config()
