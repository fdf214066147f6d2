"""Where the benchmark's files are, and how it finds them by name.

Data files (``configs/``, ``traffic/``, ``workloads/``) are JSON.  Code that
belongs to one name is a file of its own, loaded by :func:`load_code`:
``drivers/<kind>.py`` (a traffic kind), ``entries/<entry>.py`` (an entry of
the port), ``families/<family>.py`` (an integrand family's closed form) and
``metrics/<name>.py`` (a per-layer metric).  Adding one of them adds a file
and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

_LOADED: Dict[Tuple[str, str], ModuleType] = {}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_code(folder: str, name: str) -> ModuleType:
    """The module ``<folder>/<name>.py`` under the benchmark, loaded once."""
    key = (folder, name)
    if key not in _LOADED:
        path = HERE / folder / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {folder}/{name}.py in the benchmark")
        mod_name = "qbench_{}_{}".format(folder, "".join(c if c.isalnum() else "_" for c in name))
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]
