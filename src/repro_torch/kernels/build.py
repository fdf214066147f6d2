"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library with
a plain C interface, for Hopper only (``sm_90a``), and loaded with
:mod:`ctypes`.  Libraries go to ``build/kernels/`` at the root of the
checkout, named by a hash of the sources and flags, so a changed source is
rebuilt and an unchanged one is reused.  ``-Xptxas -v`` is always on: its
report (registers, spills, shared memory per instantiation) is kept beside
each library.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler", "-fPIC",
    # no multiply-add contraction: the kernels round like their plain
    # PyTorch versions, operation by operation
    "-fmad=false",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Built:
    path: Path
    log: str  # nvcc's output, including the -Xptxas -v report


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, or the PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built on "
            "the machine that has the GPU"
        )
    return found


def _key() -> str:
    """Hash of every source and header under csrc/, and the flags."""
    h = hashlib.sha256()
    for dep in sorted(CSRC.glob("*.cu*")):
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> tuple[Path, Path, Path]:
    source = CSRC / f"{name}.cu"
    if not source.exists():
        raise FileNotFoundError(source)
    lib = BUILD_DIR / f"{name}-{_key()}.so"
    return source, lib, lib.with_suffix(".log")


def build_all(names: tuple[str, ...] | None = None) -> dict[str, Built]:
    """Build the named sources (default: every csrc/*.cu), all nvcc at once.

    Up-to-date libraries are reused.  Raises RuntimeError with nvcc's
    output if any build fails.
    """
    if names is None:
        names = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        source, lib, log = _target(name)
        if lib.exists() and log.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        running[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in running.items():
        out, _ = proc.communicate()
        _, lib, log = _target(name)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{out}")
            continue
        log.write_text(out)
        os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    out = {}
    for name in names:
        _, lib, log = _target(name)
        out[name] = Built(lib, log.read_text())
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    return ctypes.CDLL(str(build_all((name,))[name].path))
