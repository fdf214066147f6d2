"""Build the CUDA kernels at first use and load them with ctypes.

Each library of :data:`LIBRARIES` is a list of translation units under
``csrc/`` (a source and its ``-D`` defines).  Every unit is compiled by its
own ``nvcc -c``, all of them at once, for Hopper only (``sm_90a``); the
objects are linked into a shared library with a plain C interface and
loaded with :mod:`ctypes`.  Libraries go to ``build/kernels/`` at the root
of the checkout, named by a hash of the sources, units and flags, so a
changed source is rebuilt and an unchanged one is reused.  ``-Xptxas -v`` is
always on: its report (registers, spills, shared memory per kernel) is kept
beside each library.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler", "-fPIC",
    # no multiply-add contraction: the kernels round like their plain
    # PyTorch versions, operation by operation
    "-fmad=false",
    "-Xptxas", "-v",
)

# The GM kernel: the dispatcher, and one unit per (working type, dimension)
# with that pair's ten integrand kernels.  The VEGAS sample reductions: one
# unit.  The redistribution round's round and pack kernels: one unit.
LIBRARIES: dict[str, tuple[tuple[str, tuple[str, ...]], ...]] = {
    "genz_malik_eval": (
        ("genz_malik_eval.cu", ()),
        *(
            ("gm_instance.cu", (f"-DGM_T={t}", f"-DGM_D={d}"))
            for t in ("double", "float")
            for d in range(1, 17)
        ),
    ),
    "vegas_sums": (("vegas_sums.cu", ()),),
    "redistribute_round": (("redistribute_round.cu", ()),),
}


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


def _key(name: str) -> str:
    """Hash of every source and header under csrc/, the units and the flags."""
    h = hashlib.sha256()
    for dep in sorted(CSRC.iterdir()):
        if dep.suffix in (".cu", ".cuh", ".h"):
            h.update(dep.name.encode())
            h.update(dep.read_bytes())
    h.update(repr(LIBRARIES[name]).encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> tuple[Path, Path]:
    if name not in LIBRARIES:
        raise KeyError(f"unknown kernel library {name!r}; known: {sorted(LIBRARIES)}")
    lib = BUILD_DIR / f"{name}-{_key(name)}.so"
    return lib, lib.with_suffix(".log")


def compile_commands(name: str, objdir: Path) -> list[tuple[list[str], Path]]:
    """The ``nvcc -c`` command and object path of each unit of library ``name``."""
    out = []
    for n, (source, defines) in enumerate(LIBRARIES[name]):
        obj = objdir / f"{n:02d}-{Path(source).stem}.o"
        out.append(([nvcc(), *NVCC_FLAGS, *defines, "-c", "-o", str(obj), str(CSRC / source)], obj))
    return out


def build_all(names: tuple[str, ...] | None = None) -> dict[str, Built]:
    """Build the named libraries (default: all), every unit's nvcc at once.

    Up-to-date libraries are reused.  Raises RuntimeError with nvcc's
    output if any build fails.
    """
    names = tuple(LIBRARIES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    for name in names:
        lib, log = _target(name)
        if lib.exists() and log.exists():
            continue
        objdir = Path(tempfile.mkdtemp(prefix=f"{name}-", dir=BUILD_DIR))
        procs = [
            (obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for cmd, obj in compile_commands(name, objdir)
        ]
        pending[name] = (objdir, procs)
    failed = []
    for name, (objdir, procs) in pending.items():
        lib, log = _target(name)
        logs, ok = [], True
        for (source, defines), (_, proc) in zip(LIBRARIES[name], procs):
            out, _ = proc.communicate()
            logs.append(f"== {source} {' '.join(defines)}\n{out}")
            if proc.returncode != 0:
                ok = False
                failed.append(f"nvcc failed for {source} {' '.join(defines)} "
                              f"(exit {proc.returncode}):\n{out}")
        if ok:
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            link = subprocess.run(
                [nvcc(), "-shared", "-o", str(tmp), *(str(obj) for obj, _ in procs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            if link.returncode != 0:
                failed.append(f"link failed for {name} (exit {link.returncode}):\n{link.stdout}")
            else:
                log.write_text("\n".join(logs) + link.stdout)
                os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
        shutil.rmtree(objdir, ignore_errors=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    out = {}
    for name in names:
        lib, log = _target(name)
        out[name] = Built(lib, log.read_text())
    return out


_KERNEL_NAME = re.compile(r"gm_eval_kernelI([df])Li(\d+)E(\d+)")


def ptxas_report(log: str) -> dict[tuple[str, str, int], tuple[int, int, int, int]]:
    """Parse a build log's ``-Xptxas -v`` report for the GM kernels.

    Returns {(dtype, integrand functor, D): (registers, spill store bytes,
    spill load bytes, static shared bytes)}, from the mangled names
    ``gm::gm_eval_kernel<T, D, F>``.
    """
    out, key, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = _KERNEL_NAME.search(line)
            key = None
            if m:
                n = int(m.group(3))
                dtype = "float64" if m.group(1) == "d" else "float32"
                key = (dtype, line[m.end():m.end() + n], int(m.group(2)))
        elif key and "spill stores" in line:
            spills = tuple(int(v) for v in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))
        elif key and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[key] = (regs, spills[0], spills[1], int(smem.group(1)) if smem else 0)
            key = None
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build library ``name`` if needed and load it (once per process)."""
    return ctypes.CDLL(str(build_all((name,))[name].path))
