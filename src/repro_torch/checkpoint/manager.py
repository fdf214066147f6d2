"""Fault-tolerant checkpoints of named host arrays: atomic, async, re-placeable.

The port of the JAX package's ``repro.checkpoint.manager``.  A checkpoint
is an ordered ``dict[str, np.ndarray]`` of named host arrays (the JAX
package flattens a pytree to the same ``a/b/c`` names, and writes the same
files, so either package reads the other's checkpoints):

- **atomic**: writes go to ``step_XXXXXXXX.tmp/`` (``arrays.npz`` plus a
  ``manifest.json`` with shape, dtype and CRC32 per array, fsync'd) and are
  renamed into place only then, so a crash mid-write never corrupts the
  latest checkpoint; a second save of one step raises ``FileExistsError``;
- **async**: ``save(blocking=False)`` writes on a background thread; its
  error resurfaces at the next :meth:`wait` or :meth:`save`;
- **re-placeable**: :meth:`restore` returns host arrays; where they go (how
  many ranks, which devices) is the caller's business, so a checkpoint
  written at one rank count restores at another.
"""

from __future__ import annotations

import json
import os
import re
import threading
import zlib
from typing import Mapping, Optional

import numpy as np

_STEP_RE = re.compile(r"^step_(\d{8})$")


def crc32(arr: np.ndarray) -> int:
    """CRC32 of an array's bytes in C order, without a copy of a contiguous
    array (``tobytes`` would copy gigabytes of a large store)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


class CheckpointManager:
    """Steps of named host arrays under ``directory``, the last ``keep`` kept."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save -----------------------------------------------------------------

    def save(self, step: int, arrays: Mapping[str, np.ndarray], blocking: bool = False) -> None:
        """Write ``arrays`` as step ``step``.

        A blocking save writes the caller's arrays as they are; an async
        one copies them first, since the caller may change them while the
        thread writes.
        """
        self.wait()
        host = [(name, np.asarray(a) if blocking else np.array(a)) for name, a in arrays.items()]
        if blocking:
            self._write(step, host)
        else:
            self._thread = threading.Thread(target=self._write_guarded, args=(step, host))
            self._thread.start()

    def _write_guarded(self, step: int, host) -> None:
        # A bare thread target swallows its exception: a failed async write
        # (disk full, the FileExistsError of a re-save) would leave the
        # caller believing the checkpoint landed.  Keep it for wait().
        try:
            self._write(step, host)
        except BaseException as exc:  # noqa: BLE001 - resurfaced in wait()
            self._error = exc

    def _write(self, step: int, host) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {}
        arrays = {}
        for i, (name, arr) in enumerate(host):
            key = f"a{i}"
            arrays[key] = arr
            manifest[name] = {
                "key": key,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "crc32": crc32(arr),
            }
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            raise FileExistsError(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            path = os.path.join(self.dir, f"step_{s:08d}")
            for root, dirs, files in os.walk(path, topdown=False):
                for fn in files:
                    os.unlink(os.path.join(root, fn))
                for dn in dirs:
                    os.rmdir(os.path.join(root, dn))
            os.rmdir(path)

    def wait(self) -> None:
        """Join a pending async save; re-raise its exception if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    # -- restore ----------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Mapping, step: Optional[int] = None):
        """``(arrays, step)``: the arrays named by ``like``, in its order.

        ``like`` maps each name to an array or a shape tuple.  A name the
        checkpoint lacks raises ``KeyError``, a CRC mismatch ``IOError``, a
        shape other than ``like``'s ``ValueError``.  The newest step is read
        unless ``step`` is given.
        """
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        out = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for name, want in like.items():
                if name not in manifest:
                    raise KeyError(f"checkpoint missing leaf {name!r}")
                meta = manifest[name]
                arr = data[meta["key"]]
                if crc32(arr) != meta["crc32"]:
                    raise IOError(f"CRC mismatch for {name!r} (corrupt checkpoint)")
                want_shape = tuple(getattr(want, "shape", want))
                if tuple(arr.shape) != want_shape:
                    raise ValueError(f"{name}: shape {arr.shape} != {want_shape}")
                out[name] = arr
        return out, step
