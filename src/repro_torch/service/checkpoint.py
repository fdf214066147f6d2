"""Service checkpoints and resume for the continuous-batching scheduler.

The port of the JAX package's ``repro.service.checkpoint``.  A service
snapshot is two artifacts, written in this order:

1. the engine's state as host arrays (``BatchEngine.to_host`` or
   ``VegasBatchEngine.to_host``), saved atomically by
   :class:`~repro_torch.checkpoint.manager.CheckpointManager` (tmp directory,
   fsync'd manifest, rename; CRC32 per array);
2. a ``meta_XXXXXXXX.json`` sidecar with what the host loop needs to
   replay: the slot -> request map (thetas round-trip bit for bit through
   JSON's float64 repr), each slot's admission iteration, the iteration and
   tick counters, the loop's stats and the request ids already pulled.

The sidecar is written second (tmp, fsync, ``os.replace``), so its presence
commits the snapshot: a crash between the two writes leaves an orphaned
state directory behind the previous complete snapshot.

Resume parity: a snapshot is taken at an admission tick, right after its
admissions.  From there the scheduler's decisions depend only on the engine
state, the slot map, the iteration counter and the rest of the stream, all
of which are captured, so a resumed run repeats the original decision for
decision and gives the same bits for every slot the crash did not touch.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

from repro_torch.checkpoint.manager import CheckpointManager

_META_RE = re.compile(r"^meta_(\d{8})\.json$")

#: Keys the scheduler's resume reads from a meta sidecar.  A sidecar without
#: one of them is corrupt (as a JSON parse failure is): a partial write that
#: happens to be valid JSON must not restore.
_REQUIRED_META = ("it", "ticks", "stats", "pulled_ids", "slots")


class ServiceCheckpointer:
    """Snapshot and restore the whole serving state of a
    :class:`~repro_torch.service.scheduler.BatchScheduler`.

    ``save`` writes the state synchronously: the scheduler updates the
    engine's state in place as soon as it goes on.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.manager = CheckpointManager(os.path.join(directory, "state"), keep=keep)

    # -- save -----------------------------------------------------------------

    def save(self, step: int, arrays: dict, meta: dict) -> None:
        """Write one snapshot (``arrays``: an engine's ``to_host``): state
        first, then the committing meta sidecar."""
        self.manager.save(step, arrays, blocking=True)
        final = os.path.join(self.dir, f"meta_{step:08d}.json")
        tmp = final + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, **meta}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        """Drop meta sidecars whose state the manager has already dropped."""
        keep = set(self.manager.all_steps())
        for name in os.listdir(self.dir):
            m = _META_RE.match(name)
            if m and int(m.group(1)) not in keep:
                os.unlink(os.path.join(self.dir, name))

    # -- restore --------------------------------------------------------------

    def complete_steps(self) -> list[int]:
        """Steps with both artifacts on disk (the restorable snapshots)."""
        metas = set()
        for name in os.listdir(self.dir):
            m = _META_RE.match(name)
            if m:
                metas.add(int(m.group(1)))
        return sorted(metas & set(self.manager.all_steps()))

    def latest_step(self) -> Optional[int]:
        steps = self.complete_steps()
        return steps[-1] if steps else None

    def _read_meta(self, step: int) -> dict:
        """Load and check one meta sidecar (raises on a corrupt or partial one)."""
        with open(os.path.join(self.dir, f"meta_{step:08d}.json")) as f:
            meta = json.load(f)
        missing = [k for k in _REQUIRED_META if k not in meta]
        if missing:
            raise KeyError(f"meta sidecar for step {step} is missing keys {missing}")
        return meta

    def restore(self, engine, step: Optional[int] = None):
        """``(state, meta)`` from the newest readable snapshot, placed on
        ``engine``'s ranks: a snapshot written at one rank count restores at
        any other that divides the slots, every slot with its bits.

        A snapshot whose artifacts are unreadable (a truncated sidecar, a
        CRC-failing array) is passed over for the newest earlier complete
        one; only when every snapshot is unreadable, or an explicit ``step``
        is, does the error propagate.
        """
        host, meta, _ = self._restore_any(engine.host_shapes(), step)
        return engine.place(host), meta

    def restore_host(self, like, step: Optional[int] = None):
        """``(arrays, meta, step)`` from the newest readable snapshot, as host
        arrays.  ``like`` (e.g. the live ``to_host`` copy) gives the names and
        shapes.  The scheduler's evacuation patches single slot rows with it
        before it places the whole fleet on the surviving ranks."""
        return self._restore_any(like, step)

    def _restore_any(self, like, step: Optional[int]):
        if step is not None:
            meta = self._read_meta(step)
            arrays, _ = self.manager.restore(like, step=step)
            return arrays, meta, step
        steps = self.complete_steps()
        if not steps:
            raise FileNotFoundError(f"no complete service snapshot in {self.dir}")
        errors = []
        for s in reversed(steps):
            try:
                meta = self._read_meta(s)
                arrays, _ = self.manager.restore(like, step=s)
                return arrays, meta, s
            except (json.JSONDecodeError, KeyError, OSError) as err:
                errors.append(f"step {s}: {type(err).__name__}: {err}")
        raise FileNotFoundError(
            f"no readable service snapshot in {self.dir} "
            f"({len(steps)} present, all corrupt): " + "; ".join(errors)
        )
