"""The port's checkpoint manager, held against the JAX package's.

Counterparts of tests/test_checkpoint.py (roundtrip, async save and
latest, keep-last-k GC, corruption, shape mismatch) on the port's
``CheckpointManager`` over named host arrays, plus the file format: either
package restores the other's checkpoints, with the same CRC32 per array.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint.manager import CheckpointManager as JManager
from repro_torch.checkpoint.manager import CheckpointManager


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {
        "layer/w": rng.normal(size=(8, 16)),
        "layer/b": np.zeros(16),
        "count": np.asarray(seed, np.int32),
        "mask": rng.random(5) < 0.5,
    }


def _tree(arrays):
    """The same arrays as the JAX package's nested pytree."""
    return {
        "layer": {"w": jnp.asarray(arrays["layer/w"]), "b": jnp.asarray(arrays["layer/b"])},
        "count": jnp.asarray(arrays["count"]),
        "mask": jnp.asarray(arrays["mask"]),
    }


def _assert_same(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    arrays = _arrays(3)
    mgr.save(3, arrays, blocking=True)
    restored, step = mgr.restore(arrays)
    assert step == 3
    _assert_same(restored, arrays)


def test_restore_takes_shapes_in_place_of_arrays(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    arrays = _arrays(1)
    mgr.save(1, arrays, blocking=True)
    restored, _ = mgr.restore({k: np.shape(v) for k, v in arrays.items()})
    _assert_same(restored, arrays)


def test_async_save_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    for s in (1, 2, 5):
        mgr.save(s, _arrays(s))
    mgr.wait()
    assert mgr.latest_step() == 5
    restored, step = mgr.restore(_arrays(0))
    assert step == 5
    assert int(restored["count"]) == 5


def test_async_save_copies_the_callers_arrays(tmp_path):
    """The caller may change its arrays while the thread writes."""
    mgr = CheckpointManager(str(tmp_path))
    arrays = _arrays(2)
    want = {k: v.copy() for k, v in arrays.items()}
    mgr.save(2, arrays)
    arrays["layer/w"][:] = np.nan
    mgr.wait()
    _assert_same(mgr.restore(want)[0], want)


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(1, 6):
        mgr.save(s, _arrays(s), blocking=True)
    assert mgr.all_steps() == [4, 5]


def test_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _arrays(1), blocking=True)
    mpath = os.path.join(str(tmp_path), "step_00000001", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    first = next(iter(manifest["leaves"]))
    manifest["leaves"][first]["crc32"] ^= 0xDEADBEEF
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(IOError):
        mgr.restore(_arrays(0))


def test_shape_mismatch_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _arrays(1), blocking=True)
    bad = dict(_arrays(1), **{"layer/w": np.zeros((4, 4))})
    with pytest.raises(ValueError):
        mgr.restore(bad)


def test_missing_leaf_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _arrays(1), blocking=True)
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore(dict(_arrays(1), extra=np.zeros(2)))


def test_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore(_arrays(0))


def test_jax_package_reads_the_ports_checkpoint(tmp_path):
    arrays = _arrays(7)
    CheckpointManager(str(tmp_path)).save(7, arrays, blocking=True)
    tree, step = JManager(str(tmp_path)).restore(_tree(_arrays(0)))
    assert step == 7
    _assert_same({"layer/w": np.asarray(tree["layer"]["w"]),
                  "layer/b": np.asarray(tree["layer"]["b"]),
                  "count": np.asarray(tree["count"]),
                  "mask": np.asarray(tree["mask"])}, arrays)


def test_port_reads_the_jax_packages_checkpoint(tmp_path):
    arrays = _arrays(9)
    JManager(str(tmp_path / "j")).save(9, _tree(arrays), blocking=True)
    CheckpointManager(str(tmp_path / "p")).save(9, arrays, blocking=True)
    restored, step = CheckpointManager(str(tmp_path / "j")).restore(_arrays(0))
    assert step == 9
    _assert_same({k: restored[k] for k in arrays}, arrays)
    # the same manifests: names, shapes, dtypes and CRC32 per array
    manifests = [
        json.loads((tmp_path / p / "step_00000009" / "manifest.json").read_text())["leaves"]
        for p in ("j", "p")
    ]
    strip = [{k: {f: v[f] for f in ("shape", "dtype", "crc32")} for k, v in m.items()}
             for m in manifests]
    assert strip[0] == strip[1]
    assert jax.tree_util.tree_structure(_tree(arrays)).num_leaves == len(arrays)
