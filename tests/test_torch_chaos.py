"""The port's chaos self-test at 1, 2 and 4 CPU ranks.

Counterparts of tests/test_chaos.py (scenario coverage, healthy-slot bit
parity, re-routes and resume, the rank-loss scenarios, the elastic restore)
on ``repro_torch.service.chaos_selftest``, run once for the module on
``["cpu"] * c`` ranks for c in (1, 2, 4), in this process (the port's ranks
live in one host process), and through its command line once.  The
self-test asserts the contract itself; these tests hold its summary.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.service import chaos_selftest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = {"baseline", "nan_injection", "slot_corruption", "crash_resume", "queue_storm", "deadline"}
# rank-loss scenarios need surviving ranks, so two or more ranks only
ELASTIC = {"device_kill_readmit", "device_kill_snapshot", "device_transient", "device_regrow"}


@pytest.fixture(scope="module")
def chaos_output():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return chaos_selftest.run(4, "cpu")
    finally:
        torch.set_num_threads(threads)


def test_chaos_covers_every_injector_at_each_count(chaos_output):
    assert chaos_output["device_counts"] == [1, 2, 4]
    assert set(chaos_output["scenarios"]) == {"devices_1", "devices_2", "devices_4"}
    for count, scen in chaos_output["scenarios"].items():
        expected = BASE if count == "devices_1" else BASE | ELASTIC
        assert set(scen) == expected, (count, sorted(scen))


def test_chaos_healthy_slots_keep_bit_parity(chaos_output):
    for scen in chaos_output["scenarios"].values():
        assert scen["nan_injection"]["healthy_parity"]
        assert scen["slot_corruption"]["healthy_parity"]
        assert scen["deadline"]["healthy_parity"]


def test_chaos_reroutes_and_resume(chaos_output):
    for scen in chaos_output["scenarios"].values():
        assert scen["nan_injection"]["reroutes"] == 3
        assert scen["nan_injection"]["quarantines"] >= 6
        assert scen["crash_resume"]["union_parity"]
        assert scen["crash_resume"]["replayed"] > 0
        assert scen["queue_storm"]["n_results"] == 40


@pytest.mark.parametrize("count, shrunk_to", [(2, 1), (4, 2)])
def test_chaos_device_loss_scenarios(chaos_output, count, shrunk_to):
    """Losing rank 1 of ``count`` with 8 slots leaves ``count - 1`` healthy
    ranks, of which the largest set dividing 8 serves on."""
    scen = chaos_output["scenarios"][f"devices_{count}"]
    assert scen["device_kill_readmit"]["evacuated"] > 0
    assert scen["device_kill_readmit"]["shrunk_to"] == shrunk_to
    assert scen["device_kill_readmit"]["healthy_parity"]
    assert scen["device_kill_snapshot"]["snapshot_recovered"] > 0
    assert scen["device_kill_snapshot"]["healthy_parity"]
    assert scen["device_transient"]["full_parity"]
    assert scen["device_transient"]["retries"] == 2
    assert scen["device_regrow"]["regrows"] >= 1
    assert scen["device_regrow"]["final_devices"] == count


def test_chaos_elastic_restore_across_rank_counts(chaos_output):
    er = chaos_output["elastic_restore"]
    assert er["from_devices"] == 4
    assert er["union_parity"]
    assert set(er["restored_to"]) == {"1", "2"}
    assert all(n > 0 for n in er["restored_to"].values())


def test_chaos_command_line_prints_result_json_last():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.service.chaos_selftest", "1", "cpu", "-q"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("RESULT_JSON:"), proc.stdout[-2000:]
    out = json.loads(last[len("RESULT_JSON:"):])
    assert out["device_counts"] == [1] and set(out["scenarios"]["devices_1"]) == BASE
    assert "elastic_restore" not in out
