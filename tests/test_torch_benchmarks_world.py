"""The port's harnesses that start processes, at tiny sizes on the CPU
(``--device cpu``): replicated and sharded in two-rank gloo worlds
(restores bit-exact on every rank), and fleetsim as the mini-fleet of
scripts/ci_gate.sh step 12 (three trainers: one through a remote outage,
one SIGKILLed mid-write, one under a bandwidth cap), graded by its own
``fleet --check``."""

import json

import pytest

from test_torch_benchmarks import run_harness


@pytest.fixture(autouse=True)
def _telemetry_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))


def test_replicated_spreads_the_writes_and_restores_on_every_rank(capsys):
    rc, last, out = run_harness("replicated", "--gb", "0.03", capsys=capsys)
    assert rc == 0 and last["ok"] and last["restore_equal"]
    assert last["world_size"] == 2
    written = last["bytes_written_by_rank"]
    # Each value written once, the load spread over both ranks.
    assert sum(written) >= last["bytes"] and min(written) > 0
    assert "torch.save from rank 0" in out


def test_sharded_restores_every_box_in_place(capsys):
    rc, last, _ = run_harness("sharded", "--d-model", "64", "--n-layers", "1", "--runs", "2",
                              capsys=capsys)
    assert rc == 0 and last["ok"] and last["restore_equal"]
    # Every leaf but the 0-d Adam step is a Shard(0) DTensor: 9 params x 3.
    assert last["dtensors"] == 27 and len(last["take_runs"]) == 2


def test_fleetsim_mini_fleet_passes_its_own_grade(capsys):
    rc, last, out = run_harness("fleetsim", "--jobs", "3", "--branch", "0",
                                "--takes", "2", "--mb", "0.5", "--pause", "0.05",
                                "--timeout", "120", capsys=capsys)
    assert rc == 0 and last["ok"], out
    jobs = last["job_results"]
    assert jobs["fleetsim-trainer1"]["killed"]  # the rank-kill fault fired
    assert jobs["fleetsim-trainer0"]["committed"] == 2  # rode out the outage
    assert jobs["fleetsim-trainer2"]["committed"] == 2
    assert last["fleet_check_rc"] == 0 and last["history_check_rc"] in (0, 3)
    assert "fleet --check: rc=0 (HEALTHY" in out
    assert json.loads(out.strip().splitlines()[-1]) == last
