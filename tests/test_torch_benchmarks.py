"""The port's benchmark harnesses (tpusnap_torch/benchmarks/) at tiny sizes
on the CPU (``--device cpu``), each called in process through its
``main(argv)``: the exit code, the last line's JSON and its correctness
fields. The gcs_pipeline case mirrors
tests/test_gcs.py::test_gcs_pipeline_benchmark_smoke (a subprocess, the
same arguments and asserts). The harnesses that start worlds or fleets
of processes are in tests/test_torch_benchmarks_world.py."""

import importlib
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _telemetry_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))


def run_harness(name, *args, capsys):
    """``main([*args, "--device", "cpu"])``; returns (exit code, the last
    line's JSON, stdout)."""
    rc = importlib.import_module(f"tpusnap_torch.benchmarks.{name}").main(
        [*args, "--device", "cpu"]
    )
    out = capsys.readouterr().out
    last = json.loads(out.strip().splitlines()[-1])
    assert last["bench"] == name and last["device"] == "cpu"
    return rc, last, out


def test_load_tensor_stays_within_its_budget(capsys):
    rc, last, out = run_harness("load_tensor", "--gb", "0.25", capsys=capsys)
    assert rc == 0 and last["ok"]
    assert last["bytes"] == 256 << 20 and last["budget_bytes"] == 100 << 20
    assert last["rss_within_budget"] and last["rss_limit_bytes"] == 8 * (100 << 20)
    for label in ("budgeted", "unbudgeted"):
        assert last[label]["values_equal"] and last[label]["in_place"]
    assert "read_object budgeted" in out


def test_pinned_host_restores_in_place(capsys):
    rc, last, _ = run_harness("pinned_host", capsys=capsys)
    assert rc == 0 and last["ok"]
    assert last["values_equal"] and last["in_place"] and last["host_resident"]
    # Without CUDA pinning degrades to pageable memory: reported, not required.
    assert last["host_offload_supported"] is False and last["restored_pinned"] is False


def test_async_latency_blocks_less_than_sync(capsys):
    rc, last, _ = run_harness("async_latency", "--mb", "4", "--latency-ms", "20", "--runs", "2",
                              capsys=capsys)
    assert rc == 0 and last["ok"] and last["restore_equal"]
    assert len(last["sync_runs"]) == len(last["blocked_runs"]) == 2
    # Every sync take waits out at least one request's latency per blob.
    assert last["sync_s"] >= 0.02 and last["async_total_s"] >= last["async_blocked_s"]


def test_incremental_dedups_scrubs_and_restores_the_chain(capsys):
    rc, last, out = run_harness("incremental", "--gb", "0.02", "--hot-mb", "1", "--runs", "2",
                                "--chain-depth", "10", capsys=capsys)
    assert rc == 0 and last["ok"]
    assert last["increment_deduped"] and last["scrub_clean"] and last["chain_restores_equal"]
    assert last["inc_bytes_on_disk"] <= (1 << 20) + (1 << 20)  # the 1 MiB hot tensor + 1 MiB
    assert [r["depth"] for r in last["chain"]] == [1, 10]
    assert "chain depth sweep" in out


def test_embedding_sync_async_and_in_place_restore(capsys):
    rc, last, _ = run_harness("embedding", "--rows", "4096", "--dim", "16", capsys=capsys)
    assert rc == 0 and last["ok"]
    assert last["restore_equal"] and last["restore_in_place"]
    assert last["bytes"] == 4 * 4096 * (16 + 1) * 4  # tables + row-wise Adagrad state
    assert last["async_total_s"] >= last["async_blocked_s"]


def test_dcp_compare_restores_every_method_bit_for_bit(capsys):
    rc, last, out = run_harness("dcp_compare", "--d-model", "64", "--n-heads", "4",
                                "--n-layers", "1", "--runs", "2", capsys=capsys)
    assert rc == 0 and last["ok"]
    assert last["restore_equal"] == {
        "torch": True, "dcp": True, "dcp_async": True, "tpusnap": True, "tpusnap_async": True,
    }
    assert all(len(v) == 2 for v in last["samples_s"].values())
    assert set(last["speedups"]) == {"torch_save", "torch_load", "dcp_save", "dcp_load",
                                     "dcp_async_blocked", "dcp_async_total"}
    assert "MEDIAN" in out
    from tpusnap_torch.history import load_history

    events = [e for e in load_history() if e.get("kind") == "dcp"]
    assert len(events) == 1 and events[0]["sessions"] == 2


def test_gcs_pipeline_benchmark_smoke(tmp_path):
    """The gcs_pipeline harness (cloud-path throughput through the fake
    server with injected latency) runs end to end, verifies its restore,
    and reports pipeline concurrency."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", TPUSNAP_TELEMETRY_DIR=str(tmp_path / "tel"))
    proc = subprocess.run(
        [
            sys.executable, "-m", "tpusnap_torch.benchmarks.gcs_pipeline",
            "--total-mb", "16",
            "--latency-ms", "5",
            "--upload-chunk-mb", "1",
            "--device", "cpu",
        ],
        capture_output=True,
        text=True,
        timeout=240,
        env=env,
        cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "restore verified: True" in proc.stdout
    assert "concurrency" in proc.stdout
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["restore_verified"] and last["take"]["requests"] > 0
