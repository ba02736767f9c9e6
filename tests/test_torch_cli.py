"""``python -m tpusnap_torch``: the CLI halves of the port's earlier
slices that waited for the CLI (inspect, incremental, retention,
compress, tiering, CAS, delta streams, elastic streams), mirrored from
the JAX package's tests of the same names, and parity with tpusnap's
CLI: on one snapshot taken by each package, the read-only commands of
both CLIs give the same exit code and the same text, apart from the
program name and the age of the snapshot in seconds.

The CLI runs in process (``main(argv)``); one test starts it as a
module, and one tails a take in flight with ``watch --once``.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpusnap_torch import Snapshot, StateDict, knobs, telemetry
from tpusnap_torch.__main__ import main
from tpusnap_torch.knobs import (
    override_batching_disabled,
    override_checksum_disabled,
    override_compress,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated_telemetry(tmp_path, monkeypatch):
    """Every test reads and writes its own telemetry dir (history, SLO
    sidecars, ledgers, the tier status), never another test's."""
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "tele"))
    monkeypatch.setenv("TPUSNAP_TIER_DRAIN", "0")
    yield
    from tpusnap_torch import tiering

    tiering.reset_manager_for_tests()


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "dense": rng.standard_normal((256, 128)).astype(np.float32),
        "small": rng.standard_normal(16).astype(np.float32),
    }


def _state():
    return StateDict(
        **{k: torch.from_numpy(v) for k, v in _arrays().items()},
        obj={"nested": [1, 2, 3]},
        step=7,
        lr=1e-3,
    )


def _flip_byte(root: str, relpath_substr: str, offset: int = 100) -> str:
    for dirpath, _, files in os.walk(root):
        for f in files:
            full = os.path.join(dirpath, f)
            rel = os.path.relpath(full, root)
            if relpath_substr in rel and not f.startswith(".snapshot"):
                with open(full, "r+b") as fh:
                    fh.seek(min(offset, os.path.getsize(full) - 1))
                    b = fh.read(1)
                    fh.seek(-1, os.SEEK_CUR)
                    fh.write(bytes([b[0] ^ 0xFF]))
                return rel
    raise AssertionError(f"no blob matching {relpath_substr!r} under {root}")


def _tensors(seed: int = 0, n: int = 4, shape=(64, 32)):
    return {
        "m": StateDict(
            **{
                f"w{i}": torch.from_numpy(
                    np.random.default_rng(seed * 100 + i).standard_normal(shape).astype(np.float32)
                )
                for i in range(n)
            }
        )
    }


# ------------------------------------------------------------ inspect


def test_cli_info_ls_cat_verify(tmp_path, capsys):
    path = str(tmp_path / "snap")
    with override_batching_disabled(True):
        Snapshot.take(path, {"app": _state()})

    assert main(["info", path]) == 0
    out = capsys.readouterr().out
    assert "world_size:  1" in out and "payload:" in out

    assert main(["ls", "-l", path]) == 0
    out = capsys.readouterr().out
    assert "0/app/dense" in out and "tensor" in out

    assert main(["cat", path, "0/app/step"]) == 0
    assert "7" in capsys.readouterr().out

    assert main(["verify", path]) == 0
    assert "0 corrupt" in capsys.readouterr().out

    _flip_byte(path, "dense")
    assert main(["verify", path]) == 2
    assert "CORRUPT" in capsys.readouterr().err

    assert main(["info", str(tmp_path / "nosnap")]) == 1
    assert "error:" in capsys.readouterr().err

    # Usage errors exit 1 (argparse's 2 would read as "corruption
    # found"); --help stays 0.
    assert main(["verify", "--bogus-flag", path]) == 1
    capsys.readouterr()
    assert main(["--help"]) == 0
    capsys.readouterr()


def test_cli_module_invocation(tmp_path):
    """``python -m tpusnap_torch verify`` works as a real entry point."""
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"app": _state()})
    proc = subprocess.run(
        [sys.executable, "-m", "tpusnap_torch", "verify", path],
        capture_output=True, text=True, timeout=300, cwd=_REPO,
        env={**os.environ, "PYTHONPATH": _REPO},
    )
    assert proc.returncode == 0, proc.stderr
    assert "0 corrupt" in proc.stdout


def test_cli_verify_exit3_when_nothing_verifiable(tmp_path, capsys):
    """A checksum-less snapshot exits 3 (nothing verified), never 0."""
    path = str(tmp_path / "s")
    with override_checksum_disabled(True):
        Snapshot.take(path, {"app": StateDict(w=torch.arange(64, dtype=torch.float32))})
    assert main(["verify", path]) == 3
    assert "nothing verified" in capsys.readouterr().err
    good = str(tmp_path / "g")
    Snapshot.take(good, {"app": StateDict(w=torch.arange(64, dtype=torch.float32))})
    assert main(["verify", good]) == 0


def test_diff_snapshots(tmp_path, capsys):
    """The CLI half of the diff tests: same content in another layout
    exits 0, a changed, added and removed entry exits 2 (-q)."""
    st = _state()
    a, b, c = str(tmp_path / "a"), str(tmp_path / "b"), str(tmp_path / "c")
    with override_batching_disabled(True):
        Snapshot.take(a, {"app": st})
    Snapshot.take(b, {"app": st}, incremental_from=a)
    st2 = _state()
    st2["dense"] = st2["dense"] + 1.0
    del st2["small"]
    st2["extra"] = torch.ones(8)
    with override_batching_disabled(True):
        Snapshot.take(c, {"app": st2})
    assert main(["diff", a, b]) == 0
    assert "0 changed" in capsys.readouterr().out
    assert main(["diff", "-q", a, c]) == 2
    assert "1 changed, 1 added, 1 removed" in capsys.readouterr().out


def test_diff_undecidable_cases(tmp_path, capsys):
    """Checksum-less snapshots diff as undecidable: exit 3."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    with override_checksum_disabled(True):
        Snapshot.take(a, {"app": _state()})
        Snapshot.take(b, {"app": _state()})
    assert main(["diff", "-q", a, b]) == 3


# -------------------------------------------------------- incremental


def _increment(tmp_path, base_name="s0", inc_name="s1"):
    base, inc = str(tmp_path / base_name), str(tmp_path / inc_name)
    with override_batching_disabled(True):
        Snapshot.take(base, {"app": _state()})
        Snapshot.take(inc, {"app": _state()}, incremental_from=base)
    return base, inc


def test_cli_info_reports_external_refs(tmp_path, capsys):
    base, inc = _increment(tmp_path)
    assert main(["info", inc]) == 0
    out = capsys.readouterr().out
    assert "external:" in out and "s0" in out
    assert main(["info", base]) == 0
    assert "external:" not in capsys.readouterr().out


def test_cli_info_numeric_base_name(tmp_path, capsys):
    """Bases named by a bare step number display correctly."""
    _, inc = _increment(tmp_path, "1000", "1100")
    assert main(["info", inc]) == 0
    assert "../1000" in capsys.readouterr().out


def test_cli_materialize(tmp_path, capsys):
    _, inc = _increment(tmp_path)
    assert main(["materialize", inc]) == 0
    assert "self-contained" in capsys.readouterr().out
    assert main(["info", inc]) == 0
    assert "external:" not in capsys.readouterr().out


def test_cli_retain(tmp_path, capsys):
    root = str(tmp_path / "root")
    frozen = torch.from_numpy(
        np.random.default_rng(0).standard_normal((512, 64)).astype(np.float32)
    )
    prev = None
    with override_batching_disabled(True):
        for i in range(3):
            path = os.path.join(root, f"s{i}")
            Snapshot.take(
                path,
                {"app": StateDict(frozen=frozen, hot=torch.full((64,), float(i)), step=i)},
                incremental_from=prev,
            )
            prev = path
    assert main(["retain", root, "--keep", "1", "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "would delete" in out and "s0" in out
    assert sorted(os.listdir(root)) == ["s0", "s1", "s2"]
    assert main(["retain", root, "--keep", "1"]) == 0
    assert "deleted" in capsys.readouterr().out
    assert sorted(os.listdir(root)) == ["s2"]
    target = {"app": StateDict(frozen=torch.zeros(512, 64), hot=torch.zeros(64), step=0)}
    Snapshot(os.path.join(root, "s2")).restore(target)
    assert torch.equal(target["app"]["frozen"], frozen)


# ----------------------------------------------------------- compress


def test_decision_and_ratio_ride_summary_history_and_prom(tmp_path):
    """The compress decision and the codec counters land in the take
    summary, the history event and the Prometheus textfile."""
    from tpusnap_torch.history import event_from_summary
    from tpusnap_torch.metrics_export import PrometheusTextfileSink, parse_prometheus_textfile

    # bf16-precision f32 values: the shuffle filter's favourite shape.
    a = torch.from_numpy(
        np.random.default_rng(14).standard_normal((2048, 256)).astype(np.float32)
    ).to(torch.bfloat16).to(torch.float32)
    path = str(tmp_path / "snap")
    with override_compress(mode="on", min_blob_bytes=65536), override_batching_disabled(True):
        Snapshot.take(path, {"app": StateDict(w=a.clone())})
    summary = telemetry.LAST_TAKE_SUMMARY
    comp = summary.get("compress")
    assert comp and comp["decision"] == "compress" and comp["codec_gbps"] > 0
    counters = summary["counters"]
    nbytes = a.numel() * 4
    assert counters["compress.bytes_in"] == nbytes
    assert 0 < counters["compress.bytes_out"] < nbytes
    assert summary["stages"]["compress"]["count"] == 1
    ev = event_from_summary("take", summary)
    assert ev["compress_decision"] == "compress" and ev["compress_ratio"] > 1.2
    assert ev["compress_codec_gbps"] > 0
    assert ev["compress_bytes_out"] == counters["compress.bytes_out"]
    sink = PrometheusTextfileSink(directory=str(tmp_path / "prom"))
    sink.on_take_summary(summary)
    prom = os.path.join(
        str(tmp_path / "prom"), f"tpusnap_{knobs.get_job_id()}_rank{summary['rank']}.prom"
    )
    families = parse_prometheus_textfile(open(prom).read())
    assert families["tpusnap_compress_bytes_in_total"]["samples"]
    assert families["tpusnap_compress_bytes_out_total"]["samples"]
    rollup = (Snapshot(path).metadata.extras or {}).get("telemetry", {})
    assert rollup.get("counters", {}).get("compress.bytes_in") == nbytes


def test_analyze_attributes_compress_as_own_resource():
    from tpusnap_torch.analyze import ADVICE, WORK_PRIORITY, classify_span

    assert classify_span("compress") == "compress"
    assert "compress" in WORK_PRIORITY
    assert "TPUSNAP_COMPRESS" in ADVICE["compress"]
    assert "TPUSNAP_COMPRESS" in ADVICE["storage_write"]


# ------------------------------------------------------------ tiering


def _tier_url(tmp_path, name="snap"):
    cache = os.path.join(str(tmp_path), "cache")
    remote_root = os.path.join(str(tmp_path), "remote")
    return f"tier+local={cache}+remote=fs://{remote_root}/{name}"


def test_slo_check_ignores_stale_degraded_flag(tmp_path, capsys):
    """A dead uploader's last degraded status older than the freshness
    window is shown, not gated; a fresh one gates."""
    tele = os.environ["TPUSNAP_TELEMETRY_DIR"]
    os.makedirs(os.path.join(tele, "slo"), exist_ok=True)
    with open(os.path.join(tele, "slo", "rank_0.json"), "w") as f:
        json.dump(
            {"v": 1, "rank": 0, "world_size": 1, "ts": time.time(),
             "started_ts": time.time() - 10, "last_commit_ts": time.time() - 1,
             "data_at_risk_bytes": 0, "final": True},
            f,
        )
    os.makedirs(os.path.join(tele, "tier"), exist_ok=True)
    stale = {"state": "degraded", "degraded": True, "lag_bytes": 999,
             "lag_seconds": 5000.0, "remote": "s3://b/x", "ts": time.time() - 86400}
    with open(os.path.join(tele, "tier", "status.json"), "w") as f:
        json.dump(stale, f)
    assert main(["slo", "--check", "--rpo", "3600"]) == 0
    stale["ts"] = time.time()
    with open(os.path.join(tele, "tier", "status.json"), "w") as f:
        json.dump(stale, f)
    assert main(["slo", "--check", "--rpo", "3600"]) == 2
    capsys.readouterr()


def test_drain_cli_exit_contract(tmp_path, capsys):
    from tpusnap_torch.tiering import parse_tier_url

    url = _tier_url(tmp_path)
    Snapshot.take(url, _tensors())
    local_dir = parse_tier_url(url).local_dir
    assert main(["drain", local_dir, "--status"]) == 2  # tiered, not durable
    assert "local-committed" in capsys.readouterr().out
    assert main(["drain", local_dir]) == 0
    assert "durable" in capsys.readouterr().out
    assert main(["drain", local_dir, "--status", "--json"]) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["durability"] == "remote-durable" and st["lag_bytes"] == 0
    assert main(["drain", str(tmp_path / "not_tiered")]) == 3


def test_fsck_cli_shows_durability(tmp_path, capsys):
    from tpusnap_torch.tiering import drain_snapshot, parse_tier_url

    url = _tier_url(tmp_path)
    Snapshot.take(url, _tensors())
    local_dir = parse_tier_url(url).local_dir
    assert main(["fsck", local_dir]) == 0
    assert "local-committed" in capsys.readouterr().out
    drain_snapshot(url)
    assert main(["fsck", local_dir]) == 0
    assert "remote-durable" in capsys.readouterr().out


def _restore_events(n, plugin, gbps):
    return [
        {"kind": "restore", "rank": 0, "bytes": 1_000_000_000, "wall_s": 1.0 / gbps,
         "plugin": plugin, "phases_s": {"restore.read": 1.0 / gbps}}
        for _ in range(n)
    ]


def test_estimate_rto_backend_filter():
    from tpusnap_torch.slo import estimate_rto

    events = _restore_events(5, "FSStoragePlugin", 4.0) + _restore_events(
        5, "S3StoragePlugin", 0.25
    )
    local = estimate_rto(10_000_000_000, events, backend="FSStoragePlugin")
    remote = estimate_rto(10_000_000_000, events, backend="S3StoragePlugin")
    assert local.ok and remote.ok and remote.seconds > local.seconds * 10
    missing = estimate_rto(1, events, backend="GCSStoragePlugin")
    assert not missing.ok and "GCSStoragePlugin" in missing.reason


def test_restore_history_event_carries_plugin_label(tmp_path, monkeypatch):
    from tpusnap_torch.history import load_history

    monkeypatch.setenv("TPUSNAP_HISTORY", "1")
    path = str(tmp_path / "plain")
    state = _tensors()
    Snapshot.take(path, state)
    Snapshot(path).restore(
        {"m": StateDict(**{k: torch.zeros_like(v) for k, v in state["m"].items()})}
    )
    events = [e for e in load_history() if e.get("kind") == "restore" and e.get("path") == path]
    assert events and events[-1].get("plugin") == "FSStoragePlugin"


def test_prom_sink_exports_tier_gauges_and_exhausted_family(tmp_path):
    from tpusnap_torch.metrics_export import PrometheusTextfileSink, parse_prometheus_textfile

    sink = PrometheusTextfileSink(str(tmp_path / "prom"))
    sink.on_tier_update(
        {"state": "degraded", "lag_bytes": 12345, "lag_seconds": 6.5, "degraded": True}
    )
    telemetry.incr("retry.exhausted.write")
    metrics = parse_prometheus_textfile(sink.render())
    assert metrics["tpusnap_upload_lag_bytes"]["samples"] == {
        f'{{job="{knobs.get_job_id()}",rank="0"}}': 12345.0
    }
    assert list(metrics["tpusnap_upload_lag_seconds"]["samples"].values()) == [6.5]
    assert list(metrics["tpusnap_tier_degraded"]["samples"].values()) == [1.0]
    assert any("exhausted.write" in labels for labels in metrics["tpusnap_retry_total"]["samples"])


# ---------------------------------------------------------------- CAS


def _mk_store(root: str) -> str:
    from tpusnap_torch.cas import BLOBS_DIR, INTENTS_DIR, ROOTS_DIR

    for d in (BLOBS_DIR, INTENTS_DIR, ROOTS_DIR):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    return root


def test_cli_gc_store_dry_run_default(tmp_path):
    from tpusnap_torch.cas import blob_key, blob_path
    from tpusnap_torch.lifecycle import dual_hash_evidence

    store = _mk_store(str(tmp_path / "store"))
    data = b"reclaim me"
    key = blob_key(dual_hash_evidence(data))
    with open(os.path.join(store, blob_path(key)), "wb") as f:
        f.write(data)
    old = time.time() - 9999.0
    os.utime(os.path.join(store, blob_path(key)), (old, old))
    assert main(["gc", "--store", store]) == 0
    assert os.path.exists(os.path.join(store, blob_path(key)))  # dry run
    assert main(["gc", "--store", store, "--force"]) == 0
    assert not os.path.exists(os.path.join(store, blob_path(key)))


def test_cli_info_prints_cas_summary(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("TPUSNAP_DISABLE_BATCHING", "1")
    store = str(tmp_path / "store")
    with knobs.override_cas(store):
        Snapshot.take(str(tmp_path / "snap"), _tensors())
        assert main(["info", str(tmp_path / "snap")]) == 0
    out = capsys.readouterr().out
    assert "cas:" in out and "ref(s) into" in out and "deduplicated" in out


def test_dangling_ref_is_the_exit4_state(tmp_path):
    from tpusnap_torch import cas
    from tpusnap_torch.cas import ROOTS_DIR
    from tpusnap_torch.io_types import CAS_REFS_DIR
    from tpusnap_torch.lifecycle import dual_hash_evidence

    store = _mk_store(str(tmp_path / "store"))
    snap = str(tmp_path / "snap")
    os.makedirs(os.path.join(snap, CAS_REFS_DIR))
    triple = dual_hash_evidence(b"vanished content")
    with open(os.path.join(snap, CAS_REFS_DIR, "rank_0.json"), "w") as f:
        json.dump({"version": 1, "store": store, "refs": {"0/w": list(triple)}}, f)
    digest = cas._root_digest(os.path.abspath(snap))
    with open(os.path.join(store, ROOTS_DIR, digest), "w") as f:
        json.dump({"dir": os.path.abspath(snap), "ts": time.time()}, f)
    assert main(["fsck", "--store", store]) == 4
    assert main(["fsck", "--store", str(tmp_path / "nope")]) == 3


# ------------------------------------------------------ delta streams


def test_stream_anchors_slo_tracker(tmp_path):
    from tpusnap_torch import slo

    slo.reset_tracker()
    state = {"app": StateDict(w=torch.zeros(64, 32))}
    s = Snapshot.stream(str(tmp_path / "stream"), state, cadence_s=0.5)
    st = slo.tracker().snapshot_state()
    assert st["stream_cadence_s"] == 0.5 and st["rpo_s"] < 60.0
    state["app"]["w"][0, 0] = 7.0
    s.commit_now()
    st = slo.tracker().snapshot_state()
    assert st["last_commit_take_id"] and st["commit_interval_s"] is not None
    s.close(final_commit=False)
    assert slo.tracker().snapshot_state()["stream_cadence_s"] is None


def test_failed_stream_clears_slo_cadence(tmp_path):
    from tpusnap_torch import slo
    from tpusnap_torch.delta import member_name

    slo.reset_tracker()
    root = str(tmp_path / "stream")
    state = {"app": StateDict(w=torch.zeros(64, 32))}
    s = Snapshot.stream(root, state, cadence_s=3600)
    assert slo.tracker().snapshot_state()["stream_cadence_s"] == 3600
    shutil.rmtree(os.path.join(root, member_name(0)))
    state["app"]["w"][0, 0] = 1.0
    with pytest.raises(Exception):
        s.commit_now()
    s._fail(RuntimeError("boom"), where="test")
    assert slo.tracker().snapshot_state()["stream_cadence_s"] is None
    with pytest.raises(RuntimeError, match="recovery point"):
        s.raise_if_failed()
    s.close(final_commit=False)


def test_resolve_chain_names_torn_tail_and_debris(tmp_path, capsys):
    """The CLI half: a stream root with a torn tail makes ``fsck`` exit 4
    and ``info`` render the chain."""
    from tpusnap_torch.delta import member_name

    root = str(tmp_path / "stream")
    state = {"app": StateDict(w=torch.zeros(64, 32))}
    s = Snapshot.stream(root, state, cadence_s=3600)
    state["app"]["w"][0, 0] = 9.0
    s.commit_now()
    s.close(final_commit=False)
    torn = tmp_path / "stream" / member_name(2) / ".tpusnap"
    torn.mkdir(parents=True)
    (torn / "journal").write_text(json.dumps({
        "take_id": "deadbeef", "world_size": 1, "started_at": 0.0,
        "incremental_from": "../" + member_name(1),
        "stream": {"stream": s.stream_id, "seq": 2, "parent": member_name(1)},
    }))
    junk = tmp_path / "stream" / "delta-000090"
    junk.mkdir()
    (junk / "leftover.blob").write_bytes(b"x" * 32)
    assert main(["fsck", root]) == 4
    assert main(["info", root]) == 0
    out = capsys.readouterr().out
    assert f"HEAD  {member_name(1)}" in out and "torn tail:" in out and "delta-000090" in out


def test_slo_stream_cadence_gate():
    from tpusnap_torch.knobs import override_slo_stream_cadence_x
    from tpusnap_torch.slo import evaluate_records

    now = 1_000_000.0
    rec = {"rank": 0, "world_size": 2, "ts": now - 10.0, "last_commit_ts": now - 10.0,
           "stream_cadence_s": 1.0}
    out = evaluate_records([dict(rec)], now=now)
    assert out["verdict"] == "breach"
    row = out["ranks"][0]
    assert row["breach_stream"] and not row["breach_rpo"]
    assert "cadence" in out["reason"] and out["thresholds"]["stream_cadence_x"] == 3.0
    assert evaluate_records([dict(rec, final=True)], now=now)["verdict"] == "healthy"
    assert evaluate_records([dict(rec, last_commit_ts=now - 2.0)], now=now)["verdict"] == "healthy"
    with override_slo_stream_cadence_x(0.0):
        out = evaluate_records([dict(rec)], now=now)
    assert out["verdict"] == "healthy" and out["thresholds"]["stream_cadence_x"] is None


def test_chain_report_renders_world_and_degraded(capsys):
    from tpusnap_torch.__main__ import _print_chain_report
    from tpusnap_torch.delta import ChainMember, DeltaChainReport

    rep = DeltaChainReport(
        root="/x",
        members=[
            ChainMember(name="base-000000", state="committed", seq=0, stream_id="s",
                        world={"size": 2, "ranks": [0, 1]}),
            ChainMember(name="delta-000001", state="committed", seq=1, parent="base-000000",
                        stream_id="s", world={"size": 1, "ranks": [0], "left": [1]},
                        degraded={"dead_ranks": [1], "live_ranks": [0],
                                  "adopted_units": ["u1", "u2"], "adopters": {"u1": 0}}),
            ChainMember(name="delta-000002", state="torn", seq=2, parent="delta-000001",
                        stream_id="s", world={"size": 2, "ranks": [0, 1]}, missing_ranks=[1]),
        ],
        head="delta-000001",
        torn_tail="delta-000002",
        chain=["delta-000001", "base-000000"],
    )
    _print_chain_report(rep)
    out = capsys.readouterr().out
    assert "world 2 (ranks [0, 1])" in out and "left [1]" in out
    assert "DEGRADED: rank(s) [1] died mid-epoch; 2 unit(s) adopted" in out
    assert "journal evidence missing from global rank(s) [1]" in out


def test_postmortem_renders_left_ranks(capsys):
    from tpusnap_torch.__main__ import _render_verdict

    _render_verdict({"state": "committed", "ranks": {}, "left_ranks": [1], "dead_ranks": None})
    out = capsys.readouterr().out
    assert "LEFT rank(s) [1]" in out and "GRACEFULLY" in out and "DEAD" not in out


# ------------------------------------------------ the rest of the commands


def test_every_subcommand_is_there(capsys):
    from tpusnap.__main__ import main as jax_main

    assert main(["--help"]) == 0
    ours = capsys.readouterr().out
    assert jax_main(["--help"]) == 0
    theirs = capsys.readouterr().out

    def commands(text):
        m = re.search(r"\{([a-z_,]+)\}", text)
        return m.group(1).split(",")

    assert commands(ours) == commands(theirs)
    assert main(["lint", "--check"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_watch_once_tails_a_take_in_flight(tmp_path):
    """``watch --once`` in a subprocess, on a take whose writes are held
    back: it renders the in-flight row and says the metadata is not yet
    written."""
    from tpusnap_torch.storage_plugins import fs as fs_mod

    path = str(tmp_path / "snap")
    gate = threading.Event()
    orig = fs_mod.FSStoragePlugin.write

    async def slow_write(self, write_io):
        import asyncio

        while not gate.is_set():
            await asyncio.sleep(0.02)
        await orig(self, write_io)

    fs_mod.FSStoragePlugin.write = slow_write
    errors = []

    def take():
        try:
            with knobs.override_heartbeat_interval_s(0.05):
                Snapshot.take(path, _tensors(n=2))
        except BaseException as e:  # reported below
            errors.append(e)

    t = threading.Thread(target=take)
    t.start()
    try:
        deadline = time.monotonic() + 60
        while not os.path.isdir(os.path.join(path, ".tpusnap", "progress")):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        time.sleep(0.3)
        proc = subprocess.run(
            [sys.executable, "-m", "tpusnap_torch", "watch", path, "--once"],
            capture_output=True, text=True, timeout=300, cwd=_REPO,
            env={**os.environ, "PYTHONPATH": _REPO},
        )
    finally:
        gate.set()
        fs_mod.FSStoragePlugin.write = orig
        t.join(60)
    assert not errors, errors
    assert proc.returncode == 0, proc.stderr
    assert "running" in proc.stdout
    assert "metadata: not yet written" in proc.stdout


# ------------------------------------------------------ parity with tpusnap


_AGO = re.compile(r"\(\d+s ago\)")


def _run_both(argv, capsys):
    from tpusnap.__main__ import main as jax_main

    out = {}
    for name, fn in (("port", main), ("jax", jax_main)):
        rc = fn(list(argv))
        cap = capsys.readouterr()
        out[name] = (
            rc,
            _AGO.sub("(Ns ago)", cap.out.replace("tpusnap_torch", "tpusnap")),
            cap.err.replace("tpusnap_torch", "tpusnap"),
        )
    return out["port"], out["jax"]


@pytest.fixture
def both_snapshots(tmp_path, monkeypatch):
    """One snapshot of the same numpy values taken by each package (and a
    changed one of each, for diff), with the history of those takes."""
    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import StateDict as JaxStateDict

    monkeypatch.setenv("TPUSNAP_HISTORY", "1")
    monkeypatch.setenv("TPUSNAP_JOB_ID", "parity")
    arrays = _arrays()
    paths = {}
    with override_batching_disabled(True):
        for name, take, wrap in (
            ("jax", JaxSnapshot.take, lambda a: JaxStateDict(**a, step=7)),
            ("port", Snapshot.take,
             lambda a: StateDict(**{k: torch.from_numpy(v) for k, v in a.items()}, step=7)),
        ):
            paths[name] = str(tmp_path / name)
            take(paths[name], {"app": wrap(dict(arrays))})
            changed = dict(arrays, dense=arrays["dense"] + 1.0)
            paths[name + "2"] = str(tmp_path / (name + "2"))
            take(paths[name + "2"], {"app": wrap(changed)})
    return paths


@pytest.mark.parametrize(
    "argv",
    [
        ["info", "{s}"],
        ["ls", "{s}"],
        ["ls", "-l", "-a", "{s}"],
        ["verify", "{s}"],
        ["fsck", "{s}"],
        ["diff", "{s}", "{s2}"],
        ["diff", "-q", "{s}", "{s}"],
        ["trace", "--json", "{s}"],
        ["cat", "{s}", "0/app/small"],
        ["cat", "{s}", "0/app/step"],
        ["history", "--json"],
        ["info", "{missing}"],
    ],
    ids=lambda a: "_".join(x.strip("{}-") for x in a if x not in ("{s}",)),
)
@pytest.mark.parametrize("taker", ["port", "jax"])
def test_read_only_commands_match_tpusnap(both_snapshots, taker, argv, capsys, tmp_path):
    """Both CLIs on the snapshot one package took: same exit code, same
    text. Both packages recorded the same checksum algorithm, so
    ``verify`` and ``diff`` compare real checksums on both sides."""
    paths = both_snapshots
    for name in ("jax", "port"):
        md = json.load(open(os.path.join(paths[name], ".snapshot_metadata")))
        algos = {
            e["checksum"].split(":")[0] for e in md["manifest"].values() if e.get("checksum")
        }
        assert algos == {"crc32c"}, (name, algos)
    fill = {"s": paths[taker], "s2": paths[taker + "2"], "missing": str(tmp_path / "none")}
    argv = [a.format(**fill) for a in argv]
    ours, theirs = _run_both(argv, capsys)
    assert ours == theirs


def test_cat_prints_bf16_as_float32_values(tmp_path, capsys):
    """bfloat16 has no numpy dtype here: the port prints the format's
    dtype string and the values upcast to float32, equal to tpusnap's
    values."""
    from tpusnap import Snapshot as JaxSnapshot

    x = torch.arange(-6, 6, dtype=torch.float32).to(torch.bfloat16) / 4
    path = str(tmp_path / "bf16")
    Snapshot.take(path, {"app": StateDict(x=x)})
    assert main(["cat", path, "0/app/x"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "# bfloat16[12]"
    printed = np.array([float(v) for v in " ".join(lines[1:]).strip("[]").split()])
    jax_values = np.asarray(JaxSnapshot(path).read_object("0/app/x"), dtype=np.float32)
    assert np.array_equal(printed, jax_values)
    assert np.array_equal(printed, x.float().numpy())
