"""The port's flight recorder against tpusnap's: the mirror of
``tests/test_flight.py`` for ``tpusnap_torch``, with tpusnap's
``timeline`` command reading the port's flight logs.

Unit level: ring bounding and eviction accounting, flush throttle and
atomicity, the JSONL reader, barrier-anchored skew estimation and the
post-mortem verdict on synthetic logs (pure math, no sleeps). System
level: a take persists the sidecar inside the snapshot AND the local
TPUSNAP_TELEMETRY_DIR copy, fsck treats it as a legitimate sidecar, the
knob disables the whole layer, an aborted take leaves its forensic
breadcrumb without locking the path, a SIGKILLed take's surviving
sidecar names the in-flight op and last phase, and the CLI honors the
exit contract (0 committed / 4 uncommitted post-mortem / 3 no data).
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpusnap_torch import Snapshot, StateDict
from tpusnap_torch import flight
from tpusnap_torch.flight import (
    FlightRecorder,
    estimate_skew,
    load_flight_logs,
    merge_timeline,
    parse_flight_log,
    postmortem_verdict,
)
from tpusnap_torch.io_types import FLIGHT_DIR
from tpusnap_torch.knobs import (
    override_flight_enabled,
    override_flight_flush_interval_s,
    override_telemetry_dir,
)


def _state(seed=0, n=6):
    return {
        f"w{i}": torch.from_numpy(
            np.random.default_rng(seed * 100 + i).standard_normal((128, 128)).astype(np.float32)
        )
        for i in range(n)
    }


# ------------------------------------------------------------- unit: ring


def test_ring_bounded_and_eviction_counted(tmp_path):
    rec = FlightRecorder(ring_size=8)
    for i in range(20):
        rec.record("ev", op=f"e{i}")
    rec._sidecar_dir = str(tmp_path / "flight")
    assert rec.maybe_flush(force=True)
    doc = parse_flight_log((tmp_path / "flight" / "rank_0.jsonl").read_text())
    assert doc["meta"]["events_total"] == 20
    assert doc["meta"]["dropped"] == 12
    assert [e["op"] for e in doc["events"]] == [f"e{i}" for i in range(12, 20)]


def test_disabled_recorder_records_nothing(tmp_path):
    with override_flight_enabled(False):
        rec = FlightRecorder(ring_size=8)
        rec.record("ev")
        assert rec.events_total == 0
        rec._sidecar_dir = str(tmp_path / "flight")
        assert not rec.maybe_flush(force=True)


def test_flush_throttle_and_force(tmp_path):
    with override_flight_flush_interval_s(3600.0):
        rec = FlightRecorder(ring_size=8)
        rec._flush_interval_s = 3600.0
        rec._sidecar_dir = str(tmp_path / "flight")
        rec.record("a")
        assert rec.maybe_flush()  # first flush always lands
        rec.record("b")
        assert not rec.maybe_flush()  # throttled
        assert rec.maybe_flush(force=True)
        assert rec.flushes == 2


def test_flush_is_atomic_and_reparsable(tmp_path):
    rec = FlightRecorder(ring_size=64)
    rec.record("x", op="y", detail_key=3)
    rec.set_context({"phase": "stage", "op": "storage_write"})
    rec._sidecar_dir = str(tmp_path / "flight")
    rec.maybe_flush(force=True)
    names = os.listdir(tmp_path / "flight")
    assert names == ["rank_0.jsonl"]  # no .tmp debris
    doc = parse_flight_log((tmp_path / "flight" / "rank_0.jsonl").read_text())
    assert doc["meta"]["context"]["phase"] == "stage"
    (ev,) = [e for e in doc["events"] if e["k"] == "x"]
    assert ev["op"] == "y" and ev["detail_key"] == 3
    # Wall mapping: anchors present and self-consistent.
    assert doc["meta"]["wall_anchor"] > 0
    assert doc["meta"]["mono_anchor"] <= ev["t"]


def test_parse_tolerates_garbage_lines():
    text = '{"k":"meta","rank":1}\nnot json\n[]\n{"t":1.0,"k":"ev"}\n'
    doc = parse_flight_log(text)
    assert doc["meta"]["rank"] == 1
    assert len(doc["events"]) == 1
    assert parse_flight_log("") is None


# ------------------------------------------------- unit: skew + timeline


def _mk_log(rank, wall_anchor, events, context=None, world_size=2):
    return {
        "meta": {
            "rank": rank,
            "wall_anchor": wall_anchor,
            "mono_anchor": 0.0,
            "world_size": world_size,
            "flush_mono": max((e["t"] for e in events), default=0.0),
            "context": context or {},
            "take_id": "deadbeef",
        },
        "events": events,
    }


def test_skew_estimated_from_shared_barrier_anchors():
    # Rank 1's wall clock runs 5 s ahead; both ranks saw two barrier
    # releases at the same true instants.
    logs = {
        0: _mk_log(0, 1000.0, [
            {"t": 1.0, "k": "barrier_exit", "op": "ns/b1"},
            {"t": 2.0, "k": "barrier_exit", "op": "ns/b2"},
            {"t": 2.5, "k": "op_begin", "op": "storage_write"},
        ]),
        1: _mk_log(1, 1005.0, [
            {"t": 1.0, "k": "barrier_exit", "op": "ns/b1"},
            {"t": 2.0, "k": "barrier_exit", "op": "ns/b2"},
            {"t": 1.5, "k": "op_begin", "op": "dtoh"},
        ]),
    }
    skew = estimate_skew(logs)
    assert skew[0]["anchors"] is None  # the reference rank
    assert skew[1]["anchors"] == 2
    assert skew[1]["offset_s"] == pytest.approx(-5.0)
    assert skew[1]["bound_s"] == pytest.approx(0.0)
    merged = merge_timeline(logs, skew)
    # After alignment rank 1's dtoh (true t=1.5) sorts between the two
    # barrier releases despite its +5 s wall clock.
    kinds = [(e["rank"], e["op"]) for e in merged]
    assert kinds.index((1, "dtoh")) < kinds.index((0, "ns/b2"))
    assert kinds.index((0, "ns/b1")) < kinds.index((1, "dtoh"))


def test_skew_bound_reflects_anchor_jitter():
    logs = {
        0: _mk_log(0, 1000.0, [
            {"t": 1.0, "k": "barrier_exit", "op": "b1"},
            {"t": 2.0, "k": "barrier_exit", "op": "b2"},
            {"t": 3.0, "k": "barrier_exit", "op": "b3"},
        ]),
        1: _mk_log(1, 1000.0, [
            {"t": 1.0, "k": "barrier_exit", "op": "b1"},
            {"t": 2.04, "k": "barrier_exit", "op": "b2"},
            {"t": 2.96, "k": "barrier_exit", "op": "b3"},
        ]),
    }
    skew = estimate_skew(logs)
    assert abs(skew[1]["offset_s"]) <= 0.04
    assert 0.03 <= skew[1]["bound_s"] <= 0.09


def test_skew_without_shared_anchors_is_zero_offset():
    logs = {
        0: _mk_log(0, 1000.0, [{"t": 1.0, "k": "phase", "op": "plan"}]),
        1: _mk_log(1, 1003.0, [{"t": 1.0, "k": "phase", "op": "plan"}]),
    }
    skew = estimate_skew(logs)
    assert skew[1] == {"offset_s": 0.0, "bound_s": None, "anchors": 0}


def test_postmortem_verdict_fields_and_missing_ranks():
    logs = {
        0: _mk_log(
            0,
            1000.0,
            [
                {"t": 1.0, "k": "op_begin", "op": "storage_write"},
                {"t": 1.2, "k": "stall", "op": "storage_write"},
            ],
            context={
                "phase": "stage",
                "op": "storage_write",
                "ops": ["storage_write", "dtoh"],
                "bytes_planned": 100,
                "bytes_written": 25,
                "bytes_staged": 50,
                "percent": 25.0,
            },
            world_size=3,
        )
    }
    v = postmortem_verdict(
        "/p", "torn", logs, journal_evidence={0: {"blobs_completed": 2,
                                                 "bytes_completed": 25}}
    )
    assert v["world_size"] == 3
    assert v["missing_ranks"] == [1, 2]
    r = v["ranks"][0]
    assert r["phase"] == "stage"
    assert r["inflight_op"] == "storage_write"
    assert r["bytes_written"] == 25 and r["bytes_planned"] == 100
    assert r["journal"]["blobs_completed"] == 2
    assert r["stall_episodes"] == 1
    assert v["stall_episodes"] == 1
    assert r["last_event"]["k"] == "stall"
    assert r["last_event"]["flush_age_s"] == pytest.approx(0.0)


# --------------------------------------------------------------- system


def _timeline(path, *extra):
    return subprocess.run(
        [sys.executable, "-m", "tpusnap", "timeline", path, *extra],
        capture_output=True,
        text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )


def test_take_persists_flight_sidecar_and_local_copy(tmp_path):
    path = str(tmp_path / "snap")
    tdir = str(tmp_path / "tele")
    with override_telemetry_dir(tdir):
        Snapshot.take(path, {"app": StateDict(**_state())})
        sidecar = os.path.join(path, FLIGHT_DIR, "rank_0.jsonl")
        assert os.path.exists(sidecar)
        doc = parse_flight_log(open(sidecar).read())
        kinds = {e["k"] for e in doc["events"]}
        # Span open/close, phase transitions, journal evidence and the
        # terminal event are all on the record.
        assert {"phase", "op_begin", "op_end", "take_end"} <= kinds
        assert doc["meta"]["context"]["state"] == "committed"
        # The local copy exists and holds the same take.
        copy_dir = flight.local_flight_dir(path)
        assert os.path.exists(os.path.join(copy_dir, "rank_0.jsonl"))
    # fsck: the sidecar is legitimate — committed, no orphans.
    from tpusnap_torch.lifecycle import fsck_snapshot

    report = fsck_snapshot(path)
    assert report.state == "committed"
    assert not report.orphans


def test_flight_knob_off_leaves_no_sidecar(tmp_path):
    path = str(tmp_path / "snap")
    with override_flight_enabled(False):
        Snapshot.take(path, {"app": StateDict(**_state())})
    assert not os.path.exists(os.path.join(path, FLIGHT_DIR))


def test_timeline_cli_committed_exit0(tmp_path):
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"app": StateDict(**_state())})
    r = _timeline(path)
    assert r.returncode == 0, r.stderr
    assert "state:  committed" in r.stdout
    assert "op_begin" in r.stdout
    # --json is machine-parseable and carries the same events.
    rj = _timeline(path, "--json", "--last", "5")
    assert rj.returncode == 0
    doc = json.loads(rj.stdout)
    assert doc["state"] == "committed" and len(doc["events"]) == 5
    # --rank filters display (single-rank: everything stays).
    rr = _timeline(path, "--rank", "0", "--last", "3")
    assert rr.returncode == 0


def test_timeline_filters_stale_sidecars_from_previous_take(tmp_path):
    """A retake overwrites only the ranks it runs: sidecars left by a
    WIDER previous take to the same path must not merge into the
    current take's timeline (their recurring barrier anchor strings
    would also poison the skew estimate)."""
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"app": StateDict(**_state())})
    stale = (
        json.dumps(
            {
                "k": "meta",
                "v": 1,
                "rank": 3,
                "take_id": "00000000previous0000000000000000",
                "world_size": 4,
                "wall_anchor": 1.0,
                "mono_anchor": 0.0,
                "context": {"state": "running"},
            }
        )
        + "\n"
        + json.dumps({"t": 1.0, "k": "phase", "op": "plan"})
        + "\n"
    )
    with open(os.path.join(path, FLIGHT_DIR, "rank_3.jsonl"), "w") as f:
        f.write(stale)
    r = _timeline(path, "--json")
    assert r.returncode == 0, r.stderr
    doc = json.loads(r.stdout)
    assert doc["ranks"] == [0], doc["ranks"]


def test_timeline_cli_no_flight_data_exit3(tmp_path):
    r = _timeline(str(tmp_path))
    assert r.returncode == 3
    assert "no flight data" in r.stderr


def test_aborted_take_leaves_breadcrumb_path_stays_reusable(
    tmp_path, monkeypatch
):
    import tpusnap_torch.storage_plugins.fs as fs_mod
    from tpusnap_torch.lifecycle import fsck_snapshot

    path = str(tmp_path / "snap")
    orig_write = fs_mod.FSStoragePlugin.write

    async def bad_write(self, write_io):
        raise RuntimeError("injected fatal write")

    monkeypatch.setattr(fs_mod.FSStoragePlugin, "write", bad_write)
    with pytest.raises(RuntimeError, match="injected fatal write"):
        Snapshot.take(path, {"app": StateDict(**_state())})
    monkeypatch.setattr(fs_mod.FSStoragePlugin, "write", orig_write)
    # The abort cleaned blobs + journal but left the black box: the
    # path classifies empty (reusable), and the breadcrumb names the
    # aborted state.
    report = fsck_snapshot(path)
    assert report.state == "empty", report.summary()
    sidecar = os.path.join(path, FLIGHT_DIR, "rank_0.jsonl")
    assert os.path.exists(sidecar)
    doc = parse_flight_log(open(sidecar).read())
    assert doc["meta"]["context"]["state"] == "aborted"
    assert any(e["k"] == "abort" for e in doc["events"])
    # timeline reports the post-mortem for the uncommitted path.
    r = _timeline(path)
    assert r.returncode == 4
    assert "POST-MORTEM" in r.stdout and "state=aborted" in r.stdout
    # Path stays reusable.
    Snapshot.take(path, {"app": StateDict(**_state())})
    assert fsck_snapshot(path).state == "committed"


_KILL_CHILD = r"""
import os, sys
import numpy as np
import torch
from tpusnap_torch import Snapshot, StateDict

path = sys.argv[1]
os.environ["TPUSNAP_DISABLE_BATCHING"] = "1"
# Tight flush cadence (the loss bound under test) + slowed writes so the
# kill lands with storage_write provably in flight at the last flush.
os.environ["TPUSNAP_HEARTBEAT_INTERVAL_S"] = "0.05"
os.environ["TPUSNAP_FAULT_SPEC"] = "latency_ms=400,crash_after_op=write:4"
state = {
    f"w{i}": torch.from_numpy(np.random.default_rng(i).standard_normal((128, 128))
    .astype(np.float32))
    for i in range(8)
}
Snapshot.take("chaos+fs://" + path, {"app": StateDict(**state)})
print("UNEXPECTED_COMPLETION", flush=True)
"""


def test_sigkill_mid_take_timeline_names_inflight_op(tmp_path):
    path = str(tmp_path / "snap")
    r = subprocess.run(
        [sys.executable, "-c", _KILL_CHILD, path],
        capture_output=True,
        text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        timeout=150,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == -signal.SIGKILL, r.stdout[-2000:]
    t = _timeline(path, "--json")
    assert t.returncode == 4, (t.returncode, t.stderr)
    doc = json.loads(t.stdout)
    assert doc["state"] == "torn"
    verdict = doc["verdict"]
    r0 = verdict["ranks"]["0"]
    # The surviving sidecar names what rank 0 was doing when it died:
    # a completed phase and the op(s) in flight at the last flush.
    assert r0["phase"] is not None
    assert r0["inflight_op"] == "storage_write" or (
        r0["inflight_ops"] and "storage_write" in r0["inflight_ops"]
    ), r0
    assert r0["bytes_planned"] > 0
    assert r0["bytes_written"] > 0  # flushed context saw real progress
    # journal.d evidence channel is wired (the count itself races the
    # kill: record flushes are coalesced and draw the same injected
    # latency as the blob writes they witness).
    assert "journal" in r0, r0
    assert verdict["missing_ranks"] == []
    # analyze folds the same verdict on a torn path.
    a = subprocess.run(
        [sys.executable, "-m", "tpusnap", "analyze", path],
        capture_output=True,
        text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert a.returncode == 4
    assert "POST-MORTEM" in a.stdout and "storage_write" in a.stdout


def _world_flight_take(snap_dir):
    """2-rank take: both ranks' flight logs land, share barrier anchors,
    and the merged timeline covers both."""
    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.comm import get_communicator
    from tpusnap_torch.flight import estimate_skew, load_flight_logs

    comm = get_communicator()
    state = {f"w{i}": torch.full((2048,), float(i)) for i in range(4)}
    Snapshot.take(snap_dir, {"app": StateDict(**state)})
    comm.barrier()
    if comm.rank == 0:
        logs = load_flight_logs(snap_dir)
        assert sorted(logs) == [0, 1], sorted(logs)
        skew = estimate_skew(logs)
        assert skew[1]["anchors"] and skew[1]["anchors"] >= 1, skew
        assert skew[1]["bound_s"] is not None
        print(f"FLIGHT_OK anchors={skew[1]['anchors']}", flush=True)


def test_two_rank_flight_logs_share_barrier_anchors(tmp_path):
    from tpusnap_torch.test_utils import run_subprocess_world

    outs = run_subprocess_world(
        _world_flight_take,
        world_size=2,
        args=[str(tmp_path / "snap")],
        timeout=150,
    )
    assert any("FLIGHT_OK" in o for o in outs), outs
