"""The port's live observability against tpusnap's: the mirror of
``tests/test_progress.py`` for ``tpusnap_torch``. Heartbeat throttling
and the stall watchdog on a fake clock (no sleeps), straggler skew math,
the `stall` fault kind, tpusnap's `watch` command against an in-flight
port take, restore traces read by tpusnap's `trace --restore`, and the
2-process stall attribution; then the pump's own store client: heartbeats
keep advancing while the take's thread waits in a barrier.
"""

import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpusnap_torch import FaultPlan, PytreeState, Snapshot
from tpusnap_torch import telemetry
from tpusnap_torch.dist_store import MemoryKVStore
from tpusnap_torch.knobs import override_telemetry_dir, override_telemetry_enabled
from tpusnap_torch.progress import (
    PROGRESS_DIR,
    ProgressMonitor,
    local_root_of,
    read_progress_records,
    restore_trace_dir,
)
from tpusnap_torch.telemetry import TakeTelemetry, rollup_summaries

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _monitor(rec, tmp_path, clk, **kw):
    kw.setdefault("interval_s", 1.0)
    kw.setdefault("stall_deadline_s", 5.0)
    return ProgressMonitor(
        rec,
        rank=kw.pop("rank", 0),
        world_size=kw.pop("world_size", 1),
        take_id="t0",
        kv=kw.pop("kv", MemoryKVStore()),
        local_dir=str(tmp_path),
        clock=clk,
        wall_clock=lambda: 1_000_000.0,
        thread=False,
        **kw,
    )


# ------------------------------------------------- heartbeat throttling


def test_heartbeat_time_and_delta_throttled(tmp_path):
    rec = TakeTelemetry(rank=0, enabled=True)
    clk = FakeClock()
    mon = _monitor(rec, tmp_path, clk)
    mon.set_bytes_planned(100)

    mon.tick()  # first observation publishes immediately
    assert mon.published == 1
    mon.tick()  # nothing changed, interval not elapsed
    assert mon.published == 1
    clk.t += 1.5
    mon.tick()  # interval elapsed but NOTHING changed: delta throttle
    assert mon.published == 1
    telemetry.incr("storage.bytes_written", 60, rec=rec)
    mon.tick()  # changed + due -> publish
    assert mon.published == 2
    telemetry.incr("storage.bytes_written", 40, rec=rec)
    mon.tick()  # changed but within the interval: time throttle
    assert mon.published == 2
    clk.t += 1.1
    mon.tick()
    assert mon.published == 3
    # Keep-alive: with no change at all, a record still goes out every
    # 10 intervals so watchers can tell idle-alive from dead.
    clk.t += 10.1
    mon.tick()
    assert mon.published == 4
    rec.finalize()


def test_heartbeat_record_contents_and_final_commit(tmp_path):
    rec = TakeTelemetry(rank=3, enabled=True)
    clk = FakeClock()
    kv = MemoryKVStore()
    mon = _monitor(rec, tmp_path, clk, rank=3, world_size=4, kv=kv)
    mon.set_bytes_planned(200)
    telemetry.incr("storage.bytes_written", 50, rec=rec)
    mon.tick()
    recs = read_progress_records(str(tmp_path))
    assert len(recs) == 1
    r = recs[0]
    assert r["rank"] == 3 and r["state"] == "running"
    assert r["bytes_planned"] == 200 and r["bytes_written"] == 50
    assert r["percent"] == 25.0
    assert kv.try_get("tpusnap_progress/t0/3") is not None
    # finish(committed) forces 100% and a terminal state.
    mon.finish("committed")
    r = read_progress_records(str(tmp_path))[0]
    assert r["state"] == "committed" and r["percent"] == 100.0
    rec.finalize()


def test_heartbeat_aborted_cleans_own_kv_key(tmp_path):
    rec = TakeTelemetry(rank=1, enabled=True)
    kv = MemoryKVStore()
    mon = _monitor(rec, tmp_path, FakeClock(), rank=1, kv=kv)
    mon.tick()
    assert kv.try_get("tpusnap_progress/t0/1") is not None
    mon.finish("aborted")
    assert kv.try_get("tpusnap_progress/t0/1") is None
    assert read_progress_records(str(tmp_path))[0]["state"] == "aborted"
    rec.finalize()


# --------------------------------------------------------- stall watchdog


def test_watchdog_fires_once_per_episode(tmp_path, caplog):
    rec = TakeTelemetry(rank=0, enabled=True)
    clk = FakeClock()
    mon = _monitor(rec, tmp_path, clk, stall_deadline_s=5.0)
    token = rec.op_enter("storage_write")
    with caplog.at_level(logging.WARNING, logger="tpusnap_torch.progress"):
        mon.tick()  # baseline signature
        clk.t += 6.0
        mon.tick()
        stalls = [r for r in caplog.records if hasattr(r, "tpusnap_stall")]
        assert len(stalls) == 1
        info = stalls[0].tpusnap_stall
        assert info["op"] == "storage_write"
        assert info["rank"] == 0
        assert info["stalled_s"] >= 5.0
        assert info["missing_ranks"] is None
        # Still stalled: NO second warning for the same episode.
        clk.t += 6.0
        mon.tick()
        assert (
            len([r for r in caplog.records if hasattr(r, "tpusnap_stall")])
            == 1
        )
        # Forward progress resets the episode; a NEW stall warns again.
        rec.record_span("x", 0.0, 0.01)
        mon.tick()
        clk.t += 6.0
        mon.tick()
        assert (
            len([r for r in caplog.records if hasattr(r, "tpusnap_stall")])
            == 2
        )
    rec.op_exit(token)
    rec.finalize()


def test_watchdog_requires_inflight_op(tmp_path, caplog):
    rec = TakeTelemetry(rank=0, enabled=True)
    clk = FakeClock()
    mon = _monitor(rec, tmp_path, clk, stall_deadline_s=5.0)
    with caplog.at_level(logging.WARNING, logger="tpusnap_torch.progress"):
        mon.tick()
        clk.t += 60.0
        mon.tick()  # no op in flight: idle, not stalled
    assert not [r for r in caplog.records if hasattr(r, "tpusnap_stall")]
    rec.finalize()


def test_watchdog_names_missing_ranks(tmp_path, caplog):
    rec = TakeTelemetry(rank=0, enabled=True)
    clk = FakeClock()
    mon = _monitor(rec, tmp_path, clk, stall_deadline_s=5.0, world_size=4)
    mon.add_attribution(lambda: [2, 3])
    token = rec.op_enter("comm.barrier")
    with caplog.at_level(logging.WARNING, logger="tpusnap_torch.progress"):
        mon.tick()
        clk.t += 6.0
        mon.tick()
    stalls = [r for r in caplog.records if hasattr(r, "tpusnap_stall")]
    assert len(stalls) == 1
    assert stalls[0].tpusnap_stall["missing_ranks"] == [2, 3]
    assert stalls[0].tpusnap_stall["op"] == "comm.barrier"
    assert "[2, 3]" in stalls[0].getMessage()
    rec.op_exit(token)
    rec.finalize()


# ------------------------------------------------------------- skew math


def test_rollup_phase_skew_and_max_rank():
    a = {
        "rank": 0,
        "take_wall_s": 1.0,
        "phase_coverage": 0.95,
        "phases": {"stage": 0.2, "io_drain": 0.1},
        "stages": {"storage_write": {"count": 1, "total_s": 0.1, "p50_s": 0.1, "max_s": 0.1}},
    }
    b = {
        "rank": 1,
        "take_wall_s": 2.0,
        "phase_coverage": 0.95,
        "phases": {"stage": 0.2, "io_drain": 0.9},
        "stages": {"storage_write": {"count": 1, "total_s": 0.8, "p50_s": 0.8, "max_s": 0.8}},
    }
    r = rollup_summaries([a, b])
    assert r["stages"]["storage_write"]["max_rank"] == 1
    skew = r["phase_skew"]["io_drain"]
    assert skew["max_rank"] == 1
    assert skew["max_s"] == pytest.approx(0.9)
    assert skew["skew"] == pytest.approx(0.9 / 0.9)  # p50 of [0.1, 0.9] -> 0.9
    assert r["phase_skew"]["stage"]["skew"] == pytest.approx(1.0)


# ---------------------------------------------------------- path helpers


def test_local_root_of():
    assert local_root_of("/tmp/x/snap") == "/tmp/x/snap"
    assert local_root_of("file:///tmp/x") == "/tmp/x"
    assert local_root_of("chaos+fs:///tmp/x") == "/tmp/x"
    assert local_root_of("s3://bucket/key") is None
    assert local_root_of("chaos+s3://bucket/key") is None


def test_restore_trace_dir_spelling_invariant():
    """Every spelling of the same local destination digests to the same
    trace dir — a restore via 'file://...' must be findable by
    `trace --restore /plain/path` (and vice versa)."""
    plain = restore_trace_dir("/tmp/x/snap")
    assert restore_trace_dir("file:///tmp/x/snap") == plain
    assert restore_trace_dir("chaos+fs:///tmp/x/snap") == plain
    assert restore_trace_dir("/tmp/x/snap/") == plain
    assert restore_trace_dir("s3://b/snap") != plain


# ------------------------------------------------------- stall fault kind


def test_stall_fault_spec_parse():
    assert FaultPlan.from_spec("stall_op=write:2:1.5").stall_op == ("write", 2, 1.5)
    assert FaultPlan.from_spec("stall_op=read:*:0.5").stall_op == ("read", 0, 0.5)
    with pytest.raises(ValueError):
        FaultPlan.from_spec("stall_nope=1")


def test_stall_fault_injects_in_op_sleep(tmp_path):
    telemetry.reset_global_counters()
    path = str(tmp_path / "snap")
    snap = Snapshot.take(
        "chaos+fs://" + path,
        {"m": PytreeState({"w": torch.ones(2048)})},
        storage_options={"fault_plan": FaultPlan(stall_op=("write", 1, 0.15))},
    )
    assert telemetry.counter_value("faults.stalled.write") == 1
    assert snap.verify().clean


# ------------------------------------------------ take heartbeat records


def test_take_heartbeat_reaches_100_at_commit(tmp_path):
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": PytreeState({"w": torch.ones(4096)})})
    recs = read_progress_records(path)
    assert len(recs) == 1
    assert recs[0]["state"] == "committed"
    assert recs[0]["percent"] == 100.0
    assert recs[0]["phase"] is not None


def test_telemetry_off_skips_heartbeats_entirely(tmp_path):
    path = str(tmp_path / "snap")
    with override_telemetry_enabled(False):
        Snapshot.take(path, {"m": PytreeState({"w": torch.ones(1024)})})
    assert not os.path.exists(os.path.join(path, PROGRESS_DIR))


def test_aborted_take_publishes_aborted_record(tmp_path):
    path = str(tmp_path / "snap")

    class Boom(RuntimeError):
        pass

    class BadState:
        def state_dict(self):
            return {"w": torch.ones(256)}

        def load_state_dict(self, sd):
            pass

    # Fail inside the write pipeline (journal off so the first faulted
    # op is a blob write, after the monitor has started): transients
    # that never converge exhaust the shortened retry deadline.
    from tpusnap_torch.knobs import override_journal_disabled

    with override_journal_disabled(True), pytest.raises(Exception):
        Snapshot.take(
            "chaos+fs://" + path,
            {"m": BadState()},
            storage_options={
                "fault_plan": FaultPlan(transient_per_op=10**6),
                "retry_deadline_sec": 0.3,
                "retry_backoff_base_sec": 0.01,
            },
        )
    recs = read_progress_records(path)
    assert recs and recs[0]["state"] == "aborted"
    # The aborted breadcrumb is observability-only: the path still
    # classifies empty (reusable), not foreign.
    from tpusnap_torch import fsck_snapshot

    assert fsck_snapshot(path).state == "empty"


# ------------------------------------------------------------- watch CLI


def test_watch_once_no_records_exits_3(tmp_path, capsys):
    from tpusnap.__main__ import main

    assert main(["watch", str(tmp_path), "--once"]) == 3
    out = capsys.readouterr().out
    assert "no heartbeat records yet" in out


def test_watch_rejects_non_local_path(capsys):
    from tpusnap.__main__ import main

    assert main(["watch", "s3://bucket/snap", "--once"]) == 1


def test_render_watch_table_flags_stalled(tmp_path):
    """tpusnap's `watch` table renders the port's heartbeat records: a
    rank whose beat went stale is flagged."""
    from tpusnap.progress import render_watch_table

    recs = []
    for rank, age in ((0, 0.1), (1, 42.0)):
        rec = TakeTelemetry(rank=rank, enabled=True)
        clk = FakeClock(100.0)
        mon = _monitor(rec, tmp_path / str(rank), clk, rank=rank, world_size=2)
        mon.tick()
        record = mon._record(clk.t + age, rec.live_snapshot())
        record["beat_age_s"] = age
        recs.append(record)
        rec.finalize()
    frame = render_watch_table(recs, committed=False, stall_flag_s=10.0, now=recs[0]["ts"])
    lines = frame.splitlines()
    assert "STALLED" not in lines[1]
    assert "STALLED" in lines[2]
    assert "not yet written" in frame


def test_watch_live_take_shows_progress_to_100(tmp_path, capsys):
    """Acceptance: `tpusnap watch` against an in-flight (slowed) take in
    a subprocess shows running per-rank progress, then 100% at commit."""
    from tpusnap.__main__ import main

    snap = str(tmp_path / "snap")
    script = (
        "import torch\n"
        "from tpusnap_torch import Snapshot, PytreeState, FaultPlan\n"
        "state = {'w%d' % i: torch.ones(1 << 14) for i in range(8)}\n"
        f"Snapshot.take('chaos+fs://{snap}', {{'m': PytreeState(state)}},\n"
        "              storage_options={'fault_plan': FaultPlan(stall_op=('write', 6, 2.5))})\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(
        {
            "PYTHONPATH": _REPO_ROOT,
            "JAX_PLATFORMS": "cpu",
            "TPUSNAP_HEARTBEAT_INTERVAL_S": "0.05",
            "TPUSNAP_DISABLE_BATCHING": "1",
        }
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", script],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    frames = []
    try:
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            rc = main(["watch", snap, "--json"])
            out = capsys.readouterr().out.strip()
            if rc == 0 and out:
                frame = json.loads(out.splitlines()[-1])
                if frame["records"]:
                    frames.append(frame)
                    if frame["records"][0]["state"] != "running":
                        break
            time.sleep(0.1)
    finally:
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out
    running = [
        f["records"][0] for f in frames if f["records"][0]["state"] == "running"
    ]
    assert running, "watch never observed the take in flight"
    assert any(r["percent"] is not None for r in running)
    final = frames[-1]["records"][0]
    assert final["state"] == "committed"
    assert final["percent"] == 100.0
    assert final["phase"] is not None


# --------------------------------------------------------- restore traces


def test_restore_persists_trace_and_cli(tmp_path, capsys):
    from tpusnap.__main__ import main

    path = str(tmp_path / "snap")
    state = {"w%d" % i: torch.arange(4096, dtype=torch.float32) + i for i in range(4)}
    Snapshot.take(path, {"m": PytreeState(state)})
    with override_telemetry_dir(str(tmp_path / "teledir")):
        target = {
            "w%d" % i: torch.zeros(4096) for i in range(4)
        }
        Snapshot(path).restore({"m": PytreeState(target)})
        assert torch.equal(target["w2"], state["w2"])
        # Acceptance: a rank trace readable by `trace --restore`, with
        # phase spans covering >= 90% of restore wall-clock.
        tf = os.path.join(restore_trace_dir(path), "rank_0.json")
        assert os.path.exists(tf)
        doc = json.load(open(tf))
        assert doc["kind"] == "restore"
        assert doc["summary"]["phase_coverage"] >= 0.9
        for phase in ("restore.plan", "restore.read", "restore.load"):
            assert phase in doc["summary"]["phases"], phase
        assert doc["summary"]["counters"]["storage.bytes_read"] > 0
        assert main(["trace", path, "--restore"]) == 0
        out = capsys.readouterr().out
        assert "restore.read" in out and "phase coverage" in out
        assert main(["trace", path, "--restore", "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["kind"] == "restore"
        assert doc["rollup"]["phase_coverage_min"] >= 0.9


def test_back_to_back_restores_keep_run_scoped_traces(tmp_path):
    """Back-to-back restores of the same snapshot must NOT clobber each
    other's traces: each run writes its own rank_<k>.<run>.json, the
    rank_<k>.json latest-pointer tracks the newest, and retention is
    bounded per digest+rank."""
    from tpusnap_torch.progress import RESTORE_TRACE_KEEP, load_restore_traces

    path = str(tmp_path / "snap")
    state = {"w": torch.arange(4096, dtype=torch.float32)}
    Snapshot.take(path, {"m": PytreeState(state)})
    with override_telemetry_dir(str(tmp_path / "teledir")):
        n_runs = RESTORE_TRACE_KEEP + 2
        for _ in range(n_runs):
            Snapshot(path).restore(
                {"m": PytreeState({"w": torch.zeros(4096)})}
            )
        tdir = restore_trace_dir(path)
        runs = [
            n
            for n in os.listdir(tdir)
            if n.startswith("rank_0.") and n != "rank_0.json"
        ]
        # Every run got its own file, bounded by the retention cap.
        assert len(runs) == RESTORE_TRACE_KEEP, sorted(runs)
        # The latest pointer resolves to one of the retained run files
        # and still reads as a full trace doc (what `trace --restore`
        # and `analyze --restore` load).
        latest = os.path.join(tdir, "rank_0.json")
        assert os.path.islink(latest)
        assert os.readlink(latest) in runs
        docs = load_restore_traces(path)
        assert sorted(docs) == [0]
        assert docs[0]["kind"] == "restore"
        assert docs[0]["run_id"] in os.readlink(latest)
        # Retained run files are distinct documents, not copies.
        run_ids = set()
        for n in runs:
            run_ids.add(json.load(open(os.path.join(tdir, n)))["run_id"])
        assert len(run_ids) == len(runs)


def test_trace_restore_falls_back_to_run_files(tmp_path, capsys):
    """A missing or dangling latest-pointer must not hide a rank's
    traces: ``load_restore_traces`` falls back to the newest run-scoped
    ``rank_<k>.<run>.json`` (a reaped tmpdir target, a partially-synced
    telemetry dir)."""
    from tpusnap.__main__ import main
    from tpusnap_torch.progress import load_restore_traces, restore_trace_dir

    path = str(tmp_path / "snap")
    state = {"w": torch.arange(4096, dtype=torch.float32)}
    Snapshot.take(path, {"m": PytreeState(state)})
    with override_telemetry_dir(str(tmp_path / "teledir")):
        for _ in range(2):
            Snapshot(path).restore(
                {"m": PytreeState({"w": torch.zeros(4096)})}
            )
        tdir = restore_trace_dir(path)
        latest = os.path.join(tdir, "rank_0.json")
        want_run = load_restore_traces(path)[0]["run_id"]
        # Dangling symlink: target gone, pointer still there.
        os.remove(latest)
        os.symlink("rank_0.feedfeedfeed.json", latest)
        docs = load_restore_traces(path)
        assert docs and docs[0]["kind"] == "restore"
        assert docs[0]["run_id"] == want_run  # newest run file wins
        # Pointer absent entirely.
        os.remove(latest)
        docs = load_restore_traces(path)
        assert docs and docs[0]["run_id"] == want_run
        assert main(["trace", path, "--restore"]) == 0
        assert "restore.read" in capsys.readouterr().out


def test_trace_restore_without_traces_exits_3(tmp_path, capsys):
    from tpusnap.__main__ import main

    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": PytreeState({"w": torch.ones(256)})})
    with override_telemetry_dir(str(tmp_path / "empty_teledir")):
        assert main(["trace", path, "--restore"]) == 3
        assert "no restore telemetry" in capsys.readouterr().err


def test_restore_telemetry_off_skips_trace(tmp_path):
    path = str(tmp_path / "snap")
    state = {"w": torch.ones(1024)}
    Snapshot.take(path, {"m": PytreeState(state)})
    with override_telemetry_dir(str(tmp_path / "teledir")):
        with override_telemetry_enabled(False):
            Snapshot(path).restore(
                {"m": PytreeState({"w": torch.zeros(1024)})}
            )
        assert not os.path.exists(restore_trace_dir(path))


def test_async_restore_also_traces(tmp_path):
    path = str(tmp_path / "snap")
    state = {"w": torch.arange(2048, dtype=torch.float32)}
    Snapshot.take(path, {"m": PytreeState(state)})
    with override_telemetry_dir(str(tmp_path / "teledir")):
        target = {"w": torch.zeros(2048)}
        Snapshot(path).async_restore({"m": PytreeState(target)}).wait()
        assert torch.equal(target["w"], state["w"])
        doc = json.load(
            open(os.path.join(restore_trace_dir(path), "rank_0.json"))
        )
        assert doc["summary"]["phase_coverage"] >= 0.9


# ------------------------------------------------------------ distributed


def _world_stall_take(snap_dir):
    import logging

    import numpy as np

    from tpusnap_torch import FaultPlan, PytreeState, Snapshot
    from tpusnap_torch.comm import get_communicator

    comm = get_communicator()
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    logging.getLogger("tpusnap_torch.progress").addHandler(Capture())
    # Rank 1's first blob write hangs for 6 s; rank 0 sails through and
    # blocks in the commit barrier. Its watchdog (deadline 1 s via
    # extra_env) must name the barrier and the exact missing rank well
    # before the 600 s barrier timeout.
    plan = (
        FaultPlan(stall_op=("write", 1, 6.0))
        if comm.rank == 1
        else FaultPlan()
    )
    state = {"w": torch.arange(8192, dtype=torch.float32) * (comm.rank + 1)}
    Snapshot.take(
        "chaos+fs://" + snap_dir,
        {"m": PytreeState(state)},
        storage_options={"fault_plan": plan},
    )
    if comm.rank == 0:
        stalls = [r for r in records if hasattr(r, "tpusnap_stall")]
        assert stalls, "healthy rank's watchdog never fired"
        barrier_stalls = [
            r.tpusnap_stall
            for r in stalls
            if r.tpusnap_stall.get("missing_ranks")
        ]
        assert barrier_stalls, [r.tpusnap_stall for r in stalls]
        info = barrier_stalls[0]
        assert info["missing_ranks"] == [1], info
        assert "barrier" in info["op"], info
        print("STALL_ATTRIBUTION_OK")


def test_two_proc_stall_watchdog_names_missing_rank(tmp_path):
    from tpusnap_torch.test_utils import run_subprocess_world

    outs = run_subprocess_world(
        _world_stall_take,
        world_size=2,
        args=[str(tmp_path / "snap")],
        extra_env={
            "TPUSNAP_STALL_DEADLINE_S": "1.0",
            "TPUSNAP_HEARTBEAT_INTERVAL_S": "0.1",
        },
    )
    assert any("STALL_ATTRIBUTION_OK" in o for o in outs)


def _world_heartbeats_while_parked(snap_dir):
    """Rank 1's first blob write hangs 3 s inside the op; rank 0 waits in
    the commit barrier meanwhile. Rank 0's lease keeps being published
    from the pump's own store client throughout the wait, and neither
    rank is declared dead (TTL 1 s): a parked rank is alive."""
    import threading

    from tpusnap_torch import FaultPlan, PytreeState, Snapshot
    from tpusnap_torch.comm import StoreComm, get_communicator
    from tpusnap_torch.liveness import LeasePublisher

    comm = get_communicator()
    publishes, waits = [], []
    lock = threading.Lock()
    orig_publish, orig_barrier = LeasePublisher.publish, StoreComm.barrier

    def publish(self, state=None):
        orig_publish(self, state)
        with lock:
            publishes.append(time.monotonic())

    def barrier(self):
        t0 = time.monotonic()
        orig_barrier(self)
        waits.append((t0, time.monotonic()))

    LeasePublisher.publish, StoreComm.barrier = publish, barrier
    plan = FaultPlan(stall_op=("write", 1, 3.0)) if comm.rank == 1 else FaultPlan()
    state = {"w": torch.arange(8192, dtype=torch.float32) * (comm.rank + 1)}
    Snapshot.take("chaos+fs://" + snap_dir, {"m": PytreeState(state)},
                  storage_options={"fault_plan": plan})
    LeasePublisher.publish, StoreComm.barrier = orig_publish, orig_barrier
    if comm.rank == 0:
        start, end = max(waits, key=lambda w: w[1] - w[0])
        during = [t for t in publishes if start <= t <= end]
        # The interval is 0.1 s: a pump stalled behind the waiting thread
        # would publish once or not at all in this window.
        assert len(during) >= 5, (end - start, len(during))
        print("HEARTBEATS_WHILE_PARKED", end - start, len(during))


def test_heartbeats_advance_while_peer_parks_in_barrier(tmp_path):
    from tpusnap_torch.test_utils import run_subprocess_world

    outs = run_subprocess_world(
        _world_heartbeats_while_parked, world_size=2, args=[str(tmp_path / "snap")],
        extra_env={"TPUSNAP_HEARTBEAT_INTERVAL_S": "0.1", "TPUSNAP_LIVENESS_TTL_S": "1.0"},
    )
    assert any("HEARTBEATS_WHILE_PARKED" in o for o in outs)


def test_pump_publishes_on_its_own_store_client(monkeypatch):
    """The heartbeat KV store runs over a clone of the job's store (its
    own client connection), not the client the take's collectives use."""
    import torch.distributed as dist

    from tpusnap_torch import dist_store
    from tpusnap_torch.comm import StoreComm
    from tpusnap_torch.progress import pump_kv_store

    store = dist.TCPStore("127.0.0.1", 0, 1, True)
    comm = StoreComm(store, 0, 2)
    given = []
    real = dist_store.TCPStoreKVStore

    class Recording(real):
        def __init__(self, s, *a, **k):
            given.append(s)
            super().__init__(s, *a, **k)

    monkeypatch.setattr(dist_store, "TCPStoreKVStore", Recording)
    kv = pump_kv_store(comm)
    assert len(given) == 1 and given[0] is not comm.store
    kv.set("k", b"v")
    assert comm.store.get("tpusnap_store/k") == b"v"  # the same server
    assert pump_kv_store(StoreComm(store, 0, 1)) is None
