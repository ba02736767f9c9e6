"""The port's SLO tracker, mirrored from tests/test_slo.py (the RPO
clock and commit anchor, the data-at-risk evidence tiers, edge-triggered
breaches, ``estimate_rto``, the sidecars and their exit marker, the
rank-0 fleet fold, the ``slo`` CLI exit contract, the Prometheus gauges,
the heartbeat's ``slo`` fields, ``record_slo_step`` and the crash
matrix), plus cross-package checks: ``estimate_rto`` gives tpusnap's
estimate on the same history, and the sidecars either package writes
give the same verdict in the other.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch
import pytest

from tpusnap_torch import Snapshot, StateDict
from tpusnap_torch import slo as slo_mod
from tpusnap_torch.knobs import (
    override_heartbeat_interval_s,
    override_metrics_dir,
    override_metrics_export,
    override_slo_thresholds,
    override_telemetry_dir,
)
from tpusnap_torch.metrics_export import (
    PrometheusTextfileSink,
    install_env_sinks,
    parse_prometheus_textfile,
)
from tpusnap_torch.slo import (
    RTOEstimate,
    SLOTracker,
    estimate_rto,
    evaluate_records,
    read_slo_records,
    slo_rank_path,
)


@pytest.fixture
def slo_env(tmp_path):
    """Isolated telemetry/metrics dirs + a fresh process-global tracker
    (the tracker is process-global state like the telemetry counters)."""
    slo_mod.reset_tracker()
    with override_telemetry_dir(str(tmp_path / "tele")), override_metrics_dir(
        str(tmp_path / "tele")
    ):
        yield str(tmp_path / "tele")
    slo_mod.reset_tracker()
    install_env_sinks()


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _tracker(clock=None, wall=None):
    clock = clock or FakeClock()
    wall = wall or FakeClock(1_700_000_000.0)
    return SLOTracker(clock=clock, wall=wall), clock, wall


# ------------------------------------------------------------ tracker math


def test_rpo_counts_from_tracker_start_before_any_commit(slo_env):
    t, clock, _ = _tracker()
    clock.advance(12.5)
    assert t.rpo_s() == pytest.approx(12.5)


def test_commit_anchors_rpo_and_interval(slo_env):
    t, clock, _ = _tracker()
    clock.advance(10.0)
    sec = t.record_commit("t1", "/p", snapshot_bytes=1000)
    assert sec["commit_interval_s"] == pytest.approx(10.0)
    clock.advance(4.0)
    assert t.rpo_s() == pytest.approx(4.0)
    sec2 = t.record_commit("t2", "/p", snapshot_bytes=1000)
    assert sec2["commit_interval_s"] == pytest.approx(4.0)
    assert t.rpo_s() == pytest.approx(0.0)


def test_data_at_risk_evidence_tiers(slo_env):
    t, _clock, _ = _tracker()
    # Tier 1: explicit steps accumulate.
    t.record_step(100)
    t.record_step(50)
    assert t.data_at_risk_bytes() == 150
    # Tier 3: planned payload floors the figure (conservative max).
    t.note_planned(1000, incremental=False)
    assert t.data_at_risk_bytes() == 1000
    t.record_step(2000)
    assert t.data_at_risk_bytes() == 2150
    # Commit clears the planned payload and the PRE-capture steps; the
    # 2000 recorded after the capture is not in the snapshot and stays
    # at risk. The interval's realized change bounds the explicit tier
    # at its capture-time value (150) — post-capture bytes belong to
    # the NEXT interval's event, never double-counted.
    sec = t.record_commit("t1", "/p", snapshot_bytes=1000)
    assert sec["change_bytes"] == 1000
    assert t.data_at_risk_bytes() == 2000
    assert t.rpo_s() == pytest.approx(0.0)


def test_commit_anchors_at_capture_not_commit(slo_env):
    """An async take's drain can run minutes after staging: the commit
    makes the CAPTURE instant durable, so the RPO clock restarts from
    capture time and drain-window step evidence survives the commit."""
    t, clock, _ = _tracker()
    t.record_step(100)  # pre-capture: durable once the take commits
    clock.advance(10.0)
    t.note_planned(1000, incremental=False, take_id="t1")  # capture @110
    clock.advance(60.0)  # the drain window
    t.record_step(500)  # post-capture: NOT in the snapshot
    sec = t.record_commit("t1", "/p", snapshot_bytes=1000)
    # RPO measured from capture, not commit.
    assert t.rpo_s() == pytest.approx(60.0)
    assert sec["commit_interval_s"] == pytest.approx(10.0)
    # The interval's change excludes the drain-window 500 (it will be
    # the NEXT interval's change, not this one's — no double count).
    assert sec["change_bytes"] == 1000
    # Drain-window mutation stays at risk; pre-capture step cleared.
    assert t.data_at_risk_bytes() == 500


def test_incremental_change_stats_subtract_dedup_skips(slo_env):
    t, _clock, _ = _tracker()
    counters = {"scheduler.dedup_skipped_bytes": 0}
    t.note_planned(1000, incremental=True, live_counters=lambda: counters)
    assert t.data_at_risk_bytes() == 1000
    # The dual-hash pass proves 800 bytes unchanged: exposure shrinks live.
    counters["scheduler.dedup_skipped_bytes"] = 800
    assert t.data_at_risk_bytes() == 200
    sec = t.record_commit(
        "t1", "/p", snapshot_bytes=1000, incremental=True, counters=counters
    )
    assert sec["change_bytes"] == 200


def test_abort_releases_recorder_but_keeps_exposure(slo_env):
    """An aborted take must release the dead take's counter closure
    (memory) without clearing the at-risk figure — nothing committed,
    the planned bytes are still exposure. Incremental refinement is
    frozen at the last observed skip evidence."""
    t, _clock, _ = _tracker()
    counters = {"scheduler.dedup_skipped_bytes": 300}
    t.note_planned(1000, incremental=True, live_counters=lambda: counters)
    assert t.data_at_risk_bytes() == 700
    t.note_take_aborted()
    assert t._live_counters is None
    counters["scheduler.dedup_skipped_bytes"] = 999  # dead take: ignored
    assert t.data_at_risk_bytes() == 700


def test_failed_take_keeps_data_at_risk(slo_env, tmp_path):
    """End-to-end abort path: a take that dies must leave the exposure
    standing — the explicit step evidence survives the abort — and the
    next successful commit clears it."""
    from tpusnap_torch import FaultPlan, InjectedFaultError, record_slo_step

    state = {"a": StateDict(w=torch.arange(50000, dtype=torch.float32))}
    record_slo_step(200000)
    # Mark a live-counter closure as if a take were mid-flight, then
    # fail a real take: on_failure must release the closure while the
    # exposure stands.
    with pytest.raises(InjectedFaultError):
        Snapshot.take(
            "chaos+fs://" + str(tmp_path / "fail"),
            state,
            storage_options={
                "fault_plan": FaultPlan(transient_per_op=99),
                "retry": False,
            },
        )
    assert slo_mod.tracker().data_at_risk_bytes() == 200000
    assert slo_mod.tracker()._live_counters is None  # recorder released
    Snapshot.take(str(tmp_path / "ok"), state)
    assert slo_mod.tracker().data_at_risk_bytes() == 0


def test_exit_marker_clean_vs_crash(tmp_path):
    """Clean interpreter exit stamps the sidecar final (exposure
    frozen); an unhandled-exception crash — which ALSO runs atexit —
    must NOT be stamped, so the gate keeps screaming about it."""
    tele = str(tmp_path / "tele")
    env = dict(os.environ, JAX_PLATFORMS="cpu", TPUSNAP_TELEMETRY_DIR=tele)
    child = (
        "import sys, torch\n"
        "from tpusnap_torch import Snapshot, StateDict\n"
        "Snapshot.take(sys.argv[1], {'a': StateDict(w=torch.arange(1000))})\n"
        "if sys.argv[2] == 'crash':\n"
        "    raise RuntimeError('simulated training crash')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", child, str(tmp_path / "s1"), "clean"],
        env=env, timeout=180,
    )
    assert r.returncode == 0
    assert json.load(open(os.path.join(tele, "slo", "rank_0.json")))["final"]
    r = subprocess.run(
        [sys.executable, "-c", child, str(tmp_path / "s2"), "crash"],
        env=env, capture_output=True, text=True, timeout=180,
    )
    assert r.returncode == 1
    rec = json.load(open(os.path.join(tele, "slo", "rank_0.json")))
    assert not rec.get("final")


def test_telemetry_off_take_still_anchors(slo_env, tmp_path):
    """The SLO tracker is bookkeeping, not spans: with TPUSNAP_TELEMETRY=0
    (no pump, no attach) the commit must still anchor and publish the
    sidecar with the rank configured."""
    from tpusnap_torch.knobs import override_telemetry_enabled

    with override_telemetry_enabled(False):
        Snapshot.take(
            str(tmp_path / "s"),
            {"a": StateDict(w=torch.arange(50000, dtype=torch.float32))},
        )
    recs = read_slo_records()
    assert len(recs) == 1
    assert recs[0]["last_commit_ts"] is not None
    assert recs[0]["world_size"] == 1


def test_breach_is_edge_triggered(slo_env):
    from tpusnap_torch import telemetry

    telemetry.reset_global_counters()
    t, clock, _ = _tracker()
    with override_slo_thresholds(rpo_s=5.0):
        clock.advance(10.0)  # over threshold
        t.publish(force=True)
        t.publish(force=True)  # same episode: no second fire
        assert telemetry.counter_value("slo.breaches") == 1
        t.record_commit("t1", "/p", snapshot_bytes=10)  # re-arms
        clock.advance(10.0)
        t.publish(force=True)
        assert telemetry.counter_value("slo.breaches") == 2


# ----------------------------------------------------------- RTO estimator


def _restore_event(wall_s, nbytes, read_s=None, rank=0):
    ev = {"kind": "restore", "rank": rank, "wall_s": wall_s, "bytes": nbytes}
    if read_s is not None:
        ev["phases_s"] = {"restore.read": read_s}
    return ev


def test_estimate_rto_insufficient_history():
    # estimate_rto falls back to any read ceiling in the registry: start
    # from an empty one (ROADMAP.md C9).
    from tpusnap_torch import compress

    compress._reset_ceilings()
    est = estimate_rto(10**9, events=[_restore_event(1.0, 10**9)] * 2)
    assert not est.ok and est.n_baseline == 2
    assert "need 3" in est.reason


def test_estimate_rto_scales_bytes_and_adds_overhead():
    # 1 GB read in 1 s (+0.5 s overhead), three times over.
    events = [_restore_event(1.5, 10**9, read_s=1.0) for _ in range(3)]
    est = estimate_rto(4 * 10**9, events=events)
    assert est.ok and est.read_gbps == pytest.approx(1.0)
    assert est.seconds == pytest.approx(4.5, rel=1e-3)
    # Without phase data the whole wall prices the bytes (overhead 0).
    events = [_restore_event(2.0, 10**9) for _ in range(3)]
    est = estimate_rto(10**9, events=events)
    assert est.ok and est.seconds == pytest.approx(2.0, rel=1e-3)


def test_estimate_rto_ignores_other_kinds_and_ranks():
    events = (
        [{"kind": "take", "rank": 0, "wall_s": 9.0, "bytes": 10**9}] * 5
        + [_restore_event(1.0, 10**9, rank=1)] * 5
        + [_restore_event(1.0, 10**9)] * 3
    )
    est = estimate_rto(10**9, events=events)
    assert est.ok and est.n_baseline == 3


# ------------------------------------------------- records + gate verdicts


def _record(rank=0, last_commit_age=10.0, at_risk=0, rto=None, now=1000.0):
    return {
        "v": 1,
        "rank": rank,
        "world_size": 1,
        "ts": now - 1.0,
        "started_ts": now - 500.0,
        "last_commit_ts": now - last_commit_age,
        "data_at_risk_bytes": at_risk,
        "estimated_rto_s": rto,
    }


def test_evaluate_records_verdicts():
    now = 1000.0
    # Healthy under thresholds.
    rep = evaluate_records(
        [_record(last_commit_age=10, rto=5.0, now=now)],
        rpo_threshold_s=60,
        rto_threshold_s=60,
        now=now,
    )
    assert rep["verdict"] == "healthy"
    # Live recomputation from wall anchors: a stale record still breaches.
    rep = evaluate_records(
        [_record(last_commit_age=120, now=now)],
        rpo_threshold_s=60,
        now=now,
    )
    assert rep["verdict"] == "breach"
    assert rep["ranks"][0]["since_commit_s"] == pytest.approx(120.0)
    # RTO objective set but no estimate anywhere: no verdict.
    rep = evaluate_records(
        [_record(last_commit_age=10, rto=None, now=now)],
        rto_threshold_s=60,
        now=now,
    )
    assert rep["verdict"] == "insufficient"
    # No records at all.
    assert evaluate_records([], now=now)["verdict"] == "insufficient"
    # Never-committed record: exposure counts from tracker start.
    rec = _record(now=now)
    rec["last_commit_ts"] = None
    rep = evaluate_records([rec], rpo_threshold_s=60, now=now)
    assert rep["verdict"] == "breach"
    assert rep["ranks"][0]["since_commit_s"] == pytest.approx(500.0)


def test_final_record_freezes_exposure():
    """A record marked `final` (clean process exit) freezes
    since-commit at its write time — a finished run is not an incident;
    an unmarked (SIGKILLed/live) record keeps growing."""
    now = 10_000.0
    rec = _record(last_commit_age=30, now=1000.0)
    rec["ts"] = 1000.0 - 1.0
    rec["final"] = True
    rep = evaluate_records([rec], rpo_threshold_s=60, now=now)
    assert rep["verdict"] == "healthy"
    assert rep["ranks"][0]["since_commit_s"] == pytest.approx(29.0)
    del rec["final"]
    rep = evaluate_records([rec], rpo_threshold_s=60, now=now)
    assert rep["verdict"] == "breach"


def test_fleet_fold_adds_record_staleness():
    """A hung rank's frozen heartbeat must not freeze the fleet RPO:
    the fold adds how stale each record is."""

    class FakeKV:
        def try_get_dir(self, prefix, keys=None):
            # A TCPStore cannot list: the fold names every rank's key.
            assert keys == [f"{prefix}{r}" for r in range(2)]
            return {
                f"{prefix}1": json.dumps(
                    {"ts": 500.0, "slo": {"rpo_s": 40.0,
                                          "data_at_risk_bytes": 1}}
                ).encode(),
            }

    wall = FakeClock(800.0)  # record is 300s stale
    t = SLOTracker(clock=FakeClock(), wall=wall)
    t.configure(rank=0, world_size=2)
    t._fold_fleet("take1", FakeKV())
    assert t.snapshot_state()["fleet"]["rpo_s"] == pytest.approx(340.0)


def test_rto_estimator_uses_own_rank(slo_env):
    """A host running only ranks >= 8 must form its estimate from its
    own ranks' restore events, not wait for rank-0 events forever."""
    from tpusnap_torch.history import record_event

    for _ in range(3):
        record_event(_restore_event(1.0, 10**9, read_s=1.0, rank=8))
    t, _clock, _ = _tracker()
    t.configure(rank=8, world_size=16)
    t.note_planned(10**9, incremental=False)
    assert t.snapshot_state()["estimated_rto_s"] is not None


def test_cli_exit_contract(slo_env, tmp_path):
    """slo --check: 0 healthy / 2 breach / 3 insufficient — unit leg of
    the contract ci_gate.sh exercises end-to-end."""
    from tpusnap_torch import compress
    from tpusnap_torch.__main__ import main

    compress._reset_ceilings()  # no probe ceiling to estimate from (C9)

    # (3) empty dir.
    assert main(["slo", "--check"]) == 3
    # Seed a fresh record through a real take.
    Snapshot.take(
        str(tmp_path / "s"),
        {"a": StateDict(w=torch.arange(50000, dtype=torch.float32))},
    )
    assert os.path.exists(slo_rank_path(0))
    # (0) healthy under a generous threshold.
    assert main(["slo", "--check", "--rpo", "3600"]) == 0
    # (2) stale-commit breach.
    rec = json.load(open(slo_rank_path(0)))
    rec["last_commit_ts"] = time.time() - 900
    json.dump(rec, open(slo_rank_path(0), "w"))
    assert main(["slo", "--check", "--rpo", "60"]) == 2
    # (3) RTO objective with no estimator verdict.
    assert main(["slo", "--check", "--rto", "60"]) == 3
    # Informational mode never gates (exit 0 once records exist).
    assert main(["slo", "--rpo", "60"]) == 0
    assert main(["slo", "--json"]) == 0


# ------------------------------------------------ prometheus + fleet fold


def test_prometheus_exposition_covers_slo_gauges(slo_env):
    """Acceptance: parse_prometheus_textfile covers the four new gauge
    families (plus the breach flag and fleet samples)."""
    sink = PrometheusTextfileSink(slo_env)
    state = {
        "rank": 0,
        "rpo_s": 12.5,
        "data_at_risk_bytes": 1 << 20,
        "estimated_rto_s": 42.0,
        "commit_interval_s": 30.0,
        "breach": {"rpo": True, "rto": False},
        "fleet": {
            "ranks": 4,
            "rpo_s": 99.0,
            "data_at_risk_bytes": 1 << 22,
            "estimated_rto_s": 50.0,
        },
    }
    sink.on_slo_update(state)
    text = open(sink.path(0)).read()
    parsed = parse_prometheus_textfile(text)
    from tpusnap_torch.knobs import get_job_id

    job = get_job_id()
    for fam, local, fleet in (
        ("tpusnap_rpo_seconds", 12.5, 99.0),
        ("tpusnap_data_at_risk_bytes", float(1 << 20), float(1 << 22)),
        ("tpusnap_estimated_rto_seconds", 42.0, 50.0),
        ("tpusnap_commit_interval_seconds", 30.0, None),
    ):
        samples = parsed[fam]["samples"]
        assert parsed[fam]["type"] == "gauge"
        assert samples[f'{{job="{job}",rank="0"}}'] == local
        if fleet is not None:
            assert samples[f'{{job="{job}",rank="0",scope="fleet"}}'] == fleet
    breach = parsed["tpusnap_slo_breach"]["samples"]
    assert breach[f'{{job="{job}",objective="rpo",rank="0"}}'] == 1.0
    assert breach[f'{{job="{job}",objective="rto",rank="0"}}'] == 0.0


def test_fleet_fold_takes_worst_rank(slo_env):
    class FakeKV:
        def try_get_dir(self, prefix, keys=None):
            # A TCPStore cannot list: the fold names every rank's key.
            assert keys == [f"{prefix}{r}" for r in range(2)]
            return {
                f"{prefix}0": json.dumps(
                    {"slo": {"rpo_s": 3.0, "data_at_risk_bytes": 100}}
                ).encode(),
                f"{prefix}1": json.dumps(
                    {
                        "slo": {
                            "rpo_s": 9.0,
                            "data_at_risk_bytes": 50,
                            "estimated_rto_s": 7.0,
                        }
                    }
                ).encode(),
            }

    t, _clock, _ = _tracker()
    t.configure(rank=0, world_size=2)
    t._fold_fleet("take1", FakeKV())
    state = t.snapshot_state()
    assert state["fleet"] == {
        "ranks": 2,
        "rpo_s": 9.0,
        "data_at_risk_bytes": 100,
        "estimated_rto_s": 7.0,
    }


# ------------------------------------------------- end-to-end seam checks


def test_take_writes_sidecar_and_history_slo_section(slo_env, tmp_path):
    from tpusnap_torch.history import load_history

    state = {"a": StateDict(w=torch.arange(100000, dtype=torch.float32))}
    Snapshot.take(str(tmp_path / "s1"), state)
    recs = read_slo_records()
    assert len(recs) == 1 and recs[0]["rank"] == 0
    rec = recs[0]
    assert rec["last_commit_ts"] is not None
    assert rec["snapshot_bytes"] == 400000
    assert rec["last_change_bytes"] == 400000  # full take: planned payload
    assert rec["data_at_risk_bytes"] == 0  # cleared at commit
    evs = [e for e in load_history() if e.get("kind") == "take"]
    assert evs and evs[-1]["slo"]["snapshot_bytes"] == 400000
    assert evs[-1]["commit_interval_s"] == evs[-1]["slo"]["commit_interval_s"]


def test_incremental_take_records_change_bytes(slo_env, tmp_path):
    state = {"a": StateDict(**{
        f"w{i}": torch.arange(25000, dtype=torch.float32) + i for i in range(4)
    })}
    Snapshot.take(str(tmp_path / "base"), state)
    # One of four arrays changes: the incremental commit's change bytes
    # must reflect the dual-hash skip evidence, not the full payload.
    state["a"]["w0"] = state["a"]["w0"] + 1.0
    Snapshot.take(
        str(tmp_path / "inc"), state, incremental_from=str(tmp_path / "base")
    )
    rec = read_slo_records()[0]
    total = 4 * 100000
    assert rec["snapshot_bytes"] == total
    assert 0 < rec["last_change_bytes"] < total


def test_async_take_anchors_commit(slo_env, tmp_path):
    pending = Snapshot.async_take(
        str(tmp_path / "s"),
        {"a": StateDict(w=torch.arange(100000, dtype=torch.float32))},
    )
    pending.wait()
    rec = read_slo_records()[0]
    assert rec["last_commit_ts"] is not None
    assert rec["data_at_risk_bytes"] == 0


def test_heartbeat_record_carries_slo_fields(slo_env, tmp_path):
    """The progress record's slo sub-dict (what `watch` renders and the
    fleet fold reads)."""
    from tpusnap_torch.progress import read_progress_records, render_watch_table

    path = str(tmp_path / "s")
    with override_heartbeat_interval_s(0.01):
        Snapshot.take(
            path, {"a": StateDict(w=torch.arange(200000, dtype=torch.float32))}
        )
    recs = read_progress_records(path)
    assert recs and "slo" in recs[0]
    slo = recs[0]["slo"]
    assert "rpo_s" in slo and "data_at_risk_bytes" in slo
    table = render_watch_table(recs, committed=True, stall_flag_s=10)
    assert "at-risk" in table and "commit" in table


def test_watch_table_renders_exposure_columns():
    from tpusnap_torch.progress import render_watch_table

    rec = {
        "rank": 0,
        "state": "running",
        "phase": "stage",
        "percent": 50.0,
        "mbps": 100.0,
        "beat_age_s": 0.1,
        "ts": 1000.0,
        "slo": {"rpo_s": 42.0, "data_at_risk_bytes": 3 * 1024**3},
    }
    table = render_watch_table([rec], committed=False, stall_flag_s=10, now=1000.0)
    assert "3.0G" in table and "42s" in table
    # Exposure grows with record staleness even when progress is frozen.
    table = render_watch_table([rec], committed=False, stall_flag_s=1e9, now=1010.0)
    assert "52s" in table


def test_record_step_rides_into_next_commit(slo_env, tmp_path):
    import tpusnap_torch

    tpusnap_torch.record_slo_step(12345)
    assert slo_mod.tracker().data_at_risk_bytes() == 12345
    Snapshot.take(
        str(tmp_path / "s"),
        {"a": StateDict(w=torch.arange(1000, dtype=torch.float32))},
    )
    assert slo_mod.tracker().data_at_risk_bytes() == 0


# -------------------------------------------------- crash-matrix validation

_CRASH_CHILD = r"""
import os, sys
import numpy as np
import torch
from tpusnap_torch import Snapshot, StateDict

mode, path, seed = sys.argv[1], sys.argv[2], int(sys.argv[3])
state = {
    f"w{i}": torch.from_numpy(
        np.random.default_rng(seed * 100 + i)
        .standard_normal((256, 256))
        .astype(np.float32)
    )
    for i in range(8)
}
url = ("chaos+fs://" + path) if mode == "crash" else path
Snapshot.take(url, {"a": StateDict(**state)})
"""


def _crash_state_bytes():
    return 8 * 256 * 256 * 4


def _crash_state(seed):
    return {
        f"w{i}": torch.from_numpy(
            np.random.default_rng(seed * 100 + i)
            .standard_normal((256, 256))
            .astype(np.float32)
        )
        for i in range(8)
    }


def test_crash_matrix_data_at_risk_and_rto_accuracy(tmp_path):
    """Acceptance: SIGKILL a take mid-write and assert (a) the pre-kill
    exported ``tpusnap_data_at_risk_bytes`` matches the bytes the
    salvage/retake actually had to re-do (at-risk = salvaged + redone,
    the full interval change), and (b) a real measured restore falls
    within the documented ≤2x factor of the pre-crash
    ``tpusnap_estimated_rto_seconds``."""
    tele = str(tmp_path / "tele")
    mdir = str(tmp_path / "metrics")
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        TPUSNAP_TELEMETRY_DIR=tele,
        TPUSNAP_METRICS_DIR=mdir,
        TPUSNAP_METRICS_EXPORT="prom",
        TPUSNAP_HEARTBEAT_INTERVAL_S="0.02",
        TPUSNAP_DISABLE_BATCHING="1",
    )
    env.pop("TPUSNAP_FAULT_SPEC", None)
    seed = 7
    nbytes = _crash_state_bytes()

    # 1. A committed base snapshot (the recovery point).
    base = str(tmp_path / "base")
    subprocess.run(
        [sys.executable, "-c", _CRASH_CHILD, "plain", base, str(seed)],
        check=True,
        env=env,
        timeout=180,
    )

    # 2. Three real restores feed the estimator's baseline (crash
    # recovery restores exactly this state from this storage).
    slo_mod.reset_tracker()
    with override_telemetry_dir(tele), override_metrics_dir(mdir):
        restore_walls = []
        for _ in range(3):
            target = {"a": StateDict(**_crash_state(seed))}
            t0 = time.perf_counter()
            Snapshot(base).restore(target)
            restore_walls.append(time.perf_counter() - t0)

        # 3. SIGKILL a take mid-write (chaos crash_after_op): the
        # pre-kill heartbeat ticks exported the SLO gauges to the prom
        # textfile at 20 ms cadence.
        torn = str(tmp_path / "torn")
        crash_env = dict(
            env,
            # Pin the job id: the prom filename carries it, and the
            # child's host-pid default is unknowable from here.
            TPUSNAP_JOB_ID="slocrash",
            TPUSNAP_FAULT_SPEC="latency_ms=150,crash_after_op=write:5",
            # Serialize the writes (one ~256 KB blob in flight at a
            # time): concurrent dispatch would complete all 8 writes in
            # one latency window and the SIGKILL would beat every
            # journal record flush — leaving nothing to salvage.
            TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES="300000",
        )
        r = subprocess.run(
            [sys.executable, "-c", _CRASH_CHILD, "crash", torn, str(seed)],
            capture_output=True,
            text=True,
            env=crash_env,
            timeout=180,
        )
        assert r.returncode == -signal.SIGKILL, r.stderr[-500:]

        prom = open(os.path.join(mdir, "tpusnap_slocrash_rank0.prom")).read()
        parsed = parse_prometheus_textfile(prom)
        at_risk = parsed["tpusnap_data_at_risk_bytes"]["samples"][
            '{job="slocrash",rank="0"}'
        ]
        est_samples = parsed.get("tpusnap_estimated_rto_seconds", {}).get(
            "samples", {}
        )
        assert est_samples, (
            "pre-crash prom carries no RTO estimate despite 3 restore "
            "events in history"
        )
        est_rto = est_samples['{job="slocrash",rank="0"}']

        # (a) Pre-kill data-at-risk = the take's full planned payload
        # (nothing was committed), which must equal what the salvage
        # retake re-does plus what it salvages — re-take the same state
        # and account for every byte.
        assert at_risk == nbytes
        from tpusnap_torch import telemetry
        from tpusnap_torch.knobs import override_batching_disabled

        telemetry.reset_global_counters()
        # Batching off like the crashed child: slab-batched retakes
        # always rewrite (no salvage), which would void the accounting.
        with override_batching_disabled(True):
            Snapshot.take(torn, {"a": StateDict(**_crash_state(seed))})
        # storage.bytes_written counts every payload byte the retake
        # processed (salvage skips happen below the counter, tallied in
        # salvage.bytes_salvaged): redone = written - salvaged, and
        # redone + salvaged must account for exactly the bytes the
        # pre-kill gauge declared at risk.
        written = telemetry.counter_value("storage.bytes_written")
        salvaged = telemetry.counter_value("salvage.bytes_salvaged")
        assert salvaged > 0, "crash at write:5 left nothing to salvage?"
        redone = written - salvaged
        assert redone > 0
        assert abs((redone + salvaged) - at_risk) / at_risk < 0.05

        # (b) A real measured restore within the documented ≤2x factor
        # of the pre-crash estimate (best of 3 — the estimator is a
        # median, one cold outlier must not fail the contract; the
        # 50 ms additive guard absorbs timer noise at this small scale).
        target = {"a": StateDict(**_crash_state(seed))}
        t0 = time.perf_counter()
        Snapshot(base).restore(target)
        measured = min(time.perf_counter() - t0, *restore_walls)
        assert measured <= 2.0 * est_rto + 0.05, (
            f"measured restore {measured:.3f}s vs pre-crash estimate "
            f"{est_rto:.3f}s — estimator overpromised by more than 2x"
        )
        assert est_rto <= 2.0 * measured + 0.05, (
            f"pre-crash estimate {est_rto:.3f}s vs measured {measured:.3f}s "
            "— estimator overestimated by more than 2x"
        )
    slo_mod.reset_tracker()
    install_env_sinks()


# ------------------------------------------------------ cross-package

_RTO_CASES = {
    "insufficient": ([_restore_event(1.0, 10**9)] * 2, {}),
    "read_phase": ([_restore_event(1.5, 10**9, read_s=1.0)] * 3, {}),
    "whole_wall": ([_restore_event(2.0, 10**9)] * 4, {}),
    "other_rank": ([_restore_event(1.0, 10**9, rank=3)] * 3, {"rank": 3}),
    "backend_filter": (
        [dict(_restore_event(1.0, 10**9), plugin="FSStoragePlugin")] * 3
        + [dict(_restore_event(8.0, 10**9), plugin="S3StoragePlugin")] * 3,
        {"backend": "S3StoragePlugin"},
    ),
    "mixed_kinds": (
        [_restore_event(1.2, 2 * 10**9, read_s=1.0)] * 3
        + [{"kind": "take", "rank": 0, "wall_s": 9.0, "bytes": 10**9}] * 3,
        {"window": 2},
    ),
}


@pytest.mark.parametrize("case", sorted(_RTO_CASES))
def test_estimate_rto_matches_tpusnap(case):
    from tpusnap import compress as jax_compress
    from tpusnap.slo import estimate_rto as jax_estimate_rto
    from tpusnap_torch import compress

    # An estimate without enough restores falls back to the process's
    # probe ceiling: start both packages without one, whatever an earlier
    # test in this process left (C13).
    compress._reset_ceilings()
    jax_compress._reset_ceilings()
    events, kw = _RTO_CASES[case]
    for nbytes in (0, 10**9, 7 * 10**9 + 3):
        ours = estimate_rto(nbytes, events=events, **kw)
        theirs = jax_estimate_rto(nbytes, events=events, **kw)
        assert vars(ours) == vars(theirs)


def test_sidecars_of_either_package_give_the_same_verdict(tmp_path, monkeypatch):
    """A take of each package writes its rank's sidecar into its own
    telemetry dir; each package reads both and gives the same verdict
    under the same thresholds."""
    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import StateDict as JaxStateDict
    from tpusnap import slo as jax_slo

    monkeypatch.setenv("TPUSNAP_SLO_RPO_S", "3600")
    for name, take in (
        ("port", lambda p: Snapshot.take(p, {"a": StateDict(w=torch.ones(64))})),
        ("jax", lambda p: JaxSnapshot.take(p, {"a": JaxStateDict(w=np.ones(64, np.float32))})),
    ):
        monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / name))
        take(str(tmp_path / f"snap_{name}"))
    for name in ("port", "jax"):
        d = slo_mod.slo_dir(str(tmp_path / name))
        ours, theirs = slo_mod.read_slo_records(d), jax_slo.read_slo_records(d)
        assert ours == theirs and len(ours) == 1 and ours[0]["snapshot_bytes"] == 256
        now = ours[0]["ts"] + 5.0
        for rpo in (1.0, 3600.0):
            assert slo_mod.evaluate_records(
                ours, rpo_threshold_s=rpo, now=now
            ) == jax_slo.evaluate_records(theirs, rpo_threshold_s=rpo, now=now)
    port_keys = set(slo_mod.read_slo_records(slo_mod.slo_dir(str(tmp_path / "port")))[0])
    jax_keys = set(jax_slo.read_slo_records(jax_slo.slo_dir(str(tmp_path / "jax")))[0])
    assert port_keys == jax_keys


def test_fleet_fold_over_a_tcpstore_never_blocks():
    """Rank 0's fold reads the heartbeat keys of a TCPStore while peers
    that finished delete theirs. A key deleted right after it was seen
    (the store below deletes it on every ``check``) or never written
    reads as absent at once and is not re-created; a ``get`` of it would
    wait out the store's timeout."""
    import datetime

    import torch.distributed as dist

    from tpusnap_torch.dist_store import TCPStoreKVStore
    from tpusnap_torch.test_utils import find_free_port

    store = dist.TCPStore(
        "127.0.0.1", find_free_port(), 1, True, timeout=datetime.timedelta(seconds=3)
    )
    kv = TCPStoreKVStore(store)
    prefix = "tpusnap_progress/take1/"
    kv.set(f"{prefix}0", json.dumps({"slo": {"rpo_s": 2.0, "data_at_risk_bytes": 7}}).encode())
    kv.set(f"{prefix}1", b"{}")

    class DeletedAfterCheck:
        """rank 1 finishes (deletes its key) just after any check."""

        def __init__(self, inner):
            self.inner = inner

        def check(self, keys):
            found = self.inner.check(keys)
            self.inner.delete_key(f"{prefix}1")
            return found

        def __getattr__(self, name):
            return getattr(self.inner, name)

    kv._store = DeletedAfterCheck(kv._store)
    t, _clock, _ = _tracker()
    t.configure(rank=0, world_size=2)
    t0 = time.monotonic()
    t._fold_fleet("take1", kv)
    assert time.monotonic() - t0 < 2.0
    assert t.snapshot_state()["fleet"]["data_at_risk_bytes"] == 7
    assert kv.try_get(f"{prefix}2") is None
    assert not store.check([f"tpusnap_store/{prefix}2"])
