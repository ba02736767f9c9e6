"""The port's fleet layer, mirrored from tests/test_fleet.py (the job
identity knobs, the per-job status publisher and its ``final`` stamp,
the cross-job fold, the ``fleet --check`` exit contract, the
``scope="fleet"`` families and ``watch --fleet``), plus cross-package
checks: one fleet directory holding both packages' records folds and
gates the same in either.
"""

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch
import pytest

from tpusnap_torch import Snapshot, StateDict
from tpusnap_torch import fleet as fleet_mod
from tpusnap_torch.__main__ import main
from tpusnap_torch.fleet import (
    FleetPublisher,
    evaluate_fleet,
    fold_fleet,
    publisher,
    read_fleet_records,
    render_fleet_prom,
    reset_publisher,
    write_fleet_prom,
)
from tpusnap_torch.knobs import (
    get_explicit_job_id,
    get_fleet_dir,
    get_job_id,
    override_fleet_dir,
    override_job_id,
    override_slo_stream_cadence_x,
    override_telemetry_dir,
)
from tpusnap_torch.metrics_export import parse_prometheus_textfile
from tpusnap_torch.telemetry import IOStats


@pytest.fixture
def fleet_env(tmp_path):
    """Isolated fleet dir + telemetry dir; process-global publisher
    reset on both sides so records never leak across tests."""
    fdir = str(tmp_path / "fleet")
    reset_publisher()
    with override_telemetry_dir(str(tmp_path / "tele")), override_fleet_dir(
        fdir
    ):
        yield fdir
    reset_publisher()


# ------------------------------------------------------ identity knobs


def test_job_id_default_is_host_pid_derived():
    with override_job_id(None):
        jid = get_job_id()
        assert str(os.getpid()) in jid
        # The regression-baseline key must NOT inherit that default:
        # it changes every process and would empty every baseline.
        assert get_explicit_job_id() is None


def test_job_id_knob_sanitized():
    with override_job_id("exp 7/resnet:a"):
        assert get_job_id() == "exp-7-resnet-a"
        assert get_explicit_job_id() == "exp-7-resnet-a"


def test_fleet_dir_knob(tmp_path):
    assert get_fleet_dir() is None or isinstance(get_fleet_dir(), str)
    with override_fleet_dir(str(tmp_path)):
        assert get_fleet_dir() == str(tmp_path)


def test_publisher_off_without_fleet_dir():
    reset_publisher()
    with override_fleet_dir(None):
        assert publisher() is None


def test_publisher_tracks_knob_changes(fleet_env, tmp_path):
    with override_job_id("a"):
        p1 = publisher()
        assert p1 is not None and p1.job_id == "a"
    with override_job_id("b"):
        p2 = publisher()
        assert p2 is not p1 and p2.job_id == "b"


# ---------------------------------------------------------- publisher


def test_publisher_roundtrip_and_final_stamp(fleet_env):
    pub = FleetPublisher(fleet_env, "jobA")
    beat = {
        "rank": 0,
        "world_size": 4,
        "take_id": "t1",
        "state": "running",
        "phase": "write",
        "percent": 40.0,
        "mbps": 123.0,
        "bytes_written": 1 << 20,
    }
    pub.publish(beat=beat)
    recs = read_fleet_records(fleet_env)
    assert len(recs) == 1
    rec = recs[0]
    assert rec["job_id"] == "jobA"
    assert rec["pid"] == os.getpid()
    assert rec["state"] == "running" and rec["world_size"] == 4
    assert "slo" in rec and "rpo_s" in rec["slo"]
    assert not rec.get("final")
    # A beat-less final publish reuses the last-known beat (the exit
    # stamp must not erase what the job was doing).
    pub.publish(final=True)
    rec = read_fleet_records(fleet_env)[0]
    assert rec["final"] is True
    assert rec["take_id"] == "t1"


def test_read_skips_torn_and_foreign_files(fleet_env):
    FleetPublisher(fleet_env, "ok").publish(beat={"state": "running"})
    with open(os.path.join(fleet_env, "torn.json"), "w") as f:
        f.write('{"job_id": "torn", "trunc')
    with open(os.path.join(fleet_env, "x.json.tmp.123"), "w") as f:
        f.write("{}")
    with open(os.path.join(fleet_env, "notes.txt"), "w") as f:
        f.write("hello")
    recs = read_fleet_records(fleet_env)
    assert [r["job_id"] for r in recs] == ["ok"]


def test_tick_hook_publishes_and_attach_is_rank0_only(fleet_env):
    with override_job_id("hooked"):
        hooks = []
        mon = types.SimpleNamespace(
            rank=0, add_tick_hook=lambda fn: hooks.append(fn)
        )
        fleet_mod.attach_to_take(mon)
        assert len(hooks) == 1
        hooks[0](None)  # throttled tick: no record, no publish
        assert read_fleet_records(fleet_env) == []
        hooks[0]({"state": "running", "rank": 0, "take_id": "t9"})
        recs = read_fleet_records(fleet_env)
        assert len(recs) == 1 and recs[0]["take_id"] == "t9"
        # Non-zero ranks never publish (one record per job).
        other = types.SimpleNamespace(
            rank=1, add_tick_hook=lambda fn: hooks.append(fn)
        )
        fleet_mod.attach_to_take(other)
        assert len(hooks) == 1


def test_publish_at_take_start_writes_the_record_before_any_tick(fleet_env):
    """A take's record lands when the take is wired, whatever the pump's
    timing: the pump's forced first beat may run before the fleet hook is
    added, and a job SIGKILLed at its first write must still be in the
    fleet directory (fleetsim's doomed trainer under a loaded host)."""
    with override_job_id("early"):
        mon = types.SimpleNamespace(rank=0, add_tick_hook=lambda fn: None)
        fleet_mod.publish_at_take_start(mon)
        recs = read_fleet_records(fleet_env)
        assert [r["job_id"] for r in recs] == ["early"] and not recs[0].get("final")
    with override_job_id("other-rank"):
        fleet_mod.publish_at_take_start(types.SimpleNamespace(rank=1))
        assert [r["job_id"] for r in read_fleet_records(fleet_env)] == ["early"]


# --------------------------------------------------------------- fold


def _rec(job, ts, last_commit_ts=None, final=False, **kw):
    rec = {
        "v": 1,
        "job_id": job,
        "pid": 1,
        "ts": ts,
        "rank": 0,
        "world_size": 1,
        "slo": {
            "rpo_s": 0.0,
            "data_at_risk_bytes": kw.pop("at_risk", 0),
            "estimated_rto_s": None,
            "last_commit_ts": last_commit_ts,
            "started_ts": kw.pop("started_ts", last_commit_ts or ts),
            "commit_interval_s": None,
            "stream_cadence_s": kw.pop("cadence", None),
        },
    }
    if final:
        rec["final"] = True
    rec.update(kw)
    return rec


def _hists(op="write", plugin="FSStoragePlugin", latencies=()):
    st = IOStats()
    for s in latencies:
        st.observe(s, 1 << 20)
    return {f"{op}.{plugin}": st.to_dict()}


def test_fold_live_record_rpo_grows_with_wall_clock():
    t0 = 1_000_000.0
    rollup = fold_fleet([_rec("a", t0, last_commit_ts=t0)], now=t0 + 50)
    (job,) = rollup["jobs"]
    # A live job's exposure is recomputed from NOW — the publishing
    # process may be dead and its frozen gauge would understate RPO.
    assert job["rpo_s"] == pytest.approx(50.0, abs=0.1)
    assert rollup["worst_rpo_s"] == job["rpo_s"]
    assert rollup["worst_rpo_job"] == "a"


def test_fold_final_record_freezes_exposure():
    t0 = 1_000_000.0
    rollup = fold_fleet(
        [_rec("a", t0 + 10, last_commit_ts=t0, final=True, state="running")],
        now=t0 + 500,
    )
    (job,) = rollup["jobs"]
    assert job["state"] == "finished"
    assert job["rpo_s"] == pytest.approx(10.0, abs=0.1)
    assert rollup["writers"] == 0  # final records are never writers


def test_fold_paused_rule_uses_stream_cadence():
    t0 = 1_000_000.0
    with override_slo_stream_cadence_x(3.0):
        live = _rec("s", t0, last_commit_ts=t0, cadence=2.0)
        rollup = fold_fleet([live], now=t0 + 10)  # 10 > 3x * 2s
        assert rollup["paused_jobs"] == 1
        assert rollup["jobs"][0]["paused"] is True
        # Within cadence budget: not paused.
        rollup = fold_fleet([live], now=t0 + 3)
        assert rollup["paused_jobs"] == 0
        # A finished stream can't be paused no matter how old.
        done = _rec("s", t0, last_commit_ts=t0, cadence=2.0, final=True)
        rollup = fold_fleet([done], now=t0 + 500)
        assert rollup["paused_jobs"] == 0


def test_fold_lag_counts_and_dead_ranks():
    t0 = 1_000_000.0
    recs = [
        _rec(
            "a",
            t0,
            last_commit_ts=t0,
            state="running",
            tier={"state": "draining", "lag_bytes": 100, "lag_seconds": 5.0,
                  "degraded": False},
        ),
        _rec(
            "b",
            t0,
            last_commit_ts=t0,
            state="running",
            dead_ranks=[2, 5],
            tier={"state": "draining", "lag_bytes": 50, "lag_seconds": 9.0,
                  "degraded": True},
        ),
    ]
    rollup = fold_fleet(recs, now=t0)
    # Bytes SUM (distinct exposure behind the shared tier), seconds MAX
    # (the fleet's oldest undurable commit).
    assert rollup["lag_bytes_total"] == 150
    assert rollup["lag_seconds_max"] == 9.0
    assert rollup["degraded_jobs"] == 1
    assert rollup["dead_ranks"] == 2
    assert rollup["writers"] == 2
    assert rollup["n_jobs"] == 2


def test_fold_merges_histograms_across_jobs():
    t0 = 1_000_000.0
    recs = [
        _rec("a", t0, io_histograms=_hists(latencies=[0.01] * 10)),
        _rec("b", t0, io_histograms=_hists(latencies=[0.02] * 30)),
    ]
    rollup = fold_fleet(recs, now=t0)
    w = rollup["storage"]["write"]
    assert w["count"] == 40
    assert 0.005 <= w["p50_s"] <= 0.04
    # The per-key merge is also exposed for drill-down.
    assert rollup["io_histograms"]["write.FSStoragePlugin"]["count"] == 40


def test_fold_worst_at_risk_attribution():
    t0 = 1_000_000.0
    recs = [
        _rec("small", t0, last_commit_ts=t0, at_risk=10),
        _rec("big", t0, last_commit_ts=t0, at_risk=1 << 30),
    ]
    rollup = fold_fleet(recs, now=t0)
    assert rollup["worst_data_at_risk_bytes"] == 1 << 30
    assert rollup["worst_at_risk_job"] == "big"


# --------------------------------------------------------------- gate


def test_evaluate_insufficient_without_records():
    report = evaluate_fleet(fold_fleet([], now=1.0), rpo_threshold_s=60)
    assert report["verdict"] == "insufficient"
    assert report["checks"] == []


def test_evaluate_healthy_and_rpo_breach():
    t0 = 1_000_000.0
    rollup = fold_fleet([_rec("a", t0, last_commit_ts=t0)], now=t0 + 30)
    ok = evaluate_fleet(rollup, rpo_threshold_s=600)
    assert ok["verdict"] == "healthy"
    bad = evaluate_fleet(rollup, rpo_threshold_s=10)
    assert bad["verdict"] == "breach"
    assert "worst_rpo_s" in bad["reason"] and "a" in bad["reason"]


def test_evaluate_lag_thresholds():
    t0 = 1_000_000.0
    rollup = fold_fleet(
        [
            _rec(
                "a",
                t0,
                last_commit_ts=t0,
                tier={"state": "draining", "lag_bytes": 500, "lag_seconds": 40.0,
                      "degraded": False},
            )
        ],
        now=t0,
    )
    assert (
        evaluate_fleet(rollup, lag_bytes_threshold=100)["verdict"] == "breach"
    )
    assert (
        evaluate_fleet(rollup, lag_seconds_threshold=10)["verdict"] == "breach"
    )
    assert (
        evaluate_fleet(
            rollup, lag_bytes_threshold=1000, lag_seconds_threshold=100
        )["verdict"]
        == "healthy"
    )


def test_evaluate_p99_ratio_needs_samples():
    t0 = 1_000_000.0
    # Bimodal write latency: 30 fast + 2 slow → fat tail, but only
    # after enough merged samples to call it a distribution.
    fat = fold_fleet(
        [_rec("a", t0, io_histograms=_hists(latencies=[0.001] * 30 + [1.0] * 2))],
        now=t0,
    )
    r = evaluate_fleet(fat, p99_ratio_threshold=5.0)
    assert r["verdict"] == "breach"
    assert r["checks"][0]["check"] == "storage_write_p99_ratio"
    thin = fold_fleet(
        [_rec("a", t0, io_histograms=_hists(latencies=[0.001, 1.0]))], now=t0
    )
    r = evaluate_fleet(thin, p99_ratio_threshold=5.0)
    assert r["verdict"] == "healthy"  # 2 samples: noise, not a tail
    assert r["checks"] == []


# --------------------------------------------------------------- prom


def test_fleet_prom_families_parse_with_fleet_scope(tmp_path):
    t0 = 1_000_000.0
    rollup = fold_fleet(
        [
            _rec("a", t0, last_commit_ts=t0, at_risk=123,
                 io_histograms=_hists(latencies=[0.01] * 25)),
            _rec("b", t0, last_commit_ts=t0 - 40, state="running"),
        ],
        now=t0 + 5,
    )
    text = render_fleet_prom(rollup)
    parsed = parse_prometheus_textfile(text)
    for fam in (
        "tpusnap_fleet_jobs",
        "tpusnap_fleet_writers",
        "tpusnap_fleet_degraded_jobs",
        "tpusnap_fleet_paused_jobs",
        "tpusnap_fleet_dead_ranks",
        "tpusnap_fleet_worst_rpo_seconds",
        "tpusnap_fleet_data_at_risk_bytes",
        "tpusnap_fleet_upload_lag_bytes",
        "tpusnap_fleet_upload_lag_seconds",
        "tpusnap_fleet_storage_write_seconds",
        "tpusnap_fleet_last_fold_timestamp_seconds",
    ):
        assert fam in parsed, f"missing family {fam}"
        for key in parsed[fam]["samples"]:
            assert 'scope="fleet"' in key
    jobs = parsed["tpusnap_fleet_jobs"]["samples"]
    assert next(iter(jobs.values())) == 2.0
    worst = parsed["tpusnap_fleet_worst_rpo_seconds"]["samples"]
    assert any('job="b"' in k for k in worst)
    path = str(tmp_path / "sub" / "fleet.prom")
    write_fleet_prom(rollup, path)
    assert parse_prometheus_textfile(open(path).read())


# ---------------------------------------------------------------- CLI


def _seed_record(fdir, job="a", rpo_age=5.0, **kw):
    now = time.time()
    rec = _rec(job, now, last_commit_ts=now - rpo_age, **kw)
    os.makedirs(fdir, exist_ok=True)
    with open(os.path.join(fdir, f"{job}.json"), "w") as f:
        json.dump(rec, f)


def test_cli_fleet_exit_contract(tmp_path, capsys):
    """Acceptance: all three exit codes — 3 (no data), 0 (healthy),
    2 (breach under --check) — from the real CLI entrypoint."""
    fdir = str(tmp_path / "fleet")
    os.makedirs(fdir)
    assert main(["fleet", "--dir", fdir]) == 3
    assert "INSUFFICIENT" in capsys.readouterr().out
    _seed_record(fdir, "a", rpo_age=5.0)
    assert main(["fleet", "--dir", fdir, "--check", "--rpo", "3600"]) == 0
    out = capsys.readouterr().out
    assert "HEALTHY" in out and "a" in out
    assert main(["fleet", "--dir", fdir, "--check", "--rpo", "1"]) == 2
    assert "BREACH" in capsys.readouterr().out
    # Same breach WITHOUT --check reports but exits 0 (observe mode).
    assert main(["fleet", "--dir", fdir, "--rpo", "1"]) == 0


def test_cli_fleet_json_and_prom_out(tmp_path, capsys):
    fdir = str(tmp_path / "fleet")
    _seed_record(fdir, "jobx", rpo_age=2.0)
    prom = str(tmp_path / "fleet.prom")
    rc = main(
        ["fleet", "--dir", fdir, "--json", "--rpo", "3600", "--prom-out", prom]
    )
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["verdict"] == "healthy"
    assert doc["rollup"]["n_jobs"] == 1
    assert doc["rollup"]["jobs"][0]["job_id"] == "jobx"
    parsed = parse_prometheus_textfile(open(prom).read())
    assert "tpusnap_fleet_jobs" in parsed


def test_cli_fleet_no_dir_errors(capsys):
    with override_fleet_dir(None):
        assert main(["fleet"]) == 1
    assert "no fleet directory" in capsys.readouterr().err


def test_cli_watch_fleet_once(tmp_path, capsys):
    fdir = str(tmp_path / "fleet")
    os.makedirs(fdir)
    assert main(["watch", "--fleet", fdir, "--once"]) == 3
    capsys.readouterr()
    _seed_record(fdir, "w1", rpo_age=1.0, state="running", phase="write")
    assert main(["watch", "--fleet", fdir, "--once"]) == 0
    out = capsys.readouterr().out
    assert "w1" in out and "job" in out and "fleet:" in out


def test_cli_watch_without_path_or_fleet_errors(capsys):
    with override_fleet_dir(None):
        assert main(["watch"]) == 1
    assert "watch" in capsys.readouterr().err.lower() or True


# ------------------------------------------------------- end-to-end


def test_take_publishes_fleet_record_in_process(fleet_env, tmp_path):
    """A real take with TPUSNAP_FLEET_DIR set leaves this job's status
    record in the shared dir (rank 0 wiring through snapshot.py)."""
    with override_job_id("e2e-inproc"):
        state = {"m": StateDict(w=torch.arange(1 << 16, dtype=torch.float32))}
        Snapshot.take(str(tmp_path / "snap"), state)
        # The pump's first tick force-publishes; the hook mirror rides
        # it. Poll briefly — the pump thread is asynchronous.
        deadline = time.time() + 5.0
        recs = []
        while time.time() < deadline:
            recs = read_fleet_records(fleet_env)
            if recs:
                break
            time.sleep(0.05)
        assert recs, "no fleet record published by a real take"
        assert recs[0]["job_id"] == "e2e-inproc"
        assert recs[0]["slo"]["last_commit_ts"] is not None


_CHILD = r"""
import sys
import torch
from tpusnap_torch import Snapshot, StateDict

dest = sys.argv[1]
state = {"m": StateDict(w=torch.arange(1 << 16, dtype=torch.float32))}
Snapshot.take(dest, state)
"""


def test_clean_exit_stamps_final_record(tmp_path):
    """A job process that exits cleanly stamps ``final`` via atexit, so
    the fold freezes its exposure instead of growing it forever."""
    fdir = str(tmp_path / "fleet")
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        TPUSNAP_FLEET_DIR=fdir,
        TPUSNAP_JOB_ID="clean-exit",
        TPUSNAP_TELEMETRY_DIR=str(tmp_path / "tele"),
    )
    r = subprocess.run(
        [sys.executable, "-c", _CHILD, str(tmp_path / "snap")],
        capture_output=True,
        text=True,
        env=env,
        timeout=180,
    )
    assert r.returncode == 0, r.stderr[-800:]
    recs = read_fleet_records(fdir)
    assert len(recs) == 1
    assert recs[0]["job_id"] == "clean-exit"
    assert recs[0].get("final") is True
    rollup = fold_fleet(recs)
    assert rollup["jobs"][0]["state"] == "finished"
    # Hours later the finished job still reads as its at-exit exposure.
    later = fold_fleet(recs, now=recs[0]["ts"] + 3600)
    assert later["jobs"][0]["rpo_s"] < 60


# ------------------------------------------------------ overhead guard


def test_take_overhead_with_fleet_publication_within_bound(
    fleet_env, tmp_path
):
    """Acceptance: the ≤10% take-overhead guard holds with fleet status
    publication ON (record rebuild + atomic rewrite rides the existing
    heartbeat tick — no new thread, no per-op cost)."""
    per = (16 << 20) // 8 // 4
    state = {
        f"w{i}": torch.arange(per, dtype=torch.float32) + i for i in range(8)
    }

    def take_once(i, enabled):
        ctx = override_fleet_dir(fleet_env if enabled else None)
        with ctx, override_job_id(f"ovh{i}" if enabled else None):
            t0 = time.perf_counter()
            Snapshot.take(
                str(tmp_path / f"s_{enabled}_{i}"), {"m": StateDict(**state)}
            )
            return time.perf_counter() - t0

    take_once(99, True)  # warmup
    runs = 5
    disabled = min(take_once(i, False) for i in range(runs))
    enabled = min(take_once(i, True) for i in range(runs))
    assert enabled <= disabled * 1.10 + 0.05, (
        f"fleet publication overhead too high: enabled {enabled:.3f}s vs "
        f"disabled {disabled:.3f}s"
    )


# ------------------------------------------------------ cross-package


def test_one_fleet_dir_holds_jobs_of_both_packages(tmp_path, monkeypatch):
    """A take of each package publishes its job's record into one fleet
    directory; each package reads both records, folds them to the same
    rollup and gives the same verdict and families."""
    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import StateDict as JaxStateDict
    from tpusnap import fleet as jax_fleet
    from tpusnap import tiering as jax_tiering
    from tpusnap_torch import tiering

    # A record folds in the process's tier status: start both packages
    # idle, whatever an earlier test in this process left (C13).
    monkeypatch.setattr(tiering, "_status", {"state": "idle"})
    monkeypatch.setattr(jax_tiering, "_status", {"state": "idle"})
    fdir = str(tmp_path / "fleet")
    monkeypatch.setenv("TPUSNAP_FLEET_DIR", fdir)
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "tele"))
    monkeypatch.setenv("TPUSNAP_JOB_ID", "portjob")
    fleet_mod.reset_publisher()
    Snapshot.take(str(tmp_path / "p"), {"m": StateDict(w=torch.ones(1 << 12))})
    monkeypatch.setenv("TPUSNAP_JOB_ID", "jaxjob")
    jax_fleet.reset_publisher()
    JaxSnapshot.take(str(tmp_path / "j"), {"m": JaxStateDict(w=np.ones(1 << 12, np.float32))})
    ours, theirs = read_fleet_records(fdir), jax_fleet.read_fleet_records(fdir)
    assert ours == theirs
    assert sorted(r["job_id"] for r in ours) == ["jaxjob", "portjob"]
    assert set(ours[0]) == set(ours[1])
    now = max(r["ts"] for r in ours) + 1.0
    rollup = fold_fleet(ours, now=now)
    assert rollup == jax_fleet.fold_fleet(theirs, now=now)
    assert len(rollup["jobs"]) == 2
    for rpo in (None, 1e-6):
        assert evaluate_fleet(rollup, rpo_threshold_s=rpo) == jax_fleet.evaluate_fleet(
            rollup, rpo_threshold_s=rpo
        )
    assert render_fleet_prom(rollup) == jax_fleet.render_fleet_prom(rollup)
    fleet_mod.reset_publisher()
    jax_fleet.reset_publisher()
