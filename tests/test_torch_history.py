"""Cross-run history of the port, mirrored from tests/test_history.py
(recording from real takes and restores, cold tagging, aborted takes
excluded, a torn final line, the size bound, the regression check and
the ``history`` CLI), plus cross-package checks: ``event_from_summary``
gives tpusnap's event on the same summary, and one history file that
both packages append to loads the same in each.
"""

import json
import os

import numpy as np
import torch
import pytest

from tpusnap_torch import (
    FaultPlan,
    PytreeState,
    Snapshot,
    check_regression,
    load_history,
    record_event,
)
from tpusnap_torch import history as hist
from tpusnap_torch.__main__ import main
from tpusnap_torch.knobs import (
    override_history_enabled,
    override_history_max_bytes,
    override_telemetry_dir,
)


def _state(total_bytes=1 << 20, n=2):
    per = max(total_bytes // n // 4, 16)
    return {f"w{i}": torch.arange(per, dtype=torch.float32) + i for i in range(n)}


@pytest.fixture
def history_env(tmp_path):
    """Isolated telemetry dir + fresh per-process cold-tag state."""
    with override_telemetry_dir(str(tmp_path / "tele")):
        hist._reset_process_state()
        yield hist.history_path()
    hist._reset_process_state()


def _synth(i, gbps, kind="take", world=1, **kw):
    return {
        "v": 1,
        "ts": 1e9 + i,
        "kind": kind,
        "rank": 0,
        "world_size": world,
        "wall_s": 2.0,
        "bytes": int(gbps * 2e9),
        "throughput_gbps": gbps,
        **kw,
    }


# -------------------------------------------------------------- recording


def test_take_and_restore_record_history(tmp_path, history_env):
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": PytreeState(_state())})
    target = {k: torch.zeros_like(v) for k, v in _state().items()}
    Snapshot(path).restore({"m": PytreeState(target)})
    Snapshot.take(str(tmp_path / "snap2"), {"m": PytreeState(_state())})
    events = load_history()
    kinds = [e["kind"] for e in events]
    assert kinds == ["take", "restore", "take"]
    take1, restore, take2 = events
    assert take1["bytes"] > 0 and take1["throughput_gbps"] > 0
    assert take1["wall_s"] > 0 and take1["world_size"] == 1
    assert take1["take_id"] and take1["path"] == path
    assert "stage" in take1["phases_s"]
    assert restore["bytes"] > 0 and "restore.read" in restore["phases_s"]
    # First event of each KIND in the process is cold-tagged; later ones
    # are not (the regression check's warmup awareness rides this).
    assert take1.get("cold") is True
    assert restore.get("cold") is True
    assert "cold" not in take2


def test_incomplete_summary_not_recorded(history_env):
    assert (
        hist.record_summary(
            "take", {"rank": 0, "take_wall_s": 1.0, "counters": {}}
        )
        is None
    )
    assert not os.path.exists(history_env)


@pytest.mark.chaos
def test_failed_take_not_recorded(tmp_path, history_env):
    with pytest.raises(Exception):
        Snapshot.take(
            "chaos+fs://" + str(tmp_path / "snap"),
            {"m": PytreeState(_state())},
            storage_options={
                "retry": False,
                "fault_plan": FaultPlan(seed=1, transient_per_op=100),
            },
        )
    assert [e["kind"] for e in load_history()] == []


def test_history_disabled_knob(tmp_path, history_env):
    with override_history_enabled(False):
        Snapshot.take(str(tmp_path / "snap"), {"m": PytreeState(_state())})
    assert not os.path.exists(history_env)
    assert load_history() == []


# ------------------------------------------------------- crash tolerance


def test_torn_final_line_survives(history_env):
    for i in range(3):
        record_event(_synth(i, 1.0))
    # Crash mid-append: a torn final line with no newline.
    with open(history_env, "ab") as f:
        f.write(b'{"v":1,"kind":"take","thro')
    events = load_history()
    assert len(events) == 3  # torn tail dropped, earlier lines intact
    # The next append isolates the torn fragment on its own line
    # instead of concatenating onto it.
    record_event(_synth(3, 1.0))
    events = load_history()
    assert len(events) == 4
    assert events[-1]["ts"] == 1e9 + 3


def test_size_bound_compaction(history_env):
    with override_history_max_bytes(1):  # floor: 64 KiB
        pad = "x" * 150  # ~200B/line -> bound crossed well within 600
        for i in range(600):
            record_event(_synth(i, 1.0, note=pad))
        assert os.path.getsize(history_env) <= 64 * 1024
        events = load_history()
        assert events, "compaction must keep the newest lines"
        assert events[-1]["ts"] == 1e9 + 599  # newest survives
        assert events[0]["ts"] > 1e9  # oldest did not
        for e in events:
            assert e["note"] == pad  # every surviving line parses whole


# ------------------------------------------------------ regression check


def test_check_regression_flags_throughput_drop():
    events = [_synth(i, 1.0 + 0.01 * i) for i in range(10)]
    events.append(_synth(10, 0.5))
    r = check_regression(events, threshold=0.25)
    assert r.ok and r.regressed
    assert "below" in r.reason
    assert r.baseline_median == pytest.approx(1.04, abs=0.01)


def test_check_regression_ok_within_threshold():
    events = [_synth(i, 1.0) for i in range(10)]
    events.append(_synth(10, 0.9))
    r = check_regression(events, threshold=0.25)
    assert r.ok and not r.regressed


def test_check_cold_latest_passes():
    """Acceptance: a cold-run-only outlier (warmup) must NOT flag."""
    events = [_synth(i, 1.0) for i in range(10)]
    events.append(_synth(10, 0.2, cold=True))
    r = check_regression(events, threshold=0.25)
    assert r.ok and not r.regressed
    assert "cold" in r.reason


def test_check_all_cold_fleet_grades_cold_vs_cold():
    """One-take-per-process fleets tag EVERY event cold; the gate must
    grade cold runs against the trailing cold baseline like-for-like
    instead of being structurally green."""
    events = [_synth(i, 1.0, cold=True) for i in range(8)]
    events.append(_synth(8, 0.4, cold=True))
    r = check_regression(events, threshold=0.25)
    assert r.ok and r.regressed
    assert "cold-vs-cold" in r.reason
    # Healthy all-cold trend still passes.
    r = check_regression(events[:-1], threshold=0.25)
    assert r.ok and not r.regressed


def test_check_cold_events_excluded_from_baseline():
    # A cold crawl at the head must not drag the median down and mask a
    # real regression.
    events = [_synth(0, 0.1, cold=True)]
    events += [_synth(i, 1.0) for i in range(1, 6)]
    events.append(_synth(6, 0.6))
    r = check_regression(events, threshold=0.25)
    assert r.regressed
    assert r.baseline_median == pytest.approx(1.0)


def test_check_insufficient_history():
    r = check_regression([_synth(0, 1.0), _synth(1, 0.1)], min_baseline=3)
    assert not r.ok and not r.regressed
    r = check_regression([], min_baseline=3)
    assert not r.ok and not r.regressed


def test_check_world_size_mismatch_excluded():
    events = [_synth(i, 4.0, world=8) for i in range(10)]
    events += [_synth(10 + i, 1.0) for i in range(4)]
    # Latest is world=1: the world=8 runs are incommensurable and must
    # not form its baseline.
    r = check_regression(events, threshold=0.25)
    assert r.ok and not r.regressed
    assert r.n_baseline == 3


def test_check_incremental_takes_separated_from_full():
    """An incremental take writes only the delta — its written-bytes
    throughput must not pool with full takes' (either direction would
    corrupt the gate)."""
    events = [_synth(i, 1.0) for i in range(6)]
    # A healthy incremental take with low written-bytes throughput must
    # not flag against the full-take baseline...
    events.append(_synth(6, 0.3, incremental=True))
    r = check_regression(events, threshold=0.25)
    assert not r.ok and not r.regressed  # no incremental baseline yet
    # ...and must not dilute the full-take baseline either: a real
    # full-take regression still flags with incrementals interleaved.
    events += [_synth(7 + i, 0.3, incremental=True) for i in range(5)]
    events.append(_synth(12, 0.5))
    r = check_regression(events, threshold=0.25)
    assert r.regressed and r.baseline_median == pytest.approx(1.0)
    # And incremental runs gate against their own population.
    events.append(_synth(13, 0.1, incremental=True))
    r = check_regression(events, threshold=0.25)
    assert r.regressed and r.baseline_median == pytest.approx(0.3)


def test_check_latest_without_metric_is_not_silently_skipped():
    """A gate that grades a stale run while the newest one has no value
    for the metric would read as OK exactly when things broke."""
    events = [_synth(i, 1.0) for i in range(5)]
    no_metric = _synth(5, 1.0)
    no_metric["throughput_gbps"] = None
    events.append(no_metric)
    r = check_regression(events, threshold=0.25)
    assert not r.ok and not r.regressed
    assert "no value" in r.reason


def test_check_duration_metric_regresses_upward():
    events = [_synth(i, 1.0) for i in range(6)]
    slow = _synth(6, 1.0)
    slow["wall_s"] = 4.0
    events.append(slow)
    r = check_regression(events, metric="wall_s", threshold=0.25)
    assert r.regressed and "slower" in r.reason


def test_check_window_limits_baseline():
    events = [_synth(i, 10.0) for i in range(20)]
    events += [_synth(20 + i, 1.0) for i in range(5)]
    events.append(_synth(30, 0.9))
    r = check_regression(events, window=5, threshold=0.25)
    assert r.ok and not r.regressed  # old 10.0 era aged out of the window
    assert r.n_baseline == 5


# ------------------------------------------------------------------- CLI


def test_history_cli_table_json_and_check(history_env, capsys):
    for i in range(8):
        record_event(_synth(i, 1.0))
    assert main(["history"]) == 0
    out = capsys.readouterr().out
    assert "take" in out and "GB/s" in out
    assert main(["history", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert len(doc["events"]) == 8
    assert main(["history", "--check"]) == 0
    capsys.readouterr()
    # Synthetic >threshold regression: exit 2 (the CI gate).
    record_event(_synth(8, 0.3))
    assert main(["history", "--check"]) == 2
    assert "REGRESSION" in capsys.readouterr().out
    assert main(["history", "--check", "--json"]) == 2
    doc = json.loads(capsys.readouterr().out)
    # The machine-readable contract NAMES each regressed metric and
    # carries its latest/baseline/window values.
    assert doc["regressed"] == ["throughput_gbps"]
    assert doc["ok"] is False
    (check,) = doc["checks"]
    assert check["metric"] == "throughput_gbps"
    assert check["latest"] == pytest.approx(0.3)
    assert check["baseline_median"] == pytest.approx(1.0)
    assert check["window"] == 20 and check["n_baseline"] >= 3
    # A cold-run-only outlier on top: exit 0.
    record_event(_synth(9, 0.2, cold=True))
    assert main(["history", "--check"]) == 0
    assert "cold" in capsys.readouterr().out
    # Loose threshold tolerates the earlier regression too.
    record_event(_synth(10, 0.9))
    assert main(["history", "--check", "--threshold", "0.95"]) == 0
    capsys.readouterr()


def test_history_cli_empty_and_insufficient(history_env, capsys):
    assert main(["history"]) == 3
    assert "no history" in capsys.readouterr().err
    assert main(["history", "--check"]) == 3
    capsys.readouterr()
    record_event(_synth(0, 1.0))
    record_event(_synth(1, 1.0))
    assert main(["history", "--check"]) == 3  # < min-baseline comparable
    assert "INSUFFICIENT" in capsys.readouterr().out


def test_history_cli_check_rejects_kind_all(history_env, capsys):
    record_event(_synth(0, 1.0))
    assert main(["history", "--kind", "all", "--check"]) == 1
    assert "one event kind" in capsys.readouterr().err


def test_history_cli_kind_filter(history_env, capsys):
    record_event(_synth(0, 1.0))
    record_event(_synth(1, 2.5, kind="bench", roofline_fraction=0.9))
    assert main(["history", "--kind", "bench", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert [e["kind"] for e in doc["events"]] == ["bench"]
    assert main(["history", "--kind", "all", "--json"]) == 0
    assert len(json.loads(capsys.readouterr().out)["events"]) == 2


def test_history_cli_multi_metric_check(history_env, capsys):
    """One gate invocation covers throughput AND p99 write latency:
    only the latency regresses; the JSON names it, exit 2 fires."""
    for i in range(8):
        record_event(_synth(i, 1.0, storage_write_p99_s=0.01))
    # Throughput fine, p99 write latency 10x (a *_s metric: upward).
    record_event(_synth(8, 1.0, storage_write_p99_s=0.1))
    rc = main(
        [
            "history",
            "--check",
            "--metric",
            "throughput_gbps",
            "--metric",
            "storage_write_p99_s",
            "--json",
        ]
    )
    doc = json.loads(capsys.readouterr().out)
    assert rc == 2
    assert doc["regressed"] == ["storage_write_p99_s"]
    by_metric = {c["metric"]: c for c in doc["checks"]}
    assert by_metric["throughput_gbps"]["regressed"] is False
    assert by_metric["storage_write_p99_s"]["regressed"] is True
    assert by_metric["storage_write_p99_s"]["latest"] == pytest.approx(0.1)
    assert by_metric["storage_write_p99_s"]["baseline_median"] == pytest.approx(
        0.01
    )
    # Comma-splitting is equivalent to repeating the flag.
    assert (
        main(
            [
                "history",
                "--check",
                "--metric",
                "throughput_gbps,storage_write_p99_s",
            ]
        )
        == 2
    )
    assert "storage_write_p99_s" in capsys.readouterr().out


def test_history_cli_multi_metric_partial_coverage_passes(
    history_env, capsys
):
    """A metric absent from the events cannot be checked, but the gate
    passes while a checkable metric is green (a fleet upgrading to the
    histogram fields must not fail until old events age out)."""
    for i in range(8):
        record_event(_synth(i, 1.0))  # no storage_write_p99_s anywhere
    rc = main(
        [
            "history",
            "--check",
            "--metric",
            "throughput_gbps",
            "--metric",
            "storage_write_p99_s",
            "--json",
        ]
    )
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["regressed"] == []
    # ...and when NO metric can form a verdict: exit 3, as ever.
    assert (
        main(["history", "--check", "--metric", "no_such_metric"]) == 3
    )
    capsys.readouterr()


def test_event_from_summary_carries_write_latency_quantiles():
    """Take summaries with io_histograms produce gateable
    storage_write_p50_s/p99_s event fields (merged across plugins)."""
    from tpusnap_torch.telemetry import IOStats

    st = IOStats()
    for _ in range(98):
        st.observe(0.004, 1 << 20)
    st.observe(0.4, 1 << 20)
    st.observe(0.4, 1 << 20)
    summary = {
        "rank": 0,
        "take_wall_s": 2.0,
        "counters": {"storage.bytes_written": 100 << 20},
        "io_histograms": {
            "write.FSStoragePlugin": st.to_dict(),
            "read.FSStoragePlugin": IOStats().to_dict(),
        },
    }
    ev = hist.event_from_summary("take", summary)
    assert ev["storage_write_p50_s"] <= 0.009
    assert ev["storage_write_p99_s"] >= 0.25
    # No histograms -> no fields (old events stay shaped as before).
    ev2 = hist.event_from_summary("take", {"take_wall_s": 1.0})
    assert "storage_write_p99_s" not in ev2


# --------------------------------------------------------- job identity


def test_events_carry_explicit_job_id_only(tmp_path, history_env):
    from tpusnap_torch.knobs import override_job_id

    with override_job_id(None):
        Snapshot.take(str(tmp_path / "s1"), {"m": PytreeState(_state())})
    with override_job_id("exp-a"):
        Snapshot.take(str(tmp_path / "s2"), {"m": PytreeState(_state())})
    anon, named = load_history()
    # The host-pid DEFAULT is deliberately absent from history: it
    # changes every process and would empty every cross-run baseline.
    assert anon.get("job_id") is None
    assert named["job_id"] == "exp-a"


def test_check_regression_separates_job_ids():
    """Two named jobs interleaved in one shared history must never
    grade against each other; absent ids stay comparable (old
    histories keep their baselines)."""
    events = [_synth(i, 4.0, job_id="fast-job") for i in range(8)]
    events += [_synth(10 + i, 1.0, job_id="slow-job") for i in range(4)]
    # slow-job's latest 1.0 is healthy against ITS OWN 1.0 baseline —
    # pooling with fast-job's 4.0s would flag a phantom regression.
    r = check_regression(events, threshold=0.25)
    assert r.ok and not r.regressed
    assert r.n_baseline == 3
    # A real within-job regression still flags.
    events.append(_synth(20, 0.3, job_id="slow-job"))
    r = check_regression(events, threshold=0.25)
    assert r.regressed and r.baseline_median == pytest.approx(1.0)
    # Absent job_id (pre-knob histories + unset knob) stays one
    # comparable population.
    legacy = [_synth(i, 1.0) for i in range(6)] + [_synth(6, 0.5)]
    r = check_regression(legacy, threshold=0.25)
    assert r.regressed


# ----------------------------------------------- concurrent-append soak


_SOAK_CHILD = r"""
import os, sys, time
from tpusnap_torch.history import record_event

path = sys.argv[1]
writer = int(sys.argv[2])
n = int(sys.argv[3])
for i in range(n):
    ev = {
        "v": 1,
        "ts": 1e9 + writer * 10000 + i,
        "kind": "soak",
        "rank": 0,
        "writer": writer,
        "i": i,
        "pad": "x" * 120,
    }
    assert record_event(ev, path=path) is not None
print("DONE", writer)
"""


def _run_soak_writers(path, n_writers, n_events, env):
    import subprocess
    import sys as _sys

    procs = [
        subprocess.Popen(
            [_sys.executable, "-c", _SOAK_CHILD, path, str(w), str(n_events)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
        )
        for w in range(n_writers)
    ]
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err[-800:]
        assert "DONE" in out


def _parse_all_lines(path):
    """Every line in the file must be a whole JSON event — the torn/
    interleaved-write failure mode this soak hunts."""
    events = []
    with open(path, "rb") as f:
        for ln in f.read().split(b"\n"):
            if not ln.strip():
                continue
            events.append(json.loads(ln))  # raises on any corrupt line
    return events


@pytest.mark.chaos
def test_concurrent_append_soak_no_corruption(tmp_path):
    """N processes hammering one history.jsonl via O_APPEND: every
    event lands exactly once, no interleaved or torn lines."""
    import os as _os

    path = str(tmp_path / "tele" / "history.jsonl")
    env = dict(
        _os.environ,
        JAX_PLATFORMS="cpu",
        TPUSNAP_HISTORY_MAX_BYTES=str(8 << 20),  # bound never trips
    )
    n_writers, n_events = 6, 40
    _run_soak_writers(path, n_writers, n_events, env)
    events = _parse_all_lines(path)
    assert len(events) == n_writers * n_events
    seen = {(e["writer"], e["i"]) for e in events}
    assert len(seen) == n_writers * n_events  # exactly once each
    for e in events:
        assert e["pad"] == "x" * 120  # payload intact, not spliced


@pytest.mark.chaos
def test_concurrent_append_soak_with_compaction(tmp_path):
    """Same soak with the size bound small enough that compaction runs
    CONCURRENTLY with other writers: every surviving line is still a
    whole, bit-exact event (compaction never keeps a torn line or
    tears a complete one), and the newest events survive it."""
    import os as _os

    path = str(tmp_path / "tele" / "history.jsonl")
    env = dict(
        _os.environ,
        JAX_PLATFORMS="cpu",
        # Knob floor is 64 KiB; ~170 B/event x 6 x 120 ≈ 120 KiB total,
        # so the bound trips repeatedly mid-soak.
        TPUSNAP_HISTORY_MAX_BYTES="1",
    )
    n_writers, n_events = 6, 120
    _run_soak_writers(path, n_writers, n_events, env)
    events = _parse_all_lines(path)
    assert events, "compaction must keep the newest lines"
    assert os.path.getsize(path) <= 64 * 1024 + 32 * 1024
    for e in events:
        assert e["kind"] == "soak"
        assert 0 <= e["writer"] < n_writers and 0 <= e["i"] < n_events
        assert e["pad"] == "x" * 120
    # The newest whole events survive: at least one writer's final
    # event (the last appends happen after the last compaction).
    finals = {(e["writer"], e["i"]) for e in events}
    assert any((w, n_events - 1) in finals for w in range(n_writers))


# ------------------------------------------------------ cross-package


def _summaries(tmp_path):
    """Real summaries of a take and a restore from each package, on the
    same numpy inputs, and a synthetic one carrying every optional
    section the event copies."""
    from tpusnap import PytreeState as JaxPytreeState
    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import telemetry as jax_telemetry
    from tpusnap_torch import telemetry

    arrays = {f"w{i}": np.arange(4096, dtype=np.float32) + i for i in range(3)}
    out = {}
    JaxSnapshot.take(str(tmp_path / "j"), {"m": JaxPytreeState(dict(arrays))})
    out["jax_take"] = jax_telemetry.LAST_TAKE_SUMMARY
    JaxSnapshot(str(tmp_path / "j")).restore(
        {"m": JaxPytreeState({k: np.zeros_like(v) for k, v in arrays.items()})}
    )
    out["jax_restore"] = jax_telemetry.LAST_RESTORE_SUMMARY
    tensors = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    Snapshot.take(str(tmp_path / "p"), {"m": PytreeState(tensors)})
    out["port_take"] = telemetry.LAST_TAKE_SUMMARY
    Snapshot(str(tmp_path / "p")).restore(
        {"m": PytreeState({k: torch.zeros_like(v) for k, v in tensors.items()})}
    )
    out["port_restore"] = telemetry.LAST_RESTORE_SUMMARY
    out["synthetic"] = {
        "rank": 1,
        "world_size": 2,
        "completed": True,
        "take_wall_s": 2.5,
        "counters": {
            "storage.bytes_written": 10 << 20,
            "scheduler.dedup_skipped_bytes": 1 << 20,
            "compress.bytes_in": 4 << 20,
            "compress.bytes_out": 1 << 20,
        },
        "gauges": {"scheduler.budget_used_bytes": 123.0},
        "phases": {"stage": 1.0, "io_drain": 1.5},
        "probe": {"probes": 2, "write_gbps_p50": 1.5, "read_gbps_p50": 3.0},
        "roofline_fraction": 0.5,
        "meta": {
            "kind": "take",
            "completed": True,
            "incremental": True,
            "plugin": "FSStoragePlugin",
            "tuned": {"plan_id": "abc", "knobs": {"TPUSNAP_STAGE_THREADS": "2"}},
            "slo": {"rpo_s": 1.0, "data_at_risk_bytes": 0},
            "access": {"bytes_read": 5, "reads": 1, "working_set_bytes": 5},
            "compress": {"mode": "auto", "compress": False, "reason": "pipe_fast"},
        },
    }
    return out


def test_event_from_summary_matches_tpusnap(tmp_path, history_env, monkeypatch):
    from tpusnap import history as jax_hist

    monkeypatch.setattr(hist, "_wall", lambda: 1234.5)
    monkeypatch.setattr(jax_hist, "_wall", lambda: 1234.5)
    monkeypatch.setenv("TPUSNAP_JOB_ID", "crossjob")
    with override_history_enabled(False):
        summaries = _summaries(tmp_path)
    for name, summary in sorted(summaries.items()):
        for kind in ("take", "restore"):
            assert hist.event_from_summary(kind, summary) == jax_hist.event_from_summary(
                kind, summary
            ), (name, kind)


def test_one_history_file_loads_the_same_in_both_packages(tmp_path, history_env):
    """Both packages default to the same file under the telemetry dir:
    takes and restores of each append to it, and each package's
    ``load_history`` and ``check_regression`` read all of it alike."""
    from tpusnap import history as jax_hist

    jax_hist._reset_process_state()
    _summaries(tmp_path)
    path = hist.history_path()
    ours = load_history(path)
    theirs = jax_hist.load_history(path)
    assert ours == theirs
    assert [e["kind"] for e in ours] == ["take", "restore", "take", "restore"]
    for i in range(4):
        record_event(_synth(i, 2.0))
        jax_hist.record_event(_synth(10 + i, 2.0))
    a = check_regression(load_history(path))
    b = jax_hist.check_regression(jax_hist.load_history(path))
    assert vars(a) == vars(b)
