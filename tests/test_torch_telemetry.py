"""The port's telemetry against tpusnap's: the mirror of
``tests/test_telemetry.py`` for ``tpusnap_torch`` (span and counter
recording, the knob, persisted Chrome traces, the cross-rank rollup in
``metadata.extras["telemetry"]``, chaos faults and retries in the trace,
the RSS sampler), plus the parity of the two packages: the same phase and
span names on the same take, the same rollup keys, and tpusnap's
``trace`` command reading a port snapshot. No wall-clock bound here: the
overhead is measured on the card (``chip_smoke.py``).
"""

import json
import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

from tpusnap_torch import PytreeState, Snapshot, StateDict, telemetry
from tpusnap_torch.faults import FaultPlan
from tpusnap_torch.knobs import is_telemetry_enabled, override_telemetry_enabled
from tpusnap_torch.telemetry import (
    MetricsSink,
    TakeTelemetry,
    metrics_sink,
    rollup_summaries,
    telemetry_rank_path,
)


def _np_state(total_bytes=1 << 20, n=2):
    per = max(total_bytes // n // 4, 16)
    return {f"w{i}": np.arange(per, dtype=np.float32) + i for i in range(n)}


def _state(total_bytes=1 << 20, n=2):
    return {k: torch.from_numpy(v) for k, v in _np_state(total_bytes, n).items()}


def _trace_file(snap_path, rank=0):
    return os.path.join(snap_path, ".tpusnap", "telemetry", f"rank_{rank}.json")


def test_telemetry_knob_default_on():
    assert is_telemetry_enabled()


def test_telemetry_knob_env_and_override(monkeypatch):
    monkeypatch.setenv("TPUSNAP_TELEMETRY", "0")
    assert not is_telemetry_enabled()
    monkeypatch.setenv("TPUSNAP_TELEMETRY", "1")
    assert is_telemetry_enabled()
    with override_telemetry_enabled(False):
        assert not is_telemetry_enabled()
        with override_telemetry_enabled(True):
            assert is_telemetry_enabled()
        assert not is_telemetry_enabled()
    assert is_telemetry_enabled()


def test_span_recording_and_summary_aggregates():
    rec = TakeTelemetry(rank=3, enabled=True)
    rec.record_span("x", 0.0, 0.2)
    rec.record_span("x", 0.2, 0.4)
    rec.record_span("x", 0.6, 0.6)
    rec.record_span("p", 0.0, 1.0, phase=True)
    rec.incr("c", 2)
    rec.incr("c")
    rec.gauge_max("g", 5.0)
    rec.gauge_max("g", 3.0)
    rec.finalize()
    s = rec.summary()
    assert s["rank"] == 3
    assert s["stages"]["x"]["count"] == 3
    assert s["stages"]["x"]["max_s"] == pytest.approx(0.6)
    assert s["stages"]["x"]["p50_s"] == pytest.approx(0.4)
    assert s["stages"]["x"]["total_s"] == pytest.approx(1.2)
    assert s["counters"]["c"] == 3
    assert s["gauges"]["g"] == 5.0
    assert s["phases"] == {"p": 1.0}


def test_spans_disabled_counters_still_on():
    rec = TakeTelemetry(rank=0, enabled=False)
    with rec.span("never"):
        pass
    rec.record_span("never", 0.0, 1.0)
    rec.event("never")
    rec.incr("still_counted")
    rec.finalize()
    s = rec.summary()
    assert s["stages"] == {}
    assert s["counters"] == {"still_counted": 1}
    assert not s["enabled"]


def test_counters_atomic_across_threads():
    rec = TakeTelemetry(rank=0, enabled=True)

    def bump():
        for _ in range(500):
            rec.incr("hits")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rec.finalize()
    assert rec.summary()["counters"]["hits"] == 8 * 500


def test_module_incr_updates_global_and_current():
    telemetry.reset_global_counters()
    rec = telemetry.begin_take(rank=0)
    try:
        telemetry.incr("test.counter", 2)
        assert telemetry.counter_value("test.counter") == 2
        assert rec.summary()["counters"]["test.counter"] == 2
    finally:
        telemetry.end_take(rec)
    telemetry.incr("test.counter")
    assert telemetry.counter_value("test.counter") == 3


def test_chrome_trace_events_shape():
    rec = TakeTelemetry(rank=1, enabled=True)
    with rec.span("work", phase=True, bytes=10):
        pass
    rec.event("boom", kind="write")
    rec.finalize()
    events = rec.chrome_trace_events()
    complete = [e for e in events if e.get("ph") == "X"]
    instants = [e for e in events if e.get("ph") == "i"]
    assert len(complete) == 1 and len(instants) == 1
    ev = complete[0]
    assert ev["name"] == "work" and ev["pid"] == 1
    assert ev["args"] == {"bytes": 10}
    assert isinstance(json.loads(rec.to_json())["traceEvents"], list)


def test_rollup_summaries():
    a = {
        "take_wall_s": 1.0, "phase_coverage": 0.95,
        "stages": {"stage": {"count": 1, "total_s": 0.6, "p50_s": 0.6, "max_s": 0.6}},
        "counters": {"retry.attempts": 2, "storage.bytes_written": 100},
        "gauges": {"scheduler.budget_used_bytes": 50.0},
    }
    b = {
        "take_wall_s": 2.0, "phase_coverage": 0.91,
        "stages": {"stage": {"count": 1, "total_s": 0.8, "p50_s": 0.8, "max_s": 0.8}},
        "counters": {"retry.attempts": 1, "storage.bytes_written": 200},
        "gauges": {"scheduler.budget_used_bytes": 80.0},
    }
    r = rollup_summaries([a, b])
    assert r["ranks"] == 2
    assert r["take_wall_s"] == 2.0
    assert r["phase_coverage_min"] == 0.91
    assert r["stages"]["stage"]["max_s"] == pytest.approx(0.8)
    assert r["counters"]["retry.attempts"] == 3
    assert r["retry_attempts"] == 3
    assert r["bytes_written"] == 300
    assert r["budget_high_water_bytes"] == 80.0
    assert rollup_summaries([]) == {}


def test_metrics_sink_callbacks(tmp_path):
    seen = {"spans": [], "counters": [], "summaries": []}

    class Sink(MetricsSink):
        def on_span(self, name, duration_s, attrs):
            seen["spans"].append(name)

        def on_counter(self, name, delta, value):
            seen["counters"].append(name)

        def on_take_summary(self, summary):
            seen["summaries"].append(summary)

    with metrics_sink(Sink()):
        Snapshot.take(str(tmp_path / "snap"), {"m": PytreeState(_state())})
    assert "stage" in seen["spans"]
    assert "storage.writes" in seen["counters"]
    assert len(seen["summaries"]) == 1
    assert seen["summaries"][0]["phase_coverage"] > 0.5
    n = len(seen["counters"])
    telemetry.incr("post.unregister")
    assert len(seen["counters"]) == n


def test_raising_sink_never_breaks_a_take(tmp_path):
    class BadSink(MetricsSink):
        def on_span(self, name, duration_s, attrs):
            raise RuntimeError("bad sink")

        def on_counter(self, name, delta, value):
            raise RuntimeError("bad sink")

        def on_take_summary(self, summary):
            raise RuntimeError("bad sink")

    with metrics_sink(BadSink()):
        snap = Snapshot.take(str(tmp_path / "snap"), {"m": PytreeState(_state())})
    assert snap.verify().clean


def test_raising_sink_warns_once_per_callback_per_take(tmp_path, caplog):
    class BoomSink(MetricsSink):
        def on_span(self, name, duration_s, attrs):
            raise RuntimeError("boom")

        def on_counter(self, name, delta, value):
            raise RuntimeError("boom")

    def warnings_for(records, method):
        return [r for r in records
                if r.levelname == "WARNING" and "BoomSink" in r.message and method in r.message]

    with metrics_sink(BoomSink()):
        with caplog.at_level(logging.WARNING, logger="tpusnap_torch.telemetry"):
            Snapshot.take(str(tmp_path / "s1"), {"m": PytreeState(_state())})
        assert len(warnings_for(caplog.records, "on_span")) == 1
        assert len(warnings_for(caplog.records, "on_counter")) == 1
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="tpusnap_torch.telemetry"):
            Snapshot.take(str(tmp_path / "s2"), {"m": PytreeState(_state())})
        assert len(warnings_for(caplog.records, "on_span")) == 1


def test_metrics_sink_context_manager_unregisters_on_raise():
    calls = []

    class Sink(MetricsSink):
        def on_counter(self, name, delta, value):
            calls.append(name)

    sink = Sink()
    with pytest.raises(RuntimeError):
        with metrics_sink(sink) as registered:
            assert registered is sink
            telemetry.incr("ctx.mgr.counter")
            raise RuntimeError("body failed")
    n = len(calls)
    assert n >= 1
    telemetry.incr("ctx.mgr.counter")
    assert len(calls) == n


def test_take_persists_trace_and_rollup(tmp_path):
    path = str(tmp_path / "snap")
    snap = Snapshot.take(path, {"m": PytreeState(_state())})
    assert telemetry_rank_path(0) == ".tpusnap/telemetry/rank_0.json"
    doc = json.load(open(_trace_file(path)))
    assert doc["rank"] == 0
    events = doc["traceEvents"]
    assert isinstance(events, list) and events
    for ev in events:
        assert "ph" in ev and "pid" in ev
    s = doc["summary"]
    assert s["phase_coverage"] >= 0.9
    for phase in ("state_dict", "plan", "prepare", "stage", "manifest_gather", "metadata", "io_drain"):
        assert phase in s["phases"], phase
    assert s["counters"]["storage.bytes_written"] > 0
    assert "peak_rss_delta_bytes" in s["gauges"]
    assert "scheduler.budget_used_bytes" in s["gauges"]
    rollup = snap.metadata.extras["telemetry"]
    assert rollup["ranks"] == 1
    assert rollup["bytes_written"] == s["counters"]["storage.bytes_written"]
    assert snap.verify().clean


def test_async_take_persists_trace(tmp_path):
    path = str(tmp_path / "snap")
    snap = Snapshot.async_take(path, {"m": PytreeState(_state())}).wait()
    doc = json.load(open(_trace_file(path)))
    assert doc["summary"]["phase_coverage"] >= 0.85
    assert "io_drain" in doc["summary"]["phases"]
    assert "telemetry" in snap.metadata.extras
    assert "async_blocked_s" in doc["summary"]["meta"] if "meta" in doc["summary"] else True


def test_telemetry_disabled_skips_trace_file(tmp_path):
    path = str(tmp_path / "snap")
    with override_telemetry_enabled(False):
        snap = Snapshot.take(path, {"m": PytreeState(_state())})
    assert not os.path.exists(_trace_file(path))
    rollup = (snap.metadata.extras or {}).get("telemetry")
    assert rollup is not None
    assert rollup["bytes_written"] > 0
    assert rollup["stages"] == {}


def test_last_take_summary_exposed(tmp_path):
    Snapshot.take(str(tmp_path / "snap"), {"m": PytreeState(_state())})
    s = telemetry.LAST_TAKE_SUMMARY
    assert s is not None and s["counters"]["storage.writes"] >= 1


def test_clean_take_records_no_fatal_payload_retries(tmp_path):
    """Sidecar misses (the journal probe on a fresh path) are counted
    under their own family, never as payload retry failures. A plain path
    takes no retry layer in the port; ``chaos+fs://`` does."""
    Snapshot.take(
        "chaos+fs://" + str(tmp_path / "snap"), {"m": PytreeState(_state())},
        storage_options={"fault_plan": FaultPlan(transient_per_op=0)},
    )
    counters = telemetry.LAST_TAKE_SUMMARY["counters"]
    fatal_payload = {k: v for k, v in counters.items()
                     if k.startswith("retry.fatal.") and not k.startswith("retry.fatal.sidecar.")}
    assert not fatal_payload, fatal_payload
    assert counters.get("retry.fatal.sidecar.read", 0) >= 1, counters


@pytest.mark.chaos
def test_chaos_trace_records_faults_and_retries(tmp_path, caplog):
    path = str(tmp_path / "chaos_snap")
    with caplog.at_level(logging.INFO, logger="tpusnap_torch.retry"):
        Snapshot.take(
            "chaos+fs://" + path, {"m": PytreeState(_state())},
            storage_options={"fault_plan": FaultPlan(seed=3, transient_per_op=1),
                             "retry_backoff_base_sec": 0.01, "retry_backoff_cap_sec": 0.05},
        )
    doc = json.load(open(_trace_file(path)))
    counters = doc["summary"]["counters"]
    assert counters.get("faults.injected.write", 0) >= 1
    assert counters.get("retry.attempts", 0) >= 1
    assert counters.get("retry.recovered", 0) >= 1
    assert any(k.startswith("retry.transient.write.InjectedFaultError") for k in counters)
    instants = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "i"}
    assert "fault_injected" in instants and "retry" in instants
    assert any("succeeded after" in r.message for r in caplog.records)
    md = json.load(open(os.path.join(path, ".snapshot_metadata")))
    assert md["extras"]["telemetry"]["retry_attempts"] >= 1


def test_rss_sampler_start_stop_clean():
    from tpusnap_torch.rss_profiler import RSSSampler

    sampler = RSSSampler(interval_sec=0.02)
    sampler.start()
    time.sleep(0.08)
    deltas = sampler.stop()
    assert deltas and all(isinstance(d, int) for d in deltas)
    n = len(deltas)
    assert sampler.stop() is deltas and len(deltas) == n
    assert not any(t.name == "tpusnap-rss" for t in threading.enumerate())


def test_rss_sampler_records_final_delta_for_sub_interval_context():
    from tpusnap_torch.rss_profiler import RSSSampler

    sampler = RSSSampler(interval_sec=10.0)
    sampler.start()
    assert len(sampler.stop()) == 1


def test_measure_rss_deltas_context_manager():
    from tpusnap_torch.rss_profiler import current_rss_bytes, measure_rss_deltas

    assert current_rss_bytes() > 0
    deltas = []
    with measure_rss_deltas(deltas, interval_sec=0.01):
        blob = np.ones(4 << 20, dtype=np.uint8)
        time.sleep(0.05)
        del blob
    assert deltas and deltas[-1] is not None


def test_take_summary_includes_peak_rss(tmp_path):
    Snapshot.take(str(tmp_path / "snap"), {"m": PytreeState(_state())})
    assert "peak_rss_delta_bytes" in telemetry.LAST_TAKE_SUMMARY["gauges"]


def test_restore_records_phases_and_persists_trace(tmp_path, monkeypatch):
    from tpusnap_torch.progress import load_restore_traces

    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "tele"))
    path = str(tmp_path / "snap")
    state = _state()
    Snapshot.take(path, {"m": StateDict(**state)})
    target = {"m": StateDict(**{k: torch.zeros_like(v) for k, v in state.items()})}
    Snapshot(path).restore(target)
    s = telemetry.LAST_RESTORE_SUMMARY
    for phase in ("restore.plan", "restore.targets", "restore.prepare", "restore.read", "restore.load"):
        assert phase in s["phases"], phase
    assert "storage_read" in s["stages"] and s["counters"]["storage.bytes_read"] > 0
    assert 0 in load_restore_traces(path)


# ------------------------------------------------------ parity with tpusnap


def _names(summary):
    return set(summary["phases"]), set(summary["stages"])


def test_take_records_tpusnap_span_and_phase_names(tmp_path):
    """The same take in both packages records the same phases and the
    same pipeline spans (a trace reads the same from either), and the
    rollup carries the same keys."""
    from tpusnap import PytreeState as JaxPytreeState
    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import telemetry as jax_telemetry

    state = _np_state(total_bytes=1 << 20, n=4)
    jax_snap = JaxSnapshot.take(str(tmp_path / "j"), {"m": JaxPytreeState(state)})
    jax_summary = jax_telemetry.LAST_TAKE_SUMMARY
    port_snap = Snapshot.take(
        str(tmp_path / "p"), {"m": PytreeState({k: torch.from_numpy(v) for k, v in state.items()})}
    )
    port_summary = telemetry.LAST_TAKE_SUMMARY
    jp, js = _names(jax_summary)
    pp, ps = _names(port_summary)
    assert pp == jp, (pp ^ jp)
    assert ps == js, (ps ^ js)
    assert {"stage_buffer", "storage_write", "checksum", "stage_window"} <= ps
    assert set(port_snap.metadata.extras["telemetry"]) == set(jax_snap.metadata.extras["telemetry"])
    # tpusnap's summary also carries its SLO tracker's fields (not ported).
    assert set(port_summary) == set(jax_summary) - {"slo"}


def test_tpusnap_trace_cli_reads_a_port_snapshot(tmp_path, capsys):
    from tpusnap.__main__ import main

    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": PytreeState(_state())})
    assert main(["trace", path]) == 0
    out = capsys.readouterr().out
    assert "stage" in out and "phase coverage" in out
    assert main(["trace", path, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["rollup"]["ranks"] == 1 and "0" in doc["ranks"]


def _world_telemetry_take(snap_dir):
    from tpusnap_torch.comm import get_communicator

    comm = get_communicator()
    state = StateDict(
        w=torch.arange(4096, dtype=torch.float32) * (comm.rank + 1), b=torch.ones(64),
    )
    Snapshot.take(snap_dir, {"model": state})
    comm.barrier()
    if comm.rank == 0:
        for r in range(comm.world_size):
            p = os.path.join(snap_dir, ".tpusnap", "telemetry", f"rank_{r}.json")
            assert os.path.exists(p), f"missing trace for rank {r}"
            doc = json.load(open(p))
            assert doc["traceEvents"], f"rank {r} trace empty"
            assert doc["summary"]["phase_coverage"] >= 0.9, doc["summary"]
        md = json.load(open(os.path.join(snap_dir, ".snapshot_metadata")))
        rollup = md["extras"]["telemetry"]
        assert rollup["ranks"] == comm.world_size
        assert "comm.all_gather" in rollup["stages"]
        assert rollup["bytes_written"] > 0


def test_distributed_take_produces_rank_traces(tmp_path):
    from tpusnap_torch.test_utils import run_subprocess_world

    run_subprocess_world(_world_telemetry_take, world_size=2, args=[str(tmp_path / "snap")])
