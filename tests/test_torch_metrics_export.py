"""Metrics export of the port, mirrored from tests/test_metrics_export.py
(each test function there has its counterpart here, driving the port's
takes of torch tensors), plus cross-package checks: the strict textfile
parser gives tpusnap's result on the same text, and the textfiles and
JSONL lines each package's sinks write parse and load in the other.
"""

import json
import logging
import os
import time

import numpy as np
import torch
import pytest

from tpusnap_torch import (
    FaultPlan,
    JsonlEventSink,
    PrometheusTextfileSink,
    PytreeState,
    Snapshot,
)
from tpusnap_torch import metrics_export
from tpusnap_torch.knobs import (
    override_history_enabled,
    override_metrics_dir,
    override_metrics_export,
    override_telemetry_enabled,
    override_telemetry_dir,
)
from tpusnap_torch.metrics_export import install_env_sinks, parse_prometheus_textfile


def _state(total_bytes=1 << 20, n=2):
    per = max(total_bytes // n // 4, 16)
    return {f"w{i}": torch.arange(per, dtype=torch.float32) + i for i in range(n)}


@pytest.fixture
def metrics_env(tmp_path):
    """Isolated metrics + telemetry dirs, history off (these tests are
    about the export sinks), env sinks reconciled on entry and exit so
    no sink leaks into other tests."""
    mdir = str(tmp_path / "metrics")
    with override_telemetry_dir(str(tmp_path / "tele")), override_metrics_dir(
        mdir
    ), override_history_enabled(False):
        yield mdir
    install_env_sinks()  # spec reverted with the env: unregisters


def _prom_path(mdir, rank=0):
    # The default filename carries the job id (collision fix for two
    # jobs sharing one textfile dir) — host-pid derived unless
    # TPUSNAP_JOB_ID is set.
    from tpusnap_torch.knobs import get_job_id

    return os.path.join(mdir, f"tpusnap_{get_job_id()}_rank{rank}.prom")


def _jsonl_events(mdir):
    p = os.path.join(mdir, "events.jsonl")
    if not os.path.exists(p):
        return []
    return [json.loads(ln) for ln in open(p) if ln.strip()]


# ------------------------------------------------- prometheus textfile


def test_prom_textfile_format_and_monotonic_counters(tmp_path, metrics_env):
    with override_metrics_export("prom"):
        Snapshot.take(str(tmp_path / "s1"), {"m": PytreeState(_state())})
        first = parse_prometheus_textfile(open(_prom_path(metrics_env)).read())
        Snapshot.take(str(tmp_path / "s2"), {"m": PytreeState(_state())})
        text = open(_prom_path(metrics_env)).read()
    # Format self-check: strict parse enforces that every sampled metric
    # carries its # HELP and # TYPE lines and every sample is numeric.
    second = parse_prometheus_textfile(text)
    for name in (
        "tpusnap_take_seconds",
        "tpusnap_takes_total",
        "tpusnap_bytes_written_total",
        "tpusnap_retry_total",
        "tpusnap_retry_attempts_total",
        "tpusnap_stall_episodes_total",
        "tpusnap_budget_high_water_bytes",
        "tpusnap_peak_rss_delta_bytes",
    ):
        assert name in second, f"missing metric {name}"
        assert second[name].get("help") and second[name].get("type")
    assert second["tpusnap_take_seconds"]["type"] == "gauge"
    assert second["tpusnap_bytes_written_total"]["type"] == "counter"

    def only(metrics, name):
        return next(iter(metrics[name]["samples"].values()))

    # Monotonic counters across two consecutive takes (the exported
    # domain is process-global, so rate() works).
    assert only(second, "tpusnap_takes_total") == only(
        first, "tpusnap_takes_total"
    ) + 1
    assert only(second, "tpusnap_bytes_written_total") > only(
        first, "tpusnap_bytes_written_total"
    )
    assert only(second, "tpusnap_take_seconds") > 0
    # rank label present on every sample.
    for meta in second.values():
        for labels in meta["samples"]:
            assert 'rank="0"' in labels


def test_prom_atomic_rewrite_no_temp_debris(tmp_path, metrics_env):
    with override_metrics_export("prom"):
        Snapshot.take(str(tmp_path / "s"), {"m": PytreeState(_state())})
    assert not [f for f in os.listdir(metrics_env) if ".tmp." in f]


def test_prom_exports_storage_latency_quantiles(tmp_path, metrics_env):
    """Histogram quantiles from the process-global I/O histograms:
    summary-typed ``tpusnap_storage_write_seconds{quantile=...,plugin=
    ...}`` series, surviving the strict format self-check, quantiles
    ordered, and the monotonic-domain rule untouched (quantiles are
    point-in-time; only *_total families are counters)."""
    # The exported domain is process-global: earlier tests' backends
    # (fsspec doubles, chaos runs) would otherwise share the family.
    from tpusnap_torch import telemetry

    telemetry.reset_global_io_histograms()
    with override_metrics_export("prom"):
        Snapshot.take(str(tmp_path / "s"), {"m": PytreeState(_state())})
        text = open(_prom_path(metrics_env)).read()
    metrics = parse_prometheus_textfile(text)
    fam = metrics["tpusnap_storage_write_seconds"]
    assert fam["type"] == "summary"
    by_q = {}
    for labels, value in fam["samples"].items():
        assert 'plugin="FSStoragePlugin"' in labels
        assert 'rank="0"' in labels
        for q in ("0.5", "0.95", "0.99"):
            if f'quantile="{q}"' in labels:
                by_q[q] = value
    assert set(by_q) == {"0.5", "0.95", "0.99"}
    assert 0 < by_q["0.5"] <= by_q["0.95"] <= by_q["0.99"]
    # The read family appears once reads happen (a restore).
    state = _state()
    with override_metrics_export("prom"):
        Snapshot(str(tmp_path / "s")).restore(
            {"m": PytreeState({k: torch.zeros_like(v) for k, v in state.items()})}
        )
        text = open(_prom_path(metrics_env)).read()
    assert (
        parse_prometheus_textfile(text)["tpusnap_storage_read_seconds"][
            "type"
        ]
        == "summary"
    )


@pytest.mark.chaos
def test_prom_retry_classification_labels(tmp_path, metrics_env):
    with override_metrics_export("prom"):
        Snapshot.take(
            "chaos+fs://" + str(tmp_path / "chaos_snap"),
            {"m": PytreeState(_state())},
            storage_options={
                "fault_plan": FaultPlan(seed=3, transient_per_op=1)
            },
        )
        text = open(_prom_path(metrics_env)).read()
    parsed = parse_prometheus_textfile(text)
    labels = list(parsed["tpusnap_retry_total"]["samples"])
    assert any(
        'classification="transient.write.InjectedFaultError"' in s
        for s in labels
    ), labels


def test_prom_sink_direct_use(tmp_path):
    """The sink is a plain MetricsSink usable without the env knobs."""
    sink = PrometheusTextfileSink(str(tmp_path))
    sink.on_take_summary(
        {
            "rank": 3,
            "completed": True,
            "take_wall_s": 1.5,
            "counters": {},
            "gauges": {"scheduler.budget_used_bytes": 1024.0},
        }
    )
    text = open(_prom_path(tmp_path, rank=3)).read()
    parsed = parse_prometheus_textfile(text)
    samples = parsed["tpusnap_take_seconds"]["samples"]
    assert list(samples.values()) == [1.5]
    assert 'rank="3"' in next(iter(samples))
    budget = parsed["tpusnap_budget_high_water_bytes"]["samples"]
    assert list(budget.values()) == [1024.0]


def test_prom_sink_ignores_aborted_summaries(tmp_path):
    """end_take publishes aborted takes' summaries too; the 'last
    completed take' gauge and 'completed takes' counter must not
    absorb them."""
    sink = PrometheusTextfileSink(str(tmp_path))
    sink.on_take_summary(
        {"rank": 0, "completed": True, "take_wall_s": 1.5, "counters": {}}
    )
    sink.on_take_summary(
        {"rank": 0, "take_wall_s": 0.2, "counters": {}}  # aborted
    )
    parsed = parse_prometheus_textfile(open(_prom_path(tmp_path)).read())
    assert list(parsed["tpusnap_take_seconds"]["samples"].values()) == [1.5]
    assert list(parsed["tpusnap_takes_total"]["samples"].values()) == [1]


def test_parse_prometheus_textfile_rejects_malformed():
    with pytest.raises(ValueError):
        parse_prometheus_textfile("tpusnap_x 1\n")  # sample without TYPE
    with pytest.raises(ValueError):
        parse_prometheus_textfile(
            "# HELP tpusnap_x h\n# TYPE tpusnap_x counter\ntpusnap_x notanum\n"
        )
    with pytest.raises(ValueError):
        parse_prometheus_textfile(
            "# TYPE tpusnap_x bogus_type\ntpusnap_x 1\n"
        )


# ------------------------------------------------------ jsonl event sink


def test_jsonl_sink_take_and_restore_lines(tmp_path, metrics_env):
    with override_metrics_export("jsonl"):
        path = str(tmp_path / "snap")
        Snapshot.take(path, {"m": PytreeState(_state())})
        target = {k: torch.zeros_like(v) for k, v in _state().items()}
        Snapshot(path).restore({"m": PytreeState(target)})
    events = _jsonl_events(metrics_env)
    kinds = [e["kind"] for e in events]
    assert kinds == ["take", "restore"]
    take, restore = events
    assert take["rank"] == 0 and take["completed"] is True
    assert take["bytes"] > 0 and take["throughput_gbps"] > 0
    assert restore["bytes"] > 0
    assert take["take_id"]


def test_jsonl_rotation_bound(tmp_path):
    summaries = {
        "rank": 0,
        "completed": True,
        "take_wall_s": 1.0,
        "counters": {"storage.bytes_written": 123456},
    }
    sink = JsonlEventSink(str(tmp_path), max_bytes=4096)  # floor of the bound
    for _ in range(64):
        sink.on_take_summary(dict(summaries))
    main, rotated = sink.path(), sink.path() + ".1"
    assert os.path.exists(rotated)
    assert os.path.getsize(main) <= 4096
    # Every surviving line parses.
    for p in (main, rotated):
        for ln in open(p):
            assert json.loads(ln)["kind"] == "take"


# -------------------------------------------------- env-driven installing


def test_env_install_idempotent_and_reconfigurable(tmp_path, metrics_env):
    with override_metrics_export("prom,jsonl"):
        Snapshot.take(str(tmp_path / "a"), {"m": PytreeState(_state())})
        Snapshot.take(str(tmp_path / "b"), {"m": PytreeState(_state())})
        # One sink per format despite two installs: 2 takes -> 2 lines.
        assert len(_jsonl_events(metrics_env)) == 2
        assert os.path.exists(_prom_path(metrics_env))
    # Spec reverted: the next take must not export.
    n = len(_jsonl_events(metrics_env))
    Snapshot.take(str(tmp_path / "c"), {"m": PytreeState(_state())})
    assert len(_jsonl_events(metrics_env)) == n


def test_unknown_export_format_skipped_with_warning(caplog, metrics_env):
    with override_metrics_export("bogus,jsonl"):
        with caplog.at_level(logging.WARNING, logger="tpusnap_torch.knobs"):
            install_env_sinks()
        assert any("bogus" in r.message for r in caplog.records)
        with metrics_export._env_lock:
            kinds = [type(s).__name__ for s in metrics_export._env_sinks]
        assert kinds == ["JsonlEventSink"]
        # Warn-once per process: a typo'd knob in a job checkpointing
        # every few minutes must not spam one WARNING per take.
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="tpusnap_torch.knobs"):
            install_env_sinks()
        assert not any("bogus" in r.message for r in caplog.records)
    install_env_sinks()


def test_export_disabled_takes_write_nothing(tmp_path, metrics_env):
    Snapshot.take(str(tmp_path / "s"), {"m": PytreeState(_state())})
    assert not os.path.exists(_prom_path(metrics_env))
    assert not _jsonl_events(metrics_env)


def test_telemetry_off_still_exports_summaries(tmp_path, metrics_env):
    """Counters are always-on and the summary still publishes with
    TPUSNAP_TELEMETRY=0 — fleet export must not go dark just because
    span capture is off."""
    with override_metrics_export("prom,jsonl"), override_telemetry_enabled(
        False
    ):
        Snapshot.take(str(tmp_path / "s"), {"m": PytreeState(_state())})
    events = _jsonl_events(metrics_env)
    assert len(events) == 1 and events[0]["bytes"] > 0
    parsed = parse_prometheus_textfile(open(_prom_path(metrics_env)).read())
    assert next(iter(parsed["tpusnap_takes_total"]["samples"].values())) >= 1


# -------------------------------------------------------- overhead guard


def test_take_overhead_with_export_sinks_within_bound(tmp_path, metrics_env):
    """Acceptance: the ≤10% take-overhead guard still passes with BOTH
    export sinks enabled (prom rewrite + jsonl append per summary, sink
    span/counter callbacks inline on the recording threads)."""
    state = _state(total_bytes=16 << 20, n=8)

    def take_once(i, enabled):
        with override_telemetry_enabled(enabled), override_metrics_export(
            "prom,jsonl" if enabled else None
        ):
            t0 = time.perf_counter()
            Snapshot.take(
                str(tmp_path / f"s_{enabled}_{i}"), {"m": PytreeState(state)}
            )
            return time.perf_counter() - t0

    take_once(99, True)  # warmup: imports, native lib load, sink install
    runs = 5
    disabled = min(take_once(i, False) for i in range(runs))
    enabled = min(take_once(i, True) for i in range(runs))
    assert enabled <= disabled * 1.10 + 0.05, (
        f"telemetry+export overhead too high: enabled {enabled:.3f}s vs "
        f"disabled {disabled:.3f}s"
    )


# ------------------------------------------------------ cross-package


_PROM_CASES = {
    "valid": (
        "# HELP tpusnap_x help text\n# TYPE tpusnap_x counter\n"
        'tpusnap_x{rank="0",job="j"} 3\n'
        "# HELP tpusnap_q q\n# TYPE tpusnap_q summary\n"
        'tpusnap_q{quantile="0.5"} 0.25\ntpusnap_q{quantile="0.99"} 1e-3\n'
    ),
    "sample_without_type": "tpusnap_x 1\n",
    "non_numeric": "# HELP tpusnap_x h\n# TYPE tpusnap_x counter\ntpusnap_x notanum\n",
    "bogus_type": "# TYPE tpusnap_x bogus_type\ntpusnap_x 1\n",
    "empty": "",
}


@pytest.mark.parametrize("case", sorted(_PROM_CASES))
def test_parse_prometheus_textfile_matches_tpusnap(case):
    from tpusnap.metrics_export import parse_prometheus_textfile as jax_parse

    text = _PROM_CASES[case]

    def outcome(parse):
        try:
            return ("ok", parse(text))
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(parse_prometheus_textfile) == outcome(jax_parse)


_SUMMARY = {
    "rank": 2,
    "completed": True,
    "take_wall_s": 1.25,
    "take_id": "t1",
    "world_size": 4,
    "counters": {"storage.bytes_written": 4096, "storage.writes": 2},
    "gauges": {"scheduler.budget_used_bytes": 2048.0},
    "phases": {"stage": 0.5, "io_drain": 0.5},
    "meta": {"kind": "take", "job_id": "jobx", "path": "/p", "completed": True},
}


def test_sinks_write_files_the_other_package_reads(tmp_path):
    """The same summary through each package's sinks: every textfile
    parses with either strict parser into the same families, and the
    JSONL lines are equal but for the timestamp."""
    from tpusnap import metrics_export as jax_me
    from tpusnap import telemetry as jax_telemetry
    from tpusnap_torch import telemetry

    # The latency families come from each process-global histogram set,
    # which earlier takes in this process filled: start both empty.
    telemetry.reset_global_io_histograms()
    jax_telemetry.reset_global_io_histograms()
    out = {}
    for name, mod, parse in (
        ("port", metrics_export, parse_prometheus_textfile),
        ("jax", jax_me, jax_me.parse_prometheus_textfile),
    ):
        d = tmp_path / name
        prom = mod.PrometheusTextfileSink(str(d), filename="t.prom")
        prom.on_take_summary(dict(_SUMMARY))
        jsonl = mod.JsonlEventSink(str(d))
        jsonl.on_take_summary(dict(_SUMMARY))
        text = open(d / "t.prom").read()
        line = json.loads(open(jsonl.path()).read().strip())
        line.pop("ts", None)
        out[name] = (text, line)
    for text, _ in out.values():
        port_fams = parse_prometheus_textfile(text)
        assert port_fams == jax_me.parse_prometheus_textfile(text)
        assert {"tpusnap_take_seconds", "tpusnap_takes_total"} <= set(port_fams)
    port_fams = parse_prometheus_textfile(out["port"][0])
    jax_fams = parse_prometheus_textfile(out["jax"][0])
    assert {k: v["type"] for k, v in port_fams.items()} == {
        k: v["type"] for k, v in jax_fams.items()
    }
    assert port_fams["tpusnap_take_seconds"] == jax_fams["tpusnap_take_seconds"]
    assert out["port"][1] == out["jax"][1]
