"""The port's performance attribution, mirrored from
tests/test_analyze.py (log2 histograms, the critical-path bound
analysis, the tail and straggler findings, the ``analyze`` CLI and its
exit-3 contract, the cross-rank histogram merge; the probe cases live in
test_torch_probe.py), plus cross-package checks: ``analyze`` and
``attribute_spans`` give tpusnap's report on the same spans and
documents, and each package's ``analyze`` reads the other's take the
same way.
"""

import glob
import json
import os

import numpy as np
import torch
import pytest

from tpusnap_torch import PytreeState, Snapshot, telemetry
from tpusnap_torch.__main__ import main
from tpusnap_torch.analyze import (
    Thresholds,
    analyze,
    attribute_spans,
    classify_span,
    straggler_findings,
    tail_latency_findings,
)
from tpusnap_torch.knobs import (
    override_probe,
    override_telemetry_dir,
    override_telemetry_enabled,
)
from tpusnap_torch.progress import load_restore_traces
from tpusnap_torch.telemetry import IOStats, LogHistogram


@pytest.fixture(autouse=True)
def _leave_no_probe_ceilings():
    """Every probe sample notes a read or write ceiling in its package's
    process-wide registry (both packages' when the shared TPUSNAP_PROBE
    makes a tpusnap take probe too); an SLO estimate in a later test file
    of the same worker would find it (ROADMAP.md C9). Cleared after each
    test, in both packages."""
    yield
    import sys

    from tpusnap_torch import compress as port_compress

    port_compress._reset_ceilings()
    jax_compress = sys.modules.get("tpusnap.compress")
    if jax_compress is not None:
        jax_compress._reset_ceilings()


def _state(total_bytes=8 << 20, n=4):
    per = total_bytes // n
    return {
        f"w{i}": torch.from_numpy(
            np.random.default_rng(i).integers(0, 255, per, dtype=np.uint8)
        )
        for i in range(n)
    }


# ------------------------------------------------------- LogHistogram


def test_log_histogram_bucketing():
    h = LogHistogram()
    for v in (1.0, 1.5, 2.0, 3.99, 4.0, 0.0):
        h.observe(v)
    # [1,2): 1.0, 1.5 -> bucket 0; [2,4): 2.0, 3.99 -> bucket 1;
    # [4,8): 4.0 -> bucket 2; zero -> the zero bucket.
    assert h.buckets[0] == 2
    assert h.buckets[1] == 2
    assert h.buckets[2] == 1
    assert h.count == 6
    assert h.vmax == 4.0
    assert h.vmin == 0.0
    assert abs(h.total - 12.49) < 1e-9


def test_log_histogram_quantiles_exact_at_extremes():
    h = LogHistogram()
    assert h.quantile(0.5) is None  # empty
    h.observe(0.004)
    # Single sample: every quantile is that sample (clamped to max).
    assert h.quantile(0.5) == pytest.approx(0.004)
    assert h.quantile(1.0) == pytest.approx(0.004)
    for _ in range(99):
        h.observe(0.001)
    h.observe(10.0)
    # p50 lives in the 0.001 bucket; max is exact.
    assert h.quantile(0.5) <= 0.002048
    assert h.quantile(1.0) == pytest.approx(10.0)
    # The fat tail is visible: p99 >> p50 once the outlier has weight.
    for _ in range(10):
        h.observe(10.0)
    assert h.quantile(0.99) == pytest.approx(10.0)


def test_log_histogram_merge_preserves_tails():
    a, b = LogHistogram(), LogHistogram()
    for _ in range(100):
        a.observe(0.001)
    b.observe(5.0)  # one rank's outlier
    a.merge(b)
    assert a.count == 101
    assert a.quantile(1.0) == pytest.approx(5.0)
    # Round-trips through the serialized form (the rollup transport).
    c = LogHistogram.from_dict(a.to_dict())
    assert c.count == a.count
    assert c.quantile(1.0) == pytest.approx(5.0)
    assert c.buckets == a.buckets


def test_iostats_quantile_fields_and_merge():
    st = IOStats()
    for _ in range(98):
        st.observe(0.002, 1 << 20)
    st.observe(0.5, 1 << 20)  # tail writes (2% mass so p99 sees them)
    st.observe(0.5, 1 << 20)
    d = st.to_dict()
    assert d["count"] == 100
    assert d["bytes_total"] == 100 << 20
    assert d["p50_s"] <= 0.004096
    assert d["max_s"] == pytest.approx(0.5)
    assert d["p99_s"] >= 0.25  # the tail bucket
    other = IOStats()
    other.merge_dict(d)
    other.merge_dict(d)
    assert other.to_dict()["count"] == 200


def test_merge_io_histograms_across_ranks():
    r0, r1 = IOStats(), IOStats()
    for _ in range(10):
        r0.observe(0.001, 1 << 20)
    r1.observe(2.0, 1 << 20)  # rank 1's straggler write
    merged = telemetry.merge_io_histograms(
        [
            {"write.FSStoragePlugin": r0.to_dict()},
            {"write.FSStoragePlugin": r1.to_dict()},
        ]
    )
    st = merged["write.FSStoragePlugin"]
    assert st["count"] == 11
    assert st["max_s"] == pytest.approx(2.0)


# -------------------------------------------------------- attribution


def test_classify_span_taxonomy():
    assert classify_span("storage_write") == "storage_write"
    assert classify_span("stage_buffer") == "stage"
    assert classify_span("dtoh") == "dtoh"
    assert classify_span("checksum_late") == "checksum"
    assert classify_span("cow_verify") == "checksum"
    assert classify_span("comm.barrier") == "barrier"
    assert classify_span("kv.barrier_arrive") == "barrier"
    assert classify_span("budget_wait") == "budget_wait"
    # Containers and unknown names never attribute.
    assert classify_span("stage_window") is None
    assert classify_span("probe_roofline") is None
    assert classify_span("some_future_span") is None


def test_attribution_single_category_full_coverage():
    att = attribute_spans([("storage_write", 0.0, 10.0)], wall_s=10.0)
    assert att.attributed == {"storage_write": pytest.approx(10.0)}
    assert att.unattributed_s == pytest.approx(0.0)
    assert att.verdict() == ("storage_write", pytest.approx(1.0))


def test_attribution_io_wins_overlap_and_glue_is_unattributed():
    # stage [0,4], write [2,8], wall 10: write owns [2,8] (I/O-first
    # tiebreak), stage only its solo [0,2], [8,10] is glue.
    att = attribute_spans(
        [("stage_buffer", 0.0, 4.0), ("storage_write", 2.0, 6.0)],
        wall_s=10.0,
    )
    assert att.attributed["storage_write"] == pytest.approx(6.0)
    assert att.attributed["stage"] == pytest.approx(2.0)
    assert att.unattributed_s == pytest.approx(2.0)
    # Raw busy time ignores the overlap exclusivity.
    assert att.busy["stage"] == pytest.approx(4.0)
    assert att.coverage == pytest.approx(0.8)


def test_attribution_waits_only_when_idle():
    # budget_wait under in-flight I/O is storage-bound (writes are the
    # only budget source); a bare budget_wait is budget-bound.
    att = attribute_spans(
        [
            ("budget_wait", 0.0, 5.0),
            ("storage_write", 0.0, 5.0),
            ("budget_wait", 5.0, 3.0),
        ],
        wall_s=8.0,
    )
    assert att.attributed["storage_write"] == pytest.approx(5.0)
    assert att.attributed["budget_wait"] == pytest.approx(3.0)
    assert att.unattributed_s == pytest.approx(0.0)


def test_attribution_barrier_lowest_priority_and_clipping():
    att = attribute_spans(
        [
            ("comm.barrier", 0.0, 4.0),
            ("checksum", 1.0, 2.0),
            ("storage_read", 6.0, 100.0),  # clipped to wall
            ("stage_window", 0.0, 10.0),  # container: ignored
        ],
        wall_s=10.0,
    )
    assert att.attributed["checksum"] == pytest.approx(2.0)
    assert att.attributed["barrier"] == pytest.approx(2.0)  # [0,1]+[3,4]
    assert att.attributed["storage_read"] == pytest.approx(4.0)
    assert att.unattributed_s == pytest.approx(2.0)  # [4,6]
    total = sum(att.attributed.values()) + att.unattributed_s
    assert total == pytest.approx(10.0)


def test_attribution_overlapping_same_category_not_double_counted():
    # 16 concurrent writes over the same 5 s attribute 5 s, not 80.
    spans = [("storage_write", 0.0, 5.0) for _ in range(16)]
    att = attribute_spans(spans, wall_s=5.0)
    assert att.attributed["storage_write"] == pytest.approx(5.0)
    assert att.busy["storage_write"] == pytest.approx(5.0)


def test_attribution_empty_spans():
    att = attribute_spans([], wall_s=3.0)
    assert att.attributed == {}
    assert att.unattributed_s == pytest.approx(3.0)
    assert att.verdict() is None


# ----------------------------------------------------------- findings


def test_tail_latency_finding_fires_on_fat_tail():
    st = IOStats()
    for _ in range(98):
        st.observe(0.002, 1 << 20)
    st.observe(0.9, 1 << 20)
    st.observe(0.9, 1 << 20)
    hist = {"write.FSStoragePlugin": st.to_dict()}
    out = tail_latency_findings(hist, Thresholds(p99_ratio=20.0))
    assert len(out) == 1
    assert out[0].severity == "warn"
    assert "write.FSStoragePlugin" in out[0].message
    # Below the ratio threshold: quiet.
    assert not tail_latency_findings(hist, Thresholds(p99_ratio=10_000.0))
    # Too few samples to call a tail: quiet.
    tiny = IOStats()
    tiny.observe(0.001, 1)
    tiny.observe(1.0, 1)
    assert not tail_latency_findings(
        {"write.X": tiny.to_dict()}, Thresholds(p99_ratio=2.0)
    )


def test_straggler_finding_from_rollup_skew():
    rollup = {
        "ranks": 4,
        "phase_skew": {
            "stage": {"p50_s": 1.0, "max_s": 3.5, "max_rank": 2, "skew": 3.5}
        },
    }
    out = straggler_findings(rollup, Thresholds(max_skew=2.0))
    assert len(out) == 1 and "rank 2" in out[0].message
    # Single-rank rollups have no stragglers by construction.
    assert not straggler_findings({**rollup, "ranks": 1}, Thresholds())


def test_analyze_report_shape_on_synthetic_docs():
    doc = {
        "summary": {
            "rank": 0,
            "take_wall_s": 10.0,
            "stages": {"storage_write": {"count": 1}},
        },
        "traceEvents": [
            {
                "name": "storage_write",
                "ph": "X",
                "cat": "op",
                "ts": 0.0,
                "dur": 9e6,
            },
            {"name": "stage", "ph": "X", "cat": "phase", "ts": 0, "dur": 1e7},
        ],
    }
    report = analyze({}, {0: doc}, kind="take")
    assert report["bound_by"] == "storage_write"
    assert report["bound_pct"] == pytest.approx(90.0)
    assert "TPUSNAP" in report["advice"]
    assert report["attribution"]["coverage"] == pytest.approx(0.9)
    assert report["check_failed"] is False


def test_quantile_geometric_interpolation_stays_in_bucket():
    # The interpolated estimate never leaves the bucket that holds the
    # target rank, and clamps to the exact observed extremes.
    h = LogHistogram()
    for _ in range(50):
        h.observe(0.001)
    for _ in range(50):
        h.observe(0.003)
    p25, p75 = h.quantile(0.25), h.quantile(0.75)
    assert 0.0009765625 <= p25 <= 0.001953125  # 0.001's bucket
    assert 0.001953125 <= p75 <= 0.00390625  # 0.003's bucket
    assert p25 >= h.vmin and p75 <= h.vmax


# -------------------------------------------------- take histograms


def test_take_summary_records_io_histograms(tmp_path):
    Snapshot.take(str(tmp_path / "snap"), {"m": PytreeState(_state())})
    s = telemetry.LAST_TAKE_SUMMARY
    hist = s["io_histograms"]
    write = hist["write.FSStoragePlugin"]
    assert write["count"] > 0
    assert write["bytes_total"] >= 8 << 20
    assert write["p50_s"] is not None and write["p99_s"] >= write["p50_s"]
    # The rollup in metadata carries the merged copy. It is snapshotted
    # BEFORE the commit barrier, so the trace-sidecar and metadata
    # writes that follow are in the final summary but not in it.
    md = json.load(
        open(os.path.join(tmp_path, "snap", ".snapshot_metadata"))
    )
    merged = md["extras"]["telemetry"]["io_histograms"][
        "write.FSStoragePlugin"
    ]
    assert 0 < merged["count"] <= write["count"]
    assert merged["p99_s"] is not None


def test_histograms_recorded_even_with_telemetry_off(tmp_path):
    # Histograms are always-on like the counters (the knob gates spans).
    telemetry.reset_global_io_histograms()
    with override_telemetry_enabled(False):
        Snapshot.take(str(tmp_path / "snap"), {"m": PytreeState(_state())})
    g = telemetry.global_io_histograms_snapshot()
    assert g["write.FSStoragePlugin"]["count"] > 0


# ------------------------------------------------------ analyze CLI


def _probe_take(tmp_path):
    snap = str(tmp_path / "snap")
    with override_probe(True, interval_bytes=4 << 20, probe_bytes=1 << 20):
        Snapshot.take(snap, {"m": PytreeState(_state(total_bytes=16 << 20))})
    return snap


def test_analyze_cli_prints_verdict(tmp_path, capsys):
    snap = _probe_take(tmp_path)
    rc = main(["analyze", snap])
    out = capsys.readouterr().out
    assert rc == 0
    assert "BOUND BY:" in out
    assert "attribution" in out
    assert "storage-boundary latency" in out
    assert "roofline:" in out


def test_analyze_cli_json_shape(tmp_path, capsys):
    snap = _probe_take(tmp_path)
    rc = main(["analyze", snap, "--json"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["kind"] == "take"
    assert doc["bound_by"] in (
        "storage_write",
        "stage",
        "checksum",
        "dtoh",
    )
    assert 0 < doc["attribution"]["coverage"] <= 1
    assert "write.FSStoragePlugin" in doc["io_histograms"]
    assert isinstance(doc["findings"], list)
    assert "roofline_fraction" in doc


def test_analyze_cli_check_exit_codes(tmp_path, capsys):
    snap = _probe_take(tmp_path)
    # Impossible roofline bar -> the warn finding fires -> exit 2.
    rc = main(["analyze", snap, "--check", "--min-roofline", "1.1"])
    assert rc == 2
    capsys.readouterr()
    # Thresholds that cannot fire -> healthy -> exit 0.
    rc = main(
        [
            "analyze",
            snap,
            "--check",
            "--min-roofline",
            "0",
            "--p99-ratio",
            "1e9",
            "--max-skew",
            "1e9",
        ]
    )
    assert rc == 0


def test_analyze_cli_zero_spans_exits_3(tmp_path, capsys):
    # Knob-off take: counters roll up but zero spans anywhere — the
    # doctor has nothing to attribute; one-liner + exit 3 like `trace`.
    with override_telemetry_enabled(False):
        Snapshot.take(str(tmp_path / "snap"), {"m": PytreeState(_state())})
    rc = main(["analyze", str(tmp_path / "snap")])
    captured = capsys.readouterr()
    assert rc == 3
    assert "no telemetry recorded" in captured.err


def test_analyze_cli_pre_telemetry_snapshot_exits_3(tmp_path, capsys):
    # Simulate a pre-telemetry snapshot: strip the trace sidecar and
    # the rollup extras from a committed snapshot.
    import shutil

    snap = str(tmp_path / "snap")
    Snapshot.take(snap, {"m": PytreeState(_state())})
    shutil.rmtree(os.path.join(snap, ".tpusnap", "telemetry"))
    md_path = os.path.join(snap, ".snapshot_metadata")
    from tpusnap_torch.manifest import decode_metadata, encode_metadata

    md = decode_metadata(open(md_path, "rb").read())
    md.extras = {}
    with open(md_path, "wb") as f:
        f.write(encode_metadata(md))
    rc = main(["analyze", snap])
    captured = capsys.readouterr()
    assert rc == 3
    assert "no telemetry recorded" in captured.err


def test_analyze_cli_restore(tmp_path, capsys):
    from tpusnap_torch.knobs import override_telemetry_dir

    snap = str(tmp_path / "snap")
    state = _state()
    Snapshot.take(snap, {"m": PytreeState(state)})
    with override_telemetry_dir(str(tmp_path / "tele")):
        target = {k: torch.zeros_like(v) for k, v in state.items()}
        Snapshot(snap).restore({"m": PytreeState(target)})
        rc = main(["analyze", snap, "--restore", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["kind"] == "restore"
    assert doc["bound_by"] in ("storage_read", "consume")


def test_analyze_cli_history_context(tmp_path, capsys):
    from tpusnap_torch.knobs import override_telemetry_dir

    with override_telemetry_dir(str(tmp_path / "tele")):
        snap = _probe_take(tmp_path)
        rc = main(["analyze", snap, "--history", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["history"]["events"] >= 1
    assert "throughput_gbps" in doc["history"]


def test_cli_help_lists_analyze(capsys):
    rc = main(["--help"])
    assert rc == 0
    assert "analyze" in capsys.readouterr().out


# ------------------------------------------------------- distributed


def _world_histogram_take(snap_dir):
    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.comm import get_communicator

    comm = get_communicator()
    state = StateDict(
        w=torch.arange(8192, dtype=torch.float32) * (comm.rank + 1),
        b=torch.ones(64, dtype=torch.float32),
    )
    Snapshot.take(snap_dir, {"model": state})
    comm.barrier()
    if comm.rank == 0:
        per_rank_counts = []
        for r in range(comm.world_size):
            p = os.path.join(
                snap_dir, ".tpusnap", "telemetry", f"rank_{r}.json"
            )
            doc = json.load(open(p))
            hist = doc["summary"]["io_histograms"]
            per_rank_counts.append(hist["write.FSStoragePlugin"]["count"])
            assert per_rank_counts[-1] > 0, f"rank {r} recorded no writes"
        md = json.load(open(os.path.join(snap_dir, ".snapshot_metadata")))
        merged = md["extras"]["telemetry"]["io_histograms"][
            "write.FSStoragePlugin"
        ]
        # The rollup merge is the SUM of the per-rank histograms —
        # bucket counts included, so one rank's tail survives the fold.
        assert merged["count"] == sum(per_rank_counts), (
            merged,
            per_rank_counts,
        )
        assert merged["p99_s"] is not None


@pytest.mark.distributed
def test_distributed_histogram_merge_in_rollup(tmp_path):
    from tpusnap_torch.test_utils import run_subprocess_world

    run_subprocess_world(
        _world_histogram_take, world_size=2, args=[str(tmp_path / "snap")]
    )


def _world_probe_restore(snap_dir):
    from tpusnap_torch import PytreeState, Snapshot, telemetry
    from tpusnap_torch.comm import get_communicator
    from tpusnap_torch.knobs import override_probe
    from tpusnap_torch.progress import load_restore_traces
    from tpusnap_torch.telemetry import rollup_summaries

    comm = get_communicator()
    state = {"w": (torch.arange(1 << 21) % 256).to(torch.uint8) + comm.rank}
    Snapshot.take(snap_dir, {"m": PytreeState(state)})
    comm.barrier()
    with override_probe(True, interval_bytes=1 << 20, probe_bytes=1 << 20):
        Snapshot(snap_dir).restore(
            {"m": PytreeState({"w": torch.zeros(1 << 21, dtype=torch.uint8)})}
        )
    s = telemetry.LAST_RESTORE_SUMMARY
    assert s.get("restore_roofline_fraction"), sorted(s)
    comm.barrier()
    if comm.rank == 0:
        # Every rank persisted a restore trace; the cross-rank fold
        # carries the read-lane fraction (fleet p50) and the probe
        # aggregate — what `analyze --restore` and the Prometheus
        # gauge read.
        docs = load_restore_traces(snap_dir)
        assert sorted(docs) == [0, 1], sorted(docs)
        roll = rollup_summaries([d["summary"] for d in docs.values()])
        assert roll["restore_roofline_fraction"] > 0
        assert roll["probe"]["read_gbps_p50"] > 0


@pytest.mark.distributed
def test_distributed_restore_rollup_carries_read_fraction(tmp_path):
    from tpusnap_torch.test_utils import run_subprocess_world

    run_subprocess_world(
        _world_probe_restore,
        world_size=2,
        args=[str(tmp_path / "snap")],
        extra_env={"TPUSNAP_TELEMETRY_DIR": str(tmp_path / "teledir")},
    )


# ------------------------------------------------------ cross-package

_SPAN_CASES = {
    "io_overlaps_compute": (
        [("storage_write", 0.0, 4.0), ("stage_buffer", 1.0, 6.0), ("checksum", 5.0, 7.0)],
        10.0,
    ),
    "waits_only_when_idle": (
        [("budget_wait", 0.0, 3.0), ("storage_write", 1.0, 2.0), ("comm.barrier", 2.5, 9.0)],
        9.5,
    ),
    "restore_lanes": (
        [("storage_read", 0.0, 2.0), ("consume", 1.5, 5.0), ("restore.decode", 2.0, 4.0),
         ("dtoh", 4.5, 6.0)],
        6.0,
    ),
    "clipped_to_wall": ([("storage_write", -1.0, 3.0), ("kv.get", 2.0, 12.0)], 10.0),
    "empty": ([], 5.0),
}


@pytest.mark.parametrize("case", sorted(_SPAN_CASES))
def test_attribute_spans_matches_tpusnap(case):
    from tpusnap.analyze import attribute_spans as jax_attribute_spans

    spans, wall = _SPAN_CASES[case]
    assert attribute_spans(spans, wall).to_json() == jax_attribute_spans(spans, wall).to_json()


def _trace_docs(snap):
    from tpusnap_torch.analyze import spans_of_trace_doc  # noqa: F401

    docs = {}
    for p in sorted(glob.glob(os.path.join(snap, ".tpusnap", "telemetry", "rank_*.json"))):
        doc = json.load(open(p))
        docs[doc["summary"]["rank"]] = doc
    rollup = json.load(open(os.path.join(snap, ".snapshot_metadata")))["extras"]["telemetry"]
    return rollup, docs


@pytest.mark.parametrize("taker", ["port", "jax"])
@pytest.mark.parametrize("thresholds", ["default", "strict"])
def test_analyze_matches_tpusnap_on_a_real_take(tmp_path, taker, thresholds):
    """One real take's persisted spans and rollup, taken by either
    package: both packages' ``analyze`` give the same report."""
    from tpusnap import PytreeState as JaxPytreeState
    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap.analyze import Thresholds as JaxThresholds
    from tpusnap.analyze import analyze as jax_analyze

    arrays = {
        f"w{i}": np.random.default_rng(i).integers(0, 255, 1 << 20, dtype=np.uint8)
        for i in range(4)
    }
    snap = str(tmp_path / "snap")
    with override_probe(True, interval_bytes=1 << 40, probe_bytes=1 << 20):
        if taker == "port":
            Snapshot.take(
                snap, {"m": PytreeState({k: torch.from_numpy(v) for k, v in arrays.items()})}
            )
        else:
            JaxSnapshot.take(snap, {"m": JaxPytreeState(arrays)})
    rollup, docs = _trace_docs(snap)
    kw = {} if thresholds == "default" else dict(min_roofline=0.99, p99_ratio=1.01, min_coverage=0.99)
    ours = analyze(rollup, docs, kind="take", thresholds=Thresholds(**kw))
    theirs = jax_analyze(rollup, docs, kind="take", thresholds=JaxThresholds(**kw))
    assert ours == theirs
    assert ours["bound_by"] in ("storage_write", "stage", "checksum", "dtoh")
