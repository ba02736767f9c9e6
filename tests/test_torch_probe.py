"""The port's in-take and in-restore roofline probe, mirrored from the
probe cases of tests/test_analyze.py (samples, cleanup, the off-by-default
knob, one probe for a small take, the stand-down after a failure, never
inside an async take's blocked window, a stranded probe file, the read
lane of a restore, probe spans outside the read windows), plus checks of
what the port adds: each sample feeds the compression policy's pipe
ceiling, and the probe's bytes stay out of the take's byte counters.
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


# ----------------------------------------------------- probe runner


def test_probe_records_samples_and_cleans_up(tmp_path):
    snap = str(tmp_path / "snap")
    with override_probe(True, interval_bytes=1 << 20, probe_bytes=1 << 20):
        Snapshot.take(snap, {"m": PytreeState(_state())})
    s = telemetry.LAST_TAKE_SUMMARY
    assert s["probe"]["probes"] >= 1
    assert s["probe"]["write_gbps_p50"] > 0
    assert s["probe"]["read_gbps_p50"] > 0
    assert 0 < s["roofline_fraction"]
    assert s["counters"]["probe.probes"] >= 1
    # Probe files are transient: none survive the take.
    assert not glob.glob(os.path.join(snap, ".tpusnap", "probe", "*"))
    # The probe rides the rollup too (single-rank fold).
    md = json.load(open(os.path.join(snap, ".snapshot_metadata")))
    rollup = md["extras"]["telemetry"]
    assert rollup["roofline_fraction"] == s["roofline_fraction"]
    assert rollup["probe"]["probes"] == s["probe"]["probes"]
    # And the history event carries the drift-immune fraction.
    from tpusnap_torch.history import event_from_summary

    ev = event_from_summary("take", s)
    assert ev["roofline_fraction"] == s["roofline_fraction"]
    assert ev["probe_write_gbps"] == s["probe"]["write_gbps_p50"]


def test_probe_off_by_default(tmp_path):
    Snapshot.take(str(tmp_path / "snap"), {"m": PytreeState(_state())})
    s = telemetry.LAST_TAKE_SUMMARY
    assert "probe" not in s
    assert "roofline_fraction" not in s


def test_small_take_still_gets_one_probe(tmp_path):
    # Interval far above the take's bytes: the end-of-drain fallback
    # still measures once, so no probe-enabled take is fraction-less.
    with override_probe(True, interval_bytes=1 << 40, probe_bytes=1 << 20):
        Snapshot.take(str(tmp_path / "snap"), {"m": PytreeState(_state())})
    assert telemetry.LAST_TAKE_SUMMARY["probe"]["probes"] == 1


def test_probe_runner_stands_down_after_failure():
    """One failed probe disables probing for the take (one WARNING, no
    retry storm) — and the drain-end fallback respects the stand-down."""
    import asyncio

    from tpusnap_torch.io_types import StoragePlugin
    from tpusnap_torch.scheduler import _ProbeRunner

    class BoomPlugin(StoragePlugin):
        async def write(self, write_io):
            raise OSError("probe traffic rejected")

        async def read(self, read_io):
            raise OSError("nope")

        async def delete(self, path):
            pass

    with override_probe(True, interval_bytes=1 << 20, probe_bytes=1 << 20):
        tele = telemetry.TakeTelemetry(rank=0, enabled=True)
        try:
            runner = _ProbeRunner(BoomPlugin(), rank=0, tele=tele)
            runner.note_written(1 << 30)
            assert runner.due
            asyncio.run(runner.run())
        finally:
            # A bare TakeTelemetry (no end_take) starts an RSS sampler
            # thread; stop it or it outlives the test forever.
            tele.finalize()
    assert runner.ran == 0
    assert runner._failed
    runner.note_written(1 << 30)
    assert not runner.due  # stood down: never due again this take
    assert "probe" not in tele.summary()


def test_probe_excluded_from_async_blocked_window(tmp_path):
    """Probes never run inside a pipelined async take's blocked window
    — they would bill their I/O to async_blocked_s, the metric
    async_take exists to minimize. Every probe span starts after the
    blocked window closed."""
    snap = str(tmp_path / "snap")
    with override_probe(True, interval_bytes=1 << 20, probe_bytes=1 << 20):
        pending = Snapshot.async_take(
            snap, {"m": PytreeState(_state(total_bytes=16 << 20))}
        )
        pending.wait()
    s = telemetry.LAST_TAKE_SUMMARY
    assert s["probe"]["probes"] >= 1
    blocked_s = s["async_blocked_s"]
    doc = json.load(
        open(os.path.join(snap, ".tpusnap", "telemetry", "rank_0.json"))
    )
    probe_starts = [
        ev["ts"] / 1e6
        for ev in doc["traceEvents"]
        if ev.get("name") == "probe_roofline" and ev.get("ph") == "X"
    ]
    assert probe_starts, "no probe spans recorded"
    assert all(ts >= blocked_s for ts in probe_starts), (
        probe_starts,
        blocked_s,
    )


def test_stranded_probe_file_does_not_make_aborted_dir_foreign(tmp_path):
    """A probe stream a flaky backend's failed cleanup strands in an
    otherwise-cleaned (aborted) dir must not classify the path as
    'foreign' — gc refuses foreign, which would lock the checkpoint
    path against reuse. It reads as empty/reusable, like a leftover
    heartbeat record."""
    from tpusnap_torch.lifecycle import fsck_snapshot

    d = tmp_path / "snap" / ".tpusnap" / "probe"
    d.mkdir(parents=True)
    (d / "rank_0_0.bin").write_bytes(b"x" * 1024)
    report = fsck_snapshot(str(tmp_path / "snap"))
    assert report.state == "empty", (report.state, report.detail)


# ------------------------------------------- probe runner: read path


def _probe_restore(tmp_path, total_bytes=64 << 20, n=8):
    """Take, then restore with in-restore probes on. Returns the
    restore summary and rank 0's persisted restore trace doc."""
    from tpusnap_torch import compress

    snap = str(tmp_path / "snap")
    state = _state(total_bytes=total_bytes, n=n)
    Snapshot.take(snap, {"m": PytreeState(state)})
    compress._reset_ceilings()
    with override_telemetry_dir(str(tmp_path / "teledir")):
        with override_probe(
            True, interval_bytes=16 << 20, probe_bytes=1 << 20
        ):
            Snapshot(snap).restore(
                {
                    "m": PytreeState(
                        {k: torch.zeros_like(v) for k, v in state.items()}
                    )
                }
            )
        docs = load_restore_traces(snap)
    return snap, telemetry.LAST_RESTORE_SUMMARY, docs[0]


def test_restore_probe_feeds_read_lane_and_history(tmp_path):
    """In-restore probes (TPUSNAP_PROBE=1): the restore summary gets
    the read-lane fraction, the ceiling registry gets a read-lane
    entry, no probe scratch survives, and the history event carries
    the drift-immune read fields."""
    from tpusnap_torch import compress
    from tpusnap_torch.history import event_from_summary

    snap, s, _doc = _probe_restore(tmp_path)
    assert s["probe"]["probes"] >= 1
    assert s["probe"]["read_gbps_p50"] > 0
    assert 0 < s["restore_roofline_fraction"]
    # The write-lane fraction belongs to takes — a restore summary
    # must not grow one.
    assert "roofline_fraction" not in s
    lanes = {lane for (_label, lane) in compress.pipe_ceilings_snapshot()}
    assert "read" in lanes
    assert not glob.glob(os.path.join(snap, ".tpusnap", "probe", "*"))
    ev = event_from_summary("restore", s)
    assert ev["restore_roofline_fraction"] == s["restore_roofline_fraction"]
    assert ev["probe_read_gbps"] == s["probe"]["read_gbps_p50"]
    assert "roofline_fraction" not in ev


def test_restore_probe_spans_outside_read_windows(tmp_path):
    """Probes only run while no blob read is in flight — a probe
    interleaved with reads would bill its own I/O to the storage_read
    window it exists to price. No probe span may overlap any
    storage_read span in the restore trace."""
    _snap, s, doc = _probe_restore(tmp_path)
    assert s["probe"]["probes"] >= 1
    spans = {"probe_roofline": [], "storage_read": []}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("name") in spans:
            spans[ev["name"]].append((ev["ts"], ev["ts"] + ev["dur"]))
    assert spans["probe_roofline"] and spans["storage_read"]
    for p0, p1 in spans["probe_roofline"]:
        for r0, r1 in spans["storage_read"]:
            assert p1 <= r0 or r1 <= p0, (
                "probe span overlaps a read window",
                (p0, p1),
                (r0, r1),
            )


def test_restore_probe_stands_down_on_read_lane():
    """The stand-down contract holds on the restore side too: one
    failed probe disables probing for the restore, and the summary
    grows neither a probe block nor restore_roofline_fraction."""
    import asyncio

    from tpusnap_torch.io_types import StoragePlugin
    from tpusnap_torch.scheduler import _ProbeRunner

    class BoomPlugin(StoragePlugin):
        async def write(self, write_io):
            raise OSError("probe scratch rejected")

        async def read(self, read_io):
            raise OSError("nope")

        async def delete(self, path):
            pass

    with override_probe(True, interval_bytes=1 << 20, probe_bytes=1 << 20):
        tele = telemetry.TakeTelemetry(rank=0, enabled=True)
        tele.meta["kind"] = "restore"
        try:
            runner = _ProbeRunner(BoomPlugin(), rank=0, tele=tele)
            runner.note_written(1 << 30)
            assert runner.due
            asyncio.run(runner.run())
        finally:
            tele.finalize()
    assert runner.ran == 0
    assert runner._failed
    runner.note_written(1 << 30)
    assert not runner.due  # stood down for the rest of this restore
    s = tele.summary()
    assert "probe" not in s
    assert "restore_roofline_fraction" not in s




def test_probe_feeds_the_compress_policy_ceiling(tmp_path):
    """Every probe sample lands in the compression policy's ceiling
    registry under the take's own plugin key, in both lanes, so the
    ``auto`` policy of the next take judges a live ceiling."""
    from tpusnap_torch import compress
    from tpusnap_torch.storage_plugin import url_to_storage_plugin

    compress._reset_ceilings()
    snap = str(tmp_path / "snap")
    with override_probe(True, interval_bytes=1 << 40, probe_bytes=1 << 20):
        Snapshot.take(snap, {"m": PytreeState(_state())})
    sample = telemetry.LAST_TAKE_SUMMARY["probe"]
    key = compress.pipe_ceiling_key(url_to_storage_plugin(snap))
    assert compress.pipe_ceiling(key) == sample["write_gbps_p50"]
    assert compress.pipe_ceiling(key, lane="read") == sample["read_gbps_p50"]


def test_probe_bytes_stay_out_of_the_payload_counters(tmp_path):
    """The probe writes through the take's plugin stack but under the
    sidecar prefix: the payload byte counters, the I/O histograms and
    the files of the snapshot are the same with the probe on or off."""
    state = _state()
    counters = {}
    for on in (False, True):
        snap = str(tmp_path / f"snap_{on}")
        telemetry.reset_global_io_histograms()
        with override_probe(on, interval_bytes=1 << 20, probe_bytes=1 << 20):
            Snapshot.take(snap, {"m": PytreeState(state)})
        s = telemetry.LAST_TAKE_SUMMARY
        hist = s["io_histograms"]["write.FSStoragePlugin"]
        counters[on] = (
            s["counters"]["storage.bytes_written"],
            s["counters"]["storage.writes"],
            hist["count"],
            # Slab blobs are named per take: compare the payload files'
            # sizes, outside the sidecar directory.
            sorted(
                os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(snap)
                for f in fs
                if ".tpusnap" not in d and f != ".snapshot_metadata"
            ),
        )
    assert counters[True] == counters[False]
    assert telemetry.LAST_TAKE_SUMMARY["counters"]["probe.bytes_written"] == 4 << 20
