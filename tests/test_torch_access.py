"""The port's access ledger, mirrored from tests/test_access.py
(aggregation and the working-set union, flush, rotation and a torn
tail, the knob gate, the coverage of a partial ``read_object`` and of a
full restore, many concurrent readers, the restore overhead guard, the
fleet reader fold, gate and families, analyze's ``partial_access``
finding, the tuner's working-set budget rule, cold-first ``gc
--evict-local`` and the ``heatmap`` CLI exit contract), plus a
cross-package check: the ledgers both packages write for one snapshot
merge into the same heatmap in either.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import pytest

from tpusnap_torch import Snapshot, StateDict, knobs
from tpusnap_torch import access
from tpusnap_torch.__main__ import _heatmap_metadata, main
from tpusnap_torch.access import (
    AccessLedger,
    compute_heatmap,
    load_ledger_records,
    location_read_counts,
)
from tpusnap_torch.analyze import Thresholds, access_findings
from tpusnap_torch.fleet import (
    evaluate_fleet,
    fold_fleet,
    note_reader_scope,
    read_fleet_records,
    render_fleet_prom,
    reset_publisher,
    reset_reader_stats,
)
from tpusnap_torch.history import load_history
from tpusnap_torch.io_types import StoragePlugin
from tpusnap_torch.knobs import (
    override_access_ledger,
    override_access_ledger_max_bytes,
    override_fleet_dir,
    override_job_id,
    override_telemetry_dir,
)
from tpusnap_torch.lifecycle import gc_snapshot
from tpusnap_torch.metrics_export import parse_prometheus_textfile
from tpusnap_torch.tiering import drain_snapshot, parse_tier_url
from tpusnap_torch.tune import build_plan

MiB = 1 << 20
GiB = 1 << 30


@pytest.fixture
def tele_env(tmp_path):
    with override_telemetry_dir(str(tmp_path / "tele")):
        yield str(tmp_path / "tele")


# ------------------------------------------------------- ledger unit


def test_ledger_buckets_aggregate_and_working_set(tmp_path, tele_env):
    led = AccessLedger(str(tmp_path / "snap"))
    for _ in range(3):
        led.record("m/w0", "0/blob", 0, 100, 100)
    led.record("m/w0", "0/blob", 50, 200, 150)
    led.record("m/w1", "0/blob2", 0, 10, 10, source="cas")
    assert led.total_reads == 5
    assert led.total_bytes == 460
    # Union per location: [0,200) on blob + [0,10) on blob2.
    assert led.working_set_bytes() == 210
    led.flush()
    recs = load_ledger_records(str(tmp_path / "snap"))
    # Bounded: 3 identical reads are ONE record with n=3, not 3 lines.
    assert len(recs) == 3
    by = {(r["lp"], tuple(r["range"])): r for r in recs}
    assert by[("m/w0", (0, 100))]["n"] == 3
    assert by[("m/w0", (0, 100))]["bytes"] == 300
    assert by[("m/w1", (0, 10))]["src"] == "cas"
    # Scope totals survive the flush (the fleet reader record and the
    # restore summary read them after the buckets drained to disk).
    assert led.total_bytes == 460 and led.total_reads == 5


def test_ledger_torn_tail_skipped_and_rotation(tmp_path, tele_env):
    snap = str(tmp_path / "snap")
    led = AccessLedger(snap)
    led.record("m/w0", "0/blob", 0, 100, 100)
    led.flush()
    # Torn tail (killed mid-append): the partial line is skipped.
    with open(led.path, "ab") as f:
        f.write(b'{"v":1,"lp":"m/w1","byt')
    assert [r["lp"] for r in load_ledger_records(snap)] == ["m/w0"]
    # Rotation: past the bound (floored at 64 KiB so a misconfigured
    # knob can't rotate every flush) the file moves to `.1`; both
    # generations load (rotated first, roughly chronological).
    big = AccessLedger(snap)
    for i in range(1200):  # ~130 KB of distinct buckets
        big.record("m/w1", "0/blob", i * 100, i * 100 + 100, 100)
    big.flush()
    with override_access_ledger_max_bytes(1):
        led2 = AccessLedger(snap)
        led2.record("m/w2", "0/blob", 0, 5, 5)
        led2.flush()
    assert os.path.exists(led.path + ".1")
    assert {r["lp"] for r in load_ledger_records(snap)} == {
        "m/w0",
        "m/w1",
        "m/w2",
    }


def test_read_scope_gated_by_knob_and_ambient(tmp_path, tele_env):
    snap = str(tmp_path / "snap")
    with override_access_ledger(False):
        with access.read_scope(snap) as led:
            assert led is None
            assert access.current() is None
    assert not os.path.isdir(os.path.join(tele_env, "access"))
    with access.read_scope(snap, default_source="remote") as led:
        assert access.current() is led
        led.record("m/w", "0/b", 0, 8, 8)
    assert access.current() is None
    recs = load_ledger_records(snap)
    assert recs and recs[0]["src"] == "remote"


# --------------------------------------- acceptance: coverage shapes


def test_read_object_partial_coverage_names_read_leaves(tmp_path, tele_env):
    """Acceptance: read_object of 2 of 20 equally-sized leaves →
    whole-snapshot coverage < 0.2, and the heatmap names exactly the
    two read leaves."""
    path = str(tmp_path / "snap")
    state = {
        "m": StateDict(
            **{
                f"w{i:02d}": torch.arange(2048, dtype=torch.float32) + i
                for i in range(20)
            }
        )
    }
    Snapshot.take(path, state)
    snap = Snapshot(path)
    got = snap.read_object("0/m/w03")
    assert torch.equal(got, state["m"]["w03"])
    snap.read_object("0/m/w11")
    hm = compute_heatmap(load_ledger_records(path), _heatmap_metadata(path))
    assert 0 < hm["coverage"] < 0.2
    assert hm["unattributed_bytes"] == 0
    touched = sorted(l["path"] for l in hm["leaves"] if l["bytes_read"])
    assert touched == ["m/w03", "m/w11"]
    per_leaf = {l["path"]: l for l in hm["leaves"]}
    assert per_leaf["m/w03"]["coverage"] == pytest.approx(1.0)
    assert per_leaf["m/w00"]["coverage"] == 0.0
    # The hot ranges name the tiles a serving tier should pin.
    assert {h["path"] for h in hm["hot_ranges"]} == {"m/w03", "m/w11"}


def test_full_restore_coverage_near_one_and_history_fields(
    tmp_path, tele_env
):
    path = str(tmp_path / "snap")
    state = {
        "m": StateDict(
            **{f"w{i}": torch.arange(4096, dtype=torch.float32) + i for i in range(8)}
        )
    }
    Snapshot.take(path, state)
    dst = {
        "m": StateDict(
            **{f"w{i}": torch.zeros(4096, dtype=torch.float32) for i in range(8)}
        )
    }
    Snapshot(path).restore(dst)
    hm = compute_heatmap(load_ledger_records(path), _heatmap_metadata(path))
    assert hm["coverage"] > 0.99
    assert hm["n_readers"] == 1
    # One full pass: amplification ≈ coverage (every byte read once).
    assert hm["coverage"] <= hm["amplification"] < 1.5
    # The restore history event carries the access_* scalars, and the
    # attributed bytes equal the storage.bytes_read counter exactly.
    ev = [e for e in load_history() if e["kind"] == "restore"][-1]
    assert ev["access_bytes_read"] == ev["bytes"] == hm["bytes_read"]
    assert ev["access_reads"] >= 1
    assert ev["access_working_set_bytes"] == pytest.approx(
        hm["snapshot_bytes"], rel=0.01
    )


# ------------------------------------------------- concurrency soak

_READER_CHILD = r"""
import os, sys
import torch
from tpusnap_torch import Snapshot, StateDict
path = sys.argv[1]
dst = {"m": StateDict(**{f"w{i}": torch.zeros(4096, dtype=torch.float32)
                         for i in range(4)})}
Snapshot(path).restore(dst)
assert dst["m"]["w1"][1].item() == 2.0
print("OK", flush=True)
"""


def test_many_concurrent_readers_interleave_whole_lines(tmp_path):
    """Satellite: tens of concurrent reader processes sharing one
    telemetry dir — every ledger line parses whole (O_APPEND whole-line
    interleave), and the merged heatmap byte total equals the sum of
    every reader's ``storage.bytes_read`` counter."""
    path = str(tmp_path / "snap")
    tele = str(tmp_path / "tele")
    state = {
        "m": StateDict(
            **{f"w{i}": torch.arange(4096, dtype=torch.float32) + i for i in range(4)}
        )
    }
    with override_telemetry_dir(tele):
        Snapshot.take(path, state)
    n = 12
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _READER_CHILD, path],
            env={
                **os.environ,
                "TPUSNAP_TELEMETRY_DIR": tele,
                "TPUSNAP_JOB_ID": f"reader-{k}",
            },
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            cwd=cwd,
        )
        for k in range(n)
    ]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert "OK" in out
    with override_telemetry_dir(tele):
        root = access.access_dir(path)
        names = [m for m in os.listdir(root) if m.endswith(".jsonl")]
        assert len(names) == n
        for name in names:
            with open(os.path.join(root, name), "rb") as f:
                lines = [ln for ln in f.read().split(b"\n") if ln.strip()]
            assert lines
            for ln in lines:
                json.loads(ln)  # every interleaved line is whole
        recs = load_ledger_records(path)
        hm = compute_heatmap(recs, _heatmap_metadata(path))
        assert hm["n_readers"] == n
        assert set(hm["readers"]) == {f"reader-{k}" for k in range(n)}
        # Merged bytes == Σ per-reader storage.bytes_read (each child's
        # restore history event records its counter).
        evs = [e for e in load_history() if e["kind"] == "restore"]
        assert len(evs) == n
        assert hm["bytes_read"] == sum(e["bytes"] for e in evs)
        assert hm["bytes_read"] == sum(
            r["bytes_read"] for r in hm["readers"].values()
        )
        # n full passes over one snapshot: cross-reader amplification.
        assert hm["amplification"] == pytest.approx(n * hm["coverage"], rel=0.01)


# ------------------------------------------------------ overhead guard


def test_restore_overhead_with_ledger_within_bound(tmp_path, tele_env):
    """Acceptance: the ≤10% overhead guard holds on restore with the
    access ledger ON (in-memory bucket aggregation; one flush at scope
    exit — no per-read I/O)."""
    per = (16 << 20) // 8 // 4
    state = {
        "m": StateDict(
            **{f"w{i}": torch.arange(per, dtype=torch.float32) + i for i in range(8)}
        )
    }
    path = str(tmp_path / "snap")
    Snapshot.take(path, state)

    def restore_once(enabled):
        dst = {
            "m": StateDict(
                **{f"w{i}": torch.zeros(per, dtype=torch.float32) for i in range(8)}
            )
        }
        with override_access_ledger(enabled):
            t0 = time.perf_counter()
            Snapshot(path).restore(dst)
            return time.perf_counter() - t0

    restore_once(True)  # warmup
    runs = 5
    disabled = min(restore_once(False) for _ in range(runs))
    enabled = min(restore_once(True) for _ in range(runs))
    assert enabled <= disabled * 1.10 + 0.05, (
        f"access ledger overhead too high: enabled {enabled:.3f}s vs "
        f"disabled {disabled:.3f}s"
    )


# ------------------------------------------------- fleet reader fold


@pytest.fixture
def fleet_env(tmp_path):
    fdir = str(tmp_path / "fleet")
    reset_publisher()
    reset_reader_stats()
    with override_telemetry_dir(str(tmp_path / "tele")), override_fleet_dir(
        fdir
    ), override_job_id("reader-a"):
        yield fdir
    reset_publisher()
    reset_reader_stats()


def test_note_reader_scope_publishes_and_folds(fleet_env):
    note_reader_scope("d1", 1000, 3000, 30)
    note_reader_scope("d1", 1000, 1000, 10)
    recs = read_fleet_records(fleet_env)
    assert len(recs) == 1
    reader = recs[0]["reader"]
    assert reader["bytes_read"] == 4000 and reader["reads"] == 40
    assert reader["snapshots"]["d1"]["scopes"] == 2
    assert reader["snapshots"]["d1"]["snapshot_bytes"] == 1000
    rollup = fold_fleet(recs)
    assert rollup["readers"] == 1
    assert rollup["bytes_read_total"] == 4000
    assert rollup["read_amplification"] == pytest.approx(4.0)
    assert rollup["read_amplification_digest"] == "d1"
    (job,) = rollup["jobs"]
    assert job["reader"] is True and job["bytes_read"] == 4000


def _reader_rec(job, ts, digest, snapshot_bytes, bytes_read):
    return {
        "v": 1,
        "job_id": job,
        "pid": 1,
        "ts": ts,
        "rank": 0,
        "world_size": 1,
        "slo": {
            "rpo_s": 0.0,
            "data_at_risk_bytes": 0,
            "estimated_rto_s": None,
            "last_commit_ts": ts,
            "started_ts": ts,
            "commit_interval_s": None,
            "stream_cadence_s": None,
        },
        "reader": {
            "bytes_read": bytes_read,
            "reads": 1,
            "snapshots": {
                digest: {
                    "snapshot_bytes": snapshot_bytes,
                    "bytes_read": bytes_read,
                    "reads": 1,
                    "scopes": 1,
                }
            },
        },
    }


def test_fold_merges_amplification_across_readers_per_digest():
    """Amplification is a cross-reader, per-digest property: two 1.0x
    readers of one snapshot fold to 2.0x on the serving substrate."""
    t0 = 1_000_000.0
    recs = [
        _reader_rec("a", t0, "d1", 1000, 1000),
        _reader_rec("b", t0, "d1", 1000, 1000),
        _reader_rec("c", t0, "d2", 10_000, 5000),
    ]
    rollup = fold_fleet(recs, now=t0 + 1)
    assert rollup["readers"] == 3
    assert rollup["bytes_read_total"] == 7000
    # Worst digest wins the headline: d1 at 2.0x beats d2 at 0.5x.
    assert rollup["read_amplification"] == pytest.approx(2.0)
    assert rollup["read_amplification_digest"] == "d1"


def test_evaluate_fleet_read_amplification_gate():
    t0 = 1_000_000.0
    rollup = fold_fleet(
        [_reader_rec("a", t0, "d1", 1000, 3000)], now=t0 + 1
    )
    bad = evaluate_fleet(rollup, max_read_amplification=2.0)
    assert bad["verdict"] == "breach"
    row = next(
        c for c in bad["checks"] if c["check"] == "read_amplification"
    )
    assert row["breach"] and row["job"] == "d1"
    ok = evaluate_fleet(rollup, max_read_amplification=5.0)
    assert ok["verdict"] == "healthy"
    # No readers at all: the check is SKIPPED, not breached — absence
    # of readers is not a serving problem.
    no_readers = fold_fleet(
        [
            {
                "v": 1,
                "job_id": "w",
                "pid": 1,
                "ts": t0,
                "rank": 0,
                "world_size": 1,
                "slo": {
                    "rpo_s": 0.0,
                    "data_at_risk_bytes": 0,
                    "estimated_rto_s": None,
                    "last_commit_ts": t0,
                    "started_ts": t0,
                    "commit_interval_s": None,
                    "stream_cadence_s": None,
                },
            }
        ],
        now=t0 + 1,
    )
    rep = evaluate_fleet(no_readers, max_read_amplification=0.1)
    assert rep["verdict"] == "healthy"
    assert not any(
        c["check"] == "read_amplification" for c in rep["checks"]
    )


def test_fleet_prom_reader_families():
    t0 = 1_000_000.0
    rollup = fold_fleet(
        [_reader_rec("a", t0, "d1", 1000, 3000)], now=t0 + 1
    )
    text = render_fleet_prom(rollup)
    families = parse_prometheus_textfile(text)
    readers = families["tpusnap_fleet_readers"]["samples"]
    assert next(iter(readers.values())) == 1.0
    amp = families["tpusnap_fleet_read_amplification"]["samples"]
    (key, val) = next(iter(amp.items()))
    assert 'digest="d1"' in key and val == pytest.approx(3.0)
    # Without readers the amplification family is absent; the reader
    # count gauge stays (0 is a fact, not a gap).
    empty = fold_fleet(
        [
            {
                "v": 1,
                "job_id": "w",
                "pid": 1,
                "ts": t0,
                "rank": 0,
                "world_size": 1,
                "slo": {
                    "rpo_s": 0.0,
                    "data_at_risk_bytes": 0,
                    "estimated_rto_s": None,
                    "last_commit_ts": t0,
                    "started_ts": t0,
                    "commit_interval_s": None,
                    "stream_cadence_s": None,
                },
            }
        ],
        now=t0 + 1,
    )
    fam2 = parse_prometheus_textfile(render_fleet_prom(empty))
    assert (
        next(iter(fam2["tpusnap_fleet_readers"]["samples"].values())) == 0.0
    )
    assert "tpusnap_fleet_read_amplification" not in fam2


# --------------------------------------------- analyze + tune advice


def test_analyze_partial_access_finding():
    hm = {
        "coverage": 0.1,
        "bytes_read": 4096,
        "n_readers": 2,
        "hot_ranges": [{"path": "m/w1", "range": [0, 128]}],
    }
    (f,) = access_findings(hm, Thresholds())
    assert f.severity == "info" and f.kind == "partial_access"
    assert "10%" in f.message and "m/w1[0:128)" in f.message
    assert "read_object" in f.message
    # High coverage, or a heatmap with no attributed reads: no finding.
    assert access_findings({**hm, "coverage": 0.9}, Thresholds()) == []
    assert access_findings({**hm, "bytes_read": 0}, Thresholds()) == []


def _restore_events(n, **extra):
    return [
        {
            "kind": "restore",
            "plugin": "FSStoragePlugin",
            "world_size": 1,
            "bytes": GiB,
            "wall_s": 2.0,
            **extra,
        }
        for _ in range(n)
    ]


def test_tune_sizes_restore_budget_to_access_working_set(monkeypatch):
    """Partial-reader history (working set ≪ payload) → the planner
    proposes a restore budget of 2x the hot working set."""
    monkeypatch.delenv(
        "TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES", raising=False
    )
    events = _restore_events(
        5, access_working_set_bytes=64 * MiB, access_bytes_read=80 * MiB
    )
    plan = build_plan(events, "restore", ceilings={}, codec_gbps=0.0)
    assert plan.ok
    envs = {k.env: k.value for k in plan.knobs}
    assert envs["TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES"] == str(128 * MiB)
    # Full-restore history (working set ≈ payload): rule stays quiet.
    full = _restore_events(
        5, access_working_set_bytes=GiB, access_bytes_read=GiB
    )
    plan2 = build_plan(full, "restore", ceilings={}, codec_gbps=0.0)
    assert "TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES" not in {
        k.env for k in plan2.knobs
    }
    # Re-reading history (bytes_read ≫ working set) means the reads
    # revisit tiles — a tight budget would thrash; rule stays quiet.
    rereads = _restore_events(
        5, access_working_set_bytes=64 * MiB, access_bytes_read=512 * MiB
    )
    plan3 = build_plan(rereads, "restore", ceilings={}, codec_gbps=0.0)
    assert "TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES" not in {
        k.env for k in plan3.knobs
    }


# ------------------------------------------------ gc cold-first order


def test_gc_evict_local_deletes_cold_blobs_first(tmp_path, monkeypatch):
    """``gc --evict-local`` evicts never-read blobs before the fleet's
    hot tiles: an interrupted eviction leaves the popular working set
    on the fast tier."""
    # The explicit drain below must be the ONLY drain: the take's
    # background uploader would race it on the upload journal.
    monkeypatch.setenv("TPUSNAP_TIER_DRAIN", "0")
    cache = os.path.join(str(tmp_path), "cache")
    remote_root = os.path.join(str(tmp_path), "remote")
    url = f"tier+local={cache}+remote=fs://{remote_root}/snap"
    state = {
        "m": StateDict(
            **{
                f"w{i}": torch.arange(4096, dtype=torch.float32) + i
                for i in range(6)
            }
        )
    }
    with override_telemetry_dir(
        str(tmp_path / "tele")
    ), knobs.override_batching_disabled(True):
        Snapshot.take(url, state)
        assert drain_snapshot(url).state == "durable"
        snap = Snapshot(url)
        snap.read_object("0/m/w4")
        for _ in range(3):
            snap.read_object("0/m/w2")
        local_dir = parse_tier_url(url).local_dir
        # Ledgers recorded via the tier-URL spelling must be findable
        # from the local dir (digest normalization).
        counts = location_read_counts(load_ledger_records(local_dir))
        assert counts and len(counts) == 2
        warm_loc = min(counts, key=counts.get)  # w4: 1 read
        hot_loc = max(counts, key=counts.get)  # w2: 3 reads
        order = []
        orig = StoragePlugin.sync_delete

        def recording_delete(self, p, loop):
            order.append(p)
            return orig(self, p, loop)

        monkeypatch.setattr(StoragePlugin, "sync_delete", recording_delete)
        report = gc_snapshot(url, dry_run=False, evict_local=True)
        assert not report.errors
        payload = [p for p in order if p in report.reclaimed]
        assert hot_loc in payload and warm_loc in payload
        # Cold (never-read) blobs go first; warm before hot; the
        # hottest tile is the LAST payload blob to leave the cache.
        assert payload[-1] == hot_loc
        assert payload[-2] == warm_loc


# ---------------------------------------------------- heatmap CLI leg


def test_heatmap_cli_exit_contract(tmp_path, tele_env, capsys):
    path = str(tmp_path / "snap")
    state = {
        "m": StateDict(
            **{f"w{i}": torch.arange(4096, dtype=torch.float32) + i for i in range(4)}
        )
    }
    Snapshot.take(path, state)
    # No ledgers yet: exit 3 (no data, the slo/history stance).
    assert main(["heatmap", path]) == 3
    capsys.readouterr()
    Snapshot(path).read_object("0/m/w0")
    assert main(["heatmap", path]) == 0
    out = capsys.readouterr().out
    assert "coverage" in out and "m/w0" in out
    assert main(["heatmap", path, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["n_readers"] == 1
    assert 0 < doc["coverage"] < 1
    assert "breach" not in doc  # only stamped when a threshold is set
    assert (
        main(["heatmap", path, "--json", "--max-amplification", "5"]) == 0
    )
    doc = json.loads(capsys.readouterr().out)
    assert doc["breach"] is False and doc["max_amplification"] == 5.0
    # Gate: amplification over budget → exit 2; within → 0.
    assert (
        main(["heatmap", path, "--check", "--max-amplification", "0.01"])
        == 2
    )
    capsys.readouterr()
    assert (
        main(["heatmap", path, "--check", "--max-amplification", "5"]) == 0
    )
    capsys.readouterr()


# ------------------------------------------------------ cross-package


def test_ledgers_of_both_packages_merge_into_one_heatmap(tmp_path, tele_env):
    """A snapshot tpusnap took, read by both packages (a full restore in
    each, one ``read_object`` in the port): the ledgers land under the
    same digest, and each package's loader and heatmap read all of them
    alike."""
    from tpusnap import StateDict as JaxStateDict
    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import access as jax_access
    from tpusnap.__main__ import _heatmap_metadata as jax_heatmap_metadata

    arrays = {f"w{i}": np.arange(4096, dtype=np.float32) + i for i in range(4)}
    path = str(tmp_path / "snap")
    JaxSnapshot.take(path, {"m": JaxStateDict(**arrays)})
    with knobs.override_job_id("jaxreader"):
        JaxSnapshot(path).restore(
            {"m": JaxStateDict(**{k: np.zeros_like(v) for k, v in arrays.items()})}
        )
    with knobs.override_job_id("portreader"):
        dst = {"m": StateDict(**{k: torch.zeros(4096) for k in arrays})}
        Snapshot(path).restore(dst)
        assert torch.equal(dst["m"]["w2"], torch.from_numpy(arrays["w2"]))
        Snapshot(path).read_object("0/m/w1")
    ours = load_ledger_records(path)
    theirs = jax_access.load_ledger_records(path)
    assert sorted(map(json.dumps, ours)) == sorted(map(json.dumps, theirs))
    assert {r["job_id"] for r in ours} == {"jaxreader", "portreader"}
    hm = compute_heatmap(ours, _heatmap_metadata(path))
    assert hm == jax_access.compute_heatmap(theirs, jax_heatmap_metadata(path))
    assert hm["n_readers"] == 2 and hm["coverage"] > 0.99
