"""Write-back tiering in the port (tpusnap_torch/tiering.py), held to
tpusnap's tests/test_tiering.py case by case on CPU tensors: the tier
URL, the local commit with remote read-through, the crash-safe dual-hash
upload journal and resume, chain-aware draining, the outage circuit,
``gc --evict-local`` and the crash matrix (SIGKILLed drain and eviction
children). The cases whose subject is A9 (SLO gate, the CLI, history and
Prometheus export) wait for it (ROADMAP.md). Every restore is bit-exact.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpusnap_torch import Snapshot, StateDict, knobs, telemetry, tiering
from tpusnap_torch.faults import FaultPlan
from tpusnap_torch.io_types import UPLOAD_JOURNAL_PATH, ReadIO, StoragePlugin, WriteIO
from tpusnap_torch.lifecycle import fsck_snapshot, gc_snapshot
from tpusnap_torch.storage_plugin import (
    register_storage_plugin,
    unregister_storage_plugin,
    url_to_storage_plugin,
)
from tpusnap_torch.tiering import (
    DrainReport,
    drain_snapshot,
    parse_tier_url,
    read_upload_journal_dir,
    restore_source_label,
    tier_state_of_dir,
)

pytestmark = pytest.mark.tiering

_N = 6
_SHAPE = (64, 64)


def _state(seed: int = 0):
    return {
        "m": StateDict(
            **{
                f"w{i}": torch.from_numpy(
                    np.random.default_rng(seed * 100 + i)
                    .standard_normal(_SHAPE)
                    .astype(np.float32)
                )
                for i in range(_N)
            }
        )
    }


def _zeros():
    return {
        "m": StateDict(**{f"w{i}": torch.zeros(_SHAPE) for i in range(_N)})
    }


def _assert_eq(a, b):
    """Bit-exact (tolerance 0)."""
    for k in a["m"]:
        assert torch.equal(a["m"][k], b["m"][k]), k


def _tier_url(tmp_path, name="snap", remote_scheme="fs"):
    cache = os.path.join(str(tmp_path), "cache")
    remote_root = os.path.join(str(tmp_path), "remote")
    return (
        f"tier+local={cache}+remote={remote_scheme}://{remote_root}/{name}",
        os.path.join(str(tmp_path), "remote", name),
    )


@pytest.fixture(autouse=True)
def _isolated_tier_env(tmp_path, monkeypatch):
    """Each test gets its own telemetry dir (the tier status sidecar
    lives there) and a quiet, manually-driven drain by default."""
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "tele"))
    monkeypatch.setenv("TPUSNAP_TIER_DRAIN", "0")
    yield
    tiering.reset_manager_for_tests()


# ------------------------------------------------------------- URL parsing


def test_parse_tier_url_basic():
    spec = parse_tier_url("tier+local=/nvme/cache+remote=s3://bucket/run1")
    assert spec is not None
    assert spec.local_base == "/nvme/cache"
    assert spec.remote_url == "s3://bucket/run1"
    assert spec.local_dir == "/nvme/cache/bucket/run1"


def test_parse_tier_url_composed_remote_and_suffix():
    spec = parse_tier_url(
        "tier+local=/c+remote=chaos+fsspec+memory://root/run/inc_0001"
    )
    assert spec.remote_scheme == "chaos+fsspec+memory"
    # Appending a member suffix to the URL extends BOTH tiers.
    assert spec.local_dir == "/c/root/run/inc_0001"
    assert spec.remote_url == "chaos+fsspec+memory://root/run/inc_0001"


def test_parse_tier_url_rejects_malformed():
    assert parse_tier_url("fs:///plain") is None
    assert parse_tier_url("/plain/dir") is None
    with pytest.raises(ValueError):
        parse_tier_url("tier+remote=s3://b/x")
    with pytest.raises(ValueError):
        parse_tier_url("tier+local=+remote=s3://b/x")


def test_chaos_around_whole_tier_refused(tmp_path):
    url, _ = _tier_url(tmp_path)
    with pytest.raises(RuntimeError, match="remote sub-scheme"):
        url_to_storage_plugin("chaos+" + url)


# ------------------------------------------------------- plugin semantics


def test_writes_stay_local_reads_fall_back(tmp_path):
    url, remote_dir = _tier_url(tmp_path)
    plugin = url_to_storage_plugin(url)
    local_dir = plugin.local_dir
    try:
        plugin.sync_write(WriteIO(path="blob/a", buf=b"payload-bytes"))
        assert os.path.exists(os.path.join(local_dir, "blob/a"))
        assert not os.path.exists(os.path.join(remote_dir, "blob/a"))

        # Sidecar miss must NOT consult the remote (it would put a
        # possibly-down endpoint on the take path): plain miss.
        probe = ReadIO(path=UPLOAD_JOURNAL_PATH + ".absent")
        with pytest.raises(FileNotFoundError):
            plugin.sync_read(probe)

        # A blob present only remotely reads through.
        os.makedirs(os.path.join(remote_dir, "blob"), exist_ok=True)
        with open(os.path.join(remote_dir, "blob/b"), "wb") as f:
            f.write(b"remote-only")
        rio = ReadIO(path="blob/b")
        plugin.sync_read(rio)
        assert rio.buf.getvalue() == b"remote-only"

        # Deletes propagate to both tiers (remote-only file included).
        plugin.sync_delete("blob/b")
        assert not os.path.exists(os.path.join(remote_dir, "blob/b"))
    finally:
        plugin.sync_close()


def test_listing_is_local_only(tmp_path):
    url, remote_dir = _tier_url(tmp_path)
    plugin = url_to_storage_plugin(url)
    try:
        plugin.sync_write(WriteIO(path="x", buf=b"1"))
        os.makedirs(remote_dir, exist_ok=True)
        with open(os.path.join(remote_dir, "remote_only"), "wb") as f:
            f.write(b"2")
        files = plugin.sync_list_with_sizes()
        assert "x" in files and "remote_only" not in files
    finally:
        plugin.sync_close()


# ----------------------------------------- take → drain → remote-durable


def test_take_drain_restore_roundtrip(tmp_path):
    url, remote_dir = _tier_url(tmp_path)
    state = _state()
    Snapshot.take(url, state)
    local_dir = parse_tier_url(url).local_dir

    rep = fsck_snapshot(local_dir)
    assert rep.state == "committed"
    assert rep.durability == "local-committed"
    assert rep.tier_remote.endswith("/snap")
    # Nothing reached the remote yet (drain disabled).
    assert not os.path.exists(os.path.join(remote_dir, ".snapshot_metadata"))

    report = drain_snapshot(url)
    assert report.state == "durable"
    assert report.blobs_uploaded == report.blobs_total > 0
    assert report.lag_bytes == 0

    rep2 = fsck_snapshot(local_dir)
    assert rep2.durability == "remote-durable"
    # The upload journal is a legit post-commit sidecar, not an orphan.
    assert UPLOAD_JOURNAL_PATH not in rep2.orphans

    # The REMOTE tier is a self-contained committed snapshot.
    restored = _zeros()
    Snapshot(remote_dir).restore(restored)
    _assert_eq(state, restored)

    # Idempotent re-drain: everything skips on journal evidence.
    again = drain_snapshot(url)
    assert again.state == "durable"
    assert again.blobs_uploaded == 0
    assert again.blobs_skipped == report.blobs_total


def test_background_drain_on_commit(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_TIER_DRAIN", "1")
    url, remote_dir = _tier_url(tmp_path)
    Snapshot.take(url, _state())
    assert tiering.drain_manager().wait_idle(timeout=60)
    st = tier_state_of_dir(parse_tier_url(url).local_dir)
    assert st["durability"] == "remote-durable"
    assert st["lag_bytes"] == 0
    assert os.path.exists(os.path.join(remote_dir, ".snapshot_metadata"))


def test_upload_journal_alone_is_not_foreign(tmp_path):
    d = str(tmp_path / "dir")
    os.makedirs(os.path.join(d, os.path.dirname(UPLOAD_JOURNAL_PATH)))
    with open(os.path.join(d, UPLOAD_JOURNAL_PATH), "w") as f:
        json.dump({"version": 1, "remote": "s3://b/x", "blobs": {}}, f)
    rep = fsck_snapshot(d)
    assert rep.state == "empty"


# -------------------------------------------------- resume / skip-on-resume


class _FailAfterK(StoragePlugin):
    """Remote double that accepts K payload writes then hard-fails
    (non-transient) — a deterministic in-process partial drain."""

    budget = {"n": 0}

    def __init__(self, inner):
        self.inner = inner

    async def write(self, write_io):
        if self.budget["n"] <= 0:
            raise OSError(5, "remote exploded")  # EIO: classified fatal
        self.budget["n"] -= 1
        await self.inner.write(write_io)

    async def write_atomic(self, write_io, durable=False):
        if self.budget["n"] <= 0:
            raise OSError(5, "remote exploded")
        self.budget["n"] -= 1
        await self.inner.write_atomic(write_io, durable=durable)

    async def read(self, read_io):
        await self.inner.read(read_io)

    async def delete(self, path):
        await self.inner.delete(path)

    async def list_with_sizes(self):
        return await self.inner.list_with_sizes()

    async def close(self):
        await self.inner.close()


def test_drain_resume_skips_proven_blobs(tmp_path, monkeypatch):
    """Partial drain (remote dies after K uploads) → degraded; the
    resumed drain re-uploads ONLY the unproven remainder (≥50% of the
    bytes skip on journal evidence)."""
    from tpusnap_torch.storage_plugins.fs import FSStoragePlugin

    remote_root = str(tmp_path / "remote_fk")

    def factory(path, storage_options):
        return _FailAfterK(FSStoragePlugin(root=os.path.join(remote_root, path)))

    register_storage_plugin("failk", factory)
    try:
        cache = str(tmp_path / "cache")
        url = f"tier+local={cache}+remote=failk://snap"
        # Many small blobs: slab batching off so each array is its own
        # upload unit.
        with knobs.override_batching_disabled(True):
            Snapshot.take(url, _state())
        local_dir = parse_tier_url(url).local_dir

        _FailAfterK.budget["n"] = 4  # enough for 4 of the 6+ blobs
        with knobs.override_tier_outage(threshold=1, backoff_cap_s=0.05):
            partial = drain_snapshot(url, deadline_s=2.0)
        assert partial.state == "degraded"
        assert partial.blobs_uploaded == 4
        assert partial.degraded_episodes >= 1
        assert partial.lag_bytes > 0
        # fsck still says local-committed: durability never lies.
        assert fsck_snapshot(local_dir).durability == "local-committed"

        _FailAfterK.budget["n"] = 10**9  # remote healthy again
        resumed = drain_snapshot(url)
        assert resumed.state == "durable"
        assert resumed.blobs_skipped == 4
        total = resumed.bytes_skipped + resumed.bytes_uploaded
        assert resumed.bytes_skipped >= total * 0.5
        restored = _zeros()
        Snapshot(os.path.join(remote_root, "snap")).restore(restored)
        _assert_eq(_state(), restored)
    finally:
        unregister_storage_plugin("failk")


class _StampOnFirstWrite(StoragePlugin):
    """Remote double that, on its first payload write, re-stamps the
    LOCAL upload journal's committed_at — deterministically simulating
    a retake committing to the dir while the drain is mid-flight."""

    hooks = {"local_dir": None, "fired": False}

    def __init__(self, inner):
        self.inner = inner

    async def write(self, write_io):
        if not self.hooks["fired"]:
            self.hooks["fired"] = True
            jpath = os.path.join(self.hooks["local_dir"], UPLOAD_JOURNAL_PATH)
            with open(jpath) as f:
                journal = json.load(f)
            journal["committed_at"] = (journal.get("committed_at") or 0) + 99.0
            journal["state"] = "pending"
            with open(jpath, "w") as f:
                json.dump(journal, f)
        await self.inner.write(write_io)

    async def write_atomic(self, write_io, durable=False):
        await self.inner.write_atomic(write_io, durable=durable)

    async def read(self, read_io):
        await self.inner.read(read_io)

    async def delete(self, path):
        await self.inner.delete(path)

    async def list_with_sizes(self):
        return await self.inner.list_with_sizes()

    async def close(self):
        await self.inner.close()


def test_concurrent_retake_never_clobbered_by_durable_marker(tmp_path):
    """A retake committing WHILE a drain runs must not end up falsely
    remote-durable: the drain's journal flushes merge (the new pending
    stamp survives) and the durable marker is refused (superseded)."""
    from tpusnap_torch.storage_plugins.fs import FSStoragePlugin

    remote_root = str(tmp_path / "remote_stamp")

    def factory(path, storage_options):
        return _StampOnFirstWrite(
            FSStoragePlugin(root=os.path.join(remote_root, path))
        )

    register_storage_plugin("stampfs", factory)
    try:
        cache = str(tmp_path / "cache")
        url = f"tier+local={cache}+remote=stampfs://snap"
        Snapshot.take(url, _state())
        local_dir = parse_tier_url(url).local_dir
        _StampOnFirstWrite.hooks.update(local_dir=local_dir, fired=False)

        report = drain_snapshot(url)
        assert report.state == "superseded", report.summary()
        journal = read_upload_journal_dir(local_dir)
        # The concurrent commit's stamp survived every flush and the
        # durability state stayed honest.
        assert journal["state"] == "pending"
        assert fsck_snapshot(local_dir).durability == "local-committed"
        # Evidence still accumulated: the follow-up drain skips it all
        # and converges.
        converged = drain_snapshot(url)
        assert converged.state == "durable"
        assert converged.blobs_uploaded == 0
        assert converged.blobs_skipped == report.blobs_uploaded
    finally:
        unregister_storage_plugin("stampfs")


def test_retake_first_write_clears_commit_stamp(tmp_path):
    """The seed of a RETAKE must drop the previous take's commit stamp:
    an in-flight drain of take N gates its durable marker on that
    stamp, and a stale one surviving into take N+1's pre-commit window
    would let the drain bless the dir while N+1 overwrites payload."""
    url, _ = _tier_url(tmp_path)
    Snapshot.take(url, _state())
    local_dir = parse_tier_url(url).local_dir
    assert read_upload_journal_dir(local_dir)["committed_at"] is not None
    # Simulate the retake's FIRST blob write (before any commit).
    plugin = url_to_storage_plugin(url)
    try:
        plugin.sync_write(WriteIO(path="0/m/w0", buf=b"new-bytes"))
    finally:
        plugin.sync_close()
    journal = read_upload_journal_dir(local_dir)
    assert journal["state"] == "pending"
    assert journal.get("committed_at") is None  # stamp gone with the seed


def test_delete_surfaces_real_local_failure(tmp_path, monkeypatch):
    """A non-FileNotFoundError local delete failure must raise even
    when the remote delete succeeds — otherwise gc/retention report
    bytes reclaimed that still occupy the local disk."""
    from tpusnap_torch.storage_plugins import fs as fs_mod

    url, remote_dir = _tier_url(tmp_path)
    Snapshot.take(url, _state())
    assert drain_snapshot(url).state == "durable"
    plugin = url_to_storage_plugin(url)
    orig = fs_mod.FSStoragePlugin.delete

    async def deny_local(self, path):
        if self.root.startswith(str(tmp_path / "cache")):
            raise PermissionError(13, "read-only local tier")
        await orig(self, path)

    monkeypatch.setattr(fs_mod.FSStoragePlugin, "delete", deny_local)
    try:
        with pytest.raises(PermissionError):
            plugin.sync_delete(".snapshot_metadata")
        # Evicted blob (genuine local miss) still deletes via remote.
        monkeypatch.undo()
    finally:
        plugin.sync_close()


def test_manager_requeues_enqueue_during_active_drain(tmp_path, monkeypatch):
    """enqueue() for a dir whose drain is ACTIVE must re-run after it —
    a retake's bytes must not stay local-committed forever."""
    import threading

    from tpusnap_torch.storage_plugins.fs import FSStoragePlugin

    remote_root = str(tmp_path / "remote_slow")
    gate = threading.Event()
    started = threading.Event()

    class _Slow(StoragePlugin):
        def __init__(self, inner):
            self.inner = inner

        async def write(self, write_io):
            started.set()
            import asyncio as _a

            while not gate.is_set():
                await _a.sleep(0.01)
            await self.inner.write(write_io)

        async def write_atomic(self, write_io, durable=False):
            await self.inner.write_atomic(write_io, durable=durable)

        async def read(self, read_io):
            await self.inner.read(read_io)

        async def delete(self, path):
            await self.inner.delete(path)

        async def list_with_sizes(self):
            return await self.inner.list_with_sizes()

        async def close(self):
            await self.inner.close()

    def factory(path, storage_options):
        return _Slow(FSStoragePlugin(root=os.path.join(remote_root, path)))

    register_storage_plugin("slowfs", factory)
    try:
        cache = str(tmp_path / "cache")
        url = f"tier+local={cache}+remote=slowfs://snap"
        Snapshot.take(url, _state())
        local_dir = parse_tier_url(url).local_dir
        mgr = tiering.drain_manager()
        mgr.enqueue(local_dir, "slowfs://snap", None)
        assert started.wait(timeout=30), "drain never started"
        # Retake while the drain is stuck inside its first upload: the
        # journal gets a new stamp, and the enqueue lands mid-active.
        Snapshot.take(url, _state(seed=1))
        mgr.enqueue(local_dir, "slowfs://snap", None)
        gate.set()
        assert mgr.wait_idle(timeout=60)
        journal = read_upload_journal_dir(local_dir)
        assert journal["state"] == "durable"
        restored = _zeros()
        Snapshot(os.path.join(remote_root, "snap")).restore(restored)
        _assert_eq(_state(seed=1), restored)  # the RETAKE's bytes
    finally:
        unregister_storage_plugin("slowfs")



# --------------------------------------------------- chain-aware draining


def test_drain_uploads_incremental_base_first(tmp_path):
    cache = str(tmp_path / "cache")
    remote_root = str(tmp_path / "remote")
    base_url = f"tier+local={cache}+remote=fs://{remote_root}/base"
    inc_url = f"tier+local={cache}+remote=fs://{remote_root}/inc"
    state = _state()
    Snapshot.take(base_url, state)
    state["m"]["w0"] = state["m"]["w0"] + 1.0
    Snapshot.take(
        inc_url, state, incremental_from=parse_tier_url(base_url).local_dir
    )

    report = drain_snapshot(inc_url)
    assert report.state == "durable"
    # The base drained first, to its remote sibling.
    assert report.bases and report.bases[0].state == "durable"
    assert os.path.exists(os.path.join(remote_root, "base", ".snapshot_metadata"))
    restored = _zeros()
    Snapshot(os.path.join(remote_root, "inc")).restore(restored)
    _assert_eq(state, restored)


def test_drain_skips_orphans_and_zero_byte_blobs(tmp_path):
    """Only manifest-referenced blobs drain (orphans/.tmp debris are
    gc's business, not cloud spend), and tiny/empty referenced blobs
    skip on evidence like any other — a fully-proven snapshot re-drains
    with zero uploads."""
    url, remote_dir = _tier_url(tmp_path)
    state = _state()
    state["m"]["empty"] = torch.zeros((0,))
    Snapshot.take(url, state)
    local_dir = parse_tier_url(url).local_dir
    # Plant an orphan and flush debris next to the payload.
    with open(os.path.join(local_dir, "orphan_blob"), "wb") as f:
        f.write(b"x" * 512)
    with open(os.path.join(local_dir, "0.tmp.999"), "wb") as f:
        f.write(b"y" * 512)
    report = drain_snapshot(url)
    assert report.state == "durable"
    assert not os.path.exists(os.path.join(remote_dir, "orphan_blob"))
    assert not os.path.exists(os.path.join(remote_dir, "0.tmp.999"))
    # Orphans don't count as upload lag either.
    assert tier_state_of_dir(local_dir)["lag_bytes"] == 0
    again = drain_snapshot(url)
    assert again.blobs_uploaded == 0


def test_malformed_journal_evidence_rereads_not_crashes(tmp_path):
    url, _ = _tier_url(tmp_path)
    Snapshot.take(url, _state())
    local_dir = parse_tier_url(url).local_dir
    jpath = os.path.join(local_dir, UPLOAD_JOURNAL_PATH)
    with open(jpath, "w") as f:
        json.dump(
            {"version": 1, "remote": "ignored", "blobs": {"0/m/w0": 42}}, f
        )
    # Malformed evidence reads as absent (re-upload), never a crash.
    assert read_upload_journal_dir(local_dir)["blobs"] == {}
    report = drain_snapshot(url)
    assert report.state == "durable"
    assert report.blobs_uploaded == report.blobs_total


def test_drain_refuses_durable_with_unreachable_blobs(tmp_path):
    """A referenced blob neither present locally nor journal-proven
    must block the durable marker (the remote could not restore)."""
    url, _ = _tier_url(tmp_path)
    with knobs.override_batching_disabled(True):
        Snapshot.take(url, _state())
    local_dir = parse_tier_url(url).local_dir
    victim = next(
        os.path.join(dp, f)
        for dp, _dn, fn in os.walk(os.path.join(local_dir, "0"))
        for f in fn
    )
    os.remove(victim)
    report = drain_snapshot(url)
    assert report.state == "missing-blobs"
    assert fsck_snapshot(local_dir).durability == "local-committed"


def test_base_short_circuits_once_durable(tmp_path):
    """A delta/incremental drain must not re-hash its whole durable
    base chain on every micro-commit: the base recursion short-circuits
    on the base's durable marker."""
    cache = str(tmp_path / "cache")
    remote_root = str(tmp_path / "remote")
    base_url = f"tier+local={cache}+remote=fs://{remote_root}/base"
    inc_url = f"tier+local={cache}+remote=fs://{remote_root}/inc"
    state = _state()
    Snapshot.take(base_url, state)
    state["m"]["w0"] = state["m"]["w0"] + 1.0
    Snapshot.take(
        inc_url, state, incremental_from=parse_tier_url(base_url).local_dir
    )
    first = drain_snapshot(inc_url)
    assert first.state == "durable"
    assert first.bases[0].blobs_total > 0  # base actually drained
    second = drain_snapshot(inc_url)
    assert second.state == "durable"
    # Short-circuited: no blob pass ran against the base at all.
    assert second.bases[0].blobs_total == 0
    assert second.bases[0].blobs_skipped == 0


def test_queued_backlog_counts_in_lag(tmp_path, monkeypatch):
    """tpusnap_upload_lag_bytes covers the QUEUE, not just the active
    job: snapshots piling up behind a stuck drain are exposure too."""
    import threading

    from tpusnap_torch.storage_plugins.fs import FSStoragePlugin

    remote_root = str(tmp_path / "remote_q")
    gate = threading.Event()
    started = threading.Event()

    class _Gated(StoragePlugin):
        def __init__(self, inner):
            self.inner = inner

        async def write(self, write_io):
            started.set()
            import asyncio as _a

            while not gate.is_set():
                await _a.sleep(0.01)
            await self.inner.write(write_io)

        async def write_atomic(self, write_io, durable=False):
            await self.inner.write_atomic(write_io, durable=durable)

        async def read(self, read_io):
            await self.inner.read(read_io)

        async def delete(self, path):
            await self.inner.delete(path)

        async def list_with_sizes(self):
            return await self.inner.list_with_sizes()

        async def close(self):
            await self.inner.close()

    def factory(path, storage_options):
        return _Gated(FSStoragePlugin(root=os.path.join(remote_root, path)))

    register_storage_plugin("gatedfs", factory)
    try:
        cache = str(tmp_path / "cache")
        url_a = f"tier+local={cache}+remote=gatedfs://a"
        url_b = f"tier+local={cache}+remote=gatedfs://b"
        Snapshot.take(url_a, _state())
        Snapshot.take(url_b, _state(seed=1))
        mgr = tiering.drain_manager()
        mgr.enqueue(parse_tier_url(url_a).local_dir, "gatedfs://a", None)
        assert started.wait(timeout=30)
        mgr.enqueue(parse_tier_url(url_b).local_dir, "gatedfs://b", None)
        st = tiering.current_status()
        # Snapshot B is queued behind the stuck A: its bytes are lag.
        assert st.get("queued_lag_bytes", 0) > 0
        assert st["lag_bytes"] >= st["queued_lag_bytes"]
        gate.set()
        assert mgr.wait_idle(timeout=60)
        st = tiering.current_status()
        assert st["lag_bytes"] == 0 and st.get("queued_lag_bytes", 0) == 0
    finally:
        unregister_storage_plugin("gatedfs")


# ------------------------------------------------------- outage tolerance


@pytest.mark.chaos
def test_outage_take_never_blocks_and_lag_recovers(tmp_path, monkeypatch):
    """The acceptance soak, shrunk: remote down for a window — the
    tiered take's wall stays within 1.5x of a plain local take (+ a
    small absolute floor for fixed per-take overhead at this tiny
    size), the drain degrades (lag gauge > 0, degraded episode
    counted), then recovers to remote-durable with lag 0."""
    monkeypatch.setenv("TPUSNAP_TIER_DRAIN", "1")
    state = _state()
    t0 = time.monotonic()
    Snapshot.take(str(tmp_path / "plain"), state)
    plain_wall = time.monotonic() - t0

    url, remote_dir = _tier_url(tmp_path, remote_scheme="chaos+fs")
    opts = {"fault_plan": FaultPlan(outage=("*", 0.0, 1.2))}
    before = telemetry.global_counters_snapshot().get(
        "tier.degraded_episodes", 0
    )
    with knobs.override_tier_outage(
        threshold=1, backoff_cap_s=0.1, op_deadline_s=0.1
    ):
        t0 = time.monotonic()
        Snapshot.take(url, state, storage_options=opts)
        tier_wall = time.monotonic() - t0
        assert tier_wall <= max(plain_wall * 1.5, plain_wall + 0.5), (
            f"tiered take blocked on the outage: {tier_wall:.2f}s vs "
            f"plain {plain_wall:.2f}s"
        )
        # Lag is visible while the outage holds the drain back.
        deadline = time.monotonic() + 10
        saw_lag = False
        while time.monotonic() < deadline:
            st = tiering.read_tier_status()
            if st and (st.get("lag_bytes") or 0) > 0:
                saw_lag = True
                break
            time.sleep(0.02)
        assert saw_lag, "upload lag never surfaced during the outage"
        # ...and falls to zero once the window passes.
        assert tiering.drain_manager().wait_idle(timeout=30)
    st = tiering.read_tier_status()
    assert st["state"] == "durable" and st["lag_bytes"] == 0
    after = telemetry.global_counters_snapshot().get(
        "tier.degraded_episodes", 0
    )
    assert after > before
    assert fsck_snapshot(parse_tier_url(url).local_dir).durability == (
        "remote-durable"
    )
    restored = _zeros()
    Snapshot(remote_dir).restore(restored)
    _assert_eq(state, restored)


@pytest.mark.slow
@pytest.mark.chaos
def test_outage_take_local_speed_2gb(tmp_path, monkeypatch):
    """The acceptance criterion at full scale: a 2 GB tiered take
    against an unavailable remote commits within 1.5x of a plain local
    take."""
    monkeypatch.setenv("TPUSNAP_TIER_DRAIN", "0")
    big = {
        "m": StateDict(
            **{
                f"w{i}": torch.from_numpy(
                    np.random.default_rng(i)
                    .standard_normal((128, 1024, 1024))
                    .astype(np.float32)
                )
                for i in range(4)
            }
        )
    }  # 4 x 512 MB
    t0 = time.monotonic()
    Snapshot.take(str(tmp_path / "plain"), big)
    plain_wall = time.monotonic() - t0

    url, _ = _tier_url(tmp_path, remote_scheme="chaos+fs")
    opts = {"fault_plan": FaultPlan(outage=("*", 0.0, 3600.0))}
    t0 = time.monotonic()
    Snapshot.take(url, big, storage_options=opts)
    tier_wall = time.monotonic() - t0
    assert tier_wall <= plain_wall * 1.5, (
        f"2GB tiered take blocked on the outage: {tier_wall:.2f}s vs "
        f"plain {plain_wall:.2f}s"
    )
    assert (
        fsck_snapshot(parse_tier_url(url).local_dir).durability
        == "local-committed"
    )


# ------------------------------------------------------------ crash matrix


_DRAIN_CHILD = r"""
import os, sys
os.environ["TPUSNAP_TIER_DRAIN"] = "0"
import numpy as np
import torch
from tpusnap_torch import Snapshot, StateDict, tiering

url, kill_after = sys.argv[1], int(sys.argv[2])
state = {"m": StateDict(**{
    f"w{i}": torch.from_numpy(
        np.random.default_rng(i).standard_normal((64, 64)).astype(np.float32))
    for i in range(6)})}
from tpusnap_torch.knobs import override_batching_disabled
with override_batching_disabled(True):
    Snapshot.take(url, state)
print("TAKEN", flush=True)
# Chaos remote SIGKILLs this process right after the Nth successful
# payload write — mid-upload-drain, deterministic.
os.environ["TPUSNAP_FAULT_SPEC"] = f"crash_after_op=write:{kill_after}"
spec = tiering.parse_tier_url(url)
tiering.drain_snapshot(url, remote_url="chaos+" + spec.remote_url)
print("DRAINED (kill overshot)", flush=True)
"""


def test_sigkill_mid_drain_resume_skips_half(tmp_path):
    """Crash-matrix window (a): SIGKILL mid-upload-drain. fsck says
    local-committed; the restarted drain converges to remote-durable
    with ≥50% of the upload bytes skipped on journal evidence."""
    url, remote_dir = _tier_url(tmp_path)
    kill_after = 4  # of 6 single-array blobs
    r = subprocess.run(
        [sys.executable, "-c", _DRAIN_CHILD, url, str(kill_after)],
        capture_output=True,
        text=True,
        env={**os.environ, "TPUSNAP_TELEMETRY_DIR": str(tmp_path / "tele_c")},
        timeout=180,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == -signal.SIGKILL, r.stdout + r.stderr
    assert "TAKEN" in r.stdout

    local_dir = parse_tier_url(url).local_dir
    rep = fsck_snapshot(local_dir)
    assert rep.state == "committed"
    assert rep.durability == "local-committed"
    # No remote metadata: the remote tier never half-commits.
    assert not os.path.exists(os.path.join(remote_dir, ".snapshot_metadata"))
    journal = read_upload_journal_dir(local_dir)
    assert journal["state"] == "pending"
    # Evidence for at least the pre-kill blobs minus the in-flight one.
    assert len(journal["blobs"]) >= kill_after - 1

    resumed = drain_snapshot(url)
    assert resumed.state == "durable"
    total = resumed.bytes_skipped + resumed.bytes_uploaded
    assert resumed.bytes_skipped >= total * 0.5, resumed.summary()
    restored = _zeros()
    Snapshot(remote_dir).restore(restored)
    _assert_eq(_state(), restored)


_GC_CHILD = r"""
import os, sys
local_dir, kill_after = sys.argv[1], int(sys.argv[2])
os.environ["TPUSNAP_FAULT_SPEC"] = f"crash_after_op=delete:{kill_after}"
from tpusnap_torch.lifecycle import gc_snapshot
print("MARK", flush=True)
gc_snapshot("chaos+fs://" + local_dir, dry_run=False, evict_local=True)
print("EVICTED (kill overshot)", flush=True)
"""


def test_sigkill_mid_evict_remote_stays_restorable(tmp_path):
    """Crash-matrix window (b): SIGKILL mid-gc of drained local blobs.
    The remote-durable snapshot stays restorable from the remote, and
    the local dir keeps classifying remote-durable (partial eviction =
    evicted blobs, never 'missing')."""
    url, remote_dir = _tier_url(tmp_path)
    with knobs.override_batching_disabled(True):
        Snapshot.take(url, _state())
    assert drain_snapshot(url).state == "durable"
    local_dir = parse_tier_url(url).local_dir

    r = subprocess.run(
        [sys.executable, "-c", _GC_CHILD, local_dir, "2"],
        capture_output=True,
        text=True,
        env={**os.environ, "TPUSNAP_TELEMETRY_DIR": str(tmp_path / "tele_c")},
        timeout=180,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == -signal.SIGKILL, r.stdout + r.stderr

    rep = fsck_snapshot(local_dir)
    assert rep.state == "committed"
    assert rep.durability == "remote-durable"
    assert rep.evicted and not rep.missing_referenced
    # Restorable from the remote, bit-exact — and through the tier URL
    # (per-blob fallback over the half-evicted cache).
    for path in (remote_dir, url):
        restored = _zeros()
        Snapshot(path).restore(restored)
        _assert_eq(_state(), restored)


# ----------------------------------------------------------- gc eviction


def test_evict_refused_before_durable_and_within_retention(tmp_path):
    url, _ = _tier_url(tmp_path)
    Snapshot.take(url, _state())
    local_dir = parse_tier_url(url).local_dir
    with pytest.raises(RuntimeError, match="NOT yet proven remote"):
        gc_snapshot(local_dir, dry_run=False, evict_local=True)

    assert drain_snapshot(url).state == "durable"
    with knobs.override_tier_outage(local_retention_s=3600):
        with pytest.raises(RuntimeError, match="hot local cache"):
            gc_snapshot(local_dir, dry_run=False, evict_local=True)

    report = gc_snapshot(local_dir, dry_run=False, evict_local=True)
    assert report.bytes_reclaimed > 0
    rep = fsck_snapshot(local_dir)
    assert rep.durability == "remote-durable"
    assert rep.evicted and not rep.missing_referenced
    restored = _zeros()
    Snapshot(url).restore(restored)  # read-through after eviction
    _assert_eq(_state(), restored)
    assert (
        telemetry.global_counters_snapshot().get("tier.remote_fallback_reads", 0)
        > 0
    )


def test_evict_via_tier_url_never_touches_remote(tmp_path):
    url, remote_dir = _tier_url(tmp_path)
    Snapshot.take(url, _state())
    assert drain_snapshot(url).state == "durable"
    gc_snapshot(url, dry_run=False, evict_local=True)
    # The remote copy is intact (eviction rewrote the path to local).
    restored = _zeros()
    Snapshot(remote_dir).restore(restored)
    _assert_eq(_state(), restored)



# ------------------------------------------------- outage fault (faults.py)


@pytest.mark.chaos
class TestOutageFault:
    def test_spec_parse(self):
        p = FaultPlan.from_spec("outage=write:10")
        assert p.outage == ("write", 0.0, 10.0)
        p = FaultPlan.from_spec("outage=*:5:10")
        assert p.outage == ("*", 5.0, 10.0)
        with pytest.raises(ValueError):
            FaultPlan.from_spec("outage=10")

    def test_window_is_deterministic(self, tmp_path, monkeypatch):
        from tpusnap_torch import faults as faults_mod
        from tpusnap_torch.faults import (
            FaultInjectionStoragePlugin,
            InjectedFaultError,
        )
        from tpusnap_torch.storage_plugins.fs import FSStoragePlugin

        clock = [100.0]
        monkeypatch.setattr(faults_mod, "_mono", lambda: clock[0])
        plugin = FaultInjectionStoragePlugin(
            FSStoragePlugin(root=str(tmp_path / "d")),
            FaultPlan(outage=("write", 2.0, 5.0)),
        )
        # t=0 (anchor): before the window — op succeeds.
        plugin.sync_write(WriteIO(path="a", buf=b"1"))
        clock[0] += 3.0  # t=3: inside [2, 7)
        with pytest.raises(InjectedFaultError, match="outage"):
            plugin.sync_write(WriteIO(path="b", buf=b"2"))
        # Reads are untouched (kind filter).
        rio = ReadIO(path="a")
        plugin.sync_read(rio)
        assert rio.buf.getvalue() == b"1"
        clock[0] += 5.0  # t=8: window over
        plugin.sync_write(WriteIO(path="b", buf=b"2"))
        counters = telemetry.global_counters_snapshot()
        assert counters.get("faults.outage.write", 0) >= 1


# ------------------------------------- retry-budget exhaustion (retry.py)


class _AlwaysDown(StoragePlugin):
    async def write(self, write_io):
        raise ConnectionError("down")

    async def read(self, read_io):
        raise ConnectionError("down")

    async def delete(self, path):
        raise ConnectionError("down")


def test_retry_exhaustion_counter_and_flight_event():
    from tpusnap_torch import flight
    from tpusnap_torch.retry import RetryingStoragePlugin, RetryPolicy

    flight.reset_for_tests()
    plugin = RetryingStoragePlugin(
        _AlwaysDown(),
        RetryPolicy(deadline_sec=0.0, backoff_base_sec=0.001),
    )
    before = telemetry.global_counters_snapshot().get(
        "retry.exhausted.write", 0
    )
    with pytest.raises(ConnectionError):
        plugin.sync_write(WriteIO(path="blob/x", buf=b"z"))
    after = telemetry.global_counters_snapshot().get("retry.exhausted.write", 0)
    assert after == before + 1
    events = [
        e
        for e in flight.recorder().snapshot_events()
        if e.get("k") == "retry_exhausted"
    ]
    assert events, "no retry_exhausted flight breadcrumb"
    ev = events[-1]
    assert ev["op"] == "write" and ev["path"] == "blob/x"
    assert ev["error"] == "ConnectionError"


def test_hard_fatal_still_counts_fatal():
    from tpusnap_torch.retry import RetryingStoragePlugin, RetryPolicy

    class _Denied(StoragePlugin):
        async def write(self, write_io):
            raise PermissionError(13, "nope")

        async def read(self, read_io):
            raise PermissionError(13, "nope")

        async def delete(self, path):
            raise PermissionError(13, "nope")

    plugin = RetryingStoragePlugin(_Denied(), RetryPolicy(deadline_sec=60.0))
    before = telemetry.global_counters_snapshot()
    with pytest.raises(PermissionError):
        plugin.sync_write(WriteIO(path="blob/y", buf=b"z"))
    after = telemetry.global_counters_snapshot()
    assert after.get("retry.fatal.write", 0) == before.get(
        "retry.fatal.write", 0
    ) + 1
    assert after.get("retry.exhausted.write", 0) == before.get(
        "retry.exhausted.write", 0
    )


# ------------------------------------------------ restore source label



def test_restore_source_label_tracks_eviction(tmp_path):
    # Not tiered → no filter.
    assert restore_source_label(str(tmp_path)) is None
    url = f"tier+local={tmp_path / 'cache'}+remote=fs://{tmp_path / 'remote'}/s"
    Snapshot.take(url, _state())
    local_dir = parse_tier_url(url).local_dir
    # Cached → local tier label (both via URL and via the local dir).
    assert restore_source_label(url) == "FSStoragePlugin"
    assert restore_source_label(local_dir) == "FSStoragePlugin"
    drain_snapshot(url)
    gc_snapshot(local_dir, dry_run=False, evict_local=True)
    # Evicted → a restore reads the remote tier.
    # (remote scheme fs here; the label logic keys off cache state)
    journal = read_upload_journal_dir(local_dir)
    assert journal["state"] == "durable"
    assert restore_source_label(url) == "FSStoragePlugin"  # fs remote

    # Pretend the remote is s3 (label map leg, no client needed).
    journal["remote"] = "s3://bucket/s"
    with open(os.path.join(local_dir, UPLOAD_JOURNAL_PATH), "w") as f:
        json.dump(journal, f)
    assert restore_source_label(local_dir) == "S3StoragePlugin"




def test_drain_report_json_roundtrip():
    r = DrainReport(local_dir="/a", remote_url="fs:///b", state="durable")
    r.bases.append(
        DrainReport(local_dir="/base", remote_url="fs:///c", state="durable")
    )
    d = r.to_json()
    assert d["state"] == "durable" and d["bases"][0]["local_dir"] == "/base"


# ------------------------------------------------------------ cross-package


def _algos(path):
    """(checksum algorithms, dedup-hash algorithms) a manifest records."""
    md = json.load(open(os.path.join(path, ".snapshot_metadata")))
    crc, dedup = set(), set()
    for e in md["manifest"].values():
        if isinstance(e, dict):
            if "checksum" in e:
                crc.add(e["checksum"].split(":")[0])
            for h in [e.get("dedup_hash")] + list(e.get("tile_dedup_hashes") or []):
                if h:
                    dedup.add(h.split(":")[0])
    return crc, dedup


@pytest.mark.parametrize("drainer", ["port", "tpusnap"])
def test_tiered_snapshot_drained_by_one_package_is_durable_to_the_other(tmp_path, drainer):
    """A tiered snapshot one package took and drained is remote-durable
    in the other's fsck, and the remote restores bit-exact through both
    (tolerance 0)."""
    import tpusnap
    from tpusnap.lifecycle import fsck_snapshot as jax_fsck
    from tpusnap.tiering import drain_snapshot as jax_drain

    url, remote_dir = _tier_url(tmp_path)
    state = _state(5)
    if drainer == "port":
        Snapshot.take(url, state)
        assert drain_snapshot(url).state == "durable"
        rep = jax_fsck(parse_tier_url(url).local_dir)
    else:
        jax_state = {"m": tpusnap.StateDict(**{k: v.numpy() for k, v in state["m"].items()})}
        tpusnap.Snapshot.take(url, jax_state)
        assert jax_drain(url).state == "durable"
        rep = fsck_snapshot(parse_tier_url(url).local_dir)
    assert rep.state == "committed"
    assert rep.durability == "remote-durable"
    assert not rep.missing_referenced
    # Both packages hash with the same algorithms (the native builds).
    from tpusnap import _native as jax_native
    from tpusnap_torch import _native as port_native

    assert jax_native.checksum_algorithm() == port_native.checksum_algorithm() == "crc32c"
    assert jax_native.dedup_hash_algorithm() == port_native.dedup_hash_algorithm() == "xxh64"
    assert _algos(remote_dir)[0] == {"crc32c"}
    restored = _zeros()
    Snapshot(remote_dir).restore(restored)
    _assert_eq(state, restored)
    loaded = tpusnap.load_snapshot(remote_dir)["m"]
    for k, v in state["m"].items():
        assert np.asarray(loaded[k]).tobytes() == v.numpy().tobytes(), k
