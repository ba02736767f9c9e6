"""The content-addressed store in the port (tpusnap_torch/cas.py), held
to tpusnap's tests/test_cas.py case by case on CPU tensors: two jobs pay
for shared content once and restore bit-exact through their refs; the
intent/ref/grace state machine under a fake clock; the gc lease; SIGKILL
at the CAS chaos windows converging under fsck and gc; a publisher
against a gc sweeper in another process with zero lost blobs; and
``gc --evict-local`` with CAS refs. The CLI cases (``gc --store``,
``info``) wait for A9 (ROADMAP.md).
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

from tpusnap_torch import Snapshot, StateDict, knobs
from tpusnap_torch import cas
from tpusnap_torch.cas import (
    BLOBS_DIR,
    GC_LOCK_PATH,
    INTENTS_DIR,
    ROOTS_DIR,
    blob_key,
    blob_path,
    fsck_store,
    gc_store,
    read_refs_dir,
)
from tpusnap_torch.io_types import CAS_REFS_DIR
from tpusnap_torch.lifecycle import dual_hash_evidence, fsck_snapshot, gc_snapshot
from tpusnap_torch.storage_plugin import url_to_storage_plugin

pytestmark = pytest.mark.cas

_SHAPE = (96, 96)
_N = 4


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
    return {"m": StateDict(**{f"w{i}": torch.zeros(_SHAPE) for i in range(_N)})}


def _assert_eq(a, b):
    """Bit-exact (tolerance 0)."""
    for k in a["m"]:
        assert torch.equal(a["m"][k], b["m"][k]), k


@pytest.fixture(autouse=True)
def _isolated_cas_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "tele"))
    # Payload blobs must reach the CAS write path individually (slab
    # objects are uuid-named per take and deliberately never dedup).
    monkeypatch.setenv("TPUSNAP_DISABLE_BATCHING", "1")
    yield


# ------------------------------------------------- store construction


def _mk_store(root: str) -> str:
    for d in (BLOBS_DIR, INTENTS_DIR, ROOTS_DIR):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    return root


def _put_blob(store: str, data: bytes) -> str:
    key = blob_key(dual_hash_evidence(data))
    with open(os.path.join(store, blob_path(key)), "wb") as f:
        f.write(data)
    return key


def _put_ref_snapshot(store: str, snap_dir: str, loc: str, data: bytes):
    """Hand-build a snapshot dir holding one ref, rooted in the store."""
    triple = dual_hash_evidence(data)
    refs_dir = os.path.join(snap_dir, CAS_REFS_DIR)
    os.makedirs(refs_dir, exist_ok=True)
    with open(os.path.join(refs_dir, "rank_0.json"), "w") as f:
        json.dump(
            {"version": 1, "store": store, "refs": {loc: list(triple)}}, f
        )
    digest = cas._root_digest(os.path.abspath(snap_dir))
    with open(os.path.join(store, ROOTS_DIR, digest), "w") as f:
        json.dump({"dir": os.path.abspath(snap_dir), "ts": time.time()}, f)
    return blob_key(triple)


def _backdate(path: str, seconds: float) -> None:
    t = time.time() - seconds
    os.utime(path, (t, t))


# ---------------------------------------------- intent/ref/grace matrix


def test_blob_key_from_triple():
    nbytes, crc, xxh = dual_hash_evidence(b"payload bytes")
    key = blob_key((nbytes, crc, xxh))
    assert key == f"{crc.split(':')[1]}-{xxh.split(':')[1]}"
    assert blob_path(key) == f"blobs/{key}"


def test_orphan_sweeps_only_past_grace(tmp_path):
    store = _mk_store(str(tmp_path / "store"))
    key = _put_blob(store, b"orphan content")
    # Young orphan: inside the grace window, protected.
    rep = gc_store(store, dry_run=False, grace_s=60.0)
    assert not rep.reclaimed and rep.kept_young == 1
    assert os.path.exists(os.path.join(store, blob_path(key)))
    # Aged past grace: swept.
    _backdate(os.path.join(store, blob_path(key)), 120.0)
    rep = gc_store(store, dry_run=False, grace_s=60.0)
    assert blob_path(key) in rep.reclaimed
    assert not os.path.exists(os.path.join(store, blob_path(key)))


def test_fresh_intent_protects_unrooted_blob(tmp_path):
    store = _mk_store(str(tmp_path / "store"))
    key = _put_blob(store, b"mid-publish content")
    _backdate(os.path.join(store, blob_path(key)), 999.0)
    intent = os.path.join(store, INTENTS_DIR, f"{key}__555-abc")
    with open(intent, "w") as f:
        json.dump({"ts": time.time(), "job": "j1"}, f)
    # Fresh intent: the publisher is inside the publish-to-ref window —
    # the blob must survive even though it is old and unreferenced.
    rep = gc_store(store, dry_run=False, grace_s=60.0)
    assert blob_path(key) not in rep.reclaimed
    assert os.path.exists(os.path.join(store, blob_path(key)))
    # Stale intent: protection lapses; both intent and blob sweep.
    _backdate(intent, 120.0)
    rep = gc_store(store, dry_run=False, grace_s=60.0)
    assert blob_path(key) in rep.reclaimed
    assert f"{INTENTS_DIR}/{key}__555-abc" in rep.reclaimed


def test_refd_blob_never_sweeps_and_root_goes_stale(tmp_path):
    store = _mk_store(str(tmp_path / "store"))
    data = b"shared content" * 64
    snap = str(tmp_path / "snapA")
    key = _put_ref_snapshot(store, snap, "0/w", data)
    _put_blob(store, data)
    _backdate(os.path.join(store, blob_path(key)), 9999.0)
    rep = gc_store(store, dry_run=False, grace_s=60.0)
    assert blob_path(key) not in rep.reclaimed and rep.marked == 1
    # Snapshot dir deleted -> the root is stale; past grace the root
    # record sweeps, and with it the blob's liveness.
    import shutil

    shutil.rmtree(snap)
    for name in os.listdir(os.path.join(store, ROOTS_DIR)):
        _backdate(os.path.join(store, ROOTS_DIR, name), 120.0)
    rep = gc_store(store, dry_run=False, grace_s=60.0)
    assert any(p.startswith(ROOTS_DIR + "/") for p in rep.reclaimed)
    assert blob_path(key) in rep.reclaimed


def test_gc_lease_refuses_live_steals_expired(tmp_path, monkeypatch):
    store = _mk_store(str(tmp_path / "store"))
    now = 1_000_000.0
    monkeypatch.setattr(cas, "_wall", lambda: now)
    with open(os.path.join(store, GC_LOCK_PATH), "w") as f:
        json.dump({"owner": "other-host:1", "expires_at": now + 30.0}, f)
    with pytest.raises(RuntimeError, match="lease"):
        gc_store(store, dry_run=False, grace_s=60.0)
    # Dry-run never takes the lease, so it is never refused.
    gc_store(store, dry_run=True, grace_s=60.0)
    # Fake clock past expiry: the abandoned lease is stolen.
    monkeypatch.setattr(cas, "_wall", lambda: now + 60.0)
    rep = gc_store(store, dry_run=False, grace_s=60.0)
    assert not rep.errors


def test_torn_publish_named_and_swept(tmp_path):
    store = _mk_store(str(tmp_path / "store"))
    torn = os.path.join(store, BLOBS_DIR, "deadbeef-0123456789abcdef.tmp.42")
    with open(torn, "wb") as f:
        f.write(b"half a blob")
    rep = fsck_store(store)
    assert rep.state == "store"
    assert rep.torn_publishes == [
        f"{BLOBS_DIR}/deadbeef-0123456789abcdef.tmp.42"
    ]
    _backdate(torn, 120.0)
    g = gc_store(store, dry_run=False, grace_s=60.0)
    assert f"{BLOBS_DIR}/deadbeef-0123456789abcdef.tmp.42" in g.reclaimed


def test_refcount_cache_divergence_detected_and_rederived(tmp_path):
    store = _mk_store(str(tmp_path / "store"))
    data = b"counted content"
    key = _put_ref_snapshot(store, str(tmp_path / "snap"), "0/w", data)
    _put_blob(store, data)
    with open(os.path.join(store, cas.REFCOUNTS_PATH), "w") as f:
        json.dump({key: 7, "bogus-key": 1}, f)
    rep = fsck_store(store)
    assert key in rep.refcount_divergence
    assert "bogus-key" in rep.refcount_divergence
    # gc rewrites the advisory cache from fresh marks.
    gc_store(store, dry_run=False, grace_s=60.0)
    with open(os.path.join(store, cas.REFCOUNTS_PATH)) as f:
        assert json.load(f) == {key: 1}
    assert not fsck_store(store).refcount_divergence


def test_dangling_ref_is_the_exit4_state(tmp_path):
    # The library half; the CLI's exit codes (4 dangling, 3 not a
    # store) come with A9.
    store = _mk_store(str(tmp_path / "store"))
    snap = str(tmp_path / "snap")
    _put_ref_snapshot(store, snap, "0/w", b"vanished content")
    # The ref's blob was never published (or was lost): DANGLING.
    rep = fsck_store(store)
    assert rep.dangling and rep.dangling[0]["location"] == "0/w"
    assert fsck_store(str(tmp_path / "nope")).state == "not-a-store"


# --------------------------------------------------- two-job e2e dedup


def test_two_jobs_share_one_base_storage(tmp_path):
    store = str(tmp_path / "store")
    s = _state(7)
    with knobs.override_cas(store):
        Snapshot.take(str(tmp_path / "jobA"), s)
        Snapshot.take(str(tmp_path / "jobB"), s)
        out = _zeros()
        Snapshot(str(tmp_path / "jobB")).restore(out)
        _assert_eq(out, s)
        rep = fsck_store(store)
        assert rep.state == "store" and not rep.dangling
        # ~1x aggregate: one blob per unique tensor, each refcount 2.
        assert len(rep.blobs) == _N
        assert sorted(rep.referenced.values()) == [2] * _N
        for job in ("jobA", "jobB"):
            fa = fsck_snapshot(str(tmp_path / job))
            assert fa.state == "committed"
            assert fa.cas_refs == _N and not fa.cas_dangling
            # No private payload copies on disk.
            payload = [
                f
                for d, _, fs in os.walk(str(tmp_path / job))
                if CAS_REFS_DIR.split("/")[0] not in d
                for f in fs
                if f != ".snapshot_metadata"
            ]
            assert not payload, payload
        # gc converges to a no-op on the healthy store.
        g = gc_store(store, dry_run=False, grace_s=0.0)
        assert not g.reclaimed and g.marked == _N


def test_deleting_one_job_keeps_shared_blobs(tmp_path):
    import shutil

    store = str(tmp_path / "store")
    s = _state(3)
    with knobs.override_cas(store):
        Snapshot.take(str(tmp_path / "jobA"), s)
        Snapshot.take(str(tmp_path / "jobB"), s)
        shutil.rmtree(str(tmp_path / "jobA"))
        for name in os.listdir(os.path.join(store, ROOTS_DIR)):
            _backdate(os.path.join(store, ROOTS_DIR, name), 120.0)
        gc_store(store, dry_run=False, grace_s=60.0)
        # jobB's refs keep every blob alive.
        fb = fsck_snapshot(str(tmp_path / "jobB"))
        assert not fb.cas_dangling
        out = _zeros()
        Snapshot(str(tmp_path / "jobB")).restore(out)
        _assert_eq(out, s)
        # Now the last root goes too: blobs become orphans and sweep.
        shutil.rmtree(str(tmp_path / "jobB"))
        for name in os.listdir(os.path.join(store, ROOTS_DIR)):
            _backdate(os.path.join(store, ROOTS_DIR, name), 120.0)
        for name in os.listdir(os.path.join(store, BLOBS_DIR)):
            _backdate(os.path.join(store, BLOBS_DIR, name), 120.0)
        rep = gc_store(store, dry_run=False, grace_s=60.0)
        assert len([p for p in rep.reclaimed if p.startswith("blobs/")]) == _N


def test_snapshot_gc_prunes_stale_refs(tmp_path):
    store = str(tmp_path / "store")
    with knobs.override_cas(store):
        path = str(tmp_path / "snap")
        Snapshot.take(path, _state(1))
        # Retake under DIFFERENT tensor names: the old locations vanish
        # from the manifest but their refs linger in the rank record.
        rng = np.random.default_rng(2)
        Snapshot.take(
            path,
            {
                "m": StateDict(
                    v=torch.from_numpy(rng.standard_normal(_SHAPE).astype(np.float32))
                )
            },
        )
        refs, _ = read_refs_dir(path)
        assert len(refs) == _N + 1  # stale w0..w3 + live v
        gc_snapshot(path, dry_run=False)
        refs_after, _ = read_refs_dir(path)
        from tpusnap_torch.lifecycle import _referenced_locations

        md = fsck_snapshot(path).metadata
        assert set(refs_after) <= _referenced_locations(md)
        assert len(refs_after) == 1
        assert not fsck_snapshot(path).cas_dangling


# ------------------------------------------------------ chaos windows


_CHAOS_TAKE = r"""
import os, sys
import numpy as np
import torch
from tpusnap_torch import Snapshot, StateDict

path, seed = sys.argv[1], int(sys.argv[2])
state = {
    "m": StateDict(**{
        f"w{i}": torch.from_numpy(np.random.default_rng(seed * 100 + i)
        .standard_normal((96, 96)).astype(np.float32))
        for i in range(4)
    })
}
print("READY", flush=True)
Snapshot.take(path, state)
print("DONE", flush=True)
"""


def _run_chaos_child(
    path: str, seed: int, env_extra: dict, timeout: float = 120.0
):
    env = dict(
        os.environ,
        TPUSNAP_DISABLE_BATCHING="1",
        **env_extra,
    )
    proc = subprocess.run(
        [sys.executable, "-c", _CHAOS_TAKE, path, str(seed)],
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    return proc


@pytest.mark.chaos
@pytest.mark.parametrize(
    "fault,window",
    [
        ("crash_after_op=write_atomic:2", "mid-publish"),
        ("crash_after_op=cas_ref:1", "mid-ref-write"),
    ],
)
def test_sigkill_chaos_windows_converge(tmp_path, fault, window):
    """SIGKILL inside a CAS window: fsck names the resulting state, a
    second job still commits the same content, gc converges, and no
    committed snapshot ever holds a dangling ref."""
    store = str(tmp_path / "store")
    if window == "mid-publish":
        # Chaos on the STORE plugin: the child dies right after a store
        # write (intent or blob publish) — before its ref lands.
        env = {
            "TPUSNAP_CAS_DIR": f"chaos+fs://{store}",
            "TPUSNAP_FAULT_SPEC": fault,
        }
        snap_url = str(tmp_path / "jobA")
    else:
        # Chaos on the SNAPSHOT plugin: the child dies right after its
        # first ref-record flush (the cas_ref chaos kind).
        env = {"TPUSNAP_CAS_DIR": store}
        snap_url = f"chaos+fs://{tmp_path / 'jobA'}"
        env["TPUSNAP_FAULT_SPEC"] = fault
    proc = _run_chaos_child(snap_url, 5, env)
    assert proc.returncode == -signal.SIGKILL, (
        proc.returncode,
        proc.stdout,
        proc.stderr,
    )
    assert "DONE" not in proc.stdout

    # fsck names the state on both sides; nothing is "corrupt".
    srep = fsck_store(store)
    assert srep.state == "store"
    assert not srep.dangling  # a never-committed take cannot dangle
    frep = fsck_snapshot(str(tmp_path / "jobA"))
    assert frep.state in ("torn", "empty", "committed")

    # A concurrent/second job taking the SAME content converges: it
    # adopts published blobs (or republishes) and commits cleanly.
    proc2 = _run_chaos_child(
        str(tmp_path / "jobB"), 5, {"TPUSNAP_CAS_DIR": store}
    )
    assert proc2.returncode == 0, proc2.stderr
    fb = fsck_snapshot(str(tmp_path / "jobB"))
    assert fb.state == "committed" and not fb.cas_dangling

    # gc converges: heal the torn job dir, sweep store debris; the
    # committed job's refs all still resolve and it restores bit-exact.
    if frep.state == "torn":
        gc_snapshot(str(tmp_path / "jobA"), dry_run=False, reclaim_torn=True)
    for sub in (BLOBS_DIR, INTENTS_DIR, ROOTS_DIR):
        d = os.path.join(store, sub)
        for name in os.listdir(d) if os.path.isdir(d) else []:
            _backdate(os.path.join(d, name), 120.0)
    g = gc_store(store, dry_run=False, grace_s=60.0)
    assert not g.errors
    fb = fsck_snapshot(str(tmp_path / "jobB"))
    assert not fb.cas_dangling, fb.cas_dangling
    with knobs.override_cas(store):
        out = _zeros()
        Snapshot(str(tmp_path / "jobB")).restore(out)
        _assert_eq(out, _state(5))


@pytest.mark.chaos
def test_sigkill_mid_gc_sweep_converges(tmp_path, monkeypatch):
    """A gc SIGKILLed mid-sweep (chaos ``delete`` kill on the store
    plugin) leaves a state fsck names; a re-run gc converges and live
    refs are untouched."""
    store = _mk_store(str(tmp_path / "store"))
    data = b"live content" * 32
    key_live = _put_ref_snapshot(store, str(tmp_path / "snap"), "0/w", data)
    _put_blob(store, data)
    orphans = [_put_blob(store, b"orphan-%d" % i * 40) for i in range(6)]
    for name in os.listdir(os.path.join(store, BLOBS_DIR)):
        _backdate(os.path.join(store, BLOBS_DIR, name), 600.0)

    child = (
        "import sys\n"
        "from tpusnap_torch.cas import gc_store\n"
        "gc_store(sys.argv[1], dry_run=False, grace_s=60.0)\n"
    )
    env = dict(
        os.environ,
        TPUSNAP_FAULT_SPEC="crash_after_op=delete:2",
    )
    proc = subprocess.run(
        [sys.executable, "-c", child, f"chaos+fs://{store}"],
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == -signal.SIGKILL, (proc.returncode, proc.stderr)

    # Mid-sweep state: some orphans gone, some left; the lease may be
    # stranded. fsck still names everything and the live blob is safe.
    rep = fsck_store(store)
    assert rep.state == "store" and not rep.dangling
    assert key_live in rep.referenced
    # Re-run converges: past its TTL the dead sweeper's lease is STOLEN
    # (fake-forward the clock rather than sleeping out the 60 s default).
    monkeypatch.setattr(cas, "_wall", lambda: time.time() + 120.0)
    g = gc_store(store, dry_run=False, grace_s=60.0, lease_ttl_s=0.0)
    assert not g.errors
    rep = fsck_store(store)
    assert not rep.orphans and not rep.dangling
    assert os.path.exists(os.path.join(store, blob_path(key_live)))
    for k in orphans:
        assert not os.path.exists(os.path.join(store, blob_path(k)))


@pytest.mark.chaos
def test_sigkill_mid_store_drain_resumes(tmp_path):
    """A store drain SIGKILLed mid-upload re-runs to convergence, with
    the already-journaled blobs skipped via hash evidence."""
    store = _mk_store(str(tmp_path / "store"))
    keys = [
        _put_blob(store, b"drain-me-%d" % i * 512) for i in range(6)
    ]
    remote = str(tmp_path / "mirror")
    child = (
        "import sys\n"
        "from tpusnap_torch.cas import drain_store\n"
        "r = drain_store(sys.argv[1], remote_url=sys.argv[2])\n"
        "print(r.summary())\n"
    )
    env = dict(
        os.environ,
        TPUSNAP_FAULT_SPEC="crash_after_op=write_atomic:2",
    )
    proc = subprocess.run(
        [sys.executable, "-c", child, store, f"chaos+fs://{remote}"],
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == -signal.SIGKILL, (proc.returncode, proc.stderr)
    journal = cas.read_store_journal(store)
    assert journal is not None and 0 < len(journal["blobs"]) < len(keys)

    rep = cas.drain_store(store, remote_url=f"fs://{remote}")
    assert rep.state == "durable", rep.summary()
    assert rep.skipped >= 1  # journaled evidence licensed skips
    proven, _ = cas.store_remote_evidence(store, set(keys))
    assert proven == set(keys)
    for k in keys:
        assert os.path.exists(os.path.join(remote, blob_path(k)))


# ------------------------------------------------- 2-process hammer


def test_publisher_vs_gc_hammer_zero_lost_blobs(tmp_path):
    """One process publishing through the full CAS plugin protocol, a
    REAL second process gc-sweeping in a tight loop with a sub-second
    grace window: ≥100 publishes, zero lost blobs (every committed ref
    resolves, every location reads back bit-exact)."""
    store = str(tmp_path / "store")
    snap = str(tmp_path / "snap")
    beacon = str(tmp_path / "sweeps")
    stop = str(tmp_path / "stop")
    # The sweeper runs until told to stop (and then finishes its sweep
    # and releases its lease), not for a wall-clock span; its hard cap
    # only bounds a leaked process.
    gc_child = (
        "import os, sys, time\n"
        "from tpusnap_torch.cas import gc_store\n"
        "store, beacon, stop = sys.argv[1], sys.argv[2], sys.argv[3]\n"
        "end = time.monotonic() + 900\n"
        "sweeps = 0\n"
        "while time.monotonic() < end and not os.path.exists(stop):\n"
        "    try:\n"
        "        gc_store(store, dry_run=False, grace_s=0.5,\n"
        "                 lease_ttl_s=5.0, owner='hammer-gc')\n"
        "        sweeps += 1\n"
        "        with open(beacon, 'w') as f:\n"
        "            f.write(str(sweeps))\n"
        "    except RuntimeError:\n"
        "        pass\n"
        "    time.sleep(0.002)\n"
    )
    sweeper = subprocess.Popen(
        [sys.executable, "-c", gc_child, store, beacon, stop], env=dict(os.environ)
    )

    def _sweeps() -> int:
        try:
            with open(beacon) as f:
                return int(f.read() or 0)
        except (OSError, ValueError):
            return 0

    try:
        import asyncio

        from tpusnap_torch.io_types import ReadIO, WriteIO

        with knobs.override_cas(store):
            plugin = url_to_storage_plugin(snap)
        contents = {}
        iterations = 120
        # The race only exists once the sweeper is ALIVE: wait for its
        # first completed gc pass before publishing anything.
        while _sweeps() == 0:
            assert sweeper.poll() is None, "gc sweeper died before start"
            time.sleep(0.01)
        sweeps_at_start = _sweeps()

        async def hammer():
            for i in range(iterations):
                # A rotating content pool: repeats exercise the ADOPT
                # path against blobs the sweeper is racing to age out;
                # overwritten locations feed it a steady orphan diet.
                data = (b"hammer-%d|" % (i % 9)) * 257
                loc = f"0/blob_{i % 24}"
                await plugin.write(WriteIO(path=loc, buf=data))
                contents[loc] = data
                # Zero-lost-blobs invariant, checked at full race
                # pressure: the ref just flushed MUST resolve.
                read_io = ReadIO(path=loc)
                await plugin.read(read_io)
                assert read_io.buf.getvalue() == data, (
                    f"iteration {i}: lost blob under gc race ({loc})"
                )
                # Pace the publisher across the sweeper's cadence so a
                # fast machine cannot finish before gc ever interleaves.
                if i % 24 == 23:
                    target = sweeps_at_start + (i // 24) + 1
                    while _sweeps() < target:
                        assert sweeper.poll() is None, "gc sweeper died"
                        await asyncio.sleep(0.005)
            await plugin.close()

        asyncio.run(hammer())
        assert _sweeps() > sweeps_at_start, "gc never ran during the hammer"
    finally:
        with open(stop, "w"):
            pass
        try:
            assert sweeper.wait(timeout=300) == 0
        finally:
            if sweeper.poll() is None:
                sweeper.kill()

    # Post-hammer: the sweeper released its lease on the way out; the
    # final refs all resolve through a FRESH plugin (nothing cached),
    # and a final gc converges with zero dangling.
    gc_store(store, dry_run=False, grace_s=0.5, lease_ttl_s=0.0)
    refs, _ = read_refs_dir(snap)
    assert len(refs) == 24
    import asyncio

    from tpusnap_torch.io_types import ReadIO

    with knobs.override_cas(store):
        fresh = url_to_storage_plugin(snap)

    async def verify():
        for loc, data in contents.items():
            read_io = ReadIO(path=loc)
            await fresh.read(read_io)
            assert read_io.buf.getvalue() == data, f"lost blob at {loc}"
        await fresh.close()

    asyncio.run(verify())


# ------------------------------------------ evict-local interplay


def test_evict_local_refuses_without_store_remote_evidence(tmp_path):
    """A tiered snapshot whose payload is CAS refs must not evict on
    its OWN durable marker: the store's journal has to prove every
    ref'd blob remote first."""
    store = str(tmp_path / "store")
    cache = str(tmp_path / "cache")
    remote_root = str(tmp_path / "remote")
    url = f"tier+local={cache}+remote=fs://{remote_root}/snap"
    s = _state(11)
    with knobs.override_cas(store):
        Snapshot.take(url, s)
        from tpusnap_torch.tiering import drain_snapshot

        # The store has no remote mirror yet: the drain must refuse the
        # durable marker (shared blobs have no durable copy elsewhere).
        rep = drain_snapshot(url, deadline_s=30.0)
        assert rep.state != "durable", rep.summary()
        assert rep.cas_refs == _N
        with pytest.raises(RuntimeError):
            gc_snapshot(url, dry_run=False, evict_local=True)

        # Give the store a remote; drain store-level, then the snapshot
        # drain converges and eviction is licensed — but ref'd
        # locations are EXCLUDED from the delete set (deleting a ref
        # would drop the liveness root other jobs may rely on).
        store_remote = str(tmp_path / "store_mirror")
        with open(os.path.join(store, cas.CONFIG_PATH), "w") as f:
            json.dump({"remote": f"fs://{store_remote}"}, f)
        rep = drain_snapshot(url, deadline_s=60.0)
        assert rep.state == "durable", rep.summary()
        assert rep.cas_blobs_uploaded == _N
        local_dir = os.path.join(cache, os.path.abspath(remote_root)[1:], "snap")
        from tpusnap_torch.tiering import parse_tier_url

        local_dir = parse_tier_url(url).local_dir
        monkey_retention = dict(os.environ)
        os.environ["TPUSNAP_TIER_LOCAL_RETENTION_S"] = "0"
        try:
            g = gc_snapshot(url, dry_run=False, evict_local=True)
        finally:
            os.environ.clear()
            os.environ.update(monkey_retention)
        assert not g.errors
        refs, _ = read_refs_dir(local_dir)
        assert len(refs) == _N  # refs survived eviction
        out = _zeros()
        Snapshot(url).restore(out)
        _assert_eq(out, s)


def test_incremental_over_cas_base_restores_verifies_and_materializes(tmp_path):
    """An incremental take over a CAS-composed base references the
    base's locations, which the base holds as refs: reads resolve them
    through the base's ref records (tpusnap reads them as missing)."""
    from tpusnap_torch import verify_snapshot
    from tpusnap_torch.inspect import materialize_snapshot

    store = str(tmp_path / "store")
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    s = _state(12)
    with knobs.override_cas(store):
        Snapshot.take(a, s)
        s["m"]["w0"] = s["m"]["w0"] + 1.0
        Snapshot.take(b, s, incremental_from=a)
        assert verify_snapshot(b).clean
        out = _zeros()
        Snapshot(b).restore(out)
        _assert_eq(out, s)
        assert materialize_snapshot(b)["blobs_copied"] == _N - 1
        assert verify_snapshot(b).clean
        fr = fsck_snapshot(b)
        assert fr.state == "committed" and not fr.cas_dangling


# ------------------------------------------------------------ cross-package


def _algos(path):
    """(checksum algorithms, dedup-hash algorithms) a manifest records."""
    md = json.load(open(os.path.join(path, ".snapshot_metadata")))
    crc, dedup = set(), set()
    for e in md["manifest"].values():
        if isinstance(e, dict):
            if "checksum" in e:
                crc.add(e["checksum"].split(":")[0])
            if e.get("dedup_hash"):
                dedup.add(e["dedup_hash"].split(":")[0])
    return crc, dedup


def test_tpusnap_populated_store_dedups_the_ports_take(tmp_path):
    """A store tpusnap populated holds the port's take of the same bytes
    already: the port publishes no blob, both packages record the same
    checksum algorithm and key the store by the same CRC32C+XXH64 pair,
    and both restore the port's snapshot bit-exact (tolerance 0)."""
    import tpusnap
    from tpusnap import knobs as jax_knobs

    store = str(tmp_path / "store")
    s = _state(21)
    jax_state = {"m": tpusnap.StateDict(**{k: v.numpy() for k, v in s["m"].items()})}
    with jax_knobs.override_cas(store):
        tpusnap.Snapshot.take(str(tmp_path / "jax_job"), jax_state)
    before = sorted(os.listdir(os.path.join(store, BLOBS_DIR)))
    assert len(before) == _N
    published = cas.telemetry.counter_value("cas.blobs_published")
    hits = cas.telemetry.counter_value("cas.ref_hits")
    with knobs.override_cas(store):
        Snapshot.take(str(tmp_path / "port_job"), s)
        assert cas.telemetry.counter_value("cas.blobs_published") == published
        assert cas.telemetry.counter_value("cas.ref_hits") == hits + _N
        out = _zeros()
        Snapshot(str(tmp_path / "port_job")).restore(out)
        _assert_eq(out, s)
    assert sorted(os.listdir(os.path.join(store, BLOBS_DIR))) == before
    from tpusnap import _native as jax_native
    from tpusnap_torch import _native as port_native

    assert jax_native.checksum_algorithm() == port_native.checksum_algorithm() == "crc32c"
    assert jax_native.dedup_hash_algorithm() == port_native.dedup_hash_algorithm() == "xxh64"
    assert _algos(str(tmp_path / "jax_job"))[0] == _algos(str(tmp_path / "port_job"))[0] == {"crc32c"}
    refs, _ = read_refs_dir(str(tmp_path / "port_job"))
    jrefs, _ = read_refs_dir(str(tmp_path / "jax_job"))
    assert sorted(map(tuple, refs.values())) == sorted(map(tuple, jrefs.values()))
    assert {r[1].split(":")[0] for r in refs.values()} == {"crc32c"}
    assert {r[2].split(":")[0] for r in refs.values()} == {"xxh64"}
    with jax_knobs.override_cas(store):
        loaded = tpusnap.load_snapshot(str(tmp_path / "port_job"))["m"]
    for k, v in s["m"].items():
        assert np.asarray(loaded[k]).tobytes() == v.numpy().tobytes(), k
