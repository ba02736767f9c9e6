"""tpusnap_torch multi-rank takes on the CPU: async, elastic, incremental
and integrity cases.

Ports of tests/test_distributed.py (the async take's fault that never
commits, the happy path under in-place mutation, elastic upscale,
overlapping async takes, tile-grain incremental at world 2), of
tests/test_incremental.py (``test_multirank_replicated_incremental``,
``test_elastic_incremental_upscale``) and of tests/test_inspect.py
(``test_multiprocess_snapshot_scrubs_clean_and_detects``), plus the abort
of a sync take on one rank reaching its peer within seconds. Each world
is a ``torch.distributed`` gloo world of subprocesses
(``tpusnap_torch.test_utils.run_subprocess_world``).
"""

import os
import tempfile

import pytest
import torch

from tpusnap_torch import Snapshot, StateDict, verify_snapshot
from tpusnap_torch.test_utils import run_subprocess_world

torch.set_num_threads(1)


def _patch_fs_write(make_write):
    """Replace the filesystem plugin's ``write`` with ``make_write(orig)``;
    returns the undo."""
    import tpusnap_torch.storage_plugins.fs as fs

    orig = fs.FSStoragePlugin.write
    fs.FSStoragePlugin.write = make_write(orig)
    return lambda: setattr(fs.FSStoragePlugin, "write", orig)


def _blob_files(root):
    out = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.startswith(".snapshot"):
                out.append(os.path.relpath(os.path.join(dirpath, f), root))
    return sorted(out)


# --- world functions --------------------------------------------------------


def _world_async_take_fault(snap_dir):
    from tpusnap_torch.comm import get_communicator

    comm = get_communicator()

    def make_write(orig):
        async def write(self, write_io):
            if comm.rank == 1:
                raise OSError("rank1 disk failure")
            await orig(self, write_io)

        return write

    undo = _patch_fs_write(make_write)
    try:
        pending = Snapshot.async_take(snap_dir, {"s": StateDict(x=torch.ones(128))})
        with pytest.raises(Exception) as info:
            pending.wait()
        # On any rank's failure, .snapshot_metadata is never written; the
        # failing rank re-raises its own error, the peer the abort.
        assert not os.path.exists(os.path.join(snap_dir, ".snapshot_metadata"))
        if comm.rank == 1:
            assert "rank1 disk failure" in str(info.value)
        else:
            assert "aborted by rank 1" in str(info.value), info.value
    finally:
        undo()


def _world_sync_take_abort(snap_dir):
    """A sync take failing on rank 1 while staging: rank 0, waiting in the
    manifest gather, raises TakeAbortedError long before the barrier
    timeout, and the path holds no metadata and no blobs."""
    import time

    from tpusnap_torch.comm import get_communicator
    from tpusnap_torch.dist_store import TakeAbortedError
    from tpusnap_torch.io_preparers import array

    comm = get_communicator()
    orig = array.ArrayBufferStager._stage_blocking

    def failing(self):
        if comm.rank == 1:
            raise RuntimeError("rank1 staging failure")
        return orig(self)

    array.ArrayBufferStager._stage_blocking = failing
    state = StateDict(own=torch.full((4096,), float(comm.rank)), shared=torch.ones(4096))
    t0 = time.monotonic()
    try:
        with pytest.raises((TakeAbortedError, RuntimeError)) as info:
            Snapshot.take(snap_dir, {"m": state}, replicated=["m/shared"])
    finally:
        array.ArrayBufferStager._stage_blocking = orig
    if comm.rank == 0:
        assert isinstance(info.value, TakeAbortedError), info.value
        assert time.monotonic() - t0 < 30.0
    comm.barrier()
    assert not os.path.exists(os.path.join(snap_dir, ".snapshot_metadata"))
    assert _blob_files(snap_dir) == [], _blob_files(snap_dir)


def _world_async_take_happy(snap_dir):
    """async_take, then in-place mutation, then wait(): the snapshot holds
    the values at the call, in both staging modes, with writes slowed so
    the mutation lands while storage I/O is in flight."""
    import asyncio

    from tpusnap_torch.comm import get_communicator

    comm = get_communicator()

    def make_write(orig):
        async def write(self, write_io):
            await asyncio.sleep(0.5)
            await orig(self, write_io)

        return write

    undo = _patch_fs_write(make_write)
    try:
        for leg, cow in (("cow", True), ("clone", False)):
            os.environ["TPUSNAP_ASYNC_COW"] = "1" if cow else "0"
            path = f"{snap_dir}_{leg}"
            state = StateDict(w=torch.full((1024,), float(comm.rank)), step=0)
            pending = Snapshot.async_take(path, {"s": state})
            assert not pending.done()
            if cow:
                assert pending.wait_staged(timeout=60.0)
            state["w"] += 1000.0
            state["step"] = 99
            pending.wait()
            target = {"s": StateDict(w=torch.zeros(1024), step=-1)}
            Snapshot(path).restore(target)
            assert torch.equal(target["s"]["w"], torch.full((1024,), float(comm.rank)))
            assert target["s"]["step"] == 0
    finally:
        undo()
        os.environ.pop("TPUSNAP_ASYNC_COW", None)


def _world_elastic_restore(snap_dir, phase):
    from tpusnap_torch.comm import get_communicator

    comm = get_communicator()
    if phase == "save":  # world 2
        state = StateDict(
            shared=torch.arange(64, dtype=torch.float32),
            own=torch.full((4,), float(comm.rank)),
        )
        Snapshot.take(snap_dir, {"m": state}, replicated=["m/shared"])
    else:  # world 3: rank 2 is new
        dst = {"m": StateDict(shared=torch.zeros(64), own=torch.full((4,), -1.0))}
        Snapshot(snap_dir).restore(dst)
        assert torch.equal(dst["m"]["shared"], torch.arange(64, dtype=torch.float32))
        if comm.rank < 2:
            assert torch.equal(dst["m"]["own"], torch.full((4,), float(comm.rank)))
        else:
            # No per-rank entry exists for the new rank: the manifest is
            # the source of truth, so the key is absent.
            assert "own" not in dst["m"]


def _world_overlapping_async_takes(snap_dir):
    import numpy as np

    from tpusnap_torch.comm import get_communicator

    comm = get_communicator()
    rng = np.random.default_rng(comm.rank)

    def state(step):
        local = torch.from_numpy(rng.standard_normal((256, 32)).astype(np.float32)) + step
        return StateDict(local=local, step=step)

    # Three async takes in flight at once on one communicator: distinct
    # KV barriers; the epoch-bounded key GC must not release a newer
    # take's keys.
    states = [state(step) for step in range(3)]
    pendings = [
        Snapshot.async_take(f"{snap_dir}/s{step}", {"app": states[step]}) for step in range(3)
    ]
    snaps = [p.wait() for p in pendings]
    for snap in snaps:
        assert snap.metadata.world_size == comm.world_size
    if comm.rank == 0:
        for step in range(3):
            assert verify_snapshot(f"{snap_dir}/s{step}").clean, step
    target = {"app": StateDict(local=torch.zeros(256, 32), step=-1)}
    Snapshot(f"{snap_dir}/s2").restore(target)
    assert target["app"]["step"] == 2
    assert torch.equal(target["app"]["local"], states[2]["local"])


def _world_tile_grain_incremental(snap_dir):
    """World-2 incremental chain: per-rank dense state dedups at tile
    grain, replicated state stays blob-grain (the partition plan's unit
    ids must match what is prepared on every rank)."""
    from tpusnap_torch.comm import get_communicator
    from tpusnap_torch.knobs import override_record_dedup_hashes, override_tile_checksum_bytes

    comm = get_communicator()
    rank = comm.rank

    def state(step):
        local = torch.arange(1024 * 64, dtype=torch.float32).reshape(1024, 64) + rank * 1000
        if step:
            local[500, :] += step  # one row -> one tile
        repl = torch.full((2048,), 7.0)
        if step:
            repl = repl + step
        return StateDict(local=local, repl=repl, step=step)

    with override_tile_checksum_bytes(4 * 1024), override_record_dedup_hashes(True):
        Snapshot.take(f"{snap_dir}/s0", {"app": state(0)}, replicated=["app/repl"])
        comm.barrier()
        Snapshot.take(
            f"{snap_dir}/s1", {"app": state(1)}, replicated=["app/repl"],
            incremental_from=f"{snap_dir}/s0",
        )
    comm.barrier()
    if rank == 0:
        # Each rank's dense blob wrote about one 4 KiB tile, not 256 KiB;
        # repl rewrote whole.
        total = sum(os.path.getsize(os.path.join(f"{snap_dir}/s1", f))
                    for f in _blob_files(f"{snap_dir}/s1"))
        assert total < 64 * 1024, f"s1 wrote {total} bytes"
        assert verify_snapshot(f"{snap_dir}/s1").clean
    comm.barrier()
    target = {"app": StateDict(local=torch.zeros(1024, 64), repl=torch.zeros(2048), step=-1)}
    Snapshot(f"{snap_dir}/s1").restore(target)
    expect = state(1)
    assert torch.equal(target["app"]["local"], expect["local"])
    assert torch.equal(target["app"]["repl"], expect["repl"])
    assert target["app"]["step"] == 1


def _world_incremental_replicated(base, inc):
    def state():
        return StateDict(
            w1=torch.arange(512 * 64, dtype=torch.float32).reshape(512, 64),
            w2=torch.arange(512 * 64, dtype=torch.float32).reshape(512, 64) * 2,
        )

    # Both replicated; the partitioner gives them to different ranks, so
    # one writer is not rank 0.
    Snapshot.take(base, {"model": state()}, replicated=["**"])
    Snapshot.take(inc, {"model": state()}, replicated=["**"], incremental_from=base)
    st = state()
    st["w2"] = st["w2"] + 1.0
    Snapshot.take(inc + "_b", {"model": st}, replicated=["**"], incremental_from=inc)


def _world_elastic_incremental(base_dir, inc_dir, phase):
    from tpusnap_torch.comm import get_communicator

    comm = get_communicator()
    shared = torch.arange(4096, dtype=torch.float32)
    if phase == "save":  # world 2: the base
        state = StateDict(shared=shared, own=torch.full((64,), float(comm.rank)))
        Snapshot.take(base_dir, {"m": state}, replicated=["m/shared"])
        return
    # World 3: an incremental take on the world-2 base.
    state = StateDict(shared=shared, own=torch.full((64,), 10.0 + comm.rank))
    Snapshot.take(inc_dir, {"m": state}, replicated=["m/shared"], incremental_from=base_dir)
    md = Snapshot(inc_dir).metadata
    assert md.world_size == 3
    # The replicated blob deduped against the base across the world-size
    # change; the changed per-rank blobs were written.
    assert md.manifest["0/m/shared"].location.startswith("../")
    for r in range(3):
        assert not md.manifest[f"{r}/m/own"].location.startswith("../")
    if comm.rank == 0:
        assert verify_snapshot(inc_dir).clean
    dst = {"m": StateDict(shared=torch.zeros(4096), own=torch.zeros(64))}
    Snapshot(inc_dir).restore(dst)
    assert torch.equal(dst["m"]["shared"], shared)
    assert torch.equal(dst["m"]["own"], torch.full((64,), 10.0 + comm.rank))


def _world_take_for_scrub(snap_dir):
    from tpusnap_torch.comm import get_communicator

    comm = get_communicator()
    state = StateDict(
        local=torch.full((64, 8), float(comm.rank)),
        shared=torch.arange(128, dtype=torch.float32),
    )
    Snapshot.take(snap_dir, {"app": state}, replicated=["**/shared"])


# --- tests ------------------------------------------------------------------


def test_async_take_fault_never_commits():
    with tempfile.TemporaryDirectory() as d:
        run_subprocess_world(_world_async_take_fault, world_size=2, args=[f"{d}/snap"])


def test_sync_take_abort_reaches_peer():
    with tempfile.TemporaryDirectory() as d:
        run_subprocess_world(
            _world_sync_take_abort, world_size=2, args=[f"{d}/snap"],
            extra_env={"TPUSNAP_DISABLE_BATCHING": "1"},
        )


def test_async_take_happy_path_consistent_under_mutation():
    with tempfile.TemporaryDirectory() as d:
        run_subprocess_world(_world_async_take_happy, world_size=2, args=[f"{d}/snap"])


def test_elastic_upscale_restore():
    """Saved at world 2, restored at world 3."""
    with tempfile.TemporaryDirectory() as d:
        run_subprocess_world(_world_elastic_restore, world_size=2, args=[f"{d}/snap", "save"])
        run_subprocess_world(
            _world_elastic_restore, world_size=3, args=[f"{d}/snap", "restore"]
        )


def test_overlapping_async_takes():
    with tempfile.TemporaryDirectory() as d:
        run_subprocess_world(_world_overlapping_async_takes, world_size=2, args=[f"{d}/snap"])


def test_tile_grain_incremental_world2():
    with tempfile.TemporaryDirectory() as d:
        run_subprocess_world(_world_tile_grain_incremental, world_size=2, args=[f"{d}/snap"])


def test_multirank_replicated_incremental(tmp_path):
    """A replicated entry deduped by its writer (possibly not rank 0)
    survives consolidation: the committed manifest references the base
    blob, restores and scrubs clean."""
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    run_subprocess_world(
        _world_incremental_replicated, world_size=2, args=[base, inc],
        extra_env={"TPUSNAP_DISABLE_BATCHING": "1"},
    )
    assert _blob_files(inc) == [], _blob_files(inc)
    md = Snapshot(inc).metadata
    for p in ("0/model/w1", "0/model/w2"):
        assert md.manifest[p].location.startswith("../"), (p, md.manifest[p].location)
        assert md.manifest[p].checksum is not None
    target = {"model": StateDict(w1=torch.zeros(512, 64), w2=torch.zeros(512, 64))}
    Snapshot(inc).restore(target)
    assert torch.equal(
        target["model"]["w2"], torch.arange(512 * 64, dtype=torch.float32).reshape(512, 64) * 2
    )
    assert verify_snapshot(inc).clean
    # The second increment rewrote only the changed value.
    assert _blob_files(inc + "_b") == ["replicated/model/w2"]
    md_b = Snapshot(inc + "_b").metadata
    assert md_b.manifest["0/model/w1"].location.startswith("../")
    assert verify_snapshot(inc + "_b").clean


def test_elastic_incremental_upscale(tmp_path):
    """An incremental take at world 3 on a world-2 base: unchanged
    replicated state references the base, changed per-rank state is
    written."""
    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    env = {"TPUSNAP_DISABLE_BATCHING": "1"}
    run_subprocess_world(
        _world_elastic_incremental, world_size=2, args=[base, inc, "save"], extra_env=env
    )
    run_subprocess_world(
        _world_elastic_incremental, world_size=3, args=[base, inc, "load"], extra_env=env
    )


def test_multiprocess_snapshot_scrubs_clean_and_detects(tmp_path):
    """A world-2 snapshot scrubs clean from one process; a corrupted
    rank-1 blob is found and attributed to its '1/...' manifest path."""
    path = str(tmp_path / "snap")
    run_subprocess_world(_world_take_for_scrub, world_size=2, args=[path])
    assert verify_snapshot(path).clean
    md = Snapshot(path).metadata
    assert md.world_size == 2
    assert "1/app/local" in md.manifest
    for entry in md.manifest.values():
        if hasattr(entry, "location") and hasattr(entry, "checksum"):
            assert entry.checksum is not None, entry
    loc = md.manifest["1/app/local"].location
    start = md.manifest["1/app/local"].byte_range[0] if md.manifest["1/app/local"].byte_range else 0
    with open(os.path.join(path, loc), "r+b") as f:
        f.seek(start + 10)
        b = f.read(1)
        f.seek(start + 10)
        f.write(bytes([b[0] ^ 0xFF]))
    report = verify_snapshot(path)
    assert not report.clean
    assert any(f.manifest_path.startswith("1/") for f in report.failures), report.failures
