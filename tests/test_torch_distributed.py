"""tpusnap_torch across processes: the store-based communicator, the KV
store and ``LinearBarrier``, and multi-rank takes on the CPU.

Ports of the cases of tests/test_distributed.py, run in real
``torch.distributed`` worlds (gloo on the CPU) that
``tpusnap_torch.test_utils.run_subprocess_world`` starts: collectives at
world 2, 3 and 16 (16 over the TCPStore alone, with no process group),
``LinearBarrier`` and its error propagation, interleaved communicators,
replicated take and restore, the partitioner spreading writes, the
collective counts of a take at world 8, late checksums, and the
simulated multi-host budget divisor. tests/test_torch_distributed_take.py
holds the async, elastic, incremental and integrity cases, and
tests/test_torch_distributed_parity.py the cross-package ones.
"""

import os
import tempfile

import pytest

from tpusnap_torch.test_utils import run_subprocess_world

# --- world functions (run in each rank's process) --------------------------


def _world_collectives(store_only: str = "0"):
    from tpusnap_torch.comm import StoreComm, get_communicator

    if store_only == "1":
        from tpusnap_torch.test_utils import store_from_env

        comm = StoreComm(
            store_from_env(), int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        )
    else:
        comm = get_communicator()
        # Detection: an initialised group of more than one rank gives the
        # store communicator.
        assert isinstance(comm, StoreComm), type(comm)
    rank, world = comm.rank, comm.world_size
    assert world == int(os.environ["WORLD_SIZE"])

    gathered = comm.all_gather_object({"rank": rank, "payload": "x" * rank})
    assert [g["rank"] for g in gathered] == list(range(world))
    assert [g["payload"] for g in gathered] == ["x" * r for r in range(world)]

    value = comm.broadcast_object(f"from-{rank}" if rank == 0 else None, src=0)
    assert value == "from-0"
    comm.barrier()
    # A later barrier proved the gather and broadcast consumed: rank 0
    # deleted their keys.
    comm.barrier()
    ns = comm._namespace()
    assert not comm.store.check([f"{ns}/ag1/0"]), "gather keys were not collected"


def _world_linear_barrier():
    from tpusnap_torch.comm import get_communicator
    from tpusnap_torch.dist_store import LinearBarrier
    from tpusnap_torch.snapshot import _get_kv_store

    comm = get_communicator()
    barrier = LinearBarrier(
        _get_kv_store(comm), "test_lb", comm.rank, comm.world_size, timeout_sec=60
    )
    barrier.arrive()
    barrier.depart()


def _world_linear_barrier_error():
    from tpusnap_torch.comm import get_communicator
    from tpusnap_torch.dist_store import LinearBarrier, LinearBarrierError
    from tpusnap_torch.snapshot import _get_kv_store

    comm = get_communicator()
    barrier = LinearBarrier(
        _get_kv_store(comm), "test_lb_err", comm.rank, comm.world_size, timeout_sec=60
    )
    if comm.rank == 1:
        barrier.report_error(RuntimeError("rank1 exploded"))
    else:
        try:
            barrier.arrive()
            barrier.depart()
        except LinearBarrierError as e:
            assert "rank1 exploded" in str(e)
        else:
            raise AssertionError("leader did not observe the reported error")


def _world_interleaved_communicators():
    """Two communicators used in different relative orders on different
    ranks must not cross-wire values."""
    from tpusnap_torch.comm import StoreComm, get_communicator

    base = get_communicator()
    rank = base.rank
    comm_a = StoreComm(base.store, rank, base.world_size, namespace="test_a")
    comm_b = StoreComm(base.store, rank, base.world_size, namespace="test_b")
    if rank == 0:
        comm_a.broadcast_object("from-A", src=0)
        comm_b.broadcast_object("from-B", src=0)
    else:
        got_b = comm_b.broadcast_object(None, src=0)
        got_a = comm_a.broadcast_object(None, src=0)
        assert got_b == "from-B", got_b
        assert got_a == "from-A", got_a
    base.barrier()
    ga = comm_a.all_gather_object(("a", rank))
    gb = comm_b.all_gather_object(("b", rank * 10))
    assert ga == [("a", r) for r in range(base.world_size)], ga
    assert gb == [("b", r * 10) for r in range(base.world_size)], gb


def _world_replicated_take_restore(snap_dir):
    import torch

    from tpusnap_torch import Snapshot, StateDict

    state = StateDict(
        w=torch.arange(256, dtype=torch.float32).reshape(16, 16),
        b=torch.ones(16) * 3,
        step=42,
    )
    snap = Snapshot.take(snap_dir, {"model": state}, replicated=["**"])
    manifest = snap.get_manifest()
    # Replicated entries consolidated into rank 0's tree only.
    assert "0/model/w" in manifest
    assert "1/model/w" not in manifest
    assert manifest["0/model/w"].replicated
    dst = {"model": StateDict(w=torch.zeros(16, 16), b=torch.zeros(16), step=0)}
    Snapshot(snap_dir).restore(dst)
    assert dst["model"]["step"] == 42
    assert torch.equal(dst["model"]["w"], state["w"])
    assert torch.equal(dst["model"]["b"], state["b"])


def _world_partitioner_spreads_writes(snap_dir):
    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.comm import get_communicator
    from tpusnap_torch.knobs import override_batching_disabled

    comm = get_communicator()
    state = StateDict(**{f"p{i}": torch.full((64,), float(i)) for i in range(8)})
    written = []
    import tpusnap_torch.storage_plugins.fs as fs

    orig_write = fs.FSStoragePlugin.write

    async def recording_write(self, write_io):
        written.append(write_io.path)
        await orig_write(self, write_io)

    fs.FSStoragePlugin.write = recording_write
    try:
        with override_batching_disabled(True):
            Snapshot.take(snap_dir, {"m": state}, replicated=["**"])
    finally:
        fs.FSStoragePlugin.write = orig_write
    # Every rank wrote its share of the 8 equal blobs, and no blob twice.
    mine = sorted(p for p in written if p.startswith("replicated/"))
    everyone = comm.all_gather_object(mine)
    assert all(len(w) == 4 for w in everyone), everyone
    assert sorted(sum(everyone, [])) == sorted(f"replicated/m/p{i}" for i in range(8))
    if comm.rank == 0:
        files = os.listdir(os.path.join(snap_dir, "replicated", "m"))
        assert len(files) == 8, files


def _world_collective_count(snap_dir):
    """A take issues exactly 2 gathers and 2 barriers and no broadcast;
    a restore and read_object issue none (the take cached the budget
    divisor); per_key_barrier adds one key gather and a barrier per
    key."""
    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.comm import Communicator, get_communicator

    class CountingComm(Communicator):
        def __init__(self, inner):
            self.inner = inner
            self.counts = {"barrier": 0, "all_gather": 0, "broadcast": 0}

        @property
        def rank(self):
            return self.inner.rank

        @property
        def world_size(self):
            return self.inner.world_size

        def barrier(self):
            self.counts["barrier"] += 1
            self.inner.barrier()

        def all_gather_object(self, obj):
            self.counts["all_gather"] += 1
            return self.inner.all_gather_object(obj)

        def broadcast_object(self, obj, src=0):
            self.counts["broadcast"] += 1
            return self.inner.broadcast_object(obj, src)

        def set_wait_watcher(self, watcher):
            self.inner.set_wait_watcher(watcher)

        def clear_wait_watcher(self):
            self.inner.clear_wait_watcher()

    comm = CountingComm(get_communicator())
    state = StateDict(
        w=torch.arange(4096, dtype=torch.float32),
        b=torch.ones(64) * comm.rank,
        step=7,
    )
    Snapshot.take(snap_dir, {"m": state}, replicated=["m/w"], comm=comm)
    assert comm.counts == {"barrier": 2, "all_gather": 2, "broadcast": 0}, comm.counts

    restore_comm = CountingComm(get_communicator())
    dst = {"m": StateDict(w=torch.zeros(4096), b=torch.zeros(64), step=0)}
    Snapshot(snap_dir, comm=restore_comm).restore(dst)
    assert restore_comm.counts == {"barrier": 0, "all_gather": 0, "broadcast": 0}
    assert dst["m"]["step"] == 7
    assert torch.equal(dst["m"]["b"], torch.ones(64) * comm.rank)
    out = Snapshot(snap_dir, comm=restore_comm).read_object("0/m/w")
    assert torch.equal(out, torch.arange(4096, dtype=torch.float32))
    assert restore_comm.counts["all_gather"] == 0, restore_comm.counts

    safety_comm = CountingComm(get_communicator())
    Snapshot.take(
        f"{snap_dir}_pkb", {"m": state}, replicated=["m/w"], comm=safety_comm,
        per_key_barrier=True,
    )
    assert safety_comm.counts["all_gather"] == 3, safety_comm.counts
    assert safety_comm.counts["barrier"] == 3, safety_comm.counts


def _world_late_checksums(snap_dir):
    """Checksums hashed on the write path reach the committed metadata and
    every rank's cached copy through the KV store, and the take's KV keys
    are deleted after the final barrier."""
    import torch

    import tpusnap_torch.snapshot as snap_mod
    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch import _native
    from tpusnap_torch.comm import get_communicator
    from tpusnap_torch.snapshot import _get_kv_store

    take_ids = []
    orig_init = snap_mod._LateChecksums.__init__

    def recording_init(self, comm, take_id, stagers):
        take_ids.append(take_id)
        orig_init(self, comm, take_id, stagers)

    snap_mod._LateChecksums.__init__ = recording_init
    comm = get_communicator()
    rank = comm.rank
    state = StateDict(
        w=torch.arange(512 * 64, dtype=torch.float32).reshape(512, 64) + rank,
        small=torch.ones(32) * rank,
    )
    algo = _native.checksum_algorithm() + ":"

    def check(snap):
        assert snap._metadata is not None, rank
        for key in (f"{r}/app/{n}" for r in range(comm.world_size) for n in ("w", "small")):
            cs = snap._metadata.manifest[key].checksum
            assert cs is not None and cs.startswith(algo), (rank, key, cs)
        assert snap.verify().clean, rank
        manifest = Snapshot(snap.path).metadata.manifest
        for key in (f"{r}/app/w" for r in range(comm.world_size)):
            assert manifest[key].checksum is not None, key
        comm.barrier()
        store = _get_kv_store(comm)
        keys = [f"tpusnap_late_cs/{take_ids[-1]}/{r}" for r in range(comm.world_size)]
        leftovers = store.try_get_dir("tpusnap_late_cs/", keys=keys)
        assert leftovers == {}, leftovers

    check(Snapshot.take(snap_dir, {"app": state}))
    assert take_ids, "late-checksum deferral did not engage"
    check(Snapshot.async_take(snap_dir + "_a", {"app": state}).wait())


def _world_multihost_budget(snap_dir):
    """4 ranks on 2 simulated hosts: the memory-budget divisor sees 2
    ranks per host, and the partitioner spreads replicated entries over
    both hosts."""
    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch import scheduler as sched
    from tpusnap_torch.comm import get_communicator
    from tpusnap_torch.knobs import override_batching_disabled
    from tpusnap_torch.partitioner import assign_replicated_units, estimate_write_loads

    comm = get_communicator()

    def w(i):
        return torch.arange(256 * 64, dtype=torch.float32).reshape(256, 64) + i

    state = StateDict(**{f"w{i}": w(i) for i in range(8)})
    with override_batching_disabled(True):
        Snapshot.take(snap_dir, {"model": state}, replicated=["**"])
    assert sched._cached_local_world_size == 2, (comm.rank, sched._cached_local_world_size)
    if comm.rank == 0:
        files = os.listdir(os.path.join(snap_dir, "replicated", "model"))
        assert len(files) == 8, files
        flattened = {f"model/w{i}": state[f"w{i}"] for i in range(8)}
        units, base_load, _ = estimate_write_loads(flattened, sorted(flattened))
        assignment, _ = assign_replicated_units([units] * 4, [base_load] * 4)
        writers = set(assignment.values())
        assert writers & {0, 1} and writers & {2, 3}, assignment
    target = {"model": StateDict(**{f"w{i}": torch.zeros(256, 64) for i in range(8)})}
    Snapshot(snap_dir).restore(target)
    for i in range(8):
        assert torch.equal(target["model"][f"w{i}"], w(i))


# --- tests ------------------------------------------------------------------


@pytest.mark.parametrize("world_size", [2, 3])
def test_comm_collectives(world_size):
    run_subprocess_world(_world_collectives, world_size=world_size)


def test_comm_collectives_world16():
    """The O(1)-RPC design at world 16, over the TCPStore alone."""
    run_subprocess_world(
        _world_collectives, world_size=16, args=["1"], init_process_group=False,
        timeout=300,
    )


def test_linear_barrier():
    run_subprocess_world(_world_linear_barrier, world_size=2)


def test_linear_barrier_error_propagation():
    run_subprocess_world(_world_linear_barrier_error, world_size=2)


def test_interleaved_communicator_instances():
    run_subprocess_world(_world_interleaved_communicators, world_size=2)


def test_replicated_take_restore():
    with tempfile.TemporaryDirectory() as d:
        run_subprocess_world(_world_replicated_take_restore, world_size=2, args=[f"{d}/snap"])


def test_partitioner_spreads_writes():
    with tempfile.TemporaryDirectory() as d:
        run_subprocess_world(
            _world_partitioner_spreads_writes, world_size=2, args=[f"{d}/snap"]
        )


def test_collective_count_world8():
    with tempfile.TemporaryDirectory() as d:
        run_subprocess_world(_world_collective_count, world_size=8, args=[f"{d}/snap"])


def test_late_checksums_world2():
    # Unbatched, so both tensors are standalone blobs hashed on the write
    # path (slab members hash at stage time and need no transport).
    with tempfile.TemporaryDirectory() as d:
        run_subprocess_world(
            _world_late_checksums, world_size=2, args=[f"{d}/snap"],
            extra_env={"TPUSNAP_DISABLE_BATCHING": "1"},
        )


def test_multihost_simulated_budget_divisor():
    with tempfile.TemporaryDirectory() as d:
        run_subprocess_world(
            _world_multihost_budget, world_size=4, args=[f"{d}/snap"],
            hostnames=["hostA", "hostA", "hostB", "hostB"],
        )


# --- the KV stores in one process ---------------------------------------------


def _kv_store(kind, tmp_path):
    from tpusnap_torch.dist_store import FileKVStore, MemoryKVStore, TCPStoreKVStore

    if kind == "memory":
        return MemoryKVStore()
    if kind == "file":
        return FileKVStore(str(tmp_path / "kv"))
    import datetime

    import torch.distributed as dist

    server = dist.TCPStore("127.0.0.1", 0, 1, True, timeout=datetime.timedelta(seconds=30))
    return TCPStoreKVStore(server)


@pytest.mark.parametrize("kind", ["memory", "file", "tcpstore"])
def test_kv_store_semantics(kind, tmp_path):
    """Overwriting set (lease and membership records rewrite one key), a
    try_get that does not wait for a missing key, a dir read of the keys
    present, and a prefix delete (of the named keys, where the backend
    cannot list)."""
    import time

    store = _kv_store(kind, tmp_path)
    store.set("p/a", b"1")
    store.set("p/a", b"2")
    assert store.try_get("p/a") == b"2"
    t0 = time.monotonic()
    assert store.try_get("p/missing") is None
    assert time.monotonic() - t0 < 1.0
    store.set("p/b", b"3")
    store.set("q/c", b"4")
    keys = ["p/a", "p/b", "p/z"]
    assert store.try_get_dir("p/", keys=keys) == {"p/a": b"2", "p/b": b"3"}
    assert store.get("p/b", timeout_sec=1.0) == b"3"
    with pytest.raises(TimeoutError):
        store.get("p/z", timeout_sec=0.2)
    store.delete_prefix("p/", keys=keys)
    assert store.try_get_dir("p/", keys=keys) == {}
    assert store.try_get("q/c") == b"4"


def test_take_abort_monitor_and_linear_barrier_in_one_process():
    """A published abort record makes every check raise TakeAbortedError
    naming the rank and chaining its cause; clear() removes it; a world-1
    LinearBarrier arrives and departs at once."""
    from tpusnap_torch.dist_store import (
        LinearBarrier,
        MemoryKVStore,
        TakeAbortedError,
        TakeAbortMonitor,
    )

    store = MemoryKVStore()
    mine = TakeAbortMonitor(store, "t1", rank=0, world_size=2)
    peer = TakeAbortMonitor(store, "t1", rank=1, world_size=2)
    mine.check(force=True)  # nothing published
    assert not mine.commit_may_have_started()
    peer.publish(OSError("disk gone"))
    with pytest.raises(TakeAbortedError, match="aborted by rank 1") as info:
        mine.check(force=True)
    assert isinstance(info.value.__cause__, OSError)
    peer.mark_commit_started()
    assert mine.commit_may_have_started()
    mine.clear()
    mine.check(force=True)
    barrier = LinearBarrier(store, "lb", rank=0, world_size=1, timeout_sec=1.0)
    barrier.arrive()
    barrier.depart()
