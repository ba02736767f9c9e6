"""The port's rank-failure tolerance against tpusnap's: the mirror of
``tests/test_liveness.py`` for ``tpusnap_torch`` (lease liveness,
fast-fail waits, the degraded commit, the rank-scoped chaos faults).

Unit layer (fake clocks, MemoryKVStore — zero sleeps): lease expiry
semantics, terminal-state immunity, watcher exclusion, the knob
routing of the historical barrier-timeout literals, the deterministic
adoption re-plan, degrade eligibility, and the chaos-spec extensions
(``rank=``, ``wedge=``).

Multi-process layer (two-rank gloo worlds of
``tpusnap_torch.test_utils.run_subprocess_world``): SIGKILL one rank of 2
mid-stage, mid-write and inside the commit barrier and the survivor
raises :class:`RankFailedError` naming the dead rank within 3x a generous
lease TTL; a degrade-mode replicated-only take that commits with one rank
dead and restores bit-exact (tpusnap's fsck reads its
``extras["degraded"]``); the same for an async take whose survivor
updates its CPU tensors in place after the call, which must still commit
the state at the call (the units it adopts were frozen with its own); and
a Shard(0) DTensor take whose peer dies, which aborts to a torn,
salvageable directory naming the reason.
"""

import os
import re
import signal
import time

import numpy as np
import pytest
import torch

from tpusnap_torch.dist_store import LinearBarrier, MemoryKVStore
from tpusnap_torch.knobs import (
    get_barrier_timeout_s,
    get_commit_barrier_timeout_s,
    get_liveness_ttl_s,
    get_rank_failure_policy,
    override_barrier_timeout_s,
    override_liveness,
)
from tpusnap_torch.liveness import (
    LeasePublisher,
    LivenessMonitor,
    RankFailedError,
    lease_key,
)

# ------------------------------------------------------------ unit layer


class FakeClock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _world(kv, take_id, world_size, ttl, clock):
    pubs = [LeasePublisher(kv, take_id, r) for r in range(world_size)]
    for p in pubs:
        p.publish()
    mon = LivenessMonitor(
        kv, take_id, 0, world_size, ttl_s=ttl, clock=clock
    )
    return pubs, mon


def test_monitor_alive_while_leases_advance():
    kv, clock = MemoryKVStore(), FakeClock()
    pubs, mon = _world(kv, "t1", 3, ttl=10.0, clock=clock)
    for _ in range(5):
        clock.advance(5.0)
        for p in pubs:
            p.publish()
        mon.check()  # advancing leases: never raises
    assert mon.expired() == []


def test_monitor_expires_silent_rank_and_names_it():
    kv, clock = MemoryKVStore(), FakeClock()
    pubs, mon = _world(kv, "t2", 3, ttl=10.0, clock=clock)
    mon.check()  # anchor: first observation of every lease
    # Rank 2 stops publishing; 1 keeps beating. 8s in: still fine.
    clock.advance(4.0)
    pubs[1].publish()
    mon.check()
    clock.advance(4.0)
    pubs[1].publish()
    mon.check()
    # 12s since rank 2's lease advanced: past the 10s TTL.
    clock.advance(4.0)
    pubs[1].publish()
    with pytest.raises(RankFailedError) as ei:
        mon.check()
    assert ei.value.ranks == [2]
    assert "2" in str(ei.value)
    assert mon.dead_ranks() == [2]


def test_monitor_never_expires_self_or_terminal():
    kv, clock = MemoryKVStore(), FakeClock()
    pubs, mon = _world(kv, "t3", 2, ttl=5.0, clock=clock)
    # Rank 1 exits the take deliberately: terminal lease, not a death.
    pubs[1].finish("committed")
    clock.advance(60.0)
    mon.check()  # no raise: rank 0 is self, rank 1 is terminal
    assert mon.expired() == []


def test_monitor_grace_for_never_published_rank():
    kv, clock = MemoryKVStore(), FakeClock()
    # Rank 1 never publishes at all (killed pre-first-beat).
    mon = LivenessMonitor(kv, "t4", 0, 2, ttl_s=5.0, clock=clock)
    clock.advance(7.0)
    assert mon.expired() == []  # within the 2x-TTL grace
    clock.advance(5.0)
    assert mon.expired() == [1]


def test_monitor_exclude_acknowledged_dead():
    kv, clock = MemoryKVStore(), FakeClock()
    pubs, mon = _world(kv, "t5", 3, ttl=5.0, clock=clock)
    mon.check()  # anchor the first observation
    clock.advance(20.0)
    pubs[0].publish()
    assert sorted(mon.expired()) == [1, 2]
    # The degraded commit's barriers exclude the acknowledged dead set.
    mon.check(exclude={1, 2})  # no raise
    with pytest.raises(RankFailedError):
        mon.check(exclude={1})


def test_lease_tick_hook_and_terminal_mapping():
    kv = MemoryKVStore()
    pub = LeasePublisher(kv, "t6", 0)
    hook = pub.make_tick_hook()
    hook(None)
    hook({"state": "running"})
    import json

    rec = json.loads(kv.try_get(lease_key("t6", 0)))
    assert rec["state"] == "live" and rec["seq"] == 2
    hook({"state": "committed"})
    rec = json.loads(kv.try_get(lease_key("t6", 0)))
    assert rec["state"] == "done"
    pub.cleanup()
    assert kv.try_get(lease_key("t6", 0)) is None


# ----------------------------------------------- knob routing (satellite)


def test_barrier_timeout_knob_routes_everywhere():
    assert get_barrier_timeout_s() == 600.0
    assert get_commit_barrier_timeout_s() == 1800.0
    with override_barrier_timeout_s(42):
        assert get_barrier_timeout_s() == 42.0
        assert get_commit_barrier_timeout_s() == 126.0
        b = LinearBarrier(MemoryKVStore(), "kt", 0, 2)
        assert b.timeout_sec == 42.0
        from tpusnap_torch.comm import _default_timeout_ms

        assert _default_timeout_ms() == 42_000
        from tpusnap_torch.dist_store import KVStore

        store = MemoryKVStore()
        store.set("x", b"1")
        assert store.get("x") == b"1"  # default timeout resolves


def test_liveness_knobs():
    assert get_liveness_ttl_s() == 15.0
    with override_liveness(ttl_s=0):
        assert get_liveness_ttl_s() == 0.0  # disabled
    with override_liveness(ttl_s=0.01):
        # Floor: 4x the heartbeat interval.
        assert get_liveness_ttl_s() == pytest.approx(2.0)
    assert get_rank_failure_policy() == "abort"
    with override_liveness(policy="degrade"):
        assert get_rank_failure_policy() == "degrade"
    with override_liveness(policy="bogus"):
        assert get_rank_failure_policy() == "abort"  # warn-once fallback


# ------------------------------------------------- subset LinearBarrier


def test_linear_barrier_subset_ranks():
    import threading

    store = MemoryKVStore()
    done = []

    def member(rank):
        b = LinearBarrier(store, "sub", rank, 4, ranks=[0, 2], timeout_sec=10)
        assert b.leader_rank == 0
        b.arrive()
        b.depart()
        done.append(rank)

    t = threading.Thread(target=member, args=(2,))
    t.start()
    member(0)
    t.join(timeout=10)
    assert sorted(done) == [0, 2]


def test_linear_barrier_rejects_non_member():
    with pytest.raises(ValueError):
        LinearBarrier(MemoryKVStore(), "nm", 1, 4, ranks=[0, 2])


def test_linear_barrier_watcher_raises_rank_failure():
    kv, clock = MemoryKVStore(), FakeClock()
    pubs, mon = _world(kv, "t7", 2, ttl=5.0, clock=clock)
    mon.check()  # anchor the first observation
    b = LinearBarrier(
        MemoryKVStore(),
        "wf",
        0,
        2,
        timeout_sec=30,
        watchers=[mon.check],
    )
    clock.advance(20.0)
    with pytest.raises(RankFailedError):
        b.arrive()  # leader waits for rank 1's arrive; watcher fires


# -------------------------------------------------- adoption re-planning


def test_reassign_dead_units_deterministic_round_robin():
    from tpusnap_torch.partitioner import reassign_dead_units

    assignment = {"a": 1, "b": 1, "c": 0, "d::0": 1, "d::1": 2}
    plan = reassign_dead_units(assignment, dead_ranks=[1], live_ranks=[0, 2])
    assert set(plan) == {"a", "b", "d::0"}
    # Round-robin over sorted live ranks, in sorted unit order.
    assert plan == {"a": 0, "b": 2, "d::0": 0}
    # Identical on every caller (pure function of its inputs).
    assert plan == reassign_dead_units(assignment, [1], [2, 0])


def test_degrade_eligibility_rule():
    from tpusnap_torch.manifest import (
        DictEntry,
        ObjectEntry,
        PrimitiveEntry,
        ShardedEntry,
        TensorEntry,
    )
    from tpusnap_torch.snapshot import _degrade_eligible

    repl = TensorEntry(
        location="app/w", serializer="raw", dtype="float32",
        shape=[2], replicated=True,
    )
    assert _degrade_eligible([{"app/w": repl, "app": DictEntry(keys=["w"])}]) is None
    sharded = ShardedEntry(shards=[], dtype="float32", shape=[2, 2])
    reason = _degrade_eligible([{"app/w": repl, "app/s": sharded}])
    assert reason is not None and "unique" in reason
    prim = PrimitiveEntry(
        dtype="int", layout="", serialized_value="3", replicated=False
    )
    reason = _degrade_eligible([{"app/step": prim}])
    assert reason is not None and "primitive" in reason
    obj = ObjectEntry(
        location="app/o", serializer="pickle", obj_type="T", replicated=False
    )
    assert _degrade_eligible([{"app/o": obj}]) is not None


# ------------------------------------------------ chaos spec extensions


def test_fault_spec_rank_and_wedge_parse():
    from tpusnap_torch.faults import FaultPlan

    plan = FaultPlan.from_spec("rank=1,crash_after_op=write:2,wedge=read:3")
    assert plan.rank == 1
    assert plan.crash_after_op == ("write", 2)
    assert plan.wedge == ("read", 3)
    assert FaultPlan.from_spec("wedge=write:*").wedge == ("write", 0)
    assert FaultPlan.from_spec("wedge=write").wedge == ("write", 0)


def test_rank_filter_neutralizes_plan_on_other_ranks(monkeypatch):
    import tpusnap_torch.faults as faults_mod
    from tpusnap_torch.faults import FaultInjectionStoragePlugin, FaultPlan

    monkeypatch.setattr(faults_mod, "_process_rank", lambda: 0)
    inner = object.__new__(FaultInjectionStoragePlugin)  # placeholder inner

    plugin = FaultInjectionStoragePlugin.__new__(FaultInjectionStoragePlugin)
    FaultInjectionStoragePlugin.__init__(
        plugin, inner, FaultPlan(rank=1, transient_per_op=3, torn_writes=True)
    )
    # Mismatched rank: the plan is inert (no transients, no tears).
    assert plugin.plan.transient_per_op == 0
    assert plugin.plan.torn_writes is False
    # Matching rank keeps the faults.
    monkeypatch.setattr(faults_mod, "_process_rank", lambda: 1)
    plugin2 = FaultInjectionStoragePlugin.__new__(FaultInjectionStoragePlugin)
    FaultInjectionStoragePlugin.__init__(
        plugin2, inner, FaultPlan(rank=1, transient_per_op=3)
    )
    assert plugin2.plan.transient_per_op == 3


def test_wedge_sigstops_on_the_planned_attempt(monkeypatch):
    from tpusnap_torch.faults import FaultInjectionStoragePlugin, FaultPlan

    sent = []
    monkeypatch.setattr(
        os, "kill", lambda pid, sig: sent.append((pid, sig))
    )
    plugin = FaultInjectionStoragePlugin.__new__(FaultInjectionStoragePlugin)
    FaultInjectionStoragePlugin.__init__(
        plugin, object(), FaultPlan(wedge=("write", 2))
    )
    plugin._check_wedge("write")
    assert sent == []
    plugin._check_wedge("read")  # other kinds don't advance the counter
    assert sent == []
    plugin._check_wedge("write")
    assert sent == [(os.getpid(), signal.SIGSTOP)]


# ------------------------------------------- post-mortem verdict folding


def test_postmortem_verdict_folds_dead_ranks():
    from tpusnap_torch.flight import postmortem_verdict

    logs = {
        0: {
            "meta": {"world_size": 3, "take_id": "x"},
            "events": [
                {"k": "rank_dead", "t": 1.0, "rank": 2},
                {"k": "abort", "t": 1.1},
            ],
        },
        1: {"meta": {"world_size": 3}, "events": []},
    }
    v = postmortem_verdict("/p", "torn", logs)
    assert v["dead_ranks"] == [2]
    assert v["ranks"][0]["dead_ranks_seen"] == [2]
    assert v["missing_ranks"] == [2]


def test_stall_episode_carries_dead_ranks():
    from tpusnap_torch import telemetry
    from tpusnap_torch.progress import ProgressMonitor

    rec = telemetry.TakeTelemetry(rank=0, enabled=True)
    tok = rec.op_enter("storage.write")
    clock = FakeClock()
    mon = ProgressMonitor(
        rec, 0, 2, "take", thread=False, clock=clock,
        stall_deadline_s=5.0, interval_s=0.5,
    )
    mon.set_liveness_probe(lambda: [1])
    mon.tick(now=clock.t)
    clock.advance(10.0)
    mon.tick(now=clock.t)
    rec.op_exit(tok)
    # The heartbeat record surfaces the dead peer too.
    payload = mon._record(clock.t, rec.live_snapshot())
    assert payload["dead_ranks"] == [1]
    rec.finalize()  # stop the recorder's RSS-sampler thread


def test_watch_table_flags_dead_peers():
    """tpusnap's `watch` table renders a port heartbeat record whose
    liveness probe names a dead peer."""
    from tpusnap.progress import render_watch_table

    from tpusnap_torch import telemetry
    from tpusnap_torch.progress import ProgressMonitor

    rec = telemetry.TakeTelemetry(rank=0, enabled=True)
    mon = ProgressMonitor(rec, 0, 2, "take", thread=False, clock=FakeClock(),
                          wall_clock=lambda: 100.0)
    mon.set_liveness_probe(lambda: [1])
    record = mon._record(1000.0, rec.live_snapshot())
    rec.finalize()
    out = render_watch_table([record], committed=False, stall_flag_s=15.0, now=100.0)
    assert "PEER DEAD [1]" in out


# ------------------------------------------------- multi-process layer


_TTL = 4.0
_LIVENESS_ENV = {
    "TPUSNAP_LIVENESS_TTL_S": str(_TTL),
    "TPUSNAP_HEARTBEAT_INTERVAL_S": "0.1",
    "TPUSNAP_DISABLE_BATCHING": "1",
    "TPUSNAP_COMPRESS": "off",
}


def _arrays(n=6, seed=7, numel=1 << 15):
    rng = np.random.default_rng(seed)
    return {f"w{i}": torch.from_numpy(rng.standard_normal(numel).astype(np.float32))
            for i in range(n)}


def _mark_and_die(marker):
    with open(marker, "w") as f:
        f.write(repr(time.time()))
        f.flush()
        os.fsync(f.fileno())
    os.kill(os.getpid(), signal.SIGKILL)


def _world_kill_one_rank(snap_dir, window):
    """Rank 1 SIGKILLs itself inside ``window`` (a hook in its own
    process: the first stage, the first blob write, the commit barrier);
    rank 0 raises RankFailedError naming it within 3x the lease TTL."""
    from tpusnap_torch import RankFailedError, Snapshot, StateDict
    from tpusnap_torch.comm import StoreComm, get_communicator

    comm = get_communicator()
    marker = os.path.join(snap_dir, f"killed_at.{window}")
    if comm.rank == 1:
        if window == "stage":
            from tpusnap_torch.io_preparers import array as arr_mod

            def hooked(self):
                _mark_and_die(marker)

            arr_mod.ArrayBufferStager._stage_blocking = hooked
        elif window == "write":
            import tpusnap_torch.storage_plugins.fs as fs_mod

            orig_write = fs_mod.FSStoragePlugin.write

            async def hooked_write(self, write_io):
                await orig_write(self, write_io)
                if not write_io.path.startswith(".tpusnap"):
                    _mark_and_die(marker)

            fs_mod.FSStoragePlugin.write = hooked_write
        elif window == "commit_barrier":
            import tpusnap_torch.snapshot as snap_mod

            orig_commit, orig_barrier = snap_mod._commit, StoreComm.barrier
            in_commit = []

            def commit(*a, **k):
                in_commit.append(True)
                return orig_commit(*a, **k)

            def barrier(self):
                if in_commit:
                    _mark_and_die(marker)
                return orig_barrier(self)

            snap_mod._commit, StoreComm.barrier = commit, barrier
        else:
            raise AssertionError(window)
    os.makedirs(snap_dir, exist_ok=True)
    t0 = time.time()
    try:
        Snapshot.take(snap_dir, {"m": StateDict(**_arrays(n=4))}, replicated=["**"])
    except RankFailedError as e:
        assert e.ranks == [1], e.ranks
        detect = time.time()
        try:
            with open(marker) as f:
                killed_at = float(f.read())
        except OSError:
            killed_at = t0
        dt = detect - killed_at
        print(f"RANKFAILED window={window} dt={dt:.2f}", flush=True)
        os._exit(0)  # the process group's exit barrier would wait on the dead peer
    raise AssertionError("rank 0 did not observe the rank failure")


@pytest.mark.parametrize("window", ["stage", "write", "commit_barrier"])
def test_rank_death_fails_fast_and_names_the_rank(tmp_path, window):
    """A SIGKILLed peer is detected within 3x the lease TTL, not at the
    barrier timeout (600 s here), and the directory is torn."""
    from tpusnap_torch.flight import load_flight_logs, postmortem_verdict
    from tpusnap_torch.lifecycle import fsck_snapshot
    from tpusnap_torch.test_utils import run_subprocess_world

    snap = str(tmp_path / f"snap_{window}")
    with pytest.raises(RuntimeError) as ei:
        run_subprocess_world(
            _world_kill_one_rank, world_size=2, args=[snap, window],
            extra_env=_LIVENESS_ENV, timeout=120,
        )
    logs = str(ei.value)
    assert "ranks [1] failed" in logs, logs[-3000:]
    m = re.search(rf"RANKFAILED window={window} dt=([0-9.]+)", logs)
    assert m, f"rank 0 never printed detection proof:\n{logs[-3000:]}"
    assert float(m.group(1)) <= 3.0 * _TTL
    os.unlink(os.path.join(snap, f"killed_at.{window}"))
    report = fsck_snapshot(snap)
    assert report.state == "torn", report.summary()
    # The survivor's writes landed with their evidence: a retake salvages.
    assert report.salvage_records > 0, report.summary()
    verdict = postmortem_verdict(snap, report.state, load_flight_logs(snap, files=report.files))
    assert 1 in verdict["dead_ranks"], verdict


def _world_degraded_replicated_take(snap_dir):
    """Degrade: rank 1 dies after its second blob write of a fully
    replicated take (a fault plan's rank filter); rank 0 adopts its units
    and commits."""
    from tpusnap_torch import Snapshot, StateDict, telemetry, verify_snapshot
    from tpusnap_torch.comm import get_communicator

    comm = get_communicator()
    arrays = _arrays(n=6, seed=11)
    state = {"m": StateDict(step=42, **arrays)}
    snap = Snapshot.take("chaos+fs://" + snap_dir, state, replicated=["**"],
                         storage_options={"fault_plan": "rank=1,crash_after_op=write:2"})
    assert comm.rank == 0  # rank 1 never gets here
    deg = (snap.metadata.extras or {}).get("degraded")
    assert deg and deg["dead_ranks"] == [1] and deg["live_ranks"] == [0], deg
    assert set(deg) == {"dead_ranks", "live_ranks", "adopted_units", "adopters"}
    assert telemetry.counter_value("degraded.adopted_bytes") > 0
    target = {"m": StateDict(step=0, **{k: torch.zeros_like(v) for k, v in arrays.items()})}
    Snapshot(snap_dir).restore(target)
    assert target["m"]["step"] == 42
    for k, v in arrays.items():
        assert torch.equal(target["m"][k], v), k
    assert verify_snapshot(snap_dir).clean
    print("DEGRADED-OK", flush=True)
    os._exit(0)


def test_degraded_commit_completes_replicated_take(tmp_path):
    import tpusnap.lifecycle as jax_lifecycle

    from tpusnap_torch.lifecycle import fsck_snapshot
    from tpusnap_torch.test_utils import run_subprocess_world

    snap = str(tmp_path / "snap_degraded")
    env = dict(_LIVENESS_ENV, TPUSNAP_RANK_FAILURE="degrade")
    with pytest.raises(RuntimeError) as ei:
        run_subprocess_world(_world_degraded_replicated_take, world_size=2, args=[snap],
                             extra_env=env, timeout=120)
    logs = str(ei.value)
    assert "DEGRADED-OK" in logs, logs[-3000:]
    assert "ranks [1] failed" in logs
    # Both packages read the degraded commit the same way.
    for report in (fsck_snapshot(snap), jax_lifecycle.fsck_snapshot(snap)):
        assert report.state == "committed", report.summary()
        assert "DEGRADED commit: rank(s) [1]" in report.summary()


def _world_degraded_async_take(snap_dir):
    """Degrade under an async take: rank 1 stops on its first blob write
    (a wedge: SIGSTOP), rank 0 updates every tensor in place after the
    call (once ``wait_staged()`` allows it), then SIGKILLs rank 1. The
    degraded snapshot must hold the state at the call: the units rank 0
    adopts were frozen with its own."""
    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.comm import get_communicator

    comm = get_communicator()
    pids = comm.all_gather_object(os.getpid())
    arrays = _arrays(n=6, seed=13)
    witness = {k: v.clone() for k, v in arrays.items()}
    pending = Snapshot.async_take(
        "chaos+fs://" + snap_dir, {"m": StateDict(**arrays)}, replicated=["**"],
        storage_options={"fault_plan": "rank=1,wedge=write:1"},
    )
    if comm.rank == 1:
        pending.wait()  # stopped inside its drain, then killed
        raise AssertionError("rank 1 committed")
    pending.wait_staged()
    for v in arrays.values():
        v.add_(1.0)  # the caller's next step, in place
    os.kill(pids[1], signal.SIGKILL)
    snap = pending.wait()
    deg = snap.metadata.extras["degraded"]
    assert deg["dead_ranks"] == [1] and deg["adopted_units"], deg
    target = {"m": StateDict(**{k: torch.zeros_like(v) for k, v in arrays.items()})}
    Snapshot(snap_dir).restore(target)
    for k, v in witness.items():
        assert torch.equal(target["m"][k], v), k
        assert not torch.equal(arrays[k], v), k
    print("DEGRADED-ASYNC-OK", flush=True)
    os._exit(0)


def test_degraded_async_take_holds_the_state_at_the_call(tmp_path):
    from tpusnap_torch.test_utils import run_subprocess_world

    snap = str(tmp_path / "snap_degraded_async")
    env = dict(_LIVENESS_ENV, TPUSNAP_RANK_FAILURE="degrade")
    with pytest.raises(RuntimeError) as ei:
        run_subprocess_world(_world_degraded_async_take, world_size=2, args=[snap],
                             extra_env=env, timeout=120)
    logs = str(ei.value)
    assert "DEGRADED-ASYNC-OK" in logs, logs[-3000:]


def test_async_degrade_freezes_the_units_it_may_adopt():
    """An async take under degrade stages the replicated units assigned
    to other ranks at the call (CPU tensors: clones, not COW views), so
    an in-place update afterwards cannot reach them."""
    import asyncio

    from tpusnap_torch.io_preparers.array import ArrayBufferStager
    from tpusnap_torch.io_types import WriteReq
    from tpusnap_torch.manifest import TensorEntry
    from tpusnap_torch.snapshot import _freeze_for_adoption, _PrestagedStager

    t = torch.arange(1024, dtype=torch.float32)
    entry = TensorEntry(location="replicated/m/w", serializer="raw", dtype="float32",
                        shape=[1024], replicated=True)
    wr = WriteReq(path="replicated/m/w",
                  buffer_stager=ArrayBufferStager(t, entry, is_async_snapshot=True))
    loop = asyncio.new_event_loop()
    try:
        _freeze_for_adoption({"m/w": [wr]}, loop)
        assert isinstance(wr.buffer_stager, _PrestagedStager) and wr.buffer_stager.frozen
        t.add_(1.0)
        buf = loop.run_until_complete(wr.buffer_stager.stage_buffer())
    finally:
        loop.close()
    got = torch.frombuffer(bytearray(memoryview(buf).cast("B")), dtype=torch.float32)
    assert torch.equal(got, torch.arange(1024, dtype=torch.float32))
    assert entry.checksum is not None


def _world_sharded_death_aborts_torn(snap_dir):
    """Degrade with a Shard(0) DTensor: the dead rank held unique boxes,
    so the survivor refuses to degrade and aborts to a torn directory."""
    from torch.distributed.tensor import Shard

    from tpusnap_torch import RankFailedError, Snapshot, StateDict
    from tpusnap_torch.test_utils import as_dtensor, world_mesh

    mesh = world_mesh("cpu")
    full = torch.arange(64 * 16, dtype=torch.float32).reshape(64, 16)
    state = {"m": StateDict(s=as_dtensor(full, mesh, [Shard(0)]), **_arrays(n=4, seed=3))}
    try:
        Snapshot.take("chaos+fs://" + snap_dir, state, replicated=["m/w*"],
                      storage_options={"fault_plan": "rank=1,crash_after_op=write:2"})
    except RankFailedError as e:
        assert e.ranks == [1]
        assert "degrade refused" in str(e) and "ShardedEntry" in str(e), str(e)
        print("SHARDED-ABORT-OK", flush=True)
        os._exit(0)
    raise AssertionError("a sharded-state death must not commit")


def test_sharded_death_aborts_torn_named_and_salvageable(tmp_path):
    from tpusnap_torch import Snapshot, StateDict, telemetry
    from tpusnap_torch.flight import load_flight_logs, postmortem_verdict
    from tpusnap_torch.knobs import override_batching_disabled
    from tpusnap_torch.lifecycle import fsck_snapshot
    from tpusnap_torch.test_utils import run_subprocess_world

    snap = str(tmp_path / "snap_sharded")
    env = dict(_LIVENESS_ENV, TPUSNAP_RANK_FAILURE="degrade")
    with pytest.raises(RuntimeError) as ei:
        run_subprocess_world(_world_sharded_death_aborts_torn, world_size=2, args=[snap],
                             extra_env=env, timeout=120)
    assert "SHARDED-ABORT-OK" in str(ei.value), str(ei.value)[-3000:]
    report = fsck_snapshot(snap)
    assert report.state == "torn", report.summary()
    assert report.salvage_bytes_present > 0
    verdict = postmortem_verdict(snap, report.state, load_flight_logs(snap, files=report.files))
    assert 1 in verdict["dead_ranks"], verdict
    arrays = _arrays(n=4, seed=3)
    before = telemetry.counter_value("salvage.bytes_salvaged")
    with override_batching_disabled(True):
        snap2 = Snapshot.take(snap, {"m": StateDict(**arrays)}, replicated=["m/w*"])
    salvaged = telemetry.counter_value("salvage.bytes_salvaged") - before
    assert salvaged > 0
    target = {"m": StateDict(**{k: torch.zeros_like(v) for k, v in arrays.items()})}
    snap2.restore(target)
    for k, v in arrays.items():
        assert torch.equal(target["m"][k], v), k
