"""Elastic multi-process delta streams in the port, held to tpusnap's
tests/test_stream_elastic.py on CPU tensors over a two-rank gloo world
(the control plane rides the process group's TCPStore):

- a rank SIGKILLed inside a micro-commit does not kill the stream:
  replicated epochs commit degraded and the survivor streams on alone;
- sharded (DTensor) state cannot be adopted, so the same death tears the
  epoch and pauses the stream; a fresh world reopening the root resumes
  the committed chain and the retake salvages the torn member;
- a graceful ``leave()`` and a later re-join re-plan the world at the
  next capture, recorded per epoch in ``extras["delta"]["world"]``;
- the ``preempt`` fault kind and the terminal ``left`` lease state.

Every wait is on an event (a commit count, a membership, a pause) or a
lease deadline, bounded only to catch a hang; no assertion compares wall
times. Restores are bit-exact (tolerance 0). The SLO gate and the CLI's
chain and post-mortem reports are in tests/test_torch_cli.py.
"""

import os
import signal
import time

import numpy as np
import pytest
import torch

_TTL = 2.0
_ENV = {
    "TPUSNAP_LIVENESS_TTL_S": "2.0",
    "TPUSNAP_HEARTBEAT_INTERVAL_S": "0.1",
    "TPUSNAP_DISABLE_BATCHING": "1",
    "TPUSNAP_RANK_FAILURE": "degrade",
}
# Bounds only a hang: every wait ends on its event long before.
_HANG_S = 120.0


def _state(nbytes_per_arr=1 << 16, n=4, seed=7):
    rng = np.random.default_rng(seed)
    return {
        f"w{i}": torch.from_numpy(rng.standard_normal(nbytes_per_arr // 8))
        for i in range(n)
    }


def _arm_kill_on_next_write(armed):
    """Rank-local: SIGKILL this process on the first blob write (not a
    lifecycle sidecar) after ``armed[0]`` flips — the deterministic
    'die inside a micro-commit' window."""
    import tpusnap_torch.storage_plugins.fs as fs_mod

    orig_write = fs_mod.FSStoragePlugin.write

    async def hooked_write(self, write_io):
        await orig_write(self, write_io)
        if armed[0] and not write_io.path.startswith(".tpusnap"):
            os.kill(os.getpid(), signal.SIGKILL)

    fs_mod.FSStoragePlugin.write = hooked_write


def _wait(pred, what, deadline_s=_HANG_S):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if pred():
            return time.monotonic() - t0
        time.sleep(0.05)
    raise AssertionError(f"no {what} after {deadline_s}s (hung)")


# --------------------------------------------------------------------------
# (a) A replicated stream survives SIGKILL of a rank: a degraded epoch,
#     then solo epochs.
# --------------------------------------------------------------------------


def _world_stream_survives_sigkill(root):
    from tpusnap_torch import Snapshot, StateDict, verify_snapshot
    from tpusnap_torch.comm import get_communicator
    from tpusnap_torch.delta import resolve_chain

    comm = get_communicator()
    arrays = _state(seed=11)
    state = {"m": StateDict(step=7, **arrays)}

    armed = [False]
    if comm.rank == 1:
        _arm_kill_on_next_write(armed)

    stream = Snapshot.stream(root, state, cadence_s=0.5, replicated=["**"])
    # Base and one clean two-rank epoch first, so the kill lands inside
    # a delta micro-commit.
    _wait(lambda: stream.stats["commits"] >= 2, "base + first epoch")
    # Mutate in place (identically on both ranks) right after a commit:
    # the next epoch has real blob writes for the kill to land in.
    for v in arrays.values():
        v += 1.0
    t_armed = time.monotonic()
    armed[0] = True  # rank 1 dies on its next blob write

    if comm.rank == 1:
        time.sleep(_HANG_S)
        os._exit(3)  # the hooked write should have SIGKILLed us
    _wait(lambda: stream.stats["degraded_epochs"] >= 1, "degraded epoch")
    print(f"STREAM-DEGRADED dt={time.monotonic() - t_armed:.1f}", flush=True)
    assert not stream.paused
    after = stream.stats["commits"]
    _wait(lambda: stream.stats["commits"] > after, "post-death epoch")
    assert stream.members == [0], stream.members
    stream.close(final_commit=False)

    rep = resolve_chain(root)
    assert rep.head and not rep.torn_tail, rep.summary()
    assert "DEGRADED" in rep.summary(), rep.summary()
    by_name = {m.name: m for m in rep.members}
    deg = [m for m in rep.members if m.degraded]
    # The lease, not a clock, named the dead rank.
    assert deg and deg[0].degraded["dead_ranks"] == [1], rep.summary()
    assert deg[0].world and deg[0].world["ranks"] == [0, 1], deg[0]
    head = by_name[rep.head]
    assert head.world and head.world["ranks"] == [0], head
    assert head.world.get("left") == [1] or head.world.get("expired") == [1]

    target = {"m": StateDict(step=0, **{k: torch.zeros_like(v) for k, v in arrays.items()})}
    Snapshot(rep.head_path).restore(target)
    assert target["m"]["step"] == 7
    for k, v in arrays.items():
        assert torch.equal(target["m"][k], v), k
    vr = verify_snapshot(rep.head_path)
    assert vr.clean and not vr.corrupt, vr
    print("STREAM-SURVIVED-OK", flush=True)
    os._exit(0)  # the gloo exit barrier would wait on the dead peer


def test_stream_survives_rank_sigkill(tmp_path):
    from tpusnap_torch.test_utils import run_subprocess_world

    root = str(tmp_path / "stream_sigkill")
    with pytest.raises(RuntimeError) as ei:
        run_subprocess_world(
            _world_stream_survives_sigkill,
            world_size=2,
            args=[root],
            extra_env=_ENV,
            timeout=240,
        )
    logs = str(ei.value)
    assert "STREAM-SURVIVED-OK" in logs, logs[-4000:]
    assert "STREAM-DEGRADED dt=" in logs, logs[-4000:]


# --------------------------------------------------------------------------
# (b) Sharded stream: death tears the epoch and pauses the stream; a
#     fresh world reopening the root resumes and salvages.
# --------------------------------------------------------------------------


def _make_sharded(mesh, bump):
    from torch.distributed.tensor import Shard

    from tpusnap_torch.test_utils import as_dtensor

    n = mesh.size() * 8
    full = torch.arange(n * 512, dtype=torch.float32).reshape(n, 512) + bump
    return as_dtensor(full, mesh, [Shard(0)])


def _sharded_state(mesh, bump=0.0):
    from tpusnap_torch import StateDict

    arrays = {k: v + bump for k, v in _state(n=2, seed=3).items()}
    return {"m": StateDict(s=_make_sharded(mesh, bump), **arrays)}


def _world_stream_sharded_pause(root):
    from tpusnap_torch import Snapshot
    from tpusnap_torch.comm import get_communicator
    from tpusnap_torch.test_utils import world_mesh

    comm = get_communicator()
    mesh = world_mesh()
    state = _sharded_state(mesh)

    armed = [False]
    if comm.rank == 1:
        _arm_kill_on_next_write(armed)

    stream = Snapshot.stream(root, state, cadence_s=0.5, replicated=["m/w*"])
    _wait(lambda: stream.stats["commits"] >= 2, "base + first epoch")
    # Swap in the bump=1 state (identically on both ranks): the next
    # epoch has real writes, and the resume world rebuilds this same
    # state, which makes the torn member's journaled bytes salvageable.
    for k, v in _sharded_state(mesh, bump=1.0)["m"].items():
        state["m"][k] = v
    armed[0] = True

    if comm.rank == 1:
        time.sleep(_HANG_S)
        os._exit(3)
    _wait(lambda: stream.paused, "stream pause")
    info = stream.pause_info
    assert info and info["dead_ranks"] == [1], info
    assert info["member"], info
    assert stream.closed
    stream.raise_if_failed()  # a pause is not a worker failure
    print(f"STREAM-PAUSED-OK member={info['member']}", flush=True)
    os._exit(0)


def _world_stream_resume_salvages(root):
    from tpusnap_torch import Snapshot, telemetry, verify_snapshot
    from tpusnap_torch.comm import get_communicator
    from tpusnap_torch.delta import resolve_chain
    from tpusnap_torch.test_utils import world_mesh

    comm = get_communicator()
    state = _sharded_state(world_mesh(), bump=1.0)  # what the torn epoch captured
    before = resolve_chain(root)
    assert before.torn_tail, before.summary()
    committed_seq = max(m.seq for m in before.members if m.state == "committed")

    salv0 = telemetry.counter_value("salvage.bytes_salvaged")
    stream = Snapshot.stream(root, state, cadence_s=0.5, replicated=["m/w*"])
    # A resume, not a second base.
    assert stream.seq == committed_seq, (stream.seq, committed_seq)
    _wait(lambda: stream.stats["commits"] >= 1, "resumed micro-commit")
    salvaged = telemetry.counter_value("salvage.bytes_salvaged") - salv0
    stream.close(final_commit=False)

    rep = resolve_chain(root)
    assert rep.head and not rep.torn_tail, rep.summary()
    assert not os.path.isdir(os.path.join(root, "base-000001"))
    if comm.rank == 0:
        assert salvaged > 0, salvaged
        vr = verify_snapshot(rep.head_path)
        assert vr.clean and not vr.corrupt, vr
        print(f"STREAM-RESUMED-OK salvaged={salvaged}", flush=True)


def test_stream_sharded_death_pauses_then_resume_salvages(tmp_path):
    from tpusnap_torch.delta import resolve_chain
    from tpusnap_torch.test_utils import run_subprocess_world

    root = str(tmp_path / "stream_sharded")
    with pytest.raises(RuntimeError) as ei:
        run_subprocess_world(
            _world_stream_sharded_pause,
            world_size=2,
            args=[root],
            extra_env=_ENV,
            timeout=240,
        )
    logs = str(ei.value)
    assert "STREAM-PAUSED-OK" in logs, logs[-4000:]

    rep = resolve_chain(root)
    assert rep.torn_tail, rep.summary()
    torn = next(m for m in rep.members if m.name == rep.torn_tail)
    assert torn.world and torn.world["ranks"] == [0, 1], torn

    logs2 = run_subprocess_world(
        _world_stream_resume_salvages,
        world_size=2,
        args=[root],
        extra_env=_ENV,
        timeout=240,
    )
    assert any("STREAM-RESUMED-OK" in log for log in logs2), logs2


# --------------------------------------------------------------------------
# (c) Graceful leave and a later re-join.
# --------------------------------------------------------------------------


def _touch(path):
    with open(path, "w") as f:
        f.write("1")
        f.flush()
        os.fsync(f.fileno())


def _world_stream_leave_rejoin(root, sync_dir):
    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.comm import get_communicator

    comm = get_communicator()
    arrays = _state(n=3, seed=5)
    state = {"m": StateDict(step=1, **arrays)}
    stream = Snapshot.stream(root, state, cadence_s=0.4, replicated=["**"])
    _wait(lambda: stream.stats["commits"] >= 2, "base + first epoch")

    if comm.rank == 1:
        head = stream.leave()
        assert head is not None
        assert stream.closed and not stream.paused
        print("R1-LEFT", flush=True)
        # Re-join the live stream on the same root: a solo open against
        # the incumbents' registration, no collectives.
        st2 = Snapshot.stream(root, state, cadence_s=0.4, replicated=["**"])
        assert st2.stats["joins"] == 1
        _wait(lambda: st2.stats["commits"] >= 1 and 1 in st2.members, "re-joined epoch")
        print("R1-REJOINED", flush=True)
        _wait(lambda: os.path.exists(os.path.join(sync_dir, "r0_done")), "rank 0 ack")
        st2.leave()
    else:
        _wait(lambda: stream.members == [0], "solo epoch after leave")
        print("R0-SAW-LEAVE", flush=True)
        _wait(lambda: stream.members == [0, 1], "re-planned epoch")
        print("R0-SAW-REJOIN", flush=True)
        _touch(os.path.join(sync_dir, "r0_done"))
        _wait(lambda: stream.members == [0], "second leave")
        stream.close(final_commit=False)


def test_stream_graceful_leave_and_rejoin(tmp_path):
    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.delta import resolve_chain
    from tpusnap_torch.test_utils import run_subprocess_world

    root = str(tmp_path / "stream_elastic")
    sync = str(tmp_path / "sync")
    os.makedirs(sync, exist_ok=True)
    logs = run_subprocess_world(
        _world_stream_leave_rejoin,
        world_size=2,
        args=[root, sync],
        extra_env=_ENV,
        timeout=240,
    )
    joined = "\n".join(logs)
    for marker in ("R1-LEFT", "R1-REJOINED", "R0-SAW-LEAVE", "R0-SAW-REJOIN"):
        assert marker in joined, joined[-4000:]

    rep = resolve_chain(root)
    assert rep.head and not rep.torn_tail, rep.summary()
    worlds = [m.world for m in rep.members if m.world]
    assert any(w.get("left") == [1] for w in worlds), worlds
    assert any(w.get("joined") == [1] for w in worlds), worlds

    arrays = _state(n=3, seed=5)
    target = {"m": StateDict(step=0, **{k: torch.zeros_like(v) for k, v in arrays.items()})}
    Snapshot(rep.head_path).restore(target)
    assert target["m"]["step"] == 1
    for k, v in arrays.items():
        assert torch.equal(target["m"][k], v), k


# --------------------------------------------------------------------------
# The preempt fault kind and the terminal ``left`` lease state.
# --------------------------------------------------------------------------


def test_preempt_spec_parses():
    from tpusnap_torch.faults import FaultPlan

    plan = FaultPlan.from_spec("preempt=write:3:30")
    assert plan.preempt == ("write", 3, 30.0)
    plan = FaultPlan.from_spec("rank=1,preempt=write:*:5")
    assert plan.preempt == ("write", 0, 5.0)
    assert plan.rank == 1
    with pytest.raises(ValueError):
        FaultPlan.from_spec("preempt=write:3")  # grace_s is required


def test_preempt_delivers_sigterm_once_with_kill_deadline(monkeypatch):
    from tpusnap_torch import faults

    sent = []
    timers = []

    class FakeTimer:
        def __init__(self, interval, fn):
            timers.append(interval)
            self.daemon = False

        def start(self):
            pass

    monkeypatch.setattr(faults.os, "kill", lambda pid, sig: sent.append(sig))
    monkeypatch.setattr(faults.threading, "Timer", FakeTimer)

    plugin = faults.FaultInjectionStoragePlugin(
        inner=None, plan=faults.FaultPlan.from_spec("preempt=write:2:7.5")
    )
    plugin._check_preempt("write")  # attempt 1: not yet
    assert sent == []
    plugin._check_preempt("write")  # attempt 2: SIGTERM + armed SIGKILL
    assert sent == [signal.SIGTERM]
    assert timers == [7.5]
    plugin._check_preempt("write")  # fires at most once
    plugin._check_preempt("write")
    assert sent == [signal.SIGTERM]


def test_monitor_never_expires_a_left_rank():
    from tpusnap_torch.dist_store import MemoryKVStore
    from tpusnap_torch.liveness import LeasePublisher, LivenessMonitor

    kv = MemoryKVStore()
    t = [100.0]
    mon = LivenessMonitor(kv, "take-x", rank=0, world_size=2, ttl_s=1.0, clock=lambda: t[0])
    p0 = LeasePublisher(kv, "take-x", 0)
    p1 = LeasePublisher(kv, "take-x", 1)
    p0.publish()
    p1.publish()
    mon.check()  # both live
    # Rank 1 leaves, then goes silent for many TTLs: no expiry, no
    # RankFailedError, and the departure is queryable.
    p1.leave()
    for _ in range(20):
        t[0] += 1.0
        p0.publish()
        mon.check()
    assert mon.left_ranks() == [1]
    assert not mon.dead_ranks()
