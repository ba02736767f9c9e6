"""tpusnap_torch async takes and restores on CPU tensors: the pipelined
write engine, the staging pool, COW and clone staging, RNG invariance,
and cross-package restores. Mirrors of tests/test_staging_pool.py and
tests/test_pipelined_staging.py, with the port's objects in place of
tpusnap's. Snapshots are bit-exact,
so every comparison has tolerance 0.

CPU tensors take tpusnap's contract: under COW (the default) the caller
mutates them only after ``wait_staged()``; with ``TPUSNAP_ASYNC_COW=0``
they are cloned. CUDA tensors, frozen at the return, are held by
tests/test_torch_cuda.py on the card.
"""

import asyncio
import glob
import os
import pickle
import random
import threading
import time

import numpy as np
import pytest
import torch

import tpusnap_torch._staging_pool as sp
from tpusnap_torch import RNGState, Snapshot, StateDict
from tpusnap_torch.io_preparers.array import ArrayBufferStager, _record_checksums
from tpusnap_torch.io_types import BufferStager, WriteReq
from tpusnap_torch.knobs import (
    get_stage_threads,
    override_async_cow,
    override_async_stage_window_bytes,
    override_batching_disabled,
    override_memory_budget_bytes,
    override_stage_threads,
)
from tpusnap_torch.manifest import TensorEntry
from tpusnap_torch.scheduler import _WriteScheduler, execute_write_reqs
from tpusnap_torch.storage_plugins.fs import FSStoragePlugin

torch.set_num_threads(1)

_N = 8
_PER = 1 << 18  # 256 KiB per tensor


def _state(n=_N, per=_PER, seed=7):
    return {
        f"w{i}": torch.from_numpy(
            np.random.default_rng(seed * 100 + i).integers(0, 255, per, dtype=np.uint8)
        ).view(torch.float32)
        for i in range(n)
    }


def _bytes(t: torch.Tensor) -> bytes:
    return bytes(t.contiguous().reshape(-1).view(torch.uint8).numpy())


def _blob_files(root):
    return [
        f
        for f in glob.glob(os.path.join(root, "**", "*"), recursive=True)
        if os.path.isfile(f) and not f.endswith(".snapshot_metadata")
    ]


def _restore_and_check(path, state):
    targets = StateDict({k: torch.zeros_like(v) for k, v in state.items()})
    Snapshot(path).restore({"m": targets})
    for k, v in state.items():
        assert _bytes(targets[k]) == _bytes(v), k


@pytest.fixture
def slow_writes(monkeypatch):
    """Every storage write waits ``delay`` seconds first (the drain's leg)."""

    def install(delay):
        orig = FSStoragePlugin.write

        async def write(self, write_io):
            await asyncio.sleep(delay)
            await orig(self, write_io)

        monkeypatch.setattr(FSStoragePlugin, "write", write)

    return install


@pytest.fixture(autouse=True)
def _fresh_pool():
    sp.clear()
    yield
    sp.clear()


# ---------------------------------------------------------- staging pool


def test_exact_size_reuse():
    a = sp.acquire(1 << 20)
    ptr = a.ctypes.data
    assert sp.release(a) is True
    b = sp.acquire(1 << 20)
    assert b.ctypes.data == ptr  # the same (warm) buffer handed back
    c = sp.acquire(2 << 20)  # another size misses
    assert c.ctypes.data != ptr


def test_release_ignores_foreign_buffers():
    user = np.zeros(1 << 20, np.uint8)
    assert sp.release(user) is False
    assert sp.release(memoryview(user)) is False
    assert sp.release(b"bytes") is False


def test_cap_evicts_oldest_sizes(monkeypatch):
    monkeypatch.setenv("TPUSNAP_STAGING_POOL_BYTES", str(3 << 20))
    old = sp.acquire(2 << 20)
    old_ptr = old.ctypes.data
    assert sp.release(old) is True
    new = sp.acquire(2 << 20 | 4096)
    assert sp.release(new) is True  # evicts the old entry to fit
    assert sp.acquire(2 << 20).ctypes.data != old_ptr
    monkeypatch.setenv("TPUSNAP_STAGING_POOL_BYTES", str(1 << 20))
    assert sp.release(sp.acquire(2 << 20)) is False  # above the cap


def test_dropped_buffers_do_not_leak_tracking():
    a = sp.acquire(1 << 20)
    a_id = id(a)
    del a  # an abort path: dropped without release()
    # The probe is held through the check: a freed probe's address can be
    # recycled as a_id and look like a fresh dead entry. Retry a few times
    # for the same reason with other threads' buffers.
    for _ in range(5):
        probe = sp.acquire(4096)
        ref = sp._outstanding.get(a_id)
        ok = ref is None or ref() is not None
        sp.release(probe)
        del probe
        if ok:
            break
        time.sleep(0.05)
    else:
        raise AssertionError("dropped buffer leaked in _outstanding")


def test_double_release_is_inert():
    a = sp.acquire(1 << 20)
    assert sp.release(a) is True
    assert sp.release(a) is False
    assert sp.free_bytes() == 1 << 20


def _record_acquires(monkeypatch):
    seen = []
    orig = sp.acquire

    def acquire(nbytes):
        buf = orig(nbytes)
        seen.append(buf.ctypes.data)
        return buf

    monkeypatch.setattr(sp, "acquire", acquire)
    return seen


def test_async_take_loop_reuses_buffers(tmp_path, monkeypatch):
    """The second async take's clones come from the pool (clone mode: COW
    clones nothing)."""
    state = {
        f"w{i}": torch.from_numpy(
            np.random.default_rng(i).standard_normal(1 << 17).astype(np.float32)
        )
        for i in range(3)
    }
    take_bytes = sum(t.numel() * 4 for t in state.values())
    seen = _record_acquires(monkeypatch)
    with override_async_cow(False):
        Snapshot.async_take(str(tmp_path / "s0"), {"m": StateDict(state)}).wait()
        first = set(seen)
        assert sp.free_bytes() > 0  # clones went back to the pool
        free_after_first = sp.free_bytes()
        seen.clear()
        Snapshot.async_take(str(tmp_path / "s1"), {"m": StateDict(state)}).wait()
    assert first & set(seen), "no clone of the second take reused a pooled buffer"
    assert sp.free_bytes() <= free_after_first + take_bytes
    for s in ("s0", "s1"):
        _restore_and_check(str(tmp_path / s), state)


# -------------------------------------------------------- write engine


class _UnitStager(BufferStager):
    live = 0
    peak = 0

    def __init__(self, data):
        self.data = data

    async def stage_buffer(self, executor=None):
        _UnitStager.live += 1
        _UnitStager.peak = max(_UnitStager.peak, _UnitStager.live)
        await asyncio.sleep(0.002)
        return self.data

    def get_staging_cost_bytes(self) -> int:
        return len(self.data)


def test_pipelined_execute_returns_at_first_window(tmp_path):
    """The engine hands back resumable work once one window's worth is
    staged; complete() stages the rest under the window bound."""
    _UnitStager.live = 0
    _UnitStager.peak = 0
    unit = 1000

    class DecPlugin(FSStoragePlugin):
        async def write(self, write_io) -> None:
            await asyncio.sleep(0.005)
            await super().write(write_io)
            _UnitStager.live -= 1

    plugin = DecPlugin(root=str(tmp_path))
    write_reqs = [
        WriteReq(path=f"b{i}", buffer_stager=_UnitStager(os.urandom(unit))) for i in range(10)
    ]

    async def go():
        pending = await execute_write_reqs(
            write_reqs, plugin, memory_budget_bytes=1 << 30, pipelined_staging=True
        )
        assert not pending.staging_complete()
        assert _UnitStager.peak <= 3  # the window (2) + the >=1 admission
        await pending.complete()
        assert pending.staging_complete() and pending.drained()

    with override_async_stage_window_bytes(2 * unit):
        asyncio.run(go())
    for i in range(10):
        assert (tmp_path / f"b{i}").exists()
    assert _UnitStager.peak <= 3, f"window unenforced: peak {_UnitStager.peak}"


class _NamedStager(BufferStager):
    def __init__(self, name, data, log, delay=0.0):
        self.name, self.data, self.log, self.delay = name, data, log, delay

    async def stage_buffer(self, executor=None):
        await asyncio.sleep(self.delay)
        self.log.append(self.name)
        return self.data

    def get_staging_cost_bytes(self) -> int:
        return len(self.data)


def test_pipelined_stage_eagerly_requests_stage_in_blocked_window(tmp_path):
    staged = []
    write_reqs = [
        WriteReq(path=f"{p}{i}", buffer_stager=_NamedStager(f"{p}{i}", os.urandom(500), staged))
        for p in ("e", "d")
        for i in range(4)
    ]

    async def go():
        pending = await execute_write_reqs(
            write_reqs,
            FSStoragePlugin(root=str(tmp_path)),
            memory_budget_bytes=1 << 30,
            pipelined_staging=True,
            stage_eagerly=lambda wr: wr.path.startswith("e"),
        )
        assert {f"e{i}" for i in range(4)} <= set(staged), staged
        await pending.complete()

    with override_async_stage_window_bytes(1000):
        asyncio.run(go())


def test_stage_eagerly_holds_window_open_across_threads(tmp_path):
    """Fast non-eager stagers that overshoot the window while a slow eager
    one is in flight must not close the blocked window early."""
    staged = []
    write_reqs = [
        WriteReq(path="eager", buffer_stager=_NamedStager("eager", os.urandom(400), staged, 0.15))
    ] + [
        WriteReq(path=f"d{i}", buffer_stager=_NamedStager(f"d{i}", os.urandom(600), staged, 0.001))
        for i in range(6)
    ]

    async def go():
        pending = await execute_write_reqs(
            write_reqs,
            FSStoragePlugin(root=str(tmp_path)),
            memory_budget_bytes=1 << 30,
            pipelined_staging=True,
            stage_eagerly=lambda wr: wr.path == "eager",
        )
        assert "eager" in staged, f"window closed mid-eager: {staged}"
        await pending.complete()

    with override_stage_threads(2), override_async_stage_window_bytes(1200):
        asyncio.run(go())


def test_single_stage_thread_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("TPUSNAP_STAGE_THREADS", raising=False)
    assert get_stage_threads() == 1
    with override_stage_threads(3):
        sched = _WriteScheduler([], FSStoragePlugin(root=str(tmp_path)), 1 << 20)
        try:
            assert sched.stage_concurrency == 3
            assert sched.executor._max_workers == 3
        finally:
            sched.executor.shutdown(wait=False)
            sched.hash_executor.shutdown(wait=False)


# ------------------------------------------------------------ take level


def test_blocked_window_is_budget_bounded(tmp_path, monkeypatch, slow_writes):
    """An async take of many windows under a tight budget keeps the bytes
    staged and not yet written within the budget, and returns before all
    blobs exist; the commit completes and restores bit-exact."""
    state = _state()
    budget = 4 * _PER  # four in-flight COW stagings (cost = payload)
    lock = threading.Lock()
    live = {"now": 0, "peak": 0}
    orig_stage = ArrayBufferStager.stage_buffer

    async def stage(self, executor=None):
        buf = await orig_stage(self, executor)
        with lock:
            live["now"] += memoryview(buf).nbytes
            live["peak"] = max(live["peak"], live["now"])
        return buf

    monkeypatch.setattr(ArrayBufferStager, "stage_buffer", stage)
    slow_writes(0.3)
    orig_write = FSStoragePlugin.write

    async def write(self, write_io):
        await orig_write(self, write_io)
        with lock:
            live["now"] -= memoryview(write_io.buf).nbytes

    monkeypatch.setattr(FSStoragePlugin, "write", write)
    path = str(tmp_path / "snap")
    with override_batching_disabled(True), override_memory_budget_bytes(budget):
        pending = Snapshot.async_take(path, {"m": StateDict(state)})
        assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))
        assert len(_blob_files(path)) < _N
        snap = pending.wait()
        assert pending.staged()
    assert 0 < live["peak"] <= budget, live
    assert os.path.exists(os.path.join(path, ".snapshot_metadata"))
    _restore_and_check(snap.path, state)


@pytest.mark.parametrize("window", [1 << 30, 0], ids=["window_fits_state", "strict"])
def test_window_fits_state_keeps_strict_semantics(tmp_path, window):
    """A state within the window (or window 0) stages completely before
    the return: with clones, in-place mutation right after it is harmless."""
    state = _state(n=3)
    path = str(tmp_path / "snap")
    with override_async_stage_window_bytes(window), override_async_cow(False):
        pending = Snapshot.async_take(path, {"m": StateDict(state)})
        assert pending.staged()
        frozen = {k: v.clone() for k, v in state.items()}
        for v in state.values():
            v.view(torch.uint8).fill_(0xAB)
        pending.wait()
    _restore_and_check(path, frozen)


def test_clone_mode_residual_windows_freeze_at_wait_staged(tmp_path, slow_writes):
    """With clones and a state larger than the window, the residual windows
    clone on the drain: staged() turns True at staging-complete, and a
    mutation after wait_staged() is harmless."""
    state = _state()
    slow_writes(0.05)
    path = str(tmp_path / "snap")
    with override_batching_disabled(True), override_async_cow(False), \
            override_async_stage_window_bytes(2 * 2 * _PER):
        pending = Snapshot.async_take(path, {"m": StateDict(state)})
        assert not pending.staged()
        assert pending.wait_staged(timeout=30)
        frozen = {k: v.clone() for k, v in state.items()}
        for v in state.values():
            v.view(torch.uint8).fill_(0xCD)
        pending.wait()
    _restore_and_check(path, frozen)


def test_stall_in_drain_does_not_extend_blocked_window(tmp_path, slow_writes):
    state = _state()
    stall_s = 1.2
    slow_writes(stall_s)
    path = str(tmp_path / "snap")
    with override_batching_disabled(True), override_async_stage_window_bytes(2 * 2 * _PER):
        t0 = time.perf_counter()
        pending = Snapshot.async_take(path, {"m": StateDict(state)})
        blocked = time.perf_counter() - t0
        pending.wait()
    assert blocked < stall_s, f"blocked window {blocked:.2f}s swallowed the drain's stall"
    _restore_and_check(path, state)


def test_warm_pool_reuse_across_windows(tmp_path):
    """Window N+1's clones reuse the buffers window N's writes released:
    the pool ends up holding about one window, not the state."""
    state = _state()
    path = str(tmp_path / "snap")
    with override_batching_disabled(True), override_async_cow(False), \
            override_async_stage_window_bytes(2 * 2 * _PER):
        Snapshot.async_take(path, {"m": StateDict(state)}).wait()
    assert 0 < sp.free_bytes() < _N * _PER, sp.free_bytes()
    _restore_and_check(path, state)


# ------------------------------------------------------------ COW mode


def test_cow_frozen_state_clones_nothing(tmp_path, monkeypatch):
    verified = []
    orig = ArrayBufferStager.verify_cow_after_write

    def verify(self, buf):
        verified.append(self.entry.location)
        orig(self, buf)

    monkeypatch.setattr(ArrayBufferStager, "verify_cow_after_write", verify)
    seen = _record_acquires(monkeypatch)
    state = _state()
    path = str(tmp_path / "snap")
    with override_batching_disabled(True), override_async_cow(True):
        snap = Snapshot.async_take(path, {"m": StateDict(state)}).wait()
    assert not seen and sp.free_bytes() == 0  # no clone buffer was acquired
    assert len(verified) == _N
    _restore_and_check(snap.path, state)


def test_cow_detects_concurrent_mutation(tmp_path, slow_writes):
    """Mutating a CPU tensor between its stage-time hash and its storage
    write fails the take; the metadata is never written."""
    state = _state(n=4)
    slow_writes(1.0)
    path = str(tmp_path / "snap")
    with override_batching_disabled(True), override_async_cow(True), \
            override_async_stage_window_bytes(2 * _PER):
        pending = Snapshot.async_take(path, {"m": StateDict(state)})
        # The live bytes stay aliased until the stalled writes drain.
        assert not pending.wait_staged(timeout=0.05)
        assert not pending.staged()
        for v in state.values():
            v.view(torch.uint8).fill_(0x5A)
        with pytest.raises(RuntimeError, match="concurrent mutation"):
            pending.wait()
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))


def test_cow_verify_checks_xxh64_lane():
    from tpusnap_torch import _native

    data = np.arange(1024, dtype=np.uint8)
    entry = TensorEntry(
        location="w", serializer="buffer_protocol", dtype="uint8", shape=[1024],
        replicated=False, byte_range=None,
    )
    _record_checksums(entry, memoryview(data.tobytes()))
    assert entry.dedup_hash
    stager = ArrayBufferStager(torch.from_numpy(data), entry=entry, is_async_snapshot=True)
    stager.verify_cow_after_write(data.tobytes())  # unmutated: clean
    mutated = bytearray(data.tobytes())
    mutated[0] ^= 0xFF
    with pytest.raises(_native.ChecksumError):
        stager._verify_cow_xxh_lane(memoryview(bytes(mutated)))


def test_cow_slab_members_verified_against_slab_copy(tmp_path, monkeypatch):
    state = _state(n=4)
    path = str(tmp_path / "ok")
    with override_async_cow(True):
        snap = Snapshot.async_take(path, {"m": StateDict(state)}).wait()
    _restore_and_check(snap.path, state)

    orig = ArrayBufferStager.stage_buffer

    async def mutate_after_hash(self, executor=None):
        buf = await orig(self, executor)
        if self.cow_pending:
            self.arr.view(torch.uint8)[:1].bitwise_xor_(0xFF)
        return buf

    monkeypatch.setattr(ArrayBufferStager, "stage_buffer", mutate_after_hash)
    bad = str(tmp_path / "bad")
    with override_async_cow(True):
        with pytest.raises(RuntimeError, match="concurrent mutation"):
            Snapshot.async_take(bad, {"m": StateDict(_state(n=4))}).wait()
    assert not os.path.exists(os.path.join(bad, ".snapshot_metadata"))


# ------------------------------------------------------- async take/restore


def test_failed_async_take_leaves_no_metadata(tmp_path, monkeypatch):
    orig = FSStoragePlugin.write

    async def write(self, write_io):
        if write_io.path.endswith("w3"):
            raise OSError(28, "No space left on device", write_io.path)
        await orig(self, write_io)

    monkeypatch.setattr(FSStoragePlugin, "write", write)
    path = str(tmp_path / "snap")
    with override_batching_disabled(True), override_async_stage_window_bytes(2 * _PER):
        pending = Snapshot.async_take(path, {"m": StateDict(_state())})
        with pytest.raises(OSError, match="No space"):
            pending.wait_staged()
        with pytest.raises(OSError, match="No space"):
            pending.wait()
    assert pending.done()
    assert pending._event_loop.is_closed()  # closed by the drain
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))


@pytest.mark.parametrize(
    "option", ["incremental_from", "_custom_array_prepare_func"]
)
def test_async_take_with_item3_options(tmp_path, option):
    """Formerly "not ported" cases. An async incremental take stages
    everything before it returns and writes only the changed tensor; an
    async take with a save-time transform stores the transformed bytes."""
    state = _state(n=3)
    path = str(tmp_path / "snap")
    with override_batching_disabled(True):
        if option == "incremental_from":
            base = str(tmp_path / "base")
            Snapshot.take(base, {"m": StateDict(state)})
            state["w1"] = state["w1"] + 1.0
            pending = Snapshot.async_take(path, {"m": StateDict(state)}, incremental_from=base)
            assert pending._pending_io_work.staging_complete()
            pending.wait()
            assert [os.path.relpath(f, path) for f in _blob_files(path)] == ["0/m/w1"]
            want = state
        else:
            fn = lambda p, a, tracing: a.to(torch.float16)  # noqa: E731
            Snapshot.async_take(path, {"m": StateDict(state)}, _custom_array_prepare_func=fn).wait()
            want = {k: v.to(torch.float16).float() for k, v in state.items()}
    targets = StateDict({k: torch.zeros_like(v) for k, v in state.items()})
    Snapshot(path).restore({"m": targets})
    for k, v in want.items():
        assert _bytes(targets[k]) == _bytes(v), k


def test_async_restore_round_trip(tmp_path):
    state = _state(n=3)
    param = torch.nn.Parameter(torch.arange(6, dtype=torch.float32))
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": StateDict(state), "p": StateDict(p=param, step=4)})
    targets = {k: torch.zeros_like(v) for k, v in state.items()}
    target_param = torch.nn.Parameter(torch.zeros(6))
    m, p = StateDict(dict(targets)), StateDict(p=target_param, step=0)
    pending = Snapshot(path).async_restore({"m": m, "p": p})
    assert pending.wait() is None and pending.done()
    assert p["p"] is target_param and torch.equal(target_param, param)
    assert p["step"] == 4
    for k, v in state.items():
        assert m[k] is targets[k] and _bytes(targets[k]) == _bytes(v), k


def test_async_restore_rejects_load_requires_collectives(tmp_path):
    class Collective(StateDict):
        load_requires_collectives = True

    path = str(tmp_path / "snap")
    Snapshot.take(path, {"c": StateDict(x=1), "m": StateDict(y=2)})
    with pytest.raises(ValueError, match="load_requires_collectives"):
        Snapshot(path).async_restore({"c": Collective(x=0), "m": StateDict(y=0)})


class _DrawsOnStateDict(StateDict):
    """A stateful whose state_dict() draws from every global generator."""

    def state_dict(self):
        random.random()
        np.random.rand()
        torch.rand(1)
        return super().state_dict()


@pytest.mark.parametrize("kind", ["take", "async_take"])
def test_rng_state_invariance(tmp_path, kind):
    app_state = {"rng": RNGState(), "s": _DrawsOnStateDict(x=1)}
    random.seed(1)
    np.random.seed(1234)
    torch.manual_seed(7)
    before = (random.getstate(), np.random.get_state()[1].copy(), torch.get_rng_state())
    path = str(tmp_path / "snap")
    if kind == "take":
        snap = Snapshot.take(path, app_state)
    else:
        snap = Snapshot.async_take(path, app_state).wait()
    assert random.getstate() == before[0], "take perturbed python's random"
    assert np.array_equal(np.random.get_state()[1], before[1]), "take perturbed numpy"
    assert torch.equal(torch.get_rng_state(), before[2]), "take perturbed torch"

    expected = (random.random(), np.random.rand(4), torch.rand(4))
    random.seed(999)
    np.random.seed(999)
    torch.manual_seed(999)
    # The RNG loads last: the other stateful's loading cannot disturb it.
    snap.restore({"s": _DrawsOnStateDict(x=0), "rng": RNGState()})
    assert random.random() == expected[0]
    assert np.array_equal(np.random.rand(4), expected[1])
    assert torch.equal(torch.rand(4), expected[2])


def test_tpusnap_rng_state_restores_into_port(tmp_path):
    """tpusnap's RNGState keys restore the port's python and numpy
    generators and leave torch's as they are."""
    from tpusnap import RNGState as JaxRNGState
    from tpusnap import Snapshot as JaxSnapshot

    np.random.seed(42)
    random.seed(42)
    path = str(tmp_path / "jax")
    JaxSnapshot.take(path, {"rng": JaxRNGState()})
    expected = (random.random(), np.random.rand(3))
    np.random.seed(0)
    random.seed(0)
    torch.manual_seed(5)
    torch_before = torch.get_rng_state()
    Snapshot(path).restore({"rng": RNGState()})
    assert (random.random(), *np.random.rand(3)) == (expected[0], *expected[1])
    assert torch.equal(torch.get_rng_state(), torch_before)
    state = pickle.loads(pickle.dumps(RNGState().state_dict()))
    assert {"python_random", "numpy_random", "torch_cpu"} <= set(state)


@pytest.mark.parametrize("cow", [True, False], ids=["cow", "clone"])
def test_port_async_take_restores_through_tpusnap(tmp_path, monkeypatch, cow):
    """A pipelined async take (residual windows, chunked tensors, a slab)
    restores through tpusnap bit-exact, with crc32c on both sides."""
    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import StateDict as JaxStateDict
    from tpusnap_torch.knobs import override_max_chunk_size_bytes

    monkeypatch.setenv("TPUSNAP_SLAB_SIZE_THRESHOLD_BYTES", "4096")
    state = _state(n=4)
    state["small_a"] = torch.arange(10, dtype=torch.int32)
    state["small_b"] = torch.ones(7, dtype=torch.float32)
    path = str(tmp_path / "snap")
    with override_async_cow(cow), override_async_stage_window_bytes(2 * _PER), \
            override_max_chunk_size_bytes(_PER // 2):
        snap = Snapshot.async_take(path, {"m": StateDict(state)}).wait()
    manifest = snap.metadata.manifest
    assert manifest["0/m/w0"].type == "ChunkedTensor"
    assert manifest["0/m/small_a"].location.startswith("batched/")
    algos = {
        e.checksum.split(":")[0] for e in manifest.values() if getattr(e, "checksum", None)
    }
    assert algos == {"crc32c"}
    targets = JaxStateDict({k: np.zeros(v.shape, v.numpy().dtype) for k, v in state.items()})
    JaxSnapshot(path).restore({"m": targets})
    for k, v in state.items():
        assert np.asarray(targets[k]).tobytes() == _bytes(v), k


# -------------------------------------------------- history/regression


def test_async_blocked_s_recorded_and_gated(tmp_path):
    """async_blocked_s lands in the take summary and the history event,
    and `history --check` grades it as a duration (upward regressions
    fire). Mirror of tests/test_pipelined_staging.py's case."""
    from tpusnap_torch import check_regression, telemetry
    from tpusnap_torch import history as hist
    from tpusnap_torch.knobs import override_telemetry_dir

    state = _state(n=2)
    with override_telemetry_dir(str(tmp_path / "tele")):
        hist._reset_process_state()
        Snapshot.async_take(str(tmp_path / "s"), {"m": StateDict(state)}).wait()
        assert isinstance(telemetry.LAST_TAKE_SUMMARY["async_blocked_s"], float)
        events = hist.load_history()
        takes = [e for e in events if e.get("kind") == "take"]
        assert takes and isinstance(takes[-1].get("async_blocked_s"), float)

        # Synthetic trend: a 2x slower blocked window must regress.
        base = dict(takes[-1], cold=False)
        evs = []
        for i in range(5):
            evs.append(dict(base, async_blocked_s=0.1, ts=i))
        evs.append(dict(base, async_blocked_s=0.25, ts=9))
        report = check_regression(
            evs, kind="take", metric="async_blocked_s", min_baseline=3
        )
        assert report.ok and report.regressed, report.reason
        ok = check_regression(
            evs[:-1], kind="take", metric="async_blocked_s", min_baseline=3
        )
        assert ok.ok and not ok.regressed, ok.reason
