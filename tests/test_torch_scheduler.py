"""tpusnap_torch's scheduler: budget gating, over-budget items, failure
propagation, read gating, the progress reporter and ``prioritize_staging``.

Mirror of tests/test_scheduler.py, case for case, with the port's objects
in place of tpusnap's, plus one cross-package case: the same requests
through both schedulers publish ``LAST_EXECUTION_STATS`` with the same
keys and the same request and byte counts. Every payload is made from a
seeded numpy generator; byte comparisons are exact.
"""

import asyncio
import logging
import time

import numpy as np
import pytest

import tpusnap_torch._staging_pool as sp
from tpusnap_torch import io_types as p_io
from tpusnap_torch import scheduler as sched
from tpusnap_torch.io_types import (
    BufferConsumer,
    BufferStager,
    ReadReq,
    WriteIO,
    WriteReq,
)
from tpusnap_torch.knobs import override_memory_budget_bytes
from tpusnap_torch.scheduler import (
    PendingIOWork,
    execute_read_reqs,
    execute_write_reqs,
    get_process_memory_budget_bytes,
    sync_execute_write_reqs,
)
from tpusnap_torch.storage_plugins.fs import FSStoragePlugin


def _payload(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


class TrackingStager(BufferStager):
    """Stager that tracks the global concurrent staging cost."""

    live_cost = 0
    peak_cost = 0

    def __init__(self, data: bytes, cost: int):
        self.data = data
        self.cost = cost

    async def stage_buffer(self, executor=None):
        TrackingStager.live_cost += self.cost
        TrackingStager.peak_cost = max(TrackingStager.peak_cost, TrackingStager.live_cost)
        await asyncio.sleep(0.01)
        # The buffer stays live until its write completes (the plugin
        # below takes it off the count).
        return self.data

    def get_staging_cost_bytes(self) -> int:
        return self.cost


class ByteConsumer(BufferConsumer):
    def __init__(self, sink: dict, key: str, cost: int = 0):
        self.sink = sink
        self.key = key
        self.cost = cost

    async def consume_buffer(self, buf, executor=None) -> None:
        self.sink[self.key] = bytes(buf)

    def get_consuming_cost_bytes(self) -> int:
        return self.cost


class FaultyStager(BufferStager):
    async def stage_buffer(self, executor=None):
        raise RuntimeError("staging boom")

    def get_staging_cost_bytes(self) -> int:
        return 10


class FaultyPlugin(FSStoragePlugin):
    async def write(self, write_io) -> None:
        raise OSError("storage boom")


def test_write_then_read_roundtrip(tmp_path):
    plugin = FSStoragePlugin(root=str(tmp_path))
    blobs = {f"blob{i}": _payload(i, 1000 + i) for i in range(40)}
    write_reqs = [
        WriteReq(path=k, buffer_stager=TrackingStager(v, cost=len(v)))
        for k, v in blobs.items()
    ]
    loop = asyncio.new_event_loop()
    try:
        pending = sync_execute_write_reqs(
            write_reqs, plugin, memory_budget_bytes=1 << 30, rank=0, event_loop=loop
        )
        assert isinstance(pending, PendingIOWork)
        pending.sync_complete(loop)

        sink = {}
        read_reqs = [
            ReadReq(path=k, buffer_consumer=ByteConsumer(sink, k, cost=len(v)))
            for k, v in blobs.items()
        ]
        loop.run_until_complete(execute_read_reqs(read_reqs, plugin, 1 << 30, rank=0))
        assert sink == blobs
    finally:
        loop.close()


def test_budget_gates_staging(tmp_path):
    """With a budget of 2 units and 8 one-unit items, the peak concurrent
    staging cost never exceeds the budget."""
    TrackingStager.live_cost = 0
    TrackingStager.peak_cost = 0
    unit = 1000
    blobs = {f"b{i}": _payload(100 + i, unit) for i in range(8)}

    class DecrementingPlugin(FSStoragePlugin):
        async def write(self, write_io) -> None:
            await super().write(write_io)
            TrackingStager.live_cost -= len(write_io.buf)

    plugin = DecrementingPlugin(root=str(tmp_path))
    write_reqs = [
        WriteReq(path=k, buffer_stager=TrackingStager(v, cost=unit)) for k, v in blobs.items()
    ]

    async def go():
        pending = await execute_write_reqs(write_reqs, plugin, memory_budget_bytes=2 * unit, rank=0)
        await pending.complete()

    asyncio.run(go())
    assert TrackingStager.peak_cost <= 2 * unit


def test_over_budget_item_still_runs(tmp_path):
    plugin = FSStoragePlugin(root=str(tmp_path))
    data = _payload(7, 5000)
    write_reqs = [WriteReq(path="huge", buffer_stager=TrackingStager(data, cost=len(data)))]

    async def go():
        pending = await execute_write_reqs(write_reqs, plugin, memory_budget_bytes=10, rank=0)
        await pending.complete()

    asyncio.run(go())  # must not deadlock
    assert (tmp_path / "huge").read_bytes() == data


def test_staging_failure_propagates(tmp_path):
    plugin = FSStoragePlugin(root=str(tmp_path))
    write_reqs = [WriteReq(path="x", buffer_stager=FaultyStager())]

    async def go():
        pending = await execute_write_reqs(write_reqs, plugin, 1 << 30, rank=0)
        await pending.complete()

    with pytest.raises(RuntimeError, match="staging boom"):
        asyncio.run(go())


def test_storage_failure_propagates_on_complete(tmp_path):
    plugin = FaultyPlugin(root=str(tmp_path))
    write_reqs = [WriteReq(path="x", buffer_stager=TrackingStager(b"abc", cost=3))]

    async def go():
        pending = await execute_write_reqs(write_reqs, plugin, 1 << 30, rank=0)
        await pending.complete()

    with pytest.raises(OSError, match="storage boom"):
        asyncio.run(go())


def test_memory_budget_env_override():
    with override_memory_budget_bytes(12345):
        assert get_process_memory_budget_bytes() == 12345
    budget = get_process_memory_budget_bytes()
    assert 0 < budget <= 32 * 1024**3


def test_read_budget_gating(tmp_path):
    """Reads whose consuming cost is above the budget still complete (one
    at a time) and all data arrives."""
    plugin = FSStoragePlugin(root=str(tmp_path))
    blobs = {f"r{i}": _payload(200 + i, 500) for i in range(6)}
    loop = asyncio.new_event_loop()
    try:
        for k, v in blobs.items():
            plugin.sync_write(WriteIO(path=k, buf=v), event_loop=loop)
        sink = {}
        read_reqs = [
            ReadReq(path=k, buffer_consumer=ByteConsumer(sink, k, cost=400)) for k in blobs
        ]
        loop.run_until_complete(execute_read_reqs(read_reqs, plugin, 450, rank=0))
        assert sink == blobs
        stats = sched.LAST_EXECUTION_STATS["read"]
        assert stats["reqs"] == 6 and stats["bytes"] == 6 * 400
        assert stats["budget_bytes"] == 450
    finally:
        loop.close()


def test_reporter_stats_and_log_split(tmp_path, caplog, monkeypatch):
    """The final summary logs the staging-time vs total-time split,
    periodic reports carry per-stage pipeline counts and the budget left,
    and the split is published in LAST_EXECUTION_STATS."""
    monkeypatch.setattr(sched, "_REPORT_INTERVAL_SEC", 0.0)
    plugin = FSStoragePlugin(root=str(tmp_path))
    write_reqs = [
        WriteReq(path=f"w{i}", buffer_stager=TrackingStager(_payload(300 + i, 256), 256))
        for i in range(5)
    ]
    loop = asyncio.new_event_loop()
    try:
        with caplog.at_level(logging.INFO, logger="tpusnap_torch.scheduler"):
            pending = sync_execute_write_reqs(write_reqs, plugin, 10_000, rank=0, event_loop=loop)
            pending.sync_complete(loop)
    finally:
        loop.close()
    stats = sched.LAST_EXECUTION_STATS["write"]
    assert stats["reqs"] == 5
    assert stats["bytes"] == 5 * 256
    assert stats["staging_s"] is not None
    assert 0 <= stats["staging_s"] <= stats["total_s"]
    assert stats["budget_bytes"] == 10_000
    text = caplog.text
    assert "staging" in text and "residual I/O" in text
    # Per-stage counts and the budget appear in at least one periodic report.
    assert "ready_for_staging=" in text and "io=" in text
    assert "budget" in text and "rss delta" in text


def test_reporter_counts_skipped_writes_as_done_with_no_bytes(tmp_path):
    """A stager that returns SKIP_WRITE (deduplicated against a base) is
    a finished request with 0 bytes, and no file is written."""
    from tpusnap_torch.io_types import SKIP_WRITE

    class SkipStager(BufferStager):
        async def stage_buffer(self, executor=None):
            return SKIP_WRITE

        def get_staging_cost_bytes(self) -> int:
            return 64

    plugin = FSStoragePlugin(root=str(tmp_path))
    write_reqs = [WriteReq(path="skipped", buffer_stager=SkipStager())] + [
        WriteReq(path=f"w{i}", buffer_stager=TrackingStager(_payload(350 + i, 128), 128))
        for i in range(3)
    ]

    async def go():
        pending = await execute_write_reqs(write_reqs, plugin, 1 << 20, rank=0)
        await pending.complete()

    asyncio.run(go())
    stats = sched.LAST_EXECUTION_STATS["write"]
    assert stats["reqs"] == 4 and stats["bytes"] == 3 * 128
    assert not (tmp_path / "skipped").exists()


def test_pipelined_take_reports_blocked_window_and_stage_windows(tmp_path):
    """A pipelined write publishes ``blocked_s`` (the window control
    returned after) and how many staging windows it ran."""
    from tpusnap_torch.knobs import override_async_stage_window_bytes

    unit = 1000
    plugin = FSStoragePlugin(root=str(tmp_path))
    write_reqs = [
        WriteReq(path=f"p{i}", buffer_stager=TrackingStager(_payload(400 + i, unit), unit))
        for i in range(8)
    ]

    async def go():
        with override_async_stage_window_bytes(2 * unit):
            pending = await execute_write_reqs(
                write_reqs, plugin, 1 << 30, rank=0, pipelined_staging=True
            )
        await pending.complete()

    asyncio.run(go())
    stats = sched.LAST_EXECUTION_STATS["write"]
    assert stats["reqs"] == 8 and stats["bytes"] == 8 * unit
    assert stats["budget_bytes"] == 2 * unit
    assert stats["stage_windows"] == 4
    assert 0 <= stats["blocked_s"] <= stats["staging_s"] <= stats["total_s"]


@pytest.mark.parametrize("warm_pool", [False, True])
def test_pooled_buffers_do_not_permanently_debit_budget(tmp_path, warm_pool):
    """Buffers the staging pool keeps after a write do not withhold their
    budget credit: the budget governs in-flight buffers only (the pool has
    its own cap), so staging keeps overlapping storage I/O through the
    whole request list, from a cold pool and from a pre-warmed one (a
    checkpoint loop's second take)."""
    sp.clear()
    unit = 1 << 16
    n = 10
    spans = {}

    class PoolStager(BufferStager):
        def __init__(self, path: str):
            self.path = path

        async def stage_buffer(self, executor=None):
            spans[self.path] = [time.monotonic(), None]
            buf = sp.acquire(unit)
            await asyncio.sleep(0.003)
            return buf

        def get_staging_cost_bytes(self) -> int:
            return unit

    class SlowPlugin(FSStoragePlugin):
        async def write(self, write_io) -> None:
            await asyncio.sleep(0.02)
            await super().write(write_io)
            spans[write_io.path][1] = time.monotonic()

    if warm_pool:
        # Park unit-sized buffers, as a previous take would have.
        parked = [sp.acquire(unit) for _ in range(4)]
        for b in parked:
            assert sp.release(b) is True
        del parked

    plugin = SlowPlugin(root=str(tmp_path))
    write_reqs = [WriteReq(path=f"b{i}", buffer_stager=PoolStager(f"b{i}")) for i in range(n)]

    async def go():
        pending = await execute_write_reqs(
            write_reqs, plugin, memory_budget_bytes=2 * unit + unit // 2, rank=0
        )
        await pending.complete()

    try:
        asyncio.run(go())
    finally:
        sp.clear()

    assert all(e is not None for _, e in spans.values())
    # Only the second half (by stage start): a withheld credit is right
    # early and seizes up once retained bytes cross the budget.
    tail = sorted(spans.values())[n // 2 :]
    overlaps = sum(
        1
        for i, a in enumerate(tail)
        for j, b in enumerate(tail)
        if i != j and a[0] < b[1] and b[0] < a[1]
    )
    assert overlaps > 0, "budget-capped pooled take degraded to serialized stage-then-write"


def test_prioritize_staging_defers_io_until_staging_done(tmp_path):
    """No storage I/O starts while staging can still proceed; the writes
    drain through PendingIOWork after."""
    events = []

    class Stager(BufferStager):
        def __init__(self, data):
            self.data = data

        async def stage_buffer(self, executor=None):
            await asyncio.sleep(0.01)
            events.append(("stage", time.monotonic()))
            return self.data

        def get_staging_cost_bytes(self) -> int:
            return len(self.data)

    class Plugin(FSStoragePlugin):
        async def write(self, write_io) -> None:
            events.append(("write", time.monotonic()))
            await super().write(write_io)

    plugin = Plugin(root=str(tmp_path))
    write_reqs = [
        WriteReq(path=f"b{i}", buffer_stager=Stager(_payload(500 + i, 64))) for i in range(8)
    ]

    async def go():
        pending = await execute_write_reqs(
            write_reqs, plugin, 1 << 30, rank=0, prioritize_staging=True
        )
        assert not pending.scheduler.io_tasks  # nothing dispatched in the window
        assert len(pending.scheduler.ready_for_io) == 8
        await pending.complete()

    asyncio.run(go())
    last_stage = max(t for k, t in events if k == "stage")
    first_write = min(t for k, t in events if k == "write")
    assert first_write >= last_stage, "write started inside the staging window"
    assert sum(1 for k, _ in events if k == "write") == 8


def test_prioritize_staging_budget_starved_opens_io_gate(tmp_path):
    """When the budget cannot hold every staged buffer at once, the I/O
    gate opens mid-staging (write completions are the only budget
    source): writes interleave with staging, resident staged bytes stay
    within the budget plus the one over-budget admission, and the take
    completes."""
    unit = 1000
    events = []
    live = {"n": 0, "peak": 0}

    class Stager(BufferStager):
        def __init__(self, data):
            self.data = data

        async def stage_buffer(self, executor=None):
            await asyncio.sleep(0.005)
            live["n"] += 1
            live["peak"] = max(live["peak"], live["n"])
            events.append(("stage", time.monotonic()))
            return self.data

        def get_staging_cost_bytes(self) -> int:
            return unit

    class Plugin(FSStoragePlugin):
        async def write(self, write_io) -> None:
            events.append(("write", time.monotonic()))
            await super().write(write_io)
            live["n"] -= 1

    plugin = Plugin(root=str(tmp_path))
    write_reqs = [
        WriteReq(path=f"b{i}", buffer_stager=Stager(_payload(600 + i, unit))) for i in range(10)
    ]

    async def go():
        pending = await execute_write_reqs(
            write_reqs, plugin, memory_budget_bytes=2 * unit, rank=0, prioritize_staging=True
        )
        await pending.complete()

    asyncio.run(go())
    for i in range(10):
        assert (tmp_path / f"b{i}").exists()
    last_stage = max(t for k, t in events if k == "stage")
    first_write = min(t for k, t in events if k == "write")
    assert first_write < last_stage, "I/O gate never opened under starvation"
    assert live["peak"] <= 3, f"budget unenforced: peak {live['peak']} buffers resident"


@pytest.mark.parametrize("verb", ["write", "read"])
def test_execution_stats_match_tpusnap(tmp_path, verb):
    """The same requests through both schedulers publish stats with the
    same keys and the same request and byte counts."""
    from tpusnap import io_types as t_io
    from tpusnap import scheduler as t_sched
    from tpusnap.storage_plugins.fs import FSStoragePlugin as TFSStoragePlugin

    blobs = {f"x{i}": _payload(700 + i, 300 + 17 * i) for i in range(6)}

    def stager(base, data):
        class S(base):
            async def stage_buffer(self, executor=None):
                return data

            def get_staging_cost_bytes(self) -> int:
                return len(data)

        return S()

    def consumer(base, sink, key, cost):
        class C(base):
            async def consume_buffer(self, buf, executor=None) -> None:
                sink[key] = bytes(buf)

            def get_consuming_cost_bytes(self) -> int:
                return cost

        return C()

    def run(io, mod, plugin_cls, root):
        root.mkdir()
        plugin = plugin_cls(root=str(root))
        write_reqs = [
            io.WriteReq(path=k, buffer_stager=stager(io.BufferStager, v)) for k, v in blobs.items()
        ]
        sink = {}
        read_reqs = [
            io.ReadReq(path=k, buffer_consumer=consumer(io.BufferConsumer, sink, k, len(v)))
            for k, v in blobs.items()
        ]

        async def go():
            pending = await mod.execute_write_reqs(write_reqs, plugin, 1 << 20, rank=0)
            await pending.complete()
            await mod.execute_read_reqs(read_reqs, plugin, 1 << 20, rank=0)

        asyncio.run(go())
        assert sink == blobs
        return mod.LAST_EXECUTION_STATS[verb]

    ours = run(p_io, sched, FSStoragePlugin, tmp_path / "port")
    theirs = run(t_io, t_sched, TFSStoragePlugin, tmp_path / "ref")
    assert set(ours) == set(theirs)
    assert ours["reqs"] == theirs["reqs"] == len(blobs)
    assert ours["bytes"] == theirs["bytes"] == sum(len(v) for v in blobs.values())
    assert ours["budget_bytes"] == theirs["budget_bytes"] == 1 << 20
