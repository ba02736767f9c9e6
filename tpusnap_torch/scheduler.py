"""Async execution engine: budget-gated, pipelined staging and storage I/O.

Counterpart of tpusnap/scheduler.py for the single-process synchronous
take and the restore, without the roofline probe, progress reporter and
flight-recorder hooks:

- Write path: each WriteReq moves ready_for_staging → staging →
  ready_for_io → io → done. Staging (device→host copy into pinned memory
  and serialization, on a thread pool) is dispatched only while the
  outstanding staging cost fits the memory budget — at least one request
  is always admitted so a single over-budget item cannot deadlock.
  Storage I/O keeps ≤16 requests in flight; checksums deferred to the
  write path run on their own pool, never queued behind staging.
- Read path: read (≤16 in flight, budget-gated on consuming cost) ∥
  consume (deserialize + copy into the restore target, thread pool).
- Memory budget = min(0.6 × available host RAM, 32 GB), overridable by
  ``TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES``.
"""

from __future__ import annotations

import asyncio
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Set

from .io_types import ReadIO, ReadReq, StoragePlugin, WriteIO, WriteReq, run_on_loop
from .knobs import get_memory_budget_override_bytes, get_stage_threads

_MAX_IO_CONCURRENCY = 16
_MAX_CPU_CONCURRENCY = max(1, min(4, os.cpu_count() or 4))
_MAX_PER_RANK_MEMORY_BUDGET_BYTES = 32 * 1024 * 1024 * 1024
_AVAILABLE_MEMORY_FRACTION = 0.6


def _available_host_memory_bytes() -> int:
    """``MemAvailable`` from /proc/meminfo (free pages elsewhere)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def get_process_memory_budget_bytes() -> int:
    """Host-memory budget for staging/consuming buffers of one process."""
    override = get_memory_budget_override_bytes()
    if override is not None:
        return override
    budget = int(_available_host_memory_bytes() * _AVAILABLE_MEMORY_FRACTION)
    return min(budget, _MAX_PER_RANK_MEMORY_BUDGET_BYTES)


async def _cancel_and_drain(tasks: Set[asyncio.Task]) -> None:
    for task in tasks:
        task.cancel()
    if tasks:
        await asyncio.gather(*tasks, return_exceptions=True)


class _WritePipeline:
    def __init__(
        self,
        write_req: WriteReq,
        storage: StoragePlugin,
        hash_executor: ThreadPoolExecutor,
    ) -> None:
        self.write_req = write_req
        self.storage = storage
        self.hash_executor = hash_executor
        self.staging_cost = write_req.buffer_stager.get_staging_cost_bytes()
        self.buf = None
        self.buf_size = 0

    async def stage(self, executor: ThreadPoolExecutor) -> "_WritePipeline":
        self.buf = await self.write_req.buffer_stager.stage_buffer(executor)
        self.buf_size = memoryview(self.buf).cast("B").nbytes
        return self

    async def write(self) -> "_WritePipeline":
        stager = self.write_req.buffer_stager
        late = getattr(stager, "late_checksum", None)
        if getattr(stager, "defer_checksums", False) and late is not None:
            # Deferred hashing: the checksum runs here, overlapping other
            # requests' disk time instead of occupying the staging window.
            # The staged buffer is stable (pinned copy or the caller's
            # CPU tensor, which a synchronous take does not let change).
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(self.hash_executor, late, self.buf)
        await self.storage.write(WriteIO(path=self.write_req.path, buf=self.buf))
        self.buf = None  # release host memory
        return self


async def execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
) -> None:
    """Stage and write every request, staging overlapped with storage
    I/O under the memory budget. Returns when every write has landed."""
    executor = ThreadPoolExecutor(
        max_workers=get_stage_threads(), thread_name_prefix="tpusnap-torch-stage"
    )
    hash_executor = ThreadPoolExecutor(
        max_workers=_MAX_CPU_CONCURRENCY, thread_name_prefix="tpusnap-torch-hash"
    )
    stage_concurrency = get_stage_threads()
    # Large first: they hold budget longest and their I/O overlaps the
    # staging of everything behind them.
    pipelines = deque(
        sorted(
            (_WritePipeline(wr, storage, hash_executor) for wr in write_reqs),
            key=lambda p: p.staging_cost,
            reverse=True,
        )
    )
    budget = memory_budget_bytes
    staging_tasks: Set[asyncio.Task] = set()
    io_tasks: Set[asyncio.Task] = set()
    ready_for_io: List[_WritePipeline] = []

    def dispatch() -> None:
        nonlocal budget
        while pipelines and len(staging_tasks) < stage_concurrency:
            head = pipelines[0]
            # The over-budget admission fires only when nothing in flight
            # can free budget.
            if head.staging_cost > budget and (
                staging_tasks or io_tasks or ready_for_io
            ):
                break
            pipelines.popleft()
            budget -= head.staging_cost
            staging_tasks.add(asyncio.ensure_future(head.stage(executor)))
        while ready_for_io and len(io_tasks) < _MAX_IO_CONCURRENCY:
            io_tasks.add(asyncio.ensure_future(ready_for_io.pop(0).write()))

    try:
        dispatch()
        while staging_tasks or io_tasks or pipelines or ready_for_io:
            done, _ = await asyncio.wait(
                staging_tasks | io_tasks, return_when=asyncio.FIRST_COMPLETED
            )
            for task in done:
                pipeline = task.result()  # re-raises a failure
                if task in staging_tasks:
                    staging_tasks.discard(task)
                    # The staged buffer may be smaller than its cost.
                    budget += pipeline.staging_cost - pipeline.buf_size
                    ready_for_io.append(pipeline)
                else:
                    io_tasks.discard(task)
                    budget += pipeline.buf_size
            dispatch()
    except BaseException:
        await _cancel_and_drain(staging_tasks | io_tasks)
        raise
    finally:
        executor.shutdown(wait=True)
        hash_executor.shutdown(wait=True)


def sync_execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    event_loop: asyncio.AbstractEventLoop,
) -> None:
    run_on_loop(
        event_loop, execute_write_reqs(write_reqs, storage, memory_budget_bytes)
    )


class _ReadPipeline:
    def __init__(self, read_req: ReadReq, storage: StoragePlugin) -> None:
        self.read_req = read_req
        self.storage = storage
        # Reads landing in the caller's own memory allocate no full-size
        # scratch buffer, so they are charged only the plugin's transient
        # overhead. A callable ``into`` allocates a staging buffer (pinned
        # memory for a CUDA target) when the read is dispatched, and is
        # charged in full.
        cost = read_req.buffer_consumer.get_consuming_cost_bytes()
        if (
            isinstance(read_req.into, memoryview)
            and storage.supports_in_place_reads
        ):
            cost = min(cost, storage.in_place_read_overhead_bytes(cost))
        self.consuming_cost = cost
        self.read_io: Optional[ReadIO] = None

    async def read(self) -> "_ReadPipeline":
        into = self.read_req.into
        self.read_io = ReadIO(
            path=self.read_req.path,
            byte_range=self.read_req.byte_range,
            into=into() if callable(into) else into,
            want_crc=self.read_req.want_crc,
        )
        await self.storage.read(self.read_io)
        return self

    async def consume(self, executor: ThreadPoolExecutor) -> "_ReadPipeline":
        await self.read_req.buffer_consumer.consume_read_io(self.read_io, executor)
        self.read_io = None  # release
        return self


async def execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
) -> None:
    executor = ThreadPoolExecutor(
        max_workers=_MAX_CPU_CONCURRENCY, thread_name_prefix="tpusnap-torch-consume"
    )
    pipelines = deque(
        sorted(
            (_ReadPipeline(rr, storage) for rr in read_reqs),
            key=lambda p: p.consuming_cost,
            reverse=True,
        )
    )
    budget = memory_budget_bytes
    read_tasks: Set[asyncio.Task] = set()
    consume_tasks: Set[asyncio.Task] = set()

    def dispatch_reads() -> None:
        nonlocal budget
        while pipelines and len(read_tasks) < _MAX_IO_CONCURRENCY:
            head = pipelines[0]
            if head.consuming_cost > budget and (read_tasks or consume_tasks):
                break
            pipelines.popleft()
            budget -= head.consuming_cost
            read_tasks.add(asyncio.ensure_future(head.read()))

    try:
        dispatch_reads()
        while read_tasks or consume_tasks or pipelines:
            done, _ = await asyncio.wait(
                read_tasks | consume_tasks, return_when=asyncio.FIRST_COMPLETED
            )
            for task in done:
                pipeline = task.result()
                if task in read_tasks:
                    read_tasks.discard(task)
                    consume_tasks.add(
                        asyncio.ensure_future(pipeline.consume(executor))
                    )
                else:
                    consume_tasks.discard(task)
                    budget += pipeline.consuming_cost
            dispatch_reads()
    except BaseException:
        await _cancel_and_drain(read_tasks | consume_tasks)
        raise
    finally:
        executor.shutdown(wait=True)


def sync_execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    event_loop: asyncio.AbstractEventLoop,
) -> None:
    run_on_loop(
        event_loop, execute_read_reqs(read_reqs, storage, memory_budget_bytes)
    )
