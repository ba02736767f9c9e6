"""Async execution engine: budget-gated, pipelined staging and storage I/O.

Counterpart of tpusnap/scheduler.py for takes (sync and async) and the
restore, without the roofline probe and progress reporter. It records
tpusnap's spans (``stage_buffer``, ``checksum_late``, ``storage_write``,
``cow_verify``, ``budget_wait``, ``stage_window``, ``stage_blocked``,
``storage_read``, ``consume``) and counters (``storage.bytes_written``,
``scheduler.bytes_staged``, ...) into the take's or restore's
``telemetry`` recorder:

- Write path (``_WriteScheduler``): each WriteReq moves ready_for_staging
  → staging → ready_for_io → io → done; a stager that returns
  ``SKIP_WRITE`` (incremental dedup) is done after staging, with no I/O. Staging (device→host copy into
  pinned memory and serialization, on a thread pool) is dispatched only
  while the outstanding staging cost fits the memory budget — at least
  one request is always admitted so a single over-budget item cannot
  deadlock. Storage I/O keeps ≤16 requests in flight; checksums deferred
  to the write path and COW verifies run on their own pool, never
  queued behind staging. The engine stops at the take's blocked-window
  boundary and resumes (``PendingIOWork``) in the foreground for
  ``take`` or on a background thread for ``async_take``.
- Read path: read (≤16 in flight, budget-gated on consuming cost) ∥
  consume (deserialize + copy into the restore target, thread pool).
- Memory budget = min(0.6 × available host RAM / ranks on this host,
  32 GB), overridable by ``TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES``.
"""

from __future__ import annotations

import asyncio
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Set

from . import telemetry
from ._staging_pool import release
from .io_types import (
    SKIP_WRITE,
    BufferStager,
    ReadIO,
    ReadReq,
    StoragePlugin,
    WriteIO,
    WriteReq,
    run_on_loop,
)
from .knobs import (
    get_async_stage_window_bytes,
    get_memory_budget_override_bytes,
    get_stage_threads,
)

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


# Ranks sharing this host, stable for the life of a job: cached so that
# restore and read_object pay no collective for it (take passes it in from
# its first gather).
_cached_local_world_size: Optional[int] = None


def get_process_memory_budget_bytes(
    comm=None, local_world_size: Optional[int] = None
) -> int:
    """Host-memory budget for staging/consuming buffers of one process:
    the host's share divided by the ranks on this host. ``local_world_size``
    is passed by a caller that already gathered host names (take's first
    gather); otherwise it is found once per process with one host-name
    gather on ``comm`` and cached."""
    global _cached_local_world_size
    override = get_memory_budget_override_bytes()
    if override is not None:
        return override
    if local_world_size is not None:
        _cached_local_world_size = local_world_size
    elif _cached_local_world_size is not None:
        local_world_size = _cached_local_world_size
    elif comm is not None and comm.world_size > 1:
        from .knobs import get_node_name

        hostnames = comm.all_gather_object(get_node_name())
        local_world_size = hostnames.count(get_node_name())
        _cached_local_world_size = local_world_size
    else:
        local_world_size = 1
    budget = int(
        _available_host_memory_bytes() * _AVAILABLE_MEMORY_FRACTION / max(local_world_size, 1)
    )
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
        tele: Optional["telemetry.TakeTelemetry"] = None,
    ) -> None:
        self.write_req = write_req
        self.storage = storage
        self.tele = tele if tele is not None and tele.enabled else None
        self._counters = tele
        # Deferred checksums and COW verifies run on their own pool, never
        # queued behind staging tasks (they would stretch the blocked
        # window they were moved out of).
        self.hash_executor = hash_executor
        self.staging_cost = write_req.buffer_stager.get_staging_cost_bytes()
        self.buf = None
        self.buf_size = 0
        self.skipped = False

    async def stage(self, executor: ThreadPoolExecutor) -> "_WritePipeline":
        tele = self.tele
        start = tele.now() if tele is not None else 0.0
        token = tele.op_enter("stage_buffer") if tele is not None else None
        try:
            buf = await self.write_req.buffer_stager.stage_buffer(executor)
        finally:
            if tele is not None:
                tele.op_exit(token)
        if tele is not None:
            tele.record_span(
                "stage_buffer", start, tele.now() - start,
                path=self.write_req.path, bytes=self.staging_cost,
            )
        if buf is SKIP_WRITE:
            # Incremental dedup: the content is already persisted. No
            # storage I/O; the staging budget comes back at once.
            self.skipped = True
            telemetry.incr("scheduler.dedup_skipped", rec=self._counters)
            telemetry.incr(
                "scheduler.dedup_skipped_bytes",
                self.write_req.buffer_stager.get_planned_bytes(),
                rec=self._counters,
            )
            return self
        self.buf = buf
        self.buf_size = memoryview(self.buf).cast("B").nbytes
        return self

    async def write(self) -> "_WritePipeline":
        stager = self.write_req.buffer_stager
        tele = self.tele
        loop = asyncio.get_running_loop()
        late = getattr(stager, "late_checksum", None)
        if getattr(stager, "defer_checksums", False) and late is not None:
            # Deferred hashing: the checksum runs here, overlapping other
            # requests' disk time instead of occupying the staging window.
            # The staged buffer is stable: a pinned copy, a clone, or a
            # CPU tensor that a synchronous take does not let change (an
            # async take's COW stagers hashed at stage time).
            start = tele.now() if tele is not None else 0.0
            await loop.run_in_executor(self.hash_executor, late, self.buf)
            if tele is not None:
                tele.record_span(
                    "checksum_late", start, tele.now() - start, bytes=self.buf_size
                )
        start = tele.now() if tele is not None else 0.0
        token = tele.op_enter("storage_write") if tele is not None else None
        try:
            # A journaling storage layer hashes the buffer inside this
            # call, so its evidence is final before the buffer goes back
            # to the staging pool below.
            await self.storage.write(WriteIO(path=self.write_req.path, buf=self.buf))
        finally:
            if tele is not None:
                tele.op_exit(token)
        if tele is not None:
            tele.record_span(
                "storage_write", start, tele.now() - start,
                path=self.write_req.path, bytes=self.buf_size,
            )
        telemetry.incr("storage.bytes_written", self.buf_size, rec=self._counters)
        telemetry.incr("storage.writes", rec=self._counters)
        if getattr(stager, "cow_pending", False):
            # COW: the buffer just written IS the live tensor; re-hash it
            # against the stage-time value, failing the take on a change.
            start = tele.now() if tele is not None else 0.0
            await loop.run_in_executor(
                self.hash_executor, stager.verify_cow_after_write, self.buf
            )
            if tele is not None:
                tele.record_span(
                    "cow_verify", start, tele.now() - start, bytes=self.buf_size
                )
        # A clone goes back to the staging pool (other buffers are ignored).
        release(self.buf)
        self.buf = None  # release host memory
        return self


@dataclass
class PendingIOWork:
    """Work left when the blocked window closes: residual staging windows
    of a pipelined async take, then the storage I/O drain. ``complete``
    resumes the same engine under the same budget and caps."""

    scheduler: "_WriteScheduler"

    def staging_complete(self) -> bool:
        """Whether all staging is done (no buffer depends on live state)."""
        return self.scheduler.staging_complete

    def wait_staged(self, timeout: Optional[float] = None) -> bool:
        return self.scheduler.staging_done_event.wait(timeout)

    def drained(self) -> bool:
        """Whether every write (and COW verify) has finished: under COW,
        when the live bytes of CPU tensors stop being read."""
        return self.scheduler.drained_event.is_set()

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        return self.scheduler.drained_event.wait(timeout)

    async def complete(self) -> None:
        await self.scheduler.drain()

    def sync_complete(self, event_loop: asyncio.AbstractEventLoop) -> None:
        run_on_loop(event_loop, self.complete())

    def sync_cancel(self, event_loop: asyncio.AbstractEventLoop) -> None:
        """Cancel the staging and writes still in flight and wait for them
        to end (an aborting take does this before it deletes its blobs,
        so no write lands after the delete)."""
        run_on_loop(event_loop, self.scheduler._abort())


class _WriteScheduler:
    """Resumable budget-gated stage ∥ write engine behind every take
    (counterpart of tpusnap's, without its roofline probe, progress
    reporter and telemetry). ``run_blocked_window`` advances it to the
    take's blocked-window boundary on the calling thread; ``drain``
    resumes the same loop, possibly on another thread, until every
    request is staged and written. Three modes:

    - default (sync takes): the blocked window ends when staging is
      complete; staging and storage I/O overlap throughout.
    - ``prioritize_staging`` (strict async takes): the same boundary, but
      no storage I/O is dispatched while staging can proceed, except when
      staging is budget-starved (writes must land to free budget).
    - ``pipelined_staging`` (async takes): the in-flight staging budget is
      clamped to ``TPUSNAP_ASYNC_STAGE_WINDOW_BYTES`` and the blocked
      window ends once one window's worth is staged; the drain stages
      window N+1 while window N's writes hand buffers and budget back.
      The I/O gate is shut during the blocked window as in prioritize
      mode. ``stage_eagerly`` selects requests that must stage inside it
      (multi-process takes only; no single-process take sets it).
    """

    def __init__(
        self,
        write_reqs: List[WriteReq],
        storage: StoragePlugin,
        memory_budget_bytes: int,
        prioritize_staging: bool = False,
        pipelined_staging: bool = False,
        stage_eagerly: Optional[Callable[[WriteReq], bool]] = None,
        tele: Optional["telemetry.TakeTelemetry"] = None,
    ) -> None:
        self.storage = storage
        # Counters go to the take's recorder whatever the span knob says.
        self._counters = tele
        self.tele = tele if tele is not None and tele.enabled else None
        self._stage_phase_start = self.tele.now() if self.tele is not None else 0.0
        self._stall_start: Optional[float] = None
        self.prioritize_staging = prioritize_staging
        self.pipelined = pipelined_staging
        self.stage_concurrency = get_stage_threads()
        self.executor = ThreadPoolExecutor(
            max_workers=self.stage_concurrency, thread_name_prefix="tpusnap-torch-stage"
        )
        self.hash_executor = ThreadPoolExecutor(
            max_workers=_MAX_CPU_CONCURRENCY, thread_name_prefix="tpusnap-torch-hash"
        )
        pls = [_WritePipeline(wr, storage, self.hash_executor, tele) for wr in write_reqs]
        # Large first: they hold budget longest and their I/O overlaps the
        # staging of everything behind them. Eager requests lead.
        eager = stage_eagerly if self.pipelined and stage_eagerly is not None else None
        self.pipelines = deque(
            sorted(
                pls,
                key=lambda p: (not (eager and eager(p.write_req)), -p.staging_cost),
            )
        )
        self.eager_pending = {id(p) for p in pls if eager and eager(p.write_req)}
        total_cost = sum(p.staging_cost for p in pls)
        self.host_budget_bytes = memory_budget_bytes
        window = get_async_stage_window_bytes() if self.pipelined else None
        if window is not None:
            # The window IS the in-flight staging budget: resident staged
            # bytes never exceed it (plus the >=1 over-budget admission).
            memory_budget_bytes = min(memory_budget_bytes, window)
        self.memory_budget_bytes = memory_budget_bytes
        self.budget = memory_budget_bytes
        # The blocked window stages at least this much (everything, when
        # the state fits the window).
        self.first_window_target = min(memory_budget_bytes, total_cost)
        self.staging_tasks: Set[asyncio.Task] = set()
        self.io_tasks: Set[asyncio.Task] = set()
        self.ready_for_io: List[_WritePipeline] = []
        self.in_flight: Set[_WritePipeline] = set()
        self.staged_cost_total = 0
        # I/O gate of pipelined mode: shut in the blocked window, then open.
        self.blocked = self.pipelined
        self.staging_complete = False
        self.staging_done_event = threading.Event()
        self.drained_event = threading.Event()

    # --- dispatch ------------------------------------------------------

    def _dispatch_staging(self) -> None:
        while self.pipelines and len(self.staging_tasks) < self.stage_concurrency:
            head = self.pipelines[0]
            # The >=1 over-budget admission fires only when nothing in
            # flight (staged buffers awaiting I/O included) can free budget.
            in_flight = self.staging_tasks or self.io_tasks or self.ready_for_io
            if head.staging_cost > self.budget and in_flight:
                break
            self.pipelines.popleft()
            self.budget -= head.staging_cost
            if self.tele is not None:
                # High-water mark of the budget in use (it can exceed the
                # budget through the >=1 over-budget admission).
                self.tele.gauge_max(
                    "scheduler.budget_used_bytes", self.memory_budget_bytes - self.budget
                )
            self.in_flight.add(head)
            self.staging_tasks.add(asyncio.ensure_future(head.stage(self.executor)))

    def _io_gate_open(self) -> bool:
        if self.staging_complete:
            return True
        if self.pipelined:
            if not self.blocked:
                return True
        elif not self.prioritize_staging:
            return True
        # Blocked window / staging priority: open only while staging is
        # budget-starved (write completions are the only budget source).
        return bool(self.pipelines and not self.staging_tasks)

    def _dispatch_io(self) -> None:
        if not self._io_gate_open():
            return
        while self.ready_for_io and len(self.io_tasks) < _MAX_IO_CONCURRENCY:
            self.io_tasks.add(asyncio.ensure_future(self.ready_for_io.pop(0).write()))

    def _first_window_done(self) -> bool:
        return not self.eager_pending and self.staged_cost_total >= self.first_window_target

    def _note_stall(self) -> None:
        """One ``budget_wait`` span and counter per contiguous window in
        which the head request cannot be admitted."""
        starved = (
            bool(self.pipelines)
            and len(self.staging_tasks) < self.stage_concurrency
            and self.pipelines[0].staging_cost > self.budget
        )
        if starved:
            if self._stall_start is None:
                self._stall_start = self.tele.now() if self.tele is not None else 0.0
                telemetry.incr("scheduler.budget_waits", rec=self._counters)
        elif self._stall_start is not None:
            if self.tele is not None:
                self.tele.record_span(
                    "budget_wait", self._stall_start, self.tele.now() - self._stall_start
                )
            self._stall_start = None

    def _finish_staging(self) -> None:
        if not self.staging_complete:
            self.staging_complete = True
            if self.tele is not None:
                now = self.tele.now()
                if self._stall_start is not None:
                    self.tele.record_span(
                        "budget_wait", self._stall_start, now - self._stall_start
                    )
                self.tele.record_span(
                    "stage_window", self._stage_phase_start, now - self._stage_phase_start,
                    bytes=self.staged_cost_total,
                )
            self._stall_start = None
            self.staging_done_event.set()

    def unstaged_stagers(self) -> List[BufferStager]:
        """Stagers whose staging has not finished (queued or in flight)."""
        return [p.write_req.buffer_stager for p in (*self.pipelines, *self.in_flight)]

    # --- the loop ------------------------------------------------------

    async def _pump(self, stop_at_first_window: bool) -> None:
        self._dispatch_staging()
        while self.staging_tasks or self.pipelines:
            if stop_at_first_window and self._first_window_done():
                return
            self._note_stall()
            done, _ = await asyncio.wait(
                self.staging_tasks | self.io_tasks, return_when=asyncio.FIRST_COMPLETED
            )
            for task in done:
                pipeline = task.result()  # re-raises a failure
                if task in self.staging_tasks:
                    self.staging_tasks.discard(task)
                    self.in_flight.discard(pipeline)
                    # The staged buffer may be smaller than its cost.
                    self.budget += pipeline.staging_cost - pipeline.buf_size
                    self.eager_pending.discard(id(pipeline))
                    self.staged_cost_total += pipeline.staging_cost
                    telemetry.incr(
                        "scheduler.bytes_staged", pipeline.buf_size, rec=self._counters
                    )
                    if not pipeline.skipped:
                        self.ready_for_io.append(pipeline)
                else:
                    self.io_tasks.discard(task)
                    self.budget += pipeline.buf_size
            # Staging first: the I/O gate must see the refilled staging set.
            self._dispatch_staging()
            self._dispatch_io()
        self._finish_staging()

    async def _abort(self) -> None:
        await _cancel_and_drain(self.staging_tasks | self.io_tasks)
        self.executor.shutdown(wait=True)
        self.hash_executor.shutdown(wait=True)

    async def run_blocked_window(self) -> None:
        """Advance to the blocked-window boundary: staging complete, or
        first window staged (pipelined). In-flight tasks stay parked on
        the event loop for ``drain``."""
        try:
            await self._pump(stop_at_first_window=self.pipelined)
        except BaseException:
            await self._abort()
            raise
        if self.blocked and self.tele is not None:
            self.tele.record_span(
                "stage_blocked", self._stage_phase_start,
                self.tele.now() - self._stage_phase_start,
                staged_cost=self.staged_cost_total,
            )
        self.blocked = False  # the I/O gate opens for the drain

    async def stage_all(self) -> None:
        """Leave pipelined mode inside the blocked window: stage the rest
        now, with storage I/O only where staging is budget-starved, under
        the host budget (tpusnap's strict mode)."""
        self.pipelined = False
        self.prioritize_staging = True
        self.budget += self.host_budget_bytes - self.memory_budget_bytes
        self.memory_budget_bytes = self.host_budget_bytes
        await self.run_blocked_window()

    async def drain(self) -> None:
        """Resume to completion: residual staging windows (interleaved
        with their writes), then the storage I/O drain."""
        try:
            await self._pump(stop_at_first_window=False)
            while self.io_tasks or self.ready_for_io:
                self._dispatch_io()
                done, _ = await asyncio.wait(
                    self.io_tasks, return_when=asyncio.FIRST_COMPLETED
                )
                for task in done:
                    self.io_tasks.discard(task)
                    self.budget += task.result().buf_size
        except BaseException:
            await self._abort()
            raise
        finally:
            self.executor.shutdown(wait=True)
            self.hash_executor.shutdown(wait=True)
        self.drained_event.set()


async def execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    prioritize_staging: bool = False,
    pipelined_staging: bool = False,
    stage_eagerly: Optional[Callable[[WriteReq], bool]] = None,
) -> PendingIOWork:
    """Run the write engine to its blocked-window boundary and hand the
    rest back as :class:`PendingIOWork`: ``take`` drains it in the
    foreground, ``async_take`` on a background thread."""
    sched = _WriteScheduler(
        write_reqs,
        storage,
        memory_budget_bytes,
        prioritize_staging=prioritize_staging,
        pipelined_staging=pipelined_staging,
        stage_eagerly=stage_eagerly,
        tele=telemetry.current(),
    )
    await sched.run_blocked_window()
    return PendingIOWork(scheduler=sched)


def sync_execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    event_loop: asyncio.AbstractEventLoop,
    prioritize_staging: bool = False,
    pipelined_staging: bool = False,
    stage_eagerly: Optional[Callable[[WriteReq], bool]] = None,
) -> PendingIOWork:
    return run_on_loop(
        event_loop,
        execute_write_reqs(
            write_reqs,
            storage,
            memory_budget_bytes,
            prioritize_staging=prioritize_staging,
            pipelined_staging=pipelined_staging,
            stage_eagerly=stage_eagerly,
        ),
    )


class _ReadPipeline:
    def __init__(
        self,
        read_req: ReadReq,
        storage: StoragePlugin,
        tele: Optional["telemetry.TakeTelemetry"] = None,
    ) -> None:
        self.read_req = read_req
        self.storage = storage
        self._counters = tele
        self.tele = tele if tele is not None and tele.enabled else None
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
        tele = self.tele
        start = tele.now() if tele is not None else 0.0
        token = tele.op_enter("storage_read") if tele is not None else None
        try:
            await self.storage.read(self.read_io)
        finally:
            if tele is not None:
                tele.op_exit(token)
        nbytes = self._read_nbytes()
        if tele is not None:
            tele.record_span(
                "storage_read", start, tele.now() - start,
                path=self.read_req.path, bytes=nbytes,
            )
        telemetry.incr("storage.bytes_read", nbytes, rec=self._counters)
        telemetry.incr("storage.reads", rec=self._counters)
        return self

    def _read_nbytes(self) -> int:
        rio = self.read_io
        if rio.byte_range is not None:
            return int(rio.byte_range[1] - rio.byte_range[0])
        if rio.in_place and rio.into is not None:
            return memoryview(rio.into).nbytes
        try:
            return rio.buf.getbuffer().nbytes
        except Exception:
            return 0

    async def consume(self, executor: ThreadPoolExecutor) -> "_ReadPipeline":
        tele = self.tele
        start = tele.now() if tele is not None else 0.0
        token = tele.op_enter("consume") if tele is not None else None
        try:
            await self.read_req.buffer_consumer.consume_read_io(self.read_io, executor)
        finally:
            if tele is not None:
                tele.op_exit(token)
        if tele is not None:
            tele.record_span(
                "consume", start, tele.now() - start,
                path=self.read_req.path, bytes=self.consuming_cost,
            )
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
    tele = telemetry.current()
    pipelines = deque(
        sorted(
            (_ReadPipeline(rr, storage, tele) for rr in read_reqs),
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
        # Cancelling a task does not stop its executor work: a cloud
        # plugin's thread may still be writing into a caller-owned
        # in-place destination. Wait it out before the error reaches the
        # caller.
        await asyncio.get_running_loop().run_in_executor(None, storage.drain_in_flight)
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
