"""Async execution engine: budget-gated, pipelined staging and storage I/O.

Counterpart of tpusnap/scheduler.py for takes (sync and async) and the
restore. It records tpusnap's spans
(``stage_buffer``, ``checksum_late``, ``storage_write``, ``cow_verify``,
``budget_wait``, ``stage_window``, ``stage_blocked``, ``storage_read``,
``consume``, ``probe_roofline``) and counters (``storage.bytes_written``,
``scheduler.bytes_staged``, ``probe.probes``, ...) into the take's or
restore's ``telemetry`` recorder, and every read into the ambient
``access`` ledger:

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
- Roofline probes (``TPUSNAP_PROBE=1``, ``_ProbeRunner``): between I/O
  windows, never inside an async take's blocked window and never beside
  blob I/O, a few raw streams are written and read back through the
  operation's own plugin stack; each sample feeds the compression
  policy's pipe ceiling.
- Progress reporter (``_Reporter``): every ``_REPORT_INTERVAL_SEC`` a log
  line with the per-stage pipeline counts, the budget left and the RSS
  delta; at the end a summary with the staging-versus-total split, also
  published in ``LAST_EXECUTION_STATS`` under ``"write"`` or ``"read"``.
  It adds no span and no counter.
- Memory budget = min(0.6 × available host RAM / ranks on this host,
  32 GB), overridable by ``TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES``.
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Set

from . import access, flight, telemetry
from ._staging_pool import release
from .io_types import (
    SKIP_WRITE,
    PROBE_DIR,
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
    is_probe_enabled,
)
from .rss_profiler import current_rss_bytes

logger = logging.getLogger(__name__)

_MAX_IO_CONCURRENCY = 16
_MAX_CPU_CONCURRENCY = max(1, min(4, os.cpu_count() or 4))
_MAX_PER_RANK_MEMORY_BUDGET_BYTES = 32 * 1024 * 1024 * 1024
_AVAILABLE_MEMORY_FRACTION = 0.6
_REPORT_INTERVAL_SEC = 10.0


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


# Stats of the last finished write or read execution in this process, keyed
# by verb ("write"/"read"): benchmarks and tests read the staging-time vs
# total-time split here instead of parsing logs.
LAST_EXECUTION_STATS: dict = {}


class _Reporter:
    """Periodic pipeline progress logging: per-stage pipeline counts, RSS
    delta, budget left, and a staging-time vs total-time summary — what
    tells a staging-bound pipeline from an I/O-bound one."""

    def __init__(self, rank: int, verb: str, total_reqs: int) -> None:
        self.rank = rank
        self.verb = verb
        self.total_reqs = total_reqs
        self.begin_ts = time.monotonic()
        self.last_report_ts = self.begin_ts
        self.bytes_done = 0
        self.reqs_done = 0
        self.rss_begin = current_rss_bytes()
        self.staging_done_ts: Optional[float] = None
        # Live pipeline-stage counts, set by the execution loop.
        self.stage_counts: dict = {}
        self.budget_remaining: Optional[int] = None
        self.total_budget: Optional[int] = None
        # Wall clock of the blocked window (control returned to the
        # caller) and, for pipelined takes, the staging windows run.
        self.blocked_done_ts: Optional[float] = None
        self.stage_windows: Optional[int] = None

    def mark_staging_complete(self) -> None:
        if self.staging_done_ts is None:
            self.staging_done_ts = time.monotonic()

    def mark_blocked_window_done(self) -> None:
        if self.blocked_done_ts is None:
            self.blocked_done_ts = time.monotonic()

    def report_request_done(self, nbytes: int) -> None:
        self.reqs_done += 1
        self.bytes_done += nbytes
        now = time.monotonic()
        if now - self.last_report_ts >= _REPORT_INTERVAL_SEC:
            self.last_report_ts = now
            rss_delta = current_rss_bytes() - self.rss_begin
            counts = " ".join(f"{k}={v}" for k, v in self.stage_counts.items())
            budget = (
                f", budget {self.budget_remaining / 1e9:.1f}/"
                f"{self.total_budget / 1e9:.1f} GB free"
                if self.budget_remaining is not None and self.total_budget is not None
                else ""
            )
            logger.info(
                "Rank %d: %s %d/%d reqs [%s done=%d], %.2f GB, %.1f MB/s, "
                "rss delta %.0f MB%s",
                self.rank,
                self.verb,
                self.reqs_done,
                self.total_reqs,
                counts,
                self.reqs_done,
                self.bytes_done / 1e9,
                self.bytes_done / 1e6 / max(now - self.begin_ts, 1e-9),
                rss_delta / 1e6,
                budget,
            )

    def summarize(self) -> None:
        elapsed = max(time.monotonic() - self.begin_ts, 1e-9)
        staging_elapsed = (
            max(self.staging_done_ts - self.begin_ts, 0.0)
            if self.staging_done_ts is not None
            else None
        )
        stats = {
            "reqs": self.reqs_done,
            "bytes": self.bytes_done,
            "total_s": elapsed,
            "staging_s": staging_elapsed,
            "throughput_mbps": self.bytes_done / 1e6 / elapsed,
            "budget_bytes": self.total_budget,
        }
        if self.blocked_done_ts is not None:
            stats["blocked_s"] = max(self.blocked_done_ts - self.begin_ts, 0.0)
        if self.stage_windows is not None:
            stats["stage_windows"] = self.stage_windows
        LAST_EXECUTION_STATS[self.verb] = stats
        if staging_elapsed is not None:
            # The number async_take exists to minimize: training is
            # blocked only for the staging window, not the I/O drain.
            logger.info(
                "Rank %d: %s complete: %d reqs, %.2f GB in %.2fs "
                "(%.1f MB/s); staging %.2fs / residual I/O %.2fs",
                self.rank,
                self.verb,
                self.reqs_done,
                self.bytes_done / 1e9,
                elapsed,
                self.bytes_done / 1e6 / elapsed,
                staging_elapsed,
                elapsed - staging_elapsed,
            )
        else:
            logger.info(
                "Rank %d: %s complete: %d reqs, %.2f GB in %.2fs (%.1f MB/s)",
                self.rank,
                self.verb,
                self.reqs_done,
                self.bytes_done / 1e9,
                elapsed,
                self.bytes_done / 1e6 / elapsed,
            )


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


class _ProbeRunner:
    """In-take/in-restore roofline probes (``TPUSNAP_PROBE=1``):
    between I/O windows — once per TPUSNAP_PROBE_INTERVAL_BYTES of
    payload traffic, while no blob I/O is in flight — write (then read
    back, then delete) TPUSNAP_PROBE_BYTES of raw data through the
    operation's OWN storage plugin stack, across a few concurrent
    streams, and record the aggregate throughput as a probe sample.
    Each sample times BOTH legs: the take's summary derives
    ``roofline_fraction`` from the write leg, the restore's
    ``restore_roofline_fraction`` from the read leg — ceilings measured
    seconds (not minutes) from the I/O they judge, immune to the
    multi-minute drift of a disk measured in a separate session. On the
    restore side the probe
    still writes its own scratch (the snapshot's blobs are immutable),
    under ``.tpusnap/probe/`` (journal-exempt sidecar space; a crash's
    leftovers are orphan-visible to fsck/gc). Failures never fail the
    take or restore — a failed probe is one missing sample."""

    _STREAMS = 4

    def __init__(
        self,
        storage: StoragePlugin,
        rank: int,
        tele: "telemetry.TakeTelemetry",
    ) -> None:
        from .knobs import get_probe_bytes, get_probe_interval_bytes

        self.storage = storage
        self.rank = rank
        self.tele = tele
        self.interval_bytes = get_probe_interval_bytes()
        self.stream_bytes = max(get_probe_bytes() // self._STREAMS, 1 << 20)
        self.bytes_since_probe = 0
        self.ran = 0
        self._buf: Optional[memoryview] = None
        self._failed = False
        from . import compress as _compress

        try:
            # Same device/bucket-scoped key the auto policy looks up —
            # NOT the bare class label (two fs:// mounts with different
            # bandwidth must not share a ceiling sample).
            self._label = _compress.pipe_ceiling_key(storage)
        except Exception:
            self._label = ""

    @property
    def due(self) -> bool:
        return not self._failed and self.bytes_since_probe >= self.interval_bytes

    def note_written(self, nbytes: int) -> None:
        self.bytes_since_probe += nbytes

    def _buffer(self) -> memoryview:
        if self._buf is None:
            # Random-ish payload (tiled 1 MiB urandom block): constant
            # fill could be flattered by host-side image compression
            # and would not match what the take writes.
            block = os.urandom(1 << 20)
            reps = (self.stream_bytes + len(block) - 1) // len(block)
            self._buf = memoryview(block * reps)[: self.stream_bytes]
        return self._buf

    def _path(self, i: int) -> str:
        return f"{PROBE_DIR}/rank_{self.rank}_{i}.bin"

    async def run(self) -> None:
        """One probe segment. Caller guarantees no blob I/O in flight
        (the scheduler parks its I/O gate until the window drains), so
        the sample measures the engine, not contention with the take."""
        self.bytes_since_probe = 0
        start = self.tele.now()
        nbytes = self.stream_bytes * self._STREAMS
        try:
            buf = self._buffer()
            paths = [self._path(i) for i in range(self._STREAMS)]
            t0 = time.monotonic()
            await asyncio.gather(
                *(self.storage.write(WriteIO(path=p, buf=buf)) for p in paths)
            )
            write_s = time.monotonic() - t0
            t0 = time.monotonic()
            await asyncio.gather(
                *(self.storage.read(ReadIO(path=p)) for p in paths)
            )
            read_s = time.monotonic() - t0
            await asyncio.gather(
                *(self.storage.delete(p) for p in paths),
                return_exceptions=True,
            )
        except Exception:
            # One WARNING, then stand down for this take: a backend
            # that cannot take probe traffic must not eat a retry storm.
            # Best-effort cleanup of any stream that did land (a
            # leftover would only be orphan debris for gc, but tidy is
            # cheaper than debris).
            self._failed = True
            logger.warning(
                "Rank %d: in-take roofline probe failed (non-fatal; "
                "disabled for the rest of this take)",
                self.rank,
                exc_info=True,
            )
            try:
                await asyncio.gather(
                    *(
                        self.storage.delete(self._path(i))
                        for i in range(self._STREAMS)
                    ),
                    return_exceptions=True,
                )
            except Exception:
                pass
            return
        elapsed = self.tele.now() - start
        sample = {
            "write_gbps": round(nbytes / max(write_s, 1e-9) / 1e9, 4),
            "read_gbps": round(nbytes / max(read_s, 1e-9) / 1e9, 4),
            "bytes": nbytes,
            "elapsed_s": round(elapsed, 6),
        }
        self.ran += 1
        # Feed the compression auto policy's ceiling registry: every
        # probe sample keeps the pipe ceiling a live measurement, so
        # the next take's compress-or-bypass decision is current.
        from . import compress as _compress

        _compress.note_pipe_ceiling(self._label, sample["write_gbps"])
        _compress.note_pipe_ceiling(
            self._label, sample["read_gbps"], lane="read"
        )
        self.tele.add_probe_sample(sample)
        self.tele.record_span("probe_roofline", start, elapsed, **sample)
        telemetry.incr("probe.probes", rec=self.tele)
        telemetry.incr("probe.bytes_written", nbytes, rec=self.tele)
        flight.record(
            "probe",
            write_gbps=sample["write_gbps"],
            read_gbps=sample["read_gbps"],
            bytes=nbytes,
        )


class _WriteScheduler:
    """Resumable budget-gated stage ∥ write engine behind every take
    (counterpart of tpusnap's). ``run_blocked_window`` advances it to the
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
        rank: int = 0,
    ) -> None:
        self.storage = storage
        # In-take roofline probes: with an enabled recorder (their whole
        # output is telemetry) and the opt-in knob.
        self.probe: Optional[_ProbeRunner] = (
            _ProbeRunner(storage, rank, tele)
            if tele is not None and tele.enabled and is_probe_enabled()
            else None
        )
        self.reporter = _Reporter(rank=rank, verb="write", total_reqs=len(write_reqs))
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
        self.reporter.total_budget = memory_budget_bytes
        # The blocked window stages at least this much (everything, when
        # the state fits the window).
        self.first_window_target = min(memory_budget_bytes, total_cost)
        self.staging_tasks: Set[asyncio.Task] = set()
        self.io_tasks: Set[asyncio.Task] = set()
        self.ready_for_io: List[_WritePipeline] = []
        self.in_flight: Set[_WritePipeline] = set()
        self.staged_cost_total = 0
        # Pipelined staging windows: one closes each time a budget's worth
        # of staging cost has been staged (the blocked window is the first).
        self._window_index = 0
        self._window_accum = 0
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

    def _probe_may_run(self) -> bool:
        # Never inside a pipelined take's blocked window: a probe there
        # would bill its I/O to the time async_take blocks training.
        return self.probe is not None and self.probe.due and not self.blocked

    def _dispatch_io(self) -> None:
        if self._probe_may_run():
            # Park new blob I/O: the in-flight window drains, the loop
            # runs the probe against an idle engine, then reopens.
            return
        if not self._io_gate_open():
            return
        while self.ready_for_io and len(self.io_tasks) < _MAX_IO_CONCURRENCY:
            self.io_tasks.add(asyncio.ensure_future(self.ready_for_io.pop(0).write()))

    async def _maybe_probe(self) -> None:
        """Run one due probe segment while no blob write is in flight."""
        if self._probe_may_run() and not self.io_tasks:
            await self.probe.run()

    def _note_written(self, pipeline: "_WritePipeline") -> None:
        self.budget += pipeline.buf_size
        if self.probe is not None:
            self.probe.note_written(pipeline.buf_size)
        self.reporter.report_request_done(pipeline.buf_size)

    def _update_reporter(self) -> None:
        self.reporter.stage_counts = {
            "ready_for_staging": len(self.pipelines),
            "staging": len(self.staging_tasks),
            "ready_for_io": len(self.ready_for_io),
            "io": len(self.io_tasks),
        }
        self.reporter.budget_remaining = self.budget

    def _on_staged(self, pipeline: "_WritePipeline") -> None:
        self.staged_cost_total += pipeline.staging_cost
        if self.pipelined:
            self._window_accum += pipeline.staging_cost
            if self._window_accum >= self.memory_budget_bytes:
                self._close_window()

    def _close_window(self) -> None:
        if self._window_accum > 0:
            self._window_index += 1
            self._window_accum = 0

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
            self.reporter.mark_staging_complete()
            if self.pipelined:
                self._close_window()
                self.reporter.stage_windows = max(self._window_index, 1)
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
                    self._on_staged(pipeline)
                    telemetry.incr(
                        "scheduler.bytes_staged", pipeline.buf_size, rec=self._counters
                    )
                    if pipeline.skipped:
                        # Deduplicated against a base snapshot: no I/O.
                        self.reporter.report_request_done(0)
                    else:
                        self.ready_for_io.append(pipeline)
                else:
                    self.io_tasks.discard(task)
                    self._note_written(pipeline)
            # Staging first: the I/O gate must see the refilled staging set.
            self._dispatch_staging()
            await self._maybe_probe()
            self._dispatch_io()
            self._update_reporter()
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
        self.reporter.mark_blocked_window_done()
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
        self.reporter.total_budget = self.host_budget_bytes
        self.reporter.blocked_done_ts = None  # the window now closes here
        await self.run_blocked_window()

    async def drain(self) -> None:
        """Resume to completion: residual staging windows (interleaved
        with their writes), then the storage I/O drain."""
        try:
            await self._pump(stop_at_first_window=False)
            while self.io_tasks or self.ready_for_io:
                await self._maybe_probe()
                self._dispatch_io()
                done, _ = await asyncio.wait(
                    self.io_tasks, return_when=asyncio.FIRST_COMPLETED
                )
                for task in done:
                    self.io_tasks.discard(task)
                    self._note_written(task.result())
                self._update_reporter()
            if (
                self.probe is not None
                and self.probe.ran == 0
                and not self.probe._failed
                and self.reporter.bytes_done > 0
            ):
                # A take smaller than the probe interval still gets one
                # sample: every probe-enabled take measures its ceiling.
                await self.probe.run()
        except BaseException:
            await self._abort()
            raise
        finally:
            self.executor.shutdown(wait=True)
            self.hash_executor.shutdown(wait=True)
        self.drained_event.set()
        self.reporter.summarize()


async def execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    prioritize_staging: bool = False,
    pipelined_staging: bool = False,
    stage_eagerly: Optional[Callable[[WriteReq], bool]] = None,
    rank: int = 0,
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
        rank=rank,
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
    rank: int = 0,
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
            rank=rank,
        ),
    )


class _ReadPipeline:
    def __init__(
        self,
        read_req: ReadReq,
        storage: StoragePlugin,
        tele: Optional["telemetry.TakeTelemetry"] = None,
        ledger: Optional["access.AccessLedger"] = None,
    ) -> None:
        self.read_req = read_req
        self.storage = storage
        self.ledger = ledger
        self.read_nbytes = 0
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
        self.read_nbytes = nbytes
        if tele is not None:
            tele.record_span(
                "storage_read", start, tele.now() - start,
                path=self.read_req.path, bytes=nbytes,
            )
        telemetry.incr("storage.bytes_read", nbytes, rec=self._counters)
        telemetry.incr("storage.reads", rec=self._counters)
        self._record_access(nbytes)
        return self

    def _record_access(self, nbytes: int) -> None:
        """Attribute this read to its manifest leaf (or, for a merged
        spanning read, to each member leaf) in the ambient access
        ledger. A plugin that redirected the read stamped its source
        tier on the ReadIO."""
        ledger = self.ledger
        if ledger is None:
            return
        rr = self.read_req
        source = self.read_io.source if self.read_io is not None else None
        if rr.access_parts:
            for lp, start, end in rr.access_parts:
                ledger.record(lp, rr.path, start, end, end - start, source)
            return
        if not rr.logical_path:
            return
        start, end = rr.byte_range if rr.byte_range else (0, nbytes)
        ledger.record(rr.logical_path, rr.path, start, end, nbytes, source)

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
    rank: int = 0,
) -> None:
    executor = ThreadPoolExecutor(
        max_workers=_MAX_CPU_CONCURRENCY, thread_name_prefix="tpusnap-torch-consume"
    )
    reporter = _Reporter(rank=rank, verb="read", total_reqs=len(read_reqs))
    reporter.total_budget = memory_budget_bytes
    tele = telemetry.current()
    # The ambient access ledger (the restore and read_object scopes
    # install one); None turns attribution off for this call.
    ledger = access.current()
    pipelines = deque(
        sorted(
            (_ReadPipeline(rr, storage, tele, ledger) for rr in read_reqs),
            key=lambda p: p.consuming_cost,
            reverse=True,
        )
    )
    budget = memory_budget_bytes
    read_tasks: Set[asyncio.Task] = set()
    consume_tasks: Set[asyncio.Task] = set()
    # In-restore roofline probes: the write side's runner, its cadence
    # counted in payload bytes read. Its own scratch streams go under
    # PROBE_DIR, never beside blob reads, and cost no memory budget.
    probe = (
        _ProbeRunner(storage, rank, tele)
        if tele is not None and tele.enabled and is_probe_enabled()
        else None
    )
    bytes_read = 0

    def dispatch_reads() -> None:
        nonlocal budget
        while pipelines and len(read_tasks) < _MAX_IO_CONCURRENCY:
            if probe is not None and probe.due:
                # Park new reads until the window drains and the probe
                # has run: probe traffic beside blob reads would corrupt
                # both the sample and the storage_read spans.
                break
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
                    bytes_read += pipeline.read_nbytes
                    if probe is not None:
                        probe.note_written(pipeline.read_nbytes)
                    consume_tasks.add(
                        asyncio.ensure_future(pipeline.consume(executor))
                    )
                else:
                    consume_tasks.discard(task)
                    budget += pipeline.consuming_cost
                    reporter.report_request_done(pipeline.consuming_cost)
            if probe is not None and probe.due and not read_tasks:
                # The read window drained (consumes are host work and do
                # not touch the pipe): take the sample, then go on.
                await probe.run()
            dispatch_reads()
            reporter.stage_counts = {
                "ready_for_read": len(pipelines),
                "read": len(read_tasks),
                "consume": len(consume_tasks),
            }
            reporter.budget_remaining = budget
        if probe is not None and probe.ran == 0 and not probe._failed and bytes_read > 0:
            # A restore smaller than the probe interval still measures once.
            await probe.run()
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
    reporter.summarize()


def sync_execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    event_loop: asyncio.AbstractEventLoop,
    rank: int = 0,
) -> None:
    run_on_loop(
        event_loop, execute_read_reqs(read_reqs, storage, memory_budget_bytes, rank=rank)
    )
