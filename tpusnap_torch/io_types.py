"""Core I/O abstractions: write/read requests, stagers/consumers, and the
StoragePlugin ABC.

Counterpart of tpusnap/io_types.py, reduced to what the port's
take/restore path uses:

- ``WriteReq``  = storage path + ``BufferStager`` (produces bytes, e.g. by
  a device→host copy into pinned memory).
- ``ReadReq``   = storage path + optional byte range + ``BufferConsumer``
  (deserializes into the restore target in place).
- ``WriteIO``/``ReadIO`` = the physical request handed to a storage plugin.
- ``StoragePlugin`` = async write/read/delete/close + sync shims.

Staging/consuming cost models drive the scheduler's memory budget.
"""

from __future__ import annotations

import abc
import asyncio
import contextlib
import io
import threading
from concurrent.futures import Executor
from dataclasses import dataclass, field
from typing import Callable, Generic, Optional, Tuple, TypeVar, Union

BufferType = Union[bytes, bytearray, memoryview]

T = TypeVar("T")

# Namespace of library-owned files inside a snapshot (never blobs), and
# the canonical sidecar paths under it (docs/format.md): every layer that
# writes or classifies sidecar traffic imports these.
SIDECAR_PREFIX = ".tpusnap/"
JOURNAL_FNAME = SIDECAR_PREFIX + "journal"  # rank 0's take marker
JOURNAL_RECORDS_DIR = SIDECAR_PREFIX + "journal.d"  # per-rank evidence
PROGRESS_DIR = SIDECAR_PREFIX + "progress"  # heartbeat records
TELEMETRY_DIR = SIDECAR_PREFIX + "telemetry"  # per-rank Chrome traces
PROBE_DIR = SIDECAR_PREFIX + "probe"  # compression policy's write probe
FLIGHT_DIR = SIDECAR_PREFIX + "flight"  # flight-recorder event logs
# Write-back tiering (``tiering``): the upload journal a tiered take
# keeps in its local tier — per-blob CRC32C+XXH64 evidence of what is
# proven remote, and the durability state ("pending", "durable").
UPLOAD_JOURNAL_PATH = SIDECAR_PREFIX + "upload_journal"
# Content-addressed store (``cas``): per-rank ref records a CAS-composed
# snapshot keeps instead of private payload copies (manifest location ->
# (nbytes, CRC32C, XXH64), the shared blob's key).
CAS_REFS_DIR = SIDECAR_PREFIX + "cas_refs"


class _SkipWrite:
    """Sentinel a stager may return instead of bytes: the blob's content
    is already persisted (incremental dedup — the stager re-pointed its
    entry at the base snapshot's blob), so the request completes with no
    storage I/O."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "SKIP_WRITE"


SKIP_WRITE = _SkipWrite()


class Future(Generic[T]):
    """Completion cell for values materialized during read execution."""

    def __init__(self, obj: Optional[T] = None) -> None:
        self.obj = obj


@dataclass
class WriteIO:
    path: str
    buf: BufferType


@dataclass
class ReadIO:
    path: str
    byte_range: Optional[Tuple[int, int]] = None
    buf: io.BytesIO = field(default_factory=io.BytesIO)
    # In-place read: when ``into`` is set, the plugin lands the bytes in
    # this writable buffer (the restore target's memory, or its pinned
    # host staging buffer) and sets ``in_place``. With ``want_crc`` it
    # also reports the checksum of the delivered bytes, computed inside
    # the native read.
    into: Optional[memoryview] = None
    want_crc: bool = False
    in_place: bool = False
    crc32c: Optional[int] = None
    crc_algo: Optional[str] = None
    # Where a redirected read's bytes came from: "cas" for a read the
    # content-addressed layer served from the shared store,
    # "evicted-read-through" for a tiered local miss served by the
    # remote. None for ordinary reads.
    source: Optional[str] = None


class BufferStager(abc.ABC):
    # Whether the bytes this stager will stage no longer depend on memory
    # the caller may change in place after an async take returns.
    frozen = False

    @abc.abstractmethod
    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        """Produce the bytes to persist (may run device→host copies in
        ``executor``), or ``SKIP_WRITE`` when the content is already
        persisted and this request needs no storage I/O."""

    @abc.abstractmethod
    def get_staging_cost_bytes(self) -> int:
        """Peak host memory consumed while this buffer is staged."""

    def get_planned_bytes(self) -> int:
        """Payload bytes this request will stage and write (the progress
        denominator); stagers whose cost exceeds the payload override it."""
        return self.get_staging_cost_bytes()


@dataclass
class WriteReq:
    path: str
    buffer_stager: BufferStager


class BufferConsumer(abc.ABC):
    @abc.abstractmethod
    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        """Deserialize ``buf`` into the restore target."""

    @abc.abstractmethod
    def get_consuming_cost_bytes(self) -> int:
        """Peak host memory consumed while this buffer is being consumed."""

    async def consume_read_io(
        self, read_io: ReadIO, executor: Optional[Executor] = None
    ) -> None:
        """Consume a completed ReadIO; consumers whose reads may land in
        place override this to skip the deserialize+copy pass."""
        await self.consume_buffer(read_io.buf.getbuffer(), executor)


@dataclass
class ReadReq:
    path: str
    buffer_consumer: BufferConsumer
    byte_range: Optional[Tuple[int, int]] = None
    # Destination for an in-place read: the restore target's own memory,
    # or a callable that allocates a staging buffer when the read is
    # dispatched (a pinned buffer for a CUDA target).
    into: Union[memoryview, Callable[[], memoryview], None] = None
    want_crc: bool = False


class StoragePlugin(abc.ABC):
    """Storage backend. Implementations must be safe for many concurrent
    coroutines (the scheduler keeps up to 16 requests in flight)."""

    # Plugins that honor ReadIO.into set this True; the scheduler then
    # charges such reads only the plugin's transient overhead.
    supports_in_place_reads: bool = False

    def in_place_read_overhead_bytes(self, nbytes: int) -> int:
        return nbytes

    # Middleware markers the scheme registry reads
    # (``storage_plugin.url_to_storage_plugin``): ``wants_retry_middleware``
    # asks for the whole-op retry wrapper (``retry``);
    # ``handles_own_retries`` marks plugins that retry at a finer grain
    # themselves (gcs, per chunk) and must not be wrapped twice.
    wants_retry_middleware: bool = False
    handles_own_retries: bool = False

    def _submit_tracked(self, executor, fn):
        """Run ``fn`` on ``executor``, tracked for ``drain_in_flight``:
        plugins route thread-offloaded work that writes into caller-owned
        buffers through this."""
        inflight = self.__dict__.setdefault("_tracked_inflight", set())
        future = executor.submit(fn)
        inflight.add(future)
        future.add_done_callback(inflight.discard)
        return asyncio.wrap_future(future)

    def drain_in_flight(self) -> None:
        """Block until the worker-thread I/O offloaded through
        ``_submit_tracked`` has finished: cancelling a task does not stop
        its executor work, which may still be writing into an in-place
        destination after an aborted read."""
        import concurrent.futures

        pending = list(self.__dict__.get("_tracked_inflight", ()))
        if pending:
            concurrent.futures.wait(pending)

    def classify_transient(self, exc: BaseException) -> bool:
        """Whether ``exc`` from this backend is worth retrying."""
        from .retry import default_classify_transient

        return default_classify_transient(exc)

    @abc.abstractmethod
    async def write(self, write_io: WriteIO) -> None: ...

    async def write_atomic(self, write_io: WriteIO, durable: bool = False) -> None:
        """Write that either fully lands or leaves any existing object
        untouched (filesystem plugins: temp file + rename). ``durable``
        also makes it survive power loss once this returns (callers that
        rewrite committed metadata ask for it)."""
        await self.write(write_io)

    @abc.abstractmethod
    async def read(self, read_io: ReadIO) -> None: ...

    @abc.abstractmethod
    async def delete(self, path: str) -> None: ...

    async def list_with_sizes(self) -> Optional[dict]:
        """``{relative_path: size_bytes}`` of every object under the root,
        or None when the backend cannot list (fsck's orphan scan, gc and
        salvage need it)."""
        return None

    async def flush_created_dirs(self) -> None:
        """Make the dirents of everything this plugin instance created
        durable (filesystems: fsync each created directory). Every rank
        calls it when ``TPUSNAP_DURABLE_COMMIT`` is on, after its writes
        drain and before the commit barrier."""
        return None

    async def close(self) -> None:
        return None

    def sync_flush_created_dirs(
        self, event_loop: Optional[asyncio.AbstractEventLoop] = None
    ) -> None:
        _run(self.flush_created_dirs(), event_loop)

    def sync_write(
        self, write_io: WriteIO, event_loop: Optional[asyncio.AbstractEventLoop] = None
    ) -> None:
        _run(self.write(write_io), event_loop)

    def sync_write_atomic(
        self,
        write_io: WriteIO,
        event_loop: Optional[asyncio.AbstractEventLoop] = None,
        durable: bool = False,
    ) -> None:
        _run(self.write_atomic(write_io, durable=durable), event_loop)

    def sync_read(
        self, read_io: ReadIO, event_loop: Optional[asyncio.AbstractEventLoop] = None
    ) -> None:
        _run(self.read(read_io), event_loop)

    def sync_delete(
        self, path: str, event_loop: Optional[asyncio.AbstractEventLoop] = None
    ) -> None:
        _run(self.delete(path), event_loop)

    def sync_list_with_sizes(
        self, event_loop: Optional[asyncio.AbstractEventLoop] = None
    ) -> Optional[dict]:
        return _run(self.list_with_sizes(), event_loop)

    def sync_close(self, event_loop: Optional[asyncio.AbstractEventLoop] = None) -> None:
        _run(self.close(), event_loop)


# Joining a thread from a GC finalizer can deadlock (the collection may
# run inside a starting thread's ``Thread._set_tstate_lock``, which holds
# the lock the join's ``_stop`` takes again). Explicit closes join — an
# aborting take relies on close to quiesce its I/O threads — and only the
# finalizer path opts out, through this thread-local flag.
_finalizer_close = threading.local()


@contextlib.contextmanager
def finalizer_close_scope():
    """Mark plugin ``close()`` calls on this thread as finalizer-driven:
    executor shutdowns and worker joins are skipped."""
    prior = getattr(_finalizer_close, "active", False)
    _finalizer_close.active = True
    try:
        yield
    finally:
        _finalizer_close.active = prior


def close_may_join() -> bool:
    """Whether a ``close()`` may join threads (False only inside
    :func:`finalizer_close_scope`)."""
    return not getattr(_finalizer_close, "active", False)


def shutdown_plugin_executor(executor) -> None:
    """Join a plugin's thread pool on an explicit close (no straggler
    write survives the close that an aborting take's deletes follow); a
    finalizer-driven close does not wait."""
    executor.shutdown(wait=close_may_join())


def run_on_loop(event_loop: asyncio.AbstractEventLoop, coro):
    """``run_until_complete`` that cannot strand tasks on the loop: on an
    interrupt the top-level task is cancelled and drained before the
    exception propagates (the loop is reused across calls)."""
    task = event_loop.create_task(coro) if asyncio.iscoroutine(coro) else coro
    try:
        return event_loop.run_until_complete(task)
    except BaseException as exc:
        task.cancel()
        try:
            event_loop.run_until_complete(task)
        except BaseException:
            pass
        _release_loop_frames(exc.__traceback__)
        raise
    finally:
        task = None  # noqa: F841


def _release_loop_frames(tb) -> None:
    """A failed task holds its exception, whose traceback holds the
    finished asyncio frames that hold the task: a cycle that keeps every
    caller frame's locals (a take's staged buffers and CUDA tensors)
    alive until the cyclic collector runs, also when the caller catches
    an expected miss (a fresh path has no journal to read). Clearing the
    locals of those finished frames breaks it; the traceback still names
    their lines."""
    while tb is not None:
        frame = tb.tb_frame
        if frame.f_globals.get("__name__", "").startswith("asyncio."):
            try:
                frame.clear()
            except RuntimeError:
                pass  # still executing
        tb = tb.tb_next


def _run(coro, event_loop: Optional[asyncio.AbstractEventLoop]):
    if event_loop is not None:
        return run_on_loop(event_loop, coro)
    return asyncio.run(coro)
