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
import io
from concurrent.futures import Executor
from dataclasses import dataclass, field
from typing import Callable, Generic, Optional, Tuple, TypeVar, Union

BufferType = Union[bytes, bytearray, memoryview]

T = TypeVar("T")

# Namespace of library-owned files inside a snapshot (never blobs), and
# the directory the compression policy's write probe uses within it.
SIDECAR_PREFIX = ".tpusnap/"
PROBE_DIR = SIDECAR_PREFIX + "probe"


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

    async def flush_created_dirs(self) -> None:
        """Make the dirents of everything this plugin instance created
        durable (filesystems: fsync each created directory). Every rank
        calls it when ``TPUSNAP_DURABLE_COMMIT`` is on, after its writes
        drain and before the commit barrier."""
        return None

    async def close(self) -> None:
        return None

    def sync_flush_created_dirs(self, event_loop: asyncio.AbstractEventLoop) -> None:
        run_on_loop(event_loop, self.flush_created_dirs())

    def sync_write_atomic(
        self,
        write_io: WriteIO,
        event_loop: asyncio.AbstractEventLoop,
        durable: bool = False,
    ) -> None:
        run_on_loop(event_loop, self.write_atomic(write_io, durable=durable))

    def sync_read(
        self, read_io: ReadIO, event_loop: asyncio.AbstractEventLoop
    ) -> None:
        run_on_loop(event_loop, self.read(read_io))

    def sync_close(self, event_loop: asyncio.AbstractEventLoop) -> None:
        run_on_loop(event_loop, self.close())


def run_on_loop(event_loop: asyncio.AbstractEventLoop, coro):
    """``run_until_complete`` that cannot strand tasks on the loop: on an
    interrupt the top-level task is cancelled and drained before the
    exception propagates (the loop is reused across calls)."""
    task = event_loop.create_task(coro) if asyncio.iscoroutine(coro) else coro
    try:
        return event_loop.run_until_complete(task)
    except BaseException:
        task.cancel()
        try:
            event_loop.run_until_complete(task)
        except BaseException:
            pass
        raise
