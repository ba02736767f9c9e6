"""Dense-tensor IO preparer — the inner loop of every snapshot.

Counterpart of tpusnap/io_preparers/array.py, with the port's own device
staging. What differs from tpusnap and why:

- **Staging (take).** tpusnap enqueues ``copy_to_host_async`` and lets
  ``np.asarray`` block. Here ``enqueue_dtoh`` issues a ``non_blocking``
  copy into a *pinned* host buffer on a side CUDA stream, ordered after
  an event recorded on the caller's stream when the write was prepared
  (so the bytes are the state as of ``take``), and records a
  ``torch.cuda.Event`` after the copy. ``_stage_blocking`` synchronises
  that event BEFORE it computes a checksum or hands the buffer to
  storage: without the wait the CRC would be taken over bytes that have
  not landed yet. The copy is enqueued when staging starts, so pinned
  memory in use stays under the scheduler's memory budget. CPU tensors
  stage as a zero-copy ``.numpy()`` view, as tpusnap stages numpy arrays.
- **Restore.** tpusnap ``device_put``s a fresh array. Torch tensors are
  mutable, so the bytes land IN PLACE: a CPU target of the stored dtype
  and shape receives the read directly in its own memory; a CUDA target
  gets a pinned host buffer (allocated when its read is dispatched) and
  then ``target.copy_(host, non_blocking=True)`` under ``torch.no_grad``
  on a side stream, synchronised before the consume step returns — and
  so before ``restore`` returns. The target object is never replaced, so
  an ``nn.Parameter`` keeps its identity (and its optimizer references)
  across a restore. Non-contiguous targets and dtype-casting restores go
  through ``copy_``, which writes through the target's strides. A CUDA
  target of another shape is replaced by a new tensor on its device, as
  tpusnap ``device_put``s onto the target's sharding.
- Tile-grain checksums, the fused read-time checksum and budget-tiled
  reads are kept as in tpusnap. Compressed blobs are not ported yet.
"""

from __future__ import annotations

import asyncio
import math
from concurrent.futures import Executor
from typing import Callable, List, Optional, Tuple, Union

import torch

from .. import _native
from ..io_types import (
    BufferConsumer,
    BufferStager,
    BufferType,
    Future,
    ReadReq,
    WriteReq,
)
from ..knobs import get_tile_checksum_bytes, is_checksum_disabled
from ..manifest import TensorEntry
from ..serialization import (
    Serializer,
    dtype_to_string,
    string_to_dtype,
    tensor_as_bytes,
    tensor_as_memoryview,
    tensor_from_memoryview,
    tensor_nbytes,
)

_HASH_THREADS = 4


def array_nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def is_supported_array_dtype(t: torch.Tensor) -> bool:
    try:
        dtype_to_string(t.dtype)
        return True
    except ValueError:
        return False


def _record_ready(t: torch.Tensor) -> Optional["torch.cuda.Event"]:
    """An event on the caller's current stream: device work that must
    finish before the snapshot copies this tensor (take) or overwrites
    it (restore). None for CPU tensors."""
    if not t.is_cuda:
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return event


def enqueue_dtoh(
    t: torch.Tensor, ready: Optional["torch.cuda.Event"]
) -> Tuple[torch.Tensor, "torch.cuda.Event"]:
    """Start the device→host copy of ``t``'s bytes into a pinned buffer
    on a side stream; returns ``(pinned_u8, done_event)``. The caller
    must ``done_event.synchronize()`` before reading the buffer."""
    stream = torch.cuda.Stream(device=t.device)
    host = torch.empty(array_nbytes(t), dtype=torch.uint8, pin_memory=True)
    with torch.cuda.stream(stream):
        if ready is not None:
            stream.wait_event(ready)
        # A non-contiguous source is compacted here, on the side stream,
        # after the ready event.
        host.copy_(tensor_as_bytes(t), non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return host, done


def stage_to_host(t: torch.Tensor, ready: Optional["torch.cuda.Event"]) -> memoryview:
    """The bytes of ``t`` in host memory, safe to hash and write."""
    if array_nbytes(t) == 0:
        return memoryview(b"")
    if not t.is_cuda:
        return tensor_as_memoryview(t)
    host, done = enqueue_dtoh(t, ready)
    done.synchronize()
    return memoryview(host.numpy())


class ArrayBufferStager(BufferStager):
    def __init__(self, arr: torch.Tensor, entry: Optional[TensorEntry] = None) -> None:
        self.arr = arr
        # Manifest entry annotated with the checksums; the metadata is
        # encoded after every write has landed, so the values reach it.
        self.entry = entry
        # Set by the take after batching: hash on the write path
        # (``late_checksum``) instead of inside the staging window.
        self.defer_checksums = False
        self.ready = _record_ready(arr)

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        if executor is not None:
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(executor, self._stage_blocking)
        return self._stage_blocking()

    def _stage_blocking(self) -> BufferType:
        mv = stage_to_host(self.arr, self.ready)
        if (
            self.entry is not None
            and not is_checksum_disabled()
            and not self.defer_checksums
        ):
            _record_checksums(self.entry, mv)
        return mv

    def late_checksum(self, buf) -> None:
        """Record checksums from the STAGED buffer (write path)."""
        if self.entry is None or is_checksum_disabled() or self.entry.checksum:
            return
        _record_checksums(self.entry, memoryview(buf).cast("B"))

    def get_staging_cost_bytes(self) -> int:
        return array_nbytes(self.arr)


# ------------------------------------------------------------- checksums


def _want_crc(entry: TensorEntry) -> bool:
    return entry.checksum is not None and not is_checksum_disabled()


def _tile_lengths(nbytes: int, tile_nbytes: int, n_tiles: int) -> List[int]:
    return [
        min((i + 1) * tile_nbytes, nbytes) - i * tile_nbytes
        for i in range(n_tiles)
    ]


def _fold_crcs(crcs: List[int], lengths: List[int]) -> int:
    """Combine per-tile seed-0 CRC values into the CRC of the
    concatenation."""
    combined = crcs[0] & 0xFFFFFFFF
    for c, ln in zip(crcs[1:], lengths[1:]):
        combined = _native.crc_combine(combined, c & 0xFFFFFFFF, ln)
    return combined & 0xFFFFFFFF


def _tile_geometry(entry: TensorEntry, nbytes: int) -> Tuple[int, int]:
    """(tile_rows, row_nbytes) for tile-grain checksums, tile_rows == 0
    when the blob gets one whole-blob value — tpusnap's geometry, so both
    packages record identical manifests for identical tensors."""
    shape = entry.shape
    n_rows = shape[0] if shape else 0
    row_nbytes = nbytes // n_rows if n_rows else 0
    tile_rows = (
        max(1, get_tile_checksum_bytes() // row_nbytes) if row_nbytes else 0
    )
    if n_rows > tile_rows >= 1:
        return tile_rows, row_nbytes
    return 0, row_nbytes


# Tile-less blobs at or below this size record their 64-bit dedup hash on
# every take, as tpusnap does.
_DEDUP_HASH_EAGER_MAX = 64 << 20
_XXH_MASK = (1 << 64) - 1


def _annotate_checksums(
    entry: TensorEntry,
    tile_crcs: List[int],
    tile_rows: int,
    row_nbytes: int,
    whole_xxh: Optional[int] = None,
) -> None:
    algo = _native.checksum_algorithm()
    if tile_rows:
        n_rows = entry.shape[0]
        combined = _fold_crcs(
            tile_crcs,
            _tile_lengths(
                n_rows * row_nbytes, tile_rows * row_nbytes, len(tile_crcs)
            ),
        )
        entry.tile_rows = tile_rows
        entry.tile_checksums = [
            f"{algo}:{crc & 0xFFFFFFFF:08x}" for crc in tile_crcs
        ]
        entry.checksum = f"{algo}:{combined:08x}"
    else:
        entry.checksum = f"{algo}:{tile_crcs[0] & 0xFFFFFFFF:08x}"
        if whole_xxh is not None:
            dalgo = _native.dedup_hash_algorithm()
            entry.dedup_hash = f"{dalgo}:{whole_xxh & _XXH_MASK:016x}"


def _record_checksums(entry: TensorEntry, mv: memoryview) -> None:
    """Record integrity checksums into ``entry``: row-tile CRCs combined
    into the whole-blob value for large blobs (the verifiable unit of a
    budget-tiled read), one CRC plus the 64-bit dedup hash otherwise."""
    tile_rows, row_nbytes = _tile_geometry(entry, mv.nbytes)
    if tile_rows:
        n_rows = entry.shape[0]
        crcs = [
            _native.crc32c(
                mv[r0 * row_nbytes : min(r0 + tile_rows, n_rows) * row_nbytes]
            )
            for r0 in range(0, n_rows, tile_rows)
        ]
        _annotate_checksums(entry, crcs, tile_rows, row_nbytes)
        return
    if mv.nbytes <= _DEDUP_HASH_EAGER_MAX:
        crcs, xxhs = _native.crc_xxh_tiles(mv, mv.nbytes, nthreads=_HASH_THREADS)
        _annotate_checksums(entry, crcs, 0, row_nbytes, whole_xxh=xxhs[0])
        return
    _annotate_checksums(entry, [_native.crc32c(mv)], 0, row_nbytes)


def combined_tile_checksum(
    entry: TensorEntry, r0: int, r1: int, row_nbytes: int
) -> Optional[str]:
    """Expected checksum of rows [r0, r1) derived from recorded tile
    checksums, or None when the range is not verifiable."""
    t = entry.tile_rows
    if not entry.tile_checksums or not t:
        return None
    n_rows = entry.shape[0]
    if r0 % t != 0 or (r1 != n_rows and r1 % t != 0):
        return None
    algo = _native.checksum_algorithm()
    crcs: List[int] = []
    lengths: List[int] = []
    for i in range(r0 // t, math.ceil(r1 / t)):
        tile_algo, _, value = entry.tile_checksums[i].partition(":")
        if tile_algo != algo:
            return None
        try:
            crcs.append(int(value, 16))
        except ValueError:
            return None
        lengths.append((min((i + 1) * t, n_rows) - i * t) * row_nbytes)
    if not crcs:
        return None
    return f"{algo}:{_fold_crcs(crcs, lengths):08x}"


def _maybe_verify(buf: BufferType, checksum: Optional[str], location: str) -> None:
    if checksum is None or is_checksum_disabled():
        return
    _native.verify_checksum(memoryview(buf).cast("B"), checksum, location)


def _verify_read_time_crc(read_io, checksum: Optional[str], location: str) -> None:
    if checksum is not None and read_io.crc32c is not None:
        _native.verify_checksum_value(
            read_io.crc32c, read_io.crc_algo, checksum, location
        )


# ---------------------------------------------------------------- restore


def _copy_into_target(target: torch.Tensor, host: torch.Tensor, ready) -> None:
    """Copy a host tensor into ``target`` in place (casting to its dtype,
    through its strides). CUDA targets copy on a side stream ordered
    after ``ready`` and are synchronised before returning."""
    with torch.no_grad():
        if not target.is_cuda:
            target.copy_(host)
            return
        stream = torch.cuda.Stream(device=target.device)
        with torch.cuda.stream(stream):
            if ready is not None:
                stream.wait_event(ready)
            target.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()


def finalize_into_target(
    host: torch.Tensor,
    obj_out: Optional[torch.Tensor],
    owns_memory: bool,
    ready=None,
) -> torch.Tensor:
    """Land a deserialized host tensor in the restore target:

    - a target of the same shape is filled IN PLACE (cast to its dtype
      when it differs, on its device);
    - a CUDA target of another shape gets a new tensor on ITS device at
      the stored dtype, as tpusnap ``device_put``s onto the target's
      sharding: the state stays on the card;
    - otherwise a CPU tensor owning its memory is returned
      (``owns_memory`` says whether ``host`` already does)."""
    if isinstance(obj_out, torch.Tensor) and tuple(obj_out.shape) == tuple(host.shape):
        _copy_into_target(obj_out, host, ready)
        return obj_out
    if isinstance(obj_out, torch.Tensor) and obj_out.is_cuda:
        # From pageable memory the copy has finished when ``to`` returns,
        # so ``host`` may alias a read buffer that is released next.
        return host.to(obj_out.device)
    return host if owns_memory else host.clone()


def writable_byte_view(
    t: Optional[torch.Tensor], dtype: str, shape
) -> Optional[memoryview]:
    """Flat writable byte view over a CPU tensor when the stored blob's
    bytes may land there verbatim: contiguous, exact dtype and shape."""
    if not isinstance(t, torch.Tensor) or t.is_cuda or not t.is_contiguous():
        return None
    if t.dtype != string_to_dtype(dtype) or list(t.shape) != list(shape):
        return None
    if t.numel() == 0:
        return None
    return memoryview(tensor_as_bytes(t).numpy())


def _is_exact_cuda_target(t, dtype: str, shape) -> bool:
    return (
        isinstance(t, torch.Tensor)
        and t.is_cuda
        and t.dtype == string_to_dtype(dtype)
        and list(t.shape) == list(shape)
        and t.numel() > 0
    )


class ArrayBufferConsumer(BufferConsumer):
    """Deserializes into the restore target. CPU targets receive the read
    in their own memory; CUDA targets receive it in a pinned buffer that
    is then copied into them in place (see the module docstring)."""

    def __init__(
        self,
        entry: TensorEntry,
        obj_out: Optional[torch.Tensor],
        fut: Future,
        verify_location: str = "",
    ) -> None:
        self.entry = entry
        self.obj_out = obj_out
        self.fut = fut
        self.verify_location = verify_location or entry.location
        self.ready = (
            _record_ready(obj_out) if isinstance(obj_out, torch.Tensor) else None
        )
        self._pinned: Optional[torch.Tensor] = None
        self.into: Union[memoryview, Callable[[], memoryview], None] = (
            writable_byte_view(obj_out, entry.dtype, entry.shape)
        )
        if self.into is None and _is_exact_cuda_target(
            obj_out, entry.dtype, entry.shape
        ):
            self.into = self._pinned_destination

    def _pinned_destination(self) -> memoryview:
        """Allocated when the read is dispatched, so pinned memory in use
        stays under the read budget."""
        nbytes = tensor_nbytes(self.entry.dtype, self.entry.shape)
        self._pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return memoryview(self._pinned.numpy())

    async def consume_read_io(self, read_io, executor: Optional[Executor] = None) -> None:
        if not read_io.in_place:
            await self.consume_buffer(read_io.buf.getbuffer(), executor)
            return
        _verify_read_time_crc(read_io, self.entry.checksum, self.verify_location)
        if self._pinned is not None:
            pinned, self._pinned = self._pinned, None
            if self.obj_out.is_contiguous():
                dst = tensor_as_bytes(self.obj_out)
            else:
                dst = self.obj_out
                pinned = pinned.view(self.obj_out.dtype).reshape(self.obj_out.shape)
            await _run(executor, _copy_into_target, dst, pinned, self.ready)
        self.fut.obj = self.obj_out

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        await _run(executor, self._consume_blocking, buf)

    def _consume_blocking(self, buf: BufferType) -> None:
        _maybe_verify(buf, self.entry.checksum, self.verify_location)
        host = tensor_from_memoryview(memoryview(buf), self.entry.dtype, self.entry.shape)
        # ``host`` aliases the read buffer, which is released next.
        self.fut.obj = finalize_into_target(host, self.obj_out, False, self.ready)

    def get_consuming_cost_bytes(self) -> int:
        return tensor_nbytes(self.entry.dtype, self.entry.shape)


async def _run(executor: Optional[Executor], fn, *args):
    if executor is None:
        return fn(*args)
    return await asyncio.get_running_loop().run_in_executor(executor, fn, *args)


class ArrayIOPreparer:
    """prepare_write/prepare_read for dense (single-blob) tensors."""

    @staticmethod
    def prepare_write(
        storage_path: str, arr: torch.Tensor, replicated: bool = False
    ) -> Tuple[TensorEntry, List[WriteReq]]:
        entry = TensorEntry(
            location=storage_path,
            serializer=Serializer.BUFFER_PROTOCOL.value,
            dtype=dtype_to_string(arr.dtype),
            shape=list(arr.shape),
            replicated=replicated,
        )
        stager = ArrayBufferStager(arr, entry=entry)
        return entry, [WriteReq(path=storage_path, buffer_stager=stager)]

    @staticmethod
    def prepare_read(
        entry: TensorEntry,
        obj_out: Optional[torch.Tensor] = None,
        buffer_size_limit_bytes: Optional[int] = None,
        logical_path: str = "",
    ) -> Tuple[List[ReadReq], Future]:
        if entry.codec:
            raise NotImplementedError(
                f"{logical_path or entry.location!r} is stored compressed "
                f"({entry.codec}); compressed reads are not ported yet "
                "(ROADMAP.md item A3)"
            )
        fut: Future = Future()
        nbytes = tensor_nbytes(entry.dtype, entry.shape)
        if (
            buffer_size_limit_bytes is not None
            and nbytes > buffer_size_limit_bytes
            and len(entry.shape) > 0
            and entry.shape[0] > 1
        ):
            return ArrayIOPreparer._prepare_tiled_read(
                entry, obj_out, buffer_size_limit_bytes, fut, logical_path
            )
        byte_range = tuple(entry.byte_range) if entry.byte_range is not None else None
        consumer = ArrayBufferConsumer(
            entry, obj_out, fut, verify_location=logical_path
        )
        return [
            ReadReq(
                path=entry.location,
                byte_range=byte_range,
                buffer_consumer=consumer,
                into=consumer.into,
                want_crc=consumer.into is not None and _want_crc(entry),
            )
        ], fut

    @staticmethod
    def _prepare_tiled_read(
        entry: TensorEntry,
        obj_out: Optional[torch.Tensor],
        buffer_size_limit_bytes: int,
        fut: Future,
        logical_path: str = "",
    ) -> Tuple[List[ReadReq], Future]:
        """Split one tensor read into byte-ranged row tiles so peak host
        memory stays under the budget. Tiles land in one host tensor
        (the target itself when it is an exact-match CPU tensor); when
        the entry carries tile checksums, read tiles align to them and
        each is verified against the combined tile values."""
        shape = entry.shape
        row_nbytes = tensor_nbytes(entry.dtype, shape[1:])
        rows_per_tile = max(1, buffer_size_limit_bytes // max(row_nbytes, 1))
        n_rows = shape[0]
        verify_tiles = (
            bool(entry.tile_checksums and entry.tile_rows)
            and not is_checksum_disabled()
        )
        if verify_tiles:
            if rows_per_tile >= entry.tile_rows:
                rows_per_tile = (rows_per_tile // entry.tile_rows) * entry.tile_rows
            else:
                rows_per_tile = entry.tile_rows
        in_place = writable_byte_view(obj_out, entry.dtype, shape) is not None
        host_out = (
            obj_out
            if in_place
            else torch.empty(tuple(shape), dtype=string_to_dtype(entry.dtype))
        )
        base_offset = entry.byte_range[0] if entry.byte_range is not None else 0
        n_tiles = math.ceil(n_rows / rows_per_tile)
        remaining = {"count": n_tiles}
        ready = _record_ready(obj_out) if isinstance(obj_out, torch.Tensor) else None
        read_reqs = []
        for t in range(n_tiles):
            r0 = t * rows_per_tile
            r1 = min(r0 + rows_per_tile, n_rows)
            tile_checksum = (
                combined_tile_checksum(entry, r0, r1, row_nbytes)
                if verify_tiles
                else None
            )
            consumer = _TileConsumer(
                entry,
                host_out,
                r0,
                r1,
                remaining,
                fut,
                obj_out,
                in_place,
                ready,
                blob_checksum=tile_checksum,
                blob_location=f"{logical_path or entry.location} (rows {r0}:{r1})",
            )
            read_reqs.append(
                ReadReq(
                    path=entry.location,
                    byte_range=(
                        base_offset + r0 * row_nbytes,
                        base_offset + r1 * row_nbytes,
                    ),
                    buffer_consumer=consumer,
                    into=consumer.into_mv,
                    want_crc=consumer.into_mv is not None
                    and tile_checksum is not None,
                )
            )
        return read_reqs, fut


class _TileConsumer(BufferConsumer):
    def __init__(
        self,
        entry,
        host_out,
        r0,
        r1,
        remaining,
        fut,
        obj_out,
        in_place,
        ready,
        blob_checksum=None,
        blob_location="",
    ):
        self.entry = entry
        self.host_out = host_out
        self.r0, self.r1 = r0, r1
        self.remaining = remaining
        self.fut = fut
        self.obj_out = obj_out
        self.in_place = in_place
        self.ready = ready
        self.blob_checksum = blob_checksum
        self.blob_location = blob_location
        rows = host_out[r0:r1]
        self.into_mv = (
            memoryview(tensor_as_bytes(rows).numpy()) if rows.numel() else None
        )

    async def consume_read_io(self, read_io, executor: Optional[Executor] = None) -> None:
        if not read_io.in_place:
            await self.consume_buffer(read_io.buf.getbuffer(), executor)
            return
        _verify_read_time_crc(read_io, self.blob_checksum, self.blob_location)
        await self._after_consume(executor)

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        await _run(executor, self._consume_blocking, buf)
        await self._after_consume(executor)

    async def _after_consume(self, executor: Optional[Executor] = None) -> None:
        # Completion bookkeeping stays on the event-loop thread.
        self.remaining["count"] -= 1
        if self.remaining["count"] != 0:
            return
        if self.in_place:
            self.fut.obj = self.host_out
            return
        self.fut.obj = await _run(
            executor, finalize_into_target, self.host_out, self.obj_out, True, self.ready
        )

    def _consume_blocking(self, buf: BufferType) -> None:
        _maybe_verify(buf, self.blob_checksum, self.blob_location)
        tile_shape = [self.r1 - self.r0] + list(self.entry.shape[1:])
        src = tensor_from_memoryview(memoryview(buf), self.entry.dtype, tile_shape)
        self.host_out[self.r0 : self.r1].copy_(src)

    def get_consuming_cost_bytes(self) -> int:
        return tensor_nbytes(
            self.entry.dtype, [self.r1 - self.r0] + list(self.entry.shape[1:])
        )
