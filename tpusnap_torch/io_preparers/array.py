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
- **Async takes.** tpusnap relies on JAX arrays being immutable; torch
  tensors are updated in place. A CPU tensor's staged bytes are the
  caller's memory and take tpusnap's path exactly: COW (hash inside the
  blocked window, re-verify after the write) or, with
  ``TPUSNAP_ASYNC_COW=0``, a defensive clone from the staging pool. A
  CUDA tensor stages through a pinned copy, so only its *source* must
  not change before the copy: ``freeze_device_sources`` copies every
  CUDA source the blocked window did not stage into HBM on a side
  stream and orders the caller's current stream after those copies, so
  the state stays as of ``async_take`` while the drain copies device→host
  from the copies.
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
  target of another shape is replaced by a new tensor on its device, and
  a pinned one by a new pinned tensor, as tpusnap ``device_put``s onto
  the target's sharding and memory kind. A pinned CPU source stages as a
  view of itself, with no device-to-host copy.
- **Save-time transforms** (``array_prepare_func``, e.g.
  ``transforms.cast_on_save``). The manifest's dtype comes from running
  the transform on a ``meta`` tensor (``trace_array_prepare``: no memory,
  no arithmetic — the counterpart of ``jax.eval_shape``). At stage time a
  CUDA source is transformed on the card, on the staging side stream
  after its ready event (or after the frozen copy's), and the result
  crosses to pinned memory; the host never sees the untransformed bytes.
  Restoring a narrower stored dtype into a CUDA target casts on the card.
- **Incremental dedup** (``dedup_entry``). The staged bytes are hashed at
  stage time — whole-blob or per checksum tile, the 32-bit CRC32C and
  the 64-bit XXH64 in one pass — and a blob whose hashes all match its
  base entry's returns ``SKIP_WRITE``: no write, and the entry adopts the
  base blob's location (``dedup_entries_match``).
- **Fused tile compression** (``compress_codec``, armed by the take's
  ``compress`` policy). One pass over the staged bytes shuffles,
  LZ4-compresses and hashes each checksum tile; the staged buffer is the
  compressed blob, fresh memory, so an async take needs neither a clone
  nor COW, and a CUDA source's pinned buffer is dropped as soon as the
  codec has read it. The restore reads compressed tiles in groups whose
  decompressed size fits the budget, verifies each group's stored bytes
  and decompresses it into the target's rows — for a CUDA target into a
  pinned buffer per group, copied into the rows in place on the card.
- Tile-grain checksums, the fused read-time checksum and budget-tiled
  reads are kept as in tpusnap.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import math
import threading
from concurrent.futures import Executor
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from .. import _native, telemetry
from ..compress import (
    check_tile_coverage,
    codec_elem,
    combined_comp_checksum,
    comp_tile_offsets,
)
from ..io_types import (
    SKIP_WRITE,
    BufferConsumer,
    BufferStager,
    BufferType,
    Future,
    ReadReq,
    WriteReq,
)
from ..knobs import (
    get_native_copy_threads,
    get_tile_checksum_bytes,
    is_async_cow_enabled,
    is_checksum_disabled,
)
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

logger = logging.getLogger(__name__)


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
    t: torch.Tensor,
    ready: Optional["torch.cuda.Event"],
    transform: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, "torch.cuda.Event", Optional[tuple]]:
    """Start the device→host copy of ``t``'s bytes — of ``transform(t)``
    when given, computed on the card — into a pinned buffer on a side
    stream; returns ``(pinned_u8, done_event, timing)``. The caller hands
    ``done_event`` and ``timing`` to :func:`wait_dtoh` before reading the
    buffer.

    While span capture is on, the copy is measured: ``dtoh.bytes``, and
    ``dtoh.pin_alloc_ns`` from the pinned allocator's own clock
    (:func:`_pinned_empty`). The copy is then submitted between two
    timing events in calls that keep the GIL (:func:`_submit_timed_copy`),
    so no host wait falls between the events, and ``timing`` lets
    :func:`wait_dtoh` count the card's time between them. The transform
    and a non-contiguous source's compaction run before the first event."""
    rec = telemetry.current()
    timed = rec is not None and rec.enabled
    stream = torch.cuda.Stream(device=t.device)
    with torch.cuda.stream(stream):
        if ready is not None:
            stream.wait_event(ready)
        # The transform and the compaction of a non-contiguous source run
        # here, on the side stream, after the ready event; their results
        # are allocated on this stream, so the allocator cannot reuse
        # them before the copy below has read them.
        src = tensor_as_bytes(t if transform is None else transform(t))
        host = _pinned_empty(src.numel(), rec if timed else None)
        timing = None
        if timed:
            telemetry.incr("dtoh.bytes", host.numel(), rec=rec)
            events = _submit_timed_copy(host, src, stream)
            if events is not None:
                start, done = events
                timing = (rec, start)
        if timing is None:
            host.copy_(src, non_blocking=True)
            done = event_on(stream)
        # The caching allocator must not hand ``t``'s memory out again
        # before this copy has read it, even if the caller drops ``t``.
        t.record_stream(stream)
    return host, done, timing


def wait_dtoh(done: "torch.cuda.Event", timing: Optional[tuple]) -> None:
    """Wait for a copy :func:`enqueue_dtoh` started; when it was timed,
    add the card's time between its two events to ``dtoh.card_ns``."""
    done.synchronize()
    if timing is not None:
        rec, start = timing
        telemetry.incr("dtoh.card_ns", int(start.elapsed_time(done) * 1e6), rec=rec)


# Pinned allocations are measured one at a time, so that the allocator's
# clock, which every thread shares, is read around one allocation alone.
_pin_lock = threading.Lock()


def _host_alloc_us() -> Optional[float]:
    """Microseconds torch's pinned allocator has spent in CUDA's host
    allocation, summed over the process; None where torch lacks it."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    return None if stats is None else stats().get("host_alloc_time.total")


def _pinned_empty(nbytes: int, rec: Optional[telemetry.TakeTelemetry]) -> torch.Tensor:
    """A pinned ``uint8`` buffer. With ``rec``, the allocator's time in
    CUDA's host allocation for it goes to ``dtoh.pin_alloc_ns``: zero when
    the request is served from the allocator's cache. The allocator times
    the call itself, so the wait to retake the GIL after it is not
    counted."""
    if rec is None:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    with _pin_lock:
        before = _host_alloc_us()
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        after = _host_alloc_us()
    if after is not None:
        # The allocator reports no statistic before its first allocation.
        telemetry.incr("dtoh.pin_alloc_ns", int((after - (before or 0)) * 1000), rec=rec)
    return host


_driver: Optional[object] = None  # libcuda through ctypes.PyDLL; False if absent


def _cuda_driver():
    """The CUDA driver library loaded with ``ctypes.PyDLL``, whose calls
    keep the GIL, or None."""
    global _driver
    if _driver is None:
        try:
            lib = ctypes.PyDLL("libcuda.so.1")
            lib.cuEventRecord.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
            lib.cuMemcpyDtoHAsync_v2.argtypes = (
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_size_t, ctypes.c_void_p,
            )
            _driver = lib
        except (OSError, AttributeError):
            logger.warning("libcuda not loadable: device-to-host copies go untimed")
            _driver = False
    return _driver or None


def _submit_timed_copy(
    host: torch.Tensor, src: torch.Tensor, stream: "torch.cuda.Stream"
) -> Optional[Tuple["torch.cuda.Event", "torch.cuda.Event"]]:
    """Record a timing event, the copy of ``src`` into ``host`` and a
    second timing event on ``stream``, in three driver calls that keep
    the GIL: no other thread runs between them, so the events part only
    by the copy (and by any wait for a copy engine that another stream
    holds). Returns ``(start, done)``, or None with nothing submitted
    where the driver is not loadable.

    A ``torch.cuda.Event`` creates its handle at its first record; both
    are recorded once through torch first, which the driver's records
    then supersede."""
    lib = _cuda_driver()
    if lib is None:
        return None
    start = torch.cuda.Event(enable_timing=True)
    done = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    done.record(stream)
    handle = stream.cuda_stream
    err = lib.cuEventRecord(start.cuda_event, handle)
    if not err:
        err = lib.cuMemcpyDtoHAsync_v2(host.data_ptr(), src.data_ptr(), host.numel(), handle)
        if not err:
            err = lib.cuEventRecord(done.cuda_event, handle)
    if err:
        raise RuntimeError(f"CUDA driver error {err} in a device-to-host copy")
    return start, done


def event_on(stream: "torch.cuda.Stream") -> "torch.cuda.Event":
    event = torch.cuda.Event()
    event.record(stream)
    return event


def _may_alias_live_memory(t: torch.Tensor) -> bool:
    """Whether ``t``'s staged host bytes are memory the caller may change
    in place after an async take returns. A CPU tensor stages as a view
    of itself. A CUDA tensor stages through a pinned copy, from a frozen
    device copy when the blocked window did not stage it, so it never
    does."""
    return not t.is_cuda


def _acquire_clone_buffer(nbytes: int):
    """Aligned buffer for a defensive clone, from the staging pool (warm
    pages in a checkpoint loop); the write pipeline releases it."""
    from .._staging_pool import acquire

    return acquire(nbytes)


class ArrayBufferStager(BufferStager):
    def __init__(
        self,
        arr: torch.Tensor,
        entry: Optional[TensorEntry] = None,
        is_async_snapshot: bool = False,
        array_prepare_func: Optional[Callable[[torch.Tensor, bool], torch.Tensor]] = None,
        dedup_entry: Optional[TensorEntry] = None,
        record_dedup_hashes: bool = False,
        compressible: bool = True,
    ) -> None:
        self.arr = arr
        self.is_async_snapshot = is_async_snapshot
        # Manifest entry annotated with the checksums; the metadata is
        # encoded after every write has landed, so the values reach it.
        self.entry = entry
        # Save-time transform ``f(tensor, tracing) -> tensor``, applied to
        # the source at stage time (on its device).
        self.array_prepare_func = array_prepare_func
        # Incremental takes: the base snapshot's entry for this blob
        # (locations relative to the new root). Bytes that hash the same
        # skip their write and the entry adopts the base blob.
        self.dedup_entry = dedup_entry
        # Record the 64-bit per-tile dedup hashes too (incremental takes,
        # or TPUSNAP_RECORD_DEDUP_HASHES), so the next increment can skip
        # at tile grain.
        self.record_dedup_hashes = record_dedup_hashes
        # Set by the take's compress policy after batching: the staged
        # buffer is then the compressed blob. Shards opt out at
        # construction: a reshard reads sub-boxes of them.
        self.compressible = compressible
        self.compress_codec: Optional[str] = None
        # Set by the take after batching: hash on the write path
        # (``late_checksum``) instead of inside the staging window.
        # Incremental takes never defer: dedup needs the stage-time hash.
        self.defer_checksums = False
        # Per-take override of COW: defensive clones for CPU sources.
        self.force_clone = False
        # Set when an async take stages the LIVE bytes of a CPU tensor
        # (COW): the write pipeline then calls verify_cow_after_write.
        self.cow_pending = False
        self.ready = _record_ready(arr)
        self.cuda_device = arr.device if arr.is_cuda else None
        # CUDA sources: freeze() and the DtoH enqueue exclude each other,
        # so each source is read either by the DtoH ordered before the
        # caller's next work, or by a device copy that is.
        self._lock = threading.Lock()
        self._frozen: Optional[Tuple[torch.Tensor, "torch.cuda.Event"]] = None
        self._dtoh_done: Optional["torch.cuda.Event"] = None

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        if executor is not None:
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(executor, self._stage_blocking)
        return self._stage_blocking()

    def _stage_blocking(self) -> BufferType:
        want_crc = self.entry is not None and not is_checksum_disabled()
        if self.compress_codec is not None and want_crc:
            return self._stage_compressed()
        mv = self._host_bytes()
        if want_crc and self.dedup_entry is not None:
            # Incremental dedup: hash first (the expected outcome is
            # "unchanged", where nothing is cloned or written).
            _record_checksums(self.entry, mv, self.record_dedup_hashes)
            if dedup_entries_match(self.entry, self.dedup_entry):
                _adopt_base_location(self.entry, self.dedup_entry)
                return SKIP_WRITE
            if self.is_async_snapshot and _may_alias_live_memory(self.arr):
                if self.uses_cow():
                    self.cow_pending = True  # checksums already recorded
                    return mv
                out = _acquire_clone_buffer(mv.nbytes)
                _native.memcpy(out, mv, nthreads=get_native_copy_threads())
                return out
            return mv
        if self.is_async_snapshot and _may_alias_live_memory(self.arr):
            return self._stage_live(mv, want_crc)
        if want_crc and not self.defer_checksums:
            _record_checksums(self.entry, mv, self.record_dedup_hashes)
        return mv

    def _host_bytes(self) -> memoryview:
        """The bytes to persist in host memory: a pinned copy of a CUDA
        source (transformed on the card), a view of a CPU source (or of
        its transform's result)."""
        if self.arr.is_cuda:
            return self._stage_device()
        src = self.arr
        if self.array_prepare_func is not None:
            src = self._transformed(src)
        if array_nbytes(src) == 0:
            return memoryview(b"")
        return tensor_as_memoryview(src)

    def _transformed(self, t: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            out = self.array_prepare_func(t, False)  # tracing=False
        if self.entry is not None and (
            list(out.shape) != list(self.entry.shape)
            or dtype_to_string(out.dtype) != self.entry.dtype
        ):
            raise RuntimeError(
                f"_custom_array_prepare_func returned {out.dtype}{list(out.shape)} "
                f"at stage time but {self.entry.dtype}{list(self.entry.shape)} was "
                "recorded at prepare time — the transform must be deterministic"
            )
        return out

    def _stage_device(self) -> memoryview:
        """The source's bytes in pinned host memory, from the frozen copy
        when there is one, transformed on the card when a transform is
        set. The copy is dropped once its DtoH has landed."""
        if array_nbytes(self.arr) == 0:
            return memoryview(b"")
        transform = self._transformed if self.array_prepare_func is not None else None
        rec = telemetry.current()
        t0 = rec.now() if rec is not None and rec.enabled else None
        with telemetry.profiler_range("dtoh"):
            with self._lock:
                src, ready = self._frozen or (self.arr, self.ready)
                host, done, timing = enqueue_dtoh(src, ready, transform)
                self._dtoh_done = done
            wait_dtoh(done, timing)
        if t0 is not None:
            # The copy runs on a side stream: its span closes once its
            # event has completed, not at the enqueue.
            rec.record_span("dtoh", t0, rec.now() - t0, bytes=host.numel())
        self._frozen = None
        return memoryview(host.numpy())

    def _stage_compressed(self) -> BufferType:
        """Fused shuffle+LZ4+dual-hash staging: one read of the staged
        bytes, compressed tiles and their checksums and dedup hashes out,
        all over the STORED bytes. The result is copied into a right-sized
        pool buffer, so the codec's worst-case output buffer — and a CUDA
        source's pinned buffer — are released before the write."""
        codec = self.compress_codec
        entry = self.entry
        rec = telemetry.current()
        mv = self._host_bytes()
        tile_rows, row_nbytes = _tile_geometry(entry, mv.nbytes)
        tile_nbytes = tile_rows * row_nbytes if tile_rows else mv.nbytes
        want_dedup = (
            _want_dedup_hashes(self.record_dedup_hashes, tile_rows, mv.nbytes)
            or self.dedup_entry is not None
        )
        # Raw-hash fast skip: the codec is deterministic, so equal RAW
        # bytes imply equal stored bytes, and an unchanged blob costs one
        # hash pass instead of a codec pass.
        raw_hash = _raw_dual_hash(mv) if want_dedup else None
        prev = self.dedup_entry
        if (
            prev is not None
            and raw_hash is not None
            and prev.uncompressed_dedup_hash == raw_hash
            and prev.codec == codec
            and prev.checksum is not None
            and prev.dtype == entry.dtype
            and list(prev.shape) == list(entry.shape)
            and prev.serializer == entry.serializer
        ):
            _adopt_base_location(entry, prev)
            _annotate_from_dedup_base(entry, prev)
            telemetry.incr("compress.raw_dedup_skips", rec=rec)
            return SKIP_WRITE
        raw_nbytes = mv.nbytes
        t0 = rec.now() if rec is not None else 0.0
        with telemetry.profiler_range("compress"):
            out, comp_sizes, crcs, xxhs = _native.compress_tiles(
                mv, tile_nbytes, codec_elem(codec), want_dedup,
                nthreads=get_native_copy_threads(),
            )
        del mv  # a CUDA source's pinned buffer goes back to its pool here
        if rec is not None:
            rec.record_span(
                "compress", t0, rec.now() - t0, bytes=raw_nbytes, out_bytes=out.nbytes,
                codec=codec,
            )
        telemetry.incr("compress.bytes_in", raw_nbytes, rec=rec)
        telemetry.incr("compress.bytes_out", out.nbytes, rec=rec)
        telemetry.incr("compress.blobs", rec=rec)
        _annotate_compressed(entry, codec, raw_nbytes, comp_sizes, crcs, tile_rows, xxhs)
        if raw_hash is not None:
            # Skip evidence for the next increment's raw-hash fast path.
            entry.uncompressed_dedup_hash = raw_hash
        if prev is not None and dedup_entries_match(entry, prev):
            _adopt_base_location(entry, prev)
            return SKIP_WRITE
        final = _acquire_clone_buffer(out.nbytes)
        _native.memcpy(final, out, nthreads=get_native_copy_threads())
        return final

    def pending_device_bytes(self) -> int:
        """Device bytes ``freeze`` would copy."""
        if self.cuda_device is None or self.frozen or self._dtoh_done is not None:
            return 0
        return array_nbytes(self.arr)

    def freeze(self, stream: "torch.cuda.Stream") -> None:
        """Make the bytes this CUDA source stages independent of the
        caller's later in-place updates, with work on ``stream`` (which
        the caller's stream then waits on): a DtoH already enqueued is
        waited for; otherwise the tensor is copied on the card after its
        ready event, and the DtoH reads the copy later (a transform runs
        once, at stage time, on the copy)."""
        with self._lock:
            if self._dtoh_done is not None:
                stream.wait_event(self._dtoh_done)
            elif array_nbytes(self.arr):
                with torch.cuda.stream(stream):
                    stream.wait_event(self.ready)
                    copy = torch.empty(
                        self.arr.shape, dtype=self.arr.dtype, device=self.arr.device
                    )
                    copy.copy_(self.arr.detach())
                    self._frozen = (copy, event_on(stream))
            self.frozen = True

    def _stage_live(self, mv: memoryview, want_crc: bool) -> BufferType:
        """Async take of a CPU tensor, whose staged bytes are the caller's
        memory. COW (the default) hashes them now — overriding a deferral:
        this value is what the write path re-verifies — and stages them as
        they are; otherwise they are cloned into a pool buffer, hashed in
        the same pass unless the hash is deferred."""
        if self.uses_cow():
            _record_checksums(self.entry, mv, self.record_dedup_hashes)
            self.cow_pending = True
            return mv
        out = _acquire_clone_buffer(mv.nbytes)
        threads = get_native_copy_threads()
        if want_crc and not self.defer_checksums:
            _clone_and_record_checksums(
                self.entry, out, mv, threads, self.record_dedup_hashes
            )
        else:
            _native.memcpy(out, mv, nthreads=threads)
        return out

    def late_checksum(self, buf) -> None:
        """Record checksums from the STAGED buffer (write path)."""
        if self.entry is None or is_checksum_disabled() or self.entry.checksum:
            return
        _record_checksums(self.entry, memoryview(buf).cast("B"), self.record_dedup_hashes)

    def verify_cow_after_write(self, buf) -> None:
        """COW staging: re-hash the live bytes after the storage write and
        compare them with the checksum recorded inside the blocked window.
        A mismatch means the caller changed the tensor while the take was
        in flight, so the blob may be torn: the take fails here and its
        metadata is never written."""
        if self.entry is None or self.entry.checksum is None:
            return
        try:
            mv = memoryview(buf).cast("B")
            _native.verify_checksum(mv, self.entry.checksum, self.entry.location)
            self._verify_cow_xxh_lane(mv)
        except _native.ChecksumError as e:
            raise RuntimeError(
                f"async COW take detected a concurrent mutation of "
                f"{self.entry.location!r}: the tensor changed between staging "
                "and its storage write. Under TPUSNAP_ASYNC_COW a CPU tensor's "
                "live bytes are read until its write completes — mutate it only "
                "after PendingSnapshot.wait_staged()/wait() returns, or set "
                "TPUSNAP_ASYNC_COW=0 for defensive clones."
            ) from e

    def _verify_cow_xxh_lane(self, mv: memoryview) -> None:
        """Re-verify the 64-bit XXH64 lane too where one was recorded, so
        the mutation check carries more than the CRC's 32 bits. A lane
        recorded by another build's algorithm is skipped, as
        verify_checksum skips a foreign CRC."""
        entry = self.entry
        dalgo = _native.dedup_hash_algorithm()
        if entry.dedup_hash is not None:
            algo, _, val = entry.dedup_hash.partition(":")
            if algo == dalgo and int(val, 16) != _native.xxh64(mv):
                raise _native.ChecksumError(f"XXH64 lane mismatch for {entry.location!r}")
            return
        if not entry.tile_dedup_hashes:
            return
        tile_rows, row_nbytes = _tile_geometry(entry, mv.nbytes)
        if not tile_rows:
            return
        tile_nbytes = tile_rows * row_nbytes
        for i, recorded in enumerate(entry.tile_dedup_hashes):
            algo, _, val = recorded.partition(":")
            if algo != dalgo:
                return
            if int(val, 16) != _native.xxh64(mv[i * tile_nbytes : (i + 1) * tile_nbytes]):
                raise _native.ChecksumError(
                    f"XXH64 tile {i} mismatch for {entry.location!r}"
                )

    def uses_cow(self) -> bool:
        """Whether an async take stages this tensor's live bytes and
        verifies them after the write (instead of cloning them). A
        compressed blob is fresh memory and needs neither."""
        return (
            self.is_async_snapshot
            and _may_alias_live_memory(self.arr)
            and is_async_cow_enabled()
            and not self.force_clone
            and self.compress_codec is None
            and self.entry is not None
            and not is_checksum_disabled()
        )

    def get_staging_cost_bytes(self) -> int:
        n = self.get_planned_bytes()
        if self.compress_codec is not None:
            # The codec's worst-case output buffer plus the right-sized
            # staged copy.
            return 2 * n
        if self.is_async_snapshot and _may_alias_live_memory(self.arr) and not self.uses_cow():
            return 2 * n  # the defensive clone: a second host copy in flight
        if self.arr.is_cuda and not self.arr.is_contiguous():
            return 2 * n  # compacted on the card before the copy out
        return n

    def get_planned_bytes(self) -> int:
        if self.array_prepare_func is not None and self.entry is not None:
            # What is staged is the transformed tensor.
            return tensor_nbytes(self.entry.dtype, self.entry.shape)
        return array_nbytes(self.arr)


def freeze_device_sources(stagers: Iterable[BufferStager]) -> bool:
    """Freeze every CUDA source among ``stagers`` (``freeze``), one side
    stream per device, and make the caller's current stream wait for the
    copies: in-place updates the caller queues after this returns cannot
    overtake them, and the host does not wait. Returns False when the
    card has too little free memory for the copies (or a copy runs out
    of it): the caller must then stage everything before it returns."""
    stagers = list(stagers)
    groups: Dict[torch.device, List[BufferStager]] = {}
    for s in _device_sources(stagers):
        if not s.frozen:
            groups.setdefault(s.cuda_device, []).append(s)
    for device, group in groups.items():
        need = sum(s.pending_device_bytes() for s in group)
        room = _room_for_device_copies(device)
        if need > room:
            logger.warning(
                "async_take: %d bytes of CUDA state outside the first staging "
                "window, room for %d on %s; staging all of it before returning",
                need,
                room,
                device,
            )
            return False
    try:
        for device, group in groups.items():
            stream = torch.cuda.Stream(device=device)
            for s in group:
                s.freeze(stream)
            torch.cuda.current_stream(device).wait_event(event_on(stream))
    except torch.cuda.OutOfMemoryError:
        logger.warning(
            "async_take: out of device memory while freezing CUDA state; "
            "staging all of it before returning"
        )
        return False
    for s in stagers:
        members = getattr(s, "members", None)
        if getattr(s, "cuda_device", None) is None and members:
            # A host slab whose members are all frozen CUDA sources (they
            # carry a save-time transform) no longer reads live state.
            s.frozen = all(m.frozen for _, _, m in members)
    return True


def _device_sources(stagers: List[BufferStager]) -> Iterable[BufferStager]:
    """The stagers that read CUDA memory: CUDA tensors and device slabs,
    and the CUDA members of host slabs."""
    for s in stagers:
        if getattr(s, "cuda_device", None) is not None:
            yield s
        else:
            for _, _, m in getattr(s, "members", None) or ():
                if getattr(m, "cuda_device", None) is not None:
                    yield m


def _room_for_device_copies(device: torch.device) -> int:
    """Device memory the freeze copies may take: free memory on the card
    plus the blocks PyTorch's allocator caches unused, less the headroom
    the program's own peak has needed beyond what it holds now (the train
    steps that run while the take drains need it again)."""
    free, _ = torch.cuda.mem_get_info(device)
    allocated = torch.cuda.memory_allocated(device)
    cached = torch.cuda.memory_reserved(device) - allocated
    headroom = torch.cuda.max_memory_allocated(device) - allocated
    return free + cached - headroom


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
# every take, as tpusnap does; larger ones only when asked to.
_DEDUP_HASH_EAGER_MAX = 64 << 20
_XXH_MASK = (1 << 64) - 1


def _want_dedup_hashes(record_flag: bool, tile_rows: int, nbytes: int) -> bool:
    if tile_rows:
        return record_flag
    return record_flag or nbytes <= _DEDUP_HASH_EAGER_MAX


def dedup_entries_match(new: TensorEntry, prev: TensorEntry) -> bool:
    """True when the freshly staged blob (``new``, checksums recorded) is
    byte-identical to the base's blob by its recorded checksums: same
    dtype, shape, serializer, whole-blob CRC, tile geometry and tile CRCs,
    codec and stored layout — AND matching 64-bit dedup hashes on both
    sides (per tile for tiled blobs), so a skip never rests on a single
    32-bit CRC. A base without the hashes conservatively rewrites."""
    if not (
        prev.checksum is not None
        and new.checksum == prev.checksum
        and new.dtype == prev.dtype
        and list(new.shape) == list(prev.shape)
        and new.serializer == prev.serializer
        and new.tile_rows == prev.tile_rows
        and new.tile_checksums == prev.tile_checksums
        and new.codec == prev.codec
        and new.comp_tile_sizes == prev.comp_tile_sizes
    ):
        return False
    if new.tile_checksums:
        return bool(
            new.tile_dedup_hashes
            and prev.tile_dedup_hashes
            and new.tile_dedup_hashes == prev.tile_dedup_hashes
        )
    return (
        new.dedup_hash is not None
        and prev.dedup_hash is not None
        and new.dedup_hash == prev.dedup_hash
    )


def _adopt_base_location(entry: TensorEntry, base: TensorEntry) -> None:
    """A skipped blob references the base's bytes instead."""
    entry.location = base.location
    entry.byte_range = list(base.byte_range) if base.byte_range is not None else None


def _annotate_checksums(
    entry: TensorEntry,
    tile_crcs: List[int],
    tile_rows: int,
    row_nbytes: int,
    tile_xxhs: Optional[List[int]] = None,
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
        if tile_xxhs is not None:
            dalgo = _native.dedup_hash_algorithm()
            entry.tile_dedup_hashes = [f"{dalgo}:{x & _XXH_MASK:016x}" for x in tile_xxhs]
    else:
        entry.checksum = f"{algo}:{tile_crcs[0] & 0xFFFFFFFF:08x}"
        if whole_xxh is not None:
            dalgo = _native.dedup_hash_algorithm()
            entry.dedup_hash = f"{dalgo}:{whole_xxh & _XXH_MASK:016x}"


def _annotate_compressed(
    entry: TensorEntry,
    codec: str,
    raw_nbytes: int,
    comp_sizes: List[int],
    tile_crcs: List[int],
    tile_rows: int,
    tile_xxhs: Optional[List[int]] = None,
) -> None:
    """The compressed blob's manifest fields: codec, logical size, stored
    size per tile, and checksums and dedup hashes over the STORED bytes
    (the whole-blob value folds the tiles over their stored lengths)."""
    algo = _native.checksum_algorithm()
    entry.codec = codec
    entry.uncompressed_nbytes = raw_nbytes
    entry.comp_tile_sizes = [int(s) for s in comp_sizes]
    if tile_rows:
        entry.tile_rows = tile_rows
        entry.tile_checksums = [f"{algo}:{crc & 0xFFFFFFFF:08x}" for crc in tile_crcs]
        entry.checksum = f"{algo}:{_fold_crcs(tile_crcs, entry.comp_tile_sizes):08x}"
        if tile_xxhs is not None:
            dalgo = _native.dedup_hash_algorithm()
            entry.tile_dedup_hashes = [f"{dalgo}:{x & _XXH_MASK:016x}" for x in tile_xxhs]
    else:
        entry.checksum = f"{algo}:{tile_crcs[0] & 0xFFFFFFFF:08x}"
        if tile_xxhs is not None:
            dalgo = _native.dedup_hash_algorithm()
            entry.dedup_hash = f"{dalgo}:{tile_xxhs[0] & _XXH_MASK:016x}"


def _raw_dual_hash(mv: memoryview) -> str:
    """CRC32C and XXH64 of a compressed stager's RAW bytes: the
    ``uncompressed_dedup_hash`` skip evidence."""
    algo = _native.checksum_algorithm()
    crc = _native.crc32c(mv) & 0xFFFFFFFF
    xxh = _native.xxh64(mv) & _XXH_MASK
    return f"{algo}:{crc:08x}+xxh64:{xxh:016x}"


def _annotate_from_dedup_base(entry: TensorEntry, prev: TensorEntry) -> None:
    """A raw-hash skip never ran the codec: the entry adopts the base's
    stored representation and every integrity field wholesale (the codec
    is deterministic, so they are what compressing again would give)."""
    entry.codec = prev.codec
    entry.uncompressed_nbytes = prev.uncompressed_nbytes
    entry.comp_tile_sizes = list(prev.comp_tile_sizes) if prev.comp_tile_sizes is not None else None
    entry.tile_rows = prev.tile_rows
    entry.checksum = prev.checksum
    entry.tile_checksums = list(prev.tile_checksums) if prev.tile_checksums is not None else None
    entry.dedup_hash = prev.dedup_hash
    entry.tile_dedup_hashes = (
        list(prev.tile_dedup_hashes) if prev.tile_dedup_hashes is not None else None
    )
    entry.uncompressed_dedup_hash = prev.uncompressed_dedup_hash


def _record_checksums(
    entry: TensorEntry, mv: memoryview, record_dedup_hashes: bool = False
) -> None:
    """Record integrity checksums into ``entry``: row-tile CRCs combined
    into the whole-blob value for large blobs (the verifiable unit of a
    budget-tiled read), one CRC otherwise; plus the 64-bit dedup hashes,
    fused into the same pass, per tile when ``record_dedup_hashes`` and
    for small tile-less blobs always."""
    with telemetry.span("checksum", bytes=mv.nbytes):
        _record_checksums_impl(entry, mv, record_dedup_hashes)


def _record_checksums_impl(
    entry: TensorEntry, mv: memoryview, record_dedup_hashes: bool
) -> None:
    tile_rows, row_nbytes = _tile_geometry(entry, mv.nbytes)
    want_dedup = _want_dedup_hashes(record_dedup_hashes, tile_rows, mv.nbytes)
    threads = get_native_copy_threads()
    if tile_rows:
        if want_dedup:
            crcs, xxhs = _native.crc_xxh_tiles(mv, tile_rows * row_nbytes, nthreads=threads)
            _annotate_checksums(entry, crcs, tile_rows, row_nbytes, tile_xxhs=xxhs)
            return
        n_rows = entry.shape[0]
        crcs = [
            _native.crc32c(
                mv[r0 * row_nbytes : min(r0 + tile_rows, n_rows) * row_nbytes]
            )
            for r0 in range(0, n_rows, tile_rows)
        ]
        _annotate_checksums(entry, crcs, tile_rows, row_nbytes)
        return
    if want_dedup:
        crcs, xxhs = _native.crc_xxh_tiles(mv, mv.nbytes, nthreads=threads)
        _annotate_checksums(entry, crcs, 0, row_nbytes, whole_xxh=xxhs[0])
        return
    _annotate_checksums(entry, [_native.crc32c(mv)], 0, row_nbytes)


def _clone_and_record_checksums(
    entry: TensorEntry, out, mv: memoryview, nthreads: int, record_dedup_hashes: bool = False
) -> None:
    """The defensive clone fused with the stage-time hash: one read of the
    live bytes, recording exactly what ``_record_checksums`` would."""
    tile_rows, row_nbytes = _tile_geometry(entry, mv.nbytes)
    want_dedup = _want_dedup_hashes(record_dedup_hashes, tile_rows, mv.nbytes)
    if tile_rows:
        if want_dedup:
            crcs, xxhs = _native.memcpy_crc_xxh_tiles(
                out, mv, tile_rows * row_nbytes, nthreads=nthreads
            )
        else:
            crcs = _native.memcpy_crc_tiles(out, mv, tile_rows * row_nbytes, nthreads=nthreads)
            xxhs = None
        _annotate_checksums(entry, crcs, tile_rows, row_nbytes, tile_xxhs=xxhs)
    elif want_dedup:
        # XXH64 has no combine: the fused clone+hash runs as one tile.
        crcs, xxhs = _native.memcpy_crc_xxh_tiles(out, mv, mv.nbytes)
        _annotate_checksums(entry, crcs, 0, row_nbytes, whole_xxh=xxhs[0])
    else:
        # Sub-tiles let the copy run on several threads; their values fold
        # into the one whole-blob CRC.
        sub = 16 << 20
        crcs = _native.memcpy_crc_tiles(out, mv, sub, nthreads=nthreads)
        whole = _fold_crcs(crcs, _tile_lengths(mv.nbytes, sub, len(crcs)))
        _annotate_checksums(entry, [whole], 0, row_nbytes)


def trace_array_prepare(
    t: torch.Tensor,
    array_prepare_func: Optional[Callable[[torch.Tensor, bool], torch.Tensor]],
) -> Tuple[str, List[int]]:
    """The (dtype, shape) the manifest records for ``t`` under an optional
    save-time transform, found by running the transform on a ``meta``
    tensor of the same shape and dtype: no memory and no arithmetic (the
    counterpart of tpusnap's ``jax.eval_shape``). A transform that cannot
    run on ``meta`` tensors gets one real call, whose result is dropped.
    A transform must not change the shape."""
    if array_prepare_func is None:
        return dtype_to_string(t.dtype), list(t.shape)
    with torch.no_grad():
        try:
            traced = array_prepare_func(torch.empty_like(t, device="meta"), True)
        except Exception:
            traced = array_prepare_func(t, True)  # tracing=True
    if list(traced.shape) != list(t.shape):
        raise RuntimeError(
            "_custom_array_prepare_func must not change the tensor's shape "
            f"(changed from {list(t.shape)} to {list(traced.shape)})"
        )
    return dtype_to_string(traced.dtype), list(traced.shape)


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
    after ``ready`` and are synchronised before returning; a cast (a
    bf16-stored blob into an f32 target) crosses the bus at the stored
    width and runs on the card."""
    with torch.no_grad():
        if not target.is_cuda:
            target.copy_(host)
            return
        stream = torch.cuda.Stream(device=target.device)
        with torch.cuda.stream(stream):
            if ready is not None:
                stream.wait_event(ready)
            if host.dtype != target.dtype:
                host = host.to(target.device, non_blocking=True)
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
    - a pinned (host-offloaded) target of another shape gets a new
      pinned tensor: the state stays in pinned memory, as tpusnap's
      ``device_put`` keeps the target's memory kind;
    - otherwise a CPU tensor owning its memory is returned
      (``owns_memory`` says whether ``host`` already does)."""
    if isinstance(obj_out, torch.Tensor) and tuple(obj_out.shape) == tuple(host.shape):
        _copy_into_target(obj_out, host, ready)
        return obj_out
    if isinstance(obj_out, torch.Tensor) and obj_out.is_cuda:
        # From pageable memory the copy has finished when ``to`` returns,
        # so ``host`` may alias a read buffer that is released next.
        return host.to(obj_out.device)
    if isinstance(obj_out, torch.Tensor) and obj_out.is_pinned():
        pinned = torch.empty(tuple(host.shape), dtype=host.dtype, pin_memory=True)
        return pinned.copy_(host)
    if owns_memory:
        return host
    # The owning copy is advised before its first touch, as tpusnap's
    # ``_owning_copy``: a multi-GB clone would fault 4 KiB at a time.
    return _native.empty_advised(host.shape, host.dtype).copy_(host)


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
        storage_path: str,
        arr: torch.Tensor,
        replicated: bool = False,
        is_async_snapshot: bool = False,
        array_prepare_func: Optional[Callable[[torch.Tensor, bool], torch.Tensor]] = None,
        array_prepare_traced: Optional[Tuple[str, List[int]]] = None,
        prev_entry=None,
        record_dedup_hashes: bool = False,
    ) -> Tuple[TensorEntry, List[WriteReq]]:
        if array_prepare_traced is not None:
            dtype, shape = array_prepare_traced[0], list(array_prepare_traced[1])
        else:
            dtype, shape = trace_array_prepare(arr, array_prepare_func)
        entry = TensorEntry(
            location=storage_path,
            serializer=Serializer.BUFFER_PROTOCOL.value,
            dtype=dtype,
            shape=shape,
            replicated=replicated,
        )
        stager = ArrayBufferStager(
            arr,
            entry=entry,
            is_async_snapshot=is_async_snapshot,
            array_prepare_func=array_prepare_func,
            dedup_entry=prev_entry if isinstance(prev_entry, TensorEntry) else None,
            record_dedup_hashes=record_dedup_hashes,
        )
        return entry, [WriteReq(path=storage_path, buffer_stager=stager)]

    @staticmethod
    def prepare_read(
        entry: TensorEntry,
        obj_out: Optional[torch.Tensor] = None,
        buffer_size_limit_bytes: Optional[int] = None,
        logical_path: str = "",
    ) -> Tuple[List[ReadReq], Future]:
        fut: Future = Future()
        if entry.codec:
            return ArrayIOPreparer._prepare_compressed_read(
                entry, obj_out, buffer_size_limit_bytes, fut, logical_path
            )
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
                logical_path=logical_path,
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
        (the target itself when it is an exact-match CPU tensor), or,
        for an exact-match CUDA target, each in its own pinned buffer
        (allocated when its read is dispatched) copied into the target's
        rows on the card, so no host copy of the whole tensor exists;
        when the entry carries tile checksums, read tiles align to them
        and each is verified against the combined tile values."""
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
        on_card = not in_place and _is_exact_cuda_target(obj_out, entry.dtype, shape)
        host_out = (
            obj_out
            if in_place or on_card
            else _native.empty_advised(shape, string_to_dtype(entry.dtype))
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
                in_place or on_card,
                ready,
                on_card=on_card,
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
                    logical_path=logical_path,
                )
            )
        return read_reqs, fut


    @staticmethod
    def _prepare_compressed_read(
        entry: TensorEntry,
        obj_out: Optional[torch.Tensor],
        buffer_size_limit_bytes: Optional[int],
        fut: Future,
        logical_path: str = "",
    ) -> Tuple[List[ReadReq], Future]:
        """Read path of a codec entry: the compressed tiles are read by
        byte range in groups whose DECOMPRESSED bytes fit the budget (the
        stored tile is the smallest readable unit), each group's stored
        bytes verified against its combined checksum and decompressed into
        the destination rows: the target's own memory for an exact CPU
        target, a pinned buffer per group copied in place into an exact
        CUDA target's rows on the card, else one host tensor handed to
        ``finalize_into_target`` at the end."""
        shape = entry.shape
        raw_nbytes = entry.uncompressed_nbytes or tensor_nbytes(entry.dtype, shape)
        sizes = [int(s) for s in (entry.comp_tile_sizes or [])]
        if not sizes:
            raise IOError(
                f"compressed entry {entry.location!r} records no comp_tile_sizes "
                "— the snapshot metadata is inconsistent"
            )
        n_rows = shape[0] if shape else 0
        row_nbytes = raw_nbytes // n_rows if n_rows else 0
        tile_raw = entry.tile_rows * row_nbytes if entry.tile_rows else raw_nbytes
        # Each group verifies only its own range: a comp_tile_sizes that
        # does not cover the payload would leave the tail unwritten.
        check_tile_coverage(entry.location, len(sizes), raw_nbytes, tile_raw)
        ready = _record_ready(obj_out) if isinstance(obj_out, torch.Tensor) else None
        dest = _CompressedDestination(entry, obj_out, ready)
        offsets = comp_tile_offsets(sizes)
        base = entry.byte_range[0] if entry.byte_range is not None else 0
        groups: List[Tuple[int, int]] = []
        t0 = 0
        while t0 < len(sizes):
            t1 = t0 + 1
            if buffer_size_limit_bytes is None:
                t1 = len(sizes)
            while t1 < len(sizes) and (t1 + 1 - t0) * tile_raw <= buffer_size_limit_bytes:
                t1 += 1
            groups.append((t0, t1))
            t0 = t1
        remaining = {"count": len(groups)}
        verify = not is_checksum_disabled()
        read_reqs: List[ReadReq] = []
        for g0, g1 in groups:
            expected = combined_comp_checksum(entry, g0, g1) if verify else None
            raw_start = g0 * tile_raw
            consumer = _CompressedConsumer(
                dest,
                comp_sizes=sizes[g0:g1],
                tile_raw=tile_raw,
                raw_start=raw_start,
                raw_end=min(g1 * tile_raw, raw_nbytes),
                remaining=remaining,
                fut=fut,
                expected_checksum=expected,
                location=f"{logical_path or entry.location} (comp tiles {g0}:{g1})",
            )
            read_reqs.append(
                ReadReq(
                    path=entry.location,
                    byte_range=(base + offsets[g0], base + offsets[g1 - 1] + sizes[g1 - 1]),
                    buffer_consumer=consumer,
                    want_crc=expected is not None,
                    logical_path=logical_path,
                )
            )
        return read_reqs, fut


class _CompressedDestination:
    """Where the decompressed bytes of one codec entry land (see
    ``_prepare_compressed_read``)."""

    def __init__(self, entry: TensorEntry, obj_out, ready) -> None:
        self.entry = entry
        self.obj_out = obj_out
        self.ready = ready
        self.codec_elem = codec_elem(entry.codec)
        # The restore's recorder (prepared under it): each group's
        # decompress is a ``restore.decode`` span, as in tpusnap.
        self._tele = telemetry.current()
        self.device_bytes: Optional[torch.Tensor] = None
        self.host_out: Optional[torch.Tensor] = None
        self.host_mv = writable_byte_view(obj_out, entry.dtype, entry.shape)
        self.in_place = self.host_mv is not None
        if not self.in_place:
            if _is_exact_cuda_target(obj_out, entry.dtype, entry.shape) and obj_out.is_contiguous():
                self.device_bytes = tensor_as_bytes(obj_out)
                self.in_place = True
            else:
                self.host_out = _native.empty_advised(
                    entry.shape, string_to_dtype(entry.dtype)
                )
                if self.host_out.numel():
                    self.host_mv = memoryview(tensor_as_bytes(self.host_out).numpy())

    def decode(self, mv: memoryview, comp_sizes, tile_raw: int, raw_start: int, raw_end: int):
        """Decompress one group's stored tiles into raw bytes
        [raw_start, raw_end) of the destination."""
        threads = get_native_copy_threads()
        if self.device_bytes is None and self.host_mv is None:
            return
        tele = self._tele if self._tele is not None and self._tele.enabled else None
        start = tele.now() if tele is not None else 0.0
        pinned = None
        if self.device_bytes is not None:
            pinned = torch.empty(raw_end - raw_start, dtype=torch.uint8, pin_memory=True)
            dst = memoryview(pinned.numpy())
        else:
            dst = self.host_mv[raw_start:raw_end]
        _native.decompress_tiles(
            mv, comp_sizes, tile_raw, raw_end - raw_start, self.codec_elem, dst,
            nthreads=threads,
        )
        if tele is not None:
            tele.record_span(
                "restore.decode", start, tele.now() - start,
                path=self.entry.location, bytes=mv.nbytes, raw_bytes=raw_end - raw_start,
            )
        if pinned is not None:
            # The host-to-device leg belongs to the enclosing consume span.
            _copy_into_target(self.device_bytes[raw_start:raw_end], pinned, self.ready)

    def result(self):
        if self.in_place:
            return self.obj_out
        return finalize_into_target(self.host_out, self.obj_out, True, self.ready)


class _CompressedConsumer(BufferConsumer):
    """One group of compressed tiles: verify the CRC of the stored bytes
    (the read-time value when the plugin computed one, else one hash
    pass), then decompress into the destination rows. The last group to
    land resolves the future."""

    def __init__(
        self,
        dest: _CompressedDestination,
        comp_sizes: List[int],
        tile_raw: int,
        raw_start: int,
        raw_end: int,
        remaining: dict,
        fut: Future,
        expected_checksum: Optional[str],
        location: str,
    ) -> None:
        self.dest = dest
        self.comp_sizes = comp_sizes
        self.tile_raw = tile_raw
        self.raw_start, self.raw_end = raw_start, raw_end
        self.remaining = remaining
        self.fut = fut
        self.expected_checksum = expected_checksum
        self.location = location
        self.comp_nbytes = sum(comp_sizes)

    async def consume_read_io(self, read_io, executor: Optional[Executor] = None) -> None:
        await _run(
            executor, self._consume_blocking, read_io.buf.getbuffer(),
            read_io.crc32c, read_io.crc_algo,
        )
        await self._after_consume(executor)

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        await _run(executor, self._consume_blocking, buf, None, None)
        await self._after_consume(executor)

    def _consume_blocking(self, buf: BufferType, crc, crc_algo) -> None:
        mv = memoryview(buf).cast("B")
        if self.expected_checksum is not None:
            if crc is not None and crc_algo:
                _native.verify_checksum_value(crc, crc_algo, self.expected_checksum, self.location)
            else:
                _native.verify_checksum(mv, self.expected_checksum, self.location)
        if mv.nbytes != self.comp_nbytes:
            raise IOError(
                f"short read: got {mv.nbytes} of {self.comp_nbytes} compressed "
                f"bytes for {self.location} — the blob is truncated"
            )
        try:
            self.dest.decode(mv, self.comp_sizes, self.tile_raw, self.raw_start, self.raw_end)
        except _native.CompressionError as e:
            raise _native.CompressionError(
                f"{self.location}: {e} (stored checksum verified — the blob "
                "was written malformed, not corrupted in transit)"
            ) from e

    async def _after_consume(self, executor: Optional[Executor] = None) -> None:
        # Completion bookkeeping stays on the event-loop thread.
        self.remaining["count"] -= 1
        if self.remaining["count"] == 0:
            self.fut.obj = await _run(executor, self.dest.result)

    def get_consuming_cost_bytes(self) -> int:
        return (self.raw_end - self.raw_start) + self.comp_nbytes


class _TileConsumer(BufferConsumer):
    """Rows ``[r0, r1)`` of a tiled read: into ``host_out``'s rows, or, with
    ``on_card``, through a pinned tile buffer into the CUDA target's rows
    (``host_out`` is then the target)."""

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
        on_card=False,
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
        self.on_card = on_card
        self.blob_checksum = blob_checksum
        self.blob_location = blob_location
        self._pinned: Optional[torch.Tensor] = None
        rows = host_out[r0:r1]
        self.into_mv: Union[memoryview, Callable[[], memoryview], None] = None
        if rows.numel():
            self.into_mv = (
                self._pinned_tile if on_card else memoryview(tensor_as_bytes(rows).numpy())
            )

    def _tile_shape(self) -> List[int]:
        return [self.r1 - self.r0] + list(self.entry.shape[1:])

    def _pinned_tile(self) -> memoryview:
        """Allocated when the read is dispatched, so pinned memory in use
        stays under the read budget."""
        self._pinned = torch.empty(
            tensor_nbytes(self.entry.dtype, self._tile_shape()), dtype=torch.uint8,
            pin_memory=True,
        )
        return memoryview(self._pinned.numpy())

    def _to_card(self, src: torch.Tensor) -> None:
        _copy_into_target(self.host_out[self.r0 : self.r1], src, self.ready)

    async def consume_read_io(self, read_io, executor: Optional[Executor] = None) -> None:
        if not read_io.in_place:
            await self.consume_buffer(read_io.buf.getbuffer(), executor)
            return
        _verify_read_time_crc(read_io, self.blob_checksum, self.blob_location)
        if self._pinned is not None:
            pinned, self._pinned = self._pinned, None
            src = pinned.view(string_to_dtype(self.entry.dtype)).reshape(self._tile_shape())
            await _run(executor, self._to_card, src)
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
        src = tensor_from_memoryview(memoryview(buf), self.entry.dtype, self._tile_shape())
        if self.on_card:
            self._pinned = None
            self._to_card(src)
        else:
            self.host_out[self.r0 : self.r1].copy_(src)

    def get_consuming_cost_bytes(self) -> int:
        return tensor_nbytes(
            self.entry.dtype, [self.r1 - self.r0] + list(self.entry.shape[1:])
        )
