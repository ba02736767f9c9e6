"""Chunked-tensor preparer: tensors above ``TPUSNAP_MAX_CHUNK_SIZE_BYTES``
are split along dim 0 into chunks that stage and write independently.

Counterpart of tpusnap/io_preparers/chunked.py, with the same layout: for
the same shape, dtype and knob both packages record the same chunk rows,
the same locations (``f"{storage_path}_{r0}_0"``) and the same
``Chunk(offsets, sizes, tensor)`` entries. A chunk is a dim-0 view
(``t[r0:r1]``) staged like a dense tensor: one device→host copy each for a
CUDA tensor. Host memory stays under the scheduler's budget, and an async
take's pipelined windows move chunk by chunk.

Restore lands each chunk in ``target[r0:r1]`` in place — on the card for a
CUDA target — through the dense preparer (budget-tiled when asked; a
compressed chunk is read through the dense compressed path, in tile
groups under the budget). A target that cannot take the bytes in place
(another dtype, shape or layout) gets them assembled in one host tensor
first and then handed on as a dense restore would.

Incremental takes: chunks dedup against the base's chunks of the same
rows; and ``tile_prev_map`` lets ``io_preparer`` re-chunk a tensor on the
base's checksum-tile grid, so that each tile skips or writes on its own
(one changed row of a large tensor rewrites one tile).
"""

from __future__ import annotations

from concurrent.futures import Executor
from typing import List, Optional, Tuple

import torch

from .. import _native
from ..io_types import BufferConsumer, BufferType, Future, ReadReq, WriteReq
from ..knobs import get_max_chunk_size_bytes
from ..manifest import Chunk, ChunkedTensorEntry, TensorEntry
from ..serialization import Serializer, string_to_dtype, tensor_nbytes
from .array import (
    ArrayBufferStager,
    ArrayIOPreparer,
    _record_ready,
    _run,
    array_nbytes,
    finalize_into_target,
    trace_array_prepare,
)


def should_chunk(t: torch.Tensor) -> bool:
    return t.dim() > 0 and t.shape[0] > 1 and array_nbytes(t) > get_max_chunk_size_bytes()


def chunk_row_ranges(
    shape: List[int], dtype: str, max_chunk_bytes: int
) -> List[Tuple[int, int]]:
    row_nbytes = max(tensor_nbytes(dtype, shape[1:]), 1)
    rows_per_chunk = max(1, max_chunk_bytes // row_nbytes)
    n_rows = shape[0]
    return [
        (r0, min(r0 + rows_per_chunk, n_rows)) for r0 in range(0, n_rows, rows_per_chunk)
    ]


def tile_prev_map(
    prev_entry, dtype: str, shape: List[int]
) -> Optional[Tuple[int, dict]]:
    """Per-tile view of a base entry for tile-grain incremental dedup:
    ``(grid_rows, {(offsets, sizes): TensorEntry})`` with one entry per
    checksum tile — its byte range within the base blob, its tile CRC and
    its 64-bit tile dedup hash — or None when tile-grain dedup is not
    possible (another identity, no tile checksums or dedup hashes, a
    compressed base, an irregular grid).

    Accepts a dense ``TensorEntry`` carrying ``tile_checksums`` and
    ``tile_dedup_hashes``, or a ``ChunkedTensorEntry`` from an earlier
    tile-grain take (uniform tile-sized chunks, each with its checksum
    and dedup hash), so a chain keeps deduping at tile grain."""
    serializer = Serializer.BUFFER_PROTOCOL.value
    if (
        isinstance(prev_entry, TensorEntry)
        and prev_entry.serializer == serializer
        and prev_entry.dtype == dtype
        and list(prev_entry.shape) == list(shape)
        and prev_entry.tile_rows
        and prev_entry.tile_checksums
        and prev_entry.tile_dedup_hashes
        and len(prev_entry.tile_checksums) == len(prev_entry.tile_dedup_hashes)
        # A compressed base's tile hashes are over stored bytes at
        # compressed offsets: it dedups whole-blob only.
        and not prev_entry.codec
    ):
        t = prev_entry.tile_rows
        n_rows = shape[0]
        row_nbytes = tensor_nbytes(dtype, shape[1:]) if len(shape) > 1 else tensor_nbytes(dtype, [1])
        base = prev_entry.byte_range[0] if prev_entry.byte_range else 0
        ndim = len(shape)
        out = {}
        for i, (crc, dh) in enumerate(
            zip(prev_entry.tile_checksums, prev_entry.tile_dedup_hashes)
        ):
            r0, r1 = i * t, min((i + 1) * t, n_rows)
            offsets = tuple([r0] + [0] * (ndim - 1))
            sizes = tuple([r1 - r0] + list(shape[1:]))
            out[(offsets, sizes)] = TensorEntry(
                location=prev_entry.location,
                serializer=serializer,
                dtype=dtype,
                shape=list(sizes),
                replicated=False,
                byte_range=[base + r0 * row_nbytes, base + r1 * row_nbytes],
                checksum=crc,
                dedup_hash=dh,
            )
        return t, out
    if (
        isinstance(prev_entry, ChunkedTensorEntry)
        and prev_entry.dtype == dtype
        and list(prev_entry.shape) == list(shape)
        and prev_entry.chunks
    ):
        chunks = sorted(prev_entry.chunks, key=lambda c: c.offsets[0])
        t = chunks[0].sizes[0]
        n_rows = shape[0]
        out = {}
        expect_r0 = 0
        for i, c in enumerate(chunks):
            r0 = c.offsets[0]
            r1 = r0 + c.sizes[0]
            last = i == len(chunks) - 1
            if (
                r0 != expect_r0
                or (not last and c.sizes[0] != t)
                or (last and r1 != n_rows)
                or any(o != 0 for o in c.offsets[1:])
                or list(c.sizes[1:]) != list(shape[1:])
                or c.tensor.serializer != serializer
                or c.tensor.checksum is None
                or c.tensor.dedup_hash is None
                or c.tensor.tile_rows  # an oversized chunk: not a tile grid
                or c.tensor.codec  # a compressed chunk dedups whole-blob only
            ):
                return None
            out[(tuple(c.offsets), tuple(c.sizes))] = c.tensor
            expect_r0 = r1
        if expect_r0 != n_rows or len(out) < 2:
            return None
        return t, out
    return None


class ChunkedArrayIOPreparer:
    @staticmethod
    def prepare_write(
        storage_path: str,
        arr: torch.Tensor,
        replicated: bool = False,
        is_async_snapshot: bool = False,
        array_prepare_func=None,
        array_prepare_traced=None,
        prev_entry=None,
        record_dedup_hashes: bool = False,
        chunk_rows: Optional[int] = None,
        prev_chunks: Optional[dict] = None,
    ) -> Tuple[ChunkedTensorEntry, List[WriteReq]]:
        """``chunk_rows``/``prev_chunks`` come from the tile-grain
        incremental route (``io_preparer.prepare_write``): chunks follow
        the base's checksum-tile grid instead of the chunk-size knob, and
        each dedups against the base tile of its rows. The geometry
        follows the transformed dtype; the transform runs per chunk at
        stage time."""
        if array_prepare_traced is not None:
            dtype, shape = array_prepare_traced[0], list(array_prepare_traced[1])
        else:
            dtype, shape = trace_array_prepare(arr, array_prepare_func)
        # Dedup against the base's chunks of the same rows; a changed
        # chunk-size knob shifts the boundaries and conservatively misses.
        if prev_chunks is None:
            prev_chunks = {}
            if isinstance(prev_entry, ChunkedTensorEntry):
                prev_chunks = {
                    (tuple(c.offsets), tuple(c.sizes)): c.tensor for c in prev_entry.chunks
                }
        if chunk_rows is not None:
            ranges = [
                (r0, min(r0 + chunk_rows, shape[0])) for r0 in range(0, shape[0], chunk_rows)
            ]
        else:
            ranges = chunk_row_ranges(shape, dtype, get_max_chunk_size_bytes())
        chunks: List[Chunk] = []
        write_reqs: List[WriteReq] = []
        for r0, r1 in ranges:
            location = f"{storage_path}_{r0}_0"
            offsets = [r0] + [0] * (len(shape) - 1)
            sizes = [r1 - r0] + shape[1:]
            tensor_entry = TensorEntry(
                location=location,
                serializer=Serializer.BUFFER_PROTOCOL.value,
                dtype=dtype,
                shape=list(sizes),
                replicated=replicated,
            )
            chunks.append(Chunk(offsets=offsets, sizes=sizes, tensor=tensor_entry))
            stager = ArrayBufferStager(
                arr[r0:r1],
                entry=tensor_entry,
                is_async_snapshot=is_async_snapshot,
                array_prepare_func=array_prepare_func,
                dedup_entry=prev_chunks.get((tuple(offsets), tuple(sizes))),
                record_dedup_hashes=record_dedup_hashes,
            )
            write_reqs.append(WriteReq(path=location, buffer_stager=stager))
        entry = ChunkedTensorEntry(dtype=dtype, shape=shape, chunks=chunks, replicated=replicated)
        return entry, write_reqs

    @staticmethod
    def prepare_read(
        entry: ChunkedTensorEntry,
        obj_out: Optional[torch.Tensor] = None,
        buffer_size_limit_bytes: Optional[int] = None,
        logical_path: str = "",
    ) -> Tuple[List[ReadReq], Future]:
        """Each chunk is read as a dense tensor into ``dest[r0:r1]``:
        ``obj_out`` itself when it is a contiguous tensor of the stored
        dtype and shape (in place, on its device), else a fresh host
        tensor that is handed to ``finalize_into_target`` once every
        chunk has landed."""
        fut: Future = Future()
        torch_dtype = string_to_dtype(entry.dtype)
        in_place = (
            isinstance(obj_out, torch.Tensor)
            and obj_out.dtype == torch_dtype
            and list(obj_out.shape) == list(entry.shape)
            and obj_out.is_contiguous()
        )
        # Chunked entries are above the chunk size by construction: a fresh
        # destination is advised before its first touch.
        dest = obj_out if in_place else _native.empty_advised(entry.shape, torch_dtype)
        ready = _record_ready(obj_out) if isinstance(obj_out, torch.Tensor) else None
        remaining = {"count": len(entry.chunks)}
        read_reqs: List[ReadReq] = []
        for chunk in entry.chunks:
            r0 = chunk.offsets[0]
            r1 = r0 + chunk.sizes[0]
            reqs, _ = ArrayIOPreparer.prepare_read(
                chunk.tensor,
                dest[r0:r1],
                buffer_size_limit_bytes,
                logical_path=f"{logical_path or chunk.tensor.location} (chunk @ row {r0})",
            )
            for rr in reqs:
                rr.logical_path = logical_path
                rr.buffer_consumer = _ChunkCompletion(
                    rr.buffer_consumer, remaining, fut, dest, obj_out, in_place, ready
                )
            remaining["count"] += len(reqs) - 1
            read_reqs.extend(reqs)
        return read_reqs, fut


class _ChunkCompletion(BufferConsumer):
    """Wraps one read of a chunked tensor; the last of them to finish
    resolves the tensor's future."""

    def __init__(self, inner, remaining, fut, dest, obj_out, in_place, ready) -> None:
        self.inner = inner
        self.remaining = remaining
        self.fut = fut
        self.dest = dest
        self.obj_out = obj_out
        self.in_place = in_place
        self.ready = ready

    async def consume_read_io(self, read_io, executor: Optional[Executor] = None) -> None:
        await self.inner.consume_read_io(read_io, executor)
        await self._done(executor)

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        await self.inner.consume_buffer(buf, executor)
        await self._done(executor)

    async def _done(self, executor: Optional[Executor]) -> None:
        # Completion bookkeeping stays on the event-loop thread.
        self.remaining["count"] -= 1
        if self.remaining["count"]:
            return
        if self.in_place:
            self.fut.obj = self.obj_out
        else:
            self.fut.obj = await _run(
                executor, finalize_into_target, self.dest, self.obj_out, True, self.ready
            )

    def get_consuming_cost_bytes(self) -> int:
        return self.inner.get_consuming_cost_bytes()
