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
CUDA target — through the dense preparer (budget-tiled when asked). A
target that cannot take the bytes in place (another dtype, shape or
layout) gets them assembled in one host tensor first and then handed on
as a dense restore would.

Not here yet: ``tile_prev_map`` (tile-grain incremental dedup) and
compressed chunks belong to ``incremental_from`` and compression, ROADMAP
item 3; both raise.
"""

from __future__ import annotations

from concurrent.futures import Executor
from typing import List, Optional, Tuple

import torch

from ..io_types import BufferConsumer, BufferType, Future, ReadReq, WriteReq
from ..knobs import get_max_chunk_size_bytes
from ..manifest import Chunk, ChunkedTensorEntry, TensorEntry
from ..serialization import (
    Serializer,
    dtype_to_string,
    string_to_dtype,
    tensor_nbytes,
)
from .array import (
    ArrayBufferStager,
    ArrayIOPreparer,
    _record_ready,
    _run,
    array_nbytes,
    finalize_into_target,
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


def tile_prev_map(prev_entry, dtype: str, shape: List[int]):
    raise NotImplementedError(
        "tile-grain incremental dedup is not ported to tpusnap_torch yet "
        "(ROADMAP.md item 3)"
    )


class ChunkedArrayIOPreparer:
    @staticmethod
    def prepare_write(
        storage_path: str,
        arr: torch.Tensor,
        replicated: bool = False,
        is_async_snapshot: bool = False,
    ) -> Tuple[ChunkedTensorEntry, List[WriteReq]]:
        dtype, shape = dtype_to_string(arr.dtype), list(arr.shape)
        chunks: List[Chunk] = []
        write_reqs: List[WriteReq] = []
        for r0, r1 in chunk_row_ranges(shape, dtype, get_max_chunk_size_bytes()):
            location = f"{storage_path}_{r0}_0"
            sizes = [r1 - r0] + shape[1:]
            tensor_entry = TensorEntry(
                location=location,
                serializer=Serializer.BUFFER_PROTOCOL.value,
                dtype=dtype,
                shape=list(sizes),
                replicated=replicated,
            )
            chunks.append(
                Chunk(offsets=[r0] + [0] * (len(shape) - 1), sizes=sizes, tensor=tensor_entry)
            )
            stager = ArrayBufferStager(
                arr[r0:r1], entry=tensor_entry, is_async_snapshot=is_async_snapshot
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
        dest = obj_out if in_place else torch.empty(tuple(entry.shape), dtype=torch_dtype)
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
