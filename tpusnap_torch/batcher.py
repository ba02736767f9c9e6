"""Request batcher: coalesce small writes into slabs; merge adjacent
byte-ranged reads into spanning reads.

Counterpart of tpusnap/batcher.py. Small (< slab threshold) tensor writes
are packed into uuid-named slab objects under ``batched/``; each member's
TensorEntry is rewritten in place to point at ``(slab_location,
byte_range)``. The slab layout is tpusnap's byte for byte: members in
order, each the row-major bytes of its tensor, bool as one 0/1 byte.

Same-device CUDA members are packed ON THE CARD — ``_pack_members``
concatenates their ``uint8`` views in one ``torch.cat`` — and the whole
slab crosses to the host in ONE device→host copy, the counterpart of
tpusnap's jitted XLA pack (``tpusnap/batcher.py::_pack_members``). CPU
members are packed on the host. On read, byte-ranged requests against
the same location are merged into one spanning read and sliced back out.
"""

from __future__ import annotations

import asyncio
import uuid
from concurrent.futures import Executor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _native
from .io_preparers.array import (
    ArrayBufferStager,
    _record_checksums,
    enqueue_dtoh,
)
from .io_types import BufferConsumer, BufferStager, BufferType, ReadReq, WriteReq
from .knobs import (
    get_slab_size_threshold_bytes,
    is_batching_disabled,
    is_checksum_disabled,
)
from .manifest import Entry, TensorEntry
from .serialization import tensor_nbytes


class BatchedBufferStager(BufferStager):
    """Stages all members into one contiguous aligned host slab."""

    def __init__(self, members: List[Tuple[int, int, BufferStager]]) -> None:
        # members: [(offset, nbytes, stager)]
        self.members = members
        self.total = sum(n for _, n, _ in members)

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        slab = _native.aligned_empty(self.total)

        async def fill(offset: int, nbytes: int, stager: BufferStager) -> None:
            mv = memoryview(await stager.stage_buffer(executor)).cast("B")
            if mv.nbytes != nbytes:
                raise RuntimeError(
                    f"Batched member staged {mv.nbytes} bytes, expected {nbytes}"
                )
            slab[offset : offset + nbytes] = np.frombuffer(mv, dtype=np.uint8)

        await asyncio.gather(*(fill(o, n, s) for o, n, s in self.members))
        return slab

    def get_staging_cost_bytes(self) -> int:
        # The slab plus transiently one member's own staging cost.
        return self.total + max(
            (s.get_staging_cost_bytes() for _, _, s in self.members), default=0
        )


def _pack_members(arrs: List[torch.Tensor]) -> torch.Tensor:
    """Flat ``uint8`` view of every member, concatenated on their device."""
    flat = []
    for a in arrs:
        a = a.detach()
        if a.dtype == torch.bool:
            a = a.to(torch.uint8)  # bool is 1 byte, values 0/1
        flat.append(a.reshape(-1).view(torch.uint8))
    return torch.cat(flat) if len(flat) > 1 else flat[0]


class DeviceBatchedBufferStager(BufferStager):
    """Packs same-device CUDA members into one ``uint8`` tensor on the
    card, then makes ONE device→host copy of the whole slab into pinned
    memory. The pack runs on the copy's side stream after every member's
    ready event, so it reads the state as of ``take``."""

    def __init__(self, members: List[Tuple[int, int, ArrayBufferStager]]) -> None:
        self.members = members
        self.total = sum(n for _, n, _ in members)

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        if executor is not None:
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(executor, self._stage_blocking)
        return self._stage_blocking()

    def _stage_blocking(self) -> BufferType:
        stagers = [s for _, _, s in self.members]
        device = stagers[0].arr.device
        stream = torch.cuda.Stream(device=device)
        with torch.cuda.stream(stream):
            for s in stagers:
                stream.wait_event(s.ready)
            packed = _pack_members([s.arr for s in stagers])
        host, done = enqueue_dtoh(packed, _event_on(stream))
        done.synchronize()
        if host.numel() != self.total:
            raise RuntimeError(
                f"device-packed slab is {host.numel()} bytes, expected {self.total}"
            )
        mv = memoryview(host.numpy())
        if not is_checksum_disabled():
            # The member stagers are bypassed: record their checksums from
            # the slab slices, as the host path does inside each member.
            for offset, nbytes, stager in self.members:
                if stager.entry is not None:
                    _record_checksums(stager.entry, mv[offset : offset + nbytes])
        return mv

    def get_staging_cost_bytes(self) -> int:
        return self.total


def _event_on(stream: "torch.cuda.Stream") -> "torch.cuda.Event":
    event = torch.cuda.Event()
    event.record(stream)
    return event


def _device_group_key(stager: BufferStager) -> Optional[str]:
    """CUDA tensor members share a key per device (device packing);
    ``None`` → host packing."""
    if isinstance(stager, ArrayBufferStager) and stager.arr.is_cuda:
        return str(stager.arr.device)
    return None


def batch_write_requests(
    entries: List[Entry], write_reqs: List[WriteReq]
) -> Tuple[List[Entry], List[WriteReq]]:
    """Pack small tensor writes into slabs, rewriting entries in place."""
    threshold = get_slab_size_threshold_bytes()
    if is_batching_disabled():
        return entries, write_reqs

    entry_by_location: Dict[str, TensorEntry] = {
        e.location: e for e in entries if isinstance(e, TensorEntry)
    }
    candidates: List[WriteReq] = []
    passthrough: List[WriteReq] = []
    for wr in write_reqs:
        stager = wr.buffer_stager
        if (
            isinstance(stager, ArrayBufferStager)
            and wr.path in entry_by_location
            and stager.get_staging_cost_bytes() < threshold
        ):
            candidates.append(wr)
        else:
            passthrough.append(wr)
    if len(candidates) < 2:
        return entries, write_reqs

    batched_reqs: List[WriteReq] = []
    slab_members: List[Tuple[int, int, BufferStager]] = []
    slab_entries: List[TensorEntry] = []
    slab_device: Optional[str] = None
    offset = 0

    def flush() -> None:
        nonlocal offset, slab_members, slab_entries
        if not slab_members:
            return
        if len(slab_members) == 1:
            # A slab of one is pointless; leave the request as-is.
            passthrough.append(
                WriteReq(path=slab_entries[0].location, buffer_stager=slab_members[0][2])
            )
        else:
            location = f"batched/{uuid.uuid4().hex}"
            for (member_offset, nbytes, _), tensor_entry in zip(
                slab_members, slab_entries
            ):
                tensor_entry.location = location
                tensor_entry.byte_range = [member_offset, member_offset + nbytes]
            stager_cls = (
                DeviceBatchedBufferStager
                if slab_device is not None
                else BatchedBufferStager
            )
            batched_reqs.append(
                WriteReq(path=location, buffer_stager=stager_cls(list(slab_members)))
            )
        offset = 0
        slab_members = []
        slab_entries = []

    # Stable-sort by device group so same-device members share a slab.
    keyed = [(_device_group_key(wr.buffer_stager), wr) for wr in candidates]
    keyed.sort(key=lambda kv: kv[0] or "")
    for device_key, wr in keyed:
        tensor_entry = entry_by_location[wr.path]
        nbytes = tensor_nbytes(tensor_entry.dtype, tensor_entry.shape)
        if slab_members and (
            offset + nbytes > threshold or device_key != slab_device
        ):
            flush()
        slab_device = device_key
        slab_members.append((offset, nbytes, wr.buffer_stager))
        slab_entries.append(tensor_entry)
        offset += nbytes
    flush()

    return entries, passthrough + batched_reqs


class _SpanningConsumer(BufferConsumer):
    """Feeds slices of one spanning read to the member consumers."""

    def __init__(
        self, span_start: int, members: List[Tuple[Tuple[int, int], BufferConsumer]]
    ) -> None:
        self.span_start = span_start
        self.members = members

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        mv = memoryview(buf).cast("B")
        for (start, end), consumer in self.members:
            await consumer.consume_buffer(
                mv[start - self.span_start : end - self.span_start], executor
            )

    def get_consuming_cost_bytes(self) -> int:
        return sum(c.get_consuming_cost_bytes() for _, c in self.members)


def batch_read_requests(read_reqs: List[ReadReq]) -> List[ReadReq]:
    """Merge byte-ranged reads per location into one spanning read when the
    span is dense enough that one request beats many."""
    by_location: Dict[str, List[ReadReq]] = {}
    passthrough: List[ReadReq] = []
    for rr in read_reqs:
        if rr.byte_range is not None:
            by_location.setdefault(rr.path, []).append(rr)
        else:
            passthrough.append(rr)

    out = list(passthrough)
    for location, reqs in by_location.items():
        if len(reqs) == 1:
            out.extend(reqs)
            continue
        reqs.sort(key=lambda r: r.byte_range[0])
        span_start = reqs[0].byte_range[0]
        span_end = max(r.byte_range[1] for r in reqs)
        total = sum(r.byte_range[1] - r.byte_range[0] for r in reqs)
        if total < (span_end - span_start) * 0.5:
            out.extend(reqs)  # sparse: a spanning read would over-fetch
            continue
        out.append(
            ReadReq(
                path=location,
                byte_range=(span_start, span_end),
                buffer_consumer=_SpanningConsumer(
                    span_start,
                    [(tuple(r.byte_range), r.buffer_consumer) for r in reqs],
                ),
            )
        )
    return out
