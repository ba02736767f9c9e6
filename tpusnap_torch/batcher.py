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
members are packed on the host. Chunks of chunked tensors are slab
candidates too, as in tpusnap. On read, byte-ranged requests against
the same location are merged into one spanning read and sliced back out.

Async takes: a device slab outside the first window is packed when the
take freezes its CUDA sources — the pack is already a device copy, so
the packed slab is the frozen state. A host slab copies its members'
live bytes at staging time; COW members are verified against that copy
at once, since the write pipeline only sees the slab.

Incremental takes dedup per member: a member whose bytes match its base
entry is dropped from the slab (its entry re-pointed at the base's byte
range) and the survivors are compacted; a slab left empty is not
written. A member with a save-time transform never goes into a device
slab (the pack copies the untransformed bytes); it is host-packed, and
its own stager transforms it on the card.
"""

from __future__ import annotations

import asyncio
import ctypes
import threading
import uuid
from concurrent.futures import Executor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _native, telemetry
from ._staging_pool import release
from .io_preparers.array import (
    ArrayBufferStager,
    _adopt_base_location,
    _record_checksums,
    dedup_entries_match,
    enqueue_dtoh,
    event_on,
    wait_dtoh,
)
from .io_types import (
    SKIP_WRITE,
    BufferConsumer,
    BufferStager,
    BufferType,
    ReadReq,
    WriteReq,
)
from .knobs import (
    get_slab_size_threshold_bytes,
    is_batching_disabled,
    is_checksum_disabled,
    is_device_batching_disabled,
)
from .manifest import ChunkedTensorEntry, Entry, TensorEntry
from .serialization import tensor_nbytes


class BatchedBufferStager(BufferStager):
    """Stages all members into one contiguous aligned host slab."""

    def __init__(self, members: List[Tuple[int, int, BufferStager]]) -> None:
        # members: [(offset, nbytes, stager)]
        self.members = members
        self.total = sum(n for _, n, _ in members)

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        slab = _native.aligned_empty(self.total)
        skipped = [False] * len(self.members)

        async def fill(i: int, offset: int, nbytes: int, stager: BufferStager) -> None:
            buf = await stager.stage_buffer(executor)
            if buf is SKIP_WRITE:
                skipped[i] = True  # the member dedup'd against its base
                return
            mv = memoryview(buf).cast("B")
            if mv.nbytes != nbytes:
                raise RuntimeError(
                    f"Batched member staged {mv.nbytes} bytes, expected {nbytes}"
                )
            slab[offset : offset + nbytes] = np.frombuffer(mv, dtype=np.uint8)
            del mv
            if getattr(stager, "cow_pending", False):
                # A COW member staged the live bytes and the slab copy is
                # its clone: verify that copy against the hash taken from
                # the live tensor now.
                stager.verify_cow_after_write(slab[offset : offset + nbytes])
                stager.cow_pending = False
            release(buf)  # a member's clone goes back to the pool

        await asyncio.gather(
            *(fill(i, o, n, s) for i, (o, n, s) in enumerate(self.members))
        )
        if not any(skipped):
            return slab
        # Compact in place around the dedup'd members (memmove: source and
        # destination overlap) and return a view of the kept prefix.
        new_offset = 0
        for i, (offset, nbytes, stager) in enumerate(self.members):
            if skipped[i]:
                continue
            if new_offset != offset:
                ctypes.memmove(slab.ctypes.data + new_offset, slab.ctypes.data + offset, nbytes)
            if stager.entry is not None:
                stager.entry.byte_range = [new_offset, new_offset + nbytes]
            new_offset += nbytes
        if new_offset == 0:
            return SKIP_WRITE
        return slab[:new_offset]

    def get_staging_cost_bytes(self) -> int:
        # The slab plus transiently one member's own staging cost.
        return self.total + max(
            (s.get_staging_cost_bytes() for _, _, s in self.members), default=0
        )

    def get_planned_bytes(self) -> int:
        # The slab payload: members stream through transient buffers that
        # never count toward written bytes.
        return self.total


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
    memory. The pack runs on a side stream after every member's ready
    event, so it reads the state as of ``take``; an async take packs the
    slabs it has not staged when it freezes its CUDA sources."""

    def __init__(self, members: List[Tuple[int, int, ArrayBufferStager]]) -> None:
        self.members = members
        self.total = sum(n for _, n, _ in members)
        self.cuda_device = members[0][2].arr.device
        # As in ArrayBufferStager: the pack and the DtoH enqueue happen
        # under the lock, exclusive with freeze().
        self._lock = threading.Lock()
        self._packed: Optional[Tuple[torch.Tensor, "torch.cuda.Event"]] = None
        self._dtoh_done: Optional["torch.cuda.Event"] = None

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        if executor is not None:
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(executor, self._stage_blocking)
        return self._stage_blocking()

    def _pack_on(self, stream: "torch.cuda.Stream") -> Tuple[torch.Tensor, "torch.cuda.Event"]:
        stagers = [s for _, _, s in self.members]
        with torch.cuda.stream(stream):
            for s in stagers:
                stream.wait_event(s.ready)
            packed = _pack_members([s.arr for s in stagers])
        return packed, event_on(stream)

    def pending_device_bytes(self) -> int:
        """Device bytes ``freeze`` would pack."""
        return 0 if self.frozen or self._dtoh_done is not None else self.total

    def freeze(self, stream: "torch.cuda.Stream") -> None:
        """Pack on ``stream`` now (a slab has at least two members, so the
        pack is a copy), or wait there for the DtoH already enqueued."""
        with self._lock:
            if self._dtoh_done is not None:
                stream.wait_event(self._dtoh_done)
            else:
                self._packed = self._pack_on(stream)
            self.frozen = True

    def _stage_blocking(self) -> BufferType:
        rec = telemetry.current()
        t0 = rec.now() if rec is not None and rec.enabled else None
        with telemetry.profiler_range("dtoh"):
            with self._lock:
                if self._packed is None:
                    self._packed = self._pack_on(torch.cuda.Stream(device=self.cuda_device))
                host, done, timing = enqueue_dtoh(*self._packed)
                self._dtoh_done = done
            wait_dtoh(done, timing)
        if t0 is not None:
            rec.record_span("dtoh", t0, rec.now() - t0, bytes=host.numel())
        self._packed = None
        if host.numel() != self.total:
            raise RuntimeError(
                f"device-packed slab is {host.numel()} bytes, expected {self.total}"
            )
        mv = memoryview(host.numpy())
        if is_checksum_disabled():
            return mv
        # The member stagers are bypassed: record their checksums from the
        # slab slices, as the host path does inside each member, and drop
        # the members that match their base entry.
        keep: List[Tuple[int, int, ArrayBufferStager]] = []
        for offset, nbytes, stager in self.members:
            if stager.entry is None:
                keep.append((offset, nbytes, stager))
                continue
            _record_checksums(
                stager.entry, mv[offset : offset + nbytes], stager.record_dedup_hashes
            )
            if stager.dedup_entry is not None and dedup_entries_match(
                stager.entry, stager.dedup_entry
            ):
                _adopt_base_location(stager.entry, stager.dedup_entry)
                continue
            keep.append((offset, nbytes, stager))
        if not keep:
            return SKIP_WRITE
        if len(keep) == len(self.members):
            return mv
        # The survivors are compacted into an aligned host buffer; the
        # pinned slab goes back to its pool when this returns.
        out = _native.aligned_empty(sum(n for _, n, _ in keep))
        new_offset = 0
        for offset, nbytes, stager in keep:
            out[new_offset : new_offset + nbytes] = np.frombuffer(
                mv[offset : offset + nbytes], dtype=np.uint8
            )
            if stager.entry is not None:
                stager.entry.byte_range = [new_offset, new_offset + nbytes]
            new_offset += nbytes
        return out

    def get_staging_cost_bytes(self) -> int:
        # A partial dedup holds the pinned slab and the compacted copy at
        # once: 2x whenever a member may dedup.
        if any(s.dedup_entry is not None for _, _, s in self.members):
            return 2 * self.total
        return self.total

    def get_planned_bytes(self) -> int:
        # The slab payload, never the 2x dedup-compaction budget.
        return self.total


def _device_group_key(stager: BufferStager) -> Optional[str]:
    """CUDA tensor members share a key per device (device packing);
    ``None`` → host packing, also for every member when
    ``TPUSNAP_DISABLE_DEVICE_BATCHING=1``."""
    if (
        not is_device_batching_disabled()
        and isinstance(stager, ArrayBufferStager)
        and stager.arr.is_cuda
        # The device pack copies the untransformed bytes; a transform must
        # run in the member's own staging.
        and stager.array_prepare_func is None
    ):
        return str(stager.arr.device)
    return None


def _batchable_tensor_entries(entries: List[Entry]) -> Dict[str, TensorEntry]:
    """location → TensorEntry of every dense tensor blob, chunks included."""
    out: Dict[str, TensorEntry] = {}
    for entry in entries:
        if isinstance(entry, TensorEntry):
            out[entry.location] = entry
        elif isinstance(entry, ChunkedTensorEntry):
            for chunk in entry.chunks:
                out[chunk.tensor.location] = chunk.tensor
    return out


def batch_write_requests(
    entries: List[Entry], write_reqs: List[WriteReq]
) -> Tuple[List[Entry], List[WriteReq]]:
    """Pack small tensor writes into slabs, rewriting entries in place."""
    threshold = get_slab_size_threshold_bytes()
    if is_batching_disabled():
        return entries, write_reqs

    entry_by_location = _batchable_tensor_entries(entries)
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
                # Each member keeps its own leaf and range in the access
                # ledger, not the opaque spanning read.
                access_parts=[
                    (r.logical_path, r.byte_range[0], r.byte_range[1])
                    for r in reqs
                    if r.logical_path
                ]
                or None,
            )
        )
    return out
