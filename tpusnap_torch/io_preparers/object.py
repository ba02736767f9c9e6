"""Fallback preparer for arbitrary picklable objects.

Counterpart of tpusnap/io_preparers/object.py (copied): objects are
pickled eagerly at prepare time — they are small in practice (configs,
schedules, metrics), and it makes both the staging cost and the manifest
``nbytes`` exact, which the read scheduler's memory budget relies on.
"""

from __future__ import annotations

import asyncio
from concurrent.futures import Executor
from typing import Any, List, Optional, Tuple

from .. import _native
from ..io_types import (
    BufferConsumer,
    BufferStager,
    BufferType,
    Future,
    ReadReq,
    WriteReq,
)
from ..knobs import is_checksum_disabled
from ..manifest import ObjectEntry
from ..serialization import Serializer, pickle_as_bytes, pickle_from_bytes


class ObjectBufferStager(BufferStager):
    # Pickled at prepare time: an async take's caller may change the
    # object as soon as control returns.
    frozen = True

    def __init__(self, buf: bytes) -> None:
        self.buf = buf

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        return self.buf

    def get_staging_cost_bytes(self) -> int:
        return len(self.buf)


class ObjectBufferConsumer(BufferConsumer):
    def __init__(
        self,
        fut: Future,
        nbytes: int,
        checksum: Optional[str] = None,
        location: str = "",
    ) -> None:
        self.fut = fut
        self.nbytes = nbytes
        self.checksum = checksum
        self.location = location

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        from .array import _maybe_verify

        _maybe_verify(buf, self.checksum, self.location)
        if executor is not None:
            loop = asyncio.get_running_loop()
            self.fut.obj = await loop.run_in_executor(
                executor, pickle_from_bytes, bytes(buf)
            )
        else:
            self.fut.obj = pickle_from_bytes(bytes(buf))

    def get_consuming_cost_bytes(self) -> int:
        return max(self.nbytes, 1)


class ObjectIOPreparer:
    @staticmethod
    def prepare_write(
        storage_path: str, obj: Any, replicated: bool = False, prev_entry: Any = None
    ) -> Tuple[ObjectEntry, List[WriteReq]]:
        buf = pickle_as_bytes(obj)
        checksum = None
        dedup_hash = None
        if not is_checksum_disabled():
            checksum = _native.checksum_string(buf)
            dedup_hash = _native.dedup_hash_string(buf)
        entry = ObjectEntry(
            location=storage_path,
            serializer=Serializer.PICKLE.value,
            obj_type=type(obj).__name__,
            replicated=replicated,
            nbytes=len(buf),
            checksum=checksum,
            dedup_hash=dedup_hash,
        )
        # Incremental dedup: the object is pickled and hashed here, so an
        # unchanged one needs no write request at all. Both the CRC and
        # the 64-bit hash must match the base's.
        if (
            isinstance(prev_entry, ObjectEntry)
            and checksum is not None
            and prev_entry.checksum == checksum
            and dedup_hash is not None
            and prev_entry.dedup_hash == dedup_hash
            and prev_entry.nbytes == len(buf)
            and prev_entry.serializer == entry.serializer
        ):
            entry.location = prev_entry.location
            return entry, []
        return entry, [WriteReq(path=storage_path, buffer_stager=ObjectBufferStager(buf))]

    @staticmethod
    def prepare_read(
        entry: ObjectEntry, logical_path: str = ""
    ) -> Tuple[List[ReadReq], Future]:
        fut: Future = Future()
        consumer = ObjectBufferConsumer(
            fut,
            nbytes=entry.nbytes or 0,
            checksum=entry.checksum,
            location=logical_path or entry.location,
        )
        return [
            ReadReq(path=entry.location, buffer_consumer=consumer, logical_path=logical_path)
        ], fut
