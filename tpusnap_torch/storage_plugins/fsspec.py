"""Generic fsspec bridge plugin: ``fsspec+<protocol>://path``.

Counterpart of tpusnap/storage_plugins/fsspec.py: opens every
fsspec-supported backend (memory, http, sftp, az, …) through the same
StoragePlugin interface, with blocking fsspec calls run in a thread pool.

fsspec's in-process memory store keeps each file as a ``BytesIO``. A
blob goes in as one copy into a fresh ``bytes`` object, made with the
GIL released (``_native.copy_to_bytes``), which the stored file shares
rather than copies; its size is read from that object. Every other
backend gets the staged buffer's bytes written as they are.
"""

import asyncio
import functools
import io
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

from .. import _native, telemetry
from ..io_types import ReadIO, StoragePlugin, WriteIO


@functools.lru_cache(maxsize=None)
def _shared_file_class():
    from fsspec.implementations.memory import MemoryFile

    class SharedMemoryFile(MemoryFile):
        """A ``MemoryFile`` over the ``bytes`` object it was built from.
        ``MemoryFile.size`` calls ``getbuffer()``, which copies the whole
        buffer while another reference to it lives (a whole-file read
        returns the object itself); ``getvalue()`` returns the object."""

        @property
        def size(self):
            return len(self.getvalue())

    return SharedMemoryFile


class FsspecStoragePlugin(StoragePlugin):
    # Wrapped in the whole-op retry middleware when built from a URL:
    # fsspec backends span everything from in-memory dicts to SFTP — the
    # default connection/timeout/errno classifier is the right generic
    # net for them.
    wants_retry_middleware = True

    def __init__(
        self,
        protocol: str,
        root: str,
        storage_options: Optional[Dict[str, Any]] = None,
    ) -> None:
        import fsspec
        from fsspec.implementations.memory import MemoryFileSystem

        self._fs = fsspec.filesystem(protocol, **(storage_options or {}))
        self._memory = isinstance(self._fs, MemoryFileSystem)
        self.root = root
        self._executor = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="tpusnap-fsspec"
        )

    def _full(self, path: str) -> str:
        # normpath collapses "../" segments: incremental snapshots
        # reference base-snapshot blobs relative to their own root.
        import posixpath

        return posixpath.normpath(f"{self.root}/{path}") if self.root else path

    def _write_blocking(self, path: str, buf) -> int:
        full = self._full(path)
        parent = full.rsplit("/", 1)[0]
        if parent:
            try:
                self._fs.makedirs(parent, exist_ok=True)
            except Exception:
                pass  # object stores have no directories
        mv = memoryview(buf).cast("B")
        if self._memory:
            # What MemoryFileSystem.open(full, "wb", data=blob) stores
            # outside a transaction, with a size that needs no copy. One
            # copy thread a blob: the executor runs up to 8 writes.
            blob = _native.copy_to_bytes(mv, nthreads=1)
            key = self._fs._strip_protocol(full)
            _shared_file_class()(self._fs, key, blob).commit()
        else:
            with self._fs.open(full, "wb") as f:
                f.write(mv)
        return mv.nbytes

    def _read_blocking(self, path: str, byte_range) -> bytes:
        full = self._full(path)
        with self._fs.open(full, "rb") as f:
            if byte_range is None:
                return f.read()
            offset, end = byte_range
            f.seek(offset)
            return f.read(end - offset)

    async def write(self, write_io: WriteIO) -> None:
        loop = asyncio.get_running_loop()
        nbytes = await loop.run_in_executor(
            self._executor, self._write_blocking, write_io.path, write_io.buf
        )
        # Counted here, on the event loop's thread, where the ambient
        # recorder is the take's.
        name = "fsspec.direct_bytes" if self._memory else "fsspec.buffered_bytes"
        telemetry.incr(name, nbytes)

    async def read(self, read_io: ReadIO) -> None:
        loop = asyncio.get_running_loop()
        data = await loop.run_in_executor(
            self._executor, self._read_blocking, read_io.path, read_io.byte_range
        )
        read_io.buf = io.BytesIO(data)

    async def delete(self, path: str) -> None:
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(self._executor, self._fs.rm, self._full(path))

    async def close(self) -> None:
        from ..io_types import shutdown_plugin_executor

        shutdown_plugin_executor(self._executor)
