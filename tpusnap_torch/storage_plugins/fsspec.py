"""Generic fsspec bridge plugin: ``fsspec+<protocol>://path``.

Counterpart of tpusnap/storage_plugins/fsspec.py: opens every
fsspec-supported backend (memory, http, sftp, az, …) through the same
StoragePlugin interface, with blocking fsspec calls run in a thread pool.
"""

import asyncio
import io
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

from ..io_types import ReadIO, StoragePlugin, WriteIO


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

        self._fs = fsspec.filesystem(protocol, **(storage_options or {}))
        self.root = root
        self._executor = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="tpusnap-fsspec"
        )

    def _full(self, path: str) -> str:
        # normpath collapses "../" segments: incremental snapshots
        # reference base-snapshot blobs relative to their own root.
        import posixpath

        return posixpath.normpath(f"{self.root}/{path}") if self.root else path

    def _write_blocking(self, path: str, buf) -> None:
        full = self._full(path)
        parent = full.rsplit("/", 1)[0]
        if parent:
            try:
                self._fs.makedirs(parent, exist_ok=True)
            except Exception:
                pass  # object stores have no directories
        with self._fs.open(full, "wb") as f:
            f.write(bytes(buf))

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
        await loop.run_in_executor(
            self._executor, self._write_blocking, write_io.path, write_io.buf
        )

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
