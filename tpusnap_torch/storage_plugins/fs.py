"""Local/posix filesystem storage plugin.

Counterpart of tpusnap/storage_plugins/fs.py: a mkdir cache so each
directory is created once, whole-buffer writes and ranged reads on a
thread pool through the native helper (GIL released, O_DIRECT for large
streams), and in-place reads that land straight in the consumer's
buffer with the CRC32C fused into the copy-out. The aiofiles path of
tpusnap is not carried over: every request runs on the thread pool.

Under ``TPUSNAP_DURABLE_COMMIT=1`` every blob is fsync'd after its write
and ``flush_created_dirs`` fsyncs the directories this instance created,
as tpusnap does, so the commit that follows declares a snapshot whose
data and dirents are on stable storage.
"""

import asyncio
import io
import os
import pathlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Set

from .. import _native
from ..io_types import ReadIO, StoragePlugin, WriteIO
from ..knobs import get_direct_io_qd, is_durable_commit_enabled
from ..memoryview_stream import MemoryviewStream

_NATIVE_READ_THRESHOLD = 4 * 1024 * 1024


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class FSStoragePlugin(StoragePlugin):
    supports_in_place_reads = True
    # Whole-op retry middleware (``retry``) wraps this plugin when it is
    # built from a URL, as tpusnap's: local filesystems rarely throw
    # transient errors, but network mounts (NFS/FUSE) and chaos runs do.
    wants_retry_middleware = True

    def __init__(self, root: str, storage_options=None) -> None:
        self.root = root
        self._dir_cache: Set[pathlib.Path] = set()
        self._executor: Optional[ThreadPoolExecutor] = None

    def in_place_read_overhead_bytes(self, nbytes: int) -> int:
        """Per-stream bounce memory of the native in-place read engine
        ((qd+1) x 8 MiB chunks, clamped to the read window)."""
        qd = min(max(get_direct_io_qd(), 1), 8)
        return min(nbytes, (qd + 1) * 8 * 1024 * 1024)

    def _ensure_parent(self, path: pathlib.Path) -> None:
        parent = path.parent
        if parent not in self._dir_cache:
            parent.mkdir(parents=True, exist_ok=True)
            self._dir_cache.add(parent)

    def _get_executor(self) -> ThreadPoolExecutor:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="tpusnap-torch-fs"
            )
        return self._executor

    async def _run(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(
            self._get_executor(), fn, *args
        )

    async def write(self, write_io: WriteIO) -> None:
        path = pathlib.Path(os.path.join(self.root, write_io.path))
        self._ensure_parent(path)
        await self._run(_native.write_file, str(path), write_io.buf)
        if is_durable_commit_enabled():
            # fsync of the metadata file does not write back other files'
            # dirty pages: each blob's data is made durable before the
            # commit can declare the snapshot durable.
            await self._run(_fsync_path, str(path))

    async def write_atomic(self, write_io: WriteIO, durable: bool = False) -> None:
        """Temp file + rename: a crash mid-write never leaves a torn file
        at the destination. ``durable`` fsyncs the temp file before the
        rename, then the parent directory and every directory this
        instance created, so the dirents of the blobs written before the
        commit become durable with it."""
        path = pathlib.Path(os.path.join(self.root, write_io.path))
        self._ensure_parent(path)
        tmp = path.with_name(path.name + f".tmp.{os.getpid()}")

        def work():
            try:
                _native.write_file(str(tmp), write_io.buf)
                if durable:
                    _fsync_path(str(tmp))
                os.replace(tmp, path)
                if durable:
                    for d in {str(p) for p in self._dir_cache} | {str(path.parent)}:
                        _fsync_path(d)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

        await self._run(work)

    async def read(self, read_io: ReadIO) -> None:
        path = os.path.join(self.root, read_io.path)
        if read_io.byte_range is not None:
            offset, end = read_io.byte_range
        else:
            offset, end = 0, os.path.getsize(path)
        n = end - offset
        # Exact-size match only: a truncated blob must fall through to the
        # generic path, whose deserialize raises on the size mismatch.
        if read_io.into is not None and n == read_io.into.nbytes:
            await self._read_into(read_io, path, offset, n)
            return
        if n >= _NATIVE_READ_THRESHOLD:
            read_io.buf = await self._native_read(path, offset, n, read_io)
            return

        def work():
            with open(path, "rb") as f:
                f.seek(offset)
                return f.read(n)

        read_io.buf = io.BytesIO(await self._run(work))

    async def _read_into(
        self, read_io: ReadIO, path: str, offset: int, n: int
    ) -> None:
        """In-place read: bytes land directly in the consumer-provided
        destination with the checksum fused into the native copy-out."""
        dst = read_io.into
        got, crc, algo = await self._run(
            lambda: _native.read_range_into(
                path, offset, n, dst, want_crc=read_io.want_crc
            )
        )
        if got != n:
            raise IOError(
                f"short read: got {got} of {n} bytes at offset {offset} "
                f"from {path} — the snapshot blob is truncated"
            )
        read_io.in_place = True
        read_io.crc32c = crc
        read_io.crc_algo = algo
        read_io.buf = MemoryviewStream(dst[:n])

    async def _native_read(self, path: str, offset: int, n: int, read_io: ReadIO):
        """One GIL-released pread into an aligned, uninitialized buffer;
        with ``want_crc`` the checksum is computed on the read thread."""
        want_crc = read_io.want_crc

        def work():
            arr = _native.aligned_empty(n)
            if want_crc:
                got, crc, algo = _native.read_range_into(
                    path, offset, n, arr, want_crc=True
                )
                return arr, got, crc, algo
            return arr, _native.read_range(path, offset, n, arr.data), None, None

        arr, got, crc, algo = await self._run(work)
        if want_crc and got == n:
            read_io.crc32c = crc
            read_io.crc_algo = algo
        view = memoryview(arr)[:got] if got != n else memoryview(arr)
        return MemoryviewStream(view)

    async def flush_created_dirs(self) -> None:
        """fsync every directory this instance created (durable commit:
        each rank runs this once its writes have drained, so the dirents
        of every rank's blobs are stable before rank 0 commits)."""
        dirs = {str(p) for p in self._dir_cache} | {self.root}

        def work():
            for d in dirs:
                try:
                    _fsync_path(d)
                except FileNotFoundError:
                    pass  # deleted since it was created

        await self._run(work)

    async def delete(self, path: str) -> None:
        await self._run(os.remove, os.path.join(self.root, path))

    async def list_with_sizes(self) -> Optional[dict]:
        """``{relative_path: size}`` of every regular file under the root
        (fsck, gc and salvage); a missing root lists as empty."""

        def work():
            out = {}
            root = os.path.abspath(self.root)
            for dirpath, _dirnames, filenames in os.walk(root):
                for name in filenames:
                    full = os.path.join(dirpath, name)
                    rel = os.path.relpath(full, root).replace(os.sep, "/")
                    try:
                        out[rel] = os.path.getsize(full)
                    except OSError:
                        continue  # deleted during the walk
            return out

        return await self._run(work)

    async def close(self) -> None:
        if self._executor is not None:
            from ..io_types import shutdown_plugin_executor

            shutdown_plugin_executor(self._executor)
            self._executor = None
