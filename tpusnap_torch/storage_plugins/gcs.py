"""GCS storage plugin — the north-star cloud target.

Counterpart of tpusnap/storage_plugins/gcs.py (after torchsnapshot's):
hand-rolled resumable uploads and chunked (100MB) ranged downloads over an
``AuthorizedSession``, run in a thread-pool executor so many transfers
proceed concurrently under asyncio; transient-error classification
and the collective-progress retry strategy:
instead of a fixed per-request retry budget, a shared deadline is refreshed
whenever *any* concurrent transfer makes progress — so a pod-wide slowdown
doesn't abort the snapshot while the storage backend is merely saturated,
but a genuinely wedged backend still times out.
"""

import asyncio
import io
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

from ..io_types import ReadIO, StoragePlugin, WriteIO
from ..retry import (
    TRANSIENT_HTTP_STATUS,
    ProgressDeadline,
    RetryPolicy,
    http_status_of,
)

logger = logging.getLogger(__name__)

_UPLOAD_CHUNK_SIZE = 100 * 1024 * 1024
_DOWNLOAD_CHUNK_SIZE = 100 * 1024 * 1024
_DEFAULT_DEADLINE_SEC = 600


class _NoProgressError(ConnectionError):
    """Resumable-upload PUT was accepted (308) but persisted no bytes;
    subclasses ConnectionError so ``_is_transient`` retries it under the
    collective deadline."""


def _is_transient(exc: Exception) -> bool:
    if http_status_of(exc) in TRANSIENT_HTTP_STATUS:
        return True
    # connection-level failures are transient
    import requests

    return isinstance(
        exc, (requests.ConnectionError, requests.Timeout, ConnectionError, TimeoutError)
    )


class _RetryStrategy:
    """Collective-progress retry (after torchsnapshot's gcs plugin): a shared
    deadline refreshed whenever any concurrent coroutine completes a
    transfer, with the shared middleware's backoff shape. Composed from
    the extracted tpusnap_torch.retry primitives; kept as a local class
    because the plugin retries at CHUNK grain inside its resumable
    upload loop — finer than the whole-op wrapper can."""

    def __init__(self, deadline_sec: float = _DEFAULT_DEADLINE_SEC) -> None:
        self._progress = ProgressDeadline(deadline_sec)
        # Base 2.0 preserves the historical GCS backoff (2s, 4s, ... 30s).
        self._policy = RetryPolicy(
            deadline_sec=deadline_sec, backoff_base_sec=2.0, backoff_cap_sec=30.0
        )

    def report_progress(self) -> None:
        self._progress.report_progress()

    def expired(self) -> bool:
        return self._progress.expired()

    async def backoff(self, attempt: int) -> None:
        await asyncio.sleep(self._policy.backoff_sec(attempt))


class GCSStoragePlugin(StoragePlugin):
    supports_in_place_reads = True
    # Retries internally at chunk grain under the collective-progress
    # deadline; the registry must not double-wrap it in whole-op retry.
    handles_own_retries = True

    def classify_transient(self, exc: BaseException) -> bool:
        return _is_transient(exc)

    def in_place_read_overhead_bytes(self, nbytes: int) -> int:
        # One download chunk is materialized at a time.
        return min(nbytes, _DOWNLOAD_CHUNK_SIZE)

    def __init__(
        self, root: str, storage_options: Optional[Dict[str, Any]] = None
    ) -> None:
        components = root.split("/", 1)
        if len(components) != 2 or not components[0]:
            raise ValueError(f"Invalid gcs root: {root!r} (expected gs://bucket/prefix)")
        self.bucket, self.root = components[0], components[1]
        storage_options = storage_options or {}
        # Emulator/fake-server support (same convention as the official
        # client libraries): STORAGE_EMULATOR_HOST or an explicit
        # api_endpoint skip auth entirely and use a plain session.
        endpoint = storage_options.get("api_endpoint") or os.environ.get(
            "STORAGE_EMULATOR_HOST"
        )
        if endpoint:
            import requests

            if "://" not in endpoint:
                # fake-gcs-server convention: scheme-less host:port. The
                # official client libraries prepend http:// too.
                endpoint = f"http://{endpoint}"
            self._endpoint = endpoint.rstrip("/")
            self._session = requests.Session()
        else:
            try:
                import google.auth
                from google.auth.transport.requests import AuthorizedSession
            except ImportError as e:
                raise RuntimeError(
                    "GCS support requires google-auth (pip install google-auth)"
                ) from e
            scopes = ["https://www.googleapis.com/auth/devstorage.read_write"]
            credentials, _ = google.auth.default(scopes=scopes)
            self._endpoint = "https://storage.googleapis.com"
            self._session = AuthorizedSession(credentials)
        self._executor = ThreadPoolExecutor(
            max_workers=int(storage_options.get("max_workers", 16)),
            thread_name_prefix="tpusnap-gcs",
        )
        self._retry = _RetryStrategy(
            float(storage_options.get("deadline_sec", _DEFAULT_DEADLINE_SEC))
        )

    def _object_name(self, path: str) -> str:
        # normpath collapses "../" segments: incremental snapshots
        # reference base-snapshot blobs relative to their own root.
        import posixpath

        return posixpath.normpath(f"{self.root}/{path}")

    # --- blocking primitives, run in the executor ------------------------

    def _initiate_resumable_upload(self, name: str) -> str:
        from urllib.parse import quote

        url = (
            f"{self._endpoint}/upload/storage/v1/b/{self.bucket}/o"
            f"?uploadType=resumable&name={quote(name, safe='')}"
        )
        resp = self._session.post(url, json={})
        resp.raise_for_status()
        return resp.headers["Location"]

    def _upload_chunk(
        self, session_url: str, chunk: memoryview, offset: int, total: int
    ) -> int:
        """PUT one chunk; returns the session's new persisted offset. On a
        308 the response's Range header — not the request size — is
        authoritative for how much was actually persisted."""
        end = offset + len(chunk)
        headers = {
            "Content-Length": str(len(chunk)),
            "Content-Range": f"bytes {offset}-{end - 1}/{total}",
        }
        resp = self._session.put(session_url, data=bytes(chunk), headers=headers)
        if resp.status_code in (200, 201):
            return total
        if resp.status_code == 308:
            persisted = resp.headers.get("Range")
            if persisted is None:
                return offset  # nothing persisted from this chunk
            return int(persisted.rsplit("-", 1)[1]) + 1
        resp.raise_for_status()
        return end

    def _query_persisted_offset(self, session_url: str, total: int) -> int:
        """Ask the resumable session how many bytes it has durably stored
        (the protocol-mandated status check after an interrupted chunk:
        PUT with ``Content-Range: bytes */total``)."""
        resp = self._session.put(
            session_url,
            headers={"Content-Range": f"bytes */{total}", "Content-Length": "0"},
        )
        if resp.status_code in (200, 201):
            return total  # upload actually completed
        if resp.status_code == 308:
            persisted = resp.headers.get("Range")  # e.g. "bytes=0-524287"
            if persisted is None:
                return 0
            return int(persisted.rsplit("-", 1)[1]) + 1
        resp.raise_for_status()
        return 0

    def _upload_empty(self, name: str) -> None:
        from urllib.parse import quote

        url = (
            f"{self._endpoint}/upload/storage/v1/b/{self.bucket}/o"
            f"?uploadType=media&name={quote(name, safe='')}"
        )
        resp = self._session.post(url, data=b"")
        resp.raise_for_status()

    def _download_range(self, name: str, start: int, end: int) -> bytes:
        from urllib.parse import quote

        url = (
            f"{self._endpoint}/storage/v1/b/{self.bucket}"
            f"/o/{quote(name, safe='')}?alt=media"
        )
        headers = {"Range": f"bytes={start}-{end - 1}"}
        resp = self._session.get(url, headers=headers)
        resp.raise_for_status()
        return resp.content

    def _object_size(self, name: str) -> int:
        from urllib.parse import quote

        url = (
            f"{self._endpoint}/storage/v1/b/{self.bucket}"
            f"/o/{quote(name, safe='')}"
        )
        resp = self._session.get(url)
        resp.raise_for_status()
        return int(resp.json()["size"])

    def _delete_blocking(self, name: str) -> None:
        from urllib.parse import quote

        url = (
            f"{self._endpoint}/storage/v1/b/{self.bucket}"
            f"/o/{quote(name, safe='')}"
        )
        resp = self._session.delete(url)
        resp.raise_for_status()

    # --- retry wrapper ---------------------------------------------------

    async def _retry_gate(self, e: Exception, attempt: int) -> None:
        """Shared transient-or-raise + backoff step for all retry loops."""
        if not _is_transient(e) or self._retry.expired():
            raise e
        logger.warning("Transient GCS error (attempt %d): %s; retrying", attempt, e)
        await self._retry.backoff(attempt)

    async def _with_retry(self, fn, *args, counts_as_progress: bool = True):
        loop = asyncio.get_running_loop()
        attempt = 0
        while True:
            try:
                result = await loop.run_in_executor(self._executor, fn, *args)
                if counts_as_progress:
                    # Only data-carrying operations refresh the collective
                    # deadline; cheap status probes succeeding must not keep
                    # a wedged upload alive forever.
                    self._retry.report_progress()
                return result
            except Exception as e:
                attempt += 1
                await self._retry_gate(e, attempt)

    # --- plugin interface ------------------------------------------------

    async def write(self, write_io: WriteIO) -> None:
        name = self._object_name(write_io.path)
        buf = memoryview(write_io.buf).cast("B")
        total = buf.nbytes
        if total == 0:
            await self._with_retry(self._upload_empty, name)
            return
        session_url = await self._with_retry(self._initiate_resumable_upload, name)
        loop = asyncio.get_running_loop()
        offset = 0
        attempt = 0
        while offset < total:
            chunk = buf[offset : offset + _UPLOAD_CHUNK_SIZE]
            try:
                new_offset = await loop.run_in_executor(
                    self._executor, self._upload_chunk, session_url, chunk, offset, total
                )
                if new_offset <= offset:
                    # A 308 that persisted nothing (no/stale Range header)
                    # must count as a failed attempt — otherwise a wedged
                    # session would re-PUT the same chunk in a tight loop,
                    # never consulting the collective deadline.
                    raise _NoProgressError(
                        f"GCS resumable upload made no progress at offset "
                        f"{offset}/{total}"
                    )
            except Exception as e:
                attempt += 1
                await self._retry_gate(e, attempt)
                # A partially-persisted chunk moves the session's write
                # head; blindly re-PUTting the old Content-Range would be
                # rejected as an offset mismatch. Resynchronize first (a
                # status probe — must not refresh the progress deadline).
                offset = await self._with_retry(
                    self._query_persisted_offset,
                    session_url,
                    total,
                    counts_as_progress=False,
                )
                continue
            self._retry.report_progress()
            offset = new_offset
            attempt = 0

    async def read(self, read_io: ReadIO) -> None:
        name = self._object_name(read_io.path)
        if read_io.byte_range is not None:
            start, end = read_io.byte_range
        else:
            start, end = 0, await self._with_retry(self._object_size, name)
        n = end - start
        if read_io.into is not None:
            if n != read_io.into.nbytes:
                # The destination was sized from the manifest; fail
                # loudly instead of buffering an unbudgeted full-size
                # copy on the way to the same size/checksum error.
                raise IOError(
                    f"GCS object {name!r} has {n} readable bytes, "
                    f"expected {read_io.into.nbytes} — the snapshot "
                    "blob is truncated or corrupt"
                )
            # In-place download: chunks land directly in the restore
            # target (no BytesIO assembly, no deserialize/copy pass in
            # the consume stage), with the checksum accumulated chunk by
            # chunk over the just-landed (cache-warm) bytes. This is the
            # 7B-from-GCS restore path.
            await self._read_into(read_io, name, start, end)
            return
        out = io.BytesIO()
        for offset in range(start, end, _DOWNLOAD_CHUNK_SIZE):
            chunk_end = min(offset + _DOWNLOAD_CHUNK_SIZE, end)
            out.write(await self._with_retry(self._download_range, name, offset, chunk_end))
        out.seek(0)
        read_io.buf = out

    async def _read_into(
        self, read_io: ReadIO, name: str, start: int, end: int
    ) -> None:
        from .. import _native
        from ..memoryview_stream import MemoryviewStream

        dst = read_io.into
        n = end - start
        crc: Optional[int] = 0 if read_io.want_crc else None
        for offset in range(start, end, _DOWNLOAD_CHUNK_SIZE):
            chunk_end = min(offset + _DOWNLOAD_CHUNK_SIZE, end)
            data = await self._with_retry(
                self._download_range, name, offset, chunk_end
            )
            if len(data) != chunk_end - offset:
                raise IOError(
                    f"short GCS read: got {len(data)} of "
                    f"{chunk_end - offset} bytes at offset {offset} of "
                    f"{name!r}"
                )
            lo = offset - start

            def land(lo=lo, data=data):
                # Copy + hash off the event loop: a 100 MiB memcpy on
                # the loop thread would stall every concurrent stream.
                # Hash after the chunk fully landed (retry-safe: a
                # re-downloaded chunk overwrites the same region before
                # it is ever hashed).
                dst[lo : lo + len(data)] = data
                if crc is not None:
                    return _native.crc32c(dst[lo : lo + len(data)], crc)
                return None

            new_crc = await self._submit_tracked(self._executor, land)
            if crc is not None:
                crc = new_crc
        read_io.in_place = True
        if crc is not None:
            read_io.crc32c = crc
            read_io.crc_algo = _native.checksum_algorithm()
        read_io.buf = MemoryviewStream(dst[:n])

    async def delete(self, path: str) -> None:
        await self._with_retry(self._delete_blocking, self._object_name(path))

    async def close(self) -> None:
        from ..io_types import shutdown_plugin_executor

        shutdown_plugin_executor(self._executor)
