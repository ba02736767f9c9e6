"""S3 storage plugin (counterpart of tpusnap/storage_plugins/s3.py).

Uses aiobotocore when installed; ranged reads via the HTTP Range header.
Import of aiobotocore is deferred to construction so environments without
it can still use every other plugin.
"""

import asyncio
import io
from typing import Any, Dict, Optional

from ..io_types import ReadIO, StoragePlugin, WriteIO
from ..memoryview_stream import MemoryviewStream


class S3StoragePlugin(StoragePlugin):
    supports_in_place_reads = True
    # Wrapped in the whole-op retry middleware when built from a URL
    # (S3 PUTs are per-object atomic, so whole-op retry is torn-write
    # safe by construction).
    wants_retry_middleware = True

    # S3 error codes that mean "back off and try again" even when the
    # HTTP status alone is ambiguous.
    _TRANSIENT_ERROR_CODES = frozenset(
        {
            "SlowDown",
            "InternalError",
            "RequestTimeout",
            "RequestTimeoutException",
            "Throttling",
            "ThrottlingException",
            "ServiceUnavailable",
        }
    )

    def classify_transient(self, exc: BaseException) -> bool:
        from ..retry import default_classify_transient

        if default_classify_transient(exc):
            return True
        # botocore ClientError shape, sniffed without importing botocore.
        response = getattr(exc, "response", None)
        if isinstance(response, dict):
            code = (response.get("Error") or {}).get("Code")
            if code in self._TRANSIENT_ERROR_CODES:
                return True
        return False

    def __init__(
        self, root: str, storage_options: Optional[Dict[str, Any]] = None
    ) -> None:
        components = root.split("/", 1)
        if len(components) != 2 or not components[0]:
            raise ValueError(
                f"Invalid s3 root: {root!r} (expected s3://bucket/prefix)"
            )
        self.bucket, self.root = components[0], components[1]
        self._client = None
        self._client_ctx = None
        self._storage_options = storage_options or {}
        self._executor = None
        # The aiobotocore import is deferred to first use so construction
        # works without the package — tests inject a stub via _client, and
        # environments without S3 can still import/route every plugin.

    def _get_executor(self):
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="tpusnap-s3"
            )
        return self._executor

    async def _get_client(self):
        if self._client is None:
            try:
                from aiobotocore.session import get_session
            except ImportError as e:
                raise RuntimeError(
                    "S3 support requires aiobotocore (pip install aiobotocore)"
                ) from e
            self._client_ctx = get_session().create_client(
                "s3", **self._storage_options.get("client_kwargs", {})
            )
            self._client = await self._client_ctx.__aenter__()
        return self._client

    def _key(self, path: str) -> str:
        # normpath collapses "../" segments: incremental snapshots
        # reference base-snapshot blobs relative to their own root.
        import posixpath

        return posixpath.normpath(f"{self.root}/{path}")

    async def write(self, write_io: WriteIO) -> None:
        client = await self._get_client()
        buf = write_io.buf
        body = MemoryviewStream(buf) if isinstance(buf, memoryview) else io.BytesIO(buf)
        await client.put_object(
            Bucket=self.bucket, Key=self._key(write_io.path), Body=body
        )

    async def read(self, read_io: ReadIO) -> None:
        client = await self._get_client()
        kwargs: Dict[str, Any] = {
            "Bucket": self.bucket,
            "Key": self._key(read_io.path),
        }
        if read_io.byte_range is not None:
            start, end = read_io.byte_range
            # HTTP Range is inclusive on both ends.
            kwargs["Range"] = f"bytes={start}-{end - 1}"
        response = await client.get_object(**kwargs)
        async with response["Body"] as stream:
            body = await stream.read()
        if read_io.into is not None:
            if len(body) != read_io.into.nbytes:
                # The destination was sized from the manifest; a
                # different body means the stored object was truncated
                # or drifted. Fail loudly — falling back to buffering
                # would hold an unbudgeted full-size copy on the way to
                # the same error.
                raise IOError(
                    f"S3 object {kwargs['Key']!r} returned {len(body)} "
                    f"bytes, expected {read_io.into.nbytes} — the "
                    "snapshot blob is truncated or corrupt"
                )
            # In-place delivery: bytes land in the restore target, the
            # checksum is computed once, and the consume stage verifies
            # a 4-byte value with no deserialize/copy pass. The copy +
            # hash run in a worker thread (blocking the event loop for
            # a multi-GB memcpy would stall every concurrent stream),
            # tracked so an aborted restore can wait it out before the
            # error reaches the caller.
            from .. import _native

            def deliver():
                read_io.into[: len(body)] = body
                if read_io.want_crc:
                    read_io.crc32c = _native.crc32c(body)
                    read_io.crc_algo = _native.checksum_algorithm()

            await self._submit_tracked(self._get_executor(), deliver)
            read_io.in_place = True
            read_io.buf = MemoryviewStream(read_io.into[: len(body)])
            return
        read_io.buf = io.BytesIO(body)

    async def delete(self, path: str) -> None:
        client = await self._get_client()
        await client.delete_object(Bucket=self.bucket, Key=self._key(path))

    async def close(self) -> None:
        if self._client_ctx is not None:
            await self._client_ctx.__aexit__(None, None, None)
            self._client = None
            self._client_ctx = None
        if self._executor is not None:
            from ..io_types import shutdown_plugin_executor

            shutdown_plugin_executor(self._executor)
            self._executor = None
