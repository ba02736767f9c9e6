"""Unified storage retry middleware: collective-progress deadlines,
transient-vs-fatal classification, and a ``StoragePlugin`` wrapper.

Counterpart of tpusnap/retry.py (vendored).

Extracted from the GCS plugin's battle-tested retry strategy so that EVERY
storage backend survives transient failures the same way (previously only
gcs.py retried; fs/s3/fsspec failed hard on the first error):

- ``RetryPolicy`` — the knobs: deadline, backoff shape, optional custom
  transient classifier. Constructible from ``storage_options`` so users
  tune retries per snapshot call without code changes.
- ``ProgressDeadline`` — the collective-progress deadline (reference
  gcs.py:216-272): one shared deadline per plugin instance, refreshed
  whenever ANY concurrent transfer completes — a pod-wide slowdown does
  not abort the snapshot while the backend is merely saturated, but a
  genuinely wedged backend still times out.
- ``RetryingStoragePlugin`` — wraps any ``StoragePlugin``; each
  write/write_atomic/read/delete is retried at whole-op granularity with
  exponential backoff + jitter. Whole-op granularity is what makes torn
  writes safe to retry: a partially-persisted blob is simply rewritten
  from byte 0 (fs ``write_atomic`` additionally never exposes the torn
  state thanks to temp+rename), and a partially-delivered read is re-run
  against a fresh ``ReadIO`` so no torn buffer ever reaches a consumer.

Transient classification is per-plugin: ``StoragePlugin.classify_transient``
(overridable) decides; the default covers connection-level failures,
timeouts, HTTP-ish status carriers and retriable OS errnos, and the fault
injection layer's ``InjectedFaultError`` subclasses ``ConnectionError`` so
chaos runs exercise exactly this path.
"""

from __future__ import annotations

import asyncio
import errno
import logging
import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from . import flight, telemetry
from .io_types import SIDECAR_PREFIX, ReadIO, StoragePlugin, WriteIO

logger = logging.getLogger(__name__)

_DEFAULT_DEADLINE_SEC = 600.0
_DEFAULT_BACKOFF_BASE_SEC = 0.5
_DEFAULT_BACKOFF_CAP_SEC = 30.0

# HTTP statuses that signal "try again" on any cloud/object backend.
TRANSIENT_HTTP_STATUS = frozenset({408, 429, 500, 502, 503, 504})

# OS errnos worth retrying: interruptions, contention, and network-ish
# filesystem hiccups. Deliberately excludes EIO/ENOSPC/EACCES/EROFS —
# those are real faults a retry loop would only delay surfacing.
TRANSIENT_ERRNOS = frozenset(
    e
    for e in (
        errno.EAGAIN,
        errno.EINTR,
        errno.EBUSY,
        errno.ETIMEDOUT,
        errno.ECONNRESET,
        errno.ECONNABORTED,
        errno.ECONNREFUSED,
        errno.ENETRESET,
        errno.ENETDOWN,
        errno.ENETUNREACH,
        getattr(errno, "ESTALE", None),
        getattr(errno, "EREMOTEIO", None),
    )
    if e is not None
)


def http_status_of(exc: BaseException) -> Optional[int]:
    """Best-effort HTTP status extraction without importing any client
    library: requests-style ``exc.response.status_code`` and
    botocore-style ``exc.response["ResponseMetadata"]["HTTPStatusCode"]``."""
    response = getattr(exc, "response", None)
    if response is None:
        return None
    status = getattr(response, "status_code", None)
    if isinstance(status, int):
        return status
    if isinstance(response, dict):
        meta = response.get("ResponseMetadata")
        if isinstance(meta, dict):
            status = meta.get("HTTPStatusCode")
            if isinstance(status, int):
                return status
    return None


def default_classify_transient(exc: BaseException) -> bool:
    """The classification shared by every plugin unless overridden:
    connection-level failures and timeouts are transient; OSErrors only
    for retriable errnos; HTTP-ish carriers by status code."""
    if isinstance(exc, (ConnectionError, TimeoutError, asyncio.TimeoutError)):
        return True
    if http_status_of(exc) in TRANSIENT_HTTP_STATUS:
        return True
    if isinstance(exc, OSError):
        return exc.errno in TRANSIENT_ERRNOS
    return False


@dataclass(frozen=True)
class RetryPolicy:
    """Retry knobs, overridable per call via ``storage_options``:
    ``retry_deadline_sec``, ``retry_backoff_base_sec``,
    ``retry_backoff_cap_sec``, and ``retry=False`` to disable the
    middleware entirely."""

    deadline_sec: float = _DEFAULT_DEADLINE_SEC
    backoff_base_sec: float = _DEFAULT_BACKOFF_BASE_SEC
    backoff_cap_sec: float = _DEFAULT_BACKOFF_CAP_SEC
    classify_transient: Optional[Callable[[BaseException], bool]] = None

    @classmethod
    def from_storage_options(
        cls, storage_options: Optional[Dict[str, Any]]
    ) -> "RetryPolicy":
        opts = storage_options or {}
        return cls(
            deadline_sec=float(
                opts.get("retry_deadline_sec", _DEFAULT_DEADLINE_SEC)
            ),
            backoff_base_sec=float(
                opts.get("retry_backoff_base_sec", _DEFAULT_BACKOFF_BASE_SEC)
            ),
            backoff_cap_sec=float(
                opts.get("retry_backoff_cap_sec", _DEFAULT_BACKOFF_CAP_SEC)
            ),
            classify_transient=opts.get("retry_classify_transient"),
        )

    def backoff_sec(self, attempt: int) -> float:
        """Exponential backoff with multiplicative jitter in [0.5, 1.5)
        (the GCS plugin's shape, generalized to a configurable base)."""
        raw = min(
            self.backoff_base_sec * (2 ** max(attempt - 1, 0)),
            self.backoff_cap_sec,
        )
        return raw * (0.5 + random.random())


class ProgressDeadline:
    """Collective-progress deadline shared by every concurrent op of one
    plugin instance: refreshed whenever ANY transfer completes, so only a
    backend making no progress at all expires it.

    Armed lazily at the first consult, NOT at construction: a plugin may
    be built long before its first op runs (async takes hold the plugin
    through the whole staging pass before any storage I/O) — counting
    that idle time against the deadline would deny the first failing op
    any retries at all."""

    def __init__(self, deadline_sec: float = _DEFAULT_DEADLINE_SEC) -> None:
        self._deadline_sec = deadline_sec
        self._deadline: Optional[float] = None

    def report_progress(self) -> None:
        self._deadline = time.monotonic() + self._deadline_sec

    def expired(self) -> bool:
        if self._deadline is None:
            self.report_progress()
            return False
        return time.monotonic() > self._deadline


class RetryingStoragePlugin(StoragePlugin):
    """Transparent retry wrapper around any ``StoragePlugin``.

    Each op retries at whole-op granularity while the failure classifies
    transient and the instance's collective-progress deadline has not
    expired. The wrapper is scheduling-transparent: in-place read
    support, overhead accounting, dir flushing and in-flight draining
    all delegate to the inner plugin."""

    def __init__(
        self,
        inner: StoragePlugin,
        policy: Optional[RetryPolicy] = None,
    ) -> None:
        self.inner = inner
        self.policy = policy or RetryPolicy()
        self._deadline = ProgressDeadline(self.policy.deadline_sec)
        self._classify = self.policy.classify_transient or getattr(
            inner, "classify_transient", default_classify_transient
        )

    # --- scheduling transparency -----------------------------------------

    @property
    def supports_in_place_reads(self) -> bool:  # type: ignore[override]
        return self.inner.supports_in_place_reads

    def in_place_read_overhead_bytes(self, nbytes: int) -> int:
        return self.inner.in_place_read_overhead_bytes(nbytes)

    def drain_in_flight(self) -> None:
        self.inner.drain_in_flight()

    # --- retry core -------------------------------------------------------

    async def _gate(self, exc: Exception, attempt: int, op: str, path: str) -> None:
        """Re-raise fatal/expired failures; otherwise back off.
        Per-classification counters (op kind x exception type) record
        every retried failure whether or not the op eventually
        succeeds — the telemetry trace is how a chaos run proves its
        injected faults actually exercised this path."""
        transient = self._classify(exc)
        if not transient or self._deadline.expired():
            # Sidecar-namespace ops are expected-miss probes, not
            # payload failures: the journal read at every take start
            # 404s on a fresh path, and a ``retry.fatal.read`` counter
            # for it would read as a payload-blob retry gone fatal.
            # Label them under their own family so the payload counters
            # stay clean.
            sidecar = path.startswith(SIDECAR_PREFIX)
            if transient and not sidecar:
                # Retry-budget EXHAUSTION is its own failure mode: the
                # error was retriable, the backend just never came back
                # within the progress deadline. One structured flight
                # breadcrumb + counter NAME the op that gave up — the
                # give-up instant used to be indistinguishable from a
                # hard-fatal classification in every post-mortem.
                telemetry.incr(f"retry.exhausted.{op}")
                flight.record(
                    "retry_exhausted",
                    op=op,
                    path=path,
                    attempts=attempt,
                    deadline_sec=self.policy.deadline_sec,
                    error=type(exc).__name__,
                )
                logger.warning(
                    "Retry budget exhausted in %s(%r) after %d attempt(s) "
                    "(no collective progress for %.0fs): %s",
                    op,
                    path,
                    attempt,
                    self.policy.deadline_sec,
                    exc,
                )
            else:
                family = "retry.fatal.sidecar" if sidecar else "retry.fatal"
                telemetry.incr(f"{family}.{op}")
                if not sidecar:
                    # Sidecar misses stay out of the black box too — a
                    # 404'd journal probe at take start is not forensic
                    # signal.
                    flight.record(
                        "retry_fatal",
                        op=op,
                        path=path,
                        error=type(exc).__name__,
                    )
            raise exc
        telemetry.incr("retry.attempts")
        telemetry.incr(f"retry.transient.{op}.{type(exc).__name__}")
        telemetry.event(
            "retry", op=op, path=path, attempt=attempt, error=type(exc).__name__
        )
        flight.record(
            "retry",
            op=op,
            path=path,
            attempt=attempt,
            error=type(exc).__name__,
        )
        logger.warning(
            "Transient storage error in %s(%r) (attempt %d): %s; retrying",
            op,
            path,
            attempt,
            exc,
        )
        await asyncio.sleep(self.policy.backoff_sec(attempt))

    async def _with_retry(self, op: str, path: str, attempt_coro_factory):
        attempt = 0
        while True:
            try:
                result = await attempt_coro_factory()
            except Exception as e:
                attempt += 1
                await self._gate(e, attempt, op, path)
                continue
            self._deadline.report_progress()
            if attempt > 0:
                # Success-after-retry was previously invisible (only
                # terminal failures logged); the INFO line + counter
                # make transient-burst recovery auditable.
                telemetry.incr("retry.recovered")
                logger.info(
                    "%s(%r) succeeded after %d retr%s (%d attempts total)",
                    op,
                    path,
                    attempt,
                    "y" if attempt == 1 else "ies",
                    attempt + 1,
                )
            return result

    # --- plugin interface -------------------------------------------------

    async def write(self, write_io: WriteIO) -> None:
        await self._with_retry(
            "write", write_io.path, lambda: self.inner.write(write_io)
        )

    async def write_atomic(self, write_io: WriteIO, durable: bool = False) -> None:
        await self._with_retry(
            "write_atomic",
            write_io.path,
            lambda: self.inner.write_atomic(write_io, durable=durable),
        )

    async def read(self, read_io: ReadIO) -> None:
        async def attempt() -> ReadIO:
            # A fresh ReadIO per attempt: a failed inner read may have
            # partially filled buf/into or set crc fields — results are
            # copied back only from a fully successful attempt, so no
            # torn read state ever reaches a consumer.
            trial = ReadIO(
                path=read_io.path,
                byte_range=read_io.byte_range,
                into=read_io.into,
                want_crc=read_io.want_crc,
            )
            await self.inner.read(trial)
            return trial

        trial = await self._with_retry("read", read_io.path, attempt)
        read_io.buf = trial.buf
        read_io.in_place = trial.in_place
        read_io.crc32c = trial.crc32c
        read_io.crc_algo = trial.crc_algo

    async def delete(self, path: str) -> None:
        await self._with_retry("delete", path, lambda: self.inner.delete(path))

    async def list_with_sizes(self):
        return await self._with_retry(
            "list", "", lambda: self.inner.list_with_sizes()
        )

    async def flush_created_dirs(self) -> None:
        await self.inner.flush_created_dirs()

    async def close(self) -> None:
        await self.inner.close()
