"""Write-back storage tiering: durable-local commit, background cloud drain.

A ``tier+local=<fs-base>+remote=<scheme>://<path>`` URL composes two
storage tiers around one snapshot path:

- the **local tier** (a filesystem mirror of the remote path under
  ``<fs-base>``) is the commit-of-record: every blob write and the
  metadata-written-last commit land there at disk speed — a take through
  the tier never waits on, and never fails because of, the remote;
- the **remote tier** (any registered scheme, chaos-composable:
  ``remote=chaos+s3``) receives the blobs from a background **uploader
  state machine** that is crash-safe and outage-tolerant.

Durability is a two-state ladder, first-class in ``fsck``/``info``/
``timeline``:

    local-committed   metadata committed in the local tier; the upload
                      journal (``.tpusnap/upload_journal``) names the
                      remote target and the blobs already proven remote
    remote-durable    every payload blob uploaded, the remote metadata
                      written LAST and verified by read-back, and the
                      journal's state marker rewritten to ``durable``
                      strictly after that verify

The upload journal follows the take journal's evidence rule: after each successful
remote write the uploader records the blob's ``(nbytes, CRC32C, XXH64)``
triple (of the bytes it read locally and shipped) and atomically
rewrites the journal — so a SIGKILLed uploader, restarted by
``drain_snapshot`` or the next process's background drain,
re-hashes each local blob and SKIPS every one whose fresh dual hash
matches its journal record: nothing already proven remote is uploaded
twice. Chain-aware ordering: a snapshot's external bases (incremental
takes, delta-stream parents) drain to their remote siblings BEFORE the
snapshot itself, so the remote tier is restorable the instant its
metadata lands.

Outage tolerance: each remote op runs under the ordinary retry
middleware but with a SHORT deadline (``TPUSNAP_TIER_OP_DEADLINE_S``);
once ``TPUSNAP_TIER_OUTAGE_THRESHOLD`` consecutive uploads exhaust it,
the circuit opens — one edge-triggered ``tier_degraded`` flight event,
``tier.degraded_episodes`` counter, ``tpusnap_tier_degraded`` gauge —
and the drain backs off exponentially (jittered, capped at
``TPUSNAP_TIER_BACKOFF_CAP_S``) while takes keep committing locally.
``tpusnap_upload_lag_bytes`` / ``tpusnap_upload_lag_seconds`` quantify
the at-risk window the whole time; recovery emits ``tier_recovered``
and the drain resumes where the journal left off.

GC safety rule (:func:`tpusnap_torch.lifecycle.gc_snapshot`): local payload
blobs may be reclaimed (``gc --evict-local``) only past
``remote-durable``, and only once the durable marker is older than the
``TPUSNAP_TIER_LOCAL_RETENTION_S`` hot-cache window; reads through the
tier URL then fall back to the remote transparently.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import flight, telemetry
from .io_types import (
    SIDECAR_PREFIX,
    UPLOAD_JOURNAL_PATH,
    ReadIO,
    StoragePlugin,
    WriteIO,
)

logger = logging.getLogger(__name__)

# Wall-clock seam (timestamps in the journal/status records; injectable
# for tests). Durations/backoff run on the monotonic clock.
_wall = time.time

#: Subdirectory of TPUSNAP_TELEMETRY_DIR holding the uploader's live
#: status sidecar (read by ``read_tier_status``).
TIER_STATUS_DIRNAME = "tier"

_TIER_PREFIX = "tier+"
_LOCAL_KEY = "local="
_REMOTE_SEP = "+remote="


# ------------------------------------------------------------------- URL


@dataclass(frozen=True)
class TierSpec:
    """A parsed ``tier+local=<base>+remote=<scheme>://<path>`` URL."""

    local_base: str  # the fs cache base directory (from local=)
    remote_scheme: str  # e.g. "s3", "gs", "chaos+fs", "fsspec+memory"
    remote_path: str  # the path after ://
    url: str  # the original tier URL

    @property
    def remote_url(self) -> str:
        return f"{self.remote_scheme}://{self.remote_path}"

    @property
    def local_dir(self) -> str:
        """The local mirror directory of this snapshot path: the remote
        path re-rooted under the local base — so appending ``/member``
        to the tier URL extends BOTH tiers consistently (delta streams,
        retention roots)."""
        rel = self.remote_path.lstrip("/")
        return os.path.join(self.local_base, rel) if rel else self.local_base


def parse_tier_url(url_path: str) -> Optional[TierSpec]:
    """Parse a tier URL, or return None when ``url_path`` is not one.
    Raises ``ValueError`` on a malformed tier scheme (it IS a tier URL,
    but the local/remote parts don't parse)."""
    if "://" not in url_path:
        return None
    scheme, path = url_path.split("://", 1)
    if not scheme.lower().startswith(_TIER_PREFIX):
        return None
    spec = scheme[len(_TIER_PREFIX):]
    # rpartition on "+remote=": the local fs path may contain "+"; the
    # remote scheme may itself be composed ("chaos+fs", "fsspec+memory").
    local_part, sep, remote_scheme = spec.rpartition(_REMOTE_SEP)
    if not sep or not local_part.startswith(_LOCAL_KEY):
        raise ValueError(
            f"malformed tier URL {url_path!r}: expected "
            "tier+local=<fs-path>+remote=<scheme>://<path>"
        )
    local_base = local_part[len(_LOCAL_KEY):]
    if not local_base:
        raise ValueError(f"tier URL {url_path!r} has an empty local= path")
    return TierSpec(
        local_base=local_base,
        remote_scheme=remote_scheme or "fs",
        remote_path=path,
        url=url_path,
    )


#: Remote scheme → storage-plugin class label (the innermost class name
#: the I/O histograms and restore history events use). Static so the
#: SLO estimator can price a tier without instantiating cloud clients.
_SCHEME_LABELS = {
    "": "FSStoragePlugin",
    "fs": "FSStoragePlugin",
    "file": "FSStoragePlugin",
    "s3": "S3StoragePlugin",
    "gs": "GCSStoragePlugin",
    "gcs": "GCSStoragePlugin",
}


def scheme_plugin_label(scheme: str) -> Optional[str]:
    s = scheme.lower()
    if s.startswith("chaos+"):
        s = s[len("chaos+"):]
    if s.startswith("fsspec+"):
        return "FsspecStoragePlugin"
    return _SCHEME_LABELS.get(s)


# -------------------------------------------------------- upload journal


def _journal_from_json(data: bytes) -> Optional[Dict[str, Any]]:
    try:
        d = json.loads(data.decode("utf-8"))
    except Exception:
        return None
    if not isinstance(d, dict) or not isinstance(d.get("blobs", {}), dict):
        return None
    d.setdefault("version", 1)
    d.setdefault("state", "pending")
    # Sanitize per-blob evidence at the parse boundary: the journal is
    # advisory, never load-bearing — a malformed entry (hand edit,
    # partial corruption that still decodes) must read as absent
    # evidence (re-upload), not crash the drain or the status readers.
    d["blobs"] = {
        str(k): [int(v[0]), str(v[1]), str(v[2])]
        for k, v in (d.get("blobs") or {}).items()
        if isinstance(v, (list, tuple))
        and len(v) == 3
        and isinstance(v[0], int)
    }
    return d


def read_upload_journal(
    storage: StoragePlugin, event_loop: asyncio.AbstractEventLoop
) -> Optional[Dict[str, Any]]:
    """The upload journal at this plugin's root, or None (absent or
    unparseable — unparseable is logged and treated as absent: like the
    take journal, it is advisory for resume efficiency, never
    load-bearing for restore correctness)."""
    read_io = ReadIO(path=UPLOAD_JOURNAL_PATH)
    try:
        storage.sync_read(read_io, event_loop)
    except Exception:
        return None
    j = _journal_from_json(read_io.buf.getvalue())
    if j is None:
        logger.warning(
            "Unparseable upload journal at %r; ignoring", UPLOAD_JOURNAL_PATH
        )
    return j


def read_upload_journal_dir(local_dir: str) -> Optional[Dict[str, Any]]:
    """Direct-file read of a LOCAL tier directory's upload journal (the
    local tier is a filesystem by construction; CLI/status readers use
    this to avoid building a plugin)."""
    try:
        with open(os.path.join(local_dir, UPLOAD_JOURNAL_PATH), "rb") as f:
            return _journal_from_json(f.read())
    except OSError:
        return None


def durability_of_journal(journal: Optional[Dict[str, Any]]) -> Optional[str]:
    """The two-state durability ladder from a journal record: None when
    the snapshot is not tiered at all."""
    if journal is None:
        return None
    return (
        "remote-durable" if journal.get("state") == "durable"
        else "local-committed"
    )


# ------------------------------------------------------------ the plugin


class TieredStoragePlugin(StoragePlugin):
    """The composed two-tier plugin a tier URL resolves to.

    Writes (blobs, sidecars, the metadata commit) go to the LOCAL tier
    only — the remote is never on the take's critical path. Reads
    prefer local and fall back to the remote on a local miss (the
    evicted-hot-cache case). Deletes propagate to both tiers
    best-effort (a failed remote delete is logged and counted; running
    ``gc`` against the remote URL reclaims any stragglers). Listings
    merge both tiers with local precedence, so ``fsck`` through the
    tier URL sees the union.

    The metadata commit additionally seeds/updates the upload journal
    (state ``pending``) and — when ``TPUSNAP_TIER_DRAIN`` is on —
    enqueues this snapshot with the process-global background uploader.
    Each sub-plugin composes its own middleware (retry, histograms,
    chaos via the remote sub-scheme), so the tier itself is returned
    bare by the registry (``handles_own_retries``)."""

    # Retry/instrumentation compose on the sub-plugins, not the tier.
    handles_own_retries = True

    def __init__(
        self,
        spec: TierSpec,
        storage_options: Optional[Dict[str, Any]] = None,
    ) -> None:
        from .storage_plugin import url_to_storage_plugin

        self.spec = spec
        self._storage_options = storage_options
        # The local tier never draws the chaos plan — faults target the
        # remote via its own scheme (remote=chaos+...); a faulty LOCAL
        # commit tier would break the "commits at disk speed, never
        # fails" contract this layer exists for.
        local_opts = dict(storage_options or {})
        local_opts.pop("fault_plan", None)
        self.local = url_to_storage_plugin(spec.local_dir, local_opts or None)
        self._remote: Optional[StoragePlugin] = None
        self._journal_seeded = False

    # --- sub-plugin access ------------------------------------------------

    @property
    def local_dir(self) -> str:
        return self.spec.local_dir

    @property
    def remote_url(self) -> str:
        return self.spec.remote_url

    def _remote_plugin(self) -> StoragePlugin:
        if self._remote is None:
            from .knobs import get_tier_op_deadline_s
            from .storage_plugin import url_to_storage_plugin

            opts = dict(self._storage_options or {})
            # Short per-op deadline: a fallback read/delete against a
            # wedged remote must fail fast enough for callers to act,
            # not park for the 600 s payload default.
            opts.setdefault("retry_deadline_sec", get_tier_op_deadline_s())
            self._remote = url_to_storage_plugin(self.spec.remote_url, opts)
        return self._remote

    # --- scheduling transparency -----------------------------------------

    @property
    def supports_in_place_reads(self) -> bool:  # type: ignore[override]
        return self.local.supports_in_place_reads

    def in_place_read_overhead_bytes(self, nbytes: int) -> int:
        return self.local.in_place_read_overhead_bytes(nbytes)

    def drain_in_flight(self) -> None:
        self.local.drain_in_flight()
        if self._remote is not None:
            self._remote.drain_in_flight()

    def classify_transient(self, exc: BaseException) -> bool:
        from .retry import default_classify_transient

        return getattr(
            self.local, "classify_transient", default_classify_transient
        )(exc)

    # --- journal seeding / commit hand-off --------------------------------

    async def _seed_journal(self) -> None:
        """First write of a take: make the tier intent durable in the
        local dir — the journal names the remote target (what lets a
        bare ``drain <local-dir>`` resume after any crash) and resets
        the durability state to ``pending`` (a retake's new bytes are
        not remote yet). Prior blob evidence is PRESERVED: the drain
        re-verifies every entry against the local bytes' fresh dual
        hash, so stale evidence can only cause a re-upload, never a
        wrong skip."""
        if self._journal_seeded:
            return
        self._journal_seeded = True
        prior = None
        read_io = ReadIO(path=UPLOAD_JOURNAL_PATH)
        try:
            await self.local.read(read_io)
            prior = _journal_from_json(read_io.buf.getvalue())
        except Exception:
            prior = None
        journal = prior or {"version": 1, "blobs": {}}
        journal["remote"] = self.spec.remote_url
        journal["state"] = "pending"
        journal.pop("durable_at", None)
        # The PREVIOUS take's commit stamp must go too: an in-flight
        # drain of that take checks the stamp before writing its
        # durable marker, and a stale stamp surviving the seed would
        # let it mark the dir durable while THIS take is mid-overwrite
        # of the payload (the window between first blob write and
        # metadata commit).
        journal.pop("committed_at", None)
        await self.local.write_atomic(
            WriteIO(
                path=UPLOAD_JOURNAL_PATH,
                buf=json.dumps(journal).encode("utf-8"),
            )
        )

    async def _on_local_commit(self) -> None:
        """The local metadata just committed: stamp the journal and
        hand the snapshot to the background uploader. Best-effort — the
        take is already durable locally and a failure here only delays
        cloud convergence (the next drain picks it up)."""
        try:
            await self._seed_journal()
            read_io = ReadIO(path=UPLOAD_JOURNAL_PATH)
            await self.local.read(read_io)
            journal = _journal_from_json(read_io.buf.getvalue()) or {
                "version": 1,
                "blobs": {},
            }
            journal["remote"] = self.spec.remote_url
            journal["state"] = "pending"
            journal.pop("durable_at", None)
            journal["committed_at"] = _wall()
            await self.local.write_atomic(
                WriteIO(
                    path=UPLOAD_JOURNAL_PATH,
                    buf=json.dumps(journal).encode("utf-8"),
                )
            )
        except Exception:
            logger.warning(
                "upload journal commit stamp failed (non-fatal; the next "
                "drain will still converge)",
                exc_info=True,
            )
        from .knobs import is_tier_drain_enabled

        if is_tier_drain_enabled():
            drain_manager().enqueue(
                self.spec.local_dir,
                self.spec.remote_url,
                self._storage_options,
            )

    # --- plugin interface -------------------------------------------------

    async def write(self, write_io: WriteIO) -> None:
        await self._seed_journal()
        await self.local.write(write_io)

    async def write_atomic(self, write_io: WriteIO, durable: bool = False) -> None:
        await self._seed_journal()
        await self.local.write_atomic(write_io, durable=durable)
        from .snapshot import SNAPSHOT_METADATA_FNAME

        if write_io.path == SNAPSHOT_METADATA_FNAME:
            await self._on_local_commit()

    async def read(self, read_io: ReadIO) -> None:
        try:
            await self.local.read(read_io)
            return
        except FileNotFoundError:
            # Sidecars (journal probes, salvage records, heartbeats)
            # live ONLY in the local tier: a miss is a miss, and
            # falling through would put the remote — possibly mid-
            # outage — on the take's critical path, the exact thing
            # this layer exists to prevent.
            if read_io.path.startswith(SIDECAR_PREFIX):
                raise
            # Evicted (or never-local) blob: read through to the remote
            # tier. A fresh ReadIO per tier, retry-middleware style, so
            # a partially-filled local attempt never leaks upward.
            pass
        trial = ReadIO(
            path=read_io.path,
            byte_range=read_io.byte_range,
            into=read_io.into,
            want_crc=read_io.want_crc,
        )
        await self._remote_plugin().read(trial)
        telemetry.incr("tier.remote_fallback_reads")
        read_io.buf = trial.buf
        read_io.in_place = trial.in_place
        read_io.crc32c = trial.crc32c
        read_io.crc_algo = trial.crc_algo
        # Access-ledger provenance: the bytes came through the remote
        # tier because the local copy was evicted (or never landed).
        read_io.source = "evicted-read-through"

    async def delete(self, path: str) -> None:
        if path.startswith(SIDECAR_PREFIX):
            # Sidecars never drain to the remote; their cleanup (journal
            # clears at commit, abort cleanup) must stay local-speed.
            await self.local.delete(path)
            return
        local_exc: Optional[Exception] = None
        try:
            await self.local.delete(path)
        except Exception as e:
            local_exc = e
        try:
            await self._remote_plugin().delete(path)
        except Exception:
            if local_exc is not None:
                raise local_exc
            # Local copy gone, remote delete failed (outage, or the
            # blob never drained): not fatal — `gc` against the remote
            # URL reclaims stragglers.
            telemetry.incr("tier.remote_delete_failures")
            logger.debug(
                "remote tier delete failed for %r (non-fatal)",
                path,
                exc_info=True,
            )
            return
        # Only an evicted blob (local miss) may ride on the remote
        # delete's success: a REAL local failure (EACCES, EIO) leaving
        # the local copy behind must surface, or gc/retention report
        # bytes reclaimed that still occupy the local disk.
        if local_exc is not None and not isinstance(
            local_exc, FileNotFoundError
        ):
            raise local_exc

    async def list_with_sizes(self) -> Optional[dict]:
        # LOCAL tier only, deliberately: the take path lists at start
        # (salvage probe, metadata-existence check) and a remote walk —
        # possibly mid-outage — must never sit on it. Offline tooling
        # stays correct without the union: fsck reads durability from
        # the upload journal and classifies locally-absent referenced
        # blobs of a remote-durable snapshot as evicted, not missing;
        # the remote tier is fsck-able directly at its own URL.
        return await self.local.list_with_sizes()

    async def flush_created_dirs(self) -> None:
        await self.local.flush_created_dirs()

    async def close(self) -> None:
        # The background uploader is process-global and deliberately
        # survives this plugin: durability converges across takes.
        await self.local.close()
        if self._remote is not None:
            await self._remote.close()


def build_tiered_plugin(
    url_path: str, storage_options: Optional[Dict[str, Any]] = None
) -> TieredStoragePlugin:
    spec = parse_tier_url(url_path)
    if spec is None:
        raise ValueError(f"not a tier URL: {url_path!r}")
    return TieredStoragePlugin(spec, storage_options)


# --------------------------------------------------------- status surface

_status_lock = threading.Lock()
_status: Dict[str, Any] = {"state": "idle"}


def tier_status_path(base: Optional[str] = None) -> str:
    from .knobs import get_telemetry_dir

    return os.path.join(
        base or get_telemetry_dir(), TIER_STATUS_DIRNAME, "status.json"
    )


def _publish_status(**fields: Any) -> None:
    """Update the process-global uploader status, rewrite the local
    status sidecar atomically, and fan the record out to the metrics
    sinks (``tpusnap_upload_lag_bytes``/``_seconds``,
    ``tpusnap_tier_degraded``). Never raises.

    ``lag_bytes`` in the published record is the TOTAL at-risk figure:
    the actively-draining snapshot's remainder (callers pass it as
    ``lag_bytes``) plus the queued backlog the DrainManager maintains
    (``queued_lag_bytes``) — during an outage with micro-commits piling
    up, the queue IS most of the exposure."""
    with _status_lock:
        if "lag_bytes" in fields:
            _status["active_lag_bytes"] = int(fields.pop("lag_bytes") or 0)
        _status.update(fields)
        _status["lag_bytes"] = int(
            _status.get("active_lag_bytes") or 0
        ) + int(_status.get("queued_lag_bytes") or 0)
        _status["ts"] = _wall()
        committed = _status.get("oldest_commit_ts")
        _status["lag_seconds"] = (
            round(max(_status["ts"] - committed, 0.0), 3)
            if isinstance(committed, (int, float))
            else 0.0
        )
        state = dict(_status)
    try:
        path = tier_status_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, path)
    except Exception:
        logger.debug("tier status sidecar write failed", exc_info=True)
    try:
        telemetry.notify_tier_update(state)
    except Exception:
        logger.debug("tier status sink notify failed", exc_info=True)


def read_tier_status(base: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The last published uploader status on this host, or None."""
    try:
        with open(tier_status_path(base), "r") as f:
            rec = json.load(f)
        return rec if isinstance(rec, dict) else None
    except Exception:
        return None


def current_status() -> Dict[str, Any]:
    with _status_lock:
        return dict(_status)


# ----------------------------------------------------------- the drainer


@dataclass
class DrainReport:
    """Outcome of draining ONE snapshot directory to its remote."""

    local_dir: str
    remote_url: str
    # "durable" | "degraded" | "superseded" | "missing-blobs" | "no-metadata"
    state: str
    blobs_total: int = 0
    blobs_uploaded: int = 0
    blobs_skipped: int = 0
    bytes_uploaded: int = 0
    bytes_skipped: int = 0
    lag_bytes: int = 0
    degraded_episodes: int = 0
    error: str = ""
    # Content-addressed refs (tpusnap_torch.cas): blobs this snapshot holds
    # as shared-store refs drain at STORE level — each unique blob
    # uploads once store-wide (store journal keyed by hash), to the
    # STORE's remote, never as per-snapshot private copies.
    cas_refs: int = 0
    cas_blobs_uploaded: int = 0
    cas_blobs_skipped: int = 0
    bases: List["DrainReport"] = field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        d = {k: v for k, v in self.__dict__.items() if k != "bases"}
        d["bases"] = [b.to_json() for b in self.bases]
        return d

    def summary(self) -> str:
        s = (
            f"{self.local_dir} -> {self.remote_url}: {self.state} — "
            f"{self.blobs_uploaded}/{self.blobs_total} blob(s) uploaded "
            f"({self.bytes_uploaded} bytes), {self.blobs_skipped} skipped "
            f"via journal evidence ({self.bytes_skipped} bytes)"
        )
        if self.cas_refs:
            s += (
                f"; {self.cas_refs} CAS ref(s) drained store-level "
                f"({self.cas_blobs_uploaded} blob(s) uploaded, "
                f"{self.cas_blobs_skipped} already proven remote)"
            )
        if self.lag_bytes:
            s += f"; {self.lag_bytes} bytes still local-only"
        if self.error:
            s += f" [{self.error}]"
        return s


class _Circuit:
    """The uploader's sustained-outage circuit breaker: consecutive
    op failures past the threshold open it (one edge-triggered
    ``tier_degraded`` flight event + counter per episode); any success
    closes it (``tier_recovered``). While open, callers back off with
    capped exponential + jitter instead of hammering the endpoint."""

    def __init__(self, remote_url: str) -> None:
        from .knobs import get_tier_backoff_cap_s, get_tier_outage_threshold

        self.remote_url = remote_url
        self.threshold = get_tier_outage_threshold()
        self.backoff_cap_s = get_tier_backoff_cap_s()
        self.failures = 0
        self.open = False
        self.episodes = 0

    def record_failure(self, exc: Exception) -> None:
        self.failures += 1
        if not self.open and self.failures >= self.threshold:
            self.open = True
            self.episodes += 1
            telemetry.incr("tier.degraded_episodes")
            flight.record(
                "tier_degraded",
                op="circuit_open",
                remote=self.remote_url,
                failures=self.failures,
                error=type(exc).__name__,
            )
            logger.warning(
                "write-back tier DEGRADED: %d consecutive upload failures "
                "against %s (%s) — takes keep committing locally; the "
                "drain keeps probing with capped backoff",
                self.failures,
                self.remote_url,
                exc,
            )

    def record_success(self) -> None:
        if self.open:
            self.open = False
            flight.record(
                "tier_recovered", op="circuit_close", remote=self.remote_url
            )
            logger.info(
                "write-back tier recovered: %s reachable again; drain "
                "resuming",
                self.remote_url,
            )
        self.failures = 0

    def backoff_s(self) -> float:
        raw = min(0.1 * (2 ** min(self.failures, 16)), self.backoff_cap_s)
        return raw * (0.5 + random.random())


def _remote_sibling(remote_url: str, rel: str) -> str:
    """Apply a relative base reference (``../B`` style root, as recorded
    in ``metadata.base_roots``) to a remote URL textually."""
    scheme, _, path = remote_url.partition("://")
    segs = [s for s in path.split("/") if s not in ("", ".")]
    lead = "/" if path.startswith("/") else ""
    for part in rel.split("/"):
        if part in ("", "."):
            continue
        if part == "..":
            if segs:
                segs.pop()
        else:
            segs.append(part)
    return f"{scheme}://{lead}{'/'.join(segs)}"


def _external_base_roots(metadata) -> List[str]:
    """The relative base roots this snapshot's manifest references —
    drained FIRST so the remote tier restores the instant this
    snapshot's metadata lands (delta-stream parents reference their
    chain the same way, which is what makes the drain chain-aware:
    bases before deltas)."""
    from .inspect import base_root_of_location, iter_blobs

    roots = set()
    for b in iter_blobs(metadata.manifest):
        if b.location.startswith("../"):
            roots.add(base_root_of_location(b.location, metadata.base_roots))
    return sorted(roots)


def drain_snapshot(
    path: str,
    remote_url: Optional[str] = None,
    storage_options: Optional[Dict[str, Any]] = None,
    *,
    deadline_s: Optional[float] = None,
    should_abort: Optional[Callable[[], bool]] = None,
) -> DrainReport:
    """Drain one snapshot to remote-durable (synchronously; the unit of
    work both the background uploader and the ``drain`` CLI run).

    ``path`` may be a tier URL or a bare local tier directory (the
    upload journal then names the remote unless ``remote_url``
    overrides it). ``deadline_s`` bounds how long a sustained outage is
    tolerated before returning a ``degraded`` report (None = keep
    probing until it converges or ``should_abort`` fires)."""
    spec = parse_tier_url(path)
    if spec is not None:
        local_dir = spec.local_dir
        remote_url = remote_url or spec.remote_url
    else:
        local_dir = path
    if remote_url is None:
        journal = read_upload_journal_dir(local_dir)
        remote_url = (journal or {}).get("remote")
        if not remote_url:
            return DrainReport(
                local_dir=local_dir,
                remote_url="",
                state="no-metadata",
                error=(
                    "no remote tier recorded: pass a tier URL, or a local "
                    "dir whose upload journal names the remote"
                ),
            )
    deadline = (
        time.monotonic() + deadline_s if deadline_s is not None else None
    )

    def give_up() -> bool:
        if should_abort is not None and should_abort():
            return True
        return deadline is not None and time.monotonic() > deadline

    return _drain_one(
        local_dir, remote_url, storage_options, give_up, visited=set()
    )


def _drain_one(
    local_dir: str,
    remote_url: str,
    storage_options: Optional[Dict[str, Any]],
    give_up: Callable[[], bool],
    visited: set,
    as_base: bool = False,
) -> DrainReport:
    from .knobs import get_tier_op_deadline_s
    from .manifest import decode_metadata
    from .snapshot import SNAPSHOT_METADATA_FNAME
    from .storage_plugin import url_to_storage_plugin

    report = DrainReport(
        local_dir=local_dir, remote_url=remote_url, state="degraded"
    )
    key = os.path.abspath(local_dir)
    if key in visited:
        report.state = "durable"  # cycle guard; parent already handles it
        return report
    visited.add(key)

    if as_base:
        # Base recursion short-circuit: an already-durable base needs no
        # work — without this, EVERY delta micro-commit's drain would
        # re-read and re-hash its whole (multi-GB, long-durable) base
        # chain on the training host. An explicit top-level drain still
        # runs the full re-verify pass.
        journal0 = read_upload_journal_dir(local_dir)
        if journal0 is not None and journal0.get("state") == "durable":
            report.state = "durable"
            return report

    event_loop = asyncio.new_event_loop()
    local = remote = None
    try:
        local_opts = dict(storage_options or {})
        local_opts.pop("fault_plan", None)
        # The drain reads the RAW local dir: a CAS-composed view would
        # synthesize ref'd locations into the listing and resolve their
        # reads through the store — the drain would then upload shared
        # blobs as per-snapshot private copies, the exact N× the store
        # exists to kill. Refs drain at store level below instead.
        local_opts["cas"] = False
        local = url_to_storage_plugin(local_dir, local_opts or None)

        # 1. Local metadata: without a local commit there is nothing to
        # make durable (a torn take's blobs are salvage fuel, not a
        # drain unit).
        read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
        try:
            local.sync_read(read_io, event_loop)
            meta_bytes = read_io.buf.getvalue()
            metadata = decode_metadata(meta_bytes)
        except Exception as e:
            report.state = "no-metadata"
            report.error = f"local metadata unreadable: {e}"
            return report

        # 2. Chain-aware: drain external bases (incremental bases,
        # delta-stream parents) to their remote siblings FIRST.
        for rel in _external_base_roots(metadata):
            base_local = os.path.normpath(os.path.join(local_dir, rel))
            # The base's own upload journal is the authoritative remote
            # target (a base taken through the tier recorded it; the
            # recorded relative root may walk arbitrarily far up the
            # tree, so textual sibling math is only the fallback for
            # hand-mirrored layouts).
            base_remote = (read_upload_journal_dir(base_local) or {}).get(
                "remote"
            ) or _remote_sibling(remote_url, rel)
            base_report = _drain_one(
                base_local,
                base_remote,
                storage_options,
                give_up,
                visited,
                as_base=True,
            )
            report.bases.append(base_report)
            if base_report.state != "durable":
                # A child must never outrun its chain: the remote can
                # only restore this snapshot once every base it
                # references is remote-durable.
                report.state = (
                    "degraded"
                    if base_report.state == "degraded"
                    else base_report.state
                )
                report.error = (
                    f"base {rel!r} did not converge "
                    f"({base_report.state}): {base_report.error}"
                )
                report.lag_bytes = base_report.lag_bytes
                return report

        # 3. Journal + pending set.
        journal = read_upload_journal(local, event_loop) or {
            "version": 1,
            "blobs": {},
        }
        journal["remote"] = remote_url
        evidence: Dict[str, list] = dict(journal.get("blobs") or {})
        files = local.sync_list_with_sizes(event_loop) or {}
        # Drain what a restore can reach: the manifest's referenced
        # LOCAL locations. Orphans, superseded-take leftovers and
        # ``.tmp.<pid>`` debris are gc's business — uploading them
        # would pay cloud bandwidth/storage for unreachable bytes and
        # inflate the lag gauge forever.
        from .lifecycle import _referenced_locations

        referenced = _referenced_locations(metadata)
        pending = sorted(p for p in referenced if p in files)
        # Content-addressed refs: locations this snapshot holds as
        # shared-store refs have no local file by design — they are
        # neither "pending" (the store drains them, below) nor
        # "unreachable" (the ref record IS their reachability).
        from .cas import read_refs as _read_cas_refs
        from .cas import resolve_store_url as _resolve_cas_store

        cas_ref_map, cas_store_url = _read_cas_refs(local, event_loop)
        cas_store_url = cas_store_url or _resolve_cas_store()
        ref_locs = {
            p for p in referenced if p in cas_ref_map and p not in files
        }
        report.cas_refs = len(ref_locs)
        # Referenced blobs neither present locally NOR carried in the
        # evidence map cannot reach the remote: refusing the durable
        # marker beats blessing a snapshot the remote cannot restore.
        # (Absent-but-evidenced = evicted past a previous durable
        # marker: the remote already holds them.)
        unreachable = sorted(
            p
            for p in referenced
            if p not in files and p not in evidence and p not in ref_locs
        )
        if unreachable:
            report.state = "missing-blobs"
            report.error = (
                f"{len(unreachable)} referenced blob(s) neither present "
                "locally nor proven remote (e.g. "
                f"{unreachable[0]!r}) — run fsck; refusing to mark "
                "remote-durable"
            )
            return report
        report.blobs_total = len(pending)
        already_durable = journal.get("state") == "durable"
        # The commit stamp THIS drain is making durable: a retake that
        # commits to the same dir while the drain runs re-stamps the
        # journal, and the durable marker must never be written over a
        # newer stamp (it would falsely bless bytes the remote does not
        # hold — and license `gc --evict-local` to delete their only
        # copy).
        drain_stamp = journal.get("committed_at")

        remote_opts = dict(storage_options or {})
        remote_opts.setdefault("retry_deadline_sec", get_tier_op_deadline_s())
        remote = url_to_storage_plugin(remote_url, remote_opts)
        circuit = _Circuit(remote_url)

        def flush_journal(mark_durable: bool = False) -> bool:
            """Merge this drain's evidence into the CURRENT on-disk
            journal (read-modify-write, never blind overwrite): a
            concurrent retake's pending stamp survives every flush.
            ``mark_durable`` writes the durable marker ONLY when the
            on-disk commit stamp is still the one this drain read at
            start; returns False (superseded) otherwise."""
            current = read_upload_journal(local, event_loop) or {
                "version": 1,
                "blobs": {},
            }
            current["remote"] = remote_url
            blobs = dict(current.get("blobs") or {})
            blobs.update(evidence)
            current["blobs"] = blobs
            superseded = current.get("committed_at") != drain_stamp
            if mark_durable and not superseded:
                current["state"] = "durable"
                current["durable_at"] = _wall()
            local.sync_write_atomic(
                WriteIO(
                    path=UPLOAD_JOURNAL_PATH,
                    buf=json.dumps(current).encode("utf-8"),
                ),
                event_loop,
            )
            journal.clear()
            journal.update(current)
            return not superseded

        lag = _pending_bytes(files, pending, evidence)
        _publish_status(
            state="draining",
            snapshot=local_dir,
            remote=remote_url,
            lag_bytes=lag,
            oldest_commit_ts=journal.get("committed_at"),
            degraded=False,
        )

        from .lifecycle import dual_hash_evidence

        # 4. Blob loop: hash local bytes; journal evidence matching the
        # fresh dual hash licenses a skip (the bytes are already proven
        # remote); everything else uploads, then records evidence and
        # flushes the journal BEFORE the next blob — the crash-safety
        # granularity a resumed drain skips on.
        for p in pending:
            read_io = ReadIO(path=p)
            local.sync_read(read_io, event_loop)
            buf = read_io.buf.getbuffer()
            triple = list(dual_hash_evidence(buf))
            prior = evidence.get(p)
            # Zero-byte blobs skip like any other: the evidence is the
            # (0, crc-of-empty, xxh-of-empty) triple, and re-uploading
            # them would re-fire tier_durable on every re-drain.
            if prior is not None and list(prior) == triple:
                report.blobs_skipped += 1
                report.bytes_skipped += triple[0]
                telemetry.incr("tier.blobs_skipped")
                telemetry.incr("tier.bytes_skipped", triple[0])
                continue
            while True:
                if give_up():
                    report.lag_bytes = _pending_bytes(files, pending, evidence)
                    report.degraded_episodes = circuit.episodes
                    report.error = report.error or (
                        "drain deadline reached while the remote is "
                        "unavailable"
                    )
                    _publish_status(
                        state="degraded", lag_bytes=report.lag_bytes,
                        degraded=True,
                    )
                    return report
                try:
                    remote.sync_write(WriteIO(path=p, buf=buf), event_loop)
                    circuit.record_success()
                    break
                except Exception as e:
                    circuit.record_failure(e)
                    report.error = f"{type(e).__name__}: {e}"
                    _publish_status(
                        state="degraded" if circuit.open else "draining",
                        lag_bytes=_pending_bytes(files, pending, evidence),
                        degraded=circuit.open,
                    )
                    _interruptible_sleep(circuit.backoff_s(), give_up)
            evidence[p] = triple
            report.blobs_uploaded += 1
            report.bytes_uploaded += triple[0]
            telemetry.incr("tier.blobs_uploaded")
            telemetry.incr("tier.bytes_uploaded", triple[0])
            flush_journal()
            _publish_status(
                state="draining",
                lag_bytes=_pending_bytes(files, pending, evidence),
                degraded=False,
            )

        # 4b. CAS refs drain at STORE level: each unique blob uploads
        # once store-wide to the STORE's remote, with the store journal
        # (keyed by hash) as the skip evidence — N branched snapshots
        # referencing one base pay one upload, not N. The durable
        # marker below requires store-journal proof for EVERY ref'd
        # key: this snapshot's own journal proves nothing about shared
        # blobs.
        if ref_locs:
            from .cas import blob_key as _cas_key
            from .cas import drain_store, store_remote_evidence
            from .io_types import CAS_REFS_DIR

            keys = {_cas_key(tuple(cas_ref_map[p])) for p in ref_locs}
            if not cas_store_url:
                report.state = "missing-blobs"
                report.error = (
                    f"{len(ref_locs)} CAS ref(s) but no store is "
                    "configured (TPUSNAP_CAS_DIR unset and no ref "
                    "record names one) — refusing the durable marker"
                )
                return report
            store_report = drain_store(
                cas_store_url, keys=keys, storage_options=storage_options
            )
            report.cas_blobs_uploaded = store_report.uploaded
            report.cas_blobs_skipped = store_report.skipped
            proven, _ = store_remote_evidence(cas_store_url, keys)
            unproven = sorted(keys - proven)
            if unproven:
                report.state = (
                    "missing-blobs"
                    if store_report.state == "no-remote"
                    else "degraded"
                )
                report.error = (
                    f"store drain left {len(unproven)} ref'd blob(s) "
                    f"unproven remote ({store_report.summary()}) — "
                    "refusing the durable marker"
                )
                return report
            # Ref records ride to the remote dir before the metadata:
            # a restore from the bare remote can then resolve every
            # ref against the store's remote mirror.
            for p in sorted(files):
                if not p.startswith(CAS_REFS_DIR + "/") or ".tmp." in p:
                    continue
                ref_io = ReadIO(path=p)
                local.sync_read(ref_io, event_loop)
                remote.sync_write_atomic(
                    WriteIO(path=p, buf=ref_io.buf.getvalue()), event_loop
                )

        # 5. Remote metadata LAST (the remote tier becomes a committed
        # snapshot only now), then verify by read-back before the
        # durable marker — the marker must never promise what the
        # remote cannot prove it holds.
        while True:
            if give_up():
                report.lag_bytes = len(meta_bytes)
                report.degraded_episodes = circuit.episodes
                report.error = report.error or (
                    "remote metadata commit did not converge"
                )
                _publish_status(state="degraded", degraded=True,
                                lag_bytes=report.lag_bytes)
                return report
            try:
                remote.sync_write_atomic(
                    WriteIO(path=SNAPSHOT_METADATA_FNAME, buf=meta_bytes),
                    event_loop,
                )
                verify_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
                remote.sync_read(verify_io, event_loop)
                if verify_io.buf.getvalue() != meta_bytes:
                    raise IOError(
                        "remote metadata read-back does not match the "
                        "committed local bytes"
                    )
                decode_metadata(verify_io.buf.getvalue())
                circuit.record_success()
                break
            except Exception as e:
                circuit.record_failure(e)
                report.error = f"{type(e).__name__}: {e}"
                _interruptible_sleep(circuit.backoff_s(), give_up)

        # 6. The durable marker, strictly after the verify — and only
        # if no newer local commit landed while this drain ran (the
        # remote then holds a SUPERSEDED snapshot; the caller/manager
        # re-drains to converge).
        if not flush_journal(mark_durable=True):
            report.state = "superseded"
            report.error = (
                "a newer local commit landed during this drain; "
                "re-drain to converge the remote"
            )
            report.lag_bytes = 0
            report.degraded_episodes = circuit.episodes
            _publish_status(
                state="draining", degraded=False,
                snapshot=local_dir, remote=remote_url,
            )
            return report
        report.state = "durable"
        report.error = ""
        report.lag_bytes = 0
        report.degraded_episodes = circuit.episodes
        if not already_durable or report.blobs_uploaded:
            telemetry.incr("tier.drains_completed")
            flight.record(
                "tier_durable",
                op=local_dir,
                remote=remote_url,
                uploaded=report.blobs_uploaded,
                skipped=report.blobs_skipped,
            )
        _publish_status(
            state="durable", lag_bytes=0, degraded=False,
            oldest_commit_ts=None,  # nothing awaits durability anymore
            snapshot=local_dir, remote=remote_url,
        )
        return report
    finally:
        try:
            for plugin in (remote, local):
                if plugin is None:
                    continue
                try:
                    plugin.sync_close(event_loop)
                except Exception:
                    logger.debug("drain plugin close failed", exc_info=True)
        finally:
            event_loop.close()


def _pending_bytes(
    files: Dict[str, int], pending: List[str], evidence: Dict[str, list]
) -> int:
    return sum(
        files[p]
        for p in pending
        if evidence.get(p) is None or evidence[p][0] != files[p]
    )


def _interruptible_sleep(seconds: float, give_up: Callable[[], bool]) -> None:
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        if give_up():
            return
        time.sleep(min(0.05, max(end - time.monotonic(), 0.0)))


# ------------------------------------------------------ background drain


class DrainManager:
    """Process-global background uploader: one daemon thread draining a
    deduplicated queue of (local_dir, remote_url) jobs. Deliberately
    survives plugin close — durability converges across takes — and
    deliberately owns NO shutdown blocking: a process exit mid-drain is
    exactly the crash the upload journal makes cheap to resume."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._backlog_lock = threading.Lock()
        self._queue: List[Tuple[str, str, Optional[Dict[str, Any]]]] = []
        self._active: Optional[str] = None
        # Jobs re-enqueued WHILE active (a retake committing to the dir
        # the drain is currently working): remembered and re-queued when
        # the active job finishes — dropping them would leave the
        # retake's bytes local-committed forever despite auto-drain.
        self._dirty: Dict[str, Tuple[str, str, Optional[Dict[str, Any]]]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = False

    def enqueue(
        self,
        local_dir: str,
        remote_url: str,
        storage_options: Optional[Dict[str, Any]] = None,
    ) -> None:
        key = os.path.abspath(local_dir)
        with self._cv:
            if self._stop:
                return
            if key == self._active:
                self._dirty[key] = (local_dir, remote_url, storage_options)
            elif all(os.path.abspath(j[0]) != key for j in self._queue):
                self._queue.append((local_dir, remote_url, storage_options))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run,
                    name="tpusnap-tier-drain",
                    daemon=True,
                )
                self._thread.start()
            self._cv.notify_all()
        self._publish_backlog()

    def _publish_backlog(self) -> None:
        """Fold the QUEUED (not-yet-active) snapshots' local-only bytes
        into the published lag: during a sustained outage micro-commits
        pile up behind the one stuck job, and a gauge that only counted
        the active drain would understate the exposure by the whole
        queue. Each queued dir is one journal read + payload walk —
        queues are short (deduplicated per dir). Snapshot-compute-
        publish runs atomically under one lock: without it, an
        enqueue-time publisher that computed from the pre-pop queue
        could land AFTER the dequeue's fresh zero and stick a stale
        backlog in the gauge forever."""
        with self._backlog_lock:
            with self._cv:
                queued = [j[0] for j in self._queue]
            backlog = 0
            for d in queued:
                try:
                    st = tier_state_of_dir(d)
                    backlog += int((st or {}).get("lag_bytes") or 0)
                except Exception:
                    continue
            _publish_status(queued_lag_bytes=backlog)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                local_dir, remote_url, opts = self._queue.pop(0)
                self._active = os.path.abspath(local_dir)
            self._publish_backlog()
            rerun = False
            try:
                report = drain_snapshot(
                    local_dir,
                    remote_url,
                    opts,
                    should_abort=lambda: self._stop,
                )
                # A drain superseded by a concurrent retake must run
                # again even if no enqueue raced the active window.
                rerun = report.state == "superseded"
            except Exception:
                logger.warning(
                    "background drain of %r failed (will not retry until "
                    "the next take or an explicit `tiering.drain_snapshot`)",
                    local_dir,
                    exc_info=True,
                )
            finally:
                with self._cv:
                    key, self._active = self._active, None
                    dirty = self._dirty.pop(key, None)
                    if dirty is not None:
                        self._queue.append(dirty)
                    elif rerun and not self._stop:
                        self._queue.append((local_dir, remote_url, opts))
                    self._cv.notify_all()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is empty and no job is active (tests;
        True when idle was reached within ``timeout``)."""
        end = (
            time.monotonic() + timeout if timeout is not None else None
        )
        with self._cv:
            while self._queue or self._active is not None:
                remaining = None
                if end is not None:
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cv.wait(timeout=remaining if remaining else 0.1)
            return True

    def stop(self) -> None:
        """Test aid: abort the current job at its next blob/backoff
        boundary and park the thread. The journal keeps everything
        resumable."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
        with self._cv:
            self._stop = False
            self._thread = None
            self._queue.clear()
            self._active = None


_manager: Optional[DrainManager] = None
_manager_lock = threading.Lock()


def drain_manager() -> DrainManager:
    global _manager
    with _manager_lock:
        if _manager is None:
            _manager = DrainManager()
        return _manager


def reset_manager_for_tests() -> None:
    global _manager
    with _manager_lock:
        m, _manager = _manager, None
    if m is not None:
        m.stop()


# ------------------------------------------------- tier-aware SLO seams


def restore_source_label(path: str) -> Optional[str]:
    """The storage-plugin class label a restore of ``path`` would
    actually read its bytes from — the tier-aware input to the SLO RTO
    estimator. None for non-tiered snapshots (no filter: today's
    single-backend behavior).

    For a tiered snapshot (tier URL, or a local tier dir carrying an
    upload journal): the LOCAL tier's label while every referenced blob
    is still cached locally, the REMOTE tier's once any has been
    evicted — a restore falls back per blob, and the evicted bytes
    dominate its wall-clock."""
    try:
        spec = parse_tier_url(path)
    except ValueError:
        return None
    if spec is not None:
        local_dir = spec.local_dir
        remote_scheme = spec.remote_scheme
    else:
        if "://" in path:
            scheme = path.split("://", 1)[0].lower()
            if scheme.startswith("chaos+"):
                scheme = scheme[len("chaos+"):]
            if scheme not in ("", "fs", "file"):
                return None
            local_dir = path.split("://", 1)[1]
        else:
            local_dir = path
        remote_scheme = None
    journal = read_upload_journal_dir(local_dir)
    if journal is None:
        return None
    if remote_scheme is None:
        remote = str(journal.get("remote") or "")
        remote_scheme = remote.split("://", 1)[0] if "://" in remote else "fs"
    try:
        from .lifecycle import _referenced_locations
        from .manifest import decode_metadata
        from .snapshot import SNAPSHOT_METADATA_FNAME

        with open(os.path.join(local_dir, SNAPSHOT_METADATA_FNAME), "rb") as f:
            metadata = decode_metadata(f.read())
        referenced = _referenced_locations(metadata)
        all_local = all(
            os.path.exists(os.path.join(local_dir, loc)) for loc in referenced
        )
    except Exception:
        all_local = False
    if all_local:
        return scheme_plugin_label("fs")
    return scheme_plugin_label(remote_scheme)


def tier_state_of_dir(local_dir: str) -> Optional[Dict[str, Any]]:
    """Compact per-snapshot tier state for CLI surfaces (``info``,
    ``watch``, ``drain --status``): durability, remote target, and the
    local-only lag derived from the journal evidence vs the blobs on
    disk. None when the directory is not a tiered snapshot."""
    from .snapshot import SNAPSHOT_METADATA_FNAME

    journal = read_upload_journal_dir(local_dir)
    if journal is None:
        return None
    evidence = journal.get("blobs") or {}
    # Referenced locations only, matching what the drain will actually
    # ship (orphans/debris are gc's business, not upload lag). Falls
    # back to a whole-tree walk when the metadata is unreadable (torn
    # local state — everything non-sidecar counts as exposed).
    referenced = None
    try:
        from .lifecycle import _referenced_locations
        from .manifest import decode_metadata

        with open(os.path.join(local_dir, SNAPSHOT_METADATA_FNAME), "rb") as f:
            referenced = _referenced_locations(decode_metadata(f.read()))
    except Exception:
        referenced = None
    lag = 0
    pending = 0
    try:
        for dirpath, _dirnames, filenames in os.walk(local_dir):
            rel_dir = os.path.relpath(dirpath, local_dir).replace(os.sep, "/")
            if rel_dir == SIDECAR_PREFIX.rstrip("/") or rel_dir.startswith(
                SIDECAR_PREFIX
            ):
                continue
            for name in filenames:
                rel = name if rel_dir == "." else f"{rel_dir}/{name}"
                if rel.startswith(SIDECAR_PREFIX) or rel == SNAPSHOT_METADATA_FNAME:
                    continue
                if referenced is not None and rel not in referenced:
                    continue
                try:
                    size = os.path.getsize(os.path.join(dirpath, name))
                except OSError:
                    continue
                rec = evidence.get(rel)
                if rec is None or rec[0] != size:
                    lag += size
                    pending += 1
    except OSError:
        pass
    return {
        "durability": durability_of_journal(journal),
        "remote": journal.get("remote"),
        "state": journal.get("state"),
        "committed_at": journal.get("committed_at"),
        "durable_at": journal.get("durable_at"),
        "lag_bytes": lag,
        "pending_blobs": pending,
        "evidenced_blobs": len(evidence),
    }
