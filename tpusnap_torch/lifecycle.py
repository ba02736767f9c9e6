"""Crash-safe snapshot lifecycle: take journal, fsck/GC, salvage-resume.

Counterpart of tpusnap/lifecycle.py: the same journal family, evidence
format and fsck states (docs/format.md), with the write-back tier's
durability states and the content-addressed store's verdicts, so either
package classifies, salvages and collects the other's snapshots.

The two-phase commit proves ``metadata exists ⟺ snapshot restores
bit-exact`` — but says nothing about the OTHER side of a crash. This
module closes that gap:

- **Take journal** (``.tpusnap/journal``): rank 0 writes a record (take
  id, world size, incremental base, started-at) through the take's own
  storage plugin BEFORE any blob write and clears it only after the
  metadata commit, so a directory holding a SIGKILLed take is
  distinguishable from a committed snapshot, an empty path, or foreign
  files. While writes run, every rank journals per-blob completion
  records (``.tpusnap/journal.d/rank_<k>``: location → size + CRC32C +
  XXH64 of the exact bytes written) — the salvage evidence.
- **fsck** classifies a directory (committed / torn / empty /
  corrupt-metadata / foreign) and, on backends that can list, enumerates
  orphan blobs unreferenced by the manifest. **gc** reclaims them —
  dry-run by default, and safe to run concurrently with readers because
  orphan blobs are never referenced by any committed manifest.
- **Salvage-resume**: a take to a path holding a torn take loads the
  journal's completion records; any staged blob whose freshly computed
  CRC32C+XXH64 pair (the SAME dual-hash evidence rule incremental dedup
  uses — one 32-bit CRC leaves a ~2^-32 silent-collision channel)
  matches the record for its target location skips its storage write:
  the bytes are already on disk. A crash at 90% of a multi-TB take costs
  ~10% of the bytes on retry. Slab blobs carry fresh uuid locations each
  take and are simply rewritten (their members are small by
  construction).

Trust model: a completion record is written only AFTER the storage op
returned success, so record ⟹ the blob held exactly those bytes. This is
process-crash-grade evidence (SIGKILL, OOM-kill, preemption — the page
cache survives); power-loss-grade salvage additionally needs
``TPUSNAP_DURABLE_COMMIT=1`` at the torn take (each blob fsync'd before
its record). Post-salvage integrity is independently provable either
way: the committed manifest records stage-time checksums, so
``python -m tpusnap verify`` re-reads every salvaged byte.
"""

from __future__ import annotations

import asyncio
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import _native, flight, telemetry
from .io_types import (
    CAS_REFS_DIR,
    FLIGHT_DIR,
    JOURNAL_FNAME,
    JOURNAL_RECORDS_DIR,
    PROBE_DIR,
    PROGRESS_DIR,
    SIDECAR_PREFIX,
    TELEMETRY_DIR,
    UPLOAD_JOURNAL_PATH,
    ReadIO,
    StoragePlugin,
    WriteIO,
)
from .manifest import MetadataError, SnapshotMetadata, decode_metadata

logger = logging.getLogger(__name__)

__all__ = [
    "FsckReport",
    "GCReport",
    "TakeJournal",
    "fsck_snapshot",
    "gc_snapshot",
]

_SIDECAR_PREFIX = SIDECAR_PREFIX  # canonical definition: io_types
# Heartbeat records (tpusnap_torch.progress): observability-only — ignored by
# fsck's empty/foreign decision, legit in committed snapshots.
_PROGRESS_SIDECAR_PREFIX = PROGRESS_DIR + "/"
# Roofline probe streams (scheduler._ProbeRunner, TPUSNAP_PROBE=1):
# transient; ignored by the empty/foreign decision (a stranded stream
# must not make an aborted dir unreusable) but NOT legit post-commit —
# in a committed snapshot a leftover is an orphan gc reclaims.
_PROBE_SIDECAR_PREFIX = PROBE_DIR + "/"
# Flight-recorder event logs (tpusnap_torch.flight): observability-only, the
# same class as heartbeats — legit in committed snapshots (the black
# box of the take that produced them) and exempt from the empty/foreign
# decision (an aborted/killed take's forensic breadcrumb is the whole
# point; it must not lock the path out of reuse).
_FLIGHT_SIDECAR_PREFIX = FLIGHT_DIR + "/"


def journal_rank_path(rank: int) -> str:
    return f"{JOURNAL_RECORDS_DIR}/rank_{rank}"


def dual_hash_evidence(buf) -> Tuple[int, str, str]:
    """The dual-hash evidence triple of a buffer —
    ``(nbytes, "<algo>:<8-hex>", "<algo>:<16-hex>")`` from ONE fused
    CRC32C+XXH64 pass. The one evidence rule shared by incremental
    dedup, salvage-resume and the write-back upload journal
    (:mod:`tpusnap_torch.tiering`): a 32-bit CRC alone leaves a ~2^-32
    silent-collision channel, the 64-bit lane closes it."""
    from .knobs import get_native_copy_threads

    mv = memoryview(buf).cast("B")
    crcs, xxhs = _native.crc_xxh_tiles(mv, 0, nthreads=get_native_copy_threads())
    return (
        mv.nbytes,
        f"{_native.checksum_algorithm()}:{crcs[0] & 0xFFFFFFFF:08x}",
        f"{_native.dedup_hash_algorithm()}:{xxhs[0] & ((1 << 64) - 1):016x}",
    )


def is_journal_path(path: str) -> bool:
    """True for the journal marker and its per-rank record files (the
    fault layer groups ops on these under the ``journal`` chaos kind)."""
    return path == JOURNAL_FNAME or path.startswith(JOURNAL_RECORDS_DIR + "/")


# ------------------------------------------------------------------ journal


@dataclass
class TakeJournal:
    """The ``.tpusnap/journal`` record: present ⟺ a take started here and
    its metadata commit has not completed (modulo the post-commit clear,
    which fsck treats as stale when valid metadata exists)."""

    take_id: str
    world_size: int
    started_at: float
    incremental_from: Optional[str] = None
    version: str = ""
    # Delta-chain membership (tpusnap_torch.delta): the stream id, this
    # micro-commit's sequence number and its parent member name — what
    # lets fsck/timeline name the in-flight delta state of a take that
    # never committed (a committed member carries the same fields in
    # its metadata ``extras["delta"]`` instead).
    stream: Optional[Dict[str, Any]] = None

    def to_json(self) -> str:
        d = {
            "take_id": self.take_id,
            "world_size": self.world_size,
            "started_at": self.started_at,
            "incremental_from": self.incremental_from,
            "version": self.version,
        }
        if self.stream:
            d["stream"] = self.stream
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "TakeJournal":
        d = json.loads(s)
        stream = d.get("stream")
        return cls(
            take_id=d["take_id"],
            world_size=int(d["world_size"]),
            started_at=float(d.get("started_at", 0.0)),
            incremental_from=d.get("incremental_from"),
            version=d.get("version", ""),
            stream=stream if isinstance(stream, dict) else None,
        )


def write_journal(
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
    journal: TakeJournal,
) -> None:
    """Rank 0, before any blob write. Atomic so a crash mid-write never
    leaves a torn journal masquerading as one."""
    storage.sync_write_atomic(
        WriteIO(path=JOURNAL_FNAME, buf=journal.to_json().encode("utf-8")),
        event_loop,
    )
    flight.record(
        "journal", op="marker_written", take_id=journal.take_id[:8]
    )


def read_journal(
    storage: StoragePlugin, event_loop: asyncio.AbstractEventLoop
) -> Optional[TakeJournal]:
    """The journal at this path, or None (absent/unreadable/corrupt —
    corrupt is logged and treated as absent: the journal is advisory
    metadata, never load-bearing for restore correctness)."""
    read_io = ReadIO(path=JOURNAL_FNAME)
    try:
        storage.sync_read(read_io, event_loop)
    except Exception:
        return None
    try:
        return TakeJournal.from_json(read_io.buf.getvalue().decode("utf-8"))
    except Exception:
        logger.warning("Unparseable take journal at %r; ignoring", JOURNAL_FNAME)
        return None


def clear_journal(
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
    world_size: int,
) -> None:
    """Post-commit (rank 0) / abort cleanup: best-effort removal of the
    per-rank completion records, then the journal marker LAST — at no
    point does a record file outlive the marker's promise, and a crash
    mid-clear leaves a stale-but-classifiable state (valid metadata +
    journal = committed; fsck flags the leftovers as orphans).

    ``world_size`` must cover every rank that may have written a record
    — a salvage-retake over a torn take with a LARGER world size passes
    the max of the two (see ``_take_impl``), which is what lets this
    stay a fixed set of deletes instead of a full storage listing on
    every take's commit path. Flush-tmp debris (``rank_k.tmp.<pid>``)
    from a SIGKILLed flush is not covered; it is fsck-visible and gc
    reclaims it."""
    for r in range(world_size):
        try:
            storage.sync_delete(journal_rank_path(r), event_loop)
        except Exception:
            # A surviving record file under a cleared marker is inert
            # (fsck flags it as an orphan); the take is committed.
            logger.debug(
                "journal record delete failed (rank %d)", r, exc_info=True
            )
    try:
        storage.sync_delete(JOURNAL_FNAME, event_loop)
        flight.record("journal", op="marker_cleared")
    except Exception:
        # Marker outliving the commit keeps the dir classifiable
        # (valid metadata + journal = committed); not worth failing a
        # finished take over, but worth a trace.
        logger.debug("journal marker delete failed", exc_info=True)


def load_salvage_records(
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
    world_size: int,
    files: Optional[Dict[str, int]] = None,
) -> Dict[str, Tuple[int, str, str]]:
    """Every rank's completion records from a torn take, merged:
    ``{location: (nbytes, "<algo>:<8-hex>", "<algo>:<16-hex>")}``. Any
    rank may reuse any rank's blob — the write-load partition of the
    retake need not match the torn take's.

    REQUIRES a listing (``files``, or the backend's
    ``list_with_sizes``): record files are discovered by listing
    ``journal.d/`` (robust to the torn take having had a different world
    size than the journal a concurrent retake may already have
    overwritten — benign either way: the evidence rule compares staged
    bytes against the record, so a stale or racing record can only cause
    a rewrite, never a wrong skip), and every record is cross-checked
    against the files actually present (existence + exact size). That
    cross-check is LOAD-BEARING, not an optimization: a record whose
    blob is gone — e.g. a record file that outlived an abort's blob
    cleanup by one SIGKILL — must never license a write skip, or the
    retake commits a manifest referencing a missing blob. Backends that
    cannot list therefore get NO salvage (empty dict; the journal still
    classifies their crashes). ``world_size`` is unused when a listing
    exists and kept for the signature's documentation value."""
    if files is None:
        try:
            files = storage.sync_list_with_sizes(event_loop)
        except Exception:
            files = None
    if files is None:
        logger.info(
            "Salvage-resume disabled: this storage backend cannot list, "
            "so completion records cannot be cross-checked against the "
            "blobs actually present"
        )
        return {}
    out: Dict[str, Tuple[int, str, str]] = {}
    for rec_path in sorted(
        p for p in files if p.startswith(JOURNAL_RECORDS_DIR + "/")
    ):
        read_io = ReadIO(path=rec_path)
        try:
            storage.sync_read(read_io, event_loop)
            recs = json.loads(read_io.buf.getvalue().decode("utf-8"))
        except Exception:
            continue  # flush-tmp debris, or a torn record flush
        if not isinstance(recs, dict):
            continue
        for loc, rec in recs.items():
            try:
                out[loc] = (int(rec[0]), str(rec[1]), str(rec[2]))
            except (IndexError, TypeError, ValueError):
                continue
    return {loc: rec for loc, rec in out.items() if files.get(loc) == rec[0]}


class JournalingStoragePlugin(StoragePlugin):
    """Wraps a take's (fully middleware-composed) storage plugin:

    - every successful blob ``write`` appends a completion record
      (location → nbytes + CRC32C + XXH64 of the written bytes, both
      lanes from ONE fused pass) and flushes this rank's record file
      atomically — the salvage evidence a retake consumes;
    - when salvage records from a torn take are loaded, a ``write``
      whose buffer's dual hash matches the record for its target
      location is SKIPPED (the bytes are already on disk), counted in
      the ``salvage.bytes_salvaged`` / ``salvage.blobs_salvaged``
      telemetry counters, and re-recorded so a second crash still finds
      its evidence.

    Sidecar writes (``.tpusnap/``, the metadata file) are never
    journaled. Scheduling-transparent like the retry/chaos wrappers.
    With checksums disabled (``TPUSNAP_DISABLE_CHECKSUM=1``) neither
    recording nor salvage runs — there is no evidence rule to apply —
    but the journal marker itself still makes the take classifiable."""

    def __init__(
        self,
        inner: StoragePlugin,
        rank: int,
        salvage_records: Optional[Dict[str, Tuple[int, str, str]]] = None,
    ) -> None:
        self.inner = inner
        self.rank = rank
        self.salvage_records = salvage_records or {}
        from .knobs import is_checksum_disabled, is_journal_disabled

        self._hashing = not is_checksum_disabled() and not is_journal_disabled()
        # How many ranks' record files a commit/abort clear must cover —
        # widened by the take when a prior (torn) journal had a larger
        # world size. The take sets it after construction.
        self.clear_world_size = 1
        # Seeded with the loaded salvage records: every record flush
        # (including the take-start eager one) re-persists the torn
        # take's evidence, so a SECOND crash early in a salvage-retake
        # still finds records for the not-yet-reprocessed blobs. Safe —
        # a stale entry can only cause a rewrite, never a wrong skip
        # (the existence/size cross-check and dual-hash rule gate every
        # skip).
        self._records: Dict[str, List[Any]] = {
            loc: list(rec) for loc, rec in (salvage_records or {}).items()
        }
        # Single-loop coroutines: plain flags serialize the flusher.
        self._dirty = False
        self._flushing = False
        self._executor = None

    def sync_seed_record_file(
        self, event_loop: asyncio.AbstractEventLoop
    ) -> None:
        """Take-start eager write of this rank's record file: proves a
        take started here (the journal-family evidence fsck classifies
        on) WITHOUT losing loaded salvage records — the seeded content
        is written, not an empty map."""
        self.inner.sync_write_atomic(
            WriteIO(
                path=journal_rank_path(self.rank),
                buf=json.dumps(self._records).encode("utf-8"),
            ),
            event_loop,
        )

    def _get_executor(self):
        # The fused hash pass runs GIL-released in native code on a
        # worker thread — blocking the event loop for a multi-hundred-MB
        # pass would stall every concurrent I/O dispatch.
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="tpusnap-journal"
            )
        return self._executor

    # --- scheduling transparency -----------------------------------------

    @property
    def supports_in_place_reads(self) -> bool:  # type: ignore[override]
        return self.inner.supports_in_place_reads

    def in_place_read_overhead_bytes(self, nbytes: int) -> int:
        return self.inner.in_place_read_overhead_bytes(nbytes)

    def drain_in_flight(self) -> None:
        self.inner.drain_in_flight()

    def classify_transient(self, exc: BaseException) -> bool:
        from .retry import default_classify_transient

        return getattr(
            self.inner, "classify_transient", default_classify_transient
        )(exc)

    # --- journaling core --------------------------------------------------

    def _hash_pair(self, buf) -> Tuple[int, str, str]:
        # One fused pass, honoring the total copy-thread budget (the
        # journal hash runs concurrently with the staging executor).
        return dual_hash_evidence(buf)

    async def _record(self, path: str, triple: Tuple[int, str, str]) -> None:
        self._records[path] = list(triple)
        self._dirty = True
        if self._flushing:
            return  # the in-progress flusher will pick this record up
        self._flushing = True
        try:
            while self._dirty:
                self._dirty = False
                payload = json.dumps(self._records).encode("utf-8")
                await self.inner.write_atomic(
                    WriteIO(path=journal_rank_path(self.rank), buf=payload)
                )
        except Exception:
            # Best-effort evidence: a lost flush only shrinks what a
            # future salvage can reuse — never fails the take.
            logger.warning(
                "journal record flush failed (non-fatal)", exc_info=True
            )
        finally:
            self._flushing = False

    # --- plugin interface -------------------------------------------------

    async def write(self, write_io: WriteIO) -> None:
        if (
            not self._hashing
            or write_io.path.startswith(_SIDECAR_PREFIX)
            # Slab objects are uuid-named per take: a retake can never
            # reuse one, so journaling them is pure cost (their members
            # are small by construction — the slab threshold).
            or write_io.path.startswith("batched/")
        ):
            await self.inner.write(write_io)
            return
        loop = asyncio.get_running_loop()
        triple = await loop.run_in_executor(
            self._get_executor(), self._hash_pair, write_io.buf
        )
        prior = self.salvage_records.get(write_io.path)
        if prior is not None and tuple(prior) == triple and triple[0] > 0:
            # Dual-hash evidence matched: the torn take already persisted
            # exactly these bytes at exactly this location — skip the
            # write. (Zero-byte blobs are rewritten: trivial, and it
            # keeps "skipped" synonymous with "bytes salvaged".)
            telemetry.incr("salvage.blobs_salvaged")
            telemetry.incr("salvage.bytes_salvaged", triple[0])
            telemetry.event(
                "salvaged_blob", path=write_io.path, bytes=triple[0]
            )
            flight.record(
                "blob_salvaged", op=write_io.path, bytes=triple[0]
            )
            await self._record(write_io.path, triple)
            return
        # Hand the fused-pass evidence down the chain: a CAS layer below
        # keys the shared-store blob on exactly this triple instead of
        # paying a second hash pass over the same bytes.
        write_io.dedup_triple = triple
        await self.inner.write(write_io)
        # Completion evidence exists the moment the record lands; the
        # flight event mirrors it so the post-mortem timeline shows
        # which blobs PROVABLY finished before the lights went out.
        flight.record("blob_complete", op=write_io.path, bytes=triple[0])
        await self._record(write_io.path, triple)

    async def write_atomic(self, write_io: WriteIO, durable: bool = False) -> None:
        await self.inner.write_atomic(write_io, durable=durable)

    async def read(self, read_io: ReadIO) -> None:
        await self.inner.read(read_io)

    async def delete(self, path: str) -> None:
        await self.inner.delete(path)

    async def list_with_sizes(self):
        return await self.inner.list_with_sizes()

    async def flush_created_dirs(self) -> None:
        await self.inner.flush_created_dirs()

    async def close(self) -> None:
        if self._executor is not None:
            # Finalizer-safe join policy (io_types): explicit closes
            # join the hash worker (quiescence), GC-finalizer closes
            # must not (a Thread._set_tstate_lock self-deadlock).
            from .io_types import shutdown_plugin_executor

            shutdown_plugin_executor(self._executor)
            self._executor = None
        await self.inner.close()


# --------------------------------------------------------------------- fsck


#: fsck states. "foreign" = files present but neither metadata nor
#: journal — this directory was not produced by a tpusnap take.
FSCK_STATES = ("committed", "torn", "empty", "corrupt-metadata", "foreign")


@dataclass
class FsckReport:
    """Outcome of classifying one snapshot directory."""

    path: str
    state: str  # one of FSCK_STATES
    detail: str = ""
    journal: Optional[TakeJournal] = None
    metadata: Optional[SnapshotMetadata] = None
    listing_supported: bool = True
    # committed: files not referenced by the manifest and not legitimate
    # sidecars (stale journals, torn-take leftovers, *.tmp.* debris).
    orphans: Dict[str, int] = field(default_factory=dict)
    # torn: completion-record evidence a salvage-resume will actually
    # use (already cross-checked against the listing: records whose blob
    # is gone or resized are excluded).
    salvage_records: int = 0
    salvage_bytes_present: int = 0
    # committed: dangling external (../) base references, present-but-
    # unverifiable only when the backend cannot list — counted here only
    # for this snapshot's own files.
    referenced_files: int = 0
    missing_referenced: List[str] = field(default_factory=list)
    # Write-back tiering (tpusnap_torch.tiering): the two-state durability
    # ladder when this directory is a tiered snapshot's LOCAL tier —
    # "local-committed" (upload journal present, drain pending) or
    # "remote-durable" (the durable marker was written after the last
    # remote blob + remote metadata verify). None = not tiered.
    durability: Optional[str] = None
    tier_remote: Optional[str] = None
    # remote-durable only: referenced blobs absent LOCALLY because gc
    # evicted them past the durable marker — restorable through the
    # tier's remote fallback, so they are NOT counted as missing.
    evicted: List[str] = field(default_factory=list)
    # Delta-chain membership of this directory, when it is (or was
    # becoming) a micro-commit of a delta stream: {"stream", "seq",
    # "parent"} from the committed metadata's extras (committed) or
    # the take journal (torn) — what makes a torn tail explainable as
    # "micro-commit N over member X" instead of an anonymous torn take.
    delta: Optional[Dict[str, Any]] = None
    # Content-addressed store (tpusnap_torch.cas): ref records this snapshot
    # holds instead of private payload copies. ``cas_resolved`` are
    # referenced locations whose shared blob the store verifiably holds
    # (they are NOT missing even though the snapshot dir has no such
    # file); ``cas_dangling`` are refs whose blob the store has LOST —
    # restore-breaking, the one CAS state that exits nonzero (4).
    cas_store: Optional[str] = None
    cas_refs: int = 0
    cas_dedup_bytes: int = 0
    cas_resolved: List[str] = field(default_factory=list)
    cas_dangling: List[str] = field(default_factory=list)
    # The listing this classification was computed from (None when the
    # backend cannot list) — reused by gc so one fsck+gc pays one walk.
    files: Optional[Dict[str, int]] = field(default=None, repr=False)

    def summary(self) -> str:
        s = f"{self.path}: {self.state}"
        if self.detail:
            s += f" ({self.detail})"
        if self.state == "committed":
            s += (
                f" — {self.referenced_files} referenced file(s)"
                + (
                    f", {len(self.missing_referenced)} MISSING"
                    if self.missing_referenced
                    else ""
                )
                + (
                    f", {len(self.orphans)} orphan(s) / "
                    f"{sum(self.orphans.values())} bytes reclaimable"
                    if self.orphans
                    else ", no orphans"
                    if self.listing_supported
                    else ", orphan scan unsupported on this backend"
                )
            )
            deg = (getattr(self.metadata, "extras", None) or {}).get(
                "degraded"
            )
            if isinstance(deg, dict) and deg.get("dead_ranks"):
                s += (
                    f" [DEGRADED commit: rank(s) {deg['dead_ranks']} died "
                    "mid-take; their replicated writes were adopted by "
                    "the survivors]"
                )
            if self.cas_refs:
                s += (
                    f" [CAS: {self.cas_refs} ref(s) into "
                    f"{self.cas_store or 'unknown store'}, "
                    f"{self.cas_dedup_bytes} bytes deduplicated"
                    + (
                        f"; {len(self.cas_dangling)} DANGLING ref(s) — "
                        "the store lost blob(s) this snapshot needs"
                        if self.cas_dangling
                        else ""
                    )
                    + "]"
                )
            if self.durability is not None:
                s += f" [{self.durability}"
                if self.durability == "local-committed" and self.tier_remote:
                    s += f" — cloud drain to {self.tier_remote} pending"
                elif self.tier_remote:
                    s += f" at {self.tier_remote}"
                if self.evicted:
                    s += (
                        f"; {len(self.evicted)} local blob(s) evicted, "
                        "restorable from the remote tier"
                    )
                s += "]"
        elif self.state == "torn":
            s += (
                f" — take {self.journal.take_id[:8]} world_size="
                f"{self.journal.world_size}; {self.salvage_records} "
                f"salvageable blob record(s), {self.salvage_bytes_present} "
                "bytes intact on disk (salvage-resume will reuse matching "
                "blobs)"
                if self.journal is not None
                else ""
            )
        if self.delta:
            seq = self.delta.get("seq")
            parent = self.delta.get("parent")
            if self.state == "torn":
                s += (
                    f" [torn delta micro-commit seq {seq}"
                    + (f" over {parent!r}" if parent else "")
                    + " — recovery lands on the last committed increment;"
                    " retake/gc like any torn take]"
                )
            else:
                s += (
                    f" [delta increment seq {seq}"
                    + (f", parent {parent!r}" if parent else "")
                    + "]"
                )
        return s


def _referenced_locations(metadata: SnapshotMetadata) -> set:
    """Every LOCAL file a committed manifest references (external ``../``
    locations live in base snapshots and are not this directory's)."""
    from .inspect import _entry_tensors

    out = set()
    for entry in metadata.manifest.values():
        for t in _entry_tensors(entry):
            if not t.location.startswith("../"):
                out.add(t.location)
    return out


def _is_legit_sidecar(path: str) -> bool:
    """Sidecars a committed snapshot legitimately carries: telemetry
    traces, the final heartbeat records, the flight-recorder event
    logs, and the write-back upload journal (it IS the post-commit
    durability state — clearing it would forget what is proven remote).
    The take-journal family is NOT legit post-commit (the commit clears
    it), and ``.tmp.<pid>`` debris anywhere — including a SIGKILLed
    journal/telemetry/heartbeat atomic write — is reclaimable, so both
    count as orphans. CAS ref records (``.tpusnap/cas_refs/``) are the
    committed snapshot's claim on its shared-store blobs — deleting one
    would hand the blob to the store's next sweep."""
    if path == UPLOAD_JOURNAL_PATH:
        return True
    return (
        path.startswith(
            (
                TELEMETRY_DIR + "/",
                _PROGRESS_SIDECAR_PREFIX,
                _FLIGHT_SIDECAR_PREFIX,
                CAS_REFS_DIR + "/",
            )
        )
        and ".tmp." not in path.rsplit("/", 1)[-1]
    )


def fsck_snapshot(
    path: str,
    storage_options: Optional[Dict[str, Any]] = None,
    resources: Optional[
        Tuple[asyncio.AbstractEventLoop, StoragePlugin]
    ] = None,
) -> FsckReport:
    """Classify the directory at ``path`` and enumerate reclaimable
    orphans. Read-only; never mutates anything. See :data:`FSCK_STATES`.

    tpusnap's ``python -m tpusnap fsck`` classifies the same files the
    same way."""
    from .storage_plugin import url_to_storage_plugin_in_event_loop

    owns = resources is None
    if owns:
        event_loop = asyncio.new_event_loop()
        storage = None
    else:
        event_loop, storage = resources
    try:
        if storage is None:
            storage = url_to_storage_plugin_in_event_loop(
                path, event_loop, storage_options
            )
        try:
            return _fsck_impl(path, storage, event_loop)
        finally:
            if owns:
                storage.sync_close(event_loop)
    finally:
        if owns:
            event_loop.close()


def _fsck_impl(
    path: str,
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
) -> FsckReport:
    from .snapshot import SNAPSHOT_METADATA_FNAME

    report = FsckReport(path=path, state="empty")
    listing = storage.sync_list_with_sizes(event_loop)
    report.listing_supported = listing is not None
    report.files = listing
    files = listing or {}

    meta_bytes: Optional[bytes] = None
    read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
    try:
        storage.sync_read(read_io, event_loop)
        meta_bytes = read_io.buf.getvalue()
    except Exception as e:
        # Read failed but the listing PROVES the file exists: this is a
        # storage/permission problem, not absence — refusing to classify
        # beats calling a committed snapshot "torn" and steering the
        # operator toward `gc --torn`, which would delete it.
        if report.listing_supported and SNAPSHOT_METADATA_FNAME in files:
            raise RuntimeError(
                f"{path!r}: {SNAPSHOT_METADATA_FNAME} exists but could "
                f"not be read ({e}) — fix storage access and re-run fsck; "
                "refusing to classify"
            ) from e
        meta_bytes = None

    report.journal = read_journal(storage, event_loop)
    # An unparseable journal FILE still proves a take started here — and
    # so does any per-rank record file: every rank eagerly creates its
    # own before writing blobs, which is what keeps a gang-SIGKILL in
    # the tiny pre-marker window classifiable as torn instead of
    # foreign. Only total absence of the whole journal family means no
    # take.
    journal_file_exists = report.journal is not None or (
        report.listing_supported
        and any(is_journal_path(p) for p in files)
    )

    if meta_bytes is not None:
        try:
            report.metadata = decode_metadata(meta_bytes)
        except MetadataError as e:
            report.state = "corrupt-metadata"
            report.detail = str(e)
            return report
        report.state = "committed"
        from .manifest_ops import delta_chain_fields

        delta_fields = delta_chain_fields(report.metadata)
        if delta_fields is not None:
            report.delta = dict(delta_fields)
        referenced = _referenced_locations(report.metadata)
        report.referenced_files = len(referenced)
        if report.journal is not None:
            report.detail = (
                "stale journal present (crash between metadata commit and "
                "journal clear) — reclaimable via gc"
            )
        # Write-back tiering: the upload journal carries the durability
        # ladder of a tiered snapshot's local tier.
        from .tiering import durability_of_journal, read_upload_journal

        tier_journal = read_upload_journal(storage, event_loop)
        report.durability = durability_of_journal(tier_journal)
        if tier_journal is not None:
            report.tier_remote = tier_journal.get("remote")
        if report.listing_supported:
            report.missing_referenced = sorted(
                loc for loc in referenced if loc not in files
            )
            if (
                report.missing_referenced
                and report.durability == "remote-durable"
            ):
                # Past the durable marker, a locally-absent referenced
                # blob is an EVICTED hot-cache entry, not data loss: a
                # restore through the tier URL reads it from the remote
                # (fsck the remote URL to verify the cloud copy itself).
                report.evicted = report.missing_referenced
                report.missing_referenced = []
            # Content-addressed refs: a referenced location held as a
            # CAS ref has no private file here BY DESIGN — resolve it
            # against the shared store before calling it missing. The
            # probe is a DEEP store check even when a composed CAS
            # plugin synthesized the location into the listing: the
            # synthetic entry proves a ref exists, not that the store
            # still holds the blob (a sweep may have raced it away —
            # the one restore-breaking CAS state, "dangling ref").
            from .cas import blob_exists_in_store, blob_key as _cas_key
            from .cas import read_refs, resolve_store_url

            cas_refs, cas_store = read_refs(storage, event_loop)
            if cas_refs:
                report.cas_store = cas_store or resolve_store_url()
                report.cas_refs = len(cas_refs)
                missing = set(report.missing_referenced)
                for loc in sorted(set(cas_refs) & referenced):
                    rec = cas_refs[loc]
                    missing.discard(loc)
                    if blob_exists_in_store(
                        report.cas_store, _cas_key(tuple(rec))
                    ):
                        report.cas_resolved.append(loc)
                        report.cas_dedup_bytes += int(rec[0])
                    else:
                        report.cas_dangling.append(loc)
                report.missing_referenced = sorted(missing)
            if report.missing_referenced:
                report.detail = (
                    f"{len(report.missing_referenced)} referenced blob(s) "
                    "missing from storage — the snapshot will not restore"
                )
            if report.cas_dangling:
                report.detail = (
                    f"{len(report.cas_dangling)} CAS ref(s) DANGLING — "
                    f"the store at {report.cas_store!r} no longer holds "
                    "their blobs; the snapshot will not restore"
                )
            report.orphans = {
                p: sz
                for p, sz in sorted(files.items())
                if p not in referenced
                and p != SNAPSHOT_METADATA_FNAME
                and not _is_legit_sidecar(p)
            }
        return report

    if journal_file_exists:
        report.state = "torn"
        if report.journal is not None and report.journal.stream:
            # A torn delta micro-commit: the journal names the stream,
            # sequence number and parent — recovery is "restore the
            # last committed increment", never this directory.
            report.delta = dict(report.journal.stream)
            world = report.journal.stream.get("world")
            ranks = (
                world.get("ranks") if isinstance(world, dict) else None
            )
            if (
                isinstance(ranks, list)
                and ranks
                and report.listing_supported
            ):
                # Multi-rank epoch: name the GLOBAL rank(s) whose
                # per-rank evidence never landed — whose writes the
                # tear interrupted (journal virtual rank v maps to
                # global ranks[v]).
                have = {
                    v
                    for v in range(len(ranks))
                    if journal_rank_path(v) in files
                }
                missing = [
                    int(ranks[v])
                    for v in range(len(ranks))
                    if v not in have
                ]
                if missing:
                    report.detail = (
                        "torn multi-rank micro-commit: journal evidence "
                        f"missing from global rank(s) {missing} (world "
                        f"{ranks})"
                    )
        if report.journal is not None:
            # Already existence/size-filtered against the listing — what
            # a salvage-retake will actually consider (empty on backends
            # that cannot list, where salvage is disabled).
            records = load_salvage_records(
                storage,
                event_loop,
                report.journal.world_size,
                files=files if report.listing_supported else None,
            )
            report.salvage_records = len(records)
            report.salvage_bytes_present = sum(
                n for n, _, _ in records.values()
            )
        else:
            report.detail = (
                "journal marker missing or unparseable but per-rank "
                "records exist (torn marker write, or a kill inside the "
                "pre-marker window)"
            )
        return report

    # Heartbeat records (.tpusnap/progress/) are observability
    # breadcrumbs, never take evidence or payload: an ABORTED take
    # cleans its blobs and journal but leaves its final "aborted"
    # record for post-mortems — the path must still read as empty
    # (reusable), not foreign. Roofline probe streams (.tpusnap/probe/,
    # TPUSNAP_PROBE=1) are the same class: transient raw bytes a flaky
    # backend's failed cleanup can strand in an aborted dir; they must
    # not lock the path into "foreign" (which gc refuses) — in any
    # OTHER state they stay orphan-visible and reclaimable.
    meaningful = {
        p: sz
        for p, sz in files.items()
        if not p.startswith(
            (
                _PROGRESS_SIDECAR_PREFIX,
                _PROBE_SIDECAR_PREFIX,
                _FLIGHT_SIDECAR_PREFIX,
            )
        )
        # The write-back upload journal is tier bookkeeping, never take
        # evidence: a tiered take that died before its take journal (or
        # with TPUSNAP_DISABLE_JOURNAL=1) must not read as foreign.
        and p != UPLOAD_JOURNAL_PATH
    }
    if meaningful:
        report.state = "foreign"
        report.detail = (
            f"{len(meaningful)} file(s) but no metadata and no journal — "
            "not a tpusnap take (or a pre-journal crash); refusing to "
            "classify as torn"
        )
    else:
        report.state = "empty"
        if not report.listing_supported:
            report.detail = (
                "no metadata, no journal; backend cannot list, so foreign "
                "files cannot be ruled out"
            )
    return report


# ----------------------------------------------------------------------- gc


def _evictable_local_blobs(
    path: str,
    fsck: FsckReport,
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
) -> Dict[str, int]:
    """The referenced local payload blobs ``gc --evict-local`` may
    reclaim from a tiered snapshot's local tier. Refuses (raises)
    unless the snapshot is ``remote-durable`` AND the durable marker
    has aged past the hot-local-cache retention window — the tiering
    gc safety rule."""
    import time as _time

    from .knobs import get_tier_local_retention_s
    from .tiering import read_upload_journal

    if fsck.durability is None:
        raise RuntimeError(
            f"{path!r} is not a tiered snapshot (no upload journal); "
            "--evict-local only applies to write-back tier local dirs"
        )
    if fsck.durability != "remote-durable":
        raise RuntimeError(
            f"{path!r} is {fsck.durability}: its blobs are NOT yet proven "
            "remote — refusing to evict the only durable copy (run "
            "`tiering.drain_snapshot` to convergence first)"
        )
    journal = read_upload_journal(storage, event_loop) or {}
    retention = get_tier_local_retention_s()
    durable_at = journal.get("durable_at")
    if retention > 0:
        age = (
            _time.time() - durable_at
            if isinstance(durable_at, (int, float))
            else 0.0
        )
        if age < retention:
            raise RuntimeError(
                f"{path!r} became remote-durable only {age:.0f}s ago; "
                f"TPUSNAP_TIER_LOCAL_RETENTION_S={retention:g} keeps the "
                "hot local cache that long — re-run later or lower the "
                "retention window"
            )
    from .snapshot import SNAPSHOT_METADATA_FNAME

    referenced = (
        _referenced_locations(fsck.metadata) if fsck.metadata else set()
    )
    files = fsck.files or {}
    evictable = {
        p: sz
        for p, sz in sorted(files.items())
        if p in referenced
        and p != SNAPSHOT_METADATA_FNAME
        and not p.startswith(_SIDECAR_PREFIX)
    }
    if fsck.cas_refs:
        # CAS interplay: payload locations held as refs occupy no local
        # bytes here — their blobs live in the SHARED store, and this
        # snapshot's own upload journal proves nothing about them. A
        # composed listing synthesizes them into ``files``, so naive
        # eviction would delete the REF (dropping the gc liveness root
        # other restores rely on). Exclude them — and refuse outright
        # unless the store's upload journal proves every ref'd blob
        # remote: post-eviction this directory restores from remotes,
        # and a ref'd blob with no store-remote evidence would have NO
        # durable copy backing this snapshot's claim.
        from .cas import blob_key as _cas_key
        from .cas import read_refs, resolve_store_url, store_remote_evidence

        cas_refs, cas_store = read_refs(storage, event_loop)
        store_url = cas_store or resolve_store_url()
        ref_locs = set(cas_refs) & referenced
        keys = {_cas_key(tuple(cas_refs[loc])) for loc in ref_locs}
        proven, _remote = (
            store_remote_evidence(store_url, keys)
            if store_url
            else (set(), None)
        )
        unproven = sorted(keys - proven)
        if unproven:
            raise RuntimeError(
                f"{path!r} holds {len(ref_locs)} CAS ref(s) into "
                f"{store_url!r} but the STORE's upload journal proves "
                f"only {len(proven)}/{len(keys)} of their blobs remote "
                "— a snapshot's own durable marker does not cover "
                "shared blobs; run `cas.drain_store` to "
                "convergence first"
            )
        evictable = {
            p: sz for p, sz in evictable.items() if p not in ref_locs
        }
    return evictable


@dataclass
class GCReport:
    path: str
    state: str  # the fsck state gc acted on
    dry_run: bool
    reclaimed: Dict[str, int] = field(default_factory=dict)
    errors: List[str] = field(default_factory=list)

    @property
    def bytes_reclaimed(self) -> int:
        return sum(self.reclaimed.values())

    def summary(self) -> str:
        verb = "would reclaim" if self.dry_run else "reclaimed"
        s = (
            f"{self.path}: {self.state}; {verb} {len(self.reclaimed)} "
            f"file(s), {self.bytes_reclaimed} bytes"
        )
        if self.errors:
            s += f" ({len(self.errors)} delete error(s))"
        return s


def gc_snapshot(
    path: str,
    storage_options: Optional[Dict[str, Any]] = None,
    dry_run: bool = True,
    reclaim_torn: bool = False,
    evict_local: bool = False,
) -> GCReport:
    """Reclaim files a reader can never reach.

    - **committed**: deletes the orphans fsck enumerates — files the
      manifest does not reference (stale journals, torn-take leftovers a
      salvage didn't reuse, ``*.tmp.*`` debris). Safe concurrently with
      readers: every deleted file is unreferenced by the committed
      manifest, and the manifest itself is immutable.
    - **torn**: REFUSED by default — the blobs are salvage-resume fuel
      (retaking to the path reuses them). ``reclaim_torn=True`` deletes
      everything including the journal, returning the path to empty.
    - **corrupt-metadata / foreign**: always refused; an operator must
      decide (restore the metadata from a replica, or delete manually).
    - ``evict_local=True`` additionally reclaims a tiered snapshot's
      LOCAL payload blobs — permitted only past ``remote-durable``
      (the one gc safety rule tiering adds: a blob may leave the local
      tier only once the upload journal's durable marker proves the
      remote holds the whole snapshot), and only once the marker is
      older than the ``TPUSNAP_TIER_LOCAL_RETENTION_S`` hot-cache
      window. Metadata and the upload journal are never evicted, so
      the directory keeps classifying as remote-durable and reads
      through the tier URL fall back to the remote.

    ``dry_run=True`` (the default) only reports what would be deleted.
    tpusnap's ``python -m tpusnap gc`` does the same to the same files."""
    from .storage_plugin import url_to_storage_plugin_in_event_loop

    if evict_local:
        # Eviction deletes from the LOCAL tier only: through a tier URL
        # the composed plugin would propagate deletes to the remote —
        # destroying the very durability that licenses the eviction.
        from .tiering import parse_tier_url

        spec = parse_tier_url(path)
        if spec is not None:
            path = spec.local_dir

    event_loop = asyncio.new_event_loop()
    try:
        storage = url_to_storage_plugin_in_event_loop(
            path, event_loop, storage_options
        )
        try:
            fsck = _fsck_impl(path, storage, event_loop)
            report = GCReport(path=path, state=fsck.state, dry_run=dry_run)
            if not fsck.listing_supported:
                raise RuntimeError(
                    f"gc requires a backend that can list files; "
                    f"{path!r} cannot"
                )
            if fsck.state == "committed":
                targets = dict(fsck.orphans)
                if evict_local:
                    targets.update(
                        _evictable_local_blobs(path, fsck, storage, event_loop)
                    )
            elif fsck.state == "torn":
                if not reclaim_torn:
                    raise RuntimeError(
                        f"{path!r} holds a TORN take "
                        f"({fsck.salvage_bytes_present} salvageable bytes): "
                        "retaking to this path resumes it; pass --torn to "
                        "discard the partial take instead"
                    )
                targets = dict(sorted((fsck.files or {}).items()))
            elif fsck.state == "empty":
                targets = {}
            else:
                raise RuntimeError(
                    f"gc refuses to touch {path!r}: fsck state is "
                    f"{fsck.state!r} ({fsck.detail}) — operator decision "
                    "required"
                )
            report.reclaimed = targets
            if dry_run:
                return report
            # Blobs first, journal marker last: if gc itself is killed
            # mid-way, the directory stays classifiable (torn stays torn
            # until its journal goes; committed orphan sets only shrink).
            ordered = sorted(
                targets, key=lambda p: (p == JOURNAL_FNAME, p)
            )
            # (tpusnap orders an eviction cold-first from its access
            # ledgers, which come with A9; without them it uses this
            # name order too.)
            done: Dict[str, int] = {}
            for p in ordered:
                if (
                    p == JOURNAL_FNAME
                    and report.errors
                    and fsck.state == "torn"
                ):
                    # Some blob deletions failed: removing the marker now
                    # would strand the leftovers as "foreign" (which gc
                    # refuses) — keep the path torn so a re-run can
                    # finish the job.
                    report.errors.append(
                        f"{p}: kept (earlier deletions failed; re-run gc)"
                    )
                    continue
                try:
                    storage.sync_delete(p, event_loop)
                    done[p] = targets[p]
                except Exception as e:
                    report.errors.append(f"{p}: {e}")
            report.reclaimed = done
            if fsck.state == "committed" and fsck.cas_refs:
                # Prune ref-record entries the committed manifest does
                # not reference (a superseded retake's strands): they
                # pin shared-store blobs nothing will ever read. The
                # manifest is immutable, so this is as safe as the
                # orphan deletes above.
                from .cas import prune_refs

                pruned = prune_refs(
                    storage,
                    event_loop,
                    _referenced_locations(fsck.metadata),
                )
                if pruned:
                    logger.info(
                        "gc %s: pruned %d stale CAS ref(s)", path, pruned
                    )
            return report
        finally:
            storage.sync_close(event_loop)
    finally:
        event_loop.close()
