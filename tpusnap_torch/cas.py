"""Cross-run content-addressed blob store: crash-safe shared dedup.

``TPUSNAP_CAS_DIR`` (or an explicit ``cas+<base>://`` URL) composes a
CAS layer around a snapshot's storage plugin: every payload blob is
keyed by its (CRC32C, XXH64) dual hash — the same fused-pass evidence
rule the take journal, salvage-resume and the tiering upload journal
already run on — and published to a SHARED store directory; the
snapshot itself holds per-rank **ref records**
(``.tpusnap/cas_refs/rank_<k>.json``) instead of private copies. N
hyperparameter branches of one base model then pay ~1x storage, and a
retake after a process restart skips every blob the store already
holds, cross-process and cross-lifetime, at hash speed.

Store layout (all paths relative to the store root; the root may be a
storage URL — ``chaos+fs:///store`` — so chaos plans can SIGKILL
around store I/O)::

    blobs/<crc8hex>-<xxh16hex>   content, immutable once published
    blobs/<key>.tmp.<pid>        torn publish (fsck names it; gc sweeps)
    intents/<key>__<owner>       short-lived publish intent records
    roots/<digest>               {dir, ts}: a snapshot dir holding refs
    refcounts.json               ADVISORY ref-count cache (gc rewrites
                                 it from marks; divergence is an fsck
                                 verdict, never load-bearing)
    upload_journal               store-level dual-hash upload evidence
                                 (each unique blob drains ONCE
                                 store-wide, journal keyed by hash)
    config.json                  {"remote": <url>} optional mirror
    gc.lock                      per-store gc lease (the rank-lease shape)

Crash-safety protocol (every window SIGKILL-safe and fsck-nameable):

1. the publisher writes an **intent** record for the key;
2. the blob lands via ``write_atomic`` (tmp+rename keyed by hash — two
   jobs racing the same content converge on one file, the loser's tmp
   is orphan-visible "torn publish" debris);
3. the snapshot's **root record** and per-rank **ref record** are
   flushed — refs are the gc liveness roots, written strictly BEFORE
   the metadata commit (the CAS layer force-flushes them when the
   metadata write passes through);
4. the publisher waits out a sweep in flight that started before its
   ref landed (its lease's ``started_at``: that sweep may have marked
   before the ref and delete after it), then re-verifies the blob exists
   and republishes from the bytes it still holds if a concurrent sweep
   won the race — the closure of the adopt-then-ref window (the intent
   record makes the race rare; the wait and the re-verify make blob loss
   impossible: a sweep whose lease is written after the ref marks from a
   scan that sees it). A lease whose owner is a process of this host
   that no longer runs is abandoned and not waited on;
5. the intent is cleared (a stale intent is swept after the grace
   window).

GC (:func:`gc_store`) is mark-and-sweep over the ref records: blobs
referenced by any live root's refs — or named by an intent younger
than ``TPUSNAP_CAS_GRACE_S`` — survive; everything else older than the
grace window is swept under a per-store lock lease. Refs-as-files
rather than a refcount integer: a crashed publisher leaves either a
complete ref record or the previous one, never a half-decremented
counter — see docs/design.md "Cross-run content-addressed store".
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from . import flight, telemetry
from .io_types import (
    CAS_REFS_DIR,
    SIDECAR_PREFIX,
    ReadIO,
    StoragePlugin,
    WriteIO,
    run_on_loop,
)

logger = logging.getLogger(__name__)

# Wall-clock seam (timestamps in intents/roots/leases; injectable for
# the fake-clock unit matrix). Durations run on the monotonic clock.
_wall = time.time

_CAS_PREFIX = "cas+"

BLOBS_DIR = "blobs"
INTENTS_DIR = "intents"
ROOTS_DIR = "roots"
REFCOUNTS_PATH = "refcounts.json"
STORE_JOURNAL_PATH = "upload_journal"
CONFIG_PATH = "config.json"
GC_LOCK_PATH = "gc.lock"

#: Store sub-paths whose existence identifies a directory as a store.
_STORE_SHAPE = (BLOBS_DIR, INTENTS_DIR, ROOTS_DIR, REFCOUNTS_PATH,
                STORE_JOURNAL_PATH, GC_LOCK_PATH)


# ---------------------------------------------------------------- keys


def blob_key(triple: Tuple[int, str, str]) -> str:
    """``(nbytes, "crc32c:<8hex>", "xxh64:<16hex>") -> "<8hex>-<16hex>"``
    — the store filename of the content, derived from the SAME dual-hash
    evidence the take journal and upload journal record (the entry's
    ``uncompressed_dedup_hash`` keeps the pre-compression identity in
    the manifest; the store keys the bytes actually written)."""
    _, crc, xxh = triple
    return f"{crc.split(':', 1)[1]}-{xxh.split(':', 1)[1]}"


def blob_path(key: str) -> str:
    return f"{BLOBS_DIR}/{key}"


def _root_digest(dir_id: str) -> str:
    return hashlib.sha1(dir_id.encode("utf-8")).hexdigest()[:16]


def parse_cas_url(url_path: str) -> Optional[str]:
    """``cas+<base>://<path>`` -> ``<base>://<path>``, or None when
    ``url_path`` is not a CAS URL."""
    if "://" not in url_path:
        return None
    scheme, path = url_path.split("://", 1)
    if not scheme.lower().startswith(_CAS_PREFIX):
        return None
    base = scheme[len(_CAS_PREFIX):] or "fs"
    return f"{base}://{path}"


def store_local_root(store_url: Optional[str]) -> Optional[str]:
    """The local filesystem root of a store URL (bare path, ``fs://``,
    ``file://``, or chaos-wrapped fs), or None for non-fs stores. Store
    gc/fsck need it for mtimes (the grace window runs on file age);
    deletes still go through the composed plugin so chaos plans apply."""
    if not store_url:
        return None
    if "://" not in store_url:
        return os.path.abspath(store_url)
    scheme, path = store_url.split("://", 1)
    s = scheme.lower()
    if s.startswith("chaos+"):
        s = s[len("chaos+"):] or "fs"
    if s in ("fs", "file"):
        return os.path.abspath(path)
    return None


def resolve_store_url(
    explicit: Optional[str] = None,
    storage_options: Optional[Dict[str, Any]] = None,
) -> Optional[str]:
    from .knobs import get_cas_dir

    return (
        explicit
        or (storage_options or {}).get("cas_dir")
        or get_cas_dir()
    )


def _store_options(
    storage_options: Optional[Dict[str, Any]],
) -> Dict[str, Any]:
    """Options for the STORE's own plugin build: never recursively
    CAS-composed, and never drawing the snapshot plugin's explicit
    fault plan object (a chaos store URL draws its own plan from
    TPUSNAP_FAULT_SPEC / its own options)."""
    opts = dict(storage_options or {})
    opts["cas"] = False
    opts.pop("fault_plan", None)
    return opts


# ----------------------------------------------------------- ref records


def refs_from_json(data: bytes) -> Optional[Dict[str, Any]]:
    """Parse one per-rank ref record file; None when unparseable. Like
    the take/upload journals the refs are sanitized at the parse
    boundary — a malformed entry reads as absent, never crashes a
    reader."""
    try:
        d = json.loads(data.decode("utf-8"))
    except Exception:
        return None
    if not isinstance(d, dict) or not isinstance(d.get("refs", {}), dict):
        return None
    d.setdefault("version", 1)
    refs = {}
    for k, v in (d.get("refs") or {}).items():
        if (
            isinstance(v, (list, tuple))
            and len(v) >= 3
            and isinstance(v[0], int)
        ):
            refs[str(k)] = [int(v[0]), str(v[1]), str(v[2])]
    d["refs"] = refs
    return d


def cas_rank_path(rank: int) -> str:
    return f"{CAS_REFS_DIR}/rank_{rank}.json"


def read_refs(
    storage: StoragePlugin, event_loop: asyncio.AbstractEventLoop
) -> Tuple[Dict[str, List[Any]], Optional[str]]:
    """Merge every rank's ref records at this plugin's root: location →
    [nbytes, crc, xxh], plus the recorded store URL (from any rank's
    header). Empty on listing-incapable backends or when no refs
    exist."""
    files = storage.sync_list_with_sizes(event_loop) or {}
    refs: Dict[str, List[Any]] = {}
    store: Optional[str] = None
    for p in sorted(files):
        if not p.startswith(CAS_REFS_DIR + "/") or ".tmp." in p:
            continue
        read_io = ReadIO(path=p)
        try:
            storage.sync_read(read_io, event_loop)
        except Exception:
            continue
        doc = refs_from_json(read_io.buf.getvalue())
        if doc is None:
            logger.warning("Unparseable CAS ref record at %r; ignoring", p)
            continue
        refs.update(doc["refs"])
        store = store or doc.get("store")
    return refs, store


def read_refs_dir(local_dir: str) -> Tuple[Dict[str, List[Any]], Optional[str]]:
    """Direct-file variant of :func:`read_refs` for a LOCAL snapshot
    directory (store gc marks from roots without building per-root
    plugins)."""
    refs: Dict[str, List[Any]] = {}
    store: Optional[str] = None
    d = os.path.join(local_dir, CAS_REFS_DIR)
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return refs, store
    for name in names:
        if ".tmp." in name:
            continue
        try:
            with open(os.path.join(d, name), "rb") as f:
                doc = refs_from_json(f.read())
        except OSError:
            continue
        if doc is None:
            continue
        refs.update(doc["refs"])
        store = store or doc.get("store")
    return refs, store


def blob_exists_in_store(store_url: Optional[str], key: str) -> bool:
    """Deep existence probe against a store — snapshot fsck's
    dangling-ref check (a ref whose blob a sweep raced away is the one
    restore-breaking CAS state). Local-root stores probe the filesystem
    directly; others pay a plugin read probe."""
    if not store_url:
        return False
    root = store_local_root(store_url)
    if root is not None:
        return os.path.exists(os.path.join(root, BLOBS_DIR, key))
    store = CASStore(store_url, None)
    event_loop = asyncio.new_event_loop()
    try:
        return run_on_loop(event_loop, store.blob_exists(key))
    finally:
        try:
            run_on_loop(event_loop, store.close())
        finally:
            event_loop.close()


def prune_refs(
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
    keep: Set[str],
) -> int:
    """Drop ref-record entries whose location is outside ``keep`` —
    snapshot gc prunes refs a superseded retake stranded, so they stop
    pinning store blobs nothing references. Returns entries dropped."""
    files = storage.sync_list_with_sizes(event_loop) or {}
    pruned = 0
    for p in sorted(files):
        if not p.startswith(CAS_REFS_DIR + "/") or ".tmp." in p:
            continue
        read_io = ReadIO(path=p)
        try:
            storage.sync_read(read_io, event_loop)
        except Exception:
            logger.debug("CAS ref prune: unreadable %r", p, exc_info=True)
            continue
        doc = refs_from_json(read_io.buf.getvalue())
        if doc is None:
            continue
        kept = {loc: rec for loc, rec in doc["refs"].items() if loc in keep}
        if len(kept) == len(doc["refs"]):
            continue
        pruned += len(doc["refs"]) - len(kept)
        doc["refs"] = kept
        storage.sync_write_atomic(
            WriteIO(path=p, buf=json.dumps(doc).encode("utf-8")), event_loop
        )
    return pruned


# ------------------------------------------------------------- the store


class CASStore:
    """Async access to one store root through its composed plugin.

    One instance per CASStoragePlugin; the store plugin draws its own
    middleware (chaos for a ``chaos+fs://`` store URL, instrumentation,
    retry) from its URL, exactly like any snapshot plugin."""

    def __init__(
        self,
        store_url: str,
        storage_options: Optional[Dict[str, Any]] = None,
    ) -> None:
        from .storage_plugin import url_to_storage_plugin

        self.url = store_url
        self.local_root = store_local_root(store_url)
        self.plugin = url_to_storage_plugin(
            store_url, _store_options(storage_options)
        )
        self._config: Optional[Dict[str, Any]] = None

    async def blob_exists(self, key: str) -> bool:
        probe = ReadIO(path=blob_path(key), byte_range=(0, 1))
        try:
            await self.plugin.read(probe)
            return True
        except FileNotFoundError:
            return False

    async def publish(self, key: str, buf: Any) -> None:
        await self.plugin.write_atomic(WriteIO(path=blob_path(key), buf=buf))

    async def wait_out_sweep(self, ref_at: float) -> None:
        """Return once no store gc can delete a blob whose ref landed by
        ``ref_at`` (wall clock) without having marked it: the lease held
        now is gone, replaced (a later sweep's mark phase), expired,
        abandoned by a process of this host that no longer runs, or was
        written after ``ref_at`` (its scan starts after the lease is
        written, so it sees the ref). A sweep's deletions come from
        marks taken under its lease, so a ref written before this call
        is either seen by a later sweep or re-verified after this one's
        deletions. Stores with no local root run no gc (``gc_store``
        refuses them)."""
        if self.local_root is None:
            return
        held = _read_lease(self.local_root)
        while held is not None:
            expires, started = held.get("expires_at"), held.get("started_at")
            if not isinstance(expires, (int, float)) or expires <= _wall():
                return
            if isinstance(started, (int, float)) and started > ref_at:
                return
            if _lease_abandoned(held):
                return
            await asyncio.sleep(0.005)
            if _read_lease(self.local_root) != held:
                return

    async def write_intent(self, key: str, job: Optional[str]) -> str:
        owner = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        path = f"{INTENTS_DIR}/{key}__{owner}"
        payload = json.dumps({"ts": _wall(), "job": job}).encode("utf-8")
        await self.plugin.write_atomic(WriteIO(path=path, buf=payload))
        return path

    async def clear_intent(self, path: str) -> None:
        try:
            await self.plugin.delete(path)
        except Exception:
            # Best-effort: a stranded intent only delays reclamation of
            # its key by one grace window.
            logger.debug("CAS intent clear failed for %r", path, exc_info=True)

    async def write_root(self, dir_id: str) -> None:
        payload = json.dumps({"dir": dir_id, "ts": _wall()}).encode("utf-8")
        await self.plugin.write_atomic(
            WriteIO(path=f"{ROOTS_DIR}/{_root_digest(dir_id)}", buf=payload)
        )

    def config(self) -> Dict[str, Any]:
        if self._config is None:
            cfg: Dict[str, Any] = {}
            if self.local_root is not None:
                try:
                    with open(
                        os.path.join(self.local_root, CONFIG_PATH), "rb"
                    ) as f:
                        loaded = json.loads(f.read().decode("utf-8"))
                    if isinstance(loaded, dict):
                        cfg = loaded
                except (OSError, ValueError):
                    cfg = {}
            self._config = cfg
        return self._config

    def remote_url(self) -> Optional[str]:
        from .knobs import get_cas_remote

        return self.config().get("remote") or get_cas_remote()

    async def read_blob(self, key: str, read_io: ReadIO) -> None:
        """Read a blob into ``read_io`` (byte_range/into/want_crc
        honored), falling back to the store's remote mirror when the
        local copy was evicted AND the store journal holds upload
        evidence for the key."""
        trial = ReadIO(
            path=blob_path(key),
            byte_range=read_io.byte_range,
            into=read_io.into,
            want_crc=read_io.want_crc,
        )
        try:
            await self.plugin.read(trial)
        except FileNotFoundError:
            remote = self.remote_url()
            journal = read_store_journal(self.local_root or "")
            if remote is None or key not in (journal or {}).get("blobs", {}):
                raise
            from .storage_plugin import url_to_storage_plugin

            rp = url_to_storage_plugin(remote, _store_options(None))
            try:
                trial = ReadIO(
                    path=blob_path(key),
                    byte_range=read_io.byte_range,
                    into=read_io.into,
                    want_crc=read_io.want_crc,
                )
                await rp.read(trial)
                telemetry.incr("cas.remote_fallback_reads")
            finally:
                await rp.close()
        read_io.buf = trial.buf
        read_io.in_place = trial.in_place
        read_io.crc32c = trial.crc32c
        read_io.crc_algo = trial.crc_algo

    async def close(self) -> None:
        await self.plugin.close()


def read_store_journal(local_root: str) -> Optional[Dict[str, Any]]:
    """The store-level upload journal (blob key → dual-hash evidence of
    the bytes proven remote), or None. Advisory like every journal:
    malformed entries read as absent evidence."""
    try:
        with open(os.path.join(local_root, STORE_JOURNAL_PATH), "rb") as f:
            d = json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError):
        return None
    if not isinstance(d, dict) or not isinstance(d.get("blobs", {}), dict):
        return None
    d.setdefault("version", 1)
    d["blobs"] = {
        str(k): [int(v[0]), str(v[1]), str(v[2])]
        for k, v in (d.get("blobs") or {}).items()
        if isinstance(v, (list, tuple)) and len(v) == 3
        and isinstance(v[0], int)
    }
    return d


# ----------------------------------------------------------- the plugin


class CASStoragePlugin(StoragePlugin):
    """Composes the content-addressed store around a snapshot's (fully
    middleware-composed) storage plugin:

    - payload ``write``s publish to the store (or dedup-skip when the
      key already exists) and land a ref record instead of a private
      file — ``cas.dedup_bytes_saved`` / ``cas.blobs_published`` count
      the split;
    - ``read``/``list_with_sizes``/``delete`` resolve refs
      transparently (a ref'd location lists with its recorded size, so
      salvage-resume's existence/size cross-check keeps working);
    - the metadata commit force-flushes the ref records FIRST — refs
      are gc liveness roots and must be durable strictly before the
      snapshot becomes restorable.

    Sidecars, the metadata file and per-take slab objects (``batched/``,
    uuid-named, never reusable) pass through untouched."""

    handles_own_retries = True  # sub-plugins compose their own middleware

    def __init__(
        self,
        inner: StoragePlugin,
        base_url: str,
        store_url: Optional[str] = None,
        storage_options: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.inner = inner
        self.base_url = base_url
        self.rank = 0  # set by the take after construction
        self._storage_options = storage_options
        self._store_url = store_url
        self._store: Optional[CASStore] = None
        self._refs: Dict[str, List[Any]] = {}
        # Base snapshot dir -> its ref records (external locations).
        self._base_refs: Dict[str, Dict[str, List[Any]]] = {}
        self._refs_loaded = False
        self._root_written = False
        self._refs_lock: Optional[asyncio.Lock] = None
        self._publishing: Dict[str, asyncio.Task] = {}

    # --- store / refs plumbing -------------------------------------------

    def store(self) -> CASStore:
        if self._store is None:
            if self._store_url is None:
                raise RuntimeError(
                    f"CAS layer for {self.base_url!r} has no store: set "
                    "TPUSNAP_CAS_DIR (or storage_options['cas_dir'])"
                )
            self._store = CASStore(self._store_url, self._storage_options)
        return self._store

    def _lock(self) -> asyncio.Lock:
        if self._refs_lock is None:
            self._refs_lock = asyncio.Lock()
        return self._refs_lock

    def root_id(self) -> str:
        """The identity the store's root record names: the local dir
        when the base resolves to one (store gc then reads the refs
        directly), else the base URL itself."""
        return store_local_root(self.base_url) or self.base_url

    async def _ensure_refs_loaded(self) -> None:
        if self._refs_loaded:
            return
        self._refs_loaded = True
        files = await self.inner.list_with_sizes() or {}
        for p in sorted(files):
            if not p.startswith(CAS_REFS_DIR + "/") or ".tmp." in p:
                continue
            read_io = ReadIO(path=p)
            try:
                await self.inner.read(read_io)
            except Exception:
                continue
            doc = refs_from_json(read_io.buf.getvalue())
            if doc is None:
                continue
            # Merge every rank's records (reads/listings must resolve
            # peers' refs); this rank's flush rewrites only its own
            # file, so the merge never clobbers another rank's entries.
            for loc, rec in doc["refs"].items():
                self._refs.setdefault(loc, rec)
            if self._store_url is None and doc.get("store"):
                self._store_url = doc["store"]

    async def _flush_refs(self) -> None:
        async with self._lock():
            if not self._root_written:
                # Root BEFORE the first ref flush: refs without a root
                # record are invisible to the store's mark phase — the
                # blobs they pin would read as orphans.
                await self.store().write_root(self.root_id())
                self._root_written = True
            mine = {
                loc: rec
                for loc, rec in self._refs.items()
                if rec is not None
            }
            payload = json.dumps(
                {
                    "version": 1,
                    "store": self.store().url,
                    "refs": mine,
                }
            ).encode("utf-8")
            await self.inner.write_atomic(
                WriteIO(path=cas_rank_path(self.rank), buf=payload)
            )

    @staticmethod
    def _is_payload(path: str) -> bool:
        from .snapshot import SNAPSHOT_METADATA_FNAME

        return not (
            path.startswith(SIDECAR_PREFIX)
            or path.startswith("batched/")
            or path == SNAPSHOT_METADATA_FNAME
            or ".tmp." in path.rsplit("/", 1)[-1]
        )

    def _triple_of(self, write_io: WriteIO) -> Tuple[int, str, str]:
        # The journaling layer above stashes its fused-pass dual hash on
        # the WriteIO (one hash pass per blob, not two); compute only
        # when the take runs without journaling.
        triple = getattr(write_io, "dedup_triple", None)
        if triple is not None:
            return tuple(triple)  # type: ignore[return-value]
        from .lifecycle import dual_hash_evidence

        return dual_hash_evidence(write_io.buf)

    async def _publish_once(self, key: str, buf: Any) -> None:
        """Publish ``key`` at most once per plugin instance even under
        concurrent writes of identical content (two coroutines sharing
        one pid would interleave on the same ``.tmp.<pid>`` file)."""
        pending = self._publishing.get(key)
        if pending is None:
            pending = asyncio.ensure_future(self.store().publish(key, buf))
            self._publishing[key] = pending
        try:
            await asyncio.shield(pending)
        finally:
            if self._publishing.get(key) is pending and pending.done():
                del self._publishing[key]

    # --- plugin interface -------------------------------------------------

    async def write(self, write_io: WriteIO) -> None:
        if not self._is_payload(write_io.path):
            await self.inner.write(write_io)
            return
        await self._ensure_refs_loaded()
        triple = self._triple_of(write_io)
        key = blob_key(triple)
        store = self.store()
        from .knobs import get_job_id

        # 1. intent first: the short-lived record that keeps a
        # concurrent gc's mark phase from sweeping this key inside the
        # adopt-then-ref window.
        intent = await store.write_intent(key, get_job_id())
        if await store.blob_exists(key):
            telemetry.incr("cas.ref_hits")
            telemetry.incr("cas.dedup_bytes_saved", triple[0])
            flight.record("cas_ref_hit", op=write_io.path, bytes=triple[0])
        else:
            # 2. tmp+rename keyed by hash: concurrent publishers of the
            # same content converge on one file.
            await self._publish_once(key, write_io.buf)
            telemetry.incr("cas.blobs_published")
            telemetry.incr("cas.bytes_published", triple[0])
            flight.record("cas_publish", op=write_io.path, bytes=triple[0])
        # 3. the ref record — the liveness root — lands before this
        # write completes (the journal layer above records completion
        # evidence only after this returns).
        self._refs[write_io.path] = list(triple)
        await self._flush_refs()
        # 4. adopt-then-ref race closure: wait out a sweep that may have
        # marked before the ref landed, then re-verify; if it won the
        # window we still hold the bytes and republishing converges (the
        # next mark phase sees our ref).
        await store.wait_out_sweep(_wall())
        for _ in range(3):
            if await store.blob_exists(key):
                break
            telemetry.incr("cas.republished_after_race")
            await store.publish(key, write_io.buf)
        else:
            raise RuntimeError(
                f"CAS blob {key} vanished repeatedly after publish — "
                f"store {store.url!r} is losing writes"
            )
        # 5. the intent has served its purpose.
        await store.clear_intent(intent)

    async def write_atomic(self, write_io: WriteIO, durable: bool = False) -> None:
        from .snapshot import SNAPSHOT_METADATA_FNAME

        if write_io.path == SNAPSHOT_METADATA_FNAME:
            # Ref-before-metadata invariant: the commit must never make
            # a snapshot restorable whose liveness roots aren't durable.
            await self._ensure_refs_loaded()
            if self._refs:
                await self._flush_refs()
        await self.inner.write_atomic(write_io, durable=durable)

    def _external_ref(self, path: str) -> Optional[List[Any]]:
        """The ref record of an external (``../``) location that the base
        snapshot it points into holds as a CAS ref, or None. An
        incremental take over a CAS-composed base references the base's
        locations, which have no private file there; tpusnap reads them
        as missing, so such a snapshot does not restore through it."""
        root = store_local_root(self.base_url)
        if root is None or not path.startswith("../"):
            return None
        parts = path.split("/")
        for j in range(parts.count("..") + 1, len(parts)):
            base = os.path.normpath(os.path.join(root, *parts[:j]))
            refs = self._base_refs.get(base)
            if refs is None:
                refs = self._base_refs[base] = read_refs_dir(base)[0]
            rec = refs.get("/".join(parts[j:]))
            if rec is not None:
                return rec
        return None

    async def read(self, read_io: ReadIO) -> None:
        if not read_io.path.startswith(SIDECAR_PREFIX):
            await self._ensure_refs_loaded()
            rec = self._refs.get(read_io.path) or self._external_ref(read_io.path)
            if rec is not None:
                await self.store().read_blob(blob_key(tuple(rec)), read_io)
                telemetry.incr("cas.store_reads")
                # Access-ledger provenance: a ref-translated store read
                # (the logical location has no private copy).
                read_io.source = "cas"
                return
        await self.inner.read(read_io)

    async def delete(self, path: str) -> None:
        await self._ensure_refs_loaded()
        if self._refs.get(path) is not None:
            # Deleting a ref'd location drops the REF, never the shared
            # blob — reclaiming unreferenced blobs is gc_store's job
            # (another job may still hold a ref to the same key).
            del self._refs[path]
            await self._flush_refs()
            return
        await self.inner.delete(path)

    async def list_with_sizes(self) -> Optional[dict]:
        files = await self.inner.list_with_sizes()
        if files is None:
            return None
        await self._ensure_refs_loaded()
        out = dict(files)
        for loc, rec in self._refs.items():
            # Ref'd locations list with their recorded size: the
            # existence/size cross-check of salvage-resume and the
            # scheduler's dedup path see the store-backed blob exactly
            # like a private copy.
            out.setdefault(loc, int(rec[0]))
        return out

    async def flush_created_dirs(self) -> None:
        await self.inner.flush_created_dirs()

    async def close(self) -> None:
        await self.inner.close()
        if self._store is not None:
            await self._store.close()

    # --- scheduling transparency -----------------------------------------

    @property
    def supports_in_place_reads(self) -> bool:  # type: ignore[override]
        if self._store is not None:
            return (
                self.inner.supports_in_place_reads
                and self._store.plugin.supports_in_place_reads
            )
        return self.inner.supports_in_place_reads

    def in_place_read_overhead_bytes(self, nbytes: int) -> int:
        return self.inner.in_place_read_overhead_bytes(nbytes)

    def drain_in_flight(self) -> None:
        self.inner.drain_in_flight()
        if self._store is not None:
            self._store.plugin.drain_in_flight()

    def classify_transient(self, exc: BaseException) -> bool:
        from .retry import default_classify_transient

        return getattr(
            self.inner, "classify_transient", default_classify_transient
        )(exc)


def build_cas_plugin(
    url_path: str, storage_options: Optional[Dict[str, Any]] = None
) -> CASStoragePlugin:
    """Resolve an explicit ``cas+<base>://<path>`` URL: the base
    composes its ordinary middleware; the store comes from
    ``storage_options['cas_dir']`` / ``TPUSNAP_CAS_DIR``."""
    from .storage_plugin import url_to_storage_plugin

    base = parse_cas_url(url_path)
    if base is None:
        raise ValueError(f"not a CAS URL: {url_path!r}")
    inner_opts = dict(storage_options or {})
    inner_opts["cas"] = False  # no double composition
    inner = url_to_storage_plugin(base, inner_opts)
    return CASStoragePlugin(
        inner,
        base_url=base,
        store_url=resolve_store_url(None, storage_options),
        storage_options=storage_options,
    )


def find_cas_plugin(plugin: StoragePlugin) -> Optional[CASStoragePlugin]:
    """The CAS layer inside a composed plugin chain, if any (walks
    ``.inner`` and a write-back tier's LOCAL sub-plugin — the tier the
    take writes through)."""
    from .tiering import TieredStoragePlugin

    base: Optional[StoragePlugin] = plugin
    while base is not None:
        if isinstance(base, CASStoragePlugin):
            return base
        if isinstance(base, TieredStoragePlugin):
            base = base.local
            continue
        inner = getattr(base, "inner", None)
        base = inner if isinstance(inner, StoragePlugin) else None
    return None


# --------------------------------------------------------- store fsck/gc


@dataclass
class StoreFsckReport:
    """Read-only classification of one store directory."""

    path: str
    state: str  # "store" | "not-a-store"
    blobs: Dict[str, int] = field(default_factory=dict)  # key -> size
    referenced: Dict[str, int] = field(default_factory=dict)  # key -> refcount
    orphans: Dict[str, int] = field(default_factory=dict)  # key -> size
    dangling: List[Dict[str, Any]] = field(default_factory=list)
    torn_publishes: List[str] = field(default_factory=list)
    intents: int = 0
    stale_intents: int = 0
    roots: int = 0
    stale_roots: List[str] = field(default_factory=list)
    refcount_divergence: List[str] = field(default_factory=list)
    detail: Optional[str] = None

    @property
    def orphan_bytes(self) -> int:
        return sum(self.orphans.values())

    def summary(self) -> str:
        if self.state != "store":
            return f"{self.path}: {self.state} ({self.detail})"
        s = (
            f"{self.path}: store; {len(self.blobs)} blob(s), "
            f"{len(self.referenced)} referenced by {self.roots} root(s), "
            f"{len(self.orphans)} orphan(s) ({self.orphan_bytes} bytes "
            "reclaimable)"
        )
        if self.dangling:
            s += f"; {len(self.dangling)} DANGLING ref(s)"
        if self.torn_publishes:
            s += f"; {len(self.torn_publishes)} torn publish(es)"
        if self.stale_intents:
            s += f"; {self.stale_intents} stale intent(s)"
        if self.refcount_divergence:
            s += (
                f"; refcount cache diverges on "
                f"{len(self.refcount_divergence)} key(s)"
            )
        return s


def _scan_store(
    root: str, grace_s: float
) -> Tuple[
    Dict[str, int],  # blobs key -> size
    List[Tuple[str, float]],  # torn tmp relpaths + age
    Dict[str, int],  # marks key -> refcount
    List[Dict[str, Any]],  # dangling refs
    List[Tuple[str, float, bool]],  # intents (relpath, age, stale)
    List[Tuple[str, float, bool]],  # roots (relpath, age, stale)
    Dict[str, float],  # blob key -> age
]:
    """One shared walk for fsck/gc: blobs, marks from live roots' ref
    records, publish intents and root records with their ages."""
    now = _wall()

    def _age(p: str) -> float:
        try:
            return max(0.0, now - os.stat(p).st_mtime)
        except OSError:
            return 0.0

    blobs: Dict[str, int] = {}
    blob_age: Dict[str, float] = {}
    torn: List[Tuple[str, float]] = []
    bdir = os.path.join(root, BLOBS_DIR)
    try:
        names = sorted(os.listdir(bdir))
    except OSError:
        names = []
    for name in names:
        p = os.path.join(bdir, name)
        if ".tmp." in name:
            torn.append((f"{BLOBS_DIR}/{name}", _age(p)))
            continue
        try:
            blobs[name] = os.stat(p).st_size
        except OSError:
            continue
        blob_age[name] = _age(p)

    marks: Dict[str, int] = {}
    dangling: List[Dict[str, Any]] = []
    roots: List[Tuple[str, float, bool]] = []
    rdir = os.path.join(root, ROOTS_DIR)
    try:
        rnames = sorted(os.listdir(rdir))
    except OSError:
        rnames = []
    for name in rnames:
        p = os.path.join(rdir, name)
        if ".tmp." in name:
            continue
        try:
            with open(p, "rb") as f:
                rec = json.loads(f.read().decode("utf-8"))
            dir_id = str(rec["dir"])
        except (OSError, ValueError, KeyError, TypeError):
            roots.append((f"{ROOTS_DIR}/{name}", _age(p), True))
            continue
        refs, _ = read_refs_dir(dir_id)
        stale = not os.path.isdir(dir_id)
        roots.append((f"{ROOTS_DIR}/{name}", _age(p), stale))
        for loc, rec3 in refs.items():
            key = blob_key(tuple(rec3))
            marks[key] = marks.get(key, 0) + 1
            if key not in blobs:
                dangling.append(
                    {"root": dir_id, "location": loc, "key": key}
                )

    intents: List[Tuple[str, float, bool]] = []
    idir = os.path.join(root, INTENTS_DIR)
    try:
        inames = sorted(os.listdir(idir))
    except OSError:
        inames = []
    for name in inames:
        p = os.path.join(idir, name)
        age = _age(p)
        stale = age > grace_s
        intents.append((f"{INTENTS_DIR}/{name}", age, stale))
        if not stale:
            # A fresh intent marks its key (refcount contribution 0 —
            # protected from the sweep, not yet "referenced"): the
            # publisher is, or very recently was, inside the
            # publish-to-ref window.
            marks.setdefault(name.split("__", 1)[0], 0)
    return blobs, torn, marks, dangling, intents, roots, blob_age


def _is_store_dir(root: str) -> bool:
    return any(
        os.path.exists(os.path.join(root, p)) for p in _STORE_SHAPE
    )


def fsck_store(
    store_url: str, grace_s: Optional[float] = None
) -> StoreFsckReport:
    """Store-wide fsck: read-only; names every CAS failure-mode state
    (dangling ref, orphan, torn publish, stale intent/root, refcount
    cache divergence). Exposed as ``python -m tpusnap fsck --store``.

    Exit contract at the CLI: 0 = clean or merely-reclaimable (orphans
    and torn publishes are NORMAL crash debris, not corruption); 4 =
    dangling refs (a committed snapshot references a blob the store no
    longer holds — restore-breaking); 3 = not a store."""
    from .knobs import get_cas_grace_s

    grace = get_cas_grace_s() if grace_s is None else grace_s
    root = store_local_root(store_url)
    report = StoreFsckReport(path=store_url, state="not-a-store")
    if root is None:
        report.detail = f"store URL {store_url!r} has no local filesystem root"
        return report
    if not os.path.isdir(root) or not _is_store_dir(root):
        report.detail = (
            "no store shape (blobs/, roots/, intents/) at this path"
        )
        return report
    blobs, torn, marks, dangling, intents, roots, _ = _scan_store(root, grace)
    report.state = "store"
    report.blobs = blobs
    report.torn_publishes = [p for p, _ in torn]
    report.dangling = dangling
    report.intents = len(intents)
    report.stale_intents = sum(1 for _, _, stale in intents if stale)
    report.roots = len(roots)
    report.stale_roots = [p for p, _, stale in roots if stale]
    report.referenced = {
        k: n for k, n in marks.items() if k in blobs and n > 0
    }
    report.orphans = {
        k: sz for k, sz in blobs.items() if k not in marks
    }
    cache = None
    try:
        with open(os.path.join(root, REFCOUNTS_PATH), "rb") as f:
            cache = json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError):
        cache = None
    if isinstance(cache, dict):
        report.refcount_divergence = sorted(
            k
            for k in set(cache) | set(report.referenced)
            if int(cache.get(k, 0)) != report.referenced.get(k, 0)
        )
    return report


@dataclass
class StoreGCReport:
    path: str
    dry_run: bool
    reclaimed: Dict[str, int] = field(default_factory=dict)
    kept_young: int = 0  # unmarked but inside the grace window
    marked: int = 0
    errors: List[str] = field(default_factory=list)

    @property
    def bytes_reclaimed(self) -> int:
        return sum(self.reclaimed.values())

    def summary(self) -> str:
        verb = "would reclaim" if self.dry_run else "reclaimed"
        s = (
            f"{self.path}: {verb} {len(self.reclaimed)} file(s), "
            f"{self.bytes_reclaimed} bytes ({self.marked} blob(s) "
            f"referenced, {self.kept_young} inside the grace window)"
        )
        if self.errors:
            s += f" ({len(self.errors)} error(s))"
        return s


def _read_lease(root: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(root, GC_LOCK_PATH), "rb") as f:
            d = json.loads(f.read().decode("utf-8"))
        return d if isinstance(d, dict) else None
    except (OSError, ValueError):
        return None


def _lease_abandoned(lease: Dict[str, Any]) -> bool:
    """True when the lease's owner (``gc_store``'s default
    ``<nodename>:<pid>``) names a process of this host that no longer
    runs: a gc killed before it released its lease."""
    node, _, pid = str(lease.get("owner", "")).rpartition(":")
    if node != os.uname().nodename or not pid.isdigit():
        return False
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return True
    except OSError:
        return False
    return False


def gc_store(
    store_url: str,
    dry_run: bool = True,
    grace_s: Optional[float] = None,
    lease_ttl_s: Optional[float] = None,
    owner: Optional[str] = None,
    storage_options: Optional[Dict[str, Any]] = None,
) -> StoreGCReport:
    """Mark-and-sweep over the store's ref records.

    Mark: every blob key referenced by any live root's ref records, or
    named by a publish intent younger than the grace window. Sweep
    (oldest-debris-only — everything must out-age ``grace_s``):
    unmarked blobs, ``.tmp.*`` torn publishes, stale intents, and root
    records whose snapshot directory no longer exists. The advisory
    ``refcounts.json`` cache is rewritten from the fresh marks.

    Concurrency: a per-store lock lease (``gc.lock``) refuses a second
    concurrent sweeper; a lease abandoned by a SIGKILLed gc is stolen
    once expired. A SIGKILL anywhere mid-sweep converges on re-run —
    every deletion is independently justified by the same mark state.

    tpusnap's ``python -m tpusnap gc --store <dir>`` runs the same sweep
    (dry run by default, ``--force`` to delete)."""
    from .knobs import get_cas_grace_s, get_cas_lease_ttl_s
    from .storage_plugin import url_to_storage_plugin_in_event_loop

    grace = get_cas_grace_s() if grace_s is None else grace_s
    ttl = get_cas_lease_ttl_s() if lease_ttl_s is None else lease_ttl_s
    root = store_local_root(store_url)
    if root is None:
        raise RuntimeError(
            f"gc --store needs a local-filesystem store root; "
            f"{store_url!r} has none (the grace window runs on file age)"
        )
    report = StoreGCReport(path=store_url, dry_run=dry_run)
    if not os.path.isdir(root) or not _is_store_dir(root):
        return report  # nothing store-shaped: trivially converged

    event_loop = asyncio.new_event_loop()
    try:
        storage = url_to_storage_plugin_in_event_loop(
            store_url, event_loop, _store_options(storage_options)
        )
        leased = False
        try:
            me = owner or f"{os.uname().nodename}:{os.getpid()}"
            if not dry_run:
                lease = _read_lease(root)
                now = _wall()
                if (
                    lease is not None
                    and lease.get("owner") != me
                    and isinstance(lease.get("expires_at"), (int, float))
                    and lease["expires_at"] > now
                ):
                    raise RuntimeError(
                        f"store gc already running (lease held by "
                        f"{lease.get('owner')!r} for another "
                        f"{lease['expires_at'] - now:.0f}s) — re-run "
                        "after it expires"
                    )
                # started_at: publishers whose refs landed before it wait
                # this sweep out (its scan may have missed them).
                storage.sync_write_atomic(
                    WriteIO(
                        path=GC_LOCK_PATH,
                        buf=json.dumps(
                            {"owner": me, "expires_at": now + ttl, "started_at": now}
                        ).encode("utf-8"),
                    ),
                    event_loop,
                )
                leased = True
            (
                blobs,
                torn,
                marks,
                _dangling,
                intents,
                roots,
                blob_age,
            ) = _scan_store(root, grace)
            report.marked = sum(1 for k in marks if k in blobs)
            targets: Dict[str, int] = {}
            for key, sz in blobs.items():
                if key in marks:
                    continue
                if blob_age.get(key, 0.0) <= grace:
                    report.kept_young += 1
                    continue
                targets[blob_path(key)] = sz
            for rel, age in torn:
                if age > grace:
                    targets[rel] = 0
            for rel, _age, stale in intents:
                if stale:
                    targets[rel] = 0
            for rel, age, stale in roots:
                if stale and age > grace:
                    targets[rel] = 0
            report.reclaimed = dict(targets)
            if dry_run:
                return report
            done: Dict[str, int] = {}
            for rel in sorted(targets):
                try:
                    storage.sync_delete(rel, event_loop)
                    done[rel] = targets[rel]
                except FileNotFoundError:
                    done[rel] = targets[rel]  # a racing sweeper got it
                except Exception as e:
                    report.errors.append(f"{rel}: {e}")
            report.reclaimed = done
            telemetry.incr("cas.gc_blobs_swept", len(done))
            # Rewrite the advisory refcount cache from the fresh marks
            # (publishers never touch it; divergence = staleness, named
            # by fsck, re-derived here).
            counts = {
                k: n for k, n in marks.items() if n > 0 and k in blobs
            }
            try:
                storage.sync_write_atomic(
                    WriteIO(
                        path=REFCOUNTS_PATH,
                        buf=json.dumps(counts).encode("utf-8"),
                    ),
                    event_loop,
                )
            except Exception as e:
                report.errors.append(f"{REFCOUNTS_PATH}: {e}")
            return report
        finally:
            # Released however the sweep ends: publishers wait on a held
            # lease.
            if leased:
                try:
                    storage.sync_delete(GC_LOCK_PATH, event_loop)
                except Exception:
                    logger.debug(
                        "store gc lease release failed (expires on its own)",
                        exc_info=True,
                    )
            storage.sync_close(event_loop)
    finally:
        event_loop.close()


# ----------------------------------------------------------- store drain


@dataclass
class StoreDrainReport:
    path: str
    state: str  # "durable" | "no-remote" | "partial"
    uploaded: int = 0
    skipped: int = 0
    errors: List[str] = field(default_factory=list)

    def summary(self) -> str:
        return (
            f"{self.path}: {self.state}; {self.uploaded} blob(s) "
            f"uploaded, {self.skipped} skipped via journal evidence"
            + (f" ({len(self.errors)} error(s))" if self.errors else "")
        )


def drain_store(
    store_url: str,
    remote_url: Optional[str] = None,
    keys: Optional[Set[str]] = None,
    storage_options: Optional[Dict[str, Any]] = None,
) -> StoreDrainReport:
    """Upload store blobs to the store's remote mirror ONCE store-wide:
    each blob's dual-hash evidence lands in the store-level upload
    journal after its remote write, so a crashed drain re-hashes and
    SKIPS everything already proven remote — the tiering drain calls
    this for the keys a tiered CAS snapshot references, instead of
    uploading per-snapshot private copies."""
    from .lifecycle import dual_hash_evidence
    from .storage_plugin import url_to_storage_plugin_in_event_loop

    root = store_local_root(store_url)
    report = StoreDrainReport(path=store_url, state="partial")
    if root is None or not os.path.isdir(root):
        report.state = "no-remote"
        report.errors.append(f"no local store at {store_url!r}")
        return report
    store = CASStore(store_url, storage_options)
    remote = remote_url or store.remote_url()
    if not remote:
        report.state = "no-remote"
        report.errors.append(
            "store has no remote mirror (set TPUSNAP_CAS_REMOTE or "
            "config.json {'remote': ...})"
        )
        return report
    journal = read_store_journal(root) or {"version": 1, "blobs": {}}
    journal["remote"] = remote
    bdir = os.path.join(root, BLOBS_DIR)
    try:
        names = sorted(os.listdir(bdir))
    except OSError:
        names = []
    todo = [n for n in names if ".tmp." not in n]
    if keys is not None:
        todo = [n for n in todo if n in keys]
    event_loop = asyncio.new_event_loop()
    try:
        rp = url_to_storage_plugin_in_event_loop(
            remote, event_loop, _store_options(storage_options)
        )
        try:
            for key in todo:
                try:
                    with open(os.path.join(bdir, key), "rb") as f:
                        buf = f.read()
                except OSError as e:
                    report.errors.append(f"{key}: {e}")
                    continue
                triple = dual_hash_evidence(buf)
                prior = journal["blobs"].get(key)
                if prior is not None and tuple(prior) == triple:
                    report.skipped += 1
                    continue
                try:
                    rp.sync_write_atomic(
                        WriteIO(path=blob_path(key), buf=buf), event_loop
                    )
                except Exception as e:
                    report.errors.append(f"{key}: {e}")
                    continue
                journal["blobs"][key] = list(triple)
                report.uploaded += 1
                telemetry.incr("cas.blobs_drained")
                # Journal after EVERY upload (merge-on-write like the
                # tiering journal): a SIGKILL mid-drain loses at most
                # one blob's evidence, never the batch's.
                _flush_store_journal(root, journal)
        finally:
            rp.sync_close(event_loop)
    finally:
        event_loop.close()
    _flush_store_journal(root, journal)
    report.state = "durable" if not report.errors else "partial"
    return report


def _flush_store_journal(root: str, journal: Dict[str, Any]) -> None:
    """Read-modify-write merge + atomic rewrite of the store journal:
    concurrent drains (two jobs' tier drains hitting one store) union
    their evidence instead of clobbering each other."""
    path = os.path.join(root, STORE_JOURNAL_PATH)
    current = read_store_journal(root)
    if current is not None:
        merged = dict(current.get("blobs") or {})
        merged.update(journal.get("blobs") or {})
        journal = dict(journal)
        journal["blobs"] = merged
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(journal, f)
        os.replace(tmp, path)
    except OSError:
        logger.warning(
            "store upload journal flush failed (re-upload on next drain)",
            exc_info=True,
        )


def store_remote_evidence(
    store_url: str, keys: Set[str]
) -> Tuple[Set[str], Optional[str]]:
    """Which of ``keys`` the store journal proves remote, plus the
    journal's remote URL — the gate the tiering drain and
    ``gc --evict-local`` run on before treating a shared blob as
    durable elsewhere."""
    root = store_local_root(store_url)
    if root is None:
        return set(), None
    journal = read_store_journal(root)
    if journal is None:
        return set(), None
    blobs = journal.get("blobs") or {}
    return {k for k in keys if k in blobs}, journal.get("remote")
