"""Snapshot — the user-facing save/restore/random-access API.

Counterpart of tpusnap/snapshot.py (``Snapshot.take``, ``restore``,
``read_object`` and ``load_snapshot``) for one process or many. The steps
and the names of the functions carried over are tpusnap's:

- ``take``: per-key ``state_dict()`` → ``flatten`` → ``prepare_write`` →
  ``batch_write_requests`` → ``execute_write_reqs`` (staging ∥ storage
  I/O under the memory budget) → the two-phase commit: the
  ``.snapshot_metadata`` file is written (atomically) only after every
  blob write has landed, so a crashed take never looks committed.
- ``restore``: per-key, the manifest view for this rank, read requests
  prepared against the current ``state_dict()`` (the restore targets),
  reads merged per slab, executed under the budget, inflated and handed
  to ``load_state_dict``. Tensors are restored IN PLACE, so the objects a
  module or optimizer holds stay the same objects.
- ``read_object``: one value by manifest path, optionally under a memory
  budget (tiled reads).

- ``async_take``: the same take, returning a ``PendingSnapshot`` once the
  blocked window closes (the first ``TPUSNAP_ASYNC_STAGE_WINDOW_BYTES`` of
  staging, or all of it in strict mode); a background thread drains the
  rest and commits. CUDA tensors are frozen at the return: the caller may
  update them in place at once (``io_preparers/array.py`` says how). CPU
  tensors follow tpusnap: COW until ``wait_staged()``, or clones.
- ``async_restore``: the restore on a background thread
  (``PendingRestore``).

- ``incremental_from``: a take against an earlier snapshot. Blobs whose
  staged bytes hash the same as the base's (CRC32C and XXH64, whole-blob,
  per slab member, or per checksum tile) are not written; the manifest
  references the base's blobs by relative location (``../<base>/...``)
  and records the base roots it points into. Such a take hashes at stage
  time and stages everything before it returns (an async one too).
- ``_custom_array_prepare_func`` (e.g. ``transforms.cast_on_save``):
  save-time transforms, run on each tensor's own device.
- ``TPUSNAP_COMPRESS``: the fused tile codec, per take by the
  ``compress`` policy.
- ``verify()`` / ``materialize()``: the integrity scrub and making an
  increment self-contained (``inspect``); ``retention.apply_retention``
  retires old snapshots.

Several processes (``torchrun``, or any ``init_process_group`` job; or an
explicit ``comm.StoreComm``) take one snapshot together, as in tpusnap:

- take: one gather before staging (G1) carries every rank's path,
  replicated globs, write-load estimate, host name and a take id; from it
  every rank applies rank 0's path, keeps the globs every rank gave,
  computes the same partition plan (``partitioner``: each replicated
  unit is written by one rank, the load spread across ranks) and the
  ranks on its host (the memory-budget divisor). Replicated requests
  assigned to other ranks are dropped before staging. After staging, the
  manifest gather (G2) consolidates replicated entries onto rank 0's
  tree. Checksums hashed on the write path reach every rank's manifest
  copy through the KV store (``_LateChecksums``) between the two commit
  barriers; rank 0 alone writes the metadata between them. No device
  collective runs during a take.
- a failing rank publishes an abort record; every peer's waits raise
  ``TakeAbortedError`` within seconds, and each rank deletes the blobs it
  may have written (best effort) unless the commit may have started.
- async_take: the commit runs on the drain thread over two
  ``LinearBarrier``s of the KV store (their prefix is broadcast on the
  calling thread); a failed rank poisons them, so no metadata is written
  and ``wait()`` raises on every rank.
- restore and read_object issue no collective once the memory-budget
  divisor is cached (a cold restore pays one host-name gather); a
  snapshot restores at another world size for replicated and per-rank
  state (``manifest_ops.get_manifest_for_rank``).

``DTensor`` state (``Shard``/``Replicate`` placements over a
``DeviceMesh``) takes the sharded preparer: each distinct box is written
once, by the rank that owns it, and a restore reads the saved boxes that
overlap each rank's target box, so it reshards into any placement and
any world size (``io_preparers/sharded.py``); ``read_object`` of a
sharded path returns the dense tensor. No DTensor collective runs.

Host-offloaded (pinned) CPU tensors stage as views of themselves, with
no device-to-host copy, and restore in place; a pinned target of another
shape gets a pinned tensor (``io_preparers/array.py``).

Left out of this port so far, each raising ``NotImplementedError`` when
asked for rather than being ignored (ROADMAP.md lists them): tiering,
CAS, cloud storage, the delta stream, the degraded commit
(``TPUSNAP_RANK_FAILURE=degrade``) and rank-liveness leases (A8, which
also ports the ``chaos+`` fault-injection layer with the retry
middleware it needs). tpusnap's journal, progress, flight, SLO,
telemetry and tuner hooks are observability the port adds later (A9); a
snapshot without them reads the same in either package.
"""

from __future__ import annotations

import asyncio
import copy
import fnmatch
import functools
import logging
import os
import posixpath
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import urlsplit

import torch

from . import _native, compress
from .batcher import batch_read_requests, batch_write_requests
from .comm import Communicator, get_communicator
from .dist_store import (
    KVStore,
    LinearBarrier,
    MemoryKVStore,
    TakeAbortedError,
    TakeAbortMonitor,
    TCPStoreKVStore,
)
from .flatten import flatten, inflate
from .inspect import _entry_tensors, base_root_of_location, entry_nbytes
from .io_preparer import prepare_read, prepare_write
from .io_preparers.array import ArrayBufferStager, event_on, freeze_device_sources
from .io_types import ReadIO, StoragePlugin, WriteIO, run_on_loop
from .knobs import (
    get_async_stage_window_bytes,
    get_commit_barrier_timeout_s,
    get_node_name,
    get_rank_failure_policy,
    is_checksum_disabled,
    is_dedup_hash_recording_forced,
    is_durable_commit_enabled,
)
from .manifest import (
    ChunkedTensorEntry,
    Entry,
    Manifest,
    MetadataError,
    ShardedEntry,
    SnapshotMetadata,
    TensorEntry,
    decode_metadata,
    encode_metadata,
    is_container_entry,
    is_replicated,
)
from .manifest_ops import get_manifest_for_rank, handle_sharded_elasticity
from .partitioner import (
    assign_replicated_units,
    consolidate_replicated_entries,
    estimate_write_loads,
    filter_assigned_write_reqs,
)
from .rng_state import RNGState
from .scheduler import (
    PendingIOWork,
    get_process_memory_budget_bytes,
    sync_execute_read_reqs,
    sync_execute_write_reqs,
)
from .stateful import AppState, Stateful
from .storage_plugin import url_to_storage_plugin_in_event_loop
from .version import __version__

logger = logging.getLogger(__name__)

SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"


def _not_ported(feature: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to tpusnap_torch yet (ROADMAP.md item {item})"
    )


class Snapshot:
    """Handle on a snapshot. The event loop and storage plugin are
    created on first use and reused by restore/read_object/metadata;
    ``close()`` (or the context manager) releases them."""

    def __init__(
        self,
        path: str,
        storage_options: Optional[Dict[str, Any]] = None,
        comm: Optional[Communicator] = None,
    ) -> None:
        self.path = path
        self._storage_options = storage_options
        self._comm = comm
        self._metadata: Optional[SnapshotMetadata] = None
        self._cached_loop: Optional[asyncio.AbstractEventLoop] = None
        self._cached_storage: Optional[StoragePlugin] = None
        # restore/read_object/metadata share the cached loop, so they
        # serialize on this lock.
        self._op_lock = threading.RLock()

    def _resources(self):
        """(event_loop, storage), cached across calls. Callers hold
        ``_op_lock`` while they use them."""
        if self._cached_loop is None or self._cached_loop.is_closed():
            self._cached_loop = asyncio.new_event_loop()
            self._cached_storage = None
        if self._cached_storage is None:
            self._cached_storage = url_to_storage_plugin_in_event_loop(
                self.path, self._cached_loop, self._storage_options
            )
        return self._cached_loop, self._cached_storage

    def close(self) -> None:
        """Release the cached storage plugin and event loop."""
        with self._op_lock:
            if self._cached_storage is not None and self._cached_loop is not None:
                self._cached_storage.sync_close(self._cached_loop)
            self._cached_storage = None
            if self._cached_loop is not None:
                self._cached_loop.close()
            self._cached_loop = None

    def __enter__(self) -> "Snapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ take

    @classmethod
    def take(
        cls,
        path: str,
        app_state: AppState,
        replicated: Optional[List[str]] = None,
        storage_options: Optional[Dict[str, Any]] = None,
        comm: Optional[Communicator] = None,
        per_key_barrier: bool = False,
        incremental_from: Optional[str] = None,
        _custom_array_prepare_func: Optional[Any] = None,
        _record_dedup_hashes: bool = False,
    ) -> "Snapshot":
        """Write every stateful in ``app_state`` to ``path``. CUDA tensors
        are copied through pinned host memory; the state captured is the
        state as of this call (device work already queued on the
        caller's stream included). ``replicated`` globs mark values that
        every rank holds identically (DDP): each is written once, by the
        rank the partition plan picks, and stored under ``replicated/``.
        Several processes call ``take`` together with the same path (rank
        0's wins) and ``replicated`` (only globs every rank gives count).

        ``per_key_barrier`` orders the ``state_dict()`` calls of several
        processes (one gather of the keys, one barrier per key), for
        statefuls that run collectives inside ``state_dict()``; the port
        issues none itself, so by default there are none.

        ``incremental_from`` makes this an incremental snapshot against
        the snapshot at that path (a sibling directory, typically): blobs
        whose bytes are unchanged are not written and are referenced in
        the base, which must then outlive this snapshot (or be
        materialized into it). A base whose entries carry per-tile dedup
        hashes (every incremental take records them, as does
        ``_record_dedup_hashes=True`` or ``TPUSNAP_RECORD_DEDUP_HASHES=1``
        on a full take) dedups at tile grain: one changed row of a large
        tensor rewrites one checksum tile. Replicated values of a
        multi-process take stay blob-grain.

        ``_custom_array_prepare_func(logical_path, tensor, tracing)``
        transforms tensors at save time (``transforms.cast_on_save``); it
        must keep the shape and be deterministic."""
        comm = get_communicator(comm)
        event_loop = asyncio.new_event_loop()
        abort_ctx = _TakeAbortContext(comm, event_loop)
        try:
            try:
                pending, metadata, path, storage, late_checksums, _ = _take_impl(
                    path, app_state, storage_options, comm, replicated or [], event_loop,
                    abort_ctx,
                    is_async_snapshot=False,
                    per_key_barrier=per_key_barrier,
                    array_prepare_func=_custom_array_prepare_func,
                    incremental_from=incremental_from,
                    force_dedup_hashes=_record_dedup_hashes,
                )
                meta_cached = _commit(
                    pending, metadata, storage, comm, late_checksums, abort_ctx, event_loop
                )
            except BaseException as e:
                abort_ctx.on_failure(e)
                raise
            finally:
                abort_ctx.close_storage()
        finally:
            abort_ctx.disarm()
            event_loop.close()
        snapshot = cls(path, storage_options, comm)
        if meta_cached:
            snapshot._metadata = metadata
        return snapshot

    @classmethod
    def async_take(
        cls,
        path: str,
        app_state: AppState,
        replicated: Optional[List[str]] = None,
        storage_options: Optional[Dict[str, Any]] = None,
        comm: Optional[Communicator] = None,
        per_key_barrier: bool = False,
        incremental_from: Optional[str] = None,
        _custom_array_prepare_func: Optional[Any] = None,
        _record_dedup_hashes: bool = False,
    ) -> "PendingSnapshot":
        """``take`` that returns once the blocked window closes. The
        snapshot holds the state as of this call even if the caller then
        updates every CUDA tensor in place on its current stream. For CPU
        tensors the contract is tpusnap's: under COW (the default) mutate
        them only after ``wait_staged()``; with ``TPUSNAP_ASYNC_COW=0``
        they are cloned before the return. ``wait()`` gives the committed
        snapshot or re-raises the failure; a failed take (on any rank)
        leaves no ``.snapshot_metadata``. An incremental take stages (and
        hashes) everything before it returns: its dedup decisions must be
        final before the manifest is. The commit of several processes
        runs over the KV store on the drain thread: no collective runs
        off the calling thread."""
        comm = get_communicator(comm)
        event_loop = asyncio.new_event_loop()
        abort_ctx = _TakeAbortContext(comm, event_loop)
        try:
            pending, metadata, path, storage, late_checksums, live_until_drained = _take_impl(
                path, app_state, storage_options, comm, replicated or [], event_loop,
                abort_ctx,
                is_async_snapshot=True,
                per_key_barrier=per_key_barrier,
                array_prepare_func=_custom_array_prepare_func,
                incremental_from=incremental_from,
                force_dedup_hashes=_record_dedup_hashes,
            )
            # From here the event loop and storage belong to the drain
            # thread, which closes them.
            return PendingSnapshot(
                path, pending, metadata, storage, comm, event_loop, storage_options,
                live_until_drained, late_checksums=late_checksums, abort_ctx=abort_ctx,
            )
        except BaseException as e:
            abort_ctx.on_failure(e)
            abort_ctx.close_storage()
            abort_ctx.disarm()
            event_loop.close()
            raise

    @classmethod
    def stream(cls, *args, **kwargs):
        raise _not_ported("the delta stream", "A8")

    # --------------------------------------------------------------- restore

    def restore(self, app_state: AppState, per_key_barrier: bool = False) -> None:
        """Restore every stateful in ``app_state`` from this snapshot, in
        place where the current ``state_dict()`` holds tensors of the
        stored shape. Returns after every device copy has completed.

        Each rank restores its own view of the manifest on its own and
        issues no collective, except that a process that has not taken a
        snapshot yet gathers host names once to size its memory budget,
        so all ranks enter a cold restore together. A snapshot restores at
        another world size: replicated values on every rank, per-rank
        values on the ranks that saved them. ``per_key_barrier`` adds a
        gather of the keys and a barrier per key, for statefuls that run
        collectives inside ``load_state_dict``."""
        comm = get_communicator(self._comm)
        _validate_app_state(app_state)
        with self._op_lock:
            self._restore_locked(app_state, comm, per_key_barrier)

    def _restore_locked(
        self,
        app_state: AppState,
        comm: Communicator,
        per_key_barrier: bool,
        memory_budget: Optional[int] = None,
    ) -> None:
        event_loop, storage = self._resources()
        metadata = self._get_metadata(storage, event_loop)
        if memory_budget is None:
            memory_budget = get_process_memory_budget_bytes(comm)
        multi = per_key_barrier and comm.world_size > 1
        keys = _gather_keys(comm, sorted(app_state)) if multi else sorted(app_state)
        # RNG state loads last, so that loading other statefuls cannot
        # disturb it.
        keys.sort(key=lambda k: isinstance(app_state.get(k), RNGState))
        for key in keys:
            if multi:
                comm.barrier()
            stateful = app_state.get(key)
            if stateful is None:
                continue
            _load_stateful(
                stateful=stateful,
                key=key,
                metadata=metadata,
                rank=comm.rank,
                storage=storage,
                memory_budget=memory_budget,
                event_loop=event_loop,
            )

    def async_restore(self, app_state: AppState) -> "PendingRestore":
        """``restore`` on a background thread; ``app_state`` must not be
        touched until ``wait()`` returns. A stateful whose
        ``load_state_dict`` runs collectives declares
        ``load_requires_collectives = True`` and is refused: collectives
        must not run off the calling thread. The one collective a cold
        restore may need (the host-name gather) runs here, before the
        thread starts."""
        comm = get_communicator(self._comm)
        _validate_app_state(app_state)
        offenders = sorted(
            key
            for key, stateful in app_state.items()
            if getattr(stateful, "load_requires_collectives", False)
        )
        if offenders:
            raise ValueError(
                f"async_restore cannot restore {offenders}: their "
                "load_state_dict declares load_requires_collectives=True, and "
                "collectives must not run on the background restore thread. "
                "Use restore() for these statefuls."
            )
        return PendingRestore(self, app_state, comm, get_process_memory_budget_bytes(comm))

    # ----------------------------------------------------------- random access

    def read_object(
        self,
        path: str,
        obj_out: Any = None,
        memory_budget_bytes: Optional[int] = None,
    ) -> Any:
        """Read a single object by manifest path ``"<rank>/<logical_path>"``
        without restoring anything else. Tensors come back as CPU tensors
        unless ``obj_out`` says otherwise: a target of the stored shape is
        filled in place, a CUDA target of another shape gets a new tensor
        on its device."""
        comm = get_communicator(self._comm)
        rank_str, _, logical_path = path.partition("/")
        if not rank_str.isdigit() or not logical_path:
            raise ValueError(
                f"Invalid manifest path {path!r} (expected '<rank>/<path>')"
            )
        with self._op_lock:
            event_loop, storage = self._resources()
            metadata = self._get_metadata(storage, event_loop)
            local_manifest = get_manifest_for_rank(metadata, int(rank_str))
            if logical_path not in local_manifest:
                raise KeyError(f"{path!r} not found in snapshot manifest")
            entry = local_manifest[logical_path]
            if is_container_entry(entry):
                raise ValueError(
                    f"{path!r} is a container; read its leaves individually"
                )
            read_reqs, fut = prepare_read(
                entry,
                obj_out,
                buffer_size_limit_bytes=memory_budget_bytes,
                logical_path=logical_path,
            )
            budget = memory_budget_bytes or get_process_memory_budget_bytes(comm)
            sync_execute_read_reqs(read_reqs, storage, budget, event_loop)
            return fut.obj

    # ------------------------------------------------------------- integrity

    def verify(self):
        """Stream-verify every blob of this snapshot against the checksums
        its manifest records (see :mod:`tpusnap_torch.inspect`). Returns a
        ``ScrubReport``; ``report.clean`` is False on any corruption,
        truncation or missing blob."""
        from .inspect import verify_snapshot

        with self._op_lock:
            event_loop, storage = self._resources()
            return verify_snapshot(
                self.path,
                self._storage_options,
                metadata=self._metadata,
                resources=(event_loop, storage),
            )

    def materialize(self) -> Dict[str, int]:
        """Make an incremental snapshot self-contained: copy in every blob
        it references in its bases, verify the copies and rewrite the
        manifest; the bases may then be deleted. No-op on a full
        snapshot. Returns ``{"blobs_copied": N, "bytes_copied": N}``."""
        from .inspect import materialize_snapshot

        with self._op_lock:
            event_loop, storage = self._resources()
            stats = materialize_snapshot(
                self.path, self._storage_options, resources=(event_loop, storage)
            )
            self._metadata = None  # the manifest was rewritten on disk
        return stats

    # -------------------------------------------------------------- metadata

    @property
    def metadata(self) -> SnapshotMetadata:
        if self._metadata is None:
            with self._op_lock:
                event_loop, storage = self._resources()
                self._metadata = self._get_metadata(storage, event_loop)
        return self._metadata

    def get_manifest(self) -> Manifest:
        return dict(self.metadata.manifest)

    def _get_metadata(
        self, storage: StoragePlugin, event_loop: asyncio.AbstractEventLoop
    ) -> SnapshotMetadata:
        if self._metadata is not None:
            return self._metadata
        read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
        try:
            storage.sync_read(read_io, event_loop)
        except OSError as e:
            raise RuntimeError(
                f"Failed to read snapshot metadata at "
                f"{self.path}/{SNAPSHOT_METADATA_FNAME} — not a snapshot, or "
                f"an aborted/incomplete one"
            ) from e
        try:
            self._metadata = decode_metadata(read_io.buf.getvalue())
        except MetadataError as e:
            raise RuntimeError(
                f"Corrupt snapshot metadata at "
                f"{self.path}/{SNAPSHOT_METADATA_FNAME}: {e}"
            ) from e
        return self._metadata


# ---------------------------------------------------------------- internals


def _validate_app_state(app_state: AppState) -> None:
    for key, stateful in app_state.items():
        if not (hasattr(stateful, "state_dict") and hasattr(stateful, "load_state_dict")):
            raise TypeError(
                f"app_state[{key!r}] ({type(stateful).__name__}) is not "
                "Stateful: it must define state_dict()/load_state_dict()"
            )


class _TakeAbortContext:
    """Failure-path bookkeeping for one take.

    Armed (several processes) once G1 agrees on the take id: installs the
    :class:`TakeAbortMonitor` as the communicator's wait watcher, so every
    later collective wait and commit barrier raises
    :class:`TakeAbortedError` within seconds of any rank's failure instead
    of running out the barrier timeout. On failure it publishes this
    rank's abort record, deletes the blobs this rank may have written (so
    the path stays reusable), and drops this rank's late-checksum record.
    Blob deletion is skipped once the metadata commit may have started:
    orphan blobs are safe, dangling manifest references are not. The
    journal, the liveness lease and the degraded commit of tpusnap's
    context are not ported yet (ROADMAP.md A8)."""

    def __init__(self, comm: Communicator, event_loop: asyncio.AbstractEventLoop) -> None:
        self.comm = comm
        self.event_loop = event_loop
        self.monitor: Optional[TakeAbortMonitor] = None
        self.storage: Optional[StoragePlugin] = None
        self.pending: Optional[PendingIOWork] = None
        self.write_paths: List[str] = []
        self.late_checksums: Optional["_LateChecksums"] = None
        self.commit_started = False
        self._failed = False

    def arm(self, monitor: TakeAbortMonitor) -> None:
        self.monitor = monitor
        self.comm.set_wait_watcher(monitor.check)

    def barrier_watchers(self) -> List:
        """Watchers for the async commit's ``LinearBarrier`` waits."""
        return [self.monitor.check] if self.monitor is not None else []

    def disarm(self) -> None:
        if self.monitor is not None:
            self.comm.clear_wait_watcher()

    def close_storage(self) -> None:
        if self.storage is not None:
            self.storage.sync_close(self.event_loop)
            self.storage = None

    def mark_commit_started(self) -> None:
        self.commit_started = True
        if self.monitor is not None:
            self.monitor.mark_commit_started()

    def on_failure(self, exc: BaseException) -> None:
        """Publish and clean up, once; never raises."""
        if self._failed:
            return
        self._failed = True
        if self.monitor is not None and not isinstance(exc, TakeAbortedError):
            self.monitor.publish(exc)
        keep_blobs = self.commit_started or (
            self.monitor is not None and self.monitor.commit_may_have_started()
        )
        if self.pending is not None and not self.pending.drained():
            try:
                self.pending.sync_cancel(self.event_loop)
            except Exception:
                logger.debug("cancelling the take's writes failed", exc_info=True)
        if not keep_blobs and self.storage is not None:
            for path in self.write_paths:
                try:
                    run_on_loop(self.event_loop, self.storage.delete(path))
                except FileNotFoundError:
                    pass  # never written (dedup skip, or not reached)
                except Exception:
                    logger.debug("abort cleanup of %r failed", path, exc_info=True)
        if self.late_checksums is not None:
            try:
                self.late_checksums.discard()
            except Exception:
                logger.debug("late-checksum discard failed", exc_info=True)


def _gather_keys(comm: Communicator, local_keys: List[str]) -> List[str]:
    if comm.world_size == 1:
        return sorted(local_keys)
    merged = set()
    for keys in comm.all_gather_object(local_keys):
        merged.update(keys)
    return sorted(merged)


def _take_impl(
    path: str,
    app_state: AppState,
    storage_options: Optional[Dict[str, Any]],
    comm: Communicator,
    replicated: List[str],
    event_loop: asyncio.AbstractEventLoop,
    abort_ctx: _TakeAbortContext,
    is_async_snapshot: bool,
    per_key_barrier: bool = False,
    array_prepare_func: Optional[Any] = None,
    incremental_from: Optional[str] = None,
    force_dedup_hashes: bool = False,
) -> Tuple[PendingIOWork, SnapshotMetadata, str, StoragePlugin, Optional["_LateChecksums"], bool]:
    """Flatten, plan, prepare and batch every write, and run the write
    engine to the blocked-window boundary. Returns the work left, the
    metadata to commit once it is done, the path (rank 0's), the open
    storage plugin, the late-checksum transport (several processes) and
    whether live CPU bytes are read until the writes drain (COW).

    Exactly two gathers with several processes, as in tpusnap: G1 before
    staging (path, globs, write-load estimate, host name, take id) and G2
    after it (the manifests); ``per_key_barrier`` adds a key gather and a
    barrier per key."""
    if get_rank_failure_policy() == "degrade":
        raise _not_ported("the degraded commit (TPUSNAP_RANK_FAILURE=degrade)", "A8")
    _validate_app_state(app_state)
    rank = comm.rank
    multi = comm.world_size > 1
    # Other statefuls' state_dict() may draw from the RNGs, and a take
    # must leave them as it found them.
    rng_captured = {
        k: v.state_dict() for k, v in app_state.items() if isinstance(v, RNGState)
    }
    ordered = per_key_barrier and multi
    keys = _gather_keys(comm, sorted(app_state)) if ordered else sorted(app_state)
    manifest: Manifest = {}
    flattened_all: Dict[str, Any] = {}
    for key in keys:
        if ordered:
            comm.barrier()
        stateful = app_state.get(key)
        if stateful is None:
            continue
        state_dict = rng_captured.get(key) or stateful.state_dict()
        mft, flat = flatten(state_dict, prefix=key)
        manifest.update(mft)
        flattened_all.update(flat)
    for key, captured in rng_captured.items():
        app_state[key].load_state_dict(captured)

    globs = sorted(set(replicated))
    matched = {p for p in flattened_all if any(fnmatch.fnmatch(p, g) for g in globs)}
    assignment: Dict[str, int] = {}
    local_world_size: Optional[int] = None
    traced_geometry: Dict[str, Tuple[str, List[int]]] = {}
    take_id = uuid.uuid4().hex
    if multi:
        units, base_load, traced_geometry = estimate_write_loads(
            flattened_all, sorted(matched), array_prepare_func=array_prepare_func
        )
        gathered = comm.all_gather_object(
            {
                "path": path,
                "globs": globs,
                "units": units,
                "base_load": base_load,
                "hostname": get_node_name(),
                # Scopes the take's KV keys; rank 0's wins, like the path.
                "take_id": take_id,
            }
        )
        take_id = gathered[0]["take_id"]
        if gathered[0]["path"] != path:
            logger.warning(
                "Rank %d's snapshot path %r differs from rank 0's %r; using rank 0's",
                rank, path, gathered[0]["path"],
            )
        path = gathered[0]["path"]
        # Only globs every rank gave count.
        common_globs = set(gathered[0]["globs"])
        for g in gathered[1:]:
            common_globs &= set(g["globs"])
        if set(globs) - common_globs:
            logger.warning(
                "Replicated globs %s were not given on every rank; ignoring them",
                sorted(set(globs) - common_globs),
            )

        def unit_valid(uid: str) -> bool:
            p = uid.split("::", 1)[0]
            return any(fnmatch.fnmatch(p, g) for g in common_globs)

        assignment, replicated_paths = assign_replicated_units(
            [g["units"] for g in gathered], [g["base_load"] for g in gathered], unit_valid
        )
        my_host = gathered[rank]["hostname"]
        local_world_size = sum(1 for g in gathered if g["hostname"] == my_host)
        # From here every collective wait of this take raises within
        # seconds when a peer publishes an abort record.
        abort_ctx.arm(TakeAbortMonitor(_get_kv_store(comm), take_id, rank, comm.world_size))
    else:
        replicated_paths = matched

    # Incremental: this rank's view of the base manifest, its blob
    # locations rewritten relative to the new root.
    prev_entries: Manifest = {}
    base_root_candidates: List[str] = []
    if incremental_from is not None:
        if is_checksum_disabled():
            # Dedup compares stage-time checksums; without them every blob
            # would silently rewrite in full.
            raise ValueError(
                "incremental_from requires checksums; unset "
                "TPUSNAP_DISABLE_CHECKSUM to take an incremental snapshot"
            )
        prev_entries, base_root_candidates = _load_prev_entries(
            incremental_from, storage_options, rank, path, event_loop
        )
    record_dedup_hashes = (
        incremental_from is not None or force_dedup_hashes or is_dedup_hash_recording_forced()
    )

    # The storage plugin is the abort context's until the caller takes it
    # over: on failure the context deletes this rank's blobs through it.
    storage = url_to_storage_plugin_in_event_loop(path, event_loop, storage_options)
    abort_ctx.storage = storage
    late_checksums: Optional[_LateChecksums] = None
    entries: Manifest = dict(manifest)
    write_reqs = []
    replicated_entry_paths: List[str] = []
    for logical_path, leaf in flattened_all.items():
        is_repl = logical_path in replicated_paths
        entry, reqs = prepare_write(
            obj=leaf,
            logical_path=logical_path,
            rank=rank,
            replicated=is_repl,
            is_async_snapshot=is_async_snapshot,
            array_prepare_func=(
                functools.partial(array_prepare_func, logical_path)
                if array_prepare_func is not None
                else None
            ),
            array_prepare_traced=traced_geometry.get(logical_path),
            prev_entry=prev_entries.get(logical_path),
            record_dedup_hashes=record_dedup_hashes,
            # Replicated entries of several processes stay blob-grain:
            # the partition plan's unit ids, computed without the
            # base, must match what is prepared.
            allow_tile_dedup=not (multi and is_repl),
        )
        entries[logical_path] = entry
        if is_repl and is_replicated(entry):
            replicated_entry_paths.append(logical_path)
        write_reqs.extend(reqs)

    # Keep only the replicated requests the plan gives this rank,
    # before anything is staged or batched: the device slab pack then
    # holds this rank's members only.
    if multi and replicated_entry_paths:
        write_reqs = filter_assigned_write_reqs(
            entries, write_reqs, replicated_entry_paths, assignment, rank
        )

    entries_list, write_reqs = batch_write_requests(
        list(entries.values()), write_reqs
    )
    entries = dict(zip(entries.keys(), entries_list))
    # One measured compress-or-bypass decision per take, armed on the
    # eligible standalone blobs after batching. Never fails a take.
    compress.apply_take_policy(write_reqs, storage, event_loop)
    abort_ctx.write_paths = [wr.path for wr in write_reqs]
    if incremental_from is None:
        # Standalone tensor blobs hash on the write path, overlapping
        # other requests' disk time; slab members hash inside their
        # slab's staging. One process: the entry objects are the
        # manifest's, so the late values land before the metadata is
        # encoded. Several: the manifests are gathered by value at
        # staging-complete, so the late values travel through the KV
        # store (_LateChecksums). Incremental takes hash at stage
        # time: dedup decides before the write.
        deferred = []
        for wr in write_reqs:
            if isinstance(wr.buffer_stager, ArrayBufferStager):
                wr.buffer_stager.defer_checksums = True
                deferred.append(wr.buffer_stager)
        if multi:
            late_checksums = _LateChecksums(comm, take_id, deferred)
            abort_ctx.late_checksums = late_checksums
    live_until_drained = any(
        isinstance(wr.buffer_stager, ArrayBufferStager) and wr.buffer_stager.uses_cow()
        for wr in write_reqs
    )

    # An async take pipelines its staging unless the window knob is 0
    # (strict mode: everything stages before the return). Incremental
    # takes never pipeline: their dedup decisions rewrite entry
    # locations at stage time and must be final before the manifest.
    pipelined = (
        is_async_snapshot
        and incremental_from is None
        and get_async_stage_window_bytes() is not None
    )
    stage_eagerly = None
    if pipelined and multi:
        # The manifests are gathered by value as soon as the blocked
        # window closes: stagers that annotate their entries at stage
        # time (slabs, objects) must stage inside it; deferring
        # tensor stagers send theirs through _LateChecksums.
        stage_eagerly = lambda wr: not getattr(  # noqa: E731
            wr.buffer_stager, "defer_checksums", False
        )
    pending = sync_execute_write_reqs(
        write_reqs,
        storage,
        get_process_memory_budget_bytes(comm, local_world_size=local_world_size),
        event_loop,
        prioritize_staging=is_async_snapshot and not pipelined,
        pipelined_staging=pipelined,
        stage_eagerly=stage_eagerly,
    )
    abort_ctx.pending = pending
    if pipelined and not pending.staging_complete():
        # The freeze: CUDA state outside the first window is copied
        # on the card before the return, or, without room for the
        # copies, staged now.
        if not freeze_device_sources(pending.scheduler.unstaged_stagers()):
            run_on_loop(event_loop, pending.scheduler.stage_all())
    global_manifest = _gather_manifest(entries, comm)
    metadata = SnapshotMetadata(
        version=__version__,
        world_size=comm.world_size,
        manifest=global_manifest,
        created_at=time.time(),
        # The base roots the manifest's external references point into,
        # so readers never parse roots out of location strings.
        base_roots=_referenced_base_roots(global_manifest, base_root_candidates) or None,
    )
    return pending, metadata, path, storage, late_checksums, live_until_drained


def _commit(
    pending: PendingIOWork,
    metadata: SnapshotMetadata,
    storage: StoragePlugin,
    comm: Communicator,
    late_checksums: Optional["_LateChecksums"],
    abort_ctx: _TakeAbortContext,
    event_loop: asyncio.AbstractEventLoop,
) -> bool:
    """A sync take's drain and two-phase commit: writes drained and late
    checksums published on every rank, barrier, every rank patches its
    manifest copy, rank 0 writes the metadata, barrier, rank 0 deletes
    the take's KV keys. Returns whether this rank's manifest copy is the
    committed one (a non-leader whose patch failed reads the file)."""
    pending.sync_complete(event_loop)
    if is_durable_commit_enabled():
        # Every rank makes its own dirents durable before the commit
        # barrier: rank 0's metadata fsync covers only the directories
        # its own plugin instance created.
        storage.sync_flush_created_dirs(event_loop)
    if late_checksums is not None:
        late_checksums.publish()
    comm.barrier()
    meta_cached = True
    if late_checksums is not None:
        try:
            late_checksums.apply(metadata.manifest)
        except Exception:
            if comm.rank == 0:
                raise
            logger.warning(
                "Non-leader late-checksum patch failed; the snapshot handle "
                "reads the committed metadata instead",
                exc_info=True,
            )
            meta_cached = False
    if comm.rank == 0:
        abort_ctx.mark_commit_started()
        _write_metadata(storage, metadata, event_loop)
    # The second barrier is also the cleanup gate: every rank passing it
    # has read the take's KV records.
    comm.barrier()
    if comm.rank == 0:
        if late_checksums is not None:
            late_checksums.cleanup()
        if abort_ctx.monitor is not None:
            abort_ctx.monitor.clear()
    return meta_cached


def _gather_manifest(entries: Manifest, comm: Communicator) -> Manifest:
    """Gather every rank's entries, key them by ``rank/logical_path`` and
    consolidate replicated entries onto rank 0's tree, preferring the
    writer's version. One process keeps its own entry objects."""
    per_rank = [entries] if comm.world_size == 1 else comm.all_gather_object(entries)
    return consolidate_replicated_entries(per_rank)


class _LateChecksums:
    """Carries the checksums hashed on the write path into every rank's
    copy of the manifest before the metadata commit. The manifests of
    several processes are gathered by value at staging-complete, before
    the write path has hashed anything; without this, a multi-rank
    snapshot would commit ``checksum=None`` and ``verify`` would skip it.

    Pure KV traffic riding the commit's own synchronization (no extra
    collective; usable from the async commit's thread):

    - once a rank's writes have drained, ``publish`` sets one record of
      ``{location: fields}`` under a take-scoped key (possibly empty:
      every rank publishes);
    - after the commit barrier's arrive phase (every rank arrived, so
      every rank published), every rank ``apply``s: one ``check`` and one
      ``multi_get`` of the ``world_size`` keys, patching that rank's copy
      by blob location;
    - ``cleanup`` (rank 0, after the second barrier: every rank has read
      the records) deletes them."""

    def __init__(self, comm: Communicator, take_id: str, stagers) -> None:
        self.comm = comm
        self.take_id = take_id
        self.stagers = stagers

    def _prefix(self) -> str:
        return f"tpusnap_late_cs/{self.take_id}/"

    def _key(self, rank: int) -> str:
        return f"{self._prefix()}{rank}"

    def _keys(self) -> List[str]:
        return [self._key(r) for r in range(self.comm.world_size)]

    def publish(self) -> None:
        import pickle

        fields = {}
        for st in self.stagers:
            e = st.entry
            if e is None or e.checksum is None:
                continue
            fields[e.location] = (
                e.checksum,
                e.tile_rows,
                e.tile_checksums,
                e.dedup_hash,
                e.tile_dedup_hashes,
                # A compressed stager annotates its layout at stage time
                # but pipelines like any deferring stager.
                e.codec,
                e.uncompressed_nbytes,
                e.comp_tile_sizes,
            )
        _get_kv_store(self.comm).set(self._key(self.comm.rank), pickle.dumps(fields))

    def discard(self) -> None:
        """Abort path: remove this rank's record (the commit that would
        have deleted it will not run)."""
        _get_kv_store(self.comm).delete_prefix(
            self._key(self.comm.rank), keys=[self._key(self.comm.rank)]
        )

    def apply(self, manifest: Manifest) -> None:
        """Patch this rank's manifest copy from the published records.
        The caller holds proof that every rank published."""
        import pickle

        by_loc: Dict[str, TensorEntry] = {}
        for entry in manifest.values():
            if isinstance(entry, TensorEntry):
                by_loc[entry.location] = entry
            elif isinstance(entry, (ChunkedTensorEntry, ShardedEntry)):
                parts = entry.chunks if isinstance(entry, ChunkedTensorEntry) else entry.shards
                for part in parts:
                    by_loc[part.tensor.location] = part.tensor
        store = _get_kv_store(self.comm)
        blobs = store.try_get_dir(self._prefix(), keys=self._keys())
        if blobs is None or len(blobs) < self.comm.world_size:
            blobs = {k: store.get(k, timeout_sec=120.0) for k in self._keys()}
        for raw in blobs.values():
            for loc, fields in pickle.loads(raw).items():
                cs, tr, tcs, dh, tdh, codec, unb, cts = fields
                te = by_loc.get(loc)
                if te is None:
                    continue
                if te.checksum is None:
                    te.checksum = cs
                    te.tile_rows = tr
                    te.tile_checksums = tcs
                if te.dedup_hash is None:
                    te.dedup_hash = dh
                if te.tile_dedup_hashes is None:
                    te.tile_dedup_hashes = tdh
                if te.codec is None and codec is not None:
                    te.codec = codec
                    te.uncompressed_nbytes = unb
                    te.comp_tile_sizes = cts

    def cleanup(self) -> None:
        _get_kv_store(self.comm).delete_prefix(self._prefix(), keys=self._keys())


def _get_kv_store(comm: Communicator) -> KVStore:
    """A ``MemoryKVStore`` for one process; above that, the KV store over
    the communicator's store (or, for a communicator that wraps another,
    the default process group's)."""
    if comm.world_size == 1:
        return MemoryKVStore()
    store = getattr(comm, "store", None)
    if store is None:
        from .comm import _default_group_store

        store = _default_group_store()
    return TCPStoreKVStore(store)


def _write_metadata(
    storage: StoragePlugin,
    metadata: SnapshotMetadata,
    event_loop: asyncio.AbstractEventLoop,
) -> None:
    # Atomic (temp + rename): a crash mid-write must not leave a torn
    # metadata file. Self-checksummed, as tpusnap writes it. Durable
    # (fsynced with its directories) under TPUSNAP_DURABLE_COMMIT.
    storage.sync_write_atomic(
        WriteIO(path=SNAPSHOT_METADATA_FNAME, buf=encode_metadata(metadata)),
        event_loop,
        durable=is_durable_commit_enabled(),
    )


def _referenced_base_roots(manifest: Manifest, candidates: List[str]) -> List[str]:
    """The candidate base roots the manifest's external (``../``) blob
    locations point into, matched by the longest-prefix rule readers use
    (``inspect.base_root_of_location``)."""
    if not candidates:
        return []
    roots = set()
    for entry in manifest.values():
        for t in _entry_tensors(entry):
            if t.location.startswith("../"):
                matched = base_root_of_location(t.location, known_roots=candidates)
                if matched in candidates:
                    roots.add(matched)
    return sorted(roots)


def _relative_ref_prefix(base_path: str, new_path: str) -> str:
    """Relative reference from the NEW snapshot root to the BASE root
    (``"../step_1000"`` for siblings), so a tree of snapshots moves as a
    unit. Both must live on the same scheme and host."""
    for url in (base_path, new_path):
        scheme = url.split("://", 1)[0].lower() if "://" in url else ""
        if scheme.startswith("tier+"):
            raise _not_ported(f"the write-back tier URL {url!r}", "A8")
    a, b = urlsplit(base_path), urlsplit(new_path)
    if a.scheme != b.scheme or a.netloc != b.netloc:
        raise ValueError(
            f"incremental_from {base_path!r} must share the scheme and "
            f"bucket/host of the snapshot path {new_path!r}"
        )
    if a.scheme in ("", "file"):
        pa = os.path.abspath(a.path or base_path)
        pb = os.path.abspath(b.path or new_path)
    else:
        pa, pb = a.path, b.path
    rel = posixpath.relpath(pa, pb)
    if rel == ".":
        raise ValueError(
            "incremental_from must name a different snapshot than the one being taken"
        )
    return rel


def _rewrite_entry_locations(entry: Entry, rel_prefix: str) -> Entry:
    """Deep copy of ``entry`` with every blob location re-expressed
    relative to the new root. Chained references collapse: a base that
    itself references an older base resolves to the older one directly."""
    e = copy.deepcopy(entry)
    for t in _entry_tensors(e):
        t.location = posixpath.normpath(posixpath.join(rel_prefix, t.location))
    return e


def _load_prev_entries(
    incremental_from: str,
    storage_options: Optional[Dict[str, Any]],
    rank: int,
    new_path: str,
    event_loop: asyncio.AbstractEventLoop,
) -> Tuple[Manifest, List[str]]:
    """This rank's view of the base manifest, every blob location
    rewritten relative to the new root, and the base roots such a
    location can point into (the base and its own recorded roots)."""
    rel_prefix = _relative_ref_prefix(incremental_from, new_path)
    storage = url_to_storage_plugin_in_event_loop(
        incremental_from, event_loop, storage_options
    )
    try:
        read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
        try:
            storage.sync_read(read_io, event_loop)
            prev_md = decode_metadata(read_io.buf.getvalue())
        except Exception as e:
            raise RuntimeError(
                f"incremental_from={incremental_from!r} is not a readable "
                "snapshot (missing or corrupt .snapshot_metadata)"
            ) from e
    finally:
        storage.sync_close(event_loop)
    view = get_manifest_for_rank(prev_md, rank)
    # A base taken without checksums, or by a build with another checksum
    # algorithm, can never match: refuse rather than rewrite everything.
    algo_prefix = _native.checksum_algorithm() + ":"
    blob_entries = [e for e in view.values() if entry_nbytes(e) > 0]
    usable = any(
        (t.checksum or "").startswith(algo_prefix)
        for e in blob_entries
        for t in _entry_tensors(e)
    )
    if blob_entries and not usable:
        raise ValueError(
            f"incremental_from={incremental_from!r} carries no "
            f"{algo_prefix[:-1]} checksums (taken with checksums disabled or "
            "by a different build?) — dedup is impossible, every blob would "
            "silently rewrite in full"
        )
    candidates = [rel_prefix] + [
        posixpath.normpath(posixpath.join(rel_prefix, r)) for r in (prev_md.base_roots or [])
    ]
    return {p: _rewrite_entry_locations(e, rel_prefix) for p, e in view.items()}, candidates


def load_snapshot(
    path: str,
    rank: int = 0,
    storage_options: Optional[Dict[str, Any]] = None,
    memory_budget_bytes: Optional[int] = None,
) -> Dict[str, Any]:
    """Load a whole snapshot into host memory WITHOUT the original
    program: the nested structure is rebuilt from the manifest, tensors
    come back as CPU tensors, primitives and pickled objects as values."""
    out: Dict[str, Any] = {}
    budget = memory_budget_bytes or get_process_memory_budget_bytes()
    with Snapshot(path, storage_options) as snap:
        with snap._op_lock:
            event_loop, storage = snap._resources()
            metadata = snap._get_metadata(storage, event_loop)
            local_manifest = get_manifest_for_rank(metadata, rank)
            for key in sorted({p.split("/", 1)[0] for p in local_manifest}):
                out[key] = _read_and_inflate(
                    key,
                    _key_manifest(local_manifest, key),
                    {},
                    storage,
                    budget,
                    event_loop,
                )
    return out


def _key_manifest(local_manifest: Manifest, key: str) -> Manifest:
    return {
        p: e
        for p, e in local_manifest.items()
        if p == key or p.startswith(key + "/")
    }


def _read_and_inflate(
    key: str,
    key_manifest: Manifest,
    target_flattened: Dict[str, Any],
    storage: StoragePlugin,
    memory_budget: int,
    event_loop: asyncio.AbstractEventLoop,
) -> Any:
    """Prepare reads (against targets when given), merge them per slab,
    execute under the budget, inflate."""
    read_reqs = []
    futures: Dict[str, Any] = {}
    for logical_path, entry in key_manifest.items():
        if is_container_entry(entry):
            continue
        reqs, fut = prepare_read(
            entry,
            obj_out=target_flattened.get(logical_path),
            logical_path=logical_path,
        )
        read_reqs.extend(reqs)
        futures[logical_path] = fut
    sync_execute_read_reqs(
        batch_read_requests(read_reqs), storage, memory_budget, event_loop
    )
    flattened = {p: fut.obj for p, fut in futures.items()}
    container_manifest = {
        p: e for p, e in key_manifest.items() if is_container_entry(e)
    }
    return inflate(container_manifest, flattened, prefix=key)


def _load_stateful(
    stateful: Stateful,
    key: str,
    metadata: SnapshotMetadata,
    rank: int,
    storage: StoragePlugin,
    memory_budget: int,
    event_loop: asyncio.AbstractEventLoop,
) -> None:
    local_manifest = _key_manifest(get_manifest_for_rank(metadata, rank), key)
    if not local_manifest:
        logger.warning("No entries for key %r in snapshot; skipping", key)
        return
    # The current state_dict provides the restore targets (device
    # placement, DTensor placements, in-place destinations).
    _, target_flattened = flatten(stateful.state_dict(), prefix=key)
    handle_sharded_elasticity(local_manifest, target_flattened)
    restored = _read_and_inflate(
        key, local_manifest, target_flattened, storage, memory_budget, event_loop
    )
    stateful.load_state_dict(restored)


# ------------------------------------------------------------- async work


class _BackgroundWork:
    """Daemon thread with exception capture and join-and-reraise, behind
    ``PendingSnapshot`` and ``PendingRestore``. Subclasses implement
    ``_body`` and may implement ``_on_error`` and ``_cleanup``; all run
    on the thread."""

    _thread_name = "tpusnap-torch-bg"

    def _start(self) -> None:
        self._exc: Optional[BaseException] = None
        self._done = threading.Event()
        self._thread = threading.Thread(
            target=self._trampoline, name=self._thread_name, daemon=True
        )
        self._thread.start()

    def _trampoline(self) -> None:
        try:
            self._body()
        except BaseException as e:  # noqa: B902 - re-raised from wait()
            self._exc = e
            try:
                self._on_error(e)
            except Exception:
                logger.warning("error handling of %s failed", self._thread_name, exc_info=True)
        finally:
            try:
                self._cleanup()
            except Exception:
                logger.warning("cleanup of %s failed", self._thread_name, exc_info=True)
            self._done.set()

    def _body(self) -> None:
        raise NotImplementedError

    def _on_error(self, exc: BaseException) -> None:
        pass

    def _cleanup(self) -> None:
        pass

    def _join_and_reraise(self) -> None:
        self._thread.join()
        if self._exc is not None:
            raise self._exc

    def done(self) -> bool:
        return self._done.is_set()


class PendingSnapshot(_BackgroundWork):
    """Handle on an in-flight ``async_take``. A background thread drains
    the residual staging windows and the writes, then commits through two
    ``LinearBarrier``s of the KV store: no collective runs off the calling
    thread (their prefix was broadcast on it). If any rank fails, its
    abort record (or the poisoned barrier) makes every rank's commit
    raise: ``.snapshot_metadata`` is never written, and ``wait()``
    re-raises on every rank. ``staged()``/``wait_staged()`` report when
    the caller may change its state in place; ``wait()`` returns the
    committed ``Snapshot``."""

    _thread_name = "tpusnap-torch-commit"

    def __init__(
        self,
        path: str,
        pending_io_work: PendingIOWork,
        metadata: SnapshotMetadata,
        storage: StoragePlugin,
        comm: Communicator,
        event_loop: asyncio.AbstractEventLoop,
        storage_options: Optional[Dict[str, Any]],
        live_until_drained: bool,
        late_checksums: Optional[_LateChecksums],
        abort_ctx: _TakeAbortContext,
    ) -> None:
        self.path = path
        self._pending_io_work = pending_io_work
        self._metadata = metadata
        self._storage = storage
        self._comm = comm
        self._event_loop = event_loop
        self._storage_options = storage_options
        self._late_checksums = late_checksums
        self._abort_ctx = abort_ctx
        self._snapshot: Optional[Snapshot] = None
        # Under COW the live bytes of CPU tensors are read until their
        # writes and verifies drain; otherwise the state is safe to change
        # once nothing left to stage reads it: CUDA sources were frozen
        # before the return, CPU clones wait for staging to complete.
        self._live_until_drained = live_until_drained
        self._frozen_at_return = pending_io_work.staging_complete() or all(
            s.frozen for s in pending_io_work.scheduler.unstaged_stagers()
        )
        # The barriers' identity is agreed here, on the calling thread;
        # the drain thread then touches only the KV store.
        barrier_prefix = comm.broadcast_object(f"tpusnap_commit/{uuid.uuid4().hex}", src=0)
        # Everything pending deletion now is proved consumed once every
        # rank departs the commit barrier; collectives the calling thread
        # issues later (a newer take) stay pending.
        self._gc_epoch = comm.gc_epoch()
        store = _get_kv_store(comm)
        watchers = abort_ctx.barrier_watchers()
        self._barrier = LinearBarrier(
            store, barrier_prefix, comm.rank, comm.world_size,
            timeout_sec=get_commit_barrier_timeout_s(), watchers=watchers,
        )
        # After the commit barrier every rank patches its manifest copy
        # from the take's KV records; this barrier proves all have read
        # them before rank 0 deletes them.
        self._post_barrier = (
            LinearBarrier(
                store, barrier_prefix + "-post", comm.rank, comm.world_size,
                timeout_sec=get_commit_barrier_timeout_s(), watchers=watchers,
            )
            if comm.world_size > 1
            else None
        )
        # The calling thread is done with collectives for this take: free
        # the communicator's wait watcher for a newer take. The commit
        # keeps abort awareness through the barriers' watchers.
        abort_ctx.disarm()
        self._start()

    def _body(self) -> None:
        self._pending_io_work.sync_complete(self._event_loop)
        if is_durable_commit_enabled():
            # As in the sync take: this rank's dirents before the barrier.
            self._storage.sync_flush_created_dirs(self._event_loop)
        if self._late_checksums is not None:
            self._late_checksums.publish()
        self._barrier.arrive()
        if self._comm.rank == 0:
            # Every rank arrived, so every rank published.
            if self._late_checksums is not None:
                self._late_checksums.apply(self._metadata.manifest)
            self._abort_ctx.mark_commit_started()
            _write_metadata(self._storage, self._metadata, self._event_loop)
        self._barrier.depart()
        meta_cached = True
        if self._comm.rank != 0 and self._late_checksums is not None:
            try:
                self._late_checksums.apply(self._metadata.manifest)
            except Exception:
                logger.warning(
                    "Non-leader late-checksum patch failed; the snapshot handle "
                    "reads the committed metadata instead",
                    exc_info=True,
                )
                meta_cached = False
        if self._post_barrier is not None:
            self._post_barrier.arrive()
            if self._comm.rank == 0 and self._late_checksums is not None:
                self._late_checksums.cleanup()
            self._post_barrier.depart()
        if self._comm.rank == 0 and self._abort_ctx.monitor is not None:
            self._abort_ctx.monitor.clear()
        # Every rank departed, so every rank consumed the take's gathers
        # and the prefix broadcast: release their keys now (no further
        # barrier runs on this communicator for this take). Store deletes
        # only; bounded by the epoch taken at construction.
        try:
            self._comm.gc_consumed_keys(self._gc_epoch)
        except Exception:
            logger.debug("store gc after the async commit failed", exc_info=True)
        snapshot = Snapshot(self.path, self._storage_options, self._comm)
        if meta_cached:
            snapshot._metadata = self._metadata
        self._snapshot = snapshot

    def _on_error(self, exc: BaseException) -> None:
        # Publish this rank's abort record (peers' barrier watchers then
        # raise TakeAbortedError) and delete its staged blobs; the
        # metadata is never written. Without a monitor (one process),
        # poison the barrier.
        self._abort_ctx.on_failure(exc)
        if self._abort_ctx.monitor is None:
            self._barrier.report_error(exc)

    def _cleanup(self) -> None:
        try:
            self._storage.sync_close(self._event_loop)
        finally:
            self._event_loop.close()

    def staged(self) -> bool:
        """Whether the caller may now change the snapshotted state in
        place. True at the return for CUDA state; for CPU tensors under
        COW, once the writes have drained; for cloned CPU tensors, once
        staging is complete."""
        if self._live_until_drained:
            return self._pending_io_work.drained()
        return self._frozen_at_return or self._pending_io_work.staging_complete()

    def wait_staged(self, timeout: Optional[float] = None) -> bool:
        """Block until ``staged()`` (or ``timeout`` seconds; returns
        ``staged()``). Re-raises the background failure if the drain died
        first, instead of waiting forever."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.staged():
            if self.done():
                self._join_and_reraise()
                return self.staged()
            step = 0.05
            if deadline is not None:
                step = min(step, deadline - time.monotonic())
                if step <= 0:
                    return False
            if self._live_until_drained:
                self._pending_io_work.wait_drained(step)
            else:
                self._pending_io_work.wait_staged(step)
        return True

    def wait(self) -> Snapshot:
        self._join_and_reraise()
        assert self._snapshot is not None
        return self._snapshot


class PendingRestore(_BackgroundWork):
    """Handle on an in-flight ``async_restore``. ``wait()`` joins the
    thread and re-raises its failure.

    On the card the thread runs on the caller's current device, on a
    stream ordered after the work the caller had queued when it called
    ``async_restore``; the copies into the targets run on side streams
    after it. ``wait()`` orders the caller's current stream after them,
    so the restored values are what the caller's next kernels read."""

    _thread_name = "tpusnap-torch-restore"

    def __init__(
        self,
        snapshot: Snapshot,
        app_state: AppState,
        comm: Communicator,
        memory_budget: int,
    ) -> None:
        self._snapshot = snapshot
        self._app_state = app_state
        self._comm = comm
        self._memory_budget = memory_budget
        self._device: Optional[int] = None
        self._caller_ready: Optional["torch.cuda.Event"] = None
        self._copied: Optional["torch.cuda.Event"] = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self._device = torch.cuda.current_device()
            self._caller_ready = event_on(torch.cuda.current_stream())
        self._start()

    def _restore(self) -> None:
        with self._snapshot._op_lock:
            self._snapshot._restore_locked(
                self._app_state, self._comm, per_key_barrier=False,
                memory_budget=self._memory_budget,
            )

    def _body(self) -> None:
        if self._device is None:
            self._restore()
            return
        # The current device and stream are per thread.
        torch.cuda.set_device(self._device)
        stream = torch.cuda.Stream()
        stream.wait_event(self._caller_ready)
        with torch.cuda.stream(stream):
            self._restore()
            self._copied = event_on(stream)

    def wait(self) -> None:
        self._join_and_reraise()
        if self._copied is not None:
            torch.cuda.current_stream(self._device).wait_event(self._copied)
