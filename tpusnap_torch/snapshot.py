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

Every take carries tpusnap's crash-safe lifecycle and observability,
in tpusnap's order and with its on-disk names (docs/format.md):

- the take journal (``lifecycle``): rank 0 writes ``.tpusnap/journal``
  before any blob write, every rank its seeded record file, and each blob
  write records CRC32C+XXH64 evidence; the commit clears them. A killed
  take is "torn" to either package's ``fsck_snapshot``, and a retake to
  the same path skips the storage writes of blobs whose staged bytes
  match the evidence (salvage-resume: it still copies and hashes them).
- telemetry (``telemetry``): phase and op spans, counters and I/O
  histograms; a per-rank trace in ``.tpusnap/telemetry/`` and the
  cross-rank rollup in ``metadata.extras["telemetry"]``; restore traces
  under ``TPUSNAP_TELEMETRY_DIR``.
- the heartbeat pump (``progress``) with the flight recorder
  (``flight``) flushed on it, and, with several processes, the
  rank-liveness lease (``liveness``): a dead peer fails every wait of the
  take with ``RankFailedError`` within about twice
  ``TPUSNAP_LIVENESS_TTL_S``.
- ``TPUSNAP_RANK_FAILURE=degrade``: the survivors of a take whose dead
  rank held only replicated state adopt its units and commit, recording
  ``extras["degraded"]``. An async take freezes the units it would adopt
  at the call, with its own, so a degraded snapshot still holds the
  state at the call.
- ``chaos+fs://`` paths run under the fault plan and the retry
  middleware (``storage_plugin``).

Storage beyond the local filesystem composes as in tpusnap
(``storage_plugin``): ``s3://``, ``gs://`` and ``fsspec+<protocol>://``;
the write-back tier ``tier+local=<dir>+remote=<url>://`` (``tiering``:
a take commits locally and drains to the remote in the background); the
content-addressed store (``cas+fs://`` or ``TPUSNAP_CAS_DIR``: ``cas``).
``Snapshot.stream`` opens a delta stream of micro-commits (``delta``).

Every take and restore feeds tpusnap's consumers of its telemetry, at
tpusnap's seams: the export sinks and the cross-run history at its end
(``telemetry``), the SLO tracker (``slo``: planned bytes, the commit
anchor, the abort) and the fleet mirror (``fleet``) on the heartbeat
pump, the access ledger (``access``) around every restore and
``read_object``, and the tuner (``tune``, ``TPUSNAP_AUTOTUNE=1``) before
any budget or knob is read.
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

from . import _native, access, compress, telemetry
from . import flight as _flight
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
from .io_types import (
    BufferStager,
    ReadIO,
    StoragePlugin,
    WriteIO,
    finalizer_close_scope,
    run_on_loop,
    shutdown_plugin_executor,
)
from .knobs import (
    get_async_stage_window_bytes,
    get_commit_barrier_timeout_s,
    get_liveness_ttl_s,
    get_node_name,
    get_rank_failure_policy,
    is_checksum_disabled,
    is_dedup_hash_recording_forced,
    is_durable_commit_enabled,
    is_journal_disabled,
)
from .liveness import LeasePublisher, LivenessMonitor, RankFailedError
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
    reassign_dead_units,
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
        self._close(blocking=True)

    def _close(self, blocking: bool) -> None:
        # The finalizer path (__del__) must not block on _op_lock: GC can
        # fire on a thread that holds arbitrary locks (an executor's
        # shutdown locks inside submit). A contended _op_lock means the
        # handle is still in use; skipping leaks nothing (the next close
        # or GC pass retries).
        if not self._op_lock.acquire(blocking):
            return
        try:
            loop = self._cached_loop
            if blocking:
                if self._cached_storage is not None and loop is not None:
                    self._cached_storage.sync_close(loop)
            else:
                # GC may run __del__ inside another running event loop,
                # where run_until_complete is illegal: then only drop the
                # references.
                try:
                    asyncio.get_running_loop()
                    in_async_context = True
                except RuntimeError:
                    in_async_context = False
                if (
                    not in_async_context
                    and self._cached_storage is not None
                    and loop is not None
                    and not loop.is_closed()
                    and not loop.is_running()
                ):
                    try:
                        self._cached_storage.sync_close(loop)
                    except Exception:
                        pass
            self._cached_storage = None
            if loop is not None and not loop.is_running():
                if not blocking:
                    # loop.close() (here, or in asyncio's own __del__ if
                    # nobody closes it) shuts the loop's default executor
                    # down (run_in_executor(None, ...): the read-abort
                    # drain) with a blocking _shutdown_lock acquire, the
                    # AB/BA window shutdown_plugin_executor documents when
                    # GC fires inside a submit. Detach it and shut it down
                    # without waiting on any lock instead.
                    self._detach_default_executor(loop)
                loop.close()
            self._cached_loop = None
        finally:
            self._op_lock.release()

    @staticmethod
    def _detach_default_executor(loop) -> None:
        executor = getattr(loop, "_default_executor", None)
        if executor is None:
            return
        loop._default_executor = None
        shutdown_plugin_executor(executor)

    def __enter__(self) -> "Snapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        # A dropped handle (``Snapshot(path).restore(...)``) releases its
        # loop and storage here, through the finalizer-safe path: plugin
        # closes neither join threads nor wait on an executor's lock.
        try:
            with finalizer_close_scope():
                self._close(blocking=False)
        except Exception:
            pass

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
        _extras: Optional[Dict[str, Any]] = None,
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
        must keep the shape and be deterministic. ``_extras`` is
        caller data for ``metadata.extras`` (a delta stream's chain
        fields); the commit's own additions land beside it."""
        comm = get_communicator(comm)
        event_loop = asyncio.new_event_loop()
        abort_ctx = _TakeAbortContext(comm, event_loop)
        tele = telemetry.begin_take(comm.rank)
        try:
            try:
                pending, metadata, path, storage, late_checksums, _, tele_commit = _take_impl(
                    path, app_state, storage_options, comm, replicated or [], event_loop,
                    abort_ctx,
                    is_async_snapshot=False,
                    per_key_barrier=per_key_barrier,
                    array_prepare_func=_custom_array_prepare_func,
                    incremental_from=incremental_from,
                    extras=_extras,
                    force_dedup_hashes=_record_dedup_hashes,
                )
                meta_cached = _commit(
                    pending, metadata, storage, comm, late_checksums, abort_ctx, event_loop,
                    tele_commit, path,
                )
            except RankFailedError as rank_exc:
                # A peer died. Under TPUSNAP_RANK_FAILURE=degrade (with the
                # recovery context armed) the survivors complete the take
                # without it; anything else aborts to a torn directory.
                try:
                    degraded = _maybe_degraded_commit(abort_ctx, rank_exc)
                except BaseException as e:
                    abort_ctx.on_failure(e)
                    raise
                if degraded is None:
                    abort_ctx.on_failure(rank_exc)
                    raise
                metadata, meta_cached = degraded, True
                tele.meta["completed"] = True
                _record_slo_commit(
                    tele, metadata, abort_ctx.degrade.take_id, path, comm.rank
                )
                abort_ctx.finish_progress("committed")
                _flight.recorder().end_take("committed")
            except BaseException as e:
                abort_ctx.on_failure(e)
                raise
            finally:
                abort_ctx.close_storage()
        finally:
            abort_ctx.stop_progress()
            telemetry.end_take(tele)
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
        _extras: Optional[Dict[str, Any]] = None,
        _record_dedup_hashes: bool = False,
        _force_clone_staging: bool = False,
        _stream_capture: bool = False,
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
        off the calling thread.

        ``_force_clone_staging`` stages CPU tensors into take-owned
        clones instead of COW views (a delta stream's micro-commits,
        whose caller never calls ``wait_staged``); ``_stream_capture``
        arms the degraded commit for this incremental take, which those
        clones make safe (``delta``)."""
        comm = get_communicator(comm)
        event_loop = asyncio.new_event_loop()
        abort_ctx = _TakeAbortContext(comm, event_loop)
        tele = telemetry.begin_take(comm.rank)
        try:
            (
                pending, metadata, path, storage, late_checksums, live_until_drained,
                tele_commit,
            ) = _take_impl(
                path, app_state, storage_options, comm, replicated or [], event_loop,
                abort_ctx,
                is_async_snapshot=True,
                per_key_barrier=per_key_barrier,
                array_prepare_func=_custom_array_prepare_func,
                incremental_from=incremental_from,
                extras=_extras,
                force_dedup_hashes=_record_dedup_hashes,
                force_clone_staging=_force_clone_staging,
                stream_capture=_stream_capture,
            )
            # From here the event loop and storage belong to the drain
            # thread, which closes them.
            return PendingSnapshot(
                path, pending, metadata, storage, comm, event_loop, storage_options,
                live_until_drained, late_checksums=late_checksums, abort_ctx=abort_ctx,
                tele_commit=tele_commit,
            )
        except BaseException as e:
            abort_ctx.on_failure(e)
            abort_ctx.close_storage()
            abort_ctx.stop_progress()
            telemetry.end_take(tele)
            abort_ctx.disarm()
            event_loop.close()
            raise

    @classmethod
    def stream(
        cls,
        root: str,
        app_state: AppState,
        cadence_s: Optional[float] = None,
        replicated: Optional[List[str]] = None,
        storage_options: Optional[Dict[str, Any]] = None,
        comm: Optional[Communicator] = None,
        max_chain: Optional[int] = None,
    ) -> "DeltaStream":
        """Continuous delta checkpointing: open a ``delta.DeltaStream``
        under ``root`` — a full base snapshot now, then one journaled
        incremental micro-commit per ``cadence_s`` (default
        ``TPUSNAP_DELTA_CADENCE_S``) that writes only the tiles and blobs
        whose CRC32C+XXH64 pair changed. A crash recovers to the last
        committed member (``delta.resolve_chain(root).head``), which
        restores like any snapshot. Call ``mark_step()`` once per
        training step to take each capture at a step boundary on the
        training thread; the CUDA streams current on each state device
        when this is called order every capture. ``close()`` the stream
        (or use it as a context manager) to stop."""
        from .delta import DeltaStream

        return DeltaStream(
            root,
            app_state,
            cadence_s=cadence_s,
            replicated=replicated,
            storage_options=storage_options,
            comm=comm,
            max_chain=max_chain,
        )

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
        """The restore under its own telemetry recorder (a thread-local
        overlay, so an in-flight take's recorder is left alone): phases
        ``restore.plan`` then per key ``restore.targets``,
        ``restore.prepare``, ``restore.read``, ``restore.load``, the
        scheduler's read spans; the trace goes to the local telemetry dir
        (the snapshot is immutable)."""
        tele = telemetry.begin_restore(comm.rank)
        tele.meta.update(path=self.path, world_size=comm.world_size)
        mark = telemetry.PhaseMarker(rec=tele, from_start=True)
        # The access ledger's scope is the whole read path: every read
        # attributes (leaf, byte range, source tier) to this reader. It
        # is opened by hand, not by ``read_scope``, so that its flush
        # runs after the telemetry wall has closed.
        ledger = access.open_ledger(self.path, default_source=self._access_default_source())
        try:
            with telemetry.use(tele):
                with access.use(ledger):
                    self._restore_instrumented(
                        app_state, comm, per_key_barrier, memory_budget, mark
                    )
            tele.meta["completed"] = True
        finally:
            if ledger is not None:
                # In-memory totals only: the summary needs them, the
                # flush and the fleet publish wait until after finalize.
                tele.meta["access"] = {
                    "bytes_read": ledger.total_bytes,
                    "reads": ledger.total_reads,
                    "working_set_bytes": ledger.working_set_bytes(),
                }
            # The tuned overlay is scoped to the operation that applied it.
            from .knobs import clear_tuned_plan

            clear_tuned_plan()
            tele.finalize()
            telemetry.publish_restore_summary(tele.summary())
            if tele.enabled:
                try:
                    from .progress import persist_restore_trace

                    persist_restore_trace(tele, self.path)
                except Exception:
                    logger.warning("Failed to persist restore trace (non-fatal)", exc_info=True)
            if ledger is not None:
                try:
                    ledger.flush()
                except Exception:
                    logger.debug("access ledger flush failed", exc_info=True)
                self._publish_access_stats(ledger)

    def _restore_instrumented(
        self,
        app_state: AppState,
        comm: Communicator,
        per_key_barrier: bool,
        memory_budget: Optional[int],
        mark: "telemetry.PhaseMarker",
    ) -> None:
        event_loop, storage = self._resources()
        try:
            from .storage_plugin import storage_plugin_label

            # The backend this restore reads (tier-aware): the history
            # event's ``plugin``, what the SLO RTO estimate filters on.
            telemetry.current().meta["plugin"] = storage_plugin_label(storage)
        except Exception:
            pass
        # The tuner (TPUSNAP_AUTOTUNE=1) installs this cell's plan before
        # the budget and knob reads below; the applied subset rides the
        # summary into the history event.
        from . import tune as _tune

        tuned = _tune.maybe_apply("restore", storage=storage, world_size=comm.world_size)
        if tuned:
            telemetry.current().meta["tuned"] = tuned
        metadata = self._get_metadata(storage, event_loop)
        if memory_budget is None:
            memory_budget = get_process_memory_budget_bytes(comm)
        multi = per_key_barrier and comm.world_size > 1
        keys = _gather_keys(comm, sorted(app_state)) if multi else sorted(app_state)
        mark("restore.plan")
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
                mark=mark,
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
            # Random access is the lazy-serving path the heatmap credits:
            # this object's reads get a scope of their own, so a partial
            # reader shows with coverage below 1.
            with access.read_scope(
                self.path, default_source=self._access_default_source()
            ) as ledger:
                sync_execute_read_reqs(
                    read_reqs, storage, budget, event_loop, rank=comm.rank
                )
            if ledger is not None:
                self._publish_access_stats(ledger)
            return fut.obj

    def _access_default_source(self) -> str:
        """Source tier of the access records whose read carries no
        explicit stamp (the tier and CAS layers stamp theirs)."""
        try:
            from .storage_plugin import storage_plugin_label

            _, storage = self._resources()
            return access.default_source_for_plugin(storage_plugin_label(storage))
        except Exception:
            return "local"

    def _publish_access_stats(self, ledger) -> None:
        """Fold a finished read scope's totals into this process's fleet
        reader record (the reader side of ``fleet``). Never fails a
        read."""
        try:
            from . import fleet
            from .progress import _path_digest

            snapshot_bytes = 0
            if self._metadata is not None:
                snapshot_bytes = access.snapshot_stored_nbytes(self._metadata)
            fleet.note_reader_scope(
                _path_digest(self.path),
                snapshot_bytes,
                ledger.total_bytes,
                ledger.total_reads,
            )
        except Exception:
            logger.debug("fleet reader stats publish failed", exc_info=True)

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
    of running out the barrier timeout; once the heartbeat pump runs, the
    rank-liveness monitor joins the watcher (``arm_liveness``), so a dead
    peer raises :class:`RankFailedError`. On failure it stops the pump
    with an "aborted" record, records the abort in the flight recorder,
    publishes this rank's abort record, deletes the blobs this rank may
    have written (so the path stays reusable) and then its journal
    records (rank 0 also the marker), and drops this rank's KV records.
    Blobs and journal are kept once the metadata commit may have started
    (orphan blobs are safe, dangling manifest references are not) and on
    a rank failure (the survivors' blobs and evidence are what a retake
    salvages). ``degrade`` holds what the survivors of a rank failure
    need to finish the take (``TPUSNAP_RANK_FAILURE=degrade``)."""

    def __init__(self, comm: Communicator, event_loop: asyncio.AbstractEventLoop) -> None:
        self.comm = comm
        self.event_loop = event_loop
        self.monitor: Optional[TakeAbortMonitor] = None
        self.storage: Optional[StoragePlugin] = None
        self.pending: Optional[PendingIOWork] = None
        self.write_paths: List[str] = []
        self.late_checksums: Optional["_LateChecksums"] = None
        self.tele_commit: Optional["_TelemetryCommit"] = None
        self.progress = None
        self.lease: Optional[LeasePublisher] = None
        self.liveness: Optional[LivenessMonitor] = None
        self.degrade: Optional["_DegradeContext"] = None
        # Set once the take's journal exists: an aborted take (not a
        # killed one) cleans its blobs and then its journal, leaving the
        # path empty, not torn.
        self.journal_world_size: Optional[int] = None
        self.commit_started = False
        self._failed = False

    def arm(self, monitor: TakeAbortMonitor) -> None:
        self.monitor = monitor
        self._install_watcher()

    def arm_liveness(self, lease: LeasePublisher, liveness: LivenessMonitor) -> None:
        """Once the pump runs (after ``arm``): every wait also judges the
        peers' leases."""
        self.lease = lease
        self.liveness = liveness
        self._install_watcher()

    def _install_watcher(self) -> None:
        monitor, liveness = self.monitor, self.liveness
        if monitor is None:
            return
        if liveness is None:
            self.comm.set_wait_watcher(monitor.check)
            return

        def watcher() -> None:
            monitor.check()
            liveness.check()

        self.comm.set_wait_watcher(watcher)

    def barrier_watchers(self) -> List:
        """Watchers for the async commit's ``LinearBarrier`` waits: peer
        abort records and lease expiry."""
        out = []
        if self.monitor is not None:
            out.append(self.monitor.check)
        if self.liveness is not None:
            out.append(self.liveness.check)
        return out

    def disarm(self) -> None:
        if self.monitor is not None:
            self.comm.clear_wait_watcher()

    def close_storage(self) -> None:
        if self.storage is not None:
            self.storage.sync_close(self.event_loop)
            self.storage = None

    def finish_progress(self, state: str) -> None:
        if self.progress is not None:
            try:
                self.progress.finish(state)
            except Exception:
                logger.debug("progress finish failed", exc_info=True)

    def stop_progress(self) -> None:
        """Safety net on every exit path: the pump thread is gone."""
        if self.progress is not None:
            self.progress.stop()

    def mark_commit_started(self) -> None:
        self.commit_started = True
        if self.monitor is not None:
            self.monitor.mark_commit_started()

    def on_failure(self, exc: BaseException) -> None:
        """Publish and clean up, once; never raises."""
        if self._failed:
            return
        self._failed = True
        self.finish_progress("aborted")
        # The SLO tracker drops the dead take's counters but keeps its
        # exposure: nothing committed, so the planned bytes stay at risk.
        try:
            from . import slo as _slo

            _slo.tracker().note_take_aborted()
        except Exception:
            pass
        try:
            _flight.record("abort", op=type(exc).__name__)
            _flight.recorder().end_take("aborted")
        except Exception:
            logger.debug("flight abort record failed", exc_info=True)
        if self.monitor is not None and not isinstance(exc, TakeAbortedError):
            self.monitor.publish(exc)
        rank_failure = isinstance(exc, RankFailedError) or isinstance(
            getattr(exc, "__cause__", None), RankFailedError
        )
        keep_blobs = (
            self.commit_started
            or rank_failure
            or (self.monitor is not None and self.monitor.commit_may_have_started())
        )
        if self.pending is not None and not self.pending.drained():
            try:
                if rank_failure:
                    # The blobs stay: let this rank's staged writes land,
                    # so that its journal holds their salvage evidence.
                    self.pending.sync_complete(self.event_loop)
                else:
                    self.pending.sync_cancel(self.event_loop)
            except Exception:
                logger.debug("finishing the take's writes failed", exc_info=True)
        if not keep_blobs and self.storage is not None:
            deletes_failed = False
            for path in self.write_paths:
                try:
                    run_on_loop(self.event_loop, self.storage.delete(path))
                except FileNotFoundError:
                    pass  # never written (dedup skip, or not reached)
                except Exception:
                    deletes_failed = True
                    logger.debug("abort cleanup of %r failed", path, exc_info=True)
            # Blobs gone: this rank's journal records (rank 0: then the
            # marker) go too, so the path reads empty, not torn. If a
            # delete failed the marker stays: the leftovers must remain
            # classifiable as torn.
            if self.journal_world_size is not None:
                from .lifecycle import clear_journal, journal_rank_path

                try:
                    if self.comm.rank != 0:
                        self.storage.sync_delete(
                            journal_rank_path(self.comm.rank), self.event_loop
                        )
                    elif not deletes_failed:
                        clear_journal(self.storage, self.event_loop, self.journal_world_size)
                except Exception:
                    logger.debug("abort journal cleanup failed", exc_info=True)
        for transport in (self.late_checksums, self.tele_commit):
            if transport is not None:
                try:
                    transport.discard()
                except Exception:
                    logger.debug("KV record discard failed", exc_info=True)


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
    extras: Optional[Dict[str, Any]] = None,
    force_dedup_hashes: bool = False,
    force_clone_staging: bool = False,
    stream_capture: bool = False,
) -> Tuple[
    PendingIOWork, SnapshotMetadata, str, StoragePlugin, Optional["_LateChecksums"], bool,
    "_TelemetryCommit",
]:
    """Flatten, plan, prepare and batch every write, and run the write
    engine to the blocked-window boundary. Returns the work left, the
    metadata to commit once it is done, the path (rank 0's), the open
    storage plugin (journaling), the late-checksum transport (several
    processes), whether live CPU bytes are read until the writes drain
    (COW), and the telemetry transport of the commit.

    Exactly two gathers with several processes, as in tpusnap: G1 before
    staging (path, globs, write-load estimate, host name, take id) and G2
    after it (the manifests); ``per_key_barrier`` adds a key gather and a
    barrier per key. The phases ``state_dict``, ``plan``, ``prepare``,
    ``stage``, ``manifest_gather`` and ``metadata`` tile the take's
    timeline in its telemetry."""
    _validate_app_state(app_state)
    rank = comm.rank
    multi = comm.world_size > 1
    mark = telemetry.phase_marker(from_start=True)
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
    mark("state_dict", keys=len(keys))

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
    mark("plan")
    if mark.rec is not None:
        mark.rec.meta.update(
            take_id=take_id, path=path, world_size=comm.world_size,
            incremental=incremental_from is not None,
        )

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
    try:
        from .storage_plugin import storage_plugin_label

        telemetry.current().meta["plugin"] = storage_plugin_label(storage)
    except Exception:
        pass
    # The tuner (TPUSNAP_AUTOTUNE=1) installs this cell's plan before the
    # staging, window and budget knobs are read; explicit env vars win
    # knob by knob, and the applied subset rides the history event.
    from . import tune as _tune

    tuned = _tune.maybe_apply("take", storage=storage, world_size=comm.world_size)
    if tuned and telemetry.current() is not None:
        telemetry.current().meta["tuned"] = tuned
    storage = _open_journal(
        storage, event_loop, rank, comm.world_size, take_id, incremental_from, abort_ctx,
        stream=(extras or {}).get("delta"),
    )
    progress_monitor = _start_observability(
        mark.rec, comm, take_id, path, abort_ctx, multi
    )
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
    # holds this rank's members only. The others' are kept aside, unstaged,
    # for a degraded commit to adopt.
    dropped_replicated: Dict[str, List] = {}
    if multi and replicated_entry_paths:
        write_reqs, dropped_replicated = filter_assigned_write_reqs(
            entries, write_reqs, replicated_entry_paths, assignment, rank
        )

    entries_list, write_reqs = batch_write_requests(
        list(entries.values()), write_reqs
    )
    entries = dict(zip(entries.keys(), entries_list))
    # One measured compress-or-bypass decision per take, armed on the
    # eligible standalone blobs after batching. Never fails a take.
    compress.apply_take_policy(write_reqs, storage, event_loop)
    if force_clone_staging:
        # Per-take clone staging (delta micro-commits): armed on this
        # take's stagers, slab members included, never by a process-wide
        # knob that would race other takes.
        def _arm_clone(st):
            if hasattr(st, "force_clone"):
                st.force_clone = True
            for m in getattr(st, "members", None) or []:
                _arm_clone(m[2] if isinstance(m, tuple) else m)

        for wr in write_reqs:
            _arm_clone(wr.buffer_stager)
    abort_ctx.write_paths = [wr.path for wr in write_reqs]
    planned_payload = sum(wr.buffer_stager.get_planned_bytes() for wr in write_reqs)
    if progress_monitor is not None:
        # The denominator of the heartbeat's byte progress: payload bytes.
        progress_monitor.set_bytes_planned(planned_payload)
    # Data at risk (``slo``): everything this take stages is at risk
    # until its commit; an incremental take refines the figure from its
    # dedup counters. Recorded with telemetry off too.
    try:
        from . import slo as _slo

        rec = mark.rec
        _slo.tracker().configure(rank, comm.world_size)
        _slo.tracker().note_planned(
            planned_payload,
            incremental=incremental_from is not None,
            live_counters=(lambda: rec.live_snapshot()["counters"]) if rec is not None else None,
            # This take's commit makes the state of this instant durable.
            take_id=take_id,
        )
    except Exception:
        logger.debug("slo note_planned failed", exc_info=True)
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
    memory_budget = get_process_memory_budget_bytes(comm, local_world_size=local_world_size)
    mark("prepare", write_reqs=len(write_reqs))
    pending = sync_execute_write_reqs(
        write_reqs,
        storage,
        memory_budget,
        event_loop,
        prioritize_staging=is_async_snapshot and not pipelined,
        pipelined_staging=pipelined,
        stage_eagerly=stage_eagerly,
        rank=rank,
    )
    abort_ctx.pending = pending
    if pipelined and not pending.staging_complete():
        # The freeze: CUDA state outside the first window is copied
        # on the card before the return, or, without room for the
        # copies, staged now.
        if not freeze_device_sources(pending.scheduler.unstaged_stagers()):
            run_on_loop(event_loop, pending.scheduler.stage_all())
    mark("stage", write_reqs=len(write_reqs))
    if (
        multi
        and abort_ctx.liveness is not None
        and (incremental_from is None or stream_capture)
        and get_rank_failure_policy() == "degrade"
    ):
        # Everything a degraded commit needs is final here, before the
        # manifest gather (the first wait a dead peer can strand). An
        # async take also freezes the units it may adopt, as its own: a
        # degraded snapshot must hold the state at the call, not what
        # the caller wrote in place after it. (tpusnap arms this for
        # synchronous takes only.) Incremental takes never degrade: their
        # dedup decisions reference per-rank base views. A stream capture
        # is the exception, as in tpusnap: every member dedups against
        # the same parent and its replicated state is the same on every
        # member, so a survivor's view of a replicated entry is the dead
        # rank's.
        if is_async_snapshot:
            _freeze_for_adoption(dropped_replicated, event_loop)
        abort_ctx.degrade = _DegradeContext(
            comm=comm, take_id=take_id, storage=storage, event_loop=event_loop,
            entries=entries, dropped_replicated=dropped_replicated,
            assignment=assignment, memory_budget=memory_budget, pending_io_work=pending,
            extras=extras,
        )
    global_manifest = _gather_manifest(entries, comm)
    mark("manifest_gather")
    metadata = SnapshotMetadata(
        version=__version__,
        world_size=comm.world_size,
        manifest=global_manifest,
        created_at=time.time(),
        # The base roots the manifest's external references point into,
        # so readers never parse roots out of location strings.
        base_roots=_referenced_base_roots(global_manifest, base_root_candidates) or None,
        # Caller data (a delta stream's chain fields); the commit's own
        # additions (the telemetry rollup) land beside it.
        extras=dict(extras) if extras else None,
    )
    mark("metadata")
    tele_commit = _TelemetryCommit(mark.rec, comm, take_id, progress=progress_monitor)
    abort_ctx.tele_commit = tele_commit
    return pending, metadata, path, storage, late_checksums, live_until_drained, tele_commit


def _open_journal(
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
    rank: int,
    world_size: int,
    take_id: str,
    incremental_from: Optional[str],
    abort_ctx: _TakeAbortContext,
    stream: Optional[Dict[str, Any]] = None,
) -> StoragePlugin:
    """The take's crash-safe lifecycle, as tpusnap opens it: if the path
    holds a torn take (a journal, no metadata), load its completion
    records for salvage; wrap the plugin in the journaling layer; rank 0
    writes the journal marker before any blob write, and every rank its
    record file (seeded with the salvage records, so a retake that
    crashes early still leaves them). Returns the journaling plugin, which
    the abort context then owns."""
    from .lifecycle import (
        JournalingStoragePlugin,
        TakeJournal,
        load_salvage_records,
        read_journal,
        write_journal,
    )

    journal_enabled = not is_journal_disabled()
    salvage_records = None
    # Every rank that may hold a record here: a retake over a torn take
    # of a larger world must still clear the torn ranks' files.
    clear_ws = world_size
    prior = read_journal(storage, event_loop) if journal_enabled else None
    if prior is not None:
        clear_ws = max(clear_ws, prior.world_size)
        try:
            files = storage.sync_list_with_sizes(event_loop)
        except Exception:
            files = None
        # Salvage needs the listing (each record is checked against the
        # blob present) and never applies over committed metadata.
        if files is not None and SNAPSHOT_METADATA_FNAME not in files:
            salvage_records = load_salvage_records(
                storage, event_loop, prior.world_size, files=files
            )
            if salvage_records:
                logger.info(
                    "Torn take %s found: %d completed blob record(s) loaded for salvage",
                    prior.take_id[:8], len(salvage_records),
                )
    # A CAS layer was built before the take knew its rank; its per-rank
    # ref records need it.
    from .cas import find_cas_plugin

    cas_layer = find_cas_plugin(storage)
    if cas_layer is not None:
        cas_layer.rank = rank
    storage = JournalingStoragePlugin(storage, rank, salvage_records)
    storage.clear_world_size = clear_ws
    abort_ctx.storage = storage
    if journal_enabled:
        if rank == 0:
            write_journal(
                storage,
                event_loop,
                TakeJournal(
                    take_id=take_id, world_size=world_size, started_at=time.time(),
                    incremental_from=incremental_from, version=__version__,
                    # A killed micro-commit stays explainable as "seq N
                    # over member X", not an anonymous torn take.
                    stream=stream,
                ),
            )
        try:
            storage.sync_seed_record_file(event_loop)
        except Exception:
            logger.warning("Failed to create journal record file (non-fatal)", exc_info=True)
        abort_ctx.journal_world_size = clear_ws
    return storage


def _start_observability(
    rec: Optional["telemetry.TakeTelemetry"],
    comm: Communicator,
    take_id: str,
    path: str,
    abort_ctx: _TakeAbortContext,
    multi: bool,
):
    """The heartbeat pump and stall watchdog (telemetry on), the flight
    recorder's take destinations and its flush on the pump, and, with
    several processes, this rank's liveness lease on the pump and the
    lease monitor in every wait. Best-effort like tpusnap's: a failure
    here logs and the take goes on. Returns the progress monitor."""
    progress_monitor = None
    if rec is not None and rec.enabled:
        try:
            from .progress import start_take_monitor

            progress_monitor = start_take_monitor(rec, comm, take_id, path)
            abort_ctx.progress = progress_monitor
        except Exception:
            logger.warning("Failed to start progress monitor (non-fatal)", exc_info=True)
    try:
        from .progress import local_root_of

        frec = _flight.recorder()
        frec.configure_take(comm.rank, take_id, comm.world_size, path, local_root_of(path))
        if progress_monitor is not None and frec.enabled:
            progress_monitor.add_tick_hook(_flight.make_tick_hook(frec))
    except Exception:
        logger.warning("Failed to configure flight recorder (non-fatal)", exc_info=True)
    if multi and progress_monitor is not None and progress_monitor.kv is not None:
        ttl = get_liveness_ttl_s()
        if ttl > 0:
            try:
                lease = LeasePublisher(progress_monitor.kv, take_id, comm.rank)
                lease.publish()  # alive now, not one tick later
                liveness = LivenessMonitor(
                    progress_monitor.kv, take_id, comm.rank, comm.world_size, ttl_s=ttl
                )
                progress_monitor.add_tick_hook(lease.make_tick_hook())
                progress_monitor.set_liveness_probe(liveness.dead_ranks)
                progress_monitor.set_left_probe(liveness.left_ranks)
                abort_ctx.arm_liveness(lease, liveness)
            except Exception:
                logger.warning("Failed to arm rank-liveness leases (non-fatal)", exc_info=True)
    if progress_monitor is not None:
        # The SLO gauges (RPO, data at risk, estimated RTO) publish at the
        # heartbeat cadence, and the ``slo`` sub-dict rides every
        # heartbeat record; the fleet mirror (TPUSNAP_FLEET_DIR) rides the
        # same pump.
        try:
            from . import slo as _slo

            _slo.tracker().refresh_rto()
            _slo.attach_to_take(progress_monitor, take_id, comm.rank, comm.world_size)
        except Exception:
            logger.warning("Failed to attach SLO tracker (non-fatal)", exc_info=True)
        try:
            from . import fleet as _fleet

            _fleet.attach_to_take(progress_monitor)
            _fleet.publish_at_take_start(progress_monitor)
        except Exception:
            logger.warning("Failed to attach fleet publisher (non-fatal)", exc_info=True)
    return progress_monitor


def _commit(
    pending: PendingIOWork,
    metadata: SnapshotMetadata,
    storage: StoragePlugin,
    comm: Communicator,
    late_checksums: Optional["_LateChecksums"],
    abort_ctx: _TakeAbortContext,
    event_loop: asyncio.AbstractEventLoop,
    tele_commit: "_TelemetryCommit",
    path: str,
) -> bool:
    """A sync take's drain and two-phase commit: writes drained, late
    checksums and the telemetry summary published, this rank's trace
    written, on every rank; barrier; every rank patches its manifest copy
    and folds the rollup; rank 0 writes the metadata; barrier; rank 0
    deletes the take's KV keys, then clears the journal (strictly after
    the metadata). Returns whether this rank's manifest copy is the
    committed one (a non-leader whose patch failed reads the file)."""
    tele = tele_commit.tele
    drain_start = tele.now() if tele is not None else 0.0
    pending.sync_complete(event_loop)
    if tele is not None:
        tele.record_span("io_drain", drain_start, tele.now() - drain_start, phase=True)
    prep_start = tele.now() if tele is not None else None
    if is_durable_commit_enabled():
        # Every rank makes its own dirents durable before the commit
        # barrier: rank 0's metadata fsync covers only the directories
        # its own plugin instance created.
        storage.sync_flush_created_dirs(event_loop)
    if late_checksums is not None:
        late_checksums.publish()
    tele_commit.persist(storage, event_loop, abort_ctx, prep_start)
    comm.barrier()
    meta_cached = True
    try:
        if late_checksums is not None:
            late_checksums.apply(metadata.manifest)
        if not tele_commit.apply(metadata):
            meta_cached = False
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
        tele_commit.cleanup()
    if tele is not None:
        tele.meta["completed"] = True
    _record_slo_commit(tele, metadata, tele_commit.take_id, path, comm.rank)
    tele_commit.finish_progress()
    _flight.recorder().end_take("committed")
    if comm.rank == 0:
        _finish_commit(storage, event_loop, abort_ctx, comm.world_size)
    return meta_cached


def _record_slo_commit(
    tele: Optional["telemetry.TakeTelemetry"],
    metadata: SnapshotMetadata,
    take_id: Optional[str],
    path: str,
    rank: int,
) -> None:
    """Anchor the SLO tracker on a definitive commit (every commit path
    calls this after the metadata write, where ``completed`` is set):
    close the interval, clear the data at risk, refresh the RTO estimate
    against this rank's restore view, and fold the ``slo`` section into
    the summary the history event records. Never fails a take."""
    try:
        from . import slo as _slo
        from .inspect import rank_payload_nbytes

        counters: Dict[str, int] = {}
        incremental = False
        if tele is not None:
            counters = tele.live_snapshot()["counters"]
            incremental = bool(tele.meta.get("incremental"))
        section = _slo.tracker().record_commit(
            take_id or "",
            path,
            rank_payload_nbytes(metadata, rank),
            incremental=incremental,
            counters=counters,
        )
        if tele is not None:
            tele.meta["slo"] = section
    except Exception:
        logger.debug("slo commit record failed", exc_info=True)


def _finish_commit(
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
    abort_ctx: _TakeAbortContext,
    world_size: int,
) -> None:
    """Rank 0, after the metadata write and the last barrier: clear the
    take journal (a crash before this leaves valid metadata with a stale
    journal, which fsck calls committed and gc reclaims), the abort
    records and the leases."""
    if not is_journal_disabled():
        from .lifecycle import clear_journal

        clear_journal(storage, event_loop, getattr(storage, "clear_world_size", world_size))
    if abort_ctx.monitor is not None:
        abort_ctx.monitor.clear()
    if abort_ctx.lease is not None:
        abort_ctx.lease.cleanup(world_size)


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


class _TelemetryCommit:
    """Carries each rank's telemetry through the commit, as
    :class:`_LateChecksums` carries its checksums (tpusnap's
    ``_TelemetryCommit``):

    - ``persist`` (every rank, writes drained, before the commit
      barrier): freeze the recorder, write this rank's Chrome trace to
      ``.tpusnap/telemetry/rank_<k>.json`` through the take's storage,
      and publish its summary under a take-scoped KV key;
    - ``apply`` (after the barrier's arrive: every rank published): fold
      the cross-rank rollup into ``metadata.extras["telemetry"]``;
    - ``cleanup`` (rank 0, after the last barrier) and ``discard`` (abort)
      delete the keys.

    Best-effort throughout: telemetry never fails a take."""

    def __init__(
        self,
        tele: Optional["telemetry.TakeTelemetry"],
        comm: Communicator,
        take_id: Optional[str],
        progress=None,
    ) -> None:
        self.tele = tele
        self.comm = comm
        self.take_id = take_id
        self.progress = progress
        self._summary: Optional[Dict[str, Any]] = None

    def finish_progress(self, state: str = "committed") -> None:
        """The final heartbeat (100 % at commit), then the pump stops."""
        if self.progress is not None:
            try:
                self.progress.finish(state)
            except Exception:
                logger.debug("progress finish failed", exc_info=True)

    def _prefix(self) -> str:
        return f"tpusnap_tele/{self.take_id}/"

    def _key(self, rank: int) -> str:
        return f"{self._prefix()}{rank}"

    def _keys(self) -> List[str]:
        return [self._key(r) for r in range(self.comm.world_size)]

    def _active(self) -> bool:
        return self.comm.world_size > 1 and self.take_id is not None

    def persist(
        self,
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        abort_ctx: Optional[_TakeAbortContext] = None,
        prep_start: Optional[float] = None,
    ) -> None:
        if self.tele is None:
            return
        try:
            self.tele.finalize()
            if prep_start is not None:
                # The tail between the drain and this freeze, so that the
                # phases tile the persisted wall-clock.
                self.tele.record_span(
                    "commit_prep", prep_start,
                    max(self.tele.take_wall_s - prep_start, 0.0), phase=True,
                )
            self._summary = self.tele.summary()
        except Exception:
            logger.warning("Telemetry summary failed (non-fatal)", exc_info=True)
            return
        if self.tele.enabled:
            trace_path = telemetry.telemetry_rank_path(self.tele.rank)
            if abort_ctx is not None:
                abort_ctx.write_paths.append(trace_path)
            try:
                storage.sync_write(
                    WriteIO(path=trace_path, buf=self.tele.to_json().encode("utf-8")),
                    event_loop,
                )
            except Exception:
                logger.warning(
                    "Failed to persist telemetry trace %r (non-fatal)", trace_path,
                    exc_info=True,
                )
        if self._active():
            import pickle

            try:
                _get_kv_store(self.comm).set(
                    self._key(self.comm.rank), pickle.dumps(self._summary)
                )
            except Exception:
                logger.warning("Failed to publish telemetry summary (non-fatal)", exc_info=True)

    def apply(self, metadata: SnapshotMetadata) -> bool:
        """Fold the rollup into this rank's metadata copy. A non-leader
        whose KV read came back incomplete returns False without folding
        (its caller then reads the committed file)."""
        if self.tele is None:
            return True
        summaries = []
        if self._active():
            import pickle

            try:
                blobs = _get_kv_store(self.comm).try_get_dir(self._prefix(), keys=self._keys())
                for _, raw in sorted((blobs or {}).items()):
                    try:
                        summaries.append(pickle.loads(raw))
                    except Exception:
                        pass
            except Exception:
                summaries = []
            if self.comm.rank != 0 and len(summaries) < self.comm.world_size:
                return False
        if not summaries and self._summary is not None:
            summaries = [self._summary]
        try:
            rollup = telemetry.rollup_summaries(summaries)
        except Exception:
            logger.warning("Telemetry rollup failed (non-fatal)", exc_info=True)
            return self.comm.rank == 0
        if rollup:
            metadata.extras = dict(metadata.extras or {})
            metadata.extras["telemetry"] = rollup
        return True

    def cleanup(self) -> None:
        if self._active():
            try:
                _get_kv_store(self.comm).delete_prefix(self._prefix(), keys=self._keys())
            except Exception:
                logger.debug("telemetry KV cleanup failed (non-fatal)", exc_info=True)

    def discard(self) -> None:
        if self._active():
            key = self._key(self.comm.rank)
            try:
                _get_kv_store(self.comm).delete_prefix(key, keys=[key])
            except Exception:
                pass


# ----------------------------------------------------- degraded commit


class _PrestagedStager(BufferStager):
    """A write request's bytes staged at the call of an async take (a
    unit the rank may have to adopt): stages the held buffer."""

    frozen = True

    def __init__(self, buf, cost: int, planned: int) -> None:
        self._buf = buf
        self._cost = cost
        self._planned = planned

    async def stage_buffer(self, executor=None):
        buf, self._buf = self._buf, None
        return buf

    def get_staging_cost_bytes(self) -> int:
        return self._cost

    def get_planned_bytes(self) -> int:
        return self._planned


def _freeze_for_adoption(
    dropped: Dict[str, List], event_loop: asyncio.AbstractEventLoop
) -> None:
    """Make the replicated units this rank may adopt independent of the
    caller's in-place updates after an async take returns: CUDA sources
    are copied on the card (``freeze_device_sources``), as the rank's own
    are; what cannot be (CPU tensors, objects, no room on the card) is
    staged now into host memory the take owns (clones, not COW views)."""
    reqs = [wr for unit in sorted(dropped) for wr in dropped[unit]]
    if not reqs:
        return
    for wr in reqs:
        if hasattr(wr.buffer_stager, "force_clone"):
            wr.buffer_stager.force_clone = True
    freeze_device_sources([wr.buffer_stager for wr in reqs])
    for wr in reqs:
        st = wr.buffer_stager
        if st.frozen:
            continue
        buf = run_on_loop(event_loop, st.stage_buffer(None))
        wr.buffer_stager = _PrestagedStager(
            buf, st.get_staging_cost_bytes(), st.get_planned_bytes()
        )


class _DegradeContext:
    """What the survivors of a rank failure need to finish a replicated-
    only take without it: this rank's manifest entries (annotated once
    its writes drain), the partition plan, and this rank's unstaged (or,
    for an async take, frozen) requests for the replicated units assigned
    to other ranks, the same bytes on every rank."""

    def __init__(
        self,
        comm: Communicator,
        take_id: str,
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        entries: Manifest,
        dropped_replicated: Dict[str, List],
        assignment: Dict[str, int],
        memory_budget: int,
        pending_io_work: PendingIOWork,
        extras: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.comm = comm
        self.extras = extras
        self.take_id = take_id
        self.storage = storage
        self.event_loop = event_loop
        self.entries = entries
        self.dropped_replicated = dropped_replicated
        self.assignment = assignment
        self.memory_budget = memory_budget
        self.pending_io_work = pending_io_work


def _degrade_eligible(per_rank_entries: List[Manifest]) -> Optional[str]:
    """None when every survivor's leaf entries are replicated (then the
    dead rank's bytes exist on every survivor); otherwise why the take
    cannot degrade: a sharded or per-rank entry means the dead rank held
    unique state."""
    from .manifest import PrimitiveEntry

    for entries in per_rank_entries:
        for path, entry in entries.items():
            if is_container_entry(entry) or is_replicated(entry):
                continue
            if isinstance(entry, PrimitiveEntry):
                return (
                    f"{path!r} is a per-rank primitive (not replicated-glob-"
                    "marked); the dead rank's value is unknowable"
                )
            return f"{path!r} is {type(entry).__name__}: the dead rank held unique state"
    return None


def _degraded_prefix(take_id: str) -> str:
    return f"tpusnap_degraded/{take_id}"


def _maybe_degraded_commit(
    abort_ctx: Optional[_TakeAbortContext], exc: RankFailedError
) -> Optional[SnapshotMetadata]:
    """The commit paths' ``except RankFailedError``: the degraded metadata
    when the policy is ``degrade`` and the recovery context is armed,
    None otherwise. Raises when the degraded commit was tried and could
    not complete; the caller then aborts to a torn directory."""
    if (
        abort_ctx is None
        or abort_ctx.degrade is None
        or abort_ctx.liveness is None
        or get_rank_failure_policy() != "degrade"
    ):
        return None
    return _degraded_commit(abort_ctx, exc)


def _degraded_commit(abort_ctx: _TakeAbortContext, exc: RankFailedError) -> SnapshotMetadata:
    """Complete a replicated-only take on the surviving ranks (tpusnap's
    protocol, KV and storage traffic only, legal on the async commit's
    thread):

    1. each survivor drains its writes, publishes its manifest entries and
       meets the others in a survivor-set ``LinearBarrier`` (the dead set
       excluded from the lease watcher);
    2. eligibility: every survivor leaf must be replicated, else raise
       (abort to torn);
    3. adoption: the dead ranks' units go round-robin to the survivors
       (``reassign_dead_units``); each adopter stages and writes its own
       copies (journaled as usual) and publishes the adopted entries;
    4. every survivor builds the same manifest, the smallest survivor
       commits it with ``extras["degraded"]``, a last barrier gates the
       journal and KV cleanup.

    A survivor whose view of the dead set differs waits in a barrier the
    others never join and aborts at its timeout: the degraded commit
    fails safe to torn, never to a wrong manifest."""
    import pickle

    ctx = abort_ctx.degrade
    liveness = abort_ctx.liveness
    comm, rank = ctx.comm, ctx.comm.rank
    dead = sorted(set(exc.ranks) | set(liveness.expired()))
    live = sorted(set(range(comm.world_size)) - set(dead))
    if rank not in live or not dead:
        raise exc
    leader = live[0]
    logger.warning(
        "tpusnap degraded commit: rank(s) %s died during take %s; %d survivor(s) "
        "completing it (leader: rank %d)",
        dead, ctx.take_id[:8], len(live), leader,
    )
    _flight.record("degraded_commit", op="start", dead_ranks=dead)
    kv = _get_kv_store(comm)
    prefix = _degraded_prefix(ctx.take_id)
    watchers = [liveness.watcher(exclude=set(dead))]
    if abort_ctx.monitor is not None:
        watchers.append(abort_ctx.monitor.check)

    def barrier(name: str) -> None:
        b = LinearBarrier(
            kv, f"{prefix}/{name}", rank, comm.world_size, ranks=live, watchers=watchers
        )
        b.arrive()
        b.depart()

    def gather(sub: str) -> Dict[int, bytes]:
        keys = [f"{prefix}/{sub}/{r}" for r in live]
        blobs = kv.try_get_dir(f"{prefix}/{sub}/", keys=keys) or {}
        out = {}
        for r, key in zip(live, keys):
            # The barrier proved the publish: a key missing from the dir
            # read gets a bounded per-key read, and an unreadable one
            # raises (fail safe to torn).
            out[r] = blobs[key] if key in blobs else kv.get(key, timeout_sec=120.0)
        return out

    # 1. This rank's entries carry their write-path checksums once its
    # writes have drained.
    if not ctx.pending_io_work.drained():
        ctx.pending_io_work.sync_complete(ctx.event_loop)
    kv.set(f"{prefix}/m/{rank}", pickle.dumps(ctx.entries))
    barrier("b1")
    per_rank: List[Manifest] = [{} for _ in range(comm.world_size)]
    for r, raw in gather("m").items():
        per_rank[r] = pickle.loads(raw)

    # 2. Eligibility, the same verdict on every survivor.
    reason = _degrade_eligible([per_rank[r] for r in live])
    if reason is not None:
        _flight.record("degraded_commit", op="refused", reason=reason)
        raise RankFailedError(
            dead, ctx.take_id, detail=f"degrade refused: {reason}; aborting to a torn state"
        ) from exc

    # 3. Adoption.
    adoption = reassign_dead_units(ctx.assignment, dead, live)
    my_units = sorted(u for u, w in adoption.items() if w == rank)
    my_reqs = [wr for u in my_units for wr in ctx.dropped_replicated.get(u, [])]
    adopted_bytes = 0
    if my_reqs:
        adopted_bytes = sum(wr.buffer_stager.get_planned_bytes() for wr in my_reqs)
        sync_execute_write_reqs(
            my_reqs, ctx.storage, ctx.memory_budget, ctx.event_loop, rank=rank
        ).sync_complete(ctx.event_loop)
    adopted_payload = {}
    for u in my_units:
        entry = ctx.entries.get(u.partition("::")[0])
        if entry is not None:
            adopted_payload[u] = entry
    kv.set(f"{prefix}/a/{rank}", pickle.dumps(adopted_payload))
    barrier("b2")

    # 4. The same degraded manifest on every survivor. Replicated entries
    # consolidate onto rank 0's tree; if rank 0 died, the leader's
    # (identical) manifest stands in for it.
    if 0 in dead:
        per_rank[0] = per_rank[leader]
    global_manifest = consolidate_replicated_entries(per_rank)
    n_adopted = 0
    for _r, raw in sorted(gather("a").items()):
        for unit, entry in sorted(pickle.loads(raw).items()):
            path, _, chunk = unit.partition("::")
            gkey = f"0/{path}"
            if gkey not in global_manifest:
                continue
            n_adopted += 1
            if chunk:
                # Chunk grain: only the dead writer's chunk is replaced.
                idx = int(chunk)
                cur = global_manifest[gkey]
                if hasattr(cur, "chunks") and idx < len(cur.chunks):
                    cur.chunks[idx] = entry.chunks[idx]
            else:
                # The dead writer's version may point into a slab it never
                # wrote: the adopter's entry describes the blob it wrote.
                global_manifest[gkey] = entry
    metadata = SnapshotMetadata(
        version=__version__,
        world_size=comm.world_size,
        manifest=global_manifest,
        created_at=time.time(),
        extras=dict(
            ctx.extras or {},
            degraded={
                "dead_ranks": dead,
                "live_ranks": live,
                "adopted_units": sorted(adoption),
                "adopters": {u: w for u, w in sorted(adoption.items())},
            },
        ),
    )
    telemetry.incr("degraded.adopted_bytes", adopted_bytes)
    telemetry.incr("degraded.adopted_units", len(my_units))
    if rank == leader:
        abort_ctx.mark_commit_started()
        _write_metadata(ctx.storage, metadata, ctx.event_loop)
    barrier("b3")
    if rank == leader:
        _finish_commit(ctx.storage, ctx.event_loop, abort_ctx, comm.world_size)
        # The normal commit's cleanup never ran: sweep the take's KV
        # transports and the degraded protocol's own keys.
        ws = range(comm.world_size)
        for p, keys in (
            (prefix + "/", [f"{prefix}/{s}/{r}" for s in ("m", "a") for r in ws]),
            (f"tpusnap_late_cs/{ctx.take_id}/", [f"tpusnap_late_cs/{ctx.take_id}/{r}" for r in ws]),
            (f"tpusnap_tele/{ctx.take_id}/", [f"tpusnap_tele/{ctx.take_id}/{r}" for r in ws]),
        ):
            try:
                kv.delete_prefix(p, keys=keys)
            except Exception:
                logger.debug("degraded KV cleanup failed", exc_info=True)
    _flight.record("degraded_commit", op="committed", dead_ranks=dead, adopted=n_adopted)
    logger.warning(
        "tpusnap degraded commit: take %s committed by %d survivor(s); rank(s) %s's "
        "%d replicated unit(s) adopted (%d bytes by rank %d)",
        ctx.take_id[:8], len(live), dead, n_adopted, adopted_bytes, rank,
    )
    return metadata


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
    # Tier URLs do not parse as URLs (the scheme embeds a path): the
    # relative reference is computed between the local tier directories,
    # and the mirror layout makes it hold in the remote tier too.
    from .tiering import parse_tier_url

    try:
        spec = parse_tier_url(base_path)
        if spec is not None:
            base_path = spec.local_dir
        spec = parse_tier_url(new_path)
        if spec is not None:
            new_path = spec.local_dir
    except ValueError:
        pass  # malformed tier URL: the plain-path error below names it
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
    mark: Optional["telemetry.PhaseMarker"] = None,
    rank: int = 0,
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
    read_reqs = batch_read_requests(read_reqs)
    if mark is not None:
        mark("restore.prepare", reqs=len(read_reqs))
    sync_execute_read_reqs(read_reqs, storage, memory_budget, event_loop, rank=rank)
    if mark is not None:
        mark("restore.read", reqs=len(read_reqs))
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
    mark: Optional["telemetry.PhaseMarker"] = None,
) -> None:
    local_manifest = _key_manifest(get_manifest_for_rank(metadata, rank), key)
    if not local_manifest:
        logger.warning("No entries for key %r in snapshot; skipping", key)
        return
    # The current state_dict provides the restore targets (device
    # placement, DTensor placements, in-place destinations).
    _, target_flattened = flatten(stateful.state_dict(), prefix=key)
    handle_sharded_elasticity(local_manifest, target_flattened)
    if mark is not None:
        mark("restore.targets", key=key)
    restored = _read_and_inflate(
        key, local_manifest, target_flattened, storage, memory_budget, event_loop, mark=mark,
        rank=rank,
    )
    stateful.load_state_dict(restored)
    if mark is not None:
        mark("restore.load", key=key)


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
        tele_commit: Optional[_TelemetryCommit] = None,
    ) -> None:
        self.path = path
        self._tele_commit = tele_commit
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
        progress = tele_commit.progress if tele_commit is not None else None
        if progress is not None:
            # The commit waits in the LinearBarrier now: the stall
            # watchdog names the ranks missing from it.
            progress.add_attribution(self._barrier.current_missing)
        self._tele = tele_commit.tele if tele_commit is not None else None
        if self._tele is not None:
            # The blocked window, recorded before the drain thread starts;
            # the recorder's process-global slot is released for a newer
            # take (the drain records through a thread-local overlay).
            blocked_s = self._tele.now()
            self._tele.meta["async_blocked_s"] = round(blocked_s, 6)
            self._tele.record_span("async_blocked", 0.0, blocked_s)
            telemetry.release_global(self._tele)
        self._start()

    def _body(self) -> None:
        # A peer's death surfaces from the barrier waits as
        # RankFailedError. Under TPUSNAP_RANK_FAILURE=degrade the
        # survivors complete the take from the units they froze at the
        # call; a refused or failed degrade re-raises into the abort path
        # (torn, salvageable).
        with telemetry.use(self._tele):
            try:
                self._body_impl()
            except RankFailedError as rank_exc:
                degraded = _maybe_degraded_commit(self._abort_ctx, rank_exc)
                if degraded is None:
                    raise
                self._commit_degraded(degraded)

    def _commit_degraded(self, metadata: SnapshotMetadata) -> None:
        self._metadata = metadata
        try:
            self._comm.gc_consumed_keys(self._gc_epoch)
        except Exception:
            logger.debug("store gc after the degraded commit failed", exc_info=True)
        if self._tele is not None:
            self._tele.meta["completed"] = True
        _record_slo_commit(
            self._tele, metadata, self._abort_ctx.degrade.take_id, self.path, self._comm.rank
        )
        if self._tele_commit is not None:
            self._tele_commit.finish_progress()
        _flight.recorder().end_take("committed")
        snapshot = Snapshot(self.path, self._storage_options, self._comm)
        snapshot._metadata = metadata  # every survivor built the same one
        self._snapshot = snapshot

    def _body_impl(self) -> None:
        tele = self._tele
        drain_start = tele.now() if tele is not None else 0.0
        self._pending_io_work.sync_complete(self._event_loop)
        if tele is not None:
            tele.record_span("io_drain", drain_start, tele.now() - drain_start, phase=True)
        prep_start = tele.now() if tele is not None else None
        if is_durable_commit_enabled():
            # As in the sync take: this rank's dirents before the barrier.
            self._storage.sync_flush_created_dirs(self._event_loop)
        if self._late_checksums is not None:
            self._late_checksums.publish()
        if self._tele_commit is not None:
            self._tele_commit.persist(
                self._storage, self._event_loop, self._abort_ctx, prep_start
            )
        self._barrier.arrive()
        if self._comm.rank == 0:
            # Every rank arrived, so every rank published.
            if self._late_checksums is not None:
                self._late_checksums.apply(self._metadata.manifest)
            if self._tele_commit is not None:
                self._tele_commit.apply(self._metadata)
            self._abort_ctx.mark_commit_started()
            _write_metadata(self._storage, self._metadata, self._event_loop)
        self._barrier.depart()
        meta_cached = True
        if self._comm.rank != 0:
            try:
                if self._late_checksums is not None:
                    self._late_checksums.apply(self._metadata.manifest)
                if self._tele_commit is not None and not self._tele_commit.apply(
                    self._metadata
                ):
                    meta_cached = False
            except Exception:
                logger.warning(
                    "Non-leader late-checksum patch failed; the snapshot handle "
                    "reads the committed metadata instead",
                    exc_info=True,
                )
                meta_cached = False
        if self._post_barrier is not None:
            self._post_barrier.arrive()
            if self._comm.rank == 0:
                if self._late_checksums is not None:
                    self._late_checksums.cleanup()
                if self._tele_commit is not None:
                    self._tele_commit.cleanup()
            self._post_barrier.depart()
        if self._comm.rank == 0:
            _finish_commit(self._storage, self._event_loop, self._abort_ctx, self._comm.world_size)
        # Every rank departed, so every rank consumed the take's gathers
        # and the prefix broadcast: release their keys now (no further
        # barrier runs on this communicator for this take). Store deletes
        # only; bounded by the epoch taken at construction.
        try:
            self._comm.gc_consumed_keys(self._gc_epoch)
        except Exception:
            logger.debug("store gc after the async commit failed", exc_info=True)
        if tele is not None:
            tele.meta["completed"] = True
        _record_slo_commit(
            tele,
            self._metadata,
            self._tele_commit.take_id if self._tele_commit is not None else None,
            self.path,
            self._comm.rank,
        )
        if self._tele_commit is not None:
            self._tele_commit.finish_progress()
        _flight.recorder().end_take("committed")
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
        self._abort_ctx.stop_progress()
        try:
            self._storage.sync_close(self._event_loop)
        finally:
            self._event_loop.close()
            if self._tele is not None:
                telemetry.end_take(self._tele)

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
