"""Snapshot — the user-facing save/restore/random-access API.

Counterpart of tpusnap/snapshot.py (``Snapshot.take``, ``restore``,
``read_object`` and ``load_snapshot``) for one process. The steps and the
names of the functions carried over are tpusnap's:

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

Left out of this slice, each raising ``NotImplementedError`` when asked
for rather than being ignored (ROADMAP.md lists them): ``incremental_from``
and compression (A3), ``async_take``/``async_restore`` (A3), multi-process
communicators (A4), sharded/DTensor state (A5), tiering, CAS, cloud
storage and the delta stream (A8). tpusnap's journal, progress, flight,
SLO, telemetry and tuner hooks are observability the port adds later
(A9); a snapshot without them reads the same in either package.
"""

from __future__ import annotations

import asyncio
import fnmatch
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from .batcher import batch_read_requests, batch_write_requests
from .comm import Communicator, get_communicator
from .flatten import flatten, inflate
from .io_preparer import prepare_read, prepare_write
from .io_preparers.array import ArrayBufferStager
from .io_types import ReadIO, StoragePlugin, WriteIO
from .knobs import is_compression_forced
from .manifest import (
    Manifest,
    MetadataError,
    SnapshotMetadata,
    decode_metadata,
    encode_metadata,
    is_container_entry,
)
from .manifest_ops import get_manifest_for_rank
from .scheduler import (
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
        incremental_from: Optional[str] = None,
    ) -> "Snapshot":
        """Write every stateful in ``app_state`` to ``path``. CUDA tensors
        are copied through pinned host memory; the state captured is the
        state as of this call (device work already queued on the
        caller's stream included). ``replicated`` globs mark host values
        as replicated, as in tpusnap."""
        if incremental_from is not None:
            raise _not_ported("incremental_from", "A3")
        if is_compression_forced():
            raise _not_ported("TPUSNAP_COMPRESS compression", "A3")
        comm = get_communicator(comm)
        event_loop = asyncio.new_event_loop()
        try:
            metadata, storage = _take_impl(
                path, app_state, storage_options, comm, replicated or [], event_loop
            )
            try:
                comm.barrier()
                if comm.rank == 0:
                    _write_metadata(storage, metadata, event_loop)
                comm.barrier()
            finally:
                storage.sync_close(event_loop)
        finally:
            event_loop.close()
        snapshot = cls(path, storage_options, comm)
        snapshot._metadata = metadata
        return snapshot

    @classmethod
    def async_take(cls, *args, **kwargs) -> "Snapshot":
        raise _not_ported("async_take", "A3")

    @classmethod
    def stream(cls, *args, **kwargs):
        raise _not_ported("the delta stream", "A8")

    # --------------------------------------------------------------- restore

    def restore(self, app_state: AppState) -> None:
        """Restore every stateful in ``app_state`` from this snapshot, in
        place where the current ``state_dict()`` holds tensors of the
        stored shape. Returns after every device copy has completed."""
        comm = get_communicator(self._comm)
        _validate_app_state(app_state)
        with self._op_lock:
            event_loop, storage = self._resources()
            metadata = self._get_metadata(storage, event_loop)
            memory_budget = get_process_memory_budget_bytes()
            for key in sorted(app_state.keys()):
                _load_stateful(
                    stateful=app_state[key],
                    key=key,
                    metadata=metadata,
                    rank=comm.rank,
                    storage=storage,
                    memory_budget=memory_budget,
                    event_loop=event_loop,
                )

    def async_restore(self, app_state: AppState):
        raise _not_ported("async_restore", "A3")

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
            budget = memory_budget_bytes or get_process_memory_budget_bytes()
            sync_execute_read_reqs(read_reqs, storage, budget, event_loop)
            return fut.obj

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


def _take_impl(
    path: str,
    app_state: AppState,
    storage_options: Optional[Dict[str, Any]],
    comm: Communicator,
    replicated: List[str],
    event_loop: asyncio.AbstractEventLoop,
):
    """Flatten, prepare, batch and execute every write; returns the
    metadata to commit and the open storage plugin."""
    _validate_app_state(app_state)
    rank = comm.rank
    manifest: Manifest = {}
    flattened_all: Dict[str, Any] = {}
    for key in sorted(app_state.keys()):
        mft, flat = flatten(app_state[key].state_dict(), prefix=key)
        manifest.update(mft)
        flattened_all.update(flat)

    globs = sorted(set(replicated))
    replicated_paths = {
        p for p in flattened_all if any(fnmatch.fnmatch(p, g) for g in globs)
    }

    storage = url_to_storage_plugin_in_event_loop(path, event_loop, storage_options)
    try:
        entries: Manifest = dict(manifest)
        write_reqs = []
        for logical_path, leaf in flattened_all.items():
            entry, reqs = prepare_write(
                obj=leaf,
                logical_path=logical_path,
                rank=rank,
                replicated=logical_path in replicated_paths,
            )
            entries[logical_path] = entry
            write_reqs.extend(reqs)

        entries_list, write_reqs = batch_write_requests(
            list(entries.values()), write_reqs
        )
        entries = dict(zip(entries.keys(), entries_list))
        # Standalone tensor blobs hash on the write path, overlapping other
        # requests' disk time; slab members hash inside their slab's
        # staging. The entry objects are the manifest's, so the late
        # values land before the metadata is encoded.
        for wr in write_reqs:
            if isinstance(wr.buffer_stager, ArrayBufferStager):
                wr.buffer_stager.defer_checksums = True

        sync_execute_write_reqs(
            write_reqs, storage, get_process_memory_budget_bytes(), event_loop
        )
    except BaseException:
        storage.sync_close(event_loop)
        raise
    metadata = SnapshotMetadata(
        version=__version__,
        world_size=comm.world_size,
        manifest=_gather_manifest(entries, comm),
        created_at=time.time(),
    )
    return metadata, storage


def _gather_manifest(entries: Manifest, comm: Communicator) -> Manifest:
    """Key every rank's entries by ``rank/logical_path`` (one rank here)."""
    return {
        f"{rank}/{logical_path}": entry
        for rank, per_rank in enumerate(comm.all_gather_object(entries))
        for logical_path, entry in per_rank.items()
    }


def _write_metadata(
    storage: StoragePlugin,
    metadata: SnapshotMetadata,
    event_loop: asyncio.AbstractEventLoop,
) -> None:
    # Atomic (temp + rename): a crash mid-write must not leave a torn
    # metadata file. Self-checksummed, as tpusnap writes it.
    storage.sync_write_atomic(
        WriteIO(path=SNAPSHOT_METADATA_FNAME, buf=encode_metadata(metadata)),
        event_loop,
    )


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
    # placement, in-place destinations).
    _, target_flattened = flatten(stateful.state_dict(), prefix=key)
    restored = _read_and_inflate(
        key, local_manifest, target_flattened, storage, memory_budget, event_loop
    )
    stateful.load_state_dict(restored)
