"""Metadata collectives over a ``torch.distributed`` store.

Counterpart of tpusnap/comm.py. tpusnap runs its small-object
collectives (``all_gather_object``, ``broadcast_object``, ``barrier``)
over the JAX coordination service's KV store; the port runs them over the
c10d store that ``init_process_group`` brings up (a TCPStore), the
mechanism PyTorch's own rendezvous uses:

- it exists in every ``torchrun``/``init_process_group`` job, whatever
  the backend, so no device collective is needed (two ranks sharing one
  GPU cannot run NCCL at all);
- it is usable from background threads, where device collectives are
  forbidden;
- manifests, globs and write loads are KB-scale.

``get_communicator()`` detects the environment: an explicit communicator
wins; an initialised default process group of more than one rank gives a
``StoreComm`` over that group's store; otherwise the single-process
no-op ``Communicator``. ``StoreComm(store, rank, world_size)`` is the
explicit form.

Sequencing: keys are namespaced per communicator instance (assigned
lazily at the first collective from a process-global counter: ranks issue
their first collective on instances in the same order, while
collective-free construction on a subset of ranks stays free) and
sequenced per instance, so two interleaved communicators never cross-wire
keys. Within one instance, ranks run the same collectives in the same
order, as with any collective backend.

Scalability: ``all_gather_object`` is one set, one barrier and one
``multi_get`` of the ``world_size`` keys: O(1) RPCs per rank whatever the
world size. ``broadcast_object`` is one set on the source and a wait and
a get elsewhere, with no barrier. Consumed keys are deleted lazily: rank 0
deletes a collective's keys only after a later barrier proves that every
rank has moved past it (TCPStore cannot delete a prefix, so the keys are
listed).

Waits poll with a short backoff and never block inside the store: a
TCPStore client runs one operation at a time under a lock, so a blocking
``wait`` on the main thread would stall an async commit polling the same
store from its thread. The deadline of every wait is
``TPUSNAP_BARRIER_TIMEOUT_S``, which is also set as the store's timeout.
"""

from __future__ import annotations

import datetime
import logging
import pickle
import re
import threading
import time
from typing import Any, List, Optional

logger = logging.getLogger(__name__)

# Backoff of every polling wait: the first polls come quickly (a barrier
# among ranks that arrive together ends in a fraction of a millisecond),
# later ones at most every _MAX_POLL_SEC.
_FIRST_POLL_SEC = 0.0002
_MAX_POLL_SEC = 0.01


def _default_timeout_ms() -> int:
    from .knobs import get_barrier_timeout_s

    return int(get_barrier_timeout_s() * 1000.0)


class Communicator:
    """Uniform interface; this base class is the single-process no-op
    implementation."""

    @property
    def rank(self) -> int:
        return 0

    @property
    def world_size(self) -> int:
        return 1

    def barrier(self) -> None:
        return None

    def all_gather_object(self, obj: Any) -> List[Any]:
        return [obj]

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        return obj

    def gc_epoch(self) -> int:
        """Marker for ``gc_consumed_keys``: keys pending deletion as of now."""
        return 0

    def gc_consumed_keys(self, epoch: Optional[int] = None) -> None:
        """Delete the keys of fully consumed collectives: the first
        ``epoch`` pending ones (from an earlier ``gc_epoch()``), or all
        when None. The caller holds proof that every rank consumed them
        (all ranks departed a ``LinearBarrier`` issued after the
        collective): the async commit uses this, since it issues no
        further barrier on the communicator. Pure store deletes: safe from
        any thread."""
        return None

    def set_wait_watcher(self, watcher) -> None:
        """Install a callable run inside every collective wait; it may
        raise to end the wait early (take-abort propagation). While it is
        installed, barriers use arrive keys (``barrier_missing_ranks``).
        All ranks install and clear it at the same point of their
        collective program."""
        return None

    def clear_wait_watcher(self) -> None:
        return None

    def barrier_missing_ranks(self) -> Optional[List[int]]:
        """While this process waits in a barrier with a watcher installed,
        the sorted ranks whose arrive keys are absent. None otherwise."""
        return None


_instance_count = 0
_instance_lock = threading.Lock()


def _next_instance() -> int:
    global _instance_count
    with _instance_lock:
        _instance_count += 1
        return _instance_count


class StoreComm(Communicator):
    """Collectives for multi-process jobs over a ``torch.distributed.Store``
    shared by ``world_size`` processes (``rank`` is this one's)."""

    def __init__(
        self,
        store,
        rank: int,
        world_size: int,
        timeout_ms: Optional[int] = None,
        namespace: Optional[str] = None,
    ) -> None:
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} is outside a world of {world_size}")
        self._store = store
        self._rank = rank
        self._world_size = world_size
        self._timeout_ms = timeout_ms if timeout_ms is not None else _default_timeout_ms()
        store.set_timeout(datetime.timedelta(milliseconds=self._timeout_ms))
        # Explicit namespaces live under "u/" with unsafe characters
        # escaped, so they never collide with an auto namespace ("i<N>").
        self._ns: Optional[str] = (
            f"tpusnap/u/{_sanitize_ns(namespace)}" if namespace is not None else None
        )
        self._seq = 0
        # Keys fully consumed on this rank, deletable (by rank 0) once a
        # later barrier proves every rank has moved past them. Locked: the
        # async commit flushes from its thread while the main thread may
        # append for a newer take.
        self._gc_pending: List[List[str]] = []
        self._gc_lock = threading.Lock()
        self._wait_watcher = None
        # The polling barrier's key prefix while this rank waits in it
        # (barrier_missing_ranks reads it from another thread).
        self._live_wait: Optional[str] = None

    @classmethod
    def from_default_group(cls) -> "StoreComm":
        """Over the store of the initialised default process group."""
        import torch.distributed as dist

        return cls(_default_group_store(), dist.get_rank(), dist.get_world_size())

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world_size

    @property
    def store(self):
        return self._store

    def _namespace(self) -> str:
        if self._ns is None:
            self._ns = f"tpusnap/i{_next_instance()}"
        return self._ns

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _deadline(self) -> float:
        return time.monotonic() + self._timeout_ms / 1000.0

    def _wait_key(self, key: str, deadline: float) -> None:
        """Poll until ``key`` exists, running the wait watcher (which may
        raise) on every poll."""
        delay = _FIRST_POLL_SEC
        while True:
            watcher = self._wait_watcher
            if watcher is not None:
                watcher()
            if self._store.check([key]):
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"Timed out waiting for store key {key!r}")
            time.sleep(delay)
            delay = min(2 * delay, _MAX_POLL_SEC)

    def _flush_gc(self, upto: Optional[int] = None) -> None:
        """Delete pending keys whose consumption has been proved global:
        the first ``upto`` groups, or all when None."""
        with self._gc_lock:
            if upto is None:
                flush, self._gc_pending = self._gc_pending, []
            else:
                flush = self._gc_pending[:upto]
                self._gc_pending = self._gc_pending[upto:]
        if self._rank != 0:
            return
        for keys in flush:
            for key in keys:
                try:
                    self._store.delete_key(key)
                except Exception:
                    # A leaked key costs store memory, not correctness.
                    logger.debug("store gc delete of %r failed", key, exc_info=True)

    def _defer_gc(self, keys: List[str]) -> None:
        with self._gc_lock:
            self._gc_pending.append(keys)

    def set_wait_watcher(self, watcher) -> None:
        self._wait_watcher = watcher

    def clear_wait_watcher(self) -> None:
        self._wait_watcher = None

    def barrier(self) -> None:
        seq = self._next_seq()
        prefix = f"{self._namespace()}/b{seq}"
        deadline = self._deadline()
        if self._wait_watcher is not None:
            keys = self._polling_barrier(prefix, deadline)
        else:
            # Counter barrier: one add per rank; the last to arrive sets
            # the depart key the others wait for.
            keys = [f"{prefix}/n", f"{prefix}/d"]
            if self._store.add(keys[0], 1) == self._world_size:
                self._store.set(keys[1], b"1")
            else:
                self._wait_key(keys[1], deadline)
        # Every rank has passed every earlier collective: their keys can
        # go. This barrier's own keys may still be polled by a slow rank,
        # so they wait for the next barrier.
        self._flush_gc()
        self._defer_gc(keys)

    def _polling_barrier(self, prefix: str, deadline: float) -> List[str]:
        """Arrive keys and a depart key: every rank sets its arrive key;
        rank 0 waits for all of them and sets the depart key; the others
        wait for it. Returns the keys for deferred deletion."""
        arrive = [f"{prefix}/a/{r}" for r in range(self._world_size)]
        depart = f"{prefix}/d"
        self._store.set(arrive[self._rank], b"1")
        self._live_wait = prefix
        try:
            if self._rank == 0:
                for key in arrive[1:]:
                    self._wait_key(key, deadline)
                self._store.set(depart, b"1")
            else:
                self._wait_key(depart, deadline)
        finally:
            self._live_wait = None
        return arrive + [depart]

    def barrier_missing_ranks(self) -> Optional[List[int]]:
        prefix = self._live_wait
        if prefix is None:
            return None
        try:
            missing = [
                r
                for r in range(self._world_size)
                if not self._store.check([f"{prefix}/a/{r}"])
            ]
        except Exception:
            return None
        if not missing:
            # Everyone arrived but this rank still waits: the depart key,
            # which rank 0 owns.
            return [0] if self._rank != 0 else None
        return missing

    def gc_epoch(self) -> int:
        with self._gc_lock:
            return len(self._gc_pending)

    def gc_consumed_keys(self, epoch: Optional[int] = None) -> None:
        self._flush_gc(upto=epoch)

    def all_gather_object(self, obj: Any) -> List[Any]:
        """One set, one barrier, one ``multi_get``: O(1) RPCs per rank."""
        seq = self._next_seq()
        prefix = f"{self._namespace()}/ag{seq}"
        keys = [f"{prefix}/{r}" for r in range(self._world_size)]
        self._store.set(keys[self._rank], pickle.dumps(obj))
        # The barrier guarantees every rank's key is written.
        self.barrier()
        values = self._store.multi_get(keys)
        self._defer_gc(keys)
        return [pickle.loads(bytes(v)) for v in values]

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """One set on ``src``, one wait and get elsewhere; no barrier. The
        key is deleted after a later barrier proves it was consumed."""
        seq = self._next_seq()
        key = f"{self._namespace()}/bc{seq}"
        if self._rank == src:
            self._store.set(key, pickle.dumps(obj))
            result = obj
        else:
            self._wait_key(key, self._deadline())
            result = pickle.loads(bytes(self._store.get(key)))
        if self._rank == 0:
            self._defer_gc([key])
        return result


def _sanitize_ns(ns: str) -> str:
    """Escape everything outside [A-Za-z0-9_-]."""
    return re.sub(r"[^A-Za-z0-9_-]", lambda m: f"%{ord(m.group(0)):02x}", ns)


# One client connection per default process group: the group's store is
# cloned (where the store can be) so that the timeout set on it, and the
# client lock every operation takes, stay the port's own.
_default_store_clone: Optional[tuple] = None
_default_store_lock = threading.Lock()


def _default_group_store():
    global _default_store_clone
    from torch.distributed import distributed_c10d

    store = distributed_c10d._get_default_store()
    with _default_store_lock:
        if _default_store_clone is None or _default_store_clone[0] is not store:
            clone = store.clone() if hasattr(store, "clone") else store
            _default_store_clone = (store, clone)
        return _default_store_clone[1]


def get_communicator(comm: Optional[Communicator] = None) -> Communicator:
    """The given communicator; else a ``StoreComm`` over the default
    process group's store when ``torch.distributed`` is initialised with
    more than one rank; else the single-process ``Communicator``."""
    if comm is not None:
        return comm
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return StoreComm.from_default_group()
    return Communicator()
