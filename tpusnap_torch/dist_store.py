"""KV stores and ``LinearBarrier`` for coordination off the main thread.

Counterpart of tpusnap/dist_store.py. The async commit runs on a
background thread, where collectives are forbidden, so it synchronizes
through a KV store instead:

- ``TCPStoreKVStore`` — a ``torch.distributed.Store`` (the TCPStore that
  ``init_process_group`` brings up, under a ``PrefixStore``), in place of
  tpusnap's ``CoordinationKVStore``.
- ``FileKVStore`` — a shared-filesystem store for single-host
  multi-process use.
- ``MemoryKVStore`` — one process.
- ``LinearBarrier`` — the two-phase (arrive/depart) barrier with error
  propagation: any rank can ``report_error``; every waiter then re-raises
  it, which is how a failed async take aborts the metadata commit on all
  ranks.
- ``TakeAbortMonitor`` — a failed rank's abort record, which every other
  rank's waits check for.

Every wait here polls (``try_get`` in a loop, running the watchers each
time): a ``TCPStore`` client serializes its operations under one lock,
and its blocking ``get``/``wait`` would hold that lock, stalling every
other thread of the process on the same store until its timeout.
"""

from __future__ import annotations

import abc
import logging
import os
import pickle
import tempfile
import time
from typing import Callable, Dict, Iterable, List, Optional

logger = logging.getLogger(__name__)

_POLL_INTERVAL_SEC = 0.05


def _default_timeout_sec() -> float:
    from .knobs import get_barrier_timeout_s

    return get_barrier_timeout_s()


class KVStore(abc.ABC):
    @abc.abstractmethod
    def set(self, key: str, value: bytes) -> None: ...

    @abc.abstractmethod
    def try_get(self, key: str) -> Optional[bytes]: ...

    def try_get_dir(
        self, prefix: str, keys: Optional[Iterable[str]] = None
    ) -> Optional[Dict[str, bytes]]:
        """The (key, value) pairs under ``prefix`` in one call where the
        backend can, else None (the caller falls back to per-key gets).
        ``keys`` names the keys the caller knows may exist under the
        prefix, for backends that cannot list (TCPStore); backends that
        can list ignore it. Keys in the result are relative to the store,
        like the keys passed to ``set``."""
        return None

    def delete_prefix(self, prefix: str, keys: Optional[Iterable[str]] = None) -> None:
        """Best-effort deletion of every key under ``prefix`` (of the
        given ``keys`` under it, on a backend that cannot list)."""

    def get(self, key: str, timeout_sec: Optional[float] = None) -> bytes:
        if timeout_sec is None:
            timeout_sec = _default_timeout_sec()
        deadline = time.monotonic() + timeout_sec
        while True:
            value = self.try_get(key)
            if value is not None:
                return value
            if time.monotonic() > deadline:
                raise TimeoutError(f"Timed out waiting for key {key!r}")
            time.sleep(_POLL_INTERVAL_SEC)


class TCPStoreKVStore(KVStore):
    """Backed by a ``torch.distributed.Store`` (a TCPStore, possibly under
    PrefixStores), with this store's keys under ``prefix``.

    - ``set`` overwrites, as tpusnap's store does since its lease and
      membership records rewrite one key.
    - ``try_get`` never blocks: ``check`` before ``get`` (TCPStore's
      ``get`` waits for a missing key until the store's timeout).
    - ``try_get_dir`` needs the caller's ``keys`` (TCPStore cannot list a
      prefix): one ``check`` and one ``multi_get`` when all are present,
      else one ``check`` per key and a ``multi_get`` of those present.
    - ``delete_prefix`` deletes the caller's ``keys`` under the prefix
      (TCPStore has no prefix delete); every caller knows the keys its
      protocol set."""

    def __init__(self, store, prefix: str = "tpusnap_store") -> None:
        import torch.distributed as dist

        self._store = dist.PrefixStore(prefix, store)

    def set(self, key: str, value: bytes) -> None:
        self._store.set(key, value)

    def try_get(self, key: str) -> Optional[bytes]:
        if not self._store.check([key]):
            return None
        return bytes(self._store.get(key))

    def try_get_dir(
        self, prefix: str, keys: Optional[Iterable[str]] = None
    ) -> Optional[Dict[str, bytes]]:
        if keys is None:
            return None
        keys = [k for k in keys if k.startswith(prefix)]
        if not keys:
            return {}
        if not self._store.check(keys):
            keys = [k for k in keys if self._store.check([k])]
            if not keys:
                return {}
        return {k: bytes(v) for k, v in zip(keys, self._store.multi_get(keys))}

    def delete_prefix(self, prefix: str, keys: Optional[Iterable[str]] = None) -> None:
        for key in [k for k in keys or () if k.startswith(prefix)]:
            try:
                self._store.delete_key(key)
            except Exception:
                # Best-effort cleanup; a leaked key costs store memory only.
                logger.debug("KV delete of %r failed", key, exc_info=True)


class FileKVStore(KVStore):
    """Directory-backed store; atomic via rename. Works wherever ranks
    share a filesystem (the snapshot destination itself included)."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "%2F"))

    def set(self, key: str, value: bytes) -> None:
        path = self._path(key)
        fd, tmp = tempfile.mkstemp(dir=self.root)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(value)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def try_get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def try_get_dir(
        self, prefix: str, keys: Optional[Iterable[str]] = None
    ) -> Optional[Dict[str, bytes]]:
        enc = prefix.replace("/", "%2F")
        out = {}
        for name in os.listdir(self.root):
            if name.startswith(enc):
                try:
                    with open(os.path.join(self.root, name), "rb") as f:
                        out[name.replace("%2F", "/")] = f.read()
                except FileNotFoundError:
                    continue  # deleted between the listing and the read
        return out

    def delete_prefix(self, prefix: str, keys: Optional[Iterable[str]] = None) -> None:
        enc = prefix.replace("/", "%2F")
        for name in os.listdir(self.root):
            if name.startswith(enc):
                try:
                    os.unlink(os.path.join(self.root, name))
                except OSError:
                    pass


class MemoryKVStore(KVStore):
    """In-process store for single-process operation and unit tests."""

    def __init__(self) -> None:
        self._data: Dict[str, bytes] = {}

    def set(self, key: str, value: bytes) -> None:
        self._data[key] = value

    def try_get(self, key: str) -> Optional[bytes]:
        return self._data.get(key)

    def try_get_dir(
        self, prefix: str, keys: Optional[Iterable[str]] = None
    ) -> Optional[Dict[str, bytes]]:
        return {k: v for k, v in list(self._data.items()) if k.startswith(prefix)}

    def delete_prefix(self, prefix: str, keys: Optional[Iterable[str]] = None) -> None:
        for k in [k for k in self._data if k.startswith(prefix)]:
            del self._data[k]


class LinearBarrierError(RuntimeError):
    pass


class TakeAbortedError(RuntimeError):
    """Another rank's take failed: its abort record was published through
    the KV store, and this rank's barrier or commit wait raised within
    seconds instead of running out the barrier timeout. The path is
    reusable: no ``.snapshot_metadata`` was written, and each rank
    deleted the blobs it staged (best effort)."""


class TakeAbortMonitor:
    """Distributed take-abort propagation over a KV store.

    When a rank's take fails it ``publish``es an abort record under a
    take-scoped prefix; every other rank's waits (polling commit
    barriers, the background commit's ``LinearBarrier``) run ``check`` as
    a watcher and raise :class:`TakeAbortedError` within
    ``check_interval_sec`` plus one poll interval. Records stay behind on
    abort (take-scoped, a few bytes; the next take has a fresh take_id)
    and are deleted on a successful commit."""

    _PREFIX = "tpusnap_abort"

    def __init__(
        self,
        store: KVStore,
        take_id: str,
        rank: int,
        world_size: int,
        check_interval_sec: float = 0.25,
    ) -> None:
        self._store = store
        self.take_id = take_id
        self.rank = rank
        self.world_size = world_size
        self._interval = check_interval_sec
        self._last_check = 0.0
        self._published = False

    def _prefix(self) -> str:
        return f"{self._PREFIX}/{self.take_id}/"

    def _keys(self) -> List[str]:
        prefix = self._prefix()
        return [f"{prefix}r{r}" for r in range(self.world_size)] + [
            f"{prefix}commit_started"
        ]

    def publish(self, exc: BaseException) -> None:
        """Record this rank's failure for every peer to observe."""
        if self._published:
            return
        self._published = True
        try:
            payload = pickle.dumps(exc)
        except Exception:
            payload = pickle.dumps(RuntimeError(repr(exc)))
        try:
            self._store.set(f"{self._prefix()}r{self.rank}", payload)
        except Exception:
            logger.warning(
                "Failed to publish take-abort record for take %s",
                self.take_id,
                exc_info=True,
            )

    def mark_commit_started(self) -> None:
        """Set by the committing rank right before the metadata write.
        Aborting ranks consult it: once the commit may exist, staged blobs
        must not be deleted (orphan blobs are safe, dangling references
        are not)."""
        try:
            self._store.set(f"{self._prefix()}commit_started", b"1")
        except Exception:
            # Peers then fall back to commit_may_have_started's
            # conservative True and keep their staged blobs.
            logger.debug(
                "commit_started flag publish failed for take %s",
                self.take_id,
                exc_info=True,
            )

    def commit_may_have_started(self) -> bool:
        try:
            return self._store.try_get(f"{self._prefix()}commit_started") is not None
        except Exception:
            return True  # unknown: keep the blobs

    def check(self, force: bool = False) -> None:
        """Raise :class:`TakeAbortedError` if any rank published an abort
        record. Throttled to ``check_interval_sec`` unless forced."""
        now = time.monotonic()
        if not force and now - self._last_check < self._interval:
            return
        self._last_check = now
        prefix = self._prefix()
        try:
            records = self._store.try_get_dir(prefix, keys=self._keys())
        except Exception:
            return
        if not records:
            return
        aborts = sorted(
            (k[len(prefix) :], v)
            for k, v in records.items()
            if k.startswith(prefix) and k[len(prefix) :].startswith("r")
        )
        if not aborts:
            return
        rank_key, payload = aborts[0]
        try:
            cause: Optional[BaseException] = pickle.loads(payload)
        except Exception:
            cause = None
        err = TakeAbortedError(
            f"take {self.take_id} aborted by rank {rank_key[1:]}: {cause!r}"
        )
        if cause is not None:
            raise err from cause
        raise err

    def clear(self) -> None:
        """Best-effort deletion of the take's abort records (the leader
        calls this after a successful commit)."""
        try:
            self._store.delete_prefix(self._prefix(), keys=self._keys())
        except Exception:
            logger.debug(
                "abort-prefix cleanup failed for take %s", self.take_id, exc_info=True
            )


class LinearBarrier:
    """Two-phase barrier with error propagation. The leader waits for
    every rank to arrive, then signals departure. ``report_error``
    poisons the barrier: every waiter raises. ``watchers`` are callables
    run every poll that may raise to end the wait early (take-abort
    propagation). Pure KV traffic: safe from non-main threads.

    ``ranks`` restricts membership to a subset of the world (default:
    every rank); the leader defaults to the smallest member."""

    def __init__(
        self,
        store: KVStore,
        prefix: str,
        rank: int,
        world_size: int,
        leader_rank: Optional[int] = None,
        timeout_sec: Optional[float] = None,
        watchers: Optional[List[Callable[[], None]]] = None,
        ranks: Optional[List[int]] = None,
    ) -> None:
        self.store = store
        self.prefix = prefix
        self.rank = rank
        self.world_size = world_size
        self.ranks = sorted(ranks) if ranks is not None else list(range(world_size))
        if rank not in self.ranks:
            raise ValueError(
                f"LinearBarrier {prefix!r}: rank {rank} is not a member of {self.ranks}"
            )
        self.leader_rank = leader_rank if leader_rank is not None else min(self.ranks)
        self.timeout_sec = timeout_sec if timeout_sec is not None else _default_timeout_sec()
        self.watchers = list(watchers or [])
        # True while blocked in a _checked_get poll loop (current_missing).
        self._in_wait = False

    def _key(self, *parts: str) -> str:
        return "/".join((self.prefix,) + parts)

    def _raise_any_reported_error(self) -> None:
        """One dir-get over the error keys where the backend can, a
        per-key scan otherwise."""
        prefix = self._key("error") + "/"
        keys = [self._key("error", str(r)) for r in self.ranks]
        try:
            errs = self.store.try_get_dir(prefix, keys=keys)
        except Exception:
            errs = None
        if errs is None:
            errs = {}
            for key in keys:
                err = self.store.try_get(key)
                if err is not None:
                    errs[key] = err
        for k, err in sorted(errs.items()):
            rank = k.rsplit("/", 1)[-1]
            raise LinearBarrierError(f"Rank {rank} reported error: {pickle.loads(err)}")

    def _checked_get(self, key: str) -> bytes:
        """Wait for a key while watching for reported errors."""
        deadline = time.monotonic() + self.timeout_sec
        self._in_wait = True
        try:
            while True:
                value = self.store.try_get(key)
                if value is not None:
                    return value
                for watcher in self.watchers:
                    watcher()
                self._raise_any_reported_error()
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"LinearBarrier {self.prefix!r}: timed out waiting for {key!r}"
                    )
                time.sleep(_POLL_INTERVAL_SEC)
        finally:
            self._in_wait = False

    def current_missing(self) -> Optional[List[int]]:
        """While blocked in this barrier, the sorted ranks that have not
        arrived (a non-leader stuck in ``depart`` with every rank arrived
        gets the leader, which owns the pending depart signal). None when
        not waiting."""
        if not self._in_wait:
            return None
        missing = []
        for r in self.ranks:
            try:
                if self.store.try_get(self._key("arrive", str(r))) is None:
                    missing.append(r)
            except Exception:
                return None
        if not missing:
            return [self.leader_rank] if self.rank != self.leader_rank else None
        return missing

    def arrive(self) -> None:
        from . import flight, telemetry

        flight.record("barrier_enter", op=self.prefix)
        with telemetry.span("kv.barrier_arrive"):
            self.store.set(self._key("arrive", str(self.rank)), b"1")
            if self.rank == self.leader_rank:
                for r in self.ranks:
                    self._checked_get(self._key("arrive", str(r)))

    def depart(self) -> None:
        from . import flight, telemetry

        with telemetry.span("kv.barrier_depart"):
            if self.rank == self.leader_rank:
                self.store.set(self._key("depart"), b"1")
            else:
                self._checked_get(self._key("depart"))
        # Release observed: the cross-rank anchor of the flight timeline.
        flight.record("barrier_exit", op=self.prefix)

    def report_error(self, exc: BaseException) -> None:
        try:
            payload = pickle.dumps(exc)
        except Exception:
            payload = pickle.dumps(RuntimeError(repr(exc)))
        self.store.set(self._key("error", str(self.rank)), payload)
