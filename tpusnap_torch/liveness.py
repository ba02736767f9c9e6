"""Rank-liveness leases: fail-fast detection of dead peers mid-take.

Counterpart of tpusnap/liveness.py. A TCPStore cannot list keys, so the
monitor reads and the leader sweeps the leases of every rank by name.

The distributed take protocol is all-ranks-blocking: manifest gathers,
the commit barriers and the async commit's LinearBarrier all park until
EVERY rank arrives. Before this module, one SIGKILLed or wedged rank
stranded every survivor for the full barrier timeout (historically
600 s/1800 s — now ``TPUSNAP_BARRIER_TIMEOUT_S``) and the whole take —
minutes of staged and written work — was lost with it. At fleet scale
(thousands of concurrent jobs, preemptible hosts) rank death is routine,
not exceptional, and a checkpointing service that hangs for 10 minutes
on one preempted host violates the RPO/RTO objectives the SLO tracker
gates on.

Two pieces, both riding machinery that already exists:

- :class:`LeasePublisher` — one per-rank lease record under
  ``tpusnap_lease/<take_id>/<rank>``, republished on every heartbeat
  pump tick (:class:`tpusnap.progress.ProgressMonitor` — NO new
  thread). The record is a monotonically increasing sequence number
  plus a state tag; a final ``done``/``aborted`` publish marks a rank
  that exited the take deliberately, which peers never expire.

- :class:`LivenessMonitor` — consulted from inside every blocking wait
  (the communicator's polling barriers, ``LinearBarrier`` watchers, the
  commit path). Staleness is judged OBSERVER-SIDE: the monitor records,
  on its own monotonic clock, when each peer's sequence last advanced —
  no cross-host clock comparison, no NTP sensitivity. A peer whose
  lease has not advanced for more than the TTL
  (``TPUSNAP_LIVENESS_TTL_S``, default 15 s) is declared dead and the
  wait raises :class:`RankFailedError` naming it — detection within
  ~2x TTL (one TTL of allowed staleness + publish/poll cadence), not
  the barrier timeout.

Composition: the detecting rank's failure path publishes the error
through the existing :class:`~tpusnap.dist_store.TakeAbortMonitor`, so
survivors that have not yet judged the lease themselves abort within
seconds via the normal ``TakeAbortedError`` propagation. With
``TPUSNAP_RANK_FAILURE=degrade`` the take may instead complete on the
survivors — see ``snapshot.py``'s degraded-commit path.

A wedged-but-alive rank (stuck inside one op, heartbeat pump still
running) keeps its lease fresh: liveness distinguishes DEAD from SLOW
by construction, and the slow case stays the stall watchdog's job
(which now also reports lease-expired peers — the ``rank_dead`` flight
event the timeline post-mortem folds in).

Durations here run on the injectable monotonic ``clock``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Set

logger = logging.getLogger(__name__)

_LEASE_PREFIX = "tpusnap_lease"


def lease_prefix(take_id: str) -> str:
    return f"{_LEASE_PREFIX}/{take_id}/"


def lease_key(take_id: str, rank: int) -> str:
    return f"{lease_prefix(take_id)}{rank}"


class RankFailedError(RuntimeError):
    """A peer rank's liveness lease expired mid-take: the rank is dead
    (SIGKILLed, host lost, process frozen without its pump) from this
    process's point of view. Raised from inside the blocking wait that
    would otherwise have parked until the barrier timeout. ``ranks``
    names every expired rank; ``take_id`` scopes the evidence."""

    def __init__(self, ranks: List[int], take_id: str, detail: str = "") -> None:
        self.ranks = sorted(ranks)
        self.take_id = take_id
        msg = (
            f"rank(s) {self.ranks} failed during take {take_id[:8]}: "
            "liveness lease expired"
        )
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


class LeasePublisher:
    """This rank's lease: a seq counter republished at the heartbeat
    cadence. Everything is best-effort — a failed publish can never
    fail a take (peers tolerate up to a TTL of staleness)."""

    def __init__(self, kv, take_id: str, rank: int) -> None:
        self.kv = kv
        self.take_id = take_id
        self.rank = rank
        self._seq = 0
        self._state = "live"
        self._lock = threading.Lock()

    def publish(self, state: Optional[str] = None) -> None:
        with self._lock:
            self._seq += 1
            if state is not None:
                self._state = state
            payload = json.dumps(
                {"seq": self._seq, "state": self._state, "rank": self.rank}
            ).encode("utf-8")
        try:
            self.kv.set(lease_key(self.take_id, self.rank), payload)
        except Exception:
            logger.debug("lease publish failed", exc_info=True)

    def finish(self, state: str) -> None:
        """Terminal publish — THE one place a take outcome maps to a
        lease tag peers never expire (the rank exited deliberately;
        barrier keys / abort records carry the outcome). The tick hook
        delegates here when the pump's final record carries a terminal
        state, so the mapping cannot drift."""
        self.publish(state="done" if state == "committed" else "aborted")

    def make_tick_hook(self) -> Callable[[Optional[dict]], None]:
        """The heartbeat pump piggyback: republish the lease every tick
        (cheap — one KV set per rank per interval, same order as the
        heartbeat itself); the pump's final committed/aborted record
        routes through :meth:`finish`."""

        def hook(record: Optional[dict]) -> None:
            state = record.get("state") if record else None
            if state in ("committed", "aborted"):
                self.finish(state)
            else:
                self.publish()

        return hook

    def leave(self) -> None:
        """Terminal publish for a graceful departure (a preemption notice
        honoured, an elastic scale-down): the rank neither committed nor
        failed. Observers never expire it and never raise
        :class:`RankFailedError` for it."""
        self.publish(state="left")

    def cleanup(self, world_size: int = 1) -> None:
        """Best-effort removal of the whole take's lease prefix (leader
        calls this after a successful commit, mirroring the abort- and
        progress-prefix sweeps). A TCPStore cannot list, so the keys of
        every rank are named."""
        try:
            self.kv.delete_prefix(
                lease_prefix(self.take_id),
                keys=[lease_key(self.take_id, r) for r in range(max(world_size, self.rank + 1))],
            )
        except Exception:
            logger.debug("lease prefix cleanup failed", exc_info=True)


#: Lease states that mean "this rank exited the take deliberately" —
#: never expired by observers (the outcome travels via barrier keys or
#: abort records, both faster than a TTL). ``left`` is the graceful
#: elastic departure: not a commit, not a failure — the rank announced
#: it is leaving the world, and watchers must never declare it dead.
_TERMINAL_STATES = ("done", "aborted", "left")


class LivenessMonitor:
    """Observer-side lease staleness for one take.

    ``check()`` is designed to run inside poll loops (the communicator's
    polling barriers run their watcher every ~50 ms): it is throttled to
    one KV directory read per ``ttl/5`` and judges staleness on this
    process's monotonic clock — a peer whose lease seq has not advanced
    for > ``ttl_s`` (or that never published within 2x ttl of this
    monitor's start) raises :class:`RankFailedError`.

    The anchor is the monitor's construction time, which the take places
    strictly after the G1 gather — every rank was provably alive then,
    so "no lease yet" is a real signal, not a startup race."""

    def __init__(
        self,
        kv,
        take_id: str,
        rank: int,
        world_size: int,
        ttl_s: float,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.kv = kv
        self.take_id = take_id
        self.rank = rank
        self.world_size = world_size
        self.ttl_s = ttl_s
        self._clock = clock
        now = clock()
        # rank -> (last seen seq or None, monotonic time it last advanced)
        self._last: Dict[int, tuple] = {
            r: (None, now) for r in range(world_size)
        }
        self._terminal: Set[int] = set()
        self._left: Set[int] = set()
        self._last_refresh = -1e18
        self._throttle = max(0.1, ttl_s / 5.0)
        self._announced: Set[int] = set()
        self._lock = threading.Lock()

    # --- observation ------------------------------------------------------

    def _refresh(self, now: float) -> None:
        try:
            entries = self.kv.try_get_dir(
                lease_prefix(self.take_id),
                keys=[lease_key(self.take_id, r) for r in range(self.world_size)],
            )
        except Exception:
            return
        if entries is None:
            return
        prefix = lease_prefix(self.take_id)
        for key, raw in entries.items():
            rel = key[len(prefix):] if key.startswith(prefix) else key
            try:
                r = int(rel)
                rec = json.loads(
                    raw.decode("utf-8") if isinstance(raw, bytes) else raw
                )
                seq = int(rec["seq"])
            except Exception:
                continue
            if r not in self._last:
                continue
            state = rec.get("state")
            if state in _TERMINAL_STATES:
                self._terminal.add(r)
                if state == "left":
                    self._left.add(r)
            prev_seq, _prev_t = self._last[r]
            if seq != prev_seq:
                self._last[r] = (seq, now)

    def expired(self, now: Optional[float] = None) -> List[int]:
        """Sorted peer ranks whose lease is stale past the TTL right
        now (forcing a refresh — no throttle). Terminal leases and this
        rank itself never expire."""
        with self._lock:
            now = self._clock() if now is None else now
            self._refresh(now)
            return self._expired_locked(now)

    def _expired_locked(self, now: float) -> List[int]:
        out = []
        for r, (seq, t) in self._last.items():
            if r == self.rank or r in self._terminal:
                continue
            # A rank that never published gets a 2x-TTL grace from the
            # monitor's anchor (covers a SIGKILL in the tiny window
            # between G1 and its pump's first beat without doubling the
            # common-case detection bound).
            limit = self.ttl_s if seq is not None else 2.0 * self.ttl_s
            if now - t > limit:
                out.append(r)
        return sorted(out)

    # --- the watcher ------------------------------------------------------

    def check(self, exclude: Optional[Set[int]] = None) -> None:
        """Raise :class:`RankFailedError` if any (non-excluded) peer's
        lease expired. Throttled to one KV read per ``ttl/5``; safe to
        call every poll iteration from any thread."""
        if self.ttl_s <= 0:
            return
        with self._lock:
            now = self._clock()
            if now - self._last_refresh >= self._throttle:
                self._last_refresh = now
                self._refresh(now)
            dead = self._expired_locked(now)
            fresh = [r for r in dead if r not in self._announced]
            self._announced.update(fresh)
        for r in fresh:
            # Edge-triggered forensic breadcrumbs: one rank_dead flight
            # event + counter per expired peer, flushed crash-survivably
            # so the timeline post-mortem can name the dead rank even if
            # this survivor is itself killed moments later.
            try:
                from . import flight, telemetry

                telemetry.incr("liveness.rank_dead")
                flight.record(
                    "rank_dead", op=f"rank{r}", rank=r, ttl_s=self.ttl_s
                )
                # Crash-survivable NOW: the survivor raising in a few
                # microseconds may be torn down before the next
                # heartbeat flush, and the dead rank's name is the one
                # fact the post-mortem needs.
                flight.recorder().maybe_flush(force=True)
            except Exception:
                logger.debug("rank_dead breadcrumb failed", exc_info=True)
            try:
                from . import slo as _slo

                _slo.tracker().note_rank_dead([r])
            except Exception:
                logger.debug("rank_dead slo feed failed", exc_info=True)
            logger.warning(
                "tpusnap liveness: rank %d's lease expired (> %.1fs stale) "
                "during take %s — the rank is dead from rank %d's view",
                r,
                self.ttl_s,
                self.take_id[:8],
                self.rank,
            )
        if exclude:
            dead = [r for r in dead if r not in exclude]
        if dead:
            raise RankFailedError(dead, self.take_id)

    def watcher(
        self, exclude: Optional[Set[int]] = None
    ) -> Callable[[], None]:
        """A zero-arg callable for wait-watcher/barrier-watcher slots,
        optionally tolerating an already-acknowledged dead set (the
        degraded commit's barriers run over the live set and must not
        re-raise for the ranks they are degrading around)."""
        return lambda: self.check(exclude=exclude)

    def dead_ranks(self) -> Optional[List[int]]:
        """Already-announced expired ranks, WITHOUT a fresh KV read —
        the stall watchdog's cheap probe (it runs even when nothing is
        waiting in a barrier). None when none observed."""
        with self._lock:
            out = sorted(self._announced)
        return out or None

    def left_ranks(self) -> Optional[List[int]]:
        """Ranks that published a terminal ``left`` lease (graceful
        departure). Observed as a side effect of the throttled
        refreshes — no fresh KV read. None when none observed."""
        with self._lock:
            out = sorted(self._left)
        return out or None
