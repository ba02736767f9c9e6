"""Live take/restore observability: heartbeat progress + stall watchdog.

Counterpart of tpusnap/progress.py. The pump publishes to the job's
``torch.distributed`` store through a client connection of its own
(``pump_kv_store``): a TCPStore client serializes its operations, and the
take's thread polls barriers on the other one.

Telemetry makes a finished take legible; this module covers the window
an operator cares about while it lasts — a take that is still running.
Three pieces:

- **Heartbeat progress** (:class:`ProgressMonitor`): one daemon thread
  per telemetry-enabled take samples the recorder's observable state
  (:meth:`TakeTelemetry.live_snapshot` — last completed phase, in-flight
  ops, counters, span/event count) and publishes a compact progress
  record at a bounded cadence: at most one publish per
  ``TPUSNAP_HEARTBEAT_INTERVAL_S`` (default 0.5 s), and only when
  something actually changed (a periodic keep-alive bounds staleness) —
  O(world) KV keys per interval, never per op. Records land in the
  coordination KV under ``tpusnap_progress/<take_id>/<rank>`` and, for
  local-filesystem destinations, in
  ``<snapshot>/.tpusnap/progress/rank_<k>.json`` (atomic temp+rename),
  which is what ``python -m tpusnap watch`` tails. Everything is
  best-effort: a failed publish can never fail a take, and
  telemetry-off takes skip the whole subsystem.

- **Stall watchdog** (same thread): when the sampled state stops
  advancing for ``TPUSNAP_STALL_DEADLINE_S`` (default 30 s) while a
  named op is in flight, it emits ONE structured WARNING per stall
  episode naming the blocked op — and, via the polling barrier's
  per-rank arrive keys (``Communicator.barrier_missing_ranks`` /
  ``LinearBarrier.current_missing``), exactly which ranks have not
  arrived. A silent hang becomes an actionable log in seconds instead
  of a bare 600 s barrier timeout. The log record carries a
  ``tpusnap_stall`` dict (rank, op, phase, stalled_s, missing_ranks)
  for structured collectors.

- **Restore traces**: the snapshot is immutable once committed, so
  restore telemetry persists to a LOCAL trace dir
  (``TPUSNAP_TELEMETRY_DIR``, default ``<tmp>/tpusnap-telemetry``)
  keyed by a digest of the snapshot path — rendered by
  ``python -m tpusnap trace --restore <path>``.

Forward progress is detected by OBSERVATION, not by hot-path hooks: the
pump compares successive ``live_snapshot`` signatures, so the take's
pipeline pays nothing beyond the op-token bookkeeping the spans already
do. Clocks are injectable throughout (``clock``/``wall_clock``) so the
throttle/watchdog unit tests run on a fake clock with zero sleeps.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from .knobs import (
    get_job_id,
    get_heartbeat_interval_s,
    get_stall_deadline_s,
    get_telemetry_dir,
)

logger = logging.getLogger(__name__)

from .io_types import PROGRESS_DIR  # canonical sidecar path (io_types)

# Wall-clock seam: record timestamps only; every duration/throttle
# computation here runs on the injectable monotonic ``clock``.
_wall = time.time

# Keep-alive: with NO observable change, a record is still re-published
# every this-many intervals so `watch` can distinguish "idle but alive"
# from "process gone" (record timestamp goes stale).
_KEEPALIVE_INTERVALS = 10


def progress_rank_path(rank: int) -> str:
    """Snapshot-relative path of one rank's heartbeat file."""
    return f"{PROGRESS_DIR}/rank_{rank}.json"


def local_root_of(path: str) -> Optional[str]:
    """The local directory a snapshot URL writes into, or None for
    non-local backends (heartbeat files and ``watch`` are local-fs
    only; the KV heartbeat covers the rest). A write-back tier URL
    writes its sidecars in its local tier."""
    from urllib.parse import urlsplit

    from .tiering import parse_tier_url

    try:
        spec = parse_tier_url(path)
    except ValueError:
        return None
    if spec is not None:
        return spec.local_dir
    u = urlsplit(path)
    scheme = u.scheme
    if scheme.startswith("chaos+"):
        scheme = scheme[len("chaos+") :]
    if scheme in ("", "file", "fs"):
        root = u.path if u.scheme else path
        return root or path
    return None


def read_progress_records(root: str) -> List[Dict[str, Any]]:
    """All parseable per-rank heartbeat records under ``root``'s
    progress dir, sorted by rank. Tolerant of torn/absent files (the
    publisher renames atomically, but the dir may not exist yet)."""
    out = []
    pdir = os.path.join(root, PROGRESS_DIR)
    try:
        names = os.listdir(pdir)
    except OSError:
        return out
    for name in sorted(names):
        if not (name.startswith("rank_") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(pdir, name), "r") as f:
                rec = json.load(f)
            if isinstance(rec, dict):
                out.append(rec)
        except Exception:
            continue
    return sorted(out, key=lambda r: r.get("rank", 0))


# ------------------------------------------------------ ProgressMonitor


class ProgressMonitor:
    """Heartbeat pump + stall watchdog for one take.

    One instance per telemetry-enabled take; ``thread=False`` plus an
    injected ``clock`` turns it into a pure state machine for tests
    (drive it with :meth:`tick`)."""

    def __init__(
        self,
        tele,
        rank: int,
        world_size: int,
        take_id: str,
        kv=None,
        local_dir: Optional[str] = None,
        attributions: Optional[List[Callable[[], Optional[List[int]]]]] = None,
        interval_s: Optional[float] = None,
        stall_deadline_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
        thread: bool = True,
    ) -> None:
        self.tele = tele
        self.rank = rank
        self.world_size = world_size
        self.take_id = take_id
        self.kv = kv
        self.local_dir = local_dir
        self.interval_s = (
            interval_s if interval_s is not None else get_heartbeat_interval_s()
        )
        self.stall_deadline_s = (
            stall_deadline_s
            if stall_deadline_s is not None
            else get_stall_deadline_s()
        )
        self._attributions = list(attributions or [])
        # Piggyback hooks run once per tick with the freshly built
        # progress record (or None when the throttle skipped building
        # one) — the flight recorder's flush and the SLO tracker's
        # publisher ride here so their cadence shares this pump thread
        # instead of owning another.
        self._tick_hooks: List[Callable[[Optional[Dict[str, Any]]], None]] = []
        # Liveness probe (tpusnap.liveness): "which peer ranks' leases
        # have expired?" — folded into stall episodes (dead vs slow
        # rank) and the published heartbeat record's dead_ranks field.
        self._liveness_probe: Optional[
            Callable[[], Optional[List[int]]]
        ] = None
        # Departure probe: "which peer ranks announced a graceful
        # LEAVE?" — rendered LEFT (elastic scale-down), never DEAD.
        self._left_probe: Optional[
            Callable[[], Optional[List[int]]]
        ] = None
        self._clock = clock
        self._wall = wall_clock
        # Job identity on every published record (cached once: the
        # host-pid default shells out to gethostname, not a per-tick
        # cost worth paying).
        try:
            self.job_id = get_job_id()
        except Exception:
            self.job_id = "job"
        self._state = "running"
        self._bytes_planned = 0
        self._start_t = clock()
        self._last_sig: Optional[tuple] = None
        self._last_advance = self._start_t
        self._stall_warned = False
        self._last_pub_t: Optional[float] = None
        self._last_pub_sig: Optional[tuple] = None
        self._last_rate_point = (self._start_t, 0)
        self._mbps = 0.0
        self.published = 0  # publish count (tests assert the throttle)
        self._stopped = False
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if thread:
            self._thread = threading.Thread(
                target=self._run, name="tpusnap-progress", daemon=True
            )
            self._thread.start()

    # --- wiring ---------------------------------------------------------

    def set_bytes_planned(self, nbytes: int) -> None:
        self._bytes_planned = int(nbytes)

    def add_attribution(
        self, fn: Callable[[], Optional[List[int]]]
    ) -> None:
        """Register a callable the watchdog asks "which ranks are we
        waiting on?" when a stall fires (first non-empty answer wins)."""
        self._attributions.append(fn)

    def add_tick_hook(
        self, fn: Callable[[Optional[Dict[str, Any]]], None]
    ) -> None:
        """Register a per-tick piggyback (see ``_tick_hooks``).
        Exceptions are swallowed per hook — the pump must survive any
        subscriber."""
        self._tick_hooks.append(fn)

    def set_liveness_probe(
        self, fn: Callable[[], Optional[List[int]]]
    ) -> None:
        """Register the lease-staleness probe (see ``_liveness_probe``).
        Best-effort like every observability hook."""
        self._liveness_probe = fn

    def set_left_probe(
        self, fn: Callable[[], Optional[List[int]]]
    ) -> None:
        """Register the graceful-departure probe (see ``_left_probe``).
        Best-effort like every observability hook."""
        self._left_probe = fn

    def _probe_dead_ranks(self) -> Optional[List[int]]:
        if self._liveness_probe is None:
            return None
        try:
            return self._liveness_probe()
        except Exception:
            return None

    def _probe_left_ranks(self) -> Optional[List[int]]:
        if self._left_probe is None:
            return None
        try:
            return self._left_probe()
        except Exception:
            return None

    # --- the pump -------------------------------------------------------

    def _run(self) -> None:
        # First beat immediately: `watch` sees the take the moment it
        # starts, not one interval later.
        try:
            self.tick(force_publish=True)
        except Exception:
            pass
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # Best-effort, always: a telemetry bug must never take
                # down the pump thread mid-take (or worse, the take).
                logger.debug("progress tick failed", exc_info=True)

    def tick(self, now: Optional[float] = None, force_publish: bool = False) -> None:
        """One pump iteration: advance detection → stall check →
        throttled publish. Public so fake-clock tests drive it."""
        now = self._clock() if now is None else now
        snap = self.tele.live_snapshot()
        sig = (
            snap["phase"],
            tuple(name for _thread, name in snap["ops"]),
            snap["marks"],
            tuple(sorted(snap["counters"].items())),
        )
        if sig != self._last_sig:
            self._last_sig = sig
            self._last_advance = now
            self._stall_warned = False
        else:
            self._check_stall(now, snap)
        record = self._maybe_publish(now, snap, force=force_publish)
        for fn in self._tick_hooks:
            try:
                fn(record)
            except Exception:
                logger.debug("progress tick hook failed", exc_info=True)

    def _check_stall(self, now: float, snap: Dict[str, Any]) -> None:
        if self._stall_warned or self._state != "running":
            return
        stalled_s = now - self._last_advance
        if stalled_s < self.stall_deadline_s:
            return
        ops = snap["ops"]
        if not ops:
            return  # between ops — "no forward progress INSIDE a named op"
        op = ops[0][1]  # oldest in-flight op = what we are blocked on
        missing: Optional[List[int]] = None
        for fn in self._attributions:
            try:
                got = fn()
            except Exception:
                got = None
            if got:
                missing = got
                break
        self._stall_warned = True  # one WARNING per stall episode
        # Surface the episode to the take summary/rollup, the export
        # sinks (tpusnap_stall_episodes_total) and the cross-run
        # history: an explicit rec so the counter lands in THIS take
        # even when a newer take replaced the global recorder.
        try:
            from . import telemetry

            telemetry.incr("progress.stall_episodes", rec=self.tele)
        except Exception:
            pass
        # Lease staleness splits the episode verdict: a stall with a
        # DEAD peer is a rank failure in progress (liveness will fail
        # the wait within ~2xTTL), not merely a slow rank.
        dead = self._probe_dead_ranks()
        info = {
            "rank": self.rank,
            "take_id": self.take_id,
            "op": op,
            "ops": [name for _thread, name in ops],
            "phase": snap["phase"],
            "stalled_s": round(stalled_s, 1),
            "missing_ranks": missing,
            "dead_ranks": dead,
        }
        try:
            from . import flight

            flight.record(
                "stall",
                op=op,
                stalled_s=round(stalled_s, 1),
                phase=snap["phase"],
                missing_ranks=missing,
                dead_ranks=dead,
            )
        except Exception:
            logger.debug("flight stall record failed", exc_info=True)
        logger.warning(
            "tpusnap stall: rank %d made no forward progress for %.1fs "
            "inside op %r (last completed phase %r)%s%s",
            self.rank,
            stalled_s,
            op,
            snap["phase"],
            (
                f"; ranks not arrived: {missing}"
                if missing
                else "; no barrier attribution available"
            ),
            (
                f"; DEAD rank(s) (lease expired): {dead}"
                if dead
                else ""
            ),
            extra={"tpusnap_stall": info},
        )

    # --- publishing -----------------------------------------------------

    def _maybe_publish(
        self, now: float, snap: Dict[str, Any], force: bool = False
    ) -> Optional[Dict[str, Any]]:
        due = (
            self._last_pub_t is None
            or now - self._last_pub_t >= self.interval_s
        )
        changed = self._last_pub_sig != self._last_sig
        keepalive = (
            self._last_pub_t is not None
            and now - self._last_pub_t
            >= _KEEPALIVE_INTERVALS * self.interval_s
        )
        if not force and not (due and changed) and not keepalive:
            return None
        record = self._record(now, snap)
        self._last_pub_t = now
        self._last_pub_sig = self._last_sig
        self.published += 1
        payload = json.dumps(record)
        if self.local_dir is not None:
            try:
                self._write_local(payload)
            except Exception:
                logger.debug("heartbeat file write failed", exc_info=True)
        if self.kv is not None:
            try:
                self.kv.set(self._kv_key(self.rank), payload.encode("utf-8"))
            except Exception:
                logger.debug("heartbeat KV publish failed", exc_info=True)
        return record

    def _kv_key(self, rank: int) -> str:
        return f"tpusnap_progress/{self.take_id}/{rank}"

    def _write_local(self, payload: str) -> None:
        pdir = os.path.join(self.local_dir, PROGRESS_DIR)
        os.makedirs(pdir, exist_ok=True)
        path = os.path.join(pdir, f"rank_{self.rank}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, path)

    def _record(self, now: float, snap: Dict[str, Any]) -> Dict[str, Any]:
        counters = snap["counters"]
        written = counters.get("storage.bytes_written", 0)
        staged = counters.get("scheduler.bytes_staged", 0)
        planned = self._bytes_planned
        if self._state == "committed":
            percent: Optional[float] = 100.0
            staged_percent: Optional[float] = 100.0
        elif planned > 0:
            percent = round(min(100.0, 100.0 * written / planned), 1)
            # Pipelined async takes stage residual windows on the
            # background drain — surface that leg's own progress so a
            # watcher can tell "still cloning" from "still writing".
            staged_percent = round(min(100.0, 100.0 * staged / planned), 1)
        else:
            percent = None
            staged_percent = None
        prev_t, prev_b = self._last_rate_point
        if now - prev_t >= self.interval_s:
            self._mbps = round((written - prev_b) / max(now - prev_t, 1e-9) / 1e6, 1)
            self._last_rate_point = (now, written)
        ops = snap["ops"]
        rec = {
            "v": 1,
            "rank": self.rank,
            "world_size": self.world_size,
            "job_id": self.job_id,
            "take_id": self.take_id,
            "state": self._state,
            "phase": snap["phase"],
            "op": ops[0][1] if ops else None,
            "ops": [name for _thread, name in ops],
            "bytes_planned": planned,
            "bytes_written": written,
            "bytes_staged": staged,
            "staged_percent": staged_percent,
            "percent": percent,
            "mbps": self._mbps,
            "beat_age_s": round(now - self._last_advance, 2),
            "elapsed_s": round(now - self._start_t, 2),
            "ts": self._wall(),
        }
        # In-take roofline probes (TPUSNAP_PROBE=1): the latest measured
        # ceiling, so `watch` can render live MB/s as a fraction of the
        # achievable instead of a bare number.
        if snap.get("probe_write_gbps"):
            rec["probe_write_gbps"] = snap["probe_write_gbps"]
        # Peer ranks this rank's liveness monitor has declared dead —
        # `watch` flags them so an operator sees "rank 2 died" on the
        # survivors' rows, not just a stalled percentage.
        dead = self._probe_dead_ranks()
        left = self._probe_left_ranks()
        if left:
            rec["left_ranks"] = left
            # A rank that announced departure is not dead — never let
            # the two flags contradict on one record.
            dead = [r for r in (dead or []) if r not in left] or None
        if dead:
            rec["dead_ranks"] = dead
        return rec

    # --- lifecycle ------------------------------------------------------

    def finish(self, state: str = "committed") -> None:
        """Stop the pump, publish the final record (``committed`` forces
        100%), then release this rank's KV key — in that order, so no
        in-flight pump tick can recreate a key after its delete. The
        final record survives in the local heartbeat FILE; the KV copy
        is live-monitoring state and is always released (every rank
        deletes its own key so a peer's late publish cannot race rank
        0's sweep back into existence; rank 0 of a committed take also
        sweeps the prefix, which covers SIGKILLed peers that never
        reached finish). Idempotent, never raises."""
        if self._stopped:
            return
        self._state = state
        self.stop()
        try:
            self.tick(force_publish=True)
        except Exception:
            pass
        if self.kv is not None:
            try:
                # A TCPStore cannot list: every delete names its keys.
                own = self._kv_key(self.rank)
                self.kv.delete_prefix(own, keys=[own])
                if state == "committed" and self.rank == 0:
                    self.kv.delete_prefix(
                        f"tpusnap_progress/{self.take_id}/",
                        keys=[self._kv_key(r) for r in range(self.world_size)],
                    )
            except Exception:
                pass

    def stop(self) -> None:
        """Stop the pump thread without a final publish. Idempotent."""
        self._stopped = True
        self._stop_evt.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)


def pump_kv_store(comm):
    """The KV store the heartbeat pump (and the liveness lease riding it)
    publishes to: the job's store through a client connection of its
    own, so that the pump's sets never queue behind the take thread's
    store operations on one client (a TCPStore client serializes its
    operations under one lock). None for one process."""
    if comm.world_size <= 1:
        return None
    from .dist_store import TCPStoreKVStore

    store = getattr(comm, "store", None)
    if store is None:
        from .comm import _default_group_store

        store = _default_group_store()
    if hasattr(store, "clone"):
        store = store.clone()
    return TCPStoreKVStore(store)


def start_take_monitor(tele, comm, take_id: str, path: str) -> ProgressMonitor:
    """Wire a :class:`ProgressMonitor` for a take: KV target (multi-
    process only, on its own store client), local heartbeat dir
    (local-fs destinations only), and the communicator's barrier
    attribution."""
    kv = None
    if comm.world_size > 1:
        try:
            kv = pump_kv_store(comm)
        except Exception:
            logger.warning("heartbeat KV store unavailable", exc_info=True)
            kv = None
    return ProgressMonitor(
        tele,
        rank=comm.rank,
        world_size=comm.world_size,
        take_id=take_id,
        kv=kv,
        local_dir=local_root_of(path),
        attributions=[comm.barrier_missing_ranks],
    )


# ------------------------------------------------------- restore traces


def _path_digest(path: str) -> str:
    # Every spelling of the same local destination (plain path,
    # file://, fs://, chaos+fs://, trailing slash) must digest
    # identically, or `trace --restore <path>` misses traces a
    # differently-spelled restore persisted.
    norm = path.rstrip("/")
    root = local_root_of(norm)
    if root is not None:
        norm = os.path.abspath(root)
    return hashlib.sha1(norm.encode("utf-8")).hexdigest()[:12]


def restore_trace_dir(snapshot_path: str) -> str:
    """Local directory holding the LAST restore's per-rank traces for
    ``snapshot_path`` (the snapshot itself is immutable, so restore
    telemetry cannot ride inside it the way take traces do)."""
    return os.path.join(
        get_telemetry_dir(), f"restore_{_path_digest(snapshot_path)}"
    )


# Run-scoped trace files kept per digest+rank before the oldest are
# reaped. Back-to-back restores of the same snapshot used to clobber
# each other's rank_<k>.json; now each run writes its own suffixed file
# and only the `latest` pointer moves.
RESTORE_TRACE_KEEP = 8

_RANK_LATEST_RE = re.compile(r"^rank_(\d+)\.json$")
_RANK_RUN_RE = re.compile(r"^rank_(\d+)\.[0-9a-f]+\.json$")


def persist_restore_trace(tele, snapshot_path: str) -> str:
    """Write one rank's restore trace
    (``{rank, path, summary, traceEvents}``) under the local trace dir.
    Each restore run writes its own ``rank_<k>.<run>.json`` (atomic
    temp+rename) and repoints the ``rank_<k>.json`` latest-symlink at
    it, so back-to-back restores of the same snapshot no longer clobber
    each other while ``trace --restore`` keeps reading the latest run
    through the unchanged name. Retention is bounded to
    :data:`RESTORE_TRACE_KEEP` runs per digest+rank. Returns the
    run-scoped file path."""
    tdir = restore_trace_dir(snapshot_path)
    os.makedirs(tdir, exist_ok=True)
    run_id = uuid.uuid4().hex[:8]
    out = os.path.join(tdir, f"rank_{tele.rank}.{run_id}.json")
    doc = {
        "rank": tele.rank,
        "path": snapshot_path,
        "kind": "restore",
        "run_id": run_id,
        "summary": tele.summary(),
        "traceEvents": tele.chrome_trace_events(),
    }
    tmp = f"{out}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out)
    latest = os.path.join(tdir, f"rank_{tele.rank}.json")
    try:
        # Atomic repoint: build the new symlink aside, rename over the
        # old one (rename replaces symlinks like any other entry).
        link_tmp = f"{latest}.lnk.{os.getpid()}"
        try:
            os.unlink(link_tmp)
        except OSError:
            pass
        os.symlink(os.path.basename(out), link_tmp)
        os.replace(link_tmp, latest)
    except OSError:
        # Symlink-hostile filesystem: fall back to the pre-fix overwrite
        # semantics for the latest pointer (run files are still kept).
        tmp2 = f"{latest}.tmp.{os.getpid()}"
        with open(tmp2, "w") as f:
            json.dump(doc, f)
        os.replace(tmp2, latest)
    _reap_restore_traces(tdir, tele.rank)
    return out


def _reap_restore_traces(tdir: str, rank: int) -> None:
    """Drop this rank's oldest run-scoped trace files beyond the
    retention bound (best-effort; the latest-symlink's target is never
    younger than the survivors, so it stays valid)."""
    pat = re.compile(rf"^rank_{rank}\.[0-9a-f]+\.json$")
    try:
        runs = [n for n in os.listdir(tdir) if pat.match(n)]
    except OSError:
        return
    if len(runs) <= RESTORE_TRACE_KEEP:
        return
    dated = []
    for name in runs:
        try:
            dated.append((os.stat(os.path.join(tdir, name)).st_mtime, name))
        except OSError:
            continue
    dated.sort()
    for _, name in dated[: max(len(dated) - RESTORE_TRACE_KEEP, 0)]:
        try:
            os.unlink(os.path.join(tdir, name))
        except OSError:
            pass


def load_restore_traces(snapshot_path: str) -> Dict[int, Dict[str, Any]]:
    """Per-rank restore trace docs persisted on THIS machine for
    ``snapshot_path`` (restore issues no collectives, so there is no
    cross-host gather — each host holds its own ranks' traces). Reads
    each rank's ``rank_<k>.json`` latest pointer; when that pointer is
    missing or dangling (a reaped target, a partially-synced dir, an
    older build that never wrote one) the rank falls back to its NEWEST
    run-scoped ``rank_<k>.<run>.json`` by mtime instead of silently
    dropping out of the report."""
    tdir = restore_trace_dir(snapshot_path)
    out: Dict[int, Dict[str, Any]] = {}
    try:
        names = os.listdir(tdir)
    except OSError:
        return out
    run_files: Dict[int, List[str]] = {}
    for name in sorted(names):
        m = _RANK_RUN_RE.match(name)
        if m:
            run_files.setdefault(int(m.group(1)), []).append(name)
            continue
        if not _RANK_LATEST_RE.match(name):
            continue
        try:
            with open(os.path.join(tdir, name), "r") as f:
                doc = json.load(f)
            out[int(doc["rank"])] = doc
        except Exception:
            continue
    for rank, runs in run_files.items():
        if rank in out:
            continue
        dated = []
        for name in runs:
            try:
                dated.append(
                    (os.stat(os.path.join(tdir, name)).st_mtime, name)
                )
            except OSError:
                continue
        for _, name in sorted(dated, reverse=True):
            try:
                with open(os.path.join(tdir, name), "r") as f:
                    doc = json.load(f)
                out[int(doc["rank"])] = doc
                break
            except Exception:
                continue
    return out
