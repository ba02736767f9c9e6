"""Black-box flight recorder: crash-surviving event log + forensic reader.

Counterpart of tpusnap/flight.py: the same event kinds and sidecar
format (tpusnap's ``python -m tpusnap timeline`` reads the port's logs).

PRs 3/4/7 made a take crash-SAFE (journal/fsck), live-observable
(heartbeats) and attributable (telemetry/analyze) — but every one of
those persists its richest evidence at or after the commit barrier. The
one take an operator most needs to understand — the SIGKILLed, wedged
or aborted one — left only a journal marker and a stale heartbeat. This
module is the black box that survives the crash:

- **FlightRecorder** — an always-on, bounded, lock-light ring buffer of
  structured events: monotonic timestamp (plus a wall anchor recorded
  once per process so readers can map back), kind, op, small detail
  dict. Fed from the seams that already exist: telemetry span
  open/close and phase transitions, journal writes and blob-completion
  records, retry attempts, injected faults, barrier enter/exit, stall
  episodes, roofline probes. Recording is one lock'd ``deque.append``;
  memory and flush cost are O(ring), never O(take).

- **Crash persistence** — the ring is rewritten ATOMICALLY (temp +
  rename, like the progress sidecar) to two destinations at a bounded
  cadence: the destination sidecar ``.tpusnap/flight/rank_<k>.jsonl``
  (local-filesystem destinations; journal-exempt like the progress
  sidecar) and a local ``TPUSNAP_TELEMETRY_DIR`` copy keyed by a path
  digest (survives even when the destination is remote or the
  destination dir itself is lost). The flush piggybacks on the
  heartbeat pump plus ``atexit``/SIGTERM handlers — SIGKILL cannot be
  caught, so the flush cadence (default: the heartbeat interval) IS the
  documented loss bound: after any crash, at most one flush interval of
  events is missing.

- **Forensic reader** — :func:`load_flight_logs` /
  :func:`merge_timeline` / :func:`estimate_skew` /
  :func:`postmortem_verdict` power ``python -m tpusnap timeline``:
  all ranks' logs merged into one causally-ordered timeline using
  barrier-anchored clock-skew estimation (every rank logs the same
  barrier release; the reader aligns ranks on the shared anchors and
  reports the residual skew bound), plus a post-mortem verdict for torn
  paths: per-rank last event, in-flight op, last completed phase,
  bytes staged/written vs planned, journal.d completion evidence,
  stall episodes, and the missing-rank set.

Everything here is best-effort observability: a recorder or flush
failure can never fail a take, and the reader treats absent/partial
logs as evidence gaps, not errors.
"""

from __future__ import annotations

import atexit
import collections
import hashlib
import json
import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .io_types import FLIGHT_DIR
from .knobs import (
    get_job_id,
    get_flight_flush_interval_s,
    get_flight_ring_size,
    get_telemetry_dir,
    is_flight_enabled,
)

logger = logging.getLogger(__name__)

# Wall-clock seam: the per-process wall anchor only (all event
# timestamps and flush throttling run on the monotonic clock).
_wall = time.time


def flight_rank_path(rank: int) -> str:
    """Snapshot-relative path of one rank's flight log."""
    return f"{FLIGHT_DIR}/rank_{rank}.jsonl"


def _path_digest(path: str) -> str:
    # Same normalization contract as progress._path_digest: every
    # spelling of one local destination digests identically.
    from .progress import local_root_of

    norm = path.rstrip("/")
    root = local_root_of(norm)
    if root is not None:
        norm = os.path.abspath(root)
    return hashlib.sha1(norm.encode("utf-8")).hexdigest()[:12]


def local_flight_dir(snapshot_path: str) -> str:
    """The local (TPUSNAP_TELEMETRY_DIR) copy of the flight logs for
    ``snapshot_path`` — the fallback the timeline reader consults when
    the destination itself carries none (remote backends, or a
    destination directory that was lost with the machine that held
    it)."""
    return os.path.join(
        get_telemetry_dir(), f"flight_{_path_digest(snapshot_path)}"
    )


# ---------------------------------------------------------------- recorder


class FlightRecorder:
    """Bounded ring of (monotonic_ts, kind, op, detail) events.

    One per process (see :func:`recorder`); always on unless
    ``TPUSNAP_FLIGHT=0``. The lock is a LEAF in the process lock order:
    nothing is called while it is held, and :meth:`record` never
    raises."""

    def __init__(self, ring_size: Optional[int] = None) -> None:
        self.enabled = is_flight_enabled()
        self._ring: collections.deque = collections.deque(
            maxlen=ring_size if ring_size is not None else get_flight_ring_size()
        )
        self._lock = threading.Lock()
        # Serializes concurrent flushers (pump thread vs end_take vs
        # the SIGTERM handler): both would otherwise pass the throttle
        # check and interleave writes into the SAME pid-keyed temp file
        # before renaming. Taken non-blocking — a contended flush means
        # one is already in progress with near-identical content, and a
        # signal handler interrupting this very thread's flush must
        # not self-deadlock.
        self._flush_lock = threading.Lock()
        self.events_total = 0
        # Wall/monotonic anchor pair: readers map an event's monotonic
        # timestamp to wall time via wall_anchor + (t - mono_anchor).
        self.mono_anchor = time.monotonic()
        self.wall_anchor = _wall()
        # Per-take flush destinations (configure_take).
        self.rank = 0
        self.take_id: Optional[str] = None
        self.world_size = 1
        self._sidecar_dir: Optional[str] = None
        self._copy_dir: Optional[str] = None
        self._flush_interval_s = get_flight_flush_interval_s()
        self._last_flush_t: Optional[float] = None
        self._context: Dict[str, Any] = {}
        self.flushes = 0  # tests assert the throttle

    # --- recording ------------------------------------------------------

    def record(self, kind: str, op: Optional[str] = None, **detail: Any) -> None:
        """Append one event; cheap (one lock'd deque append) and
        non-raising — the recorder must never fail the code it
        observes."""
        if not self.enabled:
            return
        try:
            t = time.monotonic()
            with self._lock:
                self._ring.append((t, kind, op, detail or None))
                self.events_total += 1
        except Exception:
            pass

    def record_nowait(self, kind: str) -> bool:
        """Signal-handler-safe record: a handler runs on whatever thread
        the signal interrupted — if THAT frame holds the ring lock, a
        blocking acquire would self-deadlock the non-reentrant lock, so
        try-acquire and drop the event when contended (the flush that
        follows tells the story either way)."""
        if not self.enabled:
            return False
        try:
            t = time.monotonic()
            if not self._lock.acquire(False):
                return False
            try:
                self._ring.append((t, kind, None, None))
                self.events_total += 1
            finally:
                self._lock.release()
            return True
        except Exception:
            return False

    def snapshot_events(self) -> list:
        """The current ring as event dicts in the flushed-line shape
        (``{"t", "k", "op"?, ...detail}``) — the in-process read API
        tests and tooling use without round-tripping a sidecar."""
        with self._lock:
            events = list(self._ring)
        out = []
        for t, kind, op, detail in events:
            ev: Dict[str, Any] = {"t": round(t, 6), "k": kind}
            if op is not None:
                ev["op"] = op
            if detail:
                ev.update(detail)
            out.append(ev)
        return out

    def mark_take_start(self) -> None:
        """Reset the ring for a new take (called from
        ``telemetry.begin_take``, before the first phase event): the
        sidecar is a per-take artifact, so a SIGKILLed take's flushed
        log — and the verdict's stall/eviction accounting — must not
        carry the previous takes' events."""
        with self._lock:
            self._ring.clear()
            self.events_total = 0

    # --- flush ----------------------------------------------------------

    def configure_take(
        self,
        rank: int,
        take_id: str,
        world_size: int,
        path: str,
        local_root: Optional[str],
    ) -> None:
        """Arm the per-take flush destinations (called at take begin,
        after the take_id and coalesced path are agreed). Re-samples the
        knob so overrides apply per take, installs the exit handlers
        once, and resets the flush throttle so the first pump tick
        flushes immediately."""
        self.enabled = is_flight_enabled()
        if not self.enabled:
            self._sidecar_dir = self._copy_dir = None
            return
        self.rank = rank
        self.take_id = take_id
        self.world_size = world_size
        self._flush_interval_s = get_flight_flush_interval_s()
        self._sidecar_dir = (
            os.path.join(local_root, FLIGHT_DIR) if local_root else None
        )
        try:
            self._copy_dir = local_flight_dir(path)
        except Exception:
            self._copy_dir = None
        self._last_flush_t = None
        self._context = {}
        self.record("take_begin", op=take_id[:8], world_size=world_size)
        _install_exit_handlers()

    def set_context(self, context: Dict[str, Any]) -> None:
        """Live progress context carried in the flushed header (phase,
        in-flight ops, bytes planned/staged/written) — what the
        post-mortem verdict reads for "what was this rank doing when it
        died". The heartbeat pump refreshes it every tick."""
        self._context = context

    def maybe_flush(self, force: bool = False) -> bool:
        """Flush at most once per interval (the SIGKILL loss bound);
        ``force`` for the final commit/abort/exit flush. Never raises.
        A periodic flush already in progress on another thread is
        skipped, not waited for — its content is near-identical and the
        cadence bound covers the gap. A ``force`` flush (the terminal
        commit/abort/exit state must land) waits briefly instead, with
        a timeout so a signal handler interrupting THIS thread's
        in-progress flush can never self-deadlock."""
        if not self.enabled or (
            self._sidecar_dir is None and self._copy_dir is None
        ):
            return False
        if not self._flush_lock.acquire(force, 2.0 if force else -1):
            return False
        try:
            now = time.monotonic()
            if (
                not force
                and self._last_flush_t is not None
                and now - self._last_flush_t < self._flush_interval_s
            ):
                return False
            self._last_flush_t = now
            try:
                payload = self._serialize(now)
            except Exception:
                logger.debug("flight serialize failed", exc_info=True)
                return False
            wrote = False
            for d in (self._sidecar_dir, self._copy_dir):
                if d is None:
                    continue
                try:
                    os.makedirs(d, exist_ok=True)
                    out = os.path.join(d, f"rank_{self.rank}.jsonl")
                    tmp = f"{out}.tmp.{os.getpid()}"
                    with open(tmp, "w") as f:
                        f.write(payload)
                    os.replace(tmp, out)
                    wrote = True
                except Exception:
                    logger.debug(
                        "flight flush to %r failed", d, exc_info=True
                    )
            if wrote:
                self.flushes += 1
            return wrote
        finally:
            self._flush_lock.release()

    def end_take(self, state: str) -> None:
        """Record the terminal event and force the final flush. The
        destinations stay armed until the next take so the atexit flush
        still lands the tail of THIS take's events."""
        self.record("take_end", op=state)
        self._context = dict(self._context, state=state)
        self.maybe_flush(force=True)

    def _serialize(self, now: float) -> str:
        # Timeout acquire, mirroring _flush_lock: a SIGTERM handler's
        # forced flush may run on a thread whose interrupted frame
        # holds the ring lock — bail (the caller swallows) instead of
        # self-deadlocking; the previous flush is at most one interval
        # stale.
        if not self._lock.acquire(timeout=2.0):
            raise RuntimeError("flight ring lock contended")
        try:
            events = list(self._ring)
            total = self.events_total
        finally:
            self._lock.release()
        header = {
            "k": "meta",
            "v": 1,
            "rank": self.rank,
            "job_id": get_job_id(),
            "take_id": self.take_id,
            "world_size": self.world_size,
            "pid": os.getpid(),
            "wall_anchor": self.wall_anchor,
            "mono_anchor": self.mono_anchor,
            "flush_mono": now,
            "events_total": total,
            "dropped": max(0, total - len(events)),
            "context": self._context,
        }
        lines = [json.dumps(header, default=str)]
        for t, kind, op, detail in events:
            ev: Dict[str, Any] = {"t": round(t, 6), "k": kind}
            if op is not None:
                ev["op"] = op
            if detail:
                ev.update(detail)
            lines.append(json.dumps(ev, default=str))
        return "\n".join(lines) + "\n"


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def recorder() -> FlightRecorder:
    """The process-global flight recorder (created on first use)."""
    global _recorder
    rec = _recorder
    if rec is None:
        with _recorder_lock:
            rec = _recorder
            if rec is None:
                rec = _recorder = FlightRecorder()
    return rec


def record(kind: str, op: Optional[str] = None, **detail: Any) -> None:
    """Module-level seam every instrumented layer calls: append one
    event to the process ring. Cheap and never raises."""
    global _recorder
    rec = _recorder
    if rec is None:
        # Creation is rare (once per process); record() itself stays a
        # single attribute check + append afterwards.
        rec = recorder()
    rec.record(kind, op, **detail)


def reset_for_tests(ring_size: Optional[int] = None) -> FlightRecorder:
    """Replace the process recorder (test aid; production never calls)."""
    global _recorder
    with _recorder_lock:
        _recorder = FlightRecorder(ring_size=ring_size)
    return _recorder


# ------------------------------------------------------- exit persistence

_handlers_installed = False


def _flush_at_exit() -> None:
    rec = _recorder
    if rec is not None:
        rec.record("process_exit")
        rec.maybe_flush(force=True)


def _install_exit_handlers() -> None:
    """atexit + SIGTERM: flush the ring on every CATCHABLE exit.
    SIGKILL cannot be caught by design — that is why the periodic flush
    cadence, not a handler, is the loss bound. Installed once, lazily,
    at the first take (not at import: a library must not take over
    process signal handling just by being imported). The flush-then-die
    SIGTERM handler is installed ONLY when SIGTERM still has its
    default disposition — an application that ignores or handles
    SIGTERM itself keeps its semantics untouched, and relies on the
    periodic cadence (plus atexit on clean exits) instead."""
    global _handlers_installed
    if _handlers_installed:
        return
    _handlers_installed = True
    atexit.register(_flush_at_exit)
    try:
        prev = signal.getsignal(signal.SIGTERM)
        if prev is not signal.SIG_DFL:
            # The application (or a C extension — getsignal() returns
            # None then) already decided what SIGTERM means: ignoring
            # it, or handling it itself. An observability library must
            # not change process-lifetime semantics, so only the
            # default-death case gets the flush-then-die handler; the
            # rest rely on the periodic cadence (and atexit, when the
            # app's own handling exits cleanly).
            return

        def _on_sigterm(signum, frame):
            rec = _recorder
            if rec is not None:
                # record_nowait + the timeout acquires inside
                # maybe_flush: the handler may be interrupting the very
                # frame that holds a recorder lock — never block on one.
                rec.record_nowait("sigterm")
                rec.maybe_flush(force=True)
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError, RuntimeError):
        # Not the main thread (or an embedded interpreter): atexit still
        # covers normal exits; SIGTERM then behaves like SIGKILL and the
        # cadence bound applies.
        logger.debug("flight SIGTERM handler not installed", exc_info=True)


# ---------------------------------------------------------------- reader


def parse_flight_log(text: str) -> Optional[Dict[str, Any]]:
    """One rank's flushed log → ``{"meta": {...}, "events": [...]}``.
    Tolerant: unparseable lines are skipped (the writer renames
    atomically, but a reader must survive anything)."""
    meta: Optional[Dict[str, Any]] = None
    events: List[Dict[str, Any]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except Exception:
            continue
        if not isinstance(doc, dict):
            continue
        if doc.get("k") == "meta":
            meta = doc
        else:
            events.append(doc)
    if meta is None and not events:
        return None
    return {"meta": meta or {}, "events": events}


def load_flight_logs(
    path: str,
    files: Optional[Dict[str, int]] = None,
    resources: Optional[Tuple[Any, Any]] = None,
) -> Dict[int, Dict[str, Any]]:
    """All ranks' flight logs for ``path``: the destination sidecar
    first (read through the storage plugin, so any listable backend
    works), falling back to the local TPUSNAP_TELEMETRY_DIR copies.
    Returns ``{rank: {"meta", "events"}}``; empty when no flight data
    exists anywhere."""
    import asyncio

    from .io_types import ReadIO

    out: Dict[int, Dict[str, Any]] = {}
    owns = resources is None
    # A caller-provided listing with zero flight entries already proves
    # the destination carries none (flight sidecars are written by
    # DIRECT file I/O into local destinations only, and a backend that
    # cannot list has none either) — skip the plugin entirely and go
    # straight to the local-copy fallback.
    known_empty = files is not None and not any(
        p.startswith(FLIGHT_DIR + "/") for p in files
    )
    event_loop = storage = None
    try:
        if not known_empty:
            if owns:
                from .storage_plugin import (
                    url_to_storage_plugin_in_event_loop,
                )

                event_loop = asyncio.new_event_loop()
                storage = url_to_storage_plugin_in_event_loop(
                    path, event_loop
                )
            else:
                event_loop, storage = resources
            if files is None:
                try:
                    files = storage.sync_list_with_sizes(event_loop)
                except Exception:
                    files = None
        names = (
            [p for p in files if p.startswith(FLIGHT_DIR + "/")]
            if files is not None
            else []
        )
        for name in sorted(names):
            base = name.rsplit("/", 1)[-1]
            if not (base.startswith("rank_") and base.endswith(".jsonl")):
                continue
            try:
                rank = int(base[len("rank_") : -len(".jsonl")])
            except ValueError:
                continue
            read_io = ReadIO(path=name)
            try:
                storage.sync_read(read_io, event_loop)
                doc = parse_flight_log(
                    read_io.buf.getvalue().decode("utf-8", errors="replace")
                )
            except Exception:
                continue
            if doc is not None:
                out[rank] = doc
    except Exception:
        logger.debug("flight sidecar read failed", exc_info=True)
    finally:
        if owns:
            if storage is not None:
                try:
                    storage.sync_close(event_loop)
                except Exception:
                    logger.debug("flight plugin close failed", exc_info=True)
            if event_loop is not None:
                event_loop.close()
    if out:
        return out
    # Fallback: the local copy dir (remote destinations, or a destroyed
    # destination directory).
    try:
        cdir = local_flight_dir(path)
        for name in sorted(os.listdir(cdir)):
            if not (name.startswith("rank_") and name.endswith(".jsonl")):
                continue
            try:
                rank = int(name[len("rank_") : -len(".jsonl")])
                with open(os.path.join(cdir, name), "r") as f:
                    doc = parse_flight_log(f.read())
            except Exception:
                continue
            if doc is not None:
                out[rank] = doc
    except OSError:
        pass
    return out


def _event_wall(meta: Dict[str, Any], t: float) -> float:
    return float(meta.get("wall_anchor", 0.0)) + (
        t - float(meta.get("mono_anchor", 0.0))
    )


# Barrier-release event kinds usable as cross-rank clock anchors: every
# rank records the SAME op string for the same barrier, at (nearly) the
# same instant — release propagation is bounded by the polling barrier's
# 50 ms poll, which is the floor of the reported skew bound.
_ANCHOR_KINDS = ("barrier_exit",)


def estimate_skew(
    logs: Dict[int, Dict[str, Any]],
) -> Dict[int, Dict[str, Any]]:
    """Barrier-anchored clock-skew estimate per rank, relative to the
    lowest-numbered rank with data: for every shared barrier anchor the
    two ranks both logged, the wall-time delta at its release is a skew
    sample; the median is the offset (ADDED to the rank's wall times to
    align them) and the max deviation from it is the ± bound. Ranks
    without shared anchors get offset 0 and ``anchors == 0`` — their
    ordering against other ranks is wall-clock-trust only."""
    if not logs:
        return {}
    ref_rank = min(logs)
    ref = logs[ref_rank]

    def anchor_walls(doc: Dict[str, Any]) -> Dict[str, float]:
        meta = doc.get("meta") or {}
        out: Dict[str, float] = {}
        for ev in doc.get("events") or []:
            if ev.get("k") in _ANCHOR_KINDS and ev.get("op"):
                # Last release of a given anchor wins (anchors are
                # sequence-numbered, so repeats only happen on ring
                # eviction edge cases).
                out[str(ev["op"])] = _event_wall(meta, float(ev["t"]))
        return out

    ref_anchors = anchor_walls(ref)
    skew: Dict[int, Dict[str, Any]] = {
        ref_rank: {"offset_s": 0.0, "bound_s": 0.0, "anchors": None}
    }
    for rank, doc in logs.items():
        if rank == ref_rank:
            continue
        theirs = anchor_walls(doc)
        shared = sorted(set(ref_anchors) & set(theirs))
        if not shared:
            skew[rank] = {"offset_s": 0.0, "bound_s": None, "anchors": 0}
            continue
        deltas = sorted(ref_anchors[a] - theirs[a] for a in shared)
        offset = deltas[len(deltas) // 2]
        bound = max(abs(d - offset) for d in deltas)
        skew[rank] = {
            "offset_s": round(offset, 6),
            "bound_s": round(bound, 6),
            "anchors": len(shared),
        }
    return skew


def merge_timeline(
    logs: Dict[int, Dict[str, Any]],
    skew: Optional[Dict[int, Dict[str, Any]]] = None,
) -> List[Dict[str, Any]]:
    """All ranks' events merged into one causally-ordered list. Each
    event gains ``rank`` and ``wall`` (the skew-aligned wall time);
    ordering is by aligned wall time, tie-broken by rank."""
    skew = skew if skew is not None else estimate_skew(logs)
    merged: List[Dict[str, Any]] = []
    for rank, doc in logs.items():
        meta = doc.get("meta") or {}
        offset = (skew.get(rank) or {}).get("offset_s") or 0.0
        for ev in doc.get("events") or []:
            try:
                wall = _event_wall(meta, float(ev["t"])) + offset
            except Exception:
                continue
            out = dict(ev)
            out["rank"] = rank
            out["wall"] = wall
            merged.append(out)
    merged.sort(key=lambda e: (e["wall"], e["rank"]))
    return merged


def _journal_evidence(
    files: Optional[Dict[str, int]],
    path: str,
    resources: Optional[Tuple[Any, Any]] = None,
) -> Dict[int, Dict[str, Any]]:
    """Per-rank blob-completion evidence from ``journal.d``: how many
    blobs each rank PROVABLY finished writing, and their bytes —
    cross-checked against the listing like salvage does (a record whose
    blob is gone or resized does not count as written evidence)."""
    import asyncio

    from .io_types import JOURNAL_RECORDS_DIR, ReadIO

    out: Dict[int, Dict[str, Any]] = {}
    if files is None:
        return out
    rec_files = sorted(
        p for p in files if p.startswith(JOURNAL_RECORDS_DIR + "/")
    )
    if not rec_files:
        return out
    owns = resources is None
    event_loop = storage = None
    try:
        if owns:
            from .storage_plugin import url_to_storage_plugin_in_event_loop

            event_loop = asyncio.new_event_loop()
            storage = url_to_storage_plugin_in_event_loop(path, event_loop)
        else:
            event_loop, storage = resources
        for rec_path in rec_files:
            base = rec_path.rsplit("/", 1)[-1]
            if not base.startswith("rank_") or ".tmp." in base:
                continue
            try:
                rank = int(base[len("rank_") :])
            except ValueError:
                continue
            read_io = ReadIO(path=rec_path)
            try:
                storage.sync_read(read_io, event_loop)
                recs = json.loads(read_io.buf.getvalue().decode("utf-8"))
            except Exception:
                continue
            if not isinstance(recs, dict):
                continue
            blobs = bytes_done = 0
            for loc, rec in recs.items():
                try:
                    n = int(rec[0])
                except (IndexError, TypeError, ValueError):
                    continue
                if files.get(loc) == n:
                    blobs += 1
                    bytes_done += n
            out[rank] = {"blobs_completed": blobs, "bytes_completed": bytes_done}
    except Exception:
        logger.debug("journal evidence read failed", exc_info=True)
    finally:
        if owns:
            if storage is not None:
                try:
                    storage.sync_close(event_loop)
                except Exception:
                    logger.debug("flight plugin close failed", exc_info=True)
            if event_loop is not None:
                event_loop.close()
    return out


def postmortem_verdict(
    path: str,
    state: str,
    logs: Dict[int, Dict[str, Any]],
    world_size: Optional[int] = None,
    journal_evidence: Optional[Dict[int, Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """The forensic verdict for a torn (or otherwise uncommitted) path:
    per rank — the last event, the flushed live context (last completed
    phase, in-flight op, bytes staged/written vs planned), the
    journal.d completion evidence, stall episodes — plus the
    missing-rank set (ranks the take's world size expected but no
    flight log survived for: SIGKILLed before their first flush, a
    remote destination, or a host whose disk died with it)."""
    journal_evidence = journal_evidence or {}
    if world_size is None:
        sizes = [
            (d.get("meta") or {}).get("world_size") for d in logs.values()
        ]
        sizes = [s for s in sizes if isinstance(s, int)]
        world_size = max(sizes) if sizes else (max(logs) + 1 if logs else 0)
    ranks: Dict[int, Dict[str, Any]] = {}
    for rank, doc in sorted(logs.items()):
        meta = doc.get("meta") or {}
        events = doc.get("events") or []
        ctx = meta.get("context") or {}
        last = events[-1] if events else None
        flush_mono = meta.get("flush_mono")
        r: Dict[str, Any] = {
            "last_event": (
                {
                    "k": last.get("k"),
                    "op": last.get("op"),
                    "wall": _event_wall(meta, float(last["t"])),
                    # How stale the tail can be: the flush wrote this
                    # log flush_age seconds after the last event — and
                    # up to one flush interval of NEWER events died with
                    # the process.
                    "flush_age_s": (
                        round(float(flush_mono) - float(last["t"]), 3)
                        if flush_mono is not None
                        else None
                    ),
                }
                if last is not None
                else None
            ),
            "phase": ctx.get("phase"),
            "inflight_op": ctx.get("op"),
            "inflight_ops": ctx.get("ops"),
            "state": ctx.get("state", "running"),
            "bytes_planned": ctx.get("bytes_planned"),
            "bytes_staged": ctx.get("bytes_staged"),
            "bytes_written": ctx.get("bytes_written"),
            "percent": ctx.get("percent"),
            "stall_episodes": sum(
                1 for e in events if e.get("k") == "stall"
            ),
            # Peers THIS rank's liveness monitor declared dead (lease
            # expired) — the black box's dead-vs-slow distinction.
            "dead_ranks_seen": sorted(
                {
                    e.get("rank")
                    for e in events
                    if e.get("k") == "rank_dead"
                    and isinstance(e.get("rank"), int)
                }
            )
            or None,
            # Ranks observed announcing a graceful departure (a
            # ``rank_left`` event — their own, or a peer's observation):
            # LEFT, not DEAD, in every rendering.
            "left_ranks_seen": sorted(
                {
                    e.get("rank")
                    for e in events
                    if e.get("k") == "rank_left"
                    and isinstance(e.get("rank"), int)
                }
            )
            or None,
            "events": len(events),
            "dropped": meta.get("dropped", 0),
            "take_id": meta.get("take_id"),
        }
        if rank in journal_evidence:
            r["journal"] = journal_evidence[rank]
        ranks[rank] = r
    missing = sorted(set(range(world_size)) - set(logs))
    # The union of every survivor's lease-expiry observations: the
    # ranks the take DIED on, as opposed to ranks whose log merely
    # never flushed (missing_ranks covers those too).
    dead: set = set()
    left: set = set()
    for r in ranks.values():
        dead.update(r.get("dead_ranks_seen") or ())
        left.update(r.get("left_ranks_seen") or ())
    # A rank that announced departure before its lease went stale LEFT;
    # it must never be reported dead (the whole point of the `left`
    # lease state).
    dead -= left
    return {
        "path": path,
        "state": state,
        "world_size": world_size,
        "ranks": ranks,
        "missing_ranks": missing,
        "dead_ranks": sorted(dead),
        "left_ranks": sorted(left),
        "stall_episodes": sum(
            r["stall_episodes"] for r in ranks.values()
        ),
    }


def make_tick_hook(
    rec: FlightRecorder,
) -> Callable[[Optional[Dict[str, Any]]], None]:
    """The heartbeat pump's flush hook: refresh the live context from
    the pump's progress record (when it built one this tick) and run
    the throttled flush. Never raises."""

    def hook(record_ctx: Optional[Dict[str, Any]]) -> None:
        try:
            if record_ctx is not None:
                rec.set_context(
                    {
                        k: record_ctx.get(k)
                        for k in (
                            "state",
                            "phase",
                            "op",
                            "ops",
                            "bytes_planned",
                            "bytes_staged",
                            "bytes_written",
                            "percent",
                        )
                    }
                )
            rec.maybe_flush()
        except Exception:
            logger.debug("flight tick hook failed", exc_info=True)

    return hook
