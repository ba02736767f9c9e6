"""Checkpoint SLOs: continuous RPO/RTO tracking + data-at-risk accounting.

A checkpointing system exists to bound two numbers — how much work a
crash loses (the recovery-point objective, RPO) and how long recovery
takes (the recovery-time objective, RTO). This module is that
instrument (counterpart of tpusnap/slo.py, vendored with the same
sidecar and gauge formats), fed entirely from seams that already exist:

- **Commit anchor** — both commit paths (``Snapshot.take`` and the
  async drain's ``_body_impl``) call :meth:`SLOTracker.record_commit`
  strictly after the metadata write, anchoring
  ``last_commit`` (monotonic + wall), the committed snapshot's payload
  bytes and take_id, and the commit interval (the realized RPO of the
  interval that just closed).
- **Data-at-risk accumulator** — bytes mutated since that anchor.
  Three evidence tiers, best available wins: an explicit
  :func:`record_step` call from the training loop (exact), the
  incremental take's dual-hash change stats (planned bytes minus
  ``scheduler.dedup_skipped_bytes`` — what the CRC32C+XXH64 pass proved
  unchanged costs nothing to lose), or the take's planned payload bytes
  (full takes: everything staged is at risk until committed).
- **RTO estimator** — committed snapshot bytes over the trailing-median
  restore READ throughput from ``history.jsonl`` (same trailing-window
  shape as ``history --check``; fewer than ``min_baseline`` comparable
  restore events → no verdict, exit 3 at the CLI), plus the trailing
  median of the restores' non-read overhead (plan/targets/load/metadata
  phases). No cold filtering on purpose: a real crash recovery IS a
  cold process.

Publication rides the heartbeat pump — no new threads:
:func:`attach_to_take` registers a :meth:`ProgressMonitor.add_tick_hook`
that, at heartbeat cadence, refreshes the state, rewrites a local
sidecar (``TPUSNAP_TELEMETRY_DIR/slo/rank_<k>.json``, atomic
temp+rename — what ``python -m tpusnap_torch slo`` reads), pushes the
``tpusnap_rpo_seconds`` / ``tpusnap_data_at_risk_bytes`` /
``tpusnap_estimated_rto_seconds`` / ``tpusnap_commit_interval_seconds``
gauges through the registered metrics sinks
(:class:`~tpusnap_torch.metrics_export.PrometheusTextfileSink` implements
``on_slo_update``), and — on rank 0 of a multi-process take — folds a
fleet worst-case view from the heartbeat records every rank already
publishes to the coordination KV (one ``try_get_dir`` per beat, no new
keys, no new lifecycle). The same hook feeds the per-rank heartbeat
record (``rec["slo"]``) so ``tpusnap watch`` shows exposure, not just
progress. Each commit records an ``slo`` section into the take's
history event, and threshold crossings (``TPUSNAP_SLO_RPO_S`` /
``TPUSNAP_SLO_RTO_S``, 0 = unset) emit one edge-triggered
``slo_breach`` flight event + ``slo.breaches`` counter per episode.

Everything here is best-effort observability: a tracker failure can
never fail a take, and the CLI treats absent records as evidence gaps
(exit 3), not errors.

Monotonic-only invariant (same scope as telemetry/progress/
history/flight): in-process durations run on the injectable monotonic
``clock``; wall-clock TIMESTAMPS go through the module's injectable
``_wall`` seam — the one cross-process computation (the CLI's
time-since-commit against a possibly-dead process's record) is a wall
timestamp difference by necessity, and says so.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from .knobs import (
    get_heartbeat_interval_s,
    get_job_id,
    get_slo_rpo_threshold_s,
    get_slo_rto_threshold_s,
    get_slo_stream_cadence_x,
    get_telemetry_dir,
)

logger = logging.getLogger(__name__)

# Wall-clock seam: timestamps only (record anchors, sidecar staleness);
# in-process duration math runs on the monotonic clock — direct
# wall-clock CALLS are forbidden here; only this bare
# reference is allowed.
_wall = time.time

SLO_DIRNAME = "slo"


def slo_dir(base: Optional[str] = None) -> str:
    """Local directory holding the per-rank SLO state sidecars (under
    the telemetry dir — per-host, like ``history.jsonl``)."""
    return os.path.join(base or get_telemetry_dir(), SLO_DIRNAME)


def slo_rank_path(rank: int, base: Optional[str] = None) -> str:
    return os.path.join(slo_dir(base), f"rank_{rank}.json")


# --------------------------------------------------------- RTO estimator


@dataclass
class RTOEstimate:
    """One restore-time estimate. ``ok`` is False when there was not
    enough comparable restore history to form one at all (the CLI's
    exit-3 leg, mirroring ``history --check``)."""

    ok: bool
    reason: str
    seconds: Optional[float] = None
    read_gbps: Optional[float] = None
    overhead_s: Optional[float] = None
    n_baseline: int = 0
    # What priced the estimate: "history" (trailing restore medians) or
    # "probe" (the read-lane pipe ceiling — the cold-start fallback when
    # no comparable restore has run on this host yet).
    source: str = "history"

    def to_json(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "reason": self.reason,
            "seconds": self.seconds,
            "read_gbps": self.read_gbps,
            "overhead_s": self.overhead_s,
            "n_baseline": self.n_baseline,
            "source": self.source,
        }


def _load_recent_restore_events(
    max_bytes: int = 256 * 1024,
) -> List[Dict[str, Any]]:
    """The newest restore-shaped history events, parsed from only the
    file's TAIL: the estimator needs a 20-event trailing window, and a
    per-take parse of the whole (multi-MB-bounded) history.jsonl is
    exactly the kind of cost the ≤10% take-overhead guard exists to
    forbid. A partial first line (mid-file seek) is dropped like any
    torn line."""
    from .history import history_path

    path = history_path()
    out: List[Dict[str, Any]] = []
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            start = max(size - max_bytes, 0)
            f.seek(start)
            data = f.read()
    except OSError:
        return out
    lines = data.split(b"\n")
    if start > 0 and len(lines) > 1:
        lines = lines[1:]  # almost surely partial: mid-file seek
    for ln in lines:
        # Cheap pre-filter: the estimator only consumes restore events,
        # and json-parsing thousands of take lines per refresh is the
        # bulk of the tail cost (a take whose PATH contains "restore"
        # parses too — harmless, the kind filter drops it).
        if b"restore" not in ln:
            continue
        try:
            ev = json.loads(ln)
        except Exception:
            continue
        if isinstance(ev, dict):
            out.append(ev)
    return out


def _probe_read_ceiling(
    backend: Optional[str], events: List[Dict[str, Any]]
) -> Optional[float]:
    """Best read-lane throughput ceiling available without restore
    history: the in-process probe registry first (populated when
    TPUSNAP_PROBE ran in this process — the sidecar path), else the
    median ``probe_read_gbps`` of whatever history events exist (the
    CLI path, where the registry is empty). Backend labels in the
    registry may carry a tier suffix (``Plugin@tier``), hence the
    prefix match."""
    try:
        from .compress import pipe_ceilings_snapshot

        matches = [
            gbps
            for (label, lane), gbps in pipe_ceilings_snapshot().items()
            if lane == "read"
            and (
                backend is None
                or label == backend
                or label.startswith(backend + "@")
            )
        ]
        if matches:
            return max(matches)
    except Exception:
        pass
    vals = [
        float(e["probe_read_gbps"])
        for e in events
        if isinstance(e.get("probe_read_gbps"), (int, float))
        and (backend is None or e.get("plugin") == backend)
    ]
    if vals:
        return statistics.median(vals)
    return None


def estimate_rto(
    snapshot_bytes: int,
    events: Optional[List[Dict[str, Any]]] = None,
    *,
    window: int = 20,
    min_baseline: int = 3,
    rank: Optional[int] = 0,
    backend: Optional[str] = None,
) -> RTOEstimate:
    """Estimate the wall-clock of restoring ``snapshot_bytes`` from the
    trailing restore history: bytes over the median restore READ
    throughput (the ``restore.read`` phase when recorded, else the
    whole wall) plus the median non-read overhead (plan/targets/
    prepare/load — the part that does not scale with bytes). Comparable
    = ``kind == "restore"``, matching rank (default 0), positive
    bytes and wall. Cold restores are NOT filtered out: crash recovery
    is a cold process, and an estimator that only saw warm restores
    would flatter the fleet.

    ``backend`` (a storage-plugin class label, e.g. ``S3StoragePlugin``)
    restricts the baseline to restores that read from that backend —
    the tier-aware leg: a write-back-tiered snapshot whose local cache
    was evicted restores from the REMOTE tier, and pricing it with
    local-disk history would understate the RTO by the disk/cloud
    throughput ratio. Events recorded before the backend label existed
    carry none and are excluded by the filter (no verdict beats a wrong
    one)."""
    if events is None:
        events = _load_recent_restore_events()
    cand = [
        e
        for e in events
        if e.get("kind") == "restore"
        and (rank is None or e.get("rank", 0) == rank)
        and (backend is None or e.get("plugin") == backend)
        and (e.get("bytes") or 0) > 0
        and (e.get("wall_s") or 0) > 0
    ][-window:]
    if len(cand) < max(1, min_baseline):
        # Cold-start fallback: a host that has never restored still has a
        # read-lane probe ceiling if TPUSNAP_PROBE ran during any take or
        # restore — the probe streams through the same composed plugin
        # stack, so bytes/ceiling is an honest (overhead-free, hence
        # optimistic) RTO floor. Better labelled "probe" than exit-3.
        ceiling = _probe_read_ceiling(backend, events)
        if ceiling is not None and ceiling > 0:
            return RTOEstimate(
                ok=True,
                reason=(
                    f"probe read ceiling {ceiling:.2f} GB/s"
                    + (f" for backend {backend}" if backend else "")
                    + f" (only {len(cand)} comparable restore event(s); "
                    "no per-restore overhead term)"
                ),
                seconds=round(snapshot_bytes / 1e9 / ceiling, 3),
                read_gbps=round(ceiling, 4),
                overhead_s=0.0,
                n_baseline=len(cand),
                source="probe",
            )
        return RTOEstimate(
            ok=False,
            reason=(
                f"only {len(cand)} comparable restore event(s) in history"
                + (f" for backend {backend}" if backend else "")
                + f"; need {min_baseline} to estimate RTO"
            ),
            n_baseline=len(cand),
        )
    gbps_vals: List[float] = []
    overhead_vals: List[float] = []
    for e in cand:
        wall = float(e["wall_s"])
        nbytes = float(e["bytes"])
        read_s = (e.get("phases_s") or {}).get("restore.read")
        if not isinstance(read_s, (int, float)) or read_s <= 0:
            read_s = wall
        gbps_vals.append(nbytes / read_s / 1e9)
        overhead_vals.append(max(wall - read_s, 0.0))
    read_gbps = statistics.median(gbps_vals)
    overhead_s = statistics.median(overhead_vals)
    if read_gbps <= 0:
        return RTOEstimate(
            ok=False,
            reason="restore history carries zero read throughput",
            n_baseline=len(cand),
        )
    seconds = snapshot_bytes / 1e9 / read_gbps + overhead_s
    return RTOEstimate(
        ok=True,
        reason=(
            f"{len(cand)}-event trailing median: "
            f"{read_gbps:.2f} GB/s read + {overhead_s:.2f}s overhead"
        ),
        seconds=round(seconds, 3),
        read_gbps=round(read_gbps, 4),
        overhead_s=round(overhead_s, 4),
        n_baseline=len(cand),
    )


# -------------------------------------------------------------- tracker


class SLOTracker:
    """Per-process SLO state machine. One instance per process (see
    :func:`tracker`); every method is thread-safe (the pump's tick hook
    runs on the heartbeat thread, ``record_commit`` on the main or the
    async commit thread, ``record_step`` on the training loop).

    ``clock``/``wall`` are injectable so the unit tests drive RPO/
    interval math on fake clocks with zero sleeps."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
    ) -> None:
        self._clock = clock
        self._wall_fn = wall
        self._lock = threading.Lock()
        self._start_mono = clock()
        self._start_wall = wall()
        self.rank = 0
        self.world_size = 1
        # Commit anchor.
        self._commit_mono: Optional[float] = None
        self._commit_wall: Optional[float] = None
        self._commit_take_id: Optional[str] = None
        self._commit_path: Optional[str] = None
        self._commit_interval_s: Optional[float] = None
        self._snapshot_bytes: int = 0
        # Data-at-risk evidence tiers (reset per commit).
        self._explicit_bytes: int = 0
        self._planned_bytes: int = 0
        self._planned_incremental = False
        self._last_change_bytes: Optional[int] = None
        # Capture slot of the in-flight take (take_id-guarded): a
        # committed snapshot holds state as of its CAPTURE (staging),
        # not its commit — an async take's drain can run minutes, and
        # anchoring RPO at commit time would zero out exposure the
        # snapshot does not actually cover. note_planned fills it;
        # record_commit consumes it when the ids match.
        self._capture: Optional[Dict[str, Any]] = None
        # Live counter feed of the in-flight take (dual-hash change
        # stats for incremental takes); None between takes.
        self._live_counters: Optional[Callable[[], Dict[str, int]]] = None
        # Cached RTO estimate (refreshed at attach/commit, never per
        # tick — the estimator reads history.jsonl; the stat key skips
        # even that read when the file hasn't changed).
        self._rto = RTOEstimate(ok=False, reason="no commit yet")
        self._rto_key: Optional[tuple] = None
        # Edge-triggered breach episodes.
        self._breached: Dict[str, bool] = {"rpo": False, "rto": False}
        # Active delta stream's cadence (tpusnap.delta): micro-commits
        # anchor the RPO like any commit; the cadence published here is
        # the CONFIGURED bound a healthy stream keeps rpo_s under, so
        # readers can tell "seconds-scale by design" from "minutes-scale
        # between takes". None = no stream active.
        self._stream_cadence_s: Optional[float] = None
        # Sidecar write throttle (monotonic) + write serialization: the
        # pump's tick hook and a commit thread's forced publish share
        # one per-pid temp filename — unserialized, the second open
        # truncates the first's partial write and the "atomic" rename
        # installs torn JSON (the same race metrics_export._absorb
        # holds its lock for).
        self._last_sidecar_t: Optional[float] = None
        self._publish_lock = threading.Lock()
        self._fleet: Optional[Dict[str, Any]] = None
        # Peer ranks declared dead by the liveness layer during the
        # current take (tpusnap.liveness.LivenessMonitor feeds this);
        # cleared when a take commits or aborts — a dead peer from a
        # finished take is history, not live exposure.
        self._dead_ranks: set = set()

    # --- inputs ---------------------------------------------------------

    def configure(self, rank: int, world_size: int) -> None:
        with self._lock:
            self.rank = rank
            self.world_size = world_size

    def note_rank_dead(self, ranks) -> None:
        """Liveness feed: ``ranks``' leases expired during the current
        take. Rides the sidecar/gauges until the take settles."""
        with self._lock:
            self._dead_ranks.update(int(r) for r in ranks)

    def record_step(self, bytes_changed: int) -> None:
        """Training-loop API: declare that ``bytes_changed`` bytes of
        checkpointable state were mutated since the last call — the
        exact evidence tier of the data-at-risk accumulator."""
        if bytes_changed > 0:
            with self._lock:
                self._explicit_bytes += int(bytes_changed)

    def note_planned(
        self,
        nbytes: int,
        incremental: bool,
        live_counters: Optional[Callable[[], Dict[str, int]]] = None,
        take_id: Optional[str] = None,
    ) -> None:
        """Take-path seam (where the heartbeat's ``set_bytes_planned``
        already sits): the in-flight take's payload bytes become the
        data-at-risk floor until its commit clears them. For
        incremental takes the live dual-hash change stats
        (``live_counters`` → ``scheduler.dedup_skipped_bytes``) refine
        the figure as staging proves tiles unchanged. Also records the
        take's CAPTURE anchor — the instant whose state the eventual
        commit makes durable — so the RPO clock and the explicit-step
        accumulator stay honest across a long async drain."""
        with self._lock:
            self._planned_bytes = max(self._planned_bytes, int(nbytes))
            self._planned_incremental = incremental
            self._live_counters = live_counters
            self._capture = {
                "take_id": take_id,
                "mono": self._clock(),
                "wall": self._wall_fn(),
                "explicit_before": self._explicit_bytes,
            }
            have_estimate = self._rto.ok
        if not have_estimate:
            # First take of the process: no commit has sized the
            # estimator yet, but a crash DURING this take restores
            # roughly these bytes — price them now so the pre-crash
            # gauge is live (the crash-matrix acceptance reads it).
            self.refresh_rto()

    def note_stream(self, cadence_s: Optional[float]) -> None:
        """A delta stream opened (``cadence_s`` set) or closed (None):
        the configured micro-commit cadence rides the published state so
        dashboards can grade ``rpo_s`` against the stream's own bound
        rather than a fleet-wide threshold."""
        with self._lock:
            self._stream_cadence_s = (
                float(cadence_s) if cadence_s else None
            )

    def note_take_aborted(self) -> None:
        """Abort-path bookkeeping (the take's ``on_failure``): release
        the dead take's telemetry record — its counters must not stay
        referenced for the process lifetime — WITHOUT clearing the
        exposure: nothing committed, so the planned bytes are still at
        risk. The incremental refinement is frozen at its last observed
        value (the dual-hash skip evidence stays valid: the base holds
        those unchanged bytes regardless of the abort)."""
        with self._lock:
            if self._live_counters is not None:
                try:
                    skipped = self._live_counters().get(
                        "scheduler.dedup_skipped_bytes", 0
                    )
                except Exception:
                    skipped = 0
                if self._planned_incremental:
                    self._planned_bytes = max(self._planned_bytes - skipped, 0)
            self._live_counters = None
            self._planned_incremental = False
            # The aborted take's capture anchor is dead — a later
            # commit must not mistake its slot for pending evidence
            # (which would keep exposure standing forever). If a newer
            # overlapping take had overwritten the slot, its commit
            # merely falls back to commit-time anchoring: conservative.
            self._capture = None
            self._dead_ranks.clear()

    def record_commit(
        self,
        take_id: str,
        path: str,
        snapshot_bytes: int,
        incremental: bool = False,
        counters: Optional[Dict[str, int]] = None,
    ) -> Dict[str, Any]:
        """Commit anchor (both commit paths, strictly after the
        metadata write). Closes the interval, clears the at-risk
        accumulators, refreshes the RTO estimate against the bytes just
        committed, force-publishes, and returns the compact ``slo``
        section the take's summary/history event carries."""
        counters = counters or {}
        now = self._clock()
        now_wall = self._wall_fn()
        with self._lock:
            # Anchor at the take's CAPTURE, not its commit: the
            # committed snapshot holds state as of staging, and an
            # async drain between the two can run minutes — work done
            # in that window is NOT in the snapshot and must survive
            # as exposure (explicit steps recorded after capture keep
            # accumulating; RPO restarts from capture time).
            cap = self._capture
            # An unscoped capture (take_id None) matches any commit —
            # the single-slot semantics callers outside the take path
            # get by default.
            matched = cap is not None and cap.get("take_id") in (
                None,
                take_id,
            )
            change = self._interval_change_bytes_locked(
                counters,
                incremental,
                # Drain-window record_step bytes are NOT in this
                # snapshot: the interval's realized change bounds the
                # explicit tier at the capture-time figure, and the
                # remainder stays live exposure for the NEXT event —
                # counted once, not twice.
                explicit_cap=cap["explicit_before"] if matched else None,
            )
            anchor_mono = cap["mono"] if matched else now
            anchor_wall = cap["wall"] if matched else now_wall
            interval = max(
                anchor_mono - self._commit_mono
                if self._commit_mono is not None
                else anchor_mono - self._start_mono,
                0.0,
            )
            self._commit_mono = anchor_mono
            self._commit_wall = anchor_wall
            self._commit_take_id = take_id
            self._commit_path = path
            self._commit_interval_s = interval
            self._snapshot_bytes = int(snapshot_bytes)
            self._last_change_bytes = change
            if matched:
                # Steps recorded before the capture are durable now;
                # drain-window steps remain at risk.
                self._explicit_bytes = max(
                    self._explicit_bytes - cap["explicit_before"], 0
                )
                self._capture = None
                self._planned_bytes = 0
                self._planned_incremental = False
                self._live_counters = None
            else:
                # A newer take's registration is in the slot (or none
                # was made): leave the pending take's evidence alone —
                # clearing it would understate what ITS crash loses —
                # and only reset the explicit tier conservatively if no
                # newer capture exists.
                if cap is None:
                    self._explicit_bytes = 0
                    self._planned_bytes = 0
                    self._planned_incremental = False
                    self._live_counters = None
            self._fleet = None
            self._dead_ranks.clear()
        self.refresh_rto()
        section = {
            "commit_interval_s": round(interval, 3),
            "change_bytes": change,
            "snapshot_bytes": int(snapshot_bytes),
            "estimated_rto_s": self._rto.seconds if self._rto.ok else None,
        }
        self.publish(force=True)
        return section

    def _interval_change_bytes_locked(
        self,
        counters: Dict[str, int],
        incremental: bool,
        explicit_cap: Optional[int] = None,
    ) -> int:
        """Bytes mutated in the interval that just closed — the realized
        data-at-risk the commit cleared. Incremental takes have the
        exact dual-hash answer: at commit, the take-local written
        payload IS the changed set (whole-blob skips never write, slab
        compaction keeps only changed members, tile-grain dedup writes
        only changed tiles); planned-minus-skipped is only the LIVE
        mid-take approximation (it cannot see member/tile grain).
        ``explicit_cap`` bounds the explicit tier at the committed
        take's capture-time value — post-capture steps belong to the
        NEXT interval."""
        explicit = self._explicit_bytes
        if explicit_cap is not None:
            explicit = min(explicit, explicit_cap)
        if incremental:
            written = counters.get("storage.bytes_written", 0)
            if written <= 0:
                skipped = counters.get("scheduler.dedup_skipped_bytes", 0)
                written = max(self._planned_bytes - skipped, 0)
            return max(written, explicit)
        return max(self._planned_bytes, explicit)

    def refresh_rto(self) -> None:
        """Recompute the cached RTO estimate from history (called at
        attach and commit time — never per tick; the estimator reads
        only the history file's tail, and a stat-key cache skips even
        that when nothing changed — the ≤10% take-overhead guard
        budget). Best-effort."""
        with self._lock:
            nbytes = self._snapshot_bytes or self._planned_bytes
        if not nbytes:
            return
        try:
            from .history import history_path

            try:
                st = os.stat(history_path())
                key = (st.st_mtime_ns, st.st_size, nbytes)
            except OSError:
                key = (0, 0, nbytes)
            # Tier-aware pricing: for a write-back-tiered snapshot the
            # estimator must use the history of the tier a restore
            # would ACTUALLY read from — local while the cache is
            # intact, remote once any blob was evicted. None for
            # non-tiered paths (no filter, today's behavior).
            backend = None
            with self._lock:
                path = self._commit_path
            if path:
                try:
                    from .tiering import restore_source_label

                    backend = restore_source_label(path)
                except Exception:
                    backend = None
            with self._lock:
                key = key + (backend,)
                if key == self._rto_key:
                    return
                rank = self.rank
            # THIS rank's restore history: a host running ranks 8-15
            # has no rank-0 events, and its recovery restores its own
            # view under the same disk sharing its peers impose.
            est = estimate_rto(nbytes, rank=rank, backend=backend)
            with self._lock:
                self._rto = est
                self._rto_key = key
        except Exception:
            logger.debug("RTO estimate failed", exc_info=True)

    # --- state ----------------------------------------------------------

    def data_at_risk_bytes(self) -> int:
        """Current worst-case bytes a crash would lose: the best
        available evidence tier (explicit steps / incremental change
        stats / planned payload), conservative max across them."""
        with self._lock:
            planned = self._planned_bytes
            if self._planned_incremental and self._live_counters is not None:
                try:
                    skipped = self._live_counters().get(
                        "scheduler.dedup_skipped_bytes", 0
                    )
                except Exception:
                    skipped = 0
                planned = max(planned - skipped, 0)
            return max(self._explicit_bytes, planned)

    def rpo_s(self, now: Optional[float] = None) -> float:
        """Seconds since the last commit anchor (since tracker start
        when nothing ever committed — everything is at risk)."""
        now = self._clock() if now is None else now
        with self._lock:
            anchor = (
                self._commit_mono
                if self._commit_mono is not None
                else self._start_mono
            )
        return max(now - anchor, 0.0)

    def snapshot_state(self) -> Dict[str, Any]:
        """One consistent, JSON-ready view of the tracker — the sidecar
        record, the sink payload, and the heartbeat sub-dict all derive
        from this."""
        rpo = self.rpo_s()
        at_risk = self.data_at_risk_bytes()
        rpo_thresh = get_slo_rpo_threshold_s()
        rto_thresh = get_slo_rto_threshold_s()
        with self._lock:
            rto = self._rto
            state: Dict[str, Any] = {
                "v": 1,
                "rank": self.rank,
                "world_size": self.world_size,
                "job_id": get_job_id(),
                "pid": os.getpid(),
                "ts": self._wall_fn(),
                "started_ts": self._start_wall,
                "last_commit_ts": self._commit_wall,
                "last_commit_take_id": self._commit_take_id,
                "path": self._commit_path,
                "commit_interval_s": (
                    round(self._commit_interval_s, 3)
                    if self._commit_interval_s is not None
                    else None
                ),
                "rpo_s": round(rpo, 3),
                "data_at_risk_bytes": int(at_risk),
                "last_change_bytes": self._last_change_bytes,
                "snapshot_bytes": self._snapshot_bytes,
                "estimated_rto_s": rto.seconds if rto.ok else None,
                "rto_read_gbps": rto.read_gbps if rto.ok else None,
                "rto_n_baseline": rto.n_baseline,
                "rto_source": rto.source if rto.ok else None,
                "stream_cadence_s": self._stream_cadence_s,
                # Peer ranks the liveness layer declared dead during
                # the current take (tpusnap.liveness) — the slo CLI's
                # `dead` column: an RPO breach with a dead peer is a
                # rank failure, not a slow checkpoint cadence.
                "dead_ranks": sorted(self._dead_ranks) or None,
                "thresholds": {
                    "rpo_s": rpo_thresh or None,
                    "rto_s": rto_thresh or None,
                },
            }
            if self._fleet:
                state["fleet"] = dict(self._fleet)
        state["breach"] = {
            "rpo": bool(rpo_thresh and rpo > rpo_thresh),
            "rto": bool(
                rto_thresh and rto.ok and rto.seconds is not None
                and rto.seconds > rto_thresh
            ),
        }
        return state

    def heartbeat_fields(self) -> Dict[str, Any]:
        """The compact sub-dict the per-rank heartbeat record carries
        (``rec["slo"]``) — what ``tpusnap watch``'s exposure columns
        and rank 0's fleet fold read."""
        with self._lock:
            rto = self._rto
        return {
            "rpo_s": round(self.rpo_s(), 2),
            "data_at_risk_bytes": int(self.data_at_risk_bytes()),
            "estimated_rto_s": rto.seconds if rto.ok else None,
        }

    # --- publication ----------------------------------------------------

    def publish(self, force: bool = False, final: bool = False) -> None:
        """Refresh → breach check → sidecar write (throttled to the
        heartbeat interval unless forced) → sink notify. Never raises.
        ``final`` marks the sidecar as a clean process exit: readers
        then FREEZE the exposure at the record's write time instead of
        growing it live — a finished run is not an incident, while a
        SIGKILLed one (which never writes the marker) correctly keeps
        screaming until someone recovers."""
        try:
            state = self.snapshot_state()
            if final:
                state["final"] = True
        except Exception:
            logger.debug("slo state build failed", exc_info=True)
            return
        self._check_breaches(state)
        now = self._clock()
        with self._lock:
            due = (
                force
                or self._last_sidecar_t is None
                or now - self._last_sidecar_t >= get_heartbeat_interval_s()
            )
            if due:
                self._last_sidecar_t = now
        if due:
            with self._publish_lock:
                try:
                    self._write_sidecar(state)
                    _arm_atexit_finalizer()
                except Exception:
                    logger.debug("slo sidecar write failed", exc_info=True)
                try:
                    from . import telemetry

                    telemetry.notify_slo_update(state)
                except Exception:
                    logger.debug("slo sink notify failed", exc_info=True)

    def _write_sidecar(self, state: Dict[str, Any]) -> None:
        d = slo_dir()
        os.makedirs(d, exist_ok=True)
        path = slo_rank_path(state["rank"])
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, path)

    def _check_breaches(self, state: Dict[str, Any]) -> None:
        """Edge-triggered: ONE flight event + counter per breach
        episode per objective; recovery re-arms."""
        for key in ("rpo", "rto"):
            breached = state["breach"][key]
            with self._lock:
                fire = breached and not self._breached[key]
                self._breached[key] = breached
            if fire:
                try:
                    from . import flight, telemetry

                    telemetry.incr("slo.breaches")
                    flight.record(
                        "slo_breach",
                        op=key,
                        rpo_s=state["rpo_s"],
                        data_at_risk_bytes=state["data_at_risk_bytes"],
                        estimated_rto_s=state["estimated_rto_s"],
                        threshold_s=state["thresholds"][f"{key}_s"],
                    )
                except Exception:
                    logger.debug("slo breach record failed", exc_info=True)
                logger.warning(
                    "tpusnap SLO breach: %s — rpo %.1fs, %d bytes at risk, "
                    "estimated RTO %s (thresholds rpo=%s rto=%s)",
                    key.upper(),
                    state["rpo_s"],
                    state["data_at_risk_bytes"],
                    state["estimated_rto_s"],
                    state["thresholds"]["rpo_s"],
                    state["thresholds"]["rto_s"],
                )

    def make_tick_hook(self, take_id: str, kv=None):
        """The :meth:`ProgressMonitor.add_tick_hook` piggyback: publish
        at the pump's own publish cadence (``record is not None`` — the
        same delta-throttle + keep-alive the heartbeat uses), and on
        rank 0 of a multi-process take fold the fleet worst-case view
        from the heartbeat records every rank already published to the
        KV (no new keys: the slo sub-dict rides ``rec["slo"]``)."""

        def hook(record: Optional[Dict[str, Any]]) -> None:
            if record is None:
                return
            if kv is not None and self.rank == 0 and self.world_size > 1:
                self._fold_fleet(take_id, kv)
            self.publish()

        return hook

    def _fold_fleet(self, take_id: str, kv) -> None:
        try:
            # A TCPStore cannot list: the heartbeat keys are named.
            prefix = f"tpusnap_progress/{take_id}/"
            blobs = kv.try_get_dir(
                prefix, keys=[f"{prefix}{r}" for r in range(self.world_size)]
            )
        except Exception:
            blobs = None
        if not blobs:
            return
        rpo, at_risk, rto, ranks = 0.0, 0, None, 0
        now_wall = self._wall_fn()
        for raw in blobs.values():
            try:
                rec = json.loads(raw)
                s = rec.get("slo")
            except Exception:
                continue
            if not isinstance(s, dict):
                continue
            ranks += 1
            # A hung rank's frozen heartbeat must not freeze the fleet
            # gauge: its true exposure is the published figure PLUS how
            # stale the record is (same correction the watch table
            # applies per row).
            staleness = max(now_wall - (rec.get("ts") or now_wall), 0.0)
            rpo = max(rpo, float(s.get("rpo_s") or 0.0) + staleness)
            at_risk = max(at_risk, int(s.get("data_at_risk_bytes") or 0))
            r = s.get("estimated_rto_s")
            if isinstance(r, (int, float)):
                rto = max(rto, float(r)) if rto is not None else float(r)
        if not ranks:
            return
        with self._lock:
            self._fleet = {
                "ranks": ranks,
                "rpo_s": round(rpo, 2),
                "data_at_risk_bytes": at_risk,
                "estimated_rto_s": rto,
            }


# ------------------------------------------------- process-global wiring

_tracker: Optional[SLOTracker] = None
_tracker_lock = threading.Lock()
_atexit_armed = False
_crashed = False


def _arm_atexit_finalizer() -> None:
    """Register the clean-exit sidecar finalizer, once, and only for
    processes that actually published SLO state (an importing process
    that never took a snapshot must not grow a sidecar at exit). An
    unhandled exception ALSO runs atexit, so the chained excepthook
    below is what keeps a crashed-by-exception process from being
    stamped as a clean exit — the gate must keep screaming about it."""
    global _atexit_armed
    with _tracker_lock:
        if _atexit_armed:
            return
        _atexit_armed = True
    import atexit
    import sys

    prev_hook = sys.excepthook

    def _crash_hook(exc_type, exc, tb):
        global _crashed
        _crashed = True
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _crash_hook
    atexit.register(_finalize_on_exit)


def _finalize_on_exit() -> None:
    with _tracker_lock:
        t = _tracker
    if t is None or _crashed:
        # Crashed-by-exception: leave the last live record standing so
        # readers keep growing its exposure, exactly like a SIGKILL.
        return
    try:
        t.publish(force=True, final=True)
    except Exception:
        pass


def tracker() -> SLOTracker:
    """The process-global tracker (created on first use)."""
    global _tracker
    with _tracker_lock:
        if _tracker is None:
            _tracker = SLOTracker()
        return _tracker


def reset_tracker() -> None:
    """Test aid; production code never resets."""
    global _tracker
    with _tracker_lock:
        _tracker = None


def record_step(bytes_changed: int) -> None:
    """Training-loop API: ``tpusnap_torch.slo.record_step(bytes_changed=N)``
    after each optimizer step makes the data-at-risk gauge exact
    instead of take-granular."""
    tracker().record_step(bytes_changed)


def attach_to_take(monitor, take_id: str, rank: int, world_size: int) -> None:
    """Wire the tracker into one take's heartbeat pump: the slo
    sub-dict rides every published heartbeat record, and the tick hook
    publishes the gauges/sidecar at the pump's cadence. Called from
    ``_take_impl`` right after the monitor starts; best-effort."""
    t = tracker()
    t.configure(rank, world_size)
    monitor.set_slo_provider(t.heartbeat_fields)
    monitor.add_tick_hook(t.make_tick_hook(take_id, kv=monitor.kv))


# --------------------------------------------------------------- reading


def read_slo_records(directory: Optional[str] = None) -> List[Dict[str, Any]]:
    """All parseable per-rank SLO sidecars under the slo dir, sorted by
    rank. Tolerant of torn/absent files (atomic writers, but the dir
    may not exist yet)."""
    d = directory or slo_dir()
    out: List[Dict[str, Any]] = []
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for name in sorted(names):
        if not (name.startswith("rank_") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(d, name), "r") as f:
                rec = json.load(f)
            if isinstance(rec, dict):
                out.append(rec)
        except Exception:
            continue
    return sorted(out, key=lambda r: r.get("rank", 0))


def evaluate_records(
    records: List[Dict[str, Any]],
    rpo_threshold_s: Optional[float] = None,
    rto_threshold_s: Optional[float] = None,
    now: Optional[float] = None,
) -> Dict[str, Any]:
    """The ``slo --check`` verdict over per-rank records, thresholds
    defaulting to the knobs. Per rank, the LIVE time-since-commit is
    recomputed from the record's wall anchors (the publishing process
    may be long dead — its frozen ``rpo_s`` would understate exposure;
    a wall-timestamp difference is the only cross-process clock there
    is). Verdict: ``breach`` when any rank crosses a set threshold;
    ``insufficient`` when there are no records at all, or when an RTO
    threshold is set but no rank has an estimate (same no-verdict
    stance as ``history --check``'s exit 3); else ``healthy``."""
    now = _wall() if now is None else now
    if rpo_threshold_s is None:
        rpo_threshold_s = get_slo_rpo_threshold_s() or None
    if rto_threshold_s is None:
        rto_threshold_s = get_slo_rto_threshold_s() or None
    stream_x = get_slo_stream_cadence_x()
    rows: List[Dict[str, Any]] = []
    any_rto = False
    breach = False
    for rec in records:
        anchor = rec.get("last_commit_ts") or rec.get("started_ts") or now
        # A record marked `final` is a CLEAN process exit: exposure is
        # frozen at the write time (a finished run is not an incident).
        # Records without the marker — a live process, or one that was
        # SIGKILLed before it could write it — grow live from the wall
        # anchor, so a dead-but-unrecovered job keeps breaching.
        final = bool(rec.get("final"))
        ref = rec.get("ts") if final and rec.get("ts") else now
        since_commit = max(ref - anchor, 0.0)
        rto = rec.get("estimated_rto_s")
        fleet = rec.get("fleet") or {}
        row = {
            "rank": rec.get("rank", 0),
            "world_size": rec.get("world_size", 1),
            "path": rec.get("path"),
            "final": final,
            "since_commit_s": round(since_commit, 2),
            "data_at_risk_bytes": int(rec.get("data_at_risk_bytes") or 0),
            "estimated_rto_s": rto,
            # "history" (restore-event medians) or "probe" (read-lane
            # ceiling cold-start fallback — no overhead term, optimistic).
            "rto_source": rec.get("rto_source"),
            "record_age_s": round(max(now - (rec.get("ts") or now), 0.0), 2),
            "committed": rec.get("last_commit_ts") is not None,
            "fleet": fleet or None,
            # A live delta stream's configured micro-commit cadence
            # (tpusnap.delta) — the bound a healthy stream keeps
            # since_commit under; None when no stream was active.
            "stream_cadence_s": rec.get("stream_cadence_s"),
            # Peer ranks this rank's liveness layer declared dead
            # during its current take — exposure with a dead peer is a
            # rank failure, not a slow cadence.
            "dead_ranks": rec.get("dead_ranks"),
        }
        row["breach_rpo"] = bool(
            rpo_threshold_s and since_commit > rpo_threshold_s
        )
        row["breach_rto"] = bool(
            rto_threshold_s
            and isinstance(rto, (int, float))
            and rto > rto_threshold_s
        )
        # The stream-cadence gate: a LIVE delta stream (non-final record
        # advertising a cadence) that has not committed for more than
        # N x its declared cadence has silently stalled — that is a
        # breach even with no absolute RPO threshold configured (the
        # declared cadence IS the operator's objective).
        cadence = row["stream_cadence_s"]
        row["breach_stream"] = bool(
            stream_x
            and not final
            and isinstance(cadence, (int, float))
            and cadence > 0
            and since_commit > stream_x * cadence
        )
        if isinstance(rto, (int, float)):
            any_rto = True
        breach = (
            breach
            or row["breach_rpo"]
            or row["breach_rto"]
            or row["breach_stream"]
        )
        rows.append(row)
    if not rows:
        verdict = "insufficient"
        reason = "no SLO records found (no instrumented process ran here)"
    elif breach:
        verdict = "breach"
        worst = max(rows, key=lambda r: r["since_commit_s"])
        reason = (
            f"rank {worst['rank']}: {worst['since_commit_s']:.1f}s since "
            f"last commit, {worst['data_at_risk_bytes']} bytes at risk"
        )
        if worst.get("breach_stream"):
            reason += (
                f" (live stream declared a {worst['stream_cadence_s']}s "
                f"cadence; observed RPO exceeds {stream_x:g}x it)"
            )
    elif rto_threshold_s and not any_rto:
        verdict = "insufficient"
        reason = (
            "RTO threshold set but no rank has an estimate (needs ≥3 "
            "comparable restore events in history.jsonl)"
        )
    else:
        verdict = "healthy"
        reason = f"{len(rows)} rank(s) within thresholds"
    return {
        "verdict": verdict,
        "reason": reason,
        "thresholds": {
            "rpo_s": rpo_threshold_s,
            "rto_s": rto_threshold_s,
            "stream_cadence_x": stream_x or None,
        },
        "ranks": rows,
    }
