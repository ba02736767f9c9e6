"""Cross-job fleet observability: per-job status mirror + aggregation.

Counterpart of tpusnap/fleet.py (vendored; the status records and the
fleet gauges are the same, so one fleet directory may hold jobs of
either package).

Every observability surface before this module (telemetry, heartbeats,
history, SLO sidecars, the Prometheus textfiles) is scoped to ONE job.
The north star is N concurrent jobs sharing one storage substrate, and
a shared substrate fails at fleet scale in ways no single job can see:
one job's upload backlog starves another's drain, a wedged stream
quietly grows the whole fleet's recovery point, concurrent writers
contend for the same tail latency. This module makes the fleet a
first-class, gateable observability domain:

- **Publisher** (:class:`FleetPublisher`): when ``TPUSNAP_FLEET_DIR``
  is set, rank 0 of every instrumented job mirrors its EXISTING
  heartbeat/SLO/tier publications into one compact per-job record
  (``<fleet_dir>/<job_id>.json``, atomic temp+rename) — riding the
  :meth:`~tpusnap_torch.progress.ProgressMonitor.add_tick_hook` pump like
  the flight flush and the SLO publisher, so the fleet layer owns no
  thread and costs nothing when the knob is unset. A clean process
  exit stamps the record ``final`` (same contract as the SLO sidecar:
  a finished job is not an incident; a SIGKILLed one keeps screaming).

- **Aggregator** (:func:`read_fleet_records` → :func:`fold_fleet`):
  folds all jobs' records into fleet rollups — worst-case RPO and
  data-at-risk across jobs (exposure recomputed live from each
  record's wall anchors, with the SLO record-age treatment: ``final``
  records freeze at their write time, everything else grows), the
  aggregate upload lag behind the shared tier (bytes summed — each
  job's undrained bytes are distinct exposure — and the oldest
  commit's age), cross-job merged storage-latency histograms (the
  log2 buckets are mergeable by design: one job's p99 survives the
  fold), and concurrent-writer / degraded / paused / dead-rank
  counts. "Paused" reuses the SLO stream-cadence rule: a live stream
  that declared a cadence but has not committed for
  ``TPUSNAP_SLO_STREAM_CADENCE_X`` times it has silently stopped.

- **Gate** (:func:`evaluate_fleet`): the ``python -m tpusnap_torch fleet
  --check`` verdict over the rollup, with the established exit
  contract — 0 healthy, 2 breach (worst RPO / aggregate lag / storage
  p99-over-p50 tail ratio past a threshold), 3 no data. The rollup
  also renders as ``scope="fleet"`` Prometheus families
  (:func:`render_fleet_prom`) for the same collectors that scrape the
  per-job textfiles.

File-based, not a server, on purpose (same argument as the Prometheus
textfile sink): checkpoint jobs are short-lived batch processes behind
schedulers and NATs. A shared directory on the substrate the jobs
already share needs no discovery, no port, no daemon, and a crashed
job's last record is exactly the evidence the fold needs.

Monotonic-only invariant (same scope as telemetry/progress/
slo): the cross-job computations here (record staleness, exposure
since a possibly-dead job's commit anchor) are wall-timestamp
differences by necessity — cross-process, there is no shared monotonic
clock — and go through the module's injectable ``_wall`` seam.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .knobs import (
    get_fleet_dir,
    get_job_id,
    get_slo_rpo_threshold_s,
    get_slo_stream_cadence_x,
)

logger = logging.getLogger(__name__)

# Wall-clock seam: timestamps and cross-process staleness only; only
# this bare reference is allowed.
_wall = time.time

# Heartbeat-record fields the per-job mirror copies verbatim (the
# compact subset `fleet`/`watch --fleet` render; the full record stays
# in the per-take sidecars).
_BEAT_FIELDS = (
    "rank",
    "world_size",
    "take_id",
    "state",
    "phase",
    "percent",
    "mbps",
    "bytes_written",
    "dead_ranks",
    "left_ranks",
)


class FleetPublisher:
    """Mirror of THIS job's live status into ``<fleet_dir>/<job_id>.json``
    (atomic rewrite). One per process; driven by the heartbeat pump's
    tick hook — no thread of its own. Never raises to the caller."""

    def __init__(self, fleet_dir: str, job_id: Optional[str] = None) -> None:
        self.fleet_dir = fleet_dir
        self.job_id = job_id or get_job_id()
        self._lock = threading.Lock()
        self._last_beat: Optional[Dict[str, Any]] = None

    def record_path(self) -> str:
        return os.path.join(self.fleet_dir, f"{self.job_id}.json")

    def build_record(
        self, beat: Optional[Dict[str, Any]] = None, final: bool = False
    ) -> Dict[str, Any]:
        """One compact per-job status record from the publications that
        already exist: the latest heartbeat record, the SLO tracker's
        exposure anchors, the write-back uploader's status, and the
        process-global storage-latency histograms (log2 buckets —
        mergeable across jobs by design)."""
        rec: Dict[str, Any] = {
            "v": 1,
            "job_id": self.job_id,
            "pid": os.getpid(),
            "ts": _wall(),
        }
        if beat:
            for k in _BEAT_FIELDS:
                if beat.get(k) is not None:
                    rec[k] = beat[k]
        try:
            from . import slo as _slo

            s = _slo.tracker().snapshot_state()
            rec["slo"] = {
                k: s.get(k)
                for k in (
                    "rpo_s",
                    "data_at_risk_bytes",
                    "estimated_rto_s",
                    "last_commit_ts",
                    "started_ts",
                    "commit_interval_s",
                    "stream_cadence_s",
                )
            }
        except Exception:
            logger.debug("fleet slo fold failed", exc_info=True)
        try:
            from .tiering import current_status

            t = current_status()
            if t and t.get("state") != "idle":
                rec["tier"] = {
                    k: t[k]
                    for k in ("state", "lag_bytes", "lag_seconds", "degraded")
                    if t.get(k) is not None
                }
        except Exception:
            logger.debug("fleet tier fold failed", exc_info=True)
        try:
            from .telemetry import global_io_histograms_snapshot

            hists = global_io_histograms_snapshot()
            if hists:
                rec["io_histograms"] = hists
        except Exception:
            logger.debug("fleet histogram snapshot failed", exc_info=True)
        rs = reader_stats_snapshot()
        if rs:
            rec["reader"] = {
                "bytes_read": sum(s["bytes_read"] for s in rs.values()),
                "reads": sum(s["reads"] for s in rs.values()),
                "snapshots": rs,
            }
        if final:
            rec["final"] = True
        return rec

    def publish(
        self, beat: Optional[Dict[str, Any]] = None, final: bool = False
    ) -> None:
        """Rebuild and atomically rewrite this job's record. ``beat`` is
        the freshly published heartbeat record (kept as the last-known
        progress state for beat-less publishes like the exit stamp)."""
        try:
            with self._lock:
                if beat is not None:
                    self._last_beat = dict(beat)
                rec = self.build_record(beat=self._last_beat, final=final)
                os.makedirs(self.fleet_dir, exist_ok=True)
                path = self.record_path()
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(rec, f)
                os.replace(tmp, path)
        except Exception:
            logger.debug("fleet status publish failed", exc_info=True)


# ------------------------------------------------- process-global wiring

_publisher: Optional[FleetPublisher] = None
_pub_lock = threading.Lock()
_atexit_armed = False
_crashed = False


def publisher() -> Optional[FleetPublisher]:
    """The process-global publisher for the current ``TPUSNAP_FLEET_DIR``
    / ``TPUSNAP_JOB_ID``, or None when the layer is off. Re-created when
    either knob changes (tests flip them between takes)."""
    d = get_fleet_dir()
    if not d:
        return None
    job = get_job_id()
    global _publisher
    with _pub_lock:
        if (
            _publisher is None
            or _publisher.fleet_dir != d
            or _publisher.job_id != job
        ):
            _publisher = FleetPublisher(d, job)
        return _publisher


def reset_publisher() -> None:
    """Test aid; production code never resets."""
    global _publisher
    with _pub_lock:
        _publisher = None


def make_tick_hook():
    """The :meth:`ProgressMonitor.add_tick_hook` piggyback: republish
    this job's fleet record at the pump's own publish cadence (``record
    is not None`` — the same delta-throttle + keep-alive the heartbeat
    uses)."""

    def hook(record: Optional[Dict[str, Any]]) -> None:
        if record is None:
            return
        p = publisher()
        if p is not None:
            p.publish(beat=record)

    return hook


def attach_to_take(monitor) -> None:
    """Wire the fleet mirror onto one take's heartbeat pump. Rank 0
    only: all ranks of a job share one job id (one record per job),
    and rank 0's SLO state already carries the worst-case fold of its
    peers. No-op when ``TPUSNAP_FLEET_DIR`` is unset; best-effort like
    everything observability."""
    if monitor.rank != 0 or get_fleet_dir() is None:
        return
    monitor.add_tick_hook(make_tick_hook())
    _arm_atexit_finalizer()


def publish_at_take_start(monitor) -> None:
    """Publish this job's record now, from the take's own thread, once
    the take is wired (rank 0 only, no-op without ``TPUSNAP_FLEET_DIR``).
    The pump's first beat can run before :func:`attach_to_take` adds its
    hook (the pump's thread starts with the monitor), and its next
    publish waits for a change or an interval; a job killed at its first
    write would otherwise never appear in the fleet directory."""
    if monitor.rank != 0 or get_fleet_dir() is None:
        return
    p = publisher()
    if p is not None:
        p.publish()


def _arm_atexit_finalizer() -> None:
    """Register the clean-exit record stamp, once, and only for
    processes that actually published fleet state. Mirrors the SLO
    sidecar finalizer: an exception-crashed process must NOT stamp
    ``final`` — its last live record keeps growing exposure in the
    fold, exactly like a SIGKILL."""
    global _atexit_armed
    with _pub_lock:
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
    if _crashed:
        return
    p = publisher()
    if p is not None:
        p.publish(final=True)


# ---------------------------------------------------- reader attribution
#
# Reader jobs (restore / read_object consumers) have no heartbeat pump
# to ride — their fleet presence is published directly at access-ledger
# scope exit. Stats accumulate per snapshot DIGEST so the fold can
# merge amplification across readers of the same snapshot.

_reader_lock = threading.Lock()
_reader_stats: Dict[str, Dict[str, Any]] = {}


def note_reader_scope(
    snapshot_digest: str,
    snapshot_bytes: int,
    bytes_read: int,
    reads: int,
) -> None:
    """Fold one finished read scope into this process's reader stats
    and republish the job's fleet record. No-op when the fleet layer is
    off; never raises (observability stance)."""
    try:
        p = publisher()
        if p is None:
            return
        with _reader_lock:
            st = _reader_stats.setdefault(
                snapshot_digest,
                {
                    "snapshot_bytes": 0,
                    "bytes_read": 0,
                    "reads": 0,
                    "scopes": 0,
                },
            )
            st["snapshot_bytes"] = max(
                int(st["snapshot_bytes"]), int(snapshot_bytes or 0)
            )
            st["bytes_read"] += int(bytes_read)
            st["reads"] += int(reads)
            st["scopes"] += 1
        _arm_atexit_finalizer()
        p.publish()
    except Exception:
        logger.debug("fleet reader publish failed", exc_info=True)


def reader_stats_snapshot() -> Optional[Dict[str, Any]]:
    """This process's per-digest reader stats, or None when it never
    read through an access-ledger scope."""
    with _reader_lock:
        if not _reader_stats:
            return None
        return {d: dict(s) for d, s in _reader_stats.items()}


def reset_reader_stats() -> None:
    """Test aid; production code never resets."""
    with _reader_lock:
        _reader_stats.clear()


# --------------------------------------------------------------- reading


def read_fleet_records(directory: Optional[str] = None) -> List[Dict[str, Any]]:
    """All parseable per-job status records under the fleet dir, sorted
    by job id. Tolerant of torn/absent files (atomic writers, but jobs
    come and go); ``*.tmp.*`` leftovers are skipped."""
    d = directory or get_fleet_dir()
    out: List[Dict[str, Any]] = []
    if not d:
        return out
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for name in sorted(names):
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, name), "r") as f:
                rec = json.load(f)
            if isinstance(rec, dict) and rec.get("job_id"):
                out.append(rec)
        except Exception:
            continue
    return sorted(out, key=lambda r: str(r.get("job_id")))


def fold_fleet(
    records: List[Dict[str, Any]], now: Optional[float] = None
) -> Dict[str, Any]:
    """Fold per-job records into the fleet rollup. Exposure per job is
    recomputed LIVE from the record's wall anchors (the publishing
    process may be long dead — its frozen gauge would understate the
    fleet's recovery point); records marked ``final`` freeze at their
    write time (the SLO record-age treatment). Upload lag: bytes SUM
    (each job's undrained bytes are distinct exposure behind the shared
    tier), seconds MAX (age of the fleet's oldest undurable commit)."""
    now = _wall() if now is None else now
    stream_x = get_slo_stream_cadence_x()
    jobs: List[Dict[str, Any]] = []
    hists: List[Dict[str, Any]] = []
    for rec in records:
        slo = rec.get("slo") or {}
        final = bool(rec.get("final"))
        ts = rec.get("ts") or now
        age = max(now - ts, 0.0)
        anchor = slo.get("last_commit_ts") or slo.get("started_ts") or ts
        ref = ts if final else now
        rpo = max(ref - anchor, 0.0)
        tier = rec.get("tier") or {}
        cadence = slo.get("stream_cadence_s")
        # A LIVE stream that declared a cadence but has not committed
        # for stream_x times it has silently stopped — the fleet's
        # "paused" jobs (same rule as `slo --check`'s stream gate).
        paused = bool(
            not final
            and stream_x
            and isinstance(cadence, (int, float))
            and cadence > 0
            and rpo > stream_x * cadence
        )
        reader = rec.get("reader") or {}
        jobs.append(
            {
                "job_id": rec.get("job_id"),
                "state": "finished" if final else rec.get("state") or "unknown",
                "final": final,
                "reader": bool(reader),
                "bytes_read": int(reader.get("bytes_read") or 0),
                "ts": ts,
                "age_s": round(age, 2),
                "rank": rec.get("rank", 0),
                "world_size": rec.get("world_size", 1),
                "phase": rec.get("phase"),
                "percent": rec.get("percent"),
                "take_id": rec.get("take_id"),
                "rpo_s": round(rpo, 2),
                "data_at_risk_bytes": int(slo.get("data_at_risk_bytes") or 0),
                "estimated_rto_s": slo.get("estimated_rto_s"),
                "lag_bytes": int(tier.get("lag_bytes") or 0),
                "lag_seconds": float(tier.get("lag_seconds") or 0.0),
                "degraded": bool(tier.get("degraded")),
                "paused": paused,
                "dead_ranks": rec.get("dead_ranks") or [],
                "left_ranks": rec.get("left_ranks") or [],
                "stream_cadence_s": cadence,
            }
        )
        if rec.get("io_histograms"):
            hists.append(rec["io_histograms"])
    merged: Dict[str, Any] = {}
    storage: Dict[str, Any] = {}
    if hists:
        try:
            from .telemetry import IOStats, merge_io_histograms

            merged = merge_io_histograms(hists)
            # Per-op fleet aggregate across plugin classes: the tail
            # ratio gate wants ONE write distribution for the shared
            # substrate, not one per backend class per job.
            for op in ("write", "read"):
                agg = IOStats()
                for key, st in merged.items():
                    if key.startswith(op + "."):
                        agg.merge_dict(st)
                if agg.latency.count:
                    storage[op] = agg.to_dict()
        except Exception:
            logger.debug("fleet histogram fold failed", exc_info=True)
    worst = max(jobs, key=lambda j: j["rpo_s"], default=None)
    worst_risk = max(jobs, key=lambda j: j["data_at_risk_bytes"], default=None)
    # Read-side fold: amplification merges ACROSS readers of the same
    # snapshot (aggregate bytes read / stored bytes), keyed by the
    # snapshot-path digest the ledger scope stamped. A single reader at
    # 1.0x is healthy; ten full restores of one snapshot is 10x on the
    # serving substrate — only the cross-reader sum sees that.
    digest_reads: Dict[str, Dict[str, int]] = {}
    for rec in records:
        for digest, st in ((rec.get("reader") or {}).get("snapshots") or {}).items():
            acc = digest_reads.setdefault(
                digest, {"snapshot_bytes": 0, "bytes_read": 0}
            )
            acc["snapshot_bytes"] = max(
                acc["snapshot_bytes"], int(st.get("snapshot_bytes") or 0)
            )
            acc["bytes_read"] += int(st.get("bytes_read") or 0)
    read_amp = None
    read_amp_digest = None
    for digest, acc in digest_reads.items():
        if acc["snapshot_bytes"] <= 0:
            continue
        amp = round(acc["bytes_read"] / acc["snapshot_bytes"], 4)
        if read_amp is None or amp > read_amp:
            read_amp, read_amp_digest = amp, digest
    return {
        "v": 1,
        "ts": now,
        "n_jobs": len(jobs),
        "writers": sum(
            1 for j in jobs if not j["final"] and j["state"] == "running"
        ),
        "degraded_jobs": sum(1 for j in jobs if j["degraded"]),
        "paused_jobs": sum(1 for j in jobs if j["paused"]),
        "dead_ranks": sum(len(j["dead_ranks"]) for j in jobs),
        "worst_rpo_s": worst["rpo_s"] if worst else None,
        "worst_rpo_job": worst["job_id"] if worst else None,
        "worst_data_at_risk_bytes": (
            worst_risk["data_at_risk_bytes"] if worst_risk else None
        ),
        "worst_at_risk_job": worst_risk["job_id"] if worst_risk else None,
        "lag_bytes_total": sum(j["lag_bytes"] for j in jobs),
        "lag_seconds_max": max((j["lag_seconds"] for j in jobs), default=0.0),
        "readers": sum(1 for j in jobs if j["reader"]),
        "bytes_read_total": sum(j["bytes_read"] for j in jobs),
        "read_amplification": read_amp,
        "read_amplification_digest": read_amp_digest,
        "storage": storage,
        "io_histograms": merged or None,
        "jobs": jobs,
    }


# ---------------------------------------------------------------- gating


def evaluate_fleet(
    rollup: Dict[str, Any],
    rpo_threshold_s: Optional[float] = None,
    lag_bytes_threshold: Optional[int] = None,
    lag_seconds_threshold: Optional[float] = None,
    p99_ratio_threshold: Optional[float] = None,
    min_latency_samples: int = 20,
    max_read_amplification: Optional[float] = None,
) -> Dict[str, Any]:
    """The ``fleet --check`` verdict over a rollup: ``breach`` when any
    configured fleet objective is crossed — worst-job RPO, aggregate
    upload lag (bytes or seconds), or the merged storage write
    p99-over-p50 tail ratio (skipped below ``min_latency_samples``
    merged samples: a two-sample "distribution" is noise, not a tail).
    ``insufficient`` when there are no records at all — the same
    no-verdict stance as ``slo``/``history --check``'s exit 3. The RPO
    threshold defaults to ``TPUSNAP_SLO_RPO_S``."""
    if rpo_threshold_s is None:
        rpo_threshold_s = get_slo_rpo_threshold_s() or None
    thresholds = {
        "rpo_s": rpo_threshold_s,
        "lag_bytes": lag_bytes_threshold,
        "lag_seconds": lag_seconds_threshold,
        "p99_ratio": p99_ratio_threshold,
        "read_amplification": max_read_amplification,
    }
    if not rollup.get("n_jobs"):
        return {
            "verdict": "insufficient",
            "reason": (
                "no fleet status records found (is TPUSNAP_FLEET_DIR set "
                "on the jobs?)"
            ),
            "thresholds": thresholds,
            "checks": [],
        }
    checks: List[Dict[str, Any]] = []

    def check(name: str, value, threshold, breach: bool, job=None) -> None:
        row = {
            "check": name,
            "value": value,
            "threshold": threshold,
            "breach": breach,
        }
        if job is not None:
            row["job"] = job
        checks.append(row)

    if rpo_threshold_s:
        v = float(rollup.get("worst_rpo_s") or 0.0)
        check(
            "worst_rpo_s",
            v,
            rpo_threshold_s,
            v > rpo_threshold_s,
            job=rollup.get("worst_rpo_job"),
        )
    if lag_bytes_threshold:
        v = int(rollup.get("lag_bytes_total") or 0)
        check("lag_bytes_total", v, lag_bytes_threshold, v > lag_bytes_threshold)
    if lag_seconds_threshold:
        v = float(rollup.get("lag_seconds_max") or 0.0)
        check(
            "lag_seconds_max", v, lag_seconds_threshold, v > lag_seconds_threshold
        )
    if p99_ratio_threshold:
        st = (rollup.get("storage") or {}).get("write") or {}
        p50, p99 = st.get("p50_s"), st.get("p99_s")
        if (
            (st.get("count") or 0) >= min_latency_samples
            and p50
            and p99 is not None
        ):
            ratio = round(p99 / p50, 2)
            check("storage_write_p99_ratio", ratio, p99_ratio_threshold,
                  ratio > p99_ratio_threshold)
    if max_read_amplification:
        # Skipped when no reader attributed any bytes — absence of
        # readers is not a serving breach.
        amp = rollup.get("read_amplification")
        if amp is not None:
            check(
                "read_amplification",
                amp,
                max_read_amplification,
                amp > max_read_amplification,
                job=rollup.get("read_amplification_digest"),
            )
    breached = [c for c in checks if c["breach"]]
    if breached:
        c = breached[0]
        reason = f"{c['check']} {c['value']} > {c['threshold']}"
        if c.get("job"):
            reason += f" (worst job: {c['job']})"
        verdict = "breach"
    else:
        verdict = "healthy"
        reason = f"{rollup['n_jobs']} job(s) within fleet objectives"
    return {
        "verdict": verdict,
        "reason": reason,
        "thresholds": thresholds,
        "checks": checks,
    }


# ---------------------------------------------------------- prom export


def render_fleet_prom(rollup: Dict[str, Any]) -> str:
    """The rollup as ``scope="fleet"`` Prometheus families (exposition
    format, same strict shape :func:`~tpusnap_torch.metrics_export.
    parse_prometheus_textfile` checks). These aggregate ACROSS jobs —
    the per-job textfiles keep their own ``job``-labeled series."""
    from .metrics_export import _fmt_labels, _fmt_value

    out: List[str] = []

    def metric(name, mtype, help_, samples) -> None:
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            all_labels = dict(labels)
            all_labels["scope"] = "fleet"
            out.append(f"{name}{_fmt_labels(all_labels)} {_fmt_value(value)}")

    metric(
        "tpusnap_fleet_jobs",
        "gauge",
        "Jobs with a status record in the fleet directory.",
        [({}, rollup.get("n_jobs") or 0)],
    )
    metric(
        "tpusnap_fleet_writers",
        "gauge",
        "Jobs currently inside a running take (concurrent writers on "
        "the shared substrate).",
        [({}, rollup.get("writers") or 0)],
    )
    metric(
        "tpusnap_fleet_degraded_jobs",
        "gauge",
        "Jobs whose write-back uploader circuit is open.",
        [({}, rollup.get("degraded_jobs") or 0)],
    )
    metric(
        "tpusnap_fleet_paused_jobs",
        "gauge",
        "Live delta streams that stopped committing past their own "
        "declared cadence.",
        [({}, rollup.get("paused_jobs") or 0)],
    )
    metric(
        "tpusnap_fleet_dead_ranks",
        "gauge",
        "Lease-expired DEAD ranks across all jobs.",
        [({}, rollup.get("dead_ranks") or 0)],
    )
    if rollup.get("worst_rpo_s") is not None:
        metric(
            "tpusnap_fleet_worst_rpo_seconds",
            "gauge",
            "Worst-job seconds since last committed take (staleness-"
            "corrected; final records frozen at exit).",
            [({"job": str(rollup.get("worst_rpo_job"))}, rollup["worst_rpo_s"])],
        )
    if rollup.get("worst_data_at_risk_bytes") is not None:
        metric(
            "tpusnap_fleet_data_at_risk_bytes",
            "gauge",
            "Worst-job bytes a crash right now would lose.",
            [(
                {"job": str(rollup.get("worst_at_risk_job"))},
                rollup["worst_data_at_risk_bytes"],
            )],
        )
    metric(
        "tpusnap_fleet_readers",
        "gauge",
        "Jobs that attributed snapshot reads through the access ledger.",
        [({}, rollup.get("readers") or 0)],
    )
    if rollup.get("read_amplification") is not None:
        metric(
            "tpusnap_fleet_read_amplification",
            "gauge",
            "Worst-snapshot aggregate bytes read across all readers "
            "over the snapshot's stored bytes.",
            [(
                {"digest": str(rollup.get("read_amplification_digest"))},
                rollup["read_amplification"],
            )],
        )
    metric(
        "tpusnap_fleet_upload_lag_bytes",
        "gauge",
        "Sum of local-committed bytes not yet remote-durable across "
        "all jobs behind the shared tier.",
        [({}, rollup.get("lag_bytes_total") or 0)],
    )
    metric(
        "tpusnap_fleet_upload_lag_seconds",
        "gauge",
        "Age of the fleet's oldest local commit still awaiting remote "
        "durability.",
        [({}, rollup.get("lag_seconds_max") or 0.0)],
    )
    for op in ("write", "read"):
        st = (rollup.get("storage") or {}).get(op) or {}
        samples = [
            ({"quantile": q}, st[k])
            for q, k in (("0.5", "p50_s"), ("0.95", "p95_s"), ("0.99", "p99_s"))
            if st.get(k) is not None
        ]
        if samples:
            metric(
                f"tpusnap_fleet_storage_{op}_seconds",
                "summary",
                f"Cross-job merged storage-plugin {op} latency quantiles "
                "(log2 histograms folded across all jobs).",
                samples,
            )
    metric(
        "tpusnap_fleet_last_fold_timestamp_seconds",
        "gauge",
        "Unix time this rollup was folded (staleness probe).",
        [({}, rollup.get("ts") or _wall())],
    )
    return "\n".join(out) + "\n"


def write_fleet_prom(rollup: Dict[str, Any], path: str) -> None:
    """Atomically write the rollup's ``scope="fleet"`` families to
    ``path`` (point it into the node collector's textfile directory)."""
    text = render_fleet_prom(rollup)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
