"""Cross-run checkpoint performance history + regression detection.

Counterpart of tpusnap/history.py (vendored; the two packages append
the same event shape to the same file, and each loads the other's
lines). Persisted traces and live heartbeats make one take legible;
this module is the cross-RUN memory: an
append-only, size-bounded, per-host JSONL history
(``TPUSNAP_TELEMETRY_DIR/history.jsonl``) of every COMPLETED take and
restore — throughput, phase breakdown, bytes, world size,
salvage/dedup/stall counters — plus the trailing-median regression
check behind ``python -m tpusnap_torch history --check``.

Design constraints, in order:

- **Never fail a take.** Recording is best-effort and exception-free at
  the call sites (:func:`record_summary` is invoked from
  ``telemetry.end_take`` under a try/except).
- **Crash-tolerant.** Appends are single ``os.write`` calls on an
  ``O_APPEND`` descriptor (concurrent ranks/processes interleave whole
  lines, never bytes); a process killed mid-append leaves at most one
  torn FINAL line, which :func:`load_history` (and the compactor)
  silently drop — the acceptance property "history survives a torn
  final line".
- **Size-bounded.** When an append pushes the file past
  ``TPUSNAP_HISTORY_MAX_BYTES`` the oldest lines are compacted away
  (newest kept to half the bound, temp+rename). Compaction racing a
  concurrent appender can drop that appender's in-flight line — an
  accepted best-effort bound, same stance as every other observability
  surface here.
- **Cold-run aware.** The first recorded event of each kind in a
  process is tagged ``cold: true`` (it pays imports, native-library
  load, allocator growth). The
  regression check matches the cold tag like-for-like: a lone cold
  run among warm ones passes (warmup never pages an operator), while
  an all-cold history — the one-take-per-process fleet — grades cold
  against cold so the gate still fires.

Monotonic-only invariant: durations in events come from the telemetry
summaries' monotonic math; the one wall-clock TIMESTAMP (``ts``) goes
through the module's injectable ``_wall`` seam.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .knobs import (
    get_explicit_job_id,
    get_history_max_bytes,
    get_telemetry_dir,
    is_history_enabled,
)

logger = logging.getLogger(__name__)

HISTORY_FILENAME = "history.jsonl"

# Wall-clock seam: timestamps only, never duration math (tests inject).
_wall = time.time

# Event kinds with per-process cold tagging already consumed.
_warm_kinds: set = set()
_state_lock = threading.Lock()


def history_path() -> str:
    """The per-host history file (under the telemetry dir)."""
    return os.path.join(get_telemetry_dir(), HISTORY_FILENAME)


def _reset_process_state() -> None:
    """Test aid: forget which kinds consumed their cold tag."""
    with _state_lock:
        _warm_kinds.clear()


# ------------------------------------------------------------- recording


def event_from_summary(kind: str, summary: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten one telemetry summary into a compact history/JSONL event:
    the trend-relevant scalars only (throughput, phases, byte and
    episode counters) — spans and full counter maps stay in the trace
    files."""
    counters = summary.get("counters") or {}
    gauges = summary.get("gauges") or {}
    wall = float(summary.get("take_wall_s") or 0.0)
    byte_counter = (
        "storage.bytes_read" if kind == "restore" else "storage.bytes_written"
    )
    nbytes = int(counters.get(byte_counter, 0))
    ev: Dict[str, Any] = {
        "v": 1,
        "ts": round(_wall(), 3),
        "kind": kind,
        "rank": summary.get("rank", 0),
        "world_size": summary.get("world_size", 1),
        # Job identity: two named jobs (TPUSNAP_JOB_ID) sharing one
        # telemetry dir interleave events in the same history.jsonl,
        # and the regression baseline filters on this so they never
        # grade against each other. Deliberately the EXPLICIT id only —
        # the host-pid default changes every process and would empty
        # every cross-run baseline.
        "job_id": get_explicit_job_id(),
        "take_id": summary.get("take_id"),
        "path": summary.get("path"),
        "wall_s": round(wall, 6),
        "bytes": nbytes,
        # Incremental takes write only the delta — their written-bytes
        # throughput is incommensurable with full takes', so the
        # regression check separates the two populations on this flag.
        "incremental": bool(summary.get("incremental")),
        "throughput_gbps": (
            round(nbytes / wall / 1e9, 6) if wall > 0 and nbytes else None
        ),
        "phases_s": {
            k: round(v, 6) for k, v in (summary.get("phases") or {}).items()
        },
        "stall_episodes": counters.get("progress.stall_episodes", 0),
        "retry_attempts": counters.get("retry.attempts", 0),
        "dedup_skips": counters.get("scheduler.dedup_skipped", 0),
        "blobs_salvaged": counters.get("salvage.blobs_salvaged", 0),
        "bytes_salvaged": counters.get("salvage.bytes_salvaged", 0),
    }
    # The storage backend this run read/wrote (innermost plugin class,
    # tier-aware for restores): the SLO RTO estimator filters its
    # baseline on it so cloud-tier restores never get priced with
    # local-disk history.
    if summary.get("plugin"):
        ev["plugin"] = summary["plugin"]
    if "scheduler.budget_used_bytes" in gauges:
        ev["budget_high_water_bytes"] = int(gauges["scheduler.budget_used_bytes"])
    if "peak_rss_delta_bytes" in gauges:
        ev["peak_rss_delta_bytes"] = int(gauges["peak_rss_delta_bytes"])
    # Async takes: the blocked window (take start → control returned to
    # training). A *_s metric, so `history --check --metric
    # async_blocked_s` gates it upward like every other duration — the
    # pipelined-staging win cannot silently regress.
    if isinstance(summary.get("async_blocked_s"), (int, float)):
        ev["async_blocked_s"] = round(float(summary["async_blocked_s"]), 6)
    # Fused tile compression: the take's resolved policy decision plus
    # realized ratio/codec throughput. Flat scalars so `history --check
    # --metric compress_ratio` (or the bench's effective-GB/s metrics)
    # trend and gate like everything else; absent on bypassed takes
    # keeps old/new event populations comparable.
    comp = summary.get("compress")
    if isinstance(comp, dict):
        ev["compress_decision"] = comp.get("decision")
        ev["compress_reason"] = comp.get("reason")
        if comp.get("codec_gbps"):
            ev["compress_codec_gbps"] = comp["codec_gbps"]
        if comp.get("pipe_gbps") is not None:
            ev["compress_pipe_gbps"] = comp["pipe_gbps"]
    c_in = counters.get("compress.bytes_in", 0)
    c_out = counters.get("compress.bytes_out", 0)
    if c_in and c_out:
        ev["compress_bytes_in"] = int(c_in)
        ev["compress_bytes_out"] = int(c_out)
        ev["compress_ratio"] = round(c_in / c_out, 4)
    # Storage-boundary latency quantiles from the run's log2 histograms
    # (merged across plugin classes, per op): *_s metrics, so `history
    # --check --metric storage_write_p99_s` (and storage_read_p99_s on
    # restores/benches) gates tail latency upward exactly like every
    # other duration.
    for op in ("write", "read"):
        op_lat = None
        for key, st in (summary.get("io_histograms") or {}).items():
            if not key.startswith(f"{op}."):
                continue
            try:
                from .telemetry import LogHistogram

                h = LogHistogram.from_dict(st.get("latency") or {})
            except Exception:
                continue
            if op_lat is None:
                op_lat = h
            else:
                op_lat.merge(h)
        if op_lat is not None and op_lat.count:
            p50, p99 = op_lat.quantile(0.5), op_lat.quantile(0.99)
            if p50 is not None:
                ev[f"storage_{op}_p50_s"] = round(p50, 6)
            if p99 is not None:
                ev[f"storage_{op}_p99_s"] = round(p99, 6)
    # Roofline probes (TPUSNAP_PROBE=1): the drift-immune fraction and
    # the measured ceiling ride the trend — write lane for takes, read
    # lane for restores.
    if isinstance(summary.get("roofline_fraction"), (int, float)):
        ev["roofline_fraction"] = round(float(summary["roofline_fraction"]), 4)
        pw = (summary.get("probe") or {}).get("write_gbps_p50")
        if pw:
            ev["probe_write_gbps"] = pw
    if isinstance(summary.get("restore_roofline_fraction"), (int, float)):
        ev["restore_roofline_fraction"] = round(
            float(summary["restore_roofline_fraction"]), 4
        )
        pr = (summary.get("probe") or {}).get("read_gbps_p50")
        if pr:
            ev["probe_read_gbps"] = pr
    # Access-ledger attribution (restores / read_object scopes): the
    # scope's logical read totals and distinct-byte working set. Flat
    # ints so `analyze`/`tune` can size restore budgets from the HOT
    # working set instead of the whole snapshot, and so amplification
    # trends are greppable straight from history.jsonl.
    acc = summary.get("access")
    if isinstance(acc, dict):
        ev["access_bytes_read"] = int(acc.get("bytes_read") or 0)
        ev["access_reads"] = int(acc.get("reads") or 0)
        ev["access_working_set_bytes"] = int(acc.get("working_set_bytes") or 0)
    # Auto-tuner provenance (TPUSNAP_AUTOTUNE=1): which plan and which
    # knobs this run actually applied, so any regression the tuner
    # causes is attributable — and gated by the same `history --check`
    # that gates everything else.
    if isinstance(summary.get("tuned"), dict):
        ev["tuned"] = summary["tuned"]
    # Checkpoint-SLO section (tpusnap.slo, recorded at the commit
    # anchor): realized commit interval, the interval's change bytes,
    # and the estimated RTO at commit time. commit_interval_s is a
    # *_s metric, so `history --check --metric slo.commit_interval_s`
    # would gate it upward — but the flat copy below is what makes the
    # top-level gate usable without dotted-path lookups.
    slo = summary.get("slo")
    if isinstance(slo, dict):
        ev["slo"] = slo
        if isinstance(slo.get("commit_interval_s"), (int, float)):
            ev["commit_interval_s"] = round(float(slo["commit_interval_s"]), 3)
        if isinstance(slo.get("estimated_rto_s"), (int, float)):
            ev["estimated_rto_s"] = round(float(slo["estimated_rto_s"]), 3)
    return ev


def record_summary(
    kind: str, summary: Dict[str, Any], cold: Optional[bool] = None
) -> Optional[Dict[str, Any]]:
    """Append one COMPLETED take/restore summary to the history.
    Summaries without ``completed: True`` (aborted takes, failed
    restores) are skipped — a half-take's throughput is not a trend
    point. Returns the recorded event, or None when skipped/disabled."""
    if not is_history_enabled():
        return None
    if not summary.get("completed"):
        return None
    ev = event_from_summary(kind, summary)
    if cold is None:
        with _state_lock:
            cold = kind not in _warm_kinds
            _warm_kinds.add(kind)
    if cold:
        ev["cold"] = True
    return record_event(ev)


def append_jsonl_line(path: str, line: str) -> None:
    """Crash-tolerant JSONL append (shared by the history store and the
    JSONL export sink): one O_APPEND write so concurrent writers
    interleave whole lines. O_RDWR (not O_WRONLY) because a crash
    mid-append leaves a torn final line with no newline — blindly
    appending would concatenate the new record onto the torn tail and
    corrupt BOTH; peeking at the last byte and leading with a newline
    isolates the torn fragment on its own (skipped) line."""
    if not line.endswith("\n"):
        line += "\n"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        size = os.fstat(fd).st_size
        if size > 0 and os.pread(fd, 1, size - 1) != b"\n":
            line = "\n" + line
        os.write(fd, line.encode("utf-8"))
    finally:
        os.close(fd)


def record_event(
    event: Dict[str, Any], path: Optional[str] = None
) -> Optional[Dict[str, Any]]:
    """Atomically append one event line, then enforce the size bound.
    Best-effort: failures log at DEBUG and return None."""
    if not is_history_enabled():
        return None
    path = path or history_path()
    try:
        append_jsonl_line(path, json.dumps(event, separators=(",", ":")))
        _enforce_size_bound(path)
    except Exception:
        logger.debug("history append failed", exc_info=True)
        return None
    return event


def _enforce_size_bound(path: str) -> None:
    max_bytes = get_history_max_bytes()
    try:
        if os.path.getsize(path) <= max_bytes:
            return
    except OSError:
        return
    # Compact: keep the newest whole lines up to half the bound, so the
    # file breathes between compactions instead of rewriting per append.
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    kept: List[bytes] = []
    budget = max_bytes // 2
    total = 0
    for ln in reversed(lines):
        if not ln.strip():
            continue
        if total + len(ln) + 1 > budget:
            break
        try:
            json.loads(ln)  # a torn/corrupt line is not worth keeping
        except Exception:
            continue
        kept.append(ln)
        total += len(ln) + 1
    kept.reverse()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(b"\n".join(kept) + (b"\n" if kept else b""))
    os.replace(tmp, path)


# --------------------------------------------------------------- loading


def load_history(
    path: Optional[str] = None, limit: Optional[int] = None
) -> List[Dict[str, Any]]:
    """All parseable events, oldest first. Crash-tolerant: a torn final
    line (or any corrupt line) is skipped, never raised. ``limit`` keeps
    the newest N."""
    path = path or history_path()
    out: List[Dict[str, Any]] = []
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return out
    for ln in data.split(b"\n"):
        if not ln.strip():
            continue
        try:
            ev = json.loads(ln)
        except Exception:
            continue
        if isinstance(ev, dict):
            out.append(ev)
    if limit is not None and limit >= 0:
        out = out[-limit:]
    return out


# ---------------------------------------------------- regression checking

# Metrics where SMALLER is better (durations); everything else
# (throughput, fractions) regresses downward.
_LOWER_IS_BETTER_SUFFIXES = ("_s", "_seconds")


@dataclass
class RegressionReport:
    """Outcome of one trailing-median comparison. ``regressed`` is the
    CI-gate verdict; ``ok`` is False only when there was not enough
    comparable history to form a verdict at all."""

    ok: bool
    regressed: bool
    reason: str
    metric: str
    kind: str
    latest: Optional[float] = None
    baseline_median: Optional[float] = None
    ratio: Optional[float] = None
    n_baseline: int = 0
    window: int = 0
    threshold: float = 0.0
    latest_event: Optional[Dict[str, Any]] = field(default=None, repr=False)

    def to_json(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "regressed": self.regressed,
            "reason": self.reason,
            "metric": self.metric,
            "kind": self.kind,
            "latest": self.latest,
            "baseline_median": self.baseline_median,
            "ratio": self.ratio,
            "n_baseline": self.n_baseline,
            "window": self.window,
            "threshold": self.threshold,
        }


def check_regression(
    events: Optional[List[Dict[str, Any]]] = None,
    *,
    kind: str = "take",
    metric: str = "throughput_gbps",
    window: int = 20,
    threshold: float = 0.25,
    min_baseline: int = 3,
    rank: Optional[int] = 0,
) -> RegressionReport:
    """Compare the latest event's ``metric`` against the trailing median
    of the previous ``window`` comparable events.

    The LATEST event is the genuinely newest one of the kind/rank —
    never an older run that happens to carry the metric (a gate that
    silently evaluates a stale run reads as OK while the most recent
    run went unchecked); a latest run without the metric returns
    ``ok=False``. Comparable = same ``world_size`` AND the same
    ``incremental`` flag as the latest event (an incremental take's
    written-bytes throughput is incommensurable with a full take's),
    same ``rank`` (default 0 — per-rank byte counters make cross-rank
    throughputs incommensurable), metric present, and the same cold
    tag as the latest event. The cold symmetry matters in both
    directions: a lone cold run among warm ones passes (warmup is not
    a regression — there is no cold baseline to grade it against), but
    in one-take-per-process fleets where EVERY event is cold, cold
    runs grade against the trailing cold baseline like-for-like, so
    the gate still fires instead of being structurally green. Fewer
    than ``min_baseline`` comparable baseline events returns
    ``ok=False`` (exit 3 at the CLI) for a warm latest — a guess is
    not a verdict.

    Regression: for throughput-like metrics, latest < median x (1 -
    threshold); for duration metrics (``*_s``), latest > median x (1 +
    threshold)."""
    if events is None:
        events = load_history()
    cand = [
        e
        for e in events
        if e.get("kind") == kind
        and (rank is None or e.get("rank", 0) == rank)
    ]
    if not cand:
        return RegressionReport(
            ok=False,
            regressed=False,
            reason=f"no {kind} events in history",
            metric=metric,
            kind=kind,
            window=window,
            threshold=threshold,
        )
    latest = cand[-1]
    if not isinstance(latest.get(metric), (int, float)):
        if latest.get("cold"):
            return RegressionReport(
                ok=True,
                regressed=False,
                reason=(
                    "latest run is cold-tagged (process warmup) and "
                    f"carries no value for metric {metric!r}; not compared"
                ),
                metric=metric,
                kind=kind,
                window=window,
                threshold=threshold,
                latest_event=latest,
            )
        return RegressionReport(
            ok=False,
            regressed=False,
            reason=(
                f"latest {kind} run has no value for metric {metric!r} "
                "(cannot be checked)"
            ),
            metric=metric,
            kind=kind,
            window=window,
            threshold=threshold,
            latest_event=latest,
        )
    cold_latest = bool(latest.get("cold"))
    baseline_vals = [
        float(e[metric])
        for e in cand[:-1]
        if bool(e.get("cold")) == cold_latest
        and isinstance(e.get(metric), (int, float))
        and e.get("world_size", 1) == latest.get("world_size", 1)
        and bool(e.get("incremental")) == bool(latest.get("incremental"))
        # Same comparability stance as kind/world_size: two different
        # jobs' runs interleaved in a shared telemetry dir must never
        # grade against each other (pre-job_id events are all None,
        # which keeps old histories self-comparable).
        and e.get("job_id") == latest.get("job_id")
    ][-window:]
    if len(baseline_vals) < max(1, min_baseline):
        if cold_latest:
            # A lone cold run among warm ones: warmup, not a regression
            # (and nothing like-for-like to grade it against).
            lv = latest.get(metric)
            return RegressionReport(
                ok=True,
                regressed=False,
                reason=(
                    "latest run is cold-tagged (process warmup); no cold "
                    "baseline to compare against"
                ),
                metric=metric,
                kind=kind,
                latest=float(lv) if isinstance(lv, (int, float)) else None,
                n_baseline=len(baseline_vals),
                window=window,
                threshold=threshold,
                latest_event=latest,
            )
        return RegressionReport(
            ok=False,
            regressed=False,
            reason=(
                f"only {len(baseline_vals)} comparable baseline event(s); "
                f"need {min_baseline}"
            ),
            metric=metric,
            kind=kind,
            latest=float(latest[metric]),
            n_baseline=len(baseline_vals),
            window=window,
            threshold=threshold,
            latest_event=latest,
        )
    median = statistics.median(baseline_vals)
    value = float(latest[metric])
    lower_is_better = metric.endswith(_LOWER_IS_BETTER_SUFFIXES)
    if median > 0:
        ratio = value / median
    else:
        ratio = None
    if lower_is_better:
        regressed = median > 0 and value > median * (1.0 + threshold)
        direction = "slower than"
    else:
        regressed = value < median * (1.0 - threshold)
        direction = "below"
    if regressed:
        reason = (
            f"{metric} {value:.4g} is {direction} the trailing-median "
            f"{median:.4g} by more than {threshold:.0%} "
            f"(n={len(baseline_vals)})"
        )
    else:
        reason = (
            f"{metric} {value:.4g} within {threshold:.0%} of trailing-median "
            f"{median:.4g} (n={len(baseline_vals)})"
        )
    if cold_latest:
        reason += " [cold-vs-cold: every run here is a process-first]"
    return RegressionReport(
        ok=True,
        regressed=regressed,
        reason=reason,
        metric=metric,
        kind=kind,
        latest=value,
        baseline_median=median,
        ratio=round(ratio, 4) if ratio is not None else None,
        n_baseline=len(baseline_vals),
        window=window,
        threshold=threshold,
        latest_event=latest,
    )
