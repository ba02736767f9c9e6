"""Fleet metrics export: production :class:`~tpusnap_torch.telemetry.MetricsSink`s.

Counterpart of tpusnap/metrics_export.py (vendored, the same file names,
metric families and line formats, so either package's collectors read
the other's files). Two always-safe sinks any fleet can turn on with one
env var, no code.

- :class:`PrometheusTextfileSink` — atomic rewrite of a per-rank
  ``.prom`` textfile (Prometheus exposition format, ``# HELP``/``# TYPE``
  per metric) on every take/restore summary, suitable for
  node-exporter's textfile collector. Counters come from the
  PROCESS-GLOBAL telemetry counters, so they are monotonic across
  takes — exactly what Prometheus ``rate()`` needs. A textfile, not an
  HTTP endpoint, on purpose: checkpoint ranks are short-lived batch
  processes behind schedulers and NATs; a scrape port per rank is a
  service-discovery problem, a file under the node collector is not
  (see docs/design.md "Fleet observability").
- :class:`JsonlEventSink` — one structured JSON line per take/restore
  summary (rank-tagged, rotation-bounded): the raw-event feed for
  fleet log pipelines (Vector/fluentd -> wherever), carrying the same
  compact event shape the cross-run history records.

Both are registered automatically when ``TPUSNAP_METRICS_EXPORT``
names them (``prom``, ``jsonl``, or ``prom,jsonl``; files land under
``TPUSNAP_METRICS_DIR``, default the telemetry dir) —
:func:`install_env_sinks` runs at every take/restore begin and
reconciles registration against the current env, so tests and
long-lived processes can flip the knobs between takes. They can also
be registered explicitly like any sink (``tpusnap.metrics_sink(
PrometheusTextfileSink(dir))``). Sink failures never fail a take
(swallowed + rate-limited WARNING, telemetry.py).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import telemetry
from .knobs import get_job_id, get_metrics_dir, get_metrics_export

logger = logging.getLogger(__name__)

JSONL_FILENAME = "events.jsonl"
_DEFAULT_JSONL_MAX_BYTES = 16 * 1024 * 1024

# Wall-clock seam (timestamps only; durations ride the summaries).
_wall = time.time


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


class PrometheusTextfileSink(telemetry.MetricsSink):
    """Atomic ``.prom`` textfile per rank, rewritten on every
    take/restore summary (never per counter — the textfile collector
    scrapes on its own cadence; rewriting per hot-path increment would
    be pure churn). The default filename carries the job id
    (``tpusnap_<job>_rank<k>.prom``) and every sample a ``job`` label
    (``TPUSNAP_JOB_ID``, host-pid default), so concurrent jobs sharing
    one metrics directory stay attributable instead of clobbering.

    Exported series (``rank`` and ``job`` labels on all):

    - ``tpusnap_take_seconds`` / ``tpusnap_restore_seconds`` — gauges,
      last completed take/restore wall-clock.
    - ``tpusnap_takes_total`` / ``tpusnap_restores_total`` — summaries
      exported since process start.
    - ``tpusnap_bytes_written_total`` / ``tpusnap_bytes_read_total`` —
      process-global byte counters (monotonic).
    - ``tpusnap_retry_attempts_total``, and
      ``tpusnap_retry_total{classification="transient.<op>.<Exc>"}`` —
      one series per observed retry classification.
    - ``tpusnap_stall_episodes_total`` — stall-watchdog episodes.
    - ``tpusnap_salvage_bytes_total``, ``tpusnap_dedup_skips_total``.
    - ``tpusnap_compress_bytes_in_total`` /
      ``tpusnap_compress_bytes_out_total`` — fused tile codec volume
      (ratio = in/out; equal ⇒ the auto policy is bypassing).
    - ``tpusnap_budget_high_water_bytes``,
      ``tpusnap_peak_rss_delta_bytes`` — gauges from the last summary.
    - ``tpusnap_storage_write_seconds`` /
      ``tpusnap_storage_read_seconds`` — summary-typed latency
      quantiles (``quantile="0.5|0.95|0.99"``, ``plugin=<class>``) from
      the process-global log2 histograms recorded at the
      storage-plugin boundary.
    - ``tpusnap_rpo_seconds``, ``tpusnap_data_at_risk_bytes``,
      ``tpusnap_estimated_rto_seconds``,
      ``tpusnap_commit_interval_seconds`` — checkpoint-SLO gauges
      (:mod:`tpusnap_torch.slo`), refreshed at heartbeat cadence while a
      take runs and at every commit; rank 0 of a multi-process take
      additionally exports the fleet worst-case as ``scope="fleet"``
      samples. ``tpusnap_slo_breach`` is 1 while a set
      ``TPUSNAP_SLO_RPO_S``/``TPUSNAP_SLO_RTO_S`` threshold is
      crossed (``objective`` label).
    - ``tpusnap_last_summary_timestamp_seconds`` — staleness probe.
    """

    def __init__(
        self, directory: Optional[str] = None, filename: Optional[str] = None
    ) -> None:
        self._directory = directory
        self._filename = filename
        self._lock = threading.Lock()
        self._last_wall: Dict[str, float] = {}
        self._summary_counts: Dict[str, int] = {}
        self._last_gauges: Dict[str, float] = {}
        self._slo_state: Optional[Dict[str, Any]] = None
        self._tier_state: Optional[Dict[str, Any]] = None
        self._rank: Optional[int] = None

    # --- MetricsSink ----------------------------------------------------

    def on_take_summary(self, summary: Dict[str, Any]) -> None:
        self._absorb(summary.get("kind") or "take", summary)

    def on_restore_summary(self, summary: Dict[str, Any]) -> None:
        self._absorb("restore", summary)

    def on_slo_update(self, state: Dict[str, Any]) -> None:
        # Same locked write+rename discipline as _absorb: the SLO
        # publisher runs on the heartbeat pump thread while summaries
        # publish from commit threads; the per-pid temp name is shared.
        with self._lock:
            self._slo_state = dict(state)
            self._rank = state.get("rank", self._rank or 0)
            self._rewrite_locked()

    def on_tier_update(self, state: Dict[str, Any]) -> None:
        # Write-back tier status (tpusnap.tiering): the uploader's
        # drain thread publishes on every transition/blob completion.
        with self._lock:
            self._tier_state = dict(state)
            self._rewrite_locked()

    # --- internals ------------------------------------------------------

    def path(self, rank: int) -> str:
        d = self._directory or get_metrics_dir()
        # The job id is in the default filename so two jobs sharing one
        # TPUSNAP_METRICS_DIR (a node collector's textfile directory)
        # can never silently overwrite each other's samples.
        name = self._filename or f"tpusnap_{get_job_id()}_rank{rank}.prom"
        return os.path.join(d, name)

    def _absorb(self, kind: str, summary: Dict[str, Any]) -> None:
        # The write+rename stays INSIDE the lock: an async take's commit
        # publishes from its background thread while a restore publishes
        # from the main thread, and the per-pid temp name is shared
        # across threads — unlocked, the two rewrites would interleave
        # into a torn .prom.
        with self._lock:
            self._rank = summary.get("rank", self._rank or 0)
            if summary.get("completed"):
                # Aborted takes/failed restores publish summaries too;
                # the "last completed" gauges and "completed ... total"
                # counters must not absorb them (the file still
                # rewrites below: the global counters advanced).
                self._last_wall[kind] = float(summary.get("take_wall_s") or 0.0)
                self._summary_counts[kind] = (
                    self._summary_counts.get(kind, 0) + 1
                )
            for g in ("scheduler.budget_used_bytes", "peak_rss_delta_bytes"):
                v = (summary.get("gauges") or {}).get(g)
                if v is not None:
                    self._last_gauges[g] = float(v)
            # Probe-derived roofline fractions ride as top-level summary
            # fields, not gauges: write lane from takes, read lane from
            # restores (TPUSNAP_PROBE=1 only — absent otherwise).
            for f in ("roofline_fraction", "restore_roofline_fraction"):
                v = summary.get(f)
                if isinstance(v, (int, float)):
                    self._last_gauges[f] = float(v)
            self._rewrite_locked()

    def _rewrite_locked(self) -> None:
        text = self.render()
        path = self.path(self._rank if self._rank is not None else 0)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)

    def render(self) -> str:
        """The full exposition text from current state (process-global
        counters + last summary). Callable without a write for tests."""
        rank = str(self._rank if self._rank is not None else 0)
        job = get_job_id()
        counters = telemetry.global_counters_snapshot()
        out: List[str] = []

        def metric(
            name: str,
            mtype: str,
            help_: str,
            samples: List[Tuple[Dict[str, str], float]],
        ) -> None:
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {mtype}")
            for labels, value in samples:
                all_labels = dict(labels)
                all_labels["rank"] = rank
                all_labels["job"] = job
                out.append(f"{name}{_fmt_labels(all_labels)} {_fmt_value(value)}")

        for kind, mname in (("take", "tpusnap_take_seconds"),
                            ("restore", "tpusnap_restore_seconds")):
            if kind in self._last_wall:
                metric(
                    mname,
                    "gauge",
                    f"Wall-clock seconds of the last completed {kind}.",
                    [({}, self._last_wall[kind])],
                )
        for kind, mname in (("take", "tpusnap_takes_total"),
                            ("restore", "tpusnap_restores_total")):
            metric(
                mname,
                "counter",
                f"Completed {kind} summaries exported since process start.",
                [({}, self._summary_counts.get(kind, 0))],
            )
        metric(
            "tpusnap_bytes_written_total",
            "counter",
            "Snapshot bytes written to storage (process lifetime).",
            [({}, counters.get("storage.bytes_written", 0))],
        )
        metric(
            "tpusnap_bytes_read_total",
            "counter",
            "Snapshot bytes read from storage (process lifetime).",
            [({}, counters.get("storage.bytes_read", 0))],
        )
        metric(
            "tpusnap_retry_attempts_total",
            "counter",
            "Storage retry attempts (process lifetime).",
            [({}, counters.get("retry.attempts", 0))],
        )
        retry_series: List[Tuple[Dict[str, str], float]] = [
            ({"classification": name[len("retry."):]}, v)
            for name, v in sorted(counters.items())
            if name.startswith("retry.transient.")
            or name.startswith("retry.fatal.")
            or name.startswith("retry.exhausted.")
        ]
        metric(
            "tpusnap_retry_total",
            "counter",
            "Storage retries by classification (transient/fatal, op, "
            "exception type).",
            retry_series or [({"classification": "none"}, 0)],
        )
        metric(
            "tpusnap_stall_episodes_total",
            "counter",
            "Stall-watchdog episodes (no forward progress past the "
            "deadline inside a named op).",
            [({}, counters.get("progress.stall_episodes", 0))],
        )
        metric(
            "tpusnap_salvage_bytes_total",
            "counter",
            "Bytes salvaged from torn takes instead of rewritten.",
            [({}, counters.get("salvage.bytes_salvaged", 0))],
        )
        metric(
            "tpusnap_dedup_skips_total",
            "counter",
            "Incremental-dedup skipped blob writes.",
            [({}, counters.get("scheduler.dedup_skipped", 0))],
        )
        # Fused tile compression: input (logical) vs output (stored)
        # bytes through the codec — the fleet-level compression ratio is
        # rate(in)/rate(out), and a sustained in==out says the auto
        # policy is bypassing (fast local disk) as designed.
        metric(
            "tpusnap_compress_bytes_in_total",
            "counter",
            "Logical bytes fed through the fused tile codec.",
            [({}, counters.get("compress.bytes_in", 0))],
        )
        metric(
            "tpusnap_compress_bytes_out_total",
            "counter",
            "Stored (compressed) bytes produced by the fused tile codec.",
            [({}, counters.get("compress.bytes_out", 0))],
        )
        # Storage-boundary latency quantiles from the PROCESS-GLOBAL
        # log2 histograms (one summary-typed family per op, labeled by
        # plugin class): the tail the whole-op gauges average away.
        # Quantiles are point-in-time values, not counters — the
        # monotonic-domain rule applies to the *_total families only.
        io_hist = telemetry.global_io_histograms_snapshot()
        for op in ("write", "read"):
            samples: List[Tuple[Dict[str, str], float]] = []
            for key, st in io_hist.items():
                key_op, _, plugin = key.partition(".")
                if key_op != op or not st.get("count"):
                    continue
                for qname, qkey in (
                    ("0.5", "p50_s"),
                    ("0.95", "p95_s"),
                    ("0.99", "p99_s"),
                ):
                    v = st.get(qkey)
                    if v is not None:
                        samples.append(
                            ({"plugin": plugin, "quantile": qname}, v)
                        )
            if samples:
                metric(
                    f"tpusnap_storage_{op}_seconds",
                    "summary",
                    f"Storage-plugin {op} latency quantiles "
                    "(process-lifetime log2 histograms, per plugin class).",
                    samples,
                )
        if "scheduler.budget_used_bytes" in self._last_gauges:
            metric(
                "tpusnap_budget_high_water_bytes",
                "gauge",
                "Scheduler memory-budget high-water mark of the last "
                "take/restore.",
                [({}, self._last_gauges["scheduler.budget_used_bytes"])],
            )
        if "peak_rss_delta_bytes" in self._last_gauges:
            metric(
                "tpusnap_peak_rss_delta_bytes",
                "gauge",
                "Peak RSS delta sampled over the last take/restore.",
                [({}, self._last_gauges["peak_rss_delta_bytes"])],
            )
        if "roofline_fraction" in self._last_gauges:
            metric(
                "tpusnap_roofline_fraction",
                "gauge",
                "Last take's payload throughput as a fraction of the "
                "in-take probe WRITE ceiling (TPUSNAP_PROBE=1).",
                [({}, self._last_gauges["roofline_fraction"])],
            )
        if "restore_roofline_fraction" in self._last_gauges:
            metric(
                "tpusnap_restore_roofline_fraction",
                "gauge",
                "Last restore's payload throughput as a fraction of "
                "the in-restore probe READ ceiling (TPUSNAP_PROBE=1).",
                [({}, self._last_gauges["restore_roofline_fraction"])],
            )
        # Checkpoint-SLO gauges (tpusnap.slo): the per-rank view, plus
        # rank 0's fleet worst-case fold as scope="fleet" samples.
        slo = self._slo_state
        if slo is not None:
            fleet = slo.get("fleet") or {}

            def slo_samples(key: str) -> List[Tuple[Dict[str, str], float]]:
                samples: List[Tuple[Dict[str, str], float]] = []
                v = slo.get(key)
                if isinstance(v, (int, float)):
                    samples.append(({}, float(v)))
                fv = fleet.get(key)
                if isinstance(fv, (int, float)):
                    samples.append(({"scope": "fleet"}, float(fv)))
                return samples

            for key, mname, help_ in (
                (
                    "rpo_s",
                    "tpusnap_rpo_seconds",
                    "Seconds since the last committed take (recovery-"
                    "point exposure; fleet scope = worst rank).",
                ),
                (
                    "data_at_risk_bytes",
                    "tpusnap_data_at_risk_bytes",
                    "Bytes mutated since the last committed take (best "
                    "evidence tier: explicit steps / incremental change "
                    "stats / planned payload).",
                ),
                (
                    "estimated_rto_s",
                    "tpusnap_estimated_rto_seconds",
                    "History-derived estimated restore wall-clock of "
                    "the last committed snapshot.",
                ),
                (
                    "commit_interval_s",
                    "tpusnap_commit_interval_seconds",
                    "Monotonic interval between the last two commits "
                    "(the realized RPO of the closed interval).",
                ),
            ):
                samples = slo_samples(key)
                if samples:
                    metric(mname, "gauge", help_, samples)
            breach = slo.get("breach") or {}
            metric(
                "tpusnap_slo_breach",
                "gauge",
                "1 while a set TPUSNAP_SLO_RPO_S/RTO_S threshold is "
                "crossed, by objective.",
                [
                    ({"objective": k}, 1.0 if breach.get(k) else 0.0)
                    for k in ("rpo", "rto")
                ],
            )
        # Write-back tier gauges (tpusnap.tiering): the at-risk window
        # between local commit and cloud durability, live through
        # outages (lag rises while degraded, falls as the drain
        # recovers), plus the circuit-breaker state itself.
        tier = self._tier_state
        if tier is not None:
            metric(
                "tpusnap_upload_lag_bytes",
                "gauge",
                "Local-committed bytes not yet proven remote by the "
                "write-back uploader's journal.",
                [({}, float(tier.get("lag_bytes") or 0))],
            )
            metric(
                "tpusnap_upload_lag_seconds",
                "gauge",
                "Age of the oldest local commit still awaiting remote "
                "durability.",
                [({}, float(tier.get("lag_seconds") or 0.0))],
            )
            metric(
                "tpusnap_tier_degraded",
                "gauge",
                "1 while the uploader's outage circuit is open (remote "
                "unavailable; takes keep committing locally).",
                [({}, 1.0 if tier.get("degraded") else 0.0)],
            )
        metric(
            "tpusnap_last_summary_timestamp_seconds",
            "gauge",
            "Unix time this file was last rewritten (staleness probe).",
            [({}, _wall())],
        )
        return "\n".join(out) + "\n"


class JsonlEventSink(telemetry.MetricsSink):
    """One JSON line per take/restore summary, appended (O_APPEND, one
    write syscall — concurrent ranks interleave whole lines) to
    ``<metrics_dir>/events.jsonl``. Rotation-bounded: when the file
    exceeds ``max_bytes`` it is renamed to ``events.jsonl.1`` (replacing
    the previous rotation) and a fresh file starts — bounded worst-case
    footprint of 2x ``max_bytes``."""

    def __init__(
        self,
        directory: Optional[str] = None,
        max_bytes: int = _DEFAULT_JSONL_MAX_BYTES,
    ) -> None:
        self._directory = directory
        self.max_bytes = max(4096, int(max_bytes))
        self._lock = threading.Lock()

    def path(self) -> str:
        return os.path.join(self._directory or get_metrics_dir(), JSONL_FILENAME)

    def on_take_summary(self, summary: Dict[str, Any]) -> None:
        self._append(summary.get("kind") or "take", summary)

    def on_restore_summary(self, summary: Dict[str, Any]) -> None:
        self._append("restore", summary)

    def _append(self, kind: str, summary: Dict[str, Any]) -> None:
        from .history import append_jsonl_line, event_from_summary

        event = event_from_summary(kind, summary)
        event["completed"] = bool(summary.get("completed"))
        line = json.dumps(event, separators=(",", ":")) + "\n"
        path = self.path()
        with self._lock:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            try:
                if os.path.getsize(path) + len(line) > self.max_bytes:
                    os.replace(path, path + ".1")
            except OSError:
                pass
            append_jsonl_line(path, line)


# -------------------------------------------------- env-driven installing

_env_lock = threading.Lock()
_env_spec: Optional[Tuple[Tuple[str, ...], str]] = None
_env_sinks: List[telemetry.MetricsSink] = []


def install_env_sinks() -> None:
    """Reconcile registered export sinks against
    ``TPUSNAP_METRICS_EXPORT`` / ``TPUSNAP_METRICS_DIR``. Idempotent
    per spec (same env -> no-op); a changed spec unregisters the old
    env-installed sinks and registers the new set. Called at every
    take/restore begin; never raises to the caller."""
    spec = (get_metrics_export(), get_metrics_dir())
    with _env_lock:
        global _env_spec
        if spec == _env_spec:
            return
        for sink in _env_sinks:
            telemetry.unregister_metrics_sink(sink)
        _env_sinks.clear()
        formats, directory = spec
        for fmt in formats:
            sink: telemetry.MetricsSink
            if fmt == "prom":
                sink = PrometheusTextfileSink(directory)
            else:
                sink = JsonlEventSink(directory)
            telemetry.register_metrics_sink(sink)
            _env_sinks.append(sink)
        _env_spec = spec


# --------------------------------------------------- format self-checking


def parse_prometheus_textfile(text: str) -> Dict[str, Dict[str, Any]]:
    """Strict parse of the exposition text this module writes:
    ``{metric_name: {"type", "help", "samples": {label_string: value}}}``.
    Raises ``ValueError`` on any malformed line, a sample without a
    preceding ``# TYPE``, or a ``# TYPE``/``# HELP`` pair missing for a
    sampled metric — the acceptance-criteria format self-check, also
    usable against any collector-side copy of the file."""
    metrics: Dict[str, Dict[str, Any]] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_ = rest.partition(" ")
            if not name:
                raise ValueError(f"line {lineno}: HELP without a metric name")
            metrics.setdefault(name, {"samples": {}})["help"] = help_
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE "):]
            name, _, mtype = rest.partition(" ")
            if mtype not in ("counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(
                    f"line {lineno}: bad metric type {mtype!r} for {name!r}"
                )
            metrics.setdefault(name, {"samples": {}})["type"] = mtype
            continue
        if line.startswith("#"):
            continue  # comment
        # Sample: name[{labels}] value
        brace = line.find("{")
        if brace != -1:
            close = line.rfind("}")
            if close == -1 or close < brace:
                raise ValueError(f"line {lineno}: unbalanced label braces")
            name = line[:brace]
            labels = line[brace : close + 1]
            value_part = line[close + 1 :].strip()
        else:
            name, _, value_part = line.partition(" ")
            labels = ""
        if not name or not value_part:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        try:
            value = float(value_part.split()[0])
        except ValueError:
            raise ValueError(
                f"line {lineno}: non-numeric value {value_part!r}"
            ) from None
        meta = metrics.get(name)
        if meta is None or "type" not in meta:
            raise ValueError(
                f"line {lineno}: sample for {name!r} without a # TYPE line"
            )
        meta["samples"][labels] = value
    for name, meta in metrics.items():
        if meta["samples"] and ("help" not in meta or "type" not in meta):
            raise ValueError(f"metric {name!r} missing # HELP or # TYPE")
    return metrics
