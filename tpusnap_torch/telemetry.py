"""Per-take telemetry: stage spans, rank counters, persisted traces.

Counterpart of tpusnap/telemetry.py, with the same span, phase and
counter names, so a trace from either package reads the same (tpusnap's
``python -m tpusnap trace`` reads the port's). The device-to-host copy's
``dtoh`` span closes when the copy's CUDA event has completed, and a
restore's ``consume`` span when its host-to-device copy has. Each
summary feeds the export sinks (``metrics_export``), the cross-run
history (``history``) and, through them, the tuner (``tune``).

The paper's core claims — overlapped DtoH and storage I/O, memory-budget
driven scheduling, write load spread across ranks — are only verifiable
if a running take can say *where* its wall-clock and budget went, per
rank. This module is that instrument:

- **Spans** — monotonic-clock intervals recorded around every pipeline
  stage (flatten, the G1 plan gather, prepare, staging, checksum
  passes, storage writes, budget waits, barriers/KV waits). Span
  capture is gated by the ``TPUSNAP_TELEMETRY`` knob (on by default;
  the disabled path is a single dict lookup + ``None`` check).
- **Counters** — atomic, ALWAYS-ON (knob-independent): retry attempts
  per classification, injected faults, staging-pool hits/misses, bytes
  written, dedup skips. Cheap enough for the hot path (one lock'd
  ``dict`` add).
- **Gauges** — high-water marks (scheduler budget in use, peak RSS
  delta sampled by :mod:`tpusnap.rss_profiler`).
- **I/O histograms** — always-on log2-bucketed latency × size
  histograms per ``(op, plugin class)`` at the storage-plugin boundary
  (:class:`LogHistogram`/:class:`IOStats`, fed by the registry's
  instrumentation wrapper): p50/p95/p99/max derivable from any
  cross-rank merge, recorded per rank and folded into the rollup —
  whole-op spans hide tail latency; these are where it lives.
- **Roofline probes** — opt-in (``TPUSNAP_PROBE=1``) in-take probe
  segments the write scheduler interleaves between I/O windows; their
  samples land here and the summary derives a drift-immune
  ``roofline_fraction`` (see :mod:`tpusnap.analyze`).
- **Busy time** — each summary's ``stages`` entry carries ``busy_s``,
  the wall time during which at least one span of that name was open
  (the union of its intervals; ``total_s`` sums spans that overlap).
- **GIL probe** — while span capture is on, a take or restore runs one
  daemon thread that sleeps :data:`GIL_PROBE_PERIOD_S` and counts its
  lateness beyond the period (waits for the interpreter, over a floor
  of the operating system's wake-up latency) into ``gil.wait_ns``,
  ``gil.samples`` and the gauge ``gil.wait_max_s``.
- **Profiler ranges** — while ``torch.profiler`` runs, the spans of the
  analyze work categories are also ``record_function`` ranges named
  ``tpusnap.<span>`` (:func:`profiler_range`, :func:`ranged_executor`),
  so a device trace can put its idle gaps down to them. Pool threads
  show up only under ``profile_all_threads=True``.
- **TakeTelemetry** — the per-take aggregate. One is installed
  process-globally for the duration of a take (background drain
  threads re-install it thread-locally via :func:`use`); module-level
  :func:`span`/:func:`incr`/:func:`event` record into it from any
  layer without threading a handle through every call.

Persistence: each rank serializes its trace to **Chrome trace-event
JSON** (load it in ``chrome://tracing`` / Perfetto) plus a compact
summary, stored inside the snapshot at
``.tpusnap/telemetry/rank_<k>.json`` — written after the rank's blob
writes drain and BEFORE the metadata commit, so the
metadata-written-last invariant holds (a trace file can be orphaned by
an abort; a committed snapshot missing its trace only means telemetry
was disabled or its best-effort write failed). Rank 0 additionally
folds a cross-rank rollup (per-stage p50/max, bytes written, retries,
budget high-water) into the take's metadata ``extras`` — surfaced by
``python -m tpusnap trace <path>``.

External collectors subscribe through :class:`MetricsSink`
(``register_metrics_sink``): per-span and per-counter callbacks plus
one take-summary callback. Sink exceptions are swallowed — telemetry
must never fail a take.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Dict, Generator, List, Optional, Tuple

from torch.autograd import profiler as _torch_profiler

from .analyze import classify_span, union_seconds
from .knobs import is_telemetry_enabled

logger = logging.getLogger(__name__)

from .io_types import TELEMETRY_DIR  # canonical sidecar path (io_types)
from . import flight as _flight  # black-box event feed (span open/close)

# Wall-clock seam: timestamps only (started_at); all duration math in
# this file is monotonic.
_wall = time.time

# Summary of the most recent completed take in this process (set by
# end_take); benchmarks read this to embed the stage breakdown in their
# JSON without re-reading the snapshot.
LAST_TAKE_SUMMARY: Optional[Dict[str, Any]] = None

# Summary of the most recent completed restore in this process (set by
# Snapshot._restore_locked) — the restore-path counterpart benchmarks
# read for their restore stage_breakdown.
LAST_RESTORE_SUMMARY: Optional[Dict[str, Any]] = None


def telemetry_rank_path(rank: int) -> str:
    """Storage-relative path of one rank's persisted trace."""
    return f"{TELEMETRY_DIR}/rank_{rank}.json"


# --------------------------------------------------------------- sinks


class MetricsSink:
    """Subscriber interface for external collectors. Override any
    subset; default implementations are no-ops. Callbacks run inline on
    the recording thread and must be fast and non-raising (raises are
    swallowed, but the time is still yours)."""

    def on_span(self, name: str, duration_s: float, attrs: Dict[str, Any]) -> None:
        pass

    def on_counter(self, name: str, delta: int, value: int) -> None:
        pass

    def on_take_summary(self, summary: Dict[str, Any]) -> None:
        pass

    def on_restore_summary(self, summary: Dict[str, Any]) -> None:
        pass

    def on_slo_update(self, state: Dict[str, Any]) -> None:
        """A checkpoint-SLO state refresh (``slo``): RPO, data at risk,
        estimated RTO, commit interval; pushed at heartbeat cadence while
        a take runs and at every commit."""
        pass

    def on_tier_update(self, state: Dict[str, Any]) -> None:
        """A write-back tier status refresh (``tiering``): upload lag in
        bytes and seconds, degraded flag."""
        pass


_sinks: Tuple[MetricsSink, ...] = ()
_sinks_lock = threading.Lock()
# (sink class name, callback name) pairs already warned about since the
# last take/restore began — a broken exporter logs ONE rate-limited
# WARNING per sink class per callback per take instead of being
# silently invisible (or spamming once per span).
_sink_warned: set = set()


def _reset_sink_warnings() -> None:
    with _sinks_lock:
        _sink_warned.clear()


def register_metrics_sink(sink: MetricsSink) -> None:
    global _sinks
    with _sinks_lock:
        _sinks = _sinks + (sink,)


def unregister_metrics_sink(sink: MetricsSink) -> None:
    global _sinks
    with _sinks_lock:
        _sinks = tuple(s for s in _sinks if s is not sink)


@contextmanager
def metrics_sink(sink: MetricsSink) -> Generator[MetricsSink, None, None]:
    """Scoped registration: ``with metrics_sink(MySink()) as s: ...``
    unregisters on exit even when the body raises — a failing test (or a
    short-lived collector) can no longer leak its sink into the
    process-global tuple."""
    register_metrics_sink(sink)
    try:
        yield sink
    finally:
        unregister_metrics_sink(sink)


def _notify(method: str, *args) -> None:
    for sink in _sinks:
        try:
            getattr(sink, method)(*args)
        except Exception:
            # Swallowed (telemetry never fails a take) but NOT silent: a
            # broken exporter is diagnosable from one WARNING naming the
            # sink class and callback, rate-limited to once per sink
            # class per callback per take.
            key = (type(sink).__name__, method)
            with _sinks_lock:
                first = key not in _sink_warned
                _sink_warned.add(key)
            if first:
                logger.warning(
                    "MetricsSink %s.%s raised; exception swallowed "
                    "(telemetry never fails a take) — further failures "
                    "from this sink/callback suppressed until the next "
                    "take",
                    key[0],
                    method,
                    exc_info=True,
                )


def notify_slo_update(state: Dict[str, Any]) -> None:
    """Fan one SLO state refresh out to every sink (the ``slo``
    publisher's sink leg)."""
    _notify("on_slo_update", state)


def notify_tier_update(state: Dict[str, Any]) -> None:
    """Fan one write-back tier status refresh out to every sink."""
    _notify("on_tier_update", state)


# ---------------------------------------------------- global counters

# Process-lifetime counters, knob-independent: retry/fault/pool events
# are recorded here even outside a take, so tests and sinks can observe
# them without a snapshot in flight.
_global_counters: Dict[str, int] = {}
_counters_lock = threading.Lock()


def counter_value(name: str) -> int:
    with _counters_lock:
        return _global_counters.get(name, 0)


def global_counters_snapshot() -> Dict[str, int]:
    """Copy of the process-lifetime counters — the monotonic domain the
    Prometheus textfile sink exports (take-local counters reset per
    take and would break ``rate()``)."""
    with _counters_lock:
        return dict(_global_counters)


def reset_global_counters() -> None:
    """Test aid; production code never resets."""
    with _counters_lock:
        _global_counters.clear()


# ----------------------------------------------------- I/O histograms

# Bucket key for non-positive observations (a zero-latency op, an empty
# write): kept separate so quantile math never takes log2(0).
_ZERO_BUCKET = -1074  # below the smallest positive float64 exponent


class LogHistogram:
    """log2-bucketed histogram: observation ``v`` lands in bucket
    ``floor(log2 v)`` (i.e. the half-open interval ``[2^k, 2^(k+1))``),
    so the whole dynamic range of I/O latencies (microseconds to
    minutes) and sizes (bytes to gigabytes) fits in a few dozen integer
    buckets with bounded relative error. Tracks exact count/sum/min/max
    alongside, so ``quantile(1.0)`` is the true max and single-sample
    histograms are exact. Mergeable across ranks (bucket-count sums) —
    the property the cross-rank rollup and the trend gates rely on;
    p50/p95/p99 are derivable from any merge. NOT thread-safe on its
    own; callers hold their registry lock."""

    __slots__ = ("buckets", "count", "total", "vmin", "vmax")

    def __init__(self) -> None:
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        if v > 0.0:
            # floor(log2 v) == frexp exponent - 1 (v = m * 2^e, m in
            # [0.5, 1)) — no log call, exact at bucket boundaries.
            k = math.frexp(v)[1] - 1
        else:
            v = 0.0
            k = _ZERO_BUCKET
        self.buckets[k] = self.buckets.get(k, 0) + 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` in [0, 1]: geometrically interpolated
        within the bucket holding the q-th observation (rank position
        maps to an exponent fraction, so the estimate moves CONTINUOUSLY
        as mass shifts across a bucket boundary — a gated p99 must not
        jump 2x when the true latency drifts 10% across a power of
        two), clamped into the exact observed [min, max]. Exact for max
        and for single-sample histograms (a lone sample interpolates to
        its bucket's upper edge, which the clamp pins to the sample)."""
        if self.count == 0:
            return None
        if q >= 1.0:
            return self.vmax
        target = q * self.count
        cum = 0
        for k in sorted(self.buckets):
            n = self.buckets[k]
            cum += n
            if cum >= target:
                if k == _ZERO_BUCKET:
                    return 0.0
                frac = (target - (cum - n)) / n
                est = math.ldexp(1.0, k) * (2.0 ** frac)
                return max(min(est, self.vmax), self.vmin)
        return self.vmax

    def merge(self, other: "LogHistogram") -> None:
        for k, n in other.buckets.items():
            self.buckets[k] = self.buckets.get(k, 0) + n
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "total": self.total,
            "min": self.vmin if self.count else None,
            "max": self.vmax,
            "buckets": {str(k): n for k, n in sorted(self.buckets.items())},
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LogHistogram":
        h = cls()
        for k, n in (d.get("buckets") or {}).items():
            h.buckets[int(k)] = int(n)
        h.count = int(d.get("count", 0))
        h.total = float(d.get("total", 0.0))
        h.vmin = float(d["min"]) if d.get("min") is not None else math.inf
        h.vmax = float(d.get("max", 0.0))
        return h


class IOStats:
    """Latency × size histogram pair for one (op, plugin-class) key at
    the storage-plugin boundary: per-op latency in seconds and payload
    size in bytes, each log2-bucketed, plus the derived quantiles the
    doctor CLI and the regression gates read."""

    __slots__ = ("latency", "size")

    def __init__(self) -> None:
        self.latency = LogHistogram()
        self.size = LogHistogram()

    def observe(self, seconds: float, nbytes: int) -> None:
        self.latency.observe(seconds)
        self.size.observe(nbytes)

    def merge_dict(self, d: Dict[str, Any]) -> None:
        if "latency" in d:
            self.latency.merge(LogHistogram.from_dict(d["latency"]))
        if "size" in d:
            self.size.merge(LogHistogram.from_dict(d["size"]))

    def to_dict(self) -> Dict[str, Any]:
        lat = self.latency
        out: Dict[str, Any] = {
            "count": lat.count,
            "total_s": round(lat.total, 6),
            "bytes_total": int(self.size.total),
            "latency": lat.to_dict(),
            "size": self.size.to_dict(),
        }
        for name, q in (("p50_s", 0.5), ("p95_s", 0.95), ("p99_s", 0.99)):
            v = lat.quantile(q)
            out[name] = round(v, 9) if v is not None else None
        out["max_s"] = round(lat.vmax, 9) if lat.count else None
        return out


# Process-lifetime I/O histograms, knob-independent like the counters:
# one IOStats per "<op>.<PluginClass>" key ("write.FSStoragePlugin").
# The Prometheus sink exports quantiles from THIS registry (stable
# across takes); per-take copies ride TakeTelemetry and the rollup.
_global_io_stats: Dict[str, IOStats] = {}
_io_stats_lock = threading.Lock()


def observe_io(
    op: str,
    plugin: str,
    seconds: float,
    nbytes: int,
    rec: Optional["TakeTelemetry"] = None,
) -> None:
    """Record one storage-plugin op (write/read/delete/list) into the
    process-global histograms AND the in-flight take/restore recorder
    (the ambient one, or an explicit ``rec``). Always-on: the cost is
    two dict updates per multi-MB I/O op."""
    key = f"{op}.{plugin}"
    with _io_stats_lock:
        st = _global_io_stats.get(key)
        if st is None:
            st = _global_io_stats[key] = IOStats()
        st.observe(seconds, nbytes)
    rec = rec if rec is not None else current()
    if rec is not None:
        rec.observe_io(key, seconds, nbytes)


def global_io_histograms_snapshot() -> Dict[str, Dict[str, Any]]:
    """Serialized copy of the process-lifetime I/O histograms (the
    monotonic domain the Prometheus sink exports quantiles from)."""
    with _io_stats_lock:
        return {k: v.to_dict() for k, v in sorted(_global_io_stats.items())}


def reset_global_io_histograms() -> None:
    """Test aid; production code never resets."""
    with _io_stats_lock:
        _global_io_stats.clear()


def probe_aggregate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold in-take roofline probe samples into the compact aggregate
    the summary/rollup/history carry: sample count, p50 of the per-probe
    write/read ceilings, total probe bytes and elapsed time."""

    def _p50(key: str) -> Optional[float]:
        vals = sorted(s[key] for s in samples if s.get(key))
        return round(vals[len(vals) // 2], 4) if vals else None

    return {
        "probes": len(samples),
        "write_gbps_p50": _p50("write_gbps"),
        "read_gbps_p50": _p50("read_gbps"),
        "bytes": int(sum(s.get("bytes", 0) for s in samples)),
        "elapsed_s": round(sum(s.get("elapsed_s", 0.0) for s in samples), 6),
    }


def merge_io_histograms(
    dicts: List[Dict[str, Dict[str, Any]]],
) -> Dict[str, Dict[str, Any]]:
    """Merge serialized per-rank ``io_histograms`` maps (bucket-count
    sums per key) — the cross-rank rollup's histogram fold. Quantiles
    are recomputed from the merged buckets."""
    merged: Dict[str, IOStats] = {}
    for d in dicts:
        for key, st_dict in (d or {}).items():
            st = merged.get(key)
            if st is None:
                st = merged[key] = IOStats()
            try:
                st.merge_dict(st_dict)
            except Exception:
                continue
    return {k: v.to_dict() for k, v in sorted(merged.items())}


# ---------------------------------------------------- profiler ranges

# The analyze categories whose spans are opened as profiler ranges: the
# work of a take or a restore, not its waits or containers.
_RANGE_CATEGORIES = frozenset(
    {"stage", "dtoh", "checksum", "compress", "storage_write", "storage_read", "consume"}
)
_NO_RANGE = nullcontext()


def profiler_range(name: str):
    """A ``record_function`` range ``tpusnap.<name>`` while
    ``torch.profiler`` runs and ``name`` is a span of a work category,
    whether or not span capture is on; a shared no-op context otherwise
    (one boolean read)."""
    if not _torch_profiler._is_profiler_enabled or classify_span(name) not in _RANGE_CATEGORIES:
        return _NO_RANGE
    return _torch_profiler.record_function("tpusnap." + name)


class _RangedExecutor:
    """Runs each call submitted to ``executor`` inside a profiler range,
    on the pool thread that runs it (``loop.run_in_executor`` submits)."""

    def __init__(self, executor, name: str) -> None:
        self._executor = executor
        self._name = name

    def submit(self, fn, *args, **kwargs):
        return self._executor.submit(self._run, fn, *args, **kwargs)

    def _run(self, fn, *args, **kwargs):
        with profiler_range(self._name):
            return fn(*args, **kwargs)


def ranged_executor(executor, name: str):
    """``executor`` itself, or, while ``torch.profiler`` runs, a view of
    it whose calls run inside ``tpusnap.<name>`` ranges on their pool
    threads (for spans that an event loop holds across an await while a
    pool does the work)."""
    if executor is None or not _torch_profiler._is_profiler_enabled:
        return executor
    return _RangedExecutor(executor, name)


# ------------------------------------------------------------ GIL probe

# The probe's sleep. Lateness beyond it is time the probe, a Python
# thread, took to run again: waits for the interpreter, and the
# operating system's wake-up latency, which an idle process reads alone
# and which every reading holds as its floor (docs/design.md).
GIL_PROBE_PERIOD_S = 0.005


class _GilProbe:
    """Daemon thread that sleeps :data:`GIL_PROBE_PERIOD_S` over and over
    and sums its lateness; :meth:`stop` joins it and records the totals
    into its recorder."""

    def __init__(self, rec: "TakeTelemetry") -> None:
        self._rec = rec
        self._stop = threading.Event()
        self._wait_ns = 0
        self._samples = 0
        self._max_ns = 0
        self._until_ns = 0
        self._thread = threading.Thread(target=self._run, name="tpusnap-gil-probe", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        period_ns = int(GIL_PROBE_PERIOD_S * 1e9)
        clock = time.perf_counter_ns
        while True:
            t = clock()
            if self._stop.wait(GIL_PROBE_PERIOD_S):
                return
            now = clock()
            if self._stop.is_set():
                # A wake that outlived the recorder's freeze counts up to it.
                now = min(now, self._until_ns)
            late = max(now - t - period_ns, 0)
            self._samples += 1
            self._wait_ns += late
            if late > self._max_ns:
                self._max_ns = late

    def stop(self) -> None:
        """Called at the recorder's freeze: no lateness past now counts,
        so the sum stays inside the take's wall time."""
        self._until_ns = time.perf_counter_ns()
        self._stop.set()
        self._thread.join()
        incr("gil.wait_ns", self._wait_ns, rec=self._rec)
        incr("gil.samples", self._samples, rec=self._rec)
        self._rec.gauge_max("gil.wait_max_s", self._max_ns / 1e9)


# ------------------------------------------------------- TakeTelemetry


class TakeTelemetry:
    """Thread-safe per-take aggregate of spans, counters and gauges.

    ``enabled`` gates SPAN capture only (the TPUSNAP_TELEMETRY knob,
    sampled once at construction so a take is internally consistent);
    counters and gauges are always recorded. Timestamps are offsets
    from the take's start on the monotonic clock."""

    def __init__(self, rank: int, enabled: Optional[bool] = None) -> None:
        self.rank = rank
        self.enabled = is_telemetry_enabled() if enabled is None else enabled
        self.t0 = time.monotonic()
        self.wall0 = _wall()
        # Identity/outcome context merged into summary(): the take path
        # sets kind/take_id/path/world_size once they're agreed, and
        # completed=True strictly after the commit — the history store
        # and export sinks key off these (an aborted take must not
        # become a throughput trend point).
        self.meta: Dict[str, Any] = {}
        self._lock = threading.Lock()
        # (name, start_s, dur_s, thread_name, is_phase, attrs)
        self._spans: List[Tuple[str, float, float, str, bool, Dict[str, Any]]] = []
        # (name, ts_s, thread_name, attrs) — instant events (faults, retries)
        self._events: List[Tuple[str, float, str, Dict[str, Any]]] = []
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        # Per-take I/O histograms ("<op>.<PluginClass>" → IOStats) and
        # in-take roofline probe samples — always-on like the counters.
        self._io_hist: Dict[str, IOStats] = {}
        self._probe_samples: List[Dict[str, Any]] = []
        self._finalized_wall_s: Optional[float] = None
        # Live state for the heartbeat/watchdog (tpusnap.progress):
        # in-flight named ops keyed by an opaque token (an op may span
        # awaits, so a per-thread stack would mis-pop under the event
        # loop's interleaving), plus the most recently COMPLETED phase.
        self._inflight: Dict[object, Tuple[str, str]] = {}
        self._last_phase: Optional[str] = None
        self._rss_sampler = None
        self._gil_probe: Optional[_GilProbe] = None
        if self.enabled:
            try:
                from .rss_profiler import RSSSampler

                self._rss_sampler = RSSSampler(interval_sec=0.1)
                self._rss_sampler.start()
            except Exception:
                self._rss_sampler = None

    # --- recording ------------------------------------------------------

    def now(self) -> float:
        return time.monotonic() - self.t0

    def record_span(
        self,
        name: str,
        start_s: float,
        dur_s: float,
        phase: bool = False,
        **attrs: Any,
    ) -> None:
        if not self.enabled:
            return
        thread = threading.current_thread().name
        with self._lock:
            self._spans.append((name, start_s, dur_s, thread, phase, attrs))
        _notify("on_span", name, dur_s, attrs)

    @contextmanager
    def span(
        self, name: str, phase: bool = False, **attrs: Any
    ) -> Generator[None, None, None]:
        if not self.enabled:
            with profiler_range(name):
                yield
            return
        start = self.now()
        token = self.op_enter(name)
        try:
            with profiler_range(name):
                yield
        finally:
            self.op_exit(token)
            self.record_span(name, start, self.now() - start, phase=phase, **attrs)

    # --- live state (heartbeat/watchdog feed) ---------------------------

    def op_enter(self, name: str) -> Optional[object]:
        """Mark a named op as in flight; returns the token to pass back
        to :meth:`op_exit`. No-op (None) when span capture is off."""
        if not self.enabled:
            return None
        token = object()
        thread = threading.current_thread().name
        with self._lock:
            self._inflight[token] = (thread, name)
        # Flight-recorder feed (span OPEN): an op that began but never
        # ended is exactly what the post-mortem timeline must show.
        _flight.record("op_begin", op=name)
        return token

    def op_exit(self, token: Optional[object]) -> None:
        if token is None:
            return
        with self._lock:
            entry = self._inflight.pop(token, None)
        if entry is not None:
            _flight.record("op_end", op=entry[1])

    @contextmanager
    def op(self, name: str) -> Generator[None, None, None]:
        """In-flight tracking only (no span record) — for call sites
        that record their span manually but should still be visible to
        the stall watchdog while blocked."""
        token = self.op_enter(name)
        try:
            yield
        finally:
            self.op_exit(token)

    def note_phase(self, name: str) -> None:
        """Record ``name`` as the most recently completed phase (called
        by :class:`PhaseMarker`); read by the heartbeat publisher."""
        self._last_phase = name
        _flight.record("phase", op=name)

    def live_snapshot(self) -> Dict[str, Any]:
        """One consistent snapshot of the recorder's observable state
        for the progress pump: last completed phase, in-flight ops in
        start order (oldest first), counters, and a monotonically
        growing mark count (spans + events) whose advance IS forward
        progress."""
        with self._lock:
            ops = list(self._inflight.values())
            counters = dict(self._counters)
            marks = len(self._spans) + len(self._events)
            probe_gbps = (
                self._probe_samples[-1].get("write_gbps")
                if self._probe_samples
                else None
            )
        out = {
            "phase": self._last_phase,
            "ops": ops,
            "counters": counters,
            "marks": marks,
        }
        if probe_gbps:
            # Latest in-take probe ceiling: lets the heartbeat/watch
            # table express live MB/s as a fraction of the achievable.
            out["probe_write_gbps"] = round(probe_gbps, 3)
        return out

    def event(self, name: str, **attrs: Any) -> None:
        if not self.enabled:
            return
        thread = threading.current_thread().name
        with self._lock:
            self._events.append((name, self.now(), thread, attrs))

    def incr(self, name: str, n: int = 1) -> None:
        # No sink notification here: the module-level incr() notifies
        # with the PROCESS-GLOBAL cumulative value, so sinks see one
        # consistent monotonic domain instead of take-local resets.
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge_max(self, name: str, value: float) -> None:
        with self._lock:
            if value > self._gauges.get(name, float("-inf")):
                self._gauges[name] = value

    def observe_io(self, key: str, seconds: float, nbytes: int) -> None:
        """Take-local leg of :func:`observe_io` (always-on)."""
        with self._lock:
            st = self._io_hist.get(key)
            if st is None:
                st = self._io_hist[key] = IOStats()
            st.observe(seconds, nbytes)

    def add_probe_sample(self, sample: Dict[str, Any]) -> None:
        """Record one in-take roofline probe result (scheduler's probe
        runner): ``write_gbps``/``read_gbps``/``bytes``/``elapsed_s``."""
        with self._lock:
            self._probe_samples.append(dict(sample))

    # --- finalization ---------------------------------------------------

    def start_gil_probe(self) -> None:
        """Start the GIL probe (span capture on only); :meth:`finalize`
        stops it."""
        if self.enabled and self._gil_probe is None:
            self._gil_probe = _GilProbe(self)

    def finalize(self) -> None:
        """Freeze the take wall-clock, stop the GIL probe and the RSS
        sampler. Idempotent; spans recorded after this still reach sinks
        but are not part of the persisted trace's coverage window."""
        if self._finalized_wall_s is not None:
            return
        self._finalized_wall_s = self.now()
        if self._gil_probe is not None:
            self._gil_probe.stop()
            self._gil_probe = None
        if self._rss_sampler is not None:
            try:
                self._rss_sampler.stop()
                self.gauge_max(
                    "peak_rss_delta_bytes", float(self._rss_sampler.peak_delta)
                )
            except Exception:
                pass
            self._rss_sampler = None

    @property
    def take_wall_s(self) -> float:
        return (
            self._finalized_wall_s
            if self._finalized_wall_s is not None
            else self.now()
        )

    # --- serialization --------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """Compact aggregate: per-span-name {count, total_s, p50_s,
        max_s, busy_s}, phase list (for wall-clock coverage), counters,
        gauges. ``busy_s`` is the union of the name's spans: the wall
        time during which at least one of them was open."""
        with self._lock:
            spans = list(self._spans)
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            events = list(self._events)
            io_hist = {k: v.to_dict() for k, v in sorted(self._io_hist.items())}
            probes = [dict(s) for s in self._probe_samples]
        by_name: Dict[str, List[Tuple[float, float]]] = {}
        phase_total: Dict[str, float] = {}
        for name, start, dur, _thread, phase, _attrs in spans:
            by_name.setdefault(name, []).append((start, dur))
            if phase:
                phase_total[name] = phase_total.get(name, 0.0) + dur
        stages = {}
        for name, ivs in sorted(by_name.items()):
            durs_sorted = sorted(dur for _, dur in ivs)
            stages[name] = {
                "count": len(ivs),
                "total_s": round(sum(durs_sorted), 6),
                "p50_s": round(durs_sorted[len(durs_sorted) // 2], 6),
                "max_s": round(durs_sorted[-1], 6),
                "busy_s": round(union_seconds([(s, s + d) for s, d in ivs]), 6),
            }
        take_wall = self.take_wall_s
        phase_sum = sum(phase_total.values())
        out = {
            **self.meta,
            "rank": self.rank,
            "enabled": self.enabled,
            "started_at": self.wall0,
            "take_wall_s": round(take_wall, 6),
            "phases": {k: round(v, 6) for k, v in phase_total.items()},
            "phase_coverage": (
                round(min(phase_sum / take_wall, 1.0), 4) if take_wall > 0 else 0.0
            ),
            "stages": stages,
            "counters": counters,
            "gauges": gauges,
            "events": len(events),
        }
        if io_hist:
            out["io_histograms"] = io_hist
        if probes:
            out["probe"] = probe_aggregate(probes)
            # Drift-immune roofline fraction: the operation's payload
            # throughput over its NON-PROBE wall-clock, against the
            # ceiling the interleaved probes measured through the same
            # engine moments apart — no separate roofline session whose
            # disk window the take never shared. Takes judge the write
            # leg; restores judge the read leg.
            adj_wall = max(take_wall - out["probe"].get("elapsed_s", 0.0), 1e-9)
            if self.meta.get("kind") == "restore":
                ceiling = out["probe"].get("read_gbps_p50")
                payload = counters.get("storage.bytes_read", 0)
                if ceiling and payload:
                    out["restore_roofline_fraction"] = round(
                        (payload / adj_wall / 1e9) / ceiling, 4
                    )
            else:
                ceiling = out["probe"].get("write_gbps_p50")
                payload = counters.get("storage.bytes_written", 0)
                if ceiling and payload:
                    out["roofline_fraction"] = round(
                        (payload / adj_wall / 1e9) / ceiling, 4
                    )
        return out

    def chrome_trace_events(self) -> List[Dict[str, Any]]:
        """Chrome trace-event list: complete ("X") events for spans,
        instant ("i") events for faults/retries, ts/dur in microseconds,
        pid = rank, tid = recording thread name."""
        with self._lock:
            spans = list(self._spans)
            events = list(self._events)
        out: List[Dict[str, Any]] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": self.rank,
                "tid": 0,
                "args": {"name": f"tpusnap rank {self.rank}"},
            }
        ]
        for name, start, dur, thread, phase, attrs in spans:
            ev: Dict[str, Any] = {
                "name": name,
                "ph": "X",
                "cat": "phase" if phase else "op",
                "ts": round(start * 1e6, 1),
                "dur": round(dur * 1e6, 1),
                "pid": self.rank,
                "tid": thread,
            }
            if attrs:
                ev["args"] = attrs
            out.append(ev)
        for name, ts, thread, attrs in events:
            ev = {
                "name": name,
                "ph": "i",
                "cat": "event",
                "s": "p",
                "ts": round(ts * 1e6, 1),
                "pid": self.rank,
                "tid": thread,
            }
            if attrs:
                ev["args"] = attrs
            out.append(ev)
        return out

    def to_json(self) -> str:
        return json.dumps(
            {
                "rank": self.rank,
                "summary": self.summary(),
                "traceEvents": self.chrome_trace_events(),
            },
            sort_keys=False,
        )


# --------------------------------------------- ambient current recorder

# The take installs its recorder process-globally; background threads
# (async commit drain) overlay it thread-locally via use() so a NEWER
# take's global install cannot steal their spans.
_global_current: Optional[TakeTelemetry] = None
_tls = threading.local()


def current() -> Optional[TakeTelemetry]:
    rec = getattr(_tls, "current", None)
    return rec if rec is not None else _global_current


def _job_id() -> str:
    """The job identity every summary carries (``meta["job_id"]`` —
    concurrent jobs sharing a telemetry/metrics dir stay attributable).
    Best-effort: identity must never fail a take."""
    try:
        from .knobs import get_job_id

        return get_job_id()
    except Exception:
        return "job"


def _begin_common() -> None:
    # Fresh take/restore: re-arm the one-warning-per-sink budget and
    # reconcile env-driven export sinks (TPUSNAP_METRICS_EXPORT may
    # have changed since the last take; best-effort, never fatal).
    _reset_sink_warnings()
    try:
        from .metrics_export import install_env_sinks

        install_env_sinks()
    except Exception:
        logger.warning("Failed to install metrics export sinks (non-fatal)", exc_info=True)


def begin_take(rank: int) -> TakeTelemetry:
    """Create a take recorder and install it as the process-global
    current. Pipeline layers then record through the module-level
    span()/incr()/event() without threading a handle."""
    global _global_current
    _begin_common()
    # Fresh black box per take: the flight sidecar is a per-take
    # artifact, and a crashed take's verdict must not count previous
    # takes' stalls/evictions (restores do NOT reset — they overlay).
    try:
        _flight.recorder().mark_take_start()
    except Exception:
        logger.debug("flight ring reset failed", exc_info=True)
    rec = TakeTelemetry(rank)
    rec.meta["kind"] = "take"
    rec.meta["job_id"] = _job_id()
    rec.start_gil_probe()
    _global_current = rec
    return rec


def begin_restore(rank: int) -> TakeTelemetry:
    """Create a restore recorder (NOT installed globally — restores
    overlay it thread-locally via :func:`use` so an in-flight take's
    global recorder is never disturbed)."""
    _begin_common()
    rec = TakeTelemetry(rank)
    rec.meta["kind"] = "restore"
    rec.meta["job_id"] = _job_id()
    rec.start_gil_probe()
    return rec


def release_global(rec: TakeTelemetry) -> None:
    """Uninstall ``rec`` as the process-global current (no-op when a
    newer take already replaced it). async_take calls this when control
    returns to training — the background drain keeps recording through
    captured references and a thread-local :func:`use` overlay."""
    global _global_current
    if _global_current is rec:
        _global_current = None


def end_take(rec: TakeTelemetry) -> None:
    """Finalize + uninstall (only if still installed) and publish the
    summary: LAST_TAKE_SUMMARY, the sinks' on_take_summary, and — for
    COMPLETED takes only — one cross-run history event."""
    global LAST_TAKE_SUMMARY
    # The tuner's overlay is scoped to the take that applied it (every
    # take path, sync, async or aborted, ends here); knob reads after it
    # see the plain environment. The summary still carries meta["tuned"].
    try:
        from .knobs import clear_tuned_plan

        clear_tuned_plan()
    except Exception:
        pass
    rec.finalize()
    release_global(rec)
    summary = rec.summary()
    LAST_TAKE_SUMMARY = summary
    _notify("on_take_summary", summary)
    try:
        from .history import record_summary

        record_summary("take", summary)
    except Exception:
        logger.debug("history record failed", exc_info=True)


def publish_restore_summary(summary: Dict[str, Any]) -> None:
    """Restore-side counterpart of :func:`end_take`'s publication step:
    LAST_RESTORE_SUMMARY, the sinks' on_restore_summary, and — for
    completed restores — one history event."""
    global LAST_RESTORE_SUMMARY
    LAST_RESTORE_SUMMARY = summary
    _notify("on_restore_summary", summary)
    try:
        from .history import record_summary

        record_summary("restore", summary)
    except Exception:
        logger.debug("history record failed", exc_info=True)


@contextmanager
def use(rec: Optional[TakeTelemetry]) -> Generator[None, None, None]:
    """Thread-local overlay: make ``rec`` the current recorder on THIS
    thread (async commit / background restore threads)."""
    prev = getattr(_tls, "current", None)
    _tls.current = rec
    try:
        yield
    finally:
        _tls.current = prev


@contextmanager
def span(name: str, phase: bool = False, **attrs: Any) -> Generator[None, None, None]:
    """Record a span into the ambient recorder; no-op (one lookup) when
    no take is in flight or span capture is knob-disabled."""
    rec = current()
    if rec is None or not rec.enabled:
        with profiler_range(name):
            yield
        return
    with rec.span(name, phase=phase, **attrs):
        yield


def event(name: str, **attrs: Any) -> None:
    rec = current()
    if rec is not None:
        rec.event(name, **attrs)


def incr(name: str, n: int = 1, rec: Optional[TakeTelemetry] = None) -> None:
    """Always-on counter: bumps the process-global counter AND the
    in-flight take's (the ambient one, or an explicit ``rec`` captured
    by code that outlives the take's global install). Sinks are
    notified with the process-global cumulative value — one monotonic
    domain regardless of take boundaries."""
    with _counters_lock:
        global_value = _global_counters.get(name, 0) + n
        _global_counters[name] = global_value
    rec = rec if rec is not None else current()
    if rec is not None:
        rec.incr(name, n)
    _notify("on_counter", name, n, global_value)


def gauge_max(name: str, value: float) -> None:
    rec = current()
    if rec is not None:
        rec.gauge_max(name, value)


class PhaseMarker:
    """Sequential PHASE-span recorder for a linear pipeline: each call
    records a phase span from the previous mark (or construction) to
    now, so the recorded phases tile the timeline with no gaps — which
    is what makes the trace CLI's wall-clock coverage meaningful."""

    def __init__(
        self, rec: Optional[TakeTelemetry] = None, from_start: bool = False
    ) -> None:
        self.rec = rec if rec is not None else current()
        # from_start anchors the first phase at the recorder's t0, so
        # recorder-construction overhead (RSS sampler thread spawn)
        # cannot open a coverage hole before the first phase.
        self.last = (
            self.rec.now()
            if self.rec is not None and self.rec.enabled and not from_start
            else 0.0
        )

    def __call__(self, name: str, **attrs: Any) -> None:
        if self.rec is None or not self.rec.enabled:
            return
        now = self.rec.now()
        self.rec.record_span(name, self.last, now - self.last, phase=True, **attrs)
        self.rec.note_phase(name)
        self.last = now

def phase_marker(from_start: bool = False) -> PhaseMarker:
    return PhaseMarker(from_start=from_start)


# -------------------------------------------------------------- rollup


def rollup_summaries(summaries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Cross-rank rollup rank 0 folds into the metadata extras: per
    stage, the p50/max over ranks of each rank's TOTAL time in that
    stage — WITH the straggler's rank id (``max_rank``); summed
    counters; max gauges; slowest-rank wall-clock; and ``phase_skew``,
    the per-phase straggler attribution (slowest rank + max/p50 skew)
    the stall watchdog's post-mortem reads."""
    summaries = [s for s in summaries if s]
    if not summaries:
        return {}
    # (total_s, rank) pairs so the straggler keeps its rank id.
    stage_totals: Dict[str, List[Tuple[float, int]]] = {}
    phase_totals: Dict[str, List[Tuple[float, int]]] = {}
    counters: Dict[str, int] = {}
    gauges: Dict[str, float] = {}
    for i, s in enumerate(summaries):
        rank = s.get("rank", i)
        for name, agg in (s.get("stages") or {}).items():
            stage_totals.setdefault(name, []).append(
                (agg.get("total_s", 0.0), rank)
            )
        for name, v in (s.get("phases") or {}).items():
            phase_totals.setdefault(name, []).append((v, rank))
        for name, v in (s.get("counters") or {}).items():
            counters[name] = counters.get(name, 0) + v
        for name, v in (s.get("gauges") or {}).items():
            if v > gauges.get(name, float("-inf")):
                gauges[name] = v
    stages = {}
    for name, totals in sorted(stage_totals.items()):
        ts = sorted(totals)
        stages[name] = {
            "ranks": len(ts),
            "p50_s": round(ts[len(ts) // 2][0], 6),
            "max_s": round(ts[-1][0], 6),
            "max_rank": ts[-1][1],
        }
    phase_skew = {}
    for name, totals in sorted(phase_totals.items()):
        ts = sorted(totals)
        p50, mx = ts[len(ts) // 2][0], ts[-1][0]
        phase_skew[name] = {
            "p50_s": round(p50, 6),
            "max_s": round(mx, 6),
            "max_rank": ts[-1][1],
            "skew": round(mx / p50, 3) if p50 > 0 else None,
        }
    out = {
        "phase_skew": phase_skew,
        "ranks": len(summaries),
        "take_wall_s": round(max(s.get("take_wall_s", 0.0) for s in summaries), 6),
        "phase_coverage_min": round(
            min(s.get("phase_coverage", 0.0) for s in summaries), 4
        ),
        "stages": stages,
        "counters": counters,
        "gauges": gauges,
        "bytes_written": counters.get("storage.bytes_written", 0),
        "retry_attempts": counters.get("retry.attempts", 0),
        "budget_high_water_bytes": gauges.get("scheduler.budget_used_bytes"),
        "peak_rss_delta_bytes": gauges.get("peak_rss_delta_bytes"),
    }
    # Cross-rank I/O histogram merge: bucket-count sums per
    # "<op>.<PluginClass>" key, quantiles recomputed from the merge —
    # a rank's p99 outlier survives the fold instead of averaging away.
    io_merged = merge_io_histograms(
        [s.get("io_histograms") or {} for s in summaries]
    )
    if io_merged:
        out["io_histograms"] = io_merged
    # Roofline probes: the p50 fraction across ranks (the fleet
    # headline) plus the worst rank's, with its id (a single rank's slow
    # disk is a straggler story, not a fleet story). Takes fold
    # ``roofline_fraction`` (write lane), restores fold
    # ``restore_roofline_fraction`` (read lane) — same shape.
    any_fracs = False
    for field in ("roofline_fraction", "restore_roofline_fraction"):
        fracs = sorted(
            (s[field], s.get("rank", i))
            for i, s in enumerate(summaries)
            if isinstance(s.get(field), (int, float))
        )
        if not fracs:
            continue
        any_fracs = True
        out[field] = round(fracs[len(fracs) // 2][0], 4)
        out[f"{field}_min"] = round(fracs[0][0], 4)
        out[f"{field}_min_rank"] = fracs[0][1]
    if any_fracs:
        probe_ranks = [s["probe"] for s in summaries if s.get("probe")]
        if probe_ranks:
            out["probe"] = {
                "probes": sum(p.get("probes", 0) for p in probe_ranks)
            }
            for lane in ("write_gbps_p50", "read_gbps_p50"):
                ceilings = sorted(
                    p[lane] for p in probe_ranks if p.get(lane)
                )
                out["probe"][lane] = (
                    round(ceilings[len(ceilings) // 2], 4) if ceilings else None
                )
    return out
