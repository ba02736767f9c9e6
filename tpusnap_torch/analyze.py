"""Performance attribution: critical-path bound analysis + doctor logic.

Counterpart of tpusnap/analyze.py (vendored: the same categories,
thresholds, verdicts and advice, so both packages judge one trace
alike). Spans, heartbeats, histograms and fleet counters alone
interpret nothing: an operator looking at a slow take
still has to eyeball a Chrome trace to learn whether it was
storage-bound, budget-wait-bound or straggler-bound. This module is the
interpreter behind ``python -m tpusnap_torch analyze <path>``:

- **Critical-path bound analysis** (:func:`attribute_spans`): a
  deterministic sweep over one rank's recorded op spans that attributes
  every instant of take/restore wall-clock to exactly one RESOURCE
  (storage write/read, DtoH, stage/clone, checksum, consume,
  ``budget_wait``, barriers) and emits a bound-by verdict with
  percentages. Attribution semantics (documented in docs/design.md
  "Performance attribution"):

  * instants where storage I/O is in flight attribute to the I/O
    category — in an overlapped pipeline, compute that runs UNDER
    in-flight I/O is hidden by it, so shrinking it cannot shrink the
    take;
  * compute categories (DtoH, checksum, stage, consume) attribute only
    the instants they run with no I/O in flight, in a fixed priority
    order (ties are impossible to break per-instant; the order is the
    tiebreak and it is deterministic);
  * pure waits (``budget_wait``, barriers/KV waits) attribute only the
    instants NOTHING else runs — a budget wait while writes drain IS
    storage-bound (writes are the only budget source);
  * instants covered by no op span are ``unattributed`` (Python glue,
    planning) — the acceptance bar is ≥80% attributed on a real take.

- **Tail-latency outliers**: p99/p50 ratios from the log2 latency
  histograms recorded at the storage-plugin boundary
  (:class:`~tpusnap_torch.telemetry.LogHistogram`) — whole-op spans average
  tails away; the histograms are where a 41x p99 write hides.

- **Straggler ranks**: the rollup's per-phase ``phase_skew``.

- **Roofline**: the in-take probe fraction when recorded
  (``TPUSNAP_PROBE=1``) — how much of the self-measured storage ceiling
  the take actually achieved.

Everything here is pure computation over recorded data (no I/O except
the CLI's loaders in ``__main__``), so the attribution math unit-tests
on synthetic spans with a fake clock.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

# ------------------------------------------------------- classification

# Span names that are CONTAINERS over other ops (windows, blocked-window
# markers, probe segments) or phases — excluded from attribution, which
# must never double-count an instant.
EXCLUDED_SPANS = frozenset(
    {"stage_window", "stage_blocked", "async_blocked", "probe_roofline"}
)

# Resource category per op-span name (prefix match for dotted families).
_CATEGORY_EXACT = {
    "storage_write": "storage_write",
    "storage_read": "storage_read",
    "stage_buffer": "stage",
    "dtoh": "dtoh",
    "host_offload.dtoh": "dtoh",
    "checksum": "checksum",
    "checksum_late": "checksum",
    "cow_verify": "checksum",
    "compress": "compress",
    "consume": "consume",
    "restore.decode": "decode",
    "budget_wait": "budget_wait",
}
_CATEGORY_PREFIX = (
    ("comm.", "barrier"),
    ("kv.", "barrier"),
)

# Work categories, highest attribution priority first: I/O wins every
# overlap (see the module docstring), then the device copy, then the
# host compute lanes.
WORK_PRIORITY = (
    "storage_write",
    "storage_read",
    "dtoh",
    # decode outranks consume: restore.decode spans nest inside their
    # containing consume span, and the nested lane must claim the
    # overlap or decode time vanishes into the generic consume bucket.
    "decode",
    "consume",
    "stage",
    "compress",
    "checksum",
)
# Pure waits: attributed only when no work category is active.
WAIT_PRIORITY = ("budget_wait", "barrier")

CATEGORIES = WORK_PRIORITY + WAIT_PRIORITY

# Verdict → the concrete knob to turn. One sentence of operator-ready
# advice per bound; the CLI appends context (percent, tail ratios).
ADVICE = {
    "storage_write": (
        "the storage backend is the limit — raise TPUSNAP_DIRECT_IO_QD / "
        "TPUSNAP_DIRECT_IO_CHUNK_BYTES for deeper device queues, use "
        "async_take (TPUSNAP_ASYNC_STAGE_WINDOW_BYTES) so training "
        "overlaps the drain, let TPUSNAP_COMPRESS=auto compress bf16/f32 "
        "tiles when the codec outruns this pipe, or target a faster tier "
        "(local fs write-back beats writing through to cloud)"
    ),
    "storage_read": (
        "restore is read-bound — raise TPUSNAP_SCRUB_CONCURRENCY-style "
        "read parallelism via a larger memory budget "
        "(TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES) so more tiled reads "
        "stay in flight"
    ),
    "dtoh": (
        "device-to-host copies dominate — batch smaller arrays "
        "(TPUSNAP_SLAB_SIZE_THRESHOLD_BYTES) and keep "
        "TPUSNAP_DISABLE_DEVICE_BATCHING off so slabs pack on-device"
    ),
    "stage": (
        "staging (clone/serialize) dominates — raise TPUSNAP_STAGE_THREADS "
        "only on hosts whose memory system feeds multiple cores (measure "
        "first), or enable TPUSNAP_ASYNC_COW=1 so frozen host-aliasing "
        "arrays clone nothing"
    ),
    "checksum": (
        "checksum passes dominate — raise TPUSNAP_TILE_CHECKSUM_BYTES "
        "(fewer, larger tiles) or TPUSNAP_DISABLE_CHECKSUM=1 for an A/B; "
        "deferred checksums (the default on non-incremental takes) should "
        "already overlap I/O"
    ),
    "consume": (
        "restore consume (deserialize + HtoD) dominates — check that "
        "in-place reads are active (they skip the copy-out) and batch "
        "small objects"
    ),
    "decode": (
        "the fused tile DECOMPRESSOR dominates the restore — the pipe "
        "outruns the codec on the read side, so write the next snapshot "
        "uncompressed for this tier (TPUSNAP_COMPRESS=off forces it; "
        "auto mode decides from the write-side ceiling, which can be "
        "faster than this read pipe); decode threads derive from the "
        "TPUSNAP_STAGE_THREADS budget if you'd rather keep the codec"
    ),
    "compress": (
        "the fused tile codec dominates — the pipe outruns the codec "
        "here, so flip the policy to bypass (TPUSNAP_COMPRESS=auto does "
        "this from the probe ceiling; TPUSNAP_COMPRESS=off forces it); "
        "the codec shares the TPUSNAP_STAGE_THREADS×native copy-thread "
        "budget, so there is no separate codec-thread knob to raise"
    ),
    "budget_wait": (
        "staging starves on the memory budget with no I/O to blame — "
        "raise TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES (or lower "
        "TPUSNAP_MAX_CHUNK_SIZE_BYTES so admission granularity shrinks)"
    ),
    "barrier": (
        "blocked on peers (barriers/KV waits) — this rank is NOT the "
        "straggler; find the slowest rank in the stragglers section and "
        "analyze that rank"
    ),
}


def classify_span(name: str) -> Optional[str]:
    """Resource category of an op-span name, or None for spans that do
    not participate in attribution (container spans, unknown names)."""
    if name in EXCLUDED_SPANS:
        return None
    cat = _CATEGORY_EXACT.get(name)
    if cat is not None:
        return cat
    for prefix, c in _CATEGORY_PREFIX:
        if name.startswith(prefix):
            return c
    return None


# ---------------------------------------------------------- attribution


@dataclass
class Attribution:
    """Outcome of one rank's critical-path sweep. ``attributed`` is
    exclusive (sums + unattributed_s == wall_s); ``busy`` is each
    category's raw interval-union time (overlaps allowed), the
    "pressure" view the exclusive walk would otherwise hide."""

    wall_s: float
    attributed: Dict[str, float] = field(default_factory=dict)
    busy: Dict[str, float] = field(default_factory=dict)
    unattributed_s: float = 0.0

    @property
    def coverage(self) -> float:
        if self.wall_s <= 0:
            return 0.0
        return min(sum(self.attributed.values()) / self.wall_s, 1.0)

    def verdict(self) -> Optional[Tuple[str, float]]:
        """(category, fraction-of-wall) of the dominant resource."""
        if not self.attributed or self.wall_s <= 0:
            return None
        cat = max(self.attributed, key=self.attributed.get)
        return cat, self.attributed[cat] / self.wall_s

    def to_json(self) -> Dict[str, Any]:
        return {
            "wall_s": round(self.wall_s, 6),
            "attributed_s": {
                k: round(v, 6) for k, v in sorted(self.attributed.items())
            },
            "attributed_pct": {
                k: round(100.0 * v / self.wall_s, 2)
                for k, v in sorted(self.attributed.items())
                if self.wall_s > 0
            },
            "busy_s": {k: round(v, 6) for k, v in sorted(self.busy.items())},
            "unattributed_s": round(self.unattributed_s, 6),
            "coverage": round(self.coverage, 4),
        }


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals (sorted in
    place): the time during which at least one was open. Shared with
    the telemetry summary's ``busy_s``."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_start, cur_end = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_end:
            total += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    return total + (cur_end - cur_start)


def attribute_spans(
    spans: Sequence[Tuple[str, float, float]], wall_s: float
) -> Attribution:
    """Deterministic critical-path sweep over op spans of ONE rank.

    ``spans`` are ``(name, start_s, dur_s)`` tuples on the recorder's
    monotonic timeline (phase spans and container spans are ignored via
    :func:`classify_span`). The timeline [0, wall_s] is cut at every
    span boundary; each elementary slice is attributed to the
    highest-priority ACTIVE category (work before waits — see the
    module docstring), or to ``unattributed`` when nothing is in
    flight. Slices beyond ``wall_s`` are clipped; zero/negative
    durations are dropped."""
    by_cat: Dict[str, List[Tuple[float, float]]] = {}
    for name, start, dur in spans:
        cat = classify_span(name)
        if cat is None or dur <= 0:
            continue
        s = max(0.0, float(start))
        e = min(float(start) + float(dur), wall_s) if wall_s > 0 else (
            float(start) + float(dur)
        )
        if e <= s:
            continue
        by_cat.setdefault(cat, []).append((s, e))

    att = Attribution(wall_s=max(wall_s, 0.0))
    for cat, ivs in by_cat.items():
        att.busy[cat] = union_seconds(list(ivs))

    # Sweep: +1/-1 events per category, slice between consecutive cuts.
    events: List[Tuple[float, int, str]] = []
    for cat, ivs in by_cat.items():
        for s, e in ivs:
            events.append((s, 1, cat))
            events.append((e, -1, cat))
    if not events:
        att.unattributed_s = att.wall_s
        return att
    events.sort(key=lambda t: (t[0], t[1]))
    active: Dict[str, int] = {}
    prev_t = 0.0
    attributed: Dict[str, float] = {}
    unattributed = 0.0

    def _account(span_len: float) -> None:
        nonlocal unattributed
        if span_len <= 0:
            return
        for cat in WORK_PRIORITY:
            if active.get(cat, 0) > 0:
                attributed[cat] = attributed.get(cat, 0.0) + span_len
                return
        for cat in WAIT_PRIORITY:
            if active.get(cat, 0) > 0:
                attributed[cat] = attributed.get(cat, 0.0) + span_len
                return
        unattributed += span_len

    for t, delta, cat in events:
        _account(t - prev_t)
        prev_t = t
        active[cat] = active.get(cat, 0) + delta
    if att.wall_s > prev_t:
        unattributed += att.wall_s - prev_t
    att.attributed = attributed
    att.unattributed_s = max(
        att.wall_s - sum(attributed.values()), 0.0
    ) if att.wall_s > 0 else unattributed
    return att


def spans_of_trace_doc(doc: Dict[str, Any]) -> List[Tuple[str, float, float]]:
    """(name, start_s, dur_s) op spans from one persisted rank trace
    (``rank_<k>.json``): Chrome trace events with ``ph == "X"`` and
    category ``op`` (phases tile the same timeline and would
    double-count)."""
    out = []
    for ev in doc.get("traceEvents") or []:
        if ev.get("ph") != "X" or ev.get("cat") == "phase":
            continue
        out.append(
            (
                ev.get("name", ""),
                float(ev.get("ts", 0.0)) / 1e6,
                float(ev.get("dur", 0.0)) / 1e6,
            )
        )
    return out


# -------------------------------------------------------------- findings


@dataclass
class Finding:
    """One actionable observation. ``severity`` is ``warn`` (fails
    ``--check``) or ``info`` (reported, never gates)."""

    severity: str
    kind: str
    message: str

    def to_json(self) -> Dict[str, str]:
        return {
            "severity": self.severity,
            "kind": self.kind,
            "message": self.message,
        }


@dataclass
class Thresholds:
    """``--check`` gates, all overridable at the CLI."""

    p99_ratio: float = 20.0  # write/read p99 over p50 beyond this → warn
    min_roofline: float = 0.4  # roofline_fraction below this → warn
    min_read_roofline: float = 0.4  # restore_roofline_fraction gate
    max_skew: float = 2.0  # per-phase straggler skew beyond this → warn
    min_coverage: float = 0.5  # attribution coverage below this → info
    # Access-ledger coverage (bytes ever read ÷ stored) below this →
    # the fleet reads a sliver of the snapshot; advise the lazy path.
    min_access_coverage: float = 0.3


def tail_latency_findings(
    io_histograms: Dict[str, Dict[str, Any]],
    thresholds: Thresholds,
    min_count: int = 8,
    min_p99_s: float = 0.005,
) -> List[Finding]:
    """p99/p50 outliers from the storage-boundary latency histograms.
    Only the payload ops (write/read) gate: delete/list run at
    microsecond scale where a single ordinary fs hiccup is a routine
    20x ratio, not a finding. Keys under ``min_count`` samples are
    skipped (a 3-sample p99 is noise, not a tail), as are tails whose
    absolute p99 is below ``min_p99_s`` (a fast op with a fast tail is
    healthy whatever the ratio says)."""
    out = []
    for key, st in sorted((io_histograms or {}).items()):
        if not key.startswith(("write.", "read.")):
            continue
        count = st.get("count") or 0
        p50, p99 = st.get("p50_s"), st.get("p99_s")
        if count < min_count or not p50 or not p99 or p50 <= 0:
            continue
        if p99 < min_p99_s:
            continue
        ratio = p99 / p50
        if ratio > thresholds.p99_ratio:
            op = key.split(".", 1)[0]
            out.append(
                Finding(
                    "warn",
                    "tail_latency",
                    f"{key}: p99 latency {p99 * 1e3:.1f}ms is "
                    f"{ratio:.0f}x the p50 ({p50 * 1e3:.1f}ms) over "
                    f"{count} ops — a fat {op} tail; check for "
                    "device/host contention, throttling, or a failing "
                    "disk (history --check gates storage_write_p99_s)",
                )
            )
    return out


def straggler_findings(
    rollup: Dict[str, Any], thresholds: Thresholds
) -> List[Finding]:
    out = []
    if (rollup or {}).get("ranks", 1) <= 1:
        return out
    for name, agg in sorted((rollup.get("phase_skew") or {}).items()):
        skew = agg.get("skew")
        if skew and skew > thresholds.max_skew and agg.get("max_s", 0) > 0.05:
            out.append(
                Finding(
                    "warn",
                    "straggler",
                    f"phase {name!r}: rank {agg.get('max_rank')} took "
                    f"{agg.get('max_s'):.2f}s, {skew:.2f}x the p50 — "
                    "a straggler rank; analyze that rank's trace "
                    "(trace --rank) and its host",
                )
            )
    return out


def roofline_findings(
    summary_like: Dict[str, Any], thresholds: Thresholds
) -> List[Finding]:
    out: List[Finding] = []
    frac = (summary_like or {}).get("roofline_fraction")
    if isinstance(frac, (int, float)) and frac < thresholds.min_roofline:
        ceiling = ((summary_like.get("probe") or {}).get("write_gbps_p50"))
        out.append(
            Finding(
                "warn",
                "roofline",
                f"take achieved only {frac:.0%} of the in-take probe "
                "ceiling"
                + (f" ({ceiling:.2f} GB/s)" if ceiling else "")
                + " — the pipeline, not the disk, is leaving throughput "
                "on the table; see the bound verdict",
            )
        )
    rfrac = (summary_like or {}).get("restore_roofline_fraction")
    if (
        isinstance(rfrac, (int, float))
        and rfrac < thresholds.min_read_roofline
    ):
        ceiling = ((summary_like.get("probe") or {}).get("read_gbps_p50"))
        out.append(
            Finding(
                "warn",
                "read_roofline",
                f"restore achieved only {rfrac:.0%} of the in-restore "
                "probe READ ceiling"
                + (f" ({ceiling:.2f} GB/s)" if ceiling else "")
                + " — the restore pipeline, not the disk, is leaving "
                "read throughput on the table; see the bound verdict "
                "(decode-bound restores overlap away under a pipelined "
                "engine)",
            )
        )
    return out


def access_findings(
    heatmap: Dict[str, Any], thresholds: Thresholds
) -> List[Finding]:
    """Serving advice from the merged access heatmap (see
    :func:`tpusnap_torch.access.compute_heatmap`). ``info`` severity: partial
    access is an optimization opportunity, not a failure — the gateable
    side lives in ``heatmap --check`` / ``fleet --check``."""
    out: List[Finding] = []
    cov = (heatmap or {}).get("coverage")
    if not (heatmap or {}).get("bytes_read"):
        return out
    if (
        isinstance(cov, (int, float))
        and cov < thresholds.min_access_coverage
    ):
        hot = ", ".join(
            f"{h['path']}[{h['range'][0]}:{h['range'][1]})"
            for h in (heatmap.get("hot_ranges") or [])[:5]
        )
        out.append(
            Finding(
                "info",
                "partial_access",
                f"{heatmap.get('n_readers', 0)} reader(s) ever touched "
                f"only {cov:.0%} of this snapshot's stored bytes — "
                "serve it through read_object / the lazy path instead "
                "of full restores, and keep just the hot tiles on the "
                "fast tier"
                + (f"; hottest: {hot}" if hot else ""),
            )
        )
    return out


# ---------------------------------------------------------- the report


def analyze(
    rollup: Optional[Dict[str, Any]],
    rank_docs: Dict[int, Dict[str, Any]],
    kind: str = "take",
    thresholds: Optional[Thresholds] = None,
    history_events: Optional[List[Dict[str, Any]]] = None,
    heatmap: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The doctor report: bound verdict + attribution for the SLOWEST
    traced rank (the take ends when it does), per-rank attributions,
    tail/straggler/roofline findings, and optional history trend
    context. Pure; the CLI loads and renders."""
    thresholds = thresholds or Thresholds()
    rollup = rollup or {}
    attributions: Dict[int, Attribution] = {}
    for rank, doc in rank_docs.items():
        summary = doc.get("summary") or {}
        wall = float(summary.get("take_wall_s") or 0.0)
        spans = spans_of_trace_doc(doc)
        if wall > 0 and spans:
            attributions[rank] = attribute_spans(spans, wall)

    report: Dict[str, Any] = {"kind": kind, "findings": []}
    findings: List[Finding] = []

    slowest_rank: Optional[int] = None
    if attributions:
        slowest_rank = max(
            attributions, key=lambda r: attributions[r].wall_s
        )
        att = attributions[slowest_rank]
        report["rank"] = slowest_rank
        report["attribution"] = att.to_json()
        report["attribution_by_rank"] = {
            str(r): a.to_json() for r, a in sorted(attributions.items())
        }
        v = att.verdict()
        if v is not None:
            cat, frac = v
            report["bound_by"] = cat
            report["bound_pct"] = round(100.0 * frac, 1)
            report["advice"] = ADVICE.get(cat, "")
        if att.coverage < thresholds.min_coverage:
            findings.append(
                Finding(
                    "info",
                    "coverage",
                    f"only {att.coverage:.0%} of rank {slowest_rank}'s "
                    "wall-clock is covered by op spans — the verdict "
                    "reflects the instrumented part; the rest is Python "
                    "glue/planning",
                )
            )

    # Histograms: prefer the cross-rank rollup merge; fall back to the
    # slowest rank's own.
    io_hist = rollup.get("io_histograms")
    if not io_hist and slowest_rank is not None:
        io_hist = (
            rank_docs[slowest_rank].get("summary") or {}
        ).get("io_histograms")
    if io_hist:
        report["io_histograms"] = io_hist
        findings.extend(tail_latency_findings(io_hist, thresholds))

    findings.extend(straggler_findings(rollup, thresholds))

    # Roofline: rollup first (multi-rank p50), else the slowest rank.
    # Takes carry roofline_fraction (write lane); restores carry
    # restore_roofline_fraction (read lane) — same source selection.
    roofline_src: Dict[str, Any] = {}
    _FRACS = ("roofline_fraction", "restore_roofline_fraction")
    if any(isinstance(rollup.get(f), (int, float)) for f in _FRACS):
        roofline_src = rollup
    elif slowest_rank is not None:
        s = rank_docs[slowest_rank].get("summary") or {}
        if any(isinstance(s.get(f), (int, float)) for f in _FRACS):
            roofline_src = s
    if roofline_src:
        for f in _FRACS:
            if isinstance(roofline_src.get(f), (int, float)):
                report[f] = roofline_src[f]
        if roofline_src.get("probe"):
            report["probe"] = roofline_src["probe"]
        findings.extend(roofline_findings(roofline_src, thresholds))

    if heatmap:
        report["access"] = {
            k: heatmap.get(k)
            for k in (
                "snapshot_bytes",
                "bytes_read",
                "coverage",
                "amplification",
                "n_readers",
            )
        }
        findings.extend(access_findings(heatmap, thresholds))

    if history_events:
        report["history"] = history_context(history_events, kind)

    report["findings"] = [f.to_json() for f in findings]
    report["check_failed"] = any(f.severity == "warn" for f in findings)
    return report


def history_context(
    events: List[Dict[str, Any]], kind: str, window: int = 20
) -> Dict[str, Any]:
    """Trend context for the report: latest vs trailing-median
    throughput (and p99 write latency when recorded) over the last
    ``window`` events of ``kind``."""
    cand = [e for e in events if e.get("kind") == kind][-window:]
    out: Dict[str, Any] = {"events": len(cand)}
    if not cand:
        return out
    for metric in (
        "throughput_gbps",
        "storage_write_p99_s",
        "roofline_fraction",
        "storage_read_p99_s",
        "restore_roofline_fraction",
    ):
        vals = sorted(
            float(e[metric])
            for e in cand
            if isinstance(e.get(metric), (int, float))
        )
        if vals:
            latest = next(
                (
                    float(e[metric])
                    for e in reversed(cand)
                    if isinstance(e.get(metric), (int, float))
                ),
                None,
            )
            out[metric] = {
                "latest": latest,
                "median": round(vals[len(vals) // 2], 6),
                "n": len(vals),
            }
    return out
