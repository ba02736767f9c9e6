"""`tpusnap_torch tune` — a deterministic knob planner driven by
`analyze`'s own evidence (counterpart of tpusnap/tune.py, vendored: the
same inputs give the same plan and the same ``plan_id``).

The observability column ends in a loop-closer: history.jsonl events
(what past takes/restores of this cell achieved), the probe ceiling
registry (what the pipe can do, write and read lane), and the bound
verdict (what the slowest rank actually spent its wall-clock on) go in;
a knob plan comes out — one proposed env value per knob, each with a
one-line rationale naming the evidence. The planner is a PURE function
of its inputs: same events, same ceilings, same verdict → same plan,
same ``plan_id``. No wall-clock, no randomness, no I/O.

A plan cell is ``(backend, kind, world_size)``: knobs tuned from local
NVMe history must never apply to a cloud-tier restore, and a 2-process
cell's budget medians must never price a 16-process job.

Application (``TPUSNAP_AUTOTUNE=1``) goes through
:func:`knobs.apply_tuned_plan` — a fallback layer BELOW the
environment, so an explicitly-set env var always beats the tuner, per
lookup. The knobs a run actually applied are stamped into its history
event as ``tuned: {plan_id, knobs}``; `history --check` then gates any
regression the tuner causes, attributably.
"""

from __future__ import annotations

import hashlib
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# Comparable-evidence floor: below this many events for the cell the
# planner refuses (exit 3 at the CLI) rather than tune from noise —
# the same bar the SLO RTO estimator uses for its history baseline.
MIN_EVENTS = 3

# Events older than this many entries (per cell) are ignored: the plan
# should track the CURRENT machine, not a disk that was replaced.
DEFAULT_WINDOW = 50

_MIN_ASYNC_WINDOW_BYTES = 256 * 1024 * 1024
_MAX_STAGE_THREADS = 8
_PROBE_INTERVAL_FLOOR = 16 * 1024 * 1024
_PROBE_INTERVAL_CAP = 2 * 1024 * 1024 * 1024
_MIN_RESTORE_BUDGET_BYTES = 16 * 1024 * 1024


@dataclass
class KnobChange:
    """One proposed knob: the env var, the value the plan would set,
    the current effective value, and the evidence one-liner."""

    env: str
    value: str
    current: Optional[str]
    rationale: str

    def to_json(self) -> Dict[str, Any]:
        return {
            "env": self.env,
            "value": self.value,
            "current": self.current,
            "rationale": self.rationale,
        }


@dataclass
class TunePlan:
    ok: bool
    reason: str
    kind: Optional[str] = None
    backend: Optional[str] = None
    world_size: Optional[int] = None
    n_events: int = 0
    verdict: Optional[str] = None
    knobs: List[KnobChange] = field(default_factory=list)
    plan_id: Optional[str] = None

    def to_json(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "reason": self.reason,
            "cell": {
                "backend": self.backend,
                "kind": self.kind,
                "world_size": self.world_size,
            },
            "n_events": self.n_events,
            "verdict": self.verdict,
            "plan_id": self.plan_id,
            "knobs": [k.to_json() for k in self.knobs],
        }

    def env_exports(self) -> List[str]:
        """Shell-exportable lines (`tune --env`)."""
        return [f"export {k.env}={k.value}" for k in self.knobs]


def _median(vals: List[float]) -> Optional[float]:
    vals = sorted(vals)
    return vals[len(vals) // 2] if vals else None


def _metric_median(
    events: List[Dict[str, Any]], key: str
) -> Optional[float]:
    return _median(
        [float(e[key]) for e in events if isinstance(e.get(key), (int, float))]
    )


def _plan_id(
    kind: Optional[str],
    backend: Optional[str],
    world_size: Optional[int],
    knobs: List[KnobChange],
) -> str:
    """Deterministic content id: same cell + same knob values → same
    id, so `history --check` can group runs by the plan they ran."""
    doc = {
        "cell": [backend, kind, world_size],
        "knobs": {k.env: k.value for k in knobs},
    }
    return hashlib.sha1(
        json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()[:12]


def ceiling_for(
    ceilings: Optional[Dict[Tuple[str, str], float]],
    backend: Optional[str],
    lane: str,
    events: List[Dict[str, Any]],
) -> Optional[float]:
    """Pipe ceiling for one (backend, lane): the live in-process probe
    registry when this process has run probes (registry keys are
    ``label@device``; the event's backend is the bare label, so prefix
    match), else the median probe ceiling past events recorded —
    a fresh CLI process has an empty registry but the history remembers
    what the probes measured."""
    if ceilings:
        cands = [
            v
            for (label, ln), v in sorted(ceilings.items())
            if ln == lane
            and (
                backend is None
                or label == backend
                or label.startswith(f"{backend}@")
            )
        ]
        med = _median(cands)
        if med:
            return med
    fallback = "probe_write_gbps" if lane == "write" else "probe_read_gbps"
    return _metric_median(events, fallback)


def select_events(
    events: List[Dict[str, Any]],
    kind: str,
    backend: Optional[str] = None,
    world_size: Optional[int] = None,
    window: int = DEFAULT_WINDOW,
) -> List[Dict[str, Any]]:
    """The cell's comparable evidence: newest ``window`` events of
    ``kind``, filtered to the backend and world size when given."""
    out = [
        e
        for e in events
        if e.get("kind") == kind
        and (backend is None or e.get("plugin") == backend)
        and (world_size is None or e.get("world_size") == world_size)
    ]
    return out[-window:]


def build_plan(
    events: List[Dict[str, Any]],
    kind: str,
    backend: Optional[str] = None,
    world_size: Optional[int] = None,
    ceilings: Optional[Dict[Tuple[str, str], float]] = None,
    verdict: Optional[str] = None,
    codec_gbps: Optional[float] = None,
    min_events: int = MIN_EVENTS,
    window: int = DEFAULT_WINDOW,
) -> TunePlan:
    """The planner. ``events`` is the full history (oldest first);
    ``ceilings`` a :func:`compress.pipe_ceilings_snapshot`; ``verdict``
    the analyze bound category when the caller computed one;
    ``codec_gbps`` the measured codec throughput (None → read it from
    :func:`compress.codec_throughput_gbps`). Current knob values come
    from :mod:`tpusnap_torch.knobs` (env + any applied plan)."""
    from . import knobs

    cell = select_events(
        events, kind, backend=backend, world_size=world_size, window=window
    )
    if backend is None and cell:
        # Pin the cell to the newest event's backend so the medians
        # below never mix tiers.
        backend = cell[-1].get("plugin")
        if backend is not None:
            cell = [e for e in cell if e.get("plugin") == backend]
    if world_size is None and cell:
        world_size = cell[-1].get("world_size")
        if world_size is not None:
            cell = [e for e in cell if e.get("world_size") == world_size]

    plan = TunePlan(
        ok=False,
        reason="",
        kind=kind,
        backend=backend,
        world_size=world_size,
        n_events=len(cell),
        verdict=verdict,
    )
    if len(cell) < max(1, min_events):
        plan.reason = (
            f"only {len(cell)} comparable {kind} event(s) for backend="
            f"{backend or 'any'} world_size={world_size or 'any'} — "
            f"need {max(1, min_events)}; run more {kind}s (with "
            "TPUSNAP_PROBE=1 for ceilings) and retry"
        )
        return plan

    if codec_gbps is None:
        from .compress import codec_throughput_gbps

        try:
            codec_gbps = codec_throughput_gbps()
        except Exception:
            codec_gbps = 0.0

    med_bytes = _metric_median(cell, "bytes")
    med_wall = _metric_median(cell, "wall_s")
    knob_list: List[KnobChange] = []

    # --- staging executor width (takes; verdict-driven) ---------------
    if kind == "take" and verdict == "stage":
        cur = knobs.get_stage_threads()
        target = min(_MAX_STAGE_THREADS, cur * 2)
        if target > cur:
            knob_list.append(
                KnobChange(
                    env="TPUSNAP_STAGE_THREADS",
                    value=str(target),
                    current=str(cur),
                    rationale=(
                        "bound verdict is 'stage' — widen the staging "
                        f"executor {cur}→{target} (the native "
                        "copy-thread budget stays constant, so this "
                        "shifts grain, not oversubscription)"
                    ),
                )
            )

    # --- async blocked window (takes; history-driven) ------------------
    if kind == "take" and med_wall:
        med_blocked = _metric_median(cell, "async_blocked_s")
        cur_win = knobs.get_async_stage_window_bytes()
        if (
            med_blocked is not None
            and med_blocked > 0.25 * med_wall
            and cur_win
            and cur_win // 2 >= _MIN_ASYNC_WINDOW_BYTES
        ):
            target = cur_win // 2
            knob_list.append(
                KnobChange(
                    env="TPUSNAP_ASYNC_STAGE_WINDOW_BYTES",
                    value=str(target),
                    current=str(cur_win),
                    rationale=(
                        f"median blocked window {med_blocked:.2f}s is >25% "
                        f"of the {med_wall:.2f}s median take — halve the "
                        "staging window so control returns to training "
                        "sooner (the drain overlaps the rest)"
                    ),
                )
            )

    # --- restore memory budget (restores; verdict-driven) --------------
    if kind == "restore" and verdict == "storage_read":
        med_hw = _metric_median(cell, "budget_high_water_bytes")
        cur_override = knobs.get_memory_budget_override_bytes()
        if med_hw:
            target = int(med_hw * 2)
            if cur_override is None or cur_override < target:
                knob_list.append(
                    KnobChange(
                        env="TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES",
                        value=str(target),
                        current=(
                            str(cur_override)
                            if cur_override is not None
                            else None
                        ),
                        rationale=(
                            "bound verdict is 'storage_read' — double the "
                            "median budget high-water "
                            f"({int(med_hw)}→{target} bytes) so more "
                            "tiled reads stay in flight"
                        ),
                    )
                )

    # --- restore budget from the access working set (history-driven) ----
    # The ledger's distinct-byte union rides history as
    # access_working_set_bytes. Lazy/partial readers touch a working
    # set far below the restore payload — a budget sized for the whole
    # payload reserves memory the reads can never fill. 2x the median
    # working set keeps double-buffering headroom. Skipped on a
    # 'storage_read' verdict: a read-bound restore wants MORE in
    # flight, and the rule above already raises the budget.
    if kind == "restore" and verdict != "storage_read":
        med_ws = _metric_median(cell, "access_working_set_bytes")
        med_read = _metric_median(cell, "access_bytes_read")
        cur_override = knobs.get_memory_budget_override_bytes()
        if (
            med_ws
            and med_bytes
            and med_ws < 0.5 * med_bytes
            and (med_read or 0) <= 2 * med_ws
        ):
            target = max(int(med_ws * 2), _MIN_RESTORE_BUDGET_BYTES)
            if cur_override is None or cur_override > 2 * target:
                knob_list.append(
                    KnobChange(
                        env="TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES",
                        value=str(target),
                        current=(
                            str(cur_override)
                            if cur_override is not None
                            else None
                        ),
                        rationale=(
                            "median access working set is "
                            f"{int(med_ws)} bytes against a "
                            f"{int(med_bytes)}-byte median payload — "
                            "partial readers; size the restore budget "
                            "to 2x the hot working set instead of the "
                            "full payload"
                        ),
                    )
                )

    # --- compression policy (ceiling vs codec) --------------------------
    lane = "read" if kind == "restore" else "write"
    pipe = ceiling_for(ceilings, backend, lane, cell)
    cur_mode = knobs.get_compress_mode()
    if verdict == "decode" and cur_mode != "off":
        knob_list.append(
            KnobChange(
                env="TPUSNAP_COMPRESS",
                value="off",
                current=cur_mode,
                rationale=(
                    "bound verdict is 'decode' — the read pipe outruns "
                    "the decompressor; write the next snapshot "
                    "uncompressed for this tier"
                ),
            )
        )
    elif pipe and codec_gbps:
        if pipe >= 2.0 * codec_gbps and cur_mode not in ("off",):
            knob_list.append(
                KnobChange(
                    env="TPUSNAP_COMPRESS",
                    value="off",
                    current=cur_mode,
                    rationale=(
                        f"probe {lane} ceiling {pipe:.2f} GB/s is ≥2x the "
                        f"codec's {codec_gbps:.2f} GB/s — the pipe wins; "
                        "pin bypass so no take pays the codec"
                    ),
                )
            )
        elif codec_gbps >= 2.0 * pipe and cur_mode not in ("on", "lz4"):
            knob_list.append(
                KnobChange(
                    env="TPUSNAP_COMPRESS",
                    value="on",
                    current=cur_mode,
                    rationale=(
                        f"codec {codec_gbps:.2f} GB/s is ≥2x the probe "
                        f"{lane} ceiling {pipe:.2f} GB/s — the codec "
                        "wins; pin compression on for this tier"
                    ),
                )
            )

    # --- probe cadence (both kinds; payload-driven) ---------------------
    if med_bytes:
        target = int(
            min(
                _PROBE_INTERVAL_CAP,
                max(_PROBE_INTERVAL_FLOOR, med_bytes // 8),
            )
        )
        cur_int = knobs.get_probe_interval_bytes()
        # Only repoint the cadence when it is off by ≥2x — a probe
        # count of 6 vs 8 is not worth a knob churn.
        if max(target, cur_int) >= 2 * min(target, cur_int):
            knob_list.append(
                KnobChange(
                    env="TPUSNAP_PROBE_INTERVAL_BYTES",
                    value=str(target),
                    current=str(cur_int),
                    rationale=(
                        f"median {kind} payload is {int(med_bytes)} bytes "
                        f"— one probe per ~1/8th of it ({target} bytes) "
                        "yields ~8 in-run ceiling samples instead of "
                        f"{max(1, int(med_bytes // cur_int))}"
                    ),
                )
            )

    plan.ok = True
    plan.knobs = knob_list
    plan.plan_id = _plan_id(kind, backend, world_size, knob_list)
    plan.reason = (
        f"{len(knob_list)} knob(s) proposed from {len(cell)} {kind} "
        "event(s)"
        if knob_list
        else f"all knobs already match the evidence from {len(cell)} "
        f"{kind} event(s) — nothing to change"
    )
    return plan


def maybe_apply(
    kind: str, storage: Any = None, world_size: Optional[int] = None
) -> Optional[Dict[str, Any]]:
    """Take/restore-begin reconcile (TPUSNAP_AUTOTUNE=1): build this
    cell's plan from the local history and install it through the
    tuned-plan overlay. Returns ``{plan_id, knobs}`` for the knobs
    ACTUALLY applied (explicit env vars win and are skipped), or None
    when autotune is off, history is insufficient, or the plan is
    empty. Never raises — a broken tuner must not fail a restore."""
    from . import knobs

    if not knobs.is_autotune_enabled():
        return None
    try:
        from . import compress
        from .history import load_history
        from .storage_plugin import storage_plugin_label

        backend = None
        if storage is not None:
            try:
                backend = storage_plugin_label(storage)
            except Exception:
                backend = None
        plan = build_plan(
            load_history(),
            kind,
            backend=backend,
            world_size=world_size,
            ceilings=compress.pipe_ceilings_snapshot(),
        )
        if not plan.ok or not plan.knobs:
            knobs.clear_tuned_plan()
            return None
        applied = knobs.apply_tuned_plan(
            plan.plan_id, {k.env: k.value for k in plan.knobs}
        )
        if not applied:
            return None
        logger.info(
            "autotune: applied plan %s to this %s (%s)",
            plan.plan_id,
            kind,
            ", ".join(f"{k}={v}" for k, v in sorted(applied.items())),
        )
        return {"plan_id": plan.plan_id, "knobs": applied}
    except Exception:
        logger.warning(
            "autotune: reconcile failed (non-fatal; running untuned)",
            exc_info=True,
        )
        knobs.clear_tuned_plan()
        return None
