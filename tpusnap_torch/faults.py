"""Deterministic storage fault injection: seeded ``FaultPlan`` + a
``StoragePlugin`` wrapper, exposed as ``chaos+<scheme>://`` URLs.

Counterpart of tpusnap/faults.py with the same spec grammar, so one
``TPUSNAP_FAULT_SPEC`` gives both packages the same schedule; the
``rank=`` filter reads the ``torch.distributed`` rank (or ``RANK``).

The chaos layer sits UNDER the retry middleware
(``Retrying(FaultInjection(real plugin))``), so injected faults exercise
exactly the production retry/abort paths:

- transient exceptions (``InjectedFaultError`` subclasses
  ``ConnectionError`` → classified transient by every plugin);
- injected per-op latency (seeded jitter);
- torn writes: a failing ``write`` persists a seeded prefix of the
  buffer through the real plugin before raising — the exact failure
  whole-op retry and metadata-written-last commit exist to survive;
- short reads: a failing ``read`` delivers a truncated buffer before
  raising — discarded by the retry wrapper's fresh-ReadIO-per-attempt;
- crash-after-op: SIGKILL the process after the Nth successful op of a
  kind (crash-matrix windows inside storage I/O, no monkeypatching).

Usage — no code changes needed, just the URL (and optionally a spec)::

    Snapshot.take("chaos+fs:///tmp/snap", app_state,
                  storage_options={"fault_plan": FaultPlan(seed=3,
                                                           transient_per_op=1)})
    # or via the environment, e.g. in an example/benchmark run:
    #   TPUSNAP_FAULT_SPEC="seed=3,transient_per_op=1,latency_ms=2"

Determinism: all randomness derives from ``FaultPlan.seed``; op indices
are assigned in arrival order. Under concurrent scheduling the mapping
of logical blobs to op indices can vary run to run, but the injected
fault COUNT and shape per seed are fixed — which is what the chaos soak
asserts convergence and integrity against.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from . import flight, telemetry
from .io_types import ReadIO, StoragePlugin, WriteIO

logger = logging.getLogger(__name__)


class InjectedFaultError(ConnectionError):
    """A deliberately injected transient storage failure. Subclasses
    ``ConnectionError`` so every transient classifier retries it."""


@dataclass
class FaultPlan:
    """Seeded, deterministic description of how a backend misbehaves.

    - ``transient_per_op``: the first K attempts of every distinct
      (kind, path) op raise transient errors — "≥1 transient error per
      storage op" with guaranteed convergence under retry.
    - ``transient_every``: additionally, every Nth op overall raises
      (0 = off). Only FIRST attempts of an op can draw this fault
      (retries are exempt, though they advance the counter), so any N —
      including 1 — converges under retry.
    - ``torn_writes``: failing writes persist a seeded prefix through
      the real plugin before raising (object-store ``write_atomic``
      failures stay clean: tearing there would fabricate a failure the
      real backend cannot produce).
    - ``short_reads``: failing reads deliver a seeded truncation of the
      real bytes before raising.
    - ``latency_sec``: seeded-jittered sleep on every op.
    - ``crash_after_op``: ("write", 7) → SIGKILL this process right
      after the 7th successful write (1-based).
    - ``stall_op``: ("write", 3, 5.0) → the 3rd write ATTEMPT sleeps
      5 s inside the op before proceeding normally (index 0 stalls
      every attempt of the kind). The op stays in flight for the whole
      sleep — the deterministic hang the stall watchdog
      (:mod:`tpusnap.progress`) is tested against.
    - ``outage``: ("write", 0.0, 10.0) → a SUSTAINED unavailability
      window: every matching op (kind, or ``*`` for all) raises a
      transient error from ``start`` seconds after this plugin's first
      op until ``start + duration``. Deterministic in TIME rather than
      per-op probability — "cloud down for 10 s mid-drain" as one spec
      token (``outage=write:10``, ``outage=*:5:10``), the failure shape
      the write-back tier's circuit breaker exists for.
    - ``bandwidth_gbps``: a WRITE-PATH pipe ceiling — a shared token
      bucket serializes write/write_atomic payload bytes at this GB/s
      across all concurrent ops, so the plugin behaves like a slow
      network pipe rather than per-op latency (which would tax
      compressed and raw bytes identically). The deterministic
      bandwidth-bound regime the compression auto policy exists for.
    - ``rank``: RANK FILTER — the whole plan applies only on the
      process whose distributed rank (the torch.distributed rank, or ``RANK``, 0
      when uninitialized) matches; every other rank's plugin behaves
      fault-free. One shared ``TPUSNAP_FAULT_SPEC`` can thus
      deterministically kill or wedge exactly one rank of a
      multi-process world (``rank=1,crash_after_op=write:2``), as the
      rank-failure tests and the smoke's degrade phase do.
    - ``wedge``: ("write", 3) → the 3rd write ATTEMPT SIGSTOPs the
      whole process (index 0/``*`` = first attempt of the kind). Unlike
      ``stall_op`` — which hangs one op while heartbeat/lease threads
      keep running (a SLOW rank) — SIGSTOP freezes every thread, so
      from the peers' view the rank is DEAD (leases expire, liveness
      raises RankFailedError) while the parent test can still SIGCONT
      or SIGKILL the frozen process. The deterministic "host froze"
      fault the lease layer exists for.
    - ``preempt``: ("write", 3, 30.0) → the 3rd write ATTEMPT delivers
      SIGTERM to this process (index 0/``*`` = first attempt of the
      kind), then SIGKILLs it ``grace_s`` seconds later if it is still
      alive — the graceful-leave twin of ``wedge``: a cloud preemption
      NOTICE with a hard deadline. A process whose SIGTERM handler
      drains its work and leaves (e.g. ``DeltaStream.leave()``) within
      the grace exits cleanly; one that ignores the notice dies like a
      ``wedge``-then-kill. Fires at most once per plugin instance.
    """

    seed: int = 0
    transient_per_op: int = 0
    transient_every: int = 0
    torn_writes: bool = False
    short_reads: bool = False
    latency_sec: float = 0.0
    crash_after_op: Optional[Tuple[str, int]] = None
    stall_op: Optional[Tuple[str, int, float]] = None
    outage: Optional[Tuple[str, float, float]] = None
    bandwidth_gbps: float = 0.0
    rank: Optional[int] = None
    wedge: Optional[Tuple[str, int]] = None
    preempt: Optional[Tuple[str, int, float]] = None

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse ``"seed=3,transient_per_op=1,latency_ms=2,torn_writes=1"``.
        Keys mirror the field names; ``latency_ms`` is accepted as a
        convenience; ``crash_after_op=write:7``."""
        plan = cls()
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            key, _, value = item.partition("=")
            key = key.strip()
            value = value.strip()
            if key == "latency_ms":
                plan.latency_sec = float(value) / 1000.0
            elif key == "latency_sec":
                plan.latency_sec = float(value)
            elif key == "bandwidth_gbps":
                plan.bandwidth_gbps = float(value)
            elif key in ("seed", "transient_per_op", "transient_every"):
                setattr(plan, key, int(value))
            elif key in ("torn_writes", "short_reads"):
                setattr(plan, key, value not in ("0", "false", "False", ""))
            elif key == "rank":
                plan.rank = int(value)
            elif key == "crash_after_op":
                kind, _, idx = value.partition(":")
                plan.crash_after_op = (kind, int(idx))
            elif key == "wedge":
                # "write:3" → 3rd write attempt SIGSTOPs the process
                # ("write:*" or index 0 → the first attempt).
                kind, _, idx = value.partition(":")
                plan.wedge = (kind, 0 if idx in ("", "*") else int(idx))
            elif key == "stall_op":
                # "write:3:5.0" → 3rd write attempt sleeps 5 s
                # ("write:*:5.0" or index 0 → every attempt).
                kind, idx, secs = value.split(":")
                plan.stall_op = (
                    kind,
                    0 if idx == "*" else int(idx),
                    float(secs),
                )
            elif key == "preempt":
                # "write:3:30" → 3rd write attempt gets SIGTERM with a
                # 30 s SIGKILL deadline ("write:*:30" or index 0 → the
                # first attempt).
                kind, idx, secs = value.split(":")
                plan.preempt = (
                    kind,
                    0 if idx == "*" else int(idx),
                    float(secs),
                )
            elif key == "outage":
                # "write:10" → writes down for the first 10 s;
                # "*:5:10" → ALL ops down from t=5 s to t=15 s
                # (t anchored at this plugin's first op).
                parts = value.split(":")
                if len(parts) == 2:
                    plan.outage = (parts[0], 0.0, float(parts[1]))
                elif len(parts) == 3:
                    plan.outage = (parts[0], float(parts[1]), float(parts[2]))
                else:
                    raise ValueError(
                        f"outage spec {value!r}: expected <kind>:<secs> "
                        "or <kind>:<start>:<secs>"
                    )
            else:
                raise ValueError(f"Unknown fault spec key {key!r} in {spec!r}")
        return plan

    @classmethod
    def coerce(cls, value) -> "FaultPlan":
        """FaultPlan | spec-string | dict | None → FaultPlan. ``None``
        consults TPUSNAP_FAULT_SPEC, defaulting to one transient error
        per op (a chaos URL with no plan should still misbehave)."""
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls.from_spec(value)
        if isinstance(value, dict):
            return cls(**value)
        if value is None:
            from .knobs import get_fault_spec

            env = get_fault_spec()
            if env:
                return cls.from_spec(env)
            return cls(transient_per_op=1)
        raise TypeError(f"Cannot build a FaultPlan from {value!r}")


@dataclass
class _FaultState:
    """Mutable per-plugin-instance counters (the plan itself is data)."""

    rng: random.Random
    op_count: int = 0
    kind_success: Dict[str, int] = field(default_factory=dict)
    kind_attempts: Dict[str, int] = field(default_factory=dict)
    wedge_attempts: Dict[str, int] = field(default_factory=dict)
    preempt_attempts: Dict[str, int] = field(default_factory=dict)
    preempt_fired: bool = False
    per_op_attempts: Dict[Tuple[str, str], int] = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock)
    # Outage-window anchor (monotonic, set at this plugin's first op)
    # and the edge-trigger flag for its one flight breadcrumb.
    outage_anchor: Optional[float] = None
    outage_announced: bool = False
    # Write-bandwidth token bucket: the monotonic time the shared pipe
    # frees up (concurrent writers queue behind it, like a real link).
    bw_release: float = 0.0


# Monotonic seam for the outage window (tests pin it to a fake clock so
# the window is exact without sleeps).
_mono = time.monotonic


def _process_rank() -> int:
    """This process's distributed rank for the ``rank=`` plan filter: the
    ``torch.distributed`` rank when a process group exists, else the
    ``RANK`` environment variable (a launcher's, or a StoreComm job's),
    else 0."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        logger.debug("no torch.distributed rank; falling back to RANK", exc_info=True)
    try:
        return int(os.environ.get("RANK", "0"))
    except ValueError:
        return 0


class FaultInjectionStoragePlugin(StoragePlugin):
    """Wraps any ``StoragePlugin``, misbehaving per a seeded ``FaultPlan``.
    Scheduling-transparent like the retry wrapper (in-place reads,
    overhead accounting, draining all delegate)."""

    def __init__(self, inner: StoragePlugin, plan: Optional[FaultPlan] = None):
        self.inner = inner
        self.plan = FaultPlan.coerce(plan)
        if self.plan.rank is not None and self.plan.rank != _process_rank():
            # Rank-filtered plan on a non-matching rank: behave
            # fault-free (an inert plan, not a bypassed wrapper, so the
            # plugin surface stays identical on every rank).
            self.plan = FaultPlan(seed=self.plan.seed)
        self._state = _FaultState(rng=random.Random(self.plan.seed))

    # --- scheduling transparency -----------------------------------------

    @property
    def supports_in_place_reads(self) -> bool:  # type: ignore[override]
        return self.inner.supports_in_place_reads

    def in_place_read_overhead_bytes(self, nbytes: int) -> int:
        return self.inner.in_place_read_overhead_bytes(nbytes)

    def drain_in_flight(self) -> None:
        self.inner.drain_in_flight()

    def classify_transient(self, exc: BaseException) -> bool:
        # The retry wrapper asks the plugin it wraps; delegate to the
        # real backend's classifier (InjectedFaultError is a
        # ConnectionError, transient under every default).
        from .retry import default_classify_transient

        inner_classify = getattr(
            self.inner, "classify_transient", default_classify_transient
        )
        return isinstance(exc, InjectedFaultError) or inner_classify(exc)

    # --- fault decisions --------------------------------------------------

    @staticmethod
    def _kind_for(kind: str, path: str) -> str:
        """Ops on lifecycle-journal sidecars count under their own kind
        (``journal``) so crash-matrix specs can SIGKILL around journal
        writes by name (``crash_after_op=journal:1``) without the index
        arithmetic drifting as blob counts change; everything else keeps
        the raw op kind. ``list`` (fsck/gc enumeration) is already its
        own kind. CAS ref records get the same treatment
        (``crash_after_op=cas_ref:1`` kills precisely after the first
        ref flush — the mid-ref-write chaos window)."""
        from .io_types import CAS_REFS_DIR
        from .lifecycle import is_journal_path

        if is_journal_path(path):
            return "journal"
        if path.startswith(CAS_REFS_DIR + "/"):
            return "cas_ref"
        return kind

    def _decide(self, kind: str, path: str) -> Tuple[bool, float]:
        """One decision per op attempt: (inject_transient, latency)."""
        plan, st = self.plan, self._state
        with st.lock:
            st.op_count += 1
            n = st.op_count
            latency = (
                plan.latency_sec * (0.5 + st.rng.random())
                if plan.latency_sec
                else 0.0
            )
            inject = False
            key = (kind, path)
            attempts = st.per_op_attempts.get(key, 0)
            st.per_op_attempts[key] = attempts + 1
            if plan.transient_per_op and attempts < plan.transient_per_op:
                inject = True
            if (
                plan.transient_every
                and attempts == 0
                and n % plan.transient_every == 0
            ):
                # First attempts only: a RETRY of an op that drew the
                # every-Nth fault must not draw it again (with
                # transient_every=1 every attempt would fault and the
                # op could never converge under retry).
                inject = True
            return inject, latency

    def _record_success(self, kind: str) -> None:
        plan, st = self.plan, self._state
        with st.lock:
            st.kind_success[kind] = st.kind_success.get(kind, 0) + 1
            crash = (
                plan.crash_after_op is not None
                and plan.crash_after_op[0] == kind
                and st.kind_success[kind] == plan.crash_after_op[1]
            )
        if crash:
            logger.warning(
                "FaultPlan crash_after_op=%s: SIGKILLing pid %d",
                plan.crash_after_op,
                os.getpid(),
            )
            os.kill(os.getpid(), signal.SIGKILL)

    def _torn_len(self, total: int) -> int:
        with self._state.lock:
            return self._state.rng.randrange(0, max(total, 1))

    def _stall_seconds(self, kind: str) -> float:
        """Injected in-op sleep for this attempt of ``kind`` (the
        ``stall_op`` plan): 1-based attempt index, 0/``*`` = every."""
        plan, st = self.plan, self._state
        if plan.stall_op is None or plan.stall_op[0] != kind:
            return 0.0
        with st.lock:
            n = st.kind_attempts.get(kind, 0) + 1
            st.kind_attempts[kind] = n
        idx = plan.stall_op[1]
        return plan.stall_op[2] if idx == 0 or n == idx else 0.0

    def _check_outage(self, kind: str, path: str) -> None:
        """Raise while a planned sustained-outage window covers this op
        (deterministic in time, anchored at the plugin's first op)."""
        plan, st = self.plan, self._state
        if plan.outage is None:
            return
        okind, start, duration = plan.outage
        now = _mono()
        with st.lock:
            # Anchor at the plugin's FIRST op of any kind (as the spec
            # documents) — a kind-filtered anchor would shift the
            # window by however long the plugin spent listing/reading
            # before its first matching op.
            if st.outage_anchor is None:
                st.outage_anchor = now
            t = now - st.outage_anchor
        if okind not in ("*", kind):
            return
        with st.lock:
            in_window = start <= t < start + duration
            announce = in_window and not st.outage_announced
            if announce:
                st.outage_announced = True
        if not in_window:
            return
        telemetry.incr(f"faults.outage.{kind}")
        if announce:
            # One flight breadcrumb per window, not one per rejected op.
            telemetry.event(
                "outage_injected", kind=okind, start=start, seconds=duration
            )
            flight.record(
                "fault_outage", op=okind, start=start, seconds=duration
            )
        raise InjectedFaultError(
            f"injected outage: {kind}({path!r}) rejected "
            f"({t - start:.2f}s into a {duration:.2f}s window)"
        )

    async def _throttle_bandwidth(self, nbytes: int) -> None:
        """Serialize ``nbytes`` of write payload through the planned
        pipe ceiling: a shared token bucket (not per-op sleep), so N
        concurrent writes still drain at ``bandwidth_gbps`` aggregate
        and compressed payloads genuinely cost fewer pipe-seconds."""
        bw = self.plan.bandwidth_gbps
        if bw <= 0 or nbytes <= 0:
            return
        cost = nbytes / (bw * 1e9)
        st = self._state
        with st.lock:
            start = max(_mono(), st.bw_release)
            st.bw_release = start + cost
            release = st.bw_release
        delay = release - _mono()
        if delay > 0:
            telemetry.incr("faults.bandwidth_throttled")
            await asyncio.sleep(delay)

    def _check_wedge(self, kind: str) -> None:
        """SIGSTOP this process on the planned attempt of ``kind``: the
        whole process freezes (heartbeat pump and lease publisher
        included), so peers' liveness leases expire and survivors raise
        RankFailedError — a dead rank from their view, while the parent
        test keeps a SIGCONT/SIGKILL handle on the frozen pid."""
        plan, st = self.plan, self._state
        if plan.wedge is None or plan.wedge[0] != kind:
            return
        with st.lock:
            n = st.wedge_attempts.get(kind, 0) + 1
            st.wedge_attempts[kind] = n
        idx = plan.wedge[1]
        if idx != 0 and n != idx:
            return
        telemetry.incr(f"faults.wedged.{kind}")
        flight.record("fault_wedge", op=kind)
        # Flush the black box NOW: a frozen process never reaches its
        # next heartbeat flush, and the wedge breadcrumb is exactly
        # what the post-mortem needs.
        try:
            flight.recorder().maybe_flush(force=True)
        except Exception:
            logger.debug("pre-wedge flight flush failed", exc_info=True)
        logger.warning(
            "FaultPlan wedge=%s: SIGSTOPping pid %d", plan.wedge, os.getpid()
        )
        os.kill(os.getpid(), signal.SIGSTOP)

    def _check_preempt(self, kind: str) -> None:
        """Deliver a preemption NOTICE on the planned attempt of
        ``kind``: SIGTERM to this process now, SIGKILL ``grace_s``
        seconds later if it is still alive (a daemon timer — a process
        that exits within the grace implicitly cancels the kill). The
        handler the app installed on SIGTERM gets a real, bounded
        window to leave gracefully — the deterministic "spot instance
        reclaim" fault elastic-leave tests run on."""
        plan, st = self.plan, self._state
        if plan.preempt is None or plan.preempt[0] != kind:
            return
        with st.lock:
            if st.preempt_fired:
                return
            n = st.preempt_attempts.get(kind, 0) + 1
            st.preempt_attempts[kind] = n
            idx = plan.preempt[1]
            if idx != 0 and n != idx:
                return
            st.preempt_fired = True
        grace_s = plan.preempt[2]
        telemetry.incr("faults.preempt")
        flight.record("fault_preempt", op=kind, grace_s=grace_s)
        # Flush the black box NOW: the SIGTERM handler may exit the
        # process before the next heartbeat flush, and the preemption
        # breadcrumb is what the post-mortem needs to tell a graceful
        # leave from a silent death.
        try:
            flight.recorder().maybe_flush(force=True)
        except Exception:
            logger.debug("pre-preempt flight flush failed", exc_info=True)
        logger.warning(
            "FaultPlan preempt=%s: SIGTERM to pid %d (SIGKILL in %.1fs)",
            plan.preempt,
            os.getpid(),
            grace_s,
        )
        pid = os.getpid()

        def _hard_kill() -> None:
            logger.warning(
                "FaultPlan preempt grace expired: SIGKILLing pid %d", pid
            )
            os.kill(pid, signal.SIGKILL)

        timer = threading.Timer(grace_s, _hard_kill)
        timer.daemon = True
        timer.start()
        os.kill(pid, signal.SIGTERM)

    async def _pre(self, kind: str, path: str) -> bool:
        """Apply latency + injected stalls; return whether this attempt
        must fail."""
        self._check_outage(kind, path)
        self._check_wedge(kind)
        self._check_preempt(kind)
        inject, latency = self._decide(kind, path)
        if latency:
            telemetry.incr("faults.latency_injections")
            await asyncio.sleep(latency)
        stall = self._stall_seconds(kind)
        if stall:
            # The op is already in flight (the scheduler's op token is
            # held across this await), so the sleep is exactly the
            # no-forward-progress hang the watchdog must detect.
            telemetry.incr(f"faults.stalled.{kind}")
            telemetry.event("stall_injected", kind=kind, path=path, seconds=stall)
            flight.record(
                "fault_stall", op=kind, path=path, seconds=stall
            )
            await asyncio.sleep(stall)
        if inject:
            # Always-on counter + instant trace event: a chaos take's
            # persisted trace shows exactly which ops drew faults.
            telemetry.incr(f"faults.injected.{kind}")
            telemetry.event("fault_injected", kind=kind, path=path)
            flight.record("fault", op=kind, path=path)
        return inject

    # --- plugin interface -------------------------------------------------

    async def write(self, write_io: WriteIO) -> None:
        kind = self._kind_for("write", write_io.path)
        if await self._pre(kind, write_io.path):
            if self.plan.torn_writes and len(write_io.buf) > 0:
                keep = self._torn_len(len(write_io.buf))
                torn = memoryview(write_io.buf).cast("B")[:keep]
                try:
                    await self.inner.write(WriteIO(path=write_io.path, buf=torn))
                except Exception:
                    # tpusnap: waive=TPS004 the torn write itself may
                    # fail; the InjectedFaultError below raises either way
                    pass
                raise InjectedFaultError(
                    f"injected torn write: {keep}/{len(write_io.buf)} bytes "
                    f"of {write_io.path!r} persisted"
                )
            raise InjectedFaultError(f"injected write failure: {write_io.path!r}")
        await self._throttle_bandwidth(len(write_io.buf))
        await self.inner.write(write_io)
        self._record_success(kind)

    async def write_atomic(self, write_io: WriteIO, durable: bool = False) -> None:
        kind = self._kind_for("write_atomic", write_io.path)
        if await self._pre(kind, write_io.path):
            # Never tear an atomic write: the wrapped plugin's contract is
            # that a failed write_atomic leaves no trace, and chaos must
            # not fabricate failures the real backend cannot produce.
            raise InjectedFaultError(
                f"injected write_atomic failure: {write_io.path!r}"
            )
        await self._throttle_bandwidth(len(write_io.buf))
        await self.inner.write_atomic(write_io, durable=durable)
        self._record_success(kind)

    async def read(self, read_io: ReadIO) -> None:
        if await self._pre("read", read_io.path):
            if self.plan.short_reads:
                # Deliver a seeded truncation of the real bytes, then fail
                # the op — simulating a connection dropped mid-transfer.
                trial = ReadIO(path=read_io.path, byte_range=read_io.byte_range)
                try:
                    await self.inner.read(trial)
                    data = trial.buf.getvalue()
                    import io as _io

                    read_io.buf = _io.BytesIO(data[: self._torn_len(len(data))])
                except Exception:
                    # tpusnap: waive=TPS004 the trial read may fail too;
                    # the InjectedFaultError below raises either way
                    pass
                raise InjectedFaultError(
                    f"injected short read: {read_io.path!r}"
                )
            raise InjectedFaultError(f"injected read failure: {read_io.path!r}")
        await self.inner.read(read_io)
        self._record_success("read")

    async def delete(self, path: str) -> None:
        kind = self._kind_for("delete", path)
        if await self._pre(kind, path):
            raise InjectedFaultError(f"injected delete failure: {path!r}")
        await self.inner.delete(path)
        self._record_success(kind)

    async def list_with_sizes(self):
        # fsck/gc's enumeration is a faultable op of its own kind, so
        # soaks can target lifecycle tooling (``crash_after_op=list:1``,
        # transient faults on listing) by name.
        if await self._pre("list", ""):
            raise InjectedFaultError("injected list failure")
        out = await self.inner.list_with_sizes()
        self._record_success("list")
        return out

    async def flush_created_dirs(self) -> None:
        await self.inner.flush_created_dirs()

    async def close(self) -> None:
        await self.inner.close()
