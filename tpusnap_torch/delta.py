"""Continuous delta checkpointing: streaming micro-commits for
seconds-scale RPO with crash-replay restore.

Counterpart of tpusnap/delta.py, with the same chain layout,
``extras["delta"]`` fields and elastic control plane, so either package
resolves, resumes and restores the other's stream root. See
"Step consistency on CUDA" below for what the port adds.

A classic take is a periodic stop-the-world event: a crash loses
everything since the last one — minutes of work at fleet cadences, and
an SLO tracker can only *measure* that exposure. This module
composes primitives the system already owns — incremental dedup's
dual-hash (CRC32C+XXH64) change detection, strict-staging incremental
``async_take``, the crash-safe journal, salvage-resume and fsck's
torn-tail classification — into a **streaming delta mode** with a
tunable recovery-point objective:

- :meth:`tpusnap_torch.Snapshot.stream` opens a :class:`DeltaStream` under a
  root directory: one full **base** snapshot now (with per-tile dedup
  hashes recorded, so every blob has tile grain from the first
  increment), then one **micro-commit** per cadence interval — a real,
  journaled, metadata-written-last incremental snapshot referencing the
  previous committed member, shipping only tiles/blobs whose fresh
  dual-hash pair changed. An unchanged model streams ~zero payload
  bytes; one mutated row of a multi-GB array streams ~one checksum
  tile.
- Because incremental writers **collapse chained references** (each
  member's external locations point at the member that physically holds
  the bytes — never through an intermediate), the chain never deepens
  lookups: ``Snapshot(head).restore`` / ``read_object`` work
  transparently on any member, reading base + changed blobs flat.
- Every micro-commit runs the unchanged crash machinery: a SIGKILL
  mid-commit leaves a **torn tail** the journal classifies (fsck names
  it "torn delta micro-commit seq N over member X"), gc'd or salvaged
  like any torn take — and recovery lands on the last committed
  increment via :func:`resolve_chain`.
- Chains stay bounded: past ``TPUSNAP_DELTA_MAX_CHAIN`` members the
  stream **compacts** — ``materialize`` copies the head's referenced
  blobs in (checksum-verified, committed atomically), making it the new
  self-contained base, and the superseded members are retired.

Step consistency on CUDA. Torch updates state in place — every
optimizer step writes the parameters and moments of the CUDA tensors it
was handed — so the port keeps tpusnap's contract in these terms:

- :meth:`DeltaStream.mark_step` (once per training step, on the training
  thread) makes each due capture run inline there, at the step
  boundary: the capture holds the whole state at that boundary, bit for
  bit. Its cost is the strict incremental staging (the device-to-host
  copy and the dual hash of every byte) before ``mark_step`` returns;
  the writes and the two-phase commit drain in the background.
- A free-running capture (no ``mark_step`` caller, a capture on any
  thread but the one that opened the stream, and every epoch of a
  multi-process stream) holds each tensor whole at some step boundary
  (blob grain): it first copies the CUDA tensors on the card, IN the
  training stream's order (the copies are queued on that stream from
  the capturing thread), so no later in-place update can reach them,
  and stages the copies. A step that writes a tensor with one kernel
  (``copy_``, a fused optimizer) leaves it at a boundary whichever
  position the copy takes in the stream.
- The streams that order every capture are the ones current on each
  state device when ``Snapshot.stream`` is called (training under
  ``torch.cuda.stream(s)`` opens the stream there), whatever thread the
  capture runs on; the capturing thread also selects the state's
  device, since ``torch.cuda.set_device`` is per thread.
- :meth:`DeltaStream.commit_now` forces a synchronous micro-commit and
  returns the committed :class:`~tpusnap_torch.Snapshot`;
  :meth:`DeltaStream.close` stops the stream (with a final commit by
  default).

Multi-process streams are **elastic**: the minimum joined rank — the
*leader* — announces each capture epoch over the process group's
TCPStore; every member polls for the announcement and joins the
epoch's collective micro-commit over a fresh per-epoch
:class:`~tpusnap_torch.comm.SubsetComm`, so each micro-commit is a real
multi-rank incremental take riding the unchanged journal /
metadata-written-last machinery, with the participating world recorded
in ``extras["delta"]["world"]`` (and in the take journal, so a torn
epoch still names its world). Death and resize are stream events, not
wedges:

- a rank dying mid-epoch (lease expiry → ``RankFailedError``) lets the
  survivors complete the epoch DEGRADED when every leaf is replicated
  (the degraded-commit protocol, extended to the stream's
  force-clone-staged incremental async takes via ``stream_capture``);
  the dead rank is expired from the membership and streaming continues;
- sharded state refuses adoption: the torn epoch aborts (its salvage
  substrate kept) and the stream **pauses** —
  :attr:`DeltaStream.paused` / ``pause_info`` name the event; reopening
  ``Snapshot.stream`` on the root resumes the committed chain and the
  retake of the torn member salvages its journal-proven blobs;
- ranks leave gracefully via :meth:`DeltaStream.leave` (a terminal
  ``left`` member/lease state — watchers render LEFT, never DEAD) and
  join a LIVE stream by calling ``Snapshot.stream`` on the same root;
  either way the next capture boundary re-plans the world through the
  take's own partitioner/resharding machinery.

The TCPStore lists no prefix, so membership is read by the per-rank
probe, and every wait polls. Rank 0 hosts the store (as process 0 hosts
JAX's coordinator), so a stream survives the death or departure of any
rank but 0.

Reopening a stream root after full shutdown resumes the committed
chain in place (single- and multi-process alike): the new stream
adopts the head's stream id and sequence, takes no new base, and its
first micro-commit retakes — and salvages — any torn tail.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import posixpath
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional
from urllib.parse import urlsplit

import torch

from . import flight, telemetry
from .comm import Communicator, get_communicator
from .knobs import get_delta_cadence_s, get_delta_max_chain

logger = logging.getLogger(__name__)

# Coordination-KV namespace of the elastic-stream control plane:
# `tpusnap_stream/<stream_id>/members/<rank>` membership records,
# `tpusnap_stream/<stream_id>/ann/<inc>/<epoch>` capture-epoch
# announcements, `tpusnap_stream_root/<digest(root)>` the root
# registration a joiner reads.
_STREAM_KV_ROOT = "tpusnap_stream"
# Follower poll interval for the next epoch announcement.
_ANN_POLL_S = 0.1

__all__ = [
    "DeltaStream",
    "DeltaChainReport",
    "ChainMember",
    "resolve_chain",
    "delta_payload_bytes",
]


def member_name(seq: int) -> str:
    """Canonical member directory name: ``base-000000`` for the stream's
    first full snapshot, ``delta-%06d`` for micro-commits. Chain
    structure is read from metadata (``extras["delta"]``), never parsed
    from names — a compacted head keeps its ``delta-*`` name while
    being fully self-contained."""
    return f"base-{seq:06d}" if seq == 0 else f"delta-{seq:06d}"


def delta_fields(metadata) -> Optional[Dict[str, Any]]:
    """The validated delta-chain fields of a committed snapshot's
    metadata — delegates to :func:`tpusnap_torch.manifest_ops.
    delta_chain_fields`, the one place chain membership is decoded."""
    from .manifest_ops import delta_chain_fields

    return delta_chain_fields(metadata)


def delta_payload_bytes(metadata) -> int:
    """Bytes PHYSICALLY stored in this member's own directory — i.e.
    excluding external (``../``) references into earlier chain members.
    The numerator of delta write amplification: for an unchanged model
    this is ~zero; for one changed row of a tiled array it is ~one
    checksum tile."""
    from .inspect import iter_blobs

    total = 0
    for blob in iter_blobs(metadata.manifest):
        if blob.location.startswith("../"):
            continue
        if blob.byte_range is not None:
            total += blob.byte_range[1] - blob.byte_range[0]
    return total


# -------------------------------------------------------- chain resolution


@dataclass
class ChainMember:
    """One directory under a stream root, classified."""

    name: str
    state: str  # "committed" | "torn" | "debris"
    seq: Optional[int] = None
    parent: Optional[str] = None
    stream_id: Optional[str] = None
    created_at: Optional[float] = None
    payload_bytes: int = 0
    # Elastic-stream forensics (multi-process epochs). ``world`` is the
    # participating world recorded at capture time
    # (``{"size", "ranks", "joined"?, "left"?, "expired"?}`` with
    # GLOBAL process ids); ``degraded`` is the ``extras["degraded"]``
    # record of an epoch the survivors completed without a dead rank;
    # ``missing_ranks`` (torn members only) names the GLOBAL ranks
    # whose per-rank journal evidence never landed — the write the tear
    # interrupted.
    world: Optional[Dict[str, Any]] = None
    degraded: Optional[Dict[str, Any]] = None
    missing_ranks: Optional[List[int]] = None


@dataclass
class DeltaChainReport:
    """What :func:`resolve_chain` finds under a stream root.

    ``head`` is the RECOVERY POINT: the committed member with the
    highest sequence number — ``Snapshot(<root>/<head>).restore``
    replays base + committed deltas transparently. ``torn_tail`` names
    a member whose micro-commit was interrupted (journal present, no
    metadata): recovery IGNORES it (gc or the next stream's
    salvage-resume reclaims it). ``chain`` is the set of members the
    head's blob references actually span (head first) — what retention
    must keep alive for the head to stay restorable. ``superseded`` are
    committed members outside every live chain (compaction leftovers) —
    reclaimable. ``debris`` are half-deleted/foreign subdirectories
    (e.g. a compaction retire interrupted mid-rmtree)."""

    root: str
    members: List[ChainMember] = field(default_factory=list)
    head: Optional[str] = None  # member name
    torn_tail: Optional[str] = None
    chain: List[str] = field(default_factory=list)  # head first
    superseded: List[str] = field(default_factory=list)
    debris: List[str] = field(default_factory=list)

    @property
    def head_path(self) -> Optional[str]:
        return f"{self.root.rstrip('/')}/{self.head}" if self.head else None

    def summary(self) -> str:
        if not self.members:
            return f"{self.root}: no delta-stream members"
        s = (
            f"{self.root}: {len(self.members)} member(s), "
            f"head={self.head or 'NONE'}"
        )
        if self.chain:
            s += f", chain depth {len(self.chain)}"
        degraded = [m for m in self.members if m.degraded]
        if degraded:
            s += f", {len(degraded)} DEGRADED epoch(s)"
        if self.torn_tail:
            s += f", TORN TAIL {self.torn_tail} (recovery ignores it)"
            torn_m = next(
                (m for m in self.members if m.name == self.torn_tail), None
            )
            if torn_m is not None and torn_m.missing_ranks:
                s += (
                    f" — missing journal evidence from rank(s) "
                    f"{torn_m.missing_ranks}"
                )
        if self.superseded:
            s += f", {len(self.superseded)} superseded"
        if self.debris:
            s += f", {len(self.debris)} debris dir(s)"
        return s


def resolve_chain(
    root: str, storage_options: Optional[Dict[str, Any]] = None
) -> DeltaChainReport:
    """Scan a stream root and name the recovery head, the torn tail (if
    a crash interrupted a micro-commit) and the live chain. Read-only;
    works on any backend that can list (tpusnap's ``info``/``fsck``
    report the same for a root that holds chain members)."""
    import asyncio

    from .io_types import ReadIO
    from .lifecycle import JOURNAL_FNAME, JOURNAL_RECORDS_DIR
    from .manifest import decode_metadata
    from .snapshot import SNAPSHOT_METADATA_FNAME
    from .storage_plugin import url_to_storage_plugin_in_event_loop

    report = DeltaChainReport(root=root)
    event_loop = asyncio.new_event_loop()
    try:
        storage = url_to_storage_plugin_in_event_loop(
            root, event_loop, storage_options
        )
        try:
            files = storage.sync_list_with_sizes(event_loop)
            if not files:
                return report
            # Group by first path component: each member is a subdir.
            by_member: Dict[str, Dict[str, int]] = {}
            for path, size in files.items():
                member, sep, rest = path.partition("/")
                if sep:
                    by_member.setdefault(member, {})[rest] = size
            for name in sorted(by_member):
                sub = by_member[name]
                m = ChainMember(name=name, state="debris")
                if SNAPSHOT_METADATA_FNAME in sub:
                    read_io = ReadIO(
                        path=f"{name}/{SNAPSHOT_METADATA_FNAME}"
                    )
                    try:
                        storage.sync_read(read_io, event_loop)
                        md = decode_metadata(read_io.buf.getvalue())
                    except Exception:
                        report.members.append(m)
                        report.debris.append(name)
                        continue
                    m.state = "committed"
                    m.created_at = md.created_at
                    d = delta_fields(md)
                    if d is not None:
                        m.seq = d.get("seq")
                        m.parent = d.get("parent")
                        m.stream_id = d.get("stream")
                        w = d.get("world")
                        if isinstance(w, dict):
                            m.world = w
                    deg = (md.extras or {}).get("degraded")
                    if isinstance(deg, dict):
                        m.degraded = deg
                    try:
                        m.payload_bytes = delta_payload_bytes(md)
                    except Exception:
                        pass
                elif JOURNAL_FNAME in sub or any(
                    p.startswith(JOURNAL_RECORDS_DIR + "/") for p in sub
                ):
                    m.state = "torn"
                    read_io = ReadIO(path=f"{name}/{JOURNAL_FNAME}")
                    try:
                        from .lifecycle import TakeJournal

                        storage.sync_read(read_io, event_loop)
                        j = TakeJournal.from_json(
                            read_io.buf.getvalue().decode("utf-8")
                        )
                        if j.stream:
                            m.seq = j.stream.get("seq")
                            m.parent = j.stream.get("parent")
                            m.stream_id = j.stream.get("stream")
                            w = j.stream.get("world")
                            if isinstance(w, dict):
                                m.world = w
                                ranks = w.get("ranks")
                                if isinstance(ranks, list) and ranks:
                                    # Per-rank journal evidence present
                                    # under the torn member: a VIRTUAL
                                    # rank with no record file never
                                    # proved a single blob — name it by
                                    # its GLOBAL id.
                                    have = set()
                                    rec_pfx = JOURNAL_RECORDS_DIR + "/rank_"
                                    for p in sub:
                                        if p.startswith(rec_pfx):
                                            try:
                                                have.add(
                                                    int(p.rsplit("_", 1)[-1])
                                                )
                                            except ValueError:
                                                pass
                                    missing = [
                                        int(ranks[v])
                                        for v in range(len(ranks))
                                        if v not in have
                                    ]
                                    m.missing_ranks = missing or None
                    except Exception:
                        pass
                else:
                    report.debris.append(name)
                report.members.append(m)
        finally:
            storage.sync_close(event_loop)
    finally:
        event_loop.close()

    committed = [m for m in report.members if m.state == "committed"]
    chain_members = [m for m in committed if m.seq is not None]
    if chain_members:
        head = max(
            chain_members, key=lambda m: (m.seq, m.created_at or 0.0)
        )
        report.head = head.name
    elif committed:
        # Non-stream snapshots under the root (or pre-field members):
        # newest committed by created_at is still the best recovery
        # point resolve can offer.
        report.head = max(
            committed, key=lambda m: m.created_at or 0.0
        ).name
    torn = [m for m in report.members if m.state == "torn"]
    if torn:
        report.torn_tail = max(
            torn, key=lambda m: (m.seq is not None, m.seq or 0)
        ).name
    if report.head:
        report.chain = _chain_of(root, report.head, storage_options)
        live = set(report.chain)
        report.superseded = [
            m.name for m in committed if m.name not in live
        ]
    return report


def _chain_of(
    root: str,
    head_name: str,
    storage_options: Optional[Dict[str, Any]] = None,
) -> List[str]:
    """The member names the head's blob references actually span (head
    first) — the base_roots recorded at take time, resolved back to
    member names. Because writers collapse chained references, this IS
    the complete keep-alive set for the head; no transitive walk is
    needed (retention still walks transitively as defense in depth)."""
    from .inspect import load_snapshot_metadata

    head_path = f"{root.rstrip('/')}/{head_name}"
    try:
        md = load_snapshot_metadata(head_path, storage_options)
    except Exception:
        return [head_name]
    out = [head_name]
    for r in md.base_roots or []:
        # Base roots are relative to the member ("../base-000000").
        name = posixpath.normpath(posixpath.join(head_name, r))
        if "/" not in name and name not in out and name != head_name:
            out.append(name)
    return out


# ------------------------------------------------------- CUDA capture order


def _map_cuda(obj: Any, fn) -> Any:
    """``obj`` with ``fn`` applied to every CUDA tensor, through the
    containers ``flatten`` walks (dicts become plain dicts, keeping an
    OrderedDict's type; named tuples become tuples, as they flatten)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj) if obj.is_cuda else obj
    if isinstance(obj, dict):
        out = {k: _map_cuda(v, fn) for k, v in obj.items()}
        return collections.OrderedDict(out) if isinstance(obj, collections.OrderedDict) else out
    if isinstance(obj, list):
        return [_map_cuda(v, fn) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_map_cuda(v, fn) for v in obj)
    return obj


def _state_streams(app_state) -> Dict[int, "torch.cuda.Stream"]:
    """Device index -> the calling thread's current stream, for every
    device holding a CUDA tensor of ``app_state``: the streams training
    writes the state on, which order every capture of the stream."""
    from .rng_state import RNGState

    devices: set = set()

    def note(t: torch.Tensor) -> torch.Tensor:
        devices.add(t.device.index if t.device.index is not None else torch.cuda.current_device())
        return t

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    for stateful in app_state.values():
        if not isinstance(stateful, RNGState):
            _map_cuda(stateful.state_dict(), note)
    return {d: torch.cuda.current_stream(d) for d in sorted(devices)}


class _FrozenStateful:
    """A stateful whose ``state_dict`` is a capture-time copy: what a
    free-running capture hands the take."""

    def __init__(self, state: Any) -> None:
        self._state = state

    def state_dict(self) -> Any:
        return self._state

    def load_state_dict(self, state_dict: Any) -> None:
        raise TypeError("a capture's frozen state is not restorable in place")


def _freeze_in_stream(app_state) -> Dict[str, Any]:
    """Copy every CUDA tensor of ``app_state`` on the card, on the
    current stream (the training stream, inside ``_ordered``): each copy
    takes its tensor at its position in that stream's queue, after the
    kernels training queued before it and before any it queues later. RNG
    states are captured first and restored after, as a take does."""
    from .rng_state import RNGState

    rng = {k: v.state_dict() for k, v in app_state.items() if isinstance(v, RNGState)}
    frozen: Dict[str, Any] = {}
    with torch.no_grad():
        for key, stateful in app_state.items():
            if key in rng:
                continue
            frozen[key] = _FrozenStateful(
                _map_cuda(stateful.state_dict(), lambda t: t.detach().clone())
            )
    for key, state in rng.items():
        app_state[key].load_state_dict(state)
        frozen[key] = _FrozenStateful(state)
    return frozen


# --------------------------------------------------------------- the stream


class DeltaStream:
    """A live continuous-checkpointing session. Construct via
    :meth:`tpusnap_torch.Snapshot.stream`. Thread-safe; one capture in flight
    at a time. See the module docstring for semantics."""

    def __init__(
        self,
        root: str,
        app_state,
        cadence_s: Optional[float] = None,
        replicated: Optional[List[str]] = None,
        storage_options: Optional[Dict[str, Any]] = None,
        comm: Optional[Communicator] = None,
        max_chain: Optional[int] = None,
    ) -> None:
        comm = get_communicator(comm)
        self.root = root
        if cadence_s is not None:
            cadence_s = float(cadence_s)
            if cadence_s <= 0:
                raise ValueError(
                    f"cadence_s must be > 0, got {cadence_s!r} (the "
                    "TPUSNAP_DELTA_CADENCE_S default applies when omitted)"
                )
            # Same floor as the knob: a micro-commit is a real
            # two-phase-committed take.
            self.cadence_s = max(0.1, cadence_s)
        else:
            self.cadence_s = get_delta_cadence_s()
        self.max_chain = int(max_chain or get_delta_max_chain())
        self.stream_id = uuid.uuid4().hex[:16]
        self._app_state = app_state
        self._replicated = replicated
        self._storage_options = storage_options
        self._comm = comm
        self._multi = comm.world_size > 1
        self._rank = comm.rank  # GLOBAL process id
        # CUDA capture order: the thread that opened the stream (captures
        # there run at a step boundary) and the streams training writes
        # the state on (every capture is ordered against them).
        self._owner_thread = threading.get_ident()
        self._streams = _state_streams(app_state)
        self._device: Optional[int] = next(iter(self._streams), None)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._closed = False
        self._leaving = False  # graceful departure in progress (multi)
        self._paused = False  # torn epoch on rank failure (multi)
        self._pause_info: Optional[Dict[str, Any]] = None
        self._seq = 0
        self._head: Optional[str] = None  # member NAME
        self._chain: List[str] = []  # oldest first, head last
        self._step_gated = False  # a mark_step caller exists
        self._commit_due = False  # cadence elapsed, capture wanted
        self._capture_busy = False  # a capture/commit is in flight
        self._last_commit_mono: float = 0.0
        self._last_error: Optional[BaseException] = None
        # A staged-but-not-finalized capture handed off by mark_step:
        # the worker waits out its background commit drain so the
        # training thread never blocks past the staging window.
        self._pending_finalize: Optional[Dict[str, Any]] = None
        self._observability_stopped = False
        # Multi-process control plane (all no-ops when world_size == 1).
        self._kv = None
        self._inc = ""  # per-open incarnation token (epoch key scope)
        self._epoch = 1  # next epoch this rank expects to run
        self._members: List[int] = [self._rank]  # last epoch's world
        self._nudge_seen: Optional[bytes] = None
        self.stats: Dict[str, Any] = {
            "commits": 0,
            "bytes_written_total": 0,
            "last_commit_bytes": 0,
            "last_commit_wall_s": None,
            "max_commit_interval_s": None,
            "compactions": 0,
            "steps_marked": 0,
            # Captures run inline in mark_step, and the seconds the last
            # and the longest of them held the training thread.
            "mark_step_captures": 0,
            "last_capture_blocked_s": None,
            "max_capture_blocked_s": None,
            "epochs": 0,
            "degraded_epochs": 0,
            "joins": 0,
            "leaves": 0,
        }

        if self._multi:
            from .snapshot import _get_kv_store

            try:
                self._kv = _get_kv_store(comm)
            except Exception as e:
                raise RuntimeError(
                    "a multi-process delta stream runs its control plane over "
                    "the process group's TCPStore: initialise torch.distributed "
                    "(or pass a StoreComm) before Snapshot.stream"
                ) from e
            reg = self._read_reg()
            if reg and reg.get("live"):
                # A live stream already runs on this root: JOIN it solo
                # (no collectives — the incumbents are mid-cadence, not
                # at our call site).
                self._open_join(reg)
            else:
                self._open_collective()
        else:
            self._open_solo()

        self._worker = threading.Thread(
            target=self._run, name="tpusnap-delta", daemon=True
        )
        self._worker.start()

    # ----------------------------------------------------------- open paths

    def _plan_open(self) -> Dict[str, Any]:
        """Classify the root: FRESH (no committed chain — new stream id,
        base now; a torn base-000000 is retaken in place, salvaging its
        journal-proven blobs) or RESUME (committed chain present — adopt
        its identity and head; the first micro-commit retakes — and
        salvages — any torn tail). Committed members that are NOT chain
        members keep the historical refusal: a fresh base under foreign
        snapshots would silently change what the directory means."""
        existing = resolve_chain(self.root, self._storage_options)
        committed = [m for m in existing.members if m.state == "committed"]
        if not committed:
            return {
                "resume": False,
                "sid": self.stream_id,
                "seq": 0,
                "head": None,
                "chain": [],
                "torn": existing.torn_tail,
            }
        head_m = next(
            (m for m in existing.members if m.name == existing.head), None
        )
        if head_m is None or head_m.seq is None or not head_m.stream_id:
            raise ValueError(
                f"{self.root!r} already holds committed non-stream "
                f"snapshot(s) ({', '.join(m.name for m in committed[:4])}"
                f"{', ...' if len(committed) > 4 else ''}). A delta "
                "stream cannot adopt them: open the stream on a FRESH "
                "root (or gc the old members first)."
            )
        return {
            "resume": True,
            "sid": head_m.stream_id,
            "seq": int(head_m.seq),
            "head": existing.head,
            "chain": list(reversed(existing.chain)),
            "torn": existing.torn_tail,
        }

    def _apply_plan(self, plan: Dict[str, Any]) -> None:
        self.stream_id = plan["sid"]
        self._seq = int(plan["seq"])
        self._head = plan["head"]
        self._chain = list(plan["chain"])
        if plan["resume"]:
            # The caller restored the head before reopening (or is
            # about to diverge from it knowingly); the stream is armed
            # on the EXISTING recovery point — no new base.
            self._last_commit_mono = time.monotonic()
            telemetry.incr("delta.stream_resumes")
            flight.record(
                "delta",
                op="stream_resume",
                stream=self.stream_id,
                head=self._head,
                seq=self._seq,
                torn_tail=plan.get("torn"),
            )
            logger.info(
                "Resuming delta stream %s at %r: head %s (seq %d)%s",
                self.stream_id,
                self.root,
                self._head,
                self._seq,
                (
                    f"; torn tail {plan['torn']} will be salvaged on "
                    "the next micro-commit"
                    if plan.get("torn")
                    else ""
                ),
            )

    def _open_solo(self) -> None:
        plan = self._plan_open()
        self._apply_plan(plan)
        flight.record(
            "delta", op="stream_start", stream=self.stream_id,
            cadence_s=self.cadence_s,
        )
        if not plan["resume"]:
            # The base: a full, committed snapshot with per-tile dedup
            # hashes recorded, so the very first increment already
            # skips at tile grain. Synchronous — the stream is not
            # armed until a recovery point exists.
            self._commit(kind="base")

    def _open_collective(self) -> None:
        """Full-world open: rank 0 resolves the root (fresh vs resume)
        and broadcasts ONE plan — every rank must enter together,
        exactly like any SPMD cold start."""
        plan = None
        if self._rank == 0:
            plan = self._plan_open()
            plan["inc"] = uuid.uuid4().hex[:8]
        plan = self._comm.broadcast_object(plan, src=0)
        self._apply_plan(plan)
        self._inc = plan["inc"]
        self._members = list(range(self._comm.world_size))
        self._epoch = 1
        # Every rank of this open has read the registration (and found
        # no live stream) before rank 0 marks it live: without this
        # barrier a rank reaching Snapshot.stream after rank 0's write
        # would take the open for a live stream, join it alone, and
        # leave the others' base take waiting for it (the broadcast
        # above does not wait on its receivers).
        self._comm.barrier()
        # Membership + root registration BEFORE the base take, so a
        # joiner arriving mid-base already sees a live stream.
        self._set_member_state("joined")
        if self._rank == 0:
            self._write_reg(live=True)
        flight.record(
            "delta", op="stream_start", stream=self.stream_id,
            cadence_s=self.cadence_s, world=len(self._members),
        )
        if not plan["resume"]:
            self._commit(kind="base")

    def _open_join(self, reg: Dict[str, Any]) -> None:
        """Join a LIVE stream on this root: adopt the advertised
        identity, record membership, and participate from the first
        epoch whose announcement lists this rank. No collectives, no
        base — the chain already has one."""
        self.stream_id = reg["sid"]
        self._inc = reg.get("inc", "")
        if reg.get("cadence_s"):
            self.cadence_s = float(reg["cadence_s"])
        self._seq = int(reg.get("seq", 0))
        self._head = reg.get("head")
        self._chain = [self._head] if self._head else []
        self._epoch = int(reg.get("epoch", 0)) + 1
        self._members = []
        self._last_commit_mono = time.monotonic()
        self._set_member_state("joined")
        self.stats["joins"] += 1
        telemetry.incr("delta.stream_joins")
        flight.record(
            "delta", op="stream_join", stream=self.stream_id,
            rank=self._rank, epoch=self._epoch,
        )
        logger.info(
            "rank %d joining live delta stream %s at %r (next epoch %d)",
            self._rank, self.stream_id, self.root, self._epoch,
        )

    # ------------------------------------------------------------- public

    @property
    def head(self) -> Optional[str]:
        """Path of the last committed member — the recovery point."""
        with self._lock:
            return self._member_path(self._head) if self._head else None

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    @property
    def chain(self) -> List[str]:
        """Committed member names, oldest first."""
        with self._lock:
            return list(self._chain)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def mark_step(self, bytes_changed: Optional[int] = None) -> None:
        """Declare a training-step boundary (call once per optimizer
        step from the training thread). Arms step-gated capture: each
        due micro-commit's CAPTURE (state_dict + dual-hash staging)
        runs inline HERE, at a boundary, so it can never overlap an
        in-place mutation; the write + two-phase commit still drain in
        the background. ``bytes_changed`` (optional) feeds the SLO
        tracker's exact data-at-risk tier (accepted and ignored until the
        tracker is ported, ROADMAP.md item A9)."""
        capture = False
        with self._lock:
            self._step_gated = True
            self.stats["steps_marked"] += 1
            if self._commit_due and not self._capture_busy and not self._closed:
                self._commit_due = False
                self._capture_busy = True
                capture = True
        if capture:
            # Capture ONLY on the training thread: async_take returns
            # at staging-complete (incremental takes stage strictly),
            # so the state is frozen — and safe to mutate again — the
            # moment _begin_capture returns. The storage writes and the
            # two-phase commit drain on the take's background thread;
            # the WORKER waits them out and finalizes, so mark_step
            # never blocks on storage or compaction.
            t0 = time.monotonic()
            try:
                ctx = self._begin_capture("delta")
                blocked = round(time.monotonic() - t0, 6)
                with self._lock:
                    st = self.stats
                    st["mark_step_captures"] += 1
                    st["last_capture_blocked_s"] = blocked
                    st["max_capture_blocked_s"] = max(st["max_capture_blocked_s"] or 0.0, blocked)
            except Exception as e:
                # A failed capture must not take the TRAINING loop down
                # — stop the stream; the last committed increment stays
                # the recovery point and raise_if_failed() surfaces it.
                self._fail(e, where="micro-commit capture in mark_step")
                with self._cv:
                    self._capture_busy = False
                    self._cv.notify_all()
                return
            inline = False
            with self._cv:
                if self._closed:
                    # Teardown race: the worker may already be gone —
                    # finalize here rather than strand the capture.
                    inline = True
                else:
                    self._pending_finalize = ctx
                    self._cv.notify_all()
            if inline:
                try:
                    self._finalize_capture(ctx)
                except Exception:
                    logger.warning(
                        "DeltaStream finalize during close failed "
                        "(the previous head remains the recovery point)",
                        exc_info=True,
                    )
                finally:
                    with self._cv:
                        self._capture_busy = False
                        self._cv.notify_all()

    def commit_now(self):
        """Force a micro-commit and return the committed
        :class:`~tpusnap_torch.Snapshot`. Raises if the stream is closed.
        Single-process: runs synchronously on the calling thread.
        Multi-process: nudges the leader to announce the next epoch
        immediately and blocks until this rank's worker has committed
        it — commits are collective, so they always run on the epoch
        protocol, never inline on one rank."""
        if self._multi:
            return self._commit_now_multi()
        with self._cv:
            if self._closed:
                raise RuntimeError("DeltaStream is closed")
            while self._capture_busy:
                self._cv.wait()
                if self._closed:
                    raise RuntimeError("DeltaStream is closed")
            self._capture_busy = True
            self._commit_due = False
        try:
            return self._commit(kind="delta")
        finally:
            with self._cv:
                self._capture_busy = False
                self._cv.notify_all()

    def _commit_now_multi(self):
        from .snapshot import Snapshot

        with self._cv:
            if self._closed:
                raise RuntimeError("DeltaStream is closed")
            target = self.stats["commits"] + 1
        try:
            self._kv.set(
                f"{self._kv_prefix()}/nudge", uuid.uuid4().hex.encode()
            )
        except Exception:
            logger.warning("commit_now nudge failed", exc_info=True)
        deadline = time.monotonic() + max(60.0, 4.0 * self.cadence_s)
        with self._cv:
            while self.stats["commits"] < target:
                if self._closed:
                    if self._paused:
                        raise RuntimeError(
                            f"DeltaStream is paused: {self._pause_info}"
                        )
                    err = self._last_error
                    if err is not None:
                        raise RuntimeError(
                            "DeltaStream worker failed during commit_now"
                        ) from err
                    raise RuntimeError("DeltaStream is closed")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        "commit_now timed out waiting for the stream epoch"
                    )
                self._cv.wait(timeout=0.25)
            head = self._member_path(self._head)
        return Snapshot(head, self._storage_options)

    def close(self, final_commit: bool = True) -> Optional[str]:
        """Stop the stream. With ``final_commit`` (the default) a last
        micro-commit captures the state as of close, so nothing since
        the previous cadence tick is lost. Returns the head path.
        Idempotent.

        Multi-process close is a graceful :meth:`leave` — elastic
        membership can't promise every member is at a close() call
        site, so there is no implicit final collective commit; call
        :meth:`commit_now` first for an at-close recovery point. The
        last member out turns the root registration off so a later
        full-world open resumes from storage."""
        if self._multi:
            with self._lock:
                already = self._closed
            if (
                not already
                and final_commit
                and self._last_error is None
                and not self._paused
            ):
                logger.info(
                    "multi-process DeltaStream close takes no implicit "
                    "final commit; call commit_now() first for an "
                    "at-close recovery point"
                )
            head = self.leave()
            try:
                states = self._read_members()
                if not any(s == "joined" for s in states.values()):
                    self._write_reg(live=False)
            except Exception:
                pass
            return head
        with self._cv:
            already = self._closed
            if not already:
                self._closed = True
                self._cv.notify_all()
        if already:
            self._stop_observability()
            return self._member_path(self._head) if self._head else None
        from .io_types import close_may_join

        if close_may_join():
            # Joining is safe only on the explicit-close path: a
            # GC-finalizer close skips the join — the daemon worker
            # observes _closed and exits on its own.
            self._worker.join(timeout=60.0)
        # Drain a capture the worker may have exited without finalizing
        # (mark_step hand-off racing the shutdown).
        with self._cv:
            ctx = self._pending_finalize
            self._pending_finalize = None
        if ctx is not None:
            try:
                self._finalize_capture(ctx)
            except Exception:
                logger.warning(
                    "DeltaStream finalize during close failed (the "
                    "previous head remains the recovery point)",
                    exc_info=True,
                )
            finally:
                with self._cv:
                    self._capture_busy = False
                    self._cv.notify_all()
        if final_commit and self._last_error is None:
            with self._cv:
                while self._capture_busy:
                    self._cv.wait()
                self._capture_busy = True
            try:
                self._commit(kind="delta")
            except Exception:
                logger.warning(
                    "DeltaStream final commit failed (the previous head "
                    "remains the recovery point)",
                    exc_info=True,
                )
            finally:
                with self._cv:
                    self._capture_busy = False
                    self._cv.notify_all()
        self._stop_observability()
        return self._member_path(self._head) if self._head else None

    def __enter__(self) -> "DeltaStream":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # On an exception unwind, skip the final commit: the state may
        # be mid-step garbage; the last committed increment is the
        # honest recovery point.
        self.close(final_commit=exc_type is None)

    def leave(self) -> Optional[str]:
        """Gracefully leave a multi-process stream: finish any epoch
        this rank is already announced into, publish a terminal
        ``left`` membership state (watchers render LEFT, never DEAD —
        no ``RankFailedError``, no degraded epoch), and stop this
        rank's worker. The remaining members re-plan the next capture
        boundary without this rank; it can rejoin later by reopening
        ``Snapshot.stream`` on the same root. On a single-process
        stream this is ``close(final_commit=False)``. Returns the last
        head path this rank observed. Idempotent."""
        if not self._multi:
            return self.close(final_commit=False)
        with self._cv:
            if self._closed:
                return self._member_path(self._head) if self._head else None
            if self._leaving:
                already_leaving = True
            else:
                already_leaving = False
                self._leaving = True
                self._cv.notify_all()
        if not already_leaving:
            # Publish the departure FIRST: the leader re-reads
            # membership immediately before announcing, so no NEW epoch
            # lists this rank after this write. An epoch ALREADY
            # announced with us in its world is honored by the worker
            # before it exits (the _leaving checks in the epoch loop).
            self._set_member_state("left")
            self.stats["leaves"] += 1
            telemetry.incr("delta.stream_leaves")
            flight.record("rank_left", rank=self._rank)
            flight.record(
                "delta", op="stream_leave", stream=self.stream_id,
                rank=self._rank, epoch=self._epoch,
            )
        from .io_types import close_may_join

        if close_may_join():
            # Same join gate as close(): a GC-finalizer leave must not
            # block; the daemon worker observes _leaving and exits.
            self._worker.join(timeout=120.0)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._stop_observability()
        logger.info(
            "rank %d left delta stream %s", self._rank, self.stream_id
        )
        return self._member_path(self._head) if self._head else None

    @property
    def paused(self) -> bool:
        """True when a torn epoch paused the stream (rank failure the
        survivors could not degrade). A paused stream is a NAMED,
        policy-handled event, not a worker failure —
        :meth:`raise_if_failed` stays silent; ``pause_info`` carries
        the forensics. Reopen ``Snapshot.stream`` on the root to
        resume (the torn member salvages on the retake)."""
        with self._lock:
            return self._paused

    @property
    def pause_info(self) -> Optional[Dict[str, Any]]:
        """``{"epoch", "member", "dead_ranks", "detail"}`` of the torn
        epoch that paused the stream, or None."""
        with self._lock:
            return dict(self._pause_info) if self._pause_info else None

    @property
    def members(self) -> List[int]:
        """GLOBAL ranks of the last completed epoch's world (this
        process alone for single-process streams)."""
        with self._lock:
            return list(self._members)

    def raise_if_failed(self) -> None:
        """Re-raise the worker's terminal failure, if any (a failed
        micro-commit stops the stream rather than silently shipping
        stale recovery points forever). A PAUSED stream does not raise
        — check :attr:`paused`."""
        with self._lock:
            err = self._last_error
        if err is not None:
            raise RuntimeError(
                "DeltaStream worker failed; the stream is stopped and the "
                f"last committed increment is the recovery point: {err!r}"
            ) from err

    # ------------------------------------------------------------ internals

    def _member_path(self, name: str) -> str:
        return f"{self.root.rstrip('/')}/{name}"

    # --------------------------------------------- multi-process control KV

    def _kv_prefix(self) -> str:
        return f"{_STREAM_KV_ROOT}/{self.stream_id}"

    def _member_key(self, rank: int) -> str:
        return f"{self._kv_prefix()}/members/{rank}"

    def _ann_key(self, epoch: int) -> str:
        return f"{self._kv_prefix()}/ann/{self._inc}/{epoch}"

    def _reg_key(self) -> str:
        import hashlib

        digest = hashlib.sha1(
            self.root.rstrip("/").encode("utf-8")
        ).hexdigest()[:16]
        return f"{_STREAM_KV_ROOT}_root/{digest}"

    def _read_reg(self) -> Optional[Dict[str, Any]]:
        try:
            raw = self._kv.try_get(self._reg_key())
            return None if raw is None else json.loads(raw.decode("utf-8"))
        except Exception:
            return None

    def _write_reg(self, live: bool) -> None:
        """Root registration: what a later ``Snapshot.stream`` on the
        same root reads to decide join-live vs collective open. Updated
        by the leader after every epoch (so a joiner adopts a current
        head), turned off at pause and by the last member out."""
        try:
            self._kv.set(
                self._reg_key(),
                json.dumps(
                    {
                        "sid": self.stream_id,
                        "inc": self._inc,
                        "live": bool(live),
                        "cadence_s": self.cadence_s,
                        "epoch": self._epoch - 1,
                        "seq": self._seq,
                        "head": self._head,
                    }
                ).encode("utf-8"),
            )
        except Exception:
            logger.debug("stream reg write failed", exc_info=True)

    def _set_member_state(self, state: str, rank: Optional[int] = None) -> None:
        try:
            self._kv.set(
                self._member_key(self._rank if rank is None else rank),
                json.dumps({"state": state, "epoch": self._epoch}).encode(
                    "utf-8"
                ),
            )
        except Exception:
            logger.warning(
                "stream membership write (%s) failed", state, exc_info=True
            )

    def _read_members(self) -> Dict[int, str]:
        """GLOBAL rank -> membership state (joined/left/expired)."""
        out: Dict[int, str] = {}
        blobs = None
        try:
            blobs = self._kv.try_get_dir(f"{self._kv_prefix()}/members/")
        except Exception:
            blobs = None
        if blobs is None:
            # Per-rank probe fallback (a TCPStore cannot list): the world is the
            # superset of every possible member.
            blobs = {}
            for r in range(self._comm.world_size):
                raw = self._kv.try_get(self._member_key(r))
                if raw is not None:
                    blobs[str(r)] = raw
        for key, raw in blobs.items():
            try:
                r = int(key.rsplit("/", 1)[-1])
                out[r] = json.loads(raw.decode("utf-8")).get(
                    "state", "joined"
                )
            except Exception:
                continue
        return out

    def _joined_members(self) -> List[int]:
        membership = self._read_members()
        members = sorted(
            r for r, s in membership.items() if s == "joined"
        )
        if self._rank not in members:
            members = sorted(set(members) | {self._rank})
        return members

    def _nudged(self) -> bool:
        """A commit_now caller (any member) wants the next epoch NOW."""
        try:
            raw = self._kv.try_get(f"{self._kv_prefix()}/nudge")
        except Exception:
            return False
        if raw is not None and raw != self._nudge_seen:
            self._nudge_seen = raw
            return True
        return False

    def _takeover_grace(self) -> float:
        # How long a follower waits past the cadence before presuming
        # the leader dead: several lease TTLs (death detection would
        # have fired inside any in-flight epoch long before), staggered
        # by rank so takeovers don't herd.
        from .knobs import get_liveness_ttl_s

        ttl = get_liveness_ttl_s()
        return max(4.0 * ttl, 10.0) + 0.5 * self._rank

    # ------------------------------------------------- multi-process epochs

    def _run_multi(self) -> None:
        """Elastic epoch loop. The leader — the minimum currently-joined
        global rank — announces each capture epoch over the
        coordination KV; every member polls for the announcement and
        joins the epoch's collective micro-commit over a per-epoch
        :class:`~tpusnap_torch.comm.SubsetComm`. Membership is re-read at
        every announcement, so leaves (graceful or expired) and joins
        re-plan the world at the next capture boundary."""
        while True:
            with self._cv:
                if self._closed:
                    return
            members = self._joined_members()
            try:
                if min(members) == self._rank:
                    alive = self._lead_one_epoch()
                else:
                    alive = self._follow_one_epoch(min(members))
            except Exception as e:  # defensive: never wedge the worker
                self._fail(e, where="elastic epoch loop")
                return
            if not alive:
                return

    def _lead_one_epoch(self) -> bool:
        # Cadence wait, interruptible by close/leave and commit_now
        # nudges (the nudge key is polled, not pushed — the KV has no
        # watch primitive).
        deadline = self._last_commit_mono + self.cadence_s
        while True:
            with self._cv:
                if self._closed:
                    return False
                if self._leaving:
                    return False
            if self._nudged():
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            with self._cv:
                self._cv.wait(timeout=min(remaining, 0.25))
        membership = self._read_members()
        members = sorted(
            r for r, s in membership.items() if s == "joined"
        )
        if self._rank not in members:
            members = sorted(set(members) | {self._rank})
        if min(members) != self._rank:
            # A lower rank (re)joined; it drives from here.
            return True
        prev = set(self._members)
        world: Dict[str, Any] = {"size": len(members), "ranks": members}
        joins = sorted(set(members) - prev)
        leaves = sorted(prev - set(members))
        if joins:
            world["joined"] = joins
        if leaves:
            world["left"] = leaves
            expired = [r for r in leaves if membership.get(r) == "expired"]
            if expired:
                world["expired"] = expired
        ann = {
            "epoch": self._epoch,
            "seq": self._seq + 1,
            "parent": self._head,
            "members": members,
            "world": world,
        }
        self._kv.set(
            self._ann_key(self._epoch),
            json.dumps(ann).encode("utf-8"),
        )
        return self._run_epoch(ann)

    def _follow_one_epoch(self, leader: int) -> bool:
        ann_key = self._ann_key(self._epoch)
        takeover_at = (
            time.monotonic() + self.cadence_s + self._takeover_grace()
        )
        leave_by: Optional[float] = None
        while True:
            with self._cv:
                if self._closed:
                    return False
                leaving = self._leaving
            if leaving and leave_by is None:
                # A leaver must LINGER ~one cadence: the leader may have
                # read membership just before our `left` write landed
                # and announce an epoch that still names us — exiting
                # now would strand it mid-gather. Any membership read
                # after the write excludes us, so at most one such
                # racing announcement exists; serve it if it arrives,
                # then go.
                leave_by = time.monotonic() + self.cadence_s + 2.0
            raw = None
            try:
                raw = self._kv.try_get(ann_key)
            except Exception:
                pass
            if raw is not None:
                break
            if leave_by is not None and time.monotonic() > leave_by:
                # No racing announcement can still list us — done.
                return False
            if not leaving and time.monotonic() > takeover_at:
                # The leader went a full cadence plus several lease
                # TTLs without announcing: presume it dead BETWEEN
                # epochs (an in-flight epoch's liveness would have
                # caught it), expire it and let the next-lowest joined
                # rank (possibly this one) drive.
                self._set_member_state("expired", rank=leader)
                flight.record(
                    "delta", op="leader_takeover", stream=self.stream_id,
                    expired=leader, by=self._rank, epoch=self._epoch,
                )
                logger.warning(
                    "delta stream %s: leader rank %d silent past "
                    "takeover grace; expiring it from the stream",
                    self.stream_id, leader,
                )
                return True
            with self._cv:
                self._cv.wait(timeout=_ANN_POLL_S)
        try:
            ann = json.loads(raw.decode("utf-8"))
        except Exception:
            logger.warning("unparseable epoch announcement; skipping")
            self._epoch += 1
            return True
        if self._rank not in ann.get("members", []):
            # Announced before our join record landed: skip — the next
            # epoch's membership read includes us. seq/head are adopted
            # from the first announcement we DO participate in. A
            # LEAVER seeing itself re-planned out is done for good.
            self._epoch = int(ann["epoch"]) + 1
            return not leaving
        return self._run_epoch(ann)

    def _run_epoch(self, ann: Dict[str, Any]) -> bool:
        """One collective micro-commit over the announced member set.
        Returns False when the stream must stop (close/pause/failure)."""
        from .comm import SubsetComm
        from .dist_store import TakeAbortedError
        from .liveness import RankFailedError

        members = [int(r) for r in ann["members"]]
        epoch = int(ann["epoch"])
        seq = int(ann["seq"])
        with self._cv:
            if self._closed:
                return False
            self._capture_busy = True
        snap = None
        try:
            subset = SubsetComm(
                members,
                namespace=(
                    f"tpusnap/st/{self.stream_id}-{self._inc}-e{epoch}"
                ),
                store=self._comm.store,
                global_rank=self._rank,
            )
            ctx = self._begin_capture(
                "delta",
                seq=seq,
                parent=ann.get("parent"),
                comm=subset,
                world=ann.get("world")
                or {"size": len(members), "ranks": members},
            )
            snap = self._finalize_capture(ctx)
        except RankFailedError as e:
            self._pause_on_rank_failure(e, ann)
            return False
        except TakeAbortedError as e:
            if "RankFailedError" in str(e):
                # A peer detected the death first and published the
                # abort; same torn-epoch outcome on this rank.
                self._pause_on_rank_failure(e, ann)
            else:
                self._fail(e, where=f"elastic micro-commit (epoch {epoch})")
            return False
        except BaseException as e:
            self._fail(e, where=f"elastic micro-commit (epoch {epoch})")
            return False
        finally:
            with self._cv:
                self._capture_busy = False
                self._cv.notify_all()
        # Commit landed (possibly degraded — metadata says which).
        self._members = members
        self._epoch = epoch + 1
        self.stats["epochs"] += 1
        deg = (snap.metadata.extras or {}).get("degraded")
        if deg:
            dead_global = sorted(
                members[v]
                for v in deg.get("dead_ranks", [])
                if 0 <= v < len(members)
            )
            self.stats["degraded_epochs"] += 1
            telemetry.incr("delta.degraded_epochs")
            for r in dead_global:
                self._set_member_state("expired", rank=r)
            flight.record(
                "delta", op="degraded_epoch", stream=self.stream_id,
                epoch=epoch, seq=seq, dead_ranks=dead_global,
            )
            logger.warning(
                "delta stream %s epoch %d committed DEGRADED without "
                "global rank(s) %s; they are expired from the stream "
                "and the next capture re-plans around them",
                self.stream_id, epoch, dead_global,
            )
        if min(members) == self._rank:
            self._write_reg(live=True)
        return True

    def _pause_on_rank_failure(self, exc: BaseException, ann: Dict[str, Any]) -> None:
        """A rank died mid-epoch and the survivors could not degrade
        (sharded state cannot be adopted): the torn epoch keeps its
        salvage substrate and the stream PAUSES — a named,
        policy-handled event, not a worker failure. The committed chain
        stays the recovery point; reopening ``Snapshot.stream`` on the
        root resumes it and the retake salvages the torn member."""
        members = [int(r) for r in ann["members"]]
        ranks = getattr(exc, "ranks", None) or []
        dead_global = sorted(
            {members[v] for v in ranks if 0 <= v < len(members)}
        )
        member = member_name(int(ann["seq"]))
        for r in dead_global:
            self._set_member_state("expired", rank=r)
        with self._cv:
            self._paused = True
            self._pause_info = {
                "epoch": int(ann["epoch"]),
                "member": member,
                "dead_ranks": dead_global or None,
                "detail": str(exc),
            }
            self._closed = True
            self._cv.notify_all()
        telemetry.incr("delta.stream_pauses")
        flight.record(
            "delta", op="stream_pause", stream=self.stream_id,
            epoch=int(ann["epoch"]), member=member,
            dead_ranks=dead_global or None,
        )
        self._write_reg(live=False)
        logger.error(
            "delta stream %s PAUSED: epoch %d (member %s) tore on rank "
            "failure%s and could not commit degraded. The committed "
            "chain is intact; reopen Snapshot.stream on %r after "
            "recovery — the torn member salvages on the retake.",
            self.stream_id,
            int(ann["epoch"]),
            member,
            f" of global rank(s) {dead_global}" if dead_global else "",
            self.root,
        )
        self._stop_observability()

    def _fail(self, exc: BaseException, where: str) -> None:
        """Stop the stream on a terminal failure (the last committed
        increment remains the recovery point); raise_if_failed()
        surfaces the cause to the caller."""
        logger.error(
            "DeltaStream %s failed; stopping the stream (the last "
            "committed increment remains the recovery point)",
            where,
            exc_info=True,
        )
        with self._cv:
            self._last_error = exc
            self._closed = True
            self._cv.notify_all()
        self._stop_observability()

    def _stop_observability(self) -> None:
        """Idempotent teardown of the stream's observability footprint
        (the stream's close record in the flight log), whatever stopped
        the stream."""
        with self._lock:
            if self._observability_stopped:
                return
            self._observability_stopped = True
        flight.record(
            "delta", op="stream_close", stream=self.stream_id,
            commits=self.stats["commits"],
        )

    def _run(self) -> None:
        """Worker loop: finalize captures handed off by mark_step (wait
        out their background commit drains), wake at cadence, capture
        here (free-running) or defer to the next mark_step (step-gated,
        with a one-cadence grace so a stalled training loop cannot
        suspend checkpointing forever). Multi-process streams run the
        elastic epoch loop instead — captures are announcement-driven
        and always run here on the worker (the collective rendezvous
        inside the take is the cross-rank step synchronizer; mark_step
        still feeds stats)."""
        if self._device is not None:
            # The capturing thread's device (set_device is per thread).
            torch.cuda.set_device(self._device)
        if self._multi:
            self._run_multi()
            return
        while True:
            with self._cv:
                ctx = self._pending_finalize
                self._pending_finalize = None
            if ctx is not None:
                # A mark_step capture: wait out its background commit
                # drain + bookkeeping/compaction here, off the training
                # thread.
                try:
                    self._finalize_capture(ctx)
                except Exception as e:
                    self._fail(e, where="micro-commit")
                    return
                finally:
                    with self._cv:
                        self._capture_busy = False
                        self._cv.notify_all()
                continue
            with self._cv:
                deadline = self._last_commit_mono + self.cadence_s
                while not self._closed and self._pending_finalize is None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=min(remaining, 0.5))
                if self._pending_finalize is not None:
                    continue
                if self._closed:
                    return
                if self._capture_busy:
                    # A commit_now (or an in-flight mark_step capture)
                    # owns the slot; check back shortly rather than
                    # stacking a second commit on top.
                    self._cv.wait(timeout=0.05)
                    continue
                if self._step_gated:
                    # Hand the capture to the training thread: the next
                    # mark_step performs it at a step boundary.
                    self._commit_due = True
                    grace = time.monotonic() + self.cadence_s
                    while (
                        not self._closed
                        and self._commit_due
                        and time.monotonic() < grace
                    ):
                        self._cv.wait(timeout=0.05)
                    if self._closed:
                        return
                    if not self._commit_due:
                        # mark_step took it (or a commit_now raced in);
                        # loop to the top — the hand-off pickup and the
                        # next interval live there.
                        continue
                    # Grace expired: training loop stalled mid-step (or
                    # stopped calling mark_step) — a bounded RPO beats
                    # step consistency; fall through to a free-running
                    # capture.
                    self._commit_due = False
                self._capture_busy = True
            try:
                self._commit(kind="delta")
            except Exception as e:
                self._fail(e, where="micro-commit")
                return
            finally:
                with self._cv:
                    self._capture_busy = False
                    self._cv.notify_all()

    def _commit(self, kind: str):
        """One full micro-commit on THIS thread (capture + commit drain
        + bookkeeping). commit_now/close/base use it; mark_step splits
        it into _begin_capture (training thread) + _finalize_capture
        (worker)."""
        return self._finalize_capture(self._begin_capture(kind))

    def _begin_capture(
        self,
        kind: str,
        *,
        seq: Optional[int] = None,
        parent: Optional[str] = None,
        comm: Optional[Communicator] = None,
        world: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """The capture half: state_dict + strict dual-hash staging.
        When this returns, the content is FROZEN (incremental takes
        stage everything before async_take returns) and the caller may
        mutate state again; the storage writes + two-phase commit drain
        on the take's own background thread. Caller holds the
        _capture_busy slot (or is __init__).

        Elastic epochs pass ``seq``/``parent`` from the announcement
        (authoritative — a joiner's local view may lag), ``comm`` the
        per-epoch :class:`~tpusnap_torch.comm.SubsetComm`, and ``world`` the
        participating world recorded into ``extras["delta"]`` (and
        thus the take journal, so even a torn epoch names it)."""
        t0 = time.monotonic()
        if seq is None:
            with self._lock:
                seq = self._seq if kind == "base" else self._seq + 1
                parent = self._head
        take_comm = comm if comm is not None else self._comm
        if world is None and self._multi:
            world = {
                "size": take_comm.world_size,
                "ranks": sorted(self._members),
            }
        name = member_name(seq)
        path = self._member_path(name)
        delta_extras: Dict[str, Any] = {
            "stream": self.stream_id,
            "seq": seq,
            "parent": parent,
        }
        if world:
            delta_extras["world"] = world
        extras = {"delta": delta_extras}
        ctx: Dict[str, Any] = {"kind": kind, "t0": t0, "seq": seq,
                               "name": name}
        with self._ordered():
            # Off the training thread the state may change under the
            # capture: freeze its CUDA tensors in the training stream's
            # order first (blob grain). On it, the caller is at a step
            # boundary and the strict staging holds the whole state.
            app_state = self._app_state
            if self._streams and threading.get_ident() != self._owner_thread:
                app_state = _freeze_in_stream(app_state)
            self._take_capture(ctx, kind, path, app_state, take_comm, parent, extras)
        return ctx

    @contextlib.contextmanager
    def _ordered(self):
        """The state's device and the training streams current on this
        thread, so the take's ready events (and, off the training thread,
        the freeze's copies) are queued in training's order."""
        with contextlib.ExitStack() as stack:
            if self._device is not None:
                stack.enter_context(torch.cuda.device(self._device))
            for stream in self._streams.values():
                stack.enter_context(torch.cuda.stream(stream))
            yield

    def _take_capture(self, ctx, kind, path, app_state, take_comm, parent, extras) -> None:
        from .snapshot import Snapshot

        if kind == "base":
            # Full base, tile-grain dedup hashes recorded everywhere.
            ctx["snap"] = Snapshot.take(
                path,
                app_state,
                replicated=self._replicated,
                storage_options=self._storage_options,
                comm=take_comm,
                _extras=extras,
                _record_dedup_hashes=True,
            )
        else:
            # Micro-commits force DEFENSIVE-CLONE staging (not the
            # process-wide TPUSNAP_ASYNC_COW default): the stream's
            # whole point is that training keeps mutating while the
            # drain runs, with no wait_staged() rendezvous — under COW
            # every free-running capture would fail on the write-time
            # mutation check. Per-take parameter, not an env override:
            # a global flip would race concurrent takes on other
            # threads into silently paying the full clone pass.
            ctx["pending"] = Snapshot.async_take(
                path,
                app_state,
                replicated=self._replicated,
                storage_options=self._storage_options,
                comm=take_comm,
                incremental_from=self._member_path(parent),
                _extras=extras,
                _record_dedup_hashes=True,
                _force_clone_staging=True,
                # Arms the degraded-commit context for this incremental
                # async take (see the _take_impl gate): the force-clone
                # staging above is exactly what makes adoption safe.
                _stream_capture=True,
            )

    def _finalize_capture(self, ctx: Dict[str, Any]):
        """The commit half: wait out the background drain (ONE commit in
        flight at a time — the capture slot is held until this returns),
        then head/chain bookkeeping and compaction."""
        kind, t0, seq = ctx["kind"], ctx["t0"], ctx["seq"]
        name = ctx["name"]
        snap = ctx.get("snap")
        if snap is None:
            snap = ctx["pending"].wait()
        wall = time.monotonic() - t0
        written = 0
        try:
            written = delta_payload_bytes(snap.metadata)
        except Exception:
            logger.debug("delta payload accounting failed", exc_info=True)
        telemetry.incr("delta.commits")
        if written:
            telemetry.incr("delta.bytes_written", written)
        with self._lock:
            interval = (
                time.monotonic() - self._last_commit_mono
                if self._last_commit_mono
                else None
            )
            self._last_commit_mono = time.monotonic()
            self._seq = seq
            self._head = name
            self._chain.append(name)
            st = self.stats
            st["commits"] += 1
            st["bytes_written_total"] += written
            st["last_commit_bytes"] = written
            st["last_commit_wall_s"] = round(wall, 4)
            if interval is not None:
                st["max_commit_interval_s"] = max(
                    st["max_commit_interval_s"] or 0.0, round(interval, 4)
                )
            chain_len = len(self._chain)
            # commit_now waiters (multi) watch stats["commits"].
            self._cv.notify_all()
        flight.record(
            "delta",
            op="micro_commit" if kind != "base" else "base_commit",
            stream=self.stream_id,
            seq=seq,
            bytes=written,
            wall_s=round(wall, 4),
        )
        if chain_len > self.max_chain:
            if self._multi:
                # Compaction (materialize + retire) is a single-writer
                # job; with every member holding a handle it would
                # race. Leave long multi-process chains to `lifecycle.gc_snapshot`
                # or an explicit maintenance materialize.
                logger.debug(
                    "multi-process stream chain depth %d exceeds "
                    "max_chain=%d; compaction is single-process only",
                    chain_len, self.max_chain,
                )
            else:
                self._compact(snap)
        return snap

    def _compact(self, head_snap) -> None:
        """Chain compaction via the existing materialize path: the head
        becomes self-contained (referenced base blobs copied in,
        checksum-verified, metadata rewritten atomically — a crash
        mid-copy leaves the old metadata and the chain intact), then
        the superseded members are retired. Local-fs roots delete them;
        other backends leave them for `gc`/bucket lifecycle rules."""
        t0 = time.monotonic()
        stats = head_snap.materialize()
        with self._lock:
            head = self._head
            superseded = [m for m in self._chain if m != head]
            self._chain = [head]
        telemetry.incr("delta.compactions")
        flight.record(
            "delta",
            op="compact",
            stream=self.stream_id,
            head=head,
            bytes_copied=stats.get("bytes_copied", 0),
            retired=len(superseded),
            wall_s=round(time.monotonic() - t0, 4),
        )
        self.stats["compactions"] += 1
        parts = urlsplit(self.root)
        if parts.scheme not in ("", "file"):
            logger.info(
                "Delta chain compacted at %r; %d superseded member(s) left "
                "for bucket lifecycle rules / `lifecycle.gc_snapshot`",
                self.root,
                len(superseded),
            )
            return
        import os
        import shutil

        root = os.path.abspath(parts.path or self.root)
        for name in superseded:
            target = os.path.join(root, name)
            # Metadata first: a retire interrupted mid-delete leaves a
            # directory that can never be mistaken for a committed
            # snapshot (resolve_chain reports it as debris; the
            # crash-matrix covers this window).
            try:
                meta = os.path.join(target, ".snapshot_metadata")
                if os.path.exists(meta):
                    os.unlink(meta)
                shutil.rmtree(target, ignore_errors=True)
            except OSError:
                logger.warning(
                    "Failed to retire superseded member %r (reclaim via "
                    "`lifecycle.gc_snapshot` later)",
                    target,
                    exc_info=True,
                )
