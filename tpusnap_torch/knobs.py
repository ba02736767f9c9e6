"""Tunable knobs read from the environment — the subset the port's
take/restore paths consult.

Counterpart of tpusnap/knobs.py. The names stay ``TPUSNAP_*`` so one
environment configures either package; the defaults are tpusnap's
(512 MB max chunk and shard, 128 MB slab threshold, 16 MiB checksum
tiles, 2 GiB async staging window, COW async staging on, 4 GiB staging
pool, ``TPUSNAP_COMPRESS=auto``).
"""

import contextlib
import logging
import os
import threading
from typing import Dict, Generator, Optional

logger = logging.getLogger(__name__)

_MAX_CHUNK_SIZE_ENV_VAR = "TPUSNAP_MAX_CHUNK_SIZE_BYTES"
_SLAB_SIZE_THRESHOLD_ENV_VAR = "TPUSNAP_SLAB_SIZE_THRESHOLD_BYTES"
_DISABLE_BATCHING_ENV_VAR = "TPUSNAP_DISABLE_BATCHING"
_MEMORY_BUDGET_ENV_VAR = "TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES"
_DISABLE_NATIVE_ENV_VAR = "TPUSNAP_DISABLE_NATIVE"
_DISABLE_DIRECT_IO_ENV_VAR = "TPUSNAP_DISABLE_DIRECT_IO"
_DISABLE_DONTCACHE_ENV_VAR = "TPUSNAP_DISABLE_DONTCACHE"
_DISABLE_CHECKSUM_ENV_VAR = "TPUSNAP_DISABLE_CHECKSUM"
_DIRECT_IO_QD_ENV_VAR = "TPUSNAP_DIRECT_IO_QD"
_DIRECT_IO_CHUNK_ENV_VAR = "TPUSNAP_DIRECT_IO_CHUNK_BYTES"
_TILE_CHECKSUM_ENV_VAR = "TPUSNAP_TILE_CHECKSUM_BYTES"
_STAGE_THREADS_ENV_VAR = "TPUSNAP_STAGE_THREADS"
_COMPRESS_ENV_VAR = "TPUSNAP_COMPRESS"
_CAS_DIR_ENV_VAR = "TPUSNAP_CAS_DIR"
_CAS_GRACE_ENV_VAR = "TPUSNAP_CAS_GRACE_S"
_CAS_LEASE_TTL_ENV_VAR = "TPUSNAP_CAS_LEASE_TTL_S"
_CAS_REMOTE_ENV_VAR = "TPUSNAP_CAS_REMOTE"
_DELTA_CADENCE_ENV_VAR = "TPUSNAP_DELTA_CADENCE_S"
_DELTA_MAX_CHAIN_ENV_VAR = "TPUSNAP_DELTA_MAX_CHAIN"
_TIER_DRAIN_ENV_VAR = "TPUSNAP_TIER_DRAIN"
_TIER_OP_DEADLINE_ENV_VAR = "TPUSNAP_TIER_OP_DEADLINE_S"
_TIER_OUTAGE_THRESHOLD_ENV_VAR = "TPUSNAP_TIER_OUTAGE_THRESHOLD"
_TIER_BACKOFF_CAP_ENV_VAR = "TPUSNAP_TIER_BACKOFF_CAP_S"
_TIER_LOCAL_RETENTION_ENV_VAR = "TPUSNAP_TIER_LOCAL_RETENTION_S"
_ASYNC_STAGE_WINDOW_ENV_VAR = "TPUSNAP_ASYNC_STAGE_WINDOW_BYTES"
_ASYNC_COW_ENV_VAR = "TPUSNAP_ASYNC_COW"
_STAGING_POOL_ENV_VAR = "TPUSNAP_STAGING_POOL_BYTES"
_COMPRESS_MIN_BLOB_ENV_VAR = "TPUSNAP_COMPRESS_MIN_BLOB_BYTES"
_RECORD_DEDUP_HASHES_ENV_VAR = "TPUSNAP_RECORD_DEDUP_HASHES"
_SCRUB_CONCURRENCY_ENV_VAR = "TPUSNAP_SCRUB_CONCURRENCY"
_BARRIER_TIMEOUT_ENV_VAR = "TPUSNAP_BARRIER_TIMEOUT_S"
_NODE_NAME_ENV_VAR = "TPUSNAP_NODE_NAME"
_DISABLE_PARTITIONER_ENV_VAR = "TPUSNAP_DISABLE_PARTITIONER"
_MAX_SHARD_SIZE_ENV_VAR = "TPUSNAP_MAX_SHARD_SIZE_BYTES"
_DISABLE_DEVICE_BATCHING_ENV_VAR = "TPUSNAP_DISABLE_DEVICE_BATCHING"
_DURABLE_COMMIT_ENV_VAR = "TPUSNAP_DURABLE_COMMIT"
_RANK_FAILURE_ENV_VAR = "TPUSNAP_RANK_FAILURE"
_DISABLE_JOURNAL_ENV_VAR = "TPUSNAP_DISABLE_JOURNAL"
_TELEMETRY_ENV_VAR = "TPUSNAP_TELEMETRY"
_LOCKCHECK_ENV_VAR = "TPUSNAP_LOCKCHECK"
_STALL_DEADLINE_ENV_VAR = "TPUSNAP_STALL_DEADLINE_S"
_HEARTBEAT_INTERVAL_ENV_VAR = "TPUSNAP_HEARTBEAT_INTERVAL_S"
_TELEMETRY_DIR_ENV_VAR = "TPUSNAP_TELEMETRY_DIR"
_FLIGHT_ENV_VAR = "TPUSNAP_FLIGHT"
_FLIGHT_RING_ENV_VAR = "TPUSNAP_FLIGHT_RING"
_FLIGHT_FLUSH_ENV_VAR = "TPUSNAP_FLIGHT_FLUSH_S"
_LIVENESS_TTL_ENV_VAR = "TPUSNAP_LIVENESS_TTL_S"
_JOB_ID_ENV_VAR = "TPUSNAP_JOB_ID"
_FAULT_SPEC_ENV_VAR = "TPUSNAP_FAULT_SPEC"
_METRICS_EXPORT_ENV_VAR = "TPUSNAP_METRICS_EXPORT"
_METRICS_DIR_ENV_VAR = "TPUSNAP_METRICS_DIR"
_HISTORY_ENV_VAR = "TPUSNAP_HISTORY"
_HISTORY_MAX_BYTES_ENV_VAR = "TPUSNAP_HISTORY_MAX_BYTES"
_ACCESS_LEDGER_ENV_VAR = "TPUSNAP_ACCESS_LEDGER"
_ACCESS_LEDGER_MAX_BYTES_ENV_VAR = "TPUSNAP_ACCESS_LEDGER_MAX_BYTES"
_PROBE_ENV_VAR = "TPUSNAP_PROBE"
_PROBE_INTERVAL_ENV_VAR = "TPUSNAP_PROBE_INTERVAL_BYTES"
_PROBE_BYTES_ENV_VAR = "TPUSNAP_PROBE_BYTES"
_AUTOTUNE_ENV_VAR = "TPUSNAP_AUTOTUNE"
_SLO_RPO_ENV_VAR = "TPUSNAP_SLO_RPO_S"
_SLO_RTO_ENV_VAR = "TPUSNAP_SLO_RTO_S"
_SLO_STREAM_CADENCE_X_ENV_VAR = "TPUSNAP_SLO_STREAM_CADENCE_X"
_FLEET_DIR_ENV_VAR = "TPUSNAP_FLEET_DIR"

_DEFAULT_MAX_CHUNK_SIZE_BYTES = 512 * 1024 * 1024
_DEFAULT_MAX_SHARD_SIZE_BYTES = 512 * 1024 * 1024
_DEFAULT_SLAB_SIZE_THRESHOLD_BYTES = 128 * 1024 * 1024
_DEFAULT_DIRECT_IO_QD = 2
_DEFAULT_DIRECT_IO_CHUNK_BYTES = 32 * 1024 * 1024
_DEFAULT_TILE_CHECKSUM_BYTES = 16 * 1024 * 1024
_DEFAULT_ASYNC_STAGE_WINDOW_BYTES = 2 * 1024 * 1024 * 1024
_DEFAULT_STAGING_POOL_BYTES = 4 * 1024 * 1024 * 1024
# In-take roofline probes: one probe segment per this many payload bytes,
# each writing (and reading back) this many raw bytes through the take's
# own plugin stack (about 3 % of the take's I/O at the defaults).
_DEFAULT_PROBE_INTERVAL_BYTES = 2 * 1024 * 1024 * 1024
_DEFAULT_PROBE_BYTES = 64 * 1024 * 1024


# ------------------------------------------------- tuned-plan overlay
#
# The tuner's seam (``TPUSNAP_AUTOTUNE=1``, ``tune.maybe_apply``): an
# applied plan's knob values live here, one layer below the environment.
# Every knob lookup goes through ``_env_get``, which reads the
# environment first, so an explicitly set variable always beats the
# tuner, and nothing of the plan leaks into ``os.environ`` (or into child
# processes).
_tuned_lock = threading.Lock()
_tuned_overlay: Dict[str, str] = {}
_tuned_plan_id: Optional[str] = None


def apply_tuned_plan(plan_id: str, knobs: Dict[str, str]) -> Dict[str, str]:
    """Install a tuner plan's knob values as the fallback layer. Knobs
    the environment already sets are skipped (explicit env always wins).
    Returns the subset applied: what the take or restore stamps into its
    history event as ``tuned.knobs``."""
    applied: Dict[str, str] = {}
    with _tuned_lock:
        global _tuned_plan_id
        _tuned_overlay.clear()
        for name, value in knobs.items():
            if name in os.environ:
                continue
            _tuned_overlay[name] = str(value)
            applied[name] = str(value)
        _tuned_plan_id = plan_id if applied else None
    return applied


def clear_tuned_plan() -> None:
    with _tuned_lock:
        global _tuned_plan_id
        _tuned_overlay.clear()
        _tuned_plan_id = None


def tuned_plan() -> Optional[Dict[str, object]]:
    """The applied plan (``{plan_id, knobs}``) or None."""
    with _tuned_lock:
        if _tuned_plan_id is None or not _tuned_overlay:
            return None
        return {"plan_id": _tuned_plan_id, "knobs": dict(_tuned_overlay)}


def _env_get(name: str, default: Optional[str] = None) -> Optional[str]:
    """Knob lookup: the explicit environment first, then the applied
    tuner plan, then the default."""
    val = os.environ.get(name)
    if val is not None:
        return val
    with _tuned_lock:
        val = _tuned_overlay.get(name)
    return val if val is not None else default


def _get_int_env(name: str, default: int) -> int:
    val = _env_get(name)
    if val is None:
        return default
    try:
        return int(val)
    except ValueError:
        logger.warning("Ignoring non-integer %s=%r", name, val)
        return default


def _get_float_env(name: str, default: float) -> float:
    val = _env_get(name)
    if val is None:
        return default
    try:
        return float(val)
    except ValueError:
        logger.warning("Ignoring non-numeric %s=%r", name, val)
        return default


def _flag(name: str) -> bool:
    return _env_get(name, "0") == "1"


def get_max_chunk_size_bytes() -> int:
    return _get_int_env(_MAX_CHUNK_SIZE_ENV_VAR, _DEFAULT_MAX_CHUNK_SIZE_BYTES)


def get_max_shard_size_bytes() -> int:
    """Sharded (DTensor) blobs above this size are split along their
    largest dim, at the stored dtype's width."""
    return _get_int_env(_MAX_SHARD_SIZE_ENV_VAR, _DEFAULT_MAX_SHARD_SIZE_BYTES)


def get_slab_size_threshold_bytes() -> int:
    return _get_int_env(
        _SLAB_SIZE_THRESHOLD_ENV_VAR, _DEFAULT_SLAB_SIZE_THRESHOLD_BYTES
    )


def is_batching_disabled() -> bool:
    return _flag(_DISABLE_BATCHING_ENV_VAR)


def is_device_batching_disabled() -> bool:
    """CUDA slab members are packed on the host, each with its own
    device-to-host copy, instead of in one pack on the card."""
    return _flag(_DISABLE_DEVICE_BATCHING_ENV_VAR)


def is_native_disabled() -> bool:
    return _flag(_DISABLE_NATIVE_ENV_VAR)


def is_direct_io_disabled() -> bool:
    return _flag(_DISABLE_DIRECT_IO_ENV_VAR)


def is_dontcache_disabled() -> bool:
    return _flag(_DISABLE_DONTCACHE_ENV_VAR)


def is_checksum_disabled() -> bool:
    return _flag(_DISABLE_CHECKSUM_ENV_VAR)


def get_direct_io_qd() -> int:
    return _get_int_env(_DIRECT_IO_QD_ENV_VAR, _DEFAULT_DIRECT_IO_QD)


def get_direct_io_chunk_bytes() -> int:
    return _get_int_env(_DIRECT_IO_CHUNK_ENV_VAR, _DEFAULT_DIRECT_IO_CHUNK_BYTES)


def get_tile_checksum_bytes() -> int:
    return _get_int_env(_TILE_CHECKSUM_ENV_VAR, _DEFAULT_TILE_CHECKSUM_BYTES)


def get_stage_threads() -> int:
    """Worker threads of the write scheduler's staging executor (default
    1, clamped to [1, 16])."""
    return max(1, min(16, _get_int_env(_STAGE_THREADS_ENV_VAR, 1)))


def get_native_copy_threads() -> int:
    """Internal threads of one native copy/hash pass, so that stage
    threads x this stays about 4: past that the memory system is
    saturated and more copy threads only contend."""
    return max(1, 4 // get_stage_threads())


def get_async_stage_window_bytes() -> Optional[int]:
    """Staging window of a pipelined ``async_take``: control returns once
    the first window of write requests is staged, and the background
    drain stages the rest under this in-flight bound. ``0`` (returned
    as None) is strict mode: the whole state stages before the return."""
    val = _get_int_env(_ASYNC_STAGE_WINDOW_ENV_VAR, _DEFAULT_ASYNC_STAGE_WINDOW_BYTES)
    return val if val > 0 else None


def is_async_cow_enabled() -> bool:
    """Copy-on-write async staging of host-aliasing tensors (CPU tensors),
    on by default: the blocked window hashes the live bytes instead of
    cloning them, and the write path re-hashes after the storage write; a
    mismatch (the caller mutated the tensor mid-take) fails the take.
    ``TPUSNAP_ASYNC_COW=0`` restores the defensive clone."""
    return _env_get(_ASYNC_COW_ENV_VAR, "1") != "0"


def get_staging_pool_bytes() -> int:
    """Cap on the reusable clone-buffer pool (``_staging_pool``); 0
    disables it."""
    return max(0, _get_int_env(_STAGING_POOL_ENV_VAR, _DEFAULT_STAGING_POOL_BYTES))


def get_memory_budget_override_bytes() -> Optional[int]:
    """``TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES`` when set to a
    positive integer, else None (the budget is derived from host RAM)."""
    if _env_get(_MEMORY_BUDGET_ENV_VAR) is None:
        return None
    val = _get_int_env(_MEMORY_BUDGET_ENV_VAR, -1)
    return val if val > 0 else None


_KNOWN_COMPRESS_MODES = ("auto", "on", "off", "lz4")
_warned_compress_modes: set = set()


def get_compress_mode() -> str:
    """Per-take fused tile compression (``compress``): ``auto`` (the
    default) compresses when the storage pipe's measured ceiling is
    clearly slower than the codec's measured throughput, ``on`` compresses
    every eligible blob, ``off`` bypasses, ``lz4`` pins the codec family
    (the same as ``on`` today). Unknown values warn once per process and
    fall back to ``auto``."""
    raw = (_env_get(_COMPRESS_ENV_VAR) or "auto").strip().lower()
    if raw not in _KNOWN_COMPRESS_MODES:
        if raw not in _warned_compress_modes:
            _warned_compress_modes.add(raw)
            logger.warning(
                "Ignoring unknown %s=%r (known: %s); using auto",
                _COMPRESS_ENV_VAR,
                raw,
                ", ".join(_KNOWN_COMPRESS_MODES),
            )
        return "auto"
    return raw


def get_compress_min_blob_bytes() -> int:
    """Blobs smaller than this bypass the codec (floor 64 KiB, default
    1 MiB)."""
    return max(64 * 1024, _get_int_env(_COMPRESS_MIN_BLOB_ENV_VAR, 1024 * 1024))


def is_dedup_hash_recording_forced() -> bool:
    """Record 64-bit per-tile dedup hashes on every take, not only on
    incremental ones: set on the full base take of a planned incremental
    chain so that its first increment already dedups at tile grain."""
    return _flag(_RECORD_DEDUP_HASHES_ENV_VAR)


def get_scrub_concurrency() -> int:
    """Blob ranges ``verify`` keeps in flight (default 4)."""
    return max(1, _get_int_env(_SCRUB_CONCURRENCY_ENV_VAR, 4))


def get_barrier_timeout_s() -> float:
    """Deadline of every blocking collective or KV-store wait (the
    communicator's barriers and gathers, ``LinearBarrier``, ``KVStore.get``)
    and the timeout set on the communicator's store. Default 600 s, floor
    1 s."""
    return max(1.0, _get_float_env(_BARRIER_TIMEOUT_ENV_VAR, 600.0))


def get_commit_barrier_timeout_s() -> float:
    """Deadline of the async commit's ``LinearBarrier`` waits: 3x the
    collective timeout (the commit waits on every rank's whole write
    drain, not one round trip)."""
    return 3.0 * get_barrier_timeout_s()


def get_node_name() -> str:
    """Which host this process runs on, for the per-host memory-budget
    divisor: ``TPUSNAP_NODE_NAME`` or the OS hostname (the variable
    serves containers that each report their own hostname on one node,
    and simulated multi-host tests)."""
    import socket

    return _env_get(_NODE_NAME_ENV_VAR) or socket.gethostname()


def is_partitioner_disabled() -> bool:
    """Every rank writes its own copy of each replicated value (the
    write-load partitioner is bypassed; the manifest is the same)."""
    return _flag(_DISABLE_PARTITIONER_ENV_VAR)


def is_durable_commit_enabled() -> bool:
    """Make a returned take survive power loss: every blob file is
    fsync'd after its write, every rank fsyncs the directories its
    storage plugin created before the commit barrier, and the metadata
    commit fsyncs its temp file, renames, then fsyncs its directory. Off
    by default: the fsyncs after a multi-GB take force the device to
    flush everything just written. Without it the commit is still
    crash-safe (temp + rename: never torn, at worst invisible)."""
    return _flag(_DURABLE_COMMIT_ENV_VAR)


_KNOWN_RANK_FAILURE_POLICIES = ("abort", "degrade")
_warned_rank_failure_policies: set = set()


def get_rank_failure_policy() -> str:
    """What a multi-process take does when a peer dies mid-take:
    ``abort`` (the default) or ``degrade`` (the survivors complete a
    take whose dead rank held only replicated writes). Unknown values
    warn once per process and fall back to ``abort``."""
    raw = _env_get(_RANK_FAILURE_ENV_VAR, "abort").strip().lower()
    if raw not in _KNOWN_RANK_FAILURE_POLICIES:
        if raw not in _warned_rank_failure_policies:
            _warned_rank_failure_policies.add(raw)
            logger.warning(
                "Ignoring unknown %s=%r (known: %s); using abort",
                _RANK_FAILURE_ENV_VAR,
                raw,
                ", ".join(_KNOWN_RANK_FAILURE_POLICIES),
            )
        return "abort"
    return raw


def get_cas_dir() -> Optional[str]:
    """The shared content-addressed blob store (``cas``): a directory or
    a storage URL every CAS-composed take publishes payload blobs into,
    keyed by their (CRC32C, XXH64) pair. When set, a plain ``fs`` take
    is composed with the CAS layer (as ``cas+fs://`` is). Unset: off."""
    return _env_get(_CAS_DIR_ENV_VAR) or None


def get_cas_grace_s() -> float:
    """Grace window of the store's mark-and-sweep gc: unmarked blobs,
    stale intents, torn ``.tmp.*`` leftovers and stale roots are swept
    only once at least this old (a young one may be a publisher whose
    ref record has not landed yet)."""
    return max(0.0, _get_float_env(_CAS_GRACE_ENV_VAR, 900.0))


def get_cas_lease_ttl_s() -> float:
    """TTL of the store's gc lock lease: a second sweeper is refused
    while a live lease exists; an abandoned one is stealable this old."""
    return max(0.5, _get_float_env(_CAS_LEASE_TTL_ENV_VAR, 60.0))


def get_cas_remote() -> Optional[str]:
    """Remote mirror of the store: the tier drain uploads each unique
    blob once to ``<remote>/blobs/<key>`` and store reads fall back to
    it for evicted blobs. Unset: the store is local only."""
    return _env_get(_CAS_REMOTE_ENV_VAR) or None


def get_delta_cadence_s() -> float:
    """Default micro-commit cadence of a delta stream (``Snapshot.stream``
    without ``cadence_s``): one journaled incremental snapshot per
    interval bounds the recovery point. Floor 0.1 s."""
    return max(0.1, _get_float_env(_DELTA_CADENCE_ENV_VAR, 5.0))


def get_delta_max_chain() -> int:
    """Chain length past which a delta stream compacts: the head is
    materialized into a self-contained base and the superseded members
    retired. Clamped to [2, 1024]."""
    return max(2, min(1024, _get_int_env(_DELTA_MAX_CHAIN_ENV_VAR, 8)))


def is_tier_drain_enabled() -> bool:
    """Background drain of the write-back tier: on by default (a tiered
    take commits locally and an uploader thread drains it to the remote).
    ``0`` leaves takes ``local-committed`` until drained explicitly."""
    return _env_get(_TIER_DRAIN_ENV_VAR, "1") != "0"


def get_tier_op_deadline_s() -> float:
    """Per-op retry deadline of the uploader's remote plugin: past it the
    retry layer gives up and the uploader's outage circuit takes over."""
    return max(0.05, _get_float_env(_TIER_OP_DEADLINE_ENV_VAR, 60.0))


def get_tier_outage_threshold() -> int:
    """Consecutive failed remote uploads before the uploader's circuit
    opens (degraded mode: capped, jittered backoff between probes)."""
    return max(1, _get_int_env(_TIER_OUTAGE_THRESHOLD_ENV_VAR, 3))


def get_tier_backoff_cap_s() -> float:
    """Cap on the uploader's backoff between probes during an outage."""
    return max(0.05, _get_float_env(_TIER_BACKOFF_CAP_ENV_VAR, 30.0))


def get_tier_local_retention_s() -> float:
    """``gc --evict-local`` reclaims a remote-durable snapshot's local
    blobs only once its durable marker is at least this old (0: at once)."""
    return max(0.0, _get_float_env(_TIER_LOCAL_RETENTION_ENV_VAR, 0.0))


def is_journal_disabled() -> bool:
    """The crash-safe take journal (``lifecycle``) is on by default: rank
    0 marks the take before any blob write and every rank records a
    CRC32C+XXH64 completion record per blob (the salvage evidence).
    ``TPUSNAP_DISABLE_JOURNAL=1`` turns it off, for A/B measurement: a
    crashed take then reads as foreign and a retake starts from zero."""
    return _flag(_DISABLE_JOURNAL_ENV_VAR)


def is_lockcheck_enabled() -> bool:
    """Runtime lock-order watchdog (:mod:`tpusnap_torch.devtools.lockwatch`),
    OPT-IN via ``TPUSNAP_LOCKCHECK=1``: every ``threading.Lock``/
    ``RLock`` created after import is wrapped to record the per-thread
    held-lock stack and a global lock-order graph; AB/BA cycles
    (potential deadlocks) and locks held across storage I/O are
    reported at process exit and via the lockwatch API. Off by default:
    the instrumentation adds a pure-Python hop to every lock
    acquisition. Read at import, before any tuner plan exists. The test
    suite enables it so the whole suite doubles as a deadlock
    detector."""
    return os.environ.get(_LOCKCHECK_ENV_VAR, "0") == "1"


def is_telemetry_enabled() -> bool:
    """Per-take span capture, persisted traces and the heartbeat pump
    (``telemetry``, ``progress``): on by default. ``TPUSNAP_TELEMETRY=0``
    turns spans, traces, heartbeats and rank-liveness leases off;
    counters stay on either way."""
    return _env_get(_TELEMETRY_ENV_VAR, "1") != "0"


def get_stall_deadline_s() -> float:
    """No-progress window after which the stall watchdog warns, naming
    the blocked op and the ranks not yet arrived (default 30 s)."""
    return max(0.1, _get_float_env(_STALL_DEADLINE_ENV_VAR, 30.0))


def get_heartbeat_interval_s() -> float:
    """Cadence of the heartbeat pump (default 0.5 s, floor 0.02 s)."""
    return max(0.02, _get_float_env(_HEARTBEAT_INTERVAL_ENV_VAR, 0.5))


def get_telemetry_dir() -> str:
    """Local directory for telemetry that cannot live in a snapshot
    (restore traces, local flight copies): ``TPUSNAP_TELEMETRY_DIR`` or a
    per-user directory under the system temp dir."""
    import tempfile

    uid = os.getuid() if hasattr(os, "getuid") else "u"
    return _env_get(_TELEMETRY_DIR_ENV_VAR) or os.path.join(
        tempfile.gettempdir(), f"tpusnap-telemetry-{uid}"
    )


def is_flight_enabled() -> bool:
    """The flight recorder (``flight``): a bounded ring of events flushed
    to ``.tpusnap/flight/`` at the heartbeat cadence. On by default;
    ``TPUSNAP_FLIGHT=0`` turns recording and flushing off."""
    return _env_get(_FLIGHT_ENV_VAR, "1") != "0"


def get_flight_ring_size() -> int:
    """Flight ring capacity in events (default 4096, floor 256)."""
    return max(256, _get_int_env(_FLIGHT_RING_ENV_VAR, 4096))


def get_flight_flush_interval_s() -> float:
    """Cadence of the flight recorder's flush: after a SIGKILL at most
    this many seconds of events are lost. Defaults to the heartbeat
    interval."""
    val = _get_float_env(_FLIGHT_FLUSH_ENV_VAR, -1.0)
    if val <= 0:
        return get_heartbeat_interval_s()
    return max(0.02, val)


def get_liveness_ttl_s() -> float:
    """Rank-liveness lease TTL (``liveness``): a peer whose lease has not
    advanced for this long is declared dead and every wait of the take
    raises ``RankFailedError`` within about twice the TTL. Default 15 s;
    ``0`` turns leases off; floor 4x the heartbeat interval. Needs
    telemetry on (the lease rides the heartbeat pump)."""
    ttl = _get_float_env(_LIVENESS_TTL_ENV_VAR, 15.0)
    if ttl <= 0:
        return 0.0
    return max(4.0 * get_heartbeat_interval_s(), ttl)


def get_explicit_job_id() -> Optional[str]:
    """``TPUSNAP_JOB_ID`` as configured (sanitized), or None when unset."""
    raw = _env_get(_JOB_ID_ENV_VAR)
    if not raw:
        return None
    clean = "".join(c if (c.isalnum() or c in "._-") else "-" for c in raw)
    return clean or None


def get_job_id() -> str:
    """This job's identity on every observability record:
    ``TPUSNAP_JOB_ID``, or ``<node>-<pid>``."""
    explicit = get_explicit_job_id()
    if explicit is not None:
        return explicit
    raw = f"{get_node_name()}-{os.getpid()}"
    clean = "".join(c if (c.isalnum() or c in "._-") else "-" for c in raw)
    return clean or "job"


def get_fault_spec() -> Optional[str]:
    """``TPUSNAP_FAULT_SPEC``: the fault plan a ``chaos+`` URL uses when
    its storage options carry none (``faults.FaultPlan``)."""
    return _env_get(_FAULT_SPEC_ENV_VAR) or None


_KNOWN_METRICS_FORMATS = ("prom", "jsonl")
# Unknown format tokens already warned about: one typo must not warn at
# every take for the job's whole life.
_warned_metrics_formats: set = set()


def get_metrics_export() -> tuple:
    """Metrics export formats (``metrics_export``), comma-separated:
    ``prom`` (a Prometheus textfile rewritten atomically per take and
    restore summary) and/or ``jsonl`` (one event line per summary,
    rotation-bounded). Empty (the default) exports nothing; unknown
    names warn once per process and are skipped."""
    raw = _env_get(_METRICS_EXPORT_ENV_VAR, "") or ""
    out = []
    for tok in raw.replace(";", ",").split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        if tok not in _KNOWN_METRICS_FORMATS:
            if tok not in _warned_metrics_formats:
                _warned_metrics_formats.add(tok)
                logger.warning(
                    "Ignoring unknown %s format %r (known: %s)",
                    _METRICS_EXPORT_ENV_VAR,
                    tok,
                    ", ".join(_KNOWN_METRICS_FORMATS),
                )
            continue
        if tok not in out:
            out.append(tok)
    return tuple(out)


def get_metrics_dir() -> str:
    """Directory the export sinks write into: ``TPUSNAP_METRICS_DIR`` or
    the telemetry dir (point it at node-exporter's textfile collector)."""
    return _env_get(_METRICS_DIR_ENV_VAR) or get_telemetry_dir()


def is_history_enabled() -> bool:
    """Cross-run history (``history``): every completed take and restore
    appends one summary line to ``TPUSNAP_TELEMETRY_DIR/history.jsonl``.
    On by default; ``TPUSNAP_HISTORY=0`` turns the append off."""
    return _env_get(_HISTORY_ENV_VAR, "1") != "0"


def get_history_max_bytes() -> int:
    """Size bound on history.jsonl: past it the oldest lines are
    compacted away (atomic rewrite). Floor 64 KiB."""
    return max(64 * 1024, _get_int_env(_HISTORY_MAX_BYTES_ENV_VAR, 4 * 1024 * 1024))


def is_access_ledger_enabled() -> bool:
    """Read-side access attribution (``access``): every restore and
    ``read_object`` records which manifest leaves and byte ranges it
    read, one JSONL line per read scope in
    ``TPUSNAP_TELEMETRY_DIR/access/<digest>/<job_id>.jsonl``. On by
    default; ``TPUSNAP_ACCESS_LEDGER=0`` turns it off, as does
    ``TPUSNAP_TELEMETRY=0``."""
    return _env_get(_ACCESS_LEDGER_ENV_VAR, "1") != "0" and is_telemetry_enabled()


def get_access_ledger_max_bytes() -> int:
    """Size bound on one reader's ledger file: past it the file rotates
    to ``<name>.1``. Floor 64 KiB."""
    return max(64 * 1024, _get_int_env(_ACCESS_LEDGER_MAX_BYTES_ENV_VAR, 8 * 1024 * 1024))


def is_probe_enabled() -> bool:
    """In-take roofline probes (``TPUSNAP_PROBE=1``, off by default):
    between I/O windows the write and read schedulers write and read
    back a few raw streams through the operation's own plugin stack, so
    every take and restore measures its storage ceiling (its
    ``roofline_fraction``). Needs telemetry on."""
    return _env_get(_PROBE_ENV_VAR, "0") == "1"


def is_autotune_enabled() -> bool:
    """``TPUSNAP_AUTOTUNE=1`` (off by default): at take and restore
    begin, the ``tune`` plan of this backend, kind and world size is
    computed from the local history and applied through the tuned-plan
    overlay; explicit env vars win. The applied knobs ride the history
    event as ``tuned: {plan_id, knobs}``."""
    return _env_get(_AUTOTUNE_ENV_VAR, "0") == "1"


def get_probe_interval_bytes() -> int:
    """Payload bytes between two probe segments. Floor 16 MiB."""
    return max(
        16 * 1024 * 1024, _get_int_env(_PROBE_INTERVAL_ENV_VAR, _DEFAULT_PROBE_INTERVAL_BYTES)
    )


def get_probe_bytes() -> int:
    """Raw bytes one probe segment writes and reads back, split over a
    few concurrent streams. Floor 1 MiB."""
    return max(1024 * 1024, _get_int_env(_PROBE_BYTES_ENV_VAR, _DEFAULT_PROBE_BYTES))


def get_slo_rpo_threshold_s() -> float:
    """Recovery-point objective (``slo``): past this many seconds since
    the last committed take, one edge-triggered ``slo_breach`` per
    episode, and ``slo --check`` exits 2. ``0`` (default): unset."""
    return max(0.0, _get_float_env(_SLO_RPO_ENV_VAR, 0.0))


def get_slo_rto_threshold_s() -> float:
    """Recovery-time objective (``slo``): breach when the history-derived
    restore time of the last committed snapshot exceeds this. ``0``
    (default): unset."""
    return max(0.0, _get_float_env(_SLO_RTO_ENV_VAR, 0.0))


def get_slo_stream_cadence_x() -> float:
    """Stream-cadence gate of ``slo --check``: while a delta stream is
    live, the time since its last commit must stay under this many
    multiples of its cadence. ``0`` disables the gate; floor 1; default
    3."""
    val = _get_float_env(_SLO_STREAM_CADENCE_X_ENV_VAR, 3.0)
    if val <= 0:
        return 0.0
    return max(1.0, val)


def get_fleet_dir() -> Optional[str]:
    """Shared cross-job status directory (``fleet``): rank 0 of every job
    mirrors its heartbeat, SLO and tier state into ``<dir>/<job_id>.json``
    on the heartbeat pump. Unset: off."""
    return _env_get(_FLEET_DIR_ENV_VAR) or None


@contextlib.contextmanager
def _override_env(name: str, value: Optional[str]) -> Generator[None, None, None]:
    prev = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def override_batching_disabled(disabled: bool):
    return _override_env(_DISABLE_BATCHING_ENV_VAR, "1" if disabled else "0")


def override_max_shard_size_bytes(nbytes: int):
    return _override_env(_MAX_SHARD_SIZE_ENV_VAR, str(nbytes))


def override_slab_size_threshold_bytes(nbytes: int):
    return _override_env(_SLAB_SIZE_THRESHOLD_ENV_VAR, str(nbytes))


def override_device_batching_disabled(disabled: bool):
    return _override_env(_DISABLE_DEVICE_BATCHING_ENV_VAR, "1" if disabled else "0")


def override_max_chunk_size_bytes(nbytes: int):
    return _override_env(_MAX_CHUNK_SIZE_ENV_VAR, str(nbytes))


def override_memory_budget_bytes(nbytes: int):
    return _override_env(_MEMORY_BUDGET_ENV_VAR, str(nbytes))


def override_stage_threads(n: int):
    return _override_env(_STAGE_THREADS_ENV_VAR, str(n))


def override_async_stage_window_bytes(nbytes: int):
    """0 disables pipelined async staging (strict stage-all semantics)."""
    return _override_env(_ASYNC_STAGE_WINDOW_ENV_VAR, str(nbytes))


def override_async_cow(enabled: bool):
    return _override_env(_ASYNC_COW_ENV_VAR, "1" if enabled else "0")


@contextlib.contextmanager
def override_compress(mode: Optional[str] = None, min_blob_bytes: Optional[int] = None):
    """Override the compression knobs in one scope (None leaves one as it
    is)."""
    with contextlib.ExitStack() as stack:
        if mode is not None:
            stack.enter_context(_override_env(_COMPRESS_ENV_VAR, mode))
        if min_blob_bytes is not None:
            stack.enter_context(_override_env(_COMPRESS_MIN_BLOB_ENV_VAR, str(min_blob_bytes)))
        yield


def override_record_dedup_hashes(enabled: bool):
    return _override_env(_RECORD_DEDUP_HASHES_ENV_VAR, "1" if enabled else "0")


def override_tile_checksum_bytes(nbytes: int):
    return _override_env(_TILE_CHECKSUM_ENV_VAR, str(nbytes))


def override_checksum_disabled(disabled: bool):
    return _override_env(_DISABLE_CHECKSUM_ENV_VAR, "1" if disabled else "0")


def override_direct_io_disabled(disabled: bool):
    return _override_env(_DISABLE_DIRECT_IO_ENV_VAR, "1" if disabled else "0")


def override_barrier_timeout_s(seconds: float):
    return _override_env(_BARRIER_TIMEOUT_ENV_VAR, str(seconds))


def override_journal_disabled(disabled: bool):
    return _override_env(_DISABLE_JOURNAL_ENV_VAR, "1" if disabled else "0")


def override_telemetry_enabled(enabled: bool):
    return _override_env(_TELEMETRY_ENV_VAR, "1" if enabled else "0")


def override_stall_deadline_s(seconds: float):
    return _override_env(_STALL_DEADLINE_ENV_VAR, str(seconds))


def override_heartbeat_interval_s(seconds: float):
    return _override_env(_HEARTBEAT_INTERVAL_ENV_VAR, str(seconds))


def override_telemetry_dir(path: str):
    return _override_env(_TELEMETRY_DIR_ENV_VAR, path)


def override_flight_enabled(enabled: bool):
    return _override_env(_FLIGHT_ENV_VAR, "1" if enabled else "0")


def override_flight_ring_size(n: int):
    return _override_env(_FLIGHT_RING_ENV_VAR, str(n))


def override_flight_flush_interval_s(seconds: float):
    return _override_env(_FLIGHT_FLUSH_ENV_VAR, str(seconds))


def override_job_id(job_id: Optional[str]):
    return _override_env(_JOB_ID_ENV_VAR, job_id)


@contextlib.contextmanager
def override_liveness(ttl_s: Optional[float] = None, policy: Optional[str] = None):
    """Override the rank-liveness knobs in one scope (None leaves one as
    it is)."""
    with contextlib.ExitStack() as stack:
        if ttl_s is not None:
            stack.enter_context(_override_env(_LIVENESS_TTL_ENV_VAR, str(ttl_s)))
        if policy is not None:
            stack.enter_context(_override_env(_RANK_FAILURE_ENV_VAR, policy))
        yield


def override_delta_cadence_s(seconds: float):
    return _override_env(_DELTA_CADENCE_ENV_VAR, str(seconds))


@contextlib.contextmanager
def override_delta_max_chain(n: int) -> Generator[None, None, None]:
    with _override_env(_DELTA_MAX_CHAIN_ENV_VAR, str(n)):
        yield


def override_tier_drain(enabled: bool):
    return _override_env(_TIER_DRAIN_ENV_VAR, "1" if enabled else "0")


@contextlib.contextmanager
def override_tier_outage(
    threshold: Optional[int] = None,
    backoff_cap_s: Optional[float] = None,
    op_deadline_s: Optional[float] = None,
    local_retention_s: Optional[float] = None,
) -> Generator[None, None, None]:
    """Override the write-back tier's outage and retention knobs in one
    scope (None leaves one as it is)."""
    with contextlib.ExitStack() as stack:
        for name, value in (
            (_TIER_OUTAGE_THRESHOLD_ENV_VAR, threshold),
            (_TIER_BACKOFF_CAP_ENV_VAR, backoff_cap_s),
            (_TIER_OP_DEADLINE_ENV_VAR, op_deadline_s),
            (_TIER_LOCAL_RETENTION_ENV_VAR, local_retention_s),
        ):
            if value is not None:
                stack.enter_context(_override_env(name, str(value)))
        yield


@contextlib.contextmanager
def override_cas(
    store_dir: Optional[str],
    grace_s: Optional[float] = None,
    lease_ttl_s: Optional[float] = None,
    remote: Optional[str] = None,
) -> Generator[None, None, None]:
    """Point the content-addressed store at ``store_dir`` (None: off),
    with optional gc grace, lease TTL and remote overrides."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(_override_env(_CAS_DIR_ENV_VAR, store_dir))
        for name, value in (
            (_CAS_GRACE_ENV_VAR, grace_s),
            (_CAS_LEASE_TTL_ENV_VAR, lease_ttl_s),
            (_CAS_REMOTE_ENV_VAR, remote),
        ):
            if value is not None:
                stack.enter_context(_override_env(name, str(value)))
        yield


def override_metrics_export(formats: Optional[str]):
    return _override_env(_METRICS_EXPORT_ENV_VAR, formats)


def override_metrics_dir(path: Optional[str]):
    return _override_env(_METRICS_DIR_ENV_VAR, path)


def override_history_enabled(enabled: bool):
    return _override_env(_HISTORY_ENV_VAR, "1" if enabled else "0")


def override_history_max_bytes(nbytes: int):
    return _override_env(_HISTORY_MAX_BYTES_ENV_VAR, str(nbytes))


def override_access_ledger(enabled: bool):
    return _override_env(_ACCESS_LEDGER_ENV_VAR, "1" if enabled else "0")


def override_access_ledger_max_bytes(nbytes: int):
    return _override_env(_ACCESS_LEDGER_MAX_BYTES_ENV_VAR, str(nbytes))


@contextlib.contextmanager
def override_slo_thresholds(
    rpo_s: Optional[float] = None, rto_s: Optional[float] = None
) -> Generator[None, None, None]:
    """Override the SLO thresholds in one scope (None leaves one as it
    is)."""
    with contextlib.ExitStack() as stack:
        if rpo_s is not None:
            stack.enter_context(_override_env(_SLO_RPO_ENV_VAR, str(rpo_s)))
        if rto_s is not None:
            stack.enter_context(_override_env(_SLO_RTO_ENV_VAR, str(rto_s)))
        yield


def override_slo_stream_cadence_x(factor: float):
    return _override_env(_SLO_STREAM_CADENCE_X_ENV_VAR, str(factor))


def override_fleet_dir(path: Optional[str]):
    """Point the fleet status mirror at ``path`` (None: off)."""
    return _override_env(_FLEET_DIR_ENV_VAR, path)


@contextlib.contextmanager
def override_probe(
    enabled: bool,
    interval_bytes: Optional[int] = None,
    probe_bytes: Optional[int] = None,
) -> Generator[None, None, None]:
    """Turn the in-take roofline probes on or off, with optional cadence
    and size overrides in the same scope."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(_override_env(_PROBE_ENV_VAR, "1" if enabled else "0"))
        if interval_bytes is not None:
            stack.enter_context(_override_env(_PROBE_INTERVAL_ENV_VAR, str(interval_bytes)))
        if probe_bytes is not None:
            stack.enter_context(_override_env(_PROBE_BYTES_ENV_VAR, str(probe_bytes)))
        yield


def override_autotune(enabled: bool):
    return _override_env(_AUTOTUNE_ENV_VAR, "1" if enabled else "0")
