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
from typing import Generator, Optional

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

_DEFAULT_MAX_CHUNK_SIZE_BYTES = 512 * 1024 * 1024
_DEFAULT_MAX_SHARD_SIZE_BYTES = 512 * 1024 * 1024
_DEFAULT_SLAB_SIZE_THRESHOLD_BYTES = 128 * 1024 * 1024
_DEFAULT_DIRECT_IO_QD = 2
_DEFAULT_DIRECT_IO_CHUNK_BYTES = 32 * 1024 * 1024
_DEFAULT_TILE_CHECKSUM_BYTES = 16 * 1024 * 1024
_DEFAULT_ASYNC_STAGE_WINDOW_BYTES = 2 * 1024 * 1024 * 1024
_DEFAULT_STAGING_POOL_BYTES = 4 * 1024 * 1024 * 1024


def _get_int_env(name: str, default: int) -> int:
    val = os.environ.get(name)
    if val is None:
        return default
    try:
        return int(val)
    except ValueError:
        logger.warning("Ignoring non-integer %s=%r", name, val)
        return default


def _get_float_env(name: str, default: float) -> float:
    val = os.environ.get(name)
    if val is None:
        return default
    try:
        return float(val)
    except ValueError:
        logger.warning("Ignoring non-numeric %s=%r", name, val)
        return default


def _flag(name: str) -> bool:
    return os.environ.get(name, "0") == "1"


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
    return os.environ.get(_ASYNC_COW_ENV_VAR, "1") != "0"


def get_staging_pool_bytes() -> int:
    """Cap on the reusable clone-buffer pool (``_staging_pool``); 0
    disables it."""
    return max(0, _get_int_env(_STAGING_POOL_ENV_VAR, _DEFAULT_STAGING_POOL_BYTES))


def get_memory_budget_override_bytes() -> Optional[int]:
    val = os.environ.get(_MEMORY_BUDGET_ENV_VAR)
    return int(val) if val is not None else None


_KNOWN_COMPRESS_MODES = ("auto", "on", "off", "lz4")
_warned_compress_modes: set = set()


def get_compress_mode() -> str:
    """Per-take fused tile compression (``compress``): ``auto`` (the
    default) compresses when the storage pipe's measured ceiling is
    clearly slower than the codec's measured throughput, ``on`` compresses
    every eligible blob, ``off`` bypasses, ``lz4`` pins the codec family
    (the same as ``on`` today). Unknown values warn once per process and
    fall back to ``auto``."""
    raw = (os.environ.get(_COMPRESS_ENV_VAR) or "auto").strip().lower()
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

    return os.environ.get(_NODE_NAME_ENV_VAR) or socket.gethostname()


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
    raw = os.environ.get(_RANK_FAILURE_ENV_VAR, "abort").strip().lower()
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
    return os.environ.get(_CAS_DIR_ENV_VAR) or None


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


def override_barrier_timeout_s(seconds: float):
    return _override_env(_BARRIER_TIMEOUT_ENV_VAR, str(seconds))
