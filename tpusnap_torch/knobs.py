"""Tunable knobs read from the environment — the subset the port's
single-process take/restore path consults.

Counterpart of tpusnap/knobs.py. The names stay ``TPUSNAP_*`` so one
environment configures either package; the defaults are tpusnap's
(512 MB max chunk, 128 MB slab threshold, 16 MiB checksum tiles).
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

_DEFAULT_MAX_CHUNK_SIZE_BYTES = 512 * 1024 * 1024
_DEFAULT_SLAB_SIZE_THRESHOLD_BYTES = 128 * 1024 * 1024
_DEFAULT_DIRECT_IO_QD = 2
_DEFAULT_DIRECT_IO_CHUNK_BYTES = 32 * 1024 * 1024
_DEFAULT_TILE_CHECKSUM_BYTES = 16 * 1024 * 1024


def _get_int_env(name: str, default: int) -> int:
    val = os.environ.get(name)
    if val is None:
        return default
    try:
        return int(val)
    except ValueError:
        logger.warning("Ignoring non-integer %s=%r", name, val)
        return default


def _flag(name: str) -> bool:
    return os.environ.get(name, "0") == "1"


def get_max_chunk_size_bytes() -> int:
    return _get_int_env(_MAX_CHUNK_SIZE_ENV_VAR, _DEFAULT_MAX_CHUNK_SIZE_BYTES)


def get_slab_size_threshold_bytes() -> int:
    return _get_int_env(
        _SLAB_SIZE_THRESHOLD_ENV_VAR, _DEFAULT_SLAB_SIZE_THRESHOLD_BYTES
    )


def is_batching_disabled() -> bool:
    return _flag(_DISABLE_BATCHING_ENV_VAR)


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
    return max(1, _get_int_env(_STAGE_THREADS_ENV_VAR, 1))


def get_memory_budget_override_bytes() -> Optional[int]:
    val = os.environ.get(_MEMORY_BUDGET_ENV_VAR)
    return int(val) if val is not None else None


def is_compression_forced() -> bool:
    """``TPUSNAP_COMPRESS=on``/``lz4`` forces tpusnap's fused tile codec,
    which the port does not have yet; ``auto`` (tpusnap's default) and
    ``off`` both mean uncompressed blobs here."""
    return os.environ.get(_COMPRESS_ENV_VAR, "auto").strip().lower() in ("on", "lz4")


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
