"""ctypes bindings for tpusnap_torch's native C++ helpers, compiled on demand.

Counterpart of tpusnap/_native/__init__.py, reduced to the entry points
the port calls. The .so is built from src/tpusnap_native.cpp (a copy of
tpusnap's source) with g++ the first time it is needed, or when the
source is newer than the binary. Every entry point has a pure-Python
fallback, and ``TPUSNAP_DISABLE_NATIVE=1`` forces the fallbacks.

The checksum algorithm recorded in a manifest depends on the build:
``crc32c`` with the native library, ``zlib-crc32`` without; the dedup
hash is ``xxh64`` or ``sha256-64``. Readers skip (with a warning) a
checksum recorded under another algorithm, so a take that must be
verifiable by tpusnap needs the native build on both sides.

ctypes releases the GIL around foreign calls: file writes, ranged reads
and hashes run concurrently with Python threads.
"""
import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "tpusnap_native.cpp")
_SO = os.path.join(_DIR, "libtpusnap_native.so")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_lock = threading.Lock()


def _build() -> bool:
    # Link to a temp path, then rename into place: the final .so may
    # already be dlopen-mapped (by this or another process), and letting
    # the linker truncate a live mapping corrupts it. os.replace gives the
    # new build a fresh inode, so a subsequent CDLL(_SO) maps the new
    # library instead of returning glibc's cached handle for the old one.
    tmp = f"{_SO}.tmp.{os.getpid()}"
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        "-pthread",
        "-std=c++17",
        "-o",
        tmp,
        _SRC,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except Exception as e:  # toolchain missing/failed: fall back to Python
        logger.warning("tpusnap native build failed (%s); using Python fallbacks", e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        from ..knobs import is_native_disabled

        if is_native_disabled():
            return None
        stale = not os.path.exists(_SO) or (
            os.path.exists(_SRC) and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        )
        built = False
        if stale:
            if not _build():
                return None
            built = True
        # A cached .so from an older source revision can pass the mtime
        # check (cp/checkout preserve equal mtimes) yet lack newer symbols.
        # On missing symbols, rebuild once and retry — unless this .so was
        # just built from current source, where a second identical build
        # cannot help and the Python fallbacks are the only option.
        for _ in range(2):
            try:
                lib = ctypes.CDLL(_SO)
            except OSError as e:
                logger.warning("tpusnap native load failed (%s)", e)
                return None
            try:
                _bind(lib)
            except AttributeError as e:
                if built:
                    logger.warning(
                        "tpusnap native .so is missing expected symbols "
                        "(%s); using Python fallbacks",
                        e,
                    )
                    return None
                logger.warning(
                    "tpusnap native .so is missing expected symbols; "
                    "rebuilding"
                )
                if not _build():
                    return None
                built = True
                continue
            _lib = lib
            return _lib
        return None


def _bind(lib: ctypes.CDLL) -> None:
    lib.ts_write_file.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.ts_write_file.restype = ctypes.c_int
    lib.ts_write_file_auto.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_int,
        ctypes.c_size_t,
        ctypes.c_int,
    ]
    lib.ts_write_file_auto.restype = ctypes.c_int
    lib.ts_read_range.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_size_t,
    ]
    lib.ts_read_range.restype = ctypes.c_int64
    lib.ts_read_range_direct2.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_size_t,
        ctypes.c_int,
        ctypes.c_size_t,
    ]
    lib.ts_read_range_direct2.restype = ctypes.c_int64
    lib.ts_read_range_into_crc.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_size_t,
        ctypes.c_int,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.ts_read_range_into_crc.restype = ctypes.c_int64
    lib.ts_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32]
    lib.ts_crc32c.restype = ctypes.c_uint32
    lib.ts_xxh64.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64]
    lib.ts_xxh64.restype = ctypes.c_uint64
    lib.ts_crc_xxh_tiles.argtypes = [
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int,
    ]
    lib.ts_crc_xxh_tiles.restype = None
    lib.ts_crc32c_combine.argtypes = [
        ctypes.c_uint32,
        ctypes.c_uint32,
        ctypes.c_uint64,
    ]
    lib.ts_crc32c_combine.restype = ctypes.c_uint32


def available() -> bool:
    return _load() is not None


def _ptr(buf) -> Tuple[int, np.ndarray]:
    """Raw data pointer of any buffer (incl. read-only), zero-copy.

    Returns (address, keepalive) — the caller must hold ``keepalive`` for
    the duration of the foreign call.
    """
    arr = np.frombuffer(memoryview(buf).cast("B"), dtype=np.uint8)
    return arr.ctypes.data, arr


def aligned_empty(nbytes: int, align: int = 4096) -> np.ndarray:
    """Uninitialized uint8 buffer whose data pointer is ``align``-aligned,
    so the O_DIRECT writer and reader use it without a bounce copy."""
    raw = np.empty(nbytes + align, dtype=np.uint8)
    off = (-raw.ctypes.data) % align
    return raw[off : off + nbytes]


def write_file(path: str, buf) -> None:
    """Whole-buffer file write with the GIL released for the full transfer.

    Large buffers go through the O_DIRECT double-buffered writer (page-cache
    writeback throttling caps buffered streams far below device speed on
    multi-GB checkpoints); the native layer falls back to a buffered write
    automatically when the filesystem rejects O_DIRECT."""
    mv = memoryview(buf).cast("B")
    lib = _load()
    if lib is None:
        _write_all(path, mv)
        return
    if mv.nbytes == 0:
        open(path, "wb").close()
        return
    from ..knobs import (
        get_direct_io_chunk_bytes,
        get_direct_io_qd,
        is_direct_io_disabled,
        is_dontcache_disabled,
    )

    ptr, keepalive = _ptr(mv)
    if is_direct_io_disabled():
        rc = lib.ts_write_file(path.encode(), ptr, mv.nbytes)
    else:
        rc = lib.ts_write_file_auto(
            path.encode(),
            ptr,
            mv.nbytes,
            get_direct_io_qd(),
            get_direct_io_chunk_bytes(),
            0 if is_dontcache_disabled() else 1,
        )
    del keepalive
    if rc != 0:
        raise OSError(-rc, os.strerror(-rc), path)


def _write_all(path: str, mv: memoryview) -> None:
    """Unbuffered write loop: a single ``FileIO.write`` maps to one
    write(2), which can be short (near-full disk) and is capped at
    0x7ffff000 bytes on Linux — ignoring its return would silently
    truncate buffers >= 2 GiB."""
    with open(path, "wb", buffering=0) as f:
        pos = 0
        while pos < mv.nbytes:
            written = f.write(mv[pos:])
            if not written:
                raise OSError(f"short write at {pos}/{mv.nbytes}: {path}")
            pos += written


def read_range(path: str, offset: int, n: int, out) -> int:
    """Positional ranged read into ``out`` (writable buffer); returns bytes
    read (short only at EOF). Large ranges go through the O_DIRECT
    double-buffered reader — the page cache's bounded readahead window
    caps cold buffered reads ~10x below device speed — with automatic
    buffered fallback on filesystems without O_DIRECT."""
    mv = memoryview(out).cast("B")
    if mv.readonly:
        raise ValueError("out buffer must be writable")
    if n > mv.nbytes:
        raise ValueError(f"out buffer too small: {mv.nbytes} < {n}")
    lib = _load()
    if lib is None:
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(n)
        mv[: len(data)] = data
        return len(data)
    if n == 0:
        return 0
    from ..knobs import (
        get_direct_io_chunk_bytes,
        get_direct_io_qd,
        is_direct_io_disabled,
    )

    # Direct reads only pay off for large streams: many concurrent small
    # direct reads thrash the device queue (each chunk is a synchronous
    # round trip with no readahead) and measurably lose to buffered reads
    # + POSIX_FADV_SEQUENTIAL. 64 MiB is past the crossover on the
    # measured virtio/NVMe configs. Aligned destinations (fs-plugin read
    # buffers are) take the zero-copy pread path inside direct2.
    use_direct = n >= (64 << 20) and not is_direct_io_disabled()
    ptr, keepalive = _ptr(mv)
    if use_direct:
        got = lib.ts_read_range_direct2(
            path.encode(),
            ptr,
            offset,
            n,
            get_direct_io_qd(),
            get_direct_io_chunk_bytes(),
        )
    else:
        got = lib.ts_read_range(path.encode(), ptr, offset, n)
    del keepalive
    if got < 0:
        raise OSError(-got, os.strerror(-got), path)
    return got


def read_range_into(
    path: str, offset: int, n: int, out, want_crc: bool = False
) -> Tuple[int, Optional[int], str]:
    """Ranged read landing directly in ``out`` (the restore target's own
    memory), with the checksum fused into the bounce copy-out.

    Returns ``(bytes_read, crc_or_None, algorithm)``. Compared to
    ``read_range`` + a separate verify + a separate copy, this makes one
    RAM-read + one RAM-write pass per byte total — the difference between
    a CPU-ceiling-bound and a disk-bound restore on few-core hosts."""
    mv = memoryview(out).cast("B")
    if mv.readonly:
        raise ValueError("out buffer must be writable")
    if n > mv.nbytes:
        raise ValueError(f"out buffer too small: {mv.nbytes} < {n}")
    lib = _load()
    if lib is None:
        # readinto the destination directly — the in-place path's whole
        # premise is that no full-size scratch buffer exists.
        got = 0
        with open(path, "rb") as f:
            f.seek(offset)
            while got < n:
                r = f.readinto(mv[got:n])
                if not r:
                    break  # EOF
                got += r
        if want_crc:
            import zlib

            return got, zlib.crc32(mv[:got]), "zlib-crc32"
        return got, None, "zlib-crc32"
    if n == 0:
        return 0, (crc32c(b"") if want_crc else None), "crc32c"
    from ..knobs import (
        get_direct_io_chunk_bytes,
        get_direct_io_qd,
        is_direct_io_disabled,
    )

    ptr, keepalive = _ptr(mv)
    crc_out = ctypes.c_uint32(0)
    if is_direct_io_disabled():
        got = lib.ts_read_range(path.encode(), ptr, offset, n)
        if got >= 0 and want_crc:
            crc_val = lib.ts_crc32c(ptr, got, 0) if got else crc32c(b"")
        else:
            crc_val = None
    else:
        got = lib.ts_read_range_into_crc(
            path.encode(),
            ptr,
            offset,
            n,
            get_direct_io_qd(),
            get_direct_io_chunk_bytes(),
            ctypes.byref(crc_out) if want_crc else None,
        )
        crc_val = crc_out.value if (want_crc and got >= 0) else None
    del keepalive
    if got < 0:
        raise OSError(-got, os.strerror(-got), path)
    return got, crc_val, "crc32c"


def xxh64(buf, seed: int = 0) -> int:
    """XXH64 of a buffer — the second, independent hash backing
    incremental-dedup equality (see dedup_hash_algorithm). The fallback
    is sha256 truncated to 64 bits: a different algorithm, so values are
    only ever compared under a matching recorded algorithm string."""
    mv = memoryview(buf).cast("B")
    lib = _load()
    if lib is None:
        return _sha256_64(mv)
    if mv.nbytes == 0:
        return lib.ts_xxh64(None, 0, seed)
    ptr, keepalive = _ptr(mv)
    out = lib.ts_xxh64(ptr, mv.nbytes, seed)
    del keepalive
    return out


def _sha256_64(mv) -> int:
    import hashlib

    return int.from_bytes(hashlib.sha256(mv).digest()[:8], "big")


def dedup_hash_algorithm() -> str:
    return "xxh64" if available() else "sha256-64"


def dedup_hash_string(buf) -> str:
    """``"<algo>:<16-hex>"`` dedup hash of a buffer, for manifest
    entries. Incremental dedup requires this 64-bit value to match IN
    ADDITION to the 32-bit CRC — a single CRC leaves a ~2^-32
    silent-collision channel per blob-take at fleet scale."""
    return f"{dedup_hash_algorithm()}:{xxh64(buf) & _U64:016x}"


_U64 = (1 << 64) - 1


def crc_xxh_tiles(buf, tile_nbytes: int, nthreads: int = 4):
    """Per-``tile_nbytes`` (CRC32C, XXH64) of ``buf`` in ONE fused memory
    pass — the stage-time hash pass that feeds both the integrity
    checksums and the dedup hashes. Returns ``(crcs, xxhs)`` lists (one
    entry each when ``tile_nbytes`` >= the buffer size)."""
    mv = memoryview(buf).cast("B")
    n = mv.nbytes
    if n == 0:
        return [crc32c(b"")], [xxh64(b"")]
    if tile_nbytes <= 0 or tile_nbytes > n:
        tile_nbytes = n
    n_tiles = (n + tile_nbytes - 1) // tile_nbytes
    lib = _load()
    if lib is None:
        crcs, xxhs = [], []
        for i in range(n_tiles):
            sub = mv[i * tile_nbytes : min((i + 1) * tile_nbytes, n)]
            crcs.append(crc32c(sub))
            xxhs.append(_sha256_64(sub))
        return crcs, xxhs
    crcs = (ctypes.c_uint32 * n_tiles)()
    xxhs = (ctypes.c_uint64 * n_tiles)()
    ptr, keepalive = _ptr(mv)
    lib.ts_crc_xxh_tiles(ptr, n, tile_nbytes, crcs, xxhs, nthreads)
    del keepalive
    return list(crcs), list(xxhs)


def crc32c(buf, seed: int = 0) -> int:
    """CRC32C (Castagnoli) of a buffer. The pure-Python fallback uses
    zlib.crc32 — a different polynomial — so checksums must only ever be
    compared when produced by the same implementation; callers record the
    algorithm alongside the value."""
    mv = memoryview(buf).cast("B")
    lib = _load()
    if lib is None:
        import zlib

        return zlib.crc32(mv, seed)
    if mv.nbytes == 0:
        return lib.ts_crc32c(None, 0, seed)
    ptr, keepalive = _ptr(mv)
    out = lib.ts_crc32c(ptr, mv.nbytes, seed)
    del keepalive
    return out


def crc_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of a concatenation A||B from crc(A), crc(B), len(B) —
    O(log len2), no data pass. Uses whichever polynomial this build's
    ``crc32c`` computes (CRC32C native / CRC-32 zlib fallback), so
    combined values are always comparable to directly-computed ones."""
    lib = _load()
    if lib is not None:
        return lib.ts_crc32c_combine(crc1 & 0xFFFFFFFF, crc2 & 0xFFFFFFFF, len2)
    return _crc_combine_py(crc1, crc2, len2, poly=0xEDB88320)


def _crc_combine_py(crc1: int, crc2: int, len2: int, poly: int) -> int:
    """Pure-Python GF(2) combine (zlib crc32_combine algorithm)."""
    if len2 == 0:
        return crc1 & 0xFFFFFFFF

    def times(mat, vec):
        s = 0
        i = 0
        while vec:
            if vec & 1:
                s ^= mat[i]
            vec >>= 1
            i += 1
        return s

    def square(mat):
        return [times(mat, mat[n]) for n in range(32)]

    odd = [poly] + [1 << n for n in range(31)]
    even = square(odd)
    odd = square(even)
    crc1 &= 0xFFFFFFFF
    while True:
        even = square(odd)
        if len2 & 1:
            crc1 = times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = square(even)
        if len2 & 1:
            crc1 = times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return (crc1 ^ crc2) & 0xFFFFFFFF


def checksum_algorithm() -> str:
    return "crc32c" if available() else "zlib-crc32"


def checksum_string(buf) -> str:
    """``"<algo>:<8-hex>"`` checksum of a buffer, for manifest entries."""
    return f"{checksum_algorithm()}:{crc32c(buf) & 0xFFFFFFFF:08x}"


class ChecksumError(IOError):
    """A restored blob's bytes do not match the checksum recorded at save
    time — storage or transport corrupted the data."""


def verify_checksum_value(
    crc: int, algo: str, recorded: str, location: str
) -> None:
    """Verify a read-time-computed checksum value (from the fused native
    read) against the manifest-recorded string — no data pass needed.

    Mirrors ``verify_checksum``'s algorithm-mismatch policy: a snapshot
    written by a build with a different checksum implementation is skipped
    with a warning; only a same-algorithm mismatch is proof of corruption.
    """
    rec_algo, _, value = recorded.partition(":")
    if rec_algo != algo:
        logger.warning(
            "skipping checksum verification for %s: snapshot used %s, "
            "this read computed %s",
            location,
            rec_algo,
            algo,
        )
        return
    try:
        recorded_value = int(value, 16)
    except ValueError:
        raise ChecksumError(
            f"malformed checksum {recorded!r} recorded for {location!r} — "
            "the snapshot metadata itself is corrupt"
        ) from None
    if (crc & 0xFFFFFFFF) != recorded_value:
        raise ChecksumError(
            f"checksum mismatch for {location!r}: stored {recorded}, "
            f"read bytes hash to {algo}:{crc & 0xFFFFFFFF:08x} — the blob "
            "was corrupted in storage or transit"
        )


def verify_checksum(buf, recorded: str, location: str) -> None:
    """Verify a read buffer against the manifest-recorded checksum.

    An algorithm mismatch (snapshot written by a build whose native
    helper/fallback used a different polynomial) is skipped with a
    warning — the bytes may be fine; only a same-algorithm mismatch is
    proof of corruption."""
    algo = checksum_algorithm()
    if not recorded.startswith(algo + ":"):
        # Defer hashing: nothing to compare against. Value 0 is unused.
        verify_checksum_value(0, algo, recorded, location)
        return
    verify_checksum_value(crc32c(buf), algo, recorded, location)
