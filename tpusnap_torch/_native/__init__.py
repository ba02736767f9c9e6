"""ctypes bindings for tpusnap_torch's native C++ helpers, compiled on demand.

Counterpart of tpusnap/_native/__init__.py, reduced to the entry points
the port calls (the tile codec included). The .so is built from src/tpusnap_native.cpp (a copy of
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
import torch

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
    lib.ts_memcpy_par.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_int,
    ]
    lib.ts_memcpy_par.restype = None
    lib.ts_memcpy_crc_tiles.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int,
    ]
    lib.ts_memcpy_crc_tiles.restype = None
    lib.ts_memcpy_crc_xxh_tiles.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int,
    ]
    lib.ts_memcpy_crc_xxh_tiles.restype = None
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
    lib.ts_lz4_compress.argtypes = [
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_int,
    ]
    lib.ts_lz4_compress.restype = ctypes.c_int64
    lib.ts_lz4_decompress.argtypes = [
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_int,
    ]
    lib.ts_lz4_decompress.restype = ctypes.c_int64
    lib.ts_compress_bound.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.ts_compress_bound.restype = ctypes.c_int64
    lib.ts_compress_tiles.argtypes = [
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_size_t,
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.ts_compress_tiles.restype = ctypes.c_int64
    lib.ts_decompress_tiles.argtypes = [
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_size_t,
        ctypes.c_size_t,
        ctypes.c_size_t,
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.ts_decompress_tiles.restype = ctypes.c_int64


def available() -> bool:
    return _load() is not None


def _ptr(buf) -> Tuple[int, np.ndarray]:
    """Raw data pointer of any buffer (incl. read-only), zero-copy.

    Returns (address, keepalive) — the caller must hold ``keepalive`` for
    the duration of the foreign call.
    """
    arr = np.frombuffer(memoryview(buf).cast("B"), dtype=np.uint8)
    return arr.ctypes.data, arr


_MADV_HUGEPAGE = 14
_PAGE = 4096
_HUGEPAGE_MIN_BYTES = 4 << 20
_libc: Optional[ctypes.CDLL] = None
_libc_failed = False


def _span(buf) -> Tuple[int, int]:
    """(address, nbytes) of a host buffer the advice may touch; (0, 0)
    for one it must leave alone."""
    if isinstance(buf, torch.Tensor):
        nbytes = buf.numel() * buf.element_size()
        if buf.device.type != "cpu" or nbytes < _HUGEPAGE_MIN_BYTES:
            return 0, 0
        # Pinned memory belongs to CUDA's caching host allocator.
        if buf.is_pinned():
            return 0, 0
        return buf.data_ptr(), nbytes
    if isinstance(buf, np.ndarray):
        # Any dtype, also those without the buffer protocol.
        return buf.ctypes.data, buf.nbytes
    mv = memoryview(buf)
    if mv.nbytes == 0:
        return 0, 0
    return _ptr(mv)[0], mv.nbytes


def advise_hugepages(buf) -> None:
    """Best-effort ``madvise(MADV_HUGEPAGE)`` on a host buffer's pages.

    A fresh destination the port allocates itself (read scratch, slabs,
    staging buffers, tiled-read, compressed, chunk and shard
    destinations, owning copies) otherwise faults 4 KiB at a time on
    first touch; advised, it can fault as 2 MiB pages where the kernel
    offers anonymous transparent hugepages. Takes a numpy array of any
    dtype, a CPU ``torch.Tensor`` or any buffer. Buffers under 4 MiB,
    empty ones, CUDA tensors and pinned tensors are left alone, and only
    whole pages inside the buffer are advised. Purely advisory: a failed
    call changes nothing and raises nothing."""
    global _libc, _libc_failed
    if _libc_failed:
        return
    if _libc is None:
        try:
            lc = ctypes.CDLL(None, use_errno=True)
            lc.madvise.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
            lc.madvise.restype = ctypes.c_int
            _libc = lc
        except (OSError, AttributeError):
            # Only a missing libc or symbol disables the advice for the
            # process; an odd buffer below must not.
            _libc_failed = True
            return
    try:
        addr, nbytes = _span(buf)
    except (TypeError, ValueError, RuntimeError):
        return
    if nbytes < _HUGEPAGE_MIN_BYTES:
        return
    start = (addr + _PAGE - 1) & ~(_PAGE - 1)
    end = (addr + nbytes) & ~(_PAGE - 1)
    if end > start:
        _libc.madvise(start, end - start, _MADV_HUGEPAGE)


def empty_advised(shape, dtype):
    """An uninitialized host buffer advised before its first touch: a
    numpy array for a numpy dtype, a CPU ``torch.Tensor`` for a
    ``torch.dtype``. The allocation for every large fresh destination
    the port creates itself."""
    if isinstance(dtype, torch.dtype):
        out = torch.empty(tuple(shape), dtype=dtype)
    else:
        out = np.empty(shape, dtype=dtype)
    advise_hugepages(out)
    return out


def aligned_empty(nbytes: int, align: int = 4096) -> np.ndarray:
    """Uninitialized uint8 buffer whose data pointer is ``align``-aligned,
    so the O_DIRECT writer and reader use it without a bounce copy.
    Large buffers are advised (``advise_hugepages``) before first touch."""
    raw = np.empty(nbytes + align, dtype=np.uint8)
    off = (-raw.ctypes.data) % align
    out = raw[off : off + nbytes]
    advise_hugepages(out)
    return out


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


def _copy_views(dst, src) -> Tuple[memoryview, memoryview]:
    dst_mv = memoryview(dst).cast("B")
    src_mv = memoryview(src).cast("B")
    if dst_mv.readonly:
        raise ValueError("dst must be writable")
    if dst_mv.nbytes != src_mv.nbytes:
        raise ValueError(f"size mismatch: {dst_mv.nbytes} != {src_mv.nbytes}")
    return dst_mv, src_mv


def memcpy(dst, src, nthreads: int = 4) -> None:
    """GIL-released (and multi-threaded for large buffers) memcpy — the
    defensive clone of an async take."""
    dst_mv, src_mv = _copy_views(dst, src)
    lib = _load()
    if lib is None or dst_mv.nbytes < (1 << 20):
        dst_mv[:] = src_mv
        return
    dst_ptr, dst_keep = _ptr(dst_mv)
    src_ptr, src_keep = _ptr(src_mv)
    lib.ts_memcpy_par(dst_ptr, src_ptr, dst_mv.nbytes, nthreads)
    del dst_keep, src_keep


# PyBytes_FromStringAndSize(NULL, n): a bytes object whose n bytes are
# left unset, for the caller to fill before anything else can see it.
# A prototype of its own, so no other user of ctypes.pythonapi sees
# changed argtypes; PYFUNCTYPE keeps the GIL held for the allocation.
_bytes_uninit = ctypes.PYFUNCTYPE(ctypes.py_object, ctypes.c_void_p, ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi)
)


def copy_to_bytes(src, nthreads: int = 4) -> bytes:
    """A new ``bytes`` object holding ``src``'s bytes: one copy, made
    with the GIL released. The object is allocated uninitialised and
    filled by the native memcpy before it is returned. Buffers under
    1 MiB, and every buffer without the native library, go through
    ``bytes()``."""
    src_mv = memoryview(src).cast("B")
    lib = _load()
    if lib is None or src_mv.nbytes < (1 << 20):
        return bytes(src_mv)
    out = _bytes_uninit(None, src_mv.nbytes)
    dst_ptr, dst_keep = _ptr(out)
    src_ptr, src_keep = _ptr(src_mv)
    lib.ts_memcpy_par(dst_ptr, src_ptr, src_mv.nbytes, nthreads)
    del dst_keep, src_keep
    return out


def memcpy_crc_tiles(dst, src, tile_nbytes: int, nthreads: int = 4) -> list:
    """Copy ``src`` into ``dst`` while computing a seed-0 checksum per
    ``tile_nbytes`` bytes — one memory pass for the clone and the hash.
    Returns the per-tile values (one, the whole-buffer value, when
    ``tile_nbytes`` >= the buffer size); fold them with ``crc_combine``."""
    dst_mv, src_mv = _copy_views(dst, src)
    n = src_mv.nbytes
    if n == 0:
        return [crc32c(b"")]
    if tile_nbytes <= 0 or tile_nbytes > n:
        tile_nbytes = n
    n_tiles = (n + tile_nbytes - 1) // tile_nbytes
    lib = _load()
    if lib is None:
        out = []
        for i in range(n_tiles):
            sub = src_mv[i * tile_nbytes : min((i + 1) * tile_nbytes, n)]
            out.append(crc32c(sub))
            dst_mv[i * tile_nbytes : i * tile_nbytes + sub.nbytes] = sub
        return out
    crcs = (ctypes.c_uint32 * n_tiles)()
    dst_ptr, dst_keep = _ptr(dst_mv)
    src_ptr, src_keep = _ptr(src_mv)
    lib.ts_memcpy_crc_tiles(dst_ptr, src_ptr, n, tile_nbytes, crcs, nthreads)
    del dst_keep, src_keep
    return list(crcs)


def memcpy_crc_xxh_tiles(dst, src, tile_nbytes: int, nthreads: int = 4):
    """Copy ``src`` into ``dst`` while computing per-tile (CRC32C, XXH64)
    in the same pass. Returns ``(crcs, xxhs)``."""
    dst_mv, src_mv = _copy_views(dst, src)
    n = src_mv.nbytes
    if n == 0:
        return [crc32c(b"")], [xxh64(b"")]
    if tile_nbytes <= 0 or tile_nbytes > n:
        tile_nbytes = n
    n_tiles = (n + tile_nbytes - 1) // tile_nbytes
    lib = _load()
    if lib is None:
        crcs, xxhs = [], []
        for i in range(n_tiles):
            sub = src_mv[i * tile_nbytes : min((i + 1) * tile_nbytes, n)]
            crcs.append(crc32c(sub))
            xxhs.append(_sha256_64(sub))
            dst_mv[i * tile_nbytes : i * tile_nbytes + sub.nbytes] = sub
        return crcs, xxhs
    crcs = (ctypes.c_uint32 * n_tiles)()
    xxhs = (ctypes.c_uint64 * n_tiles)()
    dst_ptr, dst_keep = _ptr(dst_mv)
    src_ptr, src_keep = _ptr(src_mv)
    lib.ts_memcpy_crc_xxh_tiles(dst_ptr, src_ptr, n, tile_nbytes, crcs, xxhs, nthreads)
    del dst_keep, src_keep
    return list(crcs), list(xxhs)


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


# ------------------------------------------------------------ tile codec
#
# The byte-shuffle filter and LZ4 block codec of the C++ source, bound as
# tpusnap binds them: both packages run the same code, so equal input
# bytes and tile geometry give equal compressed blobs. Compression needs
# the native library (the policy bypasses without it); decompression has
# a pure-Python fallback, slow but bit-exact.


class CompressionError(IOError):
    """A compressed tile failed to decode: the stored bytes are malformed
    (normally caught earlier by the CRC over the stored bytes)."""


def compression_available() -> bool:
    return _load() is not None


def compress_bound(n: int, tile_nbytes: int) -> int:
    """Destination capacity ``compress_tiles`` requires (per-tile
    worst-case slots, the native side's formula)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: cannot compress")
    return int(lib.ts_compress_bound(n, tile_nbytes))


def compress_tiles(buf, tile_nbytes: int, elem: int, want_xxh: bool, nthreads: int = 4):
    """Fused shuffle+LZ4+dual-hash of ``buf`` per ``tile_nbytes`` tile.

    Returns ``(out, comp_sizes, crcs, xxhs)``: ``out`` is an aligned
    uint8 array of the concatenated stored tiles (a tile that does not
    shrink is stored raw, at its uncompressed size), ``comp_sizes`` the
    per-tile stored sizes, ``crcs``/``xxhs`` the hashes of each tile's
    STORED bytes (``xxhs`` is None unless ``want_xxh``). Deterministic."""
    mv = memoryview(buf).cast("B")
    n = mv.nbytes
    if n == 0:
        raise ValueError("cannot compress an empty buffer")
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: cannot compress")
    if tile_nbytes <= 0 or tile_nbytes > n:
        tile_nbytes = n
    n_tiles = (n + tile_nbytes - 1) // tile_nbytes
    cap = int(lib.ts_compress_bound(n, tile_nbytes))
    out = aligned_empty(cap)
    comp_sizes = (ctypes.c_int64 * n_tiles)()
    crcs = (ctypes.c_uint32 * n_tiles)()
    xxhs = (ctypes.c_uint64 * n_tiles)()
    src_ptr, src_keep = _ptr(mv)
    total = lib.ts_compress_tiles(
        src_ptr, n, tile_nbytes, elem, out.ctypes.data, cap,
        comp_sizes, crcs, xxhs, 1 if want_xxh else 0, nthreads,
    )
    del src_keep
    if total < 0:
        raise RuntimeError("native tile compression failed (capacity)")
    return out[:total], list(comp_sizes), list(crcs), list(xxhs) if want_xxh else None


def decompress_tiles(
    src, comp_sizes, tile_raw: int, total_raw: int, elem: int, out, nthreads: int = 4
) -> None:
    """Decode concatenated compressed tiles into ``out`` (writable,
    exactly ``total_raw`` bytes). Raises :class:`CompressionError` on
    malformed input."""
    src_mv = memoryview(src).cast("B")
    out_mv = memoryview(out).cast("B")
    if out_mv.readonly:
        raise ValueError("out buffer must be writable")
    if out_mv.nbytes != total_raw:
        raise ValueError(f"out buffer size {out_mv.nbytes} != total_raw {total_raw}")
    if total_raw == 0:
        if src_mv.nbytes != 0:
            raise CompressionError("trailing bytes after empty payload")
        return
    n_tiles = len(comp_sizes)
    lib = _load()
    if lib is None:
        _py_decompress_tiles(src_mv, comp_sizes, tile_raw, total_raw, elem, out_mv)
        return
    sizes = (ctypes.c_int64 * n_tiles)(*comp_sizes)
    src_ptr, src_keep = _ptr(src_mv)
    out_ptr, out_keep = _ptr(out_mv)
    got = lib.ts_decompress_tiles(
        src_ptr, src_mv.nbytes, sizes, n_tiles, tile_raw, total_raw, out_ptr, elem, nthreads
    )
    del src_keep, out_keep
    if got != total_raw:
        raise CompressionError(
            f"compressed tile payload failed to decode ({got} of {total_raw} "
            "bytes) — the stored bytes are malformed"
        )


def lz4_compress(buf, elem: int = 1) -> Optional[bytes]:
    """One shuffle+LZ4 block; None when the input does not shrink (or the
    native library is absent)."""
    mv = memoryview(buf).cast("B")
    lib = _load()
    if lib is None or mv.nbytes == 0:
        return None
    out = np.empty(mv.nbytes, dtype=np.uint8)  # must be strictly smaller
    ptr, keep = _ptr(mv)
    got = lib.ts_lz4_compress(ptr, mv.nbytes, out.ctypes.data, mv.nbytes - 1, elem)
    del keep
    if got < 0:
        return None
    return out[:got].tobytes()


def lz4_decompress(buf, raw_nbytes: int, elem: int = 1) -> bytes:
    """Decode one shuffle+LZ4 block of known decoded size."""
    mv = memoryview(buf).cast("B")
    lib = _load()
    if lib is None:
        return _py_unshuffle(_py_lz4_decompress_block(mv, raw_nbytes), elem)
    out = np.empty(raw_nbytes, dtype=np.uint8)
    ptr, keep = _ptr(mv)
    got = lib.ts_lz4_decompress(ptr, mv.nbytes, out.ctypes.data, raw_nbytes, elem)
    del keep
    if got != raw_nbytes:
        raise CompressionError("LZ4 block failed to decode")
    return out.tobytes()


def _py_lz4_decompress_block(mv: memoryview, raw_nbytes: int) -> bytes:
    """Bounds-checked LZ4 block decode in Python (the fallback)."""
    src = bytes(mv)
    n = len(src)
    out = bytearray()
    ip = 0
    while ip < n:
        token = src[ip]
        ip += 1
        litlen = token >> 4
        if litlen == 15:
            while True:
                if ip >= n:
                    raise CompressionError("truncated literal length")
                b = src[ip]
                ip += 1
                litlen += b
                if b != 255:
                    break
        if ip + litlen > n or len(out) + litlen > raw_nbytes:
            raise CompressionError("literal run out of bounds")
        out += src[ip : ip + litlen]
        ip += litlen
        if ip >= n:
            break
        if ip + 2 > n:
            raise CompressionError("truncated match offset")
        offset = src[ip] | (src[ip + 1] << 8)
        ip += 2
        if offset == 0 or offset > len(out):
            raise CompressionError("match offset out of bounds")
        mlen = token & 15
        if mlen == 15:
            while True:
                if ip >= n:
                    raise CompressionError("truncated match length")
                b = src[ip]
                ip += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        if len(out) + mlen > raw_nbytes:
            raise CompressionError("match run out of bounds")
        start = len(out) - offset
        for i in range(mlen):  # a forward copy handles overlap (runs)
            out.append(out[start + i])
    if len(out) != raw_nbytes:
        raise CompressionError(f"decoded {len(out)} bytes, expected {raw_nbytes}")
    return bytes(out)


def _py_unshuffle(data: bytes, elem: int) -> bytes:
    if elem <= 1 or not data:
        return data
    ne = len(data) // elem
    body = ne * elem
    planes = np.frombuffer(data[:body], dtype=np.uint8).reshape(elem, ne)
    return planes.T.tobytes() + data[body:]


def _py_decompress_tiles(src_mv, comp_sizes, tile_raw, total_raw, elem, out_mv) -> None:
    off = 0
    raw_off = 0
    if tile_raw <= 0:
        tile_raw = total_raw
    for clen in comp_sizes:
        raw_len = min(tile_raw, total_raw - raw_off)
        if raw_len <= 0 or off + clen > src_mv.nbytes:
            raise CompressionError("compressed tile sizes out of bounds")
        tile = src_mv[off : off + clen]
        if clen == raw_len:
            out_mv[raw_off : raw_off + raw_len] = tile  # stored raw
        elif clen > raw_len:
            raise CompressionError("compressed tile larger than raw tile")
        else:
            shuffled = _py_lz4_decompress_block(tile, raw_len)
            out_mv[raw_off : raw_off + raw_len] = _py_unshuffle(shuffled, elem)
        off += clen
        raw_off += raw_len
    if off != src_mv.nbytes or raw_off != total_raw:
        raise CompressionError("compressed tile sizes do not cover payload")
