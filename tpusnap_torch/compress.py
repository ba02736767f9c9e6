"""Dtype-aware fused tile compression: codec model and probe-driven policy.

Counterpart of tpusnap/compress.py, with the same codec names, policy and
thresholds, so a take compresses the same blobs into the same bytes in
either package. Compression is host work here too: the fused
shuffle+LZ4+dual-hash pass of ``_native`` runs over the pinned buffer a
CUDA tensor's device→host copy lands in, per checksum tile, keeping
tile-grain random access on the restore path.

The policy is measured (``TPUSNAP_COMPRESS=auto``, the default): compress
when the pipe's write ceiling is clearly slower than the codec's measured
throughput, bypass when the disk outruns it. The ceiling comes from the
in-take roofline probes (``TPUSNAP_PROBE=1``: every sample lands here) or,
with no sample yet, from a one-shot mini-probe written through the take's
own storage plugin under ``PROBE_DIR``. Codec throughput is measured once
per process. Every checksum and dedup hash of a compressed blob is over
the STORED (compressed) bytes. The decision rides the take's telemetry
meta (and so its history event); ``LAST_DECISION`` holds the last one.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from . import flight, telemetry

logger = logging.getLogger(__name__)

# Auto mode never probes (or compresses) a take whose eligible payload
# is below this floor: a small take cannot amortize the policy probe or
# the codec bookkeeping, and bypass is within noise there anyway.
AUTO_MIN_TAKE_BYTES = 64 << 20

# Compress only when the codec clearly outruns the pipe: at parity the
# codec would serialize the take behind the CPU for ~zero effective
# gain, and the probe ceiling itself carries measurement noise.
COMPRESS_MARGIN = 1.3

# Policy mini-probe: streams x bytes written through the take's own
# storage plugin under PROBE_DIR, and deleted again.
_POLICY_PROBE_STREAMS = 2
_POLICY_PROBE_STREAM_BYTES = 4 << 20


def codec_for_dtype(dtype_str: str) -> Optional[str]:
    """The codec family for a manifest dtype string, or None when the
    dtype is not compressible (unknown/odd element sizes). Element size
    keys the byte-shuffle filter: ``shuf4+lz4`` for f32, ``shuf2+lz4``
    for bf16/f16, plain ``lz4`` for 1-byte dtypes (fp8/int8/uint8,
    where a shuffle is the identity)."""
    from .serialization import tensor_nbytes

    try:
        itemsize = tensor_nbytes(dtype_str, [1])
    except Exception:
        return None
    if itemsize == 1:
        return "lz4"
    if itemsize in (2, 4, 8):
        return f"shuf{itemsize}+lz4"
    return None


def codec_elem(codec: str) -> int:
    """Byte-shuffle element size encoded in a codec name. Raises
    ValueError for codec families this build cannot decode — the
    restore path surfaces that as a clear error instead of garbage."""
    if codec == "lz4":
        return 1
    if codec.startswith("shuf") and codec.endswith("+lz4"):
        try:
            elem = int(codec[4:-4])
        except ValueError:
            raise ValueError(f"unknown codec {codec!r}") from None
        if elem in (2, 4, 8):
            return elem
    raise ValueError(
        f"unknown codec {codec!r} — this snapshot was written by a newer "
        "build; upgrade to restore it"
    )


# ---------------------------------------------------------------- ceilings

# Process-global pipe ceilings by (storage label, lane), fed by every
# roofline probe sample (``scheduler._ProbeRunner``: both its write and
# its read leg) and by the policy mini-probe (the "write" lane). Newest
# sample wins: the ceiling is a live measurement, not a config belief.
_ceilings: Dict[Tuple[str, str], float] = {}
_ceilings_lock = threading.Lock()


def pipe_ceiling_key(storage) -> str:
    """Registry key for a plugin stack's pipe ceiling: the innermost
    backend class name PLUS the device/bucket it points at, so two
    same-class backends with different bandwidth — a fast local NVMe
    dir and a slow NFS/virtio fs:// mount in one process — never share
    (and poison) one sample. Filesystem plugins key on ``st_dev`` of
    the root's nearest existing ancestor (different mounts → different
    devices; sibling snapshot dirs on one disk → one shared ceiling,
    which is the reuse the probe feed exists for); object stores key on
    their bucket."""
    import os

    from .io_types import StoragePlugin
    from .storage_plugin import storage_plugin_label

    label = storage_plugin_label(storage)
    base = storage
    while isinstance(getattr(base, "inner", None), StoragePlugin):
        base = base.inner
    root = getattr(base, "root", None)
    if root:
        p = os.path.abspath(str(root))
        while True:
            try:
                return f"{label}@dev{os.stat(p).st_dev}"
            except OSError:
                parent = os.path.dirname(p)
                if parent == p:
                    break
                p = parent
    for attr in ("bucket", "bucket_name", "netloc"):
        v = getattr(base, attr, None)
        if v:
            return f"{label}@{v}"
    return label


def note_pipe_ceiling(label: str, gbps: float, lane: str = "write") -> None:
    if not label or gbps <= 0:
        return
    with _ceilings_lock:
        _ceilings[(label, lane)] = float(gbps)


def pipe_ceilings_snapshot() -> Dict[Tuple[str, str], float]:
    """Copy of every (label, lane) ceiling known to this process: the
    tune planner's view of what the probes have measured."""
    with _ceilings_lock:
        return dict(_ceilings)


def pipe_ceiling(label: str, lane: str = "write") -> Optional[float]:
    with _ceilings_lock:
        return _ceilings.get((label, lane))


def _reset_ceilings() -> None:
    """Test seam."""
    with _ceilings_lock:
        _ceilings.clear()


# ------------------------------------------------------- codec throughput

_codec_gbps: Optional[float] = None
_codec_lock = threading.Lock()


def codec_throughput_gbps() -> float:
    """Measured compression throughput of this host (GB/s of input
    consumed), cached per process: an 8 MiB f32 buffer of bf16-precision
    values through the fused native pass takes use. 0.0 without the
    native codec (the policy then always bypasses)."""
    global _codec_gbps
    with _codec_lock:
        if _codec_gbps is not None:
            return _codec_gbps
        from . import _native
        from .knobs import get_native_copy_threads

        if not _native.compression_available():
            _codec_gbps = 0.0
            return _codec_gbps
        import numpy as np

        rng = np.random.default_rng(0x7C0)
        arr = rng.standard_normal(2 << 20).astype(np.float32)
        arr = (arr.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
        buf = arr.tobytes()
        t0 = time.monotonic()
        _native.compress_tiles(
            buf, 4 << 20, 4, False, nthreads=get_native_copy_threads()
        )
        elapsed = max(time.monotonic() - t0, 1e-9)
        _codec_gbps = round(len(buf) / elapsed / 1e9, 4)
        logger.info("measured codec throughput: %.3f GB/s", _codec_gbps)
        return _codec_gbps


def _reset_codec_throughput() -> None:
    """Test seam."""
    global _codec_gbps
    with _codec_lock:
        _codec_gbps = None


# ---------------------------------------------------------------- decision


@dataclass
class CompressDecision:
    """One take's resolved compression policy, readable after the fact
    via ``LAST_DECISION``."""

    mode: str
    compress: bool
    reason: str
    codec_gbps: float = 0.0
    pipe_gbps: Optional[float] = None
    eligible_bytes: int = 0


    def to_meta(self) -> Dict[str, object]:
        """The decision as the take's telemetry records it."""
        d: Dict[str, object] = {
            "mode": self.mode,
            "decision": "compress" if self.compress else "bypass",
            "reason": self.reason,
            "codec_gbps": self.codec_gbps,
            "eligible_bytes": self.eligible_bytes,
        }
        if self.pipe_gbps is not None:
            d["pipe_gbps"] = round(self.pipe_gbps, 4)
        return d


LAST_DECISION: Optional[CompressDecision] = None


def _policy_probe(storage, event_loop, label: str) -> Optional[float]:
    """One-shot write ceiling measurement through the take's own storage
    plugin. Returns GB/s (also cached in the ceiling registry) or None."""
    import os

    from .io_types import PROBE_DIR, WriteIO

    try:
        block = os.urandom(1 << 20)
        reps = _POLICY_PROBE_STREAM_BYTES // len(block)
        buf = memoryview(block * reps)
        paths = [
            f"{PROBE_DIR}/policy_{os.getpid()}_{i}.bin"
            for i in range(_POLICY_PROBE_STREAMS)
        ]
        import asyncio

        from .io_types import run_on_loop

        async def _run() -> float:
            t0 = time.monotonic()
            await asyncio.gather(
                *(storage.write(WriteIO(path=p, buf=buf)) for p in paths)
            )
            elapsed = max(time.monotonic() - t0, 1e-9)
            await asyncio.gather(
                *(storage.delete(p) for p in paths), return_exceptions=True
            )
            return len(buf) * len(paths) / elapsed / 1e9

        gbps = run_on_loop(event_loop, _run())
        note_pipe_ceiling(label, gbps)
        return gbps
    except Exception:
        logger.warning(
            "compression policy probe failed (non-fatal; bypassing)",
            exc_info=True,
        )
        return None


def _eligible_stagers(write_reqs) -> List[object]:
    """The stagers fused compression may apply to: standalone dense
    tensor blobs (chunk blobs included) above the per-blob floor, of a
    dtype the shuffle filter understands. Slab members are not write
    requests of their own after batching, so they never appear here."""
    from .io_preparers.array import ArrayBufferStager
    from .knobs import get_compress_min_blob_bytes

    floor = get_compress_min_blob_bytes()
    out = []
    for wr in write_reqs:
        st = wr.buffer_stager
        if not isinstance(st, ArrayBufferStager):
            continue
        if not getattr(st, "compressible", True):
            continue
        entry = st.entry
        if entry is None or entry.byte_range is not None:
            continue
        if codec_for_dtype(entry.dtype) is None:
            continue
        if st.get_planned_bytes() < floor:
            continue
        out.append(st)
    return out


def apply_take_policy(write_reqs, storage, event_loop):
    """Resolve this take's compress-or-bypass decision and arm the
    eligible stagers. Called once per take, after batching and before
    scheduling; never raises (a policy failure must not fail a take)."""
    global LAST_DECISION
    try:
        decision = _apply_take_policy_impl(write_reqs, storage, event_loop)
    except Exception:
        logger.warning("compression policy failed (bypassing)", exc_info=True)
        decision = CompressDecision(
            mode="auto", compress=False, reason="policy_error"
        )
    LAST_DECISION = decision
    rec = telemetry.current()
    if rec is not None:
        rec.meta["compress"] = decision.to_meta()
    if decision.compress or decision.reason not in (
        "mode_off", "no_eligible_blobs", "below_auto_floor",
    ):
        flight.record(
            "compress_policy", op=decision.reason,
            decision="compress" if decision.compress else "bypass",
            codec_gbps=decision.codec_gbps, pipe_gbps=decision.pipe_gbps,
        )
    return decision


def _apply_take_policy_impl(write_reqs, storage, event_loop):
    from . import _native
    from .knobs import get_compress_mode, is_checksum_disabled

    mode = get_compress_mode()
    if mode == "off":
        return CompressDecision(mode=mode, compress=False, reason="mode_off")
    if is_checksum_disabled():
        # Compressed restores verify the stored bytes by checksum; with
        # checksums off there is no integrity evidence to record.
        return CompressDecision(
            mode=mode, compress=False, reason="checksums_disabled"
        )
    if not _native.compression_available():
        return CompressDecision(
            mode=mode, compress=False, reason="native_unavailable"
        )
    eligible = _eligible_stagers(write_reqs)
    if not eligible:
        return CompressDecision(
            mode=mode, compress=False, reason="no_eligible_blobs"
        )
    eligible_bytes = sum(st.get_planned_bytes() for st in eligible)
    codec_gbps = codec_throughput_gbps()
    pipe = None
    if mode == "auto":
        if eligible_bytes < AUTO_MIN_TAKE_BYTES:
            return CompressDecision(
                mode=mode,
                compress=False,
                reason="below_auto_floor",
                codec_gbps=codec_gbps,
                eligible_bytes=eligible_bytes,
            )
        label = pipe_ceiling_key(storage)
        pipe = pipe_ceiling(label)
        if pipe is None:
            pipe = _policy_probe(storage, event_loop, label)
        if pipe is None:
            return CompressDecision(
                mode=mode,
                compress=False,
                reason="no_pipe_ceiling",
                codec_gbps=codec_gbps,
                eligible_bytes=eligible_bytes,
            )
        if codec_gbps < pipe * COMPRESS_MARGIN:
            return CompressDecision(
                mode=mode,
                compress=False,
                reason="pipe_outruns_codec",
                codec_gbps=codec_gbps,
                pipe_gbps=pipe,
                eligible_bytes=eligible_bytes,
            )
        reason = "codec_outruns_pipe"
    else:
        reason = "mode_forced"
    for st in eligible:
        st.compress_codec = codec_for_dtype(st.entry.dtype)
    return CompressDecision(
        mode=mode,
        compress=True,
        reason=reason,
        codec_gbps=codec_gbps,
        pipe_gbps=pipe,
        eligible_bytes=eligible_bytes,
    )


# ------------------------------------------------------- restore helpers


def check_tile_coverage(
    location: str, n_sizes: int, raw_nbytes: int, tile_raw: int
) -> None:
    """Refuse a codec entry whose comp_tile_sizes does not COVER the
    payload: per-group/whole-blob checksums of a truncated list (buggy
    external rewriter) would all verify while the destination tail is
    never written — silent garbage. Shared by the standalone and
    chunked read paths so both decoders enforce one contract."""
    if not raw_nbytes or not tile_raw:
        return
    expected_tiles = -(-raw_nbytes // tile_raw)
    if n_sizes != expected_tiles:
        raise IOError(
            f"compressed entry {location!r} records {n_sizes} tile(s) "
            f"but its {raw_nbytes}-byte payload spans {expected_tiles} "
            f"at {tile_raw} raw bytes/tile — the snapshot metadata is "
            "inconsistent"
        )


def comp_tile_offsets(comp_sizes: List[int]) -> List[int]:
    """Start offset of each compressed tile within the stored blob."""
    out = []
    off = 0
    for s in comp_sizes:
        out.append(off)
        off += int(s)
    return out


def combined_comp_checksum(entry, t0: int, t1: int) -> Optional[str]:
    """Expected checksum of compressed tiles [t0, t1) of a codec entry,
    derived from the recorded per-tile values by CRC combine over the
    COMPRESSED tile lengths — the compressed-blob counterpart of
    ``combined_tile_checksum``. None when the range is unverifiable
    (no tiles, algorithm mismatch)."""
    from . import _native

    sizes = entry.comp_tile_sizes or []
    if not entry.tile_checksums:
        if t0 == 0 and t1 == len(sizes) == 1:
            return entry.checksum
        return None
    algo = _native.checksum_algorithm()
    crcs: List[int] = []
    lengths: List[int] = []
    for i in range(t0, t1):
        tile = entry.tile_checksums[i]
        tile_algo, _, value = tile.partition(":")
        if tile_algo != algo:
            return None
        try:
            crcs.append(int(value, 16))
        except ValueError:
            return None
        lengths.append(int(sizes[i]))
    if not crcs:
        return None
    from .io_preparers.array import _fold_crcs

    return f"{algo}:{_fold_crcs(crcs, lengths):08x}"
