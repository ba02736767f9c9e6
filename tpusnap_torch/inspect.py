"""Offline snapshot inspection, integrity scrub, materialize and diff.

Counterpart of tpusnap/inspect.py (framework-neutral, vendored with only
the package name and the tools it names changed). ``verify_snapshot``
re-reads every byte of a snapshot and checks it against the recorded
checksums without materializing any tensor: tile by tile, with the CRC
fused into the storage plugin's read, so a scrub runs at disk speed in
small constant memory. ``materialize_snapshot`` makes an incremental
snapshot self-contained by copying in the base blobs it references;
``diff_snapshots`` compares two manifests by checksum. Exposed as
``Snapshot.verify()`` and ``Snapshot.materialize()``; tpusnap's CLI is a
later slice of the port.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .manifest import (
    ChunkedTensorEntry,
    Entry,
    Manifest,
    ObjectEntry,
    PrimitiveEntry,
    ShardedEntry,
    SnapshotMetadata,
    TensorEntry,
    is_container_entry,
)
from .io_types import ReadIO, StoragePlugin
from .serialization import tensor_nbytes

__all__ = [
    "BlobCheck",
    "ScrubReport",
    "SnapshotDiff",
    "base_root_of_location",
    "diff_snapshots",
    "entry_nbytes",
    "entry_verifiable",
    "iter_blobs",
    "materialize_snapshot",
    "rank_payload_nbytes",
    "verify_snapshot",
]


def base_root_of_location(
    location: str, known_roots: Optional[List[str]] = None
) -> str:
    """Base-snapshot root (relative to the referencing snapshot) of an
    external blob location.

    ``known_roots`` — the referencing snapshot's recorded
    ``metadata.base_roots`` — is authoritative: the longest root that
    prefixes ``location`` wins, with no guessing. Locations matching no
    known root (older-format snapshots) fall back to grammar parsing:
    everything before the storage-layout segment (``<rank>/``,
    ``replicated/``, ``sharded/``, ``batched/``) that starts the blob's
    path within its own snapshot. The first segment after the leading
    ``..`` run always belongs to the base path (a relative reference
    descends into the base's directory name), so a base named by a bare
    step number ("../1000/0/app/w") parses correctly — but a MULTI-level
    base path with an interior numeric directory ("../exp/1000/final" in
    "../exp/1000/final/0/w") is ambiguous to the grammar, which is why
    writers record base_roots (ADVICE r3)."""
    if known_roots:
        best = None
        for r in known_roots:
            if (location == r or location.startswith(r + "/")) and (
                best is None or len(r) > len(best)
            ):
                best = r
        if best is not None:
            return best
    segs = location.split("/")
    i = 0
    while i < len(segs) and segs[i] == "..":
        i += 1
    j = i + 1
    while j < len(segs) and not (
        segs[j].isdigit() or segs[j] in ("replicated", "sharded", "batched")
    ):
        j += 1
    return "/".join(segs[:j]) if j < len(segs) else location


@dataclass
class _Blob:
    """One physical byte range to verify: a dense blob, a chunk, a shard,
    a slab member, or a single checksum tile of any of those."""

    manifest_path: str
    location: str
    byte_range: Optional[Tuple[int, int]]  # None = whole object
    checksum: Optional[str]  # "<algo>:<hex>" or None (unverifiable)
    detail: str = ""  # human context, e.g. "rows 0:4096" or "chunk 2"


@dataclass
class BlobCheck:
    """Outcome of verifying one physical blob range."""

    manifest_path: str
    location: str
    nbytes: int
    status: str  # "ok" | "corrupt" | "unverified"
    detail: str = ""


@dataclass
class ScrubReport:
    ok: int = 0
    corrupt: int = 0
    unverified: int = 0
    bytes_verified: int = 0
    failures: List[BlobCheck] = field(default_factory=list)
    unverified_blobs: List[BlobCheck] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return self.corrupt == 0

    def summary(self) -> str:
        gb = self.bytes_verified / 1e9
        s = (
            f"{self.ok} blob range(s) ok ({gb:.2f} GB verified), "
            f"{self.corrupt} corrupt, {self.unverified} unverified"
        )
        return s


def entry_nbytes(entry: Entry) -> int:
    """Persisted payload bytes of a leaf entry (0 for containers and
    primitives, whose values live inline in the metadata)."""
    if isinstance(entry, TensorEntry):
        return tensor_nbytes(entry.dtype, entry.shape)
    if isinstance(entry, ChunkedTensorEntry):
        return sum(entry_nbytes(c.tensor) for c in entry.chunks)
    if isinstance(entry, ShardedEntry):
        return sum(entry_nbytes(s.tensor) for s in entry.shards)
    if isinstance(entry, ObjectEntry):
        return entry.nbytes or 0
    return 0


def entry_verifiable(entry: Entry) -> bool:
    """True when every stored byte of ``entry`` has a recorded checksum
    (so a scrub can verify it; False for snapshots written with
    TPUSNAP_DISABLE_CHECKSUM=1). Primitives and containers live inline in
    the metadata and count as verifiable."""
    if isinstance(entry, TensorEntry):
        return entry.checksum is not None
    if isinstance(entry, ChunkedTensorEntry):
        return all(c.tensor.checksum is not None for c in entry.chunks)
    if isinstance(entry, ShardedEntry):
        return all(s.tensor.checksum is not None for s in entry.shards)
    if isinstance(entry, ObjectEntry):
        return entry.checksum is not None
    return True


def rank_payload_nbytes(metadata, rank: int) -> int:
    """Total payload bytes of one rank's RESTORE VIEW — what a recovery
    of this snapshot actually reads. The one definition both SLO
    surfaces share (the tracker's commit anchor and the CLI's estimated
    restore time), so they cannot silently diverge."""
    from .manifest_ops import get_manifest_for_rank

    view = get_manifest_for_rank(metadata, rank)
    return sum(
        entry_nbytes(e) for e in view.values() if not is_container_entry(e)
    )


def _tensor_blobs(path: str, entry: TensorEntry, detail: str = "") -> Iterator[_Blob]:
    """Expand one TensorEntry into its verifiable ranges. Entries carrying
    tile-grain checksums are emitted per tile (so a scrub pinpoints the
    corrupted tile and its memory footprint stays at tile size); plain
    entries are one range."""
    base = entry.byte_range[0] if entry.byte_range is not None else 0
    if entry.codec:
        # Compressed entry: the STORED blob is the concatenation of
        # independently compressed tiles, and every recorded checksum is
        # over the stored bytes — so a scrub reads compressed ranges
        # (tile i at sum(comp_tile_sizes[:i])) and verifies them exactly
        # like raw tiles. Bit-rot in a compressed tile is named per tile.
        sizes = [int(s) for s in (entry.comp_tile_sizes or [])]
        if (
            entry.tile_checksums
            and entry.tile_rows
            and len(sizes) == len(entry.tile_checksums)
        ):
            off = base
            for i, tile_crc in enumerate(entry.tile_checksums):
                yield _Blob(
                    manifest_path=path,
                    location=entry.location,
                    byte_range=(off, off + sizes[i]),
                    checksum=tile_crc,
                    detail=(detail + " " if detail else "")
                    + f"comp tile {i} ({entry.codec})",
                )
                off += sizes[i]
            return
        yield _Blob(
            manifest_path=path,
            location=entry.location,
            byte_range=(base, base + sum(sizes)),
            checksum=entry.checksum,
            detail=(detail + " " if detail else "")
            + f"compressed ({entry.codec})",
        )
        return
    nbytes = tensor_nbytes(entry.dtype, entry.shape)
    if entry.tile_checksums and entry.tile_rows:
        n_rows = entry.shape[0]
        row_nbytes = nbytes // n_rows if n_rows else 0
        t = entry.tile_rows
        for i, tile_crc in enumerate(entry.tile_checksums):
            r0 = i * t
            r1 = min(r0 + t, n_rows)
            yield _Blob(
                manifest_path=path,
                location=entry.location,
                byte_range=(base + r0 * row_nbytes, base + r1 * row_nbytes),
                checksum=tile_crc,
                detail=(detail + " " if detail else "") + f"rows {r0}:{r1}",
            )
        return
    yield _Blob(
        manifest_path=path,
        location=entry.location,
        byte_range=(base, base + nbytes),
        checksum=entry.checksum,
        detail=detail,
    )


def iter_blobs(manifest: Manifest) -> Iterator[_Blob]:
    """Every physical byte range a snapshot's manifest references, with
    its expected checksum. Walks the RAW global manifest (keys are
    ``rank/logical_path``), where replicated entries are already
    consolidated onto rank 0 and each rank's sharded entry holds only the
    shards that rank wrote — so every stored byte is yielded exactly once.
    """
    seen: set = set()
    for path, entry in manifest.items():
        if is_container_entry(entry) or isinstance(entry, PrimitiveEntry):
            continue
        blobs: Iterator[_Blob]
        if isinstance(entry, TensorEntry):
            blobs = _tensor_blobs(path, entry)
        elif isinstance(entry, ChunkedTensorEntry):
            blobs = (
                b
                for i, c in enumerate(entry.chunks)
                for b in _tensor_blobs(path, c.tensor, detail=f"chunk {i}")
            )
        elif isinstance(entry, ShardedEntry):
            blobs = (
                b
                for s in entry.shards
                for b in _tensor_blobs(
                    path, s.tensor, detail=f"shard @{s.offsets}"
                )
            )
        elif isinstance(entry, ObjectEntry):
            br = (0, entry.nbytes) if entry.nbytes is not None else None
            blobs = iter(
                [_Blob(path, entry.location, br, entry.checksum)]
            )
        else:
            continue
        for b in blobs:
            key = (b.location, b.byte_range)
            if key in seen:
                continue
            seen.add(key)
            yield b


def _entry_tensors(entry: Entry):
    """Every TensorEntry/ObjectEntry carrying a ``location`` in ``entry``."""
    if isinstance(entry, (TensorEntry, ObjectEntry)):
        yield entry
    elif isinstance(entry, ChunkedTensorEntry):
        for c in entry.chunks:
            yield c.tensor
    elif isinstance(entry, ShardedEntry):
        for s in entry.shards:
            yield s.tensor


def materialize_snapshot(
    path: str,
    storage_options: Optional[Dict[str, Any]] = None,
    resources: Optional[
        Tuple[asyncio.AbstractEventLoop, StoragePlugin]
    ] = None,
) -> Dict[str, int]:
    """Make an incremental snapshot self-contained: copy every blob it
    references from base snapshots (``../`` locations) into this
    snapshot, rewrite the manifest, and re-commit ``.snapshot_metadata``.
    Afterwards the base snapshot(s) may be deleted.

    Blobs are copied whole (slab references keep their byte ranges),
    two in flight so one blob's read overlaps another's write. Before
    the manifest is committed, every copied range is verified against
    its recorded checksum — bit-rot in a base is caught HERE, while the
    base still exists, not after the user deleted it. Peak memory: the
    copy phase holds up to 2 whole blobs, the verification phase up to
    4 scratch buffers of the largest copied blob (all bounded by the
    max-chunk/max-shard knobs, 512 MB class each). The metadata rewrite itself is
    atomic (temp + rename on fs; single PUT on object stores), so a
    failure at any point leaves the snapshot valid and base-referencing.

    ``resources`` lets a caller pass an existing (loop, storage) pair
    (``Snapshot.materialize`` reuses its cached ones); they are left
    open. Returns ``{"blobs_copied": N, "bytes_copied": N}``.
    """
    from .io_types import WriteIO
    from .storage_plugin import url_to_storage_plugin_in_event_loop

    owns_resources = resources is None
    if owns_resources:
        event_loop = asyncio.new_event_loop()
        storage = None
    else:
        event_loop, storage = resources
    local_for: Dict[str, str] = {}
    bytes_copied = 0
    try:
        if storage is None:
            storage = url_to_storage_plugin_in_event_loop(
                path, event_loop, storage_options
            )
        try:
            metadata = _read_metadata(storage, event_loop, path)

            # Map each distinct external location to its local home: the
            # blob's path within its base snapshot (unique — locations
            # embed logical paths or slab uuids).
            for entry in metadata.manifest.values():
                for t in _entry_tensors(entry):
                    if not t.location.startswith("../"):
                        continue
                    base = base_root_of_location(
                        t.location, metadata.base_roots
                    )
                    local = t.location[len(base) + 1 :]
                    prior = local_for.setdefault(t.location, local)
                    if prior != local:  # pragma: no cover - defensive
                        raise RuntimeError(
                            f"conflicting local paths for {t.location!r}"
                        )
            if not local_for:
                return {"blobs_copied": 0, "bytes_copied": 0}
            collisions: Dict[str, str] = {}
            for ext, local in local_for.items():
                if collisions.setdefault(local, ext) != ext:
                    raise RuntimeError(
                        f"two base blobs ({collisions[local]!r}, {ext!r}) "
                        f"map to the same local path {local!r}; cannot "
                        "materialize"
                    )

            # Two copies in flight: one blob's read overlaps another's
            # write. Not more — each in-flight copy holds a whole blob
            # (512 MB class) in memory.
            async def _copy_one(pair, _ctx) -> int:
                ext, local = pair
                blob_io = ReadIO(path=ext)  # whole object
                await storage.read(blob_io)
                data = blob_io.buf.getbuffer()
                await storage.write(WriteIO(path=local, buf=data))
                return data.nbytes

            bytes_copied = sum(
                _bounded_run(
                    event_loop, sorted(local_for.items()), _copy_one, 2
                )
            )

            for entry in metadata.manifest.values():
                for t in _entry_tensors(entry):
                    if t.location in local_for:
                        t.location = local_for[t.location]

            # Verify the copied bytes against the manifest checksums
            # BEFORE committing: corruption in a base must surface while
            # the base still exists, not after the user retires it.
            copied_locations = set(local_for.values())
            to_check = [
                b
                for b in iter_blobs(metadata.manifest)
                if b.location in copied_locations
            ]
            bad = [
                c
                for c in _run_verifications(storage, event_loop, to_check)
                if c.status == "corrupt"
            ]
            if bad:
                detail = "; ".join(
                    f"{c.manifest_path} ({c.detail})" for c in bad[:5]
                )
                raise RuntimeError(
                    f"{len(bad)} copied blob range(s) failed checksum "
                    f"verification — the BASE snapshot is corrupt; the "
                    f"manifest was NOT rewritten and still references the "
                    f"base: {detail}"
                )

            from .manifest import encode_metadata
            from .snapshot import SNAPSHOT_METADATA_FNAME

            metadata.base_roots = None  # self-contained now
            # durable=True: this REWRITES an already-committed snapshot's
            # metadata — power loss must never tear or lose it (fsync is
            # cheap here; no multi-GB take preceded it).
            storage.sync_write_atomic(
                WriteIO(
                    path=SNAPSHOT_METADATA_FNAME,
                    buf=encode_metadata(metadata),
                ),
                event_loop,
                durable=True,
            )
        finally:
            if owns_resources:
                storage.sync_close(event_loop)
    finally:
        if owns_resources:
            event_loop.close()
    return {"blobs_copied": len(local_for), "bytes_copied": bytes_copied}


@dataclass
class SnapshotDiff:
    """Manifest-level diff of two snapshots (by recorded checksums — no
    data is read). Paths are logical (``rank/...``)."""

    added: List[str] = field(default_factory=list)
    removed: List[str] = field(default_factory=list)
    changed: List[str] = field(default_factory=list)  # provably different
    identical: List[str] = field(default_factory=list)
    # Undecidable without reading data: a side lacks checksums, or the
    # two snapshots stored the same-typed value in incomparable layouts
    # (different chunk/shard geometry, dense vs chunked).
    unknown: List[str] = field(default_factory=list)

    @property
    def same(self) -> bool:
        """Provably identical: every path matched by checksum."""
        return not (self.added or self.removed or self.changed or self.unknown)

    @property
    def differs(self) -> bool:
        """Provably different (unknown entries do not count)."""
        return bool(self.added or self.removed or self.changed)

    def summary(self) -> str:
        return (
            f"{len(self.identical)} identical, {len(self.changed)} changed, "
            f"{len(self.added)} added, {len(self.removed)} removed"
            + (f", {len(self.unknown)} undecidable" if self.unknown else "")
        )


def _rowwise_fold(entry) -> Optional[str]:
    """Whole-array checksum of a dense or chunked tensor entry, derived
    by CRC combine over in-order row chunks when necessary — so the same
    content stored in DIFFERENT row-chunk geometries (a tile-grain
    incremental take re-chunks an array on the base's checksum-tile
    grid) still compares equal. None when not derivable (missing
    checksums, non-row chunking, or a checksum algorithm this build
    cannot combine)."""
    from . import _native

    algo = _native.checksum_algorithm()
    if isinstance(entry, TensorEntry):
        if entry.codec:
            # Compressed: the checksum is over STORED bytes — only
            # comparable against another entry of the same codec/layout
            # (the fingerprint's geometry carries the codec).
            return None
        if entry.checksum and entry.checksum.startswith(algo + ":"):
            return entry.checksum
        return None
    if not isinstance(entry, ChunkedTensorEntry) or not entry.chunks:
        return None
    if any(c.tensor.codec for c in entry.chunks):
        # Compressed chunks: per-chunk checksums are over stored bytes
        # at compressed offsets; a row-length CRC combine would be
        # meaningless. Compared chunk-by-chunk with codec-aware
        # geometry instead.
        return None
    row_nbytes = (
        tensor_nbytes(entry.dtype, entry.shape[1:])
        if len(entry.shape) > 1
        else tensor_nbytes(entry.dtype, [1])
    )
    chunks = sorted(entry.chunks, key=lambda c: c.offsets[0])
    expect = 0
    folded: Optional[int] = None
    for c in chunks:
        if (
            c.offsets[0] != expect
            or any(o != 0 for o in c.offsets[1:])
            or list(c.sizes[1:]) != list(entry.shape[1:])
            or not c.tensor.checksum
            or not c.tensor.checksum.startswith(algo + ":")
        ):
            return None
        val = int(c.tensor.checksum.partition(":")[2], 16)
        n = c.sizes[0] * row_nbytes
        folded = val if folded is None else _native.crc_combine(folded, val, n)
        expect += c.sizes[0]
    if expect != entry.shape[0] or folded is None:
        return None
    return f"{algo}:{folded & 0xFFFFFFFF:08x}"


def _entry_fingerprint(entry: Entry):
    """(identity, geometry, content) of a leaf entry.

    - ``identity``: what the value IS (dtype/shape or object type) — an
      identity mismatch is a real change regardless of layout.
    - ``geometry``: how it was stored (dense/chunked/sharded + boxes) —
      checksums are only comparable between equal geometries. Dense and
      row-chunked entries whose checksums fold to a whole-array value
      normalize to the SAME ("rows",) geometry, so a tile-grain
      incremental take (which re-chunks on the tile grid) diffs as
      identical/changed against its dense base instead of undecidable.
    - ``content``: the recorded checksums, or None when absent.

    Locations are excluded throughout — a blob that moved (slab
    repacking, incremental reference) but hashes identically is the
    same content."""
    if isinstance(entry, PrimitiveEntry):
        return (("prim", entry.dtype), (), entry.serialized_value)
    if isinstance(entry, (TensorEntry, ChunkedTensorEntry)):
        folded = _rowwise_fold(entry)
        if folded is not None:
            return (
                ("tensor", entry.dtype, tuple(entry.shape)),
                ("rows",),
                folded,
            )
    if isinstance(entry, TensorEntry):
        # Compressed entries' checksums are over STORED bytes, so they
        # only compare against entries of the same codec: raw-vs-
        # compressed of identical content must read undecidable (a
        # geometry mismatch), never falsely "changed".
        geom = ("dense", entry.codec) if entry.codec else ("dense",)
        return (
            ("tensor", entry.dtype, tuple(entry.shape)),
            geom,
            entry.checksum,
        )
    if isinstance(entry, ChunkedTensorEntry):
        parts = tuple(c.tensor.checksum for c in entry.chunks)
        return (
            ("tensor", entry.dtype, tuple(entry.shape)),
            (
                "chunked",
                tuple(
                    (tuple(c.offsets), tuple(c.sizes), c.tensor.codec)
                    if c.tensor.codec
                    else (tuple(c.offsets), tuple(c.sizes))
                    for c in entry.chunks
                ),
            ),
            None if any(p is None for p in parts) else parts,
        )
    if isinstance(entry, ShardedEntry):
        shards = sorted(
            entry.shards, key=lambda s: (tuple(s.offsets), tuple(s.sizes))
        )
        parts = tuple(s.tensor.checksum for s in shards)
        return (
            ("tensor", entry.dtype, tuple(entry.shape)),
            ("sharded", tuple((tuple(s.offsets), tuple(s.sizes)) for s in shards)),
            None if any(p is None for p in parts) else parts,
        )
    if isinstance(entry, ObjectEntry):
        return (("object", entry.obj_type), (), entry.checksum)
    return (("?", type(entry).__name__), (), None)


def _read_metadata(
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
    path: str,
) -> SnapshotMetadata:
    """Read + parse ``.snapshot_metadata`` through an existing plugin
    (the one shared metadata-loading block for scrub/materialize/diff)."""
    from .snapshot import SNAPSHOT_METADATA_FNAME

    from .manifest import decode_metadata

    read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
    try:
        storage.sync_read(read_io, event_loop)
    except Exception as e:
        raise RuntimeError(
            f"Failed to read snapshot metadata at {path} — not a "
            "snapshot, or an aborted/incomplete one (run "
            "`python -m tpusnap_torch fsck` to classify)"
        ) from e
    return decode_metadata(read_io.buf.getvalue())


def load_snapshot_metadata(
    path: str,
    storage_options: Optional[Dict[str, Any]] = None,
) -> SnapshotMetadata:
    """Read and parse a snapshot's ``.snapshot_metadata`` standalone
    (own short-lived event loop + plugin)."""
    from .storage_plugin import url_to_storage_plugin_in_event_loop

    loop = asyncio.new_event_loop()
    try:
        storage = url_to_storage_plugin_in_event_loop(
            path, loop, storage_options
        )
        try:
            return _read_metadata(storage, loop, path)
        finally:
            storage.sync_close(loop)
    finally:
        loop.close()


def diff_snapshots(
    path_a: str,
    path_b: str,
    storage_options: Optional[Dict[str, Any]] = None,
) -> SnapshotDiff:
    """Compare two snapshots entry-by-entry using only their manifests'
    recorded checksums — O(metadata), no blob reads. ``changed`` means
    the content provably differs (identity mismatch, or equal layouts
    with different checksums); ``unknown`` means equality cannot be
    decided cheaply (missing checksums, or same-typed values stored in
    incomparable chunk/shard geometries)."""
    ma = load_snapshot_metadata(path_a, storage_options).manifest
    mb = load_snapshot_metadata(path_b, storage_options).manifest
    leaves_a = {p: e for p, e in ma.items() if not is_container_entry(e)}
    leaves_b = {p: e for p, e in mb.items() if not is_container_entry(e)}
    out = SnapshotDiff()
    for p in sorted(set(leaves_a) | set(leaves_b)):
        if p not in leaves_b:
            out.removed.append(p)
        elif p not in leaves_a:
            out.added.append(p)
        else:
            ia, ga, ca = _entry_fingerprint(leaves_a[p])
            ib, gb, cb = _entry_fingerprint(leaves_b[p])
            if ia != ib:
                out.changed.append(p)  # different dtype/shape/type
            elif ca is None or cb is None or ga != gb:
                out.unknown.append(p)
            elif ca == cb:
                out.identical.append(p)
            else:
                out.changed.append(p)
    return out


async def _verify_one(
    storage: StoragePlugin,
    blob: _Blob,
    scratch: Dict[str, Any],
) -> BlobCheck:
    """Read + verify one blob range. ``scratch`` is a per-slot buffer
    holder reused across the ranges a scrub slot processes."""
    from . import _native

    n = blob.byte_range[1] - blob.byte_range[0] if blob.byte_range else None
    mk = lambda status, detail="": BlobCheck(  # noqa: E731
        manifest_path=blob.manifest_path,
        location=blob.location,
        nbytes=n or 0,
        status=status,
        detail=" ".join(x for x in (blob.detail, detail) if x),
    )
    into = None
    if n is not None and n > 0:
        buf = scratch.get("buf")
        if buf is None or buf.nbytes < n:
            buf = _native.aligned_empty(max(n, 1 << 20))
            scratch["buf"] = buf
        into = memoryview(buf)[:n]
    read_io = ReadIO(
        path=blob.location,
        byte_range=blob.byte_range,
        into=into,
        want_crc=blob.checksum is not None,
    )
    try:
        await storage.read(read_io)
    except Exception as e:
        return mk("corrupt", f"read failed: {e}")
    if blob.checksum is None:
        return mk("unverified", "no checksum recorded")
    algo, _, _ = blob.checksum.partition(":")
    try:
        if read_io.in_place and read_io.crc32c is not None:
            # Fused read-time CRC (fs plugin): verify the 4-byte value.
            _native.verify_checksum_value(
                read_io.crc32c,
                read_io.crc_algo,
                blob.checksum,
                blob.manifest_path,
            )
            if read_io.crc_algo != algo:
                return mk("unverified", f"algorithm mismatch ({algo})")
        else:
            data = read_io.buf.getbuffer()
            if n is not None and data.nbytes != n:
                return mk(
                    "corrupt", f"short read: got {data.nbytes} of {n} bytes"
                )
            if _native.checksum_algorithm() != algo:
                return mk("unverified", f"algorithm mismatch ({algo})")
            _native.verify_checksum(data, blob.checksum, blob.manifest_path)
    except _native.ChecksumError as e:
        return mk("corrupt", str(e))
    return mk("ok")


def _bounded_run(
    event_loop: asyncio.AbstractEventLoop,
    items,
    worker,
    concurrency: int,
    slot_ctx=dict,
):
    """Run ``await worker(item, ctx)`` over ``items`` with ``concurrency``
    slots; each slot owns one reusable ``slot_ctx()`` (e.g. a scratch
    buffer holder). Results come back in input order. On any failure the
    sibling slot tasks are cancelled AND drained — gather alone would
    strand them on the caller's (possibly cached-Snapshot, reused) loop,
    where the next run_until_complete resumes them mid-close. The one
    bounded-concurrency engine for the scrub and materialize copies."""

    async def run():
        work = enumerate(items)  # shared: each slot pulls the next, O(n)
        results = []

        async def slot() -> None:
            ctx = slot_ctx()
            for i, item in work:
                results.append((i, await worker(item, ctx)))

        tasks = [
            asyncio.ensure_future(slot())
            for _ in range(max(1, concurrency))
        ]
        try:
            await asyncio.gather(*tasks)
        except BaseException:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise
        return [r for _, r in sorted(results, key=lambda ir: ir[0])]

    from .io_types import run_on_loop

    return run_on_loop(event_loop, run())


def _run_verifications(
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
    blobs: List[_Blob],
    concurrency: Optional[int] = None,
) -> List[BlobCheck]:
    """Verify blob ranges with ``concurrency`` reads in flight — the scrub
    is latency-bound on serial tile reads otherwise. Each slot owns one
    reusable scratch buffer, so peak memory is concurrency x the largest
    range a slot sees (TPUSNAP_SCRUB_CONCURRENCY, default 4)."""
    import logging
    import time

    if concurrency is None:
        from .knobs import get_scrub_concurrency

        concurrency = get_scrub_concurrency()
    logger = logging.getLogger(__name__)
    progress = {"count": 0, "bytes": 0, "last_log": time.monotonic()}

    async def verify_one(blob, scratch) -> BlobCheck:
        check = await _verify_one(storage, blob, scratch)
        progress["count"] += 1
        progress["bytes"] += check.nbytes
        now = time.monotonic()
        if now - progress["last_log"] >= 10.0:
            progress["last_log"] = now
            logger.info(
                "scrub progress: %d/%d ranges, %.2f GB verified",
                progress["count"],
                len(blobs),
                progress["bytes"] / 1e9,
            )
        return check

    # Results return in manifest order, not completion order: scrub
    # output must be deterministic across runs (operators diff it).
    return _bounded_run(event_loop, blobs, verify_one, concurrency)


def verify_snapshot(
    path: str,
    storage_options: Optional[Dict[str, Any]] = None,
    metadata: Optional[SnapshotMetadata] = None,
    resources: Optional[
        Tuple[asyncio.AbstractEventLoop, StoragePlugin]
    ] = None,
) -> ScrubReport:
    """Stream-verify every blob of the snapshot at ``path`` against the
    checksums recorded in its manifest.

    Returns a :class:`ScrubReport`; ``report.clean`` is False when any
    range failed (bit-rot, truncation, or a missing blob). Ranges are
    verified with 4 reads in flight; peak memory is 4 scratch buffers of
    the largest range each slot sees — tile-sized (16 MiB class) for
    large arrays carrying tile checksums, up to the blob size (512 MB
    class) otherwise. ``resources`` lets a caller
    that already holds a (loop, storage) pair — ``Snapshot.verify`` reuses
    its cached ones — skip plugin construction; they are left open.
    """
    from .storage_plugin import url_to_storage_plugin_in_event_loop

    report = ScrubReport()
    owns_resources = resources is None
    if owns_resources:
        event_loop = asyncio.new_event_loop()
        storage = None
    else:
        event_loop, storage = resources
    try:
        if storage is None:
            storage = url_to_storage_plugin_in_event_loop(
                path, event_loop, storage_options
            )
        try:
            if metadata is None:
                metadata = _read_metadata(storage, event_loop, path)
            checks = _run_verifications(
                storage, event_loop, list(iter_blobs(metadata.manifest))
            )
            for check in checks:
                if check.status == "ok":
                    report.ok += 1
                    report.bytes_verified += check.nbytes
                elif check.status == "corrupt":
                    report.corrupt += 1
                    report.failures.append(check)
                else:
                    report.unverified += 1
                    report.unverified_blobs.append(check)
        finally:
            if owns_resources:
                storage.sync_close(event_loop)
    finally:
        if owns_resources:
            event_loop.close()
    return report
