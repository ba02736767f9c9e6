"""Typed manifest model describing everything persisted in a snapshot.

Counterpart of tpusnap/manifest.py, copied unchanged except that the
metadata is parsed as JSON only (tpusnap writes JSON; its YAML fallback
reads hand-edited files, which the port does not accept). docs/format.md
is the contract both packages follow:

- ``TensorEntry``     — one dense tensor blob (location, serializer, dtype,
                        shape, replicated flag, optional byte range when the
                        blob lives inside a batched slab).
- ``ShardedEntry`` / ``ChunkedTensorEntry`` — parsed so a manifest that
                        holds them loads; the port writes neither yet.
- ``ObjectEntry``     — arbitrary pickled object blob.
- ``PrimitiveEntry``  — int/str/bool/float/bytes inlined into the metadata.
- ``DictEntry`` / ``ListEntry`` / ``OrderedDictEntry`` / ``TupleEntry`` —
  containers, so the original nesting can be rebuilt on restore.
"""

from __future__ import annotations

import base64
import json
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union


Manifest = Dict[str, "Entry"]


class MetadataError(RuntimeError):
    """The ``.snapshot_metadata`` file is torn or bit-rotted: it fails
    its self-checksum, is not valid UTF-8, or does not parse. Raised
    instead of a bare JSON/Unicode traceback so operators see a
    storage-integrity verdict, not a parser internals dump."""


@dataclass
class Entry:
    """Base for all manifest entries; ``type`` is the tagged-union key."""

    type: str


@dataclass
class TensorEntry(Entry):
    location: str
    serializer: str
    dtype: str
    shape: List[int]
    replicated: bool
    byte_range: Optional[List[int]] = None  # [start, end) within location
    # "<algo>:<8-hex>" over this entry's serialized bytes (its byte_range
    # within location, or the whole blob). Recorded at stage time; verified
    # on read unless TPUSNAP_DISABLE_CHECKSUM=1. Beyond the reference,
    # which cannot detect a flipped bit on restore.
    checksum: Optional[str] = None
    # Tile-grain checksums for memory-budgeted partial reads: the blob is
    # hashed ONCE at stage time in row-tiles of ``tile_rows`` rows; the
    # whole-blob ``checksum`` is derived by CRC combine. Budget-tiled
    # reads align to these boundaries and verify each read range by
    # combining the covered tiles' values — so the huge-tensor-under-
    # budget path detects corruption too, at no extra hash pass anywhere.
    tile_rows: Optional[int] = None
    tile_checksums: Optional[List[str]] = None
    # Second, independent hash backing incremental-dedup equality
    # ("<algo>:<16-hex>", algo xxh64 native / sha256-64 fallback). A
    # single 32-bit CRC leaves a ~2^-32 silent-collision channel per
    # blob-take; dedup of a tile-LESS blob requires BOTH the CRC and
    # this value to match. Tiled blobs dedup whole on their multiple
    # independent tile CRCs; ``tile_dedup_hashes`` (recorded on
    # incremental takes) additionally gives each TILE a 64-bit value so
    # tile-grain dedup decisions are equally strong.
    dedup_hash: Optional[str] = None
    tile_dedup_hashes: Optional[List[str]] = None
    # Fused tile compression (tpusnap.compress). When ``codec`` is set
    # the STORED blob is the concatenation of independently compressed
    # checksum tiles: ``comp_tile_sizes[i]`` is tile i's stored size
    # (a tile stored raw has size == its uncompressed tile size — the
    # codec never stores a same-size compressed stream), tile i starts
    # at sum(comp_tile_sizes[:i]) within the blob, and
    # ``uncompressed_nbytes`` is the logical payload size. ALL recorded
    # checksums/dedup hashes of a codec entry — ``checksum``,
    # ``tile_checksums``, ``dedup_hash``, ``tile_dedup_hashes`` — are
    # over the STORED (compressed) bytes, so the journal/salvage/
    # upload-journal dual-hash evidence rule and scrub hold unchanged.
    # Absent on uncompressed entries; old snapshots parse identically.
    # ``uncompressed_dedup_hash`` (dedup-recording takes only) is the
    # ONE exception to the stored-bytes rule: a dual hash
    # ("<crc-algo>:<crc32>+xxh64:<xxh64>") of the RAW payload, recorded
    # so the NEXT incremental take can prove an unchanged blob with a
    # multi-GB/s hash pass instead of re-running the codec — the codec
    # is deterministic, so equal raw bytes imply equal stored bytes.
    # Never used to verify storage; purely write-skip evidence.
    codec: Optional[str] = None
    uncompressed_nbytes: Optional[int] = None
    comp_tile_sizes: Optional[List[int]] = None
    uncompressed_dedup_hash: Optional[str] = None

    def __init__(
        self,
        location: str,
        serializer: str,
        dtype: str,
        shape: Sequence[int],
        replicated: bool,
        byte_range: Optional[Sequence[int]] = None,
        checksum: Optional[str] = None,
        tile_rows: Optional[int] = None,
        tile_checksums: Optional[Sequence[str]] = None,
        dedup_hash: Optional[str] = None,
        tile_dedup_hashes: Optional[Sequence[str]] = None,
        codec: Optional[str] = None,
        uncompressed_nbytes: Optional[int] = None,
        comp_tile_sizes: Optional[Sequence[int]] = None,
        uncompressed_dedup_hash: Optional[str] = None,
    ) -> None:
        super().__init__(type="Tensor")
        self.location = location
        self.serializer = serializer
        self.dtype = dtype
        self.shape = list(shape)
        self.replicated = replicated
        self.byte_range = list(byte_range) if byte_range is not None else None
        self.checksum = checksum
        self.tile_rows = tile_rows
        self.tile_checksums = (
            list(tile_checksums) if tile_checksums is not None else None
        )
        self.dedup_hash = dedup_hash
        self.tile_dedup_hashes = (
            list(tile_dedup_hashes) if tile_dedup_hashes is not None else None
        )
        self.codec = codec
        self.uncompressed_nbytes = uncompressed_nbytes
        self.comp_tile_sizes = (
            list(comp_tile_sizes) if comp_tile_sizes is not None else None
        )
        self.uncompressed_dedup_hash = uncompressed_dedup_hash

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TensorEntry":
        return cls(
            location=d["location"],
            serializer=d["serializer"],
            dtype=d["dtype"],
            shape=d["shape"],
            replicated=d["replicated"],
            byte_range=d.get("byte_range"),
            checksum=d.get("checksum"),
            tile_rows=d.get("tile_rows"),
            tile_checksums=d.get("tile_checksums"),
            dedup_hash=d.get("dedup_hash"),
            tile_dedup_hashes=d.get("tile_dedup_hashes"),
            codec=d.get("codec"),
            uncompressed_nbytes=d.get("uncompressed_nbytes"),
            comp_tile_sizes=d.get("comp_tile_sizes"),
            uncompressed_dedup_hash=d.get("uncompressed_dedup_hash"),
        )


@dataclass
class Shard:
    offsets: List[int]
    sizes: List[int]
    tensor: TensorEntry

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Shard":
        return cls(
            offsets=list(d["offsets"]),
            sizes=list(d["sizes"]),
            tensor=TensorEntry.from_dict(d["tensor"]),
        )


@dataclass
class ShardedEntry(Entry):
    shards: List[Shard]
    dtype: str = ""
    shape: List[int] = field(default_factory=list)

    def __init__(
        self,
        shards: List[Shard],
        dtype: str = "",
        shape: Optional[Sequence[int]] = None,
    ) -> None:
        super().__init__(type="Sharded")
        self.shards = shards
        self.dtype = dtype or (shards[0].tensor.dtype if shards else "")
        if shape is not None:
            self.shape = list(shape)
        elif shards:
            # Global shape inferred as the max extent covered by any shard.
            ndim = len(shards[0].offsets)
            self.shape = [
                max(s.offsets[d] + s.sizes[d] for s in shards) for d in range(ndim)
            ]
        else:
            self.shape = []

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ShardedEntry":
        return cls(
            shards=[Shard.from_dict(s) for s in d["shards"]],
            dtype=d.get("dtype", ""),
            shape=d.get("shape"),
        )


# A chunk of a ChunkedTensorEntry has the same (offsets, sizes, tensor)
# structure as a shard; reuse the type (reference manifest.py:113-116 types
# chunks as List[Shard] for the same reason).
Chunk = Shard


@dataclass
class ChunkedTensorEntry(Entry):
    dtype: str
    shape: List[int]
    chunks: List[Chunk]
    replicated: bool

    def __init__(
        self,
        dtype: str,
        shape: Sequence[int],
        chunks: List[Chunk],
        replicated: bool,
    ) -> None:
        super().__init__(type="ChunkedTensor")
        self.dtype = dtype
        self.shape = list(shape)
        self.chunks = chunks
        self.replicated = replicated

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChunkedTensorEntry":
        return cls(
            dtype=d["dtype"],
            shape=d["shape"],
            chunks=[Chunk.from_dict(c) for c in d["chunks"]],
            replicated=d["replicated"],
        )


@dataclass
class ObjectEntry(Entry):
    location: str
    serializer: str
    obj_type: str
    replicated: bool
    nbytes: Optional[int] = None  # serialized size; drives read memory budget
    checksum: Optional[str] = None  # "<algo>:<8-hex>" (see TensorEntry)
    dedup_hash: Optional[str] = None  # "<algo>:<16-hex>" (see TensorEntry)

    def __init__(
        self,
        location: str,
        serializer: str,
        obj_type: str,
        replicated: bool,
        nbytes: Optional[int] = None,
        checksum: Optional[str] = None,
        dedup_hash: Optional[str] = None,
    ) -> None:
        super().__init__(type="object")
        self.location = location
        self.serializer = serializer
        self.obj_type = obj_type
        self.replicated = replicated
        self.nbytes = nbytes
        self.checksum = checksum
        self.dedup_hash = dedup_hash

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ObjectEntry":
        return cls(
            location=d["location"],
            serializer=d["serializer"],
            obj_type=d["obj_type"],
            replicated=d["replicated"],
            nbytes=d.get("nbytes"),
            checksum=d.get("checksum"),
            dedup_hash=d.get("dedup_hash"),
        )


@dataclass
class ListEntry(Entry):
    def __init__(self) -> None:
        super().__init__(type="list")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ListEntry":
        return cls()


@dataclass
class TupleEntry(Entry):
    """JAX extension: optax/flax pytrees are full of tuples/NamedTuples;
    the reference would have pickled them whole (io_preparer.py:125). We
    flatten them like lists and rebuild a tuple on inflate."""

    def __init__(self) -> None:
        super().__init__(type="tuple")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TupleEntry":
        return cls()


@dataclass
class DictEntry(Entry):
    keys: List[Union[str, int]]

    def __init__(self, keys: List[Union[str, int]]) -> None:
        super().__init__(type="dict")
        self.keys = keys

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DictEntry":
        return cls(keys=d["keys"])


@dataclass
class OrderedDictEntry(Entry):
    keys: List[Union[str, int]]

    def __init__(self, keys: List[Union[str, int]]) -> None:
        super().__init__(type="OrderedDict")
        self.keys = keys

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OrderedDictEntry":
        return cls(keys=d["keys"])


@dataclass
class PrimitiveEntry(Entry):
    """int/float/bool/str/bytes inlined directly into the metadata.

    Floats are stored bit-exactly (base64 of the IEEE-754 double) WITH a
    human-readable companion value so manifests stay auditable — the
    reference stores both for the same reason (manifest.py:221-245).
    Restore always uses the bit-exact form.
    """

    dtype: str
    layout: str
    serialized_value: str
    replicated: bool
    readable: Optional[str] = None

    def __init__(
        self,
        dtype: str,
        layout: str,
        serialized_value: str,
        replicated: bool,
        readable: Optional[str] = None,
    ) -> None:
        super().__init__(type="primitive")
        self.dtype = dtype
        self.layout = layout
        self.serialized_value = serialized_value
        self.replicated = replicated
        self.readable = readable

    SUPPORTED_TYPES = (int, float, bool, str, bytes)

    @classmethod
    def supported(cls, obj: Any) -> bool:
        # bool is a subclass of int; keep explicit for clarity.
        return type(obj) in cls.SUPPORTED_TYPES

    @classmethod
    def from_object(cls, obj: Any, replicated: bool = False) -> "PrimitiveEntry":
        t = type(obj)
        if t is int:
            return cls("int", "text", str(obj), replicated)
        if t is bool:
            return cls("bool", "text", str(obj), replicated)
        if t is str:
            return cls("str", "text", obj, replicated)
        if t is float:
            packed = base64.b64encode(struct.pack("<d", obj)).decode("ascii")
            return cls("float", "b64_le_f64", packed, replicated, readable=repr(obj))
        if t is bytes:
            return cls("bytes", "b64", base64.b64encode(obj).decode("ascii"), replicated)
        raise TypeError(f"Unsupported primitive type: {t}")

    def get_value(self) -> Any:
        if self.dtype == "int":
            return int(self.serialized_value)
        if self.dtype == "bool":
            return self.serialized_value == "True"
        if self.dtype == "str":
            return self.serialized_value
        if self.dtype == "float":
            if self.layout == "b64_le_f64":
                return struct.unpack("<d", base64.b64decode(self.serialized_value))[0]
            return float(self.serialized_value)
        if self.dtype == "bytes":
            return base64.b64decode(self.serialized_value)
        raise TypeError(f"Unsupported primitive dtype: {self.dtype}")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PrimitiveEntry":
        return cls(
            dtype=d["dtype"],
            layout=d["layout"],
            serialized_value=d["serialized_value"],
            replicated=d["replicated"],
            readable=d.get("readable"),
        )


_ENTRY_TYPES = {
    "Tensor": TensorEntry,
    "Sharded": ShardedEntry,
    "ChunkedTensor": ChunkedTensorEntry,
    "object": ObjectEntry,
    "list": ListEntry,
    "tuple": TupleEntry,
    "dict": DictEntry,
    "OrderedDict": OrderedDictEntry,
    "primitive": PrimitiveEntry,
}


def _entry_to_dict(entry: Entry) -> Dict[str, Any]:
    def convert(v: Any) -> Any:
        if isinstance(v, Shard):
            return {
                "offsets": v.offsets,
                "sizes": v.sizes,
                "tensor": _entry_to_dict(v.tensor),
            }
        if isinstance(v, Entry):
            return _entry_to_dict(v)
        if isinstance(v, list):
            return [convert(x) for x in v]
        return v

    # The "type" tag rides along in entry.__dict__ and is what
    # entry_from_dict dispatches on.
    return {k: convert(v) for k, v in entry.__dict__.items() if v is not None}


def entry_from_dict(d: Dict[str, Any]) -> Entry:
    type_ = d["type"]
    if type_ not in _ENTRY_TYPES:
        raise ValueError(f"Unknown entry type: {type_}")
    body = {k: v for k, v in d.items() if k != "type"}
    return _ENTRY_TYPES[type_].from_dict(body)


def is_replicated(entry: Entry) -> bool:
    """Mirror of reference manifest.py:321-325."""
    return (
        isinstance(entry, (TensorEntry, ChunkedTensorEntry, ObjectEntry, PrimitiveEntry))
        and entry.replicated
    )


def is_container_entry(entry: Entry) -> bool:
    return isinstance(entry, (ListEntry, TupleEntry, DictEntry, OrderedDictEntry))


@dataclass
class SnapshotMetadata:
    version: str
    world_size: int
    manifest: Manifest
    # Commit wall-clock (rank 0's time.time() at take) — recorded IN the
    # metadata because file mtimes are unreliable ordering signals
    # (materialize's atomic rewrite, rsync/copies reset them; retention
    # ordering by mtime could delete the newest checkpoints). Optional:
    # absent in pre-field snapshots.
    created_at: Optional[float] = None
    # Base-snapshot roots (relative, "../"-prefixed) this incremental
    # snapshot's external blob locations point into — recorded at take
    # time so retention/info/materialize never have to GUESS where a
    # base root ends inside a location string (a base path containing a
    # purely numeric directory, e.g. "../exp/1000/final/0/w", is
    # ambiguous to grammar parsing — ADVICE r3). Absent/empty for
    # self-contained snapshots and pre-field increments (readers fall
    # back to parsing).
    base_roots: Optional[List[str]] = None
    # Free-form, JSON-serializable sidecar data riding the committed
    # metadata (e.g. the cross-rank telemetry rollup rank 0 folds in
    # before the commit). Readers must tolerate absence and unknown
    # keys; nothing restore-critical may live here.
    extras: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "version": self.version,
            "world_size": self.world_size,
        }
        if self.created_at is not None:
            d["created_at"] = self.created_at
        if self.base_roots:
            d["base_roots"] = list(self.base_roots)
        if self.extras:
            d["extras"] = self.extras
        d["manifest"] = {
            k: _entry_to_dict(v) for k, v in self.manifest.items()
        }
        return d

    def to_yaml(self) -> str:
        # JSON is a subset of YAML (the method keeps tpusnap's name).
        return json.dumps(self.to_dict(), sort_keys=False)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SnapshotMetadata":
        manifest = {k: entry_from_dict(v) for k, v in d["manifest"].items()}
        return cls(
            version=d["version"],
            world_size=d["world_size"],
            manifest=manifest,
            created_at=d.get("created_at"),
            base_roots=d.get("base_roots"),
            extras=d.get("extras"),
        )

    @classmethod
    def from_yaml(cls, s: str) -> "SnapshotMetadata":
        d = json.loads(s)
        if "self_checksum" in d:
            d = {k: v for k, v in d.items() if k != "self_checksum"}
        return cls.from_dict(d)


# ------------------------------------------------- durable metadata encoding

_SELF_CHECKSUM_KEY = "self_checksum"


def encode_metadata(metadata: SnapshotMetadata) -> bytes:
    """Serialize metadata WITH a self-checksum: the document is plain
    JSON (external tooling keeps working with ``json.load``) whose FIRST
    key is ``self_checksum`` — ``"<algo>:<8-hex>"`` over the exact file
    bytes with the checksum value replaced by zeros. Readers that don't
    know the field ignore it; :func:`decode_metadata` verifies it, so a
    torn or bit-rotted metadata file is detected instead of silently
    parsed (or dumped as a JSON traceback)."""
    from . import _native

    algo = _native.checksum_algorithm()
    placeholder = f"{algo}:" + "0" * 8
    d = {_SELF_CHECKSUM_KEY: placeholder, **metadata.to_dict()}
    body = json.dumps(d, sort_keys=False)
    crc = _native.crc32c(body.encode("utf-8")) & 0xFFFFFFFF
    # The self_checksum field is the document's first key, so the first
    # occurrence of the placeholder is the field itself; the replacement
    # is byte-length-preserving, keeping the checksum definition exact.
    return body.replace(placeholder, f"{algo}:{crc:08x}", 1).encode("utf-8")


def decode_metadata(data: bytes) -> SnapshotMetadata:
    """Parse ``.snapshot_metadata`` bytes, verifying the self-checksum
    when present (files written before the field verify nothing; an
    algorithm mismatch across builds is skipped with a warning, matching
    blob-checksum policy). Raises :class:`MetadataError` on torn or
    bit-rotted content."""
    import logging

    from . import _native

    try:
        text = data.decode("utf-8")
    except UnicodeDecodeError as e:
        raise MetadataError(
            f"snapshot metadata is not valid UTF-8 ({e}) — the file is "
            "torn or bit-rotted"
        ) from None
    try:
        d = json.loads(text)
    except json.JSONDecodeError:
        d = None
    if not isinstance(d, dict):
        # Covers valid-but-wrong-shape parses too (a corrupted file whose
        # bytes happen to be a JSON array/scalar) — still a storage-
        # integrity verdict, never a parser traceback.
        raise MetadataError(
            "snapshot metadata does not parse as a JSON mapping — "
            "the file is torn (partial write) or corrupted"
        ) from None
    recorded = d.get(_SELF_CHECKSUM_KEY)
    # Only the canonical JSON encoding (self_checksum first) defines the
    # checksummed byte stream; reformatted copies skip verification.
    if isinstance(recorded, str) and text.startswith(
        '{"%s": ' % _SELF_CHECKSUM_KEY
    ):
        algo, _, value = recorded.partition(":")
        if algo != _native.checksum_algorithm():
            logging.getLogger(__name__).warning(
                "skipping metadata self-checksum verification: file used "
                "%s, this build computes %s",
                algo,
                _native.checksum_algorithm(),
            )
        else:
            zeroed = text.replace(recorded, f"{algo}:" + "0" * 8, 1)
            actual = _native.crc32c(zeroed.encode("utf-8")) & 0xFFFFFFFF
            try:
                expect = int(value, 16)
            except ValueError:
                raise MetadataError(
                    f"malformed metadata self-checksum {recorded!r}"
                ) from None
            if actual != expect:
                raise MetadataError(
                    f"snapshot metadata self-checksum mismatch: recorded "
                    f"{recorded}, file bytes hash to {algo}:{actual:08x} — "
                    "the metadata was torn or bit-rotted in storage"
                )
    if _SELF_CHECKSUM_KEY in d:
        d = {k: v for k, v in d.items() if k != _SELF_CHECKSUM_KEY}
    try:
        return SnapshotMetadata.from_dict(d)
    except (KeyError, TypeError, ValueError) as e:
        raise MetadataError(
            f"snapshot metadata parses but is structurally invalid ({e!r})"
        ) from e
