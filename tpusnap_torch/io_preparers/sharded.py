"""Sharded-tensor preparer: save and restore of ``DTensor`` state over a
``DeviceMesh``, with resharding on restore.

Counterpart of tpusnap/io_preparers/sharded.py. A ``jax.Array`` over a
``NamedSharding`` becomes a ``torch.distributed.tensor.DTensor`` over a
``DeviceMesh`` with ``Shard(d)`` / ``Replicate()`` placements. The
manifest and the blob names are tpusnap's (docs/format.md): one
``Sharded`` entry per logical path with the global dtype and shape,
``shards: [{offsets, sizes, tensor}]``, blobs at
``sharded/<path>.<o0>_<o1>...``.

Save: each rank writes the box its ``to_local()`` tensor holds. The box
follows from the mesh coordinate and the placements (``torch.chunk``
semantics per ``Shard(d)``, nested when several mesh dims shard one
tensor dim), and the rank writes it only when its coordinate is 0 on
every ``Replicate`` mesh dim, so exactly one rank owns each distinct
piece with no collective (tpusnap's ``replica_id == 0``). Ranks outside
the mesh and empty boxes write nothing. A box above
``TPUSNAP_MAX_SHARD_SIZE_BYTES`` at the stored width is split along its
largest dim. Shards are never compressed (a reshard reads sub-boxes of
them) and never slab members (the batcher packs only dense entries).

Restore: every saved shard that overlaps the target's box is read once
and scattered into a host buffer for the box, or straight into the
target when it is a CPU tensor of the stored dtype; a saved shard equal
to the box is read into that buffer in place. The buffer is pinned for a
CUDA target and copied into its ``to_local()`` IN PLACE on a side
stream, cast on the card when the stored dtype differs. The DTensor
itself is returned, so an ``nn.Parameter`` keeps its identity. A plain
tensor target, or none (``read_object``), gets the whole dense tensor.

No DTensor collective runs in a take or a restore: ``full_tensor``,
``redistribute`` and ``from_local(run_check=True)`` are never called.
``torch.distributed.tensor`` is never imported here: a DTensor exists
only once its caller has imported it, so a plain take never pays for it.
"""

from __future__ import annotations

import math
import sys
import threading
from concurrent.futures import Executor
from typing import Any, List, Optional, Sequence, Tuple

import torch

from .. import _native
from ..compress import check_tile_coverage, codec_elem
from ..io_types import BufferConsumer, BufferType, Future, ReadReq, WriteReq
from ..knobs import get_max_shard_size_bytes, get_native_copy_threads
from ..manifest import ChunkedTensorEntry, ShardedEntry, TensorEntry
from ..manifest import Shard as ShardMeta
from ..serialization import (
    Serializer,
    string_to_dtype,
    tensor_as_bytes,
    tensor_from_memoryview,
    tensor_nbytes,
)
from .array import (
    ArrayBufferStager,
    _copy_into_target,
    _maybe_verify,
    _record_ready,
    _run,
    _verify_read_time_crc,
    _want_crc,
    finalize_into_target,
    trace_array_prepare,
)

Box = Tuple[List[int], List[int]]


def is_sharded(obj: Any) -> bool:
    """True for a ``DTensor`` (with any placements, one box or many)."""
    module = sys.modules.get("torch.distributed.tensor")
    dtensor = getattr(module, "DTensor", None)
    return dtensor is not None and isinstance(obj, dtensor)


def _is_replicate(placement) -> bool:
    """Whether a mesh dim replicates the tensor (else it shards it).
    Placements tpusnap has no counterpart for are refused by name."""
    name = type(placement).__name__
    if name == "_StridedShard" or placement.is_partial():
        raise NotImplementedError(
            f"{name} placements are not supported: only Shard(d) and "
            "Replicate() have a counterpart in the snapshot format"
        )
    if placement.is_replicate():
        return True
    if placement.is_shard():
        return False
    raise NotImplementedError(f"unknown placement {placement!r}")


def local_box(
    global_shape: Sequence[int],
    mesh_shape: Sequence[int],
    coordinate: Sequence[int],
    placements: Sequence[Any],
) -> Box:
    """The (offsets, sizes) box of the global tensor that the rank at
    ``coordinate`` holds: each ``Shard(d)`` mesh dim, in mesh-dim order,
    cuts the current extent of dim ``d`` into ``torch.chunk`` pieces
    (size ``ceil(n / k)``, trailing pieces smaller or empty)."""
    offsets = [0] * len(global_shape)
    sizes = list(global_shape)
    for mesh_dim, placement in enumerate(placements):
        if _is_replicate(placement):
            continue
        d = placement.dim % len(global_shape)
        n, k = sizes[d], mesh_shape[mesh_dim]
        chunk = -(-n // k)
        start = min(chunk * coordinate[mesh_dim], n)
        offsets[d] += start
        sizes[d] = min(start + chunk, n) - start
    return offsets, sizes


def _local_piece(t) -> Optional[Tuple[List[int], List[int], bool]]:
    """(offsets, sizes, owner) of this rank's box of DTensor ``t``, or
    None when the rank is outside its mesh. ``owner``: the coordinate is
    0 on every ``Replicate`` mesh dim, so this rank writes the box."""
    placements = list(t.placements)
    replicate = [_is_replicate(p) for p in placements]
    mesh = t.device_mesh
    coordinate = mesh.get_coordinate()
    if coordinate is None:
        return None
    offsets, sizes = local_box(list(t.shape), list(mesh.shape), coordinate, placements)
    local_shape = list(t.to_local().shape)
    if local_shape != sizes:
        raise ValueError(
            f"the DTensor's local tensor has shape {local_shape}, but its "
            f"placements {placements} give this rank the box {sizes} of "
            f"{list(t.shape)}"
        )
    owner = all(c == 0 for c, rep in zip(coordinate, replicate) if rep)
    return offsets, sizes, owner


def _is_empty(sizes: Sequence[int]) -> bool:
    return any(n == 0 for n in sizes)


def _subdivide(
    offsets: List[int], sizes: List[int], itemsize: int, max_bytes: int
) -> List[Tuple[List[int], List[int], Tuple[int, int], int]]:
    """Split a box into sub-boxes of at most ``max_bytes`` along its
    largest dim. Returns ``[(sub_offsets, sub_sizes, (r0, r1), dim)]``
    where ``r0:r1`` is the slice of the local data along ``dim``."""
    nbytes = itemsize * math.prod(sizes) if sizes else itemsize
    if nbytes <= max_bytes or not sizes:
        return [(list(offsets), list(sizes), (0, sizes[0] if sizes else 1), 0)]
    dim = max(range(len(sizes)), key=lambda d: sizes[d])
    if sizes[dim] <= 1:
        return [(list(offsets), list(sizes), (0, sizes[dim]), dim)]
    row_bytes = nbytes // sizes[dim]
    rows_per = max(1, max_bytes // max(row_bytes, 1))
    out = []
    for r0 in range(0, sizes[dim], rows_per):
        r1 = min(r0 + rows_per, sizes[dim])
        sub_off = list(offsets)
        sub_off[dim] += r0
        sub_sz = list(sizes)
        sub_sz[dim] = r1 - r0
        out.append((sub_off, sub_sz, (r0, r1), dim))
    return out


def _location(base: str, offsets: Sequence[int]) -> str:
    suffix = "_".join(str(o) for o in offsets) if len(offsets) else "scalar"
    return f"{base}.{suffix}"


def as_sharded_entry(entry) -> ShardedEntry:
    """A dense entry seen as saved boxes, so that it restores into a
    DTensor target through the overlap reads: a tensor is one box, a
    chunked tensor one box per chunk."""
    if isinstance(entry, ChunkedTensorEntry):
        return ShardedEntry(shards=list(entry.chunks), dtype=entry.dtype, shape=entry.shape)
    return ShardedEntry(
        shards=[ShardMeta(offsets=[0] * len(entry.shape), sizes=list(entry.shape), tensor=entry)],
        dtype=entry.dtype,
        shape=entry.shape,
    )


class ShardedArrayIOPreparer:
    @staticmethod
    def prepare_write(
        storage_path: str,
        t,
        is_async_snapshot: bool = False,
        array_prepare_func=None,
        array_prepare_traced: Optional[Tuple[str, List[int]]] = None,
        prev_entry=None,
        record_dedup_hashes: bool = False,
    ) -> Tuple[ShardedEntry, List[WriteReq]]:
        """``array_prepare_func(tensor, tracing)`` is the save-time
        transform, applied to each local (sub-)shard at stage time, on its
        device. The stored dtype is traced on a ``meta`` tensor; the
        split uses the STORED itemsize, so blobs honour the max shard size
        at their written width. ``prev_entry`` is the base snapshot's
        merged (all-rank) entry: a shard whose box and bytes match a base
        shard skips its write (a resharded tensor's boxes differ and
        conservatively rewrite)."""
        local = t.to_local().detach()
        if array_prepare_traced is not None:
            dtype_str = array_prepare_traced[0]
        else:
            dtype_str, _ = trace_array_prepare(local, array_prepare_func)
        global_shape = list(t.shape)
        entry = ShardedEntry(shards=[], dtype=dtype_str, shape=global_shape)
        piece = _local_piece(t)
        if piece is None or not piece[2] or _is_empty(piece[1]):
            return entry, []
        offsets, sizes, _ = piece

        prev_shards = {}
        if isinstance(prev_entry, ShardedEntry):
            prev_shards = {
                (tuple(s.offsets), tuple(s.sizes)): s.tensor for s in prev_entry.shards
            }
        itemsize = string_to_dtype(dtype_str).itemsize
        write_reqs: List[WriteReq] = []
        for sub_off, sub_sz, (r0, r1), dim in _subdivide(
            offsets, sizes, itemsize, get_max_shard_size_bytes()
        ):
            # A slice along a later dim is not contiguous: the stager
            # compacts it on the tensor's device before the copy out.
            whole = (r0, r1) == (0, sizes[dim] if sizes else 1)
            data = local if whole else local.narrow(dim, r0, r1 - r0)
            loc = _location(storage_path, sub_off)
            tensor_entry = TensorEntry(
                location=loc,
                serializer=Serializer.BUFFER_PROTOCOL.value,
                dtype=dtype_str,
                shape=list(sub_sz),
                replicated=False,
            )
            entry.shards.append(ShardMeta(offsets=sub_off, sizes=sub_sz, tensor=tensor_entry))
            write_reqs.append(
                WriteReq(
                    path=loc,
                    buffer_stager=ArrayBufferStager(
                        data,
                        entry=tensor_entry,
                        is_async_snapshot=is_async_snapshot,
                        array_prepare_func=array_prepare_func,
                        dedup_entry=prev_shards.get((tuple(sub_off), tuple(sub_sz))),
                        record_dedup_hashes=record_dedup_hashes,
                        compressible=False,
                    ),
                )
            )
        return entry, write_reqs

    @staticmethod
    def prepare_read(
        entry: ShardedEntry,
        obj_out: Any = None,
        buffer_size_limit_bytes: Optional[int] = None,
        logical_path: str = "",
    ) -> Tuple[List[ReadReq], Future]:
        fut: Future = Future()
        assembler = _Assembler(entry, obj_out, fut)
        covered = {id(p): 0 for p in assembler.pieces}
        read_reqs: List[ReadReq] = []
        for saved in entry.shards:
            overlaps = []
            for piece in assembler.pieces:
                region = _overlap(saved.offsets, saved.sizes, piece.offsets, piece.sizes)
                if region is not None:
                    overlaps.append((piece, region))
                    covered[id(piece)] += math.prod(region[1])
            if not overlaps:
                continue
            consumer = _ScatterConsumer(
                saved,
                overlaps,
                assembler,
                verify_location=f"{logical_path or saved.tensor.location} "
                f"(shard @ {saved.offsets})",
            )
            read_reqs.append(
                ReadReq(
                    path=saved.tensor.location,
                    byte_range=(
                        tuple(saved.tensor.byte_range)
                        if saved.tensor.byte_range is not None
                        else None
                    ),
                    buffer_consumer=consumer,
                    into=consumer.into,
                    # Checksum computed inside the storage plugin's read;
                    # the consumer verifies the value without a re-read.
                    want_crc=_want_crc(saved.tensor),
                    logical_path=logical_path,
                )
            )
        for piece in assembler.pieces:
            if covered[id(piece)] != math.prod(piece.sizes):
                raise IOError(
                    f"{logical_path or 'a sharded entry'}: the "
                    f"snapshot's shards cover {covered[id(piece)]} of the "
                    f"{math.prod(piece.sizes)} elements of the box at "
                    f"{piece.offsets} — the manifest is inconsistent"
                )
        assembler.total_reads = len(read_reqs)
        if not read_reqs:  # nothing to read (an empty or absent box)
            assembler.finish()
        return read_reqs, fut


def _overlap(
    off_a: Sequence[int],
    sz_a: Sequence[int],
    off_b: Sequence[int],
    sz_b: Sequence[int],
) -> Optional[Box]:
    """Intersection box of two (offsets, sizes) boxes, or None."""
    offsets, sizes = [], []
    for d in range(len(off_a)):
        start = max(off_a[d], off_b[d])
        stop = min(off_a[d] + sz_a[d], off_b[d] + sz_b[d])
        if stop <= start:
            return None
        offsets.append(start)
        sizes.append(stop - start)
    return offsets, sizes


class _Piece:
    """The box of the restore target this process materializes, in a
    host buffer of the stored dtype: the target itself when it is a CPU
    tensor of that dtype (``direct``), else allocated on first use
    (pinned for a CUDA target). Saved shards are disjoint, so concurrent
    scatters into the buffer never write the same bytes; only the
    allocation takes the lock."""

    def __init__(
        self,
        offsets: List[int],
        sizes: List[int],
        dtype: torch.dtype,
        pinned: bool,
        direct: Optional[torch.Tensor],
    ) -> None:
        self.offsets = offsets
        self.sizes = sizes
        self._dtype = dtype
        self._pinned = pinned
        self.direct = direct
        self._buf: Optional[torch.Tensor] = direct
        self._alloc_lock = threading.Lock()

    @property
    def buf(self) -> torch.Tensor:
        buf = self._buf
        if buf is None:
            with self._alloc_lock:
                if self._buf is None:
                    self._buf = (
                        torch.empty(tuple(self.sizes), dtype=self._dtype, pin_memory=True)
                        if self._pinned
                        else _native.empty_advised(self.sizes, self._dtype)
                    )
                buf = self._buf
        return buf

    def byte_view(self) -> memoryview:
        """The buffer's bytes, for a saved shard read into it in place."""
        return memoryview(tensor_as_bytes(self.buf).numpy())


def _direct_destination(t: Optional[torch.Tensor], dtype: torch.dtype, sizes) -> Optional[torch.Tensor]:
    """``t`` when bytes of the stored dtype may land in it verbatim."""
    if (
        t is None
        or t.is_cuda
        or not t.is_contiguous()
        or t.dtype != dtype
        or list(t.shape) != list(sizes)
        or t.numel() == 0
    ):
        return None
    return t


class _Assembler:
    """Collects the scattered regions and, once every read has landed,
    hands the restored object to the future."""

    def __init__(self, entry: ShardedEntry, obj_out: Any, fut: Future) -> None:
        self.entry = entry
        self.obj_out = obj_out
        self.fut = fut
        self.total_reads = 0
        self._done_reads = 0
        dtype = string_to_dtype(entry.dtype)
        global_shape = list(entry.shape)
        self.target: Optional[torch.Tensor] = None
        box: Optional[Box] = ([0] * len(global_shape), global_shape)
        if is_sharded(obj_out):
            if list(obj_out.shape) != global_shape:
                raise ValueError(
                    f"the DTensor target has the global shape {list(obj_out.shape)}, "
                    f"the snapshot holds {global_shape}"
                )
            piece = _local_piece(obj_out)
            box = None if piece is None or _is_empty(piece[1]) else piece[:2]
            self.target = obj_out.to_local()
        elif isinstance(obj_out, torch.Tensor):
            self.target = obj_out
        # Device work the caller queued on the target before the restore.
        self.ready = _record_ready(self.target) if self.target is not None else None
        self.pieces: List[_Piece] = []
        if box is not None:
            direct = None
            if self.target is not None and list(self.target.shape) == box[1]:
                direct = _direct_destination(self.target.detach(), dtype, box[1])
            pinned = self.target is not None and self.target.is_cuda
            self.pieces.append(_Piece(box[0], box[1], dtype, pinned, direct))

    def read_landed(self) -> bool:
        """Count one landed read; True when it was the last."""
        self._done_reads += 1
        return self._done_reads == self.total_reads

    def finish(self) -> None:
        obj_out = self.obj_out
        piece = self.pieces[0] if self.pieces else None
        if is_sharded(obj_out):
            if piece is not None and piece.direct is None:
                _copy_into_target(self.target, piece.buf, self.ready)
            self.fut.obj = obj_out
        elif isinstance(obj_out, torch.Tensor) and piece.direct is not None:
            self.fut.obj = obj_out
        else:
            self.fut.obj = finalize_into_target(piece.buf, obj_out, True, self.ready)


class _ScatterConsumer(BufferConsumer):
    """Reads one saved shard and scatters it into every overlapping
    target piece (tpusnap's ``_ScatterConsumer``). A saved shard equal to
    its one piece is read into the piece's buffer in place."""

    def __init__(
        self,
        saved: ShardMeta,
        overlaps: List[Tuple[_Piece, Box]],
        assembler: _Assembler,
        verify_location: str = "",
    ) -> None:
        self.saved = saved
        self.overlaps = overlaps
        self.assembler = assembler
        self.verify_location = verify_location or saved.tensor.location
        self.into = None
        if len(overlaps) == 1 and not saved.tensor.codec:
            piece, (off, sz) = overlaps[0]
            box = (list(saved.offsets), list(saved.sizes))
            if box == (off, sz) == (piece.offsets, piece.sizes) and math.prod(sz):
                self.into = piece.byte_view

    async def consume_read_io(self, read_io, executor: Optional[Executor] = None) -> None:
        if read_io.in_place:
            _verify_read_time_crc(read_io, self.saved.tensor.checksum, self.verify_location)
        else:
            verified = False
            if read_io.crc32c is not None and _want_crc(self.saved.tensor):
                # The plugin hashed the bytes during the read.
                _verify_read_time_crc(read_io, self.saved.tensor.checksum, self.verify_location)
                verified = True
            await _run(executor, self._scatter, read_io.buf.getbuffer(), verified)
        await self._landed(executor)

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        await _run(executor, self._scatter, buf, False)
        await self._landed(executor)

    async def _landed(self, executor: Optional[Executor]) -> None:
        # The count stays on the event-loop thread; the copy into the
        # target runs on the executor.
        if self.assembler.read_landed():
            await _run(executor, self.assembler.finish)

    def _scatter(self, buf: BufferType, verified: bool) -> None:
        if not verified:
            _maybe_verify(buf, self.saved.tensor.checksum, self.verify_location)
        saved = self._decoded(memoryview(buf).cast("B"))
        for piece, (off, sz) in self.overlaps:
            src = tuple(
                slice(o - s, o - s + n) for o, s, n in zip(off, self.saved.offsets, sz)
            )
            dst = tuple(slice(o - p, o - p + n) for o, p, n in zip(off, piece.offsets, sz))
            piece.buf[dst].copy_(saved[src])

    def _decoded(self, mv: memoryview) -> torch.Tensor:
        """The saved shard as a tensor of its sizes; a compressed blob
        (a dense entry restored into a DTensor) is decompressed first."""
        t = self.saved.tensor
        raw_nbytes = tensor_nbytes(t.dtype, self.saved.sizes)
        if t.codec:
            n_rows = t.shape[0] if t.shape else 0
            row_nbytes = raw_nbytes // n_rows if n_rows else 0
            tile_raw = t.tile_rows * row_nbytes if t.tile_rows else raw_nbytes
            sizes = [int(s) for s in t.comp_tile_sizes or []]
            check_tile_coverage(t.location, len(sizes), raw_nbytes, tile_raw)
            raw = torch.empty(raw_nbytes, dtype=torch.uint8)
            _native.decompress_tiles(
                mv, sizes, tile_raw, raw_nbytes, codec_elem(t.codec),
                memoryview(raw.numpy()), nthreads=get_native_copy_threads(),
            )
            mv = memoryview(raw.numpy())
        if mv.nbytes != raw_nbytes:
            raise IOError(
                f"short read: got {mv.nbytes} of {raw_nbytes} bytes for "
                f"{self.verify_location} — the blob is truncated"
            )
        return tensor_from_memoryview(mv, t.dtype, self.saved.sizes)

    def get_consuming_cost_bytes(self) -> int:
        nbytes = tensor_nbytes(self.saved.tensor.dtype, self.saved.sizes)
        return 2 * nbytes if self.saved.tensor.codec else nbytes
