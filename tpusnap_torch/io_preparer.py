"""Type → preparer dispatch for write and Entry → preparer dispatch for read.

Counterpart of tpusnap/io_preparer.py, routing on ``torch.Tensor`` where
tpusnap routes on ``jax.Array``:

- int/float/bool/str/bytes          → inlined PrimitiveEntry (no I/O)
- DTensor                           → ShardedArrayIOPreparer ("sharded/...")
- the legacy ShardedTensor          → NotImplementedError (no counterpart
                                      in tpusnap; use DTensor)
- dense tensor whose base entry has  → ChunkedArrayIOPreparer on the
  a tile map (incremental takes)      base's checksum-tile grid
- dense tensor above max_chunk_size → ChunkedArrayIOPreparer
- dense tensor, supported dtype     → ArrayIOPreparer
- anything else                     → ObjectIOPreparer (pickle)

Read: a ``Sharded`` entry goes to the sharded preparer, and so does a
dense entry restored into a DTensor target (its blobs seen as saved
boxes, read where they overlap the target's local box).

Storage paths: sharded entries under ``sharded/``, replicated entries
under ``replicated/``, everything else under ``<rank>/``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from .io_preparers.array import (
    ArrayIOPreparer,
    is_supported_array_dtype,
    trace_array_prepare,
)
from .io_preparers.chunked import ChunkedArrayIOPreparer, should_chunk, tile_prev_map
from .io_preparers.object import ObjectIOPreparer
from .io_preparers.sharded import ShardedArrayIOPreparer, as_sharded_entry, is_sharded
from .io_types import Future, ReadReq, WriteReq
from .manifest import (
    ChunkedTensorEntry,
    Entry,
    ObjectEntry,
    PrimitiveEntry,
    ShardedEntry,
    TensorEntry,
)


def get_storage_path(
    logical_path: str, rank: int, replicated: bool, sharded: bool = False
) -> str:
    if sharded:
        return f"sharded/{logical_path}"
    if replicated:
        return f"replicated/{logical_path}"
    return f"{rank}/{logical_path}"


def is_legacy_sharded_tensor(obj: Any) -> bool:
    """The older ``ShardedTensor`` subclasses torch.Tensor; its local
    data is a shard, so it must never take the dense route."""
    return isinstance(obj, torch.Tensor) and type(obj).__name__ == "ShardedTensor"


def prepare_write(
    obj: Any,
    logical_path: str,
    rank: int,
    replicated: bool = False,
    is_async_snapshot: bool = False,
    array_prepare_func: Optional[Any] = None,
    array_prepare_traced: Optional[Tuple[str, Any]] = None,
    prev_entry: Optional[Entry] = None,
    record_dedup_hashes: bool = False,
    allow_tile_dedup: bool = True,
) -> Tuple[Entry, List[WriteReq]]:
    """``array_prepare_func(tensor, tracing) -> tensor`` is the save-time
    transform of dense and chunked tensors (other objects pass through).
    ``prev_entry`` is the base snapshot's entry for this logical path,
    locations relative to the new root: blobs whose staged bytes hash the
    same skip their writes and reference the base's. When it carries a
    tile map (``chunked.tile_prev_map``), the tensor is re-chunked on the
    base's checksum-tile grid so each tile dedups on its own.
    ``record_dedup_hashes`` records the 64-bit per-tile hashes that make
    the next increment tile-grain; ``allow_tile_dedup=False`` keeps the
    write blob-grain. A DTensor is never replicated: each distinct box is
    written once, by the rank that owns it, and the transform applies to
    each local shard."""
    if PrimitiveEntry.supported(obj):
        return PrimitiveEntry.from_object(obj, replicated=replicated), []

    if is_sharded(obj):
        return ShardedArrayIOPreparer.prepare_write(
            get_storage_path(logical_path, rank, False, sharded=True),
            obj,
            is_async_snapshot=is_async_snapshot,
            array_prepare_func=array_prepare_func,
            array_prepare_traced=array_prepare_traced,
            prev_entry=prev_entry,
            record_dedup_hashes=record_dedup_hashes,
        )
    if is_legacy_sharded_tensor(obj):
        raise NotImplementedError(
            f"{logical_path!r} is a ShardedTensor, which has no counterpart in "
            "tpusnap; convert it to a DTensor"
        )

    storage_path = get_storage_path(logical_path, rank, replicated)
    if isinstance(obj, torch.Tensor) and is_supported_array_dtype(obj):
        if array_prepare_traced is None:
            array_prepare_traced = trace_array_prepare(obj, array_prepare_func)
        kwargs = dict(
            array_prepare_func=array_prepare_func,
            array_prepare_traced=array_prepare_traced,
            record_dedup_hashes=record_dedup_hashes,
        )
        if prev_entry is not None and allow_tile_dedup:
            tiled_prev = tile_prev_map(prev_entry, *array_prepare_traced)
            if tiled_prev is not None:
                grid_rows, prev_tiles = tiled_prev
                return ChunkedArrayIOPreparer.prepare_write(
                    storage_path, obj, replicated, is_async_snapshot,
                    chunk_rows=grid_rows, prev_chunks=prev_tiles, **kwargs,
                )
        preparer = ChunkedArrayIOPreparer if should_chunk(obj) else ArrayIOPreparer
        return preparer.prepare_write(
            storage_path, obj, replicated, is_async_snapshot, prev_entry=prev_entry, **kwargs
        )

    return ObjectIOPreparer.prepare_write(storage_path, obj, replicated, prev_entry=prev_entry)


def prepare_read(
    entry: Entry,
    obj_out: Any = None,
    buffer_size_limit_bytes: Optional[int] = None,
    logical_path: str = "",
) -> Tuple[List[ReadReq], Future]:
    """``logical_path`` labels integrity failures with the user-facing
    manifest path (slab locations are opaque uuids)."""
    if isinstance(entry, PrimitiveEntry):
        return [], Future(obj=entry.get_value())
    if isinstance(entry, ShardedEntry):
        return ShardedArrayIOPreparer.prepare_read(
            entry, obj_out, buffer_size_limit_bytes, logical_path=logical_path
        )
    if is_sharded(obj_out) and isinstance(entry, (TensorEntry, ChunkedTensorEntry)):
        return ShardedArrayIOPreparer.prepare_read(
            as_sharded_entry(entry), obj_out, buffer_size_limit_bytes, logical_path=logical_path
        )
    if isinstance(entry, ChunkedTensorEntry):
        return ChunkedArrayIOPreparer.prepare_read(
            entry, obj_out, buffer_size_limit_bytes, logical_path=logical_path
        )
    if isinstance(entry, TensorEntry):
        return ArrayIOPreparer.prepare_read(
            entry, obj_out, buffer_size_limit_bytes, logical_path=logical_path
        )
    if isinstance(entry, ObjectEntry):
        return ObjectIOPreparer.prepare_read(entry, logical_path=logical_path)
    raise TypeError(f"Cannot prepare read for entry type {type(entry).__name__}")
