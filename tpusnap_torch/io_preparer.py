"""Type → preparer dispatch for write and Entry → preparer dispatch for read.

Counterpart of tpusnap/io_preparer.py, routing on ``torch.Tensor`` where
tpusnap routes on ``jax.Array``:

- int/float/bool/str/bytes          → inlined PrimitiveEntry (no I/O)
- DTensor / sharded tensor          → NotImplementedError (ROADMAP.md A5)
- dense tensor above max_chunk_size → NotImplementedError (ROADMAP.md A2:
                                      the chunked preparer is not ported)
- dense tensor, supported dtype     → ArrayIOPreparer
- anything else                     → ObjectIOPreparer (pickle)

Storage paths: replicated entries under ``replicated/``, everything else
under ``<rank>/``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from .io_preparers.array import (
    ArrayIOPreparer,
    array_nbytes,
    is_supported_array_dtype,
)
from .io_preparers.object import ObjectIOPreparer
from .io_types import Future, ReadReq, WriteReq
from .knobs import get_max_chunk_size_bytes
from .manifest import (
    ChunkedTensorEntry,
    Entry,
    ObjectEntry,
    PrimitiveEntry,
    ShardedEntry,
    TensorEntry,
)


def get_storage_path(logical_path: str, rank: int, replicated: bool) -> str:
    if replicated:
        return f"replicated/{logical_path}"
    return f"{rank}/{logical_path}"


def _is_distributed_tensor(obj: Any) -> bool:
    """DTensor (and the older ShardedTensor) subclass torch.Tensor; their
    local data is a shard, so they must never take the dense route."""
    return isinstance(obj, torch.Tensor) and type(obj).__name__ in (
        "DTensor",
        "ShardedTensor",
    )


def prepare_write(
    obj: Any,
    logical_path: str,
    rank: int,
    replicated: bool = False,
) -> Tuple[Entry, List[WriteReq]]:
    if PrimitiveEntry.supported(obj):
        return PrimitiveEntry.from_object(obj, replicated=replicated), []

    if _is_distributed_tensor(obj):
        raise NotImplementedError(
            f"{logical_path!r} is a {type(obj).__name__}; sharded state is "
            "not ported yet (ROADMAP.md item A5)"
        )

    storage_path = get_storage_path(logical_path, rank, replicated)
    if isinstance(obj, torch.Tensor) and is_supported_array_dtype(obj):
        if (
            obj.dim() > 0
            and obj.shape[0] > 1
            and array_nbytes(obj) > get_max_chunk_size_bytes()
        ):
            raise NotImplementedError(
                f"{logical_path!r} is {array_nbytes(obj)} bytes, above the "
                f"{get_max_chunk_size_bytes()}-byte chunk size; the chunked "
                "preparer is not ported yet (ROADMAP.md item A2)"
            )
        return ArrayIOPreparer.prepare_write(storage_path, obj, replicated)

    return ObjectIOPreparer.prepare_write(storage_path, obj, replicated)


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
    if isinstance(entry, (ShardedEntry, ChunkedTensorEntry)):
        raise NotImplementedError(
            f"{logical_path!r} is a {entry.type} entry; sharded and chunked "
            "reads are not ported yet (ROADMAP.md items A2 and A5)"
        )
    if isinstance(entry, TensorEntry):
        return ArrayIOPreparer.prepare_read(
            entry, obj_out, buffer_size_limit_bytes, logical_path=logical_path
        )
    if isinstance(entry, ObjectEntry):
        return ObjectIOPreparer.prepare_read(entry, logical_path=logical_path)
    raise TypeError(f"Cannot prepare read for entry type {type(entry).__name__}")
