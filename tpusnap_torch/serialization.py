"""Zero-copy serialization between host tensors and byte buffers.

Counterpart of tpusnap/serialization.py. The torch dtypes map onto the
SAME 17 dtype strings, in the same byte layout (little-endian, C order),
so a blob written by either package reads back bit-exactly through the
other:

- every dtype is serialized by reinterpreting the contiguous tensor as
  ``uint8`` (``tensor.view(torch.uint8)``) — no value conversion ever
  happens. ``bfloat16`` and the two fp8 types go the same way; numpy has
  no bf16, so nothing here passes one through numpy as a typed array.
- torch's ``uint16``/``uint32``/``uint64`` support only a few operators:
  this module touches them with ``.view()`` and ``.numpy()`` alone.
- the fallback serializer for arbitrary Python objects is stdlib pickle.
"""

from __future__ import annotations

import pickle
from enum import Enum
from typing import Any, Sequence, Tuple

import torch


class Serializer(Enum):
    BUFFER_PROTOCOL = "buffer_protocol"
    PICKLE = "pickle"


# Canonical dtype-string table — the keys tpusnap writes into
# TensorEntry.dtype.
SUPPORTED_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
    "complex128": torch.complex128,
    "complex64": torch.complex64,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint64": torch.uint64,
    "uint32": torch.uint32,
    "uint16": torch.uint16,
    "uint8": torch.uint8,
    "bool": torch.bool,
}

_DTYPE_TO_STRING = {v: k for k, v in SUPPORTED_DTYPES.items()}


def dtype_to_string(dtype: torch.dtype) -> str:
    """Canonical string for a torch dtype (e.g. ``"bfloat16"``)."""
    try:
        return _DTYPE_TO_STRING[dtype]
    except KeyError:
        raise ValueError(f"Unsupported dtype: {dtype}") from None


def string_to_dtype(s: str) -> torch.dtype:
    try:
        return SUPPORTED_DTYPES[s]
    except KeyError:
        raise ValueError(f"Unsupported dtype string: {s}") from None


def dtype_itemsize(s: str) -> int:
    return string_to_dtype(s).itemsize


def tensor_nbytes(dtype_str: str, shape: Sequence[int]) -> int:
    n = dtype_itemsize(dtype_str)
    for dim in shape:
        n *= dim
    return n


def tensor_as_bytes(t: torch.Tensor) -> torch.Tensor:
    """Flat ``uint8`` view of a tensor's bytes (same device; copies once
    when ``t`` is not contiguous)."""
    if t.dtype not in _DTYPE_TO_STRING:
        raise ValueError(f"Unsupported dtype: {t.dtype}")
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def tensor_as_memoryview(t: torch.Tensor) -> memoryview:
    """Zero-copy flat byte view of a CPU tensor (counterpart of
    ``array_as_memoryview``). Non-contiguous inputs are copied once."""
    if t.device.type != "cpu":
        raise ValueError(f"expected a CPU tensor, got one on {t.device}")
    if t.numel() == 0:
        return memoryview(b"")
    return memoryview(tensor_as_bytes(t).numpy())


def tensor_from_memoryview(
    mv: memoryview, dtype: str, shape: Sequence[int]
) -> torch.Tensor:
    """CPU tensor over a byte buffer (counterpart of
    ``array_from_memoryview``). The result aliases ``mv``; a read-only
    buffer yields a tensor that must not be written."""
    torch_dtype = string_to_dtype(dtype)
    mv = memoryview(mv)
    nbytes = tensor_nbytes(dtype, shape)
    if mv.nbytes != nbytes:
        # A truncated blob (read with checksums off) must not come back
        # as a tensor: tpusnap's reshape raises ValueError here too.
        raise ValueError(
            f"a buffer of {mv.nbytes} bytes cannot hold a {dtype} tensor of "
            f"shape {list(shape)} ({nbytes} bytes)"
        )
    if nbytes == 0:
        return torch.empty(tuple(shape), dtype=torch_dtype)
    if mv.readonly:
        # torch.frombuffer needs a writable buffer; read-only inputs are
        # small (pickled or in-memory) and take one copy.
        mv = memoryview(bytearray(mv))
    raw = torch.frombuffer(mv, dtype=torch.uint8)
    if raw.data_ptr() % torch_dtype.itemsize:
        # A slab member can start at any byte; torch's vectorized kernels
        # fault on misaligned element pointers (complex128 at offset 14),
        # so such a member takes one copy into an aligned buffer.
        raw = raw.clone()
    return raw.view(torch_dtype).reshape(tuple(shape))


def pickle_as_bytes(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def pickle_from_bytes(buf: bytes) -> Any:
    return pickle.loads(buf)


def per_element_sizes() -> Tuple[str, ...]:
    """Every supported dtype string, in the canonical table's order."""
    return tuple(SUPPORTED_DTYPES)
