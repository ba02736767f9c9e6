"""Per-dtype serialization of ``tpusnap_torch``: the mirror of
``tests/test_serialization.py``. Every tensor is made from the same
seeded numpy array tpusnap's test uses (``tpusnap.test_utils.rand_array``),
viewed as the port's dtype bit for bit, and its serialized bytes are held
equal to tpusnap's; comparisons are exact.
"""

import numpy as np
import pytest
import torch

from tpusnap_torch.serialization import (
    SUPPORTED_DTYPES,
    Serializer,
    dtype_itemsize,
    dtype_to_string,
    pickle_as_bytes,
    pickle_from_bytes,
    string_to_dtype,
    tensor_as_memoryview,
    tensor_from_memoryview,
    tensor_nbytes,
)


def _same_tensor(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    raw = torch.frombuffer(bytearray(arr.tobytes()), dtype=torch.uint8)
    return raw.view(SUPPORTED_DTYPES[dtype_str]).reshape(arr.shape)


def test_supported_dtypes_match_tpusnap():
    from tpusnap.serialization import SUPPORTED_DTYPES as REF

    assert set(SUPPORTED_DTYPES) == set(REF)
    for name in SUPPORTED_DTYPES:
        assert dtype_itemsize(name) == REF[name].itemsize, name


@pytest.mark.parametrize("dtype_str", sorted(SUPPORTED_DTYPES))
def test_buffer_roundtrip_bit_identical(dtype_str):
    from tpusnap.serialization import array_as_memoryview
    from tpusnap.test_utils import rand_array

    arr = rand_array(dtype_str)
    t = _same_tensor(arr, dtype_str)
    mv = tensor_as_memoryview(t)
    assert mv.nbytes == arr.nbytes == tensor_nbytes(dtype_str, list(t.shape))
    restored = tensor_from_memoryview(mv, dtype_str, t.shape)
    assert restored.dtype == t.dtype and restored.shape == t.shape
    # Bit-identical through raw bytes, and equal to tpusnap's serialization.
    assert bytes(mv) == bytes(tensor_as_memoryview(restored)) == bytes(array_as_memoryview(arr))


def test_zero_copy_no_conversion():
    t = torch.arange(1024, dtype=torch.float32)
    mv = tensor_as_memoryview(t)
    t[0] = 123.0  # the view observes the change: no copy was made
    assert np.frombuffer(mv, dtype=np.float32)[0] == 123.0


def test_noncontiguous_copied():
    t = torch.arange(100, dtype=torch.int32).reshape(10, 10).T
    restored = tensor_from_memoryview(tensor_as_memoryview(t), "int32", (10, 10))
    assert torch.equal(restored, t.contiguous())


def test_empty_tensor():
    t = torch.zeros((0, 5), dtype=torch.float32)
    mv = tensor_as_memoryview(t)
    assert mv.nbytes == 0
    assert tensor_from_memoryview(mv, "float32", (0, 5)).shape == (0, 5)


def test_bf16_bit_exact():
    # Every bf16 bit pattern, NaNs and infinities included.
    t = torch.arange(65536, dtype=torch.int32).to(torch.uint16).view(torch.bfloat16)
    restored = tensor_from_memoryview(tensor_as_memoryview(t), "bfloat16", t.shape)
    assert bytes(tensor_as_memoryview(restored)) == bytes(tensor_as_memoryview(t))


def test_dtype_string_tables():
    for name in ["float32", "bfloat16", "int8", "bool", "complex64"]:
        assert dtype_to_string(string_to_dtype(name)) == name
        assert dtype_itemsize(name) == string_to_dtype(name).itemsize
    assert dtype_to_string(torch.bfloat16) == "bfloat16"
    assert dtype_to_string(torch.float32) == "float32"
    with pytest.raises(ValueError):
        dtype_to_string(torch.qint8)
    with pytest.raises(ValueError):
        string_to_dtype("qint8")


def test_pickle_fallback():
    obj = {"a": [1, 2], "b": {3, 4}, "c": slice(1, 2)}
    assert pickle_from_bytes(pickle_as_bytes(obj)) == obj
    assert Serializer.PICKLE.value == "pickle"


def test_memoryview_stream():
    from tpusnap_torch.memoryview_stream import MemoryviewStream

    data = bytes(range(256))
    s = MemoryviewStream(memoryview(data))
    assert s.read(10) == data[:10]
    assert s.tell() == 10
    s.seek(-6, 2)
    assert s.read() == data[-6:]
    s.seek(0)
    buf = bytearray(300)
    assert s.readinto(buf) == 256
    assert bytes(buf[:256]) == data
    assert len(s) == 256


@pytest.mark.parametrize("nbytes", [0, 8, 12, 20], ids=["empty", "half", "short", "long"])
def test_wrong_size_buffer_refused_like_tpusnap(nbytes):
    """A buffer that is not exactly the tensor's bytes (a truncated blob
    read with checksums off) raises ValueError in both packages, never a
    tensor over garbage."""
    from tpusnap.serialization import array_from_memoryview

    mv = memoryview(bytes(range(nbytes)))
    with pytest.raises(ValueError):
        array_from_memoryview(mv, "float32", (4,))
    with pytest.raises(ValueError):
        tensor_from_memoryview(mv, "float32", (4,))
