"""tpusnap_torch chunked tensors: tensors above TPUSNAP_MAX_CHUNK_SIZE_BYTES
split along dim 0, against tpusnap's chunked preparer on the same numpy
inputs. Snapshots are bit-exact, so every comparison has tolerance 0.

The cross-package checks assert that both packages record ``crc32c``
(the native build): with different algorithms the reader only warns and
skips verification, which would let a wrong blob pass silently.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from test_format_conformance import _DTYPES as _EXTERNAL_DTYPES, _external_reader
from tpusnap_torch import Snapshot, StateDict, load_snapshot
from tpusnap_torch.io_preparers import chunked as port_chunked
from tpusnap_torch.knobs import override_batching_disabled, override_max_chunk_size_bytes
from tpusnap_torch.manifest import ChunkedTensorEntry
from tpusnap_torch.serialization import SUPPORTED_DTYPES

torch.set_num_threads(1)

_CHUNK = 64  # bytes: every tensor below spans several chunks


def _ragged_shape(dtype: torch.dtype, cols: int = 2):
    """Two full chunks of ``_CHUNK`` bytes and one ragged row after them."""
    rows_per_chunk = _CHUNK // (cols * dtype.itemsize)
    return (2 * rows_per_chunk + 1, cols)


def _tensor(dtype: torch.dtype, shape, seed=0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if dtype == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, n).astype(bool)).reshape(shape)
    # Every bit pattern of the width through a uint8 view (NaN payloads
    # and all): the snapshot must carry bytes, not values.
    raw = rng.integers(0, 256, n * dtype.itemsize).astype(np.uint8)
    return torch.from_numpy(raw).view(dtype).reshape(shape)


def _bytes(t: torch.Tensor) -> bytes:
    return bytes(t.contiguous().reshape(-1).view(torch.uint8).numpy())


def _metadata(path):
    return json.load(open(os.path.join(path, ".snapshot_metadata")))


def _algos(md):
    out = {md["self_checksum"].split(":")[0]}
    for e in md["manifest"].values():
        for c in e.get("chunks", [e]):
            if "checksum" in c.get("tensor", c):
                out.add(c.get("tensor", c)["checksum"].split(":")[0])
    return out


@pytest.mark.parametrize("batching_disabled", [False, True], ids=["batching_on", "batching_off"])
@pytest.mark.parametrize("name", sorted(SUPPORTED_DTYPES))
def test_every_dtype_round_trips_chunked(tmp_path, name, batching_disabled):
    dtype = SUPPORTED_DTYPES[name]
    shape = _ragged_shape(dtype)
    src = _tensor(dtype, shape)
    path = str(tmp_path / "snap")
    with override_max_chunk_size_bytes(_CHUNK), override_batching_disabled(batching_disabled):
        snap = Snapshot.take(path, {"s": StateDict(t=src)})
    entry = snap.metadata.manifest["0/s/t"]
    assert isinstance(entry, ChunkedTensorEntry)
    rows = [c.sizes[0] for c in entry.chunks]
    assert rows == [shape[0] // 2, shape[0] // 2, 1]  # ragged last chunk
    assert [c.offsets for c in entry.chunks] == [[0, 0], [rows[0], 0], [2 * rows[0], 0]]
    assert _algos(_metadata(path)) == {"crc32c"}

    target = torch.zeros(shape, dtype=dtype)
    state = StateDict(t=target)
    Snapshot(path).restore({"s": state})
    assert state["t"] is target and _bytes(target) == _bytes(src)
    got = Snapshot(path).read_object("0/s/t")
    assert got.dtype == dtype and _bytes(got) == _bytes(src)
    assert _bytes(load_snapshot(path)["s"]["t"]) == _bytes(src)


def test_large_tensor_default_knob_is_chunked_like_tpusnap():
    """The 512 MiB default: geometry only (nothing is allocated)."""
    from tpusnap.io_preparers.chunked import chunk_row_ranges as jax_ranges

    shape, dtype = [128256, 4096], "bfloat16"  # an 8B-class embedding table
    got = port_chunked.chunk_row_ranges(shape, dtype, 512 * 1024 * 1024)
    assert got == jax_ranges(shape, dtype, 512 * 1024 * 1024)
    assert len(got) == 2 and got[0] == (0, 65536)


# ------------------------------------------------------------ cross-package

# 64-bit inputs stay numpy on the tpusnap side, so JAX's x64 narrowing
# never applies; bfloat16 goes through ml_dtypes.
_CROSS = {
    "float32": np.float32,
    "int64": np.int64,
    "bfloat16": ml_dtypes.bfloat16,
    "uint16": np.uint16,
    "bool": np.bool_,
    "complex64": np.complex64,
}


def _numpy_inputs(seed=3):
    out = {}
    for i, (name, np_dtype) in enumerate(_CROSS.items()):
        t = _tensor(SUPPORTED_DTYPES[name], _ragged_shape(SUPPORTED_DTYPES[name], 3), seed + i)
        arr = t.numpy() if name != "bfloat16" else t.view(torch.uint16).numpy()
        out[name] = arr.view(np_dtype)
    return out


def _port_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _chunk_table(path):
    md = _metadata(path)
    table = {}
    for k, e in md["manifest"].items():
        if e["type"] != "ChunkedTensor":
            continue
        table[k] = (
            e["dtype"],
            e["shape"],
            [
                (c["offsets"], c["sizes"], c["tensor"]["location"], c["tensor"].get("byte_range"),
                 c["tensor"]["checksum"], c["tensor"].get("dedup_hash"))
                for c in e["chunks"]
            ],
        )
    return md, table


def _take_both(tmp_path, arrays):
    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import StateDict as JaxStateDict
    from tpusnap.knobs import override_batching_disabled as jax_batching_disabled
    from tpusnap.knobs import override_max_chunk_size_bytes as jax_chunk

    jax_path, port_path = str(tmp_path / "jax"), str(tmp_path / "port")
    with jax_chunk(_CHUNK), jax_batching_disabled(True):
        JaxSnapshot.take(jax_path, {"s": JaxStateDict(dict(arrays))})
    with override_max_chunk_size_bytes(_CHUNK), override_batching_disabled(True):
        Snapshot.take(port_path, {"s": StateDict({k: _port_tensor(v) for k, v in arrays.items()})})
    return jax_path, port_path


def test_chunked_manifest_and_blobs_match_tpusnap(tmp_path):
    arrays = _numpy_inputs()
    jax_path, port_path = _take_both(tmp_path, arrays)
    jax_md, jax_table = _chunk_table(jax_path)
    port_md, port_table = _chunk_table(port_path)
    assert _algos(jax_md) == _algos(port_md) == {"crc32c"}
    assert set(port_table) == {f"0/s/{k}" for k in arrays}
    assert port_table == jax_table
    for _, _, chunks in port_table.values():
        for _, _, location, _, _, _ in chunks:
            with open(os.path.join(jax_path, location), "rb") as a, open(
                os.path.join(port_path, location), "rb"
            ) as b:
                assert a.read() == b.read(), location


def test_chunked_snapshots_restore_across_packages(tmp_path):
    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import StateDict as JaxStateDict

    arrays = _numpy_inputs(seed=11)
    jax_path, port_path = _take_both(tmp_path, arrays)
    # tpusnap's snapshot into port tensors, in place.
    targets = {k: torch.zeros_like(_port_tensor(v)) for k, v in arrays.items()}
    state = StateDict(dict(targets))
    Snapshot(jax_path).restore({"s": state})
    for k, v in arrays.items():
        assert state[k] is targets[k] and _bytes(targets[k]) == v.tobytes(), k
    # The port's snapshot through tpusnap and through the external reader.
    jax_targets = JaxStateDict({k: np.zeros_like(v) for k, v in arrays.items()})
    JaxSnapshot(port_path).restore({"s": jax_targets})
    _, read = _external_reader(port_path)
    for k, v in arrays.items():
        assert np.asarray(jax_targets[k]).tobytes() == v.tobytes(), k
        if k in _EXTERNAL_DTYPES:  # the dtypes the spec's reader knows
            got = read(f"0/s/{k}")
            assert got.shape == v.shape and got.tobytes() == v.tobytes(), k


# ---------------------------------------------------------------- reads


@pytest.mark.parametrize("budget", [48, 200], ids=["tiles_within_chunks", "chunk_per_read"])
def test_tiled_read_object_of_chunked_entry(tmp_path, budget):
    src = _tensor(torch.float32, (45, 4), seed=5)  # 16-byte rows, 4-row chunks
    path = str(tmp_path / "snap")
    with override_max_chunk_size_bytes(_CHUNK), override_batching_disabled(True):
        Snapshot.take(path, {"s": StateDict(t=src)})
    snap = Snapshot(path)
    got = snap.read_object("0/s/t", memory_budget_bytes=budget)
    assert _bytes(got) == _bytes(src)
    out = torch.zeros_like(src)
    assert snap.read_object("0/s/t", obj_out=out, memory_budget_bytes=budget) is out
    assert _bytes(out) == _bytes(src)


def test_chunked_restore_into_strided_and_casting_targets(tmp_path):
    src = _tensor(torch.int32, (21, 4), seed=6)
    path = str(tmp_path / "snap")
    with override_max_chunk_size_bytes(_CHUNK):
        Snapshot.take(path, {"s": StateDict(a=src, b=src)})
    strided = torch.zeros(4, 21, dtype=torch.int32).t()  # non-contiguous
    wider = torch.zeros(21, 4, dtype=torch.int64)  # cast on restore
    state = StateDict(a=strided, b=wider)
    Snapshot(path).restore({"s": state})
    assert state["a"] is strided and torch.equal(strided, src)
    assert state["b"] is wider and torch.equal(wider, src.to(torch.int64))


def test_corrupt_chunk_fails_its_checksum(tmp_path):
    src = _tensor(torch.float32, (20, 4), seed=7)
    path = str(tmp_path / "snap")
    with override_max_chunk_size_bytes(_CHUNK), override_batching_disabled(True):
        snap = Snapshot.take(path, {"s": StateDict(t=src)})
    location = snap.metadata.manifest["0/s/t"].chunks[1].tensor.location
    with open(os.path.join(path, location), "r+b") as f:
        f.write(b"\xff")
    with pytest.raises(IOError, match="checksum mismatch"):
        Snapshot(path).restore({"s": StateDict(t=torch.zeros_like(src))})


def test_tile_prev_map_and_compressed_chunks(tmp_path):
    """Formerly "not ported": ``tile_prev_map`` gives tpusnap's tile view
    of a base entry (None without tile dedup hashes), and a compressed
    chunk reads back into its rows."""
    import tpusnap.io_preparers.chunked as jax_chunked
    from tpusnap.manifest import TensorEntry as JaxTensorEntry
    from tpusnap.manifest import _entry_to_dict as jax_entry_to_dict

    from tpusnap_torch.manifest import TensorEntry, _entry_to_dict

    assert port_chunked.tile_prev_map(None, "float32", [4, 4]) is None
    fields = dict(
        location="0/s/t", serializer="buffer_protocol", dtype="float32", shape=[5, 4],
        replicated=False, tile_rows=2, checksum="crc32c:00000009",
        tile_checksums=["crc32c:01", "crc32c:02", "crc32c:03"],
        tile_dedup_hashes=["xxh64:0a", "xxh64:0b", "xxh64:0c"],
    )
    rows, tiles = port_chunked.tile_prev_map(TensorEntry(**fields), "float32", [5, 4])
    jrows, jtiles = jax_chunked.tile_prev_map(JaxTensorEntry(**fields), "float32", [5, 4])
    assert rows == jrows == 2
    assert {k: _entry_to_dict(v) for k, v in tiles.items()} == {
        k: jax_entry_to_dict(v) for k, v in jtiles.items()
    }
    assert port_chunked.tile_prev_map(
        TensorEntry(**dict(fields, tile_dedup_hashes=None)), "float32", [5, 4]
    ) is None

    rng = np.random.default_rng(4)
    src = torch.from_numpy(rng.integers(-2, 2, (8200, 4)).astype(np.float32))
    path = str(tmp_path / "snap")
    with override_max_chunk_size_bytes(1 << 16), override_batching_disabled(True):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TPUSNAP_COMPRESS", "on")
            mp.setenv("TPUSNAP_COMPRESS_MIN_BLOB_BYTES", "65536")
            snap = Snapshot.take(path, {"s": StateDict(t=src)})
    entry = snap.metadata.manifest["0/s/t"]
    # Two full chunks compress; the ragged 128-byte one is under the floor.
    assert [c.tensor.codec for c in entry.chunks] == ["shuf4+lz4", "shuf4+lz4", None]
    out = torch.zeros_like(src)
    Snapshot(path).restore({"s": StateDict(t=out)})
    assert torch.equal(out, src)
