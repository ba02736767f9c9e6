"""The manifest model of ``tpusnap_torch``: the mirror of
``tests/test_manifest.py``, plus cross-package checks that a metadata
document written by either package reads back equal in the other.
"""

import math
import struct

import pytest

from tpusnap_torch.manifest import (
    Chunk,
    ChunkedTensorEntry,
    DictEntry,
    ListEntry,
    ObjectEntry,
    OrderedDictEntry,
    PrimitiveEntry,
    Shard,
    ShardedEntry,
    SnapshotMetadata,
    TensorEntry,
    TupleEntry,
    is_container_entry,
    is_replicated,
)


def _sample_manifest(m):
    """The reference test's manifest, built from module ``m``'s classes."""
    return {
        "0/model": m.DictEntry(keys=["w", "b", 7]),
        "0/model/w": m.TensorEntry(
            location="0/model/w", serializer="buffer_protocol", dtype="bfloat16",
            shape=[128, 256], replicated=False,
        ),
        "0/model/b": m.TensorEntry(
            location="batched/abc", serializer="buffer_protocol", dtype="float32",
            shape=[256], replicated=True, byte_range=[0, 1024],
        ),
        "0/model/7": m.PrimitiveEntry.from_object(3.14159),
        "0/opt": m.TupleEntry(),
        "0/opt/0": m.ObjectEntry(
            location="0/opt/0", serializer="pickle", obj_type="ScaleByAdamState",
            replicated=False,
        ),
        "0/big": m.ChunkedTensorEntry(
            dtype="float32",
            shape=[1000, 10],
            chunks=[
                m.Chunk(
                    offsets=[0, 0],
                    sizes=[500, 10],
                    tensor=m.TensorEntry(
                        location="0/big_0_0", serializer="buffer_protocol",
                        dtype="float32", shape=[500, 10], replicated=False,
                    ),
                )
            ],
            replicated=False,
        ),
        "sharded/emb": m.ShardedEntry(
            shards=[
                m.Shard(
                    offsets=[off, 0],
                    sizes=[512, 64],
                    tensor=m.TensorEntry(
                        location=f"sharded/emb_{i}", serializer="buffer_protocol",
                        dtype="float32", shape=[512, 64], replicated=False,
                    ),
                )
                for i, off in enumerate((0, 512))
            ]
        ),
        "0/list": m.ListEntry(),
        "0/od": m.OrderedDictEntry(keys=["x"]),
    }


class _Port:
    Chunk, ChunkedTensorEntry, DictEntry, ListEntry = Chunk, ChunkedTensorEntry, DictEntry, ListEntry
    ObjectEntry, OrderedDictEntry, PrimitiveEntry = ObjectEntry, OrderedDictEntry, PrimitiveEntry
    Shard, ShardedEntry, TensorEntry, TupleEntry = Shard, ShardedEntry, TensorEntry, TupleEntry


def test_metadata_yaml_roundtrip():
    md = SnapshotMetadata(version="0.1.0", world_size=4, manifest=_sample_manifest(_Port))
    md2 = SnapshotMetadata.from_yaml(md.to_yaml())
    assert md2.version == "0.1.0"
    assert md2.world_size == 4
    assert set(md2.manifest) == set(md.manifest)
    for k in md.manifest:
        assert md.manifest[k] == md2.manifest[k], k


@pytest.mark.parametrize("writer", ["port", "tpusnap"])
def test_metadata_yaml_reads_across_packages(writer):
    """A metadata document written by one package reads back in the other
    with the same dict form."""
    import tpusnap.manifest as ref

    port_md = SnapshotMetadata(version="0.1.0", world_size=4, manifest=_sample_manifest(_Port))
    ref_md = ref.SnapshotMetadata(version="0.1.0", world_size=4, manifest=_sample_manifest(ref))
    if writer == "port":
        back = ref.SnapshotMetadata.from_yaml(port_md.to_yaml())
    else:
        back = SnapshotMetadata.from_yaml(ref_md.to_yaml())
    assert back.to_dict() == port_md.to_dict() == ref_md.to_dict()


def test_primitive_float_bit_exact():
    for val in [0.1, math.pi, 1e-300, -0.0, 3.0]:
        got = PrimitiveEntry.from_object(val).get_value()
        assert math.copysign(1, got) == math.copysign(1, val)
        assert got == val
        assert struct.pack("<d", got) == struct.pack("<d", val)


def test_primitive_types():
    assert PrimitiveEntry.from_object(42).get_value() == 42
    assert PrimitiveEntry.from_object(True).get_value() is True
    assert PrimitiveEntry.from_object(False).get_value() is False
    assert PrimitiveEntry.from_object("hi/there%42").get_value() == "hi/there%42"
    assert PrimitiveEntry.from_object(b"\x00\xffbin").get_value() == b"\x00\xffbin"
    assert PrimitiveEntry.supported(1)
    assert PrimitiveEntry.supported("x")
    assert not PrimitiveEntry.supported([1])
    assert not PrimitiveEntry.supported(None)


def test_sharded_entry_infers_global_shape():
    e = _sample_manifest(_Port)["sharded/emb"]
    assert e.shape == [1024, 64]
    assert e.dtype == "float32"


def test_is_replicated_and_container():
    m = _sample_manifest(_Port)
    assert is_replicated(m["0/model/b"])
    assert not is_replicated(m["0/model/w"])
    assert not is_replicated(m["0/model"])
    assert is_container_entry(m["0/model"])
    assert is_container_entry(m["0/opt"])
    assert is_container_entry(m["0/list"])
    assert is_container_entry(m["0/od"])
    assert not is_container_entry(m["0/model/w"])
