"""Per-blob integrity checksums of ``tpusnap_torch``: the mirror of the
cases of ``tests/test_checksum.py`` that no other port test holds
(``test_corrupt_chunk_fails_restore`` is
``tests/test_torch_chunked.py::test_corrupt_chunk_fails_its_checksum``).

Checksums are recorded at stage time into the manifest and verified on
read; a flipped bit in storage fails the restore naming the blob. Each
state is made from a seeded numpy generator, and where both packages
take it their recorded checksums are held equal.
"""

import glob
import os

import numpy as np
import pytest
import torch

from tpusnap_torch import Snapshot, StateDict, _native, verify_snapshot
from tpusnap_torch._native import ChecksumError
from tpusnap_torch.knobs import (
    _override_env,
    override_batching_disabled,
    override_checksum_disabled,
    override_record_dedup_hashes,
    override_slab_size_threshold_bytes,
    override_tile_checksum_bytes,
)


@pytest.fixture(autouse=True)
def _telemetry_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))


def _t(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(arr.copy())


def _corrupt_one_byte(snap_dir: str, name_fragment: str, offset: int = 100) -> str:
    """Flip one byte in the first blob file whose path holds the fragment."""
    for f in sorted(glob.glob(f"{snap_dir}/**/*", recursive=True)):
        if (
            os.path.isfile(f)
            and name_fragment in os.path.relpath(f, snap_dir)
            and not f.endswith(".snapshot_metadata")
            and "/.tpusnap/" not in f
        ):
            with open(f, "r+b") as fh:
                fh.seek(offset)
                b = fh.read(1)
                fh.seek(offset)
                fh.write(bytes([b[0] ^ 0xFF]))
            return f
    raise AssertionError(f"no blob matching {name_fragment!r} in {snap_dir}")


def test_checksums_recorded_in_manifest(tmp_path):
    import tpusnap

    arr = np.arange(4096, dtype=np.float32)
    # A set does not flatten: it persists as a pickled ObjectEntry.
    Snapshot.take(str(tmp_path / "s"), {"m": StateDict(w=_t(arr), meta={1, 2, 3})})
    manifest = Snapshot(str(tmp_path / "s")).get_manifest()
    tensor_entry = manifest["0/m/w"]
    algo, _, value = tensor_entry.checksum.partition(":")
    assert algo in ("crc32c", "zlib-crc32") and len(value) == 8
    assert manifest["0/m/meta"].checksum is not None
    # tpusnap records the same checksum for the same bytes.
    tpusnap.Snapshot.take(str(tmp_path / "ref"), {"m": tpusnap.StateDict(w=arr)})
    ref = tpusnap.Snapshot(str(tmp_path / "ref")).get_manifest()["0/m/w"]
    assert tensor_entry.checksum == ref.checksum


def test_corrupt_tensor_fails_restore_naming_path(tmp_path):
    arr = np.random.default_rng(0).standard_normal(100_000).astype(np.float32)
    Snapshot.take(str(tmp_path / "s"), {"m": StateDict(w=_t(arr))})
    _corrupt_one_byte(str(tmp_path / "s"), "w")
    target = {"m": StateDict(w=torch.zeros(100_000))}
    with pytest.raises(ChecksumError, match="m/w"):
        Snapshot(str(tmp_path / "s")).restore(target)


def test_corrupt_object_fails_restore(tmp_path):
    # A set pickles into one ObjectEntry blob (a dict would flatten into
    # inline primitives with no blob to corrupt).
    Snapshot.take(str(tmp_path / "s"), {"m": StateDict(cfg={"x" * 4000, "y"})})
    _corrupt_one_byte(str(tmp_path / "s"), "cfg")
    target = {"m": StateDict(cfg=None)}
    with pytest.raises(ChecksumError, match="cfg"):
        Snapshot(str(tmp_path / "s")).restore(target)


def test_corrupt_slab_member_fails_read_object(tmp_path):
    """Slab members carry member-grain checksums."""
    tensors = {f"w{i}": torch.full((2048,), float(i)) for i in range(4)}
    with override_slab_size_threshold_bytes(1 << 20):
        Snapshot.take(str(tmp_path / "s"), {"m": StateDict(**tensors)})
    snap = Snapshot(str(tmp_path / "s"))
    entry = snap.get_manifest()["0/m/w2"]
    assert entry.byte_range is not None, "state was not slab-batched"
    assert entry.checksum is not None
    slabs = sorted(glob.glob(f"{tmp_path}/s/batched/*"))
    assert slabs, "no slab file found"
    with open(slabs[0], "r+b") as fh:  # one byte inside w2's range
        fh.seek(entry.byte_range[0] + 8)
        b = fh.read(1)
        fh.seek(entry.byte_range[0] + 8)
        fh.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(ChecksumError, match="w2"):
        snap.read_object("0/m/w2")
    assert torch.equal(snap.read_object("0/m/w1"), tensors["w1"])


def _sharded_take_world(root: str) -> None:
    """Both ranks of a gloo world take one Shard(0) DTensor."""
    from torch.distributed.tensor import Shard

    from tpusnap_torch.test_utils import as_dtensor, world_mesh

    full = torch.arange(32768, dtype=torch.float32)
    Snapshot.take(root, {"m": StateDict(w=as_dtensor(full, world_mesh("cpu"), [Shard(0)]))})


def test_corrupt_shard_fails_sharded_read(tmp_path):
    """A corrupt shard of a world-2 DTensor take fails the read that
    assembles the tensor, naming the shard's offset."""
    from tpusnap_torch.test_utils import run_subprocess_world

    path = str(tmp_path / "s")
    run_subprocess_world(_sharded_take_world, world_size=2, args=[path], timeout=150)
    manifest = Snapshot(path).metadata.manifest  # one ShardedEntry per rank
    shards = [s for r in (0, 1) for s in manifest[f"{r}/m/w"].shards]
    assert len(shards) == 2 and all(s.tensor.checksum for s in shards)
    assert torch.equal(Snapshot(path).read_object("0/m/w"), torch.arange(32768, dtype=torch.float32))
    _corrupt_one_byte(path, "w.16384")
    with pytest.raises(ChecksumError, match="16384"):
        Snapshot(path).read_object("0/m/w")


def test_checksum_knob_disables_both_sides(tmp_path):
    t = torch.arange(50_000, dtype=torch.float32)
    with override_checksum_disabled(True):
        Snapshot.take(str(tmp_path / "s"), {"m": StateDict(w=t)})
        assert Snapshot(str(tmp_path / "s")).get_manifest()["0/m/w"].checksum is None
    # Taken with checksums, corrupted, read with verification off.
    Snapshot.take(str(tmp_path / "s2"), {"m": StateDict(w=t)})
    _corrupt_one_byte(str(tmp_path / "s2"), "w")
    with override_checksum_disabled(True):
        target = {"m": StateDict(w=torch.zeros_like(t))}
        Snapshot(str(tmp_path / "s2")).restore(target)  # no raise
        assert not torch.equal(target["m"]["w"], t)


def test_budget_tiled_read_verifies_tiles(tmp_path):
    """Memory-budgeted partial reads verify against tile-grain checksums:
    a huge tensor read under a budget detects corruption."""
    with _override_env("TPUSNAP_TILE_CHECKSUM_BYTES", str(64 * 1024)):
        arr = np.random.default_rng(2).integers(0, 2**15, (256, 4096), dtype=np.int16)
        t = _t(arr)
        Snapshot.take(str(tmp_path / "s"), {"m": StateDict(w=t)})
        snap = Snapshot(str(tmp_path / "s"))
        entry = snap.get_manifest()["0/m/w"]
        assert entry.tile_checksums and entry.tile_rows
        assert len(entry.tile_checksums) == -(-256 // entry.tile_rows)
        assert torch.equal(snap.read_object("0/m/w", memory_budget_bytes=256 * 1024), t)

        _corrupt_one_byte(str(tmp_path / "s"), "w", offset=arr.nbytes // 2)
        fresh = Snapshot(str(tmp_path / "s"))
        with pytest.raises(ChecksumError, match="rows"):
            fresh.read_object("0/m/w", memory_budget_bytes=256 * 1024)
        # The whole-blob (combined) checksum catches it on a full read.
        with pytest.raises(ChecksumError, match="m/w"):
            fresh.read_object("0/m/w")
        # The kill switch turns tile verification off too (salvaging a
        # corrupt checkpoint works through the budget path).
        with override_checksum_disabled(True):
            out = Snapshot(str(tmp_path / "s")).read_object("0/m/w", memory_budget_bytes=256 * 1024)
            assert not torch.equal(out, t)


def test_tile_checksums_combine_to_whole(tmp_path):
    """The whole-blob checksum derived by CRC combine from the tiles
    equals the direct hash of the bytes."""
    with _override_env("TPUSNAP_TILE_CHECKSUM_BYTES", str(64 * 1024)):
        arr = np.random.default_rng(7).integers(0, 255, 300 * 1024, dtype=np.uint8).reshape(300, 1024)
        Snapshot.take(str(tmp_path / "s"), {"m": StateDict(w=_t(arr))})
    entry = Snapshot(str(tmp_path / "s")).get_manifest()["0/m/w"]
    assert entry.tile_checksums
    _, _, value = entry.checksum.partition(":")
    assert int(value, 16) == (_native.crc32c(arr.tobytes()) & 0xFFFFFFFF)


_FIELDS = ("checksum", "tile_rows", "tile_checksums", "dedup_hash", "tile_dedup_hashes")


def _same_hash_fields(sync_path, async_path) -> int:
    sm = Snapshot(sync_path).get_manifest()
    am = Snapshot(async_path).get_manifest()
    assert set(sm) == set(am)
    checked = 0
    for p, se in sm.items():
        for field in _FIELDS:
            if hasattr(se, field):
                assert getattr(se, field) == getattr(am[p], field), (p, field)
                checked += 1
    assert checked > 0
    return checked


def test_async_take_fused_clone_checksums_match_sync(tmp_path):
    """The async path records checksums in its clone pass; the values,
    tile grain included, equal the sync path's, and the snapshot scrubs
    clean."""
    rng = np.random.default_rng(7)
    state = {
        "big": _t(rng.standard_normal((2048, 64)).astype(np.float32)),
        "small": _t(rng.standard_normal(32).astype(np.float32)),
    }
    with override_tile_checksum_bytes(128 * 1024), override_batching_disabled(True):
        sync_path, async_path = str(tmp_path / "sync"), str(tmp_path / "async")
        Snapshot.take(sync_path, {"app": StateDict(**state)})
        Snapshot.async_take(async_path, {"app": StateDict(**state)}).wait()
    _same_hash_fields(sync_path, async_path)
    big_entry = Snapshot(async_path).get_manifest()["0/app/big"]
    assert big_entry.tile_checksums and len(big_entry.tile_checksums) > 1
    assert verify_snapshot(async_path).clean


class TestXxh64Native:
    """The 64-bit dedup hash: native XXH64 against published vectors,
    fused tile passes against one-shot recomputation, and the algorithm
    tag."""

    VECTORS = [  # (input, seed-0 XXH64), from the xxHash reference
        (b"", 0xEF46DB3751D8E999),
        (b"a", 0xD24EC4F1A98C6E5B),
        (b"abc", 0x44BC2CF5AD770999),
    ]

    def test_known_vectors(self):
        if not _native.available():
            pytest.skip("native helper unavailable")
        for data, expect in self.VECTORS:
            assert _native.xxh64(data) == expect, data

    def test_fused_tiles_match_one_shot(self):
        # An odd length exercises the sub-stripe tails.
        buf = np.random.default_rng(0).integers(0, 255, 5_000_001, dtype=np.uint8)
        tile = 1 << 20
        crcs, xxhs = _native.crc_xxh_tiles(buf, tile)
        dst = np.empty_like(buf)
        crcs2, xxhs2 = _native.memcpy_crc_xxh_tiles(dst, buf, tile)
        assert list(crcs) == list(crcs2) and list(xxhs) == list(xxhs2)
        assert np.array_equal(dst, buf)
        for i in range(len(xxhs)):
            sub = buf[i * tile : min((i + 1) * tile, buf.nbytes)]
            assert _native.crc32c(sub) == crcs[i]
            assert _native.xxh64(sub) == xxhs[i]

    def test_algorithm_tag_matches_build(self):
        from tpusnap import _native as ref_native

        s = _native.dedup_hash_string(b"hello")
        algo, _, val = s.partition(":")
        assert algo == _native.dedup_hash_algorithm()
        assert len(val) == 16 and int(val, 16) >= 0
        assert s == ref_native.dedup_hash_string(b"hello")


def test_dedup_hashes_sync_async_parity(tmp_path):
    """Incremental-capable manifests are identical between the sync hash
    pass and the async clone+hash pass, dedup hashes included."""
    rng = np.random.default_rng(11)
    state = {
        "big": _t(rng.standard_normal((2048, 32)).astype(np.float32)),
        "small": _t(rng.standard_normal(64).astype(np.float32)),
    }
    with override_batching_disabled(True), override_tile_checksum_bytes(
        16 * 1024
    ), override_record_dedup_hashes(True):
        sync_path, async_path = str(tmp_path / "sync"), str(tmp_path / "async")
        Snapshot.take(sync_path, {"app": StateDict(**state)})
        Snapshot.async_take(async_path, {"app": StateDict(**state)}).wait()
    _same_hash_fields(sync_path, async_path)
    sm = Snapshot(sync_path).get_manifest()
    assert sm["0/app/big"].tile_dedup_hashes
    assert sm["0/app/small"].dedup_hash
    assert verify_snapshot(async_path).clean
