"""Budgeted ``read_object`` of a large tensor (tests/test_tiled_read.py's
subject) into an exact-match CUDA target: the tiles go one by one through
a pinned buffer each into the target's rows, so the host never holds the
whole tensor. The card runs it in tests/test_torch_cuda.py and the smoke's
load_tensor harness; on the CPU the same consumer runs with the CUDA checks
replaced (a non-contiguous CPU target stands for the card's, pageable
buffers for pinned ones), to hold its tiling and row placement. Below it,
the four cases of tests/test_tiled_read.py on CPU tensors; the budget
case holds the reads in flight, not the process RSS."""

import numpy as np
import pytest
import torch

import tpusnap_torch.io_preparers.array as array_preparer
from tpusnap_torch import PytreeState, Snapshot, StateDict
from tpusnap_torch.knobs import override_slab_size_threshold_bytes


def test_exact_device_target_gets_each_tile_through_its_own_buffer(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))
    monkeypatch.setattr(
        array_preparer, "_is_exact_cuda_target",
        lambda t, dtype, shape: isinstance(t, torch.Tensor) and list(t.shape) == list(shape),
    )
    tiles = []

    def pageable_tile(self):
        self._pinned = torch.empty(
            array_preparer.tensor_nbytes(self.entry.dtype, self._tile_shape()), dtype=torch.uint8
        )
        tiles.append((self.r0, self.r1))
        return memoryview(self._pinned.numpy())

    monkeypatch.setattr(array_preparer._TileConsumer, "_pinned_tile", pageable_tile)
    big = torch.randn(4096, 256, generator=torch.Generator().manual_seed(0))
    Snapshot.take(str(tmp_path / "s"), {"m": PytreeState({"big": big})})
    target = torch.zeros(256, 4096).t()  # not contiguous: no in-place host view
    out = Snapshot(str(tmp_path / "s")).read_object(
        "0/m/big", obj_out=target, memory_budget_bytes=1 << 20
    )
    assert out is target and torch.equal(target, big)
    # 1 MiB tiles of 1024 rows, each read into its own buffer.
    assert sorted(tiles) == [(0, 1024), (1024, 2048), (2048, 3072), (3072, 4096)]


# The mirror of tests/test_tiled_read.py: ``read_object`` of a tensor far
# larger than the budget streams byte-ranged tiles instead of reading one
# dense copy.

MB = 1024 * 1024


@pytest.fixture()
def big_snapshot(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))
    arr = np.random.default_rng(3).integers(0, 2**15, (192, 256 * 1024), dtype=np.int16)
    big = torch.from_numpy(arr)  # 96 MiB
    Snapshot.take(str(tmp_path / "snap"), {"s": StateDict(w=big)})
    return str(tmp_path / "snap"), big


def test_tiled_read_correct_and_budgeted(big_snapshot, monkeypatch):
    """One 96 MiB tensor under an 8 MiB budget splits into byte-ranged
    tile reads. Tiles align up to the 16 MiB checksum tile (integrity
    over budget), so there are at least nbytes / 16 MiB of them, and no
    more than one tile's bytes are ever in flight."""
    from tpusnap_torch.scheduler import LAST_EXECUTION_STATS
    from tpusnap_torch.storage_plugins.fs import FSStoragePlugin

    path, big = big_snapshot
    nbytes = big.numel() * big.element_size()
    flight = {"now": 0, "peak": 0, "largest": 0}
    real_read = FSStoragePlugin.read

    async def tracked_read(self, read_io):
        if read_io.path != "0/s/w":  # the metadata
            return await real_read(self, read_io)
        start, end = read_io.byte_range or (0, nbytes)
        flight["largest"] = max(flight["largest"], end - start)
        flight["now"] += end - start
        flight["peak"] = max(flight["peak"], flight["now"])
        try:
            await real_read(self, read_io)
        finally:
            flight["now"] -= end - start

    monkeypatch.setattr(FSStoragePlugin, "read", tracked_read)
    budget = 8 * MB
    out = Snapshot(path).read_object("0/s/w", memory_budget_bytes=budget)
    assert torch.equal(out, big)
    stats = LAST_EXECUTION_STATS["read"]
    assert stats["reqs"] >= nbytes // (16 * MB)
    assert stats["budget_bytes"] == budget
    assert flight["largest"] <= 16 * MB
    assert flight["peak"] <= 16 * MB, flight


def test_tiled_read_in_place_target(big_snapshot):
    path, big = big_snapshot
    target = torch.zeros_like(big)
    out = Snapshot(path).read_object("0/s/w", obj_out=target, memory_budget_bytes=8 * MB)
    assert out is target
    assert torch.equal(target, big)


def test_tiled_read_of_slab_resident_entry(tmp_path, monkeypatch):
    """A slab-resident tensor read under a budget smaller than itself
    tiles within the slab's byte range."""
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))
    rng = np.random.default_rng(4)
    tensors = {
        f"w{i}": torch.from_numpy(rng.integers(0, 2**15, (64, 64 * 1024), dtype=np.int16))
        for i in range(3)
    }  # 8 MiB each: they batch under a raised threshold
    with override_slab_size_threshold_bytes(64 * MB):
        Snapshot.take(str(tmp_path / "snap"), {"s": StateDict(**tensors)})
    snap = Snapshot(str(tmp_path / "snap"))
    assert snap.get_manifest()["0/s/w1"].byte_range is not None, "tensors were not slab-batched"
    assert torch.equal(snap.read_object("0/s/w1", memory_budget_bytes=1 * MB), tensors["w1"])


def test_unbudgeted_read_object_unchanged(big_snapshot):
    path, big = big_snapshot
    assert torch.equal(Snapshot(path).read_object("0/s/w"), big)
