"""Budgeted ``read_object`` of a large tensor (tests/test_tiled_read.py's
subject) into an exact-match CUDA target: the tiles go one by one through
a pinned buffer each into the target's rows, so the host never holds the
whole tensor. The card runs it in tests/test_torch_cuda.py and the smoke's
load_tensor harness; on the CPU the same consumer runs with the CUDA checks
replaced (a non-contiguous CPU target stands for the card's, pageable
buffers for pinned ones), to hold its tiling and row placement."""

import torch

import tpusnap_torch.io_preparers.array as array_preparer
from tpusnap_torch import PytreeState, Snapshot


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
