"""tpusnap_torch.host_offload: the mirror of tests/test_aux.py's
TestHostOffload and of tests/test_embedding.py's async clone of
host-resident sources, for CPU tensors (pinned ones need the card:
tests/test_torch_cuda.py)."""

import logging

import numpy as np
import pytest
import torch

from tpusnap_torch import PytreeState, Snapshot
from tpusnap_torch.host_offload import (
    is_host_resident,
    is_offloaded_to_host,
    supports_host_offload,
    to_device,
    to_host_offload,
)
from tpusnap_torch.io_preparers.array import _may_alias_live_memory
from tpusnap_torch.knobs import override_async_cow


def test_supports_host_offload_when_cuda_is_there():
    assert supports_host_offload() == torch.cuda.is_available()


def test_roundtrip_and_predicates():
    x = torch.arange(64, dtype=torch.float32)
    assert is_host_resident(x)  # a CPU tensor lives in host memory
    assert not is_offloaded_to_host(x)  # but is not pinned
    xh = to_host_offload(x, "unpinned_host")
    assert xh is not x and is_host_resident(xh) and not xh.is_pinned()
    np.testing.assert_array_equal(xh.numpy(), x.numpy())
    xd = to_device(xh, "cpu")
    np.testing.assert_array_equal(xd.numpy(), x.numpy())


def test_pinned_degrades_without_cuda(caplog, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.arange(8, dtype=torch.float32)
    with caplog.at_level(logging.DEBUG, logger="tpusnap_torch.host_offload"):
        xh = to_host_offload(x)
    assert not xh.is_pinned() and torch.equal(xh, x)
    assert "pageable" in caplog.text


def test_other_memory_kinds_raise():
    with pytest.raises(ValueError, match="host memory kind"):
        to_host_offload(torch.zeros(2), "device")


def test_numpy_is_host_resident():
    assert is_host_resident(np.zeros(4))
    assert not is_offloaded_to_host(np.zeros(4))


def test_snapshot_of_host_offloaded_tensor(tmp_path):
    x = to_host_offload(torch.arange(1024, dtype=torch.float32), "unpinned_host")
    Snapshot.take(str(tmp_path / "s"), {"m": PytreeState({"emb": x})})
    target = PytreeState({"emb": torch.zeros(1024)})
    Snapshot(str(tmp_path / "s")).restore({"m": target})
    assert torch.equal(target.tree["emb"], x)


def test_host_resident_tensors_still_clone_on_async_take(tmp_path):
    """_may_alias_live_memory: a CUDA tensor stages through a copy, but a
    host-resident one (pinned: the UVM analog) stages as a view of
    itself and must keep its COW or defensive clone under async_take."""
    x = torch.arange(8, dtype=torch.float32)
    assert _may_alias_live_memory(x)
    assert _may_alias_live_memory(to_host_offload(x))
    # The defensive clone holds the state at the call while the caller
    # updates the tensor in place at once.
    table = to_host_offload(torch.arange(4096, dtype=torch.float32))
    want = table.clone()
    with override_async_cow(False):
        pending = Snapshot.async_take(str(tmp_path / "s"), {"m": PytreeState({"t": table})})
        table.add_(1)
        pending.wait()
    out = Snapshot(str(tmp_path / "s")).read_object("0/m/t")
    assert torch.equal(out, want)
