"""The port's storage knobs against tpusnap's behaviour (mirrors of
tests/test_storage.py and the batcher's device-batching switch):

- ``TPUSNAP_DURABLE_COMMIT=1`` fsyncs every blob after its write, the
  metadata's temp file, and every directory the take created; off, a take
  fsyncs nothing;
- ``TPUSNAP_DISABLE_DEVICE_BATCHING=1`` sends CUDA slab members to the
  host pack, as tpusnap's ``_device_group_key`` does.
"""

import os
import types

import pytest
import torch

import tpusnap_torch.storage_plugins.fs as fs
from tpusnap_torch import Snapshot, StateDict
from tpusnap_torch.batcher import _device_group_key
from tpusnap_torch.io_preparers.array import ArrayBufferStager
from tpusnap_torch.knobs import override_batching_disabled, override_device_batching_disabled


def _counting_fsyncs(monkeypatch, root):
    synced = []
    orig = fs._fsync_path

    def counting(path):
        synced.append(os.path.relpath(path, root))
        orig(path)

    monkeypatch.setattr(fs, "_fsync_path", counting)
    return synced


@pytest.mark.parametrize("durable", [True, False], ids=["durable", "default"])
def test_durable_commit_knob_round_trip(tmp_path, monkeypatch, durable):
    if durable:
        monkeypatch.setenv("TPUSNAP_DURABLE_COMMIT", "1")
    synced = _counting_fsyncs(monkeypatch, str(tmp_path))
    state = {"app": StateDict(w=torch.arange(32, dtype=torch.float32),
                              nested={"v": torch.ones(4, 8)})}
    with override_batching_disabled(True):
        Snapshot.take(str(tmp_path / "snap"), state)
    if not durable:
        assert synced == []
    else:
        blobs = {"snap/0/app/w", "snap/0/app/nested/v"}
        dirs = {"snap", "snap/0/app", "snap/0/app/nested"}
        assert blobs | dirs <= set(synced), synced
        assert any(s.startswith("snap/.snapshot_metadata.tmp") for s in synced), synced
    target = {"app": StateDict(w=torch.zeros(32), nested={"v": torch.zeros(4, 8)})}
    Snapshot(str(tmp_path / "snap")).restore(target)
    assert target["app"]["w"].equal(torch.arange(32, dtype=torch.float32))
    assert target["app"]["nested"]["v"].equal(torch.ones(4, 8))


def test_durable_async_take_flushes_before_commit(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_DURABLE_COMMIT", "1")
    synced = _counting_fsyncs(monkeypatch, str(tmp_path))
    with override_batching_disabled(True):
        Snapshot.async_take(str(tmp_path / "snap"), {"app": StateDict(w=torch.ones(64))}).wait()
    commit = next(i for i, s in enumerate(synced) if s.startswith("snap/.snapshot_metadata.tmp"))
    # The blob and the directories were flushed before the commit began,
    # and the directories again with it.
    assert {"snap/0/app/w", "snap/0/app", "snap"} <= set(synced[:commit]), synced
    assert {"snap/0/app", "snap"} <= set(synced[commit:]), synced


def test_device_batching_knob(monkeypatch):
    """A CUDA member packs on its device unless the knob sends it to the
    host pack (a stand-in tensor: this host has no card)."""
    stager = ArrayBufferStager(torch.ones(4))
    monkeypatch.setattr(stager, "arr", types.SimpleNamespace(is_cuda=True, device="cuda:0"))
    assert _device_group_key(stager) == "cuda:0"
    with override_device_batching_disabled(True):
        assert _device_group_key(stager) is None
    cpu = ArrayBufferStager(torch.ones(4))
    assert _device_group_key(cpu) is None
