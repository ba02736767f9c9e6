"""Retention's fault cases for ``tpusnap_torch``: the mirror of the four
crash and fault cases of ``tests/test_retention.py`` (a fault between
materialize's blob copies, a fault in its metadata commit, a crash
halfway through retention's deletions, a SIGKILL mid-materialize).

Whatever the fault, every kept snapshot stays readable bit-exact and
scrubs clean, and a re-run converges. After each fault tpusnap scrubs the
port's snapshot clean too. The plain retention cases are in
``tests/test_torch_inspect.py``. States come from seeded numpy
generators; comparisons are exact.
"""

import os
import select
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpusnap_torch import Snapshot, StateDict, verify_snapshot
from tpusnap_torch.inspect import materialize_snapshot
from tpusnap_torch.knobs import override_batching_disabled
from tpusnap_torch.retention import apply_retention
from tpusnap_torch.storage_plugins.fs import FSStoragePlugin

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _telemetry_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path.parent / f"{tmp_path.name}-tele"))


def _chain(tmp_path, n=3):
    """s0 (full) <- s1 <- s2, an incremental chain with one frozen blob
    and a changing step."""
    root = str(tmp_path)
    frozen = torch.from_numpy(np.random.default_rng(0).standard_normal((512, 64)).astype(np.float32))
    prev = None
    hots = []
    with override_batching_disabled(True):
        for i in range(n):
            hot = torch.full((64,), float(i))
            hots.append(hot)
            path = os.path.join(root, f"s{i}")
            Snapshot.take(
                path, {"app": StateDict(frozen=frozen, hot=hot, step=i)}, incremental_from=prev
            )
            prev = path
    return root, {"frozen": frozen}, hots


def _multi_blob_chain(tmp_path):
    """A chain whose last increment references several base blobs, so a
    fault can land between copies."""
    root = str(tmp_path)
    rng = np.random.default_rng(0)
    frozen = {
        f"f{i}": torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
        for i in range(4)
    }
    prev = None
    hots = []
    with override_batching_disabled(True):
        for i in range(3):
            hot = torch.full((64,), float(i))
            hots.append(hot)
            path = os.path.join(root, f"s{i}")
            Snapshot.take(
                path, {"app": StateDict(hot=hot, step=i, **frozen)}, incremental_from=prev
            )
            prev = path
    return root, frozen, hots


def _restore_ok(path, frozen, hots, i):
    tgt = {"app": StateDict(
        hot=torch.zeros(64), step=-1, **{k: torch.zeros_like(v) for k, v in frozen.items()}
    )}
    Snapshot(path).restore(tgt)
    assert tgt["app"]["step"] == i
    assert torch.equal(tgt["app"]["hot"], hots[i])
    for k, v in frozen.items():
        assert torch.equal(tgt["app"][k], v), k


def _scrubs_clean(path):
    """Clean to both packages' scrubs."""
    from tpusnap import verify_snapshot as ref_verify

    assert verify_snapshot(path).clean
    assert ref_verify(path).clean


def test_fault_mid_materialize_keeps_snapshot_readable(tmp_path, monkeypatch):
    """Blob-copy writes fail partway through materialize: the manifest is
    not rewritten (the metadata commit is last and atomic), the increment
    still references its bases and reads back, and a re-run converges."""
    root, frozen, hots = _multi_blob_chain(tmp_path)
    s2 = os.path.join(root, "s2")
    calls = {"n": 0}
    real_write = FSStoragePlugin.write

    async def faulty_write(self, write_io):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise IOError("injected: storage died mid-materialize")
        return await real_write(self, write_io)

    monkeypatch.setattr(FSStoragePlugin, "write", faulty_write)
    with pytest.raises(Exception, match="injected"):
        materialize_snapshot(s2)
    monkeypatch.setattr(FSStoragePlugin, "write", real_write)
    assert calls["n"] >= 2  # the fault landed between copies
    assert Snapshot(s2).metadata.base_roots
    _restore_ok(s2, frozen, hots, 2)
    _scrubs_clean(s2)
    stats = materialize_snapshot(s2)
    assert stats["blobs_copied"] >= 1
    assert Snapshot(s2).metadata.base_roots is None
    _restore_ok(s2, frozen, hots, 2)
    _scrubs_clean(s2)


def test_fault_mid_metadata_commit_keeps_snapshot_readable(tmp_path, monkeypatch):
    """The atomic metadata rewrite itself fails: the old metadata
    survives intact (temp + rename) and a re-run converges."""
    root, frozen, hots = _chain(tmp_path)
    s2 = os.path.join(root, "s2")

    async def faulty_atomic(self, write_io, durable=False):
        raise IOError("injected: died in metadata commit")

    monkeypatch.setattr(FSStoragePlugin, "write_atomic", faulty_atomic)
    with pytest.raises(Exception, match="injected"):
        materialize_snapshot(s2)
    monkeypatch.undo()
    assert Snapshot(s2).metadata.base_roots
    _restore_ok(s2, frozen, hots, 2)
    _scrubs_clean(s2)
    materialize_snapshot(s2)
    assert Snapshot(s2).metadata.base_roots is None
    _restore_ok(s2, frozen, hots, 2)


def test_crash_mid_delete_keeps_survivors_readable(tmp_path, monkeypatch):
    """The delete phase dies halfway (the first rmtree succeeds, the
    second raises): the kept snapshot was made self-contained before any
    deletion and reads back, and a re-run of retention converges."""
    import shutil

    root, frozen, hots = _chain(tmp_path)
    real_rmtree = shutil.rmtree
    calls = {"n": 0}

    def faulty_rmtree(path, *a, **kw):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise OSError("injected: crash mid-delete")
        return real_rmtree(path, *a, **kw)

    monkeypatch.setattr("tpusnap_torch.retention.shutil.rmtree", faulty_rmtree)
    with pytest.raises(OSError, match="injected"):
        apply_retention(root, keep_last=1)
    monkeypatch.undo()
    s2 = os.path.join(root, "s2")
    _restore_ok(s2, frozen, hots, 2)
    _scrubs_clean(s2)
    plan = apply_retention(root, keep_last=1)
    assert plan.executed
    assert sorted(os.listdir(root)) == ["s2"]
    _restore_ok(s2, frozen, hots, 2)


_SIGKILL_CHILD = r"""
import sys, time
import tpusnap_torch.storage_plugins.fs as fsmod
real = fsmod.FSStoragePlugin.write
async def slow(self, wio):
    await real(self, wio)
    print("COPIED", flush=True)
    time.sleep(30)  # hold mid-copy so the kill lands here
fsmod.FSStoragePlugin.write = slow
from tpusnap_torch.inspect import materialize_snapshot
print("READY", flush=True)
materialize_snapshot(sys.argv[1])
"""


def test_sigkill_mid_materialize(tmp_path):
    """SIGKILL (no cleanup, no exception handling) mid-materialize leaves
    the increment readable, and a re-run in a fresh process converges."""
    root, frozen, hots = _chain(tmp_path)
    s2 = os.path.join(root, "s2")
    proc = subprocess.Popen(
        [sys.executable, "-c", _SIGKILL_CHILD, s2], cwd=_REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=_REPO), start_new_session=True,
    )
    try:
        buf = ""
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and "COPIED" not in buf:
            ready, _, _ = select.select([proc.stdout], [], [], 0.5)
            if not ready:
                continue
            chunk = os.read(proc.stdout.fileno(), 4096).decode("utf-8", errors="replace")
            if chunk == "":
                break
            buf += chunk
        assert "COPIED" in buf, f"child never copied a blob: {buf[-2000:]}"
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert Snapshot(s2).metadata.base_roots
    _restore_ok(s2, frozen, hots, 2)
    _scrubs_clean(s2)
    stats = materialize_snapshot(s2)
    assert stats["blobs_copied"] >= 1
    assert Snapshot(s2).metadata.base_roots is None
    _restore_ok(s2, frozen, hots, 2)
