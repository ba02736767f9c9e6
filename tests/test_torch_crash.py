"""Crash consistency of the port's take: the mirror of ``tests/test_crash.py``
and of the salvage, pipelined-drain and gc cases of
``tests/test_crash_matrix.py`` for ``tpusnap_torch``.

A take killed with SIGKILL (no Python cleanup, no atexit) leaves no
``.snapshot_metadata``; the directory is torn to ``fsck_snapshot``; the
same path stays usable, and a retake salvages the blobs whose journal
evidence matches. The kills are deterministic: the child takes through
``chaos+fs://`` and its fault plan SIGKILLs it after its N-th blob write
(or, for gc, a hook in the child kills it inside the delete loop).
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpusnap_torch import Snapshot, StateDict, fsck_snapshot, gc_snapshot, telemetry, verify_snapshot
from tpusnap_torch.knobs import override_batching_disabled

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _expected_state(seed: int, n: int = 12) -> dict:
    return {
        f"w{i}": torch.from_numpy(
            np.random.default_rng(seed * 1000 + i).standard_normal((256, 256)).astype(np.float32)
        )
        for i in range(n)
    }


def _run_child(script: str, *args: str, env=None):
    full_env = dict(os.environ, PYTHONPATH=_REPO, TPUSNAP_DISABLE_BATCHING="1",
                    TPUSNAP_COMPRESS="off", **(env or {}))
    proc = subprocess.run(
        [sys.executable, "-c", script, *args], env=full_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=150, cwd=_REPO,
    )
    return proc.returncode, proc.stdout


_TAKE_CHILD = r"""
import sys
import numpy as np
import torch
from tpusnap_torch import Snapshot, StateDict

path, seed, crash_at = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
state = {
    f"w{i}": torch.from_numpy(np.random.default_rng(seed * 1000 + i)
                              .standard_normal((256, 256)).astype(np.float32))
    for i in range(12)
}
Snapshot.take("chaos+fs://" + path, {"app": StateDict(**state)},
              storage_options={"fault_plan": {"seed": seed, "crash_after_op": ("write", crash_at)}})
print("UNEXPECTED_COMPLETION", flush=True)
"""


def _restored(path: str, expected: dict) -> dict:
    target = {"app": StateDict(**{k: torch.zeros_like(v) for k, v in expected.items()})}
    Snapshot(path).restore(target)
    return target["app"]


def test_sigkill_mid_take_leaves_no_metadata(tmp_path):
    path = str(tmp_path / "snap")
    rc, out = _run_child(_TAKE_CHILD, path, "0", "3")
    assert rc == -signal.SIGKILL, out[-2000:]
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))
    with pytest.raises(RuntimeError, match="not a snapshot"):
        Snapshot(path).metadata
    # The path is reusable: a fresh take over the debris scrubs clean.
    fresh = StateDict(x=torch.arange(4096, dtype=torch.float32))
    Snapshot.take(path, {"app": fresh})
    assert verify_snapshot(path).clean
    target = {"app": StateDict(x=torch.zeros(4096))}
    Snapshot(path).restore(target)
    assert torch.equal(target["app"]["x"], fresh["x"])


def test_many_leaf_state_stays_compact(tmp_path):
    """10k small leaves slab-batch into a handful of files and
    round-trip."""
    rng = np.random.default_rng(0)
    state = {f"p{i}": torch.from_numpy(rng.standard_normal(64).astype(np.float32))
             for i in range(10_000)}
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"app": StateDict(**state)})
    n_files = sum(len(fs) for d, _, fs in os.walk(path) if ".tpusnap" not in d.split(os.sep))
    assert n_files <= 8, f"{n_files} files for 10k leaves — batching broken?"
    got = _restored(path, state)
    for k in ("p0", "p5000", "p9999"):
        assert torch.equal(got[k], state[k]), k
    assert verify_snapshot(path).clean


@pytest.mark.chaos
@pytest.mark.parametrize("seed,crash_at", [(0, 8), (1, 10)])
def test_salvage_resume_of_torn_take(tmp_path, seed, crash_at):
    """SIGKILL a take after N blob writes, retake the same path with the
    same state: the retake salvages exactly the intact bytes fsck counts,
    the committed rollup carries the counter, the result restores
    bit-exact, and a sibling committed snapshot is untouched."""
    path, sibling = str(tmp_path / "snap"), str(tmp_path / "sibling")
    expected = _expected_state(seed)
    with override_batching_disabled(True):
        Snapshot.take(sibling, {"app": StateDict(**expected)})
        rc, out = _run_child(_TAKE_CHILD, path, str(seed), str(crash_at))
        assert rc == -signal.SIGKILL, out[-2000:]
        report = fsck_snapshot(path)
        assert report.state == "torn", report.summary()
        assert report.salvage_records >= 1 and report.salvage_bytes_present > 0
        before = telemetry.counter_value("salvage.bytes_salvaged")
        Snapshot.take(path, {"app": StateDict(**expected)})
        salvaged = telemetry.counter_value("salvage.bytes_salvaged") - before
        assert salvaged == report.salvage_bytes_present
        rollup = (Snapshot(path).metadata.extras or {}).get("telemetry", {})
        assert rollup.get("counters", {}).get("salvage.bytes_salvaged", 0) == salvaged
    assert fsck_snapshot(path).state == "committed"
    got = _restored(path, expected)
    for k, v in expected.items():
        assert torch.equal(got[k], v), k
    assert verify_snapshot(path).clean
    assert fsck_snapshot(sibling).state == "committed"
    assert verify_snapshot(sibling).clean


_PIPELINED_DRAIN_CHILD = r"""
import os, sys
import numpy as np
import torch
from tpusnap_torch import Snapshot, StateDict

path, seed, crash_at = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
# A tight window: async_take returns after about one blob, and the kill
# lands in the background drain of the residual windows.
os.environ["TPUSNAP_ASYNC_STAGE_WINDOW_BYTES"] = str(1 << 19)
state = {
    f"w{i}": torch.from_numpy(np.random.default_rng(seed * 1000 + i)
                              .standard_normal((256, 256)).astype(np.float32))
    for i in range(12)
}
pending = Snapshot.async_take(
    "chaos+fs://" + path, {"app": StateDict(**state)},
    storage_options={"fault_plan": {"seed": seed, "crash_after_op": ("write", crash_at)}},
)
print("RETURNED", flush=True)
pending.wait()
print("UNEXPECTED_COMPLETION", flush=True)
"""


@pytest.mark.chaos
@pytest.mark.pipelined
def test_sigkill_in_pipelined_async_drain_is_torn_and_salvageable(tmp_path):
    seed, crash_at = 3, 6
    path = str(tmp_path / "snap")
    expected = _expected_state(seed)
    rc, out = _run_child(_PIPELINED_DRAIN_CHILD, path, str(seed), str(crash_at))
    assert rc == -signal.SIGKILL, out[-2000:]
    assert "RETURNED" in out and "UNEXPECTED_COMPLETION" not in out, out[-2000:]
    report = fsck_snapshot(path)
    assert report.state == "torn", report.summary()
    assert report.salvage_records >= 1 and report.salvage_bytes_present > 0
    before = telemetry.counter_value("salvage.bytes_salvaged")
    with override_batching_disabled(True):
        Snapshot.take(path, {"app": StateDict(**expected)})
    assert telemetry.counter_value("salvage.bytes_salvaged") - before == report.salvage_bytes_present
    assert fsck_snapshot(path).state == "committed"
    got = _restored(path, expected)
    for k, v in expected.items():
        assert torch.equal(got[k], v), k
    assert verify_snapshot(path).clean


_GC_CHILD = r"""
import os, sys
import tpusnap_torch.storage_plugins.fs as fs_mod
from tpusnap_torch.lifecycle import gc_snapshot

orig_delete = fs_mod.FSStoragePlugin.delete
calls = [0]

async def delete(self, p):
    calls[0] += 1
    if calls[0] == 3:  # two orphans gone, then the process dies
        os.kill(os.getpid(), 9)
    await orig_delete(self, p)

fs_mod.FSStoragePlugin.delete = delete
gc_snapshot(sys.argv[1], dry_run=False)
print("DONE", flush=True)
"""


def test_crash_mid_gc(tmp_path):
    """SIGKILL inside gc's delete loop: the snapshot stays committed and
    bit-exact, the deleted orphans stay gone, and a second gc reclaims
    exactly the survivors."""
    path = str(tmp_path / "snap")
    expected = _expected_state(0)
    Snapshot.take(path, {"app": StateDict(**expected)})
    orphans = {f"orphan_{i}.blob": 1000 + i for i in range(5)}
    for name, size in orphans.items():
        with open(os.path.join(path, name), "wb") as f:
            f.write(b"x" * size)
    assert set(fsck_snapshot(path).orphans) == set(orphans)
    rc, out = _run_child(_GC_CHILD, path)
    assert rc == -signal.SIGKILL, out[-2000:]
    report = fsck_snapshot(path)
    assert report.state == "committed" and not report.missing_referenced, report.summary()
    remaining = set(report.orphans)
    assert len(remaining) == 3 and remaining <= set(orphans)
    assert verify_snapshot(path).clean
    g = gc_snapshot(path, dry_run=False)
    assert set(g.reclaimed) == remaining and not g.errors
    assert not fsck_snapshot(path).orphans
    got = _restored(path, expected)
    for k, v in expected.items():
        assert torch.equal(got[k], v), k
