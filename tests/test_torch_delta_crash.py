"""Crash matrix of the port's delta stream, held against tpusnap: the
mirror of ``tests/test_crash_matrix.py``'s delta-stream windows for
``tpusnap_torch``.

A child opens ``Snapshot.stream`` on a self-describing state
(``w = pattern(seed) + k`` at step ``k``) and micro-commits steps 1..7;
the parent SIGKILLs its process group inside one window, at a seeded
delay (``random.Random(seed).uniform(0, 0.8)``):

- ``delta_micro``: inside a micro-commit's storage write, after at least
  one delta has committed;
- ``delta_between``: between two micro-commits (after step 3);
- ``delta_compact``: inside chain compaction (``max_chain=2``), as
  ``materialize_snapshot`` starts.

After every kill the chain's crash contract holds: replaying base +
deltas restores the last committed step bit-exact (never older than the
last printed commit), the port's and tpusnap's ``fsck_snapshot`` give the
same class to every chain member, a torn tail is torn and keeps its chain
membership, and ``python -m tpusnap_torch fsck ROOT`` exits 4 with a
torn tail and 0 without.
"""

import contextlib
import io
import json
import os
import random
import re
import select
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpusnap_torch import Snapshot, StateDict, fsck_snapshot, resolve_chain, verify_snapshot

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _telemetry_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))


_DELTA_CHILD = r"""
import os, sys, time
os.environ["TPUSNAP_DISABLE_BATCHING"] = "1"
os.environ["TPUSNAP_HEARTBEAT_INTERVAL_S"] = "0.05"
import numpy as np
import torch

window, root, seed = sys.argv[1], sys.argv[2], int(sys.argv[3])

_WINDOW_SLEEP = 1.2

def mark_and_linger():
    print("MARK", flush=True)
    time.sleep(_WINDOW_SLEEP)

import tpusnap_torch.storage_plugins.fs as fs_mod
import tpusnap_torch.inspect as inspect_mod
from tpusnap_torch import Snapshot, StateDict

if window == "delta_micro":
    # Inside a micro-commit's storage write, after >= 1 delta committed
    # (so recovery lands on a delta, not the base).
    orig_write = fs_mod.FSStoragePlugin.write
    fired = [False]
    async def hooked(self, write_io):
        root_s = getattr(self, "root", "")
        if (
            not fired[0]
            and "delta-0000" in root_s
            and not root_s.endswith("delta-000001")
            and not write_io.path.startswith(".tpusnap")
        ):
            fired[0] = True
            mark_and_linger()
        await orig_write(self, write_io)
    fs_mod.FSStoragePlugin.write = hooked
elif window == "delta_compact":
    orig_mat = inspect_mod.materialize_snapshot
    def hooked_mat(*a, **kw):
        mark_and_linger()
        return orig_mat(*a, **kw)
    inspect_mod.materialize_snapshot = hooked_mat
elif window != "delta_between":
    raise SystemExit(f"unknown window {window}")

# pattern(seed) + step: the parent recomputes the state of any step.
pattern = torch.from_numpy(
    np.random.default_rng(seed).standard_normal((256, 256)).astype(np.float32))
state = {"app": StateDict(w=pattern.clone(), step=0)}
max_chain = 2 if window == "delta_compact" else 100
stream = Snapshot.stream(root, state, cadence_s=3600, max_chain=max_chain)
for k in range(1, 8):
    state["app"]["w"] = pattern + float(k)
    state["app"]["step"] = k
    stream.commit_now()
    print(f"COMMIT {stream.seq} {k}", flush=True)
    if window == "delta_between" and k == 3:
        mark_and_linger()
print("DONE", flush=True)
stream.close(final_commit=False)
"""


def _kill_in_window(window: str, root: str, seed: int) -> str:
    """Start the child, wait for its MARK through ``select`` with a
    deadline, SIGKILL its process group after the seeded jitter."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _DELTA_CHILD, window, root, str(seed)],
        env=dict(os.environ, PYTHONPATH=_REPO), cwd=_REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True,
    )
    try:
        buf = ""
        deadline = time.monotonic() + 120
        marked = eof = False
        while time.monotonic() < deadline and not marked and not eof:
            ready, _, _ = select.select([proc.stdout], [], [], 0.5)
            if not ready:
                continue
            chunk = os.read(proc.stdout.fileno(), 4096).decode("utf-8", errors="replace")
            eof = chunk == ""
            buf += chunk
            marked = "MARK" in buf
        if not marked:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)
            pytest.fail(f"child never reached window {window!r} (eof={eof}): {buf[-2000:]}")
        time.sleep(random.Random(seed).uniform(0.0, 0.8))
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
        return buf
    finally:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()


def _cli(argv):
    """In-process ``python -m tpusnap_torch ARGV``: (exit code, stdout)."""
    from tpusnap_torch.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    return rc, buf.getvalue()


def _run_delta_window(tmp_path, window: str, seed: int) -> None:
    from tpusnap.lifecycle import fsck_snapshot as ref_fsck

    root = str(tmp_path / "stream")
    buf = _kill_in_window(window, root, seed)
    printed = [int(m.group(2)) for m in re.finditer(r"COMMIT (\d+) (\d+)", buf)]
    last_printed_step = printed[-1] if printed else 0

    rep = resolve_chain(root)
    assert rep.head is not None, (window, seed, buf[-500:], rep.summary())
    head_path = rep.head_path

    # 1. Replay restores the last committed step bit-exact (the step rides
    # in the snapshot, so an unprinted trailing commit checks too).
    pattern = torch.from_numpy(
        np.random.default_rng(seed).standard_normal((256, 256)).astype(np.float32)
    )
    target = {"app": StateDict(w=torch.zeros(256, 256), step=-1)}
    Snapshot(head_path).restore(target)
    k = target["app"]["step"]
    assert k >= last_printed_step, (
        f"recovery lost a committed micro-commit: restored step {k} < "
        f"last printed {last_printed_step}"
    )
    expected = pattern + float(k) if k > 0 else pattern
    assert torch.equal(target["app"]["w"], expected), (window, seed, k)
    assert verify_snapshot(head_path).clean, (window, seed)

    # 2. Every member of the stream root is classified alike by both
    # packages; the head is a committed delta member.
    head_report = fsck_snapshot(head_path)
    assert head_report.state == "committed", head_report.summary()
    assert head_report.delta is not None, head_report.summary()
    for name in sorted(os.listdir(root)):
        member = os.path.join(root, name)
        if not os.path.isdir(member) or name.startswith("."):
            continue
        ours, theirs = fsck_snapshot(member), ref_fsck(member)
        assert ours.state == theirs.state, (window, seed, name, ours.summary(), theirs.summary())
        assert (ours.delta is None) == (theirs.delta is None), (window, seed, name)
    if rep.torn_tail:
        torn_path = os.path.join(root, rep.torn_tail)
        torn_report = fsck_snapshot(torn_path)
        assert torn_report.state == "torn", torn_report.summary()
        assert torn_report.delta is not None, (
            "torn tail lost its chain membership", torn_report.summary(),
        )
        assert "torn delta micro-commit" in torn_report.summary()
        # 3. timeline names the in-flight delta state (4), or the kill
        # came before the first flight flush (3).
        rc, out = _cli(["timeline", torn_path, "--json"])
        assert rc in (3, 4), (window, seed, rc)
        if rc == 4:
            doc = json.loads(out)
            assert doc.get("delta") and doc["delta"].get("seq") is not None, doc
    # The stream root's fsck honours the chain's exit contract.
    rc, _ = _cli(["fsck", root])
    assert rc == (4 if rep.torn_tail else 0), (window, seed, rc)


_DELTA_WINDOWS = ["delta_micro", "delta_between", "delta_compact"]


@pytest.mark.soak
@pytest.mark.parametrize("window", _DELTA_WINDOWS)
@pytest.mark.parametrize("seed", range(2))
def test_delta_crash_matrix(tmp_path, window, seed):
    """Inside a micro-commit, between two, and mid-compaction (tier-1
    seeds)."""
    _run_delta_window(tmp_path, window, seed)


@pytest.mark.soak
@pytest.mark.slow
@pytest.mark.parametrize("window", _DELTA_WINDOWS)
@pytest.mark.parametrize("seed", range(2, 10))
def test_delta_crash_matrix_seed_sweep(tmp_path, window, seed):
    _run_delta_window(tmp_path, window, seed)
