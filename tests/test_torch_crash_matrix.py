"""Randomized crash matrix of the port's two-phase commit, held against
tpusnap: the mirror of ``tests/test_crash_matrix.py``'s commit windows
and its mid-materialize and mid-retention kills for ``tpusnap_torch``.

A child takes a seeded state through the port and lingers 1.2 s inside
one commit window; the parent SIGKILLs its process group at a seeded
delay (``random.Random(seed).uniform(0, 1.5)``), so a kill lands inside
the window or, when the jitter overshoots, after it. After every kill
the one invariant of the protocol holds:

    .snapshot_metadata exists  ⟺  the snapshot restores bit-exact
                                   and verify_snapshot is clean

and the port's ``fsck_snapshot`` classifies the directory as
``committed``, ``torn`` (journal present) or ``empty``/``foreign``;
tpusnap's ``fsck_snapshot`` gives the same state on the same directory.
A torn directory keeps the black box: ``python -m tpusnap_torch
timeline --json`` names what the killed take was doing.

Windows (hooks in the child, under the names tpusnap uses):
``staging`` (``ArrayBufferStager._stage_blocking``), ``residual_io``
(``async_take`` returned, writes slowed), ``metadata`` (inside
``_write_metadata`` after a partial flushed temp write), ``durable``
(``TPUSNAP_DURABLE_COMMIT=1``, inside ``flush_created_dirs``) and
``journal`` (inside ``write_journal``). The pure-Python legs run the
child with ``TPUSNAP_DISABLE_NATIVE=1``; their restore and scrub run in
a child under the same knob, since a native parent would skip every
``zlib-crc32`` checksum it cannot compute.
"""

import contextlib
import io
import json
import os
import random
import select
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpusnap_torch import Snapshot, StateDict, fsck_snapshot, gc_snapshot, verify_snapshot

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_N_TENSORS = 12
_SHAPE = (256, 256)  # 256 KiB each: a 3 MiB state in 12 blobs


def _expected_state(seed: int) -> dict:
    return {
        f"w{i}": torch.from_numpy(
            np.random.default_rng(seed * 1000 + i).standard_normal(_SHAPE).astype(np.float32)
        )
        for i in range(_N_TENSORS)
    }


@pytest.fixture(autouse=True)
def _telemetry_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))


_CHILD = r"""
import os, sys, time
import numpy as np
import torch

window, path, seed = sys.argv[1], sys.argv[2], int(sys.argv[3])

_WINDOW_SLEEP = 1.2

def mark_and_linger():
    # The parent SIGKILLs at a seeded delay inside this sleep; a jitter
    # past it lets the take commit (the other side of the invariant).
    print("MARK", flush=True)
    time.sleep(_WINDOW_SLEEP)

import tpusnap_torch.snapshot as snap_mod
import tpusnap_torch.storage_plugins.fs as fs_mod
from tpusnap_torch import Snapshot, StateDict

if window == "staging":
    from tpusnap_torch.io_preparers import array as arr_mod
    orig_stage = arr_mod.ArrayBufferStager._stage_blocking
    fired = [False]
    def hooked(self):
        if not fired[0]:
            fired[0] = True
            mark_and_linger()
        return orig_stage(self)
    arr_mod.ArrayBufferStager._stage_blocking = hooked
elif window == "residual_io":
    # Slow every write so residual I/O is pending when async_take returns:
    # 0.5 s (tpusnap's matrix sleeps 0.08 s, which lets the whole drain end
    # before a 0.2 s jitter on this state), so seed 1's kill lands mid-drain.
    orig_write = fs_mod.FSStoragePlugin.write
    async def slow_write(self, write_io):
        import asyncio
        await asyncio.sleep(0.5)
        await orig_write(self, write_io)
    fs_mod.FSStoragePlugin.write = slow_write
elif window == "metadata":
    orig_meta = snap_mod._write_metadata
    def hooked_meta(storage, metadata, event_loop):
        # A partial, flushed temp write first: the window temp+rename
        # exists for.
        tmp = os.path.join(path, ".snapshot_metadata.crashtmp")
        with open(tmp, "wb") as f:
            f.write(b"{" + b"x" * 100)
            f.flush()
            os.fsync(f.fileno())
        mark_and_linger()
        os.unlink(tmp)
        return orig_meta(storage, metadata, event_loop)
    snap_mod._write_metadata = hooked_meta
elif window == "durable":
    os.environ["TPUSNAP_DURABLE_COMMIT"] = "1"
    orig_flush = fs_mod.FSStoragePlugin.flush_created_dirs
    async def hooked_flush(self):
        mark_and_linger()
        return await orig_flush(self)
    fs_mod.FSStoragePlugin.flush_created_dirs = hooked_flush
elif window == "journal":
    import tpusnap_torch.lifecycle as lc_mod
    orig_journal = lc_mod.write_journal
    def hooked_journal(storage, event_loop, journal):
        mark_and_linger()
        return orig_journal(storage, event_loop, journal)
    lc_mod.write_journal = hooked_journal
else:
    raise SystemExit(f"unknown window {window}")

state = {
    f"w{i}": torch.from_numpy(np.random.default_rng(seed * 1000 + i)
                              .standard_normal((256, 256)).astype(np.float32))
    for i in range(12)
}
os.environ["TPUSNAP_DISABLE_BATCHING"] = "1"
# A tight heartbeat: the flight recorder flushes on the pump, so this
# bounds what the black box can lose before the kill.
os.environ["TPUSNAP_HEARTBEAT_INTERVAL_S"] = "0.05"

if window == "residual_io":
    pending = Snapshot.async_take(path, {"app": StateDict(**state)})
    mark_and_linger()
    pending.wait()
else:
    Snapshot.take(path, {"app": StateDict(**state)})
print("DONE", flush=True)
"""

# The pure-Python legs' check, under TPUSNAP_DISABLE_NATIVE=1: a torn
# directory is first retaken over (salvage-resume under the fallback), so
# every leg ends with a committed snapshot whose checksums are checked.
_FALLBACK_CHECK = r"""
import json, os, sys
import numpy as np
import torch
from tpusnap_torch import Snapshot, StateDict, verify_snapshot
from tpusnap_torch.manifest import TensorEntry

path, seed = sys.argv[1], int(sys.argv[2])
state = {
    f"w{i}": torch.from_numpy(np.random.default_rng(seed * 1000 + i)
                              .standard_normal((256, 256)).astype(np.float32))
    for i in range(12)
}
retaken = not os.path.exists(os.path.join(path, ".snapshot_metadata"))
if retaken:
    os.environ["TPUSNAP_DISABLE_BATCHING"] = "1"
    Snapshot.take(path, {"app": StateDict(**state)})
manifest = Snapshot(path).metadata.manifest
algos = sorted({e.checksum.partition(":")[0] for e in manifest.values()
                if isinstance(e, TensorEntry)})
target = {"app": StateDict(**{k: torch.zeros_like(v) for k, v in state.items()})}
Snapshot(path).restore(target)
report = verify_snapshot(path)
print(json.dumps({
    "retaken": retaken, "algos": algos,
    "equal": all(torch.equal(target["app"][k], v) for k, v in state.items()),
    "clean": report.clean, "ok": report.ok, "unverified": report.unverified,
}), flush=True)
"""


def _child_env(extra_env=None) -> dict:
    return dict(os.environ, PYTHONPATH=_REPO, **(extra_env or {}))


def _kill_in_window(script: str, args, seed: int, jitter_max_s: float, env: dict):
    """Start ``script``, wait for its ``MARK`` (through ``select`` with a
    deadline, so a silent child cannot hang the test), then SIGKILL its
    process group after a seeded jitter. Returns (jitter, output)."""
    proc = subprocess.Popen(
        [sys.executable, "-c", script, *args], env=env, cwd=_REPO,
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
            pytest.fail(f"child never reached its window (eof={eof}): {buf[-2000:]}")
        jitter = random.Random(seed).uniform(0.0, jitter_max_s)
        time.sleep(jitter)
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
        return jitter, buf
    finally:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()


def _timeline_json(path: str):
    """In-process ``python -m tpusnap_torch timeline PATH --json``."""
    from tpusnap_torch.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        rc = main(["timeline", path, "--json"])
    out = buf.getvalue().strip()
    return rc, (json.loads(out) if out else None)


def _assert_timeline_postmortem(path, window, seed, jitter) -> None:
    """The flight sidecar survives the kill and names what the killed
    rank was doing. The journal window kills before the heartbeat pump
    starts, so it has no flight data (exit 3) or its first flush (4)."""
    rc, doc = _timeline_json(path)
    if window == "journal":
        assert rc in (3, 4), (window, seed, rc)
        return
    assert rc == 4, (window, seed, rc, doc)
    r0 = (((doc or {}).get("verdict") or {}).get("ranks") or {}).get("0")
    assert r0 is not None, (window, seed, doc)
    assert r0.get("phase") is not None, (window, seed, r0)
    assert r0.get("last_event") is not None, (window, seed, r0)
    if window == "staging" and jitter >= 0.15:
        # Three flush intervals into the staging sleep: the last flushed
        # context names the wedged op and the planned bytes.
        assert r0.get("inflight_op") is not None, (window, seed, r0)
        assert (r0.get("bytes_planned") or 0) > 0, (window, seed, r0)


def _assert_same_fsck_state(path, report, window, seed) -> None:
    from tpusnap.lifecycle import fsck_snapshot as ref_fsck

    ref = ref_fsck(path)
    assert ref.state == report.state, (window, seed, report.summary(), ref.summary())


def _run_window(tmp_path, window: str, seed: int, extra_env=None) -> None:
    path = str(tmp_path / "snap")
    env = _child_env(extra_env)
    jitter, out = _kill_in_window(_CHILD, [window, path, str(seed)], seed, 1.5, env)
    fallback = (extra_env or {}).get("TPUSNAP_DISABLE_NATIVE") == "1"

    committed = os.path.exists(os.path.join(path, ".snapshot_metadata"))
    report = fsck_snapshot(path)
    if committed:
        # Committed ⟹ a complete, bit-exact, clean snapshot.
        assert report.state == "committed", (window, seed, report.summary())
        assert not report.missing_referenced, (window, seed)
        if not fallback:
            expected = _expected_state(seed)
            target = {"app": StateDict(**{k: torch.zeros(_SHAPE) for k in expected})}
            Snapshot(path).restore(target)
            for k, v in expected.items():
                assert torch.equal(target["app"][k], v), (window, seed, k)
            assert verify_snapshot(path).clean, (window, seed)
    else:
        # Not committed ⟹ invisible, and fsck names the debris.
        with pytest.raises(RuntimeError, match="not a snapshot"):
            Snapshot(path).metadata
        if os.path.exists(os.path.join(path, ".tpusnap/journal")):
            assert report.state == "torn", (window, seed, report.summary())
            _assert_timeline_postmortem(path, window, seed, jitter)
        else:
            assert report.state in ("empty", "foreign"), (window, seed, report.summary())
    _assert_same_fsck_state(path, report, window, seed)

    if fallback:
        proc = subprocess.run(
            [sys.executable, "-c", _FALLBACK_CHECK, path, str(seed)], env=env, cwd=_REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=150,
        )
        assert proc.returncode == 0, proc.stdout[-2000:]
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        assert got["retaken"] == (not committed), got
        assert got["algos"] == ["zlib-crc32"], got
        assert got["equal"] and got["clean"], got
        assert got["ok"] >= _N_TENSORS and got["unverified"] == 0, got


_WINDOWS = ["staging", "residual_io", "metadata", "durable", "journal"]


@pytest.mark.soak
@pytest.mark.parametrize("window", _WINDOWS)
@pytest.mark.parametrize("seed", range(3))
def test_crash_matrix(tmp_path, window, seed):
    """Fast seeds: in tier-1, so every commit window stays covered."""
    _run_window(tmp_path, window, seed)


@pytest.mark.soak
@pytest.mark.parametrize("window", ["metadata", "staging"])
def test_crash_matrix_pure_python(tmp_path, window):
    """The pure-Python fallback keeps the same guarantees: its writes
    take other syscalls and its checksums another algorithm, and the
    metadata's self-checksum verifies under the fallback CRC too."""
    _run_window(tmp_path, window, 0, extra_env={"TPUSNAP_DISABLE_NATIVE": "1"})


@pytest.mark.soak
@pytest.mark.slow
@pytest.mark.parametrize("window", _WINDOWS)
@pytest.mark.parametrize("seed", range(3, 20))
def test_crash_matrix_seed_sweep(tmp_path, window, seed):
    """A wider jitter sweep of the same windows (out of tier-1)."""
    _run_window(tmp_path, window, seed)


# ------------------------------------------- materialize and retention


_MATERIALIZE_CHILD = r"""
import sys, time
path = sys.argv[1]
import tpusnap_torch.storage_plugins.fs as fs_mod

orig_write = fs_mod.FSStoragePlugin.write
fired = [False]
async def slow_write(self, write_io):
    if not fired[0]:
        fired[0] = True
        print("MARK", flush=True)
        time.sleep(1.2)
    await orig_write(self, write_io)
fs_mod.FSStoragePlugin.write = slow_write

from tpusnap_torch.inspect import materialize_snapshot
materialize_snapshot(path)
print("DONE", flush=True)
"""

_RETAIN_CHILD = r"""
import sys, time
root = sys.argv[1]
import tpusnap_torch.retention as ret_mod

orig_rmtree = ret_mod.shutil.rmtree
def slow_rmtree(p, *a, **k):
    print("MARK", flush=True)
    time.sleep(1.2)
    return orig_rmtree(p, *a, **k)
ret_mod.shutil.rmtree = slow_rmtree

from tpusnap_torch.retention import apply_retention
apply_retention(root, 2)
print("DONE", flush=True)
"""


def _kill_after_mark(script: str, args) -> str:
    """Start a child, wait for MARK, SIGKILL it 0.3 s later."""
    proc = subprocess.Popen(
        [sys.executable, "-c", script, *args], env=_child_env(), cwd=_REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True,
    )
    try:
        buf = ""
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and "MARK" not in buf:
            ready, _, _ = select.select([proc.stdout], [], [], 0.5)
            if not ready:
                continue
            chunk = os.read(proc.stdout.fileno(), 4096).decode("utf-8", errors="replace")
            if chunk == "":
                break
            buf += chunk
        assert "MARK" in buf, buf[-2000:]
        time.sleep(0.3)
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
        return buf
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def _restorable(path, expected):
    target = {"app": StateDict(**{k: torch.zeros_like(v) for k, v in expected.items()})}
    Snapshot(path).restore(target)
    for k, v in expected.items():
        assert torch.equal(target["app"][k], v), k


@pytest.mark.soak
def test_crash_mid_materialize(tmp_path):
    """SIGKILL inside materialize's blob copy: the increment stays
    committed and still references its intact base; the half-copied
    blobs are orphans gc reclaims; a retried materialize completes and
    cuts the base references."""
    from tpusnap.lifecycle import fsck_snapshot as ref_fsck
    from tpusnap_torch.inspect import materialize_snapshot

    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    state = _expected_state(1)
    Snapshot.take(base, {"app": StateDict(**state)})
    changed = dict(state, w0=state["w0"] + 1.0)
    Snapshot.take(inc, {"app": StateDict(**changed)}, incremental_from=base)
    assert Snapshot(inc).metadata.base_roots, "increment must reference base"

    _kill_after_mark(_MATERIALIZE_CHILD, [inc])

    for p in (base, inc):
        report = fsck_snapshot(p)
        assert report.state == "committed", (p, report.summary())
        assert not report.missing_referenced
        assert ref_fsck(p).state == "committed", p
    assert Snapshot(inc).metadata.base_roots, "references must survive the crash"
    _restorable(inc, changed)
    gc_snapshot(inc, dry_run=False)
    stats = materialize_snapshot(inc)
    assert stats["blobs_copied"] > 0
    assert Snapshot(inc).metadata.base_roots is None
    _restorable(inc, changed)
    assert verify_snapshot(inc).clean
    assert not fsck_snapshot(inc).missing_referenced


@pytest.mark.soak
def test_crash_mid_retention(tmp_path):
    """SIGKILL between retention's materialize phase and its deletions:
    no kept increment references a deleted base, every kept snapshot
    restores, and a re-run converges."""
    from tpusnap.lifecycle import fsck_snapshot as ref_fsck
    from tpusnap_torch.retention import apply_retention

    root = tmp_path / "snaps"
    root.mkdir()
    s1, s2, s3 = (str(root / f"s{i}") for i in (1, 2, 3))
    state = _expected_state(2)
    Snapshot.take(s1, {"app": StateDict(**state)})
    changed = dict(state, w1=state["w1"] * 2.0)
    Snapshot.take(s2, {"app": StateDict(**changed)}, incremental_from=s1)
    state3 = dict(state, w2=state["w2"] - 3.0)
    Snapshot.take(s3, {"app": StateDict(**state3)})

    _kill_after_mark(_RETAIN_CHILD, [str(root)])

    # Retention materializes before it deletes, so s2 is either still
    # base-backed (s1 present) or already self-contained.
    assert os.path.exists(os.path.join(s2, ".snapshot_metadata"))
    report = fsck_snapshot(s2)
    assert report.state == "committed" == ref_fsck(s2).state
    assert not report.missing_referenced, report.summary()
    if Snapshot(s2).metadata.base_roots:
        assert os.path.exists(os.path.join(s1, ".snapshot_metadata")), (
            "kept increment references a deleted base"
        )
    _restorable(s2, changed)
    _restorable(s3, state3)
    apply_retention(str(root), 2)
    assert sorted(os.listdir(root)) == ["s2", "s3"]
    _restorable(s2, changed)
    _restorable(s3, state3)
    assert verify_snapshot(s2).clean and verify_snapshot(s3).clean
