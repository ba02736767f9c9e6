"""The port's wedge-proof probe runner (tpusnap_torch/_subproc.py), held
to tests/test_subproc.py: returning on time even when a grandchild
inherits the output files (a helper that holds the pipe of a wedged CUDA
child) and ignores signals, and killing the whole process group."""

import os
import sys
import time

from tpusnap_torch._subproc import run_hard_timeout


def test_success_path_captures_output():
    r = run_hard_timeout(
        [sys.executable, "-c", "import sys; print('out'); sys.stderr.write('err')"],
        timeout_s=30,
    )
    assert not r.timed_out and r.returncode == 0
    assert "out" in r.stdout and "err" in r.stderr


def test_missing_binary_reports_not_raises():
    r = run_hard_timeout(["/nonexistent-binary-xyz"], timeout_s=5)
    assert not r.timed_out and r.returncode == 127


def test_timeout_returns_promptly_despite_pipe_holding_grandchild():
    """The child spawns a grandchild that inherits its stdout and sleeps
    forever. subprocess.run with
    capture_output would block draining the pipe after the kill; the
    hard-timeout runner must return within bounds, report what the
    child DID print, and take the grandchild down with the group."""
    code = (
        "import os, subprocess, sys, time\n"
        "p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(600)'])\n"
        "print('grandchild', p.pid, flush=True)\n"
        "time.sleep(600)\n"
    )
    t0 = time.monotonic()
    # 5s: enough for the child interpreter to start and print (a 2s
    # window raced cold CPython startup), far below the sleeps.
    r = run_hard_timeout([sys.executable, "-c", code], timeout_s=5)
    elapsed = time.monotonic() - t0
    assert r.timed_out and r.returncode is None
    assert elapsed < 40
    assert "grandchild" in r.stdout  # pre-timeout output preserved
    gpid = int(r.stdout.split()[1])
    # The WHOLE group was SIGKILLed: the grandchild must be gone (it is
    # reparented to init and reaped; allow a moment for that).
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            os.kill(gpid, 0)
        except ProcessLookupError:
            break
        # Still visible: it may be a zombie pending reaping — check.
        try:
            with open(f"/proc/{gpid}/stat") as f:
                if f.read().split(")")[-1].split()[0] == "Z":
                    break
        except OSError:
            break
        time.sleep(0.1)
    else:
        raise AssertionError(f"grandchild {gpid} survived the group kill")


def test_bounded_retries_rerun_from_scratch():
    r = run_hard_timeout(
        [sys.executable, "-c", "import time; time.sleep(600)"],
        timeout_s=1,
        retries=2,
    )
    assert r.timed_out and r.attempts == 3
