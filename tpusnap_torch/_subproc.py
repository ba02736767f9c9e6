"""Hard-timeout subprocess runner for probes on the card.

A child that drives CUDA can wedge for good (a kernel that never
returns, a CUDA call stuck behind a hung context), and helper
processes it starts inherit any pipes the caller creates.
``subprocess.run(capture_output=True, timeout=...)`` is NOT safe
against that: on timeout it kills the direct child and then blocks
draining the captured pipes — forever, when a surviving grandchild
(a helper that holds the pipe) still has the write ends open.

``run_hard_timeout`` cannot wedge:

- stdout/stderr go to temp FILES, so there is nothing to drain and a
  surviving grandchild can hold its copies open without blocking us;
- the child runs in its own session (process group), and on timeout
  the WHOLE group is SIGKILLed — its helpers die with it;
- every wait is bounded; optional retries re-run the probe from
  scratch.

Counterpart of tpusnap/_subproc.py (the same code).
"""

from __future__ import annotations

import os
import signal
import subprocess
import tempfile
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class ProbeResult:
    timed_out: bool
    returncode: Optional[int]  # None when timed_out
    stdout: str
    stderr: str
    attempts: int = 1


def _read_file(f) -> str:
    try:
        f.seek(0)
        return f.read().decode("utf-8", errors="replace")
    except OSError:
        return ""


def run_hard_timeout(
    cmd: List[str],
    timeout_s: float,
    env: Optional[dict] = None,
    retries: int = 0,
    grace_s: float = 10.0,
) -> ProbeResult:
    """Run ``cmd`` with a timeout that holds even when the child spawns
    pipe-holding, signal-ignoring grandchildren. On timeout the child's
    whole process group is SIGKILLed and (with ``retries`` > 0) the
    command is re-run from scratch. Never raises for child misbehavior;
    the caller branches on ``timed_out`` / ``returncode``."""
    last: Optional[ProbeResult] = None
    for attempt in range(1, retries + 2):
        with tempfile.TemporaryFile() as out_f, tempfile.TemporaryFile() as err_f:
            try:
                proc = subprocess.Popen(
                    cmd,
                    stdout=out_f,
                    stderr=err_f,
                    stdin=subprocess.DEVNULL,
                    env=env,
                    start_new_session=True,
                )
            except OSError as e:
                return ProbeResult(False, 127, "", str(e), attempt)
            try:
                rc = proc.wait(timeout=timeout_s)
                return ProbeResult(
                    False, rc, _read_file(out_f), _read_file(err_f), attempt
                )
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                try:
                    proc.wait(timeout=grace_s)
                except subprocess.TimeoutExpired:
                    pass  # unreaped zombie; we still return on time
                last = ProbeResult(
                    True, None, _read_file(out_f), _read_file(err_f), attempt
                )
    assert last is not None
    return last
