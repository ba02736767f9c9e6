"""RSS profiler: sample the process's resident-set growth during a take.

Counterpart of tpusnap/rss_profiler.py. A background thread samples the
process RSS delta on an interval; :class:`RSSSampler` is the start/stop
form the telemetry embeds so every take's summary carries its peak-RSS
figure. The RSS is read from ``/proc/self/statm`` (the standard library
only; without procfs it reads as 0).
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Generator, List, Optional

_DEFAULT_INTERVAL_SEC = 0.1
_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def current_rss_bytes() -> int:
    """This process's resident set size in bytes."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        return 0


class RSSSampler:
    """Background-thread RSS-delta sampler with explicit start/stop.

    Samples ``process RSS - baseline`` into ``deltas`` every
    ``interval_sec`` between :meth:`start` and :meth:`stop`; ``stop``
    always appends one final sample and joins the thread."""

    def __init__(
        self,
        deltas: Optional[List[int]] = None,
        interval_sec: float = _DEFAULT_INTERVAL_SEC,
    ) -> None:
        self.deltas: List[int] = deltas if deltas is not None else []
        self.interval_sec = interval_sec
        self._baseline = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "RSSSampler":
        if self._thread is not None:
            raise RuntimeError("RSSSampler already started")
        self._baseline = current_rss_bytes()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._sample_loop, name="tpusnap-rss", daemon=True
        )
        self._thread.start()
        return self

    def _sample_loop(self) -> None:
        while not self._stop.wait(self.interval_sec):
            self.deltas.append(current_rss_bytes() - self._baseline)

    def stop(self) -> List[int]:
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
            self.deltas.append(current_rss_bytes() - self._baseline)
        return self.deltas

    @property
    def peak_delta(self) -> int:
        return max(self.deltas, default=0)


@contextmanager
def measure_rss_deltas(
    rss_deltas: List[int], interval_sec: float = _DEFAULT_INTERVAL_SEC
) -> Generator[None, None, None]:
    """Append RSS deltas (bytes, relative to entry) to ``rss_deltas``
    every ``interval_sec`` until the context exits."""
    sampler = RSSSampler(deltas=rss_deltas, interval_sec=interval_sec)
    sampler.start()
    try:
        yield
    finally:
        sampler.stop()
