"""The device trace of a run's window: ``torch.profiler`` (CUPTI) over
the window, reduced to device busy time, time by kernel name and the
idle gaps named by what the host was doing.

The host's activity is the benchmark's own ``record_function`` spans
around each call into the program (``SPANS``); an idle gap that no span
covers is ``harness``. Nothing here reads the program's own spans.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

SPANS = ("train_step", "async_take", "wait", "take", "restore", "delete")


def span(name: str):
    """A host span of the benchmark's own, seen by the profiler only
    while it runs."""
    import torch

    return torch.profiler.record_function(name)


class DeviceTrace:
    """Start with ``start()``, end with ``stop()``, then ``reduce()``."""

    def __init__(self) -> None:
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def reduce(self) -> dict:
        from torch.autograd import DeviceType

        results = self._prof.profiler.kineto_results
        device: List[Tuple[int, int, str]] = []
        host: List[Tuple[int, int, str]] = []
        # Names and times are read only of the events kept: a traced
        # window holds millions of CPU ops.
        for ev in results.events():
            on_device = ev.device_type() == DeviceType.CUDA
            annotation = ev.is_user_annotation()
            if not on_device and not annotation:
                continue
            name = ev.name()
            start = ev.start_ns()
            span_ = (start, start + ev.duration_ns(), name)
            if on_device and not annotation and name not in SPANS:
                device.append(span_)
            elif not on_device and name in SPANS:
                # A span's device-side copy covers its idle gaps too: only
                # the host side is kept.
                host.append(span_)
        self._prof = None
        kept = device + host
        if not kept:
            return summarize(device, host, 0, 0)
        t_lo = min(s for s, _, _ in kept)
        if hasattr(results, "trace_start_ns"):
            t_lo = min(t_lo, results.trace_start_ns())
        return summarize(device, host, t_lo, max(e for _, e, _ in kept))


def summarize(device: List[Tuple[int, int, str]], host: List[Tuple[int, int, str]],
              t_lo: int, t_hi: int) -> dict:
    """Device intervals and host spans (start ns, end ns, name) over the
    traced window [t_lo, t_hi] -> ``window_s``, ``busy_s`` (union of
    device intervals), ``ops`` {name: [count, seconds]} and ``idle``
    {host activity: seconds of device idle}."""
    ops: Dict[str, List[float]] = {}
    for s, e, name in device:
        agg = ops.setdefault(name, [0, 0.0])
        agg[0] += 1
        agg[1] += (e - s) / 1e9
    busy_ns, gaps = 0, []
    cur_s = cur_e = None
    for s, e, _ in sorted(device):
        if cur_e is None:
            cur_s, cur_e = s, e
            if s > t_lo:
                gaps.append((t_lo, s))
        elif s > cur_e:
            busy_ns += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_ns += cur_e - cur_s
        if t_hi > cur_e:
            gaps.append((cur_e, t_hi))
    idle: Dict[str, float] = {}
    host = sorted(host)
    starts = [s for s, _, _ in host]
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = host[i][2] if i >= 0 and host[i][1] >= mid else "harness"
        idle[name] = idle.get(name, 0.0) + (ge - gs) / 1e9
    return {
        "window_s": max(t_hi - t_lo, 0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "ops": ops,
        "idle": idle,
    }


def kernel_time(trace: Optional[dict], *needles: str) -> Tuple[int, float]:
    """(calls, device seconds) of the kernels whose name holds any of
    ``needles``."""
    calls, seconds = 0, 0.0
    for name, (count, secs) in (trace or {}).get("ops", {}).items():
        if any(n in name for n in needles):
            calls += count
            seconds += secs
    return calls, seconds


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by
    host activity, at most ``top`` each, longest first."""
    ops = sorted(trace["ops"].items(), key=lambda kv: -kv[1][1])[:top]
    idle = sorted(trace["idle"].items(), key=lambda kv: -kv[1])[:top]
    return {
        "device_ops": [[name[:160], secs] for name, (_, secs) in ops],
        "idle_gaps": [[name, secs] for name, secs in idle],
    }
