"""async_take under high-latency storage: blocked time against total time.

Counterpart of benchmarks/async_latency/main.py. On a fast local disk,
staging and I/O finish together, so async_take's advantage is invisible.
This harness adds a fixed latency to every request of the fs plugin (the
cloud-storage shape, ~50 ms a request) without disk-bandwidth noise, and
reports:

- sync take: training blocked for the whole wall time;
- async take: blocked only until the state is staged; the storage I/O
  drains behind training.

The last async snapshot is restored through the same plugin and must
equal the state.

    python -m tpusnap_torch.benchmarks.async_latency [--latency-ms 50]
        [--mb 256] [--runs 3] [--device cuda|cpu]
"""

import argparse
import asyncio
import shutil
import sys
import tempfile
import time
from typing import List, Optional

import torch

from tpusnap_torch import Snapshot, StateDict
from tpusnap_torch._device import add_device_argument, device_missing
from tpusnap_torch.benchmarks import result, synchronize
from tpusnap_torch.storage_plugin import register_storage_plugin, unregister_storage_plugin
from tpusnap_torch.storage_plugins.fs import FSStoragePlugin

N_TENSORS = 16


def _slow_fs(latency_s: float):
    class HighLatencyFS(FSStoragePlugin):
        """Local fs with a fixed latency per request."""

        async def write(self, write_io):
            await asyncio.sleep(latency_s)
            await super().write(write_io)

        async def read(self, read_io):
            await asyncio.sleep(latency_s)
            await super().read(read_io)

    return lambda path, opts: HighLatencyFS(path, opts)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tpusnap_torch.benchmarks.async_latency")
    parser.add_argument("--latency-ms", type=float, default=50.0)
    parser.add_argument("--mb", type=float, default=256.0)
    parser.add_argument("--runs", type=int, default=3)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    if device_missing(parser.prog, args.device):
        return 2

    register_storage_plugin("slowfs", _slow_fs(args.latency_ms / 1e3))
    root = tempfile.mkdtemp(prefix="tpusnap_torch_async_lat_")
    try:
        gen = torch.Generator(device=args.device).manual_seed(0)
        per = int(args.mb * 2**20) // N_TENSORS // 4
        state = StateDict(**{
            f"w{i}": torch.randn(per, generator=gen, device=args.device) for i in range(N_TENSORS)
        })
        nbytes = per * 4 * N_TENSORS
        print(f"{nbytes / 1e6:.0f} MB over {N_TENSORS} tensors, "
              f"+{args.latency_ms:.0f} ms per storage request")
        sync_times, blocked_times, total_times = [], [], []
        for run in range(args.runs):
            synchronize(args.device)
            t0 = time.perf_counter()
            Snapshot.take(f"slowfs://{root}/sync{run}", {"app": state})
            sync_times.append(time.perf_counter() - t0)

            synchronize(args.device)
            t0 = time.perf_counter()
            pending = Snapshot.async_take(f"slowfs://{root}/async{run}", {"app": state})
            blocked_times.append(time.perf_counter() - t0)
            pending.wait()
            total_times.append(time.perf_counter() - t0)

        target = StateDict(**{k: torch.zeros_like(v) for k, v in state.items()})
        Snapshot(f"slowfs://{root}/async{args.runs - 1}").restore({"app": target})
        restore_equal = all(torch.equal(target[k], v) for k, v in state.items())
    finally:
        unregister_storage_plugin("slowfs")
        shutil.rmtree(root, ignore_errors=True)

    sync_s, blocked, total = min(sync_times), min(blocked_times), min(total_times)
    print(f"sync take:   {sync_s:.2f}s blocked (100% of the snapshot)")
    print(f"async take:  {blocked:.2f}s blocked / {total:.2f}s total "
          f"(training stalls {100 * blocked / total:.0f}% of the snapshot; "
          f"{sync_s / blocked:.1f}x less than sync)")
    return result(
        "async_latency", args.device, restore_equal,
        bytes=nbytes, tensors=N_TENSORS, latency_ms=args.latency_ms, runs=args.runs,
        sync_s=sync_s, async_blocked_s=blocked, async_total_s=total,
        sync_runs=sync_times, blocked_runs=blocked_times, total_runs=total_times,
        restore_equal=restore_equal,
    )


if __name__ == "__main__":
    sys.exit(main())
