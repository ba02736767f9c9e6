"""Pinned host memory (the UVM analog) through a snapshot.

Counterpart of benchmarks/pinned_host/probe.py: a tensor made on the
device is offloaded to pinned host memory (``to_host_offload``), taken,
and restored into a pinned target, which must stay the same pinned
tensor and hold the values. It proves the capability at 4 MiB, as the
JAX probe does. Without CUDA pinning degrades to pageable memory, so with
``--device cpu`` the pinned fields are reported and not required.

    python -m tpusnap_torch.benchmarks.pinned_host [--device cuda|cpu]
"""

import argparse
import shutil
import sys
import tempfile
import time
from typing import List, Optional

import torch

from tpusnap_torch import PytreeState, Snapshot, is_host_resident, supports_host_offload
from tpusnap_torch import to_host_offload
from tpusnap_torch._device import add_device_argument, device_missing
from tpusnap_torch.benchmarks import result


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tpusnap_torch.benchmarks.pinned_host")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    if device_missing(parser.prog, args.device):
        return 2

    n = (4 << 20) // 4  # 4 MiB of f32
    arr = torch.arange(n, dtype=torch.float32, device=args.device)
    offloaded = to_host_offload(arr)
    target = to_host_offload(torch.zeros(n, dtype=torch.float32, device=args.device))
    out = {"bytes": n * 4, "host_offload_supported": supports_host_offload(),
           "host_resident": is_host_resident(offloaded), "source_pinned": offloaded.is_pinned()}
    work = tempfile.mkdtemp(prefix="tpusnap_torch_pinned_")
    try:
        t0 = time.perf_counter()
        Snapshot.take(work + "/snap", {"m": PytreeState({"table": offloaded})})
        out["take_s"] = time.perf_counter() - t0
        state = PytreeState({"table": target})
        t0 = time.perf_counter()
        Snapshot(work + "/snap").restore({"m": state})
        out["restore_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    restored = state.tree["table"]
    out["in_place"] = restored is target
    out["restored_pinned"] = restored.is_pinned()
    out["values_equal"] = bool(torch.equal(restored, arr.cpu()))
    print(f"pinned host table of {n * 4 / 1e6:.1f} MB: take {out['take_s']:.3f}s, "
          f"restore {out['restore_s']:.3f}s, restored pinned: {out['restored_pinned']}")
    ok = out["values_equal"] and out["in_place"] and (
        out["restored_pinned"] or args.device == "cpu"
    )
    return result("pinned_host", args.device, ok, **out)


if __name__ == "__main__":
    sys.exit(main())
