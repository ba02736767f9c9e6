"""Data-parallel checkpointing: the DDP example.

Counterpart of examples/distributed_example.py. N processes hold
replicas of the same model; ``replicated=["**"]`` declares all state
identical across ranks, so each value is written ONCE, the writes spread
across every rank, and every rank can restore it.

    python -m tpusnap_torch.examples.distributed --world-size 2
        [--work-dir DIR] [--device cuda|cpu]

The launcher starts the worker in N processes of one gloo world
(``tpusnap_torch.test_utils.run_subprocess_world``); with ``--device
cuda`` they share the one card. On a real cluster, run the worker once
per rank under your launcher instead.
"""

import argparse
import os
import sys
import tempfile
from typing import List, Optional

import torch

from tpusnap_torch._device import add_device_argument, device_missing


def worker(work_dir: str, device: str) -> None:
    import torch.distributed as dist

    from tpusnap_torch import PytreeState, Snapshot, StateDict

    rank = dist.get_rank()
    # Every rank constructs identical params (in real DDP training they
    # stay identical through the gradient all-reduce).
    params = {
        "w": torch.ones((256, 256), device=device) * 0.01,
        "b": torch.zeros((256,), device=device),
    }
    app_state = {"model": PytreeState(params), "progress": StateDict(step=0)}

    path = os.path.join(work_dir, "snap")
    Snapshot.take(path, app_state, replicated=["**"])
    if rank == 0:
        print(f"rank 0: snapshot at {path}")

    # The manifest holds ONE copy of each replicated value.
    snapshot = Snapshot(path)
    manifest = snapshot.get_manifest()
    logical = {p.split("/", 1)[1] for p in manifest}
    if "model/w" not in logical:  # PytreeState leaves have named paths
        raise AssertionError(sorted(logical))
    print(f"rank {rank}: manifest entries {len(manifest)} (deduplicated)")

    # Restore works on every rank, in place.
    target = {
        "model": PytreeState({k: torch.zeros_like(v) for k, v in params.items()}),
        "progress": StateDict(step=-1),
    }
    snapshot.restore(target)
    if not torch.equal(target["model"].tree["w"], params["w"]):
        raise AssertionError(f"rank {rank}: restored w differs")
    if target["progress"]["step"] != 0:
        raise AssertionError(f"rank {rank}: progress restored as {target['progress']}")
    print(f"rank {rank}: restore verified")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tpusnap_torch.examples.distributed")
    parser.add_argument("--world-size", type=int, default=2)
    parser.add_argument("--work-dir", default=None)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    if device_missing(parser.prog, args.device):
        return 2

    from tpusnap_torch.test_utils import run_subprocess_world

    # Absolute: the ranks run from the repository root.
    work_dir = os.path.abspath(args.work_dir or tempfile.mkdtemp(prefix="tpusnap_torch_ddp_"))
    outputs = run_subprocess_world(
        worker, world_size=args.world_size, args=[work_dir, args.device]
    )
    for out in outputs:
        for line in out.strip().splitlines():
            if line.startswith("rank"):
                print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
