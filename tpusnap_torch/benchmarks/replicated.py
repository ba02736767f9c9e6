"""Replicated (DDP) state: ``torch.save`` from rank 0 against a take with
``replicated=["**"]``.

Counterpart of benchmarks/replicated/main.py (the reference's DDP
benchmark). N data-parallel ranks hold identical state; compare

- ``torch.save`` from rank 0 only (the incumbent), and
- ``Snapshot.take(replicated=["**"])``: each value written once, the
  write load spread over every rank by the partitioner (the bytes each
  rank wrote are reported).

Every rank then restores the snapshot in place and must get the state
bit for bit. The ranks are one gloo world
(``tpusnap_torch.test_utils.run_subprocess_world``); with ``--device
cuda`` they share the one card.

    python -m tpusnap_torch.benchmarks.replicated [--world-size 2]
        [--gb 1.0] [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Optional

from tpusnap_torch._device import add_device_argument, device_missing

N_TENSORS = 8
_TAG = "replicated_rank "


def worker(work_dir: str, gb: str, device: str) -> None:
    import torch
    import torch.distributed as dist

    from tpusnap_torch import PytreeState, Snapshot
    from tpusnap_torch import scheduler as _sched
    from tpusnap_torch.benchmarks import synchronize

    rank = dist.get_rank()
    nbytes = int(float(gb) * 1024**3)
    gen = torch.Generator(device=device).manual_seed(0)  # same seed: identical state per rank
    state = {
        f"w{i}": torch.randint(-(2**15), 2**15, (nbytes // N_TENSORS // 2,), generator=gen,
                               dtype=torch.int16, device=device)
        for i in range(N_TENSORS)
    }
    out = {"rank": rank}
    if rank == 0:
        synchronize(device)
        t0 = time.perf_counter()
        torch.save(state, os.path.join(work_dir, "baseline.pt"))
        out["torch_save_s"] = time.perf_counter() - t0
    dist.barrier()
    synchronize(device)
    t0 = time.perf_counter()
    Snapshot.take(f"{work_dir}/snap", {"m": PytreeState(state)}, replicated=["**"])
    out["take_s"] = time.perf_counter() - t0
    # Per-rank write volume: the partitioner spreads the replicated bytes
    # over every rank, and this split is the direct evidence.
    out["bytes_written"] = _sched.LAST_EXECUTION_STATS.get("write", {}).get("bytes", 0)
    target = PytreeState({k: torch.zeros_like(v) for k, v in state.items()})
    synchronize(device)
    t0 = time.perf_counter()
    Snapshot(f"{work_dir}/snap").restore({"m": target})
    synchronize(device)
    out["restore_s"] = time.perf_counter() - t0
    out["restore_equal"] = all(torch.equal(target.tree[k], v) for k, v in state.items())
    print(_TAG + json.dumps(out), flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tpusnap_torch.benchmarks.replicated")
    parser.add_argument("--world-size", type=int, default=2)
    parser.add_argument("--gb", type=float, default=1.0)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    if device_missing(parser.prog, args.device):
        return 2

    from tpusnap_torch.benchmarks import result
    from tpusnap_torch.test_utils import run_subprocess_world

    with tempfile.TemporaryDirectory(prefix="tpusnap_torch_bench_repl_") as work_dir:
        outputs = run_subprocess_world(
            worker, world_size=args.world_size,
            args=[work_dir, str(args.gb), args.device], timeout=600.0,
        )
    ranks = [
        json.loads(line[len(_TAG):])
        for out in outputs for line in out.splitlines() if line.startswith(_TAG)
    ]
    ranks.sort(key=lambda r: r["rank"])
    nbytes = int(args.gb * 1024**3) // N_TENSORS // 2 * 2 * N_TENSORS
    save_s, take_s = ranks[0]["torch_save_s"], max(r["take_s"] for r in ranks)
    split = ", ".join(f"r{r['rank']}={r['bytes_written'] / 1e6:.0f}MB" for r in ranks)
    print(f"torch.save from rank 0: {save_s:.2f}s ({nbytes / save_s / 1e9:.2f} GB/s)")
    print(f"Snapshot.take (replicated, world={args.world_size}): {take_s:.2f}s "
          f"({nbytes / take_s / 1e9:.2f} GB/s) per-rank bytes written: [{split}]")
    restore_equal = len(ranks) == args.world_size and all(r["restore_equal"] for r in ranks)
    return result(
        "replicated", args.device, restore_equal, bytes=nbytes, world_size=args.world_size,
        torch_save_s=save_s, take_s=take_s, restore_s=max(r["restore_s"] for r in ranks),
        bytes_written_by_rank=[r["bytes_written"] for r in ranks],
        restore_equal=restore_equal,
    )


if __name__ == "__main__":
    sys.exit(main())
