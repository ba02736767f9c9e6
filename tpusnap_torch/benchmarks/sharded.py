"""Sharded (FSDP) state: take and restore a ``Shard(0)`` DTensor train
state.

Counterpart of benchmarks/sharded/main.py (the reference's FSDP
benchmark). Each rank holds the flagship transformer's train state
(vocab 32768, ``--d-model`` with 16 heads, ``--n-layers``, d_ff 4 x
d_model: the JAX harness's config) as ``Shard(0)`` DTensors over a 1-D
mesh of the ranks, whose local tensors are this rank's boxes: each rank
writes only its own boxes, and the restore puts every box back in place
into a zeroed target of the same layout, where it must equal the state
bit for bit. The 0-d Adam step stays a dense tensor. The ranks are one
gloo world; with ``--device cuda`` they share the one card.

    python -m tpusnap_torch.benchmarks.sharded [--d-model 1024]
        [--n-layers 8] [--runs 3] [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Optional

from tpusnap_torch._device import add_device_argument, device_missing

_TAG = "sharded_rank "
WORLD_SIZE = 2


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _sharded(tree, mesh):
    """``tree`` with every leaf of one or more dims as a ``Shard(0)``
    DTensor over a view of this rank's box; 0-d leaves stay dense."""
    from torch.distributed.tensor import Shard

    from tpusnap_torch.test_utils import as_dtensor

    if isinstance(tree, dict):
        return {k: _sharded(v, mesh) for k, v in tree.items()}
    return tree if tree.dim() == 0 else as_dtensor(tree.detach(), mesh, [Shard(0)])


def worker(work_dir: str, d_model: str, n_layers: str, runs: str, device: str) -> None:
    import torch
    import torch.distributed as dist

    from tpusnap_torch import PytreeState, Snapshot, is_sharded
    from tpusnap_torch.benchmarks import synchronize
    from tpusnap_torch.models import Transformer, TransformerConfig
    from tpusnap_torch.test_utils import world_mesh

    rank = dist.get_rank()
    if device == "cuda":
        torch.cuda.set_device(0)  # the ranks share the one card
    mesh = world_mesh(device)
    d = int(d_model)
    cfg = TransformerConfig(vocab_size=32768, d_model=d, n_heads=16,
                            n_layers=int(n_layers), d_ff=4 * d)
    model = Transformer(cfg, device=device, seed=0)
    state = _sharded(model.train_state(), mesh)
    fresh = Transformer(cfg, device=device, seed=1)
    for _, t in _leaves(fresh.train_state()):
        t.detach().zero_()
    target = _sharded(fresh.train_state(), mesh)
    local = lambda t: t.to_local() if is_sharded(t) else t  # noqa: E731
    nbytes = sum(local(t).numel() * local(t).element_size() for _, t in _leaves(state))
    out = {"rank": rank, "local_bytes": nbytes, "take_runs": [], "restore_runs": []}
    for run in range(int(runs)):
        path = os.path.join(work_dir, f"snap{run}")
        synchronize(device)
        t0 = time.perf_counter()
        Snapshot.take(path, {"ts": PytreeState(state)})
        out["take_runs"].append(time.perf_counter() - t0)
        for _, t in _leaves(target):
            local(t).zero_()
        synchronize(device)
        t0 = time.perf_counter()
        Snapshot(path).restore({"ts": PytreeState(target)})
        synchronize(device)
        out["restore_runs"].append(time.perf_counter() - t0)
    want = dict(_leaves(state))
    out["restore_equal"] = all(
        torch.equal(local(t), local(want[p])) for p, t in _leaves(target)
    )
    out["dtensors"] = sum(1 for _, t in _leaves(state) if is_sharded(t))
    print(_TAG + json.dumps(out), flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tpusnap_torch.benchmarks.sharded")
    parser.add_argument("--d-model", type=int, default=1024)
    parser.add_argument("--n-layers", type=int, default=8)
    parser.add_argument("--runs", type=int, default=3)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    if device_missing(parser.prog, args.device):
        return 2

    from tpusnap_torch.benchmarks import result
    from tpusnap_torch.test_utils import run_subprocess_world

    with tempfile.TemporaryDirectory(prefix="tpusnap_torch_bench_shard_") as work_dir:
        outputs = run_subprocess_world(
            worker, world_size=WORLD_SIZE, timeout=600.0,
            args=[work_dir, str(args.d_model), str(args.n_layers), str(args.runs), args.device],
        )
    ranks = sorted(
        (json.loads(line[len(_TAG):]) for out in outputs for line in out.splitlines()
         if line.startswith(_TAG)),
        key=lambda r: r["rank"],
    )
    nbytes = sum(r["local_bytes"] for r in ranks)
    # A run's seconds are its slowest rank's.
    take_runs = [max(r["take_runs"][i] for r in ranks) for i in range(args.runs)]
    restore_runs = [max(r["restore_runs"][i] for r in ranks) for i in range(args.runs)]
    take_s, restore_s = min(take_runs), min(restore_runs)
    print(f"train state: {nbytes / 1e9:.2f} GB as Shard(0) over {WORLD_SIZE} ranks")
    print(f"take:    {take_s:.2f}s ({nbytes / take_s / 1e9:.2f} GB/s)")
    print(f"restore: {restore_s:.2f}s ({nbytes / restore_s / 1e9:.2f} GB/s)")
    restore_equal = len(ranks) == WORLD_SIZE and all(r["restore_equal"] for r in ranks)
    return result(
        "sharded", args.device, restore_equal, bytes=nbytes, world_size=WORLD_SIZE,
        d_model=args.d_model, n_layers=args.n_layers,
        dtensors=ranks[0]["dtensors"], take_s=take_s, restore_s=restore_s,
        take_runs=take_runs, restore_runs=restore_runs, restore_equal=restore_equal,
    )


if __name__ == "__main__":
    sys.exit(main())
