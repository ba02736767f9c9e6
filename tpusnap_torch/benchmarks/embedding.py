"""Embedding tables through sync and async takes, with RSS tracking.

Counterpart of benchmarks/embedding/main.py (the reference's torchrec
benchmark: row-wise tables, the sync/async blocked-time split, RSS
deltas). ``EmbeddingCollection`` with row-wise Adagrad state; the last
half of the tables live in pinned host memory (the UVM analog; staged
with no device-to-host copy), as in the smoke's embedding phase. One process: the JAX harness's row-wise
sharding over a mesh is the port's smoke ``layouts`` phase. The async
take reports the blocked time (until ``async_take`` returns) beside the
total; the restore is in place and must equal the state.

    python -m tpusnap_torch.benchmarks.embedding [--rows 1000000] [--dim 64]
        [--tables 4] [--device cuda|cpu]
"""

import argparse
import os
import sys
import tempfile
import time
from typing import List, Optional

import torch

from tpusnap_torch import PytreeState, Snapshot, measure_rss_deltas
from tpusnap_torch._device import add_device_argument, device_missing
from tpusnap_torch.benchmarks import result, synchronize
from tpusnap_torch.models import EmbeddingCollection, TableConfig


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tpusnap_torch.benchmarks.embedding")
    parser.add_argument("--rows", type=int, default=1_000_000)
    parser.add_argument("--dim", type=int, default=64)
    parser.add_argument("--tables", type=int, default=4)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    if device_missing(parser.prog, args.device):
        return 2

    model = EmbeddingCollection(
        [TableConfig(f"table_{i}", args.rows, args.dim, sharding="row",
                     host_offload=i >= args.tables // 2)
         for i in range(args.tables)],
        device=args.device,
    )
    params = model.params()
    nbytes = sum(t.numel() * t.element_size() for _, t in _leaves(params))
    print(f"{args.tables} tables x [{args.rows}, {args.dim}] (+ row-wise Adagrad state), "
          f"{args.tables - args.tables // 2} pinned: {nbytes / 1e9:.2f} GB")
    out = {"bytes": nbytes, "tables": args.tables, "rows": args.rows, "dim": args.dim,
           "pinned_tables": args.tables - args.tables // 2}
    with tempfile.TemporaryDirectory(prefix="tpusnap_torch_bench_emb_") as work:
        # Warm-up: the first take sets up the staging buffers.
        Snapshot.take(os.path.join(work, "warmup"), {"emb": PytreeState(params)})
        rss: List[int] = []
        synchronize(args.device)
        with measure_rss_deltas(rss):
            t0 = time.perf_counter()
            Snapshot.take(os.path.join(work, "sync"), {"emb": PytreeState(params)})
            out["sync_s"] = time.perf_counter() - t0
        out["sync_peak_rss_delta_bytes"] = max(rss, default=0)
        print(f"sync take:  {out['sync_s']:.2f}s ({nbytes / out['sync_s'] / 1e9:.2f} GB/s), "
              f"peak RSS delta {out['sync_peak_rss_delta_bytes'] / 1e6:.0f} MB")

        synchronize(args.device)
        t0 = time.perf_counter()
        pending = Snapshot.async_take(os.path.join(work, "async"), {"emb": PytreeState(params)})
        out["async_blocked_s"] = time.perf_counter() - t0
        pending.wait()
        out["async_total_s"] = time.perf_counter() - t0
        print(f"async take: blocked {out['async_blocked_s']:.2f}s / total "
              f"{out['async_total_s']:.2f}s")

        want = {p: t.clone() for p, t in _leaves(params)}
        for _, t in _leaves(params):
            t.zero_()
        before = {p: (id(t), t.is_pinned()) for p, t in _leaves(params)}
        state = PytreeState(params)
        synchronize(args.device)
        t0 = time.perf_counter()
        Snapshot(os.path.join(work, "async")).restore({"emb": state})
        synchronize(args.device)
        out["restore_s"] = time.perf_counter() - t0
        print(f"restore:    {out['restore_s']:.2f}s ({nbytes / out['restore_s'] / 1e9:.2f} GB/s)")
    got = dict(_leaves(state.tree))
    out["restore_equal"] = all(torch.equal(got[p], w) for p, w in want.items())
    out["restore_in_place"] = {p: (id(t), t.is_pinned()) for p, t in got.items()} == before
    ok = out["restore_equal"] and out["restore_in_place"]
    return result("embedding", args.device, ok, **out)


if __name__ == "__main__":
    sys.exit(main())
