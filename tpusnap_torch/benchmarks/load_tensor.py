"""Memory-budgeted random access: read one big tensor back under a
100 MiB host budget.

Counterpart of benchmarks/load_tensor/main.py (the reference's 10 GB
tensor under a 100 MB budget): ``read_object`` splits the read into
byte-ranged tiles, so the host memory it holds stays near the budget
instead of the tensor's size, as the RSS profiler shows. The tensor lives
on the device and is read back into a preallocated target there, so the
host holds only the tiles in flight: the peak RSS delta must stay under
8x the budget (tests/test_tiled_read.py's slack over the destination).

    python -m tpusnap_torch.benchmarks.load_tensor [--gb 1.0] [--device cuda|cpu]
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

BUDGET = 100 * 2**20
RSS_SLACK = 8  # peak RSS delta < RSS_SLACK x BUDGET


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tpusnap_torch.benchmarks.load_tensor")
    parser.add_argument("--gb", type=float, default=1.0)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    if device_missing(parser.prog, args.device):
        return 2

    n_rows = int(args.gb * 1024**3) // (4 * 1024)  # 1024 f32 columns per row
    gen = torch.Generator(device=args.device).manual_seed(0)
    big = torch.randn((n_rows, 1024), generator=gen, device=args.device)
    nbytes = big.numel() * 4
    target = torch.empty_like(big)
    out = {"bytes": nbytes, "budget_bytes": BUDGET}
    with tempfile.TemporaryDirectory(prefix="tpusnap_torch_bench_load_") as work_dir:
        path = os.path.join(work_dir, "snap")
        Snapshot.take(path, {"m": PytreeState({"big": big})})
        snapshot = Snapshot(path)
        # Budgeted pass first: it must see a clean RSS baseline.
        for label, budget in (("budgeted", BUDGET), ("unbudgeted", None)):
            target.zero_()
            synchronize(args.device)
            deltas: List[int] = []
            t0 = time.perf_counter()
            with measure_rss_deltas(deltas):
                got = snapshot.read_object("0/m/big", obj_out=target,
                                           memory_budget_bytes=budget)
                synchronize(args.device)
            seconds = time.perf_counter() - t0
            peak = max(deltas, default=0)
            out[label] = {"seconds": seconds, "gb_s": nbytes / seconds / 1e9,
                          "peak_rss_delta_bytes": peak,
                          "in_place": got is target, "values_equal": bool(torch.equal(got, big))}
            print(f"read_object {label}: {seconds:.2f}s ({nbytes / seconds / 1e9:.2f} GB/s), "
                  f"peak RSS delta {peak / 1e6:.0f} MB")
    out["rss_limit_bytes"] = RSS_SLACK * BUDGET
    out["rss_within_budget"] = out["budgeted"]["peak_rss_delta_bytes"] < RSS_SLACK * BUDGET
    ok = out["rss_within_budget"] and all(
        out[k]["values_equal"] and out[k]["in_place"] for k in ("budgeted", "unbudgeted")
    )
    return result("load_tensor", args.device, ok, **out)


if __name__ == "__main__":
    sys.exit(main())
