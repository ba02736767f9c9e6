"""Incremental takes and the integrity scrub.

Counterpart of benchmarks/incremental/main.py. The common training shape:
a large mostly-frozen component (embeddings, a frozen tower) and a small
hot component that changes every step. Reports, best of ``--runs``:

- a full take of the whole state;
- an incremental take after the hot component changed (only it is
  rewritten);
- bytes on disk for the increment against the full snapshot;
- the scrub (``verify_snapshot``) of the full snapshot;
- a chain-depth sweep: manifest size, take time and tip restore time at
  depths 1, 10, 25, 50 and ``--chain-depth`` (each restore checked).

    python -m tpusnap_torch.benchmarks.incremental [--gb 2.0]
        [--hot-mb 64] [--runs 3] [--chain-depth 100] [--device cuda|cpu]
"""

import argparse
import os
import shutil
import sys
import tempfile
import time
from typing import List, Optional

import torch

from tpusnap_torch import Snapshot, StateDict, verify_snapshot
from tpusnap_torch._device import add_device_argument, device_missing
from tpusnap_torch.benchmarks import result, synchronize
from tpusnap_torch.knobs import override_record_dedup_hashes


def du(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tpusnap_torch.benchmarks.incremental")
    parser.add_argument("--gb", type=float, default=2.0)
    parser.add_argument("--hot-mb", type=float, default=64.0)
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--chain-depth", type=int, default=100,
                        help="depth of the incremental-chain sweep (0 disables)")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    if device_missing(parser.prog, args.device):
        return 2

    dev = args.device
    gen = torch.Generator(device=dev).manual_seed(0)
    frozen = torch.randint(-(2**15), 2**15, (int(args.gb * 1024**3) // 2 // 4096, 4096),
                           generator=gen, dtype=torch.int16, device=dev)
    hot = torch.randn(int(args.hot_mb * 2**20) // 4, generator=gen, device=dev)
    total = frozen.numel() * 2 + hot.numel() * 4
    print(f"state: {total / 1e9:.2f} GB ({frozen.numel() * 2 / 1e9:.2f} frozen + "
          f"{hot.numel() * 4 / 1e6:.0f} MB hot)")

    root = tempfile.mkdtemp(prefix="tpusnap_torch_inc_bench_")
    out = {"bytes": total}
    try:
        full_times, inc_times = [], []
        for run in range(args.runs):
            base, inc = os.path.join(root, f"base{run}"), os.path.join(root, f"inc{run}")
            synchronize(dev)
            t0 = time.perf_counter()
            # A base of a planned chain records 64-bit dedup hashes, so
            # every skip of the first increment has 64-bit evidence.
            with override_record_dedup_hashes(True):
                Snapshot.take(base, {"app": StateDict(frozen=frozen, hot=hot)})
            full_times.append(time.perf_counter() - t0)
            hot2 = hot + (run + 1)
            synchronize(dev)
            t0 = time.perf_counter()
            Snapshot.take(inc, {"app": StateDict(frozen=frozen, hot=hot2)}, incremental_from=base)
            inc_times.append(time.perf_counter() - t0)
            inc_bytes, base_bytes = du(inc), du(base)
            if run + 1 < args.runs:
                shutil.rmtree(base)
                shutil.rmtree(inc)
        t_full, t_inc = min(full_times), min(inc_times)
        print(f"full take:        {t_full:.2f}s ({total / t_full / 1e9:.2f} GB/s)")
        print(f"incremental take: {t_inc:.2f}s ({t_full / t_inc:.1f}x)")
        print(f"bytes on disk:    full {base_bytes / 1e9:.2f} GB, increment "
              f"{inc_bytes / 1e6:.1f} MB")
        out.update(full_take_s=t_full, inc_take_s=t_inc, full_runs=full_times,
                   inc_runs=inc_times, full_bytes_on_disk=base_bytes,
                   inc_bytes_on_disk=inc_bytes,
                   # the increment rewrites the hot tensor and nothing
                   # of the frozen one (1 MiB covers metadata and sidecars)
                   increment_deduped=inc_bytes <= hot.numel() * 4 + (1 << 20))

        scrub_times, clean = [], True
        for _ in range(args.runs):
            t0 = time.perf_counter()
            report = verify_snapshot(base)
            scrub_times.append(time.perf_counter() - t0)
            clean = clean and report.clean
        print(f"scrub (verify):   {min(scrub_times):.2f}s "
              f"({total / min(scrub_times) / 1e9:.2f} GB/s)")
        out.update(scrub_s=min(scrub_times), scrub_runs=scrub_times, scrub_clean=clean)

        # Chain-depth sweep: chains collapse to the oldest base, so the
        # manifest size, take time and tip restore must stay flat.
        rows, restores_equal = [], True
        if args.chain_depth:
            chain_root = os.path.join(root, "chain")
            hot_c = hot.clone()
            prev = os.path.join(chain_root, "d0000")
            with override_record_dedup_hashes(True):
                Snapshot.take(prev, {"app": StateDict(frozen=frozen, hot=hot_c)})
            checkpoints = {1, 10, 25, 50, args.chain_depth}
            window = []
            for d in range(1, args.chain_depth + 1):
                hot_c = hot_c + 1
                path = os.path.join(chain_root, f"d{d:04d}")
                synchronize(dev)
                t0 = time.perf_counter()
                Snapshot.take(path, {"app": StateDict(frozen=frozen, hot=hot_c)},
                              incremental_from=prev)
                window.append(time.perf_counter() - t0)
                prev = path
                if d in checkpoints:
                    meta = os.path.getsize(os.path.join(path, ".snapshot_metadata"))
                    target = {"app": StateDict(frozen=torch.empty_like(frozen),
                                               hot=torch.empty_like(hot_c))}
                    synchronize(dev)
                    t0 = time.perf_counter()
                    Snapshot(path).restore(target)
                    synchronize(dev)
                    t_restore = time.perf_counter() - t0
                    # Both leaves: "frozen" resolves through the collapsed chain.
                    restores_equal = restores_equal and bool(
                        torch.equal(target["app"]["hot"], hot_c)
                        and torch.equal(target["app"]["frozen"], frozen)
                    )
                    rows.append({"depth": d, "manifest_bytes": meta,
                                 "take_s": min(window[-10:]), "restore_s": t_restore})
            print("chain depth sweep (take = min of last 10):")
            for r in rows:
                print(f"  depth {r['depth']:4d}: manifest {r['manifest_bytes'] / 1e3:6.1f} KB, "
                      f"take {r['take_s']:5.2f}s, tip restore {r['restore_s']:5.2f}s")
        out.update(chain=rows, chain_restores_equal=restores_equal)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ok = out["increment_deduped"] and out["scrub_clean"] and restores_equal
    return result("incremental", dev, ok, **out)


if __name__ == "__main__":
    sys.exit(main())
