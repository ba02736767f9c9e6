"""Head to head against PyTorch's incumbents: ``torch.save`` and
``torch.distributed.checkpoint`` (DCP) against tpusnap, saving and
restoring the flagship transformer's train state.

Counterpart of benchmarks/orbax_compare/main.py (the JAX ecosystem's
incumbent is orbax; PyTorch's are these). The same train state (vocab
32768, ``--d-model``, ``--n-heads``, ``--n-layers``, d_ff 4 x d_model,
Adam moments; the JAX harness's config by default) goes through:

- ``torch.save`` / ``torch.load`` (then copied into the model's tensors);
- DCP ``save`` / ``load`` (in place), one process, no process group;
- DCP ``async_save``: blocked seconds (until it returns) and total
  seconds (until its future resolves);
- tpusnap ``Snapshot.take`` / ``restore`` (in place);
- tpusnap ``Snapshot.async_take``: blocked and total seconds.

Protocol (the JAX harness's): every sample is one of ``--runs``
INTERLEAVED sessions, the frameworks alternating within one disk window
per run, and the headline is each cell's median (best of N beside it).
Every restore (each method's snapshot loaded into a zeroed copy of the
state) must equal the state bit for bit. The medians go into the
cross-run history as a ``kind="dcp"`` event.

    python -m tpusnap_torch.benchmarks.dcp_compare [--d-model 1024]
        [--n-heads 16] [--n-layers 8] [--runs 5] [--device cuda|cpu]
"""

import argparse
import os
import shutil
import sys
import tempfile
import time
import warnings
from statistics import median
from typing import List, Optional

import torch

from tpusnap_torch import PytreeState, Snapshot
from tpusnap_torch._device import add_device_argument, device_missing
from tpusnap_torch.benchmarks import result, synchronize
from tpusnap_torch.models import Transformer, TransformerConfig

CELLS = (
    "torch_save", "torch_load",
    "dcp_save", "dcp_load", "dcp_async_blocked", "dcp_async_total",
    "ts_save", "ts_load", "ts_async_blocked", "ts_async_total",
)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tpusnap_torch.benchmarks.dcp_compare")
    parser.add_argument("--d-model", type=int, default=1024)
    parser.add_argument("--n-heads", type=int, default=16)
    parser.add_argument("--n-layers", type=int, default=8)
    parser.add_argument("--runs", type=int, default=5,
                        help="interleaved sessions per cell (the median is the headline)")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    if device_missing(parser.prog, args.device):
        return 2
    import torch.distributed.checkpoint as dcp

    dev = args.device
    cfg = TransformerConfig(vocab_size=32768, d_model=args.d_model,
                            n_heads=args.n_heads, n_layers=args.n_layers, d_ff=4 * args.d_model)
    model = Transformer(cfg, device=dev, seed=0)
    state = model.train_state()
    want = dict(_leaves(state))
    nbytes = sum(t.numel() * t.element_size() for t in want.values())
    print(f"train state: {nbytes / 1e9:.2f} GB in {len(want)} tensors on {dev}")
    target = _zeros_like(state)
    got = dict(_leaves(target))

    def zero_target():
        for t in got.values():
            t.zero_()
        synchronize(dev)

    def equal() -> bool:
        return all(torch.equal(got[p], w) for p, w in want.items())

    def timed(fn):
        synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        synchronize(dev)
        return time.perf_counter() - t0, out

    res = {k: [] for k in CELLS}
    checks = {k: True for k in ("torch", "dcp", "dcp_async", "tpusnap", "tpusnap_async")}
    work = tempfile.mkdtemp(prefix="tpusnap_torch_bench_dcp_")
    # DCP warns that it saves and loads in one process with no process
    # group: that is this harness's setup.
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        try:
            for run in range(args.runs):
                rdir = os.path.join(work, f"run{run}")
                os.makedirs(rdir)
                # torch.save / torch.load (+ the copy into the model's tensors)
                path = os.path.join(rdir, "torch.pt")
                s, _ = timed(lambda: torch.save(state, path))
                res["torch_save"].append(s)
                zero_target()

                def torch_load():
                    loaded = dict(_leaves(torch.load(path, map_location=dev, weights_only=True)))
                    for p, t in got.items():
                        t.copy_(loaded[p])
                s, _ = timed(torch_load)
                res["torch_load"].append(s)
                checks["torch"] &= equal()

                # DCP save / load
                ddir = os.path.join(rdir, "dcp")
                s, _ = timed(lambda: dcp.save(state, checkpoint_id=ddir))
                res["dcp_save"].append(s)
                zero_target()
                s, _ = timed(lambda: dcp.load(target, checkpoint_id=ddir))
                res["dcp_load"].append(s)
                checks["dcp"] &= equal()

                # DCP async_save
                adir = os.path.join(rdir, "dcp_async")
                synchronize(dev)
                t0 = time.perf_counter()
                fut = dcp.async_save(state, checkpoint_id=adir)
                res["dcp_async_blocked"].append(time.perf_counter() - t0)
                fut.result()
                res["dcp_async_total"].append(time.perf_counter() - t0)
                zero_target()
                dcp.load(target, checkpoint_id=adir)
                checks["dcp_async"] &= equal()

                # tpusnap take / restore
                tdir = os.path.join(rdir, "tpusnap")
                s, _ = timed(lambda: Snapshot.take(tdir, {"ts": PytreeState(state)}))
                res["ts_save"].append(s)
                zero_target()
                s, _ = timed(lambda: Snapshot(tdir).restore({"ts": PytreeState(target)}))
                res["ts_load"].append(s)
                checks["tpusnap"] &= equal()

                # tpusnap async_take
                tadir = os.path.join(rdir, "tpusnap_async")
                synchronize(dev)
                t0 = time.perf_counter()
                pending = Snapshot.async_take(tadir, {"ts": PytreeState(state)})
                res["ts_async_blocked"].append(time.perf_counter() - t0)
                pending.wait()
                res["ts_async_total"].append(time.perf_counter() - t0)
                zero_target()
                Snapshot(tadir).restore({"ts": PytreeState(target)})
                checks["tpusnap_async"] &= equal()
                shutil.rmtree(rdir)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    med = {k: median(v) for k, v in res.items()}
    best = {k: min(v) for k, v in res.items()}
    print(f"samples per cell: {args.runs} interleaved session(s); MEDIAN shown (best in parentheses)")
    for k in CELLS:
        print(f"{k:20s} {med[k]:7.3f}s  {nbytes / med[k] / 1e9:6.2f} GB/s  (best {best[k]:.3f}s)")
    speedups = {
        "torch_save": med["torch_save"] / med["ts_save"],
        "torch_load": med["torch_load"] / med["ts_load"],
        "dcp_save": med["dcp_save"] / med["ts_save"],
        "dcp_load": med["dcp_load"] / med["ts_load"],
        "dcp_async_blocked": med["dcp_async_blocked"] / med["ts_async_blocked"],
        "dcp_async_total": med["dcp_async_total"] / med["ts_async_total"],
    }
    print("tpusnap's speedup (incumbent median / tpusnap median): "
          + ", ".join(f"{k} {v:.2f}x" for k, v in speedups.items()))
    from tpusnap_torch import history

    history.record_event({
        "v": 1, "ts": round(time.time(), 3), "kind": "dcp", "bench": "dcp_compare",
        "rank": 0, "world_size": 1, "bytes": nbytes, "sessions": args.runs,
        "wall_s": round(med["ts_save"], 3),
        "throughput_gbps": round(nbytes / med["ts_save"] / 1e9, 3),
        **{f"{k}_median_s": round(v, 3) for k, v in med.items()},
        **{f"speedup_{k}": round(v, 3) for k, v in speedups.items()},
    })
    return result(
        "dcp_compare", dev, all(checks.values()), bytes=nbytes, tensors=len(want),
        config={"vocab_size": cfg.vocab_size, "d_model": args.d_model,
                "n_heads": args.n_heads, "n_layers": args.n_layers, "d_ff": 4 * args.d_model},
        runs=args.runs, median_s=med, best_s=best, samples_s=res, speedups=speedups,
        restore_equal=checks,
    )


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree.detach())


if __name__ == "__main__":
    sys.exit(main())
