"""The readings the model step's limits are set from, at a
configuration's own size: for each seed, the gaps (``checks.gaps``)
between the plain reference and

- ``program``: the program's first steps through the window's own call
  and feed (``job.Job.first_steps``), as a run takes them;
- ``control``: the reference itself in the program's place, computed in
  fp8 (e4m3 values, e5m2 gradients), the precision below the
  configuration's bfloat16;
- ``half_batch``: the reference in the program's place over half of each
  batch's rows, the mean taken over the rest.

A state left unchanged reads 1 on ``grad_gap`` and ``update_gap`` by
their definition and needs no run.

    python3 portbench/calibrate.py --config transformer-big --seeds 1 2 3 \
        --control-seeds 1 2 3 --out calibrate.jsonl

One JSON line per (seed, side) on standard output and in ``--out``.
"""

import argparse
import json
import os
import statistics
import sys


def readings(cfg: dict, seed: int, device, program: bool = True, control: bool = False) -> dict:
    """{side: gaps} of one seed at ``cfg``'s size on ``device``."""
    from portbench import checks, registry
    from portbench.harness import TRAINING_STEPS
    from portbench.job import Job

    ref = registry.reference(cfg["reference"])
    lr, n = cfg["learning_rate"], TRAINING_STEPS
    job = Job(cfg, {"batches": n}, seed, device, ref)
    batches = job.batches.clone()
    sides = {"program": job.first_steps(n)} if program else {}
    del job
    want = ref.train(cfg, ref.init_weights(cfg, seed, device), batches, lr)
    if control:
        sides["control"] = ref.train(cfg, ref.init_weights(cfg, seed, device), batches, lr,
                                     cast=ref.fp8_cast)
        sides["half_batch"] = ref.train(cfg, ref.init_weights(cfg, seed, device), batches, lr,
                                        rows=slice(0, cfg["batch"] // 2))
    floor = checks.MOVED_SHARE * statistics.median(want["grad_norms"].values())
    left_out = sorted(k for k, v in want["grad_norms"].items() if v < floor)
    return {side: {**checks.gaps(got, want), "losses": got["losses"], "ref_losses": want["losses"],
                   "left_out": left_out}
            for side, got in sides.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from portbench import registry

    cfg = registry.config(args.config)
    device = torch.device(args.device)
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        sides = readings(cfg, seed, device, seed in args.seeds, seed in args.control_seeds)
        for side, found in sides.items():
            line = json.dumps({"config": args.config, "seed": seed, "side": side, **found})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
