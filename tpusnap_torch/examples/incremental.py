"""Incremental checkpointing and the integrity workflow.

Counterpart of examples/incremental_example.py. The shape this exists
for: a model with a large frozen component (a pretrained tower or an
embedding table) and a small trained head. A plain take rewrites the
frozen bytes every time; an incremental take hashes them and writes only
the changed head.

The loop takes a full snapshot once, then an incremental snapshot on the
previous one each epoch, verifies the latest with the integrity scrub,
and finally applies a retention policy, which materializes the survivor
(copies the blobs it references in) before deleting the older snapshots.

    python -m tpusnap_torch.examples.incremental [--work-dir DIR]
        [--device cuda|cpu]
"""

import argparse
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch

from tpusnap_torch import PytreeState, Snapshot, StateDict, apply_retention
from tpusnap_torch._device import add_device_argument, device_missing

NUM_EPOCHS = 3


def _du(path: str) -> int:
    return sum(
        os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs
    )


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tpusnap_torch.examples.incremental")
    parser.add_argument("--work-dir", default=None)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    if device_missing(parser.prog, args.device):
        return 2
    work_dir = args.work_dir or tempfile.mkdtemp(prefix="tpusnap_torch_inc_example_")

    # Large frozen component + small trained head.
    frozen_tower = torch.from_numpy(
        np.random.default_rng(0).standard_normal((4096, 512)).astype(np.float32)
    ).to(args.device)
    head = torch.zeros((512, 8), dtype=torch.float32, device=args.device)

    def snap_path(epoch: int) -> str:
        return os.path.join(work_dir, f"step_{epoch}")

    prev = None
    for epoch in range(NUM_EPOCHS):
        head = head + 0.01 * (epoch + 1)  # "training" updates the head only
        app_state = {
            "model": PytreeState({"frozen": frozen_tower, "head": head}),
            "progress": StateDict(epoch=epoch),
        }
        path = snap_path(epoch)
        Snapshot.take(path, app_state, incremental_from=prev)
        kind = "full" if prev is None else f"incremental on {prev}"
        print(f"epoch {epoch}: snapshot {path} ({kind}, {_du(path) / 1e6:.1f} MB)")
        if prev is not None and not _du(path) < _du(snap_path(0)) / 10:
            # An increment holds only the changed head, a small fraction
            # of the full size.
            raise AssertionError(f"increment not deduped: {_du(path)} vs {_du(snap_path(0))}")
        prev = path

    # Verify the latest snapshot end to end (every byte, the blobs it
    # references inside step_0 included).
    latest = snap_path(NUM_EPOCHS - 1)
    report = Snapshot(latest).verify()
    print(f"verify {latest}: {report.summary()}")
    if not report.clean:
        raise AssertionError(report.summary())

    # Retention: keep only the newest snapshot, materialized first.
    plan = apply_retention(work_dir, keep_last=1)
    print(f"retention: {plan.summary()}")
    if plan.bytes_copied < frozen_tower.numel() * 4:
        raise AssertionError(f"materialize copied {plan.bytes_copied} bytes")
    if os.listdir(work_dir) != [os.path.basename(latest)]:
        raise AssertionError(f"retention left {os.listdir(work_dir)}")

    # The survivor still restores bit-exactly, in place.
    target = {
        "model": PytreeState(
            {"frozen": torch.zeros_like(frozen_tower), "head": torch.zeros_like(head)}
        ),
        "progress": StateDict(epoch=-1),
    }
    Snapshot(latest).restore(target)
    restored = target["model"].tree
    if target["progress"]["epoch"] != NUM_EPOCHS - 1:
        raise AssertionError(f"progress restored as {target['progress']}")
    if not (torch.equal(restored["frozen"], frozen_tower) and torch.equal(restored["head"], head)):
        raise AssertionError("the survivor's restore differs from the state taken")
    if restored["frozen"].device != frozen_tower.device:
        raise AssertionError(f"restored onto {restored['frozen'].device}")
    if not Snapshot(latest).verify().clean:
        raise AssertionError("the survivor does not scrub clean")
    print("restore after retention: bit-exact; survivor scrubs clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
