"""Canonical usage: an epoch loop with resumable app state.

Counterpart of examples/simple_example.py: train a tiny model, take a
snapshot every epoch, resume from any of them.

    python -m tpusnap_torch.examples.simple [--work-dir DIR]
        [--resume-from DIR/epoch_N] [--device cuda|cpu]
"""

import argparse
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from tpusnap_torch import PytreeState, RNGState, Snapshot, StateDict
from tpusnap_torch._device import add_device_argument, device_missing

NUM_EPOCHS = 4


class TinyModel(nn.Module):
    def __init__(self, device: str) -> None:
        super().__init__()
        gen = torch.Generator(device="cpu").manual_seed(0)
        self.w = nn.Parameter((torch.randn(32, 16, generator=gen) * 0.1).to(device))
        self.b = nn.Parameter(torch.zeros(16, device=device))
        self.out = nn.Parameter((torch.randn(16, 1, generator=gen) * 0.1).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x @ self.w + self.b) @ self.out


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tpusnap_torch.examples.simple")
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--resume-from", default=None)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    if device_missing(parser.prog, args.device):
        return 2
    work_dir = args.work_dir or tempfile.mkdtemp(prefix="tpusnap_torch_example_")

    model = TinyModel(args.device)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-2)
    # The parameters as a pytree (the state_dict's tensors share the
    # parameters' storage, so a restore lands in the model), the Adam
    # state as the optimizer itself (a Stateful: its moments appear after
    # the first step), the loop's progress and the RNG streams.
    train = PytreeState(model.state_dict())
    progress = StateDict(epoch=0)
    app_state = {"train": train, "optim": optimizer, "progress": progress, "rng": RNGState()}

    if args.resume_from:
        Snapshot(args.resume_from).restore(app_state)
        model.load_state_dict(train.tree)
        print(f"resumed from {args.resume_from} at epoch {progress['epoch']}")

    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((64, 32)).astype(np.float32)
    ).to(args.device)
    y = torch.from_numpy(
        np.random.default_rng(1).standard_normal((64, 1)).astype(np.float32)
    ).to(args.device)

    while progress["epoch"] < NUM_EPOCHS:
        optimizer.zero_grad()
        torch.mean((model(x) - y) ** 2).backward()
        optimizer.step()
        progress["epoch"] += 1

        snap_path = f"{work_dir}/epoch_{progress['epoch']}"
        Snapshot.take(snap_path, app_state)
        with torch.no_grad():
            loss = torch.mean((model(x) - y) ** 2).item()
        print(f"epoch {progress['epoch']}: loss={loss:.5f} snapshot={snap_path}")

    print(f"done. latest snapshot: {work_dir}/epoch_{NUM_EPOCHS}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
