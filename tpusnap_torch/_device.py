"""The ``--device`` option of the port's examples and benchmark harnesses:
``cuda`` unless the caller asks for the CPU, never a silent fallback."""

import argparse
import sys

import torch


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the state lives and the model runs (default: cuda)",
    )


def device_missing(prog: str, device: str) -> bool:
    """True, after one line on stderr, when ``device`` is ``cuda`` and no
    CUDA device is available."""
    if device == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: no CUDA device is available; pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return True
    return False
