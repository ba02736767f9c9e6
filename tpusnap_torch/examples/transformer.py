"""Flagship workload: the MoE transformer trained with an async snapshot
every epoch and resumable state.

Counterpart of examples/transformer_example.py. Brings the package
together on one model:

- the flagship ``Transformer`` with 4 experts, trained with Adam
  (``make_train_step``); on the card its attention forward runs the
  Hopper flash kernel (``ops/flash_attention.py``);
- ``Snapshot.async_take`` once per epoch, so training resumes while the
  storage I/O drains (the next epoch updates the parameters in place);
- ``--resume-from``: ``Snapshot.async_restore``, whose reads overlap the
  setup (on the card, building or loading the kernel library).

Widths: ``tiny`` (the JAX example's config: vocab 512, d_model 128, 8
heads, 2 layers, d_ff 256, tokens (4, 32)) and ``full``
(``TransformerConfig()``'s flagship width: vocab 32768, d_model 512, 8
heads of 64, 4 layers, d_ff 2048, tokens (8, 1024)); both with 4 experts
and tokens drawn from ``np.random.default_rng(0)``. It runs on one
process, dense: the JAX example's ring attention over ``"fsdp"`` needs a
mesh, and the port runs its ring across ranks elsewhere.

    python -m tpusnap_torch.examples.transformer [--width tiny|full]
        [--work-dir DIR] [--resume-from DIR/epoch_N] [--device cuda|cpu]
        [--compute-dtype bfloat16|float32]
"""

import argparse
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from tpusnap_torch import PytreeState, Snapshot, StateDict
from tpusnap_torch._device import add_device_argument, device_missing
from tpusnap_torch.models import Transformer, TransformerConfig, make_train_step

NUM_EPOCHS = 3
STEPS_PER_EPOCH = 4
LEARNING_RATE = 1e-2
# (config fields, token batch shape)
WIDTHS = {
    "tiny": (dict(vocab_size=512, d_model=128, n_heads=8, n_layers=2, d_ff=256), (4, 32)),
    "full": (dict(), (8, 1024)),
}


def build(width: str, device: str, compute_dtype: str = "bfloat16"):
    """The example's model (seed 0) and its token batch shape."""
    fields, tokens_shape = WIDTHS[width]
    cfg = TransformerConfig(**fields, n_experts=4, dtype=getattr(torch, compute_dtype))
    return Transformer(cfg, device=device, seed=0), tokens_shape


def app_state_of(model: Transformer) -> dict:
    return {"train": PytreeState(model.train_state()), "progress": StateDict(epoch=0)}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tpusnap_torch.examples.transformer")
    parser.add_argument("--width", choices=sorted(WIDTHS), default="tiny")
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--resume-from", default=None)
    parser.add_argument("--compute-dtype", choices=("bfloat16", "float32"), default="bfloat16")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    if device_missing(parser.prog, args.device):
        return 2
    work_dir = args.work_dir or tempfile.mkdtemp(prefix="tpusnap_torch_xf_")

    model, tokens_shape = build(args.width, args.device, args.compute_dtype)
    train_step = make_train_step(model, learning_rate=LEARNING_RATE)
    app_state = app_state_of(model)
    progress = app_state["progress"]
    if args.resume_from:
        # Background restore, in place into the model's tensors: app_state
        # must not be touched until wait().
        t0 = time.perf_counter()
        pending_restore = Snapshot(args.resume_from).async_restore(app_state)
    else:
        pending_restore = None

    if args.device == "cuda":
        from tpusnap_torch.ops import flash_attention

        flash_attention.build_library()  # overlaps the restore's reads
    rng = np.random.default_rng(0)
    if pending_restore is not None:
        pending_restore.wait()
        print(f"resumed at epoch {progress['epoch']} "
              f"(restore {time.perf_counter() - t0:.3f} s)")
    pending = None
    step = 0
    while progress["epoch"] < NUM_EPOCHS:
        for _ in range(STEPS_PER_EPOCH):
            tokens = torch.from_numpy(rng.integers(0, model.config.vocab_size, tokens_shape))
            loss = train_step(tokens.to(args.device)).item()
            step += 1
            print(f"step {step}: loss={loss!r}")
        progress["epoch"] += 1

        if pending is not None:
            pending.wait()  # the previous epoch's I/O must finish first
        snap_path = f"{work_dir}/epoch_{progress['epoch']}"
        t0 = time.perf_counter()
        pending = Snapshot.async_take(snap_path, app_state)
        print(f"epoch {progress['epoch']}: loss={loss:.4f} async snapshot -> {snap_path} "
              f"(blocked {time.perf_counter() - t0:.3f} s)")

    if pending is None:
        print("nothing to train (resumed at final epoch)")
        return 0
    t0 = time.perf_counter()
    snapshot = pending.wait()
    print(f"done; final snapshot committed: {snapshot.path} "
          f"(wait {time.perf_counter() - t0:.3f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
