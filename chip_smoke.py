#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpusnap_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it builds what it needs on first use
(the native helper with g++, the kernel library with nvcc for sm_90a).
It prints one JSON line per phase and, last, one line
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. Without CUDA it exits 2 at once.

Phases, in order:

1. device  — the card's name and power limit (nvidia-smi).
2. build   — g++ and nvcc builds, started together; their seconds.
3. kernels — every kernel of the port against its plain PyTorch version
             on the card at the main path's shape and at ragged shapes,
             with the kernel's time, the plain version's, one PyTorch
             library call's as a yardstick, and the least time the card
             could take for the same work.
4. train   — the flagship transformer at its full default width trains
             5 Adam steps on the card; the attention forward must run
             the flash kernel n_layers x steps times.
5. snapshot — Snapshot.take of the train state, restore into a fresh
             model (bit-exact, Parameter identity kept), read_object, and
             one more step from both giving bitwise-equal losses.
6. bulk    — take and restore of 4 GiB of CUDA tensors (32 x 128 MiB).

Launch counts are set to 0 just before the train phase and read after
the snapshot phase: the kernels phase's comparison launches do not count.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and dense
# bf16/f16 tensor-core FLOP/s; f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

# The flagship transformer's attention shape: batch 8, seq 1024, 8 heads of 64.
SLICE_SHAPE = (8, 1024, 8, 64)
TRAIN_STEPS = 5
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(shape, dtype: str, causal: bool):
    """(least ms, "bytes" or "operations") for one attention forward at
    ``shape``: the larger of the bytes (q, k, v read once, o written
    once) over HBM and the operations these inputs need (the causal
    pairs only) over the peak rate of their type."""
    b, s, h, d = shape
    itemsize = {"bfloat16": 2, "float16": 2, "float32": 4}[dtype]
    nbytes = 4 * b * s * h * d * itemsize
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs  # QK^T and PV, 2 FLOPs per multiply-add
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * flops / PEAK_FLOPS[dtype]
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_build() -> dict:
    from tpusnap_torch import _native
    from tpusnap_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        native = pool.submit(_native.available)
        kernels = pool.submit(fa.build_library)
        ptxas = kernels.result()
        if not native.result():
            raise RuntimeError("native helper failed to build (g++)")
    if _native.checksum_algorithm() != "crc32c":
        raise RuntimeError("native build missing: checksums would not be crc32c")
    info = [ln.split(":", 1)[-1].strip() for ln in ptxas.splitlines() if "registers" in ln]
    return {"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": info}


def _qkv_views(shape, dtype, gen):
    """q, k, v as the model hands them over: head-split views of one
    fused qkv projection (v is not contiguous)."""
    import torch

    b, s, h, d = shape
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(dtype)
    return tuple(t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from tpusnap_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # Each element must satisfy |out - ref| <= atol + rtol * |ref|.
    # bf16: both sides round an f32 value to bf16 (8 significant bits), and
    # f32 sums taken in another order than the reference's can move a value
    # across a rounding boundary: one bf16 ulp is at most 2**-7 * |x|, so
    # rtol 2**-6 allows two ulps; atol 1e-5 covers values near 0, where
    # the f32 order difference (~1e-6) exceeds the ulp. f32: the order
    # difference over <= 1024 keys stays near 1e-6; atol 2e-5 is the
    # repo's own f32 tolerance for this kernel.
    cases = [
        (SLICE_SHAPE, torch.bfloat16, True, 1e-5, 2**-6),
        ((1, 200, 4, 64), torch.float32, True, 2e-5, 0.0),
        ((1, 200, 4, 64), torch.float32, False, 2e-5, 0.0),
        ((2, 16, 2, 8), torch.float32, True, 2e-5, 0.0),
        ((2, 16, 2, 8), torch.float32, False, 2e-5, 0.0),
    ]
    checks = []
    with torch.no_grad():
        for shape, dtype, causal, atol, rtol in cases:
            q, k, v = _qkv_views(shape, dtype, gen)
            out = flash_attention(q, k, v, causal=causal)
            ref = flash_attention_reference(q, k, v, causal)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            allowed = atol + rtol * ref.float().abs()
            err = diff.max().item()
            worst = (diff / allowed).max().item()  # <= 1 passes
            if not worst <= 1.0:
                raise AssertionError(
                    f"flash kernel disagrees with its plain version at {shape} "
                    f"{dtype} causal={causal}: max |err| {err}, "
                    f"{worst}x the allowed atol {atol} + rtol {rtol} * |ref|"
                )
            checks.append(
                {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                 "causal": causal, "max_abs_err": err, "atol": atol,
                 "rtol": rtol, "worst_err_over_allowed": worst}
            )
        q, k, v = _qkv_views(SLICE_SHAPE, torch.bfloat16, gen)
        reps = 30
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True), reps)
        plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, True), 20)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), reps
        )
    bound_ms, bound_by = attention_bound(SLICE_SHAPE, "bfloat16", True)
    return {
        "phase": "kernels",
        "checks": checks,
        "flash_attention_fwd": {
            "shape": list(SLICE_SHAPE), "dtype": "bfloat16", "causal": True,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "torch.nn.functional.scaled_dot_product_attention",
            "bound_ms": bound_ms, "bound_by": bound_by, "timed_launches": reps,
            "max_abs_err": checks[0]["max_abs_err"],
        },
    }


def _tokens(cfg, batch: int, seed: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, cfg.max_seq_len))
    return torch.from_numpy(toks).to(torch.int64).to("cuda")


def phase_train(ctx: dict) -> dict:
    import torch

    from tpusnap_torch.models import Transformer, TransformerConfig
    from tpusnap_torch.ops import flash_attention as fa

    cfg = TransformerConfig()  # full default width: 32768 x 512, 8 heads, 4 layers
    model = Transformer(cfg, device="cuda", seed=SEED)
    tokens = _tokens(cfg, 8, SEED)
    before = fa.launches
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(model.train_step(tokens, learning_rate=1e-3).item())
        step_s.append(time.perf_counter() - t0)
    launched = fa.launches - before
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    if launched != cfg.n_layers * TRAIN_STEPS:
        raise AssertionError(
            f"flash kernel launched {launched} times, expected "
            f"{cfg.n_layers * TRAIN_STEPS}"
        )
    ctx.update(cfg=cfg, model=model)
    n_params = sum(p.numel() for p in model.parameters())
    return {
        "phase": "train", "config": {
            "vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_layers": cfg.n_layers, "d_ff": cfg.d_ff,
            "seq": cfg.max_seq_len, "batch": 8, "dtype": "bfloat16",
        },
        "params": n_params, "losses": losses, "step_s": step_s,
        "flash_launches": launched,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def phase_snapshot(ctx: dict, workdir: str) -> dict:
    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.models import Transformer
    from tpusnap_torch.ops import flash_attention as fa

    cfg, model = ctx["cfg"], ctx["model"]
    state = StateDict(**model.train_state())
    nbytes = sum(t.numel() * t.element_size() for _, t in _leaves(state))
    path = os.path.join(workdir, "train_state")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = Snapshot.take(path, {"train": state, "progress": StateDict(step=TRAIN_STEPS)})
    take_s = time.perf_counter() - t0

    fresh = Transformer(cfg, device="cuda", seed=SEED + 1)
    target = StateDict(**fresh.train_state())
    progress = StateDict(step=0)
    before_ids = {p: id(t) for p, t in _leaves(target)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot(path).restore({"train": target, "progress": progress})
    restore_s = time.perf_counter() - t0

    for (p, want), (_, got) in zip(_leaves(state), _leaves(fresh.train_state())):
        if not torch.equal(want, got):
            raise AssertionError(f"restored {p} differs from the saved tensor")
    for p, got in _leaves(target):
        if id(got) != before_ids[p]:
            raise AssertionError(f"restore replaced the tensor object at {p}")
    if {id(p) for p in fresh.parameters()} != {
        before_ids[f"params/{p}"] for p, _ in _leaves(fresh.params())
    }:
        raise AssertionError("the module's parameters are not the restored objects")
    if progress["step"] != TRAIN_STEPS:
        raise AssertionError(f"progress restored as {progress}")
    ln_f = snap.read_object("0/train/params/ln_f")
    if not torch.equal(ln_f, model.ln_f.detach().cpu()):
        raise AssertionError("read_object('0/train/params/ln_f') differs")

    # The device slab pack must give tpusnap's host layout byte for byte:
    # a take of the same state from CPU tensors records the same checksums.
    cpu_path = os.path.join(workdir, "train_state_cpu")
    cpu_state = StateDict(**_nest_cpu(model.train_state()))
    cpu_snap = Snapshot.take(cpu_path, {"train": cpu_state, "progress": StateDict(step=TRAIN_STEPS)})
    sums = lambda s: {p: getattr(e, "checksum", None) for p, e in s.metadata.manifest.items()}  # noqa: E731
    if sums(snap) != sums(cpu_snap):
        raise AssertionError("CUDA take and CPU take record different checksums")
    shutil.rmtree(cpu_path)

    tokens = _tokens(cfg, 8, SEED + 1)
    launches_before = fa.launches
    loss_a = model.train_step(tokens)
    loss_b = fresh.train_step(tokens)
    if not torch.equal(loss_a, loss_b):
        raise AssertionError(
            f"post-restore step differs: {loss_a.item()!r} vs {loss_b.item()!r}"
        )
    if fa.launches - launches_before != 2 * cfg.n_layers:
        raise AssertionError("post-restore steps did not run the flash kernel")
    shutil.rmtree(path)
    return {
        "phase": "snapshot", "bytes": nbytes, "tensors": len(list(_leaves(state))),
        "take_s": take_s, "restore_s": restore_s,
        "take_gb_s": nbytes / take_s / 1e9, "restore_gb_s": nbytes / restore_s / 1e9,
        "post_restore_loss": loss_a.item(), "bit_exact": True,
        "parameter_identity": True, "card": ctx["card"],
    }


def _nest_cpu(tree):
    if isinstance(tree, dict):
        return {k: _nest_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def phase_bulk(ctx: dict, workdir: str) -> dict:
    import torch

    from tpusnap_torch import Snapshot, StateDict

    n_tensors, tensor_bytes = 32, 128 << 20
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tensors = {}
    for i in range(n_tensors):
        dtype = torch.float32 if i % 2 == 0 else torch.bfloat16
        n = tensor_bytes // (4 if dtype == torch.float32 else 2)
        tensors[f"t{i:02d}"] = torch.randn(n, generator=gen, device="cuda").to(dtype)
    nbytes = n_tensors * tensor_bytes
    path = os.path.join(workdir, "bulk")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot.take(path, {"bulk": StateDict(tensors)})
    take_s = time.perf_counter() - t0
    targets = StateDict({k: torch.zeros_like(v) for k, v in tensors.items()})
    t0 = time.perf_counter()
    Snapshot(path).restore({"bulk": targets})
    restore_s = time.perf_counter() - t0
    for k, v in tensors.items():
        if not torch.equal(v, targets[k]):
            raise AssertionError(f"bulk tensor {k} differs after restore")
    shutil.rmtree(path)
    return {
        "phase": "bulk", "bytes": nbytes, "tensors": n_tensors,
        "take_s": take_s, "restore_s": restore_s,
        "take_gb_s": nbytes / take_s / 1e9, "restore_gb_s": nbytes / restore_s / 1e9,
        "note": "the reference's single-accelerator take to local FS (20 GB) "
        "cut to 4 GiB for the smoke's time; no claim is made from it",
        "card": ctx["card"],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpusnap_torch.ops import flash_attention as fa

    card = nvidia_smi_line()
    ctx = {"card": card}
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    workdir = tempfile.mkdtemp(prefix="tpusnap_torch_smoke_")
    try:
        emit(phase_build())
        result = phase_kernels()
        kernel_row = result["flash_attention_fwd"]
        emit(result)
        fa.launches = 0  # the main path starts here
        emit(phase_train(ctx))
        emit(phase_snapshot(ctx, workdir))
        main_path_launches = fa.launches
        emit(phase_bulk(ctx, workdir))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if main_path_launches == 0:
        raise AssertionError("the main path launched no flash kernel")
    emit({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "tpusnap_torch/csrc/flash_attention.cu",
        "replaces": "tpusnap/ops/flash_attention.py:41",
        "launches": main_path_launches,
        "max_abs_err": kernel_row["max_abs_err"],
        "max_err": kernel_row["max_abs_err"],
        "ms": kernel_row["ms"],
        "plain_ms": kernel_row["plain_ms"],
        "bound_ms": kernel_row["bound_ms"],
        "bound_by": kernel_row["bound_by"],
        "library_ms": kernel_row["library_ms"],
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0

if __name__ == "__main__":
    sys.exit(main())
