"""Flash attention forward: a hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of tpusnap/ops/flash_attention.py. The kernel
(``tpusnap_torch/csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``tpusnap/ops/flash_attention.py::_flash_fwd_kernel``: it computes what
``_flash_forward`` returns, reading ``[b, s, h, d]`` inputs through their
strides with no transpose and no padding (the source's header says what
bounds it on an H100 and how the design answers that).

- ``flash_attention(q, k, v, causal=True)`` keeps the JAX signature and
  layout. On a CUDA tensor it launches the kernel or raises — there is no
  fallback. On a CPU tensor it runs ``flash_attention_reference``.
- ``flash_attention_reference`` is the counterpart of
  ``_attention_reference``: an einsum in f32, a ``tril`` mask at -1e30,
  softmax, a cast back. The CPU path and the tests use it; on the card it
  is only the yardstick the kernel is held against.
- The gradient is a ``torch.autograd.Function`` whose backward
  differentiates the plain version, as ``_flash_bwd`` does in JAX — the
  JAX package has no backward kernel, so neither does the port.
- ``launches`` counts kernel launches (never CPU calls), so a run can show
  that its main path went through the kernel.

The kernel library is built with ``nvcc`` for ``sm_90a`` at first use into
``tpusnap_torch/_build/`` (rebuilt when the source is newer than the
library) and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional

import torch

_NEG_INF = -1e30
_MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "flash_attention.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SO = os.path.join(_BUILD_DIR, "libtpusnap_flash_attention.so")

# Kernel launches made through ``flash_attention`` in this process.
launches = 0

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the flash attention kernel is "
            "built from tpusnap_torch/csrc at first use"
        )
    return found


def build_library() -> str:
    """Compile the kernel library if it is missing or older than its
    source; returns ``ptxas``' per-kernel resource report (empty when the
    library was already current)."""
    with _lock:
        return _build_locked()


def _build_locked() -> str:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return ""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # Link to a temp path and rename: a mapped .so must never be truncated.
    tmp = f"{_SO}.tmp.{os.getpid()}"
    cmd = [
        _nvcc(),
        "-gencode",
        "arch=compute_90a,code=sm_90a",
        "-std=c++17",
        "-O3",
        "-shared",
        "-Xcompiler",
        "-fPIC",
        "-Xptxas",
        "-v",
        "-o",
        tmp,
        _SRC,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {_SRC}:\n{proc.stderr}"
        )
    os.replace(tmp, _SO)
    return proc.stderr


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _build_locked()
            lib = ctypes.CDLL(_SO)
            fn = lib.tpusnap_flash_attention_fwd
            fn.argtypes = [
                ctypes.c_void_p,  # q
                ctypes.c_void_p,  # k
                ctypes.c_void_p,  # v
                ctypes.c_void_p,  # o
                ctypes.POINTER(ctypes.c_int64),  # 12 strides
                ctypes.c_int,  # b
                ctypes.c_int,  # s
                ctypes.c_int,  # h
                ctypes.c_int,  # d
                ctypes.c_float,  # scale
                ctypes.c_int,  # causal
                ctypes.c_int,  # dtype code
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [batch, seq, heads, head_dim], got {tuple(t.shape)}")
    if not (q.shape == k.shape == v.shape):
        raise ValueError(
            f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype} (float32, float16, bfloat16)")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v devices differ: {q.device}, {k.device}, {v.device}")
    if q.shape[-1] > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[-1]} > {_MAX_HEAD_DIM}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type == "cuda":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.shape[-1] > 1 and t.stride(-1) != 1:
                raise ValueError(f"{name} must be contiguous in head_dim (stride {t.stride(-1)})")


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Plain attention in f32 (counterpart of ``_attention_reference``)."""
    b, s, h, d = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d**-0.5)
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _kernel_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream (not synchronised)."""
    global launches
    lib = _load()
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in range(3))
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.tpusnap_flash_attention_fwd(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            out.data_ptr(),
            strides,
            b,
            s,
            h,
            d,
            float(d**-0.5),
            1 if causal else 0,
            _DTYPE_CODES[q.dtype],
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed: CUDA error {err} "
            f"(shape {tuple(q.shape)}, {q.dtype})"
        )
    launches += 1
    return out


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    if q.is_cuda:
        return _kernel_forward(q, k, v, causal)
    return flash_attention_reference(q, k, v, causal)


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward:
    autograd of the plain version, recomputed from q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = tuple(t.detach().requires_grad_(True) for t in (q, k, v))
            out = flash_attention_reference(*inputs, ctx.causal)
            grads = torch.autograd.grad(out, inputs, grad_out)
        return (*grads, None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Attention over ``[batch, seq, heads, head_dim]`` inputs. CUDA
    tensors run the Hopper kernel (or raise); CPU tensors run the plain
    version. Differentiable."""
    _check_inputs(q, k, v)
    return _FlashAttention.apply(q, k, v, causal)
