"""Flash attention forward: hand-written Hopper kernels and their plain
PyTorch version.

Counterpart of tpusnap/ops/flash_attention.py. The kernels
(``tpusnap_torch/csrc/``) replace the Pallas TPU kernel
``tpusnap/ops/flash_attention.py::_flash_fwd_kernel``: they compute what
``_flash_forward`` returns, reading ``[b, s, h, d]`` inputs through their
strides with no transpose and no padding. Two routes, chosen by
``_route`` from the dtype and the strides (a dispatch, not a knob; the C
entry point checks the choice again):

- ``wgmma`` (``flash_attention_wgmma.cu``): bf16/f16 whose rows and b/s/h
  strides are multiples of 16 bytes from 16-byte aligned bases, what a TMA
  tensor map can describe. Products on the tensor cores; P is rounded to
  the input type before P V, as FlashAttention does.
- ``simt`` (``flash_attention.cu``): f32 inputs (no tensor-core type keeps
  the f32 tolerance) and 16-bit layouts TMA cannot describe.

The sources' headers say what bounds each on an H100 and how the design
answers that.

- ``flash_attention(q, k, v, causal=True)`` keeps the JAX signature and
  layout. On a CUDA tensor it launches a kernel or raises — there is no
  fallback. On a CPU tensor it runs ``flash_attention_reference``.
- ``flash_attention_reference`` is the counterpart of
  ``_attention_reference``: an einsum in f32, a ``tril`` mask at -1e30,
  softmax, a cast back. The CPU path and the tests use it; on the card it
  is only the yardstick the kernel is held against.
- The gradient is a ``torch.autograd.Function`` (``_FlashAttention``,
  taken only under grad). Its forward has the kernel also write the rows'
  log-sum-exp (``reference_lse`` on the CPU); its backward is
  ``ring_attention``'s: the delta pass (``attention_delta``), then one
  call of the backward block kernel in ``store`` mode over the whole
  sequence as one diagonal block at offsets (0, 0) and scale
  ``head_dim ** -0.5`` (``attend_block_grads``, ``path="flash"``;
  ``block_grads`` on the CPU). That replaces tpusnap's ``_flash_bwd``,
  plain XLA autodiff of ``_attention_reference``, with a kernel on the
  card; every head_dim the forward takes (up to 256) has a backward
  kernel.
- ``launches`` counts kernel launches (never CPU calls), and
  ``route_launches`` splits them by route, so a run can show that its main
  path went through the tensor-core kernel.

The kernel library is built with ``nvcc`` for ``sm_90a`` at first use into
``tpusnap_torch/_build/`` (one ``nvcc`` per source, started together, then
one link; rebuilt when a file in ``csrc/`` is newer than the library) and
bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import importlib
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
_CSRC = os.path.join(_PKG_DIR, "csrc")
# The library also holds ring attention's block kernels, forward and
# backward (ops/ring_attention.py).
_SRCS = [
    os.path.join(_CSRC, f)
    for f in ("flash_attention.cu", "flash_attention_wgmma.cu", "ring_block_wgmma.cu",
              "ring_block_bwd_wgmma.cu")
]
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SO = os.path.join(_BUILD_DIR, "libtpusnap_flash_attention.so")
_PTXAS_REPORT = os.path.join(_BUILD_DIR, "ptxas.txt")
_ROUTE_CODES = {"simt": 0, "wgmma": 1}

# Kernel launches made through ``flash_attention`` in this process, in all
# and by route.
launches = 0
route_launches = {"wgmma": 0, "simt": 0}

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
    """Compile the kernel library if it is missing or older than a file in
    ``csrc/``; returns ``ptxas``' per-kernel resource report of the build
    that made the library."""
    with _lock:
        _build_locked()
        with open(_PTXAS_REPORT) as f:
            return f.read()


def _build_locked() -> None:
    newest = max(os.path.getmtime(os.path.join(_CSRC, f)) for f in os.listdir(_CSRC))
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= newest:
        return
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
    objs = [os.path.join(_BUILD_DIR, os.path.basename(s) + f".{os.getpid()}.o") for s in _SRCS]
    procs = [
        subprocess.Popen(
            [nvcc, *flags, "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", "-o", obj, src],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for src, obj in zip(_SRCS, objs)
    ]
    report = []
    for src, proc in zip(_SRCS, procs):
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building {src}:\n{err}")
        report.append(err)
    # Link to a temp path and rename: a mapped .so must never be truncated.
    tmp = f"{_SO}.tmp.{os.getpid()}"
    proc = subprocess.run(
        [nvcc, *flags, "-shared", "-o", tmp, *objs], capture_output=True, text=True, timeout=600
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) linking {_SO}:\n{proc.stderr}")
    for obj in objs:
        os.remove(obj)
    with open(_PTXAS_REPORT, "w") as f:
        f.write("".join(report))
    os.replace(tmp, _SO)


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
                ctypes.c_void_p,  # lse, or None
                ctypes.POINTER(ctypes.c_int64),  # 12 strides
                ctypes.c_int,  # b
                ctypes.c_int,  # s
                ctypes.c_int,  # h
                ctypes.c_int,  # d
                ctypes.c_float,  # scale
                ctypes.c_int,  # causal
                ctypes.c_int,  # dtype code
                ctypes.c_int,  # route code
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
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention in f32 (counterpart of ``_attention_reference``),
    scores scaled by ``scale`` (``head_dim ** -0.5`` when None)."""
    b, s, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def reference_lse(
    q: torch.Tensor, k: torch.Tensor, causal: bool = True, scale: Optional[float] = None
) -> torch.Tensor:
    """The rows' log-sum-exp of ``flash_attention_reference``'s scores,
    ``[b, h, s]`` f32: the natural log of each row's sum of exp over the
    scaled, masked scores (what the backward takes)."""
    s, d = q.shape[1], q.shape[-1]
    if scale is None:
        scale = d**-0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    return torch.logsumexp(scores, dim=-1).contiguous()


def _route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, base_aligned: bool = True) -> str:
    """``"wgmma"`` or ``"simt"``: the tensor-core kernel takes bf16/f16
    inputs whose head_dim rows and every b/s/h stride of q, k and v are
    whole positive multiples of 16 bytes (strides of dims of size 1 are never used),
    from 16-byte aligned bases (``base_aligned``): what a TMA tensor map can
    describe. Reads only dtype, shape and strides; mirrors
    ``wgmma_route`` in ``csrc/flash_attention.cuh``."""
    if q.dtype not in (torch.bfloat16, torch.float16) or not base_aligned:
        return "simt"
    itemsize = q.element_size()
    if (q.shape[-1] * itemsize) % 16:
        return "simt"
    for t in (q, k, v):
        for dim in range(3):
            if t.shape[dim] > 1 and (t.stride(dim) <= 0 or (t.stride(dim) * itemsize) % 16):
                return "simt"
    return "wgmma"


# Unit roundoff u of P's rounding before P V, and two ulps of the output.
_ROUNDING = {torch.bfloat16: (2**-8, 2**-6), torch.float16: (2**-11, 2**-9)}


def rounding_bound(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Per-element bound on |out - flash_attention_reference(q, k, v)| for
    a 16-bit kernel that rounds P to the input type before P V:
    u·(P·|V|) + 2 ulps·|ref| + 1e-5, in f32. Rounding each p to u costs at
    most u·Σ p|v|/l; both sides round the output once; 1e-5 covers the f32
    summation order."""
    u, two_ulps = _ROUNDING[q.dtype]
    p_abs_v = flash_attention_reference(q.float(), k.float(), v.float().abs(), causal)
    ref = flash_attention_reference(q, k, v, causal).float()
    return u * p_abs_v + two_ulps * ref.abs() + 1e-5


def _kernel_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    lse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the route's Hopper kernel on the current stream (not
    synchronised); with ``lse`` (``[b, h, s]`` f32, contiguous) the kernel
    also writes the rows' log-sum-exp there."""
    global launches
    lib = _load()
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    route = _route(q, k, v, base_aligned=all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
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
            None if lse is None else lse.data_ptr(),
            strides,
            b,
            s,
            h,
            d,
            float(d**-0.5),
            1 if causal else 0,
            _DTYPE_CODES[q.dtype],
            _ROUTE_CODES[route],
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed: CUDA error {err} "
            f"(route {route}, shape {tuple(q.shape)}, {q.dtype})"
        )
    launches += 1
    route_launches[route] += 1
    return out


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    if q.is_cuda:
        return _kernel_forward(q, k, v, causal)
    return flash_attention_reference(q, k, v, causal)


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel writing the rows' log-sum-exp too (CUDA), or the
    plain version and ``reference_lse`` (CPU). Backward: the delta pass and
    the backward block kernel in ``store`` mode (CUDA), or ``block_grads``
    (CPU), through ``ring_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.is_cuda:
            b, s, h, _ = q.shape
            lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
            out = _kernel_forward(q, k, v, causal, lse)
        else:
            out = flash_attention_reference(q, k, v, causal)
            lse = reference_lse(q, k, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        # The module, not the function ops/__init__.py exports under its name.
        ra = importlib.import_module(".ring_attention", __package__)
        q, k, v, out, lse = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        grads = [torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3)]
        if q.numel() == 0:
            return (*grads, None)
        ra.attend_block_grads(q, k, v, grad_out, lse, ra.attention_delta(grad_out, out), *grads,
                              0, 0, q.shape[-1] ** -0.5, ctx.causal, mode="store", path="flash")
        return (*grads, None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Attention over ``[batch, seq, heads, head_dim]`` inputs. CUDA
    tensors run the Hopper kernel (or raise); CPU tensors run the plain
    version. Differentiable: under grad its backward runs the backward
    block kernel."""
    _check_inputs(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal)
