"""Ring attention: causal attention over a sequence split into contiguous
blocks, one per rank, with a hand-written Hopper kernel for each block step.

Counterpart of tpusnap/ops/ring_attention.py. Each rank holds one block of
the sequence; K/V blocks rotate around the ring while every rank
accumulates its queries' attention with an online softmax, so no rank ever
holds the full sequence.

- ``block_attend(q, k, v, m, l, o, q_offset, k_offset, scale, causal)`` is
  the plain PyTorch version of ``_block_attend``: one online-softmax step
  of a local query block against one K/V block, returning the new carry
  ``(m, l, o)``. The CPU path and the tests use it; on the card it is only
  the yardstick the kernel is held against.
- ``attend_block(..., mode="middle", out=None)`` is the dispatch. On CUDA
  tensors it launches the kernel of ``csrc/ring_block_wgmma.cu``
  (``_block_attend_kernel``) or raises; there is no fallback. On CPU
  tensors it runs ``block_attend`` (with ``_init_carry`` and ``_finish``
  as the mode says). The carry modes: ``"middle"`` updates ``(m, l, o)``
  in place; ``"first"`` writes them from the empty carry without reading
  them; ``"last"`` reads them and writes the output ``o / l`` in q's
  dtype into ``out`` (the carry is not written); ``"first+last"`` (a ring
  of one) touches no carry and writes ``out``. On the card the modes
  replace the fill of the empty carry and the division after the last
  step, and ``first`` equals ``middle`` from ``_init_carry``, ``last``
  equals ``middle`` followed by ``_finish``, bit for bit. A causal block
  wholly in the queries' future changes nothing: a middle step over it
  is skipped without a launch (``skips``).
- ``_step_modes(rank, n, causal)``: the mode of each of a ring's steps on
  one rank, or None for a skipped one.
- ``ring_attention(q, k, v, group=None, causal=True, scale=None)``:
  ``group=None`` is one block (``axis_name=None`` in tpusnap). With a
  ``torch.distributed`` group of n ranks, K/V rotate ``i -> i + 1 mod n``
  with ``isend``/``irecv`` for n steps; after ``step`` rotations a rank
  holds the block of rank ``(rank - step) mod n``. The rotation goes
  through host memory: gloo's ``send``/``recv`` take no CUDA tensors, and
  ranks sharing one card cannot use NCCL. Each rotating CUDA block is
  copied into a pinned host buffer, sent as bytes while the block step
  runs on the card, and the received bytes are copied back. NCCL with one
  card per rank is the open transport (ROADMAP.md item A10b). On the card
  the carry is allocated with ``torch.empty`` only when a middle or last
  step will read it, and never filled.
- Gradients: with one block (``_RingBlock``, the ring of one), the
  forward under grad runs ``first`` and ``_finish``, keeping the carry as
  ``_Ring`` does, and saves the row log-sum-exp ``m + log l``; its backward
  is one call of ``attend_block_grads`` in ``store`` mode at offsets
  (0, 0). Under ``no_grad`` it is one ``first+last`` launch. Across ranks,
  ``_Ring`` is the counterpart of JAX's autodiff through ``_block_attend``
  and ``ppermute``. Its forward is the ring above, except that the last
  step runs as ``middle`` (``first+last`` as ``first``) and ``_finish``
  divides: the carry survives, so the row log-sum-exp can be saved, and
  the output equals the ``no_grad`` ring's bit for bit (``last`` is
  ``middle`` then ``_finish`` on the card). Its backward rotates
  ``(k, v, dk, dv)`` around the same ring for n steps, the last rotation
  carrying only ``dk``/``dv`` home, and each step adds one block's
  gradients into the f32 accumulators (``attend_block_grads`` in
  ``accumulate`` mode; a block wholly in the queries' future is skipped,
  ``backward_skips``). ``backward_steps`` counts the block steps.
- ``block_grads(...)`` is the plain PyTorch version of one block's
  gradients (f32, ``torch.matmul``, masked in global positions): the CPU
  path and the tests use it; on the card it is the yardstick.
- ``attend_block_grads(q, k, v, grad_out, lse, delta, dq, dk, dv, ...,
  mode="accumulate", path="ring")`` is the backward's dispatch. On CUDA
  tensors it launches the one kernel of ``csrc/ring_block_bwd_wgmma.cu``
  (``_block_grads_kernel``) or raises; there is no fallback. ``mode``:
  ``"accumulate"`` adds into f32 accumulators in place, ``"store"``
  writes the gradients once into outputs of q's dtype (the flash
  backward and the ring of one). On CPU tensors it runs ``block_grads``
  and three adds (or copies). ``backward_route_launches`` counts its calls
  that launched, by route, ``backward_path_launches`` by the user
  (``flash``, ``ring_of_one``, ``ring``), and ``grads_kernel_launches()``
  reads the kernels the C library launched (one a call). The 16-bit
  kernel rounds P and dS to the input type before the second-stage
  products; ``grads_rounding_bound`` is the per-element bound the card
  holds it to, and ``row_stats`` makes a block's row statistics for such
  checks.
- ``attention_delta(grad_out, out)``: ``delta = rowsum(dO * O)`` as
  ``[b, h, s]`` f32, one kernel pass on the card (``delta_launches``),
  ``attention_delta_reference`` (the plain expression) on the CPU.

Which backward runs where: every user (``_Ring``, ``_RingBlock`` and the
flash kernel's ``_FlashAttention``) goes through ``attention_delta`` and
``attend_block_grads``: the kernels on the card, ``block_grads`` on the
CPU.

Routes, picked by ``flash_attention._route`` from dtype and strides (over
grad_out too for the backward) and checked again in C: ``wgmma``
(bf16/f16 that TMA can describe) or ``simt`` (f32 and other layouts);
head_dim <= 128 for the forward block kernel, and for the backward's
wgmma route, whose simt route takes up to 256 (every head_dim the flash
forward takes). The kernels live in the flash attention library
(``flash_attention.build_library``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import torch

from . import flash_attention as _fa

_NEG_INF = -1e30
_MAX_HEAD_DIM = 128
# The backward kernel: wgmma up to 128, simt up to the flash forward's 256.
_MAX_GRADS_HEAD_DIM = 256
_MAX_GRADS_WGMMA_HEAD_DIM = 128
# The backward's write modes and their codes in the C interface.
GRADS_MODES = ("accumulate", "store")
# The backward's users, for its launch counts.
GRADS_PATHS = ("flash", "ring_of_one", "ring")
# The carry modes and their codes in the C interface (bit 0: no carry in;
# bit 1: the output instead of the carry out).
MODES = ("middle", "first", "last", "first+last")
_MODE_CODES = {mode: code for code, mode in enumerate(MODES)}

# Kernel launches made through ``attend_block`` in this process, in all, by
# route and by mode, and the future blocks skipped without a launch.
launches = 0
route_launches = {"wgmma": 0, "simt": 0}
mode_launches = dict.fromkeys(MODES, 0)
skips = 0
# The backward across ranks: block steps computed and future blocks that
# rotated past without one (``backward_skips`` also counts a future block
# that ``attend_block_grads`` skips when called directly).
backward_steps = 0
backward_skips = 0
# Calls of the backward block kernel (one launch each) made through
# ``attend_block_grads``, by route and by user.
backward_route_launches = {"wgmma": 0, "simt": 0}
backward_path_launches = dict.fromkeys(GRADS_PATHS, 0)
# Launches of the delta kernel made through ``attention_delta``.
delta_launches = 0

_fn = None
_grads_fn = None
_delta_fn = None
_lock = threading.Lock()


def _load():
    global _fn
    with _lock:
        if _fn is None:
            fn = _fa._load().tpusnap_ring_block_attend
            fn.argtypes = [
                ctypes.c_void_p,  # q
                ctypes.c_void_p,  # k
                ctypes.c_void_p,  # v
                ctypes.c_void_p,  # o
                ctypes.c_void_p,  # m
                ctypes.c_void_p,  # l
                ctypes.c_void_p,  # out
                ctypes.POINTER(ctypes.c_int64),  # 9 strides
                ctypes.c_int,  # b
                ctypes.c_int,  # s
                ctypes.c_int,  # h
                ctypes.c_int,  # d
                ctypes.c_int64,  # q_offset
                ctypes.c_int64,  # k_offset
                ctypes.c_float,  # scale
                ctypes.c_int,  # causal
                ctypes.c_int,  # mode code
                ctypes.c_int,  # dtype code
                ctypes.c_int,  # route code
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def _load_grads():
    global _grads_fn
    with _lock:
        if _grads_fn is None:
            fn = _fa._load().tpusnap_ring_block_grads
            fn.argtypes = [
                ctypes.c_void_p,  # q
                ctypes.c_void_p,  # k
                ctypes.c_void_p,  # v
                ctypes.c_void_p,  # grad_out
                ctypes.c_void_p,  # lse
                ctypes.c_void_p,  # delta
                ctypes.c_void_p,  # dq
                ctypes.c_void_p,  # dk
                ctypes.c_void_p,  # dv
                ctypes.POINTER(ctypes.c_int64),  # 12 strides
                ctypes.c_int,  # b
                ctypes.c_int,  # s
                ctypes.c_int,  # h
                ctypes.c_int,  # d
                ctypes.c_int64,  # q_offset
                ctypes.c_int64,  # k_offset
                ctypes.c_float,  # scale
                ctypes.c_int,  # causal
                ctypes.c_int,  # store (1) or accumulate (0)
                ctypes.c_int,  # dtype code
                ctypes.c_int,  # route code
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
            _grads_fn = fn
        return _grads_fn


def _load_delta():
    global _delta_fn
    with _lock:
        if _delta_fn is None:
            fn = _fa._load().tpusnap_attention_delta
            fn.argtypes = [
                ctypes.c_void_p,  # grad_out
                ctypes.c_void_p,  # out
                ctypes.c_void_p,  # delta
                ctypes.POINTER(ctypes.c_int64),  # 6 strides
                ctypes.c_int,  # b
                ctypes.c_int,  # s
                ctypes.c_int,  # h
                ctypes.c_int,  # d
                ctypes.c_int,  # dtype code
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
            _delta_fn = fn
        return _delta_fn


def grads_kernel_launches() -> int:
    """Kernels the C library's backward entry point has launched in this
    process (one a call): builds and loads the library."""
    fn = _fa._load().tpusnap_ring_block_grads_kernel_launches
    fn.restype = ctypes.c_longlong
    return int(fn())


def block_attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    o: torch.Tensor,
    q_offset: int,
    k_offset: int,
    scale: float,
    causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One online-softmax step against one K/V block (plain version of
    ``_block_attend``). q: ``[b, sq, h, d]``; k, v: ``[b, sk, h, d]``; m, l:
    ``[b, h, sq]`` f32; o: ``[b, sq, h, d]`` f32. ``q_offset``/``k_offset``
    are the blocks' first global positions. Returns the new ``(m, l, o)``."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        k_pos = k_offset + torch.arange(sk, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        # A fully masked row keeps m_new == m == -1e30 and p == 1; zeroing
        # by the mask keeps it contributing nothing.
        p = torch.where(mask, p, torch.zeros_like(p))
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * alpha.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def block_grads(q, k, v, grad_out, lse, delta, q_offset: int, k_offset: int, scale: float,
                causal: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One K/V block's share of attention's gradients, in f32, plain
    PyTorch: ``P = exp(S * scale - lse)``, ``dV = P^T dO``,
    ``dS = P * (dO V^T - delta)``, ``dQ = dS K * scale``,
    ``dK = dS^T Q * scale``. q, grad_out: ``[b, sq, h, d]``; k, v:
    ``[b, sk, h, d]``; lse (``m + log l`` of the whole row) and delta
    (``rowsum(dO * O)``): ``[b, h, sq]`` f32. Masked in global positions
    as ``block_attend`` is. Returns ``(dq, dk, dv)``, each its input's
    shape."""
    qf, kf, vf, do, p, dp = _grads_terms(q, k, v, grad_out, lse, q_offset, k_offset, scale, causal)
    dv = torch.matmul(p.transpose(-1, -2), do)
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _grads_terms(q, k, v, grad_out, lse, q_offset: int, k_offset: int, scale: float,
                 causal: bool):
    """``block_grads``' f32 operands ``[b, h, s, d]`` and its ``P`` and
    ``dP = dO V^T`` (``[b, h, sq, sk]``)."""
    qf, kf, vf, do = (t.float().transpose(1, 2) for t in (q, k, v, grad_out))  # [b, h, s, d]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale  # [b, h, sq, sk]
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - lse[..., None])
    return qf, kf, vf, do, p, torch.matmul(do, vf.transpose(-1, -2))


# Unit roundoff u of P's rounding to the input type before P V.
_ROUNDING = {torch.bfloat16: 2**-8, torch.float16: 2**-11, torch.float32: 0.0}
# The f32 arithmetic's relative slack: exp2 on the special-function unit
# (about 2**-22 relative) with the log2(e) scaling folded in, and the
# tensor cores' summation order.
_F32_SLACK = 1e-5


def rounding_bound(q, k, v, m, l, o, q_offset: int, k_offset: int, scale: float, causal: bool):
    """Per-element bounds ``(bm, bl, bo)`` on the kernel's new carry against
    ``block_attend`` on the same inputs, in f32: m within f32 slack of |m|;
    l within f32 slack of its terms (p is summed before rounding);
    o within ``u * (P |V|)`` (P rounded to the input type before P V, as
    ``flash_attention.rounding_bound`` allows the flash kernel) plus f32
    slack of its terms. 1e-6 absolute covers values near 0."""
    u = _ROUNDING[q.dtype]
    m_new, p_sum, p_abs_v = block_attend(
        q, k, v.abs(), m, torch.zeros_like(l), torch.zeros_like(o), q_offset, k_offset, scale, causal
    )
    alpha = torch.exp(m - m_new)
    bm = _F32_SLACK * m_new.abs() + 1e-6
    bl = _F32_SLACK * (alpha * l + p_sum) + 1e-6
    bo = u * p_abs_v + _F32_SLACK * (alpha.transpose(1, 2)[..., None] * o.abs() + p_abs_v) + 1e-6
    return bm, bl, bo


def grads_rounding_bound(q, k, v, grad_out, lse, delta, want, q_offset: int, k_offset: int,
                         scale: float, causal: bool, store: bool = False):
    """Per-element bounds ``(bdq, bdk, bdv)`` on the accumulators after
    ``attend_block_grads`` against ``want``, the plain result on the same
    inputs (each accumulator plus its ``block_grads`` term), in f32. The
    16-bit kernel rounds P and dS to the input type before the
    second-stage products: dV within ``u (P^T |dO|)``, dQ within
    ``u scale (|dS| |K|)``, dK within ``u scale (|dS|^T |Q|)``. The f32
    arithmetic (exp2 on the special-function unit, the tensor cores'
    summation order) moves each P and dP by ``_F32_SLACK`` of its terms,
    so dS by ``E = P (|dP - delta| + |dO| |V|^T)``, and each second
    product adds its own: ``2 _F32_SLACK`` of E carried through the same
    products. Both sides round the accumulators' add once:
    ``_F32_SLACK`` of the result. 1e-6 absolute covers values near 0.
    ``store``: ``want`` is ``block_grads``' f32 result and the kernel
    writes it rounded once to q's dtype, which adds ``u`` of its size."""
    u = _ROUNDING[q.dtype]
    qf, kf, vf, do, p, dp = _grads_terms(q, k, v, grad_out, lse, q_offset, k_offset, scale, causal)
    ds_abs = p * (dp - delta[..., None]).abs()
    spread = ds_abs + p * torch.matmul(do.abs(), vf.abs().transpose(-1, -2))
    w = u * ds_abs + 2 * _F32_SLACK * spread
    bdq = scale * torch.matmul(w, kf.abs())
    bdk = scale * torch.matmul(w.transpose(-1, -2), qf.abs())
    bdv = (u + 2 * _F32_SLACK) * torch.matmul(p.transpose(-1, -2), do.abs())
    bounds = tuple(
        bound.transpose(1, 2) + _F32_SLACK * w.abs() + 1e-6
        for bound, w in zip((bdq, bdk, bdv), want)
    )
    if store:
        bounds = tuple(b + u * (w.abs() + b) for b, w in zip(bounds, want))
    return bounds


def row_stats(q, k, v, grad_out, q_offset: int, k_offset: int, scale: float, causal: bool):
    """``(lse, delta, out)`` of the rows a ring rank holds when this K/V
    block reaches it, for checks of ``attend_block_grads``: the rows see
    this block and, when it is not their diagonal, the diagonal block too
    (the same K/V at ``q_offset``), so every row sees at least itself.
    lse = ``m + log l`` and delta = ``rowsum(dO * O)``: ``[b, h, sq]`` f32,
    contiguous; out: ``[b, sq, h, d]`` f32."""
    with torch.no_grad():
        carry = _init_carry(q)
        if k_offset != q_offset:
            carry = block_attend(q, k, v, *carry, q_offset, k_offset, scale, causal)
        m, l, o = block_attend(q, k, v, *carry, q_offset, q_offset, scale, causal)
        out = _finish(l, o, torch.float32)
        lse = (m + torch.log(l)).contiguous()
        delta = (grad_out.float() * out).sum(-1).transpose(1, 2).contiguous()
    return lse, delta, out


# Relative spacing of the output types: one ulp of x is at most eps |x|.
_EPS = {torch.bfloat16: 2**-7, torch.float16: 2**-10, torch.float32: 2**-23}


def finish_bound(q, k, v, m, l, o, q_offset: int, k_offset: int, scale: float, causal: bool):
    """Per-element bound on a last step's output against ``_finish`` of
    ``block_attend`` on the same inputs: the new carry's bounds
    (``rounding_bound``) carried through the division, |d(o / l)| <=
    (bo + |o / l| bl) / (l - bl), plus one ulp of the output type (both
    sides round once to it, and may round apart). 1e-6 absolute covers
    values near 0."""
    _, l_new, o_new = block_attend(q, k, v, m, l, o, q_offset, k_offset, scale, causal)
    _, bl, bo = rounding_bound(q, k, v, m, l, o, q_offset, k_offset, scale, causal)
    ref = (o_new / l_new.clamp_min(1e-20).transpose(1, 2)[..., None]).abs()
    l_low = (l_new - bl).clamp_min(1e-20).transpose(1, 2)[..., None]
    div = (bo + ref * bl.transpose(1, 2)[..., None]) / l_low
    return div + _EPS[q.dtype] * (ref + div) + 1e-6


def _check_block(q, k, v, m, l, o, mode: str, out) -> None:
    if mode not in _MODE_CODES:
        raise ValueError(f"unknown carry mode {mode!r}: one of {MODES}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [batch, seq, heads, head_dim], got {tuple(t.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    b, sq, h, _ = q.shape
    tensors = [q, k, v]
    if mode != "first+last":
        for name, t, shape in (("m", m, (b, h, sq)), ("l", l, (b, h, sq)), ("o", o, tuple(q.shape))):
            if t is None or tuple(t.shape) != shape or t.dtype != torch.float32:
                got = None if t is None else f"{t.dtype}{list(t.shape)}"
                raise ValueError(f"carry {name} must be float32{list(shape)}, got {got}")
        tensors += [m, l, o]
    if mode in ("last", "first+last"):
        if out is None or out.shape != q.shape or out.dtype != q.dtype:
            got = None if out is None else f"{out.dtype}{list(out.shape)}"
            raise ValueError(f"out must be {q.dtype}{list(q.shape)} in mode {mode!r}, got {got}")
        tensors.append(out)
    elif out is not None:
        raise ValueError(f"out is written only in the last modes, not in {mode!r}")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and the carry lie on different devices: {devices}")


def _block_attend_kernel(q, k, v, m, l, o, out, q_offset, k_offset, scale, causal, mode) -> None:
    """Launch the route's Hopper kernel in carry mode ``mode`` on the
    current stream (not synchronised). Raises on what it cannot take."""
    global launches
    b, s, h, d = q.shape
    if q.dtype not in _fa._DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype} (float32, float16, bfloat16)")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {_MAX_HEAD_DIM}: the ring block kernel takes up to 128")
    if k.shape != q.shape:
        raise ValueError(
            f"the ring block kernel takes K/V blocks of q's shape {tuple(q.shape)}, "
            f"got {tuple(k.shape)}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in head_dim (stride {t.stride(-1)})")
    written = [] if mode == "first+last" else [("carry m", m), ("carry l", l), ("carry o", o)]
    if out is not None:
        written.append(("out", out))
    for name, t in written:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous from a 16-byte aligned base")
    route = _fa._route(q, k, v, base_aligned=all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    fn = _load()
    strides = (ctypes.c_int64 * 9)(*(t.stride(i) for t in (q, k, v) for i in range(3)))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(o), ptr(m), ptr(l), ptr(out),
            strides, b, s, h, d, int(q_offset), int(k_offset), float(scale),
            1 if causal else 0, _MODE_CODES[mode], _fa._DTYPE_CODES[q.dtype],
            _fa._ROUTE_CODES[route], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ring block kernel launch failed: CUDA error {err} "
            f"(route {route}, mode {mode}, shape {tuple(q.shape)}, {q.dtype})"
        )
    launches += 1
    route_launches[route] += 1
    mode_launches[mode] += 1


def attend_block(
    q, k, v, m, l, o, q_offset: int, k_offset: int, scale: float, causal: bool,
    mode: str = "middle", out: Optional[torch.Tensor] = None,
) -> None:
    """One ring step against one K/V block in carry mode ``mode``:
    ``"middle"`` updates the carry ``(m, l, o)`` in place, ``"first"``
    writes it from the empty carry, ``"last"`` reads it and writes the
    output into ``out``, ``"first+last"`` needs no carry (pass None) and
    writes ``out``. The Hopper kernel for CUDA tensors (or raise),
    ``block_attend`` for CPU tensors."""
    global skips
    _check_block(q, k, v, m, l, o, mode, out)
    if mode == "middle" and causal and k_offset >= q_offset + q.shape[1]:
        skips += 1  # every key is in every query's future: alpha = 1, p = 0
        return
    if q.is_cuda:
        _block_attend_kernel(q, k, v, m, l, o, out, q_offset, k_offset, scale, causal, mode)
        return
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    carry = _init_carry(q) if mode in ("first", "first+last") else (m, l, o)
    m_new, l_new, o_new = block_attend(q, k, v, *carry, q_offset, k_offset, scale, causal)
    if out is not None:
        out.copy_(_finish(l_new, o_new, q.dtype))
        return
    m.copy_(m_new)
    l.copy_(l_new)
    o.copy_(o_new)


def _check_grads(q, k, v, grad_out, lse, delta, dq, dk, dv, mode: str) -> None:
    if mode not in GRADS_MODES:
        raise ValueError(f"unknown write mode {mode!r}: one of {GRADS_MODES}")
    for name, t in (("q", q), ("k", k), ("v", v), ("grad_out", grad_out)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [batch, seq, heads, head_dim], got {tuple(t.shape)}")
    if not (q.dtype == k.dtype == v.dtype == grad_out.dtype):
        raise ValueError(
            f"q, k, v, grad_out dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}, {grad_out.dtype}"
        )
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if grad_out.shape != q.shape:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} is not q's shape {tuple(q.shape)}")
    b, sq, h, _ = q.shape
    out_dtype = torch.float32 if mode == "accumulate" else q.dtype
    for name, t, shape, dtype in (("lse", lse, (b, h, sq), torch.float32),
                                  ("delta", delta, (b, h, sq), torch.float32),
                                  ("dq", dq, tuple(q.shape), out_dtype),
                                  ("dk", dk, tuple(k.shape), out_dtype),
                                  ("dv", dv, tuple(k.shape), out_dtype)):
        if t is None or tuple(t.shape) != shape or t.dtype != dtype:
            got = None if t is None else f"{t.dtype}{list(t.shape)}"
            want = str(dtype).split(".")[-1]
            raise ValueError(f"{name} must be {want}{list(shape)} in mode {mode!r}, got {got}")
    devices = {t.device for t in (q, k, v, grad_out, lse, delta, dq, dk, dv)}
    if len(devices) != 1:
        raise ValueError(f"the inputs and accumulators lie on different devices: {devices}")


def _grads_route(q, k, v, grad_out) -> str:
    """``flash_attention._route``'s rule over q, k, v and grad_out, and
    head_dim <= 128: the wgmma backward kernel loads all four through TMA
    tensor maps."""
    if q.shape[-1] > _MAX_GRADS_WGMMA_HEAD_DIM:
        return "simt"
    aligned = [t.data_ptr() % 16 == 0 for t in (q, k, v, grad_out)]
    if (_fa._route(q, k, v, base_aligned=all(aligned[:3])) == "wgmma"
            and _fa._route(grad_out, grad_out, grad_out, base_aligned=aligned[3]) == "wgmma"):
        return "wgmma"
    return "simt"


def _block_grads_kernel(q, k, v, grad_out, lse, delta, dq, dk, dv, q_offset, k_offset, scale,
                        causal, mode: str, path: str) -> None:
    """Launch the route's backward kernel (one launch: the dK/dV and dQ
    items together) on the current stream (not synchronised). Raises on
    what it cannot take."""
    b, s, h, d = q.shape
    if q.dtype not in _fa._DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype} (float32, float16, bfloat16)")
    if d > _MAX_GRADS_HEAD_DIM:
        raise ValueError(
            f"head_dim {d} > {_MAX_GRADS_HEAD_DIM}: the backward block kernel takes up to 256"
        )
    if k.shape != q.shape:
        raise ValueError(
            f"the backward block kernel takes K/V blocks of q's shape {tuple(q.shape)}, "
            f"got {tuple(k.shape)}"
        )
    for name, t in (("q", q), ("k", k), ("v", v), ("grad_out", grad_out)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in head_dim (stride {t.stride(-1)})")
    for name, t in (("lse", lse), ("delta", delta)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    align = 16 if mode == "accumulate" else 4
    for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{name} must be contiguous from a {align}-byte aligned base")
    route = _grads_route(q, k, v, grad_out)
    fn = _load_grads()
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (q, k, v, grad_out) for i in range(3)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), grad_out.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides, b, s, h, d,
            int(q_offset), int(k_offset), float(scale), 1 if causal else 0,
            1 if mode == "store" else 0, _fa._DTYPE_CODES[q.dtype], _fa._ROUTE_CODES[route],
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ring backward block kernel launch failed: CUDA error {err} "
            f"(route {route}, mode {mode}, shape {tuple(q.shape)}, {q.dtype})"
        )
    backward_route_launches[route] += 1
    backward_path_launches[path] += 1


def attend_block_grads(
    q, k, v, grad_out, lse, delta, dq, dk, dv, q_offset: int, k_offset: int, scale: float,
    causal: bool, mode: str = "accumulate", path: str = "ring",
) -> bool:
    """One K/V block's share of attention's gradients against the local
    queries: what ``block_grads`` returns, from the rows' ``lse`` and
    ``delta`` (``[b, h, sq]`` f32). ``mode="accumulate"`` adds it in place
    into the f32 accumulators ``dq`` (q's shape), ``dk`` and ``dv`` (k's
    shape); ``mode="store"`` writes it into outputs of q's dtype, read
    never. The Hopper kernel of ``csrc/ring_block_bwd_wgmma.cu`` for CUDA
    tensors (or raise), ``block_grads`` and three adds (or copies) for CPU
    tensors. ``path`` names the user for ``backward_path_launches``. A
    causal block wholly in the queries' future adds nothing and is skipped
    without a launch (``backward_skips``; in store mode the outputs are
    zeroed); returns whether the block was computed."""
    global backward_skips
    if path not in GRADS_PATHS:
        raise ValueError(f"unknown backward path {path!r}: one of {GRADS_PATHS}")
    _check_grads(q, k, v, grad_out, lse, delta, dq, dk, dv, mode)
    if causal and k_offset >= q_offset + q.shape[1]:
        backward_skips += 1  # every key is in every query's future: P = 0
        if mode == "store":
            for t in (dq, dk, dv):
                t.zero_()
        return False
    if q.is_cuda:
        _block_grads_kernel(q, k, v, grad_out, lse, delta, dq, dk, dv, q_offset, k_offset, scale,
                            causal, mode, path)
        return True
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    gq, gk, gv = block_grads(q, k, v, grad_out, lse, delta, q_offset, k_offset, scale, causal)
    if mode == "store":
        dq.copy_(gq)
        dk.copy_(gk)
        dv.copy_(gv)
    else:
        dq += gq
        dk += gk
        dv += gv
    return True


def attention_delta_reference(grad_out: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * O)`` of attention's backward in plain PyTorch:
    ``[b, h, s]`` f32, contiguous, from ``[b, s, h, d]`` dO and O."""
    return (grad_out.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def attention_delta(grad_out: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` (``[b, h, s]`` f32, contiguous): on CUDA
    tensors one launch of the delta kernel of
    ``csrc/ring_block_bwd_wgmma.cu`` (it reads dO and O once in their
    type and sums in f32 in one fixed order) or raise; on CPU tensors
    ``attention_delta_reference``."""
    global delta_launches
    if grad_out.dim() != 4 or grad_out.shape != out.shape or grad_out.dtype != out.dtype:
        raise ValueError(f"grad_out {grad_out.dtype}{list(grad_out.shape)} and out "
                         f"{out.dtype}{list(out.shape)} must be one [b, s, h, d] shape and dtype")
    if grad_out.device != out.device:
        raise ValueError(f"grad_out and out lie on different devices: {grad_out.device}, "
                         f"{out.device}")
    if not grad_out.is_cuda:
        if grad_out.device.type != "cpu":
            raise ValueError(f"unsupported device {grad_out.device}")
        return attention_delta_reference(grad_out, out)
    if grad_out.dtype not in _fa._DTYPE_CODES:
        raise ValueError(f"unsupported dtype {grad_out.dtype} (float32, float16, bfloat16)")
    for name, t in (("grad_out", grad_out), ("out", out)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in head_dim (stride {t.stride(-1)})")
    b, s, h, d = grad_out.shape
    delta = torch.empty((b, h, s), dtype=torch.float32, device=grad_out.device)
    if delta.numel() == 0:
        return delta
    fn = _load_delta()
    strides = (ctypes.c_int64 * 6)(*(t.stride(i) for t in (grad_out, out) for i in range(3)))
    with torch.cuda.device(grad_out.device):
        stream = torch.cuda.current_stream(grad_out.device).cuda_stream
        err = fn(grad_out.data_ptr(), out.data_ptr(), delta.data_ptr(), strides, b, s, h, d,
                 _fa._DTYPE_CODES[grad_out.dtype], stream)
    if err != 0:
        raise RuntimeError(f"attention delta kernel launch failed: CUDA error {err} "
                           f"(shape {tuple(grad_out.shape)}, {grad_out.dtype})")
    delta_launches += 1
    return delta


def _init_carry(q: torch.Tensor):
    b, sq, h, _ = q.shape
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    return m, l, o


def _finish(l: torch.Tensor, o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # l > 0 for causal (the diagonal attends) and non-causal rows alike;
    # guarded as tpusnap does.
    out = o / l.clamp_min(1e-20).transpose(1, 2)[..., None]
    return out.to(dtype)


def _step_modes(rank: int, n: int, causal: bool) -> list:
    """The carry mode of each of the ``n`` steps of a ring on ``rank``, or
    None for a step it skips. At step t a rank holds the block of rank
    ``(rank - t) mod n``; with ``causal`` that block is in its future for
    every t > rank, so steps 0 ... rank launch; without it every step
    does. The first launched step starts from the empty carry and the
    last writes the output; a lone one does both."""
    launched = [t for t in range(n) if not causal or t <= rank]
    modes = [None] * n
    for t in launched:
        modes[t] = "middle"
    if len(launched) == 1:
        modes[launched[0]] = "first+last"
    else:
        modes[launched[0]], modes[launched[-1]] = "first", "last"
    return modes


def _one_block(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    attend_block(q, k, v, None, None, None, 0, 0, scale, causal, mode="first+last", out=out)
    return out


def ring_attention_reference(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """The one-block ring in plain PyTorch (tpusnap's ``axis_name=None``
    path)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    m, l, o = _init_carry(q)
    m, l, o = block_attend(q, k, v, m, l, o, 0, 0, scale, causal)
    return _finish(l, o, q.dtype)


class _RingBlock(torch.autograd.Function):
    """One block under grad (the ring of one). Forward: ``first`` and
    ``_finish`` through ``attend_block``, keeping the carry (equal to the
    ``first+last`` launch bit for bit), saving q, k, v, the output and the
    row log-sum-exp. Backward: ``attention_delta`` and one
    ``attend_block_grads`` call in ``store`` mode at offsets (0, 0)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        b, sq, h, _ = q.shape
        m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        attend_block(q, k, v, m, l, o, 0, 0, scale, causal, mode="first")
        out = _finish(l, o, q.dtype)
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        grads = [torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3)]
        attend_block_grads(q, k, v, grad_out, lse, attention_delta(grad_out, out), *grads, 0, 0,
                           ctx.scale, ctx.causal, mode="store", path="ring_of_one")
        return (*grads, None, None)


class _Rotation:
    """Blocks moving one step around the ring, ``rank -> rank + 1``, as
    bytes over the group's backend, one message per tensor of ``likes``
    (their shapes and dtypes) under ``tag``. CUDA blocks go through pinned
    host buffers (gloo takes no CUDA tensors); CPU blocks are sent as they
    are."""

    def __init__(self, group, likes: Sequence[torch.Tensor], tag: int = 0) -> None:
        import torch.distributed as dist

        self._dist = dist
        self._group = group
        self._tag = tag
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        self._dst = dist.get_global_rank(group, (rank + 1) % n)
        self._src = dist.get_global_rank(group, (rank - 1) % n)
        pin = likes[0].is_cuda
        self._send = [torch.empty(t.shape, dtype=t.dtype, pin_memory=pin) for t in likes]
        self._recv = [torch.empty(t.shape, dtype=t.dtype, pin_memory=pin) for t in likes]
        self._works = []

    def start(self, *blocks: torch.Tensor) -> None:
        """Send this rank's blocks on and post the receives of the
        neighbour's; returns once the sends' bytes are in host memory."""
        for buf, t in zip(self._send, blocks):
            buf.copy_(t)  # from the card: synchronous, the bytes are final
        dist = self._dist
        self._works = []
        for send, recv in zip(self._send, self._recv):
            self._works.append(dist.isend(send.view(torch.uint8), self._dst, group=self._group,
                                          tag=self._tag))
            self._works.append(dist.irecv(recv.view(torch.uint8), self._src, group=self._group,
                                          tag=self._tag))

    def finish(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """Wait for the exchange; the received blocks on ``device``."""
        for work in self._works:
            work.wait()
        self._works = []
        # Copies: the host buffers are reused by the next step.
        return tuple(t.to(device, copy=True) for t in self._recv)


def _ring_forward(q, k, v, group, causal: bool, scale: float, keep_carry: bool):
    """The ring's forward on this rank: its output block and, with
    ``keep_carry``, the row log-sum-exp ``m + log l`` (``[b, h, sq]`` f32).
    ``keep_carry`` runs the last step as ``middle`` (``first+last`` as
    ``first``) and divides with ``_finish``, which the ``last`` modes equal
    bit for bit."""
    import torch.distributed as dist

    global skips
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    sq = q.shape[1]
    modes = _step_modes(rank, n, causal)
    if keep_carry:
        modes = [{"last": "middle", "first+last": "first"}.get(mode, mode) for mode in modes]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    m = l = o = None  # the carry, where a middle or last step reads it
    if keep_carry or any(mode in ("middle", "last") for mode in modes):
        m = torch.empty((q.shape[0], q.shape[2], sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    rotation = _Rotation(group, (k, v))
    k_blk, v_blk = k, v
    for step, mode in enumerate(modes):
        last = step == n - 1
        if not last:
            rotation.start(k_blk, v_blk)
        if mode is None:
            skips += 1  # a block wholly in the queries' future
        else:
            src = (rank - step) % n
            attend_block(q, k_blk, v_blk, m, l, o, rank * sq, src * sq, scale, causal, mode=mode,
                         out=out if mode in ("last", "first+last") else None)
        if not last:
            k_blk, v_blk = rotation.finish(q.device)
    if not keep_carry:
        return out, None
    return _finish(l, o, q.dtype), m + torch.log(l)


class _Ring(torch.autograd.Function):
    """The ring across the ranks of ``group`` with a backward.

    Forward: ``_ring_forward`` keeping the carry; saves q, k, v, the output
    and the row log-sum-exp. Backward: ``(k, v, dk, dv)`` rotate around the
    same ring for n steps; at step t this rank holds rank ``(rank - t) mod
    n``'s block and its gradient accumulators, adds the block's share
    against its own queries (``attend_block_grads``) and passes them on;
    the n-th rotation brings each rank's ``dk``/``dv`` home (K/V need not
    go). grad_out is made contiguous first: an upstream gradient may be
    an expanded or transposed view, and the kernel loads it in rows."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        out, lse = _ring_forward(q, k, v, group, causal, scale, keep_carry=True)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        import torch.distributed as dist

        global backward_steps
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        sq = q.shape[1]
        grad_out = grad_out.contiguous()
        delta = attention_delta(grad_out, out)  # [b, h, sq]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kv_rotation = _Rotation(group, (k, v))
        grad_rotation = _Rotation(group, (dk, dv), tag=1)
        k_blk, v_blk = k, v
        for step in range(n):
            last = step == n - 1
            if not last:
                kv_rotation.start(k_blk, v_blk)  # K/V do not change: on their way at once
            src = (rank - step) % n
            # A block wholly in the queries' future is skipped (P = 0).
            if attend_block_grads(q, k_blk, v_blk, grad_out, lse, delta, dq, dk, dv, rank * sq,
                                  src * sq, scale, causal):
                backward_steps += 1
            grad_rotation.start(dk, dv)
            if not last:
                k_blk, v_blk = kv_rotation.finish(q.device)
            dk, dv = grad_rotation.finish(q.device)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention with the sequence split over the ranks of ``group``.

    q, k, v: this rank's contiguous block ``[batch, seq_local, heads,
    head_dim]`` of a global ``[batch, seq, heads, head_dim]``, rank r
    holding positions ``r * seq_local ...``. ``group=None`` is one block
    (plain attention through the block kernel). ``causal`` masks in global
    positions; ``scale`` defaults to ``head_dim ** -0.5``. Returns this
    rank's output block, q's shape and dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if group is not None:
        import torch.distributed as dist

        if dist.get_world_size(group) > 1:
            if grad:
                return _Ring.apply(q, k, v, group, causal, scale)
            return _ring_forward(q, k, v, group, causal, scale, keep_carry=False)[0]
    if grad:
        return _RingBlock.apply(q, k, v, causal, scale)
    return _one_block(q, k, v, causal, scale)
