"""Plain PyTorch reference of the flagship decoder transformer and its
Adam step, written from the model's equations; it imports nothing of the
program.

The model: token embedding; per layer, a pre-norm causal self-attention
block (RMSNorm with eps 1e-6, one fused QKV projection, rotary embedding
with theta 10000 on interleaved even/odd lanes over absolute positions,
softmax attention scaled by head_dim ** -0.5, an output projection) and a
pre-norm feed-forward block (GELU with the tanh approximation between
two projections); a final RMSNorm; an untied unembedding; the mean next-token cross-entropy (the
last position predicts nothing). Every layer weight is stacked along a
leading layer dimension, under the names ``embed``, ``layers.<name>``,
``ln_f`` and ``unembed``. Adam: b1 0.9, b2 0.999, eps 1e-8, the step
counted before the bias corrections, f32 moments.

``cast`` is applied wherever a compute precision would round: each
matmul's operands and result, the residual stream, the norms' outputs,
the rotary embedding's output and the attention probabilities before
they weight V. The reference passes ``None`` and computes everything in
float32 with TF32 off; the control passes ``fp8_cast`` and computes one
precision below the configuration's bfloat16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_NEG = -1e30


def leaf_specs(cfg: dict) -> List[tuple]:
    """(name, shape, fan_in or None for ones) of every parameter, in the
    order the weights are drawn."""
    L, D, Fd, V = cfg["n_layers"], cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    return [
        ("embed", (V, D), D),
        ("layers.ln1", (L, D), None),
        ("layers.ln2", (L, D), None),
        ("layers.wqkv", (L, D, 3 * D), D),
        ("layers.wo", (L, D, D), D),
        ("layers.w1", (L, D, Fd), D),
        ("layers.w2", (L, Fd, D), Fd),
        ("ln_f", (D,), None),
        ("unembed", (D, V), D),
    ]


def init_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The parameters from ``seed``: one normal draw on ``device`` for
    every random leaf, each scaled by fan_in ** -0.5; norms' scales are
    ones. float32, keyed by dotted name."""
    specs = leaf_specs(cfg)
    total = sum(math.prod(shape) for _, shape, fan in specs if fan is not None)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, fan in specs:
        if fan is None:
            out[name] = torch.ones(shape, device=device, dtype=torch.float32)
            continue
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(fan ** -0.5)
        at += n
    return out


def step_flops(cfg: dict) -> int:
    """FLOPs of one training step counted from shapes, each product once
    (forward 2 per multiply-add, backward twice the forward), no
    recompute: 6 T P_mm for the matmuls, P_mm = L (4 D^2 + 2 D F) + D V,
    and 6 B S^2 D L for attention over the causal pairs kept."""
    B, S = cfg["batch"], cfg["max_seq_len"]
    L, D, Fd, V = (cfg[k] for k in ("n_layers", "d_model", "d_ff", "vocab_size"))
    p_mm = L * (4 * D * D + 2 * D * Fd) + D * V
    return 6 * B * S * p_mm + 6 * B * S * S * D * L


# ------------------------------------------------------------ precisions


def _fp8_round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one per-tensor scale (its largest
    magnitude maps to the format's largest finite value), back in f32."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8Cast(torch.autograd.Function):
    """Values rounded to e4m3 going forward, gradients to e5m2 going back:
    the usual split of an fp8 training step."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2)


def fp8_cast(x: torch.Tensor) -> torch.Tensor:
    return _Fp8Cast.apply(x)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


# ---------------------------------------------------------------- model


def _rmsnorm(x, scale, c):
    rms = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + 1e-6)
    return c(c(x * rms) * c(scale))


def _rope(x, theta):
    b, s, h, d = x.shape
    pos = torch.arange(s, device=x.device, dtype=torch.float32)
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = pos[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(b, s, h, d)


def _attention(x, w, i, cfg, c):
    b, s, D = x.shape
    H = cfg["n_heads"]
    qkv = c(c(x) @ c(w["layers.wqkv"][i]))
    q, k, v = (t.reshape(b, s, H, D // H) for t in qkv.split(D, dim=-1))
    q, k = c(_rope(q, cfg["rope_theta"])), c(_rope(k, cfg["rope_theta"]))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (D // H) ** -0.5
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
    p = torch.softmax(scores.masked_fill(~mask, _NEG), dim=-1)
    out = c(torch.einsum("bhqk,bkhd->bqhd", c(p), v)).reshape(b, s, D)
    return c(out @ c(w["layers.wo"][i]))


def _ffn(x, w, i, c):
    h = c(F.gelu(c(x @ c(w["layers.w1"][i])), approximate="tanh"))
    return c(h @ c(w["layers.w2"][i]))


def loss(w: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg: dict,
         cast: Optional[Callable] = None, rows: Optional[slice] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` ``[B, S]`` (of the rows
    ``rows`` only, when given)."""
    c = cast or _identity
    if rows is not None:
        tokens = tokens[rows]
    x = c(F.embedding(tokens, w["embed"]))
    for i in range(cfg["n_layers"]):
        x = c(x + _attention(_rmsnorm(x, w["layers.ln1"][i], c), w, i, cfg, c))
        x = c(x + _ffn(_rmsnorm(x, w["layers.ln2"][i], c), w, i, c))
    logits = _rmsnorm(x, w["ln_f"], c) @ c(w["unembed"])
    logp = F.log_softmax(logits[:, :-1], dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None]).mean()


def _adam(step: int, params, grads, mus, nus, lr: float) -> None:
    bc1, bc2 = 1.0 - ADAM_B1 ** step, 1.0 - ADAM_B2 ** step
    with torch.no_grad():
        for p, g, mu, nu in zip(params, grads, mus, nus):
            mu.mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
            nu.mul_(ADAM_B2).add_((1 - ADAM_B2) * g * g)
            p.sub_(lr * (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS))


def train(cfg: dict, weights: Dict[str, torch.Tensor], batches, lr: float,
          cast: Optional[Callable] = None, rows: Optional[slice] = None) -> dict:
    """Adam steps over ``batches`` from ``weights`` (updated in place, in
    float32 with TF32 off). Returns each step's loss, the first step's
    gradient norm per leaf, and each leaf's change norm after the last
    step."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        names = list(weights)
        start = {n: weights[n].clone() for n in names}
        params = [weights[n].requires_grad_(True) for n in names]
        mus = [torch.zeros_like(p) for p in params]
        nus = [torch.zeros_like(p) for p in params]
        losses, grad_norms = [], {}
        for step, tokens in enumerate(batches, start=1):
            value = loss(weights, tokens, cfg, cast, rows)
            grads = torch.autograd.grad(value, params)
            losses.append(value.item())
            if step == 1:
                grad_norms = {n: _norm(g) for n, g in zip(names, grads)}
            _adam(step, params, grads, mus, nus, lr)
            del value, grads
        change = {n: _norm(weights[n].detach() - start[n]) for n in names}
        for p in params:
            p.requires_grad_(False)
        return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _norm(t: torch.Tensor) -> float:
    return torch.linalg.vector_norm(t.detach(), dtype=torch.float64).item()
