"""Flagship decoder transformer — the dense, single-device configuration.

Counterpart of tpusnap/models/transformer.py (``TransformerConfig``,
``Transformer``, the Adam ``train_step`` and ``init_train_state``) as an
``nn.Module``. It keeps the JAX model's STACKED layout: every layer
parameter carries a leading ``n_layers`` dim, under the same names
(``embed``, ``layers.{ln1,ln2,wqkv,wo,w1,w2}``, ``ln_f``, ``unembed``), so
``train_state()`` flattens to the same logical paths as tpusnap's
``PytreeState(init_train_state(...))`` and a snapshot of either restores
into the other. ``lax.scan`` over the layers becomes a Python loop over
layer slices.

Numerics follow the JAX model: bf16 compute with f32 params and Adam
moments; ``gelu`` with the tanh approximation (JAX's default); RoPE on
interleaved even/odd lanes; RMSNorm in f32, cast, then scaled; the
unembedding accumulated and returned in f32 from bf16 operands. The
attention forward runs the Hopper flash kernel for CUDA tensors
(``attention_impl="auto"`` or ``"flash"``) and the plain version for CPU
tensors or ``"reference"``.

Entry points run on the card: ``Transformer(cfg)`` places its parameters
on ``cuda`` and raises when CUDA is absent; pass ``device="cpu"`` to run
on the CPU. MoE FFNs (``n_experts > 0``, ROADMAP.md item A7) and ring
attention (item B3) are later slices and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention, flash_attention_reference

_LAYER_KEYS = ("ln1", "ln2", "wqkv", "wo", "w1", "w2")
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq_len: int = 1024
    n_experts: int = 0
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32
    use_ring_attention: bool = False
    # "auto"/"flash": the Hopper kernel for CUDA tensors, the plain version
    # for CPU tensors; "reference": the plain version everywhere.
    attention_impl: str = "auto"
    rope_theta: float = 10000.0

    def __post_init__(self) -> None:
        if self.attention_impl not in ("auto", "flash", "reference"):
            raise ValueError(f"unknown attention_impl: {self.attention_impl!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _resolve_device(device) -> torch.device:
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Transformer runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return device


class Transformer(nn.Module):
    """Parameters, forward, loss and the Adam train step of the flagship
    model. The module owns its Adam state (``train_state()["opt"]``)."""

    def __init__(
        self, config: TransformerConfig, device=None, seed: int = 0
    ) -> None:
        super().__init__()
        if config.n_experts:
            raise NotImplementedError(
                "MoE FFNs (n_experts > 0) are not ported yet (ROADMAP.md item A7)"
            )
        if config.use_ring_attention:
            raise NotImplementedError(
                "ring attention is not ported yet (ROADMAP.md item B3)"
            )
        if config.d_model % config.n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        self.config = config
        device = _resolve_device(device)
        cfg = config
        L, D, Fd, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
        gen = torch.Generator().manual_seed(seed)

        def norm(*shape, fan_in):
            w = torch.randn(shape, generator=gen, dtype=cfg.param_dtype) * fan_in**-0.5
            return nn.Parameter(w.to(device))

        def ones(*shape):
            return nn.Parameter(torch.ones(shape, dtype=cfg.param_dtype, device=device))

        self.embed = norm(V, D, fan_in=D)
        self.layers = nn.ParameterDict(
            {
                "ln1": ones(L, D),
                "ln2": ones(L, D),
                "wqkv": norm(L, D, 3 * D, fan_in=D),
                "wo": norm(L, D, D, fan_in=D),
                "w1": norm(L, D, Fd, fan_in=D),
                "w2": norm(L, Fd, D, fan_in=Fd),
            }
        )
        self.ln_f = ones(D)
        self.unembed = norm(D, V, fan_in=D)

        def zeros_like_params():
            return _map_tree(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=device),
                self.params(),
            )

        self.opt_state: Dict[str, Any] = {
            "mu": zeros_like_params(),
            "nu": zeros_like_params(),
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    # ------------------------------------------------------------- state

    def params(self) -> Dict[str, Any]:
        """The parameters as the JAX model's nested dict — the same
        ``nn.Parameter`` objects, not copies."""
        return {
            "embed": self.embed,
            "layers": {k: self.layers[k] for k in _LAYER_KEYS},
            "ln_f": self.ln_f,
            "unembed": self.unembed,
        }

    def train_state(self) -> Dict[str, Any]:
        """``{"params", "opt": {"mu", "nu", "step"}}`` of the tensors the
        module and its optimizer own — checkpoint it as
        ``StateDict(**model.train_state())``."""
        return {"params": self.params(), "opt": self.opt_state}

    def params_from_jax(self, tree: Dict[str, Any]) -> None:
        """Load JAX parameters (a dict of numpy arrays with the JAX
        names, e.g. ``jax.tree.map(np.asarray, model.init(key))``) into
        this module, in place, on its device."""
        _copy_tree(tree, self.params(), "params")

    def train_state_from_jax(self, tree: Dict[str, Any]) -> None:
        """Load a JAX train state ``{"params", "opt": {"mu", "nu",
        "step"}}`` of numpy arrays into the parameters and Adam state."""
        _copy_tree(tree, self.train_state(), "")

    # ----------------------------------------------------------- forward

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits ``[batch, seq, vocab]`` in f32."""
        cfg = self.config
        x = F.embedding(tokens, self.embed).to(cfg.dtype)
        for i in range(cfg.n_layers):
            lp = {k: self.layers[k][i] for k in _LAYER_KEYS}
            x = x + self._attention(lp, _rmsnorm(x, lp["ln1"]))
            x = x + self._ffn(lp, _rmsnorm(x, lp["ln2"]))
        x = _rmsnorm(x, self.ln_f)
        # bf16 operands, products and sums in f32 (the JAX einsum's
        # preferred_element_type=f32): bf16 values are exact in f32.
        return x.float() @ self.unembed.to(cfg.dtype).float()

    def _attention(self, lp, x):
        cfg = self.config
        b, s, _ = x.shape
        qkv = x @ lp["wqkv"].to(cfg.dtype)
        shape = (b, s, cfg.n_heads, cfg.head_dim)
        q, k, v = (t.reshape(shape) for t in qkv.split(cfg.d_model, dim=-1))
        q = _rope(q, cfg.rope_theta)
        k = _rope(k, cfg.rope_theta)
        if cfg.attention_impl == "reference":
            out = flash_attention_reference(q, k, v, causal=True)
        else:
            out = flash_attention(q, k, v, causal=True)
        return out.reshape(b, s, cfg.d_model) @ lp["wo"].to(cfg.dtype)

    def _ffn(self, lp, x):
        dtype = self.config.dtype
        h = F.gelu(x @ lp["w1"].to(dtype), approximate="tanh")
        return h @ lp["w2"].to(dtype)

    def loss(self, tokens: torch.Tensor) -> torch.Tensor:
        """Next-token cross-entropy (the last position predicts nothing)."""
        logits = self(tokens)
        logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -logp.gather(-1, tokens[:, 1:, None])[..., 0]
        return nll.mean()

    # ---------------------------------------------------------- training

    def train_step(self, tokens: torch.Tensor, learning_rate: float = 1e-3) -> torch.Tensor:
        """One Adam step, in place on the parameters and moments (their
        identity is kept); returns the loss before the update. Matches
        tpusnap's ``make_train_step``: ``step`` is incremented before the
        bias corrections, moments are f32, params cast back."""
        leaves = _tree_leaves(self.params())
        loss = self.loss(tokens)
        grads = torch.autograd.grad(loss, leaves)
        b1, b2, eps = _ADAM_B1, _ADAM_B2, _ADAM_EPS
        with torch.no_grad():
            step = self.opt_state["step"]
            step.add_(1)
            bc1 = 1.0 - b1 ** step.float()
            bc2 = 1.0 - b2 ** step.float()
            mus = _tree_leaves(self.opt_state["mu"])
            nus = _tree_leaves(self.opt_state["nu"])
            for p, g, mu, nu in zip(leaves, grads, mus, nus):
                g = g.float()
                mu.copy_(b1 * mu + (1 - b1) * g)
                nu.copy_(b2 * nu + (1 - b2) * g * g)
                p_new = p.float() - learning_rate * (mu / bc1) / (
                    torch.sqrt(nu / bc2) + eps
                )
                p.copy_(p_new.to(p.dtype))
        return loss.detach()


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (xf * rms).to(x.dtype) * scale.to(x.dtype)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over global positions, on INTERLEAVED lanes
    (``x[..., 0::2]``, ``x[..., 1::2]`` stacked back on the last axis), as
    the JAX model does — not the half-split layout."""
    b, s, h, d = x.shape
    pos = torch.arange(s, device=x.device, dtype=torch.float32)
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = pos[:, None] * freqs[None, :]  # [s, d/2]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(b, s, h, d).to(x.dtype)


# ------------------------------------------------------------ tree helpers


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _tree_leaves(tree[k])]
    return [tree]


def _copy_tree(src: Any, dst: Any, path: str) -> None:
    """Named copy of a tree of numpy arrays into a same-shaped tree of
    tensors; raises on a missing, extra or misshapen leaf."""
    if isinstance(dst, dict):
        if not isinstance(src, dict):
            raise ValueError(f"{path or '<root>'}: expected a dict, got {type(src).__name__}")
        missing = sorted(set(dst) - set(src))
        extra = sorted(set(src) - set(dst))
        if missing or extra:
            raise KeyError(
                f"{path or '<root>'}: missing {missing}, unexpected {extra}"
            )
        for k in dst:
            _copy_tree(src[k], dst[k], f"{path}/{k}" if path else k)
        return
    # A writable C-ordered copy (np.ascontiguousarray would turn a 0-d
    # array into shape (1,)).
    value = torch.from_numpy(np.array(src, order="C", copy=True))
    if tuple(value.shape) != tuple(dst.shape) or value.dtype != dst.dtype:
        raise ValueError(
            f"{path}: got {value.dtype}{list(value.shape)}, expected "
            f"{dst.dtype}{list(dst.shape)}"
        )
    with torch.no_grad():
        dst.copy_(value)
