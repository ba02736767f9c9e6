"""Flagship decoder transformer — dense or MoE, with its sharded layouts.

Counterpart of tpusnap/models/transformer.py (``TransformerConfig``,
``Transformer``, ``param_specs``, ``make_mesh``, the Adam ``train_step``
and ``init_train_state``) as an ``nn.Module``. It keeps the JAX model's
STACKED layout: every layer parameter carries a leading ``n_layers`` dim,
under the same names (``embed``, ``layers.{ln1,ln2,wqkv,wo}`` and
``layers.{w1,w2}`` or, with ``n_experts > 0``, ``layers.{router,w1e,w2e}``,
``ln_f``, ``unembed``), so ``train_state()`` flattens to the same logical
paths as tpusnap's ``PytreeState(init_train_state(...))`` and a snapshot
of either restores into the other. ``lax.scan`` over the layers becomes a
Python loop over layer slices.

Numerics follow the JAX model: bf16 compute with f32 params and Adam
moments; ``gelu`` with the tanh approximation (JAX's default); RoPE on
interleaved even/odd lanes; RMSNorm in f32, cast, then scaled; the
unembedding accumulated and returned in f32 from bf16 operands. The MoE
FFN is tpusnap's dense soft routing: softmax gates from the router, every
expert applied to every token, the outputs summed by gate, all in the
compute dtype. The attention forward runs the Hopper flash kernel for
CUDA tensors (``attention_impl="auto"`` or ``"flash"``) and the plain
version for CPU tensors or ``"reference"``. With ``use_ring_attention``
it runs ``ops.ring_attention`` instead: one block through the ring block
kernel, or, given a ``ring_group`` (a ``torch.distributed`` group), this
rank's contiguous block of the sequence against every rank's K/V, with
RoPE on global positions and the next-token loss taken across the
blocks' boundaries (sequence parallelism, tpusnap's ``shard_map`` over
``"fsdp"``), forward and backward.

Layouts: ``param_specs()`` are tpusnap's ``PartitionSpec``s as tuples
over a ``("data", "fsdp", "tensor")`` mesh (dp: replicated norms; fsdp
and tp: the matmul weights; ep: the expert dim over ``"data"``), and
``param_placements()`` the same as DTensor placements
(``models/layout.py``). ``init_train_state(model, mesh)`` gives the train
state as DTensors whose local tensors are this rank's boxes;
``train_state_views`` gives them as views of the module's own tensors,
for a replica trained on every rank.

Training: ``make_train_step(model)`` is one replica's Adam step;
``make_train_step(model, mesh)`` is tpusnap's SPMD step over the mesh
(``ShardedTrainStep``): ``step(state, tokens) -> loss`` with the global
batch, each rank taking its shard by tpusnap's token spec and updating
its boxes of the state in place. Its collectives run over gloo through
pinned host buffers (``models/layout.py``), so ranks may share one card;
NCCL with one card per rank is the open transport (ROADMAP.md item
A10b).

Entry points run on the card: ``Transformer(cfg)`` places its parameters
on ``cuda`` and raises when CUDA is absent; pass ``device="cpu"`` to run
on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention, flash_attention_reference
from ..ops.ring_attention import ring_attention
from .layout import make_mesh, map_specs, shard_tree, spec_placements

__all__ = [
    "ShardedTrainStep",
    "Transformer",
    "TransformerConfig",
    "init_train_state",
    "make_mesh",
    "make_train_step",
    "train_state_placements",
    "train_state_specs",
    "train_state_views",
]
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
        layers = {
            "ln1": ones(L, D),
            "ln2": ones(L, D),
            "wqkv": norm(L, D, 3 * D, fan_in=D),
            "wo": norm(L, D, D, fan_in=D),
        }
        if cfg.n_experts:
            E = cfg.n_experts
            layers["router"] = norm(L, D, E, fan_in=D)
            layers["w1e"] = norm(L, E, D, Fd, fan_in=D)
            layers["w2e"] = norm(L, E, Fd, D, fan_in=Fd)
        else:
            layers["w1"] = norm(L, D, Fd, fan_in=D)
            layers["w2"] = norm(L, Fd, D, fan_in=Fd)
        self.layer_keys = tuple(layers)
        self.layers = nn.ParameterDict(layers)
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
            "layers": {k: self.layers[k] for k in self.layer_keys},
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

    # ----------------------------------------------------------- layouts

    def param_specs(self) -> Dict[str, Any]:
        """tpusnap's ``param_specs()`` as tuples: per tensor dim, the mesh
        axis (or axes) of a ``("data", "fsdp", "tensor")`` mesh that shards
        it, or None."""
        specs: Dict[str, Any] = {
            "embed": ("fsdp", "tensor"),
            "layers": {
                "ln1": (None, None),
                "ln2": (None, None),
                "wqkv": (None, "fsdp", "tensor"),
                "wo": (None, "tensor", "fsdp"),
            },
            "ln_f": (None,),
            "unembed": ("tensor", "fsdp"),
        }
        if self.config.n_experts:
            specs["layers"]["router"] = (None, "fsdp", None)
            # Expert dim over "data": expert parallelism.
            specs["layers"]["w1e"] = (None, "data", "fsdp", "tensor")
            specs["layers"]["w2e"] = (None, "data", "tensor", "fsdp")
        else:
            specs["layers"]["w1"] = (None, "fsdp", "tensor")
            specs["layers"]["w2"] = (None, "tensor", "fsdp")
        return specs

    def param_placements(self) -> Dict[str, Any]:
        """``param_specs()`` as DTensor placements over a
        ``("data", "fsdp", "tensor")`` mesh."""
        return map_specs(spec_placements, self.param_specs())

    # ----------------------------------------------------------- forward

    def forward(self, tokens: torch.Tensor, ring_group=None) -> torch.Tensor:
        """Logits ``[batch, seq, vocab]`` in f32. With ``ring_group`` (needs
        ``use_ring_attention``), ``tokens`` is this rank's contiguous block
        of the sequence (rank r holds positions ``r * seq ...``) and the
        logits are the block's."""
        cfg = self.config
        offset = 0
        if ring_group is not None:
            if not cfg.use_ring_attention:
                raise ValueError("ring_group needs TransformerConfig(use_ring_attention=True)")
            import torch.distributed as dist

            offset = dist.get_rank(ring_group) * tokens.shape[1]
        x = F.embedding(tokens, self.embed).to(cfg.dtype)
        for i in range(cfg.n_layers):
            lp = {k: self.layers[k][i] for k in self.layer_keys}
            x = x + self._attention(lp, _rmsnorm(x, lp["ln1"]), offset, ring_group)
            x = x + self._ffn(lp, _rmsnorm(x, lp["ln2"]))
        x = _rmsnorm(x, self.ln_f)
        # bf16 operands, products and sums in f32 (the JAX einsum's
        # preferred_element_type=f32): bf16 values are exact in f32.
        return x.float() @ self.unembed.to(cfg.dtype).float()

    def _attention(self, lp, x, offset, ring_group):
        cfg = self.config
        b, s, _ = x.shape
        qkv = x @ lp["wqkv"].to(cfg.dtype)
        shape = (b, s, cfg.n_heads, cfg.head_dim)
        q, k, v = (t.reshape(shape) for t in qkv.split(cfg.d_model, dim=-1))
        q = _rope(q, cfg.rope_theta, offset)
        k = _rope(k, cfg.rope_theta, offset)
        if cfg.use_ring_attention:
            out = ring_attention(q, k, v, group=ring_group, causal=True)
        elif cfg.attention_impl == "reference":
            out = flash_attention_reference(q, k, v, causal=True)
        else:
            out = flash_attention(q, k, v, causal=True)
        return out.reshape(b, s, cfg.d_model) @ lp["wo"].to(cfg.dtype)

    def _ffn(self, lp, x):
        dtype = self.config.dtype
        if not self.config.n_experts:
            h = F.gelu(x @ lp["w1"].to(dtype), approximate="tanh")
            return h @ lp["w2"].to(dtype)
        # Dense soft routing: every token weighted over all experts.
        gates = torch.softmax(x @ lp["router"].to(dtype), dim=-1)
        h = F.gelu(torch.einsum("bsd,edf->bsef", x, lp["w1e"].to(dtype)), approximate="tanh")
        out = torch.einsum("bsef,efd->bsed", h, lp["w2e"].to(dtype))
        return torch.einsum("bsed,bse->bsd", out, gates)

    def loss(self, tokens: torch.Tensor, ring_group=None) -> torch.Tensor:
        """Next-token cross-entropy (the last position predicts nothing).
        With ``ring_group``, ``tokens`` is this rank's block: each rank
        scores its positions against the globally shifted targets (its
        last position against the next rank's first token; the last rank
        drops its last position) and every rank returns the mean over the
        whole sequence, whose gradient is this rank's share: the sum of the
        ranks' gradients is the gradient of the mean."""
        logits = self(tokens, ring_group)
        if ring_group is None:
            logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
            nll = -logp.gather(-1, tokens[:, 1:, None])[..., 0]
            return nll.mean()
        import torch.distributed as dist

        n, rank = dist.get_world_size(ring_group), dist.get_rank(ring_group)
        b, s = tokens.shape
        # Through the host: gloo takes no CUDA tensors.
        firsts = [torch.empty((b, 1), dtype=tokens.dtype) for _ in range(n)]
        dist.all_gather(firsts, tokens[:, :1].cpu().contiguous(), group=ring_group)
        if rank < n - 1:
            targets = torch.cat([tokens[:, 1:], firsts[rank + 1].to(tokens.device)], dim=1)
        else:
            targets, logits = tokens[:, 1:], logits[:, :-1]
        logp = F.log_softmax(logits.float(), dim=-1)
        nll_sum = -logp.gather(-1, targets[..., None])[..., 0].sum()
        denom = b * (n * s - 1)
        total = nll_sum.detach().double().cpu().reshape(1)
        dist.all_reduce(total, group=ring_group)
        value = (total[0] / denom).float().to(tokens.device)
        if not nll_sum.requires_grad:
            return value
        # The group's mean as the value, this rank's share of it as the
        # gradient: local - local.detach() is exactly 0.
        local = nll_sum / denom
        return value + (local - local.detach())

    # ---------------------------------------------------------- training

    def train_step(self, tokens: torch.Tensor, learning_rate: float = 1e-3) -> torch.Tensor:
        """One Adam step, in place on the parameters and moments (their
        identity is kept); returns the loss before the update. Matches
        tpusnap's ``make_train_step``: ``step`` is incremented before the
        bias corrections, moments are f32, params cast back."""
        leaves = _tree_leaves(self.params())
        loss = self.loss(tokens)
        grads = torch.autograd.grad(loss, leaves)
        _adam(self.opt_state["step"], leaves, grads, _tree_leaves(self.opt_state["mu"]),
              _tree_leaves(self.opt_state["nu"]), learning_rate)
        return loss.detach()


def make_train_step(model: Transformer, mesh=None, learning_rate: float = 1e-3):
    """tpusnap's ``make_train_step`` for the port.

    Without ``mesh``: ``step(tokens) -> loss``, one Adam step of ``model``
    in place (tpusnap's returns a new state; here the module's tensors are
    updated). With a ``("data", "fsdp", "tensor")`` ``DeviceMesh``:
    ``step(state, tokens) -> loss`` (``ShardedTrainStep``), ``state`` from
    ``init_train_state(model, mesh)``, updated in place."""
    if mesh is None:
        return functools.partial(model.train_step, learning_rate=learning_rate)
    return ShardedTrainStep(model, mesh, learning_rate)


class ShardedTrainStep:
    """tpusnap's SPMD Adam step over a ``("data", "fsdp", "tensor")`` mesh
    of ranks: ``step(state, tokens) -> loss``.

    ``tokens`` is the global batch ``[B, S]`` on every rank; each rank takes
    its shard by tpusnap's token spec: ``P("data", "fsdp")`` with ring
    attention (rows over data, the sequence over fsdp: context
    parallelism through ``ops.ring_attention`` on the fsdp group),
    ``P(("data", "fsdp"), None)`` without (rows over data x fsdp). The
    step:

    1. gathers the full parameters from the state's boxes
       (``layout.gather_full``) into ``model``, the step's workspace;
    2. takes this rank's share of the gradient of the global mean loss
       (its rows' mean times their share of the batch; with ring
       attention, the ring group's mean, whose gradient is this rank's
       share, ``Transformer.loss``);
    3. sums the gradients over the data x fsdp group;
    4. applies Adam elementwise to this rank's boxes of the params and
       moments, in place, as ``Transformer.train_step`` does (f32 moments,
       ``step`` incremented before the bias corrections).

    The tensor axis computes redundantly: ranks that differ only in their
    ``tensor`` coordinate hold the same tokens and the same full
    parameters, compute the same gradient, and each reduces only over its
    own data x fsdp group, so no token is counted twice; each then updates
    its own boxes, which the tensor axis splits (tpusnap splits the heads
    over it instead: the same function). The expert dim of the MoE weights
    rides ``data`` through the state's layout. At mesh ``(1, 1, 1)`` the
    step is ``Transformer.train_step`` bit for bit.

    ``timed = True`` synchronises the device at each stage and records
    their wall seconds in ``split`` (``gather``, ``forward``, ``backward``,
    ``reduce``, ``update``); ``keep_grads = True`` keeps the last step's
    full reduced gradients in ``grads`` (a dict by parameter path)."""

    def __init__(self, model: Transformer, mesh, learning_rate: float = 1e-3) -> None:
        from .layout import mesh_groups

        self.model, self.mesh, self.learning_rate = model, mesh, learning_rate
        names = list(mesh.mesh_dim_names)
        if names != ["data", "fsdp", "tensor"]:
            raise ValueError(f"the mesh's dims are {names}, not data, fsdp, tensor")
        self.data, self.fsdp, _ = (int(x) for x in mesh.mesh.shape)
        # Every rank builds every group, in this order.
        self.world_group = mesh_groups(mesh, ("data", "fsdp", "tensor"))
        self.batch_group = mesh_groups(mesh, ("data", "fsdp"))
        self.data_group = mesh_groups(mesh, ("data",))
        self.ring_group = mesh_groups(mesh, ("fsdp",))
        self.timed = False
        self.keep_grads = False
        self.split: Dict[str, float] = {}
        self.grads: Dict[str, torch.Tensor] = {}

    def _shard(self, tokens: torch.Tensor) -> torch.Tensor:
        d, f, _ = self.mesh.get_coordinate()
        B, S = tokens.shape
        if self.model.config.use_ring_attention:
            rows, cols = _even(B, self.data, "batch", "data"), _even(S, self.fsdp, "sequence", "fsdp")
            return tokens[d * rows:(d + 1) * rows, f * cols:(f + 1) * cols].contiguous()
        rows = _even(B, self.data * self.fsdp, "batch", "data x fsdp")
        i = d * self.fsdp + f
        return tokens[i * rows:(i + 1) * rows].contiguous()

    def _mark(self, stage: Optional[str], t0: float) -> float:
        """With ``timed``: wait for the device, record ``stage``'s seconds
        since ``t0`` (none for the first mark) and return the time."""
        if not self.timed:
            return t0
        if self.model.embed.is_cuda:
            torch.cuda.synchronize(self.model.embed.device)
        now = time.perf_counter()
        if stage is not None:
            self.split[stage] = now - t0
        return now

    def __call__(self, state: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        from .layout import _leaves, gather_full, local_slice, sum_across

        model, cfg = self.model, self.model.config
        ring = cfg.use_ring_attention
        t = self._mark(None, 0.0)
        full = gather_full(state["params"], self.world_group)
        leaves = _tree_leaves(model.params())
        with torch.no_grad():
            for p, value in zip(leaves, _tree_leaves(full)):
                p.copy_(value)
        del full
        t = self._mark("gather", t)
        mine = self._shard(tokens)
        part = model.loss(mine, self.ring_group if ring and self.fsdp > 1 else None)
        share = mine.shape[0] / tokens.shape[0]
        if share != 1:
            part = part * share
        t = self._mark("forward", t)
        grads = list(torch.autograd.grad(part, leaves))
        t = self._mark("backward", t)
        sum_across(grads, self.batch_group)
        loss = part.detach()
        # A ring's ranks hold one value between them; without a ring each
        # rank of data x fsdp holds its own rows'.
        value_group = self.data_group if ring else self.batch_group
        if dist.get_world_size(value_group) > 1:
            total = loss.double().cpu().reshape(1)
            dist.all_reduce(total, group=value_group)
            loss = total[0].float().to(loss.device)
        t = self._mark("reduce", t)
        if self.keep_grads:
            self.grads = {path: g for (path, _), g in zip(_leaves(model.params()), grads)}
        params = _tree_leaves(state["params"])
        _adam(state["opt"]["step"].to_local(), [p.to_local() for p in params],
              [local_slice(g, p) for g, p in zip(grads, params)],
              [mu.to_local() for mu in _tree_leaves(state["opt"]["mu"])],
              [nu.to_local() for nu in _tree_leaves(state["opt"]["nu"])], self.learning_rate)
        self._mark("update", t)
        return loss


def _adam(step, params, grads, mus, nus, learning_rate: float) -> None:
    """tpusnap's Adam update, in place: ``step`` incremented before the
    bias corrections, f32 moments, params cast back to their dtype."""
    b1, b2, eps = _ADAM_B1, _ADAM_B2, _ADAM_EPS
    with torch.no_grad():
        step.add_(1)
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()
        for p, g, mu, nu in zip(params, grads, mus, nus):
            g = g.float()
            mu.copy_(b1 * mu + (1 - b1) * g)
            nu.copy_(b2 * nu + (1 - b2) * g * g)
            p_new = p.float() - learning_rate * (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            p.copy_(p_new.to(p.dtype))


def _even(n: int, k: int, what: str, axes: str) -> int:
    if n % k:
        raise ValueError(f"the {what} ({n}) does not split evenly over {axes} ({k})")
    return n // k


def train_state_specs(model: Transformer) -> Dict[str, Any]:
    """The train state's specs: Adam moments as their params, the step
    replicated."""
    specs = model.param_specs()
    return {"params": specs, "opt": {"mu": specs, "nu": specs, "step": ()}}


def train_state_placements(model: Transformer) -> Dict[str, Any]:
    return map_specs(spec_placements, train_state_specs(model))


def init_train_state(model: Transformer, mesh) -> Dict[str, Any]:
    """The module's train state as DTensors over ``mesh`` (a
    ``("data", "fsdp", "tensor")`` ``DeviceMesh``) whose local tensors are
    contiguous copies of this rank's boxes."""
    return shard_tree(model.train_state(), train_state_placements(model), mesh, views=False)


def train_state_views(model: Transformer, mesh) -> Dict[str, Any]:
    """The module's train state as DTensors over ``mesh`` whose local
    tensors are views of this rank's boxes of the module's own tensors: a
    replica trained in place is snapshotted at the layout, and a restore
    lands in the module."""
    return shard_tree(model.train_state(), train_state_placements(model), mesh, views=True)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (xf * rms).to(x.dtype) * scale.to(x.dtype)


def _rope(x: torch.Tensor, theta: float, offset: int = 0) -> torch.Tensor:
    """Rotary embedding over global positions (``offset`` is the first
    one: a ring rank's block starts past the ranks before it), on
    INTERLEAVED lanes (``x[..., 0::2]``, ``x[..., 1::2]`` stacked back on
    the last axis), as the JAX model does — not the half-split layout."""
    b, s, h, d = x.shape
    pos = torch.arange(offset, offset + s, device=x.device, dtype=torch.float32)
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
