"""Embedding-table collection — the torchrec/DMP model family.

Counterpart of tpusnap/models/embedding.py (``TableConfig``,
``EmbeddingCollection``, ``param_specs``, the row-wise Adagrad step of
``make_embedding_train_step`` and ``rand_features``). The collection
owns its tables and their Adagrad accumulators under tpusnap's tree,
``{"tables": {name: [V, D]}, "opt": {name: [V]}}``; same-shape
table-wise tables stack into one ``group_{V}x{D}`` leaf ``[T, V, D]``
(accumulator ``[T, V]``), so ``params()`` flattens to tpusnap's logical
paths and a snapshot of either package restores into the other.

- **Layouts**: ``param_specs()`` are tpusnap's specs as tuples over the
  ``("data", "fsdp", "tensor")`` mesh — ``row`` shards the vocab dim over
  ``("fsdp", "tensor")``, ``col`` the embedding dim, ``table`` the stacked
  table dim, ``replicated`` nothing; an accumulator shards with the vocab
  dim of its table. ``param_placements()`` gives them as DTensor
  placements and ``shard_params(mesh)`` the collection's own tensors as
  DTensors at that layout (``models/layout.py``).
- **Host-offloaded tables** (``host_offload=True``, the UVM analog): the
  table AND its accumulator are pinned CPU tensors
  (``host_offload.to_host_offload``). A snapshot stages them as views of
  themselves, with no device-to-host copy. A lookup gathers the bag's
  rows on the host and moves only those rows to the card; the update
  touches only the rows that received a gradient, on the host. Sharded,
  such a table is a DTensor over a ``"cpu"`` mesh of the same ranks
  (``shard_params(mesh, host_mesh=...)``).
- **Row-wise Adagrad** (the fused-optimizer analog), in place:
  ``acc += mean(g², -1)``, ``w -= lr·g·rsqrt(acc + eps)`` for every row
  that received a gradient. A row with ``g = 0`` would keep its weight
  and accumulator under tpusnap's dense update, so updating only the
  touched rows gives the same state.

Lookups are fixed-size bags with ``-1`` padding: the rows of
``max(ids, 0)``, masked by ``ids >= 0``, summed or averaged per bag and
concatenated per sample. Entry points run on the card: the collection
places its device tables on ``cuda`` and raises when CUDA is absent;
pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..host_offload import to_host_offload
from .layout import map_specs, shard_tree, spec_placements
from .transformer import _copy_tree, _resolve_device

_SHARDINGS = ("row", "col", "table", "replicated")
_ADAGRAD_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """One embedding table: ``[num_embeddings, embedding_dim]``."""

    name: str
    num_embeddings: int
    embedding_dim: int
    sharding: str = "row"  # row | col | table | replicated
    host_offload: bool = False  # UVM analog: pinned host memory
    pooling: str = "sum"  # sum | mean over each bag

    def __post_init__(self) -> None:
        if self.sharding not in _SHARDINGS:
            raise ValueError(f"unknown sharding {self.sharding!r}")
        if self.pooling not in ("sum", "mean"):
            raise ValueError(f"unknown pooling {self.pooling!r}")


class EmbeddingCollection:
    """Tables, lookups, loss and the row-wise Adagrad step. Features are
    ``{table_name: int [batch, bag]}`` with ``-1`` padding."""

    def __init__(self, tables: List[TableConfig], device=None, seed: int = 0) -> None:
        names = [t.name for t in tables]
        if len(set(names)) != len(names):
            raise ValueError("duplicate table names")
        for n in names:
            if n.startswith("group_"):
                raise ValueError(
                    f"table name {n!r} uses the reserved 'group_' prefix "
                    "(table-wise groups are stored under group_{V}x{D} keys)"
                )
        self.tables = list(tables)
        self.device = _resolve_device(device)
        self._groups: Dict[str, List[TableConfig]] = {}
        for t in tables:
            if t.sharding == "table":
                self._groups.setdefault(self._group_key(t), []).append(t)
        gen = torch.Generator().manual_seed(seed)
        self._params: Dict[str, Dict[str, torch.Tensor]] = {"tables": {}, "opt": {}}
        for t in self.tables:
            if t.sharding != "table":
                self._add(t.name, (t.num_embeddings, t.embedding_dim), t.host_offload, gen)
        for gkey, members in self._groups.items():
            V, D = members[0].num_embeddings, members[0].embedding_dim
            offload = any(m.host_offload for m in members)
            self._add(gkey, (len(members), V, D), offload, gen)

    @staticmethod
    def _group_key(t: TableConfig) -> str:
        # no punctuation: the key becomes a snapshot logical-path segment
        return f"group_{t.num_embeddings}x{t.embedding_dim}"

    def _add(self, key: str, shape: Tuple[int, ...], offload: bool, gen) -> None:
        w = torch.randn(shape, generator=gen, dtype=torch.float32) * shape[-1] ** -0.5
        acc = torch.zeros(shape[:-1], dtype=torch.float32)
        if offload:
            w, acc = to_host_offload(w), to_host_offload(acc)
        else:
            w, acc = w.to(self.device), acc.to(self.device)
        self._params["tables"][key] = w
        self._params["opt"][key] = acc

    # ------------------------------------------------------------- state

    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{"tables", "opt"}``: the tensors the collection owns, not
        copies — checkpoint them as ``PytreeState(model.params())``."""
        return self._params

    def params_from_jax(self, tree: Dict[str, Any]) -> None:
        """Load tpusnap's params (a tree of numpy arrays, e.g.
        ``jax.tree.map(np.asarray, model.init(key))``) in place."""
        _copy_tree(tree, self._params, "")

    # ----------------------------------------------------------- layouts

    def param_specs(self) -> Dict[str, Any]:
        """tpusnap's ``param_specs()`` as tuples over a
        ``("data", "fsdp", "tensor")`` mesh."""
        specs: Dict[str, Any] = {"tables": {}, "opt": {}}
        model_axes = ("fsdp", "tensor")
        for t in self.tables:
            if t.sharding == "row":
                specs["tables"][t.name] = (model_axes, None)
                specs["opt"][t.name] = (model_axes,)
            elif t.sharding == "col":
                specs["tables"][t.name] = (None, model_axes)
                specs["opt"][t.name] = (None,)
            elif t.sharding == "replicated":
                specs["tables"][t.name] = (None, None)
                specs["opt"][t.name] = (None,)
        for gkey in self._groups:
            specs["tables"][gkey] = (model_axes, None, None)
            specs["opt"][gkey] = (model_axes, None)
        return specs

    def param_placements(self) -> Dict[str, Any]:
        return map_specs(spec_placements, self.param_specs())

    def shard_params(self, mesh, host_mesh=None) -> Dict[str, Any]:
        """``params()`` as DTensors at ``param_placements()`` over
        ``mesh`` whose local tensors are views of this rank's boxes of the
        collection's own tensors, so a restore lands in the collection;
        host-offloaded tensors over ``host_mesh`` (a ``"cpu"`` mesh of the
        same ranks) when given."""
        return shard_tree(self._params, self.param_placements(), mesh, True, host_mesh)

    # ----------------------------------------------------------- forward

    def _table_weight(self, t: TableConfig) -> torch.Tensor:
        if t.sharding != "table":
            return self._params["tables"][t.name]
        return self._params["tables"][self._group_key(t)][self._group_index(t)]

    def _table_acc(self, t: TableConfig) -> torch.Tensor:
        if t.sharding != "table":
            return self._params["opt"][t.name]
        return self._params["opt"][self._group_key(t)][self._group_index(t)]

    def _group_index(self, t: TableConfig) -> int:
        return next(i for i, m in enumerate(self._groups[self._group_key(t)]) if m.name == t.name)

    def _gather(self, t: TableConfig, ids: torch.Tensor) -> torch.Tensor:
        """The rows of ``max(ids, 0)`` on the collection's device: a host
        table gathers them on the host and moves only them."""
        w = self._table_weight(t)
        idx = ids.clamp_min(0)
        if w.device == idx.device:
            return F.embedding(idx, w)
        rows = w.index_select(0, idx.reshape(-1).to(w.device))
        return rows.reshape(*idx.shape, w.shape[-1]).to(self.device)

    def apply(self, features: Dict[str, torch.Tensor], rows=None) -> torch.Tensor:
        """Pooled lookup per table, concatenated: ``[batch, sum(dims)]``.
        ``rows`` (by table name) replaces the gathered rows; the train
        step differentiates through them."""
        pooled = []
        for t in self.tables:
            ids = features[t.name]
            emb = rows[t.name] if rows is not None else self._gather(t, ids)
            mask = (ids >= 0).to(torch.float32)[..., None]
            agg = (emb * mask).sum(dim=1)
            if t.pooling == "mean":
                agg = agg / mask.sum(dim=1).clamp_min(1.0)
            pooled.append(agg)
        return torch.cat(pooled, dim=-1)

    def loss(self, features, targets, rows=None) -> torch.Tensor:
        """Squared error of the summed pooled embeddings against
        ``targets``."""
        out = self.apply(features, rows)
        return ((out.sum(dim=-1) - targets) ** 2).mean()

    # ---------------------------------------------------------- training

    def train_step(self, features, targets, learning_rate: float = 0.05) -> torch.Tensor:
        """One row-wise Adagrad step, in place on the tables and
        accumulators (their identity and pinned memory are kept); returns
        the loss before the update."""
        rows = {
            t.name: self._gather(t, features[t.name]).detach().requires_grad_()
            for t in self.tables
        }
        loss = self.loss(features, targets, rows)
        grads = torch.autograd.grad(loss, [rows[t.name] for t in self.tables])
        with torch.no_grad():
            for t, g in zip(self.tables, grads):
                self._adagrad_rows(t, features[t.name], g, learning_rate)
        return loss.detach()

    def _adagrad_rows(self, t: TableConfig, ids, g, learning_rate: float) -> None:
        """Sum the bag gradients of each touched row (deterministically),
        then update those rows where the table lives."""
        valid = ids >= 0
        touched, inverse = torch.unique(ids[valid].long(), return_inverse=True)
        g_rows = torch.zeros((touched.numel(), g.shape[-1]), dtype=g.dtype, device=g.device)
        # index_put_ with accumulate sums in a fixed order (sorted on the
        # card), so replicas trained on several ranks stay bitwise equal;
        # index_add_ on the card sums by atomics in any order.
        g_rows.index_put_((inverse,), g[valid], accumulate=True)
        w, acc = self._table_weight(t), self._table_acc(t)
        touched, g_rows = touched.to(w.device), g_rows.to(w.device)
        new_acc = acc[touched] + (g_rows * g_rows).mean(dim=-1)
        scale = torch.rsqrt(new_acc + _ADAGRAD_EPS)[:, None]
        w[touched] = w[touched] - learning_rate * g_rows * scale
        acc[touched] = new_acc


def make_embedding_train_step(model: EmbeddingCollection, learning_rate: float = 0.05):
    """tpusnap's ``make_embedding_train_step`` for the port:
    ``step(features, targets) -> loss``, one row-wise Adagrad step of
    ``model`` in place."""
    return functools.partial(model.train_step, learning_rate=learning_rate)


def rand_features(
    model: EmbeddingCollection, batch: int, bag: int, seed: int = 0, device=None
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Random ``(features, targets)`` with about 25 % padding: the ids and
    targets tpusnap's ``rand_features`` draws for the same seed, on
    ``device`` (the collection's by default)."""
    device = model.device if device is None else torch.device(device)
    rng = np.random.default_rng(seed)
    feats = {}
    for t in model.tables:
        ids = rng.integers(0, t.num_embeddings, (batch, bag)).astype(np.int32)
        ids[rng.random((batch, bag)) < 0.25] = -1
        feats[t.name] = torch.from_numpy(ids).to(device)
    targets = torch.from_numpy(rng.normal(size=(batch,)).astype(np.float32)).to(device)
    return feats, targets
