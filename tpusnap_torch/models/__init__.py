"""The two model families of the port (counterpart of tpusnap/models).

A flagship decoder transformer, dense or MoE, whose parameters take every
layout the sharded preparer must round-trip over a
``("data", "fsdp", "tensor")`` mesh — dp (replicated), fsdp, tp and ep
(the expert dim over ``"data"``) — and an embedding-table collection (the
torchrec DMP analog: row-, column- and table-wise layouts, host-offloaded
tables in pinned memory, row-wise Adagrad state). Both keep tpusnap's
parameter trees, so their snapshots restore across the two packages.
``TransformerConfig(use_ring_attention=True)`` runs the attention through
``ops.ring_attention`` (sequence parallelism over a ``torch.distributed``
group, forward and backward), and ``make_train_step(model, mesh)`` is
tpusnap's sharded Adam step over a mesh of ranks (``ShardedTrainStep``).
"""

from .embedding import (  # noqa: F401
    EmbeddingCollection,
    TableConfig,
    make_embedding_train_step,
    rand_features,
)
from .layout import make_mesh  # noqa: F401
from .transformer import (  # noqa: F401
    ShardedTrainStep,
    Transformer,
    TransformerConfig,
    init_train_state,
    make_train_step,
    train_state_placements,
    train_state_views,
)

__all__ = [
    "EmbeddingCollection",
    "ShardedTrainStep",
    "TableConfig",
    "Transformer",
    "TransformerConfig",
    "init_train_state",
    "make_embedding_train_step",
    "make_mesh",
    "make_train_step",
    "rand_features",
    "train_state_placements",
    "train_state_views",
]
