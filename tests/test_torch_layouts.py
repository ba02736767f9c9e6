"""The port's layouts against tpusnap's, box by box.

For every leaf of the MoE flagship's train state and of an embedding
collection (row, col, table and replicated tables) the port's specs
equal tpusnap's ``PartitionSpec``s, and at the mesh shapes (2, 2, 2),
(1, 2, 1) and (2, 1, 2) the box ``io_preparers.sharded.local_box`` gives
rank ``i`` under the port's placements equals the index tpusnap's
``NamedSharding`` gives device ``i`` of conftest's 8 CPU devices. No
process group is needed: a rank's mesh coordinate is its index in the
mesh's row-major order, as ``make_mesh`` lays devices out.
"""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from tpusnap.models import EmbeddingCollection as JaxEmbeddingCollection
from tpusnap.models import TableConfig as JaxTableConfig
from tpusnap.models.transformer import Transformer as JaxTransformer
from tpusnap.models.transformer import TransformerConfig as JaxConfig
from tpusnap.models.transformer import make_mesh as jax_make_mesh
from tpusnap.models.transformer import train_state_specs as jax_train_state_specs
from tpusnap_torch.io_preparers.sharded import local_box
from tpusnap_torch.models import EmbeddingCollection, TableConfig, Transformer, TransformerConfig
from tpusnap_torch.models.layout import default_mesh_shape, spec_placements
from tpusnap_torch.models.transformer import train_state_specs

_TINY = dict(vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16, n_experts=4)
_MESH_SHAPES = [(2, 2, 2), (1, 2, 1), (2, 1, 2)]


def _tables():
    return [
        dict(name="r0", num_embeddings=64, embedding_dim=16, sharding="row"),
        dict(name="c0", num_embeddings=64, embedding_dim=16, sharding="col"),
        dict(name="rep", num_embeddings=32, embedding_dim=8, sharding="replicated"),
    ] + [
        dict(name=f"t{i}", num_embeddings=64, embedding_dim=16, sharding="table")
        for i in range(4)
    ]


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _models():
    jm = JaxTransformer(JaxConfig(**_TINY))
    tm = Transformer(TransformerConfig(**_TINY), device="cpu")
    jstate = jax.eval_shape(lambda: _jax_train_state(jm))
    je = JaxEmbeddingCollection([JaxTableConfig(**t) for t in _tables()])
    te = EmbeddingCollection([TableConfig(**t) for t in _tables()], device="cpu")
    jparams = jax.eval_shape(lambda: je.init(jax.random.PRNGKey(0)))
    return {
        "moe_train_state": (
            dict(_walk(jstate)), dict(_walk(jax_train_state_specs(jm))),
            dict(_walk(tm.train_state())), dict(_walk(train_state_specs(tm))),
        ),
        "embedding": (
            dict(_walk(jparams)), dict(_walk(je.param_specs())),
            dict(_walk(te.params())), dict(_walk(te.param_specs())),
        ),
    }


def _jax_train_state(jm):
    params = jm.init(jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda p: jax.numpy.zeros(p.shape, jax.numpy.float32), params)
    return {"params": params, "opt": {"mu": zeros, "nu": zeros,
                                      "step": jax.numpy.zeros((), jax.numpy.int32)}}


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.mark.parametrize("model", ["moe_train_state", "embedding"])
def test_specs_equal_tpusnaps(models, model):
    jax_leaves, jax_specs, port_leaves, port_specs = models[model]
    assert sorted(port_specs) == sorted(jax_specs) == sorted(port_leaves) == sorted(jax_leaves)
    for path, spec in port_specs.items():
        assert tuple(spec) == tuple(jax_specs[path]), path
        assert list(port_leaves[path].shape) == list(jax_leaves[path].shape), path


@pytest.mark.parametrize("mesh_shape", _MESH_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("model", ["moe_train_state", "embedding"])
def test_local_boxes_equal_named_sharding_indices(models, model, mesh_shape):
    jax_leaves, jax_specs, port_leaves, port_specs = models[model]
    n = int(np.prod(mesh_shape))
    mesh = jax_make_mesh(jax.devices()[:n], mesh_shape)
    for path, spec in port_specs.items():
        shape = list(port_leaves[path].shape)
        indices = NamedSharding(mesh, P(*jax_specs[path])).devices_indices_map(tuple(shape))
        placements = spec_placements(spec)
        for i, device in enumerate(jax.devices()[:n]):
            coordinate = list(np.unravel_index(i, mesh_shape))
            got = local_box(shape, list(mesh_shape), coordinate, placements)
            want = (
                [s.start or 0 for s in indices[device]],
                [(s.stop if s.stop is not None else d) - (s.start or 0)
                 for s, d in zip(indices[device], shape)],
            )
            assert (list(got[0]), list(got[1])) == want, (path, mesh_shape, i)


def test_spec_placements():
    assert spec_placements((None, "fsdp", "tensor")) == [Replicate(), Shard(1), Shard(2)]
    assert spec_placements((None, "data", "tensor", "fsdp")) == [Shard(1), Shard(3), Shard(2)]
    assert spec_placements((("fsdp", "tensor"), None)) == [Replicate(), Shard(0), Shard(0)]
    assert spec_placements(()) == [Replicate()] * 3
    with pytest.raises(NotImplementedError, match="mesh order"):
        spec_placements((("tensor", "fsdp"),))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12])
def test_default_mesh_shape_is_tpusnaps(n):
    from tpusnap.models.transformer import _default_mesh_shape

    assert default_mesh_shape(n) == _default_mesh_shape(n)
