"""The port's flagship with ``use_ring_attention`` against its dense self and
tpusnap's ring model.

Mirrors tests/test_models.py's train-step and ring/dense cases (tpusnap's
own rtol 2e-2 for ring against dense): a tiny config, tokens from a numpy
seed, tpusnap's parameters carried into the port with ``params_from_jax``.
The sequence-parallel forward runs in a world of two gloo processes, each
holding its half of the tokens; the group's loss must equal the
single-process loss. The worlds' processes import neither JAX nor tpusnap.
"""

import json
import os

import numpy as np
import pytest
import torch

from tpusnap_torch.models import Transformer, TransformerConfig

# One intra-op thread: the suite runs beside other test processes, and
# torch's default of one spinning thread per core starves their timing.
torch.set_num_threads(1)

_TINY = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128)


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 128, shape)


def _model(**kw):
    return Transformer(TransformerConfig(**_TINY, **kw), device="cpu", seed=0)


@pytest.mark.parametrize("ring", [False, True], ids=["noring", "ring"])
@pytest.mark.parametrize("n_experts", [0, 4], ids=["dense", "moe"])
def test_train_step_decreases_loss(n_experts, ring):
    model = _model(n_experts=n_experts, use_ring_attention=ring)
    tokens = torch.from_numpy(_tokens((4, 32)))
    losses = [float(model.train_step(tokens, learning_rate=1e-2)) for _ in range(3)]
    assert losses[-1] < losses[0]
    assert int(model.opt_state["step"]) == 3


def test_ring_and_dense_attention_agree():
    """The same parameters give the same loss with the ring path or the
    dense one: sequence parallelism is a pure layout change."""
    dense, ring = _model(), _model(use_ring_attention=True)
    tokens = torch.from_numpy(_tokens((2, 32)))
    with torch.no_grad():
        np.testing.assert_allclose(float(ring.loss(tokens)), float(dense.loss(tokens)), rtol=2e-2)


def test_ring_loss_matches_tpusnap_ring_model_on_a_mesh():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpusnap.models import Transformer as JaxTransformer, TransformerConfig as JaxConfig
    from tpusnap.models import make_mesh

    mesh = make_mesh()
    jm = JaxTransformer(JaxConfig(**_TINY, use_ring_attention=True))
    params = jm.shard_params(jm.init(jax.random.PRNGKey(0)), mesh)
    tokens = _tokens((2, 32))
    want = jax.jit(lambda p, t: jm.loss(p, t, mesh=mesh))(
        params, jax.device_put(tokens.astype(np.int32), NamedSharding(mesh, P("data", "fsdp")))
    )
    port = _model(use_ring_attention=True)
    port.params_from_jax(jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = port.loss(torch.from_numpy(tokens))
    np.testing.assert_allclose(float(got), float(want), rtol=2e-2)


def test_ring_group_without_ring_attention_is_refused():
    with pytest.raises(ValueError, match="use_ring_attention"):
        _model()(torch.zeros((1, 4), dtype=torch.int64), ring_group=object())


def _ring_rank(out_dir: str) -> None:
    """One rank of a two-rank sequence-parallel forward: this rank's half
    of the tokens, the group's loss, the block's logits."""
    import torch.distributed as dist

    rank, n = dist.get_rank(), dist.get_world_size()
    model = _model(use_ring_attention=True)
    tokens = torch.from_numpy(_tokens((2, 32)))
    blk = tokens.shape[1] // n
    with torch.no_grad():
        mine = tokens[:, rank * blk : (rank + 1) * blk]
        loss = model.loss(mine, ring_group=dist.group.WORLD)
        logits = model(mine, ring_group=dist.group.WORLD)
    np.save(os.path.join(out_dir, f"logits{rank}.npy"), logits.numpy())
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"loss": float(loss)}, f)


def test_two_rank_ring_forward_equals_the_single_process_loss(tmp_path):
    from tpusnap_torch.test_utils import run_subprocess_world

    run_subprocess_world(_ring_rank, 2, args=[str(tmp_path)], timeout=240)
    losses = [json.loads((tmp_path / f"rank{r}.json").read_text())["loss"] for r in range(2)]
    model = _model(use_ring_attention=True)
    tokens = torch.from_numpy(_tokens((2, 32)))
    with torch.no_grad():
        want_loss = float(model.loss(tokens))
        want_logits = model(tokens).numpy()
    assert losses[0] == losses[1]  # one all-reduced sum, one mean
    # bf16 activations: the ranks' K/V blocks meet in another order than
    # the single block's, and the RoPE offset must land each block at its
    # global positions (a block at positions 0.. moves logits by whole units).
    np.testing.assert_allclose(losses[0], want_loss, rtol=2e-2)
    got_logits = np.concatenate([np.load(tmp_path / f"logits{r}.npy") for r in range(2)], 1)
    np.testing.assert_allclose(got_logits, want_logits, atol=0.1)
