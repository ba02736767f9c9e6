"""The flagship example across the two packages: the JAX example
(examples/transformer_example.py) trains into a work dir, and the port's
``tpusnap_torch.examples.transformer --width tiny --device cpu`` resumes
from its ``epoch_2``. Every leaf the port restores equals tpusnap's
``read_object`` of the same path bit for bit, and the port's first step
after the resume (f32 compute, the first token batch of
``default_rng(0)``) gives tpusnap's loss on the same parameters and tokens
within 1e-5 (the tolerance of tests/test_torch_transformer.py's f32 loss
case)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusnap import PytreeState as JaxPytreeState
from tpusnap import Snapshot as JaxSnapshot
from tpusnap.models import Transformer as JaxTransformer
from tpusnap.models import TransformerConfig as JaxConfig
from tpusnap.models.transformer import init_train_state, make_mesh
from tpusnap_torch import Snapshot
from tpusnap_torch.examples import transformer as port_example

from test_examples import _run_example
from test_torch_examples import run_module


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("jax_xf")
    _run_example("transformer_example.py", "--work-dir", str(work))
    return work / "epoch_2"


def test_port_example_resumes_from_the_jax_examples_epoch_2(jax_run, tmp_path):
    proc = run_module(
        "tpusnap_torch.examples.transformer", "--width", "tiny", "--compute-dtype", "float32",
        "--work-dir", str(tmp_path / "work"), "--resume-from", str(jax_run), tmp_path=tmp_path,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "resumed at epoch 2" in proc.stdout
    assert "epoch 3:" in proc.stdout and "final snapshot committed" in proc.stdout
    first_loss = float(re.search(r"^step 1: loss=(\S+)$", proc.stdout, re.M).group(1))

    # tpusnap's loss with the same parameters on the same tokens, f32.
    fields, shape = port_example.WIDTHS["tiny"]
    jm = JaxTransformer(JaxConfig(**fields, n_experts=4, dtype=jnp.float32))
    import jax

    mesh = make_mesh(jax.devices()[:1])
    target = JaxPytreeState(init_train_state(jm, mesh, jax.random.PRNGKey(1)))
    JaxSnapshot(str(jax_run)).restore({"train": target})
    tokens = np.random.default_rng(0).integers(0, fields["vocab_size"], shape)
    want = float(jm.loss(target.tree["params"], jnp.asarray(tokens, jnp.int32)))
    assert abs(first_loss - want) <= 1e-5, (first_loss, want)


def test_port_restore_of_the_jax_snapshot_is_bit_exact(jax_run):
    """The example's own restore (``build`` + ``app_state_of`` +
    ``async_restore``) against tpusnap's read_object of every path."""
    model, _ = port_example.build("tiny", "cpu", "float32")
    app_state = port_example.app_state_of(model)
    Snapshot(str(jax_run)).async_restore(app_state).wait()
    assert app_state["progress"]["epoch"] == 2
    jax_snap = JaxSnapshot(str(jax_run))
    leaves = list(_walk(model.train_state()))
    assert len(leaves) == 3 * len(list(_walk(model.params()))) + 1  # params, mu, nu, step
    for path, got in leaves:
        want = np.asarray(jax_snap.read_object(f"0/train/{path}"))
        got = got.detach().numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
