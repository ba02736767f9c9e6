"""tpusnap_torch.models.transformer against tpusnap's JAX model.

Tiny config (vocab 128, d_model 32, 2 heads, 2 layers, d_ff 64, seq 16);
JAX weights are carried into the port with ``params_from_jax`` /
``train_state_from_jax`` so both packages compute on the same numbers.
Tokens come from numpy with a fixed seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusnap.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
    init_train_state,
    make_mesh,
    make_train_step,
)
from tpusnap_torch.models import Transformer, TransformerConfig

# One intra-op thread: the suite runs beside other test processes, and
# torch's default of one spinning thread per core starves their timing.
torch.set_num_threads(1)

_TINY = dict(vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16)
_LR = 1e-3


def _tokens():
    return np.random.default_rng(0).integers(0, 128, (2, 16))


def _jax_model(**kw):
    return JaxTransformer(JaxConfig(**_TINY, **kw))


def _port_model(**kw):
    return Transformer(TransformerConfig(**_TINY, **kw), device="cpu")


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_f32_logits_match_jax(impl):
    jm = _jax_model(dtype=jnp.float32, attention_impl=impl)
    params = jm.init(jax.random.PRNGKey(0))
    want = np.asarray(jm.apply(params, jnp.asarray(_tokens(), jnp.int32)))
    tm = _port_model(dtype=torch.float32, attention_impl=impl)
    tm.params_from_jax(_to_numpy(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(_tokens())).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_bf16_logits_match_jax():
    # bf16 keeps 8 mantissa bits: one rounding of a logit near 4 is worth
    # 1.6e-2, and the frameworks round at different places (XLA's CPU
    # einsum and gelu versus torch's) through two layers; 1e-1 bounds a
    # few such roundings while a wrong RoPE lane order or gelu variant
    # moves logits by whole units.
    jm = _jax_model()
    params = jm.init(jax.random.PRNGKey(0))
    want = np.asarray(jm.apply(params, jnp.asarray(_tokens(), jnp.int32)))
    tm = _port_model()
    tm.params_from_jax(_to_numpy(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(_tokens()))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-1)


def test_loss_and_grads_match_jax():
    jm = _jax_model(dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    loss, grads = jax.value_and_grad(jm.loss)(params, jnp.asarray(_tokens(), jnp.int32))
    tm = _port_model(dtype=torch.float32)
    tm.params_from_jax(_to_numpy(params))
    got = tm.loss(torch.from_numpy(_tokens()))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), atol=1e-5)
    want = dict(_walk(_to_numpy(grads)))
    for path, p in _walk(tm.params()):
        np.testing.assert_allclose(p.grad.numpy(), want[path], atol=1e-5, err_msg=path)


def test_adam_step_matches_make_train_step():
    jm = _jax_model(dtype=jnp.float32)
    mesh = make_mesh(jax.devices()[:1])
    state = init_train_state(jm, mesh, jax.random.PRNGKey(0))
    toks = jnp.asarray(_tokens(), jnp.int32)
    grads = dict(_walk(_to_numpy(jax.grad(jm.loss)(state["params"], toks))))
    new_state, jloss = make_train_step(jm, mesh, learning_rate=_LR)(state, toks)
    tm = _port_model(dtype=torch.float32)
    tm.train_state_from_jax(_to_numpy(state))
    params_before = {p: t.detach().clone() for p, t in _walk(tm.params())}
    ids_before = {p: id(t) for p, t in _walk(tm.train_state())}
    loss = tm.train_step(torch.from_numpy(_tokens()), learning_rate=_LR)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    want = dict(_walk(_to_numpy(new_state)))
    got = dict(_walk(tm.train_state()))
    assert {p: id(t) for p, t in got.items()} == ids_before  # updated in place
    assert int(got["opt/step"]) == int(want["opt/step"]) == 1
    for path, t in got.items():
        if path == "opt/step":
            continue
        t = t.detach().numpy()
        if path.startswith("opt/mu"):
            np.testing.assert_allclose(t, want[path], atol=1e-7, err_msg=path)
        elif path.startswith("opt/nu"):
            np.testing.assert_allclose(t, want[path], atol=1e-9, err_msg=path)
        else:
            # Adam's first step moves each weight by lr * g / (|g| + eps):
            # ±lr wherever |g| >> eps, but where |g| is within a few
            # orders of eps the step size hinges on g's last bits, which
            # the two frameworks' sums round differently. So: 1e-6
            # (1/1000 of lr) where |g| > 1e-6 = 100 x eps, and the step
            # bound 2 x lr everywhere.
            g = np.abs(grads[path[len("params/"):]])
            moved = t - params_before[path[len("params/"):]].numpy()
            np.testing.assert_array_less(np.abs(moved), 2 * _LR + 1e-6)
            big = g > 1e-6
            np.testing.assert_allclose(t[big], want[path][big], atol=1e-6, err_msg=path)


def test_train_state_paths_match_pytree_state():
    from tpusnap import PytreeState
    from tpusnap.flatten import flatten as jax_flatten
    from tpusnap_torch import StateDict
    from tpusnap_torch.flatten import flatten

    jm = _jax_model()
    state = init_train_state(jm, make_mesh(jax.devices()[:1]), jax.random.PRNGKey(0))
    _, want = jax_flatten(PytreeState(state).state_dict(), prefix="train")
    _, got = flatten(StateDict(**_port_model().train_state()).state_dict(), prefix="train")
    assert sorted(got) == sorted(want)
    assert "train/params/layers/wqkv" in got and "train/opt/step" in got
    for path, leaf in got.items():
        assert list(leaf.shape) == list(want[path].shape), path
    assert got["train/opt/step"].dtype == torch.int32
    assert got["train/opt/step"].dim() == 0


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Transformer(TransformerConfig(**_TINY))


@pytest.mark.parametrize("fault", ["missing", "extra", "misshapen"])
def test_params_from_jax_rejects_bad_trees(fault):
    tree = _to_numpy(_jax_model().init(jax.random.PRNGKey(0)))
    if fault == "missing":
        del tree["layers"]["w1"]
    elif fault == "extra":
        tree["layers"]["w3"] = tree["layers"]["w1"]
    else:
        tree["ln_f"] = np.ones((3,), np.float32)
    with pytest.raises((KeyError, ValueError)):
        _port_model().params_from_jax(tree)
