"""The MoE flagship of tpusnap_torch against tpusnap's.

Tiny config (vocab 128, d_model 32, 2 heads, 2 layers, d_ff 64, seq 16,
4 experts) with the plain attention (``attention_impl="reference"``):
JAX weights are carried into the port with ``params_from_jax`` /
``train_state_from_jax`` and tokens come from numpy with a fixed seed.
Tolerances are those of tests/test_torch_transformer.py: f32 logits
1e-4, loss and grads 1e-5, the Adam step as there.
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

torch.set_num_threads(1)

_TINY = dict(
    vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16,
    n_experts=4, attention_impl="reference",
)
_LR = 1e-3


def _tokens():
    return np.random.default_rng(0).integers(0, 128, (2, 16))


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(**kw):
    jm = JaxTransformer(JaxConfig(**_TINY, **{k: v for k, v in kw.items() if k != "torch_dtype"}))
    tm = Transformer(
        TransformerConfig(**_TINY, dtype=kw.get("torch_dtype", torch.bfloat16)), device="cpu"
    )
    return jm, tm


def test_moe_parameters_have_tpusnaps_names_and_shapes():
    jm, tm = _pair()
    want = {p: a.shape for p, a in _walk(_to_numpy(jm.init(jax.random.PRNGKey(0))))}
    got = {p: tuple(t.shape) for p, t in _walk(tm.params())}
    assert got == want
    assert {"layers/router", "layers/w1e", "layers/w2e"} <= set(got)
    assert "layers/w1" not in got
    # tpusnap's init scales: fan_in ** -0.5 (d_model for router and w1e).
    for name, fan_in in (("router", 32), ("w1e", 32), ("w2e", 64)):
        std = float(tm.layers[name].detach().std())
        assert abs(std - fan_in**-0.5) < 0.2 * fan_in**-0.5, name


def test_f32_logits_match_jax():
    jm, tm = _pair(dtype=jnp.float32, torch_dtype=torch.float32)
    params = jm.init(jax.random.PRNGKey(0))
    want = np.asarray(jm.apply(params, jnp.asarray(_tokens(), jnp.int32)))
    tm.params_from_jax(_to_numpy(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(_tokens())).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_bf16_logits_match_jax():
    # As in test_torch_transformer.py: bf16 roundings at different places
    # in the two frameworks are bounded by 1e-1 through two layers.
    jm, tm = _pair()
    params = jm.init(jax.random.PRNGKey(0))
    want = np.asarray(jm.apply(params, jnp.asarray(_tokens(), jnp.int32)))
    tm.params_from_jax(_to_numpy(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(_tokens()))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-1)


def test_loss_and_grads_match_jax():
    jm, tm = _pair(dtype=jnp.float32, torch_dtype=torch.float32)
    params = jm.init(jax.random.PRNGKey(0))
    loss, grads = jax.value_and_grad(jm.loss)(params, jnp.asarray(_tokens(), jnp.int32))
    tm.params_from_jax(_to_numpy(params))
    got = tm.loss(torch.from_numpy(_tokens()))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), atol=1e-5)
    want = dict(_walk(_to_numpy(grads)))
    for path, p in _walk(tm.params()):
        np.testing.assert_allclose(p.grad.numpy(), want[path], atol=1e-5, err_msg=path)


def test_adam_step_matches_make_train_step():
    jm, tm = _pair(dtype=jnp.float32, torch_dtype=torch.float32)
    mesh = make_mesh(jax.devices()[:1])
    state = init_train_state(jm, mesh, jax.random.PRNGKey(0))
    toks = jnp.asarray(_tokens(), jnp.int32)
    grads = dict(_walk(_to_numpy(jax.grad(jm.loss)(state["params"], toks))))
    new_state, jloss = make_train_step(jm, mesh, learning_rate=_LR)(state, toks)
    tm.train_state_from_jax(_to_numpy(state))
    params_before = {p: t.detach().clone() for p, t in _walk(tm.params())}
    ids_before = {p: id(t) for p, t in _walk(tm.train_state())}
    loss = tm.train_step(torch.from_numpy(_tokens()), learning_rate=_LR)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    want = dict(_walk(_to_numpy(new_state)))
    got = dict(_walk(tm.train_state()))
    assert {p: id(t) for p, t in got.items()} == ids_before
    assert sorted(got) == sorted(want)
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
            # Adam's first step is ±lr where |g| >> eps; where |g| is near
            # eps the step hinges on g's last bits (test_torch_transformer.py).
            name = path[len("params/"):]
            moved = t - params_before[name].numpy()
            np.testing.assert_array_less(np.abs(moved), 2 * _LR + 1e-6)
            big = np.abs(grads[name]) > 1e-6
            np.testing.assert_allclose(t[big], want[path][big], atol=1e-6, err_msg=path)


def test_make_train_step_is_the_in_place_step():
    from tpusnap_torch.models import make_train_step

    jm, a = _pair(dtype=jnp.float32, torch_dtype=torch.float32)
    _, b = _pair(dtype=jnp.float32, torch_dtype=torch.float32)
    params = _to_numpy(jm.init(jax.random.PRNGKey(0)))
    a.params_from_jax(params)
    b.params_from_jax(params)
    tokens = torch.from_numpy(_tokens())
    step = make_train_step(a, learning_rate=_LR)
    assert torch.equal(step(tokens), b.train_step(tokens, learning_rate=_LR))
    for (path, x), (_, y) in zip(_walk(a.train_state()), _walk(b.train_state())):
        assert torch.equal(x, y), path


def test_models_package_exports_tpusnaps_names():
    import tpusnap.models as jax_models
    import tpusnap_torch.models as port_models

    assert set(jax_models.__all__) <= set(port_models.__all__)
