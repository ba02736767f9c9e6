"""tpusnap_torch.ops.flash_attention against tpusnap's Pallas kernel.

The same numpy inputs go through tpusnap's ``flash_attention`` (Pallas
interpret mode on the CPU, as tests/test_models.py runs it), tpusnap's
``_attention_reference``, and the port's plain version / CPU wrapper.
f32 there, atol 2e-5 — the tolerance tests/test_models.py uses for the
kernel against its reference. The Hopper kernels themselves run only on
the card: tests/test_torch_cuda.py holds them against the plain version.
Here the CPU reaches what surrounds them: the route choice, and the
per-element bound the 16-bit kernel is held to, shown to be neither
broken by the kernel's rounding nor loose enough to hide a lost k-tile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusnap.ops import flash_attention as jax_flash_attention
from tpusnap.ops.flash_attention import _attention_reference
from tpusnap_torch.ops import flash_attention as fa
from tpusnap_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

# One intra-op thread: the suite runs beside other test processes, and
# torch's default of one spinning thread per core starves their timing.
torch.set_num_threads(1)

ATOL = 2e-5


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "shape", [(2, 16, 2, 8), (1, 200, 4, 64)], ids=["tiny", "ragged"]
)
def test_plain_matches_tpusnap(shape, causal):
    q, k, v = _inputs(shape, seed=1)
    want_kernel = np.asarray(
        jax_flash_attention(
            *(jnp.asarray(x) for x in (q, k, v)), causal=causal, block_q=64, block_k=64
        )
    )
    want_ref = np.asarray(
        _attention_reference(*(jnp.asarray(x) for x in (q, k, v)), causal)
    )
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got_plain = flash_attention_reference(tq, tk, tv, causal).numpy()
    got_wrapper = flash_attention(tq, tk, tv, causal=causal).numpy()
    np.testing.assert_allclose(got_plain, want_kernel, atol=ATOL)
    np.testing.assert_allclose(got_plain, want_ref, atol=ATOL)
    np.testing.assert_array_equal(got_wrapper, got_plain)


def test_gradients_match_jax_grad():
    q, k, v = _inputs((1, 32, 2, 16), seed=2)
    want = jax.grad(
        lambda *a: jax_flash_attention(*a).sum(), argnums=(0, 1, 2)
    )(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    flash_attention(tq, tk, tv, causal=True).sum().backward()
    for got, expect in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL)


def test_cpu_wrapper_does_not_count_launches():
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 8, 1, 4), seed=3))
    before, before_routes = fa.launches, dict(fa.route_launches)
    flash_attention(q, k, v)
    assert fa.launches == before and fa.route_launches == before_routes


@pytest.mark.parametrize(
    "case",
    ["rank3", "int_dtype", "head_dim_300", "shape_mismatch", "dtype_mismatch"],
)
def test_wrapper_rejects_unsupported_input(case):
    ok = torch.zeros((1, 4, 2, 8))
    q = k = v = ok
    if case == "rank3":
        q = k = v = torch.zeros((4, 2, 8))
    elif case == "int_dtype":
        q = k = v = torch.zeros((1, 4, 2, 8), dtype=torch.int32)
    elif case == "head_dim_300":
        q = k = v = torch.zeros((1, 4, 2, 300))
    elif case == "shape_mismatch":
        k = torch.zeros((1, 5, 2, 8))
    elif case == "dtype_mismatch":
        v = ok.to(torch.float16)
    with pytest.raises(ValueError):
        flash_attention(q, k, v)



def _fused_views(shape, dtype):
    """q, k, v as the model passes them: head-split views of one fused
    qkv projection."""
    b, s, h, d = shape
    qkv = torch.zeros((b, s, 3 * h * d), dtype=dtype)
    return tuple(t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))


@pytest.mark.parametrize(
    "case,want",
    [
        ("flagship_bf16_views", "wgmma"),
        ("flagship_f16_views", "wgmma"),
        ("f32", "simt"),
        ("bf16_d4", "simt"),
        ("bf16_seq_stride_not_16_bytes", "simt"),
        ("bf16_misaligned_base", "simt"),
        ("bf16_size1_dims_any_stride", "wgmma"),
    ],
)
def test_route_follows_dtype_and_strides(case, want):
    """``_route`` reads only dtype, shape and strides (plus whether the
    bases are 16-byte aligned): plain CPU tensors of the shapes and
    strides the card would see."""
    aligned = True
    if case == "flagship_bf16_views":
        q, k, v = _fused_views((8, 1024, 8, 64), torch.bfloat16)
        assert not v.is_contiguous()
    elif case == "flagship_f16_views":
        q, k, v = _fused_views((8, 1024, 8, 64), torch.float16)
    elif case == "f32":
        q, k, v = _fused_views((2, 16, 2, 64), torch.float32)
    elif case == "bf16_d4":
        q, k, v = _fused_views((2, 16, 2, 4), torch.bfloat16)
    elif case == "bf16_seq_stride_not_16_bytes":
        base = torch.zeros((2, 16, 2 * 8 + 4), dtype=torch.bfloat16)
        q = k = v = base[..., :16].reshape(2, 16, 2, 8)  # s stride 20 elements = 40 bytes
    elif case == "bf16_misaligned_base":
        q, k, v = _fused_views((2, 16, 2, 64), torch.bfloat16)
        aligned = False
    else:  # b = 1 and h = 1: their strides are never followed
        q = k = v = torch.zeros((1, 16, 1, 64), dtype=torch.bfloat16).as_strided(
            (1, 16, 1, 64), (3, 64, 5, 1)
        )
    assert fa._route(q, k, v, base_aligned=aligned) == want


def _modelled_kernel(q, k, v, causal, drop_keys_from=None):
    """The 16-bit kernel's arithmetic in torch: f32 scores and softmax, P
    rounded to the input type before P V, l from the unrounded P, the
    output rounded once. ``drop_keys_from`` masks every key from there on,
    as a kernel that lost its last k-tile would."""
    b, s, h, d = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d**-0.5)
    keep = torch.ones((s, s), dtype=torch.bool)
    if causal:
        keep = torch.tril(keep)
    if drop_keys_from is not None:
        keep[:, drop_keys_from:] = False
    scores = scores.masked_fill(~keep, float("-inf"))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float() / l, v.float())
    return out.to(q.dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_rounding_bound_holds_the_kernel_and_catches_a_lost_tile(dtype, causal):
    """The bound ``u·(P·|V|) + 2 ulps·|ref| + 1e-5`` (``rounding_bound``)
    around tpusnap's interpret-mode kernel on the same inputs: (1) the
    modelled 16-bit kernel lies inside it; (2) the same model without its
    last k-tile (keys 128..199 of 200) lies outside it."""
    shape = (1, 200, 2, 64)
    q, k, v = _inputs(shape, seed=4)
    want = np.asarray(
        jax_flash_attention(
            *(jnp.asarray(x).astype(dtype) for x in (q, k, v)),
            causal=causal, block_q=128, block_k=128,
        ).astype(jnp.float32)
    )
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
    bound = fa.rounding_bound(tq, tk, tv, causal).numpy()

    def worst(got):
        return float((np.abs(got.float().numpy() - want) / bound).max())

    assert worst(_modelled_kernel(tq, tk, tv, causal)) <= 1.0
    assert worst(_modelled_kernel(tq, tk, tv, causal, drop_keys_from=128)) > 1.0


# ------------------------------------------------------------------ backward


def _masked_scores_jax(q, k, causal):
    """tpusnap's scaled, masked scores (as ``_attention_reference`` forms
    them), in f32."""
    s, d = q.shape[1], q.shape[-1]
    scores = jnp.einsum(
        "bqhd,bkhd->bhqk", jnp.asarray(q), jnp.asarray(k), preferred_element_type=jnp.float32
    ) * (d**-0.5)
    if causal:
        scores = jnp.where(jnp.tril(jnp.ones((s, s), dtype=bool))[None, None], scores, -1e30)
    return scores


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("shape", [(1, 1, 2, 8), (2, 33, 2, 40), (1, 130, 2, 64)],
                         ids=["s1", "s33", "s130"])
def test_reference_lse_matches_jax_logsumexp(shape, causal):
    """The plain forward's row log-sum-exp (what the backward takes)
    against ``jax.nn.logsumexp`` of tpusnap's scaled, masked scores; f32,
    only the summation order differs: the file's ATOL."""
    q, k, _ = _inputs(shape, seed=6)
    want = np.asarray(jax.nn.logsumexp(_masked_scores_jax(q, k, causal), axis=-1))
    got = fa.reference_lse(torch.from_numpy(q), torch.from_numpy(k), causal)
    assert got.shape == (shape[0], shape[2], shape[1]) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("d", [8, 40, 64, 128, 256])
@pytest.mark.parametrize("s", [1, 33, 130])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_flash_gradients_match_jax_grad_of_tpusnap(causal, s, d):
    """q, k and v gradients of the port's ``flash_attention`` (its CPU
    backward: the plain forward's lse, the delta pass and ``block_grads``
    at offsets (0, 0)) against ``jax.grad`` of tpusnap's
    ``flash_attention`` in interpret mode (its ``_flash_bwd``) for a
    weighted sum; f32, the file's ATOL (the same f32 function in another
    summation order)."""
    shape = (1, s, 2, d)
    q, k, v = _inputs(shape, seed=7)
    w = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    want = jax.grad(
        lambda *a: jnp.sum(
            jax_flash_attention(*a, causal=causal, block_q=64, block_k=64) * w
        ),
        argnums=(0, 1, 2),
    )(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (flash_attention(tq, tk, tv, causal=causal) * torch.from_numpy(w)).sum().backward()
    for name, got, expect in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL, err_msg=name)


def test_flash_backward_on_the_cpu_is_delta_and_block_grads_in_store_mode():
    """The CPU backward is the card's function: ``attention_delta`` of the
    upstream gradient and the forward's output, then ``block_grads`` at
    offsets (0, 0) and scale d ** -0.5 from ``reference_lse``, bit for
    bit; it launches nothing and counts no backward launch."""
    import importlib

    ra = importlib.import_module("tpusnap_torch.ops.ring_attention")
    shape = (2, 24, 2, 16)
    q, k, v = (torch.from_numpy(x) for x in _inputs(shape, seed=9))
    w = torch.from_numpy(np.random.default_rng(10).standard_normal(shape).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    paths, routes = dict(ra.backward_path_launches), dict(ra.backward_route_launches)
    out = flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, w)
    assert (ra.backward_path_launches, ra.backward_route_launches) == (paths, routes)
    delta = ra.attention_delta(w, out.detach())
    want = ra.block_grads(q, k, v, w, fa.reference_lse(q, k, True), delta, 0, 0,
                          shape[-1] ** -0.5, True)
    for g, expect in zip(got, want):
        assert torch.equal(g, expect)


def test_no_grad_forward_takes_no_autograd_function():
    """Without grad the wrapper runs the forward alone: no lse, no saved
    tensors (inference launches are unchanged on the card)."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _inputs((1, 8, 1, 4), seed=11))
    with torch.no_grad():
        out = flash_attention(q, k, v)
    assert out.grad_fn is None
    assert flash_attention(q, k, v).grad_fn is not None
