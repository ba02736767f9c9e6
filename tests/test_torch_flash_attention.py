"""tpusnap_torch.ops.flash_attention against tpusnap's Pallas kernel.

The same numpy inputs go through tpusnap's ``flash_attention`` (Pallas
interpret mode on the CPU, as tests/test_models.py runs it), tpusnap's
``_attention_reference``, and the port's plain version / CPU wrapper.
f32 throughout, atol 2e-5 — the tolerance tests/test_models.py uses for
the kernel against its reference. The Hopper kernel itself runs only on
the card: tests/test_torch_cuda.py holds it against the plain version.
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
    before = fa.launches
    flash_attention(q, k, v)
    assert fa.launches == before


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

