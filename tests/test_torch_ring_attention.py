"""tpusnap_torch.ops.ring_attention against tpusnap's ring attention.

The same numpy inputs (f32, from a seed) go through tpusnap's
``ring_attention`` (one block, or inside ``shard_map`` over the "fsdp"
axis of a mesh on conftest's 8 CPU devices) and the port's (one block, or
a ring of 2 or 4 gloo processes). Mirrors tests/test_models.py's ring
cases (ring against dense, on a mesh, non-causal, gradients) with their
atol 1e-5, and holds the plain block step ``block_attend`` against
tpusnap's ``_block_attend`` at atol 1e-6 (the same f32 operations in
another summation order): diagonal, past and future blocks with a random
incoming carry and a row that has seen nothing yet. A future block leaves
the carry exactly as it was. The backward block step
(``attend_block_grads``) summed over every block pair of a sequence cut
into 1, 2 or 4 blocks equals ``jax.grad`` of tpusnap's ring attention
at atol 1e-5, and ``grads_rounding_bound`` holds a modelled 16-bit
kernel and rejects a lost tile. The kernels themselves run only on the
card (tests/test_torch_cuda.py).

The worlds are started once for the module; their processes import
neither JAX nor tpusnap, so both are imported only where the parent uses
them.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from tpusnap_torch.ops.ring_attention import attend_block, block_attend, block_grads, ring_attention

# The module (its counters): ``tpusnap_torch.ops.ring_attention`` as an
# attribute is the function the package exports.
ra = importlib.import_module("tpusnap_torch.ops.ring_attention")

# One intra-op thread: the suite runs beside other test processes, and
# torch's default of one spinning thread per core starves their timing.
torch.set_num_threads(1)

_RING_SHAPE = (2, 16, 4, 8)  # b, global seq, h, d: blocks of 8 or 4 rows


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _dense(q, k, v, causal=True):
    s = q.shape[1]
    scores = np.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


def _jax_ring(q, k, v, ring: int, causal: bool):
    """tpusnap's ring attention in ``shard_map`` with the sequence over an
    "fsdp" axis of ``ring`` devices, as tpusnap's model calls it."""
    import functools

    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from tpusnap.models.transformer import _shard_map
    from tpusnap.ops import ring_attention as jax_ring_attention

    devices = np.asarray(jax.devices()[: 2 * ring]).reshape(1, ring, 2)
    mesh = Mesh(devices, ("data", "fsdp", "tensor"))
    spec = P("data", "fsdp", "tensor", None)
    fn = jax.jit(
        _shard_map(
            functools.partial(jax_ring_attention, axis_name="fsdp", causal=causal),
            mesh=mesh,
            in_specs=(spec, spec, spec),
            out_specs=spec,
        )
    )
    return np.asarray(fn(q, k, v))


def _ring_rank(inputs: str, out_dir: str) -> None:
    """One rank of a gloo ring: this rank's block of q, k, v through the
    port's ``ring_attention``, causal and not; the outputs and the kernel
    counters saved for the parent."""
    import torch.distributed as dist

    rank, n = dist.get_rank(), dist.get_world_size()
    data = np.load(inputs)
    blk = data["q"].shape[1] // n
    q, k, v = (
        torch.from_numpy(np.ascontiguousarray(data[x][:, rank * blk : (rank + 1) * blk]))
        for x in ("q", "k", "v")
    )
    skips0 = ra.skips
    out = {}
    for causal in (True, False):
        out[f"causal={causal}"] = ring_attention(q, k, v, group=dist.group.WORLD, causal=causal).numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"launches": ra.launches, "skips": ra.skips - skips0}, f)


@pytest.fixture(scope="module")
def ring_worlds(tmp_path_factory):
    """{world size: (global q, k, v, [per-rank outputs], [per-rank counters])}
    from one 2-rank and one 4-rank world."""
    from tpusnap_torch.test_utils import run_subprocess_world

    root = tmp_path_factory.mktemp("ring")
    q, k, v = _qkv(_RING_SHAPE, seed=11)
    inputs = str(root / "qkv.npz")
    np.savez(inputs, q=q, k=k, v=v)
    worlds = {}
    for n in (2, 4):
        out_dir = root / f"world{n}"
        out_dir.mkdir()
        run_subprocess_world(_ring_rank, n, args=[inputs, str(out_dir)], timeout=240)
        outs = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(n)]
        counts = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(n)]
        worlds[n] = ((q, k, v), outs, counts)
    return worlds


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("n", [2, 4])
def test_gloo_ring_matches_jax_shard_map_ring(ring_worlds, n, causal):
    (q, k, v), outs, _ = ring_worlds[n]
    want = _jax_ring(q, k, v, n, causal)
    blk = q.shape[1] // n
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(
            out[f"causal={causal}"], want[:, rank * blk : (rank + 1) * blk], atol=1e-5,
            err_msg=f"rank {rank} of {n}",
        )
    np.testing.assert_allclose(np.concatenate([o[f"causal={causal}"] for o in outs], 1),
                               _dense(q, k, v, causal), atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_gloo_ring_skips_future_blocks_without_a_launch(ring_worlds, n):
    # Causal: rank r meets n - 1 - r future blocks; the non-causal pass
    # skips none. A CPU ring launches no kernel.
    _, _, counts = ring_worlds[n]
    assert [c["skips"] for c in counts] == [n - 1 - r for r in range(n)]
    assert all(c["launches"] == 0 for c in counts)


def test_single_block_matches_dense():
    q, k, v = _qkv((2, 16, 4, 8), seed=0)
    out = ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), _dense(q, k, v), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_single_block_matches_tpusnap(causal):
    import jax.numpy as jnp

    from tpusnap.ops import ring_attention as jax_ring_attention

    q, k, v = _qkv((1, 8, 2, 4), seed=2)
    want = np.asarray(jax_ring_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=causal))
    got = ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_non_causal_matches_dense_softmax():
    q, k, v = _qkv((1, 8, 2, 4), seed=3)
    got = ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=False).numpy()
    np.testing.assert_allclose(got, _dense(q, k, v, causal=False), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_single_block_grads_match_jax(causal):
    import jax
    import jax.numpy as jnp

    from tpusnap.ops import ring_attention as jax_ring_attention

    q, k, v = _qkv((1, 8, 2, 4), seed=4)
    w = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jax_ring_attention(q, k, v, causal=causal) * w), argnums=(0, 1, 2)
    )(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (ring_attention(tq, tk, tv, causal=causal) * torch.from_numpy(w)).sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, err_msg=name)


def _carry(b, s, h, d, seed):
    """A random incoming carry whose row 1 of every (batch, head) has seen
    nothing yet (m = -1e30, l = 0, o = 0)."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((b, h, s)).astype(np.float32)
    l = rng.uniform(0.5, 3.0, (b, h, s)).astype(np.float32)
    o = rng.standard_normal((b, s, h, d)).astype(np.float32)
    m[:, :, 1], l[:, :, 1], o[:, 1] = -1e30, 0.0, 0.0
    return m, l, o


_BLOCKS = {"diagonal": (8, 8), "past": (8, 0), "future": (0, 8)}  # q_offset, k_offset


@pytest.mark.parametrize("block", list(_BLOCKS))
def test_block_attend_matches_tpusnap(block):
    import jax.numpy as jnp

    from tpusnap.ops.ring_attention import _block_attend

    b, s, h, d = 2, 8, 3, 4
    q, k, v = _qkv((b, s, h, d), seed=6)
    m, l, o = _carry(b, s, h, d, seed=7)
    q_off, k_off = _BLOCKS[block]
    scale = d**-0.5
    want = _block_attend(
        *(jnp.asarray(x) for x in (q, k, v, m, l, o)),
        q_off + jnp.arange(s), k_off + jnp.arange(s), scale, True,
    )
    t = [torch.from_numpy(x) for x in (q, k, v, m, l, o)]
    got = block_attend(*t, q_off, k_off, scale, True)
    for name, g, w in zip(("m", "l", "o"), got, want):
        if block == "future":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, err_msg=name)
    if block == "future":
        for name, g, before in zip(("m", "l", "o"), got, (m, l, o)):
            np.testing.assert_array_equal(g.numpy(), before, err_msg=name)
    else:
        # The row that had seen nothing now has a finite max and a sum.
        assert (got[0][:, :, 1] > -1e29).all() and (got[1][:, :, 1] > 0).all()


@pytest.mark.parametrize("block", list(_BLOCKS))
def test_attend_block_updates_the_carry_in_place_on_the_cpu(block):
    b, s, h, d = 2, 8, 3, 4
    q, k, v = (torch.from_numpy(x) for x in _qkv((b, s, h, d), seed=8))
    carry = [torch.from_numpy(x) for x in _carry(b, s, h, d, seed=9)]
    q_off, k_off = _BLOCKS[block]
    want = block_attend(q, k, v, *carry, q_off, k_off, 0.5, True)
    ptrs = [t.data_ptr() for t in carry]
    launches, skips = ra.launches, ra.skips
    attend_block(q, k, v, *carry, q_off, k_off, 0.5, True)
    assert [t.data_ptr() for t in carry] == ptrs
    for g, w in zip(carry, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ra.launches == launches  # a CPU tensor never launches
    assert ra.skips == skips + (block == "future")


def test_attend_block_rejects_a_carry_of_another_shape():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 8, 2, 4), seed=10))
    m, l, o = (torch.from_numpy(x) for x in _carry(1, 8, 2, 4, seed=10))
    with pytest.raises(ValueError, match="carry m"):
        attend_block(q, k, v, m[:, :, :4], l, o, 0, 0, 0.5, True)
    with pytest.raises(ValueError, match="carry o"):
        attend_block(q, k, v, m, l, o.double(), 0, 0, 0.5, True)


def _modelled_kernel(q, k, v, m, l, o, q_off, k_off, scale, causal, lose_last_keys=0):
    """``block_attend`` as the 16-bit kernel computes it: P rounded to the
    input type before P V (l summed from P before rounding); optionally
    with the last keys' P V terms lost."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = (q_off + torch.arange(sq))[:, None] >= (k_off + torch.arange(sk))[None, :]
    if causal:
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    l_new = l * alpha + p.sum(-1)
    p_pv = p.to(q.dtype).float()
    if lose_last_keys:
        p_pv[..., -lose_last_keys:] = 0
    o_new = o * alpha.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p_pv, v.float())
    return m_new, l_new, o_new


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("block", ["diagonal", "past"])
def test_rounding_bound_holds_the_modelled_kernel_and_rejects_a_lost_tile(dtype, block):
    """The bound the card holds the 16-bit kernel to: a kernel that rounds
    P before P V stays within it; one that loses a 16-key step of P V does
    not."""
    b, s, h, d = 2, 64, 2, 32
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv((b, s, h, d), seed=13))
    carry = [torch.from_numpy(x) for x in _carry(b, s, h, d, seed=14)]
    q_off, k_off = _BLOCKS[block][0] * 8, _BLOCKS[block][1] * 8
    bounds = ra.rounding_bound(q, k, v, *carry, q_off, k_off, d**-0.5, True)
    good = _modelled_kernel(q, k, v, *carry, q_off, k_off, d**-0.5, True)
    bad = _modelled_kernel(q, k, v, *carry, q_off, k_off, d**-0.5, True, lose_last_keys=16)
    want = block_attend(q, k, v, *carry, q_off, k_off, d**-0.5, True)
    for got, ref, bound in zip(good, want, bounds):
        assert ((got - ref).abs() / bound).max().item() <= 1.0
    assert ((bad[2] - want[2]).abs() / bounds[2]).max().item() > 1.0


# ---------------------------------------------------------------- carry modes


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_step_modes_start_once_and_finish_once_per_rank(n, causal):
    for rank in range(n):
        modes = ra._step_modes(rank, n, causal)
        assert len(modes) == n
        launched = [t for t, mode in enumerate(modes) if mode is not None]
        # Causal: steps 0 ... rank launch (later ones hold future blocks).
        assert launched == (list(range(rank + 1)) if causal else list(range(n)))
        firsts = [t for t in launched if modes[t] in ("first", "first+last")]
        lasts = [t for t in launched if modes[t] in ("last", "first+last")]
        assert firsts == [launched[0]] and lasts == [launched[-1]]
        if causal:
            assert lasts == [rank]
        assert all(modes[t] == "middle" for t in launched[1:-1])
        assert (modes[launched[0]] == "first+last") == (len(launched) == 1)


def test_step_modes_of_the_two_rank_flagship_ring():
    # The smoke's ring phase: rank 0 runs its diagonal block alone, rank 1
    # its diagonal first and rank 0's block last; a ring of one is one block.
    assert ra._step_modes(0, 2, True) == ["first+last", None]
    assert ra._step_modes(1, 2, True) == ["first", "last"]
    assert ra._step_modes(0, 1, True) == ["first+last"]
    assert ra._step_modes(2, 4, False) == ["first", "middle", "middle", "last"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("block", list(_BLOCKS))
@pytest.mark.parametrize("mode", ra.MODES)
def test_cpu_modes_equal_block_attend_and_finish_bitwise(mode, block, dtype):
    """first: ``block_attend`` from ``_init_carry`` (the carry given is not
    read); middle: from the carry; last: from the carry, then ``_finish``
    into ``out`` (the carry stays); first+last: ``_init_carry``,
    ``block_attend``, ``_finish``. Bit for bit, on the CPU path."""
    b, s, h, d = 2, 8, 3, 4
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv((b, s, h, d), seed=15))
    carry = [torch.from_numpy(x) for x in _carry(b, s, h, d, seed=16)]
    q_off, k_off = _BLOCKS[block]
    start = ra._init_carry(q) if mode in ("first", "first+last") else carry
    want = block_attend(q, k, v, *start, q_off, k_off, 0.5, True)
    before = [t.clone() for t in carry]
    bufs = [t.clone() for t in carry] if mode != "first" else [torch.full_like(t, 7.0) for t in carry]
    out = torch.full(q.shape, 3.0, dtype=dtype) if mode in ("last", "first+last") else None
    if mode == "first+last":
        attend_block(q, k, v, None, None, None, q_off, k_off, 0.5, True, mode=mode, out=out)
    else:
        attend_block(q, k, v, *bufs, q_off, k_off, 0.5, True, mode=mode, out=out)
    if out is not None:
        assert torch.equal(out, ra._finish(want[1], want[2], dtype))
        if mode == "last":
            assert all(torch.equal(a, c) for a, c in zip(bufs, before))  # not written
    else:
        for g, w in zip(bufs, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_one_block_is_one_first_and_last_step(causal):
    # ring_attention(group=None) is _init_carry, block_attend and _finish,
    # bit for bit, through the first+last mode (one mode launch on a card).
    q, k, v = (torch.from_numpy(x) for x in _qkv((2, 16, 4, 8), seed=17))
    modes = dict(ra.mode_launches)
    got = ring_attention(q, k, v, causal=causal)
    assert torch.equal(got, ra.ring_attention_reference(q, k, v, causal))
    assert ra.mode_launches == modes  # a CPU tensor never launches


def test_attend_block_refuses_what_a_mode_cannot_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 8, 2, 4), seed=18))
    m, l, o = (torch.from_numpy(x) for x in _carry(1, 8, 2, 4, seed=18))
    out = torch.empty_like(q)
    with pytest.raises(ValueError, match="unknown carry mode"):
        attend_block(q, k, v, m, l, o, 0, 0, 0.5, True, mode="second")
    with pytest.raises(ValueError, match="out must be"):
        attend_block(q, k, v, m, l, o, 0, 0, 0.5, True, mode="last")
    with pytest.raises(ValueError, match="out must be"):
        attend_block(q, k, v, m, l, o, 0, 0, 0.5, True, mode="last", out=out.double())
    with pytest.raises(ValueError, match="only in the last modes"):
        attend_block(q, k, v, m, l, o, 0, 0, 0.5, True, mode="first", out=out)
    with pytest.raises(ValueError, match="carry m"):
        attend_block(q, k, v, None, None, None, 0, 0, 0.5, True, mode="middle")
    attend_block(q, k, v, None, None, None, 0, 0, 0.5, True, mode="first+last", out=out)
    assert torch.equal(out, ra.ring_attention_reference(q, k, v, True, 0.5))


def test_first_and_last_modes_still_write_over_a_future_block():
    # Only a middle step over a future block is skipped: a first step
    # there writes the empty carry, a last one the carry's output.
    b, s, h, d = 1, 8, 2, 4
    q, k, v = (torch.from_numpy(x) for x in _qkv((b, s, h, d), seed=19))
    carry = [torch.from_numpy(x) for x in _carry(b, s, h, d, seed=19)]
    skips = ra.skips
    bufs = [torch.full_like(t, 5.0) for t in carry]
    attend_block(q, k, v, *bufs, 0, 8, 0.5, True, mode="first")
    assert all(torch.equal(a, c) for a, c in zip(bufs, ra._init_carry(q)))
    out = torch.empty_like(q)
    attend_block(q, k, v, *carry, 0, 8, 0.5, True, mode="last", out=out)
    assert torch.equal(out, ra._finish(carry[1], carry[2], q.dtype))
    assert ra.skips == skips


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("block", ["diagonal", "past"])
def test_finish_bound_holds_the_modelled_kernel_and_rejects_a_lost_tile(dtype, block):
    """The bound the card holds a last step's output to: the modelled
    16-bit kernel's o / l, rounded to the output type, stays within it;
    one that loses a 16-key step of P V does not."""
    b, s, h, d = 2, 64, 2, 32
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv((b, s, h, d), seed=20))
    carry = [torch.from_numpy(x) for x in _carry(b, s, h, d, seed=21)]
    q_off, k_off = _BLOCKS[block][0] * 8, _BLOCKS[block][1] * 8
    args = (q, k, v, *carry, q_off, k_off, d**-0.5, True)
    bound = ra.finish_bound(*args)
    _, l_ref, o_ref = block_attend(*args)
    want = ra._finish(l_ref, o_ref, dtype).float()
    _, l_good, o_good = _modelled_kernel(*args)
    _, l_bad, o_bad = _modelled_kernel(*args, lose_last_keys=16)
    good = ra._finish(l_good, o_good, dtype).float()
    bad = ra._finish(l_bad, o_bad, dtype).float()
    assert ((good - want).abs() / bound).max().item() <= 1.0
    assert ((bad - want).abs() / bound).max().item() > 1.0


def test_one_block_backward_at_another_scale_matches_the_plain_block():
    # The backward differentiates plain attention at the block's scale:
    # the plain block step's gradients at that scale.
    q, k, v = _qkv((1, 8, 2, 4), seed=22)
    w = torch.from_numpy(np.random.default_rng(23).standard_normal(q.shape).astype(np.float32))
    grads = []
    for fn in (lambda *t: ring_attention(*t, scale=0.3),
               lambda *t: ra.ring_attention_reference(*t, True, 0.3)):
        ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        (fn(*ts) * w).sum().backward()
        grads.append([t.grad for t in ts])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------- backward block step


def _qkvw(shape, seed):
    """q, k, v and an upstream gradient, from two seeded draws."""
    return _qkv(shape, seed) + _qkv(shape, seed + 1)[:1]


def _whole_rows(q, k, v, w, causal):
    """lse and delta = rowsum(dO * O) ([b, h, s]) of every row over the
    whole sequence, from numpy, for an upstream gradient ``w``."""
    s = q.shape[1]
    scores = np.einsum("bqhd,bkhd->bhqk", q, k).astype(np.float64) * q.shape[-1] ** -0.5
    if causal:
        scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    mx = scores.max(-1, keepdims=True)
    lse = (mx + np.log(np.exp(scores - mx).sum(-1, keepdims=True)))[..., 0]
    out = np.einsum("bhqk,bkhd->bqhd", np.exp(scores - lse[..., None]), v)
    delta = np.einsum("bqhd,bqhd->bhq", w, out)
    return lse.astype(np.float32), delta.astype(np.float32)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_block_grads_summed_over_blocks_match_jax_grad(n, causal):
    """``attend_block_grads`` over every (query block, key block) pair of a
    sequence cut into n blocks, from the whole rows' lse and delta, adds up
    to ``jax.grad`` of tpusnap's ring attention on the whole sequence."""
    import jax
    import jax.numpy as jnp

    from tpusnap.ops import ring_attention as jax_ring_attention

    b, s, h, d = 2, 16, 2, 8
    q, k, v = _qkv((b, s, h, d), seed=30 + n)
    w = np.random.default_rng(40 + n).standard_normal(q.shape).astype(np.float32)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jax_ring_attention(q, k, v, causal=causal) * w), argnums=(0, 1, 2)
    )(*(jnp.asarray(x) for x in (q, k, v)))
    lse, delta = (torch.from_numpy(x) for x in _whole_rows(q, k, v, w, causal))
    tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
    dq, dk, dv = (torch.zeros((b, s, h, d)) for _ in range(3))
    blk = s // n
    rows = [slice(i * blk, (i + 1) * blk) for i in range(n)]
    routes, skips = dict(ra.backward_route_launches), ra.backward_skips
    computed = 0
    for i, qi in enumerate(rows):
        for j, kj in enumerate(rows):
            computed += ra.attend_block_grads(
                tq[:, qi], tk[:, kj], tv[:, kj], tw[:, qi], lse[:, :, qi].contiguous(),
                delta[:, :, qi].contiguous(), dq[:, qi], dk[:, kj], dv[:, kj], i * blk, j * blk,
                d**-0.5, causal,
            )
    assert computed == (n * (n + 1) // 2 if causal else n * n)
    assert ra.backward_skips == skips + n * n - computed
    assert ra.backward_route_launches == routes  # a CPU tensor never launches
    for name, got, ref in zip("qkv", (dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, err_msg=name)


def test_attend_block_grads_skips_a_future_block_without_a_call(monkeypatch):
    b, s, h, d = 1, 8, 2, 4
    q, k, v = (torch.from_numpy(x) for x in _qkv((b, s, h, d), seed=31))
    do = torch.ones_like(q)
    lse, delta = torch.zeros((b, h, s)), torch.zeros((b, h, s))
    acc = [torch.randn((b, s, h, d)) for _ in range(3)]
    before = [t.clone() for t in acc]

    def called(*args):
        raise AssertionError("block_grads ran for a future block")

    monkeypatch.setattr(ra, "block_grads", called)
    skips = ra.backward_skips
    assert not ra.attend_block_grads(q, k, v, do, lse, delta, *acc, 0, s, 0.5, True)
    assert ra.backward_skips == skips + 1
    assert all(torch.equal(a, c) for a, c in zip(acc, before))
    # Without the mask no block is in the future.
    monkeypatch.undo()
    assert ra.attend_block_grads(q, k, v, do, lse, delta, *acc, 0, s, 0.5, False)


def test_attend_block_grads_adds_block_grads_in_place_on_the_cpu():
    b, s, h, d = 2, 8, 3, 4
    q, k, v, w = (torch.from_numpy(x) for x in _qkvw((b, s, h, d), 32))
    lse, delta = torch.randn((b, h, s)), torch.randn((b, h, s))
    acc = [torch.randn((b, s, h, d)) for _ in range(3)]
    want = [a + g for a, g in zip(acc, block_grads(q, k, v, w, lse, delta, 8, 0, 0.5, True))]
    ptrs = [t.data_ptr() for t in acc]
    assert ra.attend_block_grads(q, k, v, w, lse, delta, *acc, 8, 0, 0.5, True)
    assert [t.data_ptr() for t in acc] == ptrs
    for got, ref in zip(acc, want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def _grads_args(shape=(1, 8, 2, 4), seed=34):
    b, s, h, d = shape
    q, k, v, w = (torch.from_numpy(x) for x in _qkvw(shape, seed))
    return [q, k, v, w, torch.zeros((b, h, s)), torch.zeros((b, h, s)),
            torch.zeros(shape), torch.zeros(shape), torch.zeros(shape)]


_REFUSALS = {
    "q_3d": (0, lambda t: t[0], "q must be"),
    "grad_out_3d": (3, lambda t: t[0], "grad_out must be"),
    "k_dtype": (1, lambda t: t.double(), "dtypes differ"),
    "grad_out_dtype": (3, lambda t: t.to(torch.bfloat16), "dtypes differ"),
    "v_shape": (2, lambda t: t[:, :, :1], "do not fit q"),
    "k_heads": (1, lambda t: torch.cat([t, t], 2), "do not fit q"),
    "grad_out_shape": (3, lambda t: t[:, :4], "is not q's shape"),
    "lse_shape": (4, lambda t: t[:, :, :4], "lse must be"),
    "delta_dtype": (5, lambda t: t.double(), "delta must be"),
    "dq_dtype": (6, lambda t: t.to(torch.bfloat16), "dq must be"),
    "dk_shape": (7, lambda t: t[:, :4], "dk must be"),
    "dv_missing": (8, lambda t: None, "dv must be"),
    "device": (8, lambda t: torch.empty(t.shape, device="meta"), "different devices"),
}


@pytest.mark.parametrize("case", list(_REFUSALS))
def test_attend_block_grads_refuses_what_check_block_refuses(case):
    index, change, message = _REFUSALS[case]
    args = _grads_args()
    args[index] = change(args[index])
    with pytest.raises(ValueError, match=message):
        ra.attend_block_grads(*args, 0, 0, 0.5, True)


def test_grads_route_takes_what_tma_describes():
    q, k, v, w = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkvw((1, 8, 2, 16), 35))
    assert ra._grads_route(q, k, v, w) == "wgmma"
    assert ra._grads_route(q.float(), k.float(), v.float(), w.float()) == "simt"
    # A grad_out whose rows are not 16 bytes apart: simt.
    odd = torch.zeros((1, 8, 2, 20), dtype=torch.bfloat16)[..., :16]
    assert ra._grads_route(q, k, v, odd) == "simt"


def _modelled_grads(q, k, v, do, lse, delta, q_off, k_off, scale, causal, lose_tile=0):
    """``block_grads`` as the 16-bit kernel computes it: P and dS rounded to
    the input type before the second-stage products; optionally with the
    first ``lose_tile`` x ``lose_tile`` (query, key) tile's terms lost."""
    qf, kf, vf, dof, p, dp = ra._grads_terms(q, k, v, do, lse, q_off, k_off, scale, causal)
    ds = p * (dp - delta[..., None])
    p_r, ds_r = p.to(q.dtype).float(), ds.to(q.dtype).float()
    if lose_tile:
        p_r[..., :lose_tile, :lose_tile] = 0
        ds_r[..., :lose_tile, :lose_tile] = 0
    dv = torch.matmul(p_r.transpose(-1, -2), dof)
    dq = torch.matmul(ds_r, kf) * scale
    dk = torch.matmul(ds_r.transpose(-1, -2), qf) * scale
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("block", ["diagonal", "past"])
def test_grads_rounding_bound_holds_the_modelled_kernel_and_rejects_a_lost_tile(dtype, block):
    """The bound the card holds the 16-bit backward kernel to: a kernel
    that rounds P and dS before the second-stage products stays within
    it on every accumulator; one that loses a 16 x 16 tile's terms does
    not."""
    b, s, h, d = 2, 64, 2, 32
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in _qkvw((b, s, h, d), 37))
    q_off, k_off = _BLOCKS[block][0] * 8, _BLOCKS[block][1] * 8
    scale = d**-0.5
    lse, delta, _ = ra.row_stats(q, k, v, do, q_off, k_off, scale, True)
    acc = [torch.from_numpy(x) for x in _qkv((b, s, h, d), 39)]
    args = (q, k, v, do, lse, delta)
    want = [a + g for a, g in zip(acc, block_grads(*args, q_off, k_off, scale, True))]
    bounds = ra.grads_rounding_bound(*args, want, q_off, k_off, scale, True)
    good = [a + g for a, g in zip(acc, _modelled_grads(*args, q_off, k_off, scale, True))]
    bad = [a + g for a, g in zip(acc, _modelled_grads(*args, q_off, k_off, scale, True, 16))]
    for got, ref, bound in zip(good, want, bounds):
        assert ((got - ref).abs() / bound).max().item() <= 1.0
    for got, ref, bound in zip(bad, want, bounds):
        assert ((got - ref).abs() / bound).max().item() > 1.0


# ------------------------------------------- store mode, delta, the ring of one


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("block", ["diagonal", "past"])
def test_attend_block_grads_store_mode_writes_block_grads(dtype, block):
    """``mode="store"`` writes ``block_grads`` once, cast to q's dtype, into
    outputs of q's dtype, whatever they held; the accumulate mode on the
    same inputs adds the same f32 terms (bit for bit on the CPU)."""
    b, s, h, d = 2, 8, 3, 4
    q, k, v, w = (torch.from_numpy(x).to(dtype) for x in _qkvw((b, s, h, d), 41))
    q_off, k_off = _BLOCKS[block]
    lse, delta, _ = ra.row_stats(q, k, v, w, q_off, k_off, 0.5, True)
    want = block_grads(q, k, v, w, lse, delta, q_off, k_off, 0.5, True)
    out = [torch.full((b, s, h, d), 7.0, dtype=dtype) for _ in range(3)]
    assert ra.attend_block_grads(q, k, v, w, lse, delta, *out, q_off, k_off, 0.5, True,
                                 mode="store")
    for got, ref in zip(out, want):
        assert got.dtype == dtype and torch.equal(got, ref.to(dtype))
    acc = [torch.zeros((b, s, h, d)) for _ in range(3)]
    ra.attend_block_grads(q, k, v, w, lse, delta, *acc, q_off, k_off, 0.5, True)
    for got, ref in zip(acc, want):
        assert torch.equal(got, ref)


def test_attend_block_grads_store_mode_zeroes_a_future_block():
    """A future block in store mode launches nothing and writes zeros (its
    gradient)."""
    args = _grads_args()
    args[6:] = [torch.full_like(t, 3.0) for t in args[6:]]
    skips = ra.backward_skips
    assert not ra.attend_block_grads(*args, 0, 8, 0.5, True, mode="store")
    assert ra.backward_skips == skips + 1
    assert all(torch.equal(t, torch.zeros_like(t)) for t in args[6:])


@pytest.mark.parametrize("case", ["mode", "path", "store_f32_outputs_of_bf16"])
def test_attend_block_grads_refuses_a_mode_path_or_output_type(case):
    args = _grads_args()
    kwargs = {"mode": "store"}
    if case == "mode":
        kwargs, message = {"mode": "add"}, "unknown write mode"
    elif case == "path":
        kwargs, message = {"path": "dense"}, "unknown backward path"
    else:
        args[:4] = [t.to(torch.bfloat16) for t in args[:4]]
        message = "dq must be bfloat16"
    with pytest.raises(ValueError, match=message):
        ra.attend_block_grads(*args, 0, 0, 0.5, True, **kwargs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_attention_delta_plain_version_is_the_old_expression(dtype):
    """The delta pass on the CPU is the backward's old expression,
    ``(dO.float() * O.float()).sum(-1).transpose(1, 2).contiguous()``, bit
    for bit, also for a head-split view of O."""
    b, s, h, d = 2, 9, 3, 8
    rng = np.random.default_rng(42)
    w = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32)).to(dtype)
    fused = torch.from_numpy(rng.standard_normal((b, s, 2 * h * d)).astype(np.float32)).to(dtype)
    for out in (w.flip(1).contiguous(), fused[..., h * d:].reshape(b, s, h, d)):
        old = (w.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        got = ra.attention_delta(w, out)
        assert got.is_contiguous() and got.dtype == torch.float32
        assert torch.equal(got, old)
        assert torch.equal(ra.attention_delta_reference(w, out), old)


def test_attention_delta_refuses_mismatched_inputs():
    w = torch.zeros((1, 4, 2, 8))
    for out in (torch.zeros((1, 4, 2, 4)), w.double(), torch.zeros((4, 2, 8))):
        with pytest.raises(ValueError, match="one \\[b, s, h, d\\] shape and dtype"):
            ra.attention_delta(w, out)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_ring_of_one_grads_at_another_scale_match_tpusnap(causal):
    """``ring_attention(group=None, scale=0.3)`` under grad (``_RingBlock``:
    first and ``_finish`` keeping the carry, then the delta pass and
    ``attend_block_grads`` in store mode) against ``jax.grad`` of tpusnap's
    ``ring_attention(axis_name=None, scale=0.3)``; f32, atol 1e-5 as the
    file's other ring cases."""
    import jax
    import jax.numpy as jnp

    from tpusnap.ops import ring_attention as jax_ring_attention

    q, k, v = _qkv((2, 12, 2, 8), seed=43)
    w = np.random.default_rng(44).standard_normal(q.shape).astype(np.float32)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jax_ring_attention(q, k, v, causal=causal, scale=0.3) * w),
        argnums=(0, 1, 2),
    )(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    paths = dict(ra.backward_path_launches)
    (ring_attention(tq, tk, tv, causal=causal, scale=0.3) * torch.from_numpy(w)).sum().backward()
    assert ra.backward_path_launches == paths  # a CPU tensor never launches
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ring_of_one_under_grad_equals_no_grad_bitwise(dtype):
    """Under grad the ring of one keeps its carry (``first``, then
    ``_finish``); its output equals the ``no_grad`` ``first+last`` step's
    bit for bit."""
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv((2, 16, 2, 8), seed=45))
    with torch.no_grad():
        plain = ring_attention(q, k, v)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ring_attention(*leaves)
    assert out.grad_fn is not None and torch.equal(out.detach(), plain)


def test_grads_route_takes_simt_past_head_dim_128():
    """The wgmma backward takes head_dim up to 128; 256 (which the flash
    forward takes on wgmma) goes to the simt backward."""
    q, k, v, w = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkvw((1, 8, 2, 128), 46))
    assert ra._grads_route(q, k, v, w) == "wgmma"
    q, k, v, w = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkvw((1, 8, 2, 256), 46))
    assert ra._grads_route(q, k, v, w) == "simt"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_grads_rounding_bound_in_store_mode_holds_the_modelled_kernel(dtype):
    """Store mode: the modelled 16-bit kernel's gradients rounded once to
    the input type stay within ``grads_rounding_bound(..., store=True)``
    of ``block_grads``; with a 16 x 16 tile lost they do not."""
    b, s, h, d = 2, 64, 2, 32
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in _qkvw((b, s, h, d), 47))
    scale = d**-0.5
    lse, delta, _ = ra.row_stats(q, k, v, do, 0, 0, scale, True)
    args = (q, k, v, do, lse, delta)
    want = block_grads(*args, 0, 0, scale, True)
    bounds = ra.grads_rounding_bound(*args, want, 0, 0, scale, True, store=True)
    good = [g.to(dtype).float() for g in _modelled_grads(*args, 0, 0, scale, True)]
    bad = [g.to(dtype).float() for g in _modelled_grads(*args, 0, 0, scale, True, 16)]
    for got, ref, bound in zip(good, want, bounds):
        assert ((got - ref).abs() / bound).max().item() <= 1.0
    for got, ref, bound in zip(bad, want, bounds):
        assert ((got - ref).abs() / bound).max().item() > 1.0
