"""tpusnap_torch on the card: the Hopper flash kernels against their plain
version, and a snapshot round trip of CUDA tensors.

Every test here carries the ``cuda`` marker and skips without a card (the
kernels have no CPU mode). The file imports neither JAX nor ``tpusnap``,
so it runs on a machine that has only PyTorch; from the repo root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

import itertools

import pytest
import torch

from tpusnap_torch import Snapshot, StateDict
from tpusnap_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _launch(q, k, v, causal, route):
    """One kernel launch; asserts it took ``route``."""
    before = dict(fa.route_launches)
    out = fa.flash_attention(q, k, v, causal=causal)
    after = fa.route_launches
    assert after[route] == before[route] + 1 and sum(after.values()) == sum(before.values()) + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    return out


def _assert_within_rounding_bound(out, q, k, v, causal):
    """16-bit: |out - ref| <= u·(P·|V|) + 2 ulps·|ref| + 1e-5 per element
    (``fa.rounding_bound``: the kernel rounds P to the input type)."""
    ref = fa.flash_attention_reference(q, k, v, causal).float()
    ratio = ((out.float() - ref).abs() / fa.rounding_bound(q, k, v, causal)).max().item()
    assert ratio <= 1.0, f"worst element {ratio}x its bound"


def _fused_views(shape, dtype, gen):
    """q, k, v as the model passes them: head-split views of one fused qkv
    projection (none is contiguous)."""
    b, s, h, d = shape
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(dtype)
    return tuple(t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))


# f32 (the simt route): only the summation order differs from the plain
# version; 2e-5 is the repo's f32 tolerance for this kernel. bf16/f16 (the
# wgmma route): the per-element rounding bound.
_CASES = [
    ((1, 200, 4, 64), torch.float32, True, 2e-5),
    ((1, 200, 4, 64), torch.float32, False, 2e-5),
    ((2, 16, 2, 8), torch.float32, False, 2e-5),
    ((2, 130, 2, 128), torch.float16, True, None),
    ((1, 96, 2, 256), torch.bfloat16, True, None),
    ((2, 64, 3, 40), torch.bfloat16, False, None),
]


@pytest.mark.parametrize(
    "shape,dtype,causal,atol", _CASES, ids=lambda x: str(x).replace(" ", "")
)
def test_kernel_matches_plain(gen, shape, dtype, causal, atol):
    q, k, v = (
        torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3)
    )
    out = _launch(q, k, v, causal, "simt" if dtype == torch.float32 else "wgmma")
    if atol is None:
        _assert_within_rounding_bound(out, q, k, v, causal)
    else:
        ref = fa.flash_attention_reference(q, k, v, causal)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.parametrize(
    "dtype,causal,s,d",
    list(itertools.product((torch.bfloat16, torch.float16), (True, False),
                           (1, 130, 200, 1000), (8, 40, 64, 128, 256))),
    ids=lambda x: str(x).replace("torch.", ""),
)
def test_wgmma_ragged_shapes(gen, dtype, causal, s, d):
    """s not a multiple of 64 or 128, d not a multiple of 64: TMA's zero
    fill and the kernel's mask handle both edges."""
    q, k, v = (
        torch.randn((2, s, 3, d), generator=gen, device="cuda").to(dtype) for _ in range(3)
    )
    out = _launch(q, k, v, causal, "wgmma")
    _assert_within_rounding_bound(out, q, k, v, causal)


@pytest.mark.parametrize(
    "dtype,causal,d",
    list(itertools.product((torch.bfloat16, torch.float16), (True, False), (40, 64, 128))),
    ids=lambda x: str(x).replace("torch.", ""),
)
def test_wgmma_reads_fused_qkv_views(gen, dtype, causal, d):
    q, k, v = _fused_views((2, 333, 4, d), dtype, gen)
    assert not v.is_contiguous()
    out = _launch(q, k, v, causal, "wgmma")
    _assert_within_rounding_bound(out, q, k, v, causal)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_wgmma_is_bitwise_repeatable(gen, dtype):
    """A fixed reduction order: two launches on the same inputs agree bit
    for bit (the post-restore train step relies on it)."""
    q, k, v = _fused_views((2, 1024, 8, 64), dtype, gen)
    first = _launch(q, k, v, True, "wgmma")
    second = _launch(q, k, v, True, "wgmma")
    assert torch.equal(first, second)


@pytest.mark.parametrize("layout", ["d4", "misaligned_base"])
def test_16bit_layouts_tma_cannot_describe_take_simt(gen, layout):
    if layout == "d4":
        q, k, v = (
            torch.randn((2, 70, 2, 4), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)
        )
    else:  # one element past a 16-byte boundary
        flat = torch.randn((3, 1 + 70 * 2 * 64), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = (row[1:].view(1, 70, 2, 64) for row in flat)
    out = _launch(q, k, v, True, "simt")
    _assert_within_rounding_bound(out, q, k, v, True)


def test_kernel_reads_strided_views(gen):
    """q, k, v as head-split views of one fused projection, as the model
    passes them: no copy, the kernel walks the strides."""
    q, k, v = _fused_views((2, 100, 4, 32), torch.float32, gen)
    assert not q.is_contiguous()
    out = _launch(q, k, v, True, "simt")
    ref = fa.flash_attention_reference(q, k, v, True)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)


def test_wrapper_rejects_strided_head_dim(gen):
    x = torch.randn((1, 8, 2, 16), generator=gen, device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(x, x, x)


def test_cuda_snapshot_round_trip_in_place(gen, tmp_path):
    """Small tensors go through the slab packed on the card, the large one
    through its own pinned DtoH; restore lands in place on the card."""
    state = {
        "w": torch.nn.Parameter(torch.randn((512, 1024), generator=gen, device="cuda")),
        "b": torch.randn((1024,), generator=gen, device="cuda").to(torch.bfloat16),
        "mask": torch.randn((33,), generator=gen, device="cuda") > 0,
        "step": torch.tensor(7, dtype=torch.int32, device="cuda"),
    }
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"s": StateDict(state)})
    targets = {k: torch.zeros_like(v) for k, v in state.items()}
    targets["w"] = torch.nn.Parameter(targets["w"])
    ids = {k: id(v) for k, v in targets.items()}
    restored = StateDict(targets)
    Snapshot(path).restore({"s": restored})
    for k, v in state.items():
        assert id(restored[k]) == ids[k], k
        assert restored[k].is_cuda and torch.equal(restored[k], v), k
    got = Snapshot(path).read_object("0/s/b")
    assert got.device.type == "cpu" and torch.equal(got, state["b"].cpu())


@pytest.mark.parametrize("budget", [None, 1 << 20], ids=["whole", "tiled"])
def test_cuda_target_of_another_shape_stays_on_card(gen, tmp_path, budget):
    """A CUDA target whose shape differs from the stored one cannot be
    filled in place; the restored tensor lands on the target's device
    (tpusnap device_puts onto the target's sharding), never on the host."""
    w = torch.randn((512, 1024), generator=gen, device="cuda")
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"s": StateDict(w=w)})
    target = torch.zeros((4, 4), device="cuda")
    got = Snapshot(path).read_object("0/s/w", obj_out=target, memory_budget_bytes=budget)
    assert got is not target and got.is_cuda
    assert torch.equal(got, w)
    restored = StateDict(w=torch.zeros((8,), device="cuda"))
    Snapshot(path).restore({"s": restored})
    assert restored["w"].is_cuda and torch.equal(restored["w"], w)
