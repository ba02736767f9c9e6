"""tpusnap_torch on the card: the Hopper flash kernel against its plain
version, and a snapshot round trip of CUDA tensors.

Every test here carries the ``cuda`` marker and skips without a card (the
kernel has no CPU mode). The file imports neither JAX nor ``tpusnap``, so
it runs on a machine that has only PyTorch; from the repo root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from tpusnap_torch import Snapshot, StateDict
from tpusnap_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


# f32: only the summation order differs from the plain version (2e-5 is
# the repo's f32 tolerance for this kernel). bf16/f16: the output is
# rounded to the input type, one ulp of a value in [1, 2) being 7.8e-3
# (bf16) and 9.8e-4 (f16), so a rounding flip costs at most that.
_CASES = [
    ((1, 200, 4, 64), torch.float32, True, 2e-5),
    ((1, 200, 4, 64), torch.float32, False, 2e-5),
    ((2, 16, 2, 8), torch.float32, False, 2e-5),
    ((2, 130, 2, 128), torch.float16, True, 2e-3),
    ((1, 96, 2, 256), torch.bfloat16, True, 1.6e-2),
    ((2, 64, 3, 40), torch.bfloat16, False, 1.6e-2),
]


@pytest.mark.parametrize(
    "shape,dtype,causal,atol", _CASES, ids=lambda x: str(x).replace(" ", "")
)
def test_kernel_matches_plain(gen, shape, dtype, causal, atol):
    q, k, v = (
        torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3)
    )
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal)
    assert fa.launches == before + 1
    ref = fa.flash_attention_reference(q, k, v, causal)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


def test_kernel_reads_strided_views(gen):
    """q, k, v as head-split views of one fused projection, as the model
    passes them: no copy, the kernel walks the strides."""
    b, s, h, d = 2, 100, 4, 32
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda")
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v)
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
