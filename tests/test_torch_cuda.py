"""tpusnap_torch on the card: the Hopper flash kernels against their plain
version, snapshot round trips of CUDA tensors (chunked ones too), async
takes followed at once by in-place updates, async restores, two ranks
sharing the card (replicated state, and DTensor state restored in place),
host-offloaded (pinned) state restored in place and kept pinned, the MoE
flagship training, embedding tables with pinned DTensor shards, delta
stream captures (at mark_step, and free-running under a side stream),
CUDA state through the write-back tier and the CAS store, ``analyze``
and the restore's ``consume`` spans over CUDA copies, and the CLI
leaving CUDA uninitialised, and every example and benchmark harness of
the port run with ``--device cuda``.

Every test here carries the ``cuda`` marker and skips without a card (the
kernels have no CPU mode). The file imports neither JAX nor ``tpusnap``,
so it runs on a machine that has only PyTorch; from the repo root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

import itertools
import os

import pytest
import torch

from tpusnap_torch import Snapshot, StateDict
from tpusnap_torch.io_preparers import array as array_preparer
from tpusnap_torch.knobs import override_async_stage_window_bytes, override_max_chunk_size_bytes
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


def _busy(stream, gen):
    """Queue a few ms of work on ``stream``, so that copies ordered only
    after what was queued before would race what is queued after."""
    with torch.cuda.stream(stream):
        x = torch.randn((2048, 2048), generator=gen, device="cuda")
        for _ in range(20):
            x = x @ x / 2048.0
    return x


@pytest.mark.parametrize(
    "mode", ["state_inside_window", "state_larger_than_window", "no_room_for_copies"]
)
def test_async_take_then_in_place_updates(gen, tmp_path, monkeypatch, mode):
    """The snapshot holds the state as of async_take although the caller
    updates every tensor in place on its stream right after the return:
    whole-window staging, device copies of the residual windows, or (no
    free memory for them) everything staged before the return."""
    state = {f"t{i}": torch.randn((256, 1024), generator=gen, device="cuda") for i in range(8)}
    state["half"] = torch.randn((512, 512), generator=gen, device="cuda").to(torch.bfloat16)
    state["small_a"] = torch.arange(100, dtype=torch.int32, device="cuda")  # device slab
    state["small_b"] = torch.randn((33,), generator=gen, device="cuda")
    state["big"] = torch.randn((1000, 700), generator=gen, device="cuda")  # chunked
    witness = {k: v.clone() for k, v in state.items()}
    # Only the two small tensors share a (device) slab.
    monkeypatch.setenv("TPUSNAP_SLAB_SIZE_THRESHOLD_BYTES", str(64 << 10))
    if mode == "no_room_for_copies":
        monkeypatch.setattr(array_preparer, "_room_for_device_copies", lambda device: 0)
    window = 1 << 30 if mode == "state_inside_window" else 2 << 20
    stream = torch.cuda.Stream()
    path = str(tmp_path / "snap")
    with override_async_stage_window_bytes(window), override_max_chunk_size_bytes(1 << 20):
        _busy(stream, gen)
        with torch.cuda.stream(stream):
            pending = Snapshot.async_take(path, {"s": StateDict(state)})
            assert pending.staged()  # CUDA state is frozen at the return
            for v in state.values():
                v.add_(1)
        snap = pending.wait()
    assert snap.metadata.manifest["0/s/big"].type == "ChunkedTensor"
    targets = StateDict({k: torch.zeros_like(v) for k, v in state.items()})
    Snapshot(path).restore({"s": targets})
    for k, v in witness.items():
        assert torch.equal(targets[k], v), k
        assert not torch.equal(state[k], v), k  # the updates did land


def test_chunked_cuda_tensor_restores_in_place(gen, tmp_path):
    w = torch.randn((1000, 700), generator=gen, device="cuda")  # 3 chunks, ragged
    path = str(tmp_path / "snap")
    with override_max_chunk_size_bytes(1 << 20):
        snap = Snapshot.take(path, {"s": StateDict(w=w, h=w.to(torch.float16))})
    assert [c.sizes[0] for c in snap.metadata.manifest["0/s/w"].chunks] == [374, 374, 252]
    targets = {"w": torch.zeros_like(w), "h": torch.zeros_like(w, dtype=torch.float16)}
    ids = {k: id(v) for k, v in targets.items()}
    restored = StateDict(dict(targets))
    Snapshot(path).restore({"s": restored})
    assert {k: id(v) for k, v in restored.items()} == ids
    assert torch.equal(restored["w"], w) and torch.equal(restored["h"], w.to(torch.float16))
    out = torch.zeros_like(w)
    got = Snapshot(path).read_object("0/s/w", obj_out=out, memory_budget_bytes=256 << 10)
    assert got is out and torch.equal(out, w)


def test_async_restore_onto_card_is_ordered_before_callers_stream(gen, tmp_path):
    w = torch.randn((1024, 1024), generator=gen, device="cuda")
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"s": StateDict(w=w)})
    target = torch.zeros_like(w)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        pending = Snapshot(path).async_restore({"s": StateDict(w=target)})
        pending.wait()
        seen = target * 1  # the caller's next kernel on its own stream
    stream.synchronize()
    assert torch.equal(seen, w)


def _written_blobs(root):
    """Payload files only: not the metadata, not the .tpusnap/ sidecars."""
    return sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _, fs in os.walk(root) for f in fs
        if f != ".snapshot_metadata" and ".tpusnap" not in os.path.relpath(d, root)
    )


def test_device_slab_member_dedup_compacts(gen, tmp_path, monkeypatch):
    """Small CUDA tensors are packed into one slab on the card; in an
    increment the unchanged members are dropped and the slab compacted to
    the changed one, hashed from the pinned slab."""
    from tpusnap_torch import batcher

    state = {f"p{i}": torch.randn((256,), generator=gen, device="cuda") for i in range(6)}
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    staged = []
    real = batcher.DeviceBatchedBufferStager._stage_blocking
    monkeypatch.setattr(
        batcher.DeviceBatchedBufferStager, "_stage_blocking",
        lambda self: staged.append(self) or real(self),
    )
    Snapshot.take(base, {"app": StateDict(state)})
    state["p3"].add_(1.0)
    Snapshot.take(inc, {"app": StateDict(state)}, incremental_from=base)
    assert len(staged) == 2  # both takes packed their slab on the card
    assert staged[1].get_staging_cost_bytes() == 2 * staged[1].total
    m = Snapshot(inc).metadata.manifest
    assert m["0/app/p3"].byte_range == [0, 1024]
    assert sum(m[k].location.startswith("../") for k in m if k.startswith("0/app/p")) == 5
    targets = StateDict({k: torch.zeros_like(v) for k, v in state.items()})
    Snapshot(inc).restore({"app": targets})
    for k, v in state.items():
        assert targets[k].is_cuda and torch.equal(targets[k], v), k
    assert Snapshot(inc).verify().clean


@pytest.mark.parametrize("shape", [(4, 4), None], ids=["other_shape", "same_shape"])
def test_compressed_budget_tiled_restore_into_cuda_target(gen, tmp_path, monkeypatch, shape):
    """A compressed blob read under a budget into a CUDA target: each tile
    group is decompressed into a pinned buffer and copied into the
    target's rows on the card; a target of another shape gets a new
    tensor on the card. Never a CPU tensor."""
    monkeypatch.setenv("TPUSNAP_COMPRESS", "on")
    monkeypatch.setenv("TPUSNAP_COMPRESS_MIN_BLOB_BYTES", "65536")
    monkeypatch.setenv("TPUSNAP_TILE_CHECKSUM_BYTES", str(1 << 18))
    w = torch.randn((2048, 512), generator=gen, device="cuda").to(torch.bfloat16)
    path = str(tmp_path / "snap")
    snap = Snapshot.take(path, {"s": StateDict(w=w)})
    entry = snap.metadata.manifest["0/s/w"]
    assert entry.codec == "shuf2+lz4" and len(entry.comp_tile_sizes) == 8
    target = torch.zeros(shape or w.shape, dtype=w.dtype, device="cuda")
    got = Snapshot(path).read_object("0/s/w", obj_out=target, memory_budget_bytes=1 << 19)
    assert got.is_cuda and torch.equal(got, w)
    assert (got is target) == (shape is None)
    upcast = torch.zeros(w.shape, device="cuda")  # f32 target of the bf16 blob
    Snapshot(path).restore({"s": StateDict(w=upcast)})
    assert torch.equal(upcast, w.float())


def test_cast_on_save_of_cuda_sources_under_async_take(gen, tmp_path, monkeypatch):
    """cast_on_save on CUDA tensors under an async take larger than its
    window: the freeze copies the raw sources, the cast runs on the card
    at stage time, and the caller's in-place updates after the return do
    not reach the snapshot."""
    from tpusnap_torch import cast_on_save

    state = {f"t{i}": torch.randn((512, 1024), generator=gen, device="cuda") for i in range(6)}
    state["small_a"] = torch.randn((64,), generator=gen, device="cuda")
    state["small_b"] = torch.randn((64,), generator=gen, device="cuda")
    witness = {k: v.to(torch.bfloat16) for k, v in state.items()}
    # The two small tensors share a host slab (a transform keeps them out
    # of the device pack); the large ones stage and freeze one by one.
    monkeypatch.setenv("TPUSNAP_SLAB_SIZE_THRESHOLD_BYTES", str(64 << 10))
    path = str(tmp_path / "snap")
    with override_async_stage_window_bytes(4 << 20):
        pending = Snapshot.async_take(
            path, {"s": StateDict(state)},
            _custom_array_prepare_func=cast_on_save({"s/*": torch.bfloat16}),
        )
        assert pending.staged()
        for v in state.values():
            v.add_(1)
        snap = pending.wait()
    assert snap.metadata.manifest["0/s/small_a"].location.startswith("batched/")
    targets = StateDict({k: torch.zeros_like(v) for k, v in state.items()})
    Snapshot(path).restore({"s": targets})
    for k, v in witness.items():
        assert snap.metadata.manifest[f"0/s/{k}"].dtype == "bfloat16"
        assert targets[k].is_cuda and torch.equal(targets[k], v.float()), k


def test_async_incremental_take_is_staged_at_return(gen, tmp_path):
    """An async incremental take stages everything before it returns: the
    caller may update its CUDA state in place at once, and only the
    changed tensor is written."""
    state = {f"t{i}": torch.randn((256, 1024), generator=gen, device="cuda") for i in range(4)}
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    with override_async_stage_window_bytes(1 << 20):
        Snapshot.take(base, {"s": StateDict(state)})
        state["t2"].mul_(2)
        witness = {k: v.clone() for k, v in state.items()}
        pending = Snapshot.async_take(inc, {"s": StateDict(state)}, incremental_from=base)
        assert pending.staged()
        for v in state.values():
            v.add_(1)
        pending.wait()
    blobs = _written_blobs(inc)  # the device slab, compacted to t2
    assert len(blobs) == 1 and os.path.getsize(os.path.join(inc, blobs[0])) == 256 * 1024 * 4
    targets = StateDict({k: torch.zeros_like(v) for k, v in state.items()})
    Snapshot(inc).restore({"s": targets})
    for k, v in witness.items():
        assert torch.equal(targets[k], v), k


# --- two ranks on the one card (gloo group, the port's store communicator) ---


def _card_state(rank):
    """Replicated values (the same on both ranks, from one seed) and one
    per-rank value, all on the card."""
    g = torch.Generator(device="cuda").manual_seed(0)
    state = {f"r{i}": torch.randn((64 * (i + 1), 1024), generator=g, device="cuda") for i in range(6)}
    state["own"] = torch.full((4096,), float(rank), device="cuda")
    return state


def _world_two_rank_take_stages_assigned_units(snap_dir):
    from tpusnap_torch import scheduler
    from tpusnap_torch.comm import get_communicator
    from tpusnap_torch.partitioner import assign_replicated_units, estimate_write_loads

    torch.cuda.set_device(0)
    comm = get_communicator()
    staged = []
    orig = scheduler._WritePipeline.stage

    async def stage(self, executor):
        result = await orig(self, executor)
        staged.append(self.buf_size)
        return result

    scheduler._WritePipeline.stage = stage
    state = _card_state(comm.rank)
    Snapshot.take(snap_dir, {"s": StateDict(state)}, replicated=["s/r*"])
    # The same plan the take computed: each rank copied to the host the
    # bytes of the units assigned to it and of its own value, no more.
    flat = {f"s/{k}": v for k, v in state.items()}
    units, base, _ = estimate_write_loads(flat, sorted(p for p in flat if "/r" in p))
    per_rank = comm.all_gather_object((units, base))
    assignment, _ = assign_replicated_units([u for u, _ in per_rank], [b for _, b in per_rank])
    mine = sum(c for u, c in units if assignment[u] == comm.rank) + base
    assert sum(staged) == mine, (comm.rank, sum(staged), mine)
    assert len(set(assignment.values())) == 2, assignment
    targets = StateDict({k: torch.zeros_like(v) for k, v in state.items()})
    Snapshot(snap_dir).restore({"s": targets})
    for k, v in state.items():
        assert targets[k].is_cuda and torch.equal(targets[k], v), k


def _world_two_rank_async_take_in_place(snap_dir):
    from tpusnap_torch.comm import get_communicator

    torch.cuda.set_device(0)
    comm = get_communicator()
    state = _card_state(comm.rank)
    witness = {k: v.clone() for k, v in state.items()}
    with override_async_stage_window_bytes(2 << 20):  # residual windows frozen on the card
        pending = Snapshot.async_take(snap_dir, {"s": StateDict(state)}, replicated=["s/r*"])
        assert pending.staged()
        for v in state.values():
            v.add_(1)
        pending.wait()
    targets = StateDict({k: torch.zeros_like(v) for k, v in state.items()})
    Snapshot(snap_dir).restore({"s": targets})
    for k, v in witness.items():
        assert torch.equal(targets[k], v), k
        assert not torch.equal(state[k], v), k


def test_two_rank_take_stages_only_assigned_units(gen, tmp_path):
    from tpusnap_torch.test_utils import run_subprocess_world

    run_subprocess_world(
        _world_two_rank_take_stages_assigned_units, world_size=2,
        args=[str(tmp_path / "snap")], extra_env={"TPUSNAP_DISABLE_BATCHING": "1"},
    )


def test_two_rank_async_take_under_in_place_updates(gen, tmp_path):
    from tpusnap_torch.test_utils import run_subprocess_world

    run_subprocess_world(
        _world_two_rank_async_take_in_place, world_size=2, args=[str(tmp_path / "snap")]
    )


# --- DTensor state on the card: two ranks, a DeviceMesh("cuda", [0, 1]) ---


def _world_dtensor_restore_in_place(snap_dir):
    """A Shard(0) snapshot restores into Shard(1) views of zeros on
    cuda:0: the DTensor objects and their local storage stay."""
    from torch.distributed.tensor import Shard

    from tpusnap_torch.test_utils import as_dtensor, world_mesh

    torch.cuda.set_device(0)
    mesh = world_mesh("cuda")
    rank = torch.distributed.get_rank()
    full = torch.randn((512, 384), generator=torch.Generator(device="cuda").manual_seed(1),
                       device="cuda")
    Snapshot.take(snap_dir, {"m": StateDict(w=as_dtensor(full, mesh, [Shard(0)]))})
    target = as_dtensor(torch.zeros_like(full), mesh, [Shard(1)])
    local = target.to_local()
    state = StateDict(w=target)
    Snapshot(snap_dir).restore({"m": state})
    assert state["w"] is target
    assert target.to_local().is_cuda and target.to_local().data_ptr() == local.data_ptr()
    assert torch.equal(target.to_local(), full[:, rank * 192:(rank + 1) * 192])


def _world_cast_sharded_restore(snap_dir):
    """A bf16 (cast on save) sharded snapshot restores into f32 DTensor
    targets on the card, upcast there, in place."""
    from torch.distributed.tensor import Shard

    from tpusnap_torch import cast_on_save
    from tpusnap_torch.test_utils import as_dtensor, world_mesh

    torch.cuda.set_device(0)
    mesh = world_mesh("cuda")
    rank = torch.distributed.get_rank()
    w = torch.linspace(-2, 2, 256 * 96, device="cuda").reshape(256, 96)
    snap = Snapshot.take(snap_dir, {"m": StateDict(w=as_dtensor(w, mesh, [Shard(0)]))},
                         _custom_array_prepare_func=cast_on_save({"**": torch.bfloat16}))
    assert all(e.dtype == "bfloat16" for k, e in snap.metadata.manifest.items() if k.endswith("/w"))
    target = as_dtensor(torch.zeros_like(w), mesh, [Shard(0)])
    ptr = target.to_local().data_ptr()
    Snapshot(snap_dir).restore({"m": StateDict(w=target)})
    got = target.to_local()
    assert got.is_cuda and got.dtype == torch.float32 and got.data_ptr() == ptr
    assert torch.equal(got, w.to(torch.bfloat16).float()[rank * 128:(rank + 1) * 128])


def _world_sharded_async_take_in_place(snap_dir):
    """The freeze covers DTensor local shards: updated in place at once
    after the async take returns, the snapshot holds the values before."""
    from torch.distributed.tensor import Shard

    from tpusnap_torch.test_utils import as_dtensor, world_mesh

    torch.cuda.set_device(0)
    mesh = world_mesh("cuda")
    full = torch.randn((2048, 1024), generator=torch.Generator(device="cuda").manual_seed(2),
                       device="cuda")
    witness = full.clone()
    src = as_dtensor(full, mesh, [Shard(0)])
    with override_async_stage_window_bytes(2 << 20):  # residual windows frozen on the card
        pending = Snapshot.async_take(snap_dir, {"m": StateDict(w=src)})
        assert pending.staged()
        src.to_local().add_(1)
        pending.wait()
    target = as_dtensor(torch.zeros_like(full), mesh, [Shard(0)])
    Snapshot(snap_dir).restore({"m": StateDict(w=target)})
    rank = torch.distributed.get_rank()
    assert torch.equal(target.to_local(), witness[rank * 1024:(rank + 1) * 1024])
    assert not torch.equal(full, witness)


@pytest.mark.parametrize(
    "world",
    [_world_dtensor_restore_in_place, _world_cast_sharded_restore,
     _world_sharded_async_take_in_place],
    ids=["restore_in_place", "cast_upcasts_on_card", "async_take_frozen"],
)
def test_two_rank_dtensor_state_on_card(gen, tmp_path, world):
    from tpusnap_torch.test_utils import run_subprocess_world

    run_subprocess_world(world, world_size=2, args=[str(tmp_path / "snap")])


# --- host-offloaded (pinned) state, the MoE flagship and the embedding tables ---


def _count_dtoh(monkeypatch):
    """Bytes through the device-to-host staging copy (a tensor's own or
    the device slab pack's)."""
    from tpusnap_torch import batcher

    counted = {"bytes": 0}
    orig = array_preparer.enqueue_dtoh

    def enqueue(t, ready, transform=None):
        counted["bytes"] += t.numel() * t.element_size()
        return orig(t, ready, transform)

    monkeypatch.setattr(array_preparer, "enqueue_dtoh", enqueue)
    monkeypatch.setattr(batcher, "enqueue_dtoh", enqueue)
    return counted


def test_pinned_target_restores_in_place(gen, tmp_path, monkeypatch):
    from tpusnap_torch import PytreeState, to_host_offload

    counted = _count_dtoh(monkeypatch)
    table = to_host_offload(torch.randn((4096, 64), generator=gen, device="cuda"))
    acc = to_host_offload(torch.rand((4096,), generator=gen, device="cuda"))
    assert table.is_pinned() and acc.is_pinned()
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"s": PytreeState({"w": table, "acc": acc})})
    assert counted["bytes"] == 0  # staged as views of themselves
    targets = {"w": to_host_offload(torch.zeros_like(table)), "acc": to_host_offload(torch.zeros_like(acc))}
    before = {k: (id(t), t.data_ptr()) for k, t in targets.items()}
    state = PytreeState(targets)
    Snapshot(path).restore({"s": state})
    for k, want in (("w", table), ("acc", acc)):
        got = state.tree[k]
        assert (id(got), got.data_ptr()) == before[k] and got.is_pinned(), k
        assert torch.equal(got, want), k


@pytest.mark.parametrize("budget", [None, 1 << 14], ids=["whole", "tiled"])
def test_pinned_target_of_another_shape_stays_pinned(gen, tmp_path, budget):
    """tpusnap device_puts onto the target's sharding, memory kind
    included: a pinned target of another shape gets a pinned tensor."""
    from tpusnap_torch import to_host_offload

    w = to_host_offload(torch.randn((512, 64), generator=gen, device="cuda"))
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"s": StateDict(w=w)})
    target = to_host_offload(torch.zeros((4, 4)))
    got = Snapshot(path).read_object("0/s/w", obj_out=target, memory_budget_bytes=budget)
    assert got is not target and got.is_pinned() and torch.equal(got, w)
    restored = StateDict(w=to_host_offload(torch.zeros((8,))))
    Snapshot(path).restore({"s": restored})
    assert restored["w"].is_pinned() and torch.equal(restored["w"], w)


def test_async_take_of_pinned_tables_holds_the_state_at_the_call(gen, tmp_path):
    from tpusnap_torch import PytreeState, to_host_offload
    from tpusnap_torch.knobs import override_async_cow

    table = to_host_offload(torch.randn((8192, 64), generator=gen, device="cuda"))
    want = table.clone()
    path = str(tmp_path / "snap")
    with override_async_cow(False):  # defensive clones: updated at once
        pending = Snapshot.async_take(path, {"s": PytreeState({"w": table})})
        table.add_(1)
        pending.wait()
    assert torch.equal(Snapshot(path).read_object("0/s/w"), want)


def test_moe_flagship_trains_on_the_card(gen):
    from tpusnap_torch.models import Transformer, TransformerConfig

    cfg = TransformerConfig(vocab_size=512, d_model=128, n_heads=2, n_layers=2, d_ff=256,
                            max_seq_len=128, n_experts=4)
    model = Transformer(cfg, device="cuda")
    tokens = torch.randint(0, 512, (2, 128), generator=gen, device="cuda")
    fa.launches = 0
    losses = [model.train_step(tokens).item() for _ in range(5)]
    assert all(map(lambda x: x == x, losses)) and losses[-1] < losses[0], losses
    assert fa.launches == 5 * cfg.n_layers
    assert sorted(model.layers.keys()) == ["ln1", "ln2", "router", "w1e", "w2e", "wo", "wqkv"]


def test_pinned_embedding_tables_train_as_device_ones(gen):
    """A step on host-offloaded tables (rows gathered on the host, only
    touched rows updated there) equals the same step on a collection held
    on the CPU, and the tables stay the same pinned tensors."""
    from tpusnap_torch.models import EmbeddingCollection, TableConfig, rand_features

    tables = [TableConfig(f"t{i}", 4096, 32, host_offload=i >= 2, pooling="mean" if i % 2 else "sum")
              for i in range(4)]
    card = EmbeddingCollection(tables, device="cuda", seed=3)
    again = EmbeddingCollection(tables, device="cuda", seed=3)
    host = EmbeddingCollection(tables, device="cpu", seed=3)
    before = {k: (id(t), t.data_ptr()) for k, t in card.params()["tables"].items()}
    for step in range(3):
        feats, targets = rand_features(card, batch=64, bag=8, seed=step)
        card.train_step(feats, targets)
        again.train_step(feats, targets)
        host.train_step(*rand_features(host, batch=64, bag=8, seed=step))
    for section in ("tables", "opt"):
        for k, t in card.params()[section].items():
            assert t.is_pinned() == (k in ("t2", "t3")), (section, k)
            torch.testing.assert_close(t.cpu(), host.params()[section][k], rtol=1e-5, atol=1e-6)
            # Deterministic: replicas trained on several ranks stay equal.
            assert torch.equal(t, again.params()[section][k]), (section, k)
    assert {k: (id(t), t.data_ptr()) for k, t in card.params()["tables"].items()} == before


def _world_pinned_dtensor_shards(snap_dir):
    """Row-wise tables, two of them pinned DTensors over a "cpu" mesh
    beside the "cuda" one: an aligned restore lands in the pinned local
    shards in place, and a resharded one (into column-wise views) is
    copied into them; neither replaces them."""
    from tpusnap_torch import PytreeState, is_sharded
    from tpusnap_torch.io_preparers.sharded import local_box
    from tpusnap_torch.models import EmbeddingCollection, TableConfig, make_mesh
    from tpusnap_torch.test_utils import host_mesh_like

    torch.cuda.set_device(0)
    mesh = make_mesh("cuda", (1, 2, 1))
    host_mesh = host_mesh_like(mesh)

    def collection(sharding, seed):
        return EmbeddingCollection(
            [TableConfig(f"t{i}", 1024, 32, sharding=sharding, host_offload=i >= 2)
             for i in range(4)], device="cuda", seed=seed)

    src = collection("row", 1)
    Snapshot.take(snap_dir, {"e": PytreeState(src.shard_params(mesh, host_mesh))})
    for sharding in ("row", "col"):
        dst = collection(sharding, 2)
        state = dst.shard_params(mesh, host_mesh)
        leaves = {f"{s}/{k}": t for s in state for k, t in state[s].items()}
        before = {p: (id(t), t.to_local().data_ptr()) for p, t in leaves.items()}
        target = PytreeState(state)
        Snapshot(snap_dir).restore({"e": target})
        for p, t in leaves.items():
            got = target.tree[p.split("/")[0]][p.split("/")[1]]
            assert is_sharded(got) and (id(got), got.to_local().data_ptr()) == before[p], p
            assert got.to_local().is_pinned() == p.endswith(("t2", "t3")), p
        for s in ("tables", "opt"):
            for k, t in dst.params()[s].items():
                full = src.params()[s][k]
                local = target.tree[s][k]
                offsets, sizes = local_box(list(full.shape), [1, 2, 1],
                                           local.device_mesh.get_coordinate(), list(local.placements))
                box = tuple(slice(o, o + n) for o, n in zip(offsets, sizes))
                assert torch.equal(t[box], full[box]), (sharding, s, k)


def test_pinned_dtensor_shards_restore_in_place(gen, tmp_path):
    from tpusnap_torch.test_utils import run_subprocess_world

    run_subprocess_world(_world_pinned_dtensor_shards, world_size=2, args=[str(tmp_path / "snap")])


# --- the crash-safe take on the card: journal, telemetry, liveness, degrade ---


def _world_degraded_async_cuda(snap_dir):
    """Degrade under an async take of CUDA state: rank 1 stops on its
    first blob write (a wedge), rank 0 updates every tensor in place
    right after the call, then SIGKILLs rank 1. The degraded snapshot
    holds the state at the call (the adopted units were frozen on the
    card with rank 0's own)."""
    import signal

    from tpusnap_torch.comm import get_communicator

    torch.cuda.set_device(0)
    comm = get_communicator()
    pids = comm.all_gather_object(os.getpid())
    g = torch.Generator(device="cuda").manual_seed(5)
    state = {f"w{i}": torch.randn((1 << 18,), generator=g, device="cuda") for i in range(8)}
    witness = {k: v.clone() for k, v in state.items()}
    pending = Snapshot.async_take(
        "chaos+fs://" + snap_dir, {"s": StateDict(state)}, replicated=["**"],
        storage_options={"fault_plan": "rank=1,wedge=write:1"},
    )
    if comm.rank == 1:
        pending.wait()
        raise AssertionError("rank 1 committed through its wedge")
    for v in state.values():
        v.add_(1)
    torch.cuda.synchronize()
    os.kill(pids[1], signal.SIGKILL)
    snap = pending.wait()
    assert snap.metadata.extras["degraded"]["dead_ranks"] == [1]
    targets = StateDict({k: torch.zeros_like(v) for k, v in state.items()})
    Snapshot(snap_dir).restore({"s": targets})
    for k, v in witness.items():
        assert torch.equal(targets[k], v), k
    print("DEGRADED-ASYNC-CUDA-OK", flush=True)
    os._exit(0)


def test_degraded_async_take_of_cuda_state_holds_the_call(gen, tmp_path):
    from tpusnap_torch.test_utils import run_subprocess_world

    with pytest.raises(RuntimeError) as ei:
        run_subprocess_world(
            _world_degraded_async_cuda, world_size=2, args=[str(tmp_path / "snap")], timeout=180,
            extra_env={"TPUSNAP_RANK_FAILURE": "degrade", "TPUSNAP_LIVENESS_TTL_S": "2",
                       "TPUSNAP_HEARTBEAT_INTERVAL_S": "0.1", "TPUSNAP_DISABLE_BATCHING": "1"},
        )
    assert "DEGRADED-ASYNC-CUDA-OK" in str(ei.value), str(ei.value)[-3000:]


_CUDA_CRASH_CHILD = r"""
import sys
import torch
from tpusnap_torch import Snapshot, StateDict
torch.cuda.set_device(0)
g = torch.Generator(device="cuda").manual_seed(3)
state = {f"w{i}": torch.randn((1 << 20,), generator=g, device="cuda") for i in range(8)}
Snapshot.take("chaos+fs://" + sys.argv[1], {"s": StateDict(state)},
              storage_options={"fault_plan": "crash_after_op=write:6"})
raise SystemExit("not killed")
"""


def test_sigkilled_cuda_child_leaves_a_torn_salvageable_dir(gen, tmp_path):
    import subprocess
    import sys

    from tpusnap_torch import fsck_snapshot, telemetry
    from tpusnap_torch.knobs import override_batching_disabled

    path = str(tmp_path / "snap")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _CUDA_CRASH_CHILD, path], capture_output=True, text=True,
        env=dict(os.environ, TPUSNAP_DISABLE_BATCHING="1", PYTHONPATH=repo), timeout=180,
    )
    assert proc.returncode == -9, proc.stderr[-3000:]
    report = fsck_snapshot(path)
    assert report.state == "torn" and report.salvage_records >= 1, report.summary()
    g = torch.Generator(device="cuda").manual_seed(3)
    state = {f"w{i}": torch.randn((1 << 20,), generator=g, device="cuda") for i in range(8)}
    before = telemetry.counter_value("salvage.blobs_salvaged")
    with override_batching_disabled(True):
        Snapshot.take(path, {"s": StateDict(state)})
    assert telemetry.counter_value("salvage.blobs_salvaged") - before == report.salvage_records
    targets = StateDict({k: torch.zeros_like(v) for k, v in state.items()})
    Snapshot(path).restore({"s": targets})
    for k, v in state.items():
        assert torch.equal(targets[k], v), k


def _world_heartbeats_on_card(snap_dir):
    """Rank 1's first blob write hangs 3 s; rank 0 waits in the commit
    barrier meanwhile, and its lease keeps being published (TTL 1 s, no
    rank declared dead)."""
    import threading
    import time

    from tpusnap_torch.comm import StoreComm, get_communicator
    from tpusnap_torch.liveness import LeasePublisher

    torch.cuda.set_device(0)
    comm = get_communicator()
    publishes, waits, lock = [], [], threading.Lock()
    orig_publish, orig_barrier = LeasePublisher.publish, StoreComm.barrier

    def publish(self, state=None):
        orig_publish(self, state)
        with lock:
            publishes.append(time.monotonic())

    def barrier(self):
        t0 = time.monotonic()
        orig_barrier(self)
        waits.append((t0, time.monotonic()))

    LeasePublisher.publish, StoreComm.barrier = publish, barrier
    plan = "stall_op=write:1:3.0" if comm.rank == 1 else "seed=0"
    state = {"w": torch.arange(1 << 16, dtype=torch.float32, device="cuda") * (comm.rank + 1)}
    Snapshot.take("chaos+fs://" + snap_dir, {"s": StateDict(state)},
                  storage_options={"fault_plan": plan})
    if comm.rank == 0:
        start, end = max(waits, key=lambda w: w[1] - w[0])
        assert len([t for t in publishes if start <= t <= end]) >= 5, (end - start, publishes)


def test_heartbeats_advance_while_peer_parks_on_card(gen, tmp_path):
    from tpusnap_torch.test_utils import run_subprocess_world

    run_subprocess_world(
        _world_heartbeats_on_card, world_size=2, args=[str(tmp_path / "snap")],
        extra_env={"TPUSNAP_HEARTBEAT_INTERVAL_S": "0.1", "TPUSNAP_LIVENESS_TTL_S": "1.0"},
    )


def test_journal_hashes_pinned_buffers_before_reuse(gen, tmp_path):
    """CUDA sources stage through pinned buffers the pool recycles: every
    journal record matches the bytes of its own tensor."""
    from tpusnap_torch.knobs import override_batching_disabled
    from tpusnap_torch.lifecycle import dual_hash_evidence, journal_rank_path

    import tpusnap_torch.lifecycle as lifecycle

    records = {}
    orig_clear = lifecycle.clear_journal

    def keep_records(storage, loop, world_size):
        import json

        with open(os.path.join(path, journal_rank_path(0))) as f:
            records.update(json.load(f))
        orig_clear(storage, loop, world_size)

    path = str(tmp_path / "snap")
    state = {f"w{i}": torch.full((1 << 20,), float(i), device="cuda") for i in range(12)}
    lifecycle.clear_journal = keep_records
    try:
        with override_batching_disabled(True):
            Snapshot.take(path, {"s": StateDict(state)})
    finally:
        lifecycle.clear_journal = orig_clear
    assert len(records) == len(state)
    for loc, rec in records.items():
        t = state[loc.rsplit("/", 1)[-1]]
        assert tuple(rec) == dual_hash_evidence(t.cpu().numpy().tobytes()), loc


def test_dtoh_span_closes_when_the_copy_completes(gen, tmp_path):
    """The device-to-host copy runs on a side stream; its telemetry span
    closes when its event has completed, so a 128 MiB copy shows a time
    near the copy's, not the enqueue's ~0 s."""
    from tpusnap_torch import telemetry

    t = torch.randn((32 << 20,), generator=gen, device="cuda")  # 128 MiB f32
    torch.cuda.synchronize()
    Snapshot.take(str(tmp_path / "snap"), {"s": StateDict(t=t)})
    dtoh = telemetry.LAST_TAKE_SUMMARY["stages"]["dtoh"]
    # 128 MiB over PCIe takes milliseconds; an enqueue takes microseconds.
    assert dtoh["count"] == 1 and dtoh["total_s"] > 1e-3, dtoh


# --------------------------------------------------------------- delta


def _stream_state(gen, n=4, numel=1 << 20):
    """Tensors an in-place optimizer updates, and the step counter that
    names the boundary a capture holds."""
    state = {f"w{i}": torch.randn((numel,), generator=gen, device="cuda") for i in range(n)}
    state["step"] = torch.zeros((), dtype=torch.int64, device="cuda")
    return state


def _step(state, spin_cycles=0):
    """One in-place step: each tensor written by one kernel (``copy_``);
    ``spin_cycles`` of device time between tensors widen the window in
    which a free-running capture lands mid-step."""
    for k, t in state.items():
        if k == "step":
            t.add_(1)
        else:
            t.copy_(t * 0.999 + 0.001)
        if spin_cycles:
            torch.cuda._sleep(spin_cycles)


def _members(root):
    from tpusnap_torch.delta import resolve_chain

    rep = resolve_chain(root)
    return [os.path.join(root, m.name) for m in rep.members if m.state == "committed"]


def _restored(path, like):
    target = {k: torch.zeros_like(v) for k, v in like.items()}
    Snapshot(path).restore({"s": StateDict(target)})
    return target


def test_mark_step_capture_is_the_boundary_bit_for_bit(gen, tmp_path):
    """Captures taken inside mark_step hold the whole state at that step
    boundary, bit for bit (tolerance 0), and the training thread blocks
    only for their staging."""
    import time

    root = str(tmp_path / "stream")
    state = _stream_state(gen)
    boundaries = {0: {k: v.clone() for k, v in state.items()}}
    stream = Snapshot.stream(root, {"s": StateDict(state)}, cadence_s=0.1)
    for _ in range(30):
        _step(state, spin_cycles=1 << 16)
        boundaries[int(state["step"])] = {k: v.clone() for k, v in state.items()}
        stream.mark_step()
        time.sleep(0.02)
    stream.close(final_commit=False)
    stream.raise_if_failed()
    assert stream.stats["mark_step_captures"] >= 2, stream.stats
    assert stream.stats["max_capture_blocked_s"] > 0
    for path in _members(root):
        got = _restored(path, state)
        want = boundaries[int(got["step"])]
        for k in state:
            assert torch.equal(got[k], want[k]), (path, k)


def test_free_running_capture_under_side_stream_holds_each_tensor_at_a_boundary(gen, tmp_path):
    """Training on a side stream, no mark_step: the worker thread's
    captures copy the state in that stream's order, so every tensor of
    every member is whole at some step boundary (blob grain, tolerance
    0), though a member may mix boundaries. Each step adds 1 to every
    element of 64 MiB int32 tensors, so a tensor at a boundary is
    constant and a copy torn by a step's write is not. The host runs
    tens of milliseconds ahead of the card, as a training loop does, so
    the writes a capture must not see are already queued when it runs;
    batching is off, so each tensor's copy to the host (milliseconds)
    is the window such a write could tear."""
    import time

    from tpusnap_torch.knobs import override_batching_disabled

    root = str(tmp_path / "stream")
    side = torch.cuda.Stream()
    with torch.cuda.stream(side), override_batching_disabled(True):
        state = {f"w{i}": torch.zeros((16 << 20,), dtype=torch.int32, device="cuda") for i in range(4)}
        stream = Snapshot.stream(root, {"s": StateDict(state)}, cadence_s=0.1, max_chain=1000)
        t_end, steps = time.monotonic() + 2.0, 0
        while time.monotonic() < t_end:
            for t in state.values():
                t.add_(1)
            torch.cuda._sleep(1 << 21)
            steps += 1
            if steps % 40 == 0:
                side.synchronize()
        side.synchronize()
        stream.close(final_commit=False)
    stream.raise_if_failed()
    members = _members(root)
    assert len(members) >= 3, members
    for path in members:
        got = _restored(path, state)
        for k, t in got.items():
            first = int(t[0])
            assert 0 <= first <= steps and torch.equal(t, torch.full_like(t, first)), (path, k)


def test_tier_take_and_restore_of_cuda_state_after_eviction(gen, tmp_path, monkeypatch):
    """CUDA state through the write-back tier: drained to the remote,
    evicted locally, restored through the tier URL from the remote into
    CUDA tensors in place, bit for bit."""
    from tpusnap_torch import gc_snapshot, telemetry
    from tpusnap_torch.tiering import drain_snapshot, parse_tier_url

    monkeypatch.setenv("TPUSNAP_TIER_DRAIN", "0")
    url = f"tier+local={tmp_path / 'cache'}+remote=fs://{tmp_path / 'remote'}/snap"
    state = _stream_state(gen)
    Snapshot.take(url, {"s": StateDict(state)})
    assert drain_snapshot(url).state == "durable"
    gc_snapshot(parse_tier_url(url).local_dir, dry_run=False, evict_local=True)
    before = telemetry.counter_value("tier.remote_fallback_reads")
    target = {k: torch.zeros_like(v) for k, v in state.items()}
    ptrs = {k: v.data_ptr() for k, v in target.items()}
    Snapshot(url).restore({"s": StateDict(target)})
    assert telemetry.counter_value("tier.remote_fallback_reads") > before
    for k, v in state.items():
        assert target[k].data_ptr() == ptrs[k] and torch.equal(target[k], v), k


def test_cas_restore_in_place(gen, tmp_path):
    """Two CAS-composed takes of the same CUDA state store it once; each
    restores into CUDA tensors in place, bit for bit."""
    from tpusnap_torch.knobs import override_batching_disabled, override_cas

    state = _stream_state(gen)
    store = str(tmp_path / "store")
    with override_cas(store), override_batching_disabled(True):
        for job in ("a", "b"):
            Snapshot.take(str(tmp_path / job), {"s": StateDict(state)})
        blobs = os.listdir(os.path.join(store, "blobs"))
        assert len(blobs) == len(state)
        for job in ("a", "b"):
            target = {k: torch.zeros_like(v) for k, v in state.items()}
            ptrs = {k: v.data_ptr() for k, v in target.items()}
            Snapshot(str(tmp_path / job)).restore({"s": StateDict(target)})
            for k, v in state.items():
                assert target[k].data_ptr() == ptrs[k] and torch.equal(target[k], v), (job, k)


# ------------------------------------------------ observability and the CLI


def test_analyze_attributes_a_cuda_takes_dtoh_to_dtoh(gen, tmp_path):
    """``analyze`` over a take of CUDA state: the device-to-host copies
    are ``dtoh`` time, in the busy view and in the attribution."""
    import glob
    import json

    from tpusnap_torch.analyze import analyze

    state = {f"w{i}": torch.randn((8 << 20,), generator=gen, device="cuda") for i in range(4)}
    torch.cuda.synchronize()
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"s": StateDict(state)})
    docs = {}
    for p in glob.glob(os.path.join(path, ".tpusnap", "telemetry", "rank_*.json")):
        doc = json.load(open(p))
        docs[doc["summary"]["rank"]] = doc
    rollup = json.load(open(os.path.join(path, ".snapshot_metadata")))["extras"]["telemetry"]
    report = analyze(rollup, docs, kind="take")
    att = report["attribution"]
    assert att["busy_s"].get("dtoh", 0) > 1e-3, att
    assert att["attributed_s"].get("dtoh", 0) > 0, att


def test_restore_consume_spans_close_after_the_host_to_device_copy(gen, tmp_path):
    """A CUDA restore target receives its bytes in pinned memory and
    then a copy on the card: each ``consume`` span ends after that
    copy's event completed, so ``analyze`` credits the copy to
    ``consume`` and not to nothing."""
    from tpusnap_torch import telemetry

    state = {f"w{i}": torch.randn((8 << 20,), generator=gen, device="cuda") for i in range(2)}
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"s": StateDict(state)})
    copies_done, recorders = [], []
    orig_copy, orig_begin = array_preparer._copy_into_target, telemetry.begin_restore

    def begin(rank):
        recorders.append(orig_begin(rank))
        return recorders[-1]

    def timed(target, host, ready):
        # The copies run on the consume executor's threads: time them
        # on the restore's recorder clock (the trace's).
        orig_copy(target, host, ready)
        copies_done.append(recorders[-1].now())

    array_preparer._copy_into_target, telemetry.begin_restore = timed, begin
    try:
        target = {k: torch.zeros_like(v) for k, v in state.items()}
        Snapshot(path).restore({"s": StateDict(target)})
    finally:
        array_preparer._copy_into_target, telemetry.begin_restore = orig_copy, orig_begin
    for k in state:
        assert torch.equal(target[k], state[k])
    assert len(copies_done) == len(state) and len(recorders) == 1
    from tpusnap_torch.progress import load_restore_traces

    doc = load_restore_traces(path)[0]
    spans = [
        (ev["ts"] / 1e6, (ev["ts"] + ev["dur"]) / 1e6)
        for ev in doc["traceEvents"]
        if ev.get("name") == "consume" and ev.get("ph") == "X"
    ]
    assert spans  # one per read: the two tensors share a slab
    # Each copy completed inside a consume span (the recorder's clock
    # is the trace's), not after its span had closed.
    for done in copies_done:
        assert any(start <= done <= end + 1e-4 for start, end in spans), (done, spans)
    consume = telemetry.LAST_RESTORE_SUMMARY["stages"]["consume"]
    assert consume["total_s"] > 1e-3, consume


def test_cli_leaves_cuda_uninitialised(gen, tmp_path):
    """An operator runs the CLI beside a training job: ``info``,
    ``verify``, ``fsck`` and ``cat`` of a snapshot of CUDA state open no
    CUDA context."""
    import subprocess
    import sys

    state = {"w": torch.randn((1 << 16,), generator=gen, device="cuda"), "n": 3}
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"s": StateDict(state)})
    code = (
        "import sys, torch\n"
        "from tpusnap_torch.__main__ import main\n"
        "p = sys.argv[1]\n"
        "rcs = [main(['info', p]), main(['verify', p]), main(['fsck', p]),\n"
        "       main(['cat', p, '0/s/w']), main(['cat', p, '0/s/n'])]\n"
        "assert rcs == [0, 0, 0, 0, 0], rcs\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('UNINITIALISED')\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", code, path], capture_output=True, text=True, timeout=300,
        cwd=repo, env={**os.environ, "PYTHONPATH": repo},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "UNINITIALISED" in proc.stdout


# ------------------------------------------------ ring attention's block kernel


def _ring_module():
    import importlib

    return importlib.import_module("tpusnap_torch.ops.ring_attention")


def _ring_carry(shape, gen):
    """A random incoming carry; every 5th row has seen nothing yet."""
    b, s, h, d = shape
    m = torch.randn((b, h, s), generator=gen, device="cuda")
    l = torch.rand((b, h, s), generator=gen, device="cuda") * 2 + 0.5
    o = torch.randn((b, s, h, d), generator=gen, device="cuda")
    m[:, :, ::5], l[:, :, ::5], o[:, ::5] = -1e30, 0.0, 0.0
    return m, l, o


_RING_CASES = [
    # shape, dtype, q_offset, k_offset, causal, route
    ((2, 256, 4, 64), torch.bfloat16, 256, 256, True, "wgmma"),
    ((2, 256, 4, 64), torch.bfloat16, 256, 0, True, "wgmma"),
    ((2, 200, 3, 128), torch.float16, 100, 164, True, "wgmma"),
    ((2, 130, 2, 40), torch.bfloat16, 0, 0, False, "wgmma"),
    ((1, 1, 2, 8), torch.bfloat16, 3, 3, True, "wgmma"),
    ((1, 130, 2, 64), torch.float32, 130, 130, True, "simt"),
    ((1, 130, 2, 32), torch.float32, 50, 90, True, "simt"),
    ((1, 70, 2, 64), torch.float32, 0, 0, False, "simt"),
]


@pytest.mark.parametrize(
    "shape,dtype,q_off,k_off,causal,route", _RING_CASES, ids=lambda x: str(x).replace(" ", "")
)
def test_ring_block_kernel_matches_plain(gen, shape, dtype, q_off, k_off, causal, route):
    """The kernel's new carry against ``block_attend`` per element, within
    ``rounding_bound`` (P rounded to the input type before P V; f32 slack),
    on the route the inputs take."""
    ra = _ring_module()
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    carry = _ring_carry(shape, gen)
    before = [t.clone() for t in carry]
    scale = shape[-1] ** -0.5
    want = ra.block_attend(q, k, v, *before, q_off, k_off, scale, causal)
    bounds = ra.rounding_bound(q, k, v, *before, q_off, k_off, scale, causal)
    routes = dict(ra.route_launches)
    ra.attend_block(q, k, v, *carry, q_off, k_off, scale, causal)
    torch.cuda.synchronize()
    assert {r: ra.route_launches[r] - routes[r] for r in routes} == {
        r: int(r == route) for r in routes
    }
    for name, got, ref, bound in zip("mlo", carry, want, bounds):
        ratio = ((got - ref).abs() / bound).max().item()
        assert ratio <= 1.0, f"{name}: worst element {ratio}x its bound"


def test_ring_future_block_is_skipped_and_leaves_the_carry(gen):
    ra = _ring_module()
    q, k, v = (torch.randn((2, 64, 2, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    carry = _ring_carry((2, 64, 2, 64), gen)
    before = [t.clone() for t in carry]
    launches, skips = ra.launches, ra.skips
    ra.attend_block(q, k, v, *carry, 0, 64, 0.125, True)
    assert (ra.launches, ra.skips) == (launches, skips + 1)
    assert all(torch.equal(a, b) for a, b in zip(carry, before))


def test_ring_block_reads_fused_qkv_views_and_repeats_bitwise(gen):
    ra = _ring_module()
    q, k, v = _fused_views((2, 192, 4, 64), torch.bfloat16, gen)
    carry = _ring_carry((2, 192, 4, 64), gen)
    first, second = [t.clone() for t in carry], [t.clone() for t in carry]
    ra.attend_block(q, k, v, *first, 192, 0, 0.125, True)
    ra.attend_block(q, k, v, *second, 192, 0, 0.125, True)
    want = ra.block_attend(q, k, v, *carry, 192, 0, 0.125, True)
    bounds = ra.rounding_bound(q, k, v, *carry, 192, 0, 0.125, True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for got, ref, bound in zip(first, want, bounds):
        assert ((got - ref).abs() / bound).max().item() <= 1.0


def test_ring_block_kernel_refuses_what_it_cannot_take(gen):
    ra = _ring_module()
    q = torch.randn((1, 8, 2, 256), generator=gen, device="cuda").to(torch.bfloat16)
    carry = _ring_carry((1, 8, 2, 256), gen)
    with pytest.raises(ValueError, match="head_dim"):
        ra.attend_block(q, q, q, *carry, 0, 0, 0.0625, True)
    q = torch.randn((2, 8, 2, 64), generator=gen, device="cuda").to(torch.bfloat16)
    m, l, o = _ring_carry((2, 8, 2, 64), gen)
    strided = o.transpose(1, 2).contiguous().transpose(1, 2)  # o's values, (b, h, s, d) order
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ra.attend_block(q, q, q, m, l, strided, 0, 0, 0.125, True)


def test_ring_attention_one_block_matches_flash_reference(gen):
    """One block through the kernel against plain causal attention, within
    the flash kernel's own 16-bit rounding bound."""
    ra = _ring_module()
    q, k, v = _fused_views((2, 256, 4, 64), torch.bfloat16, gen)
    launches = ra.launches
    out = ra.ring_attention(q, k, v)
    assert ra.launches == launches + 1
    _assert_within_rounding_bound(out, q, k, v, True)


def test_ring_model_trains_on_the_card(gen):
    from tpusnap_torch.models import Transformer, TransformerConfig

    ra = _ring_module()
    cfg = TransformerConfig(vocab_size=512, d_model=128, n_heads=2, n_layers=2, d_ff=256,
                            max_seq_len=128, use_ring_attention=True)
    model = Transformer(cfg, device="cuda", seed=0)
    tokens = torch.randint(0, 512, (2, 128), generator=gen, device="cuda")
    launches = ra.launches
    losses = [model.train_step(tokens, learning_rate=1e-2).item() for _ in range(3)]
    assert losses[-1] < losses[0]
    assert ra.launches == launches + 3 * cfg.n_layers


def _ring_mode_run(ra, q, k, v, carry, q_off, k_off, scale, causal, mode):
    """The kernel in ``mode`` on fresh buffers: the new carry (first,
    middle) or the output (last modes)."""
    bufs = [t.clone() for t in carry]
    if mode in ("last", "first+last"):
        out = torch.empty(q.shape, dtype=q.dtype, device="cuda")
        given = bufs if mode == "last" else (None, None, None)
        ra.attend_block(q, k, v, *given, q_off, k_off, scale, causal, mode=mode, out=out)
        assert all(torch.equal(a, c) for a, c in zip(bufs, carry))  # the carry is not written
        return (out,)
    ra.attend_block(q, k, v, *bufs, q_off, k_off, scale, causal, mode=mode)
    return tuple(bufs)


@pytest.mark.parametrize("mode", ["first", "last", "first+last"])
@pytest.mark.parametrize(
    "shape,dtype,q_off,k_off,causal,route", _RING_CASES, ids=lambda x: str(x).replace(" ", "")
)
def test_ring_block_modes_match_plain(gen, shape, dtype, q_off, k_off, causal, route, mode):
    """Each carry mode against its plain version per element: first's new
    carry against ``block_attend`` from ``_init_carry`` within
    ``rounding_bound``; the last modes' output against ``_finish`` of it
    within ``finish_bound``; one launch on the route the inputs take."""
    ra = _ring_module()
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    carry = _ring_carry(shape, gen)
    scale = shape[-1] ** -0.5
    start = ra._init_carry(q) if mode in ("first", "first+last") else carry
    args = (q, k, v, *start, q_off, k_off, scale, causal)
    routes, modes = dict(ra.route_launches), dict(ra.mode_launches)
    got = _ring_mode_run(ra, q, k, v, carry, q_off, k_off, scale, causal, mode)
    torch.cuda.synchronize()
    assert {r: ra.route_launches[r] - routes[r] for r in routes} == {
        r: int(r == route) for r in routes
    }
    assert ra.mode_launches[mode] == modes[mode] + 1
    if mode == "first":
        want, bounds = ra.block_attend(*args), ra.rounding_bound(*args)
    else:
        _, l_new, o_new = ra.block_attend(*args)
        want, bounds = (ra._finish(l_new, o_new, dtype),), (ra.finish_bound(*args),)
    for g, ref, bound in zip(got, want, bounds):
        ratio = ((g.float() - ref.float()).abs() / bound).max().item()
        assert ratio <= 1.0, f"{mode}: worst element {ratio}x its bound"


@pytest.mark.parametrize(
    "shape,dtype,q_off,k_off,causal,route", _RING_CASES, ids=lambda x: str(x).replace(" ", "")
)
def test_ring_block_modes_keep_the_identities_bitwise(gen, shape, dtype, q_off, k_off, causal,
                                                       route):
    """The modes change what is read and written, never the arithmetic:
    first equals middle from ``_init_carry``, last equals middle followed
    by ``_finish``, first+last equals both, bit for bit."""
    ra = _ring_module()
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    carry = _ring_carry(shape, gen)
    scale = shape[-1] ** -0.5
    args = (q, k, v, q_off, k_off, scale, causal)

    def run(carry, mode):
        return _ring_mode_run(ra, *args[:3], carry, *args[3:], mode)

    empty = ra._init_carry(q)
    middle_from_empty, middle = run(empty, "middle"), run(carry, "middle")
    assert all(torch.equal(a, c) for a, c in zip(run(carry, "first"), middle_from_empty))
    assert torch.equal(run(carry, "last")[0], ra._finish(middle[1], middle[2], dtype))
    assert torch.equal(run(carry, "first+last")[0],
                       ra._finish(middle_from_empty[1], middle_from_empty[2], dtype))


def test_ring_attention_on_the_card_fills_no_carry_and_runs_no_finish(gen, monkeypatch):
    """The ring of one on the card is one first+last launch: no
    ``_init_carry`` fill and no ``_finish`` pass around it."""
    ra = _ring_module()
    q, k, v = _fused_views((2, 256, 4, 64), torch.bfloat16, gen)
    want = ra.ring_attention_reference(q, k, v)
    bound = ra.finish_bound(q, k, v, *ra._init_carry(q), 0, 0, 64**-0.5, True)
    for name in ("_init_carry", "_finish"):
        monkeypatch.setattr(ra, name, lambda *a, name=name: pytest.fail(f"{name} ran"))
    modes = dict(ra.mode_launches)
    with torch.no_grad():
        out = ra.ring_attention(q, k, v)
    assert ra.mode_launches["first+last"] == modes["first+last"] + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    assert ((out.float() - want.float()).abs() / bound).max().item() <= 1.0


# ---------------------------------------------- examples and harnesses


def _example_args(tmp_path):
    return {
        "simple": ["--work-dir", str(tmp_path / "simple")],
        "incremental": ["--work-dir", str(tmp_path / "inc")],
        "distributed": ["--work-dir", str(tmp_path / "ddp")],
        "transformer": ["--work-dir", str(tmp_path / "xf")],
    }


@pytest.mark.parametrize("name", ["simple", "incremental", "distributed", "transformer"])
def test_example_runs_on_the_card(gen, tmp_path, monkeypatch, capsys, name):
    import importlib

    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))
    module = importlib.import_module(f"tpusnap_torch.examples.{name}")
    assert module.main([*_example_args(tmp_path)[name], "--device", "cuda"]) == 0
    out = capsys.readouterr().out
    if name == "transformer":
        before = fa.launches
        assert module.main(["--work-dir", str(tmp_path / "xf2"), "--device", "cuda",
                            "--resume-from", str(tmp_path / "xf" / "epoch_2")]) == 0
        resumed = capsys.readouterr().out
        assert "resumed at epoch 2" in resumed and "final snapshot committed" in resumed
        # One epoch of 4 steps through 2 layers, each forward on the kernel.
        assert fa.launches - before == 4 * 2
    elif name == "incremental":
        assert "0 corrupt" in out and "bit-exact" in out
    elif name == "distributed":
        assert "rank 1: restore verified" in out


_HARNESS_ARGS = {
    "load_tensor": ["--gb", "0.5"],
    "pinned_host": [],
    "async_latency": ["--mb", "64", "--runs", "2"],
    "incremental": ["--gb", "0.25", "--runs", "2", "--chain-depth", "10"],
    "replicated": ["--gb", "0.25"],
    "sharded": ["--d-model", "512", "--n-layers", "2", "--runs", "2"],
    "embedding": ["--rows", "100000"],
    "gcs_pipeline": ["--total-mb", "64", "--latency-ms", "20"],
    "dcp_compare": ["--d-model", "512", "--n-heads", "8", "--n-layers", "2", "--runs", "3"],
    "fleetsim": ["--jobs", "4", "--branch", "2", "--takes", "2", "--mb", "4"],
}


@pytest.mark.parametrize("name", sorted(_HARNESS_ARGS))
def test_harness_runs_on_the_card(gen, tmp_path, monkeypatch, capsys, name):
    import importlib
    import json

    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))
    module = importlib.import_module(f"tpusnap_torch.benchmarks.{name}")
    rc = module.main([*_HARNESS_ARGS[name], "--device", "cuda"])
    out = capsys.readouterr().out
    last = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and last["ok"], out[-3000:]
    assert last["device"] == "cuda" and last["device_name"] == torch.cuda.get_device_name(0)
    if name == "pinned_host":
        assert last["restored_pinned"] and last["source_pinned"]


def test_budgeted_read_object_into_a_cuda_target_holds_only_tiles_on_the_host(gen, tmp_path,
                                                                             monkeypatch):
    """A 512 MiB CUDA tensor read back under a 16 MiB budget into an exact
    CUDA target: in place, bit for bit, and the host's RSS grows by no
    more than 8x the budget (tests/test_tiled_read.py's slack), where a
    host copy of the whole tensor would add 512 MiB."""
    from tpusnap_torch import PytreeState, measure_rss_deltas

    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))
    big = torch.randn((512 << 20) // 4 // 1024, 1024, generator=gen, device="cuda")
    Snapshot.take(str(tmp_path / "s"), {"m": PytreeState({"big": big})})
    target = torch.zeros_like(big)
    budget = 16 << 20
    deltas = []
    with measure_rss_deltas(deltas):
        out = Snapshot(str(tmp_path / "s")).read_object(
            "0/m/big", obj_out=target, memory_budget_bytes=budget
        )
        torch.cuda.synchronize()
    assert out is target and torch.equal(target, big)
    assert max(deltas, default=0) < 8 * budget, max(deltas)
