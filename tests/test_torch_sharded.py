"""Mirrors of tests/test_sharded.py for DTensor state: the 5x5 reshard
matrix, replica dedup, subdivision, sharded <-> dense, odd shapes, bf16
bit-exactness and the six save-time transform cases; plus uneven and
empty shards (DTensor allows them, JAX does not), a fully replicated
DTensor, a mesh that leaves ranks out, a compressed dense blob restored
into a DTensor, the box arithmetic against torch's own, the refusal of
``Partial`` and ``_StridedShard`` placements, and a plain take that never
imports ``torch.distributed.tensor``.

tpusnap runs these on an 8-device CPU mesh in one process. Here a
``DTensor`` needs one process per mesh position, so the cases run on a
2x2 gloo mesh in one 4-rank world, started once for the whole module
(``_world_cases``). Every rank records each case's outcome; each test
below reads its case's outcome on every rank, and the tests that look at
a manifest open the snapshot the world wrote from this process. Every
comparison is bit-exact.

The five JAX specs on the (x, y) mesh map to placements as:
``P("x")`` -> ``[Shard(0), Replicate()]``, ``P(None, "y")`` ->
``[Replicate(), Shard(1)]``, ``P("x", "y")`` -> ``[Shard(0), Shard(1)]``,
``P(("x", "y"),)`` -> ``[Shard(0), Shard(0)]``, ``P("y")`` ->
``[Replicate(), Shard(0)]``.
"""

import json
import os
import traceback

import numpy as np
import pytest
import torch

from tpusnap_torch import Snapshot
from tpusnap_torch.manifest import ShardedEntry
from tpusnap_torch.serialization import tensor_nbytes

SHAPE = (16, 12)
SPECS = ["x", "None_y", "x_y", "xy", "y"]


def _placements(spec):
    from torch.distributed.tensor import Replicate, Shard

    return {
        "x": [Shard(0), Replicate()],
        "None_y": [Replicate(), Shard(1)],
        "x_y": [Shard(0), Shard(1)],
        "xy": [Shard(0), Shard(0)],
        "y": [Replicate(), Shard(0)],
    }[spec]


def _full(shape=SHAPE, dtype=torch.float32):
    return torch.arange(int(np.prod(shape)), dtype=dtype).reshape(shape)


def _transform_weights():
    return torch.from_numpy(
        np.linspace(-2, 2, int(np.prod(SHAPE))).astype(np.float32).reshape(SHAPE)
    )


def _case_paths(root):
    return {
        "dedup": os.path.join(root, "dedup"),
        "subdiv": os.path.join(root, "subdiv"),
        "dense_read": os.path.join(root, "dense_read"),
        "cast": os.path.join(root, "cast"),
        "cast_cap": os.path.join(root, "cast_cap"),
        "uneven": os.path.join(root, "uneven"),
        "empty": os.path.join(root, "empty"),
        "replicated": os.path.join(root, "replicated"),
        "outside": os.path.join(root, "outside"),
    }


def _world_cases(root, out_path):
    """Every case on a 2x2 mesh of 4 gloo ranks; rank 0 writes
    ``{case: [outcome per rank]}`` to ``out_path`` ("ok" or the error)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from tpusnap_torch import StateDict, cast_on_save
    from tpusnap_torch.io_preparers.sharded import local_box
    from tpusnap_torch.knobs import (
        override_batching_disabled,
        override_compress,
        override_max_shard_size_bytes,
    )
    from tpusnap_torch.test_utils import as_dtensor, world_mesh

    mesh = world_mesh("cpu", [2, 2])
    rank = dist.get_rank()

    def world_mesh_of(ranks):
        from torch.distributed.device_mesh import DeviceMesh

        return DeviceMesh("cpu", ranks)

    paths = _case_paths(root)
    outcomes = {}

    def box_of(t):
        return tuple(
            slice(o, o + n)
            for o, n in zip(*local_box(list(t.shape), list(mesh.shape), mesh.get_coordinate(),
                                       list(t.placements)))
        )

    def holds(t, full, placements):
        """``t`` is a DTensor of ``placements`` whose local tensor holds
        this rank's box of ``full``, bit for bit."""
        assert isinstance(t, DTensor) and list(t.placements) == list(placements), t.placements
        want = full[box_of(t)]
        got = t.to_local()
        assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape)
        assert got.contiguous().view(torch.uint8).equal(want.contiguous().view(torch.uint8))

    def restore_into(path, full_like, placements, want, dtype=None):
        target_full = torch.zeros(full_like.shape, dtype=dtype or full_like.dtype)
        target = as_dtensor(target_full, mesh, placements)
        local_ptr = target.to_local().data_ptr()
        state = StateDict(a=target)
        Snapshot(path).restore({"s": state})
        assert state["a"] is target, "restore replaced the DTensor"
        assert target.to_local().data_ptr() == local_ptr, "restore did not land in place"
        holds(target, want, placements)

    def run(name, fn):
        dist.barrier()
        try:
            fn()
            outcomes[name] = "ok"
        except BaseException as e:  # recorded: the test of this case fails with it
            outcomes[name] = f"{type(e).__name__}: {e}\n{traceback.format_exc()[-1500:]}"

    full = _full()

    # The 5 x 5 reshard matrix.
    for src in SPECS:
        path = os.path.join(root, f"matrix_{src}")
        run(f"take_{src}", lambda: Snapshot.take(
            path, {"s": StateDict(a=as_dtensor(full, mesh, _placements(src)))}))
        for dst in SPECS:
            run(f"matrix_{src}_{dst}",
                lambda: restore_into(path, full, _placements(dst), full))

    # Replica dedup: P("y") has 2 distinct pieces, each held by 2 ranks.
    run("dedup", lambda: Snapshot.take(
        paths["dedup"], {"s": StateDict(a=as_dtensor(full, mesh, _placements("y")))}))

    def subdivision():
        with override_max_shard_size_bytes(64):  # each (8, 12) f32 piece = 384 B
            Snapshot.take(paths["subdiv"],
                          {"s": StateDict(a=as_dtensor(full, mesh, _placements("x")))})
            restore_into(paths["subdiv"], full, _placements("None_y"), full)

    run("subdivision", subdivision)

    def sharded_to_dense():
        Snapshot.take(paths["dense_read"],
                      {"s": StateDict(a=as_dtensor(full, mesh, _placements("x_y")))})
        dense = Snapshot(paths["dense_read"]).read_object("0/s/a")
        assert type(dense) is torch.Tensor and dense.equal(full)

    run("sharded_to_dense", sharded_to_dense)

    def dense_to_sharded():
        path = os.path.join(root, "dense_src")
        Snapshot.take(path, {"s": StateDict(a=full.clone())})
        restore_into(path, full, _placements("x_y"), full)

    run("dense_to_sharded", dense_to_sharded)

    def compressed_dense_to_sharded():
        # A compressed dense blob is decoded whole, then scattered.
        big = torch.from_numpy(np.random.default_rng(5).integers(0, 9, (256, 128)).astype(np.float32))
        path = os.path.join(root, "dense_lz4")
        with override_compress(mode="on", min_blob_bytes=64 * 1024), \
                override_batching_disabled(True):
            snap = Snapshot.take(path, {"s": StateDict(a=big)})
        assert snap.metadata.manifest[f"{rank}/s/a"].codec, "the blob was not compressed"
        restore_into(path, big, _placements("x_y"), big)

    run("compressed_dense_to_sharded", compressed_dense_to_sharded)

    def odd_shape():
        odd = torch.arange(12 * 6, dtype=torch.int32).reshape(12, 6)
        path = os.path.join(root, "odd")
        Snapshot.take(path, {"s": StateDict(a=as_dtensor(odd, mesh, _placements("x")))})
        restore_into(path, odd, _placements("None_y"), odd)

    run("odd_shape", odd_shape)

    def bf16():
        bits = torch.from_numpy(np.arange(16 * 128, dtype=np.uint16).reshape(16, 128).view(np.int16))
        arr = bits.view(torch.bfloat16)
        path = os.path.join(root, "bf16")
        Snapshot.take(path, {"s": StateDict(a=as_dtensor(arr, mesh, _placements("x")))})
        restore_into(path, arr, _placements("x_y"), arr)

    run("bf16", bf16)

    # Save-time transform: cast to bf16 per local shard.
    w = _transform_weights()
    expect = w.to(torch.bfloat16)
    cast = cast_on_save({"**": torch.bfloat16})
    run("cast_take", lambda: Snapshot.take(
        paths["cast"], {"s": StateDict(a=as_dtensor(w, mesh, _placements("x")))},
        _custom_array_prepare_func=cast))
    run("cast_upcast_restore",
        lambda: restore_into(paths["cast"], w, _placements("None_y"), expect.float()))
    run("cast_bf16_restore",
        lambda: restore_into(paths["cast"], w, _placements("x"), expect, dtype=torch.bfloat16))

    def cast_cap():
        # (8, 12) pieces: 384 B at f32, 192 B as stored (bf16).
        with override_max_shard_size_bytes(192):
            Snapshot.take(paths["cast_cap"],
                          {"s": StateDict(a=as_dtensor(w, mesh, _placements("x")))},
                          _custom_array_prepare_func=cast)

    run("cast_cap", cast_cap)

    # Uneven shards: (7, 5) over the 2 x 2 mesh.
    uneven = _full((7, 5))

    def uneven_case():
        Snapshot.take(paths["uneven"],
                      {"s": StateDict(a=as_dtensor(uneven, mesh, _placements("x_y")))})
        for dst in SPECS:
            restore_into(paths["uneven"], uneven, _placements(dst), uneven)
        assert Snapshot(paths["uneven"]).read_object("0/s/a").equal(uneven)

    run("uneven", uneven_case)

    # Empty shards: 3 rows over 4 positions leave rank 3 an empty box.
    few = _full((3, 4))

    def empty_case():
        src = as_dtensor(few, mesh, _placements("xy"))
        assert (src.to_local().numel() == 0) == (rank == 3)
        Snapshot.take(paths["empty"], {"s": StateDict(a=src)})
        for dst in SPECS:
            restore_into(paths["empty"], few, _placements(dst), few)

    run("empty", empty_case)

    def partial_refused():
        t = DTensor.from_local(torch.ones(2, 2), mesh, [Partial(), Replicate()], run_check=False)
        path = os.path.join(root, "partial")
        try:
            Snapshot.take(path, {"s": StateDict(a=t)})
        except NotImplementedError as e:
            assert "Partial" in str(e), e
        else:
            raise AssertionError("a Partial placement was taken")
        assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))

    run("partial_refused", partial_refused)

    def strided_refused():
        from torch.distributed.tensor.placement_types import _StridedShard

        t = DTensor.from_local(torch.ones(2, 2), mesh, [_StridedShard(0, split_factor=2),
                                                         Replicate()], run_check=False)
        try:
            Snapshot.take(os.path.join(root, "strided"), {"s": StateDict(a=t)})
        except NotImplementedError as e:
            assert "_StridedShard" in str(e), e
        else:
            raise AssertionError("a _StridedShard placement was taken")

    run("strided_refused", strided_refused)

    def fully_replicated():
        # Replicated over every mesh dim across processes: one box, written
        # by the rank at coordinate (0, 0) alone.
        Snapshot.take(paths["replicated"],
                      {"s": StateDict(a=as_dtensor(full, mesh, [Replicate(), Replicate()]))})
        restore_into(paths["replicated"], full, _placements("xy"), full)

    run("fully_replicated", fully_replicated)

    # A mesh of ranks 0 and 1 only: ranks 2 and 3 hold and write nothing.
    half = world_mesh_of([0, 1])

    def outside_mesh():
        src = as_dtensor(full, half, [Shard(0)])
        assert (half.get_coordinate() is None) == (rank >= 2)
        Snapshot.take(paths["outside"], {"s": StateDict(a=src)})
        target = as_dtensor(torch.zeros_like(full), half, [Shard(1)])
        Snapshot(paths["outside"]).restore({"s": StateDict(a=target)})
        if rank < 2:
            assert target.to_local().equal(full[:, rank * 6:(rank + 1) * 6])
        assert Snapshot(paths["outside"]).read_object("0/s/a").equal(full)

    run("outside_mesh", outside_mesh)

    def boxes_match_torch():
        for shape in [(16, 12), (7, 5), (3, 4), (1, 9), (0, 3), (5,)]:
            for spec in SPECS:
                placements = _placements(spec)
                if len(shape) == 1 and spec in ("None_y", "x_y"):
                    continue
                sizes, offsets = compute_local_shape_and_global_offset(shape, mesh, placements)
                ours = local_box(list(shape), list(mesh.shape), mesh.get_coordinate(), placements)
                if 0 in sizes:
                    assert 0 in ours[1], (shape, spec, ours, sizes)
                else:
                    assert ours == (list(offsets), list(sizes)), (shape, spec, ours, offsets, sizes)

    run("boxes_match_torch", boxes_match_torch)

    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, outcomes)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({k: [g[k] for g in gathered] for k in outcomes}, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from tpusnap_torch.test_utils import run_subprocess_world

    root = str(tmp_path_factory.mktemp("sharded_world"))
    out = os.path.join(root, "outcomes.json")
    run_subprocess_world(_world_cases, world_size=4, args=[root, out], timeout=300)
    with open(out) as f:
        return root, json.load(f)


def _ok(world, case):
    outcomes = world[1][case]
    assert outcomes == ["ok"] * 4, "\n".join(o for o in outcomes if o != "ok")


def _manifest_entry(path, key="0/s/a"):
    from tpusnap_torch.manifest_ops import get_manifest_for_rank

    md = Snapshot(path).metadata
    return md, get_manifest_for_rank(md, int(key.split("/")[0]))[key.split("/", 1)[1]]


@pytest.mark.parametrize("src", SPECS)
@pytest.mark.parametrize("dst", SPECS)
def test_reshard_matrix(world, src, dst):
    _ok(world, f"take_{src}")
    _ok(world, f"matrix_{src}_{dst}")


def test_replica_dedup_in_manifest(world):
    """P("y") on the 2x2 mesh has 2 distinct pieces replicated twice: only
    the rank at coordinate 0 on the Replicate dim writes each."""
    _ok(world, "dedup")
    md, entry = _manifest_entry(_case_paths(world[0])["dedup"])
    assert isinstance(entry, ShardedEntry)
    assert sorted(tuple(s.offsets) for s in entry.shards) == [(0, 0), (8, 0)]
    # Ranks 0 and 1 (x == 0) wrote them; ranks 2 and 3 recorded no shard.
    per_rank = {k.split("/")[0]: len(e.shards) for k, e in md.manifest.items()
                if isinstance(e, ShardedEntry)}
    assert per_rank == {"0": 1, "1": 1, "2": 0, "3": 0}
    assert sorted(os.listdir(os.path.join(_case_paths(world[0])["dedup"], "sharded", "s"))) == [
        "a.0_0", "a.8_0"
    ]


def test_shard_subdivision(world):
    _ok(world, "subdivision")
    _, entry = _manifest_entry(_case_paths(world[0])["subdiv"])
    assert len(entry.shards) > 2  # 2 distinct pieces, each split
    assert all(tensor_nbytes(s.tensor.dtype, s.sizes) <= 64 for s in entry.shards)


def test_sharded_to_dense_read_object(world):
    _ok(world, "sharded_to_dense")
    dense = Snapshot(_case_paths(world[0])["dense_read"]).read_object("0/s/a")
    assert isinstance(dense, torch.Tensor) and not dense.is_cuda
    assert dense.equal(_full())


def test_dense_to_sharded_restore(world):
    """A snapshot of a dense tensor restores into a sharded target."""
    _ok(world, "dense_to_sharded")


def test_compressed_dense_to_sharded_restore(world):
    """A dense blob stored compressed restores into a DTensor target."""
    _ok(world, "compressed_dense_to_sharded")


def test_odd_shape_resharding(world):
    _ok(world, "odd_shape")


def test_sharded_bf16_bit_exact(world):
    _ok(world, "bf16")


class TestShardedSaveTimeTransform:
    """``cast_on_save`` reaches the sharded preparer, per local shard."""

    def test_manifest_records_stored_dtype(self, world):
        _ok(world, "cast_take")
        _, entry = _manifest_entry(_case_paths(world[0])["cast"])
        assert isinstance(entry, ShardedEntry)
        assert entry.dtype == "bfloat16"
        assert all(s.tensor.dtype == "bfloat16" for s in entry.shards)
        assert all(
            tensor_nbytes(s.tensor.dtype, s.tensor.shape) == np.prod(s.sizes) * 2
            for s in entry.shards
        )

    def test_restore_upcasts_into_f32_sharded_target(self, world):
        """Reshard and upcast in one restore."""
        _ok(world, "cast_upcast_restore")

    def test_restore_bit_exact_into_bf16_target(self, world):
        _ok(world, "cast_bf16_restore")

    def test_read_object_dense_returns_stored_dtype(self, world):
        out = Snapshot(_case_paths(world[0])["cast"]).read_object("0/s/a")
        assert out.dtype == torch.bfloat16
        assert out.view(torch.int16).equal(_transform_weights().to(torch.bfloat16).view(torch.int16))

    def test_dense_target_upcasts_in_place(self, world):
        target = torch.zeros(SHAPE, dtype=torch.float32)
        out = Snapshot(_case_paths(world[0])["cast"]).read_object("0/s/a", obj_out=target)
        assert out is target
        assert target.equal(_transform_weights().to(torch.bfloat16).float())

    def test_subdivision_uses_stored_itemsize(self, world):
        """The cap applies to the blob as written: a 384-byte f32 piece
        cast to 192 bytes of bf16 fits a 192-byte cap unsplit."""
        _ok(world, "cast_cap")
        _, entry = _manifest_entry(_case_paths(world[0])["cast_cap"])
        assert len(entry.shards) == 2


def test_uneven_shards_round_trip(world):
    """DTensor's trailing shards may be smaller: (7, 5) over 2 x 2, restored
    into every placement and read densely."""
    _ok(world, "uneven")
    _, entry = _manifest_entry(_case_paths(world[0])["uneven"])
    boxes = sorted((tuple(s.offsets), tuple(s.sizes)) for s in entry.shards)
    assert boxes == [((0, 0), (4, 3)), ((0, 3), (4, 2)), ((4, 0), (3, 3)), ((4, 3), (3, 2))]


def test_empty_shard_writes_nothing(world):
    """3 rows over 4 positions: the rank with the empty box writes no blob
    and records no shard; every placement still restores."""
    _ok(world, "empty")
    md, entry = _manifest_entry(_case_paths(world[0])["empty"])
    assert sorted(tuple(s.sizes) for s in entry.shards) == [(1, 4)] * 3
    assert not md.manifest["3/s/a"].shards
    assert len(os.listdir(os.path.join(_case_paths(world[0])["empty"], "sharded", "s"))) == 3


def test_partial_placement_refused(world):
    _ok(world, "partial_refused")


def test_strided_shard_placement_refused(world):
    _ok(world, "strided_refused")


def test_fully_replicated_dtensor_writes_one_box(world):
    """Like a jax.Array replicated across processes, it takes the sharded
    route with one box, written once."""
    _ok(world, "fully_replicated")
    md, entry = _manifest_entry(_case_paths(world[0])["replicated"])
    assert [(s.offsets, s.sizes) for s in entry.shards] == [([0, 0], list(SHAPE))]
    assert [k for k, e in md.manifest.items() if isinstance(e, ShardedEntry) and e.shards] == [
        "0/s/a"
    ]


def test_ranks_outside_the_mesh_write_nothing(world):
    _ok(world, "outside_mesh")
    md, entry = _manifest_entry(_case_paths(world[0])["outside"])
    assert sorted(tuple(s.offsets) for s in entry.shards) == [(0, 0), (8, 0)]
    assert not md.manifest["2/s/a"].shards and not md.manifest["3/s/a"].shards


def test_plain_take_does_not_import_dtensor(tmp_path):
    """``torch.distributed.tensor`` is imported by whoever makes a DTensor,
    never by the port for a take of plain tensors."""
    import subprocess
    import sys

    code = (
        "import sys, torch\n"
        "from tpusnap_torch import Snapshot, StateDict\n"
        f"Snapshot.take({str(tmp_path / 'snap')!r}, {{'a': StateDict(x=torch.ones(3))}})\n"
        "assert 'torch.distributed.tensor' not in sys.modules\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 0, proc.stderr


def test_local_box_matches_torch(world):
    """The box arithmetic agrees with torch's own for even, uneven and
    empty shards and nested Shard dims."""
    _ok(world, "boxes_match_torch")
