"""DTensor state in a world of two gloo ranks: the sharded cases of
tpusnap's incremental and inspect tests, the global-mesh case of
tests/test_distributed.py, an async take under in-place updates of the
local shards, and the durable commit.

- ``test_sharded_incremental`` and ``test_sharded_subdivided_incremental``
  (tests/test_incremental.py): an unchanged sharded increment writes no
  blob; a changed tensor rewrites every shard;
- ``test_materialized_snapshot_reshards_on_restore``: materialize, delete
  the base, restore into another placement;
- ``test_sharded_snapshot_verifies_and_detects`` (tests/test_inspect.py),
  and a checksum on every shard of a world-2 take (shards hash on the
  write path, after the manifest gather, so their checksums must reach
  the committed manifest through the late-checksum records);
- ``test_global_mesh_sharded_take_restore`` (tests/test_distributed.py);
- an async take whose local shards are updated in place after it returns
  (clones) or after ``wait_staged()`` (COW): the snapshot holds the values
  from before;
- ``test_durable_commit_world2``: every rank fsyncs its blobs and the
  directories it created, rank 0 the metadata, and the snapshots restore
  and verify.

The world starts once for the module (``_world_cases``); each rank
records each case's outcome, and the tests read them and look at the
snapshots on disk from this process.
"""

import json
import os
import shutil
import traceback

import pytest
import torch

from tpusnap_torch import Snapshot, verify_snapshot
from tpusnap_torch.manifest import ShardedEntry
from tpusnap_torch.manifest_ops import get_manifest_for_rank

def _w(shape=(64, 64), plus=0.0):
    return torch.arange(shape[0] * shape[1], dtype=torch.float32).reshape(shape) + plus


def _world_cases(root, out_path):
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    import tpusnap_torch.storage_plugins.fs as fs
    from tpusnap_torch import StateDict
    from tpusnap_torch.knobs import override_async_cow, override_max_shard_size_bytes
    from tpusnap_torch.test_utils import as_dtensor, world_mesh

    mesh = world_mesh("cpu")
    rank = dist.get_rank()
    outcomes = {}

    def p(name):
        return os.path.join(root, name)

    def sharded(full, dim=0):
        return as_dtensor(full, mesh, [Shard(dim)])

    def restore_equals(path, full, dim=0):
        target = sharded(torch.zeros_like(full), dim)
        state = StateDict(w=target)
        Snapshot(path).restore({"m": state})
        assert state["w"] is target
        rows = full.shape[dim] // 2
        want = full.narrow(dim, rank * rows, rows)
        assert target.to_local().equal(want), (path, dim)

    def run(name, fn):
        dist.barrier()
        try:
            fn()
            outcomes[name] = "ok"
        except BaseException as e:  # recorded: the test of this case fails with it
            outcomes[name] = f"{type(e).__name__}: {e}\n{traceback.format_exc()[-1500:]}"

    def incremental():
        w = _w()
        Snapshot.take(p("inc0"), {"m": StateDict(w=sharded(w))})
        Snapshot.take(p("inc1"), {"m": StateDict(w=sharded(w))}, incremental_from=p("inc0"))
        w2 = _w(plus=1.0)
        Snapshot.take(p("inc2"), {"m": StateDict(w=sharded(w2))}, incremental_from=p("inc1"))
        restore_equals(p("inc2"), w2)
        restore_equals(p("inc1"), w)

    def subdivided_incremental():
        w = _w((1024, 8))
        with override_max_shard_size_bytes(8 * 1024):
            Snapshot.take(p("sub0"), {"m": StateDict(w=sharded(w))})
            Snapshot.take(p("sub1"), {"m": StateDict(w=sharded(w))}, incremental_from=p("sub0"))
        restore_equals(p("sub1"), w)

    def materialize():
        w = _w()
        Snapshot.take(p("mat0"), {"m": StateDict(w=sharded(w))})
        Snapshot.take(p("mat1"), {"m": StateDict(w=sharded(w))}, incremental_from=p("mat0"))
        dist.barrier()
        if rank == 0:
            Snapshot(p("mat1")).materialize()
            shutil.rmtree(p("mat0"))
        dist.barrier()
        restore_equals(p("mat1"), w, dim=1)

    def verify():
        Snapshot.take(p("verify"), {"m": StateDict(w=sharded(_w()))})

    def global_mesh():
        g = torch.arange(32, dtype=torch.float32).reshape(8, 4)
        Snapshot.take(p("global"), {"m": StateDict(w=sharded(g))})
        restore_equals(p("global"), g)

    def async_take(name, cow):
        x = torch.randn((256, 64), generator=torch.Generator().manual_seed(7))
        before = x.clone()
        src = sharded(x)
        with override_async_cow(cow):
            pending = Snapshot.async_take(p(name), {"m": StateDict(w=src)})
            if cow:
                assert pending.wait_staged(timeout=60)
            with torch.no_grad():
                src.to_local().add_(1.0)  # training updates the local shard in place
            pending.wait()
        assert not x.equal(before)
        restore_equals(p(name), before)

    def durable():
        synced = []
        orig = fs._fsync_path

        def counting(path):
            synced.append(os.path.relpath(path, root))
            orig(path)

        fs._fsync_path = counting
        os.environ["TPUSNAP_DURABLE_COMMIT"] = "1"
        try:
            own = torch.full((64,), float(rank))
            Snapshot.take(p("dur0"), {"m": StateDict(w=sharded(_w()), own=own)})
            Snapshot.async_take(p("dur1"), {"m": StateDict(w=sharded(_w()), own=own)}).wait()
        finally:
            del os.environ["TPUSNAP_DURABLE_COMMIT"]
            fs._fsync_path = orig
        for snap in ("dur0", "dur1"):
            shard = f"{snap}/sharded/m/w.{32 * rank}_0"
            # Each rank fsyncs its own blobs and the directories it made.
            assert shard in synced and f"{snap}/{rank}/m/own" in synced, synced
            assert f"{snap}/sharded/m" in synced and f"{snap}/{rank}/m" in synced, synced
            if rank == 0:
                assert any(s.startswith(f"{snap}/.snapshot_metadata.tmp") for s in synced), synced
            restore_equals(p(snap), _w())

    for name, fn in [
        ("incremental", incremental),
        ("subdivided_incremental", subdivided_incremental),
        ("materialize", materialize),
        ("verify", verify),
        ("global_mesh", global_mesh),
        ("async_clone", lambda: async_take("async_clone", cow=False)),
        ("async_cow", lambda: async_take("async_cow", cow=True)),
        ("durable", durable),
    ]:
        run(name, fn)

    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, outcomes)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({k: [g[k] for g in gathered] for k in outcomes}, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from tpusnap_torch.test_utils import run_subprocess_world

    root = str(tmp_path_factory.mktemp("sharded_take"))
    out = os.path.join(root, "outcomes.json")
    run_subprocess_world(_world_cases, world_size=2, args=[root, out], timeout=300)
    with open(out) as f:
        return root, json.load(f)


def _ok(world, case):
    outcomes = world[1][case]
    assert outcomes == ["ok", "ok"], "\n".join(o for o in outcomes if o != "ok")
    return lambda name: os.path.join(world[0], name)


def _blob_files(root):
    out = []
    for dirpath, _, files in os.walk(root):
        if ".tpusnap" not in dirpath.split(os.sep):
            out += [os.path.relpath(os.path.join(dirpath, f), root)
                    for f in files if f != ".snapshot_metadata"]
    return sorted(out)


def _merged(path, logical="m/w"):
    return get_manifest_for_rank(Snapshot(path).metadata, 0)[logical]


def test_sharded_incremental(world):
    p = _ok(world, "incremental")
    assert _blob_files(p("inc1")) == []
    assert verify_snapshot(p("inc1")).clean
    # The tensor changed: every shard rewrote, one blob each.
    assert _blob_files(p("inc2")) == ["sharded/m/w.0_0", "sharded/m/w.32_0"]
    assert all(not s.tensor.location.startswith("../") for s in _merged(p("inc2")).shards)


def test_sharded_subdivided_incremental(world):
    """Shards split by the max shard size dedup per sub-box."""
    p = _ok(world, "subdivided_incremental")
    assert len(_merged(p("sub0")).shards) == 4
    assert _blob_files(p("sub1")) == []
    assert verify_snapshot(p("sub1")).clean


def test_materialized_snapshot_reshards_on_restore(world):
    """Materialize rewrote the shard locations; the overlap reads restore
    from the local copies (base deleted) into Shard(1)."""
    p = _ok(world, "materialize")
    assert not os.path.exists(p("mat0"))
    assert all(not s.tensor.location.startswith("../") for s in _merged(p("mat1")).shards)
    assert verify_snapshot(p("mat1")).clean


def test_every_shard_of_a_world2_take_has_a_checksum(world):
    p = _ok(world, "verify")
    for name in ("verify", "async_clone", "inc0"):
        md = Snapshot(p(name)).metadata
        shards = [s for e in md.manifest.values() if isinstance(e, ShardedEntry) for s in e.shards]
        assert len(shards) == 2
        assert all((s.tensor.checksum or "").startswith("crc32c:") for s in shards), name


def test_sharded_snapshot_verifies_and_detects(world, tmp_path):
    from test_torch_inspect import _flip_byte

    p = _ok(world, "verify")
    path = str(tmp_path / "verify")
    shutil.copytree(p("verify"), path)
    report = verify_snapshot(path)
    assert report.clean and report.ok >= 2  # one range per shard at least
    _flip_byte(path, "sharded", offset=8)
    assert not verify_snapshot(path).clean


def test_global_mesh_sharded_take_restore(world):
    p = _ok(world, "global_mesh")
    shards = [
        tuple(s.offsets)
        for e in Snapshot(p("global")).metadata.manifest.values()
        if isinstance(e, ShardedEntry)
        for s in e.shards
    ]
    assert sorted(shards) == [(0, 0), (4, 0)]


@pytest.mark.parametrize("mode", ["async_clone", "async_cow"])
def test_async_sharded_take_then_in_place_updates(world, mode):
    _ok(world, mode)


def test_durable_commit_world2(world):
    p = _ok(world, "durable")
    assert verify_snapshot(p("dur0")).clean
    assert verify_snapshot(p("dur1")).clean
