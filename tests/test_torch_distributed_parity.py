"""World-2 snapshots across the two packages.

The same numpy inputs (per-rank values and replicated ones, small slab
members, standalone blobs and a chunked tensor whose chunks the
partitioner spreads over both ranks) are taken by a tpusnap world of two
JAX processes (``tpusnap.test_utils.run_subprocess_world``) and by a
tpusnap_torch world of two gloo processes
(``tpusnap_torch.test_utils.run_subprocess_world``). Then:

- the tpusnap snapshot restores bit for bit through the port at world 2
  and at world 1;
- the port's snapshot restores bit for bit through tpusnap at world 2;
- the two manifests have the same keys, entries and replicated
  locations (slab file names aside, which are random), the same writer
  for every replicated blob, and both record one checksum algorithm on
  every tensor entry.
"""

import json

import numpy as np
import pytest

# Each world's processes import this module: the JAX ranks must not pay
# for torch, nor the torch ranks for JAX, so both are imported where used.

# Small slabs and chunks so that a small world exercises both: members
# under 4 KiB are batched, tensors over 16 KiB are chunked.
_ENV = {
    "TPUSNAP_SLAB_SIZE_THRESHOLD_BYTES": str(4 * 1024),
    "TPUSNAP_MAX_CHUNK_SIZE_BYTES": str(16 * 1024),
}


def _inputs(rank: int) -> dict:
    """numpy values: ``own`` differs per rank, ``r_*`` are replicated."""
    rng = np.random.default_rng(1234)
    values = {
        "r_big": rng.standard_normal((96, 128)).astype(np.float32),  # 3 chunks
        "r_mid0": rng.standard_normal((40, 32)).astype(np.float32),
        "r_mid1": rng.integers(-1000, 1000, (30, 50)).astype(np.int32),
        "r_small0": rng.standard_normal(64).astype(np.float32),
        "r_small1": rng.integers(0, 255, 200).astype(np.uint8),
    }
    values["own"] = np.random.default_rng(rank).standard_normal((64, 33)).astype(np.float32)
    return values


_GLOBS = ["app/r_*"]


def _record_writes(fs_module, out_path):
    """Record every blob path this process writes (metadata and journal
    files aside) into ``out_path`` at exit."""
    import atexit

    written = []
    orig = fs_module.FSStoragePlugin.write

    async def write(self, write_io):
        if not write_io.path.startswith("."):
            written.append(write_io.path)
        await orig(self, write_io)

    fs_module.FSStoragePlugin.write = write

    def dump():
        with open(out_path, "w") as f:
            json.dump(written, f)

    atexit.register(dump)


def _jax_world_take(snap_dir, out_prefix):
    import jax.numpy as jnp

    import tpusnap.storage_plugins.fs as fs
    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import StateDict as JaxStateDict
    from tpusnap.comm import get_communicator

    rank = get_communicator().rank
    _record_writes(fs, f"{out_prefix}.{rank}")
    state = JaxStateDict(**{k: jnp.asarray(v) for k, v in _inputs(rank).items()}, step=11)
    JaxSnapshot.take(snap_dir, {"app": state}, replicated=_GLOBS)


def _jax_world_restore(snap_dir):
    import jax.numpy as jnp

    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import StateDict as JaxStateDict
    from tpusnap.comm import get_communicator

    rank = get_communicator().rank
    want = _inputs(rank)
    target = JaxStateDict(**{k: jnp.zeros_like(jnp.asarray(v)) for k, v in want.items()}, step=0)
    JaxSnapshot(snap_dir).restore({"app": target})
    assert target["step"] == 11
    for k, v in want.items():
        got = np.asarray(target[k])
        assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), k


def _port_world_take(snap_dir, out_prefix):
    import torch

    import tpusnap_torch.storage_plugins.fs as fs
    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.comm import get_communicator

    rank = get_communicator().rank
    _record_writes(fs, f"{out_prefix}.{rank}")
    state = StateDict(**{k: torch.from_numpy(v) for k, v in _inputs(rank).items()}, step=11)
    Snapshot.take(snap_dir, {"app": state}, replicated=_GLOBS)


def _port_restore_and_check(snap_dir, rank):
    import torch

    from tpusnap_torch import Snapshot, StateDict

    want = _inputs(rank)
    target = StateDict(**{k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in want.items()}, step=0)
    before = {k: id(target[k]) for k in want}
    Snapshot(snap_dir).restore({"app": target})
    assert target["step"] == 11
    for k, v in want.items():
        assert id(target[k]) == before[k], f"{k} restored out of place"
        assert target[k].numpy().tobytes() == v.tobytes(), k


def _port_world_restore(snap_dir):
    from tpusnap_torch.comm import get_communicator

    _port_restore_and_check(snap_dir, get_communicator().rank)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """One world-2 snapshot from each package, with the blob paths each
    rank wrote."""
    import tpusnap.test_utils as jax_test_utils
    from tpusnap_torch.test_utils import run_subprocess_world

    root = tmp_path_factory.mktemp("parity")
    jax_snap, port_snap = str(root / "jax"), str(root / "port")
    jax_test_utils.run_subprocess_world(
        _jax_world_take, world_size=2, devices_per_process=1,
        args=[jax_snap, str(root / "jax_writes")], extra_env=_ENV,
    )
    run_subprocess_world(
        _port_world_take, world_size=2, args=[port_snap, str(root / "port_writes")],
        extra_env=_ENV,
    )

    def writes(prefix):
        out = {}
        for rank in (0, 1):
            with open(f"{prefix}.{rank}") as f:
                out[rank] = json.load(f)
        return out

    return {
        "jax": jax_snap,
        "port": port_snap,
        "jax_writes": writes(str(root / "jax_writes")),
        "port_writes": writes(str(root / "port_writes")),
    }


def test_tpusnap_world2_restores_through_port_at_world2(snapshots):
    from tpusnap_torch.test_utils import run_subprocess_world

    run_subprocess_world(_port_world_restore, world_size=2, args=[snapshots["jax"]])


def test_tpusnap_world2_restores_through_port_at_world1(snapshots):
    _port_restore_and_check(snapshots["jax"], 0)


def test_port_world2_restores_through_tpusnap_at_world2(snapshots):
    import tpusnap.test_utils as jax_test_utils

    jax_test_utils.run_subprocess_world(
        _jax_world_restore, world_size=2, devices_per_process=1, args=[snapshots["port"]]
    )


def _tensors(entry):
    from tpusnap_torch.manifest import ChunkedTensorEntry, TensorEntry

    if isinstance(entry, TensorEntry):
        return [entry]
    if isinstance(entry, ChunkedTensorEntry):
        return [c.tensor for c in entry.chunks]
    return []


def _writers(manifest, writes):
    """Logical path (chunk index for chunks) -> the rank that wrote the
    blob the manifest points at."""
    by_path = {p: r for r, paths in writes.items() for p in paths}
    out = {}
    for key, entry in manifest.items():
        for i, t in enumerate(_tensors(entry)):
            if getattr(entry, "replicated", False):
                out[f"{key}::{i}"] = by_path[t.location]
    return out


def test_manifests_agree_across_packages(snapshots):
    from tpusnap_torch import Snapshot

    jax_md = Snapshot(snapshots["jax"]).metadata
    port_md = Snapshot(snapshots["port"]).metadata
    assert jax_md.world_size == port_md.world_size == 2
    assert sorted(jax_md.manifest) == sorted(port_md.manifest)
    # Replicated values live in rank 0's tree only, stored under
    # replicated/ (or a slab) by one writer.
    assert "0/app/r_big" in port_md.manifest and "1/app/r_big" not in port_md.manifest

    algos = set()

    def normalized(entry):
        d = entry.to_dict() if hasattr(entry, "to_dict") else dict(vars(entry))
        d = json.loads(json.dumps(d, default=lambda o: vars(o)))

        def walk(o):
            if isinstance(o, dict):
                loc = o.get("location")
                if isinstance(loc, str) and loc.startswith("batched/"):
                    o["location"] = "batched/<slab>"
                for v in o.values():
                    walk(v)
            elif isinstance(o, list):
                for v in o:
                    walk(v)

        walk(d)
        return d

    for key in sorted(port_md.manifest):
        je, pe = jax_md.manifest[key], port_md.manifest[key]
        assert type(je).__name__ == type(pe).__name__, key
        for t in _tensors(je) + _tensors(pe):
            assert t.checksum is not None, (key, t.location)
            algos.add(t.checksum.split(":", 1)[0])
        assert normalized(je) == normalized(pe), key
    assert algos == {"crc32c"}, algos

    jax_writers = _writers(jax_md.manifest, snapshots["jax_writes"])
    port_writers = _writers(port_md.manifest, snapshots["port_writes"])
    assert jax_writers == port_writers
    # The plan spread the replicated bytes over both ranks.
    assert set(port_writers.values()) == {0, 1}, port_writers
    # Each rank wrote its own per-rank blob (or slab) and nothing twice.
    for writes in (snapshots["jax_writes"], snapshots["port_writes"]):
        assert not set(writes[0]) & set(writes[1])
