"""Sharded snapshots across the two packages.

The same numpy inputs are taken by tpusnap on its 8-device CPU mesh
(tests/conftest.py) as ``NamedSharding`` arrays, and by a tpusnap_torch
world of two gloo processes as ``Shard(0)`` DTensors. Then:

- the tpusnap snapshot restores bit for bit through the port into dense
  tensors, by ``read_object``, and into ``Shard(0)`` DTensors at world 2;
- the port's snapshot restores bit for bit through tpusnap into
  ``NamedSharding`` arrays, and its uneven tensor (DTensor allows one,
  JAX does not) into a dense target;
- both manifests hold the same shard boxes, blob names and checksums,
  and both record one checksum algorithm;
- the port's snapshot passes the json+numpy reader of
  tests/test_format_conformance.py.

The port's world is started once for the module; it imports neither JAX
nor tpusnap, so both are imported only where the parent uses them.
"""

import json
import traceback

import numpy as np
import pytest
import torch

from tpusnap_torch import Snapshot, StateDict
from tpusnap_torch.manifest import ShardedEntry
from tpusnap_torch.manifest_ops import get_manifest_for_rank

# Tensors both packages shard by rows into the same two boxes: tpusnap
# with P("y") on its (4, 2) mesh, the port with Shard(0) over 2 ranks.
_SAME_BOXES = ("f", "b", "i")


def _inputs() -> dict:
    rng = np.random.default_rng(2024)
    bits = rng.integers(0, 1 << 16, (16, 128), dtype=np.uint16)
    return {
        "f": rng.standard_normal((16, 12)).astype(np.float32),
        "b": bits,  # bf16, by its bits
        "i": rng.integers(-1000, 1000, (12, 6)).astype(np.int32),
        "u": rng.standard_normal((7, 12)).astype(np.float32),  # uneven at world 2
    }


def _torch_value(name, value):
    t = torch.from_numpy(value.copy())
    return t.view(torch.int16).view(torch.bfloat16) if name == "b" else t


def _same_bits(t: torch.Tensor, value: np.ndarray) -> bool:
    return t.detach().contiguous().view(torch.uint8).numpy().tobytes() == value.tobytes()


def _port_world(jax_path, port_path, out_path):
    """Restore tpusnap's snapshot into Shard(0) DTensors, then take the
    port's own snapshot of the inputs as Shard(0) DTensors."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from tpusnap_torch.test_utils import as_dtensor, world_mesh

    mesh = world_mesh("cpu")
    inputs = _inputs()
    outcome = "ok"
    try:
        # "g" is "f" stored by tpusnap in 8 boxes: resharded here.
        want = {k: inputs[k] for k in ("f", "b", "i")}
        want["g"] = inputs["f"]
        targets = {
            k: as_dtensor(torch.zeros_like(_torch_value(k, v)), mesh, [Shard(0)])
            for k, v in want.items()
        }
        state = StateDict(**targets)
        Snapshot(jax_path).restore({"s": state})
        r = dist.get_rank()
        for k, v in want.items():
            assert state[k] is targets[k], k
            rows = v.shape[0] // 2
            assert _same_bits(targets[k].to_local(), v[r * rows:(r + 1) * rows]), k
        Snapshot.take(port_path, {"s": StateDict(**{
            k: as_dtensor(_torch_value(k, v), mesh, [Shard(0)]) for k, v in inputs.items()
        })})
    except BaseException as e:  # reported by the tests that need it
        outcome = f"{type(e).__name__}: {e}\n{traceback.format_exc()[-1500:]}"
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, outcome)
    if dist.get_rank() == 0:
        with open(out_path, "w") as f:
            json.dump(gathered, f)


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("x", "y"))


def _jax_value(name, value):
    import jax.numpy as jnp
    import ml_dtypes

    return jnp.asarray(value.view(ml_dtypes.bfloat16) if name == "b" else value)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import StateDict as JaxStateDict
    from tpusnap_torch.test_utils import run_subprocess_world

    root = tmp_path_factory.mktemp("sharded_parity")
    jax_path, port_path = str(root / "jax"), str(root / "port")
    mesh = _jax_mesh()
    inputs = _inputs()
    state = {
        k: jax.device_put(_jax_value(k, inputs[k]), NamedSharding(mesh, P("y")))
        for k in _SAME_BOXES
    }
    state["g"] = jax.device_put(_jax_value("f", inputs["f"]), NamedSharding(mesh, P("x", "y")))
    JaxSnapshot.take(jax_path, {"s": JaxStateDict(**state)})
    out = str(root / "outcomes.json")
    run_subprocess_world(_port_world, world_size=2, args=[jax_path, port_path, out], timeout=300)
    with open(out) as f:
        outcomes = json.load(f)
    return jax_path, port_path, outcomes


def _world_ok(snapshots):
    assert snapshots[2] == ["ok", "ok"], "\n".join(o for o in snapshots[2] if o != "ok")


def test_tpusnap_sharded_snapshot_restores_into_dense_port_tensors(snapshots):
    inputs = _inputs()
    names = {"f": "f", "b": "b", "i": "i", "g": "f"}
    targets = {k: torch.zeros_like(_torch_value(v, inputs[v])) for k, v in names.items()}
    state = StateDict(**targets)
    Snapshot(snapshots[0]).restore({"s": state})
    for k, v in names.items():
        assert state[k] is targets[k]
        assert _same_bits(targets[k], inputs[v]), k


def test_tpusnap_sharded_snapshot_read_object_through_port(snapshots):
    inputs = _inputs()
    for k, v in {"f": "f", "b": "b", "i": "i", "g": "f"}.items():
        out = Snapshot(snapshots[0]).read_object(f"0/s/{k}")
        assert _same_bits(out, inputs[v]), k
    assert Snapshot(snapshots[0]).read_object("0/s/b").dtype == torch.bfloat16


def test_tpusnap_sharded_snapshot_restores_into_port_dtensors(snapshots):
    _world_ok(snapshots)


def test_port_sharded_snapshot_restores_through_tpusnap(snapshots):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import StateDict as JaxStateDict

    _world_ok(snapshots)
    mesh = _jax_mesh()
    inputs = _inputs()
    specs = {"f": P("x", "y"), "b": P(("x", "y"),), "i": P(None, "y")}
    target = JaxStateDict(**{
        k: jax.device_put(jnp.zeros_like(_jax_value(k, inputs[k])), NamedSharding(mesh, spec))
        for k, spec in specs.items()
    })
    target["u"] = np.zeros((7, 12), np.float32)
    JaxSnapshot(snapshots[1]).restore({"s": target})
    for k, spec in specs.items():
        out = target[k]
        assert out.sharding.is_equivalent_to(NamedSharding(mesh, spec), out.ndim), k
        assert np.asarray(out).tobytes() == inputs[k].tobytes(), k
    assert target["u"].tobytes() == inputs["u"].tobytes()


def test_port_uneven_snapshot_restores_dense_through_tpusnap(snapshots):
    from tpusnap import Snapshot as JaxSnapshot

    _world_ok(snapshots)
    md = Snapshot(snapshots[1]).metadata
    assert sorted(tuple(s.sizes) for s in get_manifest_for_rank(md, 0)["s/u"].shards) == [
        (3, 12), (4, 12)
    ]
    target = np.zeros((7, 12), np.float32)
    out = JaxSnapshot(snapshots[1]).read_object("0/s/u", obj_out=target)
    assert out is target
    assert target.tobytes() == _inputs()["u"].tobytes()


def _shards(path, name):
    entry = get_manifest_for_rank(Snapshot(path).metadata, 0)[f"s/{name}"]
    assert isinstance(entry, ShardedEntry)
    return entry, {
        tuple(s.offsets): (tuple(s.sizes), s.tensor.location, s.tensor.dtype, s.tensor.checksum)
        for s in entry.shards
    }


def test_manifests_have_same_boxes_and_blob_names(snapshots):
    _world_ok(snapshots)
    for name in _SAME_BOXES:
        jax_entry, jax_shards = _shards(snapshots[0], name)
        port_entry, port_shards = _shards(snapshots[1], name)
        assert (jax_entry.dtype, jax_entry.shape) == (port_entry.dtype, port_entry.shape), name
        assert jax_shards == port_shards, name
        assert len(port_shards) == 2
    # Each port rank recorded the box it owns, under its own key.
    md = Snapshot(snapshots[1]).metadata
    assert [tuple(s.offsets) for s in md.manifest["1/s/f"].shards] == [(8, 0)]


def test_both_record_one_checksum_algorithm(snapshots):
    _world_ok(snapshots)
    for path in snapshots[:2]:
        for name in _SAME_BOXES:
            _, shards = _shards(path, name)
            assert all(cs.startswith("crc32c:") for *_, cs in shards.values()), (path, name)


def test_port_sharded_snapshot_passes_external_reader(snapshots):
    from test_format_conformance import _external_reader

    _world_ok(snapshots)
    md, read = _external_reader(snapshots[1])
    inputs = _inputs()
    for name, value in inputs.items():
        out = np.empty(value.shape, value.dtype)
        for rank in ("0", "1"):
            part = read(f"{rank}/s/{name}")
            for s in md["manifest"][f"{rank}/s/{name}"]["shards"]:
                box = tuple(slice(o, o + n) for o, n in zip(s["offsets"], s["sizes"]))
                out[box] = part[box].view(value.dtype)
        assert out.tobytes() == value.tobytes(), name
