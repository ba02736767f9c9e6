"""Sharded MoE train-state snapshots across the two packages.

tpusnap's ``init_train_state`` of the tiny MoE flagship on its
(data, fsdp, tensor) = (2, 2, 2) mesh over conftest's 8 CPU devices,
holding numpy values from a seed in every leaf, is taken through
``PytreeState`` (``replicated=["**"]``, so that its fully replicated
leaves reach every rank of another world size). Then:

- it restores bit for bit into the port's dense world-1 train state and,
  in a world of two gloo processes, into ``init_train_state`` DTensors on
  a (1, 2, 1) mesh (each rank's local box, in place);
- the same world takes the port's own snapshot of other values as
  ``train_state_views`` on a (1, 1, 2) mesh, and tpusnap restores it bit
  for bit into its 8-device mesh.

The world is started once for the module; its processes import neither
JAX nor tpusnap, so both are imported only where the parent uses them.
"""

import json
import traceback

import numpy as np
import pytest
import torch

from tpusnap_torch import PytreeState, Snapshot
from tpusnap_torch.models import Transformer, TransformerConfig

_TINY = dict(vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16, n_experts=4)


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _nest(flat):
    out = {}
    for path, value in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    return out


def _port_model(seed=0):
    return Transformer(TransformerConfig(**_TINY), device="cpu", seed=seed)


def _values(seed):
    """Numpy values from a seed for every leaf of the train state."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, t in _walk(_port_model().train_state()):
        if path == "opt/step":
            out[path] = np.asarray(seed + 3, np.int32)
        else:
            out[path] = rng.standard_normal(tuple(t.shape)).astype(np.float32)
    return out


def _box(value, dtensor):
    from tpusnap_torch.io_preparers.sharded import local_box

    mesh = dtensor.device_mesh
    offsets, sizes = local_box(list(value.shape), list(mesh.shape), mesh.get_coordinate(),
                               list(dtensor.placements))
    return value[tuple(slice(o, o + n) for o, n in zip(offsets, sizes))]


def _restore_jax_snapshot(jax_path):
    """tpusnap's snapshot into init_train_state DTensors at (1, 2, 1)."""
    from tpusnap_torch.models import init_train_state, make_mesh

    want = _values(1)
    state = init_train_state(_port_model(seed=5), make_mesh("cpu", (1, 2, 1)))
    target = PytreeState(state)
    ids = {p: id(t) for p, t in _walk(state)}
    Snapshot(jax_path).restore({"m": target})
    for path, t in _walk(target.tree):
        assert id(t) == ids[path], path
        assert t.to_local().numpy().tobytes() == _box(want[path], t).tobytes(), path


def _take_port_snapshot(port_path):
    """Other values, as views of a model at (1, 1, 2)."""
    from tpusnap_torch.models import make_mesh, train_state_views

    model = _port_model(seed=6)
    model.train_state_from_jax(_nest(_values(2)))
    state = train_state_views(model, make_mesh("cpu", (1, 1, 2)))
    Snapshot.take(port_path, {"m": PytreeState(state)})


def _port_world(jax_path, port_path, out_path):
    """Each step runs on every rank; the ranks agree on its outcome
    before the next, so one rank's failure stops the world at once."""
    import torch.distributed as dist

    outcomes = {}
    for name, step in (("restore", lambda: _restore_jax_snapshot(jax_path)),
                       ("take", lambda: _take_port_snapshot(port_path))):
        outcome = "ok"
        try:
            step()
        except BaseException as e:  # reported by the tests that need it
            outcome = f"{type(e).__name__}: {e}\n{traceback.format_exc()[-1500:]}"
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, outcome)
        outcomes[name] = gathered
        if gathered != ["ok"] * len(gathered):
            break
    if dist.get_rank() == 0:
        with open(out_path, "w") as f:
            json.dump(outcomes, f)


def _jax_state(values, mesh):
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from tpusnap.models.transformer import Transformer as JaxTransformer
    from tpusnap.models.transformer import TransformerConfig as JaxConfig
    from tpusnap.models.transformer import init_train_state, train_state_specs

    jm = JaxTransformer(JaxConfig(**_TINY))
    state = init_train_state(jm, mesh, jax.random.PRNGKey(0))
    specs = dict(_walk(jax.tree.map(lambda s: s, train_state_specs(jm),
                                    is_leaf=lambda s: isinstance(s, P))))
    flat = {p: jax.device_put(values[p], NamedSharding(mesh, specs[p])) for p in values}
    assert sorted(flat) == sorted(p for p, _ in _walk(state))
    return _nest(flat)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    import jax

    from tpusnap import PytreeState as JaxPytreeState
    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap.models.transformer import make_mesh
    from tpusnap_torch.test_utils import run_subprocess_world

    root = tmp_path_factory.mktemp("models_parity")
    jax_path, port_path = str(root / "jax"), str(root / "port")
    mesh = make_mesh(jax.devices()[:8], (2, 2, 2))
    # Fully replicated leaves are dense entries of rank 0 unless marked
    # replicated, as a job that restores at another world size marks them.
    JaxSnapshot.take(jax_path, {"m": JaxPytreeState(_jax_state(_values(1), mesh))},
                     replicated=["**"])
    out = str(root / "outcomes.json")
    run_subprocess_world(_port_world, world_size=2, args=[jax_path, port_path, out], timeout=300)
    with open(out) as f:
        outcomes = json.load(f)
    return jax_path, port_path, outcomes, mesh


def _world_ok(snapshots, step):
    got = snapshots[2].get(step)
    assert got == ["ok", "ok"], f"{step}: " + "\n".join(o for o in got or ["not run"] if o != "ok")


def test_tpusnap_moe_snapshot_restores_into_dense_port_state(snapshots):
    model = _port_model(seed=9)
    state = model.train_state()
    ids = {p: id(t) for p, t in _walk(state)}
    Snapshot(snapshots[0]).restore({"m": PytreeState(state)})
    want = _values(1)
    for path, t in _walk(model.train_state()):
        assert id(t) == ids[path], path
        assert t.detach().numpy().tobytes() == want[path].tobytes(), path


def test_tpusnap_moe_snapshot_restores_into_port_dtensors(snapshots):
    _world_ok(snapshots, "restore")


def test_port_moe_snapshot_restores_through_tpusnap(snapshots):
    import jax

    from tpusnap import PytreeState as JaxPytreeState
    from tpusnap import Snapshot as JaxSnapshot

    _world_ok(snapshots, "take")
    mesh = snapshots[3]
    zeros = {p: np.zeros_like(v) for p, v in _values(2).items()}
    target = JaxPytreeState(_jax_state(zeros, mesh))
    JaxSnapshot(snapshots[1]).restore({"m": target})
    want = _values(2)
    specs_before = {p: a.sharding for p, a in _walk(_jax_state(zeros, mesh))}
    for path, arr in _walk(target.tree):
        assert arr.sharding.is_equivalent_to(specs_before[path], arr.ndim), path
        assert np.asarray(arr).tobytes() == want[path].tobytes(), path
    assert len(jax.tree.leaves(target.tree)) == 31


def test_port_moe_snapshot_is_sharded_at_the_tensor_layout(snapshots):
    from tpusnap_torch.manifest import ShardedEntry
    from tpusnap_torch.manifest_ops import get_manifest_for_rank

    _world_ok(snapshots, "take")
    manifest = get_manifest_for_rank(Snapshot(snapshots[1]).metadata, 0)
    w1e = manifest["m/params/layers/w1e"]
    assert isinstance(w1e, ShardedEntry)
    # [L, E, D, F] over (1, 1, 2): only "tensor" (F) is split.
    assert sorted(tuple(s.offsets) for s in w1e.shards) == [(0, 0, 0, 0), (0, 0, 0, 32)]
    assert len(manifest["m/params/ln_f"].shards) == 1  # replicated: written once
