"""tpusnap_torch.models.embedding against tpusnap's, and its sharded
snapshots: the mirror of tests/test_embedding.py.

In this process, on the same numpy inputs: the forward (all-padding bags
give 0), one row-wise Adagrad step for every sharding, and
``rand_features`` against tpusnap's. In one world of four gloo processes
on a (1, 2, 2) ``("data", "fsdp", "tensor")`` mesh (started once for the
module; the world records each case's outcome and the tests read it):
the src x dst resharding matrix (row/col/table, sync and async), frozen
tables deduped by an incremental take (device and host-offloaded: no
blob), trained tables rewritten, shard subdivision under a 256-byte max
shard, and a restore into the smaller (1, 2, 1) mesh of ranks 0 and 1.
Host-offloaded tables are CPU tensors here; pinned ones need the card
(tests/test_torch_cuda.py).
"""

import itertools
import json
import os
import traceback

import numpy as np
import pytest
import torch

from tpusnap_torch import PytreeState, Snapshot
from tpusnap_torch.models import EmbeddingCollection, TableConfig, rand_features

torch.set_num_threads(1)

SHARDINGS = ("row", "col", "table")
_MATRIX = [
    (src, dst, mode)
    for src, dst, mode in itertools.product(SHARDINGS, SHARDINGS, ("sync", "async"))
]


def _tables(sharding, host_offload=False):
    # "table" groups need >= 2 same-shape tables; 4 shard the stacked
    # [4, V, D] group 4 ways over ("fsdp", "tensor").
    return [
        dict(name=f"t{i}", num_embeddings=64, embedding_dim=16, sharding=sharding,
             host_offload=host_offload, pooling="mean" if i % 2 else "sum")
        for i in range(4)
    ]


def _model(sharding, seed=0, host_offload=False):
    return EmbeddingCollection(
        [TableConfig(**t) for t in _tables(sharding, host_offload)], device="cpu", seed=seed
    )


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


# ------------------------------------------------- against tpusnap, one process


def _jax_pair(sharding):
    import jax

    from tpusnap.models import EmbeddingCollection as JaxCollection
    from tpusnap.models import TableConfig as JaxTableConfig

    jm = JaxCollection([JaxTableConfig(**t) for t in _tables(sharding)])
    params = jm.init(jax.random.PRNGKey(0))
    tm = _model(sharding, seed=3)
    tm.params_from_jax(jax.tree.map(np.asarray, params))
    return jm, params, tm


def test_rand_features_match_tpusnap():
    from tpusnap.models.embedding import rand_features as jax_rand_features

    jm, _, tm = _jax_pair("row")
    jf, jt = jax_rand_features(jm, None, batch=8, bag=5, seed=11)
    tf, tt = rand_features(tm, batch=8, bag=5, seed=11)
    assert sorted(tf) == sorted(jf)
    for name in tf:
        assert tf[name].dtype == torch.int32
        np.testing.assert_array_equal(tf[name].numpy(), np.asarray(jf[name]))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert (tf["t0"] == -1).any()


@pytest.mark.parametrize("sharding", SHARDINGS + ("replicated",))
def test_forward_matches_tpusnap_and_padding_gives_zero(sharding):
    import jax.numpy as jnp

    from tpusnap.models.embedding import rand_features as jax_rand_features

    jm, params, tm = _jax_pair(sharding)
    jf, _ = jax_rand_features(jm, None, batch=8, bag=5)
    tf, _ = rand_features(tm, batch=8, bag=5)
    out = tm.apply(tf)
    assert out.shape == (8, 4 * 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.apply(params, jf)), atol=1e-6)
    tf["t0"] = torch.full_like(tf["t0"], -1)
    jf["t0"] = jnp.full_like(jf["t0"], -1)
    out = tm.apply(tf)
    np.testing.assert_array_equal(out[:, :16].numpy(), 0.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.apply(params, jf)), atol=1e-6)


@pytest.mark.parametrize("sharding", SHARDINGS + ("replicated",))
def test_adagrad_step_matches_tpusnap(sharding):
    import jax

    from tpusnap.models import make_embedding_train_step, make_mesh
    from tpusnap.models.embedding import rand_features as jax_rand_features

    jm, params, tm = _jax_pair(sharding)
    step = make_embedding_train_step(jm, make_mesh(jax.devices()[:1]))
    jf, jt = jax_rand_features(jm, None, batch=8, bag=5, seed=3)
    new_params, jloss = step(params, jf, jt)
    ids = {p: id(t) for p, t in _walk(tm.params())}
    tf, tt = rand_features(tm, batch=8, bag=5, seed=3)
    loss = tm.train_step(tf, tt)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    want = dict(_walk(jax.tree.map(np.asarray, new_params)))
    for path, t in _walk(tm.params()):
        assert id(t) == ids[path], path  # in place
        # f32 sums of the same terms in another order: a few ulps of the
        # accumulator (up to ~40) and of the weights.
        np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-6, atol=1e-7, err_msg=path)
    touched = {int(i) for i in tf["t0"][tf["t0"] >= 0]}
    acc = tm.params()["opt"]["group_64x16" if sharding == "table" else "t0"]
    acc = acc[0] if sharding == "table" else acc
    assert {int(i) for i in torch.nonzero(acc).flatten()} == touched


@pytest.mark.parametrize("sharding", SHARDINGS)
def test_train_step_decreases_loss(sharding):
    model = _model(sharding)
    feats, targets = rand_features(model, batch=8, bag=5)
    loss0 = model.train_step(feats, targets)
    for _ in range(5):
        loss = model.train_step(feats, targets)
    assert float(loss) < float(loss0)
    assert all(float(a.max()) > 0 for a in model.params()["opt"].values())


def test_reserved_group_prefix_and_duplicates_raise():
    with pytest.raises(ValueError, match="group_"):
        EmbeddingCollection([TableConfig("group_x", 4, 2)], device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        EmbeddingCollection([TableConfig("a", 4, 2), TableConfig("a", 4, 2)], device="cpu")


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EmbeddingCollection([TableConfig("a", 4, 2)])


# ----------------------------------------------------------- the sharded world


def _check_boxes(state, model, label):
    """Every local box of the DTensors in ``state`` equals the box of
    ``model``'s whole tensors (every rank holds a whole replica)."""
    from tpusnap_torch.io_preparers.sharded import local_box

    want = dict(_walk(model.params()))
    for path, t in _walk(state):
        if t.device_mesh.get_coordinate() is None:
            continue
        offsets, sizes = local_box(list(t.shape), list(t.device_mesh.shape),
                                   t.device_mesh.get_coordinate(), list(t.placements))
        box = want[path][tuple(slice(o, o + n) for o, n in zip(offsets, sizes))]
        assert torch.equal(t.to_local(), box), f"{label}: {path}"


def _dense_view(model):
    """{table: [V, D], opt/table: [V]} whatever the grouping."""
    out = {}
    for t in model.tables:
        out[t.name] = model._table_weight(t)
        out["opt/" + t.name] = model._table_acc(t)
    return out


def _zeroed(model):
    with torch.no_grad():
        for _, t in _walk(model.params()):
            t.zero_()
    return model


def _blobs(path):
    return [f for d, _, fs in os.walk(path) for f in fs
            if f != ".snapshot_metadata" and ".tpusnap" not in d.split(os.sep)]


def _case_matrix(root, mesh, src, dst, mode):
    src_model = _model(src, seed=7)
    feats, targets = rand_features(src_model, batch=8, bag=5)
    src_model.train_step(feats, targets)  # non-trivial optimizer state
    expected = src_model.apply(feats)
    path = os.path.join(root, f"m_{src}_{dst}_{mode}")
    app = {"emb": PytreeState(src_model.shard_params(mesh))}
    if mode == "async":
        Snapshot.async_take(path, app).wait()
    else:
        Snapshot.take(path, app)
    dst_model = _zeroed(_model(dst))
    if src == dst:
        target = PytreeState(dst_model.shard_params(mesh))
        Snapshot(path).restore({"emb": target})
        _check_boxes(target.tree, src_model, "restore")
        return
    # Across taxonomies: read each table dense and place it under the
    # destination's layout (tests/test_embedding.py's recipe).
    snap = Snapshot(path)
    dense = {}
    for key in src_model.param_specs()["tables"]:
        for section in ("tables", "opt"):
            value = snap.read_object(f"0/emb/{section}/{key}")
            if key.startswith("group_"):
                for i, member in enumerate(src_model._groups[key]):
                    dense[("" if section == "tables" else "opt/") + member.name] = value[i]
            else:
                dense[("" if section == "tables" else "opt/") + key] = value
    with torch.no_grad():
        for name, t in _dense_view(dst_model).items():
            t.copy_(dense[name])
    for name, t in _dense_view(src_model).items():
        assert torch.equal(_dense_view(dst_model)[name], t), name
    assert torch.equal(dst_model.apply(feats), expected)


def _case_frozen_dedup(root, mesh, host_offload):
    model = _model("row", seed=3, host_offload=host_offload)
    base, inc = os.path.join(root, f"d0_{host_offload}"), os.path.join(root, f"d1_{host_offload}")
    state = model.shard_params(mesh)
    Snapshot.take(base, {"emb": PytreeState(state)})
    Snapshot.take(inc, {"emb": PytreeState(state)}, incremental_from=base)
    assert _blobs(inc) == [], _blobs(inc)
    assert Snapshot(inc).verify().clean
    target = PytreeState(_zeroed(_model("row", host_offload=host_offload)).shard_params(mesh))
    Snapshot(inc).restore({"emb": target})
    _check_boxes(target.tree, model, "frozen")


def _case_trained_rewrite(root, mesh):
    model = _model("row", seed=3)
    base, inc = os.path.join(root, "r0"), os.path.join(root, "r1")
    Snapshot.take(base, {"emb": PytreeState(model.shard_params(mesh))})
    feats, targets = rand_features(model, batch=8, bag=5)
    model.train_step(feats, targets)
    Snapshot.take(inc, {"emb": PytreeState(model.shard_params(mesh))}, incremental_from=base)
    assert _blobs(inc), "a training step must rewrite the touched shards"
    target = PytreeState(_zeroed(_model("row")).shard_params(mesh))
    Snapshot(inc).restore({"emb": target})
    _check_boxes(target.tree, model, "trained")


def _case_subdivision(root, mesh):
    from tpusnap_torch.knobs import override_max_shard_size_bytes
    from tpusnap_torch.manifest import ShardedEntry

    model = _model("row", seed=1)
    path = os.path.join(root, "sub")
    # Each rank's box of a table is 16 x 16 f32 = 1 KiB: split to <= 256 B.
    with override_max_shard_size_bytes(256):
        Snapshot.take(path, {"emb": PytreeState(model.shard_params(mesh))})
    shards = [s for e in Snapshot(path).metadata.manifest.values()
              if isinstance(e, ShardedEntry) for s in e.shards]
    assert max(s.tensor.shape[0] * 16 * 4 for s in shards if len(s.sizes) == 2) <= 256
    target = PytreeState(_zeroed(_model("row")).shard_params(mesh))
    Snapshot(path).restore({"emb": target})
    _check_boxes(target.tree, model, "subdivided")


def _case_smaller_mesh(root, mesh, small_mesh):
    model = _model("row", seed=3)
    path = os.path.join(root, "small")
    Snapshot.take(path, {"emb": PytreeState(model.shard_params(mesh))})
    target = PytreeState(_zeroed(_model("row")).shard_params(small_mesh))
    Snapshot(path).restore({"emb": target})
    _check_boxes(target.tree, model, "smaller mesh")


def _cases(root, mesh, small_mesh):
    for src, dst, mode in _MATRIX:
        yield f"matrix-{src}-{dst}-{mode}", lambda a=(src, dst, mode): _case_matrix(root, mesh, *a)
    yield "frozen-device", lambda: _case_frozen_dedup(root, mesh, False)
    yield "frozen-offloaded", lambda: _case_frozen_dedup(root, mesh, True)
    yield "trained-rewrite", lambda: _case_trained_rewrite(root, mesh)
    yield "subdivision", lambda: _case_subdivision(root, mesh)
    yield "smaller-mesh", lambda: _case_smaller_mesh(root, mesh, small_mesh)


def _world(root, out_path):
    """Every case on every rank; the ranks agree on each outcome."""
    import torch.distributed as dist

    from torch.distributed.device_mesh import DeviceMesh

    from tpusnap_torch.models import make_mesh
    from tpusnap_torch.models.layout import MESH_AXES

    mesh = make_mesh("cpu", (1, 2, 2))
    # Ranks 0 and 1 only: ranks 2 and 3 are outside it and hold nothing.
    small_mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2, 1), mesh_dim_names=MESH_AXES)
    outcomes = {}
    for name, case in _cases(root, mesh, small_mesh):
        outcome = "ok"
        try:
            case()
        except BaseException as e:  # reported by the test of the case
            outcome = f"{type(e).__name__}: {e}\n{traceback.format_exc()[-1500:]}"
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, outcome)
        outcomes[name] = gathered
    if dist.get_rank() == 0:
        with open(out_path, "w") as f:
            json.dump(outcomes, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from tpusnap_torch.test_utils import run_subprocess_world

    root = tmp_path_factory.mktemp("embedding_world")
    out = str(root / "outcomes.json")
    run_subprocess_world(_world, world_size=4, args=[str(root), out], timeout=300)
    with open(out) as f:
        return json.load(f)


def _case_ok(world, name):
    got = world.get(name)
    assert got == ["ok"] * 4, "\n".join(o for o in got or ["not run"] if o != "ok")


@pytest.mark.parametrize("src,dst,mode", _MATRIX)
def test_src_dst(world, src, dst, mode):
    _case_ok(world, f"matrix-{src}-{dst}-{mode}")


@pytest.mark.parametrize("host_offload", ["device", "offloaded"])
def test_frozen_tables_dedup(world, host_offload):
    _case_ok(world, f"frozen-{host_offload}")


def test_trained_tables_rewrite(world):
    _case_ok(world, "trained-rewrite")


def test_shard_subdivision(world):
    _case_ok(world, "subdivision")


def test_restore_into_smaller_mesh(world):
    _case_ok(world, "smaller-mesh")


def test_make_embedding_train_step_is_the_in_place_step():
    from tpusnap_torch.models import make_embedding_train_step

    a, b = _model("table", seed=4), _model("table", seed=4)
    feats, targets = rand_features(a, batch=8, bag=5)
    step = make_embedding_train_step(a, learning_rate=0.05)
    assert torch.equal(step(feats, targets), b.train_step(feats, targets, learning_rate=0.05))
    for (path, x), (_, y) in zip(_walk(a.params()), _walk(b.params())):
        assert torch.equal(x, y), path
