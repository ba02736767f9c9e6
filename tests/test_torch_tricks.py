"""The DCP-shaped drop-in (tpusnap_torch/tricks/dcp.py), held to
tests/test_aux.py's orbax cases and test_orbax_trick_incremental, and
across the packages with tolerance 0: a directory written by
tpusnap.tricks.orbax.PyTreeCheckpointer restores through the port with
and without a target, and one written by the port through the JAX class.
The module functions ``save``/``load`` round trip in place, keeping each
tensor's identity, as ``torch.distributed.checkpoint.load`` does."""

import numpy as np
import pytest
import torch

import tpusnap_torch.tricks.dcp as dcp
from tpusnap.tricks.orbax import PyTreeCheckpointer as JaxCheckpointer
from tpusnap_torch import verify_snapshot
from tpusnap_torch.tricks.dcp import PyTreeCheckpointer


@pytest.fixture(autouse=True)
def _telemetry_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _equal_bits(a, b) -> bool:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


class TestDcpTrick:
    def test_save_restore_with_target(self, tmp_path):
        ckpt = PyTreeCheckpointer()
        tree = {"w": torch.arange(16.0), "nested": {"b": torch.ones((4, 4)), "n": 3}}
        ckpt.save(tmp_path / "ck", tree)
        target = {"w": torch.zeros(16), "nested": {"b": torch.zeros((4, 4)), "n": 0}}
        w = target["w"]
        out = ckpt.restore(tmp_path / "ck", target)
        assert out["w"] is w  # restored in place
        assert out["nested"]["n"] == 3
        assert torch.equal(out["w"], tree["w"]) and torch.equal(out["nested"]["b"], tree["nested"]["b"])

    def test_restore_without_target_rebuilds_structure(self, tmp_path):
        ckpt = PyTreeCheckpointer()
        tree = {"a": torch.ones(3), "nested": {"b": 7}}
        ckpt.save(tmp_path / "ck", tree)
        out = ckpt.restore(tmp_path / "ck")
        assert set(out) == {"a", "nested"}
        assert out["nested"]["b"] == 7
        assert torch.equal(out["a"], torch.ones(3)) and out["a"].device.type == "cpu"

    def test_restore_without_target_of_a_bare_leaf(self, tmp_path):
        ckpt = PyTreeCheckpointer()
        ckpt.save(tmp_path / "ck", torch.arange(5, dtype=torch.int32))
        assert torch.equal(ckpt.restore(tmp_path / "ck"), torch.arange(5, dtype=torch.int32))

    def test_force_overwrites(self, tmp_path):
        ckpt = PyTreeCheckpointer()
        ckpt.save(tmp_path / "ck", {"a": torch.ones(3)})
        ckpt.save(tmp_path / "ck", {"a": torch.zeros(3)}, force=True)
        out = ckpt.restore(tmp_path / "ck", {"a": torch.ones(3)})
        assert torch.equal(out["a"], torch.zeros(3))

    def test_async_save(self, tmp_path):
        ckpt = PyTreeCheckpointer()
        pending = ckpt.async_save(tmp_path / "ck", {"a": torch.arange(8.0)})
        snapshot = pending.wait()
        out = ckpt.restore(snapshot.path, {"a": torch.zeros(8)})
        assert torch.equal(out["a"], torch.arange(8.0))


def test_dcp_trick_incremental(tmp_path):
    ckpt = PyTreeCheckpointer()
    tree = {"w": torch.arange(4096, dtype=torch.float32), "step": 1}
    base, inc = tmp_path / "c0", tmp_path / "c1"
    ckpt.save(base, tree)
    ckpt.save(inc, tree, incremental_from=base)
    restored = ckpt.restore(inc)
    assert torch.equal(restored["w"], tree["w"]) and restored["step"] == 1
    assert verify_snapshot(str(inc)).clean
    pending = ckpt.async_save(tmp_path / "c2", tree, incremental_from=inc)
    pending.wait()
    assert verify_snapshot(str(tmp_path / "c2")).clean


def _numpy_tree():
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((8, 16)).astype(np.float32),
        "nested": {
            "ids": rng.integers(-(2**31), 2**31 - 1, 64, dtype=np.int32),
            "scale": rng.standard_normal(5).astype(np.float32),
            "n": 3,
        },
        "bias": rng.standard_normal(16).astype(np.float32),
    }


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree.copy()) if isinstance(tree, np.ndarray) else tree


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree) if isinstance(tree, torch.Tensor) else 0


@pytest.mark.parametrize("with_target", [True, False], ids=["target", "no_target"])
def test_jax_checkpointer_dir_restores_through_the_port(tmp_path, with_target):
    want = _numpy_tree()
    JaxCheckpointer().save(tmp_path / "ck", want)
    target = _zeros_like(_as_torch(want)) if with_target else None
    got = PyTreeCheckpointer().restore(tmp_path / "ck", target)
    assert [p for p, _ in _leaves(got)] == [p for p, _ in _leaves(want)]
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        if isinstance(b, np.ndarray):
            assert isinstance(a, torch.Tensor) and _equal_bits(a, b), path
        else:
            assert a == b, path


@pytest.mark.parametrize("with_target", [True, False], ids=["target", "no_target"])
def test_port_checkpointer_dir_restores_through_jax(tmp_path, with_target):
    src = _numpy_tree()
    PyTreeCheckpointer().save(tmp_path / "ck", _as_torch(src))
    target = None
    if with_target:
        target = {
            "w": np.zeros_like(src["w"]), "bias": np.zeros_like(src["bias"]),
            "nested": {k: (np.zeros_like(v) if isinstance(v, np.ndarray) else 0)
                       for k, v in src["nested"].items()},
        }
    got = JaxCheckpointer().restore(tmp_path / "ck", target)
    assert [p for p, _ in _leaves(got)] == [p for p, _ in _leaves(src)]
    for (path, a), (_, b) in zip(_leaves(got), _leaves(src)):
        if isinstance(b, np.ndarray):
            assert _equal_bits(a, b), path
        else:
            assert a == b, path


def test_dcp_shaped_save_and_load_round_trip_in_place(tmp_path):
    state = _as_torch(_numpy_tree())
    state["layers"] = [torch.arange(6.0), {"k": torch.ones(2, dtype=torch.int32)}]
    dcp.save(state, checkpoint_id=tmp_path / "ck")
    target = _zeros_like({k: v for k, v in state.items() if k != "layers"})
    target["layers"] = [torch.zeros(6), {"k": torch.zeros(2, dtype=torch.int32)}]
    before = {p: t for p, t in _leaves(target) if isinstance(t, torch.Tensor)}
    before_list = (target["layers"][0], target["layers"][1]["k"])
    assert dcp.load(target, checkpoint_id=tmp_path / "ck") is None
    for path, t in _leaves(target):
        if path in before:
            assert t is before[path], path  # the same tensor, filled in place
    assert target["layers"][0] is before_list[0] and target["layers"][1]["k"] is before_list[1]
    assert target["nested"]["n"] == 3
    for (path, a), (_, b) in zip(_leaves(target), _leaves(state)):
        if isinstance(b, torch.Tensor):
            assert _equal_bits(a, b), path
    assert torch.equal(target["layers"][0], state["layers"][0])
    assert torch.equal(target["layers"][1]["k"], state["layers"][1]["k"])


def test_dcp_shaped_async_save_has_the_future_surface(tmp_path):
    state = {"w": torch.arange(32.0), "step": 7}
    fut = dcp.async_save(state, checkpoint_id=tmp_path / "ck")
    snapshot = fut.result()
    assert fut.done() and snapshot.path == str(tmp_path / "ck")
    target = {"w": torch.zeros(32), "step": 0}
    dcp.load(target, checkpoint_id=tmp_path / "ck")
    assert torch.equal(target["w"], state["w"]) and target["step"] == 7


def test_orbax_import_path_is_the_same_checkpointer():
    """Code written against ``tpusnap.tricks.orbax`` moves by changing the
    package name."""
    from tpusnap_torch.tricks.orbax import PyTreeCheckpointer as FromOrbaxPath

    assert FromOrbaxPath is PyTreeCheckpointer
