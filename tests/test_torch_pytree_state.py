"""tpusnap_torch.PytreeState against tpusnap.PytreeState.

The same trees (numpy values from a seed) go through both packages'
``PytreeState``: nested dicts with int-like keys, lists, tuples, a
NamedTuple, ``None`` leaves and a bare leaf give identical state-dict
paths and values; a key collision raises in both; and a snapshot taken
through either package's ``PytreeState`` restores bit for bit through
the other, keeping the target's tree structure (NamedTuples included).
"""

from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusnap import PytreeState as JaxPytreeState
from tpusnap import Snapshot as JaxSnapshot
from tpusnap.flatten import flatten as jax_flatten
from tpusnap_torch import PytreeState, Snapshot
from tpusnap_torch.flatten import flatten

Moments = namedtuple("Moments", ["mu", "nu", "count"])


def _values(seed=0):
    rng = np.random.default_rng(seed)
    return lambda *shape: rng.standard_normal(shape).astype(np.float32)


def _tree(kind, seed=0):
    v = _values(seed)
    if kind == "int_like_keys":
        return {"layer": {"0": v(3), "1": v(2, 2)}, "idx": {0: v(4), 1: v(1), 10: v(2)}}
    if kind == "lists_tuples":
        return {"a": [v(2), (v(3), [v(1)])], "t": (v(2, 3),)}
    if kind == "namedtuple":
        return {"opt": Moments(mu=v(4), nu=v(4), count=np.int32(seed + 3) * np.ones((), np.int32))}
    if kind == "none_leaves":
        return {"a": None, "b": [v(2), None], "c": Moments(v(1), None, v(2)), "d": {"e": None}}
    if kind == "bare_leaf":
        return v(5)
    raise ValueError(kind)


_KINDS = ["int_like_keys", "lists_tuples", "namedtuple", "none_leaves", "bare_leaf"]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, x) for k, x in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    return None if tree is None else fn(tree)


def _torch_tree(tree):
    return _map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax_tree(tree):
    return _map(jnp.asarray, tree)


@pytest.mark.parametrize("kind", _KINDS)
def test_state_dict_paths_match_tpusnap(kind):
    tree = _tree(kind)
    _, want = jax_flatten(JaxPytreeState(_jax_tree(tree)).state_dict(), prefix="s")
    _, got = flatten(PytreeState(_torch_tree(tree)).state_dict(), prefix="s")
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[path]), err_msg=path)


def test_none_gives_no_entry():
    assert PytreeState(None).state_dict() == JaxPytreeState(None).state_dict() == {}
    assert PytreeState({"a": None}).state_dict() == {}


def test_key_collision_raises_in_both():
    tree = {1: np.zeros(1, np.float32), "1": np.ones(1, np.float32)}
    with pytest.raises(ValueError):
        JaxPytreeState(_jax_tree(tree)).state_dict()
    with pytest.raises(ValueError, match="collide"):
        PytreeState(_torch_tree(tree)).state_dict()


def test_load_state_dict_keeps_structure():
    tree = _torch_tree(_tree("none_leaves"))
    state = PytreeState(tree)
    state.load_state_dict(state.state_dict())
    assert type(state.tree["c"]) is Moments
    assert state.tree["a"] is None and state.tree["b"][1] is None and state.tree["c"].nu is None
    assert state.tree["b"][0] is tree["b"][0]
    with pytest.raises(KeyError, match="missing"):
        state.load_state_dict({})


def _assert_same_bits(got, want):
    leaves_got = [leaf for _, leaf in sorted(flatten(PytreeState(got).state_dict())[1].items())]
    _, want_flat = jax_flatten(JaxPytreeState(want).state_dict())
    leaves_want = [leaf for _, leaf in sorted(want_flat.items())]
    assert len(leaves_got) == len(leaves_want)
    for a, b in zip(leaves_got, leaves_want):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("kind", _KINDS)
def test_tpusnap_snapshot_restores_through_port(tmp_path, kind):
    src = _tree(kind, seed=1)
    JaxSnapshot.take(str(tmp_path / "s"), {"m": JaxPytreeState(_jax_tree(src))})
    target = PytreeState(_torch_tree(_map(np.zeros_like, _tree(kind, seed=2))))
    before = [id(t) for t in flatten(target.state_dict())[1].values()]
    Snapshot(str(tmp_path / "s")).restore({"m": target})
    _assert_same_bits(target.tree, src)
    assert [id(t) for t in flatten(target.state_dict())[1].values()] == before  # in place
    if kind == "namedtuple":
        assert type(target.tree["opt"]) is Moments


@pytest.mark.parametrize("kind", _KINDS)
def test_port_snapshot_restores_through_tpusnap(tmp_path, kind):
    src = _tree(kind, seed=1)
    Snapshot.take(str(tmp_path / "s"), {"m": PytreeState(_torch_tree(src))})
    target = JaxPytreeState(_jax_tree(_map(np.zeros_like, _tree(kind, seed=2))))
    JaxSnapshot(str(tmp_path / "s")).restore({"m": target})
    got = _map(np.asarray, target.tree)
    _assert_same_bits(_torch_tree(got), src)
    if kind == "namedtuple":
        assert type(target.tree["opt"]) is Moments
