"""tpusnap_torch.flatten against tpusnap.flatten: the mirror of
tests/test_flatten.py for the port, with every flatten also held to
tpusnap's on the same object (the same container manifest and the same
logical paths), since both packages must name a snapshot's entries
alike."""

from collections import OrderedDict

import numpy as np
import pytest

from tpusnap.flatten import flatten as jax_flatten
from tpusnap_torch.flatten import flatten, inflate
from tpusnap_torch.manifest import DictEntry, ListEntry, TupleEntry


def _entries(manifest):
    return {p: (type(e).__name__, vars(e)) for p, e in manifest.items()}


def _same_as_tpusnap(obj, prefix):
    manifest, flattened = flatten(obj, prefix=prefix)
    want_manifest, want_flattened = jax_flatten(obj, prefix=prefix)
    assert _entries(manifest) == _entries(want_manifest)
    assert list(flattened) == list(want_flattened)
    return manifest, flattened


def _roundtrip(obj, prefix="root"):
    manifest, flattened = _same_as_tpusnap(obj, prefix)
    return inflate(manifest, flattened, prefix=prefix)


def test_simple_dict():
    obj = {"a": 1, "b": {"c": 2, "d": [3, 4, {"e": 5}]}}
    assert _roundtrip(obj) == obj


def test_hostile_keys():
    obj = {
        "with/slash": 1,
        "with%percent": 2,
        "with/both%25": 3,
        "": 4,
        "ünïcödé/äöü": 5,
    }
    assert _roundtrip(obj) == obj


def test_int_keys_preserved():
    obj = {0: "zero", 1: {"nested": 2}, "s": 3}
    out = _roundtrip(obj)
    assert out == obj
    assert set(map(type, out.keys())) == {int, str}


def test_colliding_keys_not_flattened():
    obj = {"outer": {1: "int-one", "1": "str-one"}}
    _, flattened = _same_as_tpusnap(obj, "p")
    assert flattened["p/outer"] == {1: "int-one", "1": "str-one"}
    assert _roundtrip(obj) == obj


def test_non_str_int_keys_not_flattened():
    obj = {"outer": {(1, 2): "tuple-key"}}
    _, flattened = _same_as_tpusnap(obj, "p")
    assert flattened["p/outer"] == {(1, 2): "tuple-key"}
    assert _roundtrip(obj) == obj


def test_ordered_dict_preserved():
    od = OrderedDict([("z", 1), ("a", 2), ("m", [1, 2])])
    out = _roundtrip(od)
    assert isinstance(out, OrderedDict)
    assert list(out.keys()) == ["z", "a", "m"]
    assert out == od


def test_tuple_and_namedtuple():
    obj = {"opt": (1, (2, 3), [4, (5,)])}
    out = _roundtrip(obj)
    assert out == obj
    assert isinstance(out["opt"], tuple)
    assert isinstance(out["opt"][1], tuple)
    assert isinstance(out["opt"][2][1], tuple)


def test_list_ordering_beyond_ten():
    obj = {"l": list(range(15))}
    assert _roundtrip(obj)["l"] == list(range(15))


def test_leaves_are_not_copied():
    arr = np.arange(10)
    _, flattened = _same_as_tpusnap({"x": arr}, "r")
    assert flattened["r/x"] is arr


def test_manifest_entries():
    obj = {"d": {"l": [1], "t": (2,)}}
    manifest, flattened = _same_as_tpusnap(obj, "r")
    assert isinstance(manifest["r"], DictEntry)
    assert isinstance(manifest["r/d"], DictEntry)
    assert isinstance(manifest["r/d/l"], ListEntry)
    assert isinstance(manifest["r/d/t"], TupleEntry)
    assert flattened == {"r/d/l/0": 1, "r/d/t/0": 2}


def test_root_leaf():
    manifest, flattened = _same_as_tpusnap(42, "r")
    assert manifest == {}
    assert flattened == {"r": 42}
    assert inflate(manifest, flattened, prefix="r") == 42


def test_empty_containers():
    obj = {"e": {}, "l": [], "t": ()}
    out = _roundtrip(obj)
    assert out == obj
    assert isinstance(out["t"], tuple)


def test_inflate_drops_missing_leaves():
    manifest, flattened = flatten({"a": 1, "b": 2}, prefix="r")
    del flattened["r/b"]
    assert inflate(manifest, flattened, prefix="r") == {"a": 1}


def test_bad_prefix_raises():
    manifest, flattened = flatten({"a": 1}, prefix="r")
    with pytest.raises(ValueError):
        inflate(manifest, flattened, prefix="nope")


def test_missing_leaf_with_tuple_in_list_compacts():
    m, f = flatten({"l": [1, 2, (3,)]}, prefix="r")
    del f["r/l/0"]
    assert inflate(m, f, prefix="r") == {"l": [2, (3,)]}
    m, f = flatten({"l": [1, (2,), 3]}, prefix="r")
    del f["r/l/0"]
    assert inflate(m, f, prefix="r") == {"l": [(2,), 3]}


def test_inflate_drops_keys_absent_from_container_entry():
    m = {"r": DictEntry(keys=["a"])}
    f = {"r/a": 1, "r/b": 2}
    assert inflate(m, f, prefix="r") == {"a": 1}
