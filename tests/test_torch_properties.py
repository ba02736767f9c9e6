"""Property-based tests (hypothesis) of the port's pure data-model
layers: the mirror of the seven properties of ``tests/test_properties.py``
for ``tpusnap_torch``, with the same settings, plus two cross-package
properties: a generated state flattens to the same keys in both
packages, and a manifest entry serialized by either package reads back
equal in the other.
"""

import os
import shutil
import struct
import tempfile

import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis", reason="property tests need the hypothesis package")
from hypothesis import given, settings, strategies as st  # noqa: E402

from tpusnap_torch.flatten import flatten, inflate  # noqa: E402
from tpusnap_torch.manifest import (  # noqa: E402
    PrimitiveEntry,
    SnapshotMetadata,
    TensorEntry,
    _entry_to_dict,
    entry_from_dict,
    is_container_entry,
)

SETTINGS = settings(max_examples=80, deadline=None)

# Keys exercise the %/ escaping and the str/int dichotomy; values cover
# every primitive class plus nesting.
_keys = st.one_of(
    st.text(alphabet=st.sampled_from("ab%/_.0 é"), min_size=1, max_size=8),
    st.integers(min_value=0, max_value=99),
)
_primitives = st.one_of(
    st.integers(min_value=-(2**62), max_value=2**62),
    st.floats(allow_nan=False),  # NaN breaks dict equality only
    st.booleans(),
    st.text(max_size=12),
    st.binary(max_size=12),
)


def _unique_str_int_keys(d: dict) -> bool:
    # flatten refuses colliding str(int_key) == str_key pairs.
    return len({str(k) for k in d}) == len(d)


_state = st.recursive(
    _primitives,
    lambda children: st.one_of(
        st.lists(children, max_size=4),
        st.dictionaries(_keys, children, max_size=4).filter(_unique_str_int_keys),
        st.tuples(children, children),
    ),
    max_leaves=12,
)
_top = st.dictionaries(_keys, _state, min_size=1, max_size=4).filter(_unique_str_int_keys)


def _norm(obj):
    """Tuples inflate as tuples, lists as lists; int dict keys normalize
    as flatten addresses them (1 and "1" are the same child)."""
    if isinstance(obj, dict):
        return {str(k): _norm(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_norm(v) for v in obj)
    return obj


@SETTINGS
@given(_top)
def test_flatten_inflate_roundtrip(state):
    manifest, flattened = flatten(state, prefix="app")
    rebuilt = inflate(
        {p: e for p, e in manifest.items() if is_container_entry(e)}, flattened, prefix="app"
    )
    assert _norm(rebuilt) == _norm(state)


@SETTINGS
@given(_top)
def test_flatten_keys_match_tpusnap(state):
    from tpusnap.flatten import flatten as ref_flatten

    manifest, flattened = flatten(state, prefix="app")
    ref_manifest, ref_flattened = ref_flatten(state, prefix="app")
    assert list(manifest) == list(ref_manifest)
    assert list(flattened) == list(ref_flattened)


@SETTINGS
@given(st.floats())  # nan, inf, -0.0 and subnormals included
def test_primitive_float_bit_exact(x):
    back = entry_from_dict(_entry_to_dict(PrimitiveEntry.from_object(x))).get_value()
    assert isinstance(back, float)
    assert struct.pack("<d", back) == struct.pack("<d", x)


@SETTINGS
@given(
    st.integers(min_value=-(2**62), max_value=2**62)
    | st.booleans()
    | st.text(max_size=20)
    | st.binary(max_size=20)
)
def test_primitive_roundtrip(x):
    back = entry_from_dict(_entry_to_dict(PrimitiveEntry.from_object(x))).get_value()
    assert type(back) is type(x) and back == x


_names = st.text(
    alphabet=st.characters(blacklist_categories=("Cs",), min_codepoint=32), min_size=1, max_size=16
)
_tensor_specs = st.lists(
    st.tuples(
        _names,
        st.sampled_from(["float32", "bfloat16", "int8", "uint16"]),
        st.lists(st.integers(0, 7), max_size=3),
    ),
    min_size=1,
    max_size=5,
    unique_by=lambda t: t[0],
)


@SETTINGS
@given(_tensor_specs)
def test_metadata_yaml_roundtrip(specs):
    manifest = {
        f"0/{name}": TensorEntry(
            location=f"0/{name}", serializer="buffer_protocol", dtype=dtype, shape=shape,
            replicated=False, checksum="crc32c:00000000",
        )
        for name, dtype, shape in specs
    }
    md = SnapshotMetadata(version="0.1.0", world_size=1, manifest=manifest)
    assert SnapshotMetadata.from_yaml(md.to_yaml()).to_dict() == md.to_dict()


_entries = st.one_of(
    st.builds(
        lambda loc, dtype, shape, rep, rng, crc: TensorEntry(
            location=loc, serializer="buffer_protocol", dtype=dtype, shape=shape,
            replicated=rep, byte_range=rng, checksum=f"crc32c:{crc:08x}",
        ),
        _names,
        st.sampled_from(["float32", "bfloat16", "int8", "uint16", "bool", "complex64"]),
        st.lists(st.integers(0, 7), max_size=3),
        st.booleans(),
        st.none() | st.tuples(st.integers(0, 99), st.integers(100, 999)).map(list),
        st.integers(0, 2**32 - 1),
    ),
    st.floats().map(PrimitiveEntry.from_object),  # nan included
    (st.integers(min_value=-(2**62), max_value=2**62) | st.booleans() | st.text(max_size=20)
     | st.binary(max_size=20)).map(PrimitiveEntry.from_object),
)


@SETTINGS
@given(_entries, st.booleans())
def test_entry_dict_reads_across_packages(entry, port_writes):
    """An entry serialized by one package's ``_entry_to_dict`` is read
    back by the other's ``entry_from_dict`` into the same dict form."""
    from tpusnap import manifest as ref

    d = _entry_to_dict(entry)
    if port_writes:
        back = ref._entry_to_dict(ref.entry_from_dict(d))
    else:
        back = _entry_to_dict(entry_from_dict(ref._entry_to_dict(ref.entry_from_dict(d))))
    assert back == d


@SETTINGS
@given(st.binary(max_size=4096), st.binary(max_size=4096))
def test_crc_combine_identity(a, b):
    from tpusnap_torch import _native

    assert _native.crc_combine(_native.crc32c(a), _native.crc32c(b), len(b)) == _native.crc32c(a + b)


@SETTINGS
@given(st.binary(min_size=0, max_size=2048), st.integers(min_value=1, max_value=512))
def test_memcpy_crc_tiles_matches_direct(data, tile):
    from tpusnap_torch import _native

    src = np.frombuffer(data, dtype=np.uint8).copy()
    dst = np.zeros_like(src)
    crcs = _native.memcpy_crc_tiles(dst, src, tile)
    assert bytes(dst) == data
    n = len(data)
    t = min(tile, n) if n else tile
    if n:
        assert crcs == [_native.crc32c(data[i : min(i + t, n)]) for i in range(0, n, t)]
        # Folding the tiles reproduces the whole-buffer value.
        combined = crcs[0]
        for i, c in enumerate(crcs[1:], 1):
            combined = _native.crc_combine(combined, c, min((i + 1) * t, n) - i * t)
        assert combined == _native.crc32c(data)


@settings(max_examples=12, deadline=None)
@given(
    n_leaves=st.integers(min_value=2, max_value=5),
    mutate_mask=st.lists(st.booleans(), min_size=5, max_size=5),
    seed=st.integers(min_value=0, max_value=2**31),
)
def test_incremental_writes_exactly_the_changed_leaves(n_leaves, mutate_mask, seed):
    """An incremental take writes exactly the blobs whose content changed:
    no over-writing (dedup missed), no under-writing (stale data
    referenced)."""
    from tpusnap_torch import Snapshot, StateDict, verify_snapshot
    from tpusnap_torch.knobs import override_batching_disabled

    rng = np.random.default_rng(seed)
    state = {
        f"p{i}": torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
        for i in range(n_leaves)
    }
    changed = {f"p{i}" for i in range(n_leaves) if mutate_mask[i % len(mutate_mask)]}
    root = tempfile.mkdtemp(prefix="tpusnap_torch_prop_inc_")
    saved = os.environ.get("TPUSNAP_TELEMETRY_DIR")
    os.environ["TPUSNAP_TELEMETRY_DIR"] = root + "/telemetry"
    try:
        with override_batching_disabled(True):
            Snapshot.take(root + "/base", {"a": StateDict(**state)})
            state2 = {k: (v + 1.0 if k in changed else v.clone()) for k, v in state.items()}
            Snapshot.take(root + "/inc", {"a": StateDict(**state2)}, incremental_from=root + "/base")
        written = {
            os.path.relpath(os.path.join(d, f), root + "/inc")
            for d, _, fs in os.walk(root + "/inc")
            for f in fs
            if f != ".snapshot_metadata" and ".tpusnap" not in d.split(os.sep)
        }
        assert written == {f"0/a/{k}" for k in sorted(changed)}
        assert verify_snapshot(root + "/inc").clean
        target = {"a": StateDict(**{k: torch.zeros_like(v) for k, v in state2.items()})}
        Snapshot(root + "/inc").restore(target)
        for k, v in state2.items():
            assert torch.equal(target["a"][k], v), k
    finally:
        if saved is None:
            os.environ.pop("TPUSNAP_TELEMETRY_DIR", None)
        else:
            os.environ["TPUSNAP_TELEMETRY_DIR"] = saved
        shutil.rmtree(root, ignore_errors=True)
