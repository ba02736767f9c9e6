"""The public helpers tpusnap has and the port ported last, each against
tpusnap's counterpart on the same inputs:

- ``knobs.override_direct_io_disabled``, ``override_delta_cadence_s`` and
  ``override_tier_drain`` set and restore the same env var to the same
  value as tpusnap's, and the getters of both packages read it;
- ``serialization.per_element_sizes``;
- ``io_types.read_io_bytes`` and ``total_write_bytes``;
- ``test_utils.rand_array`` (the same numpy draw as tpusnap's for every
  dtype string and seed) and ``check_state_dict_eq`` (tpusnap's nesting
  rules, dtypes compared, bytes by ``torch.equal``).
"""

import io
import os

import numpy as np
import pytest
import torch

from tpusnap import knobs as jax_knobs
from tpusnap import test_utils as jax_test_utils
from tpusnap.io_types import ReadIO as JaxReadIO
from tpusnap.io_types import WriteIO as JaxWriteIO
from tpusnap.io_types import read_io_bytes as jax_read_io_bytes
from tpusnap.io_types import total_write_bytes as jax_total_write_bytes
from tpusnap.serialization import per_element_sizes as jax_per_element_sizes
from tpusnap_torch import knobs
from tpusnap_torch.io_types import ReadIO, WriteIO, read_io_bytes, total_write_bytes
from tpusnap_torch.memoryview_stream import MemoryviewStream
from tpusnap_torch.serialization import SUPPORTED_DTYPES, per_element_sizes
from tpusnap_torch.test_utils import check_state_dict_eq, rand_array

_OVERRIDES = [
    # (override name, its argument, the env var, the getter of both packages, what it reads)
    ("override_direct_io_disabled", True, "TPUSNAP_DISABLE_DIRECT_IO", "is_direct_io_disabled", True),
    ("override_direct_io_disabled", False, "TPUSNAP_DISABLE_DIRECT_IO", "is_direct_io_disabled", False),
    ("override_delta_cadence_s", 0.75, "TPUSNAP_DELTA_CADENCE_S", "get_delta_cadence_s", 0.75),
    ("override_tier_drain", False, "TPUSNAP_TIER_DRAIN", "is_tier_drain_enabled", False),
    ("override_tier_drain", True, "TPUSNAP_TIER_DRAIN", "is_tier_drain_enabled", True),
]


@pytest.mark.parametrize("name,arg,env,getter,want", _OVERRIDES,
                         ids=[f"{o[0]}-{o[1]}" for o in _OVERRIDES])
@pytest.mark.parametrize("prior", [None, "sentinel"], ids=["unset", "set"])
def test_override_sets_and_restores_like_tpusnap(monkeypatch, name, arg, env, getter, want, prior):
    if prior is None:
        monkeypatch.delenv(env, raising=False)
    else:
        monkeypatch.setenv(env, prior)
    seen = {}
    for pkg, mod in (("tpusnap", jax_knobs), ("port", knobs)):
        with getattr(mod, name)(arg):
            seen[pkg] = os.environ.get(env)
            # One env var drives both packages.
            assert getattr(knobs, getter)() == want
            assert getattr(jax_knobs, getter)() == want
        assert os.environ.get(env) == prior
    assert seen["port"] == seen["tpusnap"]


def test_per_element_sizes_match_tpusnap():
    assert per_element_sizes() == jax_per_element_sizes()
    assert per_element_sizes() == tuple(SUPPORTED_DTYPES)


def test_read_io_bytes_matches_tpusnap():
    data = np.random.default_rng(0).integers(0, 256, 1000, dtype=np.uint8).tobytes()
    ours, theirs = ReadIO(path="p"), JaxReadIO(path="p")
    ours.buf, theirs.buf = io.BytesIO(data), io.BytesIO(data)
    assert bytes(read_io_bytes(ours)) == bytes(jax_read_io_bytes(theirs)) == data
    # An in-place read's stream reads the same way.
    ours.buf = MemoryviewStream(memoryview(data)[10:20])
    assert bytes(read_io_bytes(ours)) == data[10:20]


def test_total_write_bytes_matches_tpusnap():
    rng = np.random.default_rng(1)
    bufs = [b"", b"abc", bytearray(rng.integers(0, 256, 777, dtype=np.uint8).tobytes()),
            memoryview(rng.integers(0, 256, 4096, dtype=np.uint8).tobytes())]
    ours = [WriteIO(path=f"p{i}", buf=b) for i, b in enumerate(bufs)]
    theirs = [JaxWriteIO(path=f"p{i}", buf=b) for i, b in enumerate(bufs)]
    assert total_write_bytes(ours) == jax_total_write_bytes(theirs) == 3 + 777 + 4096
    assert total_write_bytes([]) == 0
    # A typed view counts its bytes.
    assert total_write_bytes([WriteIO(path="f", buf=memoryview(bytes(16)).cast("f"))]) == 16


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dtype_str", sorted(SUPPORTED_DTYPES))
def test_rand_array_matches_tpusnap(dtype_str, seed):
    theirs = jax_test_utils.rand_array(dtype_str, shape=(16, 9), seed=seed)
    ours = rand_array(dtype_str, shape=(16, 9), seed=seed)
    assert isinstance(ours, torch.Tensor) and ours.device.type == "cpu"
    assert ours.dtype == SUPPORTED_DTYPES[dtype_str]
    assert tuple(ours.shape) == theirs.shape == (16, 9)
    assert ours.contiguous().view(torch.uint8).numpy().tobytes() == theirs.tobytes()


def test_check_state_dict_eq_nesting_like_tpusnap():
    """The same verdicts as tpusnap's on the same nested state (tensors
    on the port's side, numpy arrays on tpusnap's)."""
    a32 = rand_array("float32", seed=1)
    b32 = rand_array("float32", seed=2)
    i8 = rand_array("int8", seed=1)

    def cases(t):
        """(left, right) pairs; ``t`` turns a tensor into the package's array."""
        return [
            ({"w": t(a32), "n": {"x": [1, 2.5, "s"], "y": None}},
             {"n": {"y": None, "x": [1, 2.5, "s"]}, "w": t(a32.clone())}),
            ({"w": t(a32)}, {"w": t(b32)}),                    # values differ
            ({"w": t(a32)}, {"w": t(a32.to(torch.float64))}),  # dtype differs
            ({"w": t(a32)}, {"w": t(a32.reshape(9, 16))}),     # shape differs
            ({"w": t(i8)}, {"w": t(i8)}),
            ({"w": [1, 2]}, {"w": (1, 2)}),                    # list vs tuple
            ({"w": [1, 2]}, {"w": [1, 2, 3]}),
            ({"w": None}, {"w": 0}),
            ({"a": 1}, {"b": 1}),                              # keys differ
            ({"a": 1.0}, {"a": 1.0}),
            ({"a": 1.0}, {"a": 2.0}),
            ({"w": t(a32)}, {"w": 3}),                         # array vs scalar
        ]

    ours = [check_state_dict_eq(x, y) for x, y in cases(lambda v: v)]
    theirs = [jax_test_utils.check_state_dict_eq(x, y) for x, y in cases(lambda v: v.numpy())]
    assert ours == theirs
    assert ours[:2] == [True, False] and ours[4] is True


def test_check_state_dict_eq_compares_bits():
    """A NaN equals the same NaN (bytes, as tpusnap compares), and -0.0
    differs from 0.0."""
    nan = torch.tensor([float("nan"), 1.0])
    assert check_state_dict_eq({"w": nan}, {"w": nan.clone()})
    assert not check_state_dict_eq({"w": torch.tensor([0.0])}, {"w": torch.tensor([-0.0])})
    bf = rand_array("bfloat16")
    assert check_state_dict_eq([bf], [bf.clone()])
    assert not check_state_dict_eq([bf], [bf.float()])
