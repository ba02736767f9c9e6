"""Hugepage advice on the host buffers tpusnap_torch allocates itself.

The mirror of tests/test_aux.py's ``TestAdviseHugepages`` (bf16 given as
a torch tensor), the advice's rules held against tpusnap's
``advise_hugepages`` on the same buffers, and each allocation site driven
through its real path: a slab take, a restore and a ``read_object`` with
no target (read scratch, then the owning copy), a budgeted
``read_object`` (the tiled destination), a compressed, a chunked and a
sharded read. Each destination's mapping must carry ``hg`` in its
``VmFlags`` at the buffer's first whole page (``data_ptr()`` is not
page-aligned, and the partial page before it is never advised).

An unadvised buffer of the same size must lack the flag, so the check
can fail. That control is a fresh anonymous mapping: ``np.empty`` or
``torch.empty`` may return heap memory whose mapping an earlier buffer's
advice already flagged, in a process that freed large buffers before
(glibc serves even a 40 MiB request from a free heap chunk when it has
one). The buffers checked are 40 MiB, above glibc's largest mmap
threshold (32 MiB), which makes such reuse rarer. numpy's own allocator
advises arrays of 4 MiB and more by itself (on Linux 4.6 and later): the
port's numpy buffers are checked with that switched off, so the flag is
the port's.
"""

import contextlib
import mmap
import os

import numpy as np
import pytest
import torch

from tpusnap import _native as jax_native
from tpusnap_torch import Snapshot, StateDict, _native
from tpusnap_torch.knobs import (
    override_batching_disabled,
    override_compress,
    override_max_chunk_size_bytes,
)
from tpusnap_torch.manifest import ChunkedTensorEntry
from tpusnap_torch.rss_profiler import mapping_of

_THP_ENABLED = "/sys/kernel/mm/transparent_hugepage/enabled"
_MIB = 1 << 20
_BIG = 40 * _MIB  # bytes of every buffer whose flag is checked
_BIG_SHAPE = (2560, 4096)  # f32


@pytest.fixture(autouse=True)
def _telemetry_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))


@pytest.fixture
def thp():
    """The flag checks need the kernel's transparent hugepage support."""
    if not os.path.exists(_THP_ENABLED):
        pytest.skip(f"{_THP_ENABLED} is absent: this kernel has no transparent hugepages")


@contextlib.contextmanager
def _numpy_advice_off():
    multiarray = getattr(np, "_core", None) or np.core
    prev = multiarray.multiarray._set_madvise_hugepage(False)
    try:
        yield
    finally:
        multiarray.multiarray._set_madvise_hugepage(prev)


def _addr(buf) -> int:
    return buf.data_ptr() if isinstance(buf, torch.Tensor) else buf.ctypes.data


def _advised(addr: int) -> bool:
    """Whether the mapping holding the first whole page at or after
    ``addr`` was advised."""
    m = mapping_of((addr + 4095) & ~4095)
    assert m is not None, "no mapping holds the address"
    return "hg" in m["vm_flags"]


def _assert_advised(buf) -> None:
    nbytes = buf.numel() * buf.element_size() if isinstance(buf, torch.Tensor) else buf.nbytes
    assert nbytes >= _BIG
    assert _advised(_addr(buf)), "the destination's first whole page is not advised"
    # The check can fail: an unadvised buffer of the same size lacks it.
    control = np.frombuffer(mmap.mmap(-1, nbytes), dtype=np.uint8)
    assert not _advised(control.ctypes.data)


class _FakeLibc:
    def __init__(self):
        self.calls = []

    def madvise(self, start, length, advice):
        self.calls.append((start, length, advice))
        return 0


@pytest.fixture
def fake_libc(monkeypatch):
    """Both packages' libc replaced by one recorder of madvise calls."""
    libc = _FakeLibc()
    for mod in (_native, jax_native):
        monkeypatch.setattr(mod, "_libc", libc)
        monkeypatch.setattr(mod, "_libc_failed", False)
    return libc


# --- tests/test_aux.py::TestAdviseHugepages ------------------------------


def test_advised_buffers_usable():
    big = _native.aligned_empty(8 << 20)  # above the 4 MiB threshold
    big[:] = 7
    assert (big == 7).all()
    small = _native.aligned_empty(1024)  # below: no-op path
    small[:] = 1
    assert (small == 1).all()


def test_advise_arbitrary_arrays():
    arr = np.random.default_rng(0).standard_normal(1 << 21)
    before = arr.copy()
    _native.advise_hugepages(arr)  # must not perturb contents
    assert (arr == before).all()
    _native.advise_hugepages(np.empty(0, np.uint8))  # empty: no-op
    # bf16 has no buffer protocol: the tensor's pointer and size are used.
    bf16 = torch.ones(1 << 21, dtype=torch.bfloat16)
    _native.advise_hugepages(bf16)
    assert bool((bf16 == 1).all())
    f8 = torch.ones(1 << 23, dtype=torch.float8_e4m3fn)
    _native.advise_hugepages(f8)
    assert bool((f8.float() == 1).all())


# --- the advice's rules ----------------------------------------------------


def test_advice_rounds_in_to_whole_pages(fake_libc):
    raw = np.empty(9 * _MIB + 4096, dtype=np.uint8)
    buf = raw[123 : 123 + 8 * _MIB + 7]
    _native.advise_hugepages(buf)
    addr = buf.ctypes.data
    start = (addr + 4095) & ~4095
    end = (addr + buf.nbytes) & ~4095
    assert fake_libc.calls == [(start, end - start, 14)]
    t = torch.empty(8 * _MIB // 4 + 3, dtype=torch.float32)
    _native.advise_hugepages(t)
    a, n = t.data_ptr(), t.numel() * 4
    assert fake_libc.calls[-1] == ((a + 4095) & ~4095, ((a + n) & ~4095) - ((a + 4095) & ~4095), 14)


def test_small_empty_cuda_and_pinned_buffers_left_alone(fake_libc, monkeypatch):
    _native.advise_hugepages(np.empty(4 * _MIB - 1, np.uint8))  # under 4 MiB
    _native.advise_hugepages(torch.empty(_MIB, dtype=torch.float32).view(torch.uint8)[: 4 * _MIB - 1])
    _native.advise_hugepages(np.empty(0, np.uint8))
    _native.advise_hugepages(b"")
    # A tensor off the host (a meta tensor stands for a CUDA one here).
    _native.advise_hugepages(torch.empty(8 * _MIB, dtype=torch.uint8, device="meta"))
    assert fake_libc.calls == []
    # A pinned tensor belongs to CUDA's host allocator (this host cannot
    # pin: the query is made to say so).
    t = torch.empty(8 * _MIB, dtype=torch.uint8)
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a, **k: True)
    _native.advise_hugepages(t)
    assert fake_libc.calls == []
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a, **k: False)
    _native.advise_hugepages(t)
    assert len(fake_libc.calls) == 1


def test_only_a_libc_load_failure_latches(monkeypatch):
    monkeypatch.setattr(_native, "_libc", None)
    monkeypatch.setattr(_native, "_libc_failed", False)
    # An odd buffer is ignored and does not disable the advice...
    _native.advise_hugepages(object())
    assert not _native._libc_failed and _native._libc is not None
    # ...a libc that cannot be loaded does, for the process.
    monkeypatch.setattr(_native, "_libc", None)

    def no_libc(*args, **kwargs):
        raise OSError("no libc")

    monkeypatch.setattr(_native.ctypes, "CDLL", no_libc)
    _native.advise_hugepages(np.empty(8 * _MIB, np.uint8))
    assert _native._libc_failed
    monkeypatch.undo()
    assert not _native._libc_failed


@pytest.mark.parametrize(
    "nbytes,offset",
    [(0, 0), (_MIB, 0), (4 * _MIB, 0), (8 * _MIB, 0), (8 * _MIB + 7, 123)],
    ids=["empty", "1mib", "4mib", "8mib", "8mib+7@123"],
)
def test_advice_matches_tpusnap(fake_libc, nbytes, offset):
    """tpusnap's ``advise_hugepages`` and the port's advise the same
    range of the same buffer."""
    raw = np.empty(nbytes + offset + 1, dtype=np.uint8)
    buf = raw[offset : offset + nbytes]
    jax_native.advise_hugepages(buf)
    theirs = list(fake_libc.calls)
    fake_libc.calls.clear()
    _native.advise_hugepages(buf)
    assert fake_libc.calls == theirs
    _native.advise_hugepages(torch.from_numpy(buf))
    assert fake_libc.calls == theirs * 2


def test_advised_flags_match_tpusnap(thp):
    """The real kernel flags the same kind of buffer alike for both
    packages, and leaves it unflagged without advice."""
    bufs = [np.frombuffer(mmap.mmap(-1, _BIG), dtype=np.uint8)[16:] for _ in range(3)]
    jax_native.advise_hugepages(bufs[0])
    _native.advise_hugepages(bufs[1])
    assert [_advised(b.ctypes.data) for b in bufs] == [True, True, False]
    # The partial page before the first whole one stays unadvised.
    assert "hg" not in mapping_of(bufs[1].ctypes.data)["vm_flags"]


@pytest.mark.parametrize(
    "dtype,n", [(np.float32, _BIG // 4), (torch.bfloat16, _BIG // 2)], ids=["numpy", "torch"]
)
def test_empty_advised(thp, dtype, n):
    with _numpy_advice_off():
        out = _native.empty_advised((n,), dtype)
    if isinstance(dtype, torch.dtype):
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        assert out.dtype == dtype and tuple(out.shape) == (n,)
    else:
        assert isinstance(out, np.ndarray) and out.dtype == dtype and out.shape == (n,)
    _assert_advised(out)


def test_aligned_empty_advises(thp):
    with _numpy_advice_off():  # the port's own advice, not numpy's
        _assert_advised(_native.aligned_empty(_BIG + 7))


def test_compress_bound_matches_tpusnap():
    if not (_native.available() and jax_native.available()):
        pytest.skip("the native build is missing")
    for n, tile in [(1, 1), (4096, 4096), (16 * _MIB + 3, 16 * _MIB), (100 * _MIB, _MIB)]:
        assert _native.compress_bound(n, tile) == jax_native.compress_bound(n, tile)
        assert _native.compress_bound(n, tile) >= n


# --- each site through its real path ---------------------------------------


def _state(n_floats: int, seed: int, shape=None) -> torch.Tensor:
    arr = np.random.default_rng(seed).standard_normal(n_floats).astype(np.float32)
    t = torch.from_numpy(arr)
    return t.reshape(shape) if shape else t


@pytest.fixture
def allocations(monkeypatch):
    """Every ``aligned_empty`` buffer of 40 MiB or more, with whether its
    first whole page was advised when it was made; numpy's own advice is
    off, so the flag is the port's."""
    seen = []
    real = _native.aligned_empty

    def recording(nbytes, align=4096):
        out = real(nbytes, align)
        if nbytes >= _BIG:
            seen.append((nbytes, _advised(out.ctypes.data)))
        return out

    monkeypatch.setattr(_native, "aligned_empty", recording)
    with _numpy_advice_off():
        yield seen


def test_slab_take_advises_the_slab(thp, tmp_path, allocations):
    tensors = {f"w{i}": _state(_MIB + 3 * i, seed=i) for i in range(12)}  # 48 MiB
    snap = Snapshot.take(str(tmp_path / "s"), {"m": StateDict(**tensors)})
    entries = snap.get_manifest()
    slabs = {entries[f"0/m/{k}"].location for k in tensors}
    assert len(slabs) == 1 and next(iter(slabs)).startswith("batched/")
    slab_bytes = os.path.getsize(tmp_path / "s" / next(iter(slabs)))
    assert slab_bytes >= 48 * _MIB
    assert (slab_bytes, True) in allocations, allocations
    assert all(advised for _, advised in allocations), allocations
    target = {"m": StateDict(**{k: torch.zeros_like(v) for k, v in tensors.items()})}
    Snapshot(str(tmp_path / "s")).restore(target)
    for k, v in tensors.items():
        assert torch.equal(target["m"][k], v), k


@pytest.mark.parametrize("how", ["restore", "read_object"])
def test_read_without_target_advises_scratch_and_owning_copy(thp, tmp_path, allocations, how):
    w = _state(_BIG // 4, seed=1)
    with override_batching_disabled(True):
        Snapshot.take(str(tmp_path / "s"), {"m": StateDict(w=w)})
    snap = Snapshot(str(tmp_path / "s"))
    if how == "restore":
        target = {"m": StateDict(w=None)}
        snap.restore(target)
        got = target["m"]["w"]
    else:
        got = snap.read_object("0/m/w")
    assert torch.equal(got, w)
    assert (w.numel() * 4, True) in allocations, allocations  # the read scratch
    _assert_advised(got)  # the owning copy


def test_budgeted_read_object_advises_the_tiled_destination(thp, tmp_path):
    w = _state(_BIG // 4, seed=2, shape=_BIG_SHAPE)
    with override_batching_disabled(True):
        Snapshot.take(str(tmp_path / "s"), {"m": StateDict(w=w)})
    got = Snapshot(str(tmp_path / "s")).read_object("0/m/w", memory_budget_bytes=8 * _MIB)
    assert torch.equal(got, w)
    _assert_advised(got)


def test_compressed_read_advises_its_destination(thp, tmp_path):
    if not _native.compression_available():
        pytest.skip("the native build is missing: nothing is compressed")
    w = (torch.arange(_BIG // 4, dtype=torch.int32) % 17).reshape(_BIG_SHAPE)
    with override_batching_disabled(True), override_compress(mode="on"):
        snap = Snapshot.take(str(tmp_path / "s"), {"m": StateDict(w=w)})
    assert snap.get_manifest()["0/m/w"].codec
    got = Snapshot(str(tmp_path / "s")).read_object("0/m/w")
    assert torch.equal(got, w)
    _assert_advised(got)


def test_chunked_read_advises_its_destination(thp, tmp_path):
    w = _state(_BIG // 4, seed=3, shape=_BIG_SHAPE)
    with override_max_chunk_size_bytes(16 * _MIB):
        snap = Snapshot.take(str(tmp_path / "s"), {"m": StateDict(w=w)})
    assert isinstance(snap.get_manifest()["0/m/w"], ChunkedTensorEntry)
    got = Snapshot(str(tmp_path / "s")).read_object("0/m/w")
    assert torch.equal(got, w)
    _assert_advised(got)


def _sharded_take_world(root: str) -> None:
    """Both ranks of a gloo world take one Shard(0) DTensor of 40 MiB."""
    from torch.distributed.tensor import Shard

    from tpusnap_torch.test_utils import as_dtensor, world_mesh

    full = _state(_BIG // 4, seed=4, shape=_BIG_SHAPE)
    Snapshot.take(root, {"m": StateDict(w=as_dtensor(full, world_mesh("cpu"), [Shard(0)]))})


def test_sharded_read_advises_the_shard_destination(thp, tmp_path):
    from tpusnap_torch.test_utils import run_subprocess_world

    path = str(tmp_path / "s")
    run_subprocess_world(_sharded_take_world, world_size=2, args=[path], timeout=150)
    got = Snapshot(path).read_object("0/m/w")
    assert torch.equal(got, _state(_BIG // 4, seed=4, shape=_BIG_SHAPE))
    _assert_advised(got)
