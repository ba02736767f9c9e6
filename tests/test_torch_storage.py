"""The port's storage engine against tpusnap's: every case of
tests/test_storage.py, and the batcher's device-batching switch.

- the scheme registry and its middleware (retry outermost, the I/O
  histograms inside it, chaos under both), run-time registration;
- the fs plugin: round trips, the native write path, O_DIRECT writes and
  reads at unaligned sizes with the knob on and off, concurrent writes,
  the sync shims, ``write_atomic``'s durable flag;
- ``_native``: ranged writes and reads, ``memcpy``, ``copy_to_bytes``,
  the CRC32C vector, the fallback without the native build;
- the fsspec plugin: the memory store's one-copy write (a copy, sizes
  read without copying, the GIL released), every byte of a view to
  another backend, the counters of each path;
- in-place reads (``read_range_into``, the plugin honouring ``into``, a
  restore landing in the target, a short read failing loudly) and the
  abort path (the original error surfaces, the loop stays reusable);
- ``TPUSNAP_DURABLE_COMMIT=1`` fsyncs every blob after its write, the
  metadata's temp file, and every directory the take created; off, a take
  fsyncs nothing;
- ``TPUSNAP_DISABLE_DEVICE_BATCHING=1`` sends CUDA slab members to the
  host pack, as tpusnap's ``_device_group_key`` does.

Where a case produces bytes (a written file, a read, a CRC) they are held
equal to tpusnap's on the same input, made from a seeded numpy generator.
"""

import asyncio
import glob
import os
import subprocess
import sys
import types
import unittest.mock as mock

import numpy as np
import pytest
import torch

import tpusnap_torch.storage_plugins.fs as fs
from tpusnap import _native as jax_native
from tpusnap.knobs import is_direct_io_disabled as jax_direct_io_disabled
from tpusnap.storage_plugins.fs import FSStoragePlugin as JaxFSStoragePlugin
from tpusnap_torch import Snapshot, StateDict, _native
from tpusnap_torch.batcher import _device_group_key
from tpusnap_torch.io_preparers.array import ArrayBufferStager
from tpusnap_torch.io_types import ReadIO, WriteIO, run_on_loop
from tpusnap_torch.knobs import (
    override_batching_disabled,
    override_checksum_disabled,
    override_device_batching_disabled,
    override_direct_io_disabled,
    override_slab_size_threshold_bytes,
)
from tpusnap_torch.storage_plugin import (
    InstrumentedStoragePlugin,
    register_storage_plugin,
    unregister_storage_plugin,
    url_to_storage_plugin,
)
from tpusnap_torch.storage_plugins.fs import FSStoragePlugin

_MIB = 1 << 20
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _telemetry_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))


def _bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _run(coro):
    return asyncio.run(coro)


def _jax_read(root: str, path: str, byte_range=None) -> bytes:
    """The bytes tpusnap's fs plugin reads back."""
    from tpusnap.io_types import ReadIO as JaxReadIO

    plugin = JaxFSStoragePlugin(root=root)
    read_io = JaxReadIO(path=path, byte_range=byte_range)
    plugin.sync_read(read_io)
    plugin.sync_close()
    return bytes(read_io.buf.getbuffer())


def _counting_fsyncs(monkeypatch, root):
    synced = []
    orig = fs._fsync_path

    def counting(path):
        synced.append(os.path.relpath(path, root))
        orig(path)

    monkeypatch.setattr(fs, "_fsync_path", counting)
    return synced


@pytest.mark.parametrize("durable", [True, False], ids=["durable", "default"])
def test_durable_commit_knob_round_trip(tmp_path, monkeypatch, durable):
    if durable:
        monkeypatch.setenv("TPUSNAP_DURABLE_COMMIT", "1")
    synced = _counting_fsyncs(monkeypatch, str(tmp_path))
    state = {"app": StateDict(w=torch.arange(32, dtype=torch.float32),
                              nested={"v": torch.ones(4, 8)})}
    with override_batching_disabled(True):
        Snapshot.take(str(tmp_path / "snap"), state)
    if not durable:
        assert synced == []
    else:
        blobs = {"snap/0/app/w", "snap/0/app/nested/v"}
        dirs = {"snap", "snap/0/app", "snap/0/app/nested"}
        assert blobs | dirs <= set(synced), synced
        assert any(s.startswith("snap/.snapshot_metadata.tmp") for s in synced), synced
    target = {"app": StateDict(w=torch.zeros(32), nested={"v": torch.zeros(4, 8)})}
    Snapshot(str(tmp_path / "snap")).restore(target)
    assert target["app"]["w"].equal(torch.arange(32, dtype=torch.float32))
    assert target["app"]["nested"]["v"].equal(torch.ones(4, 8))


def test_durable_async_take_flushes_before_commit(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_DURABLE_COMMIT", "1")
    synced = _counting_fsyncs(monkeypatch, str(tmp_path))
    with override_batching_disabled(True):
        Snapshot.async_take(str(tmp_path / "snap"), {"app": StateDict(w=torch.ones(64))}).wait()
    commit = next(i for i, s in enumerate(synced) if s.startswith("snap/.snapshot_metadata.tmp"))
    # The blob and the directories were flushed before the commit began,
    # and the directories again with it.
    assert {"snap/0/app/w", "snap/0/app", "snap"} <= set(synced[:commit]), synced
    assert {"snap/0/app", "snap"} <= set(synced[commit:]), synced


def test_device_batching_knob(monkeypatch):
    """A CUDA member packs on its device unless the knob sends it to the
    host pack (a stand-in tensor: this host has no card)."""
    stager = ArrayBufferStager(torch.ones(4))
    monkeypatch.setattr(stager, "arr", types.SimpleNamespace(is_cuda=True, device="cuda:0"))
    assert _device_group_key(stager) == "cuda:0"
    with override_device_batching_disabled(True):
        assert _device_group_key(stager) is None
    cpu = ArrayBufferStager(torch.ones(4))
    assert _device_group_key(cpu) is None



def test_registry_schemes(tmp_path):
    from tpusnap_torch.retry import RetryingStoragePlugin
    from tpusnap_torch.storage_plugins.fsspec import FsspecStoragePlugin

    # Built-in plugins come wrapped retry(instrument(raw)), as tpusnap's.
    p = url_to_storage_plugin(str(tmp_path))
    assert isinstance(p, RetryingStoragePlugin)
    assert isinstance(p.inner, InstrumentedStoragePlugin)
    assert isinstance(p.inner.inner, FSStoragePlugin)
    assert p.inner.label == "FSStoragePlugin"
    p = url_to_storage_plugin(f"fs://{tmp_path}")
    assert isinstance(p.inner.inner, FSStoragePlugin)
    # storage_options={"retry": False} drops retry, keeps instrumentation.
    p = url_to_storage_plugin(str(tmp_path), {"retry": False})
    assert isinstance(p, InstrumentedStoragePlugin)
    assert isinstance(p.inner, FSStoragePlugin)
    p = url_to_storage_plugin("fsspec+memory://snap")
    assert isinstance(p.inner.inner, FsspecStoragePlugin)
    with pytest.raises(RuntimeError, match="Unsupported storage scheme"):
        url_to_storage_plugin("bogus://x")
    # S3 construction succeeds without aiobotocore; first use raises.
    s3 = url_to_storage_plugin("s3://bucket/prefix")
    with pytest.raises(RuntimeError, match="aiobotocore"):
        _run(s3.inner._get_client())


def test_registry_chaos_scheme(tmp_path):
    """chaos+<scheme>:// composes Retrying(Instrumented(FaultInjection(
    raw))), labelled by the raw backend class."""
    from tpusnap_torch.faults import FaultInjectionStoragePlugin, FaultPlan
    from tpusnap_torch.retry import RetryingStoragePlugin
    from tpusnap_torch.storage_plugins.fsspec import FsspecStoragePlugin

    def _unwrap(plugin):
        assert isinstance(plugin, RetryingStoragePlugin)
        assert isinstance(plugin.inner, InstrumentedStoragePlugin)
        return plugin.inner.inner

    p = url_to_storage_plugin(f"chaos+fs://{tmp_path}")
    fault = _unwrap(p)
    assert isinstance(fault, FaultInjectionStoragePlugin)
    assert isinstance(fault.inner, FSStoragePlugin)
    assert p.inner.label == "FSStoragePlugin"
    assert fault.plan.transient_per_op == 1
    assert p.inner.plan.transient_per_op == 1
    p = url_to_storage_plugin(
        f"chaos+fs://{tmp_path}",
        {"fault_plan": FaultPlan(seed=7, transient_every=3, torn_writes=True)},
    )
    assert _unwrap(p).plan.seed == 7 and _unwrap(p).plan.torn_writes
    p = url_to_storage_plugin(
        f"chaos+fs://{tmp_path}", {"fault_plan": "seed=2,transient_per_op=2,latency_ms=1"}
    )
    assert _unwrap(p).plan.seed == 2
    assert _unwrap(p).plan.transient_per_op == 2
    assert abs(_unwrap(p).plan.latency_sec - 0.001) < 1e-9
    p = url_to_storage_plugin("chaos+fsspec+memory://snapchaos")
    assert isinstance(_unwrap(p).inner, FsspecStoragePlugin)


def test_fs_write_read_roundtrip(tmp_path):
    plugin = FSStoragePlugin(root=str(tmp_path))
    data = _bytes(1 << 16, seed=1)

    async def go():
        await plugin.write(WriteIO(path="a/b/c", buf=memoryview(data)))
        read_io = ReadIO(path="a/b/c")
        await plugin.read(read_io)
        assert read_io.buf.getvalue() == data
        read_io = ReadIO(path="a/b/c", byte_range=(100, 356))
        await plugin.read(read_io)
        assert read_io.buf.getvalue() == data[100:356]
        await plugin.write(WriteIO(path="a/b/d", buf=memoryview(data)))
        await plugin.delete("a/b/c")
        assert not (tmp_path / "a" / "b" / "c").exists()
        await plugin.close()

    _run(go())
    # tpusnap's plugin reads the same bytes from the port's file.
    assert _jax_read(str(tmp_path), "a/b/d", (100, 356)) == data[100:356]


def test_fs_large_write_native_path(tmp_path):
    plugin = FSStoragePlugin(root=str(tmp_path))
    data = _bytes(5 * _MIB, seed=2)  # over the native threshold

    async def go():
        await plugin.write(WriteIO(path="big", buf=memoryview(data)))
        read_io = ReadIO(path="big")
        await plugin.read(read_io)
        assert bytes(read_io.buf.getbuffer()) == data
        await plugin.close()

    _run(go())
    assert _jax_read(str(tmp_path), "big") == data


@pytest.mark.parametrize("disabled", [False, True], ids=["direct", "buffered"])
@pytest.mark.parametrize(
    "nbytes", [4 * _MIB, 8 * _MIB + 4096, 9 * _MIB + 7], ids=["4mib", "8mib+4096", "9mib+7"]
)
def test_fs_direct_io_roundtrip(tmp_path, nbytes, disabled):
    """O_DIRECT writes are bit-exact at unaligned sizes (the aligned bulk
    through the direct fd, the tail buffered) and the knob forces the
    buffered path; the file equals tpusnap's written from the same bytes,
    and every ranged read equals tpusnap's."""
    data = _bytes(nbytes, seed=nbytes)
    with override_direct_io_disabled(disabled):
        assert jax_direct_io_disabled() is disabled  # one knob drives both
        path = str(tmp_path / "port")
        _native.write_file(path, memoryview(data))
        with open(path, "rb") as f:
            assert f.read() == data
        jax_native.write_file(str(tmp_path / "jax"), memoryview(data))
        with open(tmp_path / "jax", "rb") as f:
            assert f.read() == data
        # ranged reads: aligned, misaligned head/tail, past EOF, and a large
        # request starting in the final partial block
        for off, n in ((0, nbytes), (4096, 5 * _MIB), (1234, 4 * _MIB + 77),
                       (nbytes - 100, 500), (nbytes - 3, 4 * _MIB)):
            out = bytearray(n)
            got = _native.read_range(path, off, n, out)
            assert bytes(out[:got]) == data[off:off + n]
            theirs = bytearray(n)
            assert jax_native.read_range(path, off, n, theirs) == got
            assert theirs == out
    assert not jax_direct_io_disabled()


def test_fs_concurrent_writes(tmp_path):
    plugin = FSStoragePlugin(root=str(tmp_path))

    async def go():
        blobs = {f"obj{i}": _bytes(10_000, seed=100 + i) for i in range(32)}
        await asyncio.gather(*(plugin.write(WriteIO(path=k, buf=v)) for k, v in blobs.items()))
        for k, v in blobs.items():
            read_io = ReadIO(path=k)
            await plugin.read(read_io)
            assert read_io.buf.getvalue() == v
        await plugin.close()

    _run(go())


def test_fsspec_memory_roundtrip():
    plugin = url_to_storage_plugin("fsspec+memory://snaptest-port")

    async def go():
        await plugin.write(WriteIO(path="x/y", buf=b"hello"))
        read_io = ReadIO(path="x/y")
        await plugin.read(read_io)
        assert read_io.buf.getvalue() == b"hello"
        read_io = ReadIO(path="x/y", byte_range=(1, 4))
        await plugin.read(read_io)
        assert read_io.buf.getvalue() == b"ell"
        await plugin.delete("x/y")
        await plugin.close()

    _run(go())


def _float32_view(nbytes: int, seed: int):
    return np.frombuffer(_bytes(nbytes, seed), dtype=np.float32).copy()


def _bf16_view(nbytes: int, seed: int):
    t = torch.from_numpy(_float32_view(2 * nbytes, seed)).to(torch.bfloat16)
    return t.view(torch.int16).numpy()


_MEMORY_BLOB_SIZES = [0, 300_000, 8 * _MIB + 4096]


@pytest.mark.parametrize("nbytes", _MEMORY_BLOB_SIZES, ids=["empty", "small", "large"])
@pytest.mark.parametrize("make", [_float32_view, _bf16_view], ids=["float32", "bf16"])
def test_fsspec_memory_write_is_a_copy(nbytes, make):
    """A blob from a non-byte view lands whole in the memory store, as a
    copy: changing the source afterwards leaves the store alone."""
    from tpusnap_torch.storage_plugins.fsspec import FsspecStoragePlugin

    root = f"copytest-{make.__name__}-{nbytes}"
    plugin = FsspecStoragePlugin("memory", root)
    src = make(nbytes, seed=11)
    want = src.tobytes()
    assert len(want) == nbytes and memoryview(src).format != "B"
    try:
        plugin.sync_write(WriteIO(path="a/blob", buf=src))
        src.view(np.uint8)[:] += 1
        stored = plugin._fs.store[f"/{root}/a/blob"]
        assert stored.size == nbytes
        assert stored.getvalue() == want
        assert plugin._fs.cat_file(f"/{root}/a/blob") == want
        read_io = ReadIO(path="a/blob")
        plugin.sync_read(read_io)
        assert read_io.buf.getvalue() == want
        if nbytes:
            read_io = ReadIO(path="a/blob", byte_range=(7, nbytes - 3))
            plugin.sync_read(read_io)
            assert read_io.buf.getvalue() == want[7 : nbytes - 3]
    finally:
        plugin._fs.rm(f"/{root}", recursive=True)
        plugin.sync_close()


def test_fsspec_memory_file_sizes_without_copy():
    """The size a listing, ``info`` or a recursive delete reads from a
    64 MiB stored blob allocates nothing near the blob's size, also while
    a reader holds the blob (a whole read returns the stored object,
    which the stored file then shares), and the stored file still takes
    reads and later writes as any MemoryFile."""
    import tracemalloc

    from tpusnap_torch.storage_plugins.fsspec import FsspecStoragePlugin

    root = "sizetest"
    plugin = FsspecStoragePlugin("memory", root)
    fs_ = plugin._fs
    nbytes = 64 * _MIB
    plugin.sync_write(WriteIO(path="d/blob", buf=np.ones(nbytes // 4, dtype=np.float32)))
    plugin.sync_write(WriteIO(path="d/other", buf=b"tail"))
    held = ReadIO(path="d/blob")
    plugin.sync_read(held)
    tracemalloc.start()
    try:
        assert fs_.info(f"/{root}/d/blob")["size"] == nbytes
        sizes = {e["name"]: e["size"] for e in fs_.ls(f"/{root}/d", detail=True)}
        assert sizes == {f"/{root}/d/blob": nbytes, f"/{root}/d/other": 4}
        assert fs_.ls(f"/{root}/d/blob", detail=True)[0]["size"] == nbytes
        # The plugin has no listing of its own (as tpusnap's), so the
        # base class's None comes back.
        assert plugin.sync_list_with_sizes() is None
        fs_.rm(f"/{root}", recursive=True)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < _MIB, peak
    assert not fs_.exists(f"/{root}/d/blob")
    assert held.buf.getbuffer().nbytes == nbytes

    # Later writes: appending to a stored blob changes its size.
    plugin.sync_write(WriteIO(path="e/blob", buf=_bytes(2 * _MIB, seed=12)))
    with fs_.open(f"/{root}/e/blob", "ab") as f:
        f.write(b"xyz")
    assert fs_.info(f"/{root}/e/blob")["size"] == 2 * _MIB + 3
    assert fs_.cat_file(f"/{root}/e/blob", start=2 * _MIB) == b"xyz"
    with fs_.open(f"/{root}/e/blob", "rb") as f:
        assert f.read() == _bytes(2 * _MIB, seed=12) + b"xyz"
    plugin.sync_write(WriteIO(path="e/blob", buf=b"new"))
    assert fs_.cat_file(f"/{root}/e/blob") == b"new"
    fs_.rm(f"/{root}", recursive=True)
    plugin.sync_close()


def test_fsspec_memory_write_leaves_the_gil():
    """The copy into the memory store runs with the GIL released: a
    thread sleeping 1 ms at a time beside a 64 MiB write runs late by
    far less than the write takes. Holding the GIL through the copy, it
    would be late by at least one whole copy, half the write or more.
    Best of three writes, against scheduling noise on a loaded host."""
    import threading
    import time

    from tpusnap_torch.storage_plugins.fsspec import FsspecStoragePlugin

    if not _native.available():
        pytest.skip("native library not loaded: the copy holds the GIL")
    root = "giltest"
    plugin = FsspecStoragePlugin("memory", root)
    src = np.ones(16 * _MIB, dtype=np.float32)
    ratios = []
    try:
        for i in range(3):
            stop = threading.Event()
            late = [0.0]

            def probe():
                while not stop.is_set():
                    t = time.perf_counter()
                    time.sleep(0.001)
                    late[0] = max(late[0], time.perf_counter() - t - 0.001)

            prober = threading.Thread(target=probe)
            prober.start()
            time.sleep(0.02)
            t0 = time.perf_counter()
            writer = threading.Thread(
                target=plugin.sync_write, args=(WriteIO(path=f"w/{i}", buf=src),)
            )
            writer.start()
            writer.join()
            wall = time.perf_counter() - t0
            stop.set()
            prober.join()
            assert plugin._fs.info(f"/{root}/w/{i}")["size"] == src.nbytes
            ratios.append(late[0] / wall)
            if ratios[-1] < 0.25:
                break
    finally:
        plugin._fs.rm(f"/{root}", recursive=True)
        plugin.sync_close()
    assert min(ratios) < 0.25, ratios


def test_fsspec_file_backend_writes_every_byte_of_a_view(tmp_path):
    """Another backend gets the view's bytes, not its item count."""
    from tpusnap_torch.storage_plugins.fsspec import FsspecStoragePlugin

    plugin = FsspecStoragePlugin("file", str(tmp_path))
    src = _float32_view(3 * _MIB + 8, seed=13)
    plugin.sync_write(WriteIO(path="a/blob", buf=src))
    plugin.sync_close()
    assert os.path.getsize(tmp_path / "a" / "blob") == src.nbytes
    assert (tmp_path / "a" / "blob").read_bytes() == src.tobytes()


@pytest.mark.parametrize(
    "protocol,counter",
    [("memory", "fsspec.direct_bytes"), ("file", "fsspec.buffered_bytes")],
)
def test_fsspec_write_counters(tmp_path, protocol, counter):
    """Each write counts its bytes under the path it took, and only there."""
    from tpusnap_torch import telemetry
    from tpusnap_torch.storage_plugins.fsspec import FsspecStoragePlugin

    other = {"fsspec.direct_bytes", "fsspec.buffered_bytes"} - {counter}
    root = str(tmp_path) if protocol == "file" else "countertest"
    plugin = FsspecStoragePlugin(protocol, root)
    before = telemetry.counter_value(counter), telemetry.counter_value(*other)
    plugin.sync_write(WriteIO(path="a/blob", buf=_float32_view(2 * _MIB, seed=14)))
    plugin.sync_write(WriteIO(path="a/small", buf=b"12345"))
    after = telemetry.counter_value(counter), telemetry.counter_value(*other)
    if protocol == "memory":
        plugin._fs.rm(f"/{root}", recursive=True)
    plugin.sync_close()
    assert after[0] - before[0] == 2 * _MIB + 5
    assert after[1] == before[1]


@pytest.mark.parametrize("kind", ["take", "async_take"])
def test_fsspec_memory_take_counts_direct_bytes(kind, capsys):
    """A take to the memory store counts every byte it writes as
    ``fsspec.direct_bytes`` in its rollup and the ``trace`` listing."""
    import fsspec

    from tpusnap_torch.__main__ import main

    state = {f"w{i}": torch.arange(300_000, dtype=torch.float32) + i for i in range(3)}
    url = f"fsspec+memory://direct-{kind}"
    if kind == "take":
        snap = Snapshot.take(url, {"m": StateDict(state)})
    else:
        snap = Snapshot.async_take(url, {"m": StateDict(state)}).wait()
    try:
        counters = snap.metadata.extras["telemetry"]["counters"]
        assert counters["fsspec.direct_bytes"] >= 3 * 300_000 * 4
        assert counters["fsspec.direct_bytes"] >= counters["storage.bytes_written"]
        assert "fsspec.buffered_bytes" not in counters
        assert main(["trace", url]) == 0
        assert "fsspec.direct_bytes" in capsys.readouterr().out
        out = StateDict({k: torch.zeros_like(v) for k, v in state.items()})
        snap.restore({"m": out})
        for k, v in state.items():
            assert torch.equal(out[k], v)
    finally:
        fsspec.filesystem("memory").rm(f"/direct-{kind}", recursive=True)


def test_sync_shims(tmp_path):
    plugin = FSStoragePlugin(root=str(tmp_path))
    plugin.sync_write(WriteIO(path="s", buf=b"sync"))
    read_io = ReadIO(path="s")
    plugin.sync_read(read_io)
    assert read_io.buf.getvalue() == b"sync"
    plugin.sync_close()


class TestNative:
    def test_write_and_read_range(self, tmp_path):
        data = _bytes(_MIB, seed=3)
        path = str(tmp_path / "n.bin")
        _native.write_file(path, memoryview(data))
        assert open(path, "rb").read() == data
        out = bytearray(1000)
        got = _native.read_range(path, 500, 1000, out)
        assert got == 1000 and bytes(out) == data[500:1500]
        # EOF-short read
        out = bytearray(100)
        got = _native.read_range(path, len(data) - 10, 100, out)
        assert got == 10 and bytes(out[:10]) == data[-10:]

    def test_memcpy(self):
        src = _bytes(3 * _MIB, seed=4)
        dst = bytearray(len(src))
        _native.memcpy(dst, src)
        assert bytes(dst) == src
        with pytest.raises(ValueError):
            _native.memcpy(bytearray(5), b"123")

    @pytest.mark.parametrize("nbytes", [0, _MIB - 1, _MIB, _MIB + 1, 9 * _MIB + 5])
    def test_copy_to_bytes(self, nbytes):
        src = _bytes(nbytes, seed=15)
        out = _native.copy_to_bytes(memoryview(src))
        assert type(out) is bytes and out == src
        view = np.frombuffer(src[: nbytes - nbytes % 4], dtype=np.float32)
        assert _native.copy_to_bytes(view, nthreads=1) == bytes(view)

    def test_crc32c_known_vector(self):
        if not _native.available():
            pytest.skip("native unavailable")
        # RFC 3720 test vector: crc32c of 32 zero bytes == 0x8a9136aa
        assert _native.crc32c(bytes(32)) == 0x8A9136AA
        assert _native.checksum_algorithm() == "crc32c"
        data = _bytes(5 * _MIB + 3, seed=5)
        assert _native.crc32c(data) == jax_native.crc32c(data)

    def test_disabled_fallback(self, tmp_path):
        code = (
            "import os; os.environ['TPUSNAP_DISABLE_NATIVE']='1';"
            "from tpusnap_torch import _native;"
            f"p=r'{tmp_path}/f.bin';"
            "_native.write_file(p, b'abc');"
            "assert open(p,'rb').read()==b'abc';"
            "assert not _native.available();"
            "assert _native.checksum_algorithm() == 'zlib-crc32';"
            "b=bytes(range(256))*8192;"
            "assert _native.copy_to_bytes(memoryview(b))==b;"
            "print('fallback-ok')"
        )
        env = dict(os.environ, TPUSNAP_DISABLE_NATIVE="1")
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True, cwd=_REPO, env=env,
            timeout=120,
        )
        assert "fallback-ok" in out.stdout, out.stderr


def test_register_storage_plugin_runtime(tmp_path):
    """Run-time registered schemes take effect without packaging."""
    calls = {}

    def factory(path, storage_options):
        calls["path"] = path
        return FSStoragePlugin(root=str(tmp_path / path), storage_options=storage_options)

    register_storage_plugin("memtest", factory)
    try:
        plugin = url_to_storage_plugin("memtest://sub/dir")
        assert isinstance(plugin, FSStoragePlugin)
        assert calls["path"] == "sub/dir"
    finally:
        unregister_storage_plugin("memtest")
    with pytest.raises(RuntimeError):
        url_to_storage_plugin("memtest://sub/dir")


class TestReadInto:
    """In-place reads: bytes land directly in the consumer's destination
    with the checksum fused into the native copy-out."""

    def test_read_range_into_correctness(self, tmp_path):
        n = 9 * _MIB + 1234
        data = _bytes(n, seed=6)
        path = str(tmp_path / "blob")
        open(path, "wb").write(data)
        cases = [
            (0, n),                       # whole file
            (0, 5 * _MIB + 17),           # aligned start, odd length
            (1, n - 1),                   # misaligned head
            (4096, 6 * _MIB),             # aligned window
            (777, 8 * _MIB + 5),          # misaligned head + tail
            (n - 100, 100),               # small tail
            (n - 100, 500),               # EOF-short
            (0, 1000),                    # small (buffered path)
        ]
        for off, ln in cases:
            out = np.empty(ln, dtype=np.uint8)
            got, crc, algo = _native.read_range_into(path, off, ln, out, want_crc=True)
            expect = data[off : off + ln]
            assert got == len(expect), (off, ln)
            assert out[:got].tobytes() == expect, (off, ln)
            assert crc == _native.crc32c(expect) == jax_native.crc32c(expect), (off, ln)
            theirs = np.empty(ln, dtype=np.uint8)
            assert jax_native.read_range_into(path, off, ln, theirs, want_crc=True) == (got, crc, algo)
        # an aligned destination takes the zero-copy direct path
        out = _native.aligned_empty(8 * _MIB)
        got, crc, algo = _native.read_range_into(path, 0, 8 * _MIB, out, want_crc=True)
        assert got == 8 * _MIB
        assert bytes(out) == data[:got] and crc == _native.crc32c(data[:got])
        # want_crc=False reports no checksum
        got, crc, algo = _native.read_range_into(path, 0, 4 * _MIB, np.empty(4 * _MIB, np.uint8))
        assert got == 4 * _MIB and crc is None

    def test_fs_plugin_honors_into(self, tmp_path):
        plugin = FSStoragePlugin(root=str(tmp_path))
        data = _bytes(5 * _MIB, seed=7)

        async def go():
            await plugin.write(WriteIO(path="b", buf=data))
            dst = np.empty(len(data), dtype=np.uint8)
            read_io = ReadIO(path="b", into=memoryview(dst), want_crc=True)
            await plugin.read(read_io)
            assert read_io.in_place
            assert dst.tobytes() == data
            if _native.available():
                assert read_io.crc32c == _native.crc32c(data) == jax_native.crc32c(data)
                assert read_io.crc_algo == "crc32c"
            # the generic buf view still works for fallback consumers
            assert bytes(read_io.buf.getbuffer()) == data
            await plugin.close()

        _run(go())

    def test_restore_lands_in_place(self, tmp_path):
        """A CPU target of the stored dtype and shape receives the bytes
        directly: the restore keeps the SAME tensor object."""
        arr = torch.from_numpy(np.random.default_rng(5).standard_normal(500_000).astype(np.float32))
        Snapshot.take(str(tmp_path / "s"), {"m": StateDict(w=arr.clone())})
        target_arr = torch.zeros_like(arr)
        ptr = target_arr.data_ptr()
        target = {"m": StateDict(w=target_arr)}
        Snapshot(str(tmp_path / "s")).restore(target)
        assert target["m"]["w"] is target_arr and target_arr.data_ptr() == ptr
        assert torch.equal(target_arr, arr)

    def test_in_place_short_read_fails_loudly(self, tmp_path):
        """A truncated blob raises, not a partial restore in the target,
        even with checksum verification off."""
        arr = torch.arange(300_000, dtype=torch.float32)
        with override_slab_size_threshold_bytes(1024):
            Snapshot.take(str(tmp_path / "s"), {"m": StateDict(w=arr)})
        blob = str(tmp_path / "s" / "0" / "m" / "w")
        assert os.path.isfile(blob)
        with open(blob, "r+b") as f:
            f.truncate(arr.numel() * 4 // 2)
        for checksum_off in (False, True):
            with override_checksum_disabled(checksum_off):
                target = {"m": StateDict(w=torch.zeros_like(arr))}
                with pytest.raises((IOError, ValueError)):
                    Snapshot(str(tmp_path / "s")).restore(target)


class TestAbortPath:
    """A failed read surfaces the ORIGINAL error, leaves no stranded
    tasks on the (cached, reused) event loop, and no plugin thread still
    writing into caller-owned memory."""

    def test_failed_restore_surfaces_original_error_and_loop_reusable(self, tmp_path):
        from tpusnap_torch._native import ChecksumError

        arrs = {f"w{i}": torch.arange(400_000, dtype=torch.float32) + i for i in range(6)}
        Snapshot.take(str(tmp_path / "s"), {"m": StateDict(**arrs)})
        snap = Snapshot(str(tmp_path / "s"))
        entry = snap.get_manifest()["0/m/w2"]
        blob = str(tmp_path / "s" / "0" / "m" / "w2")
        if not os.path.isfile(blob):
            blob = glob.glob(str(tmp_path / "s" / "batched" / "*"))[0]
        off = (entry.byte_range[0] if entry.byte_range else 0) + 16
        with open(blob, "r+b") as fh:
            fh.seek(off)
            b = fh.read(1)
            fh.seek(off)
            fh.write(bytes([b[0] ^ 0xFF]))

        for _ in range(3):
            with pytest.raises(ChecksumError, match="w2"):
                snap.restore({"m": StateDict(**{k: torch.zeros_like(v) for k, v in arrs.items()})})
            assert torch.equal(snap.read_object("0/m/w5"), arrs["w5"])
        _, storage = snap._resources()
        storage.drain_in_flight()
        assert not storage.__dict__.get("_tracked_inflight")
        snap.close()

    def test_run_on_loop_drains_stranded_task(self):
        """A BaseException escaping run_until_complete does not leave the
        top-level task pending on the loop."""
        loop = asyncio.new_event_loop()
        state = {"cancelled": False}

        async def work():
            try:
                await asyncio.sleep(60)
            except asyncio.CancelledError:
                state["cancelled"] = True
                raise

        task = loop.create_task(work())

        def boom():
            raise KeyboardInterrupt

        loop.call_later(0.05, boom)
        with pytest.raises(KeyboardInterrupt):
            run_on_loop(loop, task)
        assert task.done() and state["cancelled"]
        assert loop.run_until_complete(asyncio.sleep(0, result=42)) == 42
        loop.close()


def test_write_atomic_durable_flag(tmp_path):
    """durable=True fsyncs the file and its parent directory and lands
    the same bytes as tpusnap's."""
    loop = asyncio.new_event_loop()
    plugin = FSStoragePlugin(str(tmp_path))
    fsyncs = []
    real_fsync = os.fsync
    try:
        plugin.sync_write_atomic(WriteIO(path="meta", buf=b"payload-1"), loop, durable=False)
        assert (tmp_path / "meta").read_bytes() == b"payload-1"
        with mock.patch("os.fsync", side_effect=lambda fd: (fsyncs.append(fd), real_fsync(fd))):
            plugin.sync_write_atomic(WriteIO(path="meta", buf=b"payload-2"), loop, durable=True)
        assert (tmp_path / "meta").read_bytes() == b"payload-2"
        assert len(fsyncs) == 2  # temp file + parent directory
        assert _jax_read(str(tmp_path), "meta") == b"payload-2"
    finally:
        plugin.sync_close(loop)
        loop.close()
