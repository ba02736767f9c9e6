"""tpusnap_torch fused tile compression (``TPUSNAP_COMPRESS``) and
save-time transforms (``cast_on_save``), against tpusnap on the same
numpy inputs. Ports of the single-process cases of tests/test_compress.py
with torch tensors (the crash-salvage, tiering and telemetry cases wait
for their slices), and cross-package checks: the same input and tile
geometry give the same compressed blob bytes and manifest entries in both
packages, each restores the other's, and ``cast_on_save`` stores the same
bf16 bytes. Everything is bit-exact (tolerance 0): nothing is computed
but the cast, and both packages round it to nearest even.
"""

import asyncio
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusnap
from tpusnap.transforms import cast_on_save as jax_cast_on_save
from tpusnap_torch import Snapshot, StateDict, cast_on_save, verify_snapshot
from tpusnap_torch import _native
from tpusnap_torch import compress as compress_mod
from tpusnap_torch.io_preparers.array import ArrayBufferStager, ArrayIOPreparer
from tpusnap_torch.io_types import Future, WriteReq
from tpusnap_torch.knobs import (
    get_compress_mode,
    override_batching_disabled,
    override_compress,
    override_max_chunk_size_bytes,
    override_memory_budget_bytes,
    override_record_dedup_hashes,
    override_tile_checksum_bytes,
)
from tpusnap_torch.manifest import ChunkedTensorEntry, TensorEntry

torch.set_num_threads(1)


def _bf16ish(shape, seed=0) -> np.ndarray:
    """f32 values of bf16 precision (low mantissa bytes zero): the shape
    of data the codec targets."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (a.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.copy())


def _blob_files(root):
    out = []
    for dirpath, _, files in os.walk(root):
        if ".tpusnap" in dirpath.split(os.sep):
            continue
        out += [
            os.path.relpath(os.path.join(dirpath, f), root)
            for f in files
            if f != ".snapshot_metadata"
        ]
    return sorted(out)


def _payload_bytes(root):
    return sum(os.path.getsize(os.path.join(root, f)) for f in _blob_files(root))


def _manifest(path):
    return json.load(open(os.path.join(path, ".snapshot_metadata")))["manifest"]


@pytest.fixture(autouse=True)
def _fresh_policy_state():
    compress_mod._reset_ceilings()
    yield
    compress_mod._reset_ceilings()
    compress_mod.LAST_DECISION = None


def _forced():
    return override_compress(mode="on", min_blob_bytes=65536)


# ------------------------------------------------------------ native codec


@pytest.mark.parametrize("dtype,elem", [(np.float32, 4), (np.float16, 2), (np.int8, 1), (np.float64, 8)])
def test_tile_roundtrip_across_dtypes(dtype, elem):
    rng = np.random.default_rng(11)
    if dtype is np.int8:
        arr = rng.integers(-8, 8, 300_001).astype(dtype)
    else:
        arr = rng.standard_normal(300_001).astype(dtype)
    buf = arr.tobytes()
    tile = 1 << 16
    out, sizes, crcs, xxhs = _native.compress_tiles(buf, tile, elem, True)
    assert sum(sizes) == out.nbytes
    assert len(sizes) == len(crcs) == len(xxhs) == (len(buf) + tile - 1) // tile
    off = 0
    for i, s in enumerate(sizes):
        assert _native.crc32c(bytes(out[off : off + s])) == crcs[i]
        off += s
    dec = bytearray(len(buf))
    _native.decompress_tiles(out, sizes, tile, len(buf), elem, dec)
    assert bytes(dec) == buf


def test_incompressible_tiles_stored_raw():
    buf = np.random.default_rng(1).integers(0, 255, 1 << 18, dtype=np.uint8).tobytes()
    tile = 1 << 16
    out, sizes, _, _ = _native.compress_tiles(buf, tile, 1, False)
    assert out.nbytes == len(buf) and all(s == tile for s in sizes)
    dec = bytearray(len(buf))
    _native.decompress_tiles(out, sizes, tile, len(buf), 1, dec)
    assert bytes(dec) == buf


def test_codec_is_deterministic():
    buf = _bf16ish((512, 128)).tobytes()
    a, sa, ca, xa = _native.compress_tiles(buf, 1 << 16, 4, True, nthreads=4)
    b, sb, cb, xb = _native.compress_tiles(buf, 1 << 16, 4, True, nthreads=1)
    assert bytes(a) == bytes(b) and sa == sb and ca == cb and xa == xb


def test_codec_bytes_equal_tpusnap():
    """Both packages compile the same C++ codec: equal input and tile
    size give equal stored bytes, sizes and hashes."""
    from tpusnap import _native as jax_native

    buf = _bf16ish((300, 77), seed=3).tobytes()
    port = _native.compress_tiles(buf, 1 << 14, 4, True)
    ref = jax_native.compress_tiles(buf, 1 << 14, 4, True)
    assert bytes(port[0]) == bytes(ref[0]) and port[1:] == ref[1:]
    assert _native.lz4_compress(buf, 4) == jax_native.lz4_compress(buf, 4)


def test_python_fallback_decode_matches_native():
    buf = _bf16ish((300, 77), seed=5).tobytes()
    tile = 1 << 14
    out, sizes, _, _ = _native.compress_tiles(buf, tile, 4, False)
    dec = bytearray(len(buf))
    _native._py_decompress_tiles(memoryview(bytes(out)), sizes, tile, len(buf), 4, memoryview(dec))
    assert bytes(dec) == buf
    block = _native.lz4_compress(buf, 4)
    assert _native.lz4_decompress(block, len(buf), 4) == buf
    assert _native._py_unshuffle(_native._py_lz4_decompress_block(memoryview(block), len(buf)), 4) == buf


@pytest.mark.parametrize("decoder", ["native", "python"])
def test_malformed_compressed_input_raises_cleanly(decoder):
    buf = _bf16ish((256, 64)).tobytes()
    out, sizes, _, _ = _native.compress_tiles(buf, len(buf), 4, False)
    assert out.nbytes < len(buf)

    def dec(src, szs):
        o = bytearray(len(buf))
        if decoder == "native":
            _native.decompress_tiles(src, szs, len(buf), len(buf), 4, o)
        else:
            _native._py_decompress_tiles(memoryview(bytes(src)), szs, len(buf), len(buf), 4, memoryview(o))

    with pytest.raises(_native.CompressionError):
        dec(out[: out.nbytes // 2], [out.nbytes // 2])
    with pytest.raises(_native.CompressionError):
        dec(np.frombuffer(os.urandom(out.nbytes), dtype=np.uint8), sizes)
    with pytest.raises(_native.CompressionError):
        dec(out, [out.nbytes + 7])


# ------------------------------------------------------------- policy units


def test_codec_for_dtype_mapping():
    assert compress_mod.codec_for_dtype("float32") == "shuf4+lz4"
    assert compress_mod.codec_for_dtype("bfloat16") == "shuf2+lz4"
    assert compress_mod.codec_for_dtype("float16") == "shuf2+lz4"
    assert compress_mod.codec_for_dtype("float64") == "shuf8+lz4"
    assert compress_mod.codec_for_dtype("int8") == "lz4"
    assert compress_mod.codec_for_dtype("no_such_dtype") is None
    assert compress_mod.codec_elem("shuf4+lz4") == 4
    assert compress_mod.codec_elem("lz4") == 1
    with pytest.raises(ValueError, match="newer"):
        compress_mod.codec_elem("zstd19")


def _mk_reqs(nbytes=1 << 20, dtype=torch.float32):
    t = torch.zeros(nbytes // dtype.itemsize, dtype=dtype)
    entry = TensorEntry(
        location="0/w", serializer="buffer_protocol", dtype="float32",
        shape=list(t.shape), replicated=False,
    )
    stager = ArrayBufferStager(t, entry=entry)
    return [WriteReq(path="0/w", buffer_stager=stager)], stager


def test_auto_policy_decision_matrix(monkeypatch):
    monkeypatch.setattr(compress_mod, "codec_throughput_gbps", lambda: 2.0)
    monkeypatch.setattr(compress_mod, "AUTO_MIN_TAKE_BYTES", 1 << 18)
    auto = lambda: override_compress(mode="auto", min_blob_bytes=65536)  # noqa: E731
    monkeypatch.setattr(compress_mod, "pipe_ceiling", lambda label: 10.0)
    reqs, st = _mk_reqs()
    with auto():
        d = compress_mod.apply_take_policy(reqs, None, None)
    assert (d.compress, d.reason) == (False, "pipe_outruns_codec") and st.compress_codec is None
    monkeypatch.setattr(compress_mod, "pipe_ceiling", lambda label: 0.2)
    reqs, st = _mk_reqs()
    with auto():
        d = compress_mod.apply_take_policy(reqs, None, None)
    assert (d.compress, d.reason) == (True, "codec_outruns_pipe")
    assert st.compress_codec == "shuf4+lz4"
    assert d.pipe_gbps == 0.2 and d.codec_gbps == 2.0
    monkeypatch.setattr(compress_mod, "pipe_ceiling", lambda label: 1.8)
    reqs, st = _mk_reqs()
    with auto():
        assert not compress_mod.apply_take_policy(reqs, None, None).compress
    reqs, st = _mk_reqs(nbytes=1 << 17)
    with auto():
        d = compress_mod.apply_take_policy(reqs, None, None)
    assert (d.compress, d.reason) == (False, "below_auto_floor")


def test_forced_modes_and_eligibility(monkeypatch):
    monkeypatch.setattr(compress_mod, "codec_throughput_gbps", lambda: 2.0)
    reqs, st = _mk_reqs()
    with override_compress(mode="off"):
        d = compress_mod.apply_take_policy(reqs, None, None)
    assert (d.compress, d.reason) == (False, "mode_off")
    reqs, st = _mk_reqs()
    with _forced():
        d = compress_mod.apply_take_policy(reqs, None, None)
    assert (d.compress, d.reason) == (True, "mode_forced")
    assert st.get_staging_cost_bytes() == 2 * st.get_planned_bytes()
    reqs, st = _mk_reqs(nbytes=1 << 17)
    with override_compress(mode="on", min_blob_bytes=1 << 20):
        d = compress_mod.apply_take_policy(reqs, None, None)
    assert (d.compress, d.reason) == (False, "no_eligible_blobs")


def test_policy_mini_probe_measures_and_cleans_up(tmp_path, monkeypatch):
    from tpusnap_torch.storage_plugin import url_to_storage_plugin_in_event_loop

    monkeypatch.setattr(compress_mod, "AUTO_MIN_TAKE_BYTES", 1 << 18)
    loop = asyncio.new_event_loop()
    storage = url_to_storage_plugin_in_event_loop(str(tmp_path), loop)
    try:
        label = compress_mod.pipe_ceiling_key(storage)
        assert label.startswith("FSStoragePlugin@")
        assert compress_mod.pipe_ceiling(label) is None
        reqs, _ = _mk_reqs()
        with override_compress(mode="auto", min_blob_bytes=65536):
            d = compress_mod.apply_take_policy(reqs, storage, loop)
        assert d.reason in ("codec_outruns_pipe", "pipe_outruns_codec")
        assert d.pipe_gbps and d.pipe_gbps > 0
        assert compress_mod.pipe_ceiling(label) == pytest.approx(d.pipe_gbps, rel=1e-3)
        probe_dir = tmp_path / ".tpusnap" / "probe"
        assert not probe_dir.exists() or os.listdir(probe_dir) == []
    finally:
        storage.sync_close(loop)
        loop.close()


def test_unknown_mode_warns_and_falls_back(monkeypatch):
    monkeypatch.setenv("TPUSNAP_COMPRESS", "zstd-max")
    assert get_compress_mode() == "auto"


# ----------------------------------------------------------- end to end


def test_take_scrub_restore_roundtrip(tmp_path):
    a = _bf16ish((2048, 256))
    b = np.random.default_rng(2).integers(-4, 4, (512, 512)).astype(np.int8)
    path = str(tmp_path / "snap")
    with _forced(), override_batching_disabled(True):
        snap = Snapshot.take(path, {"app": StateDict(w=_t(a), q=_t(b))})
    d = compress_mod.LAST_DECISION
    assert d is not None and d.compress and d.mode == "on"
    assert _payload_bytes(path) < (a.nbytes + b.nbytes) * 0.8
    md = Snapshot(path).metadata
    entry = md.manifest["0/app/w"]
    assert entry.codec == "shuf4+lz4" and entry.uncompressed_nbytes == a.nbytes
    assert sum(entry.comp_tile_sizes) == os.path.getsize(os.path.join(path, "0/app/w"))
    assert md.manifest["0/app/q"].codec == "lz4"
    rep = snap.verify()
    assert rep.clean and rep.ok > 0
    w, q = torch.zeros(2048, 256), torch.zeros(512, 512, dtype=torch.int8)
    Snapshot(path).restore({"app": StateDict(w=w, q=q)})
    assert w.numpy().tobytes() == a.tobytes() and q.numpy().tobytes() == b.tobytes()


def test_tiled_budget_restore_and_read_object(tmp_path):
    a = _bf16ish((4096, 64), seed=9)  # 1 MiB, 16 tiles of 64 KiB raw
    path = str(tmp_path / "snap")
    with _forced(), override_batching_disabled(True), override_tile_checksum_bytes(1 << 16):
        Snapshot.take(path, {"app": StateDict(w=_t(a))})
    entry = Snapshot(path).metadata.manifest["0/app/w"]
    assert entry.codec and len(entry.comp_tile_sizes) == 16 == len(entry.tile_checksums)
    reqs, _ = ArrayIOPreparer.prepare_read(entry, None, 1 << 17)
    assert len(reqs) == 8  # two 64 KiB tiles per group under 128 KiB
    got = Snapshot(path).read_object("0/app/w", memory_budget_bytes=1 << 17)
    assert got.numpy().tobytes() == a.tobytes()
    w = torch.zeros(4096, 64)
    with override_memory_budget_bytes(1 << 17):
        Snapshot(path).restore({"app": StateDict(w=w)})
    assert w.numpy().tobytes() == a.tobytes()


def test_truncated_comp_tile_sizes_refused(tmp_path):
    a = _bf16ish((4096, 64), seed=5)
    path = str(tmp_path / "snap")
    with _forced(), override_batching_disabled(True), override_tile_checksum_bytes(1 << 16):
        Snapshot.take(path, {"app": StateDict(w=_t(a))})
    entry = Snapshot(path).metadata.manifest["0/app/w"]
    entry.comp_tile_sizes = entry.comp_tile_sizes[:-2]
    with pytest.raises(IOError, match="spans 16"):
        ArrayIOPreparer._prepare_compressed_read(entry, None, None, Future())


def test_bitrot_in_compressed_tile_caught_and_named(tmp_path):
    a = _bf16ish((4096, 64), seed=3)
    path = str(tmp_path / "snap")
    with _forced(), override_batching_disabled(True), override_tile_checksum_bytes(1 << 16):
        Snapshot.take(path, {"app": StateDict(w=_t(a))})
    blob = os.path.join(path, "0/app/w")
    with open(blob, "r+b") as f:
        f.seek(os.path.getsize(blob) // 2)
        c = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([c[0] ^ 0xFF]))
    rep = verify_snapshot(path)
    assert not rep.clean and rep.corrupt == 1
    assert "comp tile" in rep.failures[0].detail
    with pytest.raises(Exception, match="hecksum|orrupt"):
        Snapshot(path).restore({"app": StateDict(w=torch.zeros(4096, 64))})


def test_compression_off_snapshot_roundtrips_without_codec_fields(tmp_path):
    a = _bf16ish((1024, 256), seed=7)
    path = str(tmp_path / "snap")
    with override_compress(mode="off"), override_batching_disabled(True):
        Snapshot.take(path, {"app": StateDict(w=_t(a))})
    assert compress_mod.LAST_DECISION.reason == "mode_off"
    raw = open(os.path.join(path, ".snapshot_metadata"), "rb").read()
    assert b'"codec"' not in raw and b"comp_tile_sizes" not in raw
    assert _payload_bytes(path) == a.nbytes
    w = torch.zeros(1024, 256)
    Snapshot(path).restore({"app": StateDict(w=w)})
    assert w.numpy().tobytes() == a.tobytes()
    assert verify_snapshot(path).clean


def test_chunked_array_compresses_per_chunk(tmp_path):
    a = _bf16ish((4096, 64), seed=4)
    path = str(tmp_path / "snap")
    with _forced(), override_batching_disabled(True), override_max_chunk_size_bytes(1 << 18):
        Snapshot.take(path, {"app": StateDict(w=_t(a))})
    entry = Snapshot(path).metadata.manifest["0/app/w"]
    assert isinstance(entry, ChunkedTensorEntry) and len(entry.chunks) == 4
    assert all(c.tensor.codec == "shuf4+lz4" for c in entry.chunks)
    assert _payload_bytes(path) < a.nbytes * 0.8
    assert verify_snapshot(path).clean
    w = torch.zeros(4096, 64)
    Snapshot(path).restore({"app": StateDict(w=w)})
    assert w.numpy().tobytes() == a.tobytes()
    out = Snapshot(path).read_object("0/app/w", memory_budget_bytes=1 << 16)
    assert out.numpy().tobytes() == a.tobytes()


def test_async_take_compressed_skips_cow_and_clone(tmp_path):
    a = _t(_bf16ish((2048, 256), seed=6))
    orig = a.clone()
    path = str(tmp_path / "snap")
    with _forced(), override_batching_disabled(True):
        pending = Snapshot.async_take(path, {"app": StateDict(w=a)})
        # The compressed blob is fresh memory: no COW, no clone.
        assert not pending._live_until_drained
        assert pending.wait_staged(timeout=60)
        a[:] = -1.0
        pending.wait()
    w = torch.zeros(2048, 256)
    Snapshot(path).restore({"app": StateDict(w=w)})
    assert torch.equal(w, orig)


def test_incremental_dedup_over_compressed_bytes(tmp_path):
    a, b = _bf16ish((1024, 256), seed=8), _bf16ish((1024, 256), seed=9)
    base, inc, inc2 = (str(tmp_path / f"s{i}") for i in range(3))
    with _forced(), override_batching_disabled(True), override_record_dedup_hashes(True):
        Snapshot.take(base, {"app": StateDict(x=_t(a), y=_t(b))})
        Snapshot.take(inc, {"app": StateDict(x=_t(a), y=_t(b))}, incremental_from=base)
        assert _blob_files(inc) == []
        b2 = b.copy()
        b2[0, 0] += 1.0
        Snapshot.take(inc2, {"app": StateDict(x=_t(a), y=_t(b2))}, incremental_from=inc)
    assert _blob_files(inc2) == ["0/app/y"]
    assert Snapshot(inc2).metadata.manifest["0/app/x"].location.startswith("../")
    x, y = torch.zeros(1024, 256), torch.zeros(1024, 256)
    Snapshot(inc2).restore({"app": StateDict(x=x, y=y)})
    assert x.numpy().tobytes() == a.tobytes() and y.numpy().tobytes() == b2.tobytes()
    raw_base, c_inc = str(tmp_path / "r0"), str(tmp_path / "r1")
    with override_batching_disabled(True), override_record_dedup_hashes(True):
        with override_compress(mode="off"):
            Snapshot.take(raw_base, {"app": StateDict(x=_t(a))})
        with _forced():
            Snapshot.take(c_inc, {"app": StateDict(x=_t(a))}, incremental_from=raw_base)
    assert _blob_files(c_inc) == ["0/app/x"]  # the codec is part of the identity
    assert verify_snapshot(c_inc).clean


def test_unchanged_compressed_blob_skips_the_codec_pass(tmp_path, monkeypatch):
    a = _bf16ish((1024, 256), seed=12)
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    calls = []
    real = _native.compress_tiles
    monkeypatch.setattr(_native, "compress_tiles", lambda *a, **k: calls.append(1) or real(*a, **k))
    with _forced(), override_batching_disabled(True), override_record_dedup_hashes(True):
        Snapshot.take(base, {"app": StateDict(x=_t(a))})
        assert Snapshot(base).metadata.manifest["0/app/x"].uncompressed_dedup_hash
        assert len(calls) == 1
        Snapshot.take(inc, {"app": StateDict(x=_t(a))}, incremental_from=base)
    assert _blob_files(inc) == [] and len(calls) == 1  # a hash pass, no codec pass
    e = Snapshot(inc).metadata.manifest["0/app/x"]
    assert e.codec and e.comp_tile_sizes and e.uncompressed_dedup_hash
    x = torch.zeros(1024, 256)
    Snapshot(inc).restore({"app": StateDict(x=x)})
    assert x.numpy().tobytes() == a.tobytes()


def test_materialize_carries_compressed_blobs(tmp_path):
    import shutil

    a = _bf16ish((1024, 256), seed=12)
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    with _forced(), override_batching_disabled(True), override_record_dedup_hashes(True):
        Snapshot.take(base, {"app": StateDict(x=_t(a))})
        Snapshot.take(inc, {"app": StateDict(x=_t(a))}, incremental_from=base)
    assert _blob_files(inc) == []
    assert Snapshot(inc).materialize()["blobs_copied"] == 1
    shutil.rmtree(base)
    assert verify_snapshot(inc).clean
    x = torch.zeros(1024, 256)
    Snapshot(inc).restore({"app": StateDict(x=x)})
    assert x.numpy().tobytes() == a.tobytes()
    assert Snapshot(inc).metadata.manifest["0/app/x"].codec == "shuf4+lz4"


def test_restore_under_disabled_native_decodes_compressed(tmp_path):
    a = _bf16ish((512, 64), seed=15)
    path = str(tmp_path / "snap")
    with _forced(), override_batching_disabled(True):
        Snapshot.take(path, {"app": StateDict(w=_t(a))})
    assert Snapshot(path).metadata.manifest["0/app/w"].codec
    child = r"""
import sys, numpy as np, torch
from tpusnap_torch import Snapshot, StateDict
w = torch.zeros(512, 64)
Snapshot(sys.argv[1]).restore({"app": StateDict(w=w)})
np.save(sys.argv[2], w.numpy())
"""
    out_npy = str(tmp_path / "restored.npy")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", child, path, out_npy],
        env=dict(os.environ, TPUSNAP_DISABLE_NATIVE="1", PYTHONPATH=repo),
        capture_output=True, text=True, timeout=300, cwd=repo,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert np.load(out_npy).tobytes() == a.tobytes()


# ------------------------------------------------------------ cross-package


def test_compressed_blobs_equal_tpusnap_and_restore_both_ways(tmp_path):
    a = _bf16ish((2048, 256), seed=21)
    h = _bf16ish((512, 1024), seed=22).astype(jnp.bfloat16)
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    with _forced(), override_batching_disabled(True), override_tile_checksum_bytes(1 << 18):
        Snapshot.take(port, {"m": StateDict(w=_t(a), h=_t(np.asarray(h).view(np.uint16)).view(torch.bfloat16))})
        tpusnap.Snapshot.take(ref, {"m": tpusnap.StateDict(w=jnp.asarray(a), h=jnp.asarray(h))})
    mp, mj = _manifest(port), _manifest(ref)
    for k in ("0/m/w", "0/m/h"):
        assert mp[k] == mj[k], k
        assert mp[k]["codec"] and mp[k]["checksum"].startswith("crc32c:")
        assert mp[k]["tile_checksums"]
        assert open(os.path.join(port, mp[k]["location"]), "rb").read() == open(
            os.path.join(ref, mj[k]["location"]), "rb"
        ).read()
    w, hh = torch.zeros(2048, 256), torch.zeros(512, 1024, dtype=torch.bfloat16)
    Snapshot(ref).restore({"m": StateDict(w=w, h=hh)})
    assert w.numpy().tobytes() == a.tobytes()
    assert hh.view(torch.uint16).numpy().tobytes() == np.asarray(h).tobytes()
    got = tpusnap.Snapshot(port).read_object("0/m/w", memory_budget_bytes=1 << 18)
    assert np.asarray(got).tobytes() == a.tobytes()
    assert tpusnap.verify_snapshot(port).clean and verify_snapshot(ref).clean


def test_cast_on_save_bytes_equal_tpusnap(tmp_path):
    rng = np.random.default_rng(31)
    w = rng.standard_normal((64, 32)).astype(np.float32) * 3.0  # finite values
    b = rng.standard_normal((32,)).astype(np.float32)
    keep = rng.standard_normal((8,)).astype(np.float32)
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    globs = "m/params/*"
    with override_batching_disabled(True):
        Snapshot.take(
            port,
            {"m": StateDict(params={"w": _t(w), "b": _t(b)}, keep=_t(keep))},
            _custom_array_prepare_func=cast_on_save({globs: torch.bfloat16}),
        )
        tpusnap.Snapshot.take(
            ref,
            {"m": tpusnap.StateDict(params={"w": jnp.asarray(w), "b": jnp.asarray(b)}, keep=jnp.asarray(keep))},
            _custom_array_prepare_func=jax_cast_on_save({globs: jnp.bfloat16}),
        )
    mp, mj = _manifest(port), _manifest(ref)
    for k in ("0/m/params/w", "0/m/params/b", "0/m/keep"):
        assert mp[k] == mj[k], k
        loc = mp[k]["location"]
        assert open(os.path.join(port, loc), "rb").read() == open(os.path.join(ref, loc), "rb").read()
    assert mp["0/m/params/w"]["dtype"] == "bfloat16" and mp["0/m/keep"]["dtype"] == "float32"
    # The restore into full-precision targets upcasts in place.
    tw, tb = torch.zeros(64, 32), torch.zeros(32)
    Snapshot(ref).restore({"m": StateDict(params={"w": tw, "b": tb}, keep=torch.zeros(8))})
    assert torch.equal(tw, _t(w).to(torch.bfloat16).float())
    assert torch.equal(tb, _t(b).to(torch.bfloat16).float())


def test_cast_on_save_with_slabs_chunks_and_async(tmp_path):
    """With batching on every small tensor goes through a host slab (the
    transform runs in each member's staging); a chunked tensor is cast per
    chunk; an async take casts at stage time."""
    rng = np.random.default_rng(41)
    small = {f"s{i}": _t(rng.standard_normal((16,)).astype(np.float32)) for i in range(3)}
    big = _t(rng.standard_normal((64, 16)).astype(np.float32))
    fn = cast_on_save({"m/*": torch.bfloat16})
    for mode in ("sync", "async"):
        path = str(tmp_path / mode)
        state = {"m": StateDict(big=big, **small)}
        with override_max_chunk_size_bytes(1024):
            if mode == "sync":
                snap = Snapshot.take(path, state, _custom_array_prepare_func=fn)
            else:
                snap = Snapshot.async_take(path, state, _custom_array_prepare_func=fn).wait()
        md = snap.metadata.manifest
        assert isinstance(md["0/m/big"], ChunkedTensorEntry) and md["0/m/big"].dtype == "bfloat16"
        assert all(md[f"0/m/s{i}"].location.startswith("batched/") for i in range(3))
        out = {k: torch.zeros_like(v) for k, v in small.items()}
        tbig = torch.zeros_like(big)
        Snapshot(path).restore({"m": StateDict(big=tbig, **out)})
        assert torch.equal(tbig, big.to(torch.bfloat16).float())
        for k, v in small.items():
            assert torch.equal(out[k], v.to(torch.bfloat16).float()), k
        assert verify_snapshot(path).clean


def test_transform_must_keep_shape_and_be_deterministic(tmp_path):
    t = torch.ones(4, 4)
    with pytest.raises(RuntimeError, match="shape"):
        Snapshot.take(str(tmp_path / "a"), {"m": StateDict(t=t)},
                      _custom_array_prepare_func=lambda p, x, tracing: x.reshape(16))
    calls = []

    def flaky(path, x, tracing):
        calls.append(tracing)
        return x.to(torch.float16) if tracing else x.to(torch.bfloat16)

    with pytest.raises(RuntimeError, match="deterministic"):
        Snapshot.take(str(tmp_path / "b"), {"m": StateDict(t=t)}, _custom_array_prepare_func=flaky)
    assert not os.path.exists(str(tmp_path / "b" / ".snapshot_metadata"))
