"""The cloud plugins of the port (tpusnap_torch/storage_plugins/s3.py,
gcs.py), held to tpusnap's tests/test_s3.py and tests/test_gcs.py with the
same fakes: an in-memory S3 client stub, and a local fake GCS HTTP server
with fault injection (resumable-upload chunking, short-Range resync,
no-progress and transient-500 retries, the collective deadline, chunked
ranged downloads), then whole snapshots of CPU tensors through ``gs://``:
in-place restores with the fused CRC, scrubs, incremental takes and
materialize. ``aiobotocore`` and ``google-auth`` are imported only at
first use and are absent here, as on the card's machine. Restores are
bit-exact (tolerance 0). The fake GCS server lives in
``tpusnap_torch/benchmarks/_fake_gcs.py``, beside the gcs_pipeline harness
that uses it; the harness's case (the mirror of
``tests/test_gcs.py::test_gcs_pipeline_benchmark_smoke``) is in
``tests/test_torch_benchmarks.py``.
"""

import asyncio
import io
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import tpusnap_torch.storage_plugins.gcs as gcs_mod
from tpusnap_torch.benchmarks._fake_gcs import FakeGCS, _make_handler
from tpusnap_torch.io_types import ReadIO, WriteIO
from tpusnap_torch.storage_plugins.gcs import GCSStoragePlugin
from tpusnap_torch.storage_plugins.s3 import S3StoragePlugin


# ------------------------------------------------------------------ S3


class _Body:
    def __init__(self, data: bytes):
        self._data = data

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        return False

    async def read(self):
        return self._data


class StubS3Client:
    def __init__(self):
        self.objects = {}
        self.calls = []

    async def put_object(self, Bucket, Key, Body):
        self.calls.append(("put", Bucket, Key))
        data = Body.read() if hasattr(Body, "read") else bytes(Body)
        self.objects[(Bucket, Key)] = bytes(data)

    async def get_object(self, Bucket, Key, Range=None):
        self.calls.append(("get", Bucket, Key, Range))
        data = self.objects[(Bucket, Key)]
        if Range is not None:
            assert Range.startswith("bytes=")
            lo, hi = Range[len("bytes=") :].split("-")
            data = data[int(lo) : int(hi) + 1]  # HTTP Range is inclusive
        return {"Body": _Body(data)}

    async def delete_object(self, Bucket, Key):
        self.calls.append(("delete", Bucket, Key))
        self.objects.pop((Bucket, Key), None)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.fixture()
def plugin():
    p = S3StoragePlugin("mybucket/some/prefix")
    p._client = StubS3Client()
    return p


def test_s3_construction_parses_root():
    p = S3StoragePlugin("bucket/deep/prefix")
    assert p.bucket == "bucket" and p.root == "deep/prefix"
    with pytest.raises(ValueError):
        S3StoragePlugin("bucketonly")


def test_s3_write_read_round_trip(plugin):
    payload = bytes(range(256)) * 10
    _run(plugin.write(WriteIO(path="rank0/w", buf=memoryview(payload))))
    assert plugin._client.objects[("mybucket", "some/prefix/rank0/w")] == payload
    read_io = ReadIO(path="rank0/w")
    _run(plugin.read(read_io))
    assert read_io.buf.getvalue() == payload


def test_s3_bytes_body(plugin):
    _run(plugin.write(WriteIO(path="b", buf=b"hello")))
    assert plugin._client.objects[("mybucket", "some/prefix/b")] == b"hello"


def test_s3_ranged_read_inclusive_header(plugin):
    payload = bytes(range(200))
    _run(plugin.write(WriteIO(path="r", buf=memoryview(payload))))
    read_io = ReadIO(path="r", byte_range=(10, 60))
    _run(plugin.read(read_io))
    assert read_io.buf.getvalue() == payload[10:60]
    get_call = [c for c in plugin._client.calls if c[0] == "get"][0]
    assert get_call[3] == "bytes=10-59"  # end-exclusive -> inclusive


def test_s3_delete(plugin):
    _run(plugin.write(WriteIO(path="d", buf=b"x")))
    _run(plugin.delete("d"))
    assert ("mybucket", "some/prefix/d") not in plugin._client.objects


def test_s3_in_place_read_with_fused_crc(plugin):
    """ReadIO.into lands the body directly in the destination with the
    checksum computed off-loop; consumers then verify a 4-byte value."""
    from tpusnap_torch import _native

    payload = bytes(range(256)) * 8
    _run(plugin.write(WriteIO(path="obj", buf=payload)))

    dst = np.zeros(len(payload), dtype=np.uint8)
    read_io = ReadIO(path="obj", into=memoryview(dst), want_crc=True)
    _run(plugin.read(read_io))
    assert read_io.in_place
    assert dst.tobytes() == payload
    assert read_io.crc32c == _native.crc32c(payload)
    assert read_io.crc_algo == _native.checksum_algorithm()
    assert bytes(read_io.buf.getbuffer()) == payload

    # byte-ranged in-place read
    dst2 = np.zeros(500, dtype=np.uint8)
    read_io = ReadIO(
        path="obj", byte_range=(100, 600), into=memoryview(dst2), want_crc=True
    )
    _run(plugin.read(read_io))
    assert dst2.tobytes() == payload[100:600]
    assert read_io.crc32c == _native.crc32c(payload[100:600])


def test_s3_in_place_size_mismatch_fails_loudly(plugin):
    """A truncated stored object must raise, not silently fall back to
    an unbudgeted full-size buffer."""
    _run(plugin.write(WriteIO(path="obj", buf=b"x" * 100)))
    dst = np.zeros(200, dtype=np.uint8)  # manifest said 200, object has 100
    read_io = ReadIO(path="obj", into=memoryview(dst), want_crc=True)
    with pytest.raises(IOError, match="truncated"):
        _run(plugin.read(read_io))


# ------------------------------------------------------------------ GCS


@pytest.fixture()
def fake_gcs():
    state = FakeGCS()
    server = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    state.endpoint = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        yield state
    finally:
        server.shutdown()
        thread.join(timeout=5)


def _plugin(state, **options):
    opts = {"api_endpoint": state.endpoint, "deadline_sec": 30.0}
    opts.update(options)
    return GCSStoragePlugin("bkt/prefix", storage_options=opts)


def test_gcs_round_trip_multi_chunk(fake_gcs, monkeypatch):
    monkeypatch.setattr(gcs_mod, "_UPLOAD_CHUNK_SIZE", 1000)
    plugin = _plugin(fake_gcs)
    payload = bytes(range(256)) * 20  # 5120 bytes -> 6 chunks
    _run(plugin.write(WriteIO(path="obj", buf=memoryview(payload))))
    assert fake_gcs.objects["prefix/obj"] == payload
    read_io = ReadIO(path="obj")
    _run(plugin.read(read_io))
    assert read_io.buf.getvalue() == payload
    _run(plugin.delete("obj"))
    assert "prefix/obj" not in fake_gcs.objects
    _run(plugin.close())


def test_gcs_empty_object(fake_gcs):
    plugin = _plugin(fake_gcs)
    _run(plugin.write(WriteIO(path="empty", buf=memoryview(b""))))
    assert fake_gcs.objects["prefix/empty"] == b""
    _run(plugin.close())


def test_gcs_short_range_forces_offset_resync(fake_gcs, monkeypatch):
    """A 308 persisting only part of a chunk: the client must accept the
    server's Range as authoritative and continue from there."""
    monkeypatch.setattr(gcs_mod, "_UPLOAD_CHUNK_SIZE", 1000)
    fake_gcs.faults.append({"kind": "chunk", "action": "short", "keep": 300})
    plugin = _plugin(fake_gcs)
    payload = bytes([i % 251 for i in range(3500)])
    _run(plugin.write(WriteIO(path="obj", buf=memoryview(payload))))
    assert fake_gcs.objects["prefix/obj"] == payload
    _run(plugin.close())


def test_gcs_http500_resyncs_via_probe(fake_gcs, monkeypatch):
    """Transient 500 mid-upload: retry must run the ``bytes */total``
    status probe and resume from the server's persisted offset."""
    monkeypatch.setattr(gcs_mod, "_UPLOAD_CHUNK_SIZE", 1000)
    fake_gcs.faults.append({"kind": "chunk", "action": "http500"})
    fake_gcs.faults.append({"kind": "chunk", "action": "http500"})
    plugin = _plugin(fake_gcs)
    payload = bytes([i % 241 for i in range(3500)])
    _run(plugin.write(WriteIO(path="obj", buf=memoryview(payload))))
    assert fake_gcs.objects["prefix/obj"] == payload
    probes = [
        r for r in fake_gcs.request_log if r[0] == "PUT" and r[2] and r[2].startswith("bytes */")
    ]
    assert probes, "500 recovery must consult the status probe"
    _run(plugin.close())


def test_gcs_no_progress_308_retries_then_succeeds(fake_gcs, monkeypatch):
    """A 308 with no Range header (nothing persisted) must count as a
    failed attempt — backoff, resync, then proceed."""
    monkeypatch.setattr(gcs_mod, "_UPLOAD_CHUNK_SIZE", 1000)
    fake_gcs.faults.append({"kind": "chunk", "action": "no_progress"})
    plugin = _plugin(fake_gcs)
    payload = bytes([i % 199 for i in range(2200)])
    _run(plugin.write(WriteIO(path="obj", buf=memoryview(payload))))
    assert fake_gcs.objects["prefix/obj"] == payload
    _run(plugin.close())


def test_gcs_collective_deadline_expiry_aborts(fake_gcs, monkeypatch):
    """A permanently wedged backend must abort once the collective
    deadline expires instead of retrying forever."""
    monkeypatch.setattr(gcs_mod, "_UPLOAD_CHUNK_SIZE", 1000)
    for _ in range(1000):
        fake_gcs.faults.append({"kind": "chunk", "action": "http500"})
    plugin = _plugin(fake_gcs, deadline_sec=1.5)
    payload = bytes(2000)
    with pytest.raises(Exception) as exc_info:
        _run(plugin.write(WriteIO(path="obj", buf=memoryview(payload))))
    assert "prefix/obj" not in fake_gcs.objects
    _run(plugin.close())


def test_gcs_chunked_ranged_download_reassembly(fake_gcs, monkeypatch):
    """Downloads larger than the chunk size are reassembled from multiple
    ranged GETs; explicit byte_range reads slice correctly."""
    monkeypatch.setattr(gcs_mod, "_DOWNLOAD_CHUNK_SIZE", 700)
    plugin = _plugin(fake_gcs)
    payload = bytes([i % 233 for i in range(5000)])
    fake_gcs.objects["prefix/obj"] = payload
    read_io = ReadIO(path="obj")
    _run(plugin.read(read_io))
    assert read_io.buf.getvalue() == payload
    media_gets = [r for r in fake_gcs.request_log if r[0] == "GET" and "alt=media" in r[1]]
    assert len(media_gets) >= 8  # 5000 / 700 -> 8 ranged chunks
    ranged = ReadIO(path="obj", byte_range=(123, 2600))
    _run(plugin.read(ranged))
    assert ranged.buf.getvalue() == payload[123:2600]
    _run(plugin.close())


def test_gcs_transient_download_500_retried(fake_gcs, monkeypatch):
    monkeypatch.setattr(gcs_mod, "_DOWNLOAD_CHUNK_SIZE", 700)
    fake_gcs.faults.append({"kind": "download", "action": "http500"})
    plugin = _plugin(fake_gcs)
    payload = bytes([i % 229 for i in range(2000)])
    fake_gcs.objects["prefix/obj"] = payload
    read_io = ReadIO(path="obj")
    _run(plugin.read(read_io))
    assert read_io.buf.getvalue() == payload
    _run(plugin.close())


def test_gcs_snapshot_end_to_end_against_fake_gcs(fake_gcs, monkeypatch):
    """Full Snapshot.take/restore through the gs:// scheme with faults."""
    from tpusnap_torch import Snapshot, StateDict

    monkeypatch.setattr(gcs_mod, "_UPLOAD_CHUNK_SIZE", 4096)
    monkeypatch.setenv("STORAGE_EMULATOR_HOST", fake_gcs.endpoint)
    fake_gcs.faults.append({"kind": "chunk", "action": "http500"})
    fake_gcs.faults.append({"kind": "chunk", "action": "short", "keep": 1000})
    state = StateDict(w=torch.arange(8192, dtype=torch.float32), step=7, name="run1")
    app_state = {"s": state}
    Snapshot.take("gs://bkt/snaps/s0", app_state)
    target = StateDict(w=torch.zeros(8192), step=0, name="")
    app2 = {"s": target}
    Snapshot("gs://bkt/snaps/s0").restore(app2)
    assert torch.equal(target["w"], state["w"])
    assert target["step"] == 7 and target["name"] == "run1"


def test_gcs_in_place_read_with_fused_crc(fake_gcs, monkeypatch):
    """ReadIO.into lands chunked downloads directly in the destination
    with the checksum accumulated chunk by chunk (the 7B-from-GCS
    restore path)."""
    from tpusnap_torch import _native

    monkeypatch.setattr(gcs_mod, "_DOWNLOAD_CHUNK_SIZE", 1024)
    plugin = _plugin(fake_gcs)
    payload = bytes(range(256)) * 17  # 4352 bytes -> 5 download chunks
    _run(plugin.write(WriteIO(path="obj", buf=memoryview(payload))))

    dst = np.zeros(len(payload), dtype=np.uint8)
    read_io = ReadIO(path="obj", into=memoryview(dst), want_crc=True)
    _run(plugin.read(read_io))
    assert read_io.in_place
    assert dst.tobytes() == payload
    assert read_io.crc32c == _native.crc32c(payload)
    assert read_io.crc_algo == _native.checksum_algorithm()
    # generic buf view still works
    assert bytes(read_io.buf.getbuffer()) == payload

    # byte-ranged in-place read
    dst2 = np.zeros(2000, dtype=np.uint8)
    read_io = ReadIO(
        path="obj", byte_range=(100, 2100), into=memoryview(dst2), want_crc=True
    )
    _run(plugin.read(read_io))
    assert dst2.tobytes() == payload[100:2100]
    assert read_io.crc32c == _native.crc32c(payload[100:2100])
    _run(plugin.close())


def test_gcs_in_place_restore_end_to_end_gcs(fake_gcs, monkeypatch):
    """Snapshot restore through gs:// uses in-place reads for numpy
    targets; corruption in the bucket is detected."""
    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch._native import ChecksumError

    monkeypatch.setenv("STORAGE_EMULATOR_HOST", fake_gcs.endpoint)
    arr = torch.from_numpy(
        np.random.default_rng(0).standard_normal(50_000).astype(np.float32)
    )
    Snapshot.take("gs://bkt/snaps/ip", {"s": StateDict(w=arr.clone())})
    target_arr = torch.zeros_like(arr)
    Snapshot("gs://bkt/snaps/ip").restore({"s": StateDict(w=target_arr)})
    assert torch.equal(target_arr, arr)

    # flip one byte of the stored blob in the bucket
    for name, blob in list(fake_gcs.objects.items()):
        if name.endswith("s/w") or "batched" in name:
            mutated = bytearray(blob)
            mutated[64] ^= 0xFF
            fake_gcs.objects[name] = bytes(mutated)
            break
    else:
        raise AssertionError(f"blob not found in {list(fake_gcs.objects)}")
    with pytest.raises(ChecksumError, match="w"):
        Snapshot("gs://bkt/snaps/ip").restore(
            {"s": StateDict(w=torch.zeros_like(arr))}
        )


def test_gcs_scrub_verifies_and_detects_through_gcs(fake_gcs, monkeypatch):
    """verify_snapshot through gs:// exercises the non-in-place verify
    branch (the plugin fills ReadIO.buf; no fused read CRC), and must
    detect server-side bit rot."""
    from tpusnap_torch import Snapshot, StateDict, verify_snapshot

    monkeypatch.setenv("STORAGE_EMULATOR_HOST", fake_gcs.endpoint)
    state = StateDict(w=torch.arange(8192, dtype=torch.float32), step=7)
    Snapshot.take("gs://bkt/snaps/scrub", {"s": state})
    opts = {"api_endpoint": fake_gcs.endpoint, "deadline_sec": 30.0}
    report = verify_snapshot("gs://bkt/snaps/scrub", storage_options=opts)
    assert report.clean and report.ok > 0

    # Flip a byte inside a stored blob on the "server".
    blob_names = [
        k for k in fake_gcs.objects if not k.endswith(".snapshot_metadata")
    ]
    assert blob_names
    name = max(blob_names, key=lambda k: len(fake_gcs.objects[k]))
    data = bytearray(fake_gcs.objects[name])
    data[10] ^= 0xFF
    fake_gcs.objects[name] = bytes(data)
    report = verify_snapshot("gs://bkt/snaps/scrub", storage_options=opts)
    assert not report.clean
    assert report.corrupt >= 1


def test_gcs_incremental_snapshot_through_gcs(fake_gcs, monkeypatch):
    """Cross-snapshot '../base/...' references resolve through the gs://
    key namespace (client-side normpath in _object_name)."""
    from tpusnap_torch import Snapshot, StateDict, verify_snapshot
    from tpusnap_torch.knobs import override_batching_disabled

    monkeypatch.setenv("STORAGE_EMULATOR_HOST", fake_gcs.endpoint)
    opts = {"api_endpoint": fake_gcs.endpoint, "deadline_sec": 30.0}
    state = StateDict(w=torch.arange(8192, dtype=torch.float32), step=1)
    with override_batching_disabled(True):
        Snapshot.take("gs://bkt/snaps/s0", {"s": state})
        n_before = len(fake_gcs.objects)
        Snapshot.take(
            "gs://bkt/snaps/s1",
            {"s": state},
            incremental_from="gs://bkt/snaps/s0",
        )
    # Only s1's metadata (plus the telemetry sidecar) was uploaded; w
    # deduped against s0's blob — no payload bytes moved.
    new = {
        k
        for k in fake_gcs.objects
        if "snaps/s1" in k and ".tpusnap/" not in k
    }
    assert new == {"snaps/s1/.snapshot_metadata"}, new
    n_sidecars = sum(
        1 for k in fake_gcs.objects if "snaps/s1" in k and ".tpusnap/" in k
    )
    assert len(fake_gcs.objects) == n_before + 1 + n_sidecars
    target = StateDict(w=torch.zeros(8192), step=0)
    Snapshot("gs://bkt/snaps/s1", storage_options=opts).restore({"s": target})
    assert torch.equal(target["w"], state["w"]) and target["step"] == 1
    assert verify_snapshot("gs://bkt/snaps/s1", storage_options=opts).clean


def test_gcs_materialize_through_gcs(fake_gcs, monkeypatch):
    """materialize copies base blobs within the gs:// namespace and
    rewrites the manifest; the base can then be deleted server-side."""
    from tpusnap_torch import Snapshot, StateDict, verify_snapshot
    from tpusnap_torch.inspect import materialize_snapshot
    from tpusnap_torch.knobs import override_batching_disabled

    monkeypatch.setenv("STORAGE_EMULATOR_HOST", fake_gcs.endpoint)
    opts = {"api_endpoint": fake_gcs.endpoint, "deadline_sec": 30.0}
    state = StateDict(w=torch.arange(8192, dtype=torch.float32), step=1)
    with override_batching_disabled(True):
        Snapshot.take("gs://bkt/snaps/m0", {"s": state})
        Snapshot.take(
            "gs://bkt/snaps/m1",
            {"s": state},
            incremental_from="gs://bkt/snaps/m0",
        )
    stats = materialize_snapshot("gs://bkt/snaps/m1", storage_options=opts)
    assert stats["blobs_copied"] == 1
    # Delete the base server-side; the materialized snapshot stands alone.
    for k in list(fake_gcs.objects):
        if "snaps/m0" in k:
            del fake_gcs.objects[k]
    assert verify_snapshot("gs://bkt/snaps/m1", storage_options=opts).clean
    target = StateDict(w=torch.zeros(8192), step=0)
    Snapshot("gs://bkt/snaps/m1", storage_options=opts).restore({"s": target})
    assert torch.equal(target["w"], state["w"]) and target["step"] == 1
