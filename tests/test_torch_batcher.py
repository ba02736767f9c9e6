"""The port's batcher against tpusnap's: the batcher cases of
tests/test_partitioner_batcher.py (slabs packed, the slab threshold,
read spans merged, sparse spans left alone, the batching-off knob), each
fed the same numpy inputs as tpusnap's batcher (torch tensors on the
port's side) and held to the same plan: requests, member byte ranges and
slab bytes equal. The device-slab cases run on the card
(``tests/test_torch_cuda.py``: ``-k device_slab``).
"""

import asyncio

import numpy as np
import pytest
import torch

from tpusnap import batcher as jax_batcher
from tpusnap.io_preparers.array import ArrayIOPreparer as JaxArrayIOPreparer
from tpusnap.io_types import BufferConsumer as JaxBufferConsumer
from tpusnap.io_types import ReadReq as JaxReadReq
from tpusnap.knobs import override_batching_disabled as jax_override_batching_disabled
from tpusnap.knobs import override_slab_size_threshold_bytes as jax_override_threshold
from tpusnap_torch.batcher import BatchedBufferStager, batch_read_requests, batch_write_requests
from tpusnap_torch.io_preparers.array import ArrayIOPreparer
from tpusnap_torch.io_types import BufferConsumer, ReadReq
from tpusnap_torch.knobs import override_batching_disabled, override_slab_size_threshold_bytes


def _arrays(n: int, nbytes: int = 100) -> dict:
    """``n`` uint8 arrays of ``nbytes``, from one seeded draw."""
    rng = np.random.default_rng(n)
    return {f"a{i}": rng.integers(0, 256, nbytes, dtype=np.uint8) for i in range(n)}


def _plan(arrays: dict, port: bool):
    """Prepared writes of ``arrays`` batched by one package: (entries,
    requests)."""
    prep = ArrayIOPreparer if port else JaxArrayIOPreparer
    entries, write_reqs = {}, []
    for name, arr in arrays.items():
        obj = torch.from_numpy(arr.copy()) if port else arr
        entry, reqs = prep.prepare_write(f"0/{name}", obj)
        entries[name] = entry
        write_reqs += reqs
    batch = batch_write_requests if port else jax_batcher.batch_write_requests
    _, reqs = batch(list(entries.values()), write_reqs)
    return entries, reqs


def _layout(entries: dict, reqs) -> tuple:
    """The plan without its random slab names: raw request paths, slab
    sizes, and each member's byte range."""
    slabs = sorted(r.buffer_stager.total for r in reqs if r.path.startswith("batched/"))
    raw = sorted(r.path for r in reqs if not r.path.startswith("batched/"))
    ranges = {k: (e.location.startswith("batched/"), e.byte_range) for k, e in entries.items()}
    return raw, slabs, ranges


def test_batch_write_requests_packs_slabs():
    arrays = _arrays(10)
    entries, reqs = _plan(arrays, port=True)
    assert len(reqs) == 1  # all ten 100 B writes in one slab
    slab_req = reqs[0]
    assert slab_req.path.startswith("batched/")
    assert isinstance(slab_req.buffer_stager, BatchedBufferStager)
    for entry in entries.values():
        assert entry.location == slab_req.path
        assert entry.byte_range is not None

    # Stage the slab: each member's byte range holds its data, and the
    # slab is tpusnap's byte for byte.
    buf = asyncio.run(slab_req.buffer_stager.stage_buffer())
    mv = memoryview(buf)
    for name, arr in arrays.items():
        start, end = entries[name].byte_range
        assert bytes(mv[start:end]) == arr.tobytes()
    jax_entries, jax_reqs = _plan(arrays, port=False)
    assert _layout(entries, reqs) == _layout(jax_entries, jax_reqs)
    theirs = asyncio.run(jax_reqs[0].buffer_stager.stage_buffer())
    assert bytes(mv) == bytes(memoryview(theirs))


def test_batch_write_respects_threshold():
    arrays = _arrays(5)
    with override_slab_size_threshold_bytes(250):
        entries, reqs = _plan(arrays, port=True)
    # 5 x 100 B with 250 B slabs: 3 groups (2 + 2 + 1); the single stays raw.
    assert len([r for r in reqs if r.path.startswith("batched/")]) == 2
    assert len(reqs) == 3
    with jax_override_threshold(250):
        jax_entries, jax_reqs = _plan(arrays, port=False)
    assert _layout(entries, reqs) == _layout(jax_entries, jax_reqs)


class _Collect(BufferConsumer):
    def __init__(self, sink, key):
        self.sink, self.key = sink, key

    async def consume_buffer(self, buf, executor=None):
        self.sink[self.key] = bytes(buf)

    def get_consuming_cost_bytes(self):
        return 1


class _JaxCollect(JaxBufferConsumer):
    def __init__(self, sink, key):
        self.sink, self.key = sink, key

    async def consume_buffer(self, buf, executor=None):
        self.sink[self.key] = bytes(buf)

    def get_consuming_cost_bytes(self):
        return 1


def _reads(spans, port: bool):
    """Read requests over ``spans`` [(path, key, (start, end))] and their sink."""
    sink = {}
    req, consumer = (ReadReq, _Collect) if port else (JaxReadReq, _JaxCollect)
    return [req(path, consumer(sink, key), byte_range=rng) for path, key, rng in spans], sink


def _merged(spans, port: bool):
    reqs, sink = _reads(spans, port)
    merged = (batch_read_requests if port else jax_batcher.batch_read_requests)(reqs)
    return merged, sink


@pytest.mark.parametrize(
    "spans,n_out",
    [
        # dense: three ranges of one blob merge into one span
        ([("loc", "a", (0, 10)), ("loc", "b", (10, 20)), ("loc", "c", (20, 32)),
          ("other", "d", (5, 9))], 2),
        # too sparse to merge
        ([("loc", "a", (0, 10)), ("loc", "b", (1000, 1010))], 2),
    ],
    ids=["merges_spans", "skips_sparse_spans"],
)
def test_batch_read_requests(spans, n_out):
    merged, sink = _merged(spans, port=True)
    jax_merged, jax_sink = _merged(spans, port=False)
    assert len(merged) == n_out
    assert sorted((r.path, tuple(r.byte_range)) for r in merged) == sorted(
        (r.path, tuple(r.byte_range)) for r in jax_merged
    )
    # Each request's consumer, fed the bytes of its range, hands every
    # member exactly its slice, as tpusnap's does.
    data = bytes(range(256)) * 4
    for out, reqs in ((sink, merged), (jax_sink, jax_merged)):
        for r in reqs:
            start, end = r.byte_range
            asyncio.run(r.buffer_consumer.consume_buffer(data[start:end]))
    assert sink == jax_sink == {key: data[s:e] for _, key, (s, e) in spans}
    if n_out == 2 and len(spans) == 4:
        span = [r for r in merged if r.path == "loc"][0]
        assert tuple(span.byte_range) == (0, 32)


def test_batching_disabled_knob():
    arrays = _arrays(4)
    with override_batching_disabled(True):
        _, reqs = _plan(arrays, port=True)
        assert len(reqs) == 4
    with jax_override_batching_disabled(True):
        _, jax_reqs = _plan(arrays, port=False)
    assert sorted(r.path for r in reqs) == sorted(r.path for r in jax_reqs)


# ------------------------------------------------ planned bytes (C20)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slab_planned_bytes_is_its_payload_as_in_tpusnap(seed):
    """A host slab plans its payload (the members' bytes), not its staging
    cost (the payload plus the largest member's staging), as tpusnap's
    ``BatchedBufferStager.get_planned_bytes`` does, on the same member
    sizes."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 5000, size=int(rng.integers(2, 30)))
    arrays = {f"a{i}": rng.integers(0, 256, int(n), dtype=np.uint8) for i, n in enumerate(sizes)}
    _, reqs = _plan(arrays, port=True)
    _, jax_reqs = _plan(arrays, port=False)
    slabs = [r.buffer_stager for r in reqs if r.path.startswith("batched/")]
    jax_slabs = [r.buffer_stager for r in jax_reqs if r.path.startswith("batched/")]
    assert slabs and all(isinstance(st, BatchedBufferStager) for st in slabs)
    for st in slabs:
        assert st.get_planned_bytes() == st.total == sum(n for _, n, _ in st.members)
        assert st.get_staging_cost_bytes() > st.get_planned_bytes()
    assert sorted(st.get_planned_bytes() for st in slabs) == sorted(
        st.get_planned_bytes() for st in jax_slabs
    )
    assert sum(st.get_planned_bytes() for st in slabs) == int(sizes.sum())


def _small_state(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {f"t{i}": torch.from_numpy(rng.standard_normal(int(n)).astype(np.float32))
            for i, n in enumerate(rng.integers(1, 500, size=20))}


def test_take_heartbeat_plans_the_payload_bytes(tmp_path, monkeypatch):
    """A take of many small CPU tensors (one host slab) publishes a
    heartbeat whose ``bytes_planned`` is the payload, so its percent can
    reach 100 before the commit."""
    from tpusnap_torch import Snapshot
    from tpusnap_torch.progress import read_progress_records
    from tpusnap_torch.state_dict import StateDict

    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))
    state = _small_state(3)
    payload = sum(t.numel() * 4 for t in state.values())
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"app": StateDict(**state)})
    (record,) = read_progress_records(path)
    assert record["bytes_planned"] == payload == record["bytes_written"]


def test_unchanged_increment_skips_the_slab_payload(tmp_path, monkeypatch):
    """An increment over an unchanged base drops the whole slab: the
    ``scheduler.dedup_skipped_bytes`` counter counts its payload."""
    from tpusnap_torch import Snapshot, telemetry
    from tpusnap_torch.state_dict import StateDict

    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))
    state = _small_state(4)
    payload = sum(t.numel() * 4 for t in state.values())
    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    Snapshot.take(base, {"app": StateDict(**state)})
    Snapshot.take(inc, {"app": StateDict(**state)}, incremental_from=base)
    counters = telemetry.LAST_TAKE_SUMMARY["counters"]
    assert counters["scheduler.dedup_skipped"] == 1
    assert counters["scheduler.dedup_skipped_bytes"] == payload
