"""The port's chaos layer against tpusnap's: the mirror of
``tests/test_faults.py`` for ``tpusnap_torch`` (seeded fault injection
under the retry middleware), plus the parity of the two packages'
``FaultPlan``: the same spec parses to the same plan and fires the same
schedule.

Every end-to-end case holds the two invariants of the chaos layer: the
retry middleware converges (take, restore and verify succeed bit-exact
through ``chaos+fs://`` with at least one transient error per storage
op) and a committed snapshot scrubs clean whatever the fault schedule,
for the local filesystem, the fsspec bridge and the s3 plugin (on a
stub client).
"""

import asyncio
import dataclasses
import errno
import os
import time

import numpy as np
import pytest
import torch

from tpusnap_torch import Snapshot, StateDict, verify_snapshot
from tpusnap_torch.faults import FaultInjectionStoragePlugin, FaultPlan, InjectedFaultError
from tpusnap_torch.io_types import ReadIO, WriteIO
from tpusnap_torch.retry import (
    ProgressDeadline,
    RetryingStoragePlugin,
    RetryPolicy,
    default_classify_transient,
)
from tpusnap_torch.storage_plugins.fs import FSStoragePlugin


def _run(coro):
    return asyncio.run(coro)


_FAST_OPTS = {"retry_backoff_base_sec": 0.01, "retry_backoff_cap_sec": 0.05}


def _chaos_opts(plan: FaultPlan) -> dict:
    return dict(_FAST_OPTS, fault_plan=plan)


def _state(seed: int, n_arrays: int = 5, size: int = 4096) -> dict:
    return {
        f"w{i}": torch.from_numpy(
            np.random.default_rng(seed * 100 + i).standard_normal(size).astype(np.float32)
        )
        for i in range(n_arrays)
    }


def _zeros(state: dict) -> dict:
    return {k: torch.zeros_like(v) for k, v in state.items()}


# --------------------------------------------------------------- FaultPlan


def test_fault_plan_spec_parsing():
    plan = FaultPlan.from_spec(
        "seed=3,transient_per_op=2,latency_ms=5,torn_writes=1,"
        "short_reads=1,crash_after_op=write:7"
    )
    assert plan.seed == 3
    assert plan.transient_per_op == 2
    assert abs(plan.latency_sec - 0.005) < 1e-9
    assert plan.torn_writes and plan.short_reads
    assert plan.crash_after_op == ("write", 7)
    assert FaultPlan.from_spec("bandwidth_gbps=0.25").bandwidth_gbps == 0.25
    with pytest.raises(ValueError, match="Unknown fault spec key"):
        FaultPlan.from_spec("bogus=1")


def test_fault_plan_coerce_env(monkeypatch):
    monkeypatch.setenv("TPUSNAP_FAULT_SPEC", "seed=9,transient_every=4")
    plan = FaultPlan.coerce(None)
    assert plan.seed == 9 and plan.transient_every == 4
    monkeypatch.delenv("TPUSNAP_FAULT_SPEC")
    assert FaultPlan.coerce(None).transient_per_op == 1  # default misbehaves
    assert FaultPlan.coerce({"seed": 2}).seed == 2
    same = FaultPlan(seed=5)
    assert FaultPlan.coerce(same) is same


def _fire_sequence(plugin_cls, plan_cls, fs_cls, write_cls, root, seed):
    plugin = plugin_cls(fs_cls(root=root), plan_cls(seed=seed, transient_every=3))
    fired = []

    async def go():
        for i in range(12):
            try:
                await plugin.write(write_cls(path=f"o{i}", buf=b"x"))
                fired.append(False)
            except ConnectionError:
                fired.append(True)
        await plugin.close()

    _run(go())
    return fired


def test_fault_plan_determinism(tmp_path):
    """Identical seeds inject identical fault schedules over a serial op
    sequence."""
    a = _fire_sequence(
        FaultInjectionStoragePlugin, FaultPlan, FSStoragePlugin, WriteIO, str(tmp_path / "a"), 1
    )
    b = _fire_sequence(
        FaultInjectionStoragePlugin, FaultPlan, FSStoragePlugin, WriteIO, str(tmp_path / "b"), 1
    )
    assert a == b
    assert sum(a) == 4  # ops 3, 6, 9, 12 of 12


_PARITY_SPECS = [
    "seed=3,transient_per_op=2,latency_ms=5,torn_writes=1,short_reads=1,crash_after_op=write:7",
    "seed=9,transient_every=4,bandwidth_gbps=0.25",
    "rank=1,wedge=write:2",
    "stall_op=write:3:0.5,outage=*:5:10,preempt=write:*:30",
]


@pytest.mark.parametrize("spec", _PARITY_SPECS)
def test_fault_plan_parses_like_tpusnap(spec):
    """One TPUSNAP_FAULT_SPEC configures both packages alike."""
    from tpusnap.faults import FaultPlan as JaxFaultPlan

    assert dataclasses.asdict(FaultPlan.from_spec(spec)) == dataclasses.asdict(
        JaxFaultPlan.from_spec(spec)
    )


@pytest.mark.parametrize("seed", [1, 7])
def test_fault_schedule_matches_tpusnap(tmp_path, seed):
    """The same seed fires the same faults on the same op sequence in
    either package."""
    from tpusnap.faults import FaultInjectionStoragePlugin as JaxFI
    from tpusnap.faults import FaultPlan as JaxFaultPlan
    from tpusnap.io_types import WriteIO as JaxWriteIO
    from tpusnap.storage_plugins.fs import FSStoragePlugin as JaxFS

    port = _fire_sequence(
        FaultInjectionStoragePlugin, FaultPlan, FSStoragePlugin, WriteIO, str(tmp_path / "p"), seed
    )
    jax_side = _fire_sequence(JaxFI, JaxFaultPlan, JaxFS, JaxWriteIO, str(tmp_path / "j"), seed)
    assert port == jax_side


def test_fault_plan_rank_filter_reads_rank_env(tmp_path, monkeypatch):
    """Without a process group the rank filter reads RANK: a plan for
    rank 1 is inert on rank 0 and live on rank 1."""
    plan = FaultPlan(transient_per_op=1, rank=1)
    monkeypatch.setenv("RANK", "0")
    inert = FaultInjectionStoragePlugin(FSStoragePlugin(root=str(tmp_path / "r0")), plan)
    _run(inert.write(WriteIO(path="o", buf=b"x")))
    monkeypatch.setenv("RANK", "1")
    live = FaultInjectionStoragePlugin(FSStoragePlugin(root=str(tmp_path / "r1")), plan)
    with pytest.raises(InjectedFaultError):
        _run(live.write(WriteIO(path="o", buf=b"x")))


# ------------------------------------------------------------------ retry


class _FlakyPlugin(FSStoragePlugin):
    """Raises a configurable exception for the first N attempts per op."""

    def __init__(self, root, fail_times=1, exc_factory=None):
        super().__init__(root)
        self.fail_times = fail_times
        self.exc_factory = exc_factory or (lambda: ConnectionResetError("flaky"))
        self.attempts = {}

    def _maybe_fail(self, key):
        n = self.attempts.get(key, 0)
        self.attempts[key] = n + 1
        if n < self.fail_times:
            raise self.exc_factory()

    async def write(self, write_io):
        self._maybe_fail(("write", write_io.path))
        await super().write(write_io)

    async def read(self, read_io):
        self._maybe_fail(("read", read_io.path))
        await super().read(read_io)

    async def delete(self, path):
        self._maybe_fail(("delete", path))
        await super().delete(path)


def test_retrying_plugin_converges(tmp_path):
    inner = _FlakyPlugin(str(tmp_path), fail_times=2)
    plugin = RetryingStoragePlugin(inner, RetryPolicy(backoff_base_sec=0.01, backoff_cap_sec=0.02))
    data = os.urandom(100_000)

    async def go():
        await plugin.write(WriteIO(path="a/b", buf=data))
        read_io = ReadIO(path="a/b")
        await plugin.read(read_io)
        assert bytes(read_io.buf.getvalue()) == data
        await plugin.delete("a/b")
        await plugin.close()

    _run(go())
    assert inner.attempts[("write", "a/b")] == 3  # 2 failures + success


def test_retrying_plugin_fatal_error_raises_immediately(tmp_path):
    inner = _FlakyPlugin(str(tmp_path), fail_times=100, exc_factory=lambda: PermissionError("denied"))
    plugin = RetryingStoragePlugin(inner, RetryPolicy(backoff_base_sec=0.01))
    with pytest.raises(PermissionError):
        _run(plugin.write(WriteIO(path="x", buf=b"data")))
    # one attempt only: PermissionError (EACCES-class) is not transient
    assert inner.attempts[("write", "x")] == 1


def test_retrying_plugin_deadline_expiry(tmp_path):
    inner = _FlakyPlugin(str(tmp_path), fail_times=10_000)
    plugin = RetryingStoragePlugin(
        inner, RetryPolicy(deadline_sec=0.2, backoff_base_sec=0.02, backoff_cap_sec=0.05)
    )
    with pytest.raises(ConnectionResetError):
        _run(plugin.write(WriteIO(path="x", buf=b"data")))


def test_default_transient_classification():
    assert default_classify_transient(ConnectionResetError("x"))
    assert default_classify_transient(TimeoutError("x"))
    assert default_classify_transient(InjectedFaultError("x"))
    assert default_classify_transient(OSError(errno.EAGAIN, "again"))
    assert not default_classify_transient(OSError(errno.ENOSPC, "full"))
    assert not default_classify_transient(ValueError("x"))
    assert not default_classify_transient(OSError("no errno"))

    class _Resp:
        status_code = 503

    class _HttpErr(Exception):
        response = _Resp()

    assert default_classify_transient(_HttpErr())


def test_retry_read_attempts_never_leak_torn_buffers(tmp_path):
    """A failing read that delivered partial bytes must not surface them:
    each retry attempt runs against a fresh ReadIO."""
    plugin = RetryingStoragePlugin(
        FaultInjectionStoragePlugin(
            FSStoragePlugin(root=str(tmp_path)),
            FaultPlan(seed=0, transient_per_op=1, short_reads=True),
        ),
        RetryPolicy(backoff_base_sec=0.01),
    )
    data = os.urandom(50_000)

    async def go():
        await plugin.write(WriteIO(path="blob", buf=data))
        read_io = ReadIO(path="blob")
        await plugin.read(read_io)
        assert bytes(read_io.buf.getvalue()) == data
        await plugin.close()

    _run(go())


def test_progress_deadline_arms_lazily():
    """A plugin built long before its first op (async takes) must grant
    the first failing op a full retry window."""
    deadline = ProgressDeadline(deadline_sec=0.0)
    assert not deadline.expired()


# ------------------------------------------------------------- chaos e2e


def _chaos_roundtrip(url: str, opts: dict, seed: int) -> None:
    state = _state(seed)
    Snapshot.take(url, {"m": StateDict(**state)}, storage_options=opts)
    target = {"m": StateDict(**_zeros(state))}
    Snapshot(url, storage_options=opts).restore(target)
    for k, v in state.items():
        assert torch.equal(target["m"][k], v), k
    report = verify_snapshot(url, storage_options=opts)
    assert report.clean, report


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_fs_roundtrip(tmp_path, seed):
    """≥1 transient error per storage op + torn writes + short reads over
    chaos+fs://: the retry middleware converges and the committed
    snapshot is bit-exact and scrubs clean."""
    plan = FaultPlan(seed=seed, transient_per_op=1, torn_writes=True, short_reads=True)
    _chaos_roundtrip(f"chaos+fs://{tmp_path}/snap", _chaos_opts(plan), seed)


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [2, 3])
def test_chaos_fs_roundtrip_seed_sweep(tmp_path, seed):
    """Two more seeds of the same invariants, with every-Nth faults and
    latency composed in."""
    plan = FaultPlan(
        seed=seed, transient_per_op=1, transient_every=7, torn_writes=True,
        short_reads=True, latency_sec=0.001,
    )
    _chaos_roundtrip(f"chaos+fs://{tmp_path}/snap", _chaos_opts(plan), seed)


@pytest.mark.chaos
def test_chaos_fsspec_memory_roundtrip(tmp_path):
    """The fsspec bridge (an in-memory filesystem) converges under chaos
    like the local one."""
    plan = FaultPlan(seed=3, transient_per_op=1, short_reads=True)
    _chaos_roundtrip("chaos+fsspec+memory://chaos_mem_snap", _chaos_opts(plan), 3)


@pytest.mark.chaos
def test_chaos_latency_and_every_n(tmp_path):
    """Latency injection and every-Nth-op faults compose with per-op
    transients."""
    plan = FaultPlan(
        seed=4, transient_per_op=1, transient_every=5, latency_sec=0.001, torn_writes=True
    )
    _chaos_roundtrip(f"chaos+fs://{tmp_path}/snap", _chaos_opts(plan), 4)


def test_bandwidth_throttle_is_shared_across_concurrent_writes(tmp_path):
    """The write-path token bucket serializes payload bytes at the
    planned GB/s across concurrent ops; half the payload costs about half
    the pipe time."""

    def timed_writes(nbytes_each, n_ops):
        plugin = FaultInjectionStoragePlugin(
            FSStoragePlugin(root=str(tmp_path / f"bw{nbytes_each}")),
            FaultPlan(bandwidth_gbps=0.05),  # 50 MB/s
        )
        payload = os.urandom(nbytes_each)

        async def go():
            t0 = time.monotonic()
            await asyncio.gather(
                *(plugin.write(WriteIO(path=f"o{i}", buf=payload)) for i in range(n_ops))
            )
            return time.monotonic() - t0

        return _run(go())

    full = timed_writes(1 << 20, 4)  # 4 MiB total at 50 MB/s >= ~80 ms
    assert full >= 0.9 * (4 * (1 << 20)) / 0.05e9
    half = timed_writes(1 << 19, 4)
    assert half < full


def test_bandwidth_throttled_snapshot_roundtrips(tmp_path):
    """A take through a throttled chaos URL commits and restores
    bit-exact; the throttle only costs wall time."""
    state = _state(seed=11, n_arrays=2)
    url = f"chaos+fs://{tmp_path}/snap"
    opts = _chaos_opts(FaultPlan(transient_per_op=0, bandwidth_gbps=0.5))
    Snapshot.take(url, {"app": StateDict(**state)}, storage_options=opts)
    target = {"app": StateDict(**_zeros(state))}
    Snapshot(url, storage_options=opts).restore(target)
    for k, v in state.items():
        assert torch.equal(target["app"][k], v), k
    assert verify_snapshot(f"{tmp_path}/snap").clean


@pytest.mark.chaos
def test_chaos_s3_stub_ops(tmp_path):
    """The s3 plugin's ops converge under chaos through the retry
    middleware (a stub client: aiobotocore is not installed here)."""
    from test_torch_cloud import StubS3Client

    from tpusnap_torch.storage_plugins.s3 import S3StoragePlugin

    raw = S3StoragePlugin("bucket/prefix")
    raw._client = StubS3Client()
    plugin = RetryingStoragePlugin(
        FaultInjectionStoragePlugin(raw, FaultPlan(seed=5, transient_per_op=1, short_reads=True)),
        RetryPolicy(backoff_base_sec=0.01),
    )
    blobs = {f"o{i}": os.urandom(10_000 + i) for i in range(6)}

    async def go():
        await asyncio.gather(*(plugin.write(WriteIO(path=k, buf=v)) for k, v in blobs.items()))
        for k, v in blobs.items():
            read_io = ReadIO(path=k)
            await plugin.read(read_io)
            assert read_io.buf.getvalue() == v, k
        ranged = ReadIO(path="o0", byte_range=(100, 900))
        await plugin.read(ranged)
        assert ranged.buf.getvalue() == blobs["o0"][100:900]

    _run(go())


@pytest.mark.chaos
def test_chaos_incremental_dedup_survives_faults(tmp_path):
    """Incremental takes through a chaotic backend: dedup decisions and
    base references stay correct under injected faults."""
    from tpusnap_torch.knobs import override_batching_disabled

    opts = _chaos_opts(FaultPlan(seed=6, transient_per_op=1, torn_writes=True))
    state = _state(6, n_arrays=3)
    with override_batching_disabled(True):
        Snapshot.take(f"chaos+fs://{tmp_path}/s0", {"m": StateDict(**state)}, storage_options=opts)
        Snapshot.take(
            f"chaos+fs://{tmp_path}/s1", {"m": StateDict(**state)}, storage_options=opts,
            incremental_from=f"chaos+fs://{tmp_path}/s0",
        )
    target = {"m": StateDict(**_zeros(state))}
    Snapshot(f"chaos+fs://{tmp_path}/s1", storage_options=opts).restore(target)
    for k, v in state.items():
        assert torch.equal(target["m"][k], v), k
    assert verify_snapshot(f"chaos+fs://{tmp_path}/s1", storage_options=opts).clean


@pytest.mark.chaos
def test_chaos_transient_every_1_converges(tmp_path):
    """transient_every=1 fails every op's first attempt; retries are
    exempt from the every-Nth draw, so the take still converges."""
    _chaos_roundtrip(f"chaos+fs://{tmp_path}/snap", _chaos_opts(FaultPlan(seed=8, transient_every=1)), 8)


@pytest.mark.chaos
def test_chaos_async_take_roundtrip(tmp_path):
    """The background commit drain retries injected faults off the main
    thread; wait() returns a committed, clean snapshot."""
    opts = _chaos_opts(FaultPlan(seed=11, transient_per_op=1, torn_writes=True))
    url = f"chaos+fs://{tmp_path}/snap"
    state = _state(11)
    snap = Snapshot.async_take(url, {"m": StateDict(**state)}, storage_options=opts).wait()
    target = {"m": StateDict(**_zeros(state))}
    snap.restore(target)
    for k, v in state.items():
        assert torch.equal(target["m"][k], v), k
    assert verify_snapshot(url, storage_options=opts).clean


def test_chaos_composition_keeps_in_place_reads(tmp_path):
    """Retrying(Instrumented(FaultInjection(fs))) for chaos+fs://,
    Retrying(Instrumented(fs)) for a plain path, as tpusnap composes
    them: both still read in place."""
    from tpusnap_torch.storage_plugin import InstrumentedStoragePlugin, url_to_storage_plugin

    chaos = url_to_storage_plugin(f"chaos+fs://{tmp_path}/a", {"fault_plan": FaultPlan()})
    assert isinstance(chaos, RetryingStoragePlugin)
    assert isinstance(chaos.inner, InstrumentedStoragePlugin)
    assert isinstance(chaos.inner.inner, FaultInjectionStoragePlugin)
    assert isinstance(chaos.inner.inner.inner, FSStoragePlugin)
    plain = url_to_storage_plugin(str(tmp_path / "b"))
    assert isinstance(plain, RetryingStoragePlugin)
    assert isinstance(plain.inner, InstrumentedStoragePlugin)
    assert isinstance(plain.inner.inner, FSStoragePlugin)
    for plugin in (chaos, plain):
        assert plugin.supports_in_place_reads
        assert plugin.in_place_read_overhead_bytes(1 << 30) == FSStoragePlugin(
            root="x"
        ).in_place_read_overhead_bytes(1 << 30)


@pytest.mark.parametrize(
    "url", ["tier+local=/tmp/a+remote=s3://b/a", "cas+fs:///tmp/a", "gs://b/a", "chaos+s3://b/a"]
)
def test_unported_schemes_refused_by_name(url, tmp_path):
    """The schemes this test once saw refused now compose in tpusnap's
    order (tier, CAS, gcs handling its own retries, chaos under retry)
    instead of writing locally."""
    from tpusnap_torch.cas import CASStoragePlugin
    from tpusnap_torch.knobs import override_cas
    from tpusnap_torch.storage_plugin import InstrumentedStoragePlugin, url_to_storage_plugin
    from tpusnap_torch.storage_plugins.gcs import GCSStoragePlugin
    from tpusnap_torch.storage_plugins.s3 import S3StoragePlugin
    from tpusnap_torch.tiering import TieredStoragePlugin

    # A gcs emulator endpoint: no credentials are looked up.
    opts = {"api_endpoint": "http://127.0.0.1:9"} if url.startswith("gs:") else None
    with override_cas(str(tmp_path / "store")):
        plugin = url_to_storage_plugin(url, opts)
    base = plugin
    while getattr(base, "inner", None) is not None and not isinstance(
        base, (TieredStoragePlugin, CASStoragePlugin)
    ):
        base = base.inner
    want = {
        "tier+": TieredStoragePlugin, "cas+fs": CASStoragePlugin,
        "gs:": GCSStoragePlugin, "chaos+s3": S3StoragePlugin,
    }
    assert isinstance(base, next(v for k, v in want.items() if url.startswith(k)))
    if url.startswith("chaos+"):
        assert isinstance(plugin, RetryingStoragePlugin)
        assert isinstance(plugin.inner, InstrumentedStoragePlugin)
        assert isinstance(plugin.inner.inner, FaultInjectionStoragePlugin)
    if url.startswith("gs:"):
        assert plugin.handles_own_retries and not isinstance(plugin, RetryingStoragePlugin)
