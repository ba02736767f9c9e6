"""The port's crash-safe lifecycle against tpusnap's: the mirror of
``tests/test_lifecycle.py`` for ``tpusnap_torch`` (take journal, fsck,
gc, salvage records, metadata self-checksum), then the on-disk parity of
the two packages with batching off, so that blob paths agree:

- a SIGKILLed take of either package is "torn" to both ``fsck_snapshot``;
- each package's retake salvages the other's torn take (the same blobs
  skip their writes) and restores bit-exact;
- both record the same checksum and dedup-hash algorithm strings.

The crashes are deterministic: a child process takes through
``chaos+fs://`` with ``crash_after_op=write:N`` and SIGKILLs itself after
its N-th blob write.
"""

import asyncio
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpusnap_torch import Snapshot, StateDict, telemetry, verify_snapshot
from tpusnap_torch.io_types import WriteIO
from tpusnap_torch.knobs import override_batching_disabled, override_journal_disabled
from tpusnap_torch.lifecycle import (
    JOURNAL_FNAME,
    JournalingStoragePlugin,
    TakeJournal,
    fsck_snapshot,
    gc_snapshot,
    journal_rank_path,
    load_salvage_records,
)
from tpusnap_torch.manifest import MetadataError, decode_metadata, encode_metadata
from tpusnap_torch.storage_plugins.fs import FSStoragePlugin

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_state(seed=0, n=4):
    return {
        f"w{i}": np.random.default_rng(seed * 100 + i).standard_normal((64, 64)).astype(np.float32)
        for i in range(n)
    }


def _state(seed=0, n=4):
    return {k: torch.from_numpy(v) for k, v in _np_state(seed, n).items()}


def _take(path, state):
    return Snapshot.take(str(path), {"app": StateDict(**state)})


def _restored(path, state):
    target = {"app": StateDict(**{k: torch.zeros_like(v) for k, v in state.items()})}
    Snapshot(str(path)).restore(target)
    return target["app"]


# ----------------------------------------------------- metadata checksum


def test_metadata_roundtrip_and_external_json_contract(tmp_path):
    path = tmp_path / "snap"
    _take(path, _state())
    raw = open(path / ".snapshot_metadata", "rb").read()
    d = json.loads(raw)
    assert next(iter(d)) == "self_checksum"
    md = decode_metadata(raw)
    assert md.world_size == 1
    assert decode_metadata(encode_metadata(md)).manifest.keys() == md.manifest.keys()


def test_metadata_bitrot_and_truncation_detected(tmp_path):
    path = tmp_path / "snap"
    _take(path, _state())
    raw = open(path / ".snapshot_metadata", "rb").read()
    idx = raw.index(b'"world_size"') + 2
    flipped = raw[:idx] + bytes([raw[idx] ^ 0x01]) + raw[idx + 1 :]
    with pytest.raises(MetadataError, match="mismatch|torn|corrupt"):
        decode_metadata(flipped)
    with pytest.raises(MetadataError, match="torn|corrupt"):
        decode_metadata(raw[: len(raw) // 2])
    legacy = json.dumps({k: v for k, v in json.loads(raw).items() if k != "self_checksum"}).encode()
    assert decode_metadata(legacy).world_size == 1


def test_metadata_wrong_json_shape_is_metadata_error(tmp_path):
    for payload in (b"[]", b"0", b'"x"'):
        with pytest.raises(MetadataError, match="torn|corrupt"):
            decode_metadata(payload)
    path = tmp_path / "snap"
    _take(path, _state())
    open(path / ".snapshot_metadata", "wb").write(b"[]")
    assert fsck_snapshot(str(path)).state == "corrupt-metadata"


def test_restore_of_corrupt_metadata_raises_clearly(tmp_path):
    path = tmp_path / "snap"
    _take(path, _state())
    mp = path / ".snapshot_metadata"
    raw = open(mp, "rb").read()
    open(mp, "wb").write(raw[: len(raw) - 40])
    with pytest.raises(RuntimeError, match="[Cc]orrupt|torn"):
        Snapshot(str(path)).metadata
    assert fsck_snapshot(str(path)).state == "corrupt-metadata"


# ------------------------------------------------------------ journal


def test_journal_written_during_take_and_cleared_after(tmp_path, monkeypatch):
    path = tmp_path / "snap"
    seen = {}
    orig = FSStoragePlugin.write

    async def spying_write(self, write_io):
        if not write_io.path.startswith(".tpusnap/"):
            seen.setdefault(
                "journal_at_first_blob", os.path.exists(os.path.join(self.root, JOURNAL_FNAME))
            )
        await orig(self, write_io)

    monkeypatch.setattr(FSStoragePlugin, "write", spying_write)
    _take(path, _state())
    assert seen.get("journal_at_first_blob") is True
    assert not os.path.exists(path / JOURNAL_FNAME)
    assert not os.path.exists(path / journal_rank_path(0))
    assert fsck_snapshot(str(path)).state == "committed"


def test_journal_knob_disables_layer(tmp_path):
    path = tmp_path / "snap"
    with override_journal_disabled(True):
        _take(path, _state())
    assert not os.path.exists(path / ".tpusnap/journal")
    assert fsck_snapshot(str(path)).state == "committed"


def test_aborted_take_clears_journal(tmp_path, monkeypatch):
    """A failed (not SIGKILLed) take cleans its blobs and its journal: the
    path reads as empty, not torn, and is reusable at once."""
    path = tmp_path / "snap"

    async def bad_write(self, write_io):
        raise ValueError("injected fatal (non-transient) failure")

    with monkeypatch.context() as m:
        m.setattr(FSStoragePlugin, "write", bad_write)
        with pytest.raises(ValueError, match="injected fatal"):
            _take(path, _state())
    report = fsck_snapshot(str(path))
    assert report.state == "empty", report.summary()
    _take(path, _state())
    assert fsck_snapshot(str(path)).state == "committed"


# --------------------------------------------------------------- fsck/gc


def test_fsck_foreign_and_torn_states(tmp_path):
    foreign = tmp_path / "foreign"
    foreign.mkdir()
    (foreign / "random.bin").write_bytes(b"hello")
    assert fsck_snapshot(str(foreign)).state == "foreign"

    torn = tmp_path / "torn"
    (torn / ".tpusnap/journal.d").mkdir(parents=True)
    (torn / JOURNAL_FNAME).write_text(
        TakeJournal(take_id="abcd" * 8, world_size=2, started_at=0.0).to_json()
    )
    (torn / journal_rank_path(0)).write_text(
        json.dumps({"0/app/w0": [16, "crc32c:00000001", "xxh64:" + "0" * 16]})
    )
    (torn / "0/app").mkdir(parents=True)
    (torn / "0/app/w0").write_bytes(b"x" * 16)
    report = fsck_snapshot(str(torn))
    assert report.state == "torn"
    assert report.salvage_records == 1
    assert report.salvage_bytes_present == 16


def test_record_file_without_marker_classifies_torn(tmp_path):
    d = tmp_path / "premarker"
    (d / ".tpusnap/journal.d").mkdir(parents=True)
    (d / journal_rank_path(1)).write_text("{}")
    (d / "1").mkdir()
    (d / "1/blob").write_bytes(b"x" * 8)
    report = fsck_snapshot(str(d))
    assert report.state == "torn", report.summary()
    assert "marker" in report.detail


def test_journal_tmp_debris_is_orphan(tmp_path):
    path = tmp_path / "snap"
    _take(path, _state())
    (path / ".tpusnap").mkdir(exist_ok=True)
    (path / ".tpusnap/journal.tmp.1234").write_bytes(b"{" + b"x" * 20)
    report = fsck_snapshot(str(path))
    assert report.state == "committed"
    assert ".tpusnap/journal.tmp.1234" in report.orphans, report.orphans
    g = gc_snapshot(str(path), dry_run=False)
    assert ".tpusnap/journal.tmp.1234" in g.reclaimed and not g.errors


def test_gc_refuses_torn_without_flag_then_reclaims(tmp_path):
    torn = tmp_path / "torn"
    (torn / ".tpusnap").mkdir(parents=True)
    (torn / JOURNAL_FNAME).write_text(
        TakeJournal(take_id="ab" * 16, world_size=1, started_at=0.0).to_json()
    )
    (torn / "blob").write_bytes(b"y" * 100)
    with pytest.raises(RuntimeError, match="TORN|torn"):
        gc_snapshot(str(torn), dry_run=False)
    g = gc_snapshot(str(torn), dry_run=False, reclaim_torn=True)
    assert set(g.reclaimed) == {JOURNAL_FNAME, "blob"}
    assert fsck_snapshot(str(torn)).state == "empty"


def test_gc_torn_keeps_marker_when_deletions_fail(tmp_path, monkeypatch):
    torn = tmp_path / "torn"
    (torn / ".tpusnap").mkdir(parents=True)
    (torn / JOURNAL_FNAME).write_text(
        TakeJournal(take_id="ef" * 16, world_size=1, started_at=0.0).to_json()
    )
    (torn / "blob_a").write_bytes(b"a" * 10)
    (torn / "blob_b").write_bytes(b"b" * 10)
    orig = FSStoragePlugin.delete

    async def flaky_delete(self, p):
        if p == "blob_a":
            raise OSError("injected delete failure")
        await orig(self, p)

    with monkeypatch.context() as m:
        m.setattr(FSStoragePlugin, "delete", flaky_delete)
        g = gc_snapshot(str(torn), dry_run=False, reclaim_torn=True)
    assert g.errors
    assert os.path.exists(torn / JOURNAL_FNAME), "marker must survive"
    assert fsck_snapshot(str(torn)).state == "torn"
    g = gc_snapshot(str(torn), dry_run=False, reclaim_torn=True)
    assert not g.errors
    assert fsck_snapshot(str(torn)).state == "empty"


def test_gc_dry_run_default_and_orphan_exactness(tmp_path):
    path = tmp_path / "snap"
    state = _state()
    _take(path, state)
    (path / "stray").write_bytes(b"z" * 123)
    g = gc_snapshot(str(path))
    assert g.dry_run and set(g.reclaimed) == {"stray"}
    assert os.path.exists(path / "stray")
    g = gc_snapshot(str(path), dry_run=False)
    assert set(g.reclaimed) == {"stray"}
    assert not os.path.exists(path / "stray")
    assert verify_snapshot(str(path)).clean
    got = _restored(path, state)
    for k, v in state.items():
        assert torch.equal(got[k], v)


def test_fsck_reports_missing_referenced_blob(tmp_path):
    path = tmp_path / "snap"
    with override_batching_disabled(True):
        _take(path, _state())
    report = fsck_snapshot(str(path))
    assert report.state == "committed" and not report.missing_referenced
    blob = next(
        os.path.join(dp, f)
        for dp, _, fns in os.walk(path)
        for f in fns
        if not f.startswith(".") and ".tpusnap" not in dp
    )
    os.unlink(blob)
    report = fsck_snapshot(str(path))
    assert report.missing_referenced, report.summary()


# ------------------------------------------------------------- salvage


def test_salvage_records_match_rule(tmp_path):
    """Matching (nbytes, CRC32C, XXH64) skips the write; any mismatch
    rewrites."""
    root = tmp_path / "s"
    loop = asyncio.new_event_loop()
    try:
        inner = FSStoragePlugin(str(root))
        plug = JournalingStoragePlugin(inner, rank=0)
        data = b"a" * 4096
        plug.sync_write(WriteIO(path="0/app/w", buf=data), loop)
        records = load_salvage_records(inner, loop, 1)
        assert "0/app/w" in records and records["0/app/w"][0] == 4096
        plug2 = JournalingStoragePlugin(inner, rank=0, salvage_records=records)
        before = telemetry.counter_value("salvage.blobs_salvaged")

        async def boom(write_io):
            raise AssertionError("matching write must be skipped")

        inner_write = inner.write
        inner.write = boom
        try:
            plug2.sync_write(WriteIO(path="0/app/w", buf=data), loop)
        finally:
            inner.write = inner_write
        assert telemetry.counter_value("salvage.blobs_salvaged") == before + 1
        plug2.sync_write(WriteIO(path="0/app/w", buf=b"b" * 4096), loop)
        assert open(root / "0/app/w", "rb").read() == b"b" * 4096
        plug.sync_close(loop)
        plug2.sync_close(loop)
    finally:
        loop.close()


def test_salvage_records_survive_a_second_crash(tmp_path):
    root = tmp_path / "s"
    loop = asyncio.new_event_loop()
    try:
        inner = FSStoragePlugin(str(root))
        plug = JournalingStoragePlugin(inner, rank=0)
        plug.sync_write(WriteIO(path="0/app/a", buf=b"a" * 256), loop)
        plug.sync_write(WriteIO(path="0/app/b", buf=b"b" * 256), loop)
        records = load_salvage_records(inner, loop, 1)
        assert set(records) == {"0/app/a", "0/app/b"}
        plug2 = JournalingStoragePlugin(inner, rank=0, salvage_records=records)
        plug2.sync_seed_record_file(loop)
        again = load_salvage_records(inner, loop, 1)
        assert set(again) == {"0/app/a", "0/app/b"}
        plug.sync_close(loop)
        plug2.sync_close(loop)
    finally:
        loop.close()


def test_salvage_record_without_blob_is_dropped(tmp_path):
    root = tmp_path / "s"
    loop = asyncio.new_event_loop()
    try:
        inner = FSStoragePlugin(str(root))
        plug = JournalingStoragePlugin(inner, rank=0)
        plug.sync_write(WriteIO(path="0/app/gone", buf=b"g" * 512), loop)
        plug.sync_write(WriteIO(path="0/app/kept", buf=b"k" * 512), loop)
        os.unlink(root / "0/app/gone")
        records = load_salvage_records(inner, loop, 1)
        assert set(records) == {"0/app/kept"}
        plug.sync_close(loop)
    finally:
        loop.close()


def test_journal_hash_is_final_before_the_pool_reuses_a_buffer(tmp_path):
    """The journaling layer hashes a buffer inside its write: by the
    time the write returns (and the scheduler hands the buffer back to
    the staging pool) the record holds this blob's evidence, whatever is
    written into the buffer afterwards."""
    from tpusnap_torch.lifecycle import dual_hash_evidence

    root = tmp_path / "s"
    loop = asyncio.new_event_loop()
    try:
        plug = JournalingStoragePlugin(FSStoragePlugin(str(root)), rank=0)
        buf = bytearray(b"q" * 8192)
        want = dual_hash_evidence(bytes(buf))
        plug.sync_write(WriteIO(path="0/app/q", buf=buf), loop)
        buf[:] = b"z" * 8192  # the pool hands the buffer to another blob
        records = load_salvage_records(FSStoragePlugin(str(root)), loop, 1)
        assert tuple(records["0/app/q"]) == want
        plug.sync_close(loop)
    finally:
        loop.close()


# ------------------------------------------- tpusnap's CLI on the port's dirs


def test_cli_fsck_and_gc(tmp_path, capsys):
    """tpusnap's fsck/gc command line classifies and cleans directories
    the port wrote, as it does its own."""
    from tpusnap.__main__ import main

    path = tmp_path / "snap"
    _take(path, _state())
    assert main(["fsck", str(path)]) == 0
    assert "committed" in capsys.readouterr().out
    (path / "junk").write_bytes(b"j" * 10)
    assert main(["gc", str(path)]) == 0
    assert os.path.exists(path / "junk")
    assert main(["gc", str(path), "--force"]) == 0
    assert not os.path.exists(path / "junk")
    torn = tmp_path / "torn"
    (torn / ".tpusnap").mkdir(parents=True)
    (torn / JOURNAL_FNAME).write_text(
        TakeJournal(take_id="cd" * 16, world_size=1, started_at=0.0).to_json()
    )
    (torn / "b").write_bytes(b"b")
    assert main(["fsck", str(torn)]) == 4
    assert main(["gc", str(torn), "--force"]) == 1
    assert gc_snapshot(str(torn), dry_run=False, reclaim_torn=True).state == "torn"
    assert main(["fsck", str(torn)]) == 3
    mp = path / ".snapshot_metadata"
    open(mp, "wb").write(open(mp, "rb").read()[:-30])
    assert main(["fsck", str(path)]) == 2


# ------------------------------------------------------ cross-package parity


_CHILD = r"""
import os, sys
import numpy as np
sys.path.insert(0, {repo!r})
pkg, path, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
state = {{f"w{{i}}": np.random.default_rng(100 * 7 + i).standard_normal((256, 256)).astype(np.float32)
          for i in range(6)}}
if pkg == "port":
    import torch
    from tpusnap_torch import Snapshot, StateDict
    state = {{k: torch.from_numpy(v) for k, v in state.items()}}
else:
    from tpusnap.test_utils import apply_platform_env
    apply_platform_env()
    from tpusnap import Snapshot, StateDict
Snapshot.take("chaos+fs://" + path, {{"app": StateDict(**state)}},
              storage_options={{"fault_plan": f"crash_after_op=write:{{n}}"}})
raise SystemExit("the take was not killed")
"""


def _crash(pkg: str, path: str, n_writes: int) -> None:
    env = dict(os.environ, TPUSNAP_DISABLE_BATCHING="1", TPUSNAP_COMPRESS="off",
               JAX_PLATFORMS="cpu", PYTHONPATH=_REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(repo=_REPO), pkg, path, str(n_writes)],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == -9, proc.stderr[-3000:]


def _parity_state():
    return {
        f"w{i}": np.random.default_rng(100 * 7 + i).standard_normal((256, 256)).astype(np.float32)
        for i in range(6)
    }


def _records(path):
    out = {}
    d = os.path.join(path, ".tpusnap", "journal.d")
    for name in os.listdir(d):
        if ".tmp." not in name:
            with open(os.path.join(d, name)) as f:
                out.update(json.load(f))
    return out


@pytest.mark.parametrize("crasher", ["port", "jax"])
def test_killed_take_is_torn_to_both_packages(tmp_path, crasher):
    import tpusnap.lifecycle as jax_lifecycle

    path = str(tmp_path / "snap")
    _crash(crasher, path, 5)
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))
    port_report = fsck_snapshot(path)
    jax_report = jax_lifecycle.fsck_snapshot(path)
    assert port_report.state == jax_report.state == "torn", (port_report.summary(), jax_report.summary())
    # Record flushes are coalesced, so how many landed before the kill
    # varies; both packages count the same ones.
    assert port_report.salvage_records == jax_report.salvage_records >= 1
    assert port_report.salvage_bytes_present == jax_report.salvage_bytes_present


def test_both_packages_record_the_same_algorithms(tmp_path):
    """The journal evidence and the manifest checksums name the same
    algorithms in both packages (a build without the native helper would
    fall back to zlib-crc32/sha256-64 and silently never match)."""
    port_path, jax_path = str(tmp_path / "p"), str(tmp_path / "j")
    _crash("port", port_path, 5)
    _crash("jax", jax_path, 5)
    algos = lambda recs: {(r[1].split(":")[0], r[2].split(":")[0]) for r in recs.values()}  # noqa: E731
    assert algos(_records(port_path)) == algos(_records(jax_path)) == {("crc32c", "xxh64")}
    # Every record of either torn take is the evidence both packages
    # compute for that blob's bytes.
    import tpusnap.lifecycle as jax_lifecycle

    from tpusnap_torch.lifecycle import dual_hash_evidence

    state = _parity_state()
    for recs in (_records(port_path), _records(jax_path)):
        assert len(recs) >= 1
        for loc, rec in recs.items():
            data = state[loc.rsplit("/", 1)[-1]].tobytes()
            assert tuple(rec) == dual_hash_evidence(data) == jax_lifecycle.dual_hash_evidence(data)


def _salvaged_by_port(path, state):
    before = telemetry.counter_value("salvage.blobs_salvaged")
    with override_batching_disabled(True):
        Snapshot.take(path, {"app": StateDict(**{k: torch.from_numpy(v) for k, v in state.items()})})
    return telemetry.counter_value("salvage.blobs_salvaged") - before


def _salvaged_by_jax(path, state):
    import tpusnap.telemetry as jax_telemetry
    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import StateDict as JaxStateDict
    from tpusnap.knobs import override_batching_disabled as jax_override

    before = jax_telemetry.counter_value("salvage.blobs_salvaged")
    with jax_override(True):
        JaxSnapshot.take(path, {"app": JaxStateDict(**state)})
    return jax_telemetry.counter_value("salvage.blobs_salvaged") - before


@pytest.mark.parametrize("crasher,retaker", [("port", "jax"), ("jax", "port")])
def test_each_package_salvages_the_others_torn_take(tmp_path, monkeypatch, crasher, retaker):
    import tpusnap.lifecycle as jax_lifecycle
    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import StateDict as JaxStateDict

    monkeypatch.setenv("TPUSNAP_COMPRESS", "off")
    path = str(tmp_path / "snap")
    _crash(crasher, path, 5)
    records = fsck_snapshot(path).salvage_records
    state = _parity_state()
    salvaged = (_salvaged_by_port if retaker == "port" else _salvaged_by_jax)(path, state)
    assert salvaged == records >= 1
    assert fsck_snapshot(path).state == jax_lifecycle.fsck_snapshot(path).state == "committed"
    port_target = {"app": StateDict(**{k: torch.zeros(v.shape) for k, v in state.items()})}
    Snapshot(path).restore(port_target)
    jax_target = {"app": JaxStateDict(**{k: np.zeros_like(v) for k, v in state.items()})}
    JaxSnapshot(path).restore(jax_target)
    for k, v in state.items():
        assert np.array_equal(port_target["app"][k].numpy(), v), k
        assert np.array_equal(np.asarray(jax_target["app"][k]), v), k


def test_port_retake_of_its_own_torn_take_writes_less(tmp_path, monkeypatch):
    """A salvage retake copies and hashes every byte but writes only the
    blobs the torn take did not finish."""
    monkeypatch.setenv("TPUSNAP_COMPRESS", "off")
    path = str(tmp_path / "snap")
    _crash("port", path, 5)
    state = _parity_state()
    total = sum(v.nbytes for v in state.values())
    hist = lambda: telemetry.global_io_histograms_snapshot().get(  # noqa: E731
        "write.FSStoragePlugin", {}).get("bytes_total", 0)
    before_written, before_salvaged = hist(), telemetry.counter_value("salvage.bytes_salvaged")
    _salvaged_by_port(path, state)
    written = hist() - before_written
    salvaged = telemetry.counter_value("salvage.bytes_salvaged") - before_salvaged
    assert salvaged >= state["w0"].nbytes
    # The histograms also saw the metadata file's write.
    assert written - os.path.getsize(os.path.join(path, ".snapshot_metadata")) + salvaged == total
    assert verify_snapshot(path).clean
    # Nothing but the killed process's interrupted record flush is left.
    assert all(".tmp." in p for p in gc_snapshot(path).reclaimed)


@pytest.mark.parametrize("kind", ["sync", "async"])
def test_take_leaves_no_cycle_holding_its_state(tmp_path, kind):
    """The journal probe of a fresh path fails inside the event loop; its
    exception must not tie the take's frames (stagers, staged buffers,
    CUDA tensors on a card) into a cycle that outlives the take until the
    cyclic collector runs."""
    import gc

    from tpusnap_torch.io_preparers.array import ArrayBufferStager

    state = {"app": StateDict(**_state())}
    gc.collect()
    gc.disable()
    try:
        if kind == "sync":
            Snapshot.take(str(tmp_path / "snap"), state)
        else:
            Snapshot.async_take(str(tmp_path / "snap"), state).wait()
        alive = sum(isinstance(o, ArrayBufferStager) for o in gc.get_objects())
    finally:
        gc.enable()
    assert alive == 0
