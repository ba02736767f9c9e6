"""tpusnap_torch inspection: ``verify`` (the integrity scrub),
``materialize``, ``diff_snapshots`` and ``retention.apply_retention``.
Ports of the single-process cases of tests/test_inspect.py and
tests/test_retention.py with torch tensors (the CLI, sharded and
multi-process cases wait for their slices), and cross-package checks:
each package's scrub reports the other's incremental and compressed
snapshots clean, and a chain whose links alternate between the packages
survives retention and restores through both. Bit-exact throughout.
"""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusnap
from tpusnap_torch import Snapshot, StateDict, apply_retention, verify_snapshot
from tpusnap_torch.inspect import (
    base_root_of_location,
    diff_snapshots,
    entry_nbytes,
    iter_blobs,
    materialize_snapshot,
)
from tpusnap_torch.knobs import (
    override_batching_disabled,
    override_checksum_disabled,
    override_compress,
    override_max_chunk_size_bytes,
    override_tile_checksum_bytes,
)
from tpusnap_torch.retention import _referenced_bases

torch.set_num_threads(1)


def _state():
    rng = np.random.default_rng(0)
    return StateDict(
        dense=torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32)),
        small=torch.from_numpy(rng.standard_normal(16).astype(np.float32)),
        obj={"nested": [1, 2, 3]},
        step=7,
        lr=1e-3,
    )


def _flip_byte(root: str, relpath_substr: str, offset: int = 100) -> str:
    for dirpath, _, files in os.walk(root):
        for f in files:
            full = os.path.join(dirpath, f)
            rel = os.path.relpath(full, root)
            if relpath_substr in rel and not f.startswith(".snapshot"):
                with open(full, "r+b") as fh:
                    fh.seek(min(offset, os.path.getsize(full) - 1))
                    b = fh.read(1)
                    fh.seek(-1, os.SEEK_CUR)
                    fh.write(bytes([b[0] ^ 0xFF]))
                return rel
    raise AssertionError(f"no blob matching {relpath_substr!r} under {root}")


@pytest.mark.parametrize("batching_disabled", [False, True], ids=["slabs", "blobs"])
def test_clean_snapshot_verifies(tmp_path, batching_disabled):
    path = str(tmp_path / "snap")
    with override_batching_disabled(batching_disabled):
        Snapshot.take(path, {"app": _state()})
    report = verify_snapshot(path)
    assert report.clean and report.corrupt == 0 and report.ok > 0
    assert report.bytes_verified >= 256 * 128 * 4
    assert Snapshot(path).verify().clean


def test_corrupt_dense_blob_detected(tmp_path):
    path = str(tmp_path / "snap")
    with override_batching_disabled(True):
        Snapshot.take(path, {"app": _state()})
    _flip_byte(path, "dense")
    report = verify_snapshot(path)
    assert report.corrupt == 1
    assert any("app/dense" in f.manifest_path for f in report.failures)


def test_corrupt_tile_pinpointed(tmp_path):
    path = str(tmp_path / "snap")
    arr = torch.from_numpy(np.random.default_rng(1).standard_normal((4096, 32)).astype(np.float32))
    with override_tile_checksum_bytes(64 * 1024), override_batching_disabled(True):
        Snapshot.take(path, {"app": StateDict(big=arr)})
    report = verify_snapshot(path)
    assert report.clean and report.ok > 4
    _flip_byte(path, "big", offset=10)
    report = verify_snapshot(path)
    assert report.corrupt == 1
    assert "rows 0:" in report.failures[0].detail


def test_corrupt_slab_member_attributed(tmp_path):
    path = str(tmp_path / "snap")
    st = StateDict(a=torch.arange(64, dtype=torch.float32), b=torch.arange(64, 128, dtype=torch.float32))
    Snapshot.take(path, {"app": st})
    assert any(
        getattr(e, "location", "").startswith("batched/")
        for e in Snapshot(path).get_manifest().values()
    )
    _flip_byte(path, "batched/", offset=4)
    report = verify_snapshot(path)
    assert not report.clean
    assert any("app/" in f.manifest_path for f in report.failures)


@pytest.mark.parametrize("damage", ["truncated", "missing"])
def test_truncated_or_missing_blob_detected(tmp_path, damage):
    path = str(tmp_path / "snap")
    with override_batching_disabled(True):
        Snapshot.take(path, {"app": _state()})
    full = os.path.join(path, "0/app/dense")
    if damage == "truncated":
        with open(full, "r+b") as fh:
            fh.truncate(os.path.getsize(full) // 2)
    else:
        os.remove(full)
    report = verify_snapshot(path)
    assert not report.clean
    if damage == "missing":
        assert any("read failed" in f.detail for f in report.failures)


def test_entry_nbytes_and_iter_blobs(tmp_path):
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"app": _state()})
    md = Snapshot(path).metadata
    blobs = list(iter_blobs(md.manifest))
    assert blobs and all(b.checksum for b in blobs)
    assert sum(entry_nbytes(e) for e in md.manifest.values()) >= 256 * 128 * 4


def test_scrub_concurrency_knob(tmp_path, monkeypatch):
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"app": _state()})
    for n in ("1", "16"):
        monkeypatch.setenv("TPUSNAP_SCRUB_CONCURRENCY", n)
        assert verify_snapshot(path).clean


def test_diff_snapshots(tmp_path):
    st = _state()
    a, b, c = (str(tmp_path / x) for x in "abc")
    with override_batching_disabled(True):
        Snapshot.take(a, {"app": st})
    Snapshot.take(b, {"app": st}, incremental_from=a)
    assert diff_snapshots(a, b).same
    st2 = _state()
    st2["dense"] = st2["dense"] + 1.0
    del st2["small"]
    st2["extra"] = torch.ones(8)
    with override_batching_disabled(True):
        Snapshot.take(c, {"app": st2})
    d = diff_snapshots(a, c)
    assert "0/app/dense" in d.changed
    assert "0/app/small" in d.removed
    assert "0/app/extra" in d.added
    assert d.summary().endswith("1 changed, 1 added, 1 removed")


def test_diff_undecidable_cases(tmp_path):
    st = _state()
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    with override_checksum_disabled(True):
        Snapshot.take(a, {"app": st})
        Snapshot.take(b, {"app": st})
    d = diff_snapshots(a, b)
    assert not d.same and not d.differs and d.unknown
    big = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32))
    c1, c2, c2b, c3 = (str(tmp_path / x) for x in ("c1", "c2", "c2b", "c3"))
    big2 = big.clone()
    big2[17, 3] += 1.0
    with override_batching_disabled(True):
        with override_max_chunk_size_bytes(4 * 1024):
            Snapshot.take(c1, {"app": StateDict(big=big)})
        with override_max_chunk_size_bytes(2 * 1024):
            Snapshot.take(c2, {"app": StateDict(big=big)})
            Snapshot.take(c2b, {"app": StateDict(big=big2)})
        Snapshot.take(c3, {"app": StateDict(big=big.double())})
    d = diff_snapshots(c1, c2)
    assert "0/app/big" in d.identical and not d.differs
    assert "0/app/big" in diff_snapshots(c1, c2b).changed
    assert "0/app/big" in diff_snapshots(c1, c3).changed


def test_base_roots_recorded_and_resolve_numeric_dirs(tmp_path):
    base = str(tmp_path / "exp" / "1000" / "final")
    inc = str(tmp_path / "exp" / "1000" / "cont")
    st = StateDict(w=torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32)))
    Snapshot.take(base, {"app": st})
    Snapshot.take(inc, {"app": st}, incremental_from=base)
    assert Snapshot(inc).metadata.base_roots == ["../final"]
    loc = "../exp/1000/final/0/w"
    assert base_root_of_location(loc) == "../exp"
    assert base_root_of_location(loc, known_roots=["../exp/1000/final"]) == "../exp/1000/final"
    assert _referenced_bases(inc) == [os.path.abspath(base)]
    materialize_snapshot(inc)
    assert Snapshot(inc).metadata.base_roots is None
    assert verify_snapshot(inc).clean


def test_chained_base_roots_accumulate(tmp_path):
    s0, s1, s2 = (str(tmp_path / f"step_{i}") for i in range(3))
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    Snapshot.take(s0, {"app": StateDict(a=a, b=b)})
    Snapshot.take(s1, {"app": StateDict(a=a, b=b + 1)}, incremental_from=s0)
    Snapshot.take(s2, {"app": StateDict(a=a, b=b + 1)}, incremental_from=s1)
    assert Snapshot(s2).metadata.base_roots == ["../step_0", "../step_1"]


# ----------------------------------------------------------------- retention


def _chain(tmp_path, n=3):
    root = str(tmp_path)
    frozen = torch.from_numpy(np.random.default_rng(0).standard_normal((512, 64)).astype(np.float32))
    prev, hots = None, []
    with override_batching_disabled(True):
        for i in range(n):
            hot = torch.full((64,), float(i))
            hots.append(hot)
            path = os.path.join(root, f"s{i}")
            Snapshot.take(path, {"app": StateDict(frozen=frozen, hot=hot, step=i)}, incremental_from=prev)
            prev = path
    return root, frozen, hots


def _restore_chain_link(path, frozen):
    tgt = {"app": StateDict(frozen=torch.zeros_like(frozen), hot=torch.zeros(64), step=-1)}
    Snapshot(path).restore(tgt)
    assert torch.equal(tgt["app"]["frozen"], frozen)
    return tgt["app"]


def test_keep_last_materializes_then_deletes(tmp_path):
    root, frozen, hots = _chain(tmp_path)
    plan = apply_retention(root, keep_last=1)
    assert plan.executed
    assert [os.path.basename(p) for p in plan.keep] == ["s2"]
    assert sorted(os.path.basename(p) for p in plan.delete) == ["s0", "s1"]
    assert [os.path.basename(p) for p in plan.materialize] == ["s2"]
    assert plan.bytes_copied >= frozen.numel() * 4
    assert sorted(os.listdir(root)) == ["s2"]
    assert verify_snapshot(os.path.join(root, "s2")).clean
    got = _restore_chain_link(os.path.join(root, "s2"), frozen)
    assert got["step"] == 2 and torch.equal(got["hot"], hots[2])


def test_dry_run_touches_nothing(tmp_path):
    root, _, _ = _chain(tmp_path)
    plan = apply_retention(root, keep_last=1, dry_run=True)
    assert not plan.executed
    assert sorted(os.path.basename(p) for p in plan.delete) == ["s0", "s1"]
    assert sorted(os.listdir(root)) == ["s0", "s1", "s2"]
    assert verify_snapshot(os.path.join(root, "s2")).clean


def test_keep_two_materializes_both_dependents(tmp_path):
    root, frozen, hots = _chain(tmp_path)
    plan = apply_retention(root, keep_last=2)
    assert sorted(os.path.basename(p) for p in plan.materialize) == ["s1", "s2"]
    assert sorted(os.listdir(root)) == ["s1", "s2"]
    for name, hot in (("s1", hots[1]), ("s2", hots[2])):
        assert verify_snapshot(os.path.join(root, name)).clean
        assert torch.equal(_restore_chain_link(os.path.join(root, name), frozen)["hot"], hot)


def test_keep_all_is_noop(tmp_path):
    root, _, _ = _chain(tmp_path)
    plan = apply_retention(root, keep_last=10)
    assert plan.executed and not plan.delete and not plan.materialize
    assert sorted(os.listdir(root)) == ["s0", "s1", "s2"]


def test_refuses_object_store_roots():
    with pytest.raises(ValueError, match="local filesystem"):
        apply_retention("gs://bkt/snaps", keep_last=1, dry_run=True)


def test_ordering_survives_mtime_resets(tmp_path):
    root, _, _ = _chain(tmp_path)
    now = time.time()
    for i, bump in (("0", 100), ("1", 50), ("2", 0)):
        meta = os.path.join(root, f"s{i}", ".snapshot_metadata")
        os.utime(meta, (now + bump, now + bump))
    plan = apply_retention(root, keep_last=1)
    assert [os.path.basename(p) for p in plan.keep] == ["s2"]
    assert verify_snapshot(os.path.join(root, "s2")).clean


# ------------------------------------------------------------ cross-package


def _bf16ish(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (a.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def _algos(path):
    md = json.load(open(os.path.join(path, ".snapshot_metadata")))
    out = set()
    for e in md["manifest"].values():
        for t in [c["tensor"] for c in e.get("chunks", [])] or [e]:
            if "checksum" in t:
                out.add(t["checksum"].split(":")[0])
    return out


def test_verify_across_packages(tmp_path):
    """tpusnap's scrub reports the port's incremental and compressed
    snapshots clean, and the port's reports tpusnap's clean; a flipped
    byte is caught by both."""
    a, b = _bf16ish((2048, 256), 1), _bf16ish((64,), 2)
    paths = {k: str(tmp_path / k) for k in ("pb", "pi", "jb", "ji")}
    with override_compress(mode="on", min_blob_bytes=65536), override_tile_checksum_bytes(
        1 << 18
    ), override_batching_disabled(True):
        Snapshot.take(paths["pb"], {"m": StateDict(a=torch.from_numpy(a), b=torch.from_numpy(b))},
                      _record_dedup_hashes=True)
        Snapshot.take(paths["pi"], {"m": StateDict(a=torch.from_numpy(a), b=torch.from_numpy(b) + 1)},
                      incremental_from=paths["pb"])
        tpusnap.Snapshot.take(paths["jb"], {"m": tpusnap.StateDict(a=jnp.asarray(a), b=jnp.asarray(b))},
                              _record_dedup_hashes=True)
        tpusnap.Snapshot.take(paths["ji"], {"m": tpusnap.StateDict(a=jnp.asarray(a), b=jnp.asarray(b) + 1)},
                              incremental_from=paths["jb"])
    for p in paths.values():
        assert _algos(p) == {"crc32c"}, p
        assert Snapshot(p).metadata.manifest["0/m/a"].codec == "shuf4+lz4", p
        assert tpusnap.verify_snapshot(p).clean, p
        assert verify_snapshot(p).clean, p
    for p in (paths["pi"], paths["ji"]):
        assert Snapshot(p).metadata.manifest["0/m/a"].location.startswith("../")
    _flip_byte(paths["pb"], "0/m/a", offset=1000)
    assert not tpusnap.verify_snapshot(paths["pi"]).clean
    assert not verify_snapshot(paths["pi"]).clean


def test_mixed_chain_survives_retention(tmp_path):
    """s0 by tpusnap, s1 by the port, s2 by tpusnap, s3 by the port, each
    an increment of the one before; keeping the last two materializes both
    and deletes the rest; both packages restore the survivors bit-exact."""
    root = str(tmp_path)
    frozen = np.random.default_rng(5).standard_normal((512, 64)).astype(np.float32)
    prev, hots = None, []
    with override_batching_disabled(True):
        for i in range(4):
            hot = np.full((64,), float(i), np.float32)
            hots.append(hot)
            path = os.path.join(root, f"s{i}")
            if i % 2 == 0:
                tpusnap.Snapshot.take(
                    path, {"app": tpusnap.StateDict(frozen=jnp.asarray(frozen), hot=jnp.asarray(hot))},
                    incremental_from=prev,
                )
            else:
                Snapshot.take(
                    path, {"app": StateDict(frozen=torch.from_numpy(frozen), hot=torch.from_numpy(hot))},
                    incremental_from=prev,
                )
            prev = path
    assert Snapshot(os.path.join(root, "s3")).metadata.manifest["0/app/frozen"].location == "../s0/0/app/frozen"
    plan = apply_retention(root, keep_last=2)
    assert sorted(os.path.basename(p) for p in plan.materialize) == ["s2", "s3"]
    assert sorted(os.listdir(root)) == ["s2", "s3"]
    for name, hot in (("s2", hots[2]), ("s3", hots[3])):
        path = os.path.join(root, name)
        assert verify_snapshot(path).clean and tpusnap.verify_snapshot(path).clean
        tgt = {"app": StateDict(frozen=torch.zeros(512, 64), hot=torch.zeros(64))}
        Snapshot(path).restore(tgt)
        assert tgt["app"]["frozen"].numpy().tobytes() == frozen.tobytes()
        assert tgt["app"]["hot"].numpy().tobytes() == hot.tobytes()
        loaded = tpusnap.load_snapshot(path)["app"]
        assert np.asarray(loaded["frozen"]).tobytes() == frozen.tobytes()
        assert np.asarray(loaded["hot"]).tobytes() == hot.tobytes()
    # tpusnap's retention keeps the port's survivors readable too.
    from tpusnap.retention import apply_retention as jax_apply_retention

    jax_apply_retention(root, keep_last=1)
    assert sorted(os.listdir(root)) == ["s3"]
    assert verify_snapshot(os.path.join(root, "s3")).clean
