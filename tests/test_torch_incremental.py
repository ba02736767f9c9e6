"""tpusnap_torch incremental takes (``incremental_from``): blobs whose
stage-time hashes match the base's are not written and are referenced in
the base by relative location. Ports of the single-process cases of
tests/test_incremental.py with torch tensors, and cross-package chains in
which tpusnap and the port take turns, on the same numpy inputs.
Snapshots are bit-exact, so every comparison has tolerance 0.

Cross-package dedup needs both sides to record the same algorithms
(``crc32c`` checksums and ``xxh64`` dedup hashes, the native builds);
with the fallbacks every skip would silently turn into a rewrite, so the
cross-package tests assert the algorithm strings of both manifests.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import tpusnap
from test_format_conformance import _external_reader
from tpusnap.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
    init_train_state,
    make_mesh,
)
from tpusnap_torch import Snapshot, StateDict, verify_snapshot
from tpusnap_torch.inspect import diff_snapshots, iter_blobs
from tpusnap_torch.io_preparers.array import dedup_entries_match
from tpusnap_torch.knobs import (
    override_async_cow,
    override_batching_disabled,
    override_checksum_disabled,
    override_max_chunk_size_bytes,
    override_record_dedup_hashes,
    override_tile_checksum_bytes,
)
from tpusnap_torch.manifest import TensorEntry
from tpusnap_torch.models import Transformer, TransformerConfig

torch.set_num_threads(1)

_TINY = dict(vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16)


def _blob_files(root):
    """Every payload file of a snapshot (not its metadata)."""
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


def _total_blob_bytes(root):
    return sum(os.path.getsize(os.path.join(root, f)) for f in _blob_files(root))


def _np_state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((512, 128)).astype(np.float32),
        "b": rng.standard_normal((256,)).astype(np.float32),
    }


def _state(seed=0):
    arrays = _np_state(seed)
    return StateDict(
        w=torch.from_numpy(arrays["w"]),
        b=torch.from_numpy(arrays["b"]),
        cfg={"lr": 0.1, "layers": [1, 2]},
        step=1,
    )


def _zeros_target():
    return {
        "app": StateDict(
            w=torch.zeros(512, 128), b=torch.zeros(256), cfg={}, step=0
        )
    }


def test_unchanged_take_writes_no_data(tmp_path):
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    with override_batching_disabled(True):
        Snapshot.take(base, {"app": _state()})
        Snapshot.take(inc, {"app": _state()}, incremental_from=base)
    assert _blob_files(inc) == []
    target = _zeros_target()
    Snapshot(inc).restore(target)
    src = _state()
    assert torch.equal(target["app"]["w"], src["w"])
    assert torch.equal(target["app"]["b"], src["b"])
    assert target["app"]["cfg"] == {"lr": 0.1, "layers": [1, 2]}
    assert target["app"]["step"] == 1
    assert verify_snapshot(inc).clean
    assert torch.equal(Snapshot(inc).read_object("0/app/w"), src["w"])
    assert Snapshot(inc).metadata.base_roots == ["../s0"]


def test_changed_leaf_rewrites_only_itself(tmp_path):
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    st = _state()
    with override_batching_disabled(True):
        Snapshot.take(base, {"app": st})
        st["b"] = st["b"] + 1.0
        Snapshot.take(inc, {"app": st}, incremental_from=base)
    assert _blob_files(inc) == ["0/app/b"]
    target = _zeros_target()
    Snapshot(inc).restore(target)
    assert torch.equal(target["app"]["b"], st["b"])
    assert torch.equal(target["app"]["w"], st["w"])


def test_chained_increments_collapse_to_oldest_base(tmp_path):
    s0, s1, s2 = (str(tmp_path / f"s{i}") for i in range(3))
    st = _state()
    with override_batching_disabled(True):
        Snapshot.take(s0, {"app": st})
        st["b"] = st["b"] * 2
        Snapshot.take(s1, {"app": st}, incremental_from=s0)
        Snapshot.take(s2, {"app": st}, incremental_from=s1)
    assert _blob_files(s2) == []
    md = Snapshot(s2).metadata
    assert md.manifest["0/app/w"].location == "../s0/0/app/w"
    assert md.manifest["0/app/b"].location == "../s1/0/app/b"
    assert md.base_roots == ["../s0", "../s1"]
    assert verify_snapshot(s2).clean
    target = _zeros_target()
    Snapshot(s2).restore(target)
    assert torch.equal(target["app"]["b"], st["b"])


def test_chunked_incremental_partial_change(tmp_path):
    arr = torch.from_numpy(np.random.default_rng(3).standard_normal((64, 256)).astype(np.float32))
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    with override_max_chunk_size_bytes(16 * 1024), override_batching_disabled(True):
        Snapshot.take(base, {"app": StateDict(big=arr)})
        arr2 = arr.clone()
        arr2[-1, :] += 1.0  # only the last chunk's rows
        Snapshot.take(inc, {"app": StateDict(big=arr2)}, incremental_from=base)
    files = _blob_files(inc)
    assert len(files) == 1 and files[0].startswith("0/app/big_"), files
    target = {"app": StateDict(big=torch.zeros_like(arr))}
    Snapshot(inc).restore(target)
    assert torch.equal(target["app"]["big"], arr2)
    assert verify_snapshot(inc).clean


def test_async_incremental_take(tmp_path):
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    st = _state()
    with override_batching_disabled(True):
        Snapshot.take(base, {"app": st})
        pending = Snapshot.async_take(inc, {"app": st}, incremental_from=base)
        # An incremental take stages and hashes everything before it
        # returns (its dedup decisions must be final before the manifest).
        assert pending._pending_io_work.staging_complete()
        snap = pending.wait()
    assert _blob_files(inc) == []
    assert snap.verify().clean


def test_deleted_base_breaks_increment_loudly(tmp_path):
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    with override_batching_disabled(True):
        Snapshot.take(base, {"app": _state()})
        Snapshot.take(inc, {"app": _state()}, incremental_from=base)
    shutil.rmtree(base)
    report = verify_snapshot(inc)
    assert not report.clean and report.corrupt > 0
    with pytest.raises(Exception):
        Snapshot(inc).restore(_zeros_target())


def test_slab_integrity_through_dedup(tmp_path):
    st = StateDict(
        a=torch.arange(64, dtype=torch.float32),
        b=torch.arange(64, 128, dtype=torch.float32),
        c=torch.arange(128, 192, dtype=torch.float32),
    )
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    Snapshot.take(base, {"app": st})
    Snapshot.take(inc, {"app": st}, incremental_from=base)
    assert _blob_files(inc) == []
    target = {"app": StateDict(a=torch.zeros(64), b=torch.zeros(64), c=torch.zeros(64))}
    Snapshot(inc).restore(target)
    for k in ("a", "b", "c"):
        assert torch.equal(target["app"][k], st[k]), k
    assert verify_snapshot(inc).clean


def test_incremental_tile_grain(tmp_path):
    arr = torch.from_numpy(np.random.default_rng(5).standard_normal((4096, 64)).astype(np.float32))
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    with override_tile_checksum_bytes(128 * 1024), override_batching_disabled(True):
        with override_record_dedup_hashes(True):
            Snapshot.take(base, {"app": StateDict(big=arr)})
        Snapshot.take(inc, {"app": StateDict(big=arr)}, incremental_from=base)
    assert _blob_files(inc) == []
    out = Snapshot(inc).read_object("0/app/big", memory_budget_bytes=256 * 1024)
    assert torch.equal(out, arr)


def test_incremental_tiled_hashless_base_rewrites_once(tmp_path):
    arr = torch.from_numpy(np.random.default_rng(6).standard_normal((4096, 64)).astype(np.float32))
    base, inc1, inc2 = (str(tmp_path / f"s{i}") for i in range(3))
    with override_tile_checksum_bytes(128 * 1024), override_batching_disabled(True):
        Snapshot.take(base, {"app": StateDict(big=arr)})
        assert Snapshot(base).metadata.manifest["0/app/big"].tile_dedup_hashes is None
        Snapshot.take(inc1, {"app": StateDict(big=arr)}, incremental_from=base)
        assert _blob_files(inc1) != []  # no 64-bit evidence in the base
        Snapshot.take(inc2, {"app": StateDict(big=arr)}, incremental_from=inc1)
    assert _blob_files(inc2) == []
    assert torch.equal(Snapshot(inc2).read_object("0/app/big"), arr)


def test_incremental_requires_same_scheme(tmp_path):
    with pytest.raises(ValueError, match="scheme"):
        Snapshot.take(
            str(tmp_path / "s1"),
            {"app": StateDict(x=torch.ones(4))},
            incremental_from="gs://bkt/other",
        )


def test_incremental_from_missing_base_fails(tmp_path):
    with pytest.raises(RuntimeError, match="not a readable snapshot"):
        Snapshot.take(
            str(tmp_path / "s1"),
            {"app": StateDict(x=torch.ones(4))},
            incremental_from=str(tmp_path / "nope"),
        )


def test_incremental_refuses_with_checksums_disabled(tmp_path):
    base = str(tmp_path / "s0")
    Snapshot.take(base, {"app": StateDict(x=torch.ones(4))})
    with override_checksum_disabled(True):
        with pytest.raises(ValueError, match="checksum"):
            Snapshot.take(
                str(tmp_path / "s1"), {"app": StateDict(x=torch.ones(4))},
                incremental_from=base,
            )


def test_incremental_refuses_checksumless_base(tmp_path):
    base = str(tmp_path / "s0")
    with override_checksum_disabled(True):
        Snapshot.take(base, {"app": StateDict(x=torch.ones(64))})
    with pytest.raises(ValueError, match="checksums"):
        Snapshot.take(
            str(tmp_path / "s1"), {"app": StateDict(x=torch.ones(64))},
            incremental_from=base,
        )


def test_materialize_makes_increment_self_contained(tmp_path):
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    st = _state()
    with override_batching_disabled(True):
        Snapshot.take(base, {"app": st})
        st["b"] = st["b"] + 1.0
        Snapshot.take(inc, {"app": st}, incremental_from=base)
    assert _blob_files(inc) == ["0/app/b"]
    snap = Snapshot(inc)
    stats = snap.materialize()
    assert stats == {"blobs_copied": 1, "bytes_copied": 512 * 128 * 4}
    assert not any(b.location.startswith("../") for b in iter_blobs(snap.metadata.manifest))
    assert snap.metadata.base_roots is None
    shutil.rmtree(base)
    assert verify_snapshot(inc).clean
    target = _zeros_target()
    Snapshot(inc).restore(target)
    assert torch.equal(target["app"]["w"], st["w"])
    assert torch.equal(target["app"]["b"], st["b"])
    assert Snapshot(inc).materialize()["blobs_copied"] == 0


def test_materialize_preserves_slab_references(tmp_path):
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    big = torch.from_numpy(np.random.default_rng(2).standard_normal((512, 128)).astype(np.float32))
    st = StateDict(big=big, a=torch.arange(64, dtype=torch.float32), b=torch.ones(64))
    Snapshot.take(base, {"app": st})  # a and b land in a base slab
    with override_batching_disabled(True):
        Snapshot.take(inc, {"app": st}, incremental_from=base)
    md = Snapshot(inc).metadata
    slab_refs = [
        e for e in md.manifest.values()
        if "batched/" in getattr(e, "location", "") and e.location.startswith("../")
    ]
    assert slab_refs
    Snapshot(inc).materialize()
    shutil.rmtree(base)
    assert verify_snapshot(inc).clean
    assert torch.equal(Snapshot(inc).read_object("0/app/a"), torch.arange(64, dtype=torch.float32))


def test_materialize_refuses_corrupt_base(tmp_path):
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    with override_batching_disabled(True):
        Snapshot.take(base, {"app": _state()})
        Snapshot.take(inc, {"app": _state()}, incremental_from=base)
    with open(os.path.join(base, "0/app/w"), "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(RuntimeError, match="BASE snapshot is corrupt"):
        Snapshot(inc).materialize()
    assert Snapshot(inc).metadata.manifest["0/app/w"].location.startswith("../")


@pytest.mark.parametrize("cow", [True, False], ids=["cow", "clone"])
def test_async_incremental_mutation_isolation(tmp_path, cow):
    """A changed leaf under COW is mutated after ``wait_staged()``; with
    clones, right after the return. Either way the deduped leaf keeps the
    base's bytes and the changed one its value at the call."""
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    frozen = torch.from_numpy(np.random.default_rng(0).standard_normal((256, 64)).astype(np.float32))
    hot = torch.arange(512, dtype=torch.float32)
    frozen_orig = frozen.clone()
    with override_batching_disabled(True), override_async_cow(cow):
        Snapshot.take(base, {"app": StateDict(frozen=frozen, hot=hot)})
        hot2 = hot + 1.0
        state = StateDict(frozen=frozen, hot=hot2)
        pending = Snapshot.async_take(inc, {"app": state}, incremental_from=base)
        if cow:
            assert pending.wait_staged()
        hot2[:] = -99.0
        frozen[:] = -77.0
        snap = pending.wait()
    assert _blob_files(inc) == ["0/app/hot"]
    assert snap.verify().clean
    target = {"app": StateDict(frozen=torch.zeros(256, 64), hot=torch.zeros(512))}
    Snapshot(inc).restore(target)
    assert torch.equal(target["app"]["hot"], hot + 1.0)
    assert torch.equal(target["app"]["frozen"], frozen_orig)


class TestTileGrainDedup:
    """One changed row of a large tensor rewrites one checksum tile: the
    increment re-chunks the tensor on the base's tile grid and unchanged
    tiles become byte-range references into the base blob."""

    SHAPE = (1024, 64)  # f32, 256 KiB; 4 KiB tiles of 16 rows

    def _arr(self):
        return torch.from_numpy(np.random.default_rng(7).standard_normal(self.SHAPE).astype(np.float32))

    def _knobs(self):
        from contextlib import ExitStack

        stack = ExitStack()
        stack.enter_context(override_tile_checksum_bytes(4 * 1024))
        stack.enter_context(override_record_dedup_hashes(True))
        return stack

    def test_one_changed_row_writes_one_tile(self, tmp_path):
        arr = self._arr()
        base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
        with self._knobs():
            Snapshot.take(base, {"app": StateDict(big=arr)})
            assert Snapshot(base).metadata.manifest["0/app/big"].tile_dedup_hashes
            changed = arr.clone()
            changed[500, :] += 1.0
            Snapshot.take(inc, {"app": StateDict(big=changed)}, incremental_from=base)
        assert 0 < _total_blob_bytes(inc) <= 2 * 4 * 1024
        e = Snapshot(inc).metadata.manifest["0/app/big"]
        assert e.type == "ChunkedTensor"
        ext = [c for c in e.chunks if c.tensor.location.startswith("../")]
        assert len(ext) == len(e.chunks) - 1
        target = {"app": StateDict(big=torch.zeros(self.SHAPE))}
        Snapshot(inc).restore(target)
        assert torch.equal(target["app"]["big"], changed)
        assert verify_snapshot(inc).clean
        assert torch.equal(Snapshot(inc).read_object("0/app/big"), changed)

    def test_chain_stays_tile_grain_and_collapses(self, tmp_path):
        arr = self._arr()
        s0, s1, s2 = (str(tmp_path / f"s{i}") for i in range(3))
        with self._knobs():
            Snapshot.take(s0, {"app": StateDict(big=arr)})
            c1 = arr.clone()
            c1[500, :] += 1.0
            Snapshot.take(s1, {"app": StateDict(big=c1)}, incremental_from=s0)
            c2 = c1.clone()
            c2[10, :] -= 2.0
            Snapshot.take(s2, {"app": StateDict(big=c2)}, incremental_from=s1)
        assert 0 < _total_blob_bytes(s2) <= 2 * 4 * 1024
        e = Snapshot(s2).metadata.manifest["0/app/big"]
        locs = {
            c.tensor.location.split("/")[1] if c.tensor.location.startswith("..") else "local"
            for c in e.chunks
        }
        assert {"s0", "s1", "local"} <= locs
        target = {"app": StateDict(big=torch.zeros(self.SHAPE))}
        Snapshot(s2).restore(target)
        assert torch.equal(target["app"]["big"], c2)
        assert verify_snapshot(s2).clean

    def test_diff_decides_across_geometries(self, tmp_path):
        arr = self._arr()
        other = torch.arange(32, dtype=torch.int32)
        base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
        with self._knobs():
            Snapshot.take(base, {"app": StateDict(big=arr, other=other)})
            changed = arr.clone()
            changed[0, 0] += 1.0
            Snapshot.take(inc, {"app": StateDict(big=changed, other=other)}, incremental_from=base)
        d = diff_snapshots(base, inc)
        assert "0/app/big" in d.changed
        assert "0/app/other" in d.identical
        assert not d.unknown

    def test_materialize_tile_grain_increment(self, tmp_path):
        arr = self._arr()
        base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
        with self._knobs():
            Snapshot.take(base, {"app": StateDict(big=arr)})
            changed = arr.clone()
            changed[123, :] *= 3.0
            Snapshot.take(inc, {"app": StateDict(big=changed)}, incremental_from=base)
        assert Snapshot(inc).materialize()["blobs_copied"] >= 1
        shutil.rmtree(base)
        target = {"app": StateDict(big=torch.zeros(self.SHAPE))}
        Snapshot(inc).restore(target)
        assert torch.equal(target["app"]["big"], changed)
        assert verify_snapshot(inc).clean

    def test_tile_route_needs_prev_tile_hashes(self, tmp_path):
        arr = self._arr()
        base, inc, inc2 = (str(tmp_path / f"s{i}") for i in range(3))
        with override_tile_checksum_bytes(4 * 1024):
            Snapshot.take(base, {"app": StateDict(big=arr)})  # no tile hashes
            changed = arr.clone()
            changed[500, :] += 1.0
            Snapshot.take(inc, {"app": StateDict(big=changed)}, incremental_from=base)
            assert _total_blob_bytes(inc) >= arr.numel() * 4  # safe rewrite
            c2 = changed.clone()
            c2[1, :] = 0.0
            Snapshot.take(inc2, {"app": StateDict(big=c2)}, incremental_from=inc)
        assert 0 < _total_blob_bytes(inc2) <= 2 * 4 * 1024


class TestSlabMemberDedup:
    def _state(self, bump: float = 0.0):
        rng = np.random.default_rng(3)
        st = {f"p{i}": torch.from_numpy(rng.standard_normal(256).astype(np.float32)) for i in range(6)}
        if bump:
            st["p3"] = st["p3"] + bump
        return StateDict(**st)

    def test_one_changed_member_compacts_slab(self, tmp_path):
        base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
        Snapshot.take(base, {"app": self._state()})
        Snapshot.take(inc, {"app": self._state(bump=1.0)}, incremental_from=base)
        assert _total_blob_bytes(inc) == 256 * 4
        m = Snapshot(inc).metadata.manifest
        ext = [k for k in m if k.startswith("0/app/p") and m[k].location.startswith("../")]
        assert len(ext) == 5
        assert m["0/app/p3"].byte_range == [0, 1024]  # compacted
        target = {"app": self._state()}
        expect = self._state(bump=1.0)
        Snapshot(inc).restore(target)
        for k in expect:
            assert torch.equal(target["app"][k], expect[k]), k
        assert verify_snapshot(inc).clean

    def test_unchanged_slab_writes_nothing(self, tmp_path):
        base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
        Snapshot.take(base, {"app": self._state()})
        Snapshot.take(inc, {"app": self._state()}, incremental_from=base)
        assert _blob_files(inc) == []
        assert verify_snapshot(inc).clean

    def test_member_without_base_hash_rewrites(self, tmp_path):
        """A base whose members lack the 64-bit hash (an older format)
        cannot back a skip on a single 32-bit CRC: everything rewrites."""
        base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
        Snapshot.take(base, {"app": self._state()})
        md_path = os.path.join(base, ".snapshot_metadata")
        md = json.loads(open(md_path).read())
        for entry in md["manifest"].values():
            entry.pop("dedup_hash", None)
        md.pop("self_checksum", None)  # a rewriter strips it, per the spec
        with open(md_path, "w") as f:
            f.write(json.dumps(md))
        Snapshot.take(inc, {"app": self._state()}, incremental_from=base)
        assert _total_blob_bytes(inc) == 6 * 256 * 4
        assert verify_snapshot(inc).clean


def test_dedup_match_requires_64bit_evidence():
    def te(**kw):
        base = dict(
            location="x", serializer="buffer_protocol", dtype="float32",
            shape=[4], replicated=False, checksum="crc32c:00000001",
        )
        base.update(kw)
        return TensorEntry(**base)

    a = te(dedup_hash="xxh64:00000000000000aa")
    assert dedup_entries_match(a, te(dedup_hash="xxh64:00000000000000aa"))
    assert not dedup_entries_match(a, te(dedup_hash="xxh64:00000000000000bb"))
    assert not dedup_entries_match(a, te())
    assert not dedup_entries_match(te(), te())
    t1 = te(tile_rows=2, tile_checksums=["crc32c:01", "crc32c:02"])
    t2 = te(tile_rows=2, tile_checksums=["crc32c:01", "crc32c:02"])
    assert not dedup_entries_match(t1, t2)
    t1.tile_dedup_hashes = ["xxh64:0a", "xxh64:0b"]
    t2.tile_dedup_hashes = ["xxh64:0a", "xxh64:0b"]
    assert dedup_entries_match(t1, t2)
    t2.tile_dedup_hashes = None
    assert not dedup_entries_match(t1, t2)
    t2.tile_dedup_hashes = ["xxh64:0a", "xxh64:0c"]
    assert not dedup_entries_match(t1, t2)


def test_dedup_chain_depth_100(tmp_path):
    """A long chain collapses to the oldest base: the manifest does not
    grow with depth, each increment writes only the changed leaf, and the
    tip resolves every reference in one hop."""
    frozen = torch.arange(256 * 1024, dtype=torch.float32).reshape(512, 512)
    hot = torch.zeros(512)
    base = str(tmp_path / "s000")
    with override_batching_disabled(True), override_record_dedup_hashes(True):
        Snapshot.take(base, {"app": StateDict(frozen=frozen, hot=hot)})
    meta_sizes = []
    prev = base
    with override_batching_disabled(True):
        for d in range(1, 101):
            hot = hot + 1.0
            path = str(tmp_path / f"s{d:03d}")
            Snapshot.take(path, {"app": StateDict(frozen=frozen, hot=hot)}, incremental_from=prev)
            meta_sizes.append(os.path.getsize(os.path.join(path, ".snapshot_metadata")))
            assert len(_blob_files(path)) == 1, d
            prev = path
    assert max(meta_sizes) <= int(min(meta_sizes) * 1.05) + 64
    tip = Snapshot(prev)
    assert "s000" in tip.metadata.manifest["0/app/frozen"].location
    target = {"app": StateDict(frozen=torch.zeros_like(frozen), hot=torch.zeros(512))}
    tip.restore(target)
    assert torch.equal(target["app"]["frozen"], frozen)
    assert torch.equal(target["app"]["hot"], torch.full((512,), 100.0))
    assert verify_snapshot(prev).clean


# ------------------------------------------------------------ cross-package


def _jax_train_state():
    model = JaxTransformer(JaxConfig(**_TINY))
    return init_train_state(model, make_mesh(jax.devices()[:1]), jax.random.PRNGKey(0))


def _port_model(jax_state):
    model = Transformer(TransformerConfig(**_TINY), device="cpu")
    model.train_state_from_jax(jax.tree.map(np.asarray, jax_state))
    return model


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _algos(path):
    """(checksum algorithms, dedup-hash algorithms) a manifest records."""
    md = json.load(open(os.path.join(path, ".snapshot_metadata")))
    crc, dedup = set(), set()

    def visit(e):
        for c in e.get("chunks", []):
            visit(c["tensor"])
        if "checksum" in e:
            crc.add(e["checksum"].split(":")[0])
        for h in [e.get("dedup_hash")] + list(e.get("tile_dedup_hashes") or []):
            if h:
                dedup.add(h.split(":")[0])

    for e in md["manifest"].values():
        visit(e)
    return crc, dedup


def _port_train(path, model, **kw):
    return Snapshot.take(
        path,
        {"train": StateDict(**model.train_state()), "progress": StateDict(step=3)},
        **kw,
    )


def _jax_train(path, jax_state, **kw):
    from tpusnap import PytreeState
    from tpusnap import StateDict as JaxStateDict

    return tpusnap.Snapshot.take(
        path, {"train": PytreeState(jax_state), "progress": JaxStateDict(step=3)}, **kw
    )


def _check_both_restore(path, want):
    """The snapshot at ``path`` restores bit-exact through the port (in
    place, into a fresh model) and through tpusnap."""
    fresh = Transformer(TransformerConfig(**_TINY), device="cpu", seed=99)
    before = {p: id(t) for p, t in _leaves(fresh.train_state())}
    Snapshot(path).restore({"train": StateDict(**fresh.train_state()), "progress": StateDict(step=0)})
    loaded = tpusnap.load_snapshot(path)["train"]
    for p, t in _leaves(fresh.train_state()):
        assert id(t) == before[p], p
        assert t.detach().numpy().tobytes() == want[p].tobytes(), p
        node = loaded
        for k in p.split("/"):
            node = node[k]
        assert np.asarray(node).tobytes() == want[p].tobytes(), p


@pytest.mark.parametrize("batching_disabled", [False, True], ids=["slabs", "blobs"])
def test_port_increment_on_tpusnap_base_skips_everything(tmp_path, batching_disabled):
    jax_state = _jax_train_state()
    model = _port_model(jax_state)
    base, inc = str(tmp_path / "jax_base"), str(tmp_path / "port_inc")
    with override_batching_disabled(batching_disabled):
        _jax_train(base, jax_state)
        _port_train(inc, model, incremental_from=base)
    assert _blob_files(inc) == []
    assert _algos(base) == _algos(inc) == ({"crc32c"}, {"xxh64"})
    assert Snapshot(inc).verify().clean
    _check_both_restore(inc, {p: np.asarray(t) for p, t in _leaves(jax.tree.map(np.asarray, jax_state))})


@pytest.mark.parametrize("batching_disabled", [False, True], ids=["slabs", "blobs"])
def test_tpusnap_increment_on_port_base_skips_everything(tmp_path, batching_disabled):
    jax_state = _jax_train_state()
    model = _port_model(jax_state)
    base, inc = str(tmp_path / "port_base"), str(tmp_path / "jax_inc")
    with override_batching_disabled(batching_disabled):
        _port_train(base, model)
        _jax_train(inc, jax_state, incremental_from=base)
    assert _blob_files(inc) == []
    assert _algos(base) == _algos(inc) == ({"crc32c"}, {"xxh64"})
    assert tpusnap.verify_snapshot(inc).clean
    _check_both_restore(inc, {p: t.detach().numpy() for p, t in _leaves(model.train_state())})


def test_tile_grain_across_packages(tmp_path):
    """A port base recording tile hashes; tpusnap's increment with one
    changed row writes one tile; the port's next increment with another
    changed row writes one more. Both packages restore the chain."""
    arr = np.random.default_rng(11).standard_normal((1024, 64)).astype(np.float32)
    s0, s1, s2 = (str(tmp_path / f"s{i}") for i in range(3))
    with override_tile_checksum_bytes(4 * 1024), override_batching_disabled(True):
        Snapshot.take(s0, {"a": StateDict(big=torch.from_numpy(arr))}, _record_dedup_hashes=True)
        c1 = arr.copy()
        c1[500] += 1.0
        tpusnap.Snapshot.take(
            s1, {"a": tpusnap.StateDict(big=jax.numpy.asarray(c1))}, incremental_from=s0
        )
        c2 = c1.copy()
        c2[10] -= 2.0
        Snapshot.take(s2, {"a": StateDict(big=torch.from_numpy(c2))}, incremental_from=s1)
    for path in (s1, s2):
        assert 0 < _total_blob_bytes(path) <= 2 * 4 * 1024, path
        assert _algos(path) == ({"crc32c"}, {"xxh64"})
    out = torch.zeros(1024, 64)
    Snapshot(s2).restore({"a": StateDict(big=out)})
    assert out.numpy().tobytes() == c2.tobytes()
    assert np.asarray(tpusnap.Snapshot(s2).read_object("0/a/big")).tobytes() == c2.tobytes()
    assert tpusnap.verify_snapshot(s2).clean and verify_snapshot(s2).clean


def test_external_reader_reads_a_port_increment(tmp_path):
    st = _state()
    base, inc = str(tmp_path / "s0"), str(tmp_path / "s1")
    with override_tile_checksum_bytes(4 * 1024), override_batching_disabled(True):
        Snapshot.take(base, {"app": st}, _record_dedup_hashes=True)
        st["w"] = st["w"].clone()
        st["w"][7] += 1.0
        Snapshot.take(inc, {"app": st}, incremental_from=base)
    md, read = _external_reader(inc)
    assert md["manifest"]["0/app/w"]["type"] == "ChunkedTensor"
    assert read("0/app/w").tobytes() == st["w"].numpy().tobytes()
    assert read("0/app/b").tobytes() == st["b"].numpy().tobytes()
    assert read("0/app/step") == 1
