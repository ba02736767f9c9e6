"""Delta streams in the port (``tpusnap_torch.delta``), held to
tpusnap's tests/test_delta.py case by case on CPU tensors: micro-commits,
chain resolution, compaction, retention pinning, resume. An unchanged
model streams zero payload bytes; a head restores the committed chain
bit-identically (tolerance 0); step-gated captures land exactly on a
``mark_step`` boundary. The SLO cases and the CLI halves wait for A9
(ROADMAP.md); the CUDA capture order is held by tests/test_torch_cuda.py
and the smoke's ``delta`` phase.
"""

import os

import numpy as np
import pytest
import torch

from tpusnap_torch import (
    DeltaStream,
    Snapshot,
    StateDict,
    resolve_chain,
    verify_snapshot,
)
from tpusnap_torch.delta import delta_fields, delta_payload_bytes, member_name
from tpusnap_torch.inspect import load_snapshot_metadata


def _payload_files(root: str):
    """PAYLOAD files under a snapshot dir (excluding metadata and the
    .tpusnap sidecars)."""
    out = []
    for dirpath, _, files in os.walk(root):
        if ".tpusnap" in dirpath.split(os.sep):
            continue
        for f in files:
            if f != ".snapshot_metadata":
                out.append(os.path.relpath(os.path.join(dirpath, f), root))
    return sorted(out)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "app": StateDict(
            w=torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32)),
            b=torch.from_numpy(rng.standard_normal((128,)).astype(np.float32)),
        )
    }


def test_stream_commit_restore_bit_identical(tmp_path):
    root = str(tmp_path / "stream")
    state = _state()
    with Snapshot.stream(root, state, cadence_s=3600) as s:
        assert s.seq == 0
        assert s.head.endswith(member_name(0))
        state["app"]["w"][0, :] = 42.0
        snap = s.commit_now()
        assert s.seq == 1
        # The committed member is a real snapshot: verifies clean and
        # carries its chain fields.
        assert verify_snapshot(snap.path).clean
        d = delta_fields(snap.metadata)
        assert d is not None and d["seq"] == 1
        assert d["parent"] == member_name(0)
        state["app"]["b"][:] = -1.0
        s.commit_now()
        expected_w = state["app"]["w"].clone()
        expected_b = state["app"]["b"].clone()
    # close() ran a final (unchanged) commit; head replays the chain.
    rep = resolve_chain(root)
    assert rep.head is not None
    target = {
        "app": StateDict(
            w=torch.zeros((256, 64)), b=torch.zeros(128)
        )
    }
    Snapshot(rep.head_path).restore(target)
    assert torch.equal(target["app"]["w"], expected_w)
    assert torch.equal(target["app"]["b"], expected_b)
    # Intermediate members restore too (any member is a snapshot).
    mid = os.path.join(root, member_name(1))
    out = Snapshot(mid).read_object("0/app/w")
    assert torch.equal(out[0], torch.full((64,), 42.0))


def test_unchanged_model_streams_zero_payload_bytes(tmp_path):
    from tpusnap_torch import telemetry

    root = str(tmp_path / "stream")
    state = _state(1)
    s = Snapshot.stream(root, state, cadence_s=3600)
    commits_before = telemetry.counter_value("delta.commits")
    snap = s.commit_now()
    # Dual-hash skip: nothing changed since the base — the member holds
    # NO payload files and the stream accounts zero bytes written.
    assert s.stats["last_commit_bytes"] == 0
    assert _payload_files(snap.path) == []
    assert delta_payload_bytes(snap.metadata) == 0
    assert telemetry.counter_value("delta.commits") == commits_before + 1
    # ... and still restores the full state through the base references.
    assert verify_snapshot(snap.path).clean
    target = {
        "app": StateDict(
            w=torch.zeros((256, 64)), b=torch.zeros(128)
        )
    }
    Snapshot(snap.path).restore(target)
    assert torch.equal(target["app"]["w"], state["app"]["w"])
    # A changed leaf rewrites only itself (b is slab-batched, so the
    # new slab holds just the one changed member: b's 512 bytes).
    state["app"]["b"][0] = 123.0
    snap2 = s.commit_now()
    files = _payload_files(snap2.path)
    assert len(files) == 1, files
    assert s.stats["last_commit_bytes"] == state["app"]["b"].nbytes
    s.close(final_commit=False)


def test_cadence_free_running_commits(tmp_path):
    import time

    root = str(tmp_path / "stream")
    state = _state(2)
    s = Snapshot.stream(root, state, cadence_s=0.3)
    t0 = time.monotonic()
    while time.monotonic() - t0 < 1.4:
        state["app"]["w"][0, 0] += 1.0
        time.sleep(0.02)
    s.close(final_commit=False)
    s.raise_if_failed()
    # ~4 intervals elapsed; allow generous slack for slow CI hosts.
    assert s.stats["commits"] >= 2, s.stats
    assert s.seq >= 2


def test_mark_step_gated_capture_lands_on_step_boundaries(tmp_path):
    """With mark_step gating, every committed increment must equal a
    state AS OF some step boundary — never a mid-mutation mixture."""
    import time

    root = str(tmp_path / "stream")
    state = _state(3)
    boundary_states = []

    def snapshot_boundary():
        boundary_states.append(
            (state["app"]["w"].clone(), state["app"]["b"].clone())
        )

    snapshot_boundary()  # the base capture in __init__ sees this state
    s = Snapshot.stream(root, state, cadence_s=0.25)
    t0 = time.monotonic()
    while time.monotonic() - t0 < 1.3:
        # "training step": in-place mutation between boundaries.
        state["app"]["w"] += 1.0
        state["app"]["b"] -= 0.5
        snapshot_boundary()
        s.mark_step(bytes_changed=state["app"]["w"].nbytes)
        time.sleep(0.02)
    s.close(final_commit=False)
    s.raise_if_failed()
    assert s.stats["commits"] >= 2, s.stats
    assert s.stats["steps_marked"] > 0
    rep = resolve_chain(root)
    target = {
        "app": StateDict(
            w=torch.zeros((256, 64)), b=torch.zeros(128)
        )
    }
    Snapshot(rep.head_path).restore(target)
    matches = [
        i
        for i, (w, b) in enumerate(boundary_states)
        if torch.equal(target["app"]["w"], w)
        and torch.equal(target["app"]["b"], b)
    ]
    assert matches, "head is not any step-boundary state (torn capture)"


def test_compaction_bounds_chain_and_retires_members(tmp_path):
    root = str(tmp_path / "stream")
    state = _state(4)
    s = Snapshot.stream(root, state, cadence_s=3600, max_chain=2)
    for i in range(5):
        state["app"]["w"][i, :] = float(i)
        s.commit_now()
    expected = state["app"]["w"].clone()
    s.close(final_commit=False)
    assert s.stats["compactions"] >= 1, s.stats
    assert len(s.chain) <= 2, s.chain
    rep = resolve_chain(root)
    # Superseded members were retired from disk (local fs).
    on_disk = {m.name for m in rep.members}
    assert set(s.chain) <= on_disk
    assert len(on_disk) <= 3, on_disk  # chain + at most the fresh head
    # The compacted base is self-contained and the head restores.
    target = {
        "app": StateDict(
            w=torch.zeros((256, 64)), b=torch.zeros(128)
        )
    }
    Snapshot(rep.head_path).restore(target)
    assert torch.equal(target["app"]["w"], expected)
    assert verify_snapshot(rep.head_path).clean


def test_resolve_chain_names_torn_tail_and_debris(tmp_path):
    import json

    root = str(tmp_path / "stream")
    state = _state(5)
    s = Snapshot.stream(root, state, cadence_s=3600)
    state["app"]["w"][0, 0] = 9.0
    s.commit_now()
    s.close(final_commit=False)
    # Manufacture a torn tail: journal marker with stream fields, no
    # metadata — exactly what a SIGKILLed micro-commit leaves.
    torn = tmp_path / "stream" / member_name(2) / ".tpusnap"
    torn.mkdir(parents=True)
    (torn / "journal").write_text(
        json.dumps(
            {
                "take_id": "deadbeef",
                "world_size": 1,
                "started_at": 0.0,
                "incremental_from": "../" + member_name(1),
                "stream": {
                    "stream": s.stream_id,
                    "seq": 2,
                    "parent": member_name(1),
                },
            }
        )
    )
    # ... and a debris dir (half-retired compaction leftover).
    junk = tmp_path / "stream" / "delta-000090"
    junk.mkdir()
    (junk / "leftover.blob").write_bytes(b"x" * 32)
    rep = resolve_chain(root)
    assert rep.torn_tail == member_name(2)
    assert rep.head == member_name(1)  # recovery ignores the torn tail
    assert "delta-000090" in rep.debris
    # fsck of the torn member classifies it and names the delta state.
    from tpusnap_torch.lifecycle import fsck_snapshot

    fr = fsck_snapshot(str(tmp_path / "stream" / member_name(2)))
    assert fr.state == "torn"
    assert fr.delta and fr.delta["seq"] == 2
    assert "torn delta micro-commit seq 2" in fr.summary()
    # (The root-level CLI half — fsck exit 4, info's chain — is A9's.)


def test_retention_pins_chain_of_kept_head(tmp_path):
    """`retain --keep 1` on a stream root: the kept head references
    earlier members (unchanged blobs dedup into them) — retention must
    materialize it BEFORE deleting them, never leaving a dangling
    chain."""
    from tpusnap_torch.retention import _referenced_bases, apply_retention

    root = str(tmp_path / "stream")
    state = _state(6)
    s = Snapshot.stream(root, state, cadence_s=3600, max_chain=100)
    # b never changes -> every increment references the base's b blob.
    state["app"]["w"][0, :] = 1.0
    s.commit_now()
    state["app"]["w"][1, :] = 2.0
    s.commit_now()
    expected_w = state["app"]["w"].clone()
    expected_b = state["app"]["b"].clone()
    s.close(final_commit=False)
    head = os.path.join(root, member_name(2))
    bases = _referenced_bases(head)
    assert any(member_name(0) in b for b in bases), bases
    plan = apply_retention(root, keep_last=1)
    assert plan.keep == [os.path.abspath(head)]
    assert plan.materialize == [os.path.abspath(head)], (
        "kept head referencing doomed chain members must be materialized"
    )
    assert not os.path.exists(os.path.join(root, member_name(0)))
    target = {
        "app": StateDict(
            w=torch.zeros((256, 64)), b=torch.zeros(128)
        )
    }
    Snapshot(head).restore(target)
    assert torch.equal(target["app"]["w"], expected_w)
    assert torch.equal(target["app"]["b"], expected_b)
    assert verify_snapshot(head).clean


def test_referenced_bases_walks_transitively(tmp_path):
    """Defense in depth: a hand-built NON-collapsed chain (C→B→A where
    C's metadata only names B) must still pin A through the transitive
    walk."""
    from tpusnap_torch.retention import _referenced_bases

    a, b, c = (str(tmp_path / n) for n in ("a", "b", "c"))
    st = _state(7)
    Snapshot.take(a, st)
    st["app"]["w"][0, 0] += 1  # w rewrites in b; bias still refs a
    Snapshot.take(b, st, incremental_from=a)
    # Nothing changes: c references b's w AND (collapsed) a's bias.
    Snapshot.take(c, st, incremental_from=b)
    direct = _referenced_bases(c)
    assert os.path.abspath(a) in direct and os.path.abspath(b) in direct
    # b itself references only a; the transitive walk from c reaches a
    # even through b (defense in depth for non-collapsed chains).
    assert _referenced_bases(b) == [os.path.abspath(a)]



def test_stream_multiprocess_needs_coordination(tmp_path):
    """A multi-process stream runs its elastic control plane over the
    process group's TCPStore — opening one without it must fail loudly,
    not wedge."""
    from tpusnap_torch.comm import Communicator

    class FakeMulti(Communicator):
        @property
        def world_size(self):
            return 2

    with pytest.raises(RuntimeError, match="TCPStore"):
        Snapshot.stream(
            str(tmp_path / "s"), _state(), comm=FakeMulti()
        )


def test_stream_resumes_committed_chain(tmp_path):
    """Reopening a stream root RESUMES the committed chain across
    process lifetimes: the new stream adopts the head's stream id and
    sequence, takes no new base, and its first micro-commit extends
    the existing chain."""
    root = str(tmp_path / "stream")
    state = _state(11)
    s = Snapshot.stream(root, state, cadence_s=3600)
    sid = s.stream_id
    state["app"]["w"][0, 0] = 1.0
    s.commit_now()
    s.close(final_commit=False)

    s2 = Snapshot.stream(root, state, cadence_s=3600)
    try:
        assert s2.stream_id == sid
        assert s2.seq == 1  # adopted, not reset
        state["app"]["w"][0, 1] = 2.0
        snap = s2.commit_now()
        assert s2.seq == 2
        # No second base: the resumed commit extends the old chain.
        assert not os.path.isdir(
            os.path.join(root, "base-000001")
        )
        restored = _state()
        snap.restore(restored)
        assert torch.equal(restored["app"]["w"], state["app"]["w"])
        rep = resolve_chain(root)
        assert rep.head == member_name(2)
        assert member_name(0) in rep.chain
        assert verify_snapshot(rep.head_path).clean
    finally:
        s2.close(final_commit=False)


def test_stream_refuses_foreign_root(tmp_path):
    """A root holding committed NON-stream snapshots still refuses: a
    fresh base under foreign snapshot dirs would silently change what
    the directory means."""
    root = str(tmp_path / "root")
    Snapshot.take(os.path.join(root, "plain"), _state(11))
    with pytest.raises(ValueError, match="non-stream"):
        Snapshot.stream(root, _state(11), cadence_s=3600)


def test_stream_rejects_nonpositive_cadence(tmp_path):
    with pytest.raises(ValueError, match="cadence_s"):
        Snapshot.stream(str(tmp_path / "s"), _state(12), cadence_s=0)
    with pytest.raises(ValueError, match="cadence_s"):
        Snapshot.stream(str(tmp_path / "s"), _state(12), cadence_s=-1.5)



def test_commit_after_close_raises(tmp_path):
    s = Snapshot.stream(str(tmp_path / "s"), _state(9), cadence_s=3600)
    s.close(final_commit=False)
    with pytest.raises(RuntimeError, match="closed"):
        s.commit_now()
    # close is idempotent.
    assert s.close() is not None


def test_chain_lookups_stay_flat(tmp_path):
    """Writer-side collapse: every external location of a deep head
    points DIRECTLY at the member holding the bytes (one '../' hop) —
    lookups never chase intermediate members."""
    root = str(tmp_path / "stream")
    state = _state(10)
    s = Snapshot.stream(root, state, cadence_s=3600, max_chain=100)
    for i in range(4):
        state["app"]["w"][i, :] = float(i + 1)
        s.commit_now()
    s.close(final_commit=False)
    md = load_snapshot_metadata(os.path.join(root, member_name(4)))
    from tpusnap_torch.inspect import iter_blobs
    from tpusnap_torch.manifest_ops import external_reference_depth

    # The chain-resolution invariant: at any chain depth, every lookup
    # is ONE parent hop ("../<member>/<path>"), never a chase through
    # intermediates.
    assert external_reference_depth(md.manifest) <= 1
    for blob in iter_blobs(md.manifest):
        if blob.location.startswith("../"):
            member = blob.location.split("/")[1]
            assert os.path.isdir(os.path.join(root, member)), blob.location


# ------------------------------------------------------------ cross-package
#
# The same train state (the tiny flagship, tpusnap's weights carried into
# the port with ``params_from_jax``/``train_state_from_jax``) streams
# through either package. Dedup across packages needs both sides to
# record the same algorithms, so each case asserts them.

_TINY = dict(vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16)


def _jax_train_state():
    import jax

    from tpusnap.models.transformer import Transformer as JaxTransformer
    from tpusnap.models.transformer import TransformerConfig as JaxConfig
    from tpusnap.models.transformer import init_train_state, make_mesh

    model = JaxTransformer(JaxConfig(**_TINY))
    return init_train_state(model, make_mesh(jax.devices()[:1]), jax.random.PRNGKey(0))


def _port_model(jax_state=None, seed=0):
    import jax

    from tpusnap_torch.models import Transformer, TransformerConfig

    model = Transformer(TransformerConfig(**_TINY), device="cpu", seed=seed)
    if jax_state is not None:
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
    import json

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
        if isinstance(e, dict):
            visit(e)
    return crc, dedup


def test_tpusnap_stream_root_resolves_and_resumes_in_port(tmp_path):
    import tpusnap
    from tpusnap import PytreeState
    from tpusnap.delta import resolve_chain as jax_resolve_chain

    root = str(tmp_path / "stream")
    jax_state = _jax_train_state()
    js = tpusnap.Snapshot.stream(root, {"train": PytreeState(jax_state)}, cadence_s=3600)
    js.commit_now()
    js.close(final_commit=False)
    ref = jax_resolve_chain(root)
    got = resolve_chain(root)
    assert (got.head, got.chain, got.torn_tail) == (ref.head, ref.chain, ref.torn_tail)
    assert [(m.name, m.state, m.seq, m.parent) for m in got.members] == [
        (m.name, m.state, m.seq, m.parent) for m in ref.members
    ]

    # The port resumes tpusnap's chain: same stream, next sequence
    # number, and a micro-commit that dedups against tpusnap's members.
    model = _port_model(jax_state)
    ps = Snapshot.stream(root, {"train": StateDict(**model.train_state())}, cadence_s=3600)
    try:
        assert ps.stream_id == js.stream_id and ps.seq == js.seq
        snap = ps.commit_now()
        assert delta_payload_bytes(snap.metadata) == 0
        with torch.no_grad():
            model.embed[3].add_(1.0)
        snap = ps.commit_now()
        assert 0 < delta_payload_bytes(snap.metadata) <= model.embed.numel() * 4
    finally:
        ps.close(final_commit=False)
    head = resolve_chain(root).head_path
    assert _algos(head) == _algos(os.path.join(root, member_name(0))) == (
        {"crc32c"}, {"xxh64"}
    )
    loaded = tpusnap.load_snapshot(head)["train"]
    for p, t in _leaves(model.train_state()):
        node = loaded
        for k in p.split("/"):
            node = node[k]
        assert np.asarray(node).tobytes() == t.detach().numpy().tobytes(), p


def test_port_stream_restores_through_tpusnap(tmp_path):
    import tpusnap
    from tpusnap.delta import resolve_chain as jax_resolve_chain

    root = str(tmp_path / "stream")
    model = _port_model(seed=3)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, _TINY["vocab_size"], (2, 16))
    )
    boundaries = []
    with Snapshot.stream(
        root, {"train": StateDict(**model.train_state())}, cadence_s=3600
    ) as s:
        for _ in range(3):
            model.train_step(tokens)
            s.mark_step()
            boundaries.append({p: t.detach().clone() for p, t in _leaves(model.train_state())})
            s.commit_now()
    rep = resolve_chain(root)
    assert rep.head == jax_resolve_chain(root).head
    assert _algos(rep.head_path) == ({"crc32c"}, {"xxh64"})
    # tpusnap restores the head (the close's final commit: the last
    # boundary), and every member to its own boundary, bit for bit.
    for seq, want in [(4, boundaries[-1])] + [(i + 1, b) for i, b in enumerate(boundaries)]:
        loaded = tpusnap.load_snapshot(os.path.join(root, member_name(seq)))["train"]
        for p, t in want.items():
            node = loaded
            for k in p.split("/"):
                node = node[k]
            assert np.asarray(node).tobytes() == t.numpy().tobytes(), (seq, p)
