"""tpusnap_torch snapshots: the port's own round trips on CPU tensors, and
cross-package round trips with tpusnap in both directions, bit-exact.

Both packages must record the same checksum algorithm (``crc32c``, the
native build): a mismatch makes the reader skip verification with only a
warning, which would turn every cross-package check here into a silent
pass.
"""

import json
import os

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
from tpusnap_torch import Snapshot, StateDict, load_snapshot
from tpusnap_torch import _native as torch_native
from tpusnap_torch.knobs import override_batching_disabled
from tpusnap_torch.models import Transformer, TransformerConfig
from tpusnap_torch.serialization import SUPPORTED_DTYPES

# One intra-op thread: the suite runs beside other test processes, and
# torch's default of one spinning thread per core starves their timing.
torch.set_num_threads(1)

_TINY = dict(vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16)


def _all_dtype_tensors(seed=0):
    """One tensor per dtype string, values from numpy, plus 0-d ones."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, dtype in SUPPORTED_DTYPES.items():
        if dtype == torch.bool:
            t = torch.from_numpy(rng.integers(0, 2, (3, 5)).astype(bool))
        elif dtype.is_complex:
            re = rng.standard_normal((3, 5))
            im = rng.standard_normal((3, 5))
            t = torch.from_numpy((re + 1j * im).astype(np.complex128)).to(dtype)
        elif dtype.is_floating_point:
            t = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)).to(dtype)
        else:
            # Every bit pattern of the width, via a uint8 view: covers the
            # unsigned types torch has few operators for.
            raw = rng.integers(0, 256, 15 * dtype.itemsize).astype(np.uint8)
            t = torch.from_numpy(raw).view(dtype).reshape(3, 5)
        out[name] = t
    out["scalar_f32"] = torch.tensor(3.25, dtype=torch.float32)
    out["scalar_i32"] = torch.tensor(-7, dtype=torch.int32)
    out["scalar_bf16"] = torch.tensor(1.5, dtype=torch.bfloat16)
    return out


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (
        a.dtype == b.dtype
        and a.shape == b.shape
        and bytes(a.contiguous().reshape(-1).view(torch.uint8).numpy())
        == bytes(b.contiguous().reshape(-1).view(torch.uint8).numpy())
    )


def _checksum_algos(path):
    md = json.load(open(os.path.join(path, ".snapshot_metadata")))
    algos = {md["self_checksum"].split(":")[0]}
    for e in md["manifest"].values():
        if "checksum" in e:
            algos.add(e["checksum"].split(":")[0])
    return algos


@pytest.mark.parametrize("batching_disabled", [False, True], ids=["batching_on", "batching_off"])
def test_every_dtype_round_trips(tmp_path, batching_disabled):
    tensors = _all_dtype_tensors()
    param = torch.nn.Parameter(torch.arange(12, dtype=torch.float32).reshape(3, 4))
    state = StateDict(t=dict(tensors), p=param, step=11, lr=0.5, tag="x")
    path = str(tmp_path / "snap")
    with override_batching_disabled(batching_disabled):
        snap = Snapshot.take(path, {"s": state})
    locations = [
        e.location for e in snap.metadata.manifest.values() if getattr(e, "location", None)
    ]
    assert any(loc.startswith("batched/") for loc in locations) != batching_disabled
    assert _checksum_algos(path) == {"crc32c"}

    targets = {k: torch.zeros_like(v) for k, v in tensors.items()}
    target_param = torch.nn.Parameter(torch.zeros(3, 4))
    restored = StateDict(t=dict(targets), p=target_param, step=0, lr=0.0, tag="")
    Snapshot(path).restore({"s": restored})
    assert restored["p"] is target_param  # in place: identity kept
    assert torch.equal(target_param, param)
    for k, v in tensors.items():
        assert restored["t"][k] is targets[k], k
        assert _same_bits(targets[k], v), k
    assert (restored["step"], restored["lr"], restored["tag"]) == (11, 0.5, "x")

    for k, v in tensors.items():
        assert _same_bits(Snapshot(path).read_object(f"0/s/t/{k}"), v), k
    loaded = load_snapshot(path)["s"]
    assert _same_bits(loaded["t"]["bfloat16"], tensors["bfloat16"])


def test_read_object_tiled_under_budget(tmp_path):
    big = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 32)).astype(np.float32))
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"s": StateDict(big=big, other=torch.ones(3))})
    got = Snapshot(path).read_object("0/s/big", memory_budget_bytes=1024)
    assert torch.equal(got, big)
    out = torch.zeros_like(big)
    assert Snapshot(path).read_object("0/s/big", obj_out=out, memory_budget_bytes=1024) is out
    assert torch.equal(out, big)


def test_restore_casts_and_fills_strided_targets(tmp_path):
    src = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"s": StateDict(a=src, b=src.to(torch.bfloat16))})
    strided = torch.zeros(4, 3).t()  # non-contiguous target
    upcast = torch.zeros(3, 4)  # f32 target for the bf16 blob
    Snapshot(path).restore({"s": StateDict(a=strided, b=upcast)})
    assert torch.equal(strided, src) and torch.equal(upcast, src)


# ------------------------------------------------------------ cross-package


def _jax_train_state():
    model = JaxTransformer(JaxConfig(**_TINY))
    return init_train_state(model, make_mesh(jax.devices()[:1]), jax.random.PRNGKey(0))


def _port_train_state_from(jax_state):
    model = Transformer(TransformerConfig(**_TINY), device="cpu")
    model.train_state_from_jax(jax.tree.map(np.asarray, jax_state))
    with torch.no_grad():  # a non-zero step and moments, as after training
        model.opt_state["step"].fill_(3)
        for i, (_, mu) in enumerate(_leaves(model.opt_state["mu"])):
            mu.add_(0.01 * (i + 1))
    return model


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.mark.parametrize("batching_disabled", [False, True], ids=["batching_on", "batching_off"])
def test_port_snapshot_reads_through_tpusnap(tmp_path, batching_disabled):
    model = _port_train_state_from(_jax_train_state())
    path = str(tmp_path / "port")
    with override_batching_disabled(batching_disabled):
        Snapshot.take(
            path,
            {"train": StateDict(**model.train_state()), "progress": StateDict(step=3)},
        )
    assert torch_native.checksum_algorithm() == "crc32c"
    assert _checksum_algos(path) == {"crc32c"}
    loaded = tpusnap.load_snapshot(path)
    md, read = _external_reader(path)
    assert md["world_size"] == 1
    assert loaded["progress"] == {"step": 3} and read("0/progress/step") == 3
    for p, t in _leaves(model.train_state()):
        want = t.detach().numpy()
        node = loaded["train"]
        for k in p.split("/"):
            node = node[k]
        got_loaded = np.asarray(node)
        got_external = read(f"0/train/{p}")
        for got in (got_loaded, got_external):
            assert got.dtype == want.dtype and got.shape == want.shape, p
            assert got.tobytes() == want.tobytes(), p


def test_tpusnap_snapshot_restores_into_port(tmp_path):
    from tpusnap import PytreeState
    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import StateDict as JaxStateDict

    jax_state = _jax_train_state()
    path = str(tmp_path / "jax")
    JaxSnapshot.take(
        path, {"train": PytreeState(jax_state), "progress": JaxStateDict(step=5)}
    )
    assert _checksum_algos(path) == {"crc32c"}
    model = Transformer(TransformerConfig(**_TINY), device="cpu", seed=123)
    before = {p: id(t) for p, t in _leaves(model.train_state())}
    train, progress = StateDict(**model.train_state()), StateDict(step=0)
    Snapshot(path).restore({"train": train, "progress": progress})
    assert progress["step"] == 5
    want = dict(_leaves(jax.tree.map(np.asarray, jax_state)))
    for p, t in _leaves(model.train_state()):
        assert id(t) == before[p], p
        got = t.detach().numpy()
        assert got.dtype == want[p].dtype and got.shape == want[p].shape, p
        assert got.tobytes() == want[p].tobytes(), p


def test_slab_layout_matches_tpusnap_byte_for_byte(tmp_path):
    """The same small arrays packed by each package: identical slab bytes
    and identical per-member ranges and checksums."""
    from tpusnap import Snapshot as JaxSnapshot
    from tpusnap import StateDict as JaxStateDict

    rng = np.random.default_rng(3)
    # 32-bit ints and floats: JAX without x64 would narrow 64-bit ones.
    arrays = {
        "a": rng.standard_normal((4, 6)).astype(np.float32),
        "b": rng.integers(-9, 9, (7,)).astype(np.int32),
        "c": rng.integers(0, 2, (5,)).astype(bool),
        "d": rng.standard_normal((3,)).astype(np.float16),
        "e": np.asarray(2.5, dtype=np.float32),
    }
    jax_path, port_path = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxSnapshot.take(
        jax_path, {"s": JaxStateDict({k: jax.numpy.asarray(v) for k, v in arrays.items()})}
    )
    Snapshot.take(port_path, {"s": StateDict({k: torch.from_numpy(v) for k, v in arrays.items()})})

    def slab(path):
        md = json.load(open(os.path.join(path, ".snapshot_metadata")))
        entries = {k: v for k, v in md["manifest"].items() if v["type"] == "Tensor"}
        locations = {e["location"] for e in entries.values()}
        assert len(locations) == 1 and next(iter(locations)).startswith("batched/")
        with open(os.path.join(path, next(iter(locations))), "rb") as f:
            data = f.read()
        meta = {
            k: (e["byte_range"], e["checksum"], e["dtype"], e["shape"])
            for k, e in entries.items()
        }
        return data, meta

    assert slab(jax_path) == slab(port_path)


_KNOB_CASES = (
    "metrics_export", "history", "fleet_dir", "autotune", "slo_rpo", "slo_rto",
    "access_ledger", "probe",
)


def _knob_case_works(call, tmp_path, monkeypatch, path, state):
    """One of the eight knobs that were refused by name before the
    telemetry consumers were ported: each now turns its consumer on, and
    the take (and restore) shows it working."""
    from tpusnap_torch import telemetry as ttele
    from tpusnap_torch.history import load_history
    from tpusnap_torch.metrics_export import parse_prometheus_textfile

    tele_dir = str(tmp_path / "tele")
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", tele_dir)
    monkeypatch.setenv("TPUSNAP_JOB_ID", "knobjob")
    env = {
        "metrics_export": {"TPUSNAP_METRICS_EXPORT": "prom"},
        "history": {"TPUSNAP_HISTORY": "1"},
        "fleet_dir": {"TPUSNAP_FLEET_DIR": str(tmp_path / "fleet")},
        "autotune": {"TPUSNAP_AUTOTUNE": "1"},
        "slo_rpo": {"TPUSNAP_SLO_RPO_S": "3600"},
        "slo_rto": {"TPUSNAP_SLO_RTO_S": "3600"},
        "access_ledger": {"TPUSNAP_ACCESS_LEDGER": "1"},
        "probe": {"TPUSNAP_PROBE": "1", "TPUSNAP_PROBE_BYTES": str(1 << 20)},
    }[call]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    Snapshot.take(path, state)
    target = {"s": StateDict(x=torch.zeros(2))}
    Snapshot(path).restore(target)
    assert torch.equal(target["s"]["x"], state["s"]["x"])
    if call == "metrics_export":
        prom = os.path.join(tele_dir, "tpusnap_knobjob_rank0.prom")
        fams = parse_prometheus_textfile(open(prom).read())
        assert {"tpusnap_take_seconds", "tpusnap_restores_total"} <= set(fams)
    elif call == "history":
        kinds = [e["kind"] for e in load_history(os.path.join(tele_dir, "history.jsonl"))]
        assert kinds == ["take", "restore"]
    elif call == "fleet_dir":
        rec = json.load(open(str(tmp_path / "fleet" / "knobjob.json")))
        assert rec["job_id"] == "knobjob"
    elif call == "autotune":
        # Too little history for a plan: the take runs on the defaults
        # and says nothing; the knob was read, not refused.
        assert "tuned" not in (ttele.LAST_TAKE_SUMMARY.get("meta") or {})
        events = load_history(os.path.join(tele_dir, "history.jsonl"))
        assert [e["kind"] for e in events] == ["take", "restore"]
    elif call in ("slo_rpo", "slo_rto"):
        rec = json.load(open(os.path.join(tele_dir, "slo", "rank_0.json")))
        key = "rpo_s" if call == "slo_rpo" else "rto_s"
        assert rec["thresholds"][key] == 3600.0 and not rec["breach"][key[:3]]
        assert rec["snapshot_bytes"] == 8 and rec["data_at_risk_bytes"] == 0
    elif call == "access_ledger":
        from tpusnap_torch import access

        records = access.load_ledger_records(path)
        assert [(r["lp"], r["loc"], r["range"], r["bytes"]) for r in records] == [
            ("s/x", "0/s/x", [0, 8], 8)
        ]
    else:
        probe = ttele.LAST_TAKE_SUMMARY.get("probe") or {}
        assert probe.get("probes", 0) >= 1 and probe.get("write_gbps_p50", 0) > 0
        assert ttele.LAST_RESTORE_SUMMARY.get("probe", {}).get("probes", 0) >= 1


@pytest.mark.parametrize(
    "call",
    ["tier_incremental_from", "stream", "s3_url", *_KNOB_CASES],
)
def test_unported_features_raise(tmp_path, monkeypatch, call):
    """Features this test once saw refused now work: an incremental take
    over a tier URL, a delta stream, an ``s3://`` take (which needs
    ``aiobotocore``, absent here, and says so before anything is
    written), and each knob of the telemetry consumers."""
    path = str(tmp_path / "snap")
    state = {"s": StateDict(x=torch.ones(2))}
    if call in _KNOB_CASES:
        _knob_case_works(call, tmp_path, monkeypatch, path, state)
        return
    if call == "s3_url":
        with pytest.raises(RuntimeError, match="requires aiobotocore"):
            Snapshot.take("s3://bucket/snap", state)
        return
    if call == "tier_incremental_from":
        monkeypatch.setenv("TPUSNAP_TIER_DRAIN", "0")
        tier = "tier+local=" + str(tmp_path / "cache") + "+remote=fs://" + str(tmp_path / "remote")
        Snapshot.take(tier + "/base", state)
        state["s"]["x"][1] = 5.0
        Snapshot.take(path, state, incremental_from=tier + "/base")
    else:
        with Snapshot.stream(path, state, cadence_s=3600) as stream:
            state["s"]["x"][1] = 5.0
            path = stream.commit_now().path
    target = {"s": StateDict(x=torch.zeros(2))}
    Snapshot(path).restore(target)
    assert torch.equal(target["s"]["x"], torch.tensor([1.0, 5.0]))


def test_incremental_from_writes_only_changed_blobs(tmp_path):
    """Formerly a "not ported" case: an increment of the flagship train
    state after one optimizer moment changed writes that tensor alone."""
    model = _port_train_state_from(_jax_train_state())
    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    with override_batching_disabled(True):
        Snapshot.take(base, {"train": StateDict(**model.train_state())})
        with torch.no_grad():
            model.opt_state["mu"]["ln_f"].add_(1.0)
        snap = Snapshot.take(
            inc, {"train": StateDict(**model.train_state())}, incremental_from=base
        )
    # Blobs only: the metadata and the .tpusnap/ sidecars (trace,
    # heartbeat, flight log) are not payload.
    written = sorted(
        os.path.relpath(os.path.join(d, f), inc)
        for d, _, fs in os.walk(inc) for f in fs
        if f != ".snapshot_metadata" and ".tpusnap" not in os.path.relpath(d, inc)
    )
    assert written == ["0/train/opt/mu/ln_f"]
    assert snap.metadata.base_roots == ["../base"]
    fresh = Transformer(TransformerConfig(**_TINY), device="cpu", seed=5)
    Snapshot(inc).restore({"train": StateDict(**fresh.train_state())})
    for (p, want), (_, got) in zip(_leaves(model.train_state()), _leaves(fresh.train_state())):
        assert _same_bits(want.detach(), got.detach()), p


def test_compress_on_round_trips_through_both_packages(tmp_path, monkeypatch):
    """Formerly a "not ported" case: ``TPUSNAP_COMPRESS=on`` compresses
    the eligible blobs, and both packages restore them bit-exact."""
    monkeypatch.setenv("TPUSNAP_COMPRESS", "on")
    monkeypatch.setenv("TPUSNAP_COMPRESS_MIN_BLOB_BYTES", "65536")
    rng = np.random.default_rng(8)
    big = torch.from_numpy(rng.integers(-3, 3, (512, 256)).astype(np.float32))
    path = str(tmp_path / "snap")
    with override_batching_disabled(True):
        snap = Snapshot.take(path, {"s": StateDict(big=big, small=torch.ones(4))})
    entry = snap.metadata.manifest["0/s/big"]
    assert entry.codec == "shuf4+lz4" and sum(entry.comp_tile_sizes) < big.numel() * 4
    assert snap.metadata.manifest["0/s/small"].codec is None  # under the floor
    out = torch.zeros_like(big)
    Snapshot(path).restore({"s": StateDict(big=out, small=torch.zeros(4))})
    assert torch.equal(out, big)
    assert np.asarray(tpusnap.Snapshot(path).read_object("0/s/big")).tobytes() == big.numpy().tobytes()
