"""tpusnap_torch's write-load partitioner, without processes.

Ports of the partitioner cases of tests/test_partitioner_batcher.py (the
greedy assignment, consolidation preferring the writer's version, the
drift guard that pins unit ids and costs against actually prepared
entries) and checks against tpusnap's partitioner on the same numpy
inputs: the same units, base loads and writer assignment.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusnap import partitioner as jax_partitioner
from tpusnap.knobs import override_max_chunk_size_bytes as jax_override_max_chunk
from tpusnap_torch.io_preparer import prepare_write
from tpusnap_torch.knobs import override_max_chunk_size_bytes
from tpusnap_torch.manifest import (
    Chunk,
    ChunkedTensorEntry,
    ObjectEntry,
    PrimitiveEntry,
    TensorEntry,
)
from tpusnap_torch.partitioner import (
    _greedy_assign,
    assign_replicated_units,
    consolidate_replicated_entries,
    estimate_write_loads,
    filter_assigned_write_reqs,
)
from tpusnap_torch.serialization import tensor_nbytes

torch.set_num_threads(1)


def _tensor_entry(path, nbytes=100, replicated=True, location=None):
    return TensorEntry(
        location=location or f"replicated/{path}",
        serializer="buffer_protocol",
        dtype="uint8",
        shape=[nbytes],
        replicated=replicated,
    )


def test_greedy_assignment_balances():
    units = [(f"u{i}", [f"p{i}"], size) for i, size in enumerate([100, 90, 50, 40, 30, 10])]
    assignment = _greedy_assign(units, [0, 0, 0])
    loads = [0, 0, 0]
    for key, _, size in units:
        loads[assignment[key]] += size
    assert max(loads) - min(loads) <= 40
    assert set(assignment.values()) == {0, 1, 2}


def test_greedy_respects_preexisting_load():
    assert _greedy_assign([("u", ["p"], 10)], [1000, 0])["u"] == 1


def test_consolidate_prefers_writer_batched_version():
    """The writer's slab-batched entry wins over rank 0's unbatched copy;
    otherwise the manifest points at a blob nobody wrote."""
    rank0 = {"m/w": _tensor_entry("m/w")}
    rank1_entry = _tensor_entry("m/w", location="batched/abc123")
    rank1_entry.byte_range = [0, 100]
    merged = consolidate_replicated_entries([rank0, {"m/w": rank1_entry}])
    assert merged["0/m/w"].location == "batched/abc123"
    assert merged["0/m/w"].byte_range == [0, 100]
    assert "1/m/w" not in merged


def test_consolidate_keeps_per_rank_entries():
    rank0 = {"m/x": _tensor_entry("m/x", replicated=False, location="0/m/x")}
    rank1 = {"m/x": _tensor_entry("m/x", replicated=False, location="1/m/x")}
    merged = consolidate_replicated_entries([rank0, rank1])
    assert merged["0/m/x"].location == "0/m/x"
    assert merged["1/m/x"].location == "1/m/x"


def test_consolidate_merges_chunks_per_writer():
    """Chunks of one replicated entry written by different ranks: each
    chunk takes its writer's (stage-time checksummed) version."""

    def chunked(marked):
        chunks = []
        for i, m in enumerate(marked):
            t = _tensor_entry(f"m/w_{i}", location=f"replicated/m/w_{i}")
            if m:
                t.checksum = f"crc32c:{i}"
            chunks.append(Chunk(offsets=[i, 0], sizes=[1, 100], tensor=t))
        return ChunkedTensorEntry(
            dtype="uint8", shape=[len(marked), 100], chunks=chunks, replicated=True
        )

    merged = consolidate_replicated_entries(
        [{"m/w": chunked([True, False])}, {"m/w": chunked([False, True])}]
    )
    assert [c.tensor.checksum for c in merged["0/m/w"].chunks] == ["crc32c:0", "crc32c:1"]


def _cast(path, t, tracing):
    return t.to(torch.bfloat16) if path.endswith("big") else t


def test_estimate_matches_prepared_entries():
    """Drift guard: the estimate's unit ids and costs agree with what
    prepare_write produces; a disagreement would degrade into duplicate
    writes."""
    with override_max_chunk_size_bytes(16 * 1024):
        flattened = {
            "m/big": torch.zeros(64, 256),  # chunked, cast to bf16
            "m/small": torch.arange(100, dtype=torch.float32),
            "m/lr": 0.1,  # primitive
            "m/blob": {1, 2, 3},  # pickled object
        }
        units, base, traced = estimate_write_loads(
            flattened, sorted(flattened), array_prepare_func=_cast
        )
        assert set(traced) == {"m/big", "m/small"}
        assert base == 0
        unit_ids = {u for u, _ in units}
        unit_costs = dict(units)
        for path, leaf in flattened.items():
            entry, _ = prepare_write(
                obj=leaf, logical_path=path, rank=0, replicated=True,
                array_prepare_func=functools.partial(_cast, path),
            )
            if isinstance(entry, PrimitiveEntry):
                assert (path, 0) in units
            elif isinstance(entry, ChunkedTensorEntry):
                for i, chunk in enumerate(entry.chunks):
                    uid = f"{path}::{i}"
                    assert uid in unit_ids, (uid, sorted(unit_ids))
                    assert unit_costs[uid] == tensor_nbytes(chunk.tensor.dtype, chunk.tensor.shape)
                assert f"{path}::{len(entry.chunks)}" not in unit_ids
                assert entry.dtype == "bfloat16"
            elif isinstance(entry, TensorEntry):
                assert unit_costs[path] == tensor_nbytes(entry.dtype, entry.shape)
            else:
                assert isinstance(entry, ObjectEntry) and path in unit_ids


def test_filter_drops_requests_assigned_elsewhere():
    """Each rank keeps its own replicated requests and every non-replicated
    one; the requests of units assigned to other ranks are dropped."""
    flattened = {f"m/p{i}": torch.full((64,), float(i)) for i in range(4)}
    flattened["m/own"] = torch.ones(8)
    repl = sorted(p for p in flattened if p != "m/own")
    units, base, _ = estimate_write_loads(flattened, repl)
    assignment, common = assign_replicated_units([units, units], [base, base])
    assert common == set(repl)
    kept_by_rank = {}
    for rank in (0, 1):
        entries, reqs = {}, []
        for path, leaf in flattened.items():
            entry, r = prepare_write(leaf, path, rank, replicated=path in common)
            entries[path] = entry
            reqs += r
        kept = filter_assigned_write_reqs(entries, reqs, repl, assignment, rank)
        kept_by_rank[rank] = sorted(wr.path for wr in kept)
        others = {f"replicated/{u}" for u, w in assignment.items() if w != rank}
        assert not others & set(kept_by_rank[rank])
        assert f"{rank}/m/own" in kept_by_rank[rank]
    written = [p for r in (0, 1) for p in kept_by_rank[r] if p.startswith("replicated/")]
    assert sorted(written) == [f"replicated/{p}" for p in repl]  # each once
    assert len(kept_by_rank[0]) == len(kept_by_rank[1])  # 2 of 4 each


def _jax_cast(path, arr, tracing):
    return arr.astype(jnp.bfloat16) if path.endswith("big") else arr


@pytest.mark.parametrize("case", ["dense", "chunked_cast", "uneven_ranks", "objects"])
def test_plan_matches_tpusnap(case):
    """The same numpy inputs through both packages' estimate and greedy
    assignment give the same units, base loads and writers."""
    rng = np.random.default_rng(7)
    shapes = [(rng.integers(1, 64), rng.integers(1, 64)) for _ in range(12)]
    arrays = {f"m/w{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate(shapes)}
    per_rank_np = [dict(arrays), dict(arrays)]
    fn_jax = fn_torch = None
    max_chunk = 512 * 1024 * 1024
    if case == "chunked_cast":
        arrays["m/big"] = rng.standard_normal((64, 256)).astype(np.float32)
        per_rank_np = [dict(arrays), dict(arrays)]
        fn_jax, fn_torch, max_chunk = _jax_cast, _cast, 16 * 1024
    elif case == "uneven_ranks":
        # Per-rank state of different sizes moves the replicated units.
        per_rank_np = [dict(arrays, own=np.zeros((300, 40), np.float32)), dict(arrays)]
    elif case == "objects":
        per_rank_np = [dict(arrays, lr=0.5, tags=["a", "b"]), dict(arrays, lr=0.5, tags=["a", "b"])]
    repl = sorted(p for p in per_rank_np[0] if p.startswith("m/"))
    if case == "objects":
        repl += ["lr", "tags"]

    def to_torch(v):
        return torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) else v

    with override_max_chunk_size_bytes(max_chunk), jax_override_max_chunk(max_chunk):
        jax_est = [
            jax_partitioner.estimate_write_loads(
                {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in flat.items()},
                repl, array_prepare_func=fn_jax,
            )
            for flat in per_rank_np
        ]
        torch_est = [
            estimate_write_loads(
                {k: to_torch(v) for k, v in flat.items()}, repl, array_prepare_func=fn_torch
            )
            for flat in per_rank_np
        ]
    for (ju, jb, jt), (tu, tb, tt) in zip(jax_est, torch_est):
        assert ju == tu
        assert jb == tb
        assert {k: (d, list(s)) for k, (d, s) in jt.items()} == {
            k: (d, list(s)) for k, (d, s) in tt.items()
        }
    jax_plan = jax_partitioner.assign_replicated_units(
        [u for u, _, _ in jax_est], [b for _, b, _ in jax_est]
    )
    torch_plan = assign_replicated_units([u for u, _, _ in torch_est], [b for _, b, _ in torch_est])
    assert jax_plan == torch_plan
    assert set(torch_plan[0].values()) == {0, 1}
