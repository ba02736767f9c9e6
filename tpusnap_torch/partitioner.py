"""Write-load partitioner: spreads replicated write requests across ranks.

Counterpart of tpusnap/partitioner.py, computed on torch tensors. Every
rank holds an identical copy of each replicated value, so any rank can
write it; the partitioner makes sure each replicated unit is written by
exactly one rank, chosen greedily so that the write load balances:

- units: one per replicated entry; chunked tensors split per chunk;
- per-rank starting load: the rank's non-replicated write bytes (the
  boxes of DTensors it owns among them, at the stored width), estimated
  before prepare, without a collective, so they ride take's one
  pre-staging gather;
- every rank runs the same deterministic largest-first argmin greedy on
  the identical gathered inputs: no broadcast;
- each rank keeps only the write requests assigned to it, and drops the
  others before anything is staged. Manifest consolidation picks the
  writer's version of each entry (which may have been slab-batched or
  deduplicated): ``consolidate_replicated_entries``.

``reassign_dead_units`` (the degraded commit's adoption plan) belongs to
the rank-failure path, which is not ported yet.
"""

from __future__ import annotations

import logging
import sys
from typing import Dict, List, Tuple

import torch

from .io_types import WriteReq
from .knobs import get_max_chunk_size_bytes, is_partitioner_disabled
from .manifest import ChunkedTensorEntry, Entry, Manifest, PrimitiveEntry, is_replicated

logger = logging.getLogger(__name__)


def estimate_write_loads(
    flattened: Dict[str, object],
    replicated_candidates: List[str],
    array_prepare_func=None,
) -> Tuple[List[Tuple[str, int]], int, Dict[str, Tuple[str, List[int]]]]:
    """This rank's write-load estimate, before prepare and without a
    collective.

    Returns ``(replicated_units, base_load, traced_map)``: one
    ``(unit_id, cost)`` per replicated candidate (chunked tensors split
    per chunk, unit id ``"path::<chunk_idx>"``), the rank's
    non-replicated write bytes, and the traced post-transform
    ``{path: (dtype, shape)}`` of every tensor, handed to prepare_write so
    a transform is traced once. Costs are what the preparers will
    produce: tensor bytes under the save-time transform, chunk-grain
    splits, ``sys.getsizeof`` for pickled objects. The routing predicates
    are the preparers' own (``is_supported_array_dtype``,
    ``should_chunk``, ``chunk_row_ranges``, ``trace_array_prepare``), and
    tests pin the unit ids against actually prepared entries.

    ``array_prepare_func(logical_path, tensor, tracing)`` must be the
    transform later given to prepare_write."""
    import functools

    from .io_preparer import is_legacy_sharded_tensor
    from .io_preparers.array import is_supported_array_dtype, trace_array_prepare
    from .io_preparers.chunked import chunk_row_ranges, should_chunk
    from .io_preparers.sharded import _is_empty, _local_piece, is_sharded
    from .serialization import tensor_nbytes

    candidates = set(replicated_candidates)
    units: List[Tuple[str, int]] = []
    traced_map: Dict[str, Tuple[str, List[int]]] = {}
    base_load = 0
    for path in sorted(flattened):
        leaf = flattened[path]
        if PrimitiveEntry.supported(leaf):
            # Inlined in the metadata: no write load, but a replicated
            # primitive still needs a zero-cost unit so the intersection
            # marks its entry replicated.
            if path in candidates:
                units.append((path, 0))
            continue
        if is_legacy_sharded_tensor(leaf):
            continue  # prepare_write refuses it
        if is_sharded(leaf):
            # Never replicated-partitioned: the box this rank owns is its
            # own load, at the stored width (the trace, of the global
            # geometry, is handed on so the preparer does not trace again).
            dtype, _ = trace_array_prepare(
                leaf.to_local(),
                functools.partial(array_prepare_func, path)
                if array_prepare_func is not None
                else None,
            )
            traced_map[path] = (dtype, list(leaf.shape))
            piece = _local_piece(leaf)
            if piece is not None and piece[2] and not _is_empty(piece[1]):
                base_load += tensor_nbytes(dtype, piece[1])
            continue
        is_tensor = isinstance(leaf, torch.Tensor) and is_supported_array_dtype(leaf)
        dtype = None
        if is_tensor:
            dtype, shape = trace_array_prepare(
                leaf,
                functools.partial(array_prepare_func, path)
                if array_prepare_func is not None
                else None,
            )
            traced_map[path] = (dtype, shape)
            nbytes = tensor_nbytes(dtype, shape)
        else:
            nbytes = sys.getsizeof(leaf)
        if path not in candidates:
            base_load += nbytes
            continue
        if is_tensor and should_chunk(leaf):
            for i, (r0, r1) in enumerate(
                chunk_row_ranges(list(shape), dtype, get_max_chunk_size_bytes())
            ):
                units.append((f"{path}::{i}", tensor_nbytes(dtype, [r1 - r0] + list(shape[1:]))))
        else:
            units.append((path, nbytes))
    return units, base_load, traced_map


def assign_replicated_units(
    per_rank_units: List[List[Tuple[str, int]]],
    per_rank_base_loads: List[int],
    unit_valid=None,
) -> Tuple[Dict[str, int], set]:
    """The partition plan from the gathered per-rank estimates.

    A unit is partitionable only when every rank listed it (the
    replicated-path intersection) and ``unit_valid`` (if given) accepts
    it; a rank's other candidates count in its base load, since it writes
    them itself. Every rank computes the identical plan.

    Returns ``(assignment, common_paths)``: unit_id -> writer rank, and
    the logical paths whose entries are replicated on all ranks."""
    unit_sets = [{u for u, _ in units} for units in per_rank_units]
    common = set.intersection(*unit_sets) if unit_sets else set()
    if unit_valid is not None:
        common = {u for u in common if unit_valid(u)}
    loads = list(per_rank_base_loads)
    for r, units in enumerate(per_rank_units):
        loads[r] += sum(cost for u, cost in units if u not in common)
    # Costs of common units are the same on every rank (same bytes).
    costs = {u: c for u, c in per_rank_units[0] if u in common}
    assignment = _greedy_assign([(u, [u], costs[u]) for u in sorted(common)], loads)
    common_paths = {u.split("::", 1)[0] for u in common}
    return assignment, common_paths


def filter_assigned_write_reqs(
    entries: Manifest,
    write_reqs: List[WriteReq],
    replicated_paths: List[str],
    assignment: Dict[str, int],
    rank: int,
) -> Tuple[List[WriteReq], Dict[str, List[WriteReq]]]:
    """Split off the replicated write requests assigned to other ranks
    (before staging: a rank never copies or hashes bytes it will not
    write). Returns ``(kept, dropped)``: ``dropped`` maps each unit id
    assigned to another rank to this rank's own unstaged requests for it
    (the same bytes), which a degraded commit stages if that rank dies.
    Entries are left untouched (their locations are rank-agnostic)."""
    if not replicated_paths or is_partitioner_disabled():
        return write_reqs, {}
    keep_paths = set()
    unit_of_location: Dict[str, str] = {}

    def decide(unit_id: str, location: str) -> None:
        unit_of_location[location] = unit_id
        writer = assignment.get(unit_id)
        if writer is None:
            # The estimate and the prepared entry disagree (ranks saw
            # different shapes, say): write it here. A duplicate write of
            # identical bytes is harmless; a referenced blob that nobody
            # wrote corrupts the snapshot.
            logger.warning(
                "replicated unit %r (blob %r) is not in the partition plan; "
                "writing it on every rank",
                unit_id,
                location,
            )
            keep_paths.add(location)
        elif writer == rank:
            keep_paths.add(location)

    for logical_path in sorted(replicated_paths):
        entry = entries[logical_path]
        if isinstance(entry, ChunkedTensorEntry):
            for i, chunk in enumerate(entry.chunks):
                decide(f"{logical_path}::{i}", chunk.tensor.location)
        else:
            loc = getattr(entry, "location", None)
            if loc is not None:
                decide(logical_path, loc)
    kept: List[WriteReq] = []
    dropped: Dict[str, List[WriteReq]] = {}
    for wr in write_reqs:
        if wr.path not in unit_of_location or wr.path in keep_paths:
            kept.append(wr)
        else:
            dropped.setdefault(unit_of_location[wr.path], []).append(wr)
    return kept, dropped


def reassign_dead_units(
    assignment: Dict[str, int], dead_ranks, live_ranks
) -> Dict[str, int]:
    """The adoption plan of a degraded commit: every unit whose writer
    died goes round-robin to the sorted live ranks. Every survivor
    computes the same plan from the same inputs (no broadcast)."""
    dead = set(dead_ranks)
    live = sorted(live_ranks)
    orphaned = sorted(u for u, w in assignment.items() if w in dead)
    return {u: live[i % len(live)] for i, u in enumerate(orphaned)}


def _greedy_assign(units: List[Tuple[str, List[str], int]], loads: List[int]) -> Dict[str, int]:
    """Largest first, each to the least-loaded rank (ties: lowest rank)."""
    loads = list(loads)
    assignment: Dict[str, int] = {}
    for unit_id, _, cost in sorted(units, key=lambda u: u[2], reverse=True):
        target = min(range(len(loads)), key=lambda r: loads[r])
        loads[target] += cost
        assignment[unit_id] = target
    return assignment


def consolidate_replicated_entries(per_rank_entries: List[Manifest]) -> Manifest:
    """Merge per-rank manifests into the global ``rank/path``-keyed
    manifest, replicated entries onto rank 0's tree only, preferring the
    writer's version of each.

    The writer's version is recognized without the assignment: only the
    writer's copy was rewritten by its batcher (location under
    ``batched/``) or by incremental dedup (under ``../``), or staged at
    all (a stage-time ``checksum``; non-writers never stage). If nothing
    marks a writer (checksums off or deferred, unbatched, not
    incremental), all copies are identical and any will do. Chunked
    entries merge per chunk (the chunks of one entry may have different
    writers)."""
    global_manifest: Manifest = {}
    world_size = len(per_rank_entries)

    def writer_marked(t) -> bool:
        return (
            getattr(t, "location", "").startswith(("batched/", "../"))
            or getattr(t, "checksum", None) is not None
        )

    authoritative: Dict[str, Entry] = {}
    for r in range(world_size):
        for path, entry in per_rank_entries[r].items():
            if not is_replicated(entry):
                continue
            if path not in authoritative:
                authoritative[path] = entry
                continue
            current = authoritative[path]
            if isinstance(entry, ChunkedTensorEntry) and isinstance(current, ChunkedTensorEntry):
                current.chunks = [
                    new
                    if writer_marked(new.tensor) and not writer_marked(cur.tensor)
                    else cur
                    for cur, new in zip(current.chunks, entry.chunks)
                ]
            elif writer_marked(entry) and not writer_marked(current):
                authoritative[path] = entry

    for r in range(world_size):
        for path, entry in per_rank_entries[r].items():
            if is_replicated(entry):
                if r == 0:
                    global_manifest[f"0/{path}"] = authoritative[path]
                continue
            global_manifest[f"{r}/{path}"] = entry
    return global_manifest
