"""Build a rank's view of a snapshot from the global manifest.

Counterpart of ``tpusnap/manifest_ops.py`` (``get_manifest_for_rank``,
``get_available_entries`` and ``handle_sharded_elasticity``), copied
unchanged. Global manifest keys are ``"<rank>/<logical_path>"``. A
rank's view:

- its own subtree (keys under ``rank/``), with the prefix stripped;
- replicated entries — stored on rank 0 only after dedup — re-exposed to
  every rank;
- all ranks' ShardedEntry shards at the same logical path merged into one
  global entry;
- a NEW rank (rank >= saved world_size) gets rank 0's manifest minus
  non-replicated, non-sharded leaf entries — containers survive so the
  tree structure inflates.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .manifest import (
    Entry,
    Manifest,
    ShardedEntry,
    SnapshotMetadata,
    is_container_entry,
    is_replicated,
)


def _split_rank_path(key: str) -> Tuple[int, str]:
    rank_str, _, logical_path = key.partition("/")
    return int(rank_str), logical_path


def get_manifest_for_rank(metadata: SnapshotMetadata, rank: int) -> Manifest:
    """Return ``{logical_path: entry}`` — everything ``rank`` can restore."""
    rank_to_manifest: Dict[int, Manifest] = {}
    for key, entry in metadata.manifest.items():
        r, logical_path = _split_rank_path(key)
        rank_to_manifest.setdefault(r, {})[logical_path] = entry

    # Merge sharded entries across ranks: all shards of a logical path
    # combine into one global ShardedEntry.
    merged_sharded: Dict[str, ShardedEntry] = {}
    for r in sorted(rank_to_manifest):
        for logical_path, entry in rank_to_manifest[r].items():
            if isinstance(entry, ShardedEntry):
                if logical_path not in merged_sharded:
                    merged_sharded[logical_path] = ShardedEntry(
                        shards=list(entry.shards),
                        dtype=entry.dtype,
                        shape=entry.shape,
                    )
                else:
                    merged_sharded[logical_path].shards.extend(entry.shards)

    if rank in rank_to_manifest:
        local = dict(rank_to_manifest[rank])
    else:
        # New rank joining after an upscale: start from rank 0's view,
        # keeping only what is restorable everywhere.
        local = {
            p: e
            for p, e in rank_to_manifest.get(0, {}).items()
            if is_container_entry(e)
            or is_replicated(e)
            or isinstance(e, ShardedEntry)
        }

    # Replicated entries live only in rank 0's tree after consolidation;
    # re-expose them (and their ancestor containers) to every rank.
    for r, manifest in rank_to_manifest.items():
        for logical_path, entry in manifest.items():
            if is_replicated(entry) and logical_path not in local:
                local[logical_path] = entry
                _ensure_ancestors(local, manifest, logical_path)

    for logical_path in list(local):
        if isinstance(local[logical_path], ShardedEntry):
            local[logical_path] = merged_sharded[logical_path]

    return local


def _ensure_ancestors(local: Manifest, source: Manifest, logical_path: str) -> None:
    parts = logical_path.split("/")
    for i in range(1, len(parts)):
        ancestor = "/".join(parts[:i])
        if ancestor not in local and ancestor in source:
            local[ancestor] = source[ancestor]


def get_available_entries(metadata: SnapshotMetadata, rank: int) -> Manifest:
    """The per-rank restorable view (the reference's
    ``Snapshot.get_manifest`` surface)."""
    return get_manifest_for_rank(metadata, rank)


def handle_sharded_elasticity(
    local_manifest: Manifest, target_flattened: Dict[str, object]
) -> None:
    """Reconcile sharded entries with the restoring rank's targets. The
    merged entries' overlap reads already reshard into any target
    placement, including ranks that did not take the snapshot; what is
    left is to drop the sharded entries the rank has no target for, so
    that no read is issued for them."""
    for logical_path in list(local_manifest):
        entry = local_manifest[logical_path]
        if isinstance(entry, ShardedEntry) and logical_path not in target_flattened:
            del local_manifest[logical_path]
