"""Snapshot retention: keep the newest N, retire the rest — safely.

Counterpart of tpusnap/retention.py (vendored). Incremental snapshots
make deletion ordering matter: an increment is only readable while its
base snapshots exist. ``apply_retention`` walks a directory of
snapshots, decides what to keep, MATERIALIZES any kept snapshot that
references a doomed base (copying the referenced blobs in,
checksum-verified, before anything is deleted), and only then removes the
rest. A crash at any point leaves every kept snapshot readable:
materialization commits atomically, and deletion happens last. Kept
snapshots pin their bases transitively, so a hand-built chain that was
never collapsed stays whole too.

Local filesystems only (deletion needs directory listing and removal).
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass, field
from typing import Dict, List, Optional
from urllib.parse import urlsplit

from .inspect import iter_blobs, load_snapshot_metadata, materialize_snapshot

__all__ = ["RetentionPlan", "apply_retention"]


@dataclass
class RetentionPlan:
    keep: List[str] = field(default_factory=list)  # newest first
    delete: List[str] = field(default_factory=list)
    materialize: List[str] = field(default_factory=list)  # subset of keep
    executed: bool = False
    bytes_copied: int = 0

    def summary(self) -> str:
        verb = "materialized" if self.executed else "to materialize"
        dverb = "deleted" if self.executed else "to delete"
        return (
            f"{len(self.keep)} kept, {len(self.materialize)} {verb} "
            f"({self.bytes_copied / 1e6:.1f} MB copied), "
            f"{len(self.delete)} {dverb}"
        )


def _local_root(root: str) -> str:
    parts = urlsplit(root)
    if parts.scheme not in ("", "file"):
        raise ValueError(
            f"retention requires a local filesystem root, got {root!r} — "
            "for object stores, materialize the survivors and use bucket "
            "lifecycle rules"
        )
    return os.path.abspath(parts.path or root)


def _list_snapshots(root: str) -> List[str]:
    """Snapshot directories directly under ``root`` (contain
    ``.snapshot_metadata``), oldest first by commit time.

    Ordering uses the ``created_at`` recorded IN the metadata at take
    time — file mtimes are unreliable (``materialize`` atomically
    rewrites the metadata file, rsync/copies reset mtimes; ordering by
    mtime could mark the true newest checkpoint as oldest and delete
    it). Pre-``created_at`` snapshots fall back to mtime."""
    out = []
    for name in os.listdir(root):
        path = os.path.join(root, name)
        meta = os.path.join(path, ".snapshot_metadata")
        if not os.path.isfile(meta):
            continue
        created = load_snapshot_metadata(path).created_at
        if created is None:
            created = os.path.getmtime(meta)
        out.append((created, path))
    out.sort()
    return [p for _, p in out]


def _direct_bases(snap_path: str) -> List[str]:
    """Absolute paths of base snapshots ``snap_path`` DIRECTLY
    references (has a ``../`` blob location into)."""
    from .inspect import base_root_of_location

    md = load_snapshot_metadata(snap_path)
    bases = set()
    for blob in iter_blobs(md.manifest):
        if blob.location.startswith("../"):
            base = base_root_of_location(blob.location, md.base_roots)
            bases.add(os.path.abspath(os.path.join(snap_path, base)))
    return sorted(bases)


def _referenced_bases(snap_path: str) -> List[str]:
    """Every base snapshot ``snap_path`` depends on, TRANSITIVELY: a
    kept delta head must pin its whole chain. Incremental writers
    collapse chained references (a head's direct refs name every member
    physically holding its bytes), so the direct set is normally
    complete — the transitive walk is defense in depth against
    hand-built or pre-collapse chains, where deleting a base-of-a-base
    would break a kept snapshot retention itself never inspected.
    Cycle-safe; unreadable bases end the walk on that branch (they are
    already broken — materialization of the keeper will surface it)."""
    out: List[str] = []
    seen = {os.path.abspath(snap_path)}
    frontier = _direct_bases(snap_path)
    while frontier:
        base = frontier.pop()
        if base in seen:
            continue
        seen.add(base)
        out.append(base)
        try:
            frontier.extend(_direct_bases(base))
        except Exception:
            continue
    return sorted(out)


def apply_retention(
    root: str,
    keep_last: int,
    dry_run: bool = False,
    storage_options: Optional[Dict] = None,
) -> RetentionPlan:
    """Keep the newest ``keep_last`` snapshots under ``root``; retire the
    rest. Kept snapshots referencing a doomed base are materialized
    (self-contained, verified) BEFORE any deletion. ``dry_run`` returns
    the plan without touching anything.

    Kept snapshots that reference bases OUTSIDE ``root`` keep those
    references — only snapshots under ``root`` are ever deleted."""
    if keep_last < 1:
        raise ValueError("keep_last must be >= 1")
    root = _local_root(root)
    snaps = _list_snapshots(root)
    plan = RetentionPlan(
        keep=list(reversed(snaps[-keep_last:])),
        delete=snaps[:-keep_last],
    )
    doomed = set(plan.delete)
    for snap in plan.keep:
        if any(base in doomed for base in _referenced_bases(snap)):
            plan.materialize.append(snap)
    if dry_run:
        return plan
    for snap in plan.materialize:
        stats = materialize_snapshot(snap, storage_options)
        plan.bytes_copied += stats["bytes_copied"]
    # Defense in depth: re-check no kept snapshot still references a
    # doomed path (materialize rewrote them; a logic regression here
    # must fail BEFORE data is destroyed).
    for snap in plan.keep:
        remaining = [b for b in _referenced_bases(snap) if b in doomed]
        if remaining:  # pragma: no cover - guarded invariant
            raise RuntimeError(
                f"{snap} still references doomed base(s) {remaining}; "
                "aborting before deletion"
            )
    for snap in plan.delete:
        shutil.rmtree(snap)
    plan.executed = True
    return plan
