"""Read-side access attribution: who reads what inside a snapshot.

Counterpart of tpusnap/access.py (vendored; the ledger files are the
same, so either package's ``heatmap`` merges the other's readers).
Beyond process-grain counters (``storage.bytes_read``), this module is
the measurement substrate for serving-shaped restore: a bounded, telemetry-gated
**access ledger** recording, per physical read, the logical manifest
leaf it served, the byte range within the stored blob, the byte count,
and the source tier (``local`` / ``remote`` / ``cas`` /
``evicted-read-through``).

Design constraints, in order (the history.jsonl stance):

- **Never fail a read.** Recording and flushing are best-effort and
  exception-free at the call sites; a broken ledger costs attribution,
  never a restore.
- **Bounded.** Reads are aggregated IN MEMORY per scope, keyed by
  (leaf, location, range, source) — a restore that reads a tile 10'000
  times produces one ledger record with ``n: 10000``, not 10'000 lines.
  One JSONL line per aggregation bucket is appended at scope exit; the
  per-reader file is size-bounded by ``TPUSNAP_ACCESS_LEDGER_MAX_BYTES``
  with single-generation rotation (``<file>.1``, the JSONL metrics-sink
  scheme — rotation keeps recent reads visible to ``heatmap`` while
  bounding disk).
- **Crash-tolerant.** Appends go through
  :func:`history.append_jsonl_line` — one O_APPEND write per line, so
  tens of concurrent reader processes interleave whole lines and a
  torn final line is isolated and skipped on load.
- **Sidecar, not KV.** Ledgers live under the LOCAL
  ``TPUSNAP_TELEMETRY_DIR/access/<digest>/<job_id>.jsonl`` — the
  snapshot itself is immutable once committed (same reasoning as
  restore traces), and a KV store would add a dependency to the one
  path that must work during disaster recovery. Readers that share a
  telemetry dir (a serving fleet on one host) are merged by ``tpusnap heatmap``; readers on different
  hosts merge at the fleet layer via their published reader records.

The ambient-scope pattern mirrors :mod:`tpusnap_torch.telemetry`: a
thread-local current ledger installed by ``Snapshot._restore_locked`` /
``read_object`` and consulted once per read inside the scheduler's
``_ReadPipeline`` (the single seam every read path — budget-tiled
restores, tile-grain compressed random access, ``read_object``, CAS
ref-translated reads — already converges on).

Monotonic-only invariant: the one wall-clock timestamp (``ts``) goes
through the injectable ``_wall`` seam.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .history import append_jsonl_line
from .knobs import (
    get_access_ledger_max_bytes,
    get_job_id,
    get_telemetry_dir,
    is_access_ledger_enabled,
)

logger = logging.getLogger(__name__)

ACCESS_DIRNAME = "access"

# Wall-clock seam: timestamps only, never duration math (tests inject).
_wall = time.time

# Source tiers a read can be attributed to. Plugins stamp the exotic
# ones on ReadIO.source; the scope's default covers the rest.
KNOWN_SOURCES = ("local", "remote", "cas", "evicted-read-through")


def access_dir(snapshot_path: str) -> str:
    """Local directory holding every reader's ledger for
    ``snapshot_path`` (digest-keyed like restore traces, so every
    spelling of one destination lands in one place)."""
    from .progress import _path_digest

    return os.path.join(
        get_telemetry_dir(), ACCESS_DIRNAME, _path_digest(snapshot_path)
    )


class AccessLedger:
    """Per-reader, per-scope read aggregation. One instance spans one
    read scope (a restore, or one ``read_object`` call); ``flush()``
    appends its buckets to this reader's ledger file. Thread-safe the
    cheap way (one lock around a dict update) because consumer
    callbacks may record from executor threads."""

    def __init__(
        self, snapshot_path: str, default_source: str = "local"
    ) -> None:
        self.snapshot_path = snapshot_path
        self.job_id = get_job_id()
        self.default_source = default_source
        self.path = os.path.join(
            access_dir(snapshot_path), f"{self.job_id}.jsonl"
        )
        # (logical_path, location, start, end, source) -> [reads, bytes]
        self._buckets: Dict[
            Tuple[str, str, int, int, str], List[int]
        ] = {}
        # Scope-lifetime totals (survive flushes — the fleet reader
        # record and the restore summary read them after the ledger
        # drained to disk). ``_ranges`` dedups distinct byte ranges per
        # location for the working-set computation.
        self._cum_reads = 0
        self._cum_bytes = 0
        self._ranges: Dict[str, set] = {}
        self._lock = threading.Lock()

    def record(
        self,
        logical_path: str,
        location: str,
        start: int,
        end: int,
        nbytes: int,
        source: Optional[str] = None,
    ) -> None:
        """Attribute one physical read (or one member of a merged
        spanning read) of ``location[start:end]`` to manifest leaf
        ``logical_path``."""
        if not logical_path:
            return
        key = (
            logical_path,
            location,
            int(start),
            int(end),
            source or self.default_source,
        )
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                self._buckets[key] = [1, int(nbytes)]
            else:
                bucket[0] += 1
                bucket[1] += int(nbytes)
            self._cum_reads += 1
            self._cum_bytes += int(nbytes)
            self._ranges.setdefault(location, set()).add(
                (int(start), int(end))
            )

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._cum_bytes

    @property
    def total_reads(self) -> int:
        with self._lock:
            return self._cum_reads

    def working_set_bytes(self) -> int:
        """Distinct stored bytes this scope touched (union of read
        ranges per location) — the hot-tile working set ``tune`` sizes
        the restore budget against."""
        with self._lock:
            ranges = {
                loc: list(rs) for loc, rs in self._ranges.items()
            }
        return sum(_union_length(rs) for rs in ranges.values())

    def flush(self) -> None:
        """Append this scope's buckets to the reader's ledger file —
        one whole line per bucket, rotated when past the size bound.
        Best-effort: failures log at DEBUG and drop the records."""
        with self._lock:
            buckets = dict(self._buckets)
            self._buckets.clear()
        if not buckets:
            return
        ts = round(_wall(), 3)
        try:
            self._rotate_if_needed()
            for (lp, loc, start, end, source), (n, nbytes) in sorted(
                buckets.items()
            ):
                line = json.dumps(
                    {
                        "v": 1,
                        "ts": ts,
                        "job_id": self.job_id,
                        "lp": lp,
                        "loc": loc,
                        "range": [start, end],
                        "n": n,
                        "bytes": nbytes,
                        "src": source,
                    },
                    separators=(",", ":"),
                )
                append_jsonl_line(self.path, line)
        except Exception:
            logger.debug("access ledger flush failed", exc_info=True)

    def _rotate_if_needed(self) -> None:
        max_bytes = get_access_ledger_max_bytes()
        try:
            if os.path.getsize(self.path) > max_bytes:
                os.replace(self.path, self.path + ".1")
        except OSError:
            return


# ----------------------------------------------------- ambient scope

_tls = threading.local()


def current() -> Optional[AccessLedger]:
    """The ledger installed on this thread, or None (recording off)."""
    return getattr(_tls, "current", None)


@contextmanager
def use(ledger: Optional[AccessLedger]):
    """Install ``ledger`` as this thread's ambient recorder for the
    duration (the telemetry.use pattern). Works across the scheduler's
    event loop because ``run_on_loop`` drives it on the calling
    thread."""
    prior = getattr(_tls, "current", None)
    _tls.current = ledger
    try:
        yield ledger
    finally:
        _tls.current = prior


def open_ledger(
    snapshot_path: str, default_source: str = "local"
) -> Optional[AccessLedger]:
    """``read_scope``'s knob gate without the context manager: a live
    ledger (or None when recording is off) whose flush timing the
    caller controls. The restore path pairs this with :func:`use` and
    flushes only after its telemetry wall has closed, so attribution
    I/O never shows up as unspanned restore time."""
    if not is_access_ledger_enabled():
        return None
    return AccessLedger(snapshot_path, default_source=default_source)


@contextmanager
def read_scope(snapshot_path: str, default_source: str = "local"):
    """The one call sites use: open a ledger for one read scope when
    the knob allows, record through it ambiently, flush at exit.
    Yields the ledger (or None when recording is off) so the caller
    can stamp scope totals into its own telemetry."""
    ledger = open_ledger(snapshot_path, default_source=default_source)
    if ledger is None:
        yield None
        return
    try:
        with use(ledger):
            yield ledger
    finally:
        try:
            ledger.flush()
        except Exception:
            logger.debug("access ledger flush failed", exc_info=True)


def default_source_for_plugin(label: str) -> str:
    """Map a storage-plugin label (``storage_plugin_label``) to the
    ambient source tier of its plain reads. Conservative: anything not
    recognizably local counts as remote."""
    lab = (label or "").lower()
    if lab.startswith(("fs", "chaos+fs", "tier", "cas+fs")):
        return "local"
    return "remote"


# --------------------------------------------------------------- loading


def load_ledger_records(
    snapshot_path: str, access_root: Optional[str] = None
) -> List[Dict[str, Any]]:
    """Every parseable record from every reader's ledger (rotated
    generation first so ordering is roughly chronological). Torn or
    corrupt lines are skipped, never raised. ``access_root`` overrides
    the digest-derived directory (tests, copied telemetry dirs)."""
    root = access_root or access_dir(snapshot_path)
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return out
    paths: List[str] = []
    for name in names:
        if name.endswith(".jsonl.1"):
            paths.append(os.path.join(root, name))
    for name in names:
        if name.endswith(".jsonl"):
            paths.append(os.path.join(root, name))
    for p in paths:
        try:
            with open(p, "rb") as f:
                data = f.read()
        except OSError:
            continue
        for ln in data.split(b"\n"):
            if not ln.strip():
                continue
            try:
                rec = json.loads(ln)
            except Exception:
                continue
            if isinstance(rec, dict) and rec.get("lp"):
                out.append(rec)
    return out


# --------------------------------------------------------------- heatmap


def _leaf_stored_nbytes(entry) -> int:
    """Stored (on-disk) payload bytes of one manifest leaf — the
    coverage denominator. Differs from the logical ``entry_nbytes``
    exactly when the entry is compressed (reads happen in stored-blob
    coordinates, so coverage must too)."""
    from .inspect import entry_nbytes
    from .manifest import (
        ChunkedTensorEntry,
        ShardedEntry,
        TensorEntry,
    )

    if isinstance(entry, TensorEntry):
        if entry.codec and entry.comp_tile_sizes:
            return sum(int(s) for s in entry.comp_tile_sizes)
        return entry_nbytes(entry)
    if isinstance(entry, ChunkedTensorEntry):
        return sum(_leaf_stored_nbytes(c.tensor) for c in entry.chunks)
    if isinstance(entry, ShardedEntry):
        return sum(_leaf_stored_nbytes(s.tensor) for s in entry.shards)
    return entry_nbytes(entry)


def _union_length(intervals: List[Tuple[int, int]]) -> int:
    """Total length covered by a set of [start, end) intervals."""
    if not intervals:
        return 0
    intervals.sort()
    covered = 0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            covered += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    covered += cur_e - cur_s
    return covered


def snapshot_stored_nbytes(metadata) -> int:
    """Total stored payload bytes of a snapshot — the denominator of
    whole-snapshot coverage and amplification (compressed entries count
    their stored, not logical, size)."""
    from .manifest import PrimitiveEntry, is_container_entry

    total = 0
    for _, entry in metadata.manifest.items():
        if is_container_entry(entry) or isinstance(entry, PrimitiveEntry):
            continue
        total += _leaf_stored_nbytes(entry)
    return total


def compute_heatmap(
    records: List[Dict[str, Any]], metadata
) -> Dict[str, Any]:
    """Merge reader ledger ``records`` against a snapshot's manifest
    into the per-leaf heatmap: read counts, bytes, distinct readers,
    per-leaf and whole-snapshot **coverage** (bytes ever read ÷ stored
    bytes) and **read amplification** (aggregate bytes read ÷ stored
    bytes)."""
    from .manifest import PrimitiveEntry, is_container_entry

    # Leaves are keyed by the rank-STRIPPED logical path — the form
    # readers see (per-rank manifest views strip the prefix, and that is
    # what the ledger records). A path present on several ranks (private
    # per-rank state, per-rank shard subsets of one sharded entry) merges
    # into one leaf whose stored size is the sum; replicated entries were
    # consolidated onto rank 0 at take time and count once.
    leaves: Dict[str, Dict[str, Any]] = {}
    stored_total = 0
    for key, entry in metadata.manifest.items():
        if is_container_entry(entry) or isinstance(entry, PrimitiveEntry):
            continue
        _, _, lp = key.partition("/")
        stored = _leaf_stored_nbytes(entry)
        stored_total += stored
        leaf = leaves.get(lp)
        if leaf is None:
            leaves[lp] = {
                "path": lp,
                "stored_bytes": stored,
                "bytes_read": 0,
                "reads": 0,
                "readers": set(),
                "sources": {},
                "_intervals": {},  # location -> [(start, end)]
            }
        else:
            leaf["stored_bytes"] += stored

    readers: Dict[str, Dict[str, int]] = {}
    unknown_bytes = 0
    range_counts: Dict[Tuple[str, str, int, int], Dict[str, int]] = {}
    for rec in records:
        lp = str(rec.get("lp", ""))
        n = int(rec.get("n", 1) or 1)
        nbytes = int(rec.get("bytes", 0) or 0)
        job = str(rec.get("job_id", "?"))
        src = str(rec.get("src", "local"))
        r = readers.setdefault(job, {"reads": 0, "bytes_read": 0})
        r["reads"] += n
        r["bytes_read"] += nbytes
        leaf = leaves.get(lp)
        if leaf is None:
            unknown_bytes += nbytes
            continue
        leaf["bytes_read"] += nbytes
        leaf["reads"] += n
        leaf["readers"].add(job)
        leaf["sources"][src] = leaf["sources"].get(src, 0) + nbytes
        rng = rec.get("range")
        if (
            isinstance(rng, (list, tuple))
            and len(rng) == 2
            and rng[1] > rng[0]
        ):
            loc = str(rec.get("loc", ""))
            leaf["_intervals"].setdefault(loc, []).append(
                (int(rng[0]), int(rng[1]))
            )
            rkey = (lp, loc, int(rng[0]), int(rng[1]))
            agg = range_counts.setdefault(rkey, {"n": 0, "bytes": 0})
            agg["n"] += n
            agg["bytes"] += nbytes

    read_total = sum(r["bytes_read"] for r in readers.values())
    covered_total = 0
    leaf_rows: List[Dict[str, Any]] = []
    for lp, leaf in leaves.items():
        union = sum(
            _union_length(iv) for iv in leaf["_intervals"].values()
        )
        covered = min(union, leaf["stored_bytes"])
        covered_total += covered
        stored = leaf["stored_bytes"]
        leaf_rows.append(
            {
                "path": lp,
                "stored_bytes": stored,
                "bytes_read": leaf["bytes_read"],
                "reads": leaf["reads"],
                "readers": len(leaf["readers"]),
                "coverage": (covered / stored) if stored else 0.0,
                "amplification": (leaf["bytes_read"] / stored)
                if stored
                else 0.0,
                "sources": dict(leaf["sources"]),
            }
        )
    leaf_rows.sort(key=lambda row: (-row["bytes_read"], row["path"]))

    hot_ranges = [
        {
            "path": lp,
            "location": loc,
            "range": [start, end],
            "reads": agg["n"],
            "bytes": agg["bytes"],
        }
        for (lp, loc, start, end), agg in range_counts.items()
    ]
    hot_ranges.sort(
        key=lambda h: (-h["reads"], -h["bytes"], h["path"], h["range"])
    )

    coverage = (covered_total / stored_total) if stored_total else 0.0
    amplification = (read_total / stored_total) if stored_total else 0.0
    return {
        "v": 1,
        "snapshot_bytes": stored_total,
        "bytes_read": read_total,
        "unattributed_bytes": unknown_bytes,
        "coverage": round(coverage, 6),
        "amplification": round(amplification, 6),
        "readers": {
            job: dict(stats) for job, stats in sorted(readers.items())
        },
        "n_readers": len(readers),
        "leaves": leaf_rows,
        "hot_ranges": hot_ranges,
    }


def location_read_counts(
    records: List[Dict[str, Any]]
) -> Dict[str, int]:
    """Aggregate read counts per storage location — the popularity
    signal ``gc --evict-local`` uses to evict cold blobs first."""
    out: Dict[str, int] = {}
    for rec in records:
        loc = str(rec.get("loc", "") or "")
        if not loc:
            continue
        out[loc] = out.get(loc, 0) + int(rec.get("n", 1) or 1)
    return out


def iter_access_roots(telemetry_dir: Optional[str] = None) -> Iterator[str]:
    """Every per-digest access directory under a telemetry dir (for
    tooling that scans without knowing the snapshot path)."""
    root = os.path.join(
        telemetry_dir or get_telemetry_dir(), ACCESS_DIRNAME
    )
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return
    for name in names:
        p = os.path.join(root, name)
        if os.path.isdir(p):
            yield p
