"""Snapshot operations CLI: ``python -m tpusnap_torch <command> ...``

Counterpart of tpusnap's ``python -m tpusnap``, with the same commands,
output and exit codes, over the same on-disk formats: each package's CLI
reads what the other wrote. It never touches the card: ``cat`` prints
CPU tensors, and no command opens a CUDA context, so an operator can run
``fsck``, ``verify`` or ``drain`` beside a training job.

  info        PATH      snapshot version, world size, size breakdown
  ls          PATH [-l] list manifest entries (one line per logical path)
  verify      PATH      stream-verify every blob against recorded CRCs
                        (exit 2 = corruption, 3 = NOTHING was verifiable
                        — checksums disabled at take or a different
                        checksum build; scripts must not read that as
                        "verified clean")
  cat         PATH MANIFEST_PATH  read one object (``read_object``), print it
  materialize PATH      copy base-referenced blobs into an incremental
                        snapshot so its bases can be deleted
  diff        A B       compare two snapshots by recorded checksums only
                        (no data reads; exit 2 = provably different,
                        3 = undecidable without reading data)
  retain ROOT --keep N  keep the newest N snapshots under ROOT; any kept
                        increment referencing a doomed base is
                        materialized first, then the rest are deleted
  fsck        PATH      classify the directory (committed / torn / empty /
                        corrupt-metadata / foreign) from the take journal
                        + self-checksummed metadata, and enumerate orphan
                        blobs unreferenced by the manifest (exit 0 =
                        committed, 2 = corrupt-metadata, 4 = torn, 3 =
                        empty/foreign)
  gc          PATH      reclaim orphan blobs (dry-run by default; --force
                        deletes; --torn additionally discards a torn
                        take's salvageable blobs; --evict-local reclaims
                        a REMOTE-DURABLE tiered snapshot's local payload
                        blobs past the retention window). Safe
                        concurrently with readers: orphans are never
                        referenced
  drain       PATH      write-back tiering: drain a tiered snapshot's
                        local tier to its remote (resumes from the
                        crash-safe upload journal — blobs already proven
                        remote by CRC32C+XXH64 evidence are skipped;
                        bases/delta parents drain first). ``--status``
                        reports durability + upload lag without
                        draining; ``--timeout`` bounds outage patience
                        (exit 0 remote-durable / 2 not converged,
                        resumable / 3 nothing tiered at PATH)
  trace       PATH      render the take's telemetry (per-stage timings,
                        counters, cross-rank rollup, slowest-rank-per-
                        phase straggler attribution) from the traces
                        persisted under .tpusnap/telemetry/ and the
                        metadata extras (``--json`` for machines,
                        ``--rank K`` for one rank's stage detail;
                        ``--restore`` renders the LAST restore's traces
                        from the local TPUSNAP_TELEMETRY_DIR instead;
                        exit 3 = no telemetry recorded)
  watch       PATH      tail an IN-FLIGHT take's heartbeat records
                        (.tpusnap/progress/rank_<k>.json) and render a
                        live per-rank table (phase, % bytes, MB/s,
                        data-at-risk + time-since-last-commit exposure,
                        stragglers flagged), refreshing in place until
                        the take commits (``--once``/``--json`` for one
                        frame; exit 3 = no heartbeat records found)
  history               cross-run take/restore performance history from
                        this host's TPUSNAP_TELEMETRY_DIR/history.jsonl
                        (one event per completed take/restore; bench.py
                        records its runs too): trend table or ``--json``;
                        ``--check`` compares the latest run against the
                        trailing median (``--window``/``--threshold``,
                        cold-run-aware; ``--metric`` repeatable — e.g.
                        ``--metric throughput_gbps --metric
                        storage_write_p99_s``, JSON names each regressed
                        metric) and exits 2 on a regression so CI and
                        cron jobs can gate on it (exit 3 = not enough
                        comparable history / no events)
  analyze     PATH      performance doctor: deterministic critical-path
                        attribution of the take's (or ``--restore``'s)
                        wall-clock to resources (storage write/read,
                        DtoH, stage/clone, checksum, budget waits,
                        barriers) with a bound-by verdict and the
                        concrete knob to turn; tail-latency outliers
                        from the storage-boundary latency histograms;
                        straggler ranks; the in-take probe
                        ``roofline_fraction`` (``TPUSNAP_PROBE=1``);
                        ``--history`` adds trend context; ``--json``
                        for machines; ``--check`` exits 2 when any
                        warn-severity finding fires (exit 3 = no
                        telemetry recorded, matching ``trace``); the
                        restore view also attributes the decode lane
                        and reports ``restore_roofline_fraction``
                        against the in-restore probe READ ceiling
                        (``--min-read-roofline`` gates it)

  tune                  deterministic knob planner for one (backend,
                        kind, world_size) cell: history.jsonl events +
                        probe ceilings (+ ``--snapshot``'s analyze
                        verdict) in, one proposed env value per knob
                        out, each with a one-line rationale (table /
                        ``--json`` / ``--env`` shell exports;
                        ``--check`` exits 0 with a plan, 3 on
                        insufficient history; TPUSNAP_AUTOTUNE=1
                        applies the plan at take/restore begin —
                        explicit env vars always win, and applied
                        knobs are stamped into the history event as
                        ``tuned``)

  timeline    PATH      forensic cross-rank timeline from the flight-
                        recorder sidecars (.tpusnap/flight/rank_<k>.jsonl,
                        falling back to the local TPUSNAP_TELEMETRY_DIR
                        copy): all ranks' event logs merged in causal
                        order using barrier-anchored clock-skew
                        alignment (per-rank offset ± bound reported);
                        for any UNCOMMITTED path a post-mortem verdict
                        names, per rank, the in-flight op, last
                        completed phase, bytes staged/written vs
                        planned, journal.d completion evidence, stall
                        episodes and the missing-rank set
                        (``--rank K`` one rank, ``--last N`` newest N
                        events, ``--around T [--window S]`` events near
                        T seconds into the timeline, ``--json``; exit 0
                        = committed, 4 = uncommitted post-mortem, 3 =
                        no flight data recorded)

  slo                   checkpoint SLO state from this host's per-rank
                        tracker sidecars (TPUSNAP_TELEMETRY_DIR/slo/):
                        per-rank time-since-last-commit, data-at-risk
                        bytes, history-derived estimated RTO, breach
                        flags, and rank 0's fleet worst-case fold
                        (``--json`` for machines; ``--check`` gates:
                        exit 0 healthy, 2 when a set TPUSNAP_SLO_RPO_S
                        / TPUSNAP_SLO_RTO_S threshold — or ``--rpo`` /
                        ``--rto`` — is breached, 3 when no records
                        exist or an RTO objective is set but no
                        estimate could be formed)

  fleet                 cross-job fleet status from the shared
                        TPUSNAP_FLEET_DIR every instrumented job's rank
                        0 mirrors its heartbeat/SLO/tier state into:
                        per-job table (state, since-commit exposure,
                        data-at-risk, upload lag, degraded/paused/dead
                        flags) plus the fleet rollup — worst-case RPO
                        and at-risk across jobs, aggregate upload lag,
                        cross-job merged storage-latency quantiles
                        (``--json`` for machines; ``--prom-out`` writes
                        scope="fleet" Prometheus families; ``--check``
                        gates: exit 0 healthy, 2 when worst RPO /
                        aggregate lag / merged write p99-over-p50 ratio
                        crosses a threshold, 3 when the fleet dir holds
                        no records; ``watch --fleet`` tails the same
                        directory live)

  lint                  AST invariant checker over the package source
                        (``tpusnap_torch/devtools/lint.py``): knob access
                        only through knobs.py, monotonic-only clocks,
                        canonical sidecar constants, no silent swallows
                        in crash-safety modules, no blocking calls in
                        scheduler coroutines, no finalizer-reachable
                        joins, knob/doc drift — with per-line waivers
                        (``# tpusnap: waive=<RULE> reason``);
                        ``--check`` exits 2 on any unwaived finding
                        (``--root`` lints another tree, ``--select``
                        runs a rule subset, ``--json`` for machines)

Exit codes: 0 success / clean, 1 usage or read error, 2 corruption found
(or provably-different diff; history --check: regression; analyze
--check: warn-severity finding; slo --check: SLO breach; fleet --check:
fleet objective breach), 3 undecidable/unverifiable (or no telemetry
recorded — trace and analyze; no flight data — timeline; fsck:
empty/foreign; history: no/insufficient events; slo: no records / no
estimator verdict; fleet: no status records; tune: insufficient
comparable history), 4 torn
take (fsck — salvageable by retaking the path; timeline: uncommitted
path, post-mortem verdict printed).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .inspect import entry_nbytes, entry_verifiable, verify_snapshot
from .manifest import (
    ChunkedTensorEntry,
    ObjectEntry,
    PrimitiveEntry,
    ShardedEntry,
    TensorEntry,
    is_container_entry,
)
from .snapshot import Snapshot


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"


def _entry_desc(entry) -> str:
    if isinstance(entry, TensorEntry):
        return f"tensor  {entry.dtype}{entry.shape}"
    if isinstance(entry, ChunkedTensorEntry):
        return f"chunked {entry.dtype}{entry.shape} ({len(entry.chunks)} chunks)"
    if isinstance(entry, ShardedEntry):
        return f"sharded {entry.dtype}{entry.shape} ({len(entry.shards)} shards)"
    if isinstance(entry, ObjectEntry):
        return f"object  {entry.obj_type}"
    if isinstance(entry, PrimitiveEntry):
        val = entry.readable if entry.readable is not None else entry.serialized_value
        return f"primitive {entry.dtype}={val!r}"
    return entry.type


def _print_chain_report(rep) -> int:
    """Render a delta-stream root (``resolve_chain``): member table,
    recovery head, torn tail. Exit 0 with a head, 3 with no members."""
    import datetime

    print(f"path:        {rep.root}")
    print("stream root: "
          f"{len(rep.members)} member(s), chain depth {len(rep.chain)}")
    for m in rep.members:
        mark = (
            "HEAD" if m.name == rep.head
            else "TORN" if m.state == "torn"
            else "????" if m.state == "debris"
            else "    "
        )
        when = (
            datetime.datetime.fromtimestamp(
                m.created_at, tz=datetime.timezone.utc
            ).isoformat(timespec="seconds")
            if m.created_at
            else "-"
        )
        seq = f"seq {m.seq}" if m.seq is not None else "  -  "
        print(
            f"  {mark}  {m.name:<16s} {m.state:<10s} {seq:<8s} "
            f"{_fmt_bytes(m.payload_bytes):>10s}  {when}"
        )
        # Elastic-stream forensics: the participating world of the
        # epoch (size + joins/leaves vs the previous epoch), degraded
        # commits (who died, who adopted), and — for a torn multi-rank
        # epoch — whose journal evidence is missing.
        bits = []
        w = m.world
        if w and w.get("size"):
            b = f"world {w['size']} (ranks {w.get('ranks')})"
            if w.get("joined"):
                b += f", joined {w['joined']}"
            if w.get("left"):
                b += f", left {w['left']}"
            if w.get("expired"):
                b += f", expired {w['expired']}"
            bits.append(b)
        if m.degraded:
            adopters = sorted(
                set((m.degraded.get("adopters") or {}).values())
            )
            bits.append(
                f"DEGRADED: rank(s) {m.degraded.get('dead_ranks')} died "
                f"mid-epoch; "
                f"{len(m.degraded.get('adopted_units') or [])} unit(s) "
                f"adopted by survivor(s) {adopters}"
            )
        if m.state == "torn" and m.missing_ranks:
            bits.append(
                "journal evidence missing from global rank(s) "
                f"{m.missing_ranks}"
            )
        for b in bits:
            print(f"        {b}")
    if rep.head:
        print(f"recovery:    restore {rep.head_path} "
              f"(replays {' + '.join(reversed(rep.chain))})")
    if rep.torn_tail:
        print(
            f"torn tail:   {rep.torn_tail} — a micro-commit was "
            "interrupted; recovery IGNORES it (`fsck`/`timeline` the "
            "member for the post-mortem, retake or `gc --torn` to "
            "reclaim)"
        )
    if rep.superseded:
        print(
            f"superseded:  {', '.join(rep.superseded)} (not referenced "
            "by the head — reclaimable via retention)"
        )
    if rep.debris:
        print(f"debris:      {', '.join(rep.debris)} (half-retired "
              "member dir(s) — reclaim manually)")
    return 0 if rep.head else 3


def cmd_info(args) -> int:
    from .inspect import iter_blobs

    try:
        md = Snapshot(args.path).metadata
    except RuntimeError:
        # Not a snapshot dir itself — a delta-stream ROOT holds chain
        # members one level down; render the chain view instead.
        from .delta import resolve_chain

        rep = resolve_chain(args.path)
        if rep.members:
            return _print_chain_report(rep)
        raise
    counts: dict = {}
    total = 0
    for p, e in md.manifest.items():
        if is_container_entry(e):
            continue
        counts[e.type] = counts.get(e.type, 0) + 1
        total += entry_nbytes(e)
    external = [b for b in iter_blobs(md.manifest) if b.location.startswith("../")]
    print(f"path:        {args.path}")
    print(f"version:     {md.version}")
    if md.created_at is not None:
        import datetime
        import time as _time

        ts = datetime.datetime.fromtimestamp(
            md.created_at, tz=datetime.timezone.utc
        )
        # Snapshot age IS the recovery-point floor: a crash right now
        # rewinds training at least this far.
        age = max(_time.time() - md.created_at, 0.0)
        print(
            f"created:     {ts.isoformat(timespec='seconds')} "
            f"({_fmt_age(age)} ago)"
        )
    print(f"world_size:  {md.world_size}")
    from .delta import delta_fields

    dfields = delta_fields(md)
    if dfields:
        parent = dfields.get("parent")
        print(
            f"delta:       micro-commit seq {dfields.get('seq')} of "
            f"stream {str(dfields.get('stream'))[:8]}"
            + (f", parent {parent}" if parent else " (stream base)")
            + " — `info` the stream root for the chain view"
        )
    print(f"payload:     {_fmt_bytes(total)}")
    print(f"entries:     {sum(counts.values())}")
    for t, c in sorted(counts.items()):
        print(f"  {t:14s} {c}")
    if external:
        from .inspect import base_root_of_location

        bases = sorted(
            {
                base_root_of_location(b.location, md.base_roots)
                for b in external
            }
        )
        print(
            f"external:    {len(external)} blob range(s) reference base "
            f"snapshot(s): {', '.join(bases)} — keep them alive (or "
            f"`materialize` to make this snapshot self-contained)"
        )
    # Telemetry rollup highlights (metadata.extras — no trace reads):
    # the take's headline numbers without a separate `trace` invocation.
    t = (md.extras or {}).get("telemetry")
    if t:
        wall = t.get("take_wall_s")
        bw = t.get("bytes_written") or 0
        if wall:
            line = f"take:        {_fmt_seconds(wall)}"
            if bw:
                line += f", {_fmt_bytes(bw)} written"
                if wall > 0:
                    line += f" ({bw / wall / 1e9:.2f} GB/s)"
            print(line)
        counters = t.get("counters") or {}
        notable = {
            "retries": t.get("retry_attempts") or 0,
            "stall episodes": counters.get("progress.stall_episodes", 0),
            "blobs salvaged": counters.get("salvage.blobs_salvaged", 0),
            "dedup skips": counters.get("scheduler.dedup_skipped", 0),
        }
        notes = [f"{v} {k}" for k, v in notable.items() if v]
        if notes:
            print(f"             {', '.join(notes)}")
        skew = t.get("phase_skew") or {}
        if (t.get("ranks") or 1) > 1 and skew:
            worst_name, worst = max(
                (
                    (name, agg)
                    for name, agg in skew.items()
                    if agg.get("skew")
                ),
                key=lambda kv: kv[1]["skew"],
                default=(None, None),
            )
            if worst is not None and worst["skew"] > 1.0:
                print(
                    f"skew:        {worst_name} rank {worst.get('max_rank')} "
                    f"at {_fmt_seconds(worst.get('max_s'))} "
                    f"({worst['skew']:.2f}x the p50) — "
                    "`trace` for the full breakdown"
                )
    # Write-back tier durability (tiering): first-class state
    # of a tiered snapshot's local tier, plus the restore-source label
    # the RTO estimate below is priced against.
    restore_backend = None
    try:
        from .tiering import parse_tier_url, tier_state_of_dir
        from .tiering import restore_source_label as _rsl

        spec = parse_tier_url(args.path)
        local_dir = spec.local_dir if spec is not None else args.path
        tier = tier_state_of_dir(local_dir)
        if tier:
            line = f"durability:  {tier['durability']}"
            if tier["durability"] == "local-committed":
                line += (
                    f" — {_fmt_bytes(tier.get('lag_bytes') or 0)} awaiting "
                    f"drain to {tier.get('remote')}"
                )
            elif tier.get("remote"):
                line += f" at {tier.get('remote')}"
            print(line)
            restore_backend = _rsl(args.path)
    except Exception:
        pass
    # Content-addressed store refs (cas): how much of this
    # snapshot's payload lives as shared-store refs instead of private
    # copies, and which store holds the blobs.
    try:
        from .cas import read_refs_dir, resolve_store_url
        from .tiering import parse_tier_url as _ptu

        _spec = _ptu(args.path)
        _dir = _spec.local_dir if _spec is not None else args.path
        cas_refs, cas_store = read_refs_dir(_dir)
        if cas_refs:
            dedup = sum(int(r[0]) for r in cas_refs.values())
            print(
                f"cas:         {len(cas_refs)} ref(s) into "
                f"{cas_store or resolve_store_url() or '(unknown store)'}"
            )
            print(
                f"             {_fmt_bytes(dedup)} deduplicated in the "
                f"store, {_fmt_bytes(max(total - dedup, 0))} materialized "
                "as private copies"
            )
    except Exception:
        pass
    # History-derived estimated restore time (the slo RTO
    # estimator over the rank-0 restore view): "how long until training
    # resumes from THIS snapshot" — best-effort, shown only when ≥3
    # comparable restore events exist on this host. Tiered snapshots
    # are priced against the tier a restore would actually read from.
    try:
        from .inspect import rank_payload_nbytes
        from .slo import estimate_rto

        est = estimate_rto(rank_payload_nbytes(md, 0), backend=restore_backend)
        if est.ok:
            src = getattr(est, "source", "history")
            print(
                f"est restore: {_fmt_seconds(est.seconds)} "
                f"({est.reason}"
                + (f", {restore_backend} {src}" if restore_backend else "")
                + "; `slo` for live exposure)"
            )
    except Exception:
        pass
    return 0


def cmd_ls(args) -> int:
    from .inspect import _entry_tensors

    md = Snapshot(args.path).metadata
    for p in sorted(md.manifest):
        e = md.manifest[p]
        if is_container_entry(e) and not args.all:
            continue
        if args.long:
            n = entry_nbytes(e)
            crc = "✓" if entry_verifiable(e) else " "
            ext = (
                "↗"
                if any(
                    t.location.startswith("../") for t in _entry_tensors(e)
                )
                else " "
            )
            print(f"{_fmt_bytes(n):>10s}  {crc}{ext}  {p}  [{_entry_desc(e)}]")
        else:
            print(p)
    return 0


def cmd_verify(args) -> int:
    report = verify_snapshot(args.path)
    for f in report.failures:
        print(
            f"CORRUPT  {f.manifest_path} ({f.location}"
            + (f", {f.detail}" if f.detail else "")
            + ")",
            file=sys.stderr,
        )
    if args.verbose:
        for u in report.unverified_blobs:
            print(f"UNVERIFIED  {u.manifest_path}: {u.detail}")
    print(report.summary())
    if not report.clean:
        return 2
    # "Nothing was verifiable" must not read as "verified clean" in
    # scripts (snapshot taken with TPUSNAP_DISABLE_CHECKSUM=1, or by a
    # build with a different checksum algorithm): exit 3, mirroring
    # diff's 3 = undecidable convention.
    if report.ok == 0 and report.unverified > 0:
        print(
            "nothing verified: no blob carries a checksum this build can "
            "check",
            file=sys.stderr,
        )
        return 3
    return 0


def cmd_materialize(args) -> int:
    from .inspect import materialize_snapshot

    stats = materialize_snapshot(args.path)
    if stats["blobs_copied"] == 0:
        print("already self-contained (no external references)")
    else:
        print(
            f"copied {stats['blobs_copied']} blob(s), "
            f"{_fmt_bytes(stats['bytes_copied'])}; snapshot is now "
            "self-contained"
        )
    return 0


def cmd_diff(args) -> int:
    from .inspect import diff_snapshots

    d = diff_snapshots(args.path_a, args.path_b)
    if not args.quiet:
        for tag, paths in (
            ("~", d.changed),
            ("+", d.added),
            ("-", d.removed),
            ("?", d.unknown),
        ):
            for p in paths:
                print(f"{tag} {p}")
    print(d.summary())
    # 0 = provably identical, 2 = provably different, 3 = undecidable
    # (missing checksums / incomparable layouts) — so scripts can't
    # mistake "couldn't compare" for either verdict.
    if d.differs:
        return 2
    return 0 if d.same else 3


def cmd_retain(args) -> int:
    from .retention import apply_retention

    plan = apply_retention(args.root, args.keep, dry_run=args.dry_run)
    would = "" if plan.executed else "would "
    for s in plan.materialize:
        print(f"{would}materialize {s}")
    for s in plan.delete:
        print(f"{would}delete {s}")
    print(plan.summary())
    return 0


def cmd_fsck(args) -> int:
    from .lifecycle import fsck_snapshot

    if getattr(args, "store", False):
        # Store-wide mode. Exit contract: 0 = clean or merely
        # reclaimable (orphans and torn publishes are NORMAL crash
        # debris gc converges, not corruption); 4 = dangling ref(s) —
        # a committed snapshot references a blob the store no longer
        # holds, restore-breaking; 3 = not a store.
        from .cas import fsck_store

        srep = fsck_store(args.path)
        print(srep.summary())
        if srep.state != "store":
            print(f"error: {srep.detail}", file=sys.stderr)
            return 3
        if args.verbose:
            for d in srep.dangling:
                print(
                    f"DANGLING {d['key']}  ref'd as {d['location']!r} "
                    f"by root {d['root']}"
                )
            for k, sz in sorted(srep.orphans.items()):
                print(f"ORPHAN   {_fmt_bytes(sz):>10s}  blobs/{k}")
            for p in srep.torn_publishes:
                print(f"TORN     {p}")
            for p in srep.stale_roots:
                print(f"STALE    {p}  (snapshot dir gone)")
            for k in srep.refcount_divergence:
                print(f"DIVERGED refcounts.json[{k}] != mark count")
        return 4 if srep.dangling else 0

    report = fsck_snapshot(args.path)
    if report.state in ("foreign", "empty"):
        # Not a take dir itself — a delta-stream ROOT holds classifiable
        # members one level down: fan the classification out per member
        # and grade the chain (torn tail → 4, healthy head → 0).
        from .delta import resolve_chain

        rep = resolve_chain(args.path)
        if any(m.seq is not None for m in rep.members):
            rc = _print_chain_report(rep)
            if rep.torn_tail:
                return 4
            return rc
    print(report.summary())
    if report.journal is not None and report.state == "torn":
        import datetime

        ts = datetime.datetime.fromtimestamp(
            report.journal.started_at, tz=datetime.timezone.utc
        )
        print(f"  take started: {ts.isoformat(timespec='seconds')}")
        if report.journal.incremental_from:
            print(f"  incremental_from: {report.journal.incremental_from}")
        if report.delta:
            print(
                f"  delta: torn micro-commit seq {report.delta.get('seq')} "
                f"over {report.delta.get('parent')!r} — recovery lands on "
                "the last committed increment (`fsck` the stream root)"
            )
        # Rank-failure attribution: when the survivors' black boxes
        # recorded a lease expiry, the torn verdict NAMES the dead
        # rank(s) — "rank 2 died" beats "something tore" at 2 a.m.
        try:
            from .flight import load_flight_logs

            logs = load_flight_logs(args.path, files=report.files)
            take_id = report.journal.take_id
            dead = sorted(
                {
                    e.get("rank")
                    for doc in logs.values()
                    if (doc.get("meta") or {}).get("take_id")
                    in (None, take_id)
                    for e in doc.get("events") or []
                    if e.get("k") == "rank_dead"
                    and isinstance(e.get("rank"), int)
                }
            )
            if dead:
                print(
                    f"  dead rank(s) (lease expired): {dead} — the "
                    "survivors observed the rank die; `tpusnap_torch timeline` "
                    "has the full post-mortem"
                )
        except Exception:
            pass
    if args.verbose:
        for p in report.missing_referenced:
            print(f"MISSING  {p}")
        for p in report.cas_dangling:
            print(
                f"DANGLING {p}  (CAS ref into {report.cas_store}; the "
                "store no longer holds the blob)"
            )
        for p in report.evicted:
            print(f"EVICTED  {p}  (remote-durable; restorable from "
                  f"{report.tier_remote})")
        for p, sz in sorted(report.orphans.items()):
            print(f"ORPHAN   {_fmt_bytes(sz):>10s}  {p}")
    # committed→0; corrupt-metadata→2 (corruption, like verify); torn→4
    # (salvageable — retake the path or `gc --torn`); a committed
    # snapshot with DANGLING CAS refs→4 (the shared store lost blobs it
    # needs — `fsck --store` the store for the other side of the
    # verdict); empty/foreign→3 (nothing tpusnap-shaped to check).
    if report.state == "committed":
        if report.cas_dangling:
            return 4
        return 2 if report.missing_referenced else 0
    if report.state == "corrupt-metadata":
        return 2
    if report.state == "torn":
        return 4
    return 3


def cmd_drain(args) -> int:
    import json as _json

    from .tiering import (
        drain_snapshot,
        parse_tier_url,
        tier_state_of_dir,
    )

    if getattr(args, "store", False):
        # Store-wide drain: upload every blob to the store's remote
        # mirror once store-wide, journaled by hash (a crashed drain
        # skips everything already proven remote on re-run).
        from .cas import drain_store

        srep = drain_store(args.path, remote_url=args.remote)
        for err in srep.errors:
            print(f"error: {err}", file=sys.stderr)
        print(srep.summary())
        if srep.state == "durable":
            return 0
        return 3 if srep.state == "no-remote" else 2

    spec = parse_tier_url(args.path)
    local_dir = spec.local_dir if spec is not None else args.path

    if args.status:
        state = tier_state_of_dir(local_dir)
        if state is None:
            print(
                f"error: {local_dir!r} carries no upload journal — not a "
                "write-back tiered snapshot (or the drain never started)",
                file=sys.stderr,
            )
            return 3
        if args.json:
            print(_json.dumps({"path": local_dir, **state}))
        else:
            print(f"path:        {local_dir}")
            print(f"remote:      {state.get('remote')}")
            print(f"durability:  {state.get('durability')}")
            print(
                f"lag:         {_fmt_bytes(state.get('lag_bytes') or 0)} "
                f"across {state.get('pending_blobs') or 0} blob(s) "
                f"({state.get('evidenced_blobs') or 0} proven remote)"
            )
        return 0 if state.get("durability") == "remote-durable" else 2

    report = drain_snapshot(
        args.path,
        remote_url=args.remote,
        deadline_s=args.timeout,
    )
    if args.json:
        print(_json.dumps(report.to_json()))
    else:
        for base in report.bases:
            print(f"base: {base.summary()}")
        print(report.summary())
    # 0 = remote-durable; 2 = did not converge (outage/degraded — retry
    # later, the journal resumes); 3 = nothing drainable at the path.
    if report.state == "durable":
        return 0
    if report.state == "no-metadata":
        print(f"error: {report.error}", file=sys.stderr)
        return 3
    return 2


def cmd_gc(args) -> int:
    from .lifecycle import gc_snapshot

    if getattr(args, "store", False):
        # Store-wide mark-and-sweep (dry-run unless --force): blobs
        # referenced by any live root's ref records — or named by a
        # publish intent younger than the grace window — survive;
        # everything else past the grace window is swept under the
        # per-store lock lease.
        from .cas import gc_store

        srep = gc_store(args.path, dry_run=not args.force)
        would = "" if args.force else "would "
        for p, sz in sorted(srep.reclaimed.items()):
            print(f"{would}delete  {_fmt_bytes(sz):>10s}  {p}")
        for err in srep.errors:
            print(f"error: {err}", file=sys.stderr)
        print(srep.summary())
        return 1 if srep.errors else 0

    report = gc_snapshot(
        args.path,
        dry_run=not args.force,
        reclaim_torn=args.torn,
        evict_local=args.evict_local,
    )
    would = "" if args.force else "would "
    for p, sz in sorted(report.reclaimed.items()):
        print(f"{would}delete  {_fmt_bytes(sz):>10s}  {p}")
    for err in report.errors:
        print(f"error: {err}", file=sys.stderr)
    print(report.summary())
    return 1 if report.errors else 0


def _fmt_seconds(s) -> str:
    if s is None:
        return "-"
    if s >= 1.0:
        return f"{s:.2f}s"
    return f"{s * 1e3:.1f}ms"


def _render_trace(args, rollup, summaries, ranks, world_size, label) -> int:
    import json as _json

    if args.json:
        print(
            _json.dumps(
                {
                    "path": args.path,
                    "kind": label,
                    "world_size": world_size,
                    "rollup": rollup,
                    "ranks": {str(r): s for r, s in sorted(summaries.items())},
                }
            )
        )
        return 0

    print(f"path:         {args.path}")
    print(f"world_size:   {world_size}")
    print(f"traced ranks: {sorted(ranks) if ranks else '(rollup only)'}")
    multi = bool(rollup) and rollup.get("ranks", 1) > 1
    if rollup:
        print(
            f"{label} wall-clock (slowest rank): "
            f"{_fmt_seconds(rollup.get('take_wall_s'))}"
        )
        cov = rollup.get("phase_coverage_min")
        if cov is not None:
            print(f"phase coverage of wall-clock:   {cov * 100:.1f}%")
        stages = rollup.get("stages") or {}
        if stages:
            head = f"\n{'stage':<24s} {'ranks':>5s} {'p50':>10s} {'max':>10s}"
            print(head + ("  max@" if multi else ""))
            for name, agg in stages.items():
                line = (
                    f"{name:<24s} {agg.get('ranks', 0):>5d} "
                    f"{_fmt_seconds(agg.get('p50_s')):>10s} "
                    f"{_fmt_seconds(agg.get('max_s')):>10s}"
                )
                if multi and agg.get("max_rank") is not None:
                    line += f"  r{agg['max_rank']}"
                print(line)
        # Straggler attribution: the slowest rank per PHASE and how far
        # behind the median it was (the skew the stall watchdog's live
        # warnings pointed at, made durable).
        skew = rollup.get("phase_skew") or {}
        if multi and skew:
            print("\nstragglers (slowest rank per phase):")
            for name, agg in skew.items():
                if not agg.get("max_s"):
                    continue
                ratio = agg.get("skew")
                print(
                    f"  {name:<22s} rank {agg.get('max_rank')} at "
                    f"{_fmt_seconds(agg.get('max_s'))}"
                    + (f" ({ratio:.2f}x the p50)" if ratio else "")
                )
        counters = rollup.get("counters") or {}
        if counters:
            print("\ncounters (summed over ranks):")
            for name, v in sorted(counters.items()):
                print(f"  {name} = {v}")
        bw = rollup.get("bytes_written")
        if bw:
            print(f"\nbytes written:     {_fmt_bytes(bw)}")
        br = (rollup.get("counters") or {}).get("storage.bytes_read")
        if br:
            print(f"bytes read:        {_fmt_bytes(br)}")
        hw = rollup.get("budget_high_water_bytes")
        if hw:
            print(f"budget high-water: {_fmt_bytes(int(hw))}")
        rss = rollup.get("peak_rss_delta_bytes")
        if rss:
            print(f"peak RSS delta:    {_fmt_bytes(int(rss))}")
    if args.rank is not None:
        s = summaries.get(args.rank)
        if s is None:
            print(f"error: no trace for rank {args.rank}", file=sys.stderr)
            return 1
        print(
            f"\nrank {args.rank} stages "
            f"(wall {_fmt_seconds(s.get('take_wall_s'))}, "
            f"coverage {s.get('phase_coverage', 0) * 100:.1f}%):"
        )
        print(f"{'stage':<24s} {'count':>6s} {'total':>10s} {'p50':>10s} {'max':>10s}")
        for name, agg in (s.get("stages") or {}).items():
            print(
                f"{name:<24s} {agg.get('count', 0):>6d} "
                f"{_fmt_seconds(agg.get('total_s')):>10s} "
                f"{_fmt_seconds(agg.get('p50_s')):>10s} "
                f"{_fmt_seconds(agg.get('max_s')):>10s}"
            )
    return 0


def _load_take_traces(path: str):
    """(world_size, rollup-or-None, {rank: trace doc}) for a committed
    snapshot — the shared loader behind ``trace`` and ``analyze``."""
    import json as _json

    from .io_types import ReadIO
    from .telemetry import telemetry_rank_path

    snap = Snapshot(path)
    md = snap.metadata
    rollup = (md.extras or {}).get("telemetry")
    ranks: dict = {}
    with snap._op_lock:
        event_loop, storage = snap._resources()
        for rank in range(md.world_size):
            read_io = ReadIO(path=telemetry_rank_path(rank))
            try:
                storage.sync_read(read_io, event_loop)
                ranks[rank] = _json.loads(read_io.buf.getvalue().decode("utf-8"))
            except Exception:
                continue  # telemetry disabled on this rank, or pre-telemetry snapshot
    return md.world_size, rollup, ranks


def _load_restore_docs(path: str):
    """{rank: trace doc} for the last restore of ``path`` from the
    local telemetry dir, or None (with the explanation printed) when
    nothing was recorded."""
    from .progress import load_restore_traces, restore_trace_dir

    docs = load_restore_traces(path)
    if not docs:
        print(
            "no restore telemetry recorded for this path (no restore "
            "ran from this machine, TPUSNAP_TELEMETRY=0, or a "
            f"different TPUSNAP_TELEMETRY_DIR — looked in "
            f"{restore_trace_dir(path)})",
            file=sys.stderr,
        )
        return None
    return docs


_NO_TELEMETRY_MSG = (
    "no telemetry recorded (taken with TPUSNAP_TELEMETRY=0, or a "
    "pre-telemetry snapshot)"
)


def cmd_trace(args) -> int:
    from .telemetry import rollup_summaries

    if args.restore:
        docs = _load_restore_docs(args.path)
        if docs is None:
            return 3
        summaries = {r: d.get("summary") or {} for r, d in docs.items()}
        rollup = rollup_summaries(list(summaries.values()))
        return _render_trace(
            args, rollup, summaries, sorted(docs), len(docs), "restore"
        )

    world_size, rollup, ranks = _load_take_traces(args.path)
    summaries = {r: d.get("summary") or {} for r, d in ranks.items()}
    if rollup is None and summaries:
        rollup = rollup_summaries(list(summaries.values()))
    # "No telemetry" covers both the pre-telemetry snapshot (no rollup,
    # no traces) and the knob-off take (always-on counters rolled up,
    # but zero spans anywhere): an empty stage table helps nobody —
    # explain and exit with the dedicated code instead.
    has_spans = bool((rollup or {}).get("stages")) or any(
        s.get("stages") for s in summaries.values()
    )
    if not summaries and not has_spans:
        print(_NO_TELEMETRY_MSG, file=sys.stderr)
        return 3
    return _render_trace(
        args, rollup, summaries, sorted(ranks), world_size, "take"
    )


def _render_analyze(path: str, report: dict) -> None:
    kind = report.get("kind", "take")
    print(f"path:   {path}")
    att = report.get("attribution")
    if report.get("bound_by"):
        print(
            f"\nBOUND BY: {report['bound_by']} "
            f"({report.get('bound_pct', 0):.1f}% of {kind} wall-clock, "
            f"rank {report.get('rank')})"
        )
        if report.get("advice"):
            print(f"  → {report['advice']}")
    if att:
        wall = att.get("wall_s") or 0.0
        print(
            f"\nattribution (rank {report.get('rank')}, "
            f"wall {_fmt_seconds(wall)}, "
            f"coverage {att.get('coverage', 0) * 100:.1f}%):"
        )
        print(f"{'resource':<16s} {'attributed':>11s} {'%':>6s} {'busy':>10s}")
        pct = att.get("attributed_pct") or {}
        busy = att.get("busy_s") or {}
        for cat, secs in sorted(
            (att.get("attributed_s") or {}).items(),
            key=lambda kv: -kv[1],
        ):
            print(
                f"{cat:<16s} {_fmt_seconds(secs):>11s} "
                f"{pct.get(cat, 0):>5.1f}% "
                f"{_fmt_seconds(busy.get(cat)):>10s}"
            )
        ua = att.get("unattributed_s") or 0.0
        if wall > 0:
            print(
                f"{'(unattributed)':<16s} {_fmt_seconds(ua):>11s} "
                f"{100.0 * ua / wall:>5.1f}%"
            )
    hist = report.get("io_histograms")
    if hist:
        print("\nstorage-boundary latency (log2 histograms, all ranks):")
        print(
            f"{'op.plugin':<28s} {'count':>6s} {'p50':>9s} {'p95':>9s} "
            f"{'p99':>9s} {'max':>9s}"
        )
        for key, st in sorted(hist.items()):
            print(
                f"{key:<28s} {st.get('count', 0):>6d} "
                f"{_fmt_seconds(st.get('p50_s')):>9s} "
                f"{_fmt_seconds(st.get('p95_s')):>9s} "
                f"{_fmt_seconds(st.get('p99_s')):>9s} "
                f"{_fmt_seconds(st.get('max_s')):>9s}"
            )
    if report.get("roofline_fraction") is not None:
        line = f"\nroofline: {report['roofline_fraction']:.1%} of the in-take probe ceiling"
        probe = report.get("probe") or {}
        if probe.get("write_gbps_p50"):
            line += (
                f" ({probe['write_gbps_p50']:.2f} GB/s over "
                f"{probe.get('probes', 0)} probe(s))"
            )
        print(line)
    if report.get("restore_roofline_fraction") is not None:
        line = (
            f"\nread roofline: {report['restore_roofline_fraction']:.1%} "
            "of the in-restore probe READ ceiling"
        )
        probe = report.get("probe") or {}
        if probe.get("read_gbps_p50"):
            line += (
                f" ({probe['read_gbps_p50']:.2f} GB/s over "
                f"{probe.get('probes', 0)} probe(s))"
            )
        print(line)
    acc = report.get("access")
    if acc and acc.get("bytes_read"):
        print(
            f"\naccess: {acc.get('n_readers', 0)} reader(s), "
            f"{_fmt_bytes(acc.get('bytes_read') or 0)} read over "
            f"{_fmt_bytes(acc.get('snapshot_bytes') or 0)} stored — "
            f"coverage {(acc.get('coverage') or 0) * 100:.1f}%, "
            f"amplification {(acc.get('amplification') or 0):.2f}x "
            "(`tpusnap_torch heatmap` for the per-leaf view)"
        )
    trend = report.get("history")
    if trend and trend.get("events"):
        print(f"\nhistory trend (last {trend['events']} {kind} event(s)):")
        for metric, agg in trend.items():
            if not isinstance(agg, dict):
                continue
            print(
                f"  {metric}: latest {agg.get('latest')} vs median "
                f"{agg.get('median')} (n={agg.get('n')})"
            )
    findings = report.get("findings") or []
    if findings:
        print("\nfindings:")
        for f in findings:
            print(f"  [{f['severity'].upper()}] {f['message']}")
    else:
        print("\nfindings: none — no gate-worthy anomalies")


def cmd_analyze(args) -> int:
    import json as _json

    from .analyze import Thresholds, analyze
    from .telemetry import rollup_summaries

    thresholds = Thresholds(
        p99_ratio=args.p99_ratio,
        min_roofline=args.min_roofline,
        min_read_roofline=args.min_read_roofline,
        max_skew=args.max_skew,
    )
    history_events = None
    if args.history:
        from .history import load_history

        history_events = load_history()
    if args.restore:
        docs = _load_restore_docs(args.path)
        if docs is None:
            return 3
        rank_docs = docs
        rollup = rollup_summaries(
            [d.get("summary") or {} for d in docs.values()]
        )
        kind = "restore"
    else:
        try:
            _world, rollup, rank_docs = _load_take_traces(args.path)
        except Exception:
            # Not a committed snapshot. A torn/killed/aborted path has
            # no telemetry rollup to analyze — but it usually has a
            # black box: fold the flight recorder's post-mortem verdict
            # in instead of a bare load error.
            report, logs, verdict = _load_flight_view(args.path)
            if report.state == "committed":
                raise  # a committed snapshot failing to load is a real error
            if not logs:
                if report.state in ("empty", "foreign"):
                    # Nothing tpusnap-shaped here at all — a typo'd
                    # path must surface the original load error (exit
                    # 1), not a misleading "flight recording was off".
                    raise
                print(_NO_FLIGHT_MSG, file=sys.stderr)
                return 3
            if args.json:
                print(
                    _json.dumps(
                        {
                            "path": args.path,
                            "state": report.state,
                            "verdict": verdict,
                        }
                    )
                )
            else:
                print(f"path:   {args.path}")
                print(
                    f"state:  {report.state} — not a committed snapshot; "
                    "per-phase analysis needs a committed trace"
                )
                _render_verdict(verdict)
                print(
                    "\n(`python -m tpusnap_torch timeline` shows the merged "
                    "cross-rank event timeline)"
                )
            return 4
        if rollup is None and rank_docs:
            rollup = rollup_summaries(
                [d.get("summary") or {} for d in rank_docs.values()]
            )
        kind = "take"
    # Zero spans anywhere (knob-off take OR pre-telemetry snapshot):
    # there is nothing to attribute — one-liner + exit 3, matching
    # `trace`.
    has_spans = bool((rollup or {}).get("stages")) or any(
        (d.get("summary") or {}).get("stages") for d in rank_docs.values()
    )
    if not rank_docs or not has_spans:
        print(_NO_TELEMETRY_MSG, file=sys.stderr)
        return 3
    # Access heatmap context (best-effort): when readers left ledgers
    # for this snapshot, fold coverage/amplification into the report —
    # the partial_access advice needs both the ledgers and the manifest.
    heatmap = None
    try:
        from . import access

        _recs = access.load_ledger_records(args.path)
        if _recs:
            heatmap = access.compute_heatmap(
                _recs, _heatmap_metadata(args.path)
            )
    except Exception:
        heatmap = None
    report = analyze(
        rollup,
        rank_docs,
        kind=kind,
        thresholds=thresholds,
        history_events=history_events,
        heatmap=heatmap,
    )
    if args.json:
        print(_json.dumps({"path": args.path, **report}))
    else:
        _render_analyze(args.path, report)
    if args.check and report.get("check_failed"):
        return 2
    return 0


def cmd_tune(args) -> int:
    import json as _json

    from . import compress
    from .history import history_path, load_history
    from .tune import build_plan

    path = args.file or history_path()
    events = load_history(path)
    kind = args.kind
    if kind is None:
        # Default cell: whatever this host did last.
        kind = next(
            (
                e.get("kind")
                for e in reversed(events)
                if e.get("kind") in ("take", "restore")
            ),
            "take",
        )
    # Best-effort bound verdict from persisted traces (--snapshot):
    # absence degrades the plan (verdict-driven rules skip), never
    # fails it.
    verdict = None
    if args.snapshot:
        try:
            from .analyze import analyze
            from .telemetry import rollup_summaries

            if kind == "restore":
                from .progress import load_restore_traces

                docs = load_restore_traces(args.snapshot)
            else:
                _w, _roll, docs = _load_take_traces(args.snapshot)
            if docs:
                roll = rollup_summaries(
                    [d.get("summary") or {} for d in docs.values()]
                )
                verdict = analyze(roll, docs, kind=kind).get("bound_by")
        except Exception:
            verdict = None
    plan = build_plan(
        events,
        kind,
        backend=args.backend,
        world_size=args.world_size,
        ceilings=compress.pipe_ceilings_snapshot(),
        verdict=verdict,
        window=args.window,
    )
    if args.json:
        print(_json.dumps({"history": path, **plan.to_json()}))
    elif args.env:
        if plan.ok:
            print(f"# tune plan {plan.plan_id}: {plan.reason}")
            for line in plan.env_exports():
                print(line)
        else:
            print(f"# no plan: {plan.reason}")
    else:
        cell = (
            f"backend={plan.backend or 'any'} kind={plan.kind} "
            f"world_size={plan.world_size or 'any'}"
        )
        if not plan.ok:
            print(f"cell:    {cell}")
            print(f"no plan: {plan.reason}")
        else:
            print(f"plan:    {plan.plan_id}")
            print(f"cell:    {cell}")
            print(
                f"evidence: {plan.n_events} event(s)"
                + (f", bound verdict {plan.verdict!r}" if plan.verdict else "")
            )
            if not plan.knobs:
                print(f"\n{plan.reason}")
            else:
                print(f"\n{'knob':<42s} {'current':>14s} {'planned':>14s}")
                for k in plan.knobs:
                    print(
                        f"{k.env:<42s} {(k.current or '(default)'):>14s} "
                        f"{k.value:>14s}"
                    )
                    print(f"    {k.rationale}")
                print(
                    "\napply: eval \"$(python -m tpusnap_torch tune --env)\" — or "
                    "set TPUSNAP_AUTOTUNE=1 to reconcile at take/restore "
                    "begin (explicit env vars always win)"
                )
    if not plan.ok:
        return 3
    return 0


_NO_FLIGHT_MSG = (
    "no flight data recorded (TPUSNAP_FLIGHT=0, a pre-flight-recorder "
    "snapshot, or the take died before its first flush)"
)


def _fmt_rel_bytes(n) -> str:
    return _fmt_bytes(int(n)) if n else "0B"


def _flight_verdict(path: str, fsck_report, logs, resources=None) -> dict:
    """The post-mortem verdict for an uncommitted path (shared by
    ``timeline`` and ``analyze``)."""
    from .flight import _journal_evidence, postmortem_verdict

    world = None
    if fsck_report.journal is not None:
        world = fsck_report.journal.world_size
    elif fsck_report.metadata is not None:
        world = fsck_report.metadata.world_size
    evidence = _journal_evidence(fsck_report.files, path, resources=resources)
    return postmortem_verdict(
        path, fsck_report.state, logs, world_size=world,
        journal_evidence=evidence,
    )


def _load_flight_view(path: str):
    """(fsck_report, logs, verdict_or_None) for ``path``, read through
    ONE storage plugin + event loop — the shared orchestration behind
    ``timeline`` and ``analyze``'s uncommitted-path fold.

    Stale-sidecar filter: a torn take's journal names the current
    take_id; flight logs left by a PREVIOUS take to the same path (a
    retake overwrites only the ranks it runs) would otherwise merge
    into the verdict as live ranks — and their recurring barrier anchor
    strings would poison the skew estimate across takes. Logs whose
    header names a different take are dropped (headerless logs are
    kept, best-effort); the filtered-out ranks then correctly show as
    missing."""
    import asyncio

    from .flight import load_flight_logs
    from .lifecycle import fsck_snapshot
    from .storage_plugin import url_to_storage_plugin_in_event_loop

    event_loop = asyncio.new_event_loop()
    try:
        storage = url_to_storage_plugin_in_event_loop(path, event_loop)
        try:
            resources = (event_loop, storage)
            report = fsck_snapshot(path, resources=resources)
            logs = load_flight_logs(
                path, files=report.files, resources=resources
            )
            expected = (
                report.journal.take_id if report.journal is not None else None
            )
            if expected is None and logs:
                # Committed path: rank 0 participates in every take and
                # its sidecar is rewritten by the committing take, so
                # its header names the current take — leftover sidecars
                # from a wider previous take must not merge in (their
                # recurring barrier anchor strings would also poison
                # the skew estimate across takes).
                ref = logs.get(min(logs)) or {}
                expected = (ref.get("meta") or {}).get("take_id")
            if expected:
                logs = {
                    rank: doc
                    for rank, doc in logs.items()
                    if (doc.get("meta") or {}).get("take_id")
                    in (None, expected)
                }
            verdict = (
                _flight_verdict(path, report, logs, resources=resources)
                if report.state != "committed" and logs
                else None
            )
        finally:
            storage.sync_close(event_loop)
    finally:
        event_loop.close()
    return report, logs, verdict


def _render_verdict(verdict: dict) -> None:
    print(f"\nPOST-MORTEM (state: {verdict['state']}):")
    for rank, r in sorted(verdict["ranks"].items()):
        ops = r.get("inflight_ops") or []
        op = r.get("inflight_op")
        op_desc = op or "-"
        if op and len(ops) > 1:
            op_desc += f" (+{len(ops) - 1} more in flight)"
        print(
            f"  rank {rank}: state={r.get('state', '?')}  "
            f"phase={r.get('phase') or '-'}  in-flight op={op_desc}"
        )
        planned = r.get("bytes_planned")
        if planned:
            pct = r.get("percent")
            print(
                f"          bytes: {_fmt_rel_bytes(r.get('bytes_written'))} "
                f"written / {_fmt_rel_bytes(planned)} planned"
                + (f" ({pct:.1f}%)" if pct is not None else "")
                + f", {_fmt_rel_bytes(r.get('bytes_staged'))} staged"
            )
        j = r.get("journal")
        if j:
            print(
                f"          journal evidence: {j['blobs_completed']} "
                f"blob(s) fully written "
                f"({_fmt_rel_bytes(j['bytes_completed'])} intact on disk)"
            )
        last = r.get("last_event")
        if last:
            age = last.get("flush_age_s")
            print(
                f"          last event: {last.get('k')} "
                f"{last.get('op') or ''}".rstrip()
                + (
                    f", {age:.2f}s before the final flush (up to one "
                    "flush interval of newer events died with the "
                    "process)"
                    if age is not None
                    else ""
                )
            )
        if r.get("dropped"):
            print(
                f"          ring evicted {r['dropped']} older event(s) "
                "(raise TPUSNAP_FLIGHT_RING for longer black boxes)"
            )
    for rank in verdict.get("missing_ranks", []):
        print(
            f"  rank {rank}: NO FLIGHT DATA — killed before its first "
            "flush, a non-local destination, or the host died with its "
            "telemetry dir"
        )
    left = verdict.get("left_ranks")
    if left:
        print(
            f"  LEFT rank(s) {left}: departed GRACEFULLY (terminal "
            "'left' lease/membership state) — not a failure; the "
            "remaining ranks re-planned without them"
        )
    dead = verdict.get("dead_ranks")
    if dead:
        print(
            f"  DEAD rank(s) {dead}: liveness lease expired — the "
            "survivors observed these ranks die (SIGKILL/host loss), "
            "which is why the take never committed"
        )
    stalls = verdict.get("stall_episodes", 0)
    print(f"  stall episodes across ranks: {stalls}")


def cmd_timeline(args) -> int:
    from .flight import estimate_skew, merge_timeline

    report, logs, verdict = _load_flight_view(args.path)
    if not logs:
        print(_NO_FLIGHT_MSG, file=sys.stderr)
        return 3
    skew = estimate_skew(logs)
    events = merge_timeline(logs, skew)
    t0 = events[0]["wall"] if events else 0.0
    shown = events
    if args.rank is not None:
        shown = [e for e in shown if e["rank"] == args.rank]
    if args.around is not None:
        lo, hi = args.around - args.window, args.around + args.window
        shown = [e for e in shown if lo <= e["wall"] - t0 <= hi]
    if args.last:
        shown = shown[-args.last :]
    if args.json:
        import json as _json

        print(
            _json.dumps(
                {
                    "path": args.path,
                    "state": report.state,
                    "durability": report.durability,
                    "delta": report.delta,
                    "ranks": sorted(logs),
                    "skew": {str(r): s for r, s in sorted(skew.items())},
                    "events": shown,
                    "verdict": verdict,
                }
            )
        )
    else:
        print(f"path:   {args.path}")
        print(f"state:  {report.state} (fsck)")
        if report.cas_refs:
            # CAS verdict line: a post-mortem must say whether the
            # shared store still backs this snapshot's refs — a
            # dangling ref is restore-breaking regardless of how
            # cleanly the take itself committed.
            print(
                f"cas:    {report.cas_refs} ref(s) into "
                f"{report.cas_store}"
                + (
                    f" — {len(report.cas_dangling)} DANGLING "
                    "(the store lost blob(s); `fsck --store` it)"
                    if report.cas_dangling
                    else " (all blobs present in the store)"
                )
            )
        if report.durability is not None:
            # Write-back tiering: a committed-but-local-only snapshot is
            # one host failure away from losing its only copy — the
            # post-mortem must say which side of that line it died on.
            print(
                f"tier:   {report.durability}"
                + (
                    f" — cloud drain to {report.tier_remote} pending "
                    "(`tpusnap_torch drain` resumes it)"
                    if report.durability == "local-committed"
                    else (
                        f" at {report.tier_remote}"
                        if report.tier_remote
                        else ""
                    )
                )
            )
        if report.delta:
            parent = report.delta.get("parent")
            print(
                f"delta:  micro-commit seq {report.delta.get('seq')} of "
                f"stream {str(report.delta.get('stream'))[:8]}"
                + (f" over {parent}" if parent else "")
                + (
                    " — IN FLIGHT when the lights went out; recovery "
                    "lands on the last committed increment"
                    if report.state == "torn"
                    else ""
                )
            )
        print(f"ranks:  {sorted(logs)} with flight data")
        multi = len(logs) > 1
        if multi:
            print("clock alignment (barrier-anchored, relative to the "
                  "lowest rank):")
            for r, s in sorted(skew.items()):
                if s.get("anchors") is None:
                    continue  # the reference rank
                if s["anchors"]:
                    print(
                        f"  rank {r}: {s['offset_s'] * 1e3:+.2f}ms "
                        f"±{s['bound_s'] * 1e3:.2f}ms "
                        f"({s['anchors']} shared barrier anchor(s))"
                    )
                else:
                    print(
                        f"  rank {r}: no shared barrier anchors — "
                        "wall-clock ordering only"
                    )
        print(
            f"\ntimeline ({len(shown)} of {len(events)} event(s); "
            "+seconds since the first):"
        )
        for e in shown:
            extra = " ".join(
                f"{k}={v}"
                for k, v in e.items()
                if k not in ("t", "k", "op", "rank", "wall") and v is not None
            )
            print(
                f"  {e['wall'] - t0:+10.3f}s  r{e['rank']}  "
                f"{e['k']:<14} {e.get('op') or '-'}"
                + (f"  [{extra}]" if extra else "")
            )
        if verdict is not None:
            _render_verdict(verdict)
    if report.state == "committed":
        return 0
    return 4


def cmd_watch(args) -> int:
    import json as _json
    import os
    import time

    if args.fleet:
        return _watch_fleet(args)
    if not args.path:
        print(
            "error: watch needs a snapshot PATH (or --fleet to tail "
            "the cross-job fleet directory)",
            file=sys.stderr,
        )
        return 1

    from .progress import (
        local_root_of,
        read_progress_records,
        render_watch_table,
    )

    from .io_types import PROGRESS_DIR

    root = local_root_of(args.path)
    if root is None:
        print(
            f"error: {args.path!r} is not a local filesystem path — "
            f"`watch` tails the local heartbeat files under "
            f"{PROGRESS_DIR}/",
            file=sys.stderr,
        )
        return 1
    deadline = (
        time.monotonic() + args.max_seconds if args.max_seconds else None
    )
    seen_records = False
    commit_seen_at = None
    prev_lines = 0
    interactive = sys.stdout.isatty() and not args.once and not args.json
    # Tier-lag cache: tier_state_of_dir walks the whole payload tree;
    # recompute only when the upload journal actually changed (evidence
    # appends / durable marker) instead of per frame.
    from .io_types import UPLOAD_JOURNAL_PATH

    tier_cache = {"stat": None, "state": None}
    while True:
        records = read_progress_records(root)
        committed = os.path.exists(os.path.join(root, ".snapshot_metadata"))
        if records:
            seen_records = True
        if args.json:
            print(
                _json.dumps(
                    {"records": records, "metadata_committed": committed}
                )
            )
            return 0 if records else 3
        frame = render_watch_table(
            records, committed, stall_flag_s=args.stall_flag
        )
        # Write-back tiering: the drain's exposure line — a committed
        # take is not cloud-durable until the lag reaches zero.
        try:
            from .tiering import tier_state_of_dir

            st = os.stat(os.path.join(root, UPLOAD_JOURNAL_PATH))
            key = (st.st_mtime_ns, st.st_size)
            if key != tier_cache["stat"]:
                tier_cache["stat"] = key
                tier_cache["state"] = tier_state_of_dir(root)
            tier = tier_cache["state"]
        except Exception:
            tier = None
        if tier:
            if tier["durability"] == "remote-durable":
                frame += "\ntier: remote-durable"
            else:
                frame += (
                    f"\ntier: local-committed — "
                    f"{_fmt_bytes(tier.get('lag_bytes') or 0)} awaiting "
                    f"drain to {tier.get('remote')}"
                )
        if interactive and prev_lines:
            # Refresh in place: move the cursor back over the last frame.
            sys.stdout.write(f"\x1b[{prev_lines}F\x1b[J")
        print(frame, flush=True)
        prev_lines = frame.count("\n") + 1
        if args.once:
            return 0 if records else 3
        done = records and all(
            r.get("state") != "running" for r in records
        )
        if done:
            return 0
        if committed and seen_records:
            # Metadata lands a beat before the final 100% heartbeat —
            # give the publishers a short grace window, then stop.
            if commit_seen_at is None:
                commit_seen_at = time.monotonic()
            elif time.monotonic() - commit_seen_at > 2.0:
                return 0
        if deadline is not None and time.monotonic() > deadline:
            return 0 if seen_records else 3
        time.sleep(args.interval)


def cmd_history(args) -> int:
    import datetime
    import json as _json

    from .history import check_regression, history_path, load_history

    path = args.file or history_path()
    events = load_history(path)
    if args.check:
        if args.kind == "all":
            # Checking pools of incommensurable metrics is meaningless;
            # refuse instead of silently coercing to one kind.
            print(
                "error: --check needs one event kind "
                "(--kind take|restore|bench); run one check per kind",
                file=sys.stderr,
            )
            return 1
        # --metric is repeatable (and comma-splittable): one gate run
        # covers throughput AND the p99 storage-write latency (and any
        # other recorded scalar) in a single invocation.
        metrics: list = []
        for m in args.metric or ["throughput_gbps"]:
            metrics.extend(t.strip() for t in m.split(",") if t.strip())
        reports = [
            check_regression(
                events,
                kind=args.kind,
                metric=m,
                window=args.window,
                threshold=args.threshold,
                min_baseline=args.min_baseline,
            )
            for m in metrics
        ]
        regressed = [r for r in reports if r.regressed]
        any_ok = any(r.ok for r in reports)
        if args.json:
            # Machine-readable contract: every regressed metric is
            # NAMED, with its latest/baseline/window values, so a CI
            # wrapper never has to parse prose.
            print(
                _json.dumps(
                    {
                        "file": path,
                        "kind": args.kind,
                        "ok": any_ok and not regressed,
                        "regressed": [r.metric for r in regressed],
                        "checks": [r.to_json() for r in reports],
                    }
                )
            )
        else:
            for report in reports:
                verdict = (
                    "REGRESSION"
                    if report.regressed
                    else ("OK" if report.ok else "INSUFFICIENT DATA")
                )
                print(f"{verdict} [{report.kind}/{report.metric}]: {report.reason}")
                if report.baseline_median is not None:
                    print(
                        f"  latest {report.latest:.4g} vs trailing-median "
                        f"{report.baseline_median:.4g} over {report.n_baseline} "
                        f"run(s) (threshold {report.threshold:.0%})"
                    )
        # Exit contract unchanged: 2 = any metric regressed, 3 = no
        # metric could form a verdict at all, 0 otherwise (a metric
        # absent from older events does not fail the gate while the
        # checkable ones pass).
        if regressed:
            return 2
        return 0 if any_ok else 3
    shown = [
        e for e in events if args.kind == "all" or e.get("kind") == args.kind
    ]
    if args.limit:
        shown = shown[-args.limit :]
    if args.json:
        print(_json.dumps({"file": path, "events": shown}))
        return 0 if shown else 3
    if not shown:
        print(
            f"no history recorded (kind {args.kind!r}; looked in {path})",
            file=sys.stderr,
        )
        return 3
    print(
        f"{'when':<16} {'kind':<8} {'rank':>4} {'world':>5} "
        f"{'GB':>8} {'wall':>9} {'GB/s':>7}  notes"
    )
    for e in shown:
        ts = e.get("ts")
        when = (
            datetime.datetime.fromtimestamp(ts).strftime("%m-%d %H:%M:%S")
            if ts
            else "-"
        )
        gbps = e.get("throughput_gbps")
        notes = []
        if e.get("cold"):
            notes.append("cold")
        if e.get("stall_episodes"):
            notes.append(f"{e['stall_episodes']} stall(s)")
        if e.get("retry_attempts"):
            notes.append(f"{e['retry_attempts']} retries")
        if e.get("blobs_salvaged"):
            notes.append(f"{e['blobs_salvaged']} salvaged")
        if e.get("dedup_skips"):
            notes.append(f"{e['dedup_skips']} dedup")
        print(
            f"{when:<16} {e.get('kind', '?'):<8} {e.get('rank', 0):>4} "
            f"{e.get('world_size', 1):>5} "
            f"{(e.get('bytes') or 0) / 1e9:>8.2f} "
            f"{_fmt_seconds(e.get('wall_s')):>9} "
            f"{(f'{gbps:.2f}' if gbps is not None else '-'):>7}  "
            f"{' '.join(notes)}"
        )
    print(f"({len(shown)} of {len(events)} event(s) in {path})")
    return 0


def _fmt_age(s: float) -> str:
    if s < 120:
        return f"{s:.0f}s"
    if s < 7200:
        return f"{s / 60:.0f}m"
    if s < 172800:
        return f"{s / 3600:.1f}h"
    return f"{s / 86400:.1f}d"


def cmd_slo(args) -> int:
    import json as _json
    import os as _os

    from .slo import evaluate_records, read_slo_records, slo_dir

    directory = args.dir or slo_dir()
    records = read_slo_records(directory)
    report = evaluate_records(
        records, rpo_threshold_s=args.rpo, rto_threshold_s=args.rto
    )
    # Write-back tier exposure (tiering): a degraded uploader
    # means local-committed bytes whose cloud durability is NOT
    # converging — an SLO risk surfaced (and gated) alongside RPO/RTO.
    import time as _time

    from .knobs import get_tier_backoff_cap_s
    from .tiering import read_tier_status

    tier = read_tier_status(
        _os.path.dirname(directory.rstrip(_os.sep)) if args.dir else None
    )
    # A LIVE degraded drain republishes its status at least once per
    # backoff cycle; a flag older than a few cycles means the uploader
    # process is gone (SIGKILLed, or the job ended) — surface it as
    # stale instead of failing the gate forever on a dead breadcrumb.
    tier_stale = bool(
        tier
        and _time.time() - (tier.get("ts") or 0)
        > 10 * get_tier_backoff_cap_s()
    )
    tier_degraded = bool(tier and tier.get("degraded") and not tier_stale)
    if args.json:
        print(_json.dumps({"dir": directory, "tier": tier, **report}))
    else:
        print(f"slo dir:    {directory}")
        th = report["thresholds"]
        print(
            "thresholds: "
            f"rpo={'%gs' % th['rpo_s'] if th['rpo_s'] else 'unset'} "
            f"rto={'%gs' % th['rto_s'] if th['rto_s'] else 'unset'} "
            f"stream={'%gx cadence' % th['stream_cadence_x'] if th.get('stream_cadence_x') else 'off'} "
            "(TPUSNAP_SLO_RPO_S / TPUSNAP_SLO_RTO_S / "
            "TPUSNAP_SLO_STREAM_CADENCE_X)"
        )
        if report["ranks"]:
            print(
                f"\n{'rank':>4} {'since-commit':>13} {'at-risk':>10} "
                f"{'est-RTO':>9} {'rec-age':>8} {'dead':>6}  breach"
            )
            for r in report["ranks"]:
                flags = [
                    k
                    for k, on in (
                        ("RPO", r["breach_rpo"]),
                        ("RTO", r["breach_rto"]),
                        ("STREAM", r.get("breach_stream")),
                    )
                    if on
                ]
                rto = r.get("estimated_rto_s")
                rto_cell = _fmt_seconds(rto) if rto is not None else "-"
                if rto is not None and r.get("rto_source") == "probe":
                    rto_cell += "~"
                since = (
                    _fmt_age(r["since_commit_s"])
                    if r.get("committed")
                    else f"{_fmt_age(r['since_commit_s'])}*"
                )
                dead = r.get("dead_ranks")
                dead_s = ",".join(str(d) for d in dead) if dead else "-"
                print(
                    f"{r['rank']:>4} {since:>13} "
                    f"{_fmt_bytes(r['data_at_risk_bytes']):>10} "
                    f"{rto_cell:>9} "
                    f"{_fmt_age(r['record_age_s']):>8} {dead_s:>6}  "
                    f"{','.join(flags) or '-'}"
                    + ("  (exited cleanly; exposure frozen)"
                       if r.get("final") else "")
                )
            fleet = next(
                (r["fleet"] for r in report["ranks"] if r.get("fleet")), None
            )
            if fleet:
                print(
                    f"fleet (rank 0 fold over {fleet.get('ranks')} rank(s)): "
                    f"rpo {_fmt_age(fleet.get('rpo_s') or 0)}, "
                    f"{_fmt_bytes(fleet.get('data_at_risk_bytes') or 0)} at "
                    "risk"
                )
            cadence = next(
                (
                    r["stream_cadence_s"]
                    for r in report["ranks"]
                    if r.get("stream_cadence_s")
                ),
                None,
            )
            if cadence:
                print(
                    f"stream:     delta stream active, cadence {cadence:g}s "
                    "— micro-commits anchor the RPO (expect since-commit "
                    "≤ ~2x cadence; --check exits 2 past the stream "
                    "threshold)"
                )
            if any(not r.get("committed") for r in report["ranks"]):
                print("(* = no commit yet; exposure counted from tracker start)")
            if any(r.get("rto_source") == "probe" for r in report["ranks"]):
                print(
                    "(~ = RTO priced from the read-lane probe ceiling — "
                    "no restore history yet, no overhead term)"
                )
        if tier:
            if tier_degraded:
                print(
                    f"tier:       DEGRADED — remote {tier.get('remote')} "
                    f"unavailable, {_fmt_bytes(tier.get('lag_bytes') or 0)} "
                    f"local-committed only "
                    f"({_fmt_age(tier.get('lag_seconds') or 0)} of lag)"
                )
            elif tier.get("state") in ("draining", "degraded"):
                print(
                    f"tier:       {'STALE — last uploader status ' if tier_stale else ''}"
                    f"draining — "
                    f"{_fmt_bytes(tier.get('lag_bytes') or 0)} awaiting "
                    f"remote durability"
                    + (
                        " (uploader gone? `tpusnap_torch drain` resumes it)"
                        if tier_stale
                        else ""
                    )
                )
        print(f"\n{report['verdict'].upper()}: {report['reason']}")
    # A live degraded tier is a breach regardless of whether any SLO
    # rank records exist yet (a drain-only host still has bytes at
    # risk) — checked BEFORE the no-records leg so the gate cannot
    # read exit 3 ("insufficient") out of a real exposure.
    if args.check and tier_degraded:
        return 2
    # Without records there is nothing to render in any mode (exit 3,
    # like watch/trace). The 2-on-breach / 3-on-no-verdict legs are
    # gate semantics and apply under --check only.
    if not records:
        return 3
    if args.check:
        if report["verdict"] == "breach":
            return 2
        if report["verdict"] == "insufficient":
            return 3
    return 0


def _render_fleet_table(rollup: dict) -> str:
    """Per-job fleet status table (shared by ``fleet`` and ``watch
    --fleet``)."""
    lines = [
        f"{'job':<22} {'state':<10} {'phase':<10} {'%':>5} "
        f"{'since-commit':>13} {'at-risk':>9} {'lag':>9} {'read':>9} "
        f"{'rec-age':>8}  flags"
    ]
    for j in rollup.get("jobs") or []:
        flags = []
        if j.get("degraded"):
            flags.append("DEGRADED")
        if j.get("paused"):
            flags.append("PAUSED")
        if j.get("reader"):
            flags.append("READER")
        if j.get("dead_ranks"):
            flags.append(
                "dead:" + ",".join(str(r) for r in j["dead_ranks"])
            )
        pct = j.get("percent")
        lines.append(
            f"{str(j.get('job_id'))[:22]:<22} {j.get('state') or '?':<10} "
            f"{str(j.get('phase') or '-')[:10]:<10} "
            f"{(f'{pct:.0f}' if pct is not None else '-'):>5} "
            f"{_fmt_age(j.get('rpo_s') or 0):>13} "
            f"{_fmt_bytes(j.get('data_at_risk_bytes') or 0):>9} "
            f"{_fmt_bytes(j.get('lag_bytes') or 0):>9} "
            f"{(_fmt_bytes(j['bytes_read']) if j.get('bytes_read') else '-'):>9} "
            f"{_fmt_age(j.get('age_s') or 0):>8}  "
            f"{' '.join(flags) or '-'}"
        )
    return "\n".join(lines)


def _fleet_summary_lines(rollup: dict) -> str:
    """The cross-job rollup footer under the per-job table."""
    worst = rollup.get("worst_rpo_s")
    parts = [
        f"{rollup.get('n_jobs', 0)} job(s), "
        f"{rollup.get('writers', 0)} writing, "
        f"{rollup.get('degraded_jobs', 0)} degraded, "
        f"{rollup.get('paused_jobs', 0)} paused, "
        f"{rollup.get('dead_ranks', 0)} dead rank(s)"
    ]
    if worst is not None:
        parts.append(
            f"worst RPO {_fmt_age(worst)} ({rollup.get('worst_rpo_job')}), "
            f"{_fmt_bytes(rollup.get('worst_data_at_risk_bytes') or 0)} at "
            "risk"
        )
    parts.append(
        f"upload lag {_fmt_bytes(rollup.get('lag_bytes_total') or 0)} "
        f"(oldest {_fmt_age(rollup.get('lag_seconds_max') or 0)})"
    )
    if rollup.get("readers"):
        amp = rollup.get("read_amplification")
        line = (
            f"{rollup['readers']} reader(s), "
            f"{_fmt_bytes(rollup.get('bytes_read_total') or 0)} read"
        )
        if amp is not None:
            line += (
                f", worst read amplification {amp:.2f}x "
                f"(snapshot {rollup.get('read_amplification_digest')})"
            )
        parts.append(line)
    w = (rollup.get("storage") or {}).get("write") or {}
    if w.get("count"):
        parts.append(
            f"storage write p50 {_fmt_seconds(w.get('p50_s'))} / "
            f"p99 {_fmt_seconds(w.get('p99_s'))} over {w['count']} op(s) "
            "(merged across jobs)"
        )
    return "\n".join("fleet:      " + p for p in parts)


def cmd_fleet(args) -> int:
    import json as _json

    from .fleet import (
        evaluate_fleet,
        fold_fleet,
        read_fleet_records,
        write_fleet_prom,
    )
    from .knobs import get_fleet_dir

    directory = args.dir or get_fleet_dir()
    if not directory:
        print(
            "error: no fleet directory (set TPUSNAP_FLEET_DIR or pass "
            "--dir)",
            file=sys.stderr,
        )
        return 1
    records = read_fleet_records(directory)
    rollup = fold_fleet(records)
    report = evaluate_fleet(
        rollup,
        rpo_threshold_s=args.rpo,
        lag_bytes_threshold=args.lag_bytes,
        lag_seconds_threshold=args.lag_s,
        p99_ratio_threshold=args.p99_ratio,
        max_read_amplification=args.max_read_amplification,
    )
    if args.prom_out:
        write_fleet_prom(rollup, args.prom_out)
    if args.json:
        print(_json.dumps({"dir": directory, "rollup": rollup, **report}))
    else:
        print(f"fleet dir:  {directory}")
        th = report["thresholds"]
        print(
            "thresholds: "
            f"rpo={'%gs' % th['rpo_s'] if th['rpo_s'] else 'unset'} "
            f"lag_bytes={th['lag_bytes'] or 'unset'} "
            f"lag_s={'%gs' % th['lag_seconds'] if th['lag_seconds'] else 'unset'} "
            f"p99_ratio={'%gx' % th['p99_ratio'] if th['p99_ratio'] else 'unset'} "
            f"read_amp={'%gx' % th['read_amplification'] if th['read_amplification'] else 'unset'}"
        )
        if records:
            print()
            print(_render_fleet_table(rollup))
            print(_fleet_summary_lines(rollup))
        print(f"\n{report['verdict'].upper()}: {report['reason']}")
    # Without records there is nothing to render in any mode (exit 3,
    # like slo/watch). The 2-on-breach leg is gate semantics under
    # --check only.
    if not records:
        return 3
    if args.check and report["verdict"] == "breach":
        return 2
    return 0


def _watch_fleet(args) -> int:
    """``watch --fleet``: tail the shared fleet directory instead of one
    take's heartbeat files — one row per JOB, refreshed in place."""
    import json as _json
    import time

    from .fleet import fold_fleet, read_fleet_records
    from .knobs import get_fleet_dir

    directory = args.path or get_fleet_dir()
    if not directory:
        print(
            "error: no fleet directory (set TPUSNAP_FLEET_DIR, or "
            "`watch --fleet DIR`)",
            file=sys.stderr,
        )
        return 1
    deadline = (
        time.monotonic() + args.max_seconds if args.max_seconds else None
    )
    interactive = sys.stdout.isatty() and not args.once and not args.json
    prev_lines = 0
    seen_records = False
    while True:
        records = read_fleet_records(directory)
        rollup = fold_fleet(records)
        if records:
            seen_records = True
        if args.json:
            print(_json.dumps({"dir": directory, "rollup": rollup}))
            return 0 if records else 3
        frame = _render_fleet_table(rollup)
        if records:
            frame += "\n" + _fleet_summary_lines(rollup)
        else:
            frame += f"\n(no fleet status records in {directory})"
        if interactive and prev_lines:
            # Refresh in place: move the cursor back over the last frame.
            sys.stdout.write(f"\x1b[{prev_lines}F\x1b[J")
        print(frame, flush=True)
        prev_lines = frame.count("\n") + 1
        if args.once:
            return 0 if records else 3
        # A fleet is open-ended (jobs come and go) — unlike the per-take
        # watch there is no commit to wait for; run until the deadline.
        if deadline is not None and time.monotonic() > deadline:
            return 0 if seen_records else 3
        time.sleep(args.interval)


def _heatmap_metadata(path: str):
    """Own-resources manifest read for the heatmap CLI (the
    verify_snapshot pattern: fresh loop + plugin, closed on exit)."""
    import asyncio

    from .inspect import _read_metadata
    from .storage_plugin import url_to_storage_plugin_in_event_loop

    event_loop = asyncio.new_event_loop()
    try:
        storage = url_to_storage_plugin_in_event_loop(path, event_loop, None)
        try:
            return _read_metadata(storage, event_loop, path)
        finally:
            storage.sync_close(event_loop)
    finally:
        event_loop.close()


def cmd_heatmap(args) -> int:
    import json as _json

    from . import access

    records = access.load_ledger_records(args.path)
    if not records:
        print(
            f"no access ledgers for {args.path} under "
            f"{access.access_dir(args.path)} — readers record only with "
            "TPUSNAP_TELEMETRY=1 (and TPUSNAP_ACCESS_LEDGER not 0)",
            file=sys.stderr,
        )
        return 3
    metadata = _heatmap_metadata(args.path)
    hm = access.compute_heatmap(records, metadata)
    breach = bool(
        args.max_amplification is not None
        and hm["amplification"] > args.max_amplification
    )
    if args.json:
        out = {"path": args.path, **hm}
        if args.max_amplification is not None:
            out["max_amplification"] = args.max_amplification
            out["breach"] = breach
        print(_json.dumps(out))
    else:
        print(f"snapshot:   {args.path}")
        print(f"ledgers:    {access.access_dir(args.path)}")
        print(
            f"readers:    {hm['n_readers']}  "
            f"(bytes read {_fmt_bytes(hm['bytes_read'])} over "
            f"{_fmt_bytes(hm['snapshot_bytes'])} stored)"
        )
        print(
            f"coverage:   {hm['coverage'] * 100:.1f}% of stored bytes "
            "ever read"
        )
        amp_line = f"amplification: {hm['amplification']:.2f}x"
        if args.max_amplification is not None:
            amp_line += (
                f"  (threshold {args.max_amplification:g}x — "
                + ("BREACH" if breach else "ok")
                + ")"
            )
        print(amp_line)
        if hm.get("unattributed_bytes"):
            print(
                f"unattributed: {_fmt_bytes(hm['unattributed_bytes'])} "
                "(ledger paths absent from this manifest — stale "
                "ledgers or a rewritten snapshot)"
            )
        print()
        print(
            f"{'leaf':<44} {'stored':>9} {'read':>9} {'reads':>6} "
            f"{'rdrs':>5} {'cov%':>6} {'amp':>6}  sources"
        )
        for row in hm["leaves"]:
            srcs = ",".join(
                f"{s}:{_fmt_bytes(b)}"
                for s, b in sorted(row["sources"].items())
            )
            print(
                f"{row['path'][:44]:<44} "
                f"{_fmt_bytes(row['stored_bytes']):>9} "
                f"{_fmt_bytes(row['bytes_read']):>9} "
                f"{row['reads']:>6} {row['readers']:>5} "
                f"{row['coverage'] * 100:>5.1f}% "
                f"{row['amplification']:>5.2f}x  {srcs or '-'}"
            )
        hot = hm["hot_ranges"][: args.top]
        if hot:
            print()
            print(f"hottest tile ranges (top {len(hot)}):")
            for h in hot:
                print(
                    f"  {h['path']}  {h['location']}"
                    f"[{h['range'][0]}:{h['range'][1]})  "
                    f"{h['reads']} read(s), {_fmt_bytes(h['bytes'])}"
                )
    if args.check and breach:
        return 2
    return 0


def cmd_cat(args) -> int:
    """Print one object. A tensor prints as ``# <dtype>[shape]`` (the
    format's dtype string) and its values as numpy prints them; dtypes
    numpy lacks (bfloat16, the float8 family) print their values upcast
    to float32."""
    import torch

    out = Snapshot(args.path).read_object(args.manifest_path)
    if isinstance(out, torch.Tensor):
        from .serialization import dtype_to_string

        t = out.detach().cpu()
        try:
            arr = t.numpy()
        except TypeError:
            arr = t.to(torch.float32).numpy()
        print(f"# {dtype_to_string(t.dtype)}{list(t.shape)}")
        print(np.array2string(arr, threshold=64, edgeitems=3))
    elif isinstance(out, np.ndarray):
        print(f"# {out.dtype}{list(out.shape)}")
        print(np.array2string(out, threshold=64, edgeitems=3))
    else:
        print(repr(out))
    return 0


def cmd_lint(args) -> int:
    from .devtools import lint as _lint

    return _lint.main(args)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpusnap_torch", description=__doc__.split("\n")[0]
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="snapshot summary")
    p.add_argument("path")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("ls", help="list manifest entries")
    p.add_argument("path")
    p.add_argument("-l", "--long", action="store_true", help="sizes/types")
    p.add_argument("-a", "--all", action="store_true", help="include containers")
    p.set_defaults(fn=cmd_ls)

    p = sub.add_parser("verify", help="integrity scrub (checksum every blob)")
    p.add_argument("path")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("cat", help="print one object")
    p.add_argument("path")
    p.add_argument("manifest_path", help='"<rank>/<logical_path>"')
    p.set_defaults(fn=cmd_cat)

    p = sub.add_parser(
        "materialize",
        help="copy base-referenced blobs into an incremental snapshot, "
        "making it self-contained",
    )
    p.add_argument("path")
    p.set_defaults(fn=cmd_materialize)

    p = sub.add_parser(
        "diff",
        help="compare two snapshots by recorded checksums (no data reads)",
    )
    p.add_argument("path_a")
    p.add_argument("path_b")
    p.add_argument(
        "-q", "--quiet", action="store_true", help="summary line only"
    )
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser(
        "trace",
        help="render per-take telemetry (stage timings, counters, rollup)",
    )
    p.add_argument("path")
    p.add_argument(
        "--json", action="store_true", help="machine-readable summaries"
    )
    p.add_argument(
        "--rank", type=int, default=None, metavar="K",
        help="also print rank K's per-stage detail",
    )
    p.add_argument(
        "--restore", action="store_true",
        help="render the LAST restore's traces (persisted locally under "
        "TPUSNAP_TELEMETRY_DIR) instead of the take's",
    )
    p.set_defaults(fn=cmd_trace)

    from .io_types import PROGRESS_DIR

    p = sub.add_parser(
        "watch",
        help="live per-rank progress table of an in-flight take "
        f"(tails {PROGRESS_DIR}/ heartbeat records); --fleet tails the "
        "cross-job fleet directory instead (one row per JOB)",
    )
    p.add_argument(
        "path", nargs="?", default=None,
        help="snapshot path (with --fleet: the fleet directory, "
        "default TPUSNAP_FLEET_DIR)",
    )
    p.add_argument(
        "--fleet", action="store_true",
        help="tail the shared fleet directory (TPUSNAP_FLEET_DIR or "
        "PATH): per-job state, since-commit exposure, upload lag, "
        "degraded/paused flags",
    )
    p.add_argument(
        "--interval", type=float, default=1.0, metavar="S",
        help="refresh interval in seconds (default 1.0)",
    )
    p.add_argument(
        "--once", action="store_true", help="render one frame and exit"
    )
    p.add_argument(
        "--json", action="store_true",
        help="print one machine-readable frame and exit",
    )
    p.add_argument(
        "--max-seconds", type=float, default=None, metavar="S",
        help="give up after S seconds (default: wait for the commit)",
    )
    p.add_argument(
        "--stall-flag", type=float, default=10.0, metavar="S",
        help="flag a rank as STALLED? after S seconds without a beat "
        "(default 10)",
    )
    p.set_defaults(fn=cmd_watch)

    p = sub.add_parser(
        "history",
        help="cross-run take/restore performance history "
        "(--check = regression gate for CI/cron)",
    )
    p.add_argument(
        "--file", default=None,
        help="history file (default: TPUSNAP_TELEMETRY_DIR/history.jsonl)",
    )
    p.add_argument(
        "--kind", default="take",
        choices=["take", "restore", "bench", "orbax", "dcp", "fleet", "all"],
        help="event kind to show/check (default take; orbax = tpusnap's "
        "orbax_compare benchmark's median/speedup events; dcp = the "
        "dcp_compare benchmark's; fleet = fleetsim soak events)",
    )
    p.add_argument(
        "-n", "--limit", type=int, default=20, metavar="N",
        help="show the newest N events (default 20; 0 = all)",
    )
    p.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    p.add_argument(
        "--check", action="store_true",
        help="compare the latest run against the trailing median; "
        "exit 2 on regression, 3 on insufficient comparable history",
    )
    p.add_argument(
        "--metric", action="append", default=None, metavar="M",
        help="event field(s) to check — repeatable and comma-splittable "
        "(default throughput_gbps; *_s metrics such as "
        "storage_write_p99_s regress upward)",
    )
    p.add_argument(
        "--window", type=int, default=20, metavar="N",
        help="trailing baseline window (default 20 runs)",
    )
    p.add_argument(
        "--threshold", type=float, default=0.25, metavar="F",
        help="regression threshold as a fraction of the trailing median "
        "(default 0.25)",
    )
    p.add_argument(
        "--min-baseline", type=int, default=3, metavar="N",
        dest="min_baseline",
        help="minimum comparable baseline runs to form a verdict "
        "(default 3)",
    )
    p.set_defaults(fn=cmd_history)

    p = sub.add_parser(
        "analyze",
        help="performance doctor: bound-by verdict + knob advice, "
        "tail-latency outliers, stragglers, roofline fraction",
    )
    p.add_argument("path")
    p.add_argument(
        "--json", action="store_true", help="machine-readable report"
    )
    p.add_argument(
        "--check", action="store_true",
        help="exit 2 when any warn-severity finding fires (tail "
        "latency, straggler skew, roofline shortfall) — the CI gate",
    )
    p.add_argument(
        "--restore", action="store_true",
        help="analyze the LAST restore's traces (local "
        "TPUSNAP_TELEMETRY_DIR) instead of the take's",
    )
    p.add_argument(
        "--history", action="store_true",
        help="add trend context from this host's history.jsonl",
    )
    p.add_argument(
        "--p99-ratio", type=float, default=20.0, metavar="R",
        dest="p99_ratio",
        help="flag an op whose p99 latency exceeds R x its p50 "
        "(default 20)",
    )
    p.add_argument(
        "--min-roofline", type=float, default=0.4, metavar="F",
        dest="min_roofline",
        help="flag a take below this fraction of its in-take probe "
        "ceiling (default 0.4; needs TPUSNAP_PROBE=1 at take time)",
    )
    p.add_argument(
        "--min-read-roofline", type=float, default=0.4, metavar="F",
        dest="min_read_roofline",
        help="flag a restore below this fraction of its in-restore "
        "probe READ ceiling (default mirrors --min-roofline's 0.4; "
        "needs TPUSNAP_PROBE=1 at restore time)",
    )
    p.add_argument(
        "--max-skew", type=float, default=2.0, metavar="S",
        dest="max_skew",
        help="flag a phase whose slowest rank exceeds S x the p50 "
        "(default 2.0)",
    )
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser(
        "tune",
        help="deterministic knob plan for one (backend, kind, "
        "world_size) cell from history.jsonl + probe ceilings + the "
        "analyze verdict (exit 0 plan / 3 insufficient history)",
    )
    p.add_argument(
        "--file", default=None,
        help="history file (default: TPUSNAP_TELEMETRY_DIR/history.jsonl)",
    )
    p.add_argument(
        "--kind", choices=("take", "restore"), default=None,
        help="plan cell kind (default: this host's newest event's kind)",
    )
    p.add_argument(
        "--backend", default=None, metavar="LABEL",
        help="plan cell backend (innermost plugin class label; "
        "default: the newest matching event's)",
    )
    p.add_argument(
        "--world-size", type=int, default=None, dest="world_size",
        metavar="N",
        help="plan cell world size (default: the newest matching "
        "event's)",
    )
    p.add_argument(
        "--snapshot", default=None, metavar="PATH",
        help="fold the analyze bound verdict from PATH's persisted "
        "traces into the plan (best-effort)",
    )
    p.add_argument(
        "--window", type=int, default=50, metavar="N",
        help="newest N cell events to plan from (default 50)",
    )
    p.add_argument(
        "--json", action="store_true", help="machine-readable plan"
    )
    p.add_argument(
        "--env", action="store_true",
        help="shell-exportable `export TPUSNAP_X=value` lines",
    )
    p.add_argument(
        "--check", action="store_true",
        help="exit 0 when a plan renders, 3 on insufficient "
        "comparable history — the CI contract",
    )
    p.set_defaults(fn=cmd_tune)

    p = sub.add_parser(
        "timeline",
        help="forensic cross-rank event timeline from the flight-"
        "recorder sidecars; post-mortem verdict for uncommitted paths "
        "(exit 0 committed / 4 uncommitted / 3 no flight data)",
    )
    p.add_argument("path")
    p.add_argument(
        "--rank", type=int, default=None, metavar="K",
        help="show only rank K's events (skew/verdict still use all)",
    )
    p.add_argument(
        "--last", type=int, default=0, metavar="N",
        help="show only the newest N merged events (default: all)",
    )
    p.add_argument(
        "--around", type=float, default=None, metavar="T",
        help="show events within --window seconds of T seconds into "
        "the timeline",
    )
    p.add_argument(
        "--window", type=float, default=2.0, metavar="S",
        help="half-width of the --around window (default 2.0s)",
    )
    p.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser(
        "fsck",
        help="classify a snapshot directory (committed/torn/empty/"
        "corrupt-metadata/foreign) and enumerate orphan blobs",
    )
    p.add_argument("path")
    p.add_argument(
        "-v", "--verbose", action="store_true",
        help="list each orphan/missing file",
    )
    p.add_argument(
        "--store", action="store_true",
        help="treat PATH as a content-addressed STORE directory: "
        "store-wide verdicts (dangling refs, orphan blobs, torn "
        "publishes, stale intents/roots, refcount-cache divergence); "
        "exit 0 clean-or-reclaimable / 4 dangling ref(s) / 3 not a "
        "store",
    )
    p.set_defaults(fn=cmd_fsck)

    p = sub.add_parser(
        "gc",
        help="reclaim orphan blobs (dry-run unless --force)",
    )
    p.add_argument("path")
    p.add_argument(
        "--force", action="store_true", help="actually delete (default: dry-run)"
    )
    p.add_argument(
        "--torn", action="store_true",
        help="also discard a TORN take's blobs (forfeits salvage-resume)",
    )
    p.add_argument(
        "--evict-local", action="store_true",
        help="write-back tiering: also reclaim a REMOTE-DURABLE "
        "snapshot's local payload blobs (refused before the upload "
        "journal's durable marker, and within the "
        "TPUSNAP_TIER_LOCAL_RETENTION_S hot-cache window; metadata and "
        "the journal stay, reads through the tier URL fall back to the "
        "remote)",
    )
    p.add_argument(
        "--store", action="store_true",
        help="treat PATH as a content-addressed STORE directory: "
        "mark-and-sweep over ref records (grace window "
        "TPUSNAP_CAS_GRACE_S, per-store lock lease); sweeps "
        "unreferenced blobs, torn publishes, stale intents and stale "
        "roots",
    )
    p.set_defaults(fn=cmd_gc)

    p = sub.add_parser(
        "drain",
        help="write-back tiering: force-drain a tiered snapshot to its "
        "remote tier (resumes from the crash-safe upload journal; "
        "exit 0 remote-durable / 2 did-not-converge / 3 not tiered)",
    )
    p.add_argument(
        "path",
        help="tier URL (tier+local=...+remote=...://...) or the local "
        "tier directory (the upload journal names the remote)",
    )
    p.add_argument(
        "--store", action="store_true",
        help="treat PATH as a content-addressed STORE directory: "
        "upload each blob ONCE store-wide to the store's remote "
        "mirror (config.json remote / TPUSNAP_CAS_REMOTE), journaled "
        "by hash for crash-safe resume",
    )
    p.add_argument(
        "--remote", default=None, metavar="URL",
        help="override the remote tier URL recorded in the journal",
    )
    p.add_argument(
        "--timeout", type=float, default=None, metavar="SECS",
        help="give up (exit 2, resumable) after this long of sustained "
        "remote unavailability (default: keep probing until durable)",
    )
    p.add_argument(
        "--status", action="store_true",
        help="report the per-snapshot tier state without draining",
    )
    p.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    p.set_defaults(fn=cmd_drain)

    p = sub.add_parser(
        "retain",
        help="keep the newest N snapshots under a directory; materialize "
        "kept increments, then delete the rest (local fs only)",
    )
    p.add_argument("root")
    p.add_argument("--keep", type=int, required=True, metavar="N")
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(fn=cmd_retain)

    p = sub.add_parser(
        "slo",
        help="checkpoint SLO state (per-rank time-since-commit, "
        "data-at-risk, estimated RTO, breach flags); --check gates "
        "(exit 2 breach / 3 no records or no estimator verdict)",
    )
    p.add_argument(
        "--dir", default=None, metavar="DIR",
        help="SLO sidecar directory (default: TPUSNAP_TELEMETRY_DIR/slo)",
    )
    p.add_argument(
        "--rpo", type=float, default=None, metavar="S",
        help="RPO threshold in seconds (default: TPUSNAP_SLO_RPO_S; "
        "0/unset = no RPO objective)",
    )
    p.add_argument(
        "--rto", type=float, default=None, metavar="S",
        help="RTO threshold in seconds (default: TPUSNAP_SLO_RTO_S; "
        "0/unset = no RTO objective)",
    )
    p.add_argument(
        "--json", action="store_true", help="machine-readable report"
    )
    p.add_argument(
        "--check", action="store_true",
        help="gate mode: exit 2 on a breached objective, 3 when no "
        "records exist or an RTO objective has no estimate, 0 healthy",
    )
    p.set_defaults(fn=cmd_slo)

    p = sub.add_parser(
        "fleet",
        help="cross-job fleet status from the shared TPUSNAP_FLEET_DIR "
        "(per-job table, worst-case RPO/at-risk fold, aggregate upload "
        "lag, merged storage latency); --check gates (exit 2 breach / "
        "3 no records)",
    )
    p.add_argument(
        "--dir", default=None, metavar="DIR",
        help="fleet status directory (default: TPUSNAP_FLEET_DIR)",
    )
    p.add_argument(
        "--rpo", type=float, default=None, metavar="S",
        help="worst-job RPO threshold in seconds (default: "
        "TPUSNAP_SLO_RPO_S; 0/unset = no RPO objective)",
    )
    p.add_argument(
        "--lag-bytes", type=int, default=None, metavar="N",
        dest="lag_bytes",
        help="aggregate upload-lag threshold in bytes summed across "
        "jobs (default: no objective)",
    )
    p.add_argument(
        "--lag-s", type=float, default=None, metavar="S", dest="lag_s",
        help="upload-lag age threshold in seconds — the fleet's oldest "
        "undurable commit (default: no objective)",
    )
    p.add_argument(
        "--p99-ratio", type=float, default=None, metavar="R",
        dest="p99_ratio",
        help="breach when the cross-job merged storage write p99 "
        "exceeds R x its p50 (default: no objective)",
    )
    p.add_argument(
        "--prom-out", default=None, metavar="PATH", dest="prom_out",
        help="also write the rollup as scope=\"fleet\" Prometheus "
        "families to PATH (atomic; point into a node collector's "
        "textfile directory)",
    )
    p.add_argument(
        "--json", action="store_true", help="machine-readable report"
    )
    p.add_argument(
        "--max-read-amplification", type=float, default=None, metavar="X",
        dest="max_read_amplification",
        help="breach when any snapshot's merged cross-reader read "
        "amplification (aggregate bytes read / stored bytes) exceeds X "
        "(default: no objective)",
    )
    p.add_argument(
        "--check", action="store_true",
        help="gate mode: exit 2 on a breached fleet objective, 3 when "
        "no status records exist, 0 healthy",
    )
    p.set_defaults(fn=cmd_fleet)

    p = sub.add_parser(
        "heatmap",
        help="merge reader access ledgers into a per-leaf read heatmap "
        "— counts, bytes, distinct readers, coverage and read "
        "amplification (requires readers run with TPUSNAP_TELEMETRY=1)",
    )
    p.add_argument("path", help="snapshot path the ledgers were recorded for")
    p.add_argument(
        "--top", type=int, default=10, metavar="N",
        help="hottest tile ranges to list (default 10)",
    )
    p.add_argument(
        "--max-amplification", type=float, default=None, metavar="X",
        dest="max_amplification",
        help="flag (and with --check, gate) aggregate read "
        "amplification above X (bytes read / stored bytes)",
    )
    p.add_argument(
        "--json", action="store_true", help="machine-readable heatmap"
    )
    p.add_argument(
        "--check", action="store_true",
        help="gate mode: exit 2 when amplification exceeds "
        "--max-amplification, 3 when no ledgers exist, 0 otherwise",
    )
    p.set_defaults(fn=cmd_heatmap)

    p = sub.add_parser(
        "lint",
        help="AST invariant checker over the package source (knob "
        "access, monotonic clocks, sidecar literals, silent swallows, "
        "async blocking calls, finalizer joins, knob/doc drift); "
        "--check exits 2 on findings",
    )
    p.add_argument(
        "--root", default=None, metavar="DIR",
        help="package directory to lint (default: the tpusnap_torch "
        "package)",
    )
    p.add_argument(
        "--select", default=None, metavar="RULES",
        help="comma-separated rule ids to run (default: all)",
    )
    p.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    p.add_argument(
        "--check", action="store_true",
        help="gate mode: exit 2 on any unwaived finding, 0 on clean",
    )
    p.set_defaults(fn=cmd_lint)

    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        # argparse exits 2 on usage errors, which would collide with the
        # documented "2 = corruption found" contract; --help stays 0.
        return 0 if e.code in (0, None) else 1
    try:
        return args.fn(args)
    except (RuntimeError, KeyError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
