"""Fleet soak: concurrent snapshot lifecycles, one shared tier, seeded
chaos, graded by the fleet observability layer itself.

Counterpart of benchmarks/fleet/fleetsim.py, with the same grading. It
starts a small fleet (trainers in a take loop, one continuous delta
stream, one restore loop), every job a real OS process with its own
``TPUSNAP_JOB_ID``, all publishing into one shared ``TPUSNAP_FLEET_DIR``
and all writing through one shared local+remote write-back tier. With
``--device cuda`` every job's state lives on the card. Seeded faults
(``TPUSNAP_FAULT_SPEC`` on ``chaos+fs://`` remotes) hit selected jobs:

- a sustained REMOTE OUTAGE window on trainer 0's drain;
- a RANK KILL (SIGKILL mid-write) on trainer 1: its fleet record must
  stay non-final;
- a BANDWIDTH CAP starving trainer 2's drain;
- a WEDGE (SIGSTOP inside a write; the parent SIGCONTs it) on trainer 3;
- per-op transient faults on the delta stream.

A shared-base BRANCHING cohort (``--branch``) writes mostly identical
content through one content-addressed store (``TPUSNAP_CAS_DIR``) under
seeded transient faults: the store's blob bytes must stay within 1.25x
ONE job's logical bytes and the store must ``fsck --store`` clean. An
optional READER cohort (``--readers``) restores one shared snapshot, and
its merged access ledgers are graded by ``heatmap --check``.

The grades: ``python -m tpusnap_torch fleet --check`` over the fleet dir
must be HEALTHY (generous thresholds: only the SIGKILLed job may miss its
commit), every other job must report its commits, and a ``kind="fleet"``
history event is recorded and gated by ``history --check`` (exit 3, no
baseline yet, is accepted).

``--jobs N`` runs N - 2 trainers, the stream and the restorer; with
N = 3 all three are trainers (the mini-fleet of an outage, a kill and a
bandwidth cap).

    python -m tpusnap_torch.benchmarks.fleetsim [--jobs 8] [--takes 3]
        [--mb 4] [--branch 4] [--readers 0] [--seed 0] [--timeout 300]
        [--keep] [--device cuda|cpu]
"""

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from tpusnap_torch._device import add_device_argument, device_missing

RESULT_TAG = "FLEETSIM_RESULT "
_MODULE = "tpusnap_torch.benchmarks.fleetsim"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# --------------------------------------------------------------- children


def _mk_state(args, seed: int):
    import torch

    from tpusnap_torch import StateDict

    gen = torch.Generator(device=args.device).manual_seed(seed)
    n = max(int(args.mb * 1e6) // 4, 1024)
    return {"app": StateDict(weights=torch.randn(n, generator=gen, device=args.device), step=0)}


def run_trainer(args) -> dict:
    """A training job: ``--takes`` takes through the shared write-back
    tier (local cache + chaos-wrapped shared remote)."""
    from tpusnap_torch import Snapshot

    state = _mk_state(args, args.seed + args.index)
    committed = 0
    for k in range(args.takes):
        state["app"]["weights"].add_(1.0)
        state["app"]["step"] = k
        Snapshot.take(
            f"tier+local={args.base}/local/{args.job}/t{k}"
            f"+remote=chaos+fs://{args.base}/remote/{args.job}/t{k}",
            state,
        )
        committed += 1
        time.sleep(args.pause)
    return {"committed": committed, "takes": args.takes}


def run_stream(args) -> dict:
    """A continuous-checkpointing job: one delta stream, explicit
    micro-commits under per-op transient faults."""
    from tpusnap_torch import Snapshot

    state = _mk_state(args, args.seed + args.index)
    stream = Snapshot.stream(f"chaos+fs://{args.base}/remote/{args.job}/stream", state,
                             cadence_s=30.0)
    commits = 0
    try:
        for k in range(args.takes):
            state["app"]["weights"].add_(0.5)
            state["app"]["step"] = k
            stream.commit_now()
            commits += 1
            time.sleep(args.pause)
    finally:
        stream.close(final_commit=False)
    return {"committed": commits, "takes": args.takes}


def run_brancher(args) -> dict:
    """A shared-base branching job: every brancher derives the SAME seeded
    base weights plus a small per-job delta tensor and takes through the
    shared content-addressed store, so the store holds ~1x one job's
    bytes, not Nx."""
    import torch

    from tpusnap_torch import Snapshot, StateDict

    n = max(int(args.mb * 1e6) // 4, 1024)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)  # shared content
    delta_gen = torch.Generator(device=args.device).manual_seed(1000 + args.index)
    state = {"app": StateDict(
        weights=torch.randn(n, generator=gen, device=args.device),
        delta=torch.randn(256, generator=delta_gen, device=args.device),
        step=0,
    )}
    committed = 0
    for k in range(args.takes):
        # The base evolves identically across branches: each generation's
        # weights dedup store-wide; only each job's delta is unique.
        state["app"]["weights"].add_(1.0)
        state["app"]["step"] = k
        Snapshot.take(f"chaos+fs://{args.base}/cas_jobs/{args.job}/t{k}", state)
        committed += 1
        time.sleep(args.pause)
    return {"committed": committed, "takes": args.takes}


def run_restorer(args) -> dict:
    """A restore-loop job: a seed take, repeated restores from it, then a
    final take so the job's last fleet record is a committed one."""
    from tpusnap_torch import Snapshot

    state = _mk_state(args, args.seed + args.index)
    seed_path = f"chaos+fs://{args.base}/remote/{args.job}/seed"
    Snapshot.take(seed_path, state)
    restores = 0
    for _ in range(args.takes):
        Snapshot(seed_path).restore(state)
        restores += 1
        time.sleep(args.pause)
    state["app"]["weights"].add_(1.0)
    Snapshot.take(f"chaos+fs://{args.base}/remote/{args.job}/final", state)
    return {"committed": 1 + restores, "takes": args.takes}


def run_readseed(args) -> dict:
    """Takes the one shared snapshot the reader cohort serves from (plain
    fs: the read-attribution grade must not ride chaos)."""
    from tpusnap_torch import Snapshot

    Snapshot.take(f"{args.base}/shared/seed", _mk_state(args, args.seed + 97))
    return {"committed": 1, "takes": 1}


def run_reader(args) -> dict:
    """A serving reader over the shared seed snapshot: full restores, each
    attributed by the access ledger into the SHARED telemetry dir."""
    from tpusnap_torch import Snapshot

    state = _mk_state(args, args.seed + 97)
    snap = Snapshot(f"{args.base}/shared/seed")
    restores = 0
    for _ in range(max(args.takes, 1)):
        snap.restore(state)
        restores += 1
        time.sleep(args.pause)
    return {"committed": 0, "restores": restores, "takes": args.takes}


ROLES = {"trainer": run_trainer, "stream": run_stream, "restore": run_restorer,
         "branch": run_brancher, "readseed": run_readseed, "reader": run_reader}


def child_main(args) -> int:
    t0 = time.time()
    out = {"job": args.job, "role": args.role, "ok": False}
    try:
        out.update(ROLES[args.role](args))
        out["ok"] = True
    except Exception as e:  # reported to the parent, which grades it
        out["error"] = f"{type(e).__name__}: {e}"
    out["wall_s"] = round(time.time() - t0, 2)
    print(RESULT_TAG + json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


# ----------------------------------------------------------------- parent

# Trainer index -> fault spec of its chaos+fs remote. Survivable by design
# except the SIGKILL: that job's missing commit is EXPECTED.
FAULTS = {
    0: "seed=1,outage=write:0:3",  # remote down 3 s; the drain rides it out
    1: None,  # the doomed job; its spec is built from --kill-after
    2: "seed=3,bandwidth_gbps=0.05",  # starved drain pipe
    3: "seed=4,wedge=write:*",  # SIGSTOP mid-write; the parent SIGCONTs
}
STREAM_FAULT = "seed=5,transient_per_op=1"
DOOMED = "fleetsim-trainer1"


def spawn_job(args, index: int, role: str, base: str, fleet_dir: str) -> dict:
    job = f"fleetsim-{role}{index}"
    env = dict(
        os.environ,
        PYTHONPATH=os.pathsep.join(p for p in (_REPO, os.environ.get("PYTHONPATH")) if p),
        TPUSNAP_JOB_ID=job,
        TPUSNAP_FLEET_DIR=fleet_dir,
        TPUSNAP_TELEMETRY_DIR=os.path.join(base, "telemetry", job),
        TPUSNAP_HEARTBEAT_INTERVAL_S="0.1",
    )
    if role == "trainer" and index in FAULTS:
        spec = FAULTS[index]
        if index == 1:
            spec = f"seed=2,crash_after_op=write:{args.kill_after}"
        env["TPUSNAP_FAULT_SPEC"] = spec
    elif role == "stream":
        env["TPUSNAP_FAULT_SPEC"] = STREAM_FAULT
    elif role in ("reader", "readseed"):
        # The cohort shares ONE telemetry dir, so the parent's heatmap
        # merge sees every reader's ledger (job ids stay distinct).
        env["TPUSNAP_TELEMETRY_DIR"] = os.path.join(base, "telemetry", "readers")
    elif role == "branch":
        # One shared content-addressed store; batching off so the base
        # weights reach the store as a dedupable blob, not a slab.
        env["TPUSNAP_CAS_DIR"] = os.path.join(base, "cas_store")
        env["TPUSNAP_DISABLE_BATCHING"] = "1"
        env["TPUSNAP_FAULT_SPEC"] = f"seed={7 + index},transient_per_op=1"
    cmd = [
        sys.executable, "-m", _MODULE, "--child", "--role", role, "--index", str(index),
        "--job", job, "--base", base, "--takes", str(args.takes), "--mb", str(args.mb),
        "--seed", str(args.seed), "--pause", str(args.pause),
        "--kill-after", str(args.kill_after), "--device", args.device,
    ]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=_REPO)
    return {"job": job, "role": role, "index": index, "proc": proc,
            "wedged": role == "trainer" and index == 3}


def cli(cmd, env=None):
    r = subprocess.run([sys.executable, "-m", "tpusnap_torch"] + cmd,
                       capture_output=True, text=True, env=env, cwd=_REPO)
    return r.returncode, r.stdout, r.stderr


def _babysit(jobs, timeout: float) -> None:
    """SIGCONT the wedged job each poll (a running process ignores it, a
    stopped one resumes), hard-kill anything past the deadline."""
    deadline = time.time() + timeout
    while any(j["proc"].poll() is None for j in jobs):
        for j in jobs:
            if j["wedged"] and j["proc"].poll() is None:
                try:
                    os.kill(j["proc"].pid, signal.SIGCONT)
                except OSError:
                    pass  # it exited between the poll and the signal
        if time.time() > deadline:
            for j in jobs:
                if j["proc"].poll() is None:
                    j["proc"].kill()
            break
        time.sleep(1.0)


def _grade_cas(args, jobs, base: str, failures: list):
    """The branching cohort's storage bill; returns the dedup ratio."""
    from tpusnap_torch.cas import BLOBS_DIR, read_refs_dir

    cas_store = os.path.join(base, "cas_store")
    blobs_dir = os.path.join(cas_store, BLOBS_DIR)
    store_bytes = sum(
        e.stat().st_size
        for e in (os.scandir(blobs_dir) if os.path.isdir(blobs_dir) else [])
        if e.is_file()
    )
    logical_bytes = 0
    for j in jobs:
        if j["role"] != "branch":
            continue
        for k in range(args.takes):
            refs, _ = read_refs_dir(os.path.join(base, "cas_jobs", j["job"], f"t{k}"))
            logical_bytes += sum(int(rec[0]) for rec in refs.values())
    ratio = round(logical_bytes / store_bytes, 2) if store_bytes else None
    budget = 1.25 * (logical_bytes / max(args.branch, 1))
    print(f"\ncas store: {store_bytes} blob byte(s) for {logical_bytes} logical byte(s) across "
          f"{args.branch} branch job(s) — dedup ratio {ratio} (budget {budget:.0f} B)")
    if store_bytes and store_bytes > budget:
        failures.append(f"cas-store-{store_bytes}B-over-{budget:.0f}B-budget")
    rc, _, err = cli(["fsck", "--store", cas_store])
    print(f"fsck --store: rc={rc}")
    if rc != 0:
        failures.append(f"cas-fsck-rc{rc}")
        if err.strip():
            print(err.strip())
    return ratio


def _grade_readers(args, base: str, n_readers: int, failures: list) -> dict:
    """The reader cohort's merged access ledgers."""
    env = dict(os.environ, TPUSNAP_TELEMETRY_DIR=os.path.join(base, "telemetry", "readers"))
    budget = n_readers * max(args.takes, 1) + 1
    rc, out, err = cli(["heatmap", os.path.join(base, "shared", "seed"), "--json", "--check",
                        "--max-amplification", str(budget)], env=env)
    try:
        doc = json.loads(out) if out else {}
    except ValueError:
        doc = {}
    print(f"\nheatmap --check: rc={rc} — {doc.get('n_readers', 0)} reader(s), coverage "
          f"{doc.get('coverage')}, amplification {doc.get('amplification')} (budget {budget}x)")
    if rc != 0:
        failures.append(f"heatmap-check-rc{rc}")
        if err.strip():
            print(err.strip())
    if doc.get("n_readers", 0) < n_readers:
        failures.append(f"heatmap-readers-{doc.get('n_readers', 0)}-of-{n_readers}")
    return doc


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog=_MODULE)
    parser.add_argument("--jobs", type=int, default=8,
                        help="fleet size (>= 3; 3 runs trainers only; default 8)")
    parser.add_argument("--takes", type=int, default=3)
    parser.add_argument("--mb", type=float, default=4.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pause", type=float, default=0.2, help="per-step sleep inside each job")
    parser.add_argument("--branch", type=int, default=4,
                        help="shared-base branching jobs through one content-addressed store "
                        "(0 disables; default 4)")
    parser.add_argument("--readers", type=int, default=0,
                        help="serving-reader jobs restoring ONE shared snapshot (0 disables)")
    parser.add_argument("--kill-after", type=int, default=1, dest="kill_after",
                        help="SIGKILL the doomed trainer after its Nth remote payload write")
    parser.add_argument("--timeout", type=float, default=300.0)
    parser.add_argument("--keep", action="store_true", help="keep the working directory")
    add_device_argument(parser)
    # child-mode plumbing
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--role", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--index", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--job", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--base", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if device_missing(parser.prog, args.device):
        return 2
    if args.child:
        return child_main(args)
    if args.jobs < 3:
        parser.error("--jobs must be >= 3")

    base = args.base or tempfile.mkdtemp(prefix="tpusnap_torch_fleetsim_")
    fleet_dir = os.path.join(base, "fleet")
    os.makedirs(fleet_dir, exist_ok=True)
    trainers_only = args.jobs == 3
    n_trainers = args.jobs if trainers_only else args.jobs - 2
    t0 = time.time()
    jobs = [spawn_job(args, i, "trainer", base, fleet_dir) for i in range(n_trainers)]
    if not trainers_only:
        jobs.append(spawn_job(args, n_trainers, "stream", base, fleet_dir))
        jobs.append(spawn_job(args, n_trainers + 1, "restore", base, fleet_dir))
    for b in range(args.branch):
        jobs.append(spawn_job(args, args.jobs + b, "branch", base, fleet_dir))
    if args.readers:
        # The shared seed must be committed before any reader starts.
        seed = spawn_job(args, 0, "readseed", base, fleet_dir)
        try:
            seed["proc"].communicate(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            seed["proc"].kill()
            seed["proc"].communicate()
        if seed["proc"].returncode != 0:
            print("readseed: FAILED — skipping the reader cohort")
        else:
            jobs += [spawn_job(args, r, "reader", base, fleet_dir) for r in range(args.readers)]
    print(f"fleet: {len(jobs)} job(s) under {base} on {args.device} (faults on trainers 0-3 "
          f"and the stream; trainer 1 is doomed; {args.branch} branch job(s) share one CAS "
          f"store; {args.readers} reader(s) on one shared snapshot)")

    _babysit(jobs, args.timeout)
    results = {}
    for j in jobs:
        stdout, stderr = j["proc"].communicate()
        rc = j["proc"].returncode
        rep = None
        for line in (stdout or "").splitlines():
            if line.startswith(RESULT_TAG):
                rep = json.loads(line[len(RESULT_TAG):])
        results[j["job"]] = {"role": j["role"], "rc": rc, "report": rep,
                             "killed": rc is not None and rc < 0,
                             "stderr_tail": (stderr or "")[-2000:]}

    print(f"\n{'job':<22} {'role':<8} {'rc':>4} {'committed':>9}  verdict")
    failures = []
    for name, r in sorted(results.items()):
        rep = r["report"] or {}
        expected_kill = name == DOOMED
        ok = (rep.get("ok") and r["rc"] == 0) or (expected_kill and r["killed"])
        if expected_kill and r["killed"]:
            verdict = "KILLED (expected)"
        elif ok:
            verdict = "ok"
        else:
            verdict = "FAIL ({})".format(rep.get("error") or "rc={}".format(r["rc"]))
            failures.append(name)
            print(r["stderr_tail"])
        print(f"{name:<22} {r['role']:<8} {str(r['rc']):>4} {rep.get('committed', 0):>9}  "
              f"{verdict}")

    # Grade 1: the fleet gate over what every job published. Generous
    # thresholds: it catches jobs that never published or committed.
    n_readers = sum(1 for j in jobs if j["role"] == "reader")
    fleet_cmd = ["fleet", "--dir", fleet_dir, "--json", "--check", "--rpo", "3600",
                 "--lag-s", "3600"]
    if n_readers:
        fleet_cmd += ["--max-read-amplification", str(n_readers * max(args.takes, 1) + 1)]
    rc, out, _ = cli(fleet_cmd)
    fleet_doc = json.loads(out) if rc in (0, 2, 3) and out else {}
    rollup = fleet_doc.get("rollup") or {}
    print(f"\nfleet --check: rc={rc} ({(fleet_doc.get('verdict') or '?').upper()}: "
          f"{fleet_doc.get('reason')})")
    if rc != 0:
        failures.append(f"fleet-check-rc{rc}")
    if rollup.get("n_jobs", 0) < len(jobs):
        failures.append(f"fleet-records-{rollup.get('n_jobs', 0)}-of-{len(jobs)}")

    cas_dedup_ratio = _grade_cas(args, jobs, base, failures) if args.branch else None
    heatmap_doc = _grade_readers(args, base, n_readers, failures) if n_readers else {}

    # Grade 2: a kind="fleet" history event and the trend gate over it
    # (exit 3 = first run, no baseline).
    wall = round(time.time() - t0, 2)
    w = (rollup.get("storage") or {}).get("write") or {}
    from tpusnap_torch.history import record_event

    record_event({
        "kind": "fleet", "ts": time.time(), "jobs": len(jobs),
        "committed_jobs": sum(1 for r in results.values() if (r["report"] or {}).get("ok")),
        "worst_rpo_s": rollup.get("worst_rpo_s"),
        "lag_bytes_total": rollup.get("lag_bytes_total"),
        "storage_write_p99_s": w.get("p99_s"),
        # higher is better in the trend gate: a dedup regression trips it
        "cas_dedup_ratio": cas_dedup_ratio,
        "readers": rollup.get("readers"),
        "read_amplification": (heatmap_doc.get("amplification") if heatmap_doc
                               else rollup.get("read_amplification")),
        "wall_s": wall,
    })
    rc_h, out_h, _ = cli(["history", "--check", "--kind", "fleet", "--metric", "wall_s"])
    print(f"history --check --kind fleet: rc={rc_h} "
          f"({'no baseline yet' if rc_h == 3 else out_h.strip()})")
    if rc_h not in (0, 3):
        failures.append(f"history-check-rc{rc_h}")

    if not args.keep and not failures:
        shutil.rmtree(base, ignore_errors=True)
    elif failures:
        print(f"(kept {base} for inspection)")
    print(f"\nfleetsim: {len(jobs)} job(s) in {wall:.1f}s — "
          + ("PASS" if not failures else f"FAIL: {failures}"))
    from tpusnap_torch.benchmarks import result

    return result(
        "fleetsim", args.device, not failures, jobs=len(jobs), trainers=n_trainers,
        branch=args.branch, readers=n_readers, takes=args.takes, mb=args.mb,
        job_results={k: {"role": v["role"], "rc": v["rc"], "killed": v["killed"],
                         "committed": (v["report"] or {}).get("committed")}
                     for k, v in results.items()},
        fleet_check_rc=rc, worst_rpo_s=rollup.get("worst_rpo_s"),
        cas_dedup_ratio=cas_dedup_ratio, history_check_rc=rc_h, wall_s=wall,
        failures=failures,
    )


if __name__ == "__main__":
    sys.exit(main())
