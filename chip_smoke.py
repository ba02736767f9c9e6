#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpusnap_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it builds what it needs on first use
(the native helper with g++, the kernel library with nvcc for sm_90a).
It prints one JSON line per phase and, last, one line
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. Without CUDA it exits 2 at once.

Phases, in order:

1. device  — the card's name and power limit (nvidia-smi).
2. build   — g++ and nvcc builds, started together; their seconds, each
             kernel instantiation's registers and spill bytes (ptxas) and
             HGMMA count (cuobjdump -sass). Fails if the D=64 bf16 flash
             wgmma kernel or any ring block wgmma kernel spills, or a
             wgmma kernel has no HGMMA instruction.
3. kernels — every kernel of the port against its plain PyTorch version
             on the card at the main path's shape and at ragged and
             strided shapes, on the route each input takes, a bitwise
             repeat check, and the tensor-core kernel's time beside the
             simt kernel's, the plain version's, one PyTorch library
             call's as a yardstick, and the least time the card could take
             for the same work. The ring block kernel in each carry mode
             (first, middle, last, first+last) at the flagship's ring
             block (8, 512, 8, 64) bf16 as a diagonal, a past and a
             future block with a non-trivial incoming carry (rows that
             have seen nothing among them), the ring of one's single
             block (8, 1024, 8, 64), ragged f16/bf16 blocks at offsets
             that cut tiles and f32 (simt), each held per element to
             ``ring_attention.rounding_bound`` (the carry) or
             ``finish_bound`` (a last mode's output), and to the modes'
             two bitwise identities (first = middle from the empty carry,
             last = middle then ``_finish``); every mode's past and
             diagonal block timed warm and with the L2 flushed, beside its
             plain version and, for first+last, SDPA. The ring of one's
             whole forward (one first+last launch) timed beside the flash
             kernel, SDPA and the attention bound. The ring's backward
             for one block (``block_grads``, plain PyTorch in f32) at the
             ring block, diagonal and causal: per element against f32
             autograd, timed warm and with the L2 flushed beside SDPA's
             backward (forward and backward captured, less the forward)
             and its bound.
4. train   — the flagship transformer at its full default width trains
             5 Adam steps on the card; the attention forward must run
             the flash kernel n_layers x steps times.
5. snapshot — Snapshot.take of the train state, restore into a fresh
             model (bit-exact, Parameter identity kept), read_object, and
             one more step from both giving bitwise-equal losses.
6. bulk    — take and restore of 4 GiB of CUDA tensors (32 x 128 MiB).
7. async_train — Snapshot.async_take of the train state, then at once two
             train steps on the same model (in-place Adam updates) while
             the take drains, then wait(); the restore into a fresh model
             must equal a device clone of the state taken before the call,
             bit for bit, and one step from each must give the same loss.
8. async_bulk — async_take of the 4 GiB state (larger than the 2 GiB
             staging window, so residual windows drain from device
             copies), add_(1) on every tensor right after the return,
             wait(); the restore must equal the values before the add_.
9. chunked — two 1.25 GiB CUDA tensors (f32, bf16) above the 512 MiB
             chunk size with a ragged last chunk: take, manifest check,
             restore in place, read_object under a 64 MiB budget into a
             CUDA target, async_restore into zeroed targets.
10. incremental — incremental takes of the train state: a full base
             recording tile dedup hashes; inc1 unchanged (writes nothing);
             inc2 after one embedding row changed (writes one 16 MiB
             tile); an async increment staged at its return, with a train
             step at once; inc3 after two Adam steps. Each restores into a
             fresh model bit-exact (Parameter identity kept) and one step
             from it equals one from a witness; verify() is clean;
             apply_retention(keep_last=2) materializes and deletes, and
             the survivors still restore and verify. Then the 4 GiB bulk:
             an increment after add_(1) on 1 of 32 tensors writes 128 MiB.
             Bytes written come from the files on disk, references from
             the manifest (``../`` locations and byte ranges).
11. compress — TPUSNAP_COMPRESS=on: the train state and two 1.25 GiB
             chunked tensors, restored in place bit-exact, a read_object
             under a 64 MiB budget into a CUDA target; ratio and GB/s; the
             ``auto`` decision of the bulk take.
12. transforms — cast_on_save of the f32 parameters to bf16: half-size
             blobs, restore into the f32 params equal to the bf16 round
             trip; then an async take of the 4 GiB bulk with its f32 half
             cast and add_(1) on every tensor right after the return.
13. distributed — two ranks on the one card
             (``tpusnap_torch.test_utils.run_subprocess_world``: a gloo
             process group, the port's store communicator; no device
             collective). Each rank trains the flagship at full width from
             one seed (2 Adam steps) and proves the replicas bitwise equal
             by hashes (else copies rank 0's state, and says so); then a
             sync take with ``replicated=["**"]`` (exactly 2 gathers, 2
             barriers, 0 broadcasts; every entry checksummed; each rank's
             staged and written bytes within one tensor of an even split),
             a restore into a fresh model (no collective; bit-exact,
             Parameter identity, post-restore step equal to the
             witness's), an async take with a train step at once, wait()
             and restore, the parent's world-1 snapshot restored on both
             ranks (1 -> 2), and an async take whose writes fail on rank
             1: both wait() raise well inside TPUSNAP_BARRIER_TIMEOUT_S
             (120 s here) and no .snapshot_metadata appears. The parent
             then restores the world-2 snapshot into a world-1 model
             (2 -> 1), bit for bit.
14. sharded — the same two ranks, each training the flagship, expose
             the train state as Shard(0) DTensors over
             DeviceMesh("cuda", [0, 1]) whose local tensors are views of
             the rank's own parameters and Adam moments (the 0-d step
             stays dense). A sync take (each rank stages and writes its
             own boxes; 2 gathers, 2 barriers, 0 broadcasts; every shard
             checksummed; verify() clean), an unchanged increment (0
             bytes), a take under a 16 MiB shard cap (the embedding's and
             unembedding's boxes split), an async take with a train step
             at once; restores into views of a fresh model, in place and
             bit-exact per box: 2 -> 2 into Shard(0), the capped snapshot
             into Shard(1) for 2-D and 3-D leaves, the async snapshot
             (the state before the step), and the parent's world-1
             snapshot (1 -> 2). The parent restores the world-2 snapshot
             into a dense model (2 -> 1) and one step from it equals one
             from a witness holding rank 0's state.

15. moe    — the MoE flagship at full default width with 4 experts
             (71,315,968 parameters; a train state of 855,791,620 bytes in
             31 tensors): two steps, a take, an async take with a step at
             once, restores of both into a fresh model (bit-exact,
             Parameter identity, a post-restore step bitwise equal to a
             witness's), verify().
16. embedding — tpusnap's embedding benchmark configuration: 4 row-wise
             [1,000,000, 64] f32 tables with row-wise Adagrad accumulators
             (1,040,000,000 bytes in 8 tensors), t2 and t3 pinned on the
             host (520,000,000 bytes). Adagrad steps (pinned rows gathered
             and updated on the host), a sync take whose device-to-host
             bytes are exactly the device tables' (none for the pinned
             ones), an unchanged increment (0 bytes written), an async
             take with a step at once (its snapshot equals the state at
             the call), restores that keep every tensor's identity,
             storage and pinning.
17. layouts — two ranks on the one card: the MoE train state as DTensor
             views at (data, fsdp, tensor) = (1, 2, 1), taken (each rank
             writes exactly its boxes) and restored into (1, 1, 2) views of
             a fresh model (a reshard, in place); the embedding tables
             row-wise at (1, 2, 1), the pinned ones over a "cpu" mesh,
             taken, then read dense with read_object and placed
             column-wise. The parent restores both world-2 snapshots into
             world 1 (2 -> 1), bit for bit, in place, pinning kept.
18. ring   — the flagship at full width with use_ring_attention: two
             ranks on the one card (gloo) each hold half of every
             sequence; the group's loss must equal the single-process
             dense model's within 1e-4 relative and each rank's logits
             the dense model's per element within 0.2 (the ring of one's
             too), rank 0 launching the ring block kernel 4 times as
             first+last (its future blocks skipped) and rank 1 8 times (4
             first, 4 last). A train step split into forward and backward
             (CUDA events), a ring-of-one model's beside a dense one's.
             Then a ring-of-one replica trains 3 Adam
             steps; its train state is taken and restored into a fresh
             ring model and into a fresh dense model, each bit for bit
             with Parameter identity and a post-restore step equal to a
             witness's.
19. sharded_step — tpusnap's sharded train step on four ranks sharing
             the card (gloo; collectives staged through pinned host
             buffers) at tpusnap's default mesh for four devices,
             (data, fsdp, tensor) = (1, 2, 2): (a) the ring flagship at
             full width, tokens (8, 1024), the sequence over fsdp (512
             positions a rank), 3 Adam steps; step 1's loss within 1e-4
             relative and its gradients within 1e-2 per leaf (relative
             Frobenius) of a one-process ring-of-one model on the whole
             batch; the ring block kernel's launches by mode (under grad:
             first and middle, all wgmma), the backward's block steps;
             the ring's output under grad equal to its no_grad output bit
             for bit. (c) The state after step 3 taken (each rank writes
             exactly its boxes), restored into a fresh state at (1, 2, 2)
             (step 4 bit for bit against the witness's) and at (1, 4, 1),
             a ring of 4 with middle steps (step 4's loss within 1e-4).
             (b) The dense flagship at (1, 2, 2), one step against the
             one-replica step, the flash kernel at each rank's (4, 1024)
             batch shard (all wgmma); (d) the MoE flagship (4 experts) at
             (2, 2, 1), its expert dim over data, one step with the same
             checks. Prints each step's seconds and its
             split (gather, forward, backward, reduce, update: wall time
             with the card synchronised at each stage).
20. crash  — the crash-safe take (every take journals itself, records
             telemetry and a flight log). A fresh flagship trained one
             step; its train state (saved to a file, setup) is loaded by
             a spawned child, which takes it through chaos+fs:// with
             crash_after_op=write:10 and TPUSNAP_DISABLE_BATCHING=1 and is
             SIGKILLed by that plan. No .snapshot_metadata, fsck torn;
             a retake salvages (bytes written < the state's, every byte
             still staged); restore bit-exact, a post-restore step equal
             to a witness's, verify() clean, gc reclaims only the killed
             process's .tmp debris. Then a child's async take of the
             4 GiB bulk, add_(1) at once, killed mid-drain: the retake
             restores the state at the call.
21. crash_matrix — tpusnap's commit-window crash matrix on the card
             (tests/test_torch_crash_matrix.py and test_torch_delta_crash.py
             on the CPU). Children load the flagship's train state onto
             the card (553,703,428 bytes in 28 tensors, batching off: one
             blob per tensor), print MARK inside one commit window, linger
             1.2 s and are SIGKILLed (their process group) at
             random.Random(seed).uniform(0, 1.5) s after the MARK: seed 0
             (1.27 s) after the window, seed 1 (0.20 s) inside it; the
             five windows of one seed run at once. staging: right after
             the first device-to-host copy into a pinned buffer is
             enqueued on its side stream; residual_io: an async_take (a
             128 MiB staging window, every blob write delayed 0.15 s),
             then 3 flagship train steps on the flash kernel that change
             the state in place while the drain runs; metadata: in the
             metadata writer after a partial flushed temp write; durable:
             TPUSNAP_DURABLE_COMMIT=1, in the flush of the created
             directories; journal: in the journal write. After each kill
             .snapshot_metadata exists iff the snapshot restores into CUDA
             targets bit for bit against the state file (the state at the
             call, for residual_io) and verify_snapshot is clean; fsck
             says committed, torn (journal present; timeline --json then
             names the killed take's phase) or empty/foreign. Then the
             delta stream of a CUDA tensor w = pattern + k (steps 1..7) in
             its three windows at seed 1 (jitter uniform(0, 0.8)): inside a
             micro-commit's blob write, between two commits, at the start
             of chain compaction; the head restores bit for bit as the
             last committed step, a torn tail is torn and keeps its chain
             membership, fsck of the root exits 4 with a torn tail, 0
             without. Prints per kill the jitter, the outcome, bit_exact,
             the child's and the check's seconds, and residual_io's flash
             launches.
22. chaos  — the train state through chaos+fs:// under a seeded plan
             (a transient error per op and every 5th op, 1 ms latency,
             torn writes), batching off: take and restore converge under
             retry (retries counted), the restore reads as many blobs in
             place as a plain path's; an async take under the plan with a
             train step at once holds the state at the call.
23. liveness — three two-rank worlds at once (TPUSNAP_LIVENESS_TTL_S=2):
             rank 1 SIGKILLed by a hook in its process at its first
             stage, first blob write or commit barrier; rank 0 raises
             RankFailedError naming it within 3x the TTL (seconds
             printed), the merged flight timeline names rank 1, the
             directory is torn with salvage records.
24. degrade — three two-rank worlds at once (TPUSNAP_RANK_FAILURE=
             degrade): a replicated sync take whose rank 1 dies after its
             first blob write, committed by rank 0 (adopted bytes
             printed, extras["degraded"]); an async take with a train step
             in place on rank 0 right after the call, then rank 1 (wedged
             on its first write) SIGKILLed: the committed snapshot equals
             the state at the call, bitwise; a Shard(0) DTensor take
             whose peer dies refuses to degrade and is torn.
25. lifecycle_ab — printed, not gated: the bulk take and the train
             state's take and restore with the default layers against
             TPUSNAP_DISABLE_JOURNAL=1 TPUSNAP_TELEMETRY=0, compression off,
             three of each in turns after a warm-up round; the
             distributed phase also times its take at a 0.5 s and a
             0.02 s heartbeat and with telemetry off.
26. delta  — Snapshot.stream of a fresh flagship's train state
             (cadence 0.5 s, TPUSNAP_DELTA_MAX_CHAIN=4, compression off)
             while it trains 12 Adam steps paced to 0.25 s, mark_step()
             after each; a device clone of the state at every boundary.
             Every member is restored into a fresh model as it commits
             and must be its boundary bit for bit (compaction retires
             the superseded ones). Two commit_now() with no step between:
             the second writes 0 payload bytes; one embedding row
             changed: at most one 16 MiB checksum tile. One step from the
             head and from its clone give the same loss. Then
             free-running streams (no mark_step) while training on the
             default stream and under a side stream: every tensor of
             every member equals that tensor at some boundary. Prints the
             seconds each capture blocked mark_step, step times with and
             without a stream, each member's payload bytes, the members
             retired by compaction.
27. delta_elastic — two ranks on the card, each a full replica of the
             lifecycle model, replicated=["**"], TPUSNAP_LIVENESS_TTL_S=2,
             TPUSNAP_RANK_FAILURE=degrade: a clean two-rank epoch, every
             tensor changed in place, then rank 1 SIGKILLed at its first
             blob write of the next epoch; rank 0 commits that epoch
             degraded and streams on alone; the head restores bit for
             bit. Prints the detection seconds, the adopted bytes and
             each member's world from extras["delta"]["world"].
28. tier   — the 4 GiB bulk through tier+local=<a>+remote=chaos+fs://<b>
             while every remote op fails for 10 s (an outage), beside a
             plain take; the background drain converges once the outage
             ends (durable marker); gc --evict-local (retention 0); a
             restore through the tier URL from the remote, bit for bit.
             Then the train state through a tier, and 5 train steps while
             its drain runs against 5 without. Both tiers are on the one
             local disk.
29. cas    — two job ids take the lifecycle model's train state into two
             directories with one TPUSNAP_CAS_DIR (batching off: slab
             blobs are named per take and never dedup): the second
             publishes 0 bytes and the store holds the state once; each
             restores into CUDA tensors in place, bit for bit; one is
             deleted and gc_store keeps the shared blobs; the other still
             restores. The other job's snapshot and the store stay for cli.
30. observe — every consumer of the take's telemetry on (history, the
             Prometheus textfile and JSONL sinks, the SLO thresholds, the
             fleet mirror, the access ledger, the roofline probe;
             compression off): a fresh flagship trains, record_slo_step()
             after each step; three sync takes and one async take of the
             train state, a take and a restore of the 4 GiB bulk, two
             restores of the train state in place (bit for bit), one
             read_object. Checks one history event per completed take and
             restore in tpusnap's shape, the strict textfile parse and
             its gauges, the SLO sidecar and fleet record, the RPO gauge
             reset at each commit, access coverage 1.0 for the restore
             and below 1 for read_object, a write and a read probe
             ceiling. Prints analyze's split of a train-state take and
             restore and of the bulk's, the probe GB/s, estimate_rto
             against the measured restores; the hooks' A/B (every hook
             but the probe against all off, three takes each,
             interleaved); an autotuned take whose history event carries
             the plan id that `tune` prints.
31. cli    — ``python -m tpusnap_torch`` in subprocesses on what observe,
             crash (a copy of its torn take), tier (the remote-durable
             train state), cas and delta left: every subcommand (lint
             --check over the package's own source),
             each exit code held to the contract for that state (the
             --check gates to the verdict the library gives for the same
             files), watch --once on a take whose writes are held back;
             then a child calls main() in process for info, verify, fsck
             and cat and must leave torch.cuda.is_initialized() False.
             Prints each command's exit code and seconds.
32. examples — the port's four examples in process (``main(argv)``), each
             in its own directory: simple, then its resume from epoch_2
             (prints "resumed ... at epoch 2", then epoch 3); incremental
             (its "incremental on", "0 corrupt" and "bit-exact" lines);
             distributed at --world-size 2 (two gloo ranks on the card);
             and the transformer example at --width full (the flagship
             with 4 experts, tokens (8, 1024)): 3 epochs of 4 Adam steps
             with an async take per epoch, then a resume from epoch_2
             through async_restore that trains epoch 3 and commits it.
             Every epoch snapshot scrubs clean, and the resumed epoch_3
             restores into a fresh model in place, bit for bit against
             read_object. The flash kernel must launch 4 layers x (12 + 4)
             steps = 64 times, all wgmma. Prints each example's seconds
             and the transformer's blocked, wait and restore seconds.
33. benchmarks — the ten benchmark harnesses of the port in process, at
             the sizes ``_HARNESSES`` gives (each cut of a default listed
             under "reduced"), one line per harness: its own last line
             under "phase": "benchmarks". Fails on a false correctness
             field: load_tensor's RSS within 8x its 100 MiB budget,
             pinned_host's target still pinned, the bit-exact restores
             (async_latency, incremental, replicated, sharded, embedding,
             gcs_pipeline, each of dcp_compare's five methods), fleetsim's
             own grade. A last line gives both phases' seconds.

Launch counts (in all and by route) are set to 0 just before each path
that runs the model — train + snapshot, async_train, incremental, each
rank of distributed, sharded and layouts, sharded's parent, moe, the
lifecycle model with crash and chaos, each residual_io child of
crash_matrix (its train steps), rank 0 of the sync and async
degrade worlds, delta, tier with cas, observe, and the examples phase's two transformer
runs — and read just after
it: the kernels phase's comparison launches do not count. The ring block
kernel's counts (by route and by carry mode, and its skipped future
blocks, the backward's block steps) are set to 0 at the same points and
read for each rank of the ring phase and for its replica (20 launches,
all first+last; the dense model restored from the replica's snapshot
counts as a flash path), and in each rank of sharded_step for (a), for
(c)'s three steps 4 and, as flash paths, for (b) and (d). Every main-path
launch must take the wgmma route. The incremental, transforms and the
four A8b phases run with compression off, so their byte counts are the
tensors' own.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and dense
# bf16/f16 tensor-core FLOP/s; f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

# The flagship transformer's attention shape: batch 8, seq 1024, 8 heads of 64.
SLICE_SHAPE = (8, 1024, 8, 64)
# One rank's block of it when two ranks split the sequence (the ring phase).
RING_BLOCK_SHAPE = (8, 512, 8, 64)
TRAIN_STEPS = 5
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph and replayed between two CUDA events, so the host's enqueue
    time between calls is not counted; the median of 5 replays over
    ``reps``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def time_ms_cold(fn, reps: int, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` with the L2 cache flushed before
    it: ``reps`` (flush, call) pairs captured in one CUDA graph, less
    ``reps`` flushes alone in another (a flush zeroes 256 MiB, five times
    the 50 MB L2); the median of 5 replays of each over ``reps``."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def both():
        flush.zero_()
        fn()

    alone = time_ms(flush.zero_, reps, warmup)
    return time_ms(both, reps, warmup) - alone


def attention_bound(shape, dtype: str, causal: bool):
    """(least ms, "bytes" or "operations") for one attention forward at
    ``shape``: the larger of the bytes (q, k, v read once, o written
    once) over HBM and the operations these inputs need (the causal
    pairs only) over the peak rate of their type."""
    b, s, h, d = shape
    itemsize = {"bfloat16": 2, "float16": 2, "float32": 4}[dtype]
    nbytes = 4 * b * s * h * d * itemsize
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * attention_flops(shape, causal) / PEAK_FLOPS[dtype]
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def attention_flops(shape, causal: bool) -> int:
    """FLOPs of QK^T and PV over the pairs the mask keeps (2 per
    multiply-add)."""
    b, s, h, d = shape
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * b * h * d * pairs


def _kernel_label(mangled: str) -> str:
    """``wgmma<bf16,64>``-style label of a mangled kernel name: ``wgmma`` and
    ``simt`` for the flash kernels, ``ring_wgmma`` and ``ring_simt`` for the
    ring block kernels (their source file's name is in every mangled name
    of that file, so the kernel's own name is matched with its template
    arguments' ``I``)."""
    import re

    if "ring_block_wgmmaI" in mangled:
        kind = "ring_wgmma"
    elif "ring_block_simtI" in mangled:
        kind = "ring_simt"
    else:
        kind = "wgmma" if "flash_fwd_wgmma" in mangled else "simt"
    dtype = ("bf16" if "__nv_bfloat16" in mangled else "f16" if "6__half" in mangled
             else "f32")
    dim = re.search(r"Li(\d+)E", mangled)
    return f"{kind}<{dtype},{dim.group(1) if dim else '?'}>"


def _ptxas_table(report: str) -> dict:
    """{label: {"registers", "spill_stores", "spill_loads"}} from ``-Xptxas -v``."""
    import re

    table, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = _kernel_label(m.group(1))
            table[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            table[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            table[name]["registers"] = int(m.group(1))
    return table


def _hgmma_counts(so_path: str, nvcc: str) -> dict:
    """{label: number of HGMMA instructions} from ``cuobjdump -sass``."""
    out = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", so_path],
        capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = _kernel_label(line.split("Function :", 1)[1].strip())
            counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    return counts


def phase_build() -> dict:
    from tpusnap_torch import _native
    from tpusnap_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        native = pool.submit(_native.available)
        kernels = pool.submit(fa.build_library)
        ptxas = _ptxas_table(kernels.result())
        if not native.result():
            raise RuntimeError("native helper failed to build (g++)")
    seconds = time.perf_counter() - t0
    if _native.checksum_algorithm() != "crc32c":
        raise RuntimeError("native build missing: checksums would not be crc32c")
    hgmma = _hgmma_counts(fa._SO, fa._nvcc())
    for label in ("wgmma<bf16,64>", "ring_wgmma<bf16,64>", "ring_wgmma<bf16,128>",
                  "ring_wgmma<f16,64>", "ring_wgmma<f16,128>"):
        row = ptxas.get(label)
        if not row or row.get("spill_stores", 1) or row.get("spill_loads", 1):
            raise AssertionError(f"the kernel {label} spills or is missing: {row}")
    wgmma = {k: n for k, n in hgmma.items() if k.split("<")[0].endswith("wgmma")}
    if not wgmma or not all(wgmma.values()):
        raise AssertionError(f"a tensor-core kernel has no HGMMA instruction: {hgmma}")
    for label, row in ptxas.items():
        row["hgmma"] = hgmma.get(label)
    return {"phase": "build", "seconds": seconds, "kernels": ptxas}


def _qkv_views(shape, dtype, gen, misalign: bool = False):
    """q, k, v as the model hands them over: head-split views of one
    fused qkv projection (v is not contiguous). ``misalign`` starts them
    one element past a 16-byte boundary, a layout TMA cannot describe."""
    import torch

    b, s, h, d = shape
    n = b * s * 3 * h * d
    flat = torch.randn((n + 1,), generator=gen, device="cuda").to(dtype)
    qkv = (flat[1:] if misalign else flat[:n]).view(b, s, 3 * h * d)
    return tuple(t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))


def _launch_on(route, fn):
    """Run ``fn`` (one flash launch) and check that it took ``route``."""
    from tpusnap_torch.ops import flash_attention as fa

    before = dict(fa.route_launches)
    out = fn()
    moved = {r: fa.route_launches[r] - before[r] for r in before}
    if moved != {r: int(r == route) for r in before}:
        raise AssertionError(f"expected one launch on the {route} route, got {moved}")
    return out


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from tpusnap_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
        rounding_bound,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # bf16/f16 (wgmma route): the kernel rounds P to the input type before
    # P V, as FlashAttention does, so each element must satisfy
    # |out - ref| <= u (P |V|) + 2 ulps |ref| + 1e-5 (``rounding_bound``:
    # u = 2**-8 and 2 ulps = 2**-6 for bf16, 2**-11 and 2**-9 for f16; the
    # 1e-5 covers the f32 summation order). f32 (simt route): only the
    # order differs; atol 2e-5 is the repo's f32 tolerance for this kernel.
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [
        # shape, dtype, causal, misaligned base (-> simt), route
        (SLICE_SHAPE, bf16, True, False, "wgmma"),
        ((2, 1000, 4, 64), bf16, False, False, "wgmma"),
        ((1, 200, 4, 40), bf16, True, False, "wgmma"),
        ((2, 130, 2, 128), f16, True, False, "wgmma"),
        ((1, 333, 2, 256), f16, False, False, "wgmma"),
        ((2, 1, 2, 8), bf16, True, False, "wgmma"),
        ((1, 200, 4, 64), bf16, True, True, "simt"),
        ((1, 200, 4, 64), f32, True, False, "simt"),
        ((1, 200, 4, 64), f32, False, False, "simt"),
        ((2, 16, 2, 8), f32, True, False, "simt"),
        ((2, 16, 2, 8), f32, False, False, "simt"),
    ]
    checks = []
    with torch.no_grad():
        for shape, dtype, causal, misalign, route in cases:
            q, k, v = _qkv_views(shape, dtype, gen, misalign)
            out = _launch_on(route, lambda: flash_attention(q, k, v, causal=causal))
            ref = flash_attention_reference(q, k, v, causal).float()
            diff = (out.float() - ref).abs()
            if dtype == f32:
                allowed, rule = torch.full_like(diff, 2e-5), "atol 2e-5"
            else:
                allowed, rule = rounding_bound(q, k, v, causal), "u*(P|V|) + 2ulp*|ref| + 1e-5"
            torch.cuda.synchronize()
            err = diff.max().item()
            worst = (diff / allowed).max().item()  # <= 1 passes
            if not worst <= 1.0:
                raise AssertionError(
                    f"flash kernel ({route}) disagrees with its plain version at "
                    f"{shape} {dtype} causal={causal}: max |err| {err}, {worst}x "
                    f"the allowed {rule}"
                )
            checks.append(
                {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                 "causal": causal, "route": route, "max_abs_err": err,
                 "bound": rule, "worst_err_over_bound": worst}
            )
        q, k, v = _qkv_views(SLICE_SHAPE, bf16, gen)
        first = flash_attention(q, k, v, causal=True)
        second = flash_attention(q, k, v, causal=True)
        if not torch.equal(first, second):
            raise AssertionError("two launches on the same inputs differ")
        reps = 30
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True), reps)
        plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, True), 20)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), reps
        )
        qm, km, vm = _qkv_views(SLICE_SHAPE, bf16, gen, misalign=True)
        _launch_on("simt", lambda: flash_attention(qm, km, vm, causal=True))
        simt_ms = time_ms(lambda: flash_attention(qm, km, vm, causal=True), reps)
    bound_ms, bound_by = attention_bound(SLICE_SHAPE, "bfloat16", True)
    flops = attention_flops(SLICE_SHAPE, True)
    ring_row, ring_checks, ring_identities = _ring_block_kernel_checks(gen)
    return {
        "phase": "kernels",
        "checks": checks,
        "ring_checks": ring_checks,
        "ring_identities": ring_identities,
        "ring_block_attend": ring_row,
        "ring_of_one_forward": _ring_of_one_forward(gen),
        "ring_backward_block": _ring_backward_block(gen),
        "bitwise_repeat": True,
        "flash_attention_fwd": {
            "shape": list(SLICE_SHAPE), "dtype": "bfloat16", "causal": True,
            "route": "wgmma", "ms": ms, "tflops": flops / ms / 1e9,
            "bound_share": bound_ms / ms, "simt_ms": simt_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "torch.nn.functional.scaled_dot_product_attention",
            "library_tflops": flops / library_ms / 1e9,
            "bound_ms": bound_ms, "bound_by": bound_by, "timed_launches": reps,
            "max_abs_err": checks[0]["max_abs_err"],
        },
    }


def ring_block_bound(shape, dtype: str, pairs: int, mode: str = "middle"):
    """(least ms, "bytes" or "operations") for one ring block step at
    ``shape`` in carry ``mode``: the larger of the bytes (q, k, v read
    once; the f32 carry o, m and l read once where the mode reads it and
    written once where it writes it; the output in q's type written once
    in the last modes) over HBM and the operations of the ``pairs``
    (query, key) pairs the mask keeps (QK^T and PV, 2 per multiply-add)
    over the peak rate of the inputs' type."""
    b, s, h, d = shape
    itemsize = {"bfloat16": 2, "float16": 2, "float32": 4}[dtype]
    carry = b * s * h * d * 4 + 2 * b * h * s * 4
    passes = int(mode in ("middle", "last")) + int(mode in ("first", "middle"))
    nbytes = 3 * b * s * h * d * itemsize + passes * carry
    if mode in ("last", "first+last"):
        nbytes += b * s * h * d * itemsize
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 4 * b * h * d * pairs / PEAK_FLOPS[dtype]
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _ring_carry(shape, gen):
    """A non-trivial incoming carry for a ring block step: m around the
    scores, l > 0, o random, and every 7th row (from row 1) one that has
    seen nothing yet (m = -1e30, l = 0, o = 0)."""
    import torch

    b, s, h, d = shape
    m = torch.randn((b, h, s), generator=gen, device="cuda")
    l = torch.rand((b, h, s), generator=gen, device="cuda") * 2 + 0.5
    o = torch.randn((b, s, h, d), generator=gen, device="cuda")
    m[:, :, 1::7], l[:, :, 1::7], o[:, 1::7] = -1e30, 0.0, 0.0
    return m, l, o


def _ring_call(ra, q, k, v, carry, out, q_off, k_off, scale, causal, mode):
    """A call of ``attend_block`` in ``mode`` writing into the buffers
    given: the carry (updated in place by middle, written by first, read
    by last) and ``out`` (the last modes)."""
    if mode == "first+last":
        return lambda: ra.attend_block(q, k, v, None, None, None, q_off, k_off, scale, causal,
                                       mode=mode, out=out)
    last = out if mode == "last" else None
    return lambda: ra.attend_block(q, k, v, *carry, q_off, k_off, scale, causal, mode=mode,
                                   out=last)


def _ring_plain(ra, q, k, v, carry, q_off, k_off, scale, causal, mode):
    """The plain version of ``mode``: ``block_attend`` from ``carry`` (from
    ``_init_carry`` in the first modes), then ``_finish`` in the last
    modes; the new carry, or the output alone."""
    start = ra._init_carry(q) if mode in ("first", "first+last") else carry
    new = ra.block_attend(q, k, v, *start, q_off, k_off, scale, causal)
    return (ra._finish(new[1], new[2], q.dtype),) if mode in ("last", "first+last") else new


def _ring_bounds(ra, q, k, v, carry, q_off, k_off, scale, causal, mode):
    """The per-element bounds a mode's results are held to against
    ``_ring_plain``: ``rounding_bound`` on the new carry, ``finish_bound``
    on an output."""
    start = ra._init_carry(q) if mode in ("first", "first+last") else carry
    args = (q, k, v, *start, q_off, k_off, scale, causal)
    return (ra.finish_bound(*args),) if mode in ("last", "first+last") else ra.rounding_bound(*args)


def _ring_block_kernel_checks(gen):
    """The ring block kernel against its plain version on the card, in
    each carry mode: the flagship's ring block (bf16, q, k, v head-split
    views of a fused qkv like the model's) as a diagonal, a past and a
    future block with a non-trivial incoming carry (rows that have seen
    nothing among them), the ring of one's single block (8, 1024, 8, 64)
    from the empty carry, f16/bf16 ragged blocks at offsets that cut tiles
    and f32 (simt). Per element the new carry within
    ``ring_attention.rounding_bound`` (u (P |V|) for P's rounding to the
    input type before P V, plus 1e-5 relative f32 slack and 1e-6), and a
    last mode's output within ``finish_bound`` (those bounds through o / l,
    plus one ulp of the output type). A middle step over a future block is
    skipped, no launch, the carry left bit for bit; the other modes launch
    on it. A last step leaves the carry as it was. Then the two identities
    the modes must keep on every case: first equals middle from
    ``_init_carry`` and last equals middle followed by ``_finish``, bit
    for bit. Then every mode's past and diagonal block timed warm and
    with the L2 flushed (CUDA-graph replays), its plain version's time,
    SDPA's for first+last on the diagonal (the same function), and the
    bounds."""
    import importlib

    import torch
    import torch.nn.functional as F

    ra = importlib.import_module("tpusnap_torch.ops.ring_attention")
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    b, s, h, d = RING_BLOCK_SHAPE
    cases = [
        # shape, dtype, q_offset, k_offset, causal, qkv views, route
        (RING_BLOCK_SHAPE, bf16, s, s, True, True, "wgmma"),
        (RING_BLOCK_SHAPE, bf16, s, 0, True, True, "wgmma"),
        (RING_BLOCK_SHAPE, bf16, 0, s, True, True, "wgmma"),  # future
        (SLICE_SHAPE, bf16, 0, 0, True, True, "wgmma"),
        ((2, 200, 3, 128), f16, 100, 164, True, False, "wgmma"),
        ((2, 200, 3, 40), bf16, 237, 200, True, False, "wgmma"),
        ((2, 300, 3, 64), bf16, 0, 0, False, False, "wgmma"),
        ((2, 130, 2, 40), bf16, 0, 0, False, False, "wgmma"),  # staged carry, rows past s
        ((1, 130, 2, 64), f32, 130, 130, True, False, "simt"),
        ((1, 130, 2, 32), f32, 50, 90, True, False, "simt"),
    ]
    checks, identities = [], []
    with torch.no_grad():
        for shape, dtype, q_off, k_off, causal, views, route in cases:
            if views:
                q, k, v = _qkv_views(shape, dtype, gen)
            else:
                q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                           for _ in range(3))
            if shape == SLICE_SHAPE:  # the ring of one starts from the empty carry
                carry = ra._init_carry(q)
            else:
                carry = _ring_carry(shape, gen)
            scale = shape[-1] ** -0.5
            future = causal and k_off >= q_off + shape[1]
            got = {}
            for mode in ra.MODES:
                bufs = [t.clone() for t in carry]
                out = torch.empty(q.shape, dtype=dtype, device="cuda")
                routes0, modes0, skips0 = dict(ra.route_launches), dict(ra.mode_launches), ra.skips
                _ring_call(ra, q, k, v, bufs, out, q_off, k_off, scale, causal, mode)()
                torch.cuda.synchronize()
                moved = {r: ra.route_launches[r] - routes0[r] for r in routes0}
                if mode == "middle" and future:
                    if ra.skips != skips0 + 1 or any(moved.values()):
                        raise AssertionError(f"a future middle block launched: {moved}")
                    if not all(torch.equal(a, c) for a, c in zip(bufs, carry)):
                        raise AssertionError("a future middle block changed the carry")
                elif (moved != {r: int(r == route) for r in moved}
                      or ra.mode_launches[mode] != modes0[mode] + 1):
                    raise AssertionError(f"ring block {mode}: expected one {route} launch, "
                                         f"got {moved}")
                if mode == "last" and not all(torch.equal(a, c) for a, c in zip(bufs, carry)):
                    raise AssertionError("a last step wrote the carry")
                results = (out,) if mode in ("last", "first+last") else tuple(bufs)
                got[mode] = results
                want = _ring_plain(ra, q, k, v, carry, q_off, k_off, scale, causal, mode)
                bounds = _ring_bounds(ra, q, k, v, carry, q_off, k_off, scale, causal, mode)
                worst, errs = 0.0, {}
                names = ("out",) if len(results) == 1 else ("m", "l", "o")
                for name, g, ref, bound in zip(names, results, want, bounds):
                    diff = (g.float() - ref.float()).abs()
                    errs[name] = diff.max().item()
                    worst = max(worst, (diff / bound).max().item())
                if not worst <= 1.0:
                    raise AssertionError(
                        f"ring block kernel ({route}, {mode}) disagrees with its plain version "
                        f"at {shape} {dtype} offsets ({q_off}, {k_off}) causal={causal}: max "
                        f"|err| {errs}, {worst}x the allowed bound"
                    )
                checks.append({
                    "shape": list(shape), "dtype": str(dtype).split(".")[-1],
                    "q_offset": q_off, "k_offset": k_off, "causal": causal, "mode": mode,
                    "route": "skipped" if mode == "middle" and future else route,
                    "max_abs_err": errs, "worst_err_over_bound": worst,
                })
            # The identities, on the kernel's own results: first against
            # middle from the empty carry, last (and first+last) against
            # middle (from the empty carry) followed by _finish.
            from_empty = [t.clone() for t in ra._init_carry(q)]
            ra.attend_block(q, k, v, *from_empty, q_off, k_off, scale, causal)
            finished = ra._finish(got["middle"][1], got["middle"][2], dtype)
            finished_empty = ra._finish(from_empty[1], from_empty[2], dtype)
            same = {
                "first": all(torch.equal(a, c) for a, c in zip(got["first"], from_empty)),
                "last": torch.equal(got["last"][0], finished),
                "first+last": torch.equal(got["first+last"][0], finished_empty),
            }
            if not all(same.values()):
                raise AssertionError(
                    f"ring block modes differ bitwise from middle (+ _finish) at {shape} "
                    f"{dtype} offsets ({q_off}, {k_off}): {same}"
                )
            identities.append({"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                               "q_offset": q_off, "k_offset": k_off, "bitwise": same})
        q, k, v = _qkv_views(RING_BLOCK_SHAPE, bf16, gen)
        carry = _ring_carry(RING_BLOCK_SHAPE, gen)
        first = [t.clone() for t in carry]
        ra.attend_block(q, k, v, *first, s, 0, d**-0.5, True)
        second = [t.clone() for t in carry]
        ra.attend_block(q, k, v, *second, s, 0, d**-0.5, True)
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError("two ring block launches on the same inputs differ")
        reps = 30
        out = torch.empty(q.shape, dtype=bf16, device="cuda")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [b, h, s, d] views
        blocks = {"past": (s, 0, s * s), "diagonal": (s, s, s * (s + 1) // 2)}
        modes = {}
        for mode in ra.MODES:
            row = {}
            for block, (q_off, k_off, pairs) in blocks.items():
                fn = _ring_call(ra, q, k, v, carry, out, q_off, k_off, d**-0.5, True, mode)
                bound_ms, bound_by = ring_block_bound(RING_BLOCK_SHAPE, "bfloat16", pairs, mode)
                cold = time_ms_cold(fn, reps)
                row[block] = {"ms": time_ms(fn, reps), "cold_ms": cold, "bound_ms": bound_ms,
                              "bound_by": bound_by, "bound_share": bound_ms / cold}
            row["plain_ms"] = time_ms(
                lambda: _ring_plain(ra, q, k, v, carry, s, 0, d**-0.5, True, mode), 10
            )
            modes[mode] = row
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
        modes["first+last"]["library_ms"] = time_ms(sdpa, reps)
        modes["first+last"]["library_cold_ms"] = time_ms_cold(sdpa, reps)
    row = {
        "shape": list(RING_BLOCK_SHAPE), "dtype": "bfloat16", "route": "wgmma",
        "modes": modes, "timed_launches": reps,
        "bound_share_from": "cold_ms (the L2 flushed before each launch)",
        "library": "torch.nn.functional.scaled_dot_product_attention, is_causal=True, for "
                   "first+last on the diagonal (the same function); none returns the carry",
        "max_abs_err": max(max(c["max_abs_err"].values()) for c in checks
                           if c["shape"] == list(RING_BLOCK_SHAPE)),
        "ring_of_one_max_abs_err": [c["max_abs_err"] for c in checks
                                    if c["shape"] == list(SLICE_SHAPE)],
        "bitwise_repeat": True,
    }
    return row, checks, identities


def ring_backward_bound(shape, dtype: str, pairs: int):
    """(least ms, "bytes" or "operations") for one K/V block's share of
    attention's gradients (``block_grads``) at ``shape``: the larger of the
    bytes (q, k, v and dO read once in the inputs' type, lse and delta read
    once in f32, dq, dk and dv written once in f32) over HBM and the
    operations of the ``pairs`` (query, key) pairs the mask keeps (S = Q K^T,
    dV = P^T dO, dO V^T, dQ = dS K and dK = dS^T Q: 2 per multiply-add)
    over the peak rate of the inputs' type."""
    b, s, h, d = shape
    itemsize = {"bfloat16": 2, "float16": 2, "float32": 4}[dtype]
    nbytes = 4 * b * s * h * d * itemsize + 2 * b * h * s * 4 + 3 * b * s * h * d * 4
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 10 * b * h * d * pairs / PEAK_FLOPS[dtype]
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _ring_backward_block(gen) -> dict:
    """The ring's backward across ranks for one block: ``block_grads``
    (plain PyTorch, f32; no kernel of its own, as tpusnap's is XLA
    autodiff) at the flagship's ring block (8, 512, 8, 64) bf16, the
    diagonal block (offsets 512, 512) causal, with lse and delta from that
    block alone, so its gradients are attention's on the block. Held per
    element against autograd of f32 attention on the same inputs, and
    against ``F.scaled_dot_product_attention``'s backward; timed warm and
    with the L2 flushed (CUDA-graph replays), beside SDPA's backward
    (``torch.autograd.grad`` of ``is_causal=True`` on the block) and the
    bound."""
    import importlib

    import torch
    import torch.nn.functional as F

    ra = importlib.import_module("tpusnap_torch.ops.ring_attention")
    b, s, h, d = RING_BLOCK_SHAPE
    scale = d**-0.5
    q, k, v = _qkv_views(RING_BLOCK_SHAPE, torch.bfloat16, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        m, l, o = ra.block_attend(q, k, v, *ra._init_carry(q), s, s, scale, True)
        # delta from the f32 output (the ring saves it in q's type; in f32
        # the gradients are exactly attention's, which the checks compare).
        out = ra._finish(l, o, torch.float32)
        lse = m + torch.log(l)
        delta = (do.float() * out).sum(-1).transpose(1, 2)  # [b, h, sq]
        got = ra.block_grads(q, k, v, do, lse, delta, s, s, scale, True)
    qf, kf, vf = (t.detach().float().transpose(1, 2).requires_grad_() for t in (q, k, v))
    ref_out = F.scaled_dot_product_attention(qf, kf, vf, is_causal=True, scale=scale)
    want = torch.autograd.grad(ref_out, (qf, kf, vf), do.float().transpose(1, 2))
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2)
    lib_fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,  # noqa: E731
                                                     scale=scale)
    # Forward and backward in one callable: captured whole in a CUDA graph,
    # as PyTorch's whole-network capture does; the forward's own time is
    # taken off.
    lib_both = lambda: torch.autograd.grad(lib_fwd(), (qt, kt, vt), dot)  # noqa: E731
    lib = lib_both()
    errs, lib_errs = {}, {}
    for name, g, w, li in zip(("dq", "dk", "dv"), got, want, lib):
        w = w.transpose(1, 2)
        errs[name] = (g - w).abs().max().item()
        lib_errs[name] = (li.float().transpose(1, 2) - w).abs().max().item()
        # Both sides are f32 over the same bf16 inputs: only the order of
        # the sums differs.
        allowed = 1e-4 * w.abs().max().item() + 1e-6
        if not errs[name] <= allowed:
            raise AssertionError(f"block_grads {name}: max |err| {errs[name]} against f32 "
                                 f"autograd, allowed {allowed}")
    reps = 20
    plain = lambda: ra.block_grads(q, k, v, do, lse, delta, s, s, scale, True)  # noqa: E731
    with torch.no_grad():
        ms, cold_ms = time_ms(plain, reps), time_ms_cold(plain, reps)
    lib_both_ms, lib_fwd_ms = time_ms(lib_both, reps), time_ms(lib_fwd, reps)
    lib_both_cold, lib_fwd_cold = time_ms_cold(lib_both, reps), time_ms_cold(lib_fwd, reps)
    bound_ms, bound_by = ring_backward_bound(RING_BLOCK_SHAPE, "bfloat16", s * (s + 1) // 2)
    return {
        "shape": list(RING_BLOCK_SHAPE), "dtype": "bfloat16", "block": "diagonal",
        "causal": True, "function": "ring_attention.block_grads (plain PyTorch, f32)",
        "max_abs_err": errs, "library_max_abs_err": lib_errs,
        "err_against": "torch.autograd.grad of f32 scaled_dot_product_attention",
        "ms": ms, "cold_ms": cold_ms, "library_ms": lib_both_ms - lib_fwd_ms,
        "library_cold_ms": lib_both_cold - lib_fwd_cold,
        "library_fwd_bwd_ms": lib_both_ms, "library_fwd_ms": lib_fwd_ms,
        "library": "torch.autograd.grad of scaled_dot_product_attention(is_causal=True) "
                   "on the block, bf16: forward and backward less the forward",
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / cold_ms,
        "timed_launches": reps,
    }


def _ring_of_one_forward(gen) -> dict:
    """The ring of one's whole forward at the flagship's shape: what the
    ring-of-one replica runs per layer, ``ring_attention(q, k, v,
    group=None)`` on head-split views of a fused qkv under ``no_grad``,
    everything it launches included (one first+last launch). Held per
    element against its plain version (``ring_attention_reference``)
    within ``finish_bound`` and against plain attention within the flash
    kernel's rounding bound (the same function), then timed warm and with
    the L2 flushed, beside the flash kernel and
    ``F.scaled_dot_product_attention(is_causal=True)`` on the same
    tensors, the plain version and the attention bound."""
    import importlib

    import torch
    import torch.nn.functional as F

    from tpusnap_torch.ops import flash_attention as fa

    ra = importlib.import_module("tpusnap_torch.ops.ring_attention")
    q, k, v = _qkv_views(SLICE_SHAPE, torch.bfloat16, gen)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [b, h, s, d] views
    reps = 30
    calls = {
        "ring_of_one": lambda: ra.ring_attention(q, k, v, group=None),
        "flash": lambda: fa.flash_attention(q, k, v, causal=True),
        "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
    }
    with torch.no_grad():
        out = calls["ring_of_one"]()
        diff = (out.float() - ra.ring_attention_reference(q, k, v).float()).abs()
        bound = ra.finish_bound(q, k, v, *ra._init_carry(q), 0, 0, q.shape[-1] ** -0.5, True)
        ratio = (diff / bound).max().item()
        flash_ratio = ((out.float() - fa.flash_attention_reference(q, k, v, True).float()).abs()
                       / fa.rounding_bound(q, k, v, True)).max().item()
        if not (ratio <= 1.0 and flash_ratio <= 1.0):
            raise AssertionError(f"ring of one vs its plain version: {ratio}x its bound; vs "
                                 f"plain attention: {flash_ratio}x the flash bound")
        warm = {name: time_ms(fn, reps) for name, fn in calls.items()}
        cold = {name: time_ms_cold(fn, reps) for name, fn in calls.items()}
        plain_ms = time_ms(lambda: ra.ring_attention_reference(q, k, v), 10)
    bound_ms, bound_by = attention_bound(SLICE_SHAPE, "bfloat16", True)
    return {
        "shape": list(SLICE_SHAPE), "dtype": "bfloat16", "causal": True,
        "max_abs_err": diff.max().item(), "worst_err_over_bound": ratio,
        "worst_err_over_flash_bound": flash_ratio, "plain_ms": plain_ms,
        "ms": warm["ring_of_one"], "flash_ms": warm["flash"], "library_ms": warm["library"],
        "cold_ms": cold["ring_of_one"], "flash_cold_ms": cold["flash"],
        "library_cold_ms": cold["library"],
        "library": "torch.nn.functional.scaled_dot_product_attention, is_causal=True",
        "bound_ms": bound_ms, "bound_by": bound_by, "timed_launches": reps,
    }


def _tokens(cfg, batch: int, seed: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, cfg.max_seq_len))
    return torch.from_numpy(toks).to(torch.int64).to("cuda")


def phase_train(ctx: dict) -> dict:
    import torch

    from tpusnap_torch.models import Transformer, TransformerConfig
    from tpusnap_torch.ops import flash_attention as fa

    cfg = TransformerConfig()  # full default width: 32768 x 512, 8 heads, 4 layers
    model = Transformer(cfg, device="cuda", seed=SEED)
    tokens = _tokens(cfg, 8, SEED)
    before = fa.launches
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(model.train_step(tokens, learning_rate=1e-3).item())
        step_s.append(time.perf_counter() - t0)
    launched = fa.launches - before
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    if launched != cfg.n_layers * TRAIN_STEPS:
        raise AssertionError(
            f"flash kernel launched {launched} times, expected "
            f"{cfg.n_layers * TRAIN_STEPS}"
        )
    ctx.update(cfg=cfg, model=model, tokens=tokens)
    n_params = sum(p.numel() for p in model.parameters())
    return {
        "phase": "train", "config": {
            "vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_layers": cfg.n_layers, "d_ff": cfg.d_ff,
            "seq": cfg.max_seq_len, "batch": 8, "dtype": "bfloat16",
        },
        "params": n_params, "losses": losses, "step_s": step_s,
        "flash_launches": launched,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def phase_snapshot(ctx: dict, workdir: str) -> dict:
    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.models import Transformer
    from tpusnap_torch.ops import flash_attention as fa

    cfg, model = ctx["cfg"], ctx["model"]
    state = StateDict(**model.train_state())
    nbytes = sum(t.numel() * t.element_size() for _, t in _leaves(state))
    path = os.path.join(workdir, "train_state")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = Snapshot.take(path, {"train": state, "progress": StateDict(step=TRAIN_STEPS)})
    take_s = time.perf_counter() - t0

    fresh = Transformer(cfg, device="cuda", seed=SEED + 1)
    target = StateDict(**fresh.train_state())
    progress = StateDict(step=0)
    before_ids = {p: id(t) for p, t in _leaves(target)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot(path).restore({"train": target, "progress": progress})
    restore_s = time.perf_counter() - t0

    for (p, want), (_, got) in zip(_leaves(state), _leaves(fresh.train_state())):
        if not torch.equal(want, got):
            raise AssertionError(f"restored {p} differs from the saved tensor")
    for p, got in _leaves(target):
        if id(got) != before_ids[p]:
            raise AssertionError(f"restore replaced the tensor object at {p}")
    if {id(p) for p in fresh.parameters()} != {
        before_ids[f"params/{p}"] for p, _ in _leaves(fresh.params())
    }:
        raise AssertionError("the module's parameters are not the restored objects")
    if progress["step"] != TRAIN_STEPS:
        raise AssertionError(f"progress restored as {progress}")
    ln_f = snap.read_object("0/train/params/ln_f")
    if not torch.equal(ln_f, model.ln_f.detach().cpu()):
        raise AssertionError("read_object('0/train/params/ln_f') differs")

    # The device slab pack must give tpusnap's host layout byte for byte:
    # a take of the same state from CPU tensors records the same checksums.
    cpu_path = os.path.join(workdir, "train_state_cpu")
    cpu_state = StateDict(**_nest_cpu(model.train_state()))
    cpu_snap = Snapshot.take(cpu_path, {"train": cpu_state, "progress": StateDict(step=TRAIN_STEPS)})
    sums = lambda s: {p: getattr(e, "checksum", None) for p, e in s.metadata.manifest.items()}  # noqa: E731
    if sums(snap) != sums(cpu_snap):
        raise AssertionError("CUDA take and CPU take record different checksums")
    shutil.rmtree(cpu_path)

    tokens = _tokens(cfg, 8, SEED + 1)
    launches_before = fa.launches
    loss_a = model.train_step(tokens)
    loss_b = fresh.train_step(tokens)
    if not torch.equal(loss_a, loss_b):
        raise AssertionError(
            f"post-restore step differs: {loss_a.item()!r} vs {loss_b.item()!r}"
        )
    if fa.launches - launches_before != 2 * cfg.n_layers:
        raise AssertionError("post-restore steps did not run the flash kernel")
    shutil.rmtree(path)
    ctx["take_s"] = take_s
    return {
        "phase": "snapshot", "bytes": nbytes, "tensors": len(list(_leaves(state))),
        "take_s": take_s, "restore_s": restore_s,
        "take_gb_s": nbytes / take_s / 1e9, "restore_gb_s": nbytes / restore_s / 1e9,
        "post_restore_loss": loss_a.item(), "bit_exact": True,
        "parameter_identity": True, "card": ctx["card"],
    }


def _nest_cpu(tree):
    if isinstance(tree, dict):
        return {k: _nest_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _bulk_tensors(n_tensors: int = 32, tensor_bytes: int = 128 << 20) -> dict:
    """32 CUDA tensors of 128 MiB, f32 and bf16 alternating (4 GiB)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tensors = {}
    for i in range(n_tensors):
        dtype = torch.float32 if i % 2 == 0 else torch.bfloat16
        n = tensor_bytes // (4 if dtype == torch.float32 else 2)
        tensors[f"t{i:02d}"] = torch.randn(n, generator=gen, device="cuda").to(dtype)
    return tensors


def phase_bulk(ctx: dict, workdir: str) -> dict:
    import torch

    from tpusnap_torch import Snapshot, StateDict

    tensors = _bulk_tensors()
    n_tensors = len(tensors)
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    path = os.path.join(workdir, "bulk")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot.take(path, {"bulk": StateDict(tensors)})
    take_s = time.perf_counter() - t0
    ctx["bulk_compress_decision"] = _decision()
    targets = StateDict({k: torch.zeros_like(v) for k, v in tensors.items()})
    t0 = time.perf_counter()
    Snapshot(path).restore({"bulk": targets})
    restore_s = time.perf_counter() - t0
    for k, v in tensors.items():
        if not torch.equal(v, targets[k]):
            raise AssertionError(f"bulk tensor {k} differs after restore")
    shutil.rmtree(path)
    return {
        "phase": "bulk", "bytes": nbytes, "tensors": n_tensors,
        "take_s": take_s, "restore_s": restore_s,
        "take_gb_s": nbytes / take_s / 1e9, "restore_gb_s": nbytes / restore_s / 1e9,
        "note": "the reference's single-accelerator take to local FS (20 GB) "
        "cut to 4 GiB for the smoke's time; no claim is made from it",
        "compress_decision": ctx["bulk_compress_decision"], "card": ctx["card"],
    }


def phase_async_train(ctx: dict, workdir: str) -> dict:
    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.models import Transformer
    from tpusnap_torch.ops import flash_attention as fa

    cfg, model, tokens = ctx["cfg"], ctx["model"], ctx["tokens"]
    # The witness: a device clone of the state as of the call, for the
    # checks only.
    witness = Transformer(cfg, device="cuda", seed=SEED + 2)
    with torch.no_grad():
        for (_, src), (_, dst) in zip(_leaves(model.train_state()), _leaves(witness.train_state())):
            dst.copy_(src)
    state = StateDict(**model.train_state())
    nbytes = sum(t.numel() * t.element_size() for _, t in _leaves(state))
    path = os.path.join(workdir, "async_train")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = Snapshot.async_take(path, {"train": state, "progress": StateDict(step=TRAIN_STEPS)})
    blocked_s = time.perf_counter() - t0
    staged_at_return = pending.staged()
    before = fa.launches
    losses = [model.train_step(tokens, learning_rate=1e-3) for _ in range(2)]
    launched = fa.launches - before
    snap = pending.wait()
    wait_s = time.perf_counter() - t0
    losses = [x.item() for x in losses]
    if launched != 2 * cfg.n_layers:
        raise AssertionError(f"the in-flight steps launched the flash kernel {launched} times")
    if torch.equal(model.ln_f, witness.ln_f):
        raise AssertionError("the in-flight steps did not update the model")

    fresh = Transformer(cfg, device="cuda", seed=SEED + 3)
    target = StateDict(**fresh.train_state())
    before_ids = {p: id(t) for p, t in _leaves(target)}
    snap.restore({"train": target, "progress": StateDict(step=0)})
    for (p, want), (_, got) in zip(_leaves(witness.train_state()), _leaves(fresh.train_state())):
        if not torch.equal(want, got):
            raise AssertionError(f"async snapshot of {p} differs from the state at the call")
    for p, got in _leaves(target):
        if id(got) != before_ids[p]:
            raise AssertionError(f"restore replaced the tensor object at {p}")
    if {id(p) for p in fresh.parameters()} != {
        before_ids[f"params/{p}"] for p, _ in _leaves(fresh.params())
    }:
        raise AssertionError("the module's parameters are not the restored objects")
    step_tokens = _tokens(cfg, 8, SEED + 4)
    loss_restored = fresh.train_step(step_tokens)
    loss_witness = witness.train_step(step_tokens)
    if not torch.equal(loss_restored, loss_witness):
        raise AssertionError(
            f"post-restore step differs: {loss_restored.item()!r} vs {loss_witness.item()!r}"
        )
    shutil.rmtree(path)
    return {
        "phase": "async_train", "bytes": nbytes, "async_blocked_s": blocked_s,
        "wait_s": wait_s, "sync_take_s": ctx["take_s"], "staged_at_return": staged_at_return,
        "in_flight_losses": losses, "in_flight_flash_launches": launched,
        "post_restore_loss": loss_restored.item(), "bit_exact": True,
        "parameter_identity": True, "card": ctx["card"],
    }


def phase_async_bulk(ctx: dict, workdir: str) -> dict:
    import torch

    from tpusnap_torch import Snapshot, StateDict

    tensors = _bulk_tensors()
    witness = {k: v.clone() for k, v in tensors.items()}
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    path = os.path.join(workdir, "async_bulk")
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    pending = Snapshot.async_take(path, {"bulk": StateDict(tensors)})
    blocked_s = time.perf_counter() - t0
    staged_at_return = pending.staged()
    device_copy_bytes = torch.cuda.memory_allocated() - allocated
    for v in tensors.values():
        v.add_(1)
    pending.wait()
    wait_s = time.perf_counter() - t0
    if not staged_at_return:
        raise AssertionError("async_take of CUDA state returned with staged() False")
    targets = StateDict({k: torch.zeros_like(v) for k, v in tensors.items()})
    Snapshot(path).restore({"bulk": targets})
    for k, v in witness.items():
        if not torch.equal(v, targets[k]):
            raise AssertionError(f"async bulk tensor {k} differs from its value at the call")
        if torch.equal(v, tensors[k]):
            raise AssertionError(f"the add_ on {k} did not land")
    shutil.rmtree(path)
    return {
        "phase": "async_bulk", "bytes": nbytes, "tensors": len(tensors),
        "async_blocked_s": blocked_s, "wait_s": wait_s, "staged_at_return": True,
        "device_copy_bytes_at_return": device_copy_bytes,
        "wait_gb_s": nbytes / wait_s / 1e9, "card": ctx["card"],
    }


def phase_chunked(ctx: dict, workdir: str) -> dict:
    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.io_preparers.chunked import chunk_row_ranges
    from tpusnap_torch.knobs import get_max_chunk_size_bytes
    from tpusnap_torch.manifest import ChunkedTensorEntry

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # 1.25 GiB each; 2.5 chunks of the default 512 MiB: the last is ragged.
    tensors = {
        "f32": torch.randn((81920, 4096), generator=gen, device="cuda"),
        "bf16": torch.randn((163840, 4096), generator=gen, device="cuda").to(torch.bfloat16),
    }
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    path = os.path.join(workdir, "chunked")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = Snapshot.take(path, {"c": StateDict(tensors)})
    take_s = time.perf_counter() - t0
    # The same take again, as a checkpoint loop repeats it: pinned blocks
    # of the chunk size are now in PyTorch's host cache.
    t0 = time.perf_counter()
    Snapshot.take(os.path.join(workdir, "chunked_again"), {"c": StateDict(tensors)})
    second_take_s = time.perf_counter() - t0
    shutil.rmtree(os.path.join(workdir, "chunked_again"))
    chunk_rows = {}
    for k, t in tensors.items():
        entry = snap.metadata.manifest[f"0/c/{k}"]
        want = [r1 - r0 for r0, r1 in chunk_row_ranges(
            list(t.shape), entry.dtype, get_max_chunk_size_bytes())]
        if not isinstance(entry, ChunkedTensorEntry) or [c.sizes[0] for c in entry.chunks] != want:
            raise AssertionError(f"{k}: expected chunks of {want} rows, got {entry}")
        chunk_rows[k] = want

    targets = {k: torch.zeros_like(v) for k, v in tensors.items()}
    ids = {k: id(v) for k, v in targets.items()}
    restored = StateDict(dict(targets))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot(path).restore({"c": restored})
    restore_s = time.perf_counter() - t0
    for k, v in tensors.items():
        if id(restored[k]) != ids[k] or not torch.equal(restored[k], v):
            raise AssertionError(f"chunked {k} not restored in place, bit-exact")

    out = torch.empty_like(tensors["f32"])
    t0 = time.perf_counter()
    got = Snapshot(path).read_object("0/c/f32", obj_out=out, memory_budget_bytes=64 << 20)
    read_s = time.perf_counter() - t0
    if got is not out or not torch.equal(out, tensors["f32"]):
        raise AssertionError("read_object of a chunked entry under 64 MiB differs")
    del out, got

    for t in targets.values():
        t.zero_()
    t0 = time.perf_counter()
    pending = Snapshot(path).async_restore({"c": StateDict(dict(targets))})
    pending.wait()
    async_restore_s = time.perf_counter() - t0
    for k, v in tensors.items():
        if not torch.equal(targets[k], v):
            raise AssertionError(f"async_restore of chunked {k} differs")
    shutil.rmtree(path)
    return {
        "phase": "chunked", "bytes": nbytes, "chunk_rows": chunk_rows,
        "take_s": take_s, "restore_s": restore_s, "take_gb_s": nbytes / take_s / 1e9,
        "second_take_gb_s": nbytes / second_take_s / 1e9,
        "restore_gb_s": nbytes / restore_s / 1e9,
        "read_object_64mib_gb_s": tensors["f32"].numel() * 4 / read_s / 1e9,
        "async_restore_s": async_restore_s, "bit_exact": True, "in_place": True,
        "card": ctx["card"],
    }


def _decision() -> dict:
    """The compress policy's decision for the last take."""
    from tpusnap_torch import compress

    d = compress.LAST_DECISION
    return {"reason": d.reason, "compress": d.compress, "codec_gbps": d.codec_gbps,
            "pipe_gbps": d.pipe_gbps, "eligible_bytes": d.eligible_bytes}


def _snapshot_bytes(path: str):
    """(bytes written into the snapshot's own blob files, bytes it
    references in base snapshots through ``../`` locations). The metadata
    and the ``.tpusnap/`` sidecars (trace, heartbeat, flight log) are not
    payload."""
    from tpusnap_torch import Snapshot
    from tpusnap_torch.inspect import iter_blobs

    written = sum(
        os.path.getsize(os.path.join(d, f))
        for d, _, files in os.walk(path) for f in files
        if f != ".snapshot_metadata" and ".tpusnap" not in os.path.relpath(d, path)
    )
    referenced = sum(
        b.byte_range[1] - b.byte_range[0]
        for b in iter_blobs(Snapshot(path).metadata.manifest)
        if b.location.startswith("../")
    )
    return written, referenced


def _tensor_locations(manifest: dict):
    """(logical path, location, byte length) of every tensor blob, chunks
    included."""
    from tpusnap_torch.manifest import ChunkedTensorEntry, TensorEntry
    from tpusnap_torch.serialization import tensor_nbytes

    for p, e in manifest.items():
        parts = [c.tensor for c in e.chunks] if isinstance(e, ChunkedTensorEntry) else [e]
        for t in parts:
            if isinstance(t, TensorEntry):
                yield p, t.location, tensor_nbytes(t.dtype, t.shape)


def _clone_state(model) -> dict:
    return {p: t.detach().clone() for p, t in _leaves(model.train_state())}


def _check_restore(path: str, want: dict, fresh, witness, tokens) -> float:
    """Restore ``path`` into ``fresh`` (in place, bit-exact against
    ``want``, Parameter identity kept), load ``want`` into ``witness``, and
    require one step of each to give bitwise-equal losses."""
    import torch

    from tpusnap_torch import Snapshot, StateDict

    target = StateDict(**fresh.train_state())
    before_ids = {p: id(t) for p, t in _leaves(target)}
    Snapshot(path).restore({"train": target})
    for p, got in _leaves(fresh.train_state()):
        if not got.is_cuda or not torch.equal(got, want[p]):
            raise AssertionError(f"{path}: restored {p} differs from the state it holds")
    for p, got in _leaves(target):
        if id(got) != before_ids[p]:
            raise AssertionError(f"{path}: restore replaced the tensor object at {p}")
    with torch.no_grad():
        for p, t in _leaves(witness.train_state()):
            t.copy_(want[p])
    loss_a, loss_b = fresh.train_step(tokens), witness.train_step(tokens)
    if not torch.equal(loss_a, loss_b):
        raise AssertionError(f"{path}: post-restore step {loss_a.item()!r} vs {loss_b.item()!r}")
    return loss_a.item()


def phase_incremental(ctx: dict, workdir: str) -> dict:
    import torch

    from tpusnap_torch import Snapshot, StateDict, apply_retention
    from tpusnap_torch.knobs import override_compress
    from tpusnap_torch.models import Transformer

    t_phase = time.perf_counter()
    cfg, model, tokens = ctx["cfg"], ctx["model"], ctx["tokens"]
    root = os.path.join(workdir, "incremental")
    paths = {n: os.path.join(root, n) for n in ("base", "inc1", "inc2", "async_inc", "inc3")}
    state_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(model.train_state()))
    takes, wants = {}, {}

    def take(name, **kw):
        wants[name] = _clone_state(model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Snapshot.take(paths[name], {"train": StateDict(**model.train_state())}, **kw)
        seconds = time.perf_counter() - t0
        written, referenced = _snapshot_bytes(paths[name])
        takes[name] = {"seconds": seconds, "bytes_written": written, "bytes_referenced": referenced}

    with override_compress(mode="off"):
        take("base", _record_dedup_hashes=True)
        take("inc1", incremental_from=paths["base"])
        manifest = Snapshot(paths["inc1"]).metadata.manifest
        if takes["inc1"]["bytes_written"] or not all(
            loc.startswith("../base/") for _, loc, _ in _tensor_locations(manifest)
        ):
            raise AssertionError(f"unchanged increment wrote data or kept a local blob: {takes['inc1']}")
        row = 12345
        with torch.no_grad():
            model.embed[row].add_(1.0)  # one row, in place, on the card
        take("inc2", incremental_from=paths["inc1"])
        tile = 16 << 20
        local = [(p, loc, n) for p, loc, n in _tensor_locations(Snapshot(paths["inc2"]).metadata.manifest)
                 if not loc.startswith("../base/")]
        if takes["inc2"]["bytes_written"] != tile or [(p, n) for p, _, n in local] != [
            ("0/train/params/embed", tile)
        ]:
            raise AssertionError(f"one changed row: expected one 16 MiB tile written, got "
                                 f"{takes['inc2']} and local blobs {local}")

        # The async increment: staged at its return, then a step at once.
        wants["async_inc"] = _clone_state(model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = Snapshot.async_take(
            paths["async_inc"], {"train": StateDict(**model.train_state())},
            incremental_from=paths["inc2"],
        )
        blocked_s = time.perf_counter() - t0
        staged_at_return = pending.staged()
        model.train_step(tokens, learning_rate=1e-3)
        pending.wait()
        wait_s = time.perf_counter() - t0
        if not staged_at_return:
            raise AssertionError("async incremental take returned with staged() False")
        written, referenced = _snapshot_bytes(paths["async_inc"])
        takes["async_inc"] = {"seconds": wait_s, "async_blocked_s": blocked_s,
                              "bytes_written": written, "bytes_referenced": referenced}
        if written:
            raise AssertionError(f"unchanged async increment wrote {written} bytes")

        model.train_step(tokens, learning_rate=1e-3)  # two Adam steps since inc2
        take("inc3", incremental_from=paths["async_inc"])
        local = {p for p, loc, _ in _tensor_locations(Snapshot(paths["inc3"]).metadata.manifest)
                 if not loc.startswith("../")}
        stale = [p for p, _ in _leaves(model.train_state())
                 if p.startswith(("params/", "opt/mu/", "opt/nu/")) and f"0/train/{p}" not in local]
        if stale:
            raise AssertionError(f"after two Adam steps inc3 did not rewrite {stale}")

        fresh = Transformer(cfg, device="cuda", seed=SEED + 5)
        witness = Transformer(cfg, device="cuda", seed=SEED + 6)
        step_tokens = _tokens(cfg, 8, SEED + 7)
        losses = {}
        for name, path in paths.items():
            losses[name] = _check_restore(path, wants[name], fresh, witness, step_tokens)
            report = Snapshot(path).verify()
            if not report.clean:
                raise AssertionError(f"verify({name}): {report.summary()}")
        plan = apply_retention(root, keep_last=2)
        kept = sorted(os.path.basename(p) for p in plan.keep)
        if kept != ["async_inc", "inc3"] or not plan.materialize or sorted(os.listdir(root)) != kept:
            raise AssertionError(f"retention: {plan.summary()}, left {os.listdir(root)}")
        for name in kept:
            if not Snapshot(paths[name]).verify().clean:
                raise AssertionError(f"{name} does not verify after retention")
            _check_restore(paths[name], wants[name], fresh, witness, step_tokens)
        retention = {"summary": plan.summary(), "bytes_copied": plan.bytes_copied,
                     "materialized": sorted(os.path.basename(p) for p in plan.materialize)}
        del fresh, witness, wants
        shutil.rmtree(root)

        # The 4 GiB bulk: one of 32 tensors changed.
        tensors = _bulk_tensors()
        bulk = {}
        for name, kw in (("base", {"_record_dedup_hashes": True}), ("inc", None)):
            if kw is None:
                tensors["t05"].add_(1)
                kw = {"incremental_from": os.path.join(workdir, "bulk_base")}
            path = os.path.join(workdir, f"bulk_{name}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Snapshot.take(path, {"bulk": StateDict(tensors)}, **kw)
            seconds = time.perf_counter() - t0
            written, referenced = _snapshot_bytes(path)
            bulk[name] = {"seconds": seconds, "bytes_written": written, "bytes_referenced": referenced}
        if bulk["inc"]["bytes_written"] != 128 << 20:
            raise AssertionError(f"bulk increment after one add_: {bulk['inc']}")
        targets = StateDict({k: torch.zeros_like(v) for k, v in tensors.items()})
        Snapshot(os.path.join(workdir, "bulk_inc")).restore({"bulk": targets})
        for k, v in tensors.items():
            if not torch.equal(targets[k], v):
                raise AssertionError(f"bulk increment restore of {k} differs")
        del tensors, targets
        shutil.rmtree(os.path.join(workdir, "bulk_base"))
        shutil.rmtree(os.path.join(workdir, "bulk_inc"))
    return {
        "phase": "incremental", "state_bytes": state_bytes, "takes": takes,
        "changed_row": row, "post_restore_losses": losses, "retention": retention,
        "bulk": bulk, "bit_exact": True, "parameter_identity": True, "verify_clean": True,
        "seconds": time.perf_counter() - t_phase, "card": ctx["card"],
    }


def phase_compress(ctx: dict, workdir: str) -> dict:
    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.knobs import override_compress
    from tpusnap_torch.models import Transformer

    t_phase = time.perf_counter()
    cfg, model = ctx["cfg"], ctx["model"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    chunked = {
        "f32": torch.randn((81920, 4096), generator=gen, device="cuda"),
        "bf16": torch.randn((163840, 4096), generator=gen, device="cuda").to(torch.bfloat16),
    }
    want = _clone_state(model)
    nbytes = sum(t.numel() * t.element_size() for t in want.values()) + sum(
        t.numel() * t.element_size() for t in chunked.values())
    path = os.path.join(workdir, "compress")
    with override_compress(mode="on"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = Snapshot.take(path, {"train": StateDict(**model.train_state()), "c": StateDict(chunked)})
        take_s = time.perf_counter() - t0
        decision = _decision()
    stored, _ = _snapshot_bytes(path)
    codecs = sorted({c.tensor.codec or "none" for k in ("0/c/f32", "0/c/bf16")
                     for c in snap.metadata.manifest[k].chunks})
    if not decision["compress"] or codecs != ["shuf2+lz4", "shuf4+lz4"]:
        raise AssertionError(f"TPUSNAP_COMPRESS=on did not compress the chunks: {decision}, {codecs}")
    fresh = Transformer(cfg, device="cuda", seed=SEED + 8)
    targets = {k: torch.zeros_like(v) for k, v in chunked.items()}
    ids = {k: id(v) for k, v in targets.items()}
    restored = StateDict(dict(targets))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot(path).restore({"train": StateDict(**fresh.train_state()), "c": restored})
    restore_s = time.perf_counter() - t0
    for p, got in _leaves(fresh.train_state()):
        if not torch.equal(got, want[p]):
            raise AssertionError(f"compressed restore of train/{p} differs")
    for k, v in chunked.items():
        if id(restored[k]) != ids[k] or not torch.equal(restored[k], v):
            raise AssertionError(f"compressed chunked {k} not restored in place, bit-exact")
    out = torch.empty_like(chunked["f32"])
    t0 = time.perf_counter()
    got = Snapshot(path).read_object("0/c/f32", obj_out=out, memory_budget_bytes=64 << 20)
    read_s = time.perf_counter() - t0
    if got is not out or not out.is_cuda or not torch.equal(out, chunked["f32"]):
        raise AssertionError("compressed read_object under 64 MiB did not land in place on the card")
    del fresh, targets, restored, out, got, chunked
    shutil.rmtree(path)
    return {
        "phase": "compress", "bytes": nbytes, "stored_bytes": stored, "ratio": stored / nbytes,
        "take_s": take_s, "take_gb_s": nbytes / take_s / 1e9, "restore_s": restore_s,
        "restore_gb_s": nbytes / restore_s / 1e9,
        "read_object_64mib_gb_s": 81920 * 4096 * 4 / read_s / 1e9,
        "decision_on": decision, "auto_decision_bulk": ctx["bulk_compress_decision"],
        "bit_exact": True, "in_place": True, "seconds": time.perf_counter() - t_phase,
        "card": ctx["card"],
    }


def phase_transforms(ctx: dict, workdir: str) -> dict:
    import fnmatch

    import torch

    from tpusnap_torch import Snapshot, StateDict, cast_on_save
    from tpusnap_torch.flatten import flatten
    from tpusnap_torch.knobs import override_compress
    from tpusnap_torch.models import Transformer

    t_phase = time.perf_counter()
    cfg, model = ctx["cfg"], ctx["model"]
    glob = "train/params/*"
    _, flat = flatten(model.train_state(), prefix="train")
    cast_paths = sorted(p for p in flat if fnmatch.fnmatch(p, glob))
    if cast_paths != sorted(f"train/params/{p}" for p, _ in _leaves(model.params())):
        raise AssertionError(f"{glob} does not select exactly the parameters: {cast_paths}")
    want = _clone_state(model)
    path = os.path.join(workdir, "cast")
    with override_compress(mode="off"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = Snapshot.take(path, {"train": StateDict(**model.train_state())},
                             _custom_array_prepare_func=cast_on_save({glob: torch.bfloat16}))
        take_s = time.perf_counter() - t0
    params_f32 = sum(t.numel() * 4 for _, t in _leaves(model.params()))
    stored_params = sum(n for p, _, n in _tensor_locations(snap.metadata.manifest)
                        if p.startswith("0/train/params/"))
    dtypes = {snap.metadata.manifest[f"0/{p}"].dtype for p in cast_paths}
    if dtypes != {"bfloat16"} or 2 * stored_params != params_f32:
        raise AssertionError(f"cast params stored as {dtypes}, {stored_params} of {params_f32} bytes")
    written, _ = _snapshot_bytes(path)
    fresh = Transformer(cfg, device="cuda", seed=SEED + 9)
    before = {id(p) for p in fresh.parameters()}
    Snapshot(path).restore({"train": StateDict(**fresh.train_state())})
    if {id(p) for p in fresh.parameters()} != before:
        raise AssertionError("the cast restore replaced Parameter objects")
    for p, got in _leaves(fresh.train_state()):
        expect = want[p].to(torch.bfloat16).to(torch.float32) if p.startswith("params/") else want[p]
        if not got.is_cuda or not torch.equal(got, expect):
            raise AssertionError(f"cast restore of {p} is not the bf16 round trip of the saved value")
    del fresh
    shutil.rmtree(path)

    # The 4 GiB bulk, f32 half cast, async: the cast runs at stage time on
    # the frozen copies while the caller updates every tensor at once.
    tensors = _bulk_tensors()
    witness = {k: v.clone() for k, v in tensors.items()}
    f32 = sorted(k for k, v in tensors.items() if v.dtype == torch.float32)
    path = os.path.join(workdir, "cast_bulk")
    with override_compress(mode="off"):
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pending = Snapshot.async_take(
            path, {"bulk": StateDict(tensors)},
            _custom_array_prepare_func=cast_on_save({f"bulk/{k}": torch.bfloat16 for k in f32}),
        )
        blocked_s = time.perf_counter() - t0
        staged_at_return = pending.staged()
        device_copy_bytes = torch.cuda.memory_allocated() - allocated
        for v in tensors.values():
            v.add_(1)
        pending.wait()
        wait_s = time.perf_counter() - t0
    if not staged_at_return or device_copy_bytes <= 0:
        raise AssertionError(f"async cast take: staged {staged_at_return}, "
                             f"{device_copy_bytes} bytes frozen on the card")
    targets = StateDict({k: torch.zeros_like(v) for k, v in tensors.items()})
    Snapshot(path).restore({"bulk": targets})
    for k, v in witness.items():
        expect = v.to(torch.bfloat16).float() if k in f32 else v
        if not torch.equal(targets[k], expect):
            raise AssertionError(f"async cast bulk {k} is not the cast of its value at the call")
    bulk_written, _ = _snapshot_bytes(path)
    del tensors, witness, targets
    shutil.rmtree(path)
    return {
        "phase": "transforms", "glob": glob, "cast_tensors": len(cast_paths),
        "params_f32_bytes": params_f32, "params_stored_bytes": stored_params,
        "take_s": take_s, "bytes_written": written,
        "bulk_async": {"async_blocked_s": blocked_s, "wait_s": wait_s,
                       "device_copy_bytes_at_return": device_copy_bytes,
                       "bytes_written": bulk_written, "staged_at_return": True},
        "bit_exact_round_trip": True, "parameter_identity": True,
        "seconds": time.perf_counter() - t_phase, "card": ctx["card"],
    }


class _CountingComm:
    """Wraps a communicator and counts the collectives a take or restore
    issues; everything else passes through."""

    def __init__(self, inner):
        self.inner = inner
        self.counts = {"all_gather": 0, "barrier": 0, "broadcast": 0}

    def __getattr__(self, name):
        return getattr(self.inner, name)

    @property
    def rank(self):
        return self.inner.rank

    @property
    def world_size(self):
        return self.inner.world_size

    def barrier(self):
        self.counts["barrier"] += 1
        self.inner.barrier()

    def all_gather_object(self, obj):
        self.counts["all_gather"] += 1
        return self.inner.all_gather_object(obj)

    def broadcast_object(self, obj, src=0):
        self.counts["broadcast"] += 1
        return self.inner.broadcast_object(obj, src)


def _tensor_hashes(tensors: dict) -> dict:
    """sha256 of each tensor's bytes, by name."""
    import hashlib

    import torch

    return {
        p: hashlib.sha256(
            t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
        ).hexdigest()
        for p, t in tensors.items()
    }


def _state_hashes(model) -> dict:
    """sha256 of every train-state tensor's bytes, by path."""
    return _tensor_hashes(dict(_leaves(model.train_state())))


def _restore_and_check(path: str, want: dict, fresh, witness, tokens, comm=None) -> tuple:
    """Restore ``path`` into ``fresh``, time it, and hold it to ``want`` as
    ``_check_restore`` does (bit for bit, Parameter identity, one step
    from each of ``fresh`` and ``witness`` bitwise equal). Returns
    (restore seconds, post-restore loss)."""
    import torch

    from tpusnap_torch import Snapshot, StateDict

    target = StateDict(**fresh.train_state())
    before_ids = {p: id(t) for p, t in _leaves(target)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot(path, comm=comm).restore({"train": target})
    restore_s = time.perf_counter() - t0
    for p, got in _leaves(fresh.train_state()):
        if not got.is_cuda or not torch.equal(got, want[p]):
            raise AssertionError(f"{path}: restored {p} differs from the state it holds")
    for p, got in _leaves(target):
        if id(got) != before_ids[p]:
            raise AssertionError(f"{path}: restore replaced the tensor object at {p}")
    if {id(p) for p in fresh.parameters()} != {
        before_ids[f"params/{p}"] for p, _ in _leaves(fresh.params())
    }:
        raise AssertionError(f"{path}: the module's parameters are not the restored objects")
    with torch.no_grad():
        for p, t in _leaves(witness.train_state()):
            t.copy_(want[p])
    loss_a, loss_b = fresh.train_step(tokens), witness.train_step(tokens)
    if not torch.equal(loss_a, loss_b):
        raise AssertionError(f"{path}: post-restore step {loss_a.item()!r} vs {loss_b.item()!r}")
    return restore_s, loss_a.item()


class _IOCounter:
    """Counts the bytes this process stages to the host (``staged[0]``)
    and writes (``written``: replicated and slab blobs, sharded blobs,
    per-rank blobs), by wrapping the write scheduler's stage step and the
    filesystem plugin's write; with ``fail_writes`` set, every write
    raises."""

    def __init__(self, rank: int) -> None:
        import tpusnap_torch.storage_plugins.fs as fs
        from tpusnap_torch import scheduler

        self.staged = [0]
        self.written = {"replicated": 0, "sharded": 0, "rank": 0}
        self.blobs = 0
        self.fail_writes = False
        orig_stage, orig_write = scheduler._WritePipeline.stage, fs.FSStoragePlugin.write
        counter = self

        async def stage(pipeline, executor):
            result = await orig_stage(pipeline, executor)
            counter.staged[0] += pipeline.buf_size
            return result

        async def write(plugin, write_io):
            if counter.fail_writes:
                raise OSError(f"rank {rank}: injected write failure")
            if write_io.path.startswith(".tpusnap/"):
                # Sidecars (telemetry trace) are not blobs.
                await orig_write(plugin, write_io)
                return
            n = memoryview(write_io.buf).nbytes
            if write_io.path.startswith(("replicated/", "batched/")):
                counter.written["replicated"] += n
            elif write_io.path.startswith("sharded/"):
                counter.written["sharded"] += n
            else:
                counter.written["rank"] += n
            counter.blobs += 1
            await orig_write(plugin, write_io)

        scheduler._WritePipeline.stage, fs.FSStoragePlugin.write = stage, write

    def reset(self) -> None:
        self.staged[0] = 0
        self.written.update(replicated=0, sharded=0, rank=0)
        self.blobs = 0


def _rank_comm(phase: str):
    """A rank's start in a two-rank phase: the card, the port's store
    communicator over the gloo group, launch counts set to 0."""
    import torch

    from tpusnap_torch.comm import StoreComm, get_communicator

    if not torch.cuda.is_available():
        raise AssertionError(f"a rank of the {phase} phase sees no CUDA device")
    torch.cuda.set_device(0)
    comm = get_communicator()
    if not isinstance(comm, StoreComm) or comm.world_size != 2:
        raise AssertionError(f"get_communicator() gave {comm!r} in a group of 2")
    _reset_launches()
    return comm


def _trained_replicas(comm, cfg, ddir: str):
    """Each rank trains the flagship from one seed (2 Adam steps) and
    proves the replicas bitwise equal by hashes; if they are not, rank 0's
    state goes to the others through a file (smoke setup, not a library
    feature) and the hashes are checked again. Returns (model, tokens,
    hashes, whether the replicas were equal without the copy)."""
    import torch

    from tpusnap_torch.models import Transformer

    model = Transformer(cfg, device="cuda", seed=SEED)
    tokens = _tokens(cfg, 8, SEED)
    for _ in range(2):
        model.train_step(tokens, learning_rate=1e-3)
    torch.cuda.synchronize()
    hashes = _state_hashes(model)
    gathered = comm.all_gather_object(hashes)
    equal = all(h == gathered[0] for h in gathered)
    if not equal:
        state_file = os.path.join(ddir, "rank0_state.pt")
        if comm.rank == 0:
            torch.save({p: t.cpu() for p, t in _leaves(model.train_state())}, state_file)
        comm.barrier()
        if comm.rank != 0:
            saved = torch.load(state_file)
            with torch.no_grad():
                for p, t in _leaves(model.train_state()):
                    t.copy_(saved[p])
        hashes = _state_hashes(model)
        if any(h != hashes for h in comm.all_gather_object(hashes)):
            raise AssertionError("replicas differ after copying rank 0's state")
    return model, tokens, hashes, equal


_RANK_LINE = "distributed_rank "


def _distributed_rank(ddir: str) -> None:
    """One rank of the distributed phase (run by ``run_subprocess_world``
    in its own process, both ranks on the one card): train, prove the
    replicas equal, take, restore, async take, restore the world-1
    snapshot, abort. Prints one line ``distributed_rank {json}``."""
    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.dist_store import TakeAbortedError
    from tpusnap_torch.knobs import get_barrier_timeout_s
    from tpusnap_torch.manifest import is_container_entry
    from tpusnap_torch.models import Transformer, TransformerConfig
    from tpusnap_torch.ops import flash_attention as fa

    comm = _rank_comm("distributed")
    rank = comm.rank
    out = {"rank": rank, "torch": torch.__version__}

    # Bytes each rank stages to the host and writes, by take.
    io = _IOCounter(rank)
    staged, written = io.staged, io.written
    reset_bytes = io.reset

    # Setup: every rank trains the flagship from one seed, then proves
    # the replicas equal by hashes before it declares them replicated.
    cfg = TransformerConfig()
    model, tokens, hashes, out["replicas_bitwise_equal_after_training"] = _trained_replicas(
        comm, cfg, ddir
    )
    n_tensors = len(hashes)
    state_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(model.train_state()))
    largest = max(t.numel() * t.element_size() for _, t in _leaves(model.train_state()))

    # 1. Sync take, every value replicated, with the collectives counted.
    path = os.path.join(ddir, "w2")
    want = _clone_state(model)
    if rank == 0:
        with open(os.path.join(ddir, "w2_hashes.json"), "w") as f:
            json.dump(hashes, f)
    reset_bytes()
    counting = _CountingComm(comm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = Snapshot.take(path, {"train": StateDict(**model.train_state())}, replicated=["**"],
                         comm=counting)
    out["take_s"] = time.perf_counter() - t0
    out["take_collectives"] = dict(counting.counts)
    out["take_bytes_staged"] = staged[0]
    out["take_bytes_written"] = dict(written)
    if counting.counts != {"all_gather": 2, "barrier": 2, "broadcast": 0}:
        raise AssertionError(f"rank {rank}: a take issued {counting.counts}")
    leaves = {k: e for k, e in snap.metadata.manifest.items() if not is_container_entry(e)}
    if any(k.startswith("1/") or not e.replicated for k, e in leaves.items()):
        raise AssertionError("replicated entries were not consolidated onto rank 0's tree")
    manifest = leaves
    missing = [k for k, e in manifest.items() if hasattr(e, "location") and not e.checksum]
    if missing:
        raise AssertionError(f"entries without a checksum: {missing}")
    if not snap.verify().clean:
        raise AssertionError(f"rank {rank}: verify() of the world-2 snapshot is not clean")

    # The heartbeat cadence's cost on this take (printed, not gated): the
    # default 0.5 s pump, a 0.02 s pump, and no pump (telemetry off), in
    # turns.
    from tpusnap_torch.knobs import override_heartbeat_interval_s, override_telemetry_enabled

    cadence = collections.defaultdict(list)
    for i, label in enumerate(["pump_0.5s", "pump_0.02s", "off", "off", "pump_0.02s", "pump_0.5s"]):
        with override_heartbeat_interval_s(0.02 if label == "pump_0.02s" else 0.5), \
                override_telemetry_enabled(label != "off"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Snapshot.take(os.path.join(ddir, f"cadence_{i}"),
                          {"train": StateDict(**model.train_state())}, replicated=["**"])
            cadence[label].append(time.perf_counter() - t0)
    out["cadence_take_s"] = dict(cadence)

    # 2. Restore into a fresh model on every rank, with no collective.
    fresh = Transformer(cfg, device="cuda", seed=SEED + 1)
    witness = Transformer(cfg, device="cuda", seed=SEED + 2)
    step_tokens = _tokens(cfg, 8, SEED + 1)
    counting = _CountingComm(comm)
    out["restore_s"], out["post_restore_loss"] = _restore_and_check(
        path, want, fresh, witness, step_tokens, comm=counting
    )
    out["restore_collectives"] = dict(counting.counts)
    if sum(counting.counts.values()):
        raise AssertionError(f"rank {rank}: a warm restore issued {counting.counts}")

    # 3. Async take with a train step at once, then wait() and restore.
    path_a = os.path.join(ddir, "w2_async")
    want_a = _clone_state(model)
    reset_bytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = Snapshot.async_take(path_a, {"train": StateDict(**model.train_state())},
                                  replicated=["**"])
    out["async_blocked_s"] = time.perf_counter() - t0
    model.train_step(tokens, learning_rate=1e-3)
    t1 = time.perf_counter()
    pending.wait()
    out["async_wait_s"] = time.perf_counter() - t1
    out["async_total_s"] = time.perf_counter() - t0
    out["async_bytes_staged"] = staged[0]
    out["async_bytes_written"] = dict(written)
    out["async_restore_s"], _ = _restore_and_check(path_a, want_a, fresh, witness, step_tokens)

    # 4. Elastic, world 1 -> 2: the parent's world-1 snapshot restores
    # into a fresh model on both ranks.
    with open(os.path.join(ddir, "w1_hashes.json")) as f:
        w1_hashes = json.load(f)
    target = StateDict(**fresh.train_state())
    before_ids = {p: id(t) for p, t in _leaves(target)}
    t0 = time.perf_counter()
    Snapshot(os.path.join(ddir, "w1")).restore({"train": target})
    out["w1_restore_s"] = time.perf_counter() - t0
    if _state_hashes(fresh) != w1_hashes:
        raise AssertionError(f"rank {rank}: the world-1 snapshot restored differently")
    if any(id(t) != before_ids[p] for p, t in _leaves(target)):
        raise AssertionError(f"rank {rank}: the world-1 restore replaced a tensor object")

    # 5. Abort: rank 1's writes fail inside the async take's drain; both
    # ranks' wait() raise within the barrier timeout and no metadata
    # appears.
    # (An async take of this size dispatches no write before it returns:
    # the first write fails on the drain thread.)
    path_x = os.path.join(ddir, "w2_abort")
    io.fail_writes = rank == 1
    pending = Snapshot.async_take(path_x, {"train": StateDict(**model.train_state())},
                                  replicated=["**"])
    t0 = time.perf_counter()
    try:
        pending.wait()
    except (TakeAbortedError, OSError) as e:
        out["abort_error"] = f"{type(e).__name__}: {e}"[:160]
    else:
        raise AssertionError(f"rank {rank}: the aborted take committed")
    finally:
        io.fail_writes = False
    out["abort_wait_s"] = time.perf_counter() - t0
    if out["abort_wait_s"] >= get_barrier_timeout_s():
        raise AssertionError(f"rank {rank}: the abort took {out['abort_wait_s']} s")
    if rank == 0 and not out["abort_error"].startswith("TakeAbortedError"):
        raise AssertionError(f"rank 0 saw {out['abort_error']}, not the peer's abort")
    comm.barrier()
    if os.path.exists(os.path.join(path_x, ".snapshot_metadata")):
        raise AssertionError("the aborted take left .snapshot_metadata")

    torch.cuda.synchronize()
    out.update(
        n_tensors=n_tensors, state_bytes=state_bytes, largest_tensor_bytes=largest,
        flash_launches=fa.launches, flash_routes=dict(fa.route_launches),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print(_RANK_LINE + json.dumps(out), flush=True)


def phase_distributed(ctx: dict, workdir: str) -> dict:
    """Two ranks on the one card (``tpusnap_torch.test_utils.
    run_subprocess_world``: gloo process group, the port's store
    communicator): see ``_distributed_rank``. The parent takes the world-1
    snapshot the ranks restore (1 -> 2) and restores the ranks' world-2
    snapshot into a world-1 model (2 -> 1)."""
    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.models import Transformer
    from tpusnap_torch.test_utils import run_subprocess_world

    t_phase = time.perf_counter()
    cfg, model = ctx["cfg"], ctx["model"]
    ddir = os.path.join(workdir, "distributed")
    os.makedirs(ddir)
    # A DDP job's world-1 snapshot marks its values replicated, so that
    # a rank the saving world did not have restores them.
    Snapshot.take(
        os.path.join(ddir, "w1"), {"train": StateDict(**model.train_state())}, replicated=["**"]
    )
    with open(os.path.join(ddir, "w1_hashes.json"), "w") as f:
        json.dump(_state_hashes(model), f)

    t0 = time.perf_counter()
    outputs = run_subprocess_world(
        _distributed_rank, world_size=2, args=[ddir], timeout=600,
        extra_env={"TPUSNAP_BARRIER_TIMEOUT_S": "120"},
    )
    world_s = time.perf_counter() - t0
    ranks = []
    for r, text in enumerate(outputs):
        lines = [ln for ln in text.splitlines() if ln.startswith(_RANK_LINE)]
        if len(lines) != 1:
            raise AssertionError(f"rank {r} printed no result:\n{text[-4000:]}")
        ranks.append(json.loads(lines[0][len(_RANK_LINE):]))

    # The replicated bytes were spread: each rank within the largest unit
    # (one tensor) of an even split, staged and written alike.
    for key in ("take_bytes_staged", "repl_written"):
        per_rank = [
            r["take_bytes_written"]["replicated"] if key == "repl_written" else r[key]
            for r in ranks
        ]
        total = sum(per_rank)
        if total < ranks[0]["state_bytes"] or any(
            abs(n - total / 2) > ranks[0]["largest_tensor_bytes"] for n in per_rank
        ):
            raise AssertionError(f"{key} per rank {per_rank}: not an even split of {total}")
    if any(r["take_bytes_written"]["rank"] for r in ranks):
        raise AssertionError("a rank wrote per-rank blobs of replicated state")

    # Elastic, world 2 -> 1: this process restores the world-2 snapshot.
    with open(os.path.join(ddir, "w2_hashes.json")) as f:
        w2_hashes = json.load(f)
    fresh = Transformer(cfg, device="cuda", seed=SEED + 5)
    target = StateDict(**fresh.train_state())
    before_ids = {p: id(t) for p, t in _leaves(target)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot(os.path.join(ddir, "w2")).restore({"train": target})
    w2_to_w1_s = time.perf_counter() - t0
    if _state_hashes(fresh) != w2_hashes:
        raise AssertionError("the world-2 snapshot restored into world 1 differs")
    if any(id(t) != before_ids[p] for p, t in _leaves(target)):
        raise AssertionError("the world-2 -> 1 restore replaced a tensor object")
    del fresh, target
    shutil.rmtree(ddir)
    keys = ("rank", "take_s", "restore_s", "async_blocked_s", "async_wait_s", "async_total_s",
            "async_restore_s", "w1_restore_s", "abort_wait_s", "take_bytes_staged",
            "take_bytes_written", "async_bytes_staged", "async_bytes_written",
            "take_collectives", "restore_collectives", "flash_launches", "flash_routes",
            "replicas_bitwise_equal_after_training", "abort_error", "peak_mem_gib",
            "cadence_take_s")
    total_repl = sum(r["take_bytes_written"]["replicated"] for r in ranks)
    return {
        "phase": "distributed", "world_size": 2, "state_bytes": ranks[0]["state_bytes"],
        "tensors": ranks[0]["n_tensors"], "largest_tensor_bytes": ranks[0]["largest_tensor_bytes"],
        "ranks": [{k: r[k] for k in keys} for r in ranks],
        "replicated_share": [r["take_bytes_written"]["replicated"] / total_repl for r in ranks],
        "world2_to_world1_restore_s": w2_to_w1_s, "world_s": world_s,
        "seconds": time.perf_counter() - t_phase, "bit_exact": True,
        "parameter_identity": True, "torch": torch.__version__, "card": ctx["card"],
    }


def _sharded_views(model, mesh, dim: int = 0):
    """The train state with every leaf as a ``Shard(d)`` DTensor whose
    local tensor is a view of this rank's box of the model's own tensor
    (``d`` = ``dim`` for leaves of more than ``dim`` dims, else 0); 0-d
    leaves stay dense. No collective runs."""
    from torch.distributed.tensor import Shard

    from tpusnap_torch import StateDict
    from tpusnap_torch.test_utils import as_dtensor

    def wrap(t):
        if t.dim() == 0:
            return t
        return as_dtensor(t.detach(), mesh, [Shard(dim if t.dim() > dim else 0)])

    def nest(tree):
        return {k: nest(v) for k, v in tree.items()} if isinstance(tree, dict) else wrap(tree)

    return StateDict(**nest(model.train_state()))


def _check_local_boxes(label: str, state, want: dict) -> None:
    """Every leaf of ``state`` holds ``want``'s values, bit for bit and on
    the same device (the card, or pinned host memory): a DTensor in its
    local box, a dense tensor whole."""
    import torch

    from tpusnap_torch import is_sharded
    from tpusnap_torch.io_preparers.sharded import local_box

    for p, t in _leaves(dict(state)):
        full = want[p]
        if is_sharded(t):
            offsets, sizes = local_box(list(t.shape), list(t.device_mesh.shape),
                                       t.device_mesh.get_coordinate(), list(t.placements))
            full = full[tuple(slice(o, o + n) for o, n in zip(offsets, sizes))]
            t = t.to_local()
        if t.device != full.device or not torch.equal(t, full):
            raise AssertionError(f"{label}: {p} differs from the state it holds")


def _restore_sharded(path: str, state, want: dict, label: str) -> float:
    """Restore ``path`` into ``state`` (DTensor views of a model); the
    objects and their local storage must stay, and every local box must
    equal ``want``'s. Returns the restore's seconds."""
    import torch

    from tpusnap_torch import Snapshot, is_sharded

    before = {p: (id(t), t.to_local().data_ptr() if is_sharded(t) else t.data_ptr())
              for p, t in _leaves(dict(state))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot(path).restore({"train": state})
    seconds = time.perf_counter() - t0
    for p, t in _leaves(dict(state)):
        ptr = t.to_local().data_ptr() if is_sharded(t) else t.data_ptr()
        if (id(t), ptr) != before[p]:
            raise AssertionError(f"{label}: the restore did not land in place at {p}")
    _check_local_boxes(label, state, want)
    return seconds


_SHARDED_LINE = "sharded_rank "


def _sharded_rank(sdir: str) -> None:
    """One rank of the sharded phase (two ranks on the one card): train,
    expose the train state as Shard(0) DTensors over views of the model's
    own tensors, take (sync, an unchanged increment, a subdivided take, an
    async take with a step at once) and restore (2 -> 2 into Shard(0) and,
    from the subdivided take, into Shard(1); the async snapshot; the
    parent's world-1 snapshot, 1 -> 2). Prints ``sharded_rank {json}``."""
    import torch

    from tpusnap_torch import Snapshot, is_sharded
    from tpusnap_torch.knobs import override_max_shard_size_bytes
    from tpusnap_torch.manifest import ShardedEntry
    from tpusnap_torch.models import Transformer, TransformerConfig
    from tpusnap_torch.ops import flash_attention as fa
    from tpusnap_torch.serialization import tensor_nbytes
    from tpusnap_torch.test_utils import world_mesh

    comm = _rank_comm("sharded")
    rank = comm.rank
    mesh = world_mesh("cuda")
    out = {"rank": rank, "torch": torch.__version__}
    io = _IOCounter(rank)
    cfg = TransformerConfig()
    model, tokens, hashes, out["replicas_bitwise_equal_after_training"] = _trained_replicas(
        comm, cfg, sdir
    )
    state = _sharded_views(model, mesh)
    leaves = dict(_leaves(dict(state)))
    out["dtensors"] = sum(1 for t in leaves.values() if is_sharded(t))
    out["local_bytes"] = sum(
        (t.to_local() if is_sharded(t) else t).numel() * t.element_size() for t in leaves.values()
    )

    def own_shards(snap):
        return [s for k, e in snap.metadata.manifest.items()
                if k.startswith(f"{rank}/") and isinstance(e, ShardedEntry) for s in e.shards]

    def take(name, **kw):
        io.reset()
        counting = _CountingComm(comm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = Snapshot.take(os.path.join(sdir, name), {"train": state}, replicated=["**"],
                             comm=counting, **kw)
        seconds = time.perf_counter() - t0
        if counting.counts != {"all_gather": 2, "barrier": 2, "broadcast": 0}:
            raise AssertionError(f"rank {rank}: the {name} take issued {counting.counts}")
        return snap, {"s": seconds, "bytes_staged": io.staged[0], "bytes_written": dict(io.written),
                      "blobs_written": io.blobs, "collectives": counting.counts}

    # 1. Sync take: this rank stages and writes its own boxes. It records
    # the tile dedup hashes the increment below needs to skip the boxes
    # of more than one 16 MiB checksum tile.
    want = _clone_state(model)
    snap, out["take"] = take("s2", _record_dedup_hashes=True)
    shards = own_shards(snap)
    out["take"]["shards"] = len(shards)
    if len(shards) != out["dtensors"] or out["take"]["bytes_written"]["sharded"] != sum(
        tensor_nbytes(s.tensor.dtype, s.sizes) for s in shards
    ):
        raise AssertionError(f"rank {rank}: wrote {out['take']} for {len(shards)} shards")
    missing = [s.tensor.location for e in snap.metadata.manifest.values()
               if isinstance(e, ShardedEntry) for s in e.shards if not s.tensor.checksum]
    if missing:
        raise AssertionError(f"shards without a checksum: {missing}")
    if not snap.verify().clean:
        raise AssertionError(f"rank {rank}: verify() of the sharded snapshot is not clean")

    # 2. An unchanged increment writes nothing.
    _, out["increment"] = take("s2_inc", incremental_from=os.path.join(sdir, "s2"))
    if out["increment"]["blobs_written"] or sum(out["increment"]["bytes_written"].values()):
        raise AssertionError(f"rank {rank}: the unchanged increment wrote {out['increment']}")

    # 3. A 16 MiB cap splits each rank's 32 MiB boxes of the embedding and
    # the unembedding (and their Adam moments).
    with override_max_shard_size_bytes(16 << 20):
        snap, out["split"] = take("s2_split")
    split = own_shards(snap)
    out["split"]["shards"] = len(split)
    per_path = collections.Counter(s.tensor.location.rsplit(".", 1)[0] for s in split)
    out["split"]["split_paths"] = sorted(p for p, n in per_path.items() if n > 1)
    if out["split"]["shards"] <= out["dtensors"] or out["split"]["blobs_written"] <= out["dtensors"]:
        raise AssertionError(f"rank {rank}: the capped take did not split: {out['split']}")

    # 4. Async take, a train step at once: it updates the viewed shards
    # in place while the take drains.
    io.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = Snapshot.async_take(os.path.join(sdir, "s2_async"), {"train": state},
                                  replicated=["**"])
    blocked = time.perf_counter() - t0
    model.train_step(tokens, learning_rate=1e-3)
    t1 = time.perf_counter()
    pending.wait()
    out["async"] = {"blocked_s": blocked, "wait_s": time.perf_counter() - t1,
                    "total_s": time.perf_counter() - t0, "bytes_staged": io.staged[0]}
    if model.embed.detach().equal(want["params/embed"]):
        raise AssertionError("the step during the async take changed nothing")

    if rank == 0:  # the parent's witness for the 2 -> 1 restore, saved
        # after the takes so that its writeback does not share their disk
        torch.save({p: t.cpu() for p, t in want.items()}, os.path.join(sdir, "w2_state.pt"))

    # 5. Restores into DTensor views of a fresh model.
    fresh = Transformer(cfg, device="cuda", seed=SEED + 1)
    out["restore_s"] = _restore_sharded(os.path.join(sdir, "s2"), _sharded_views(fresh, mesh),
                                        want, "2 -> 2")
    out["reshard_restore_s"] = _restore_sharded(
        os.path.join(sdir, "s2_split"), _sharded_views(fresh, mesh, dim=1), want, "2 -> 2 Shard(1)"
    )
    # The async snapshot holds the state from before the step.
    out["async_restore_s"] = _restore_sharded(
        os.path.join(sdir, "s2_async"), _sharded_views(fresh, mesh), want, "async"
    )
    # 1 -> 2: the parent's world-1 snapshot of its own model.
    w1_want = {p: t.to("cuda") for p, t in torch.load(os.path.join(sdir, "w1_state.pt")).items()}
    out["w1_restore_s"] = _restore_sharded(
        os.path.join(sdir, "w1"), _sharded_views(fresh, mesh), w1_want, "1 -> 2"
    )
    torch.cuda.synchronize()
    out.update(
        flash_launches=fa.launches, flash_routes=dict(fa.route_launches),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print(_SHARDED_LINE + json.dumps(out), flush=True)


def phase_sharded(ctx: dict, workdir: str) -> dict:
    """Two ranks on the one card hold the train state as Shard(0)
    DTensors (``_sharded_rank``). The parent takes the world-1 snapshot
    the ranks restore (1 -> 2), then restores the ranks' world-2 snapshot
    into a dense model (2 -> 1), bit for bit with Parameter identity, and
    steps it beside a witness holding rank 0's state at the take."""
    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.models import Transformer
    from tpusnap_torch.test_utils import run_subprocess_world

    t_phase = time.perf_counter()
    cfg, model = ctx["cfg"], ctx["model"]
    sdir = os.path.join(workdir, "sharded")
    os.makedirs(sdir)
    Snapshot.take(os.path.join(sdir, "w1"), {"train": StateDict(**model.train_state())},
                  replicated=["**"])
    torch.save({p: t.cpu() for p, t in _leaves(model.train_state())},
               os.path.join(sdir, "w1_state.pt"))

    t0 = time.perf_counter()
    # Compression off, so each take's byte counts are the tensors' own.
    outputs = run_subprocess_world(
        _sharded_rank, world_size=2, args=[sdir], timeout=600,
        extra_env={"TPUSNAP_BARRIER_TIMEOUT_S": "120", "TPUSNAP_COMPRESS": "off"},
    )
    world_s = time.perf_counter() - t0
    ranks = []
    for r, text in enumerate(outputs):
        lines = [ln for ln in text.splitlines() if ln.startswith(_SHARDED_LINE)]
        if len(lines) != 1:
            raise AssertionError(f"rank {r} printed no result:\n{text[-4000:]}")
        ranks.append(json.loads(lines[0][len(_SHARDED_LINE):]))
    state_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(model.train_state()))
    if sum(r["local_bytes"] for r in ranks) != state_bytes + 4:  # the 0-d step on both
        raise AssertionError(f"local bytes {[r['local_bytes'] for r in ranks]} of {state_bytes}")

    # 2 -> 1: a dense model from the world-2 snapshot, held to rank 0's
    # state at the take and stepped beside a witness holding that state.
    want = {p: t.to("cuda") for p, t in torch.load(os.path.join(sdir, "w2_state.pt")).items()}
    fresh = Transformer(cfg, device="cuda", seed=SEED + 7)
    witness = Transformer(cfg, device="cuda", seed=SEED + 8)
    w2_to_w1_s, loss = _restore_and_check(
        os.path.join(sdir, "s2"), want, fresh, witness, _tokens(cfg, 8, SEED + 1)
    )
    del fresh, witness, want
    shutil.rmtree(sdir)
    return {
        "phase": "sharded", "world_size": 2, "placements": "Shard(0) over DeviceMesh('cuda', [0, 1])",
        "state_bytes": state_bytes, "tensors": len(list(_leaves(model.train_state()))),
        "ranks": ranks, "world2_to_world1_restore_s": w2_to_w1_s,
        "post_restore_loss": loss, "world_s": world_s,
        "seconds": time.perf_counter() - t_phase, "bit_exact": True, "in_place": True,
        "torch": torch.__version__, "card": ctx["card"],
    }


# ---------------------------------------------------------------- slice 7

MOE_STATE_BYTES, MOE_TENSORS = 855_791_620, 31
# The dense flagship's train state (params, Adam moments, step).
FLAGSHIP_STATE_BYTES = 553_703_428
EMB_ROWS, EMB_DIM, EMB_TABLES = 1_000_000, 64, 4
EMB_STATE_BYTES, EMB_PINNED_BYTES = 1_040_000_000, 520_000_000
EMB_BATCH, EMB_BAG = 4096, 20


def _moe_config():
    from tpusnap_torch.models import TransformerConfig

    # The flagship at full default width with 4 experts
    # (tpusnap/models/transformer.py:55-71, examples/transformer_example.py:56).
    return TransformerConfig(n_experts=4)


def _state_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in _leaves(dict(tree)))


def phase_moe(ctx: dict, workdir: str) -> dict:
    """The MoE flagship on the card: two steps, a take, an async take with
    a step at once, restores in place of both into a fresh model (bit for
    bit, Parameter identity kept, a post-restore step bitwise equal to a
    witness's)."""
    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.models import Transformer
    from tpusnap_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    cfg = _moe_config()
    model = Transformer(cfg, device="cuda", seed=SEED)
    tokens = _tokens(cfg, 8, SEED)
    losses, step_s = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(model.train_step(tokens, learning_rate=1e-3).item())
        step_s.append(time.perf_counter() - t0)
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"non-finite MoE loss: {losses}")
    state = StateDict(**model.train_state())
    nbytes, n_tensors = _state_bytes(state), len(list(_leaves(dict(state))))
    if (nbytes, n_tensors) != (MOE_STATE_BYTES, MOE_TENSORS):
        raise AssertionError(f"MoE train state is {nbytes} bytes in {n_tensors} tensors")
    root = os.path.join(workdir, "moe")
    want_sync = _clone_state(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot.take(os.path.join(root, "sync"), {"train": state})
    take_s = time.perf_counter() - t0

    want_async = _clone_state(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = Snapshot.async_take(os.path.join(root, "async"), {"train": state})
    blocked_s = time.perf_counter() - t0
    model.train_step(tokens, learning_rate=1e-3)  # in place, while the take drains
    t1 = time.perf_counter()
    pending.wait()
    wait_s = time.perf_counter() - t1
    if model.layers["w1e"].detach().equal(want_async["params/layers/w1e"]):
        raise AssertionError("the step during the async take changed no expert weight")

    fresh = Transformer(cfg, device="cuda", seed=SEED + 1)
    witness = Transformer(cfg, device="cuda", seed=SEED + 2)
    tokens2 = _tokens(cfg, 8, SEED + 1)
    restore_s, loss = _restore_and_check(os.path.join(root, "sync"), want_sync, fresh, witness, tokens2)
    async_restore_s, async_loss = _restore_and_check(
        os.path.join(root, "async"), want_async, fresh, witness, tokens2
    )
    if not Snapshot(os.path.join(root, "async")).verify().clean:
        raise AssertionError("verify() of the MoE async snapshot is not clean")
    del fresh, witness, want_sync, want_async
    shutil.rmtree(root)
    torch.cuda.synchronize()
    return {
        "phase": "moe", "config": {
            "vocab_size": cfg.vocab_size, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
            "n_layers": cfg.n_layers, "d_ff": cfg.d_ff, "n_experts": cfg.n_experts,
            "seq": cfg.max_seq_len, "batch": 8, "dtype": "bfloat16",
        },
        "params": sum(p.numel() for p in model.parameters()), "bytes": nbytes,
        "tensors": n_tensors, "losses": losses, "step_s": step_s, "take_s": take_s,
        "take_gb_s": nbytes / take_s / 1e9, "async_blocked_s": blocked_s,
        "async_wait_s": wait_s, "restore_s": restore_s, "async_restore_s": async_restore_s,
        "post_restore_loss": [loss, async_loss], "flash_launches": fa.launches,
        "flash_routes": dict(fa.route_launches), "bit_exact": True,
        "parameter_identity": True, "seconds": time.perf_counter() - t_phase,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "card": ctx["card"],
    }


class _DtoHCounter:
    """Bytes that cross from the card to the host in a take: every
    device-to-host staging copy (a tensor's own and the device slab
    pack's) goes through ``enqueue_dtoh``."""

    def __init__(self) -> None:
        from tpusnap_torch import batcher
        from tpusnap_torch.io_preparers import array

        self.bytes = 0
        self._modules = (array, batcher)
        self._orig = array.enqueue_dtoh
        counter = self

        def enqueue(t, ready, transform=None):
            counter.bytes += t.numel() * t.element_size()
            return counter._orig(t, ready, transform)

        for m in self._modules:
            m.enqueue_dtoh = enqueue

    def close(self) -> None:
        for m in self._modules:
            m.enqueue_dtoh = self._orig


def _emb_tables(sharding: str = "row"):
    from tpusnap_torch.models import TableConfig

    # tpusnap's embedding benchmark: 4 row-wise [1,000,000, 64] f32 tables
    # (benchmarks/embedding/main.py:39-47); t2 and t3 host-offloaded.
    return [
        TableConfig(f"t{i}", EMB_ROWS, EMB_DIM, sharding=sharding, host_offload=i >= 2,
                    pooling="mean" if i % 2 else "sum")
        for i in range(EMB_TABLES)
    ]


def _emb_leaves(params) -> dict:
    return {f"{s}/{k}": t for s in ("tables", "opt") for k, t in params[s].items()}


def _check_emb_restore(label: str, target, want: dict, before: dict) -> None:
    """Every leaf restored bit for bit, the same tensor object with the
    same storage, pinned where it was."""
    import torch

    for p, t in _emb_leaves(target).items():
        if (id(t), t.data_ptr(), t.is_pinned() if not t.is_cuda else None) != before[p]:
            raise AssertionError(f"{label}: {p} was replaced, moved or unpinned")
        if not torch.equal(t, want[p]):
            raise AssertionError(f"{label}: {p} differs from the state it holds")


def phase_embedding(ctx: dict, workdir: str) -> dict:
    """tpusnap's embedding benchmark configuration on the card: 4 row-wise
    [1,000,000, 64] f32 tables with their Adagrad accumulators, t2 and t3
    (table and accumulator) pinned on the host. Adagrad steps, then a sync
    take (no device-to-host byte for the pinned tables), an unchanged
    increment (0 bytes written), an async take with a step at once (its
    snapshot equals the state at the call) and a restore that keeps every
    tensor's identity, storage and pinning."""
    import torch

    from tpusnap_torch import PytreeState, Snapshot
    from tpusnap_torch.knobs import override_async_cow, override_compress
    from tpusnap_torch.models import EmbeddingCollection, rand_features

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    model = EmbeddingCollection(_emb_tables(), device="cuda", seed=SEED)
    init_s = time.perf_counter() - t0
    leaves = _emb_leaves(model.params())
    pinned = {p for p, t in leaves.items() if not t.is_cuda}
    if pinned != {"tables/t2", "tables/t3", "opt/t2", "opt/t3"} or not all(
        leaves[p].is_pinned() for p in pinned
    ):
        raise AssertionError(f"pinned leaves {sorted(pinned)}")
    nbytes = _state_bytes(model.params())
    pinned_bytes = sum(leaves[p].numel() * leaves[p].element_size() for p in pinned)
    if (nbytes, len(leaves), pinned_bytes) != (EMB_STATE_BYTES, 8, EMB_PINNED_BYTES):
        raise AssertionError(f"embedding state {nbytes} bytes, {len(leaves)} tensors, "
                             f"{pinned_bytes} pinned")
    losses, step_s = [], []
    for step in range(3):
        feats, targets = rand_features(model, EMB_BATCH, EMB_BAG, seed=step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(model.train_step(feats, targets).item())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"non-finite embedding loss: {losses}")
    for p in pinned:
        if not leaves[p].is_pinned() or _emb_leaves(model.params())[p] is not leaves[p]:
            raise AssertionError(f"the Adagrad step replaced or unpinned {p}")
    touched = int((leaves["opt/t2"] > 0).sum())

    root = os.path.join(workdir, "embedding")
    app = {"emb": PytreeState(model.params())}
    dtoh = _DtoHCounter()
    out = {}
    try:
        with override_compress(mode="off"):  # byte counts are the tensors' own
            want = {p: t.clone() for p, t in leaves.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Snapshot.take(os.path.join(root, "base"), app, _record_dedup_hashes=True)
            out["take_s"] = time.perf_counter() - t0
            out["take_dtoh_bytes"] = dtoh.bytes
            if dtoh.bytes != nbytes - pinned_bytes:
                raise AssertionError(f"the take copied {dtoh.bytes} bytes device-to-host, "
                                     f"not the {nbytes - pinned_bytes} device bytes")
            dtoh.bytes = 0
            t0 = time.perf_counter()
            Snapshot.take(os.path.join(root, "inc"), app,
                          incremental_from=os.path.join(root, "base"))
            out["increment_s"] = time.perf_counter() - t0
            out["increment_bytes_written"], out["increment_bytes_referenced"] = _snapshot_bytes(
                os.path.join(root, "inc"))
            if out["increment_bytes_written"] != 0:
                raise AssertionError(f"the unchanged increment wrote {out['increment_bytes_written']}")

            # Async: pinned tables are cloned in the blocked window (COW
            # would forbid the step at once), device tables frozen on the card.
            feats, targets = rand_features(model, EMB_BATCH, EMB_BAG, seed=7)
            want_async = {p: t.clone() for p, t in leaves.items()}
            dtoh.bytes = 0
            with override_async_cow(False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pending = Snapshot.async_take(os.path.join(root, "async"), app)
                out["async_blocked_s"] = time.perf_counter() - t0
                model.train_step(feats, targets)
                t1 = time.perf_counter()
                pending.wait()
                out["async_wait_s"] = time.perf_counter() - t1
            out["async_dtoh_bytes"] = dtoh.bytes
    finally:
        dtoh.close()
    if torch.equal(leaves["tables/t2"], want_async["tables/t2"]):
        raise AssertionError("the step during the async take changed no pinned row")

    fresh = EmbeddingCollection(_emb_tables(), device="cuda", seed=SEED + 1)
    before = {p: (id(t), t.data_ptr(), t.is_pinned() if not t.is_cuda else None)
              for p, t in _emb_leaves(fresh.params()).items()}
    for name, expect in (("async", want_async), ("inc", want)):
        target = PytreeState(fresh.params())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Snapshot(os.path.join(root, name)).restore({"emb": target})
        out[f"{name}_restore_s"] = time.perf_counter() - t0
        _check_emb_restore(name, target.tree, expect, before)
    del fresh, want, want_async
    shutil.rmtree(root)
    return {
        "phase": "embedding", "tables": f"{EMB_TABLES} x [{EMB_ROWS}, {EMB_DIM}] f32 row-wise",
        "pinned_tables": ["t2", "t3"], "bytes": nbytes, "tensors": len(leaves),
        "pinned_bytes": pinned_bytes,
        "pinned_dtoh_bytes": out["take_dtoh_bytes"] - (nbytes - pinned_bytes),
        "init_s": init_s, "batch": EMB_BATCH, "bag": EMB_BAG,
        "losses": losses, "step_s": step_s, "rows_touched_t2": touched, **out,
        "bit_exact": True, "identity_and_pinning_kept": True,
        "seconds": time.perf_counter() - t_phase, "card": ctx["card"],
    }


_LAYOUTS_LINE = "layouts_rank "


def _own_box_bytes(state) -> int:
    """Bytes of the boxes this rank writes: its local tensor where its
    coordinate is 0 on every Replicate mesh dim."""
    total = 0
    for _, t in _leaves(dict(state)):
        coordinate = t.device_mesh.get_coordinate()
        if all(c == 0 for c, p in zip(coordinate, t.placements) if p.is_replicate()):
            total += t.to_local().numel() * t.element_size()
    return total


def _layouts_rank(ldir: str) -> None:
    """One rank of the layouts phase (two ranks on the one card): the MoE
    flagship trained on both ranks, taken as views at (data, fsdp, tensor)
    = (1, 2, 1) and restored into views of a fresh model at (1, 1, 2), a
    reshard; the embedding tables (t2, t3 pinned, over a "cpu" mesh)
    taken row-wise at (1, 2, 1), then read dense with read_object and
    placed column-wise. Prints ``layouts_rank {json}``."""
    import torch

    from tpusnap_torch import PytreeState, Snapshot, StateDict, is_sharded
    from tpusnap_torch.models import (
        EmbeddingCollection,
        Transformer,
        make_mesh,
        rand_features,
        train_state_views,
    )
    from tpusnap_torch.ops import flash_attention as fa
    from tpusnap_torch.test_utils import host_mesh_like

    comm = _rank_comm("layouts")
    rank = comm.rank
    mesh_fsdp, mesh_tensor = make_mesh("cuda", (1, 2, 1)), make_mesh("cuda", (1, 1, 2))
    host_fsdp = host_mesh_like(mesh_fsdp)
    out = {"rank": rank}
    io = _IOCounter(rank)

    cfg = _moe_config()
    model, tokens, hashes, out["replicas_bitwise_equal_after_training"] = _trained_replicas(
        comm, cfg, ldir
    )
    state = StateDict(**train_state_views(model, mesh_fsdp))
    out["dtensors"] = sum(1 for _, t in _leaves(dict(state)) if is_sharded(t))
    own = _own_box_bytes(state)
    want = _clone_state(model)
    if rank == 0:
        with open(os.path.join(ldir, "moe_hashes.json"), "w") as f:
            json.dump(hashes, f)
    io.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot.take(os.path.join(ldir, "moe_fsdp"), {"train": state})
    out["moe_take_s"] = time.perf_counter() - t0
    out["moe_bytes_written"], out["moe_own_box_bytes"] = io.written["sharded"], own
    if io.written["sharded"] != own or io.written["replicated"] or io.written["rank"]:
        raise AssertionError(f"rank {rank} wrote {io.written}, its boxes are {own} bytes")
    comm.barrier()

    fresh = Transformer(cfg, device="cuda", seed=SEED + 1)
    target = StateDict(**train_state_views(fresh, mesh_tensor))
    before = {p: (id(t), t.to_local().data_ptr()) for p, t in _leaves(dict(target))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot(os.path.join(ldir, "moe_fsdp")).restore({"train": target})
    out["moe_reshard_restore_s"] = time.perf_counter() - t0
    if {p: (id(t), t.to_local().data_ptr()) for p, t in _leaves(dict(target))} != before:
        raise AssertionError("the reshard restore did not land in place")
    _check_local_boxes("MoE (1,2,1) -> (1,1,2)", target, want)
    del fresh, target, want, model, state

    # Embedding tables: row-wise at (1, 2, 1), pinned ones over a "cpu" mesh.
    emb = EmbeddingCollection(_emb_tables(), device="cuda", seed=SEED)
    feats, targets = rand_features(emb, EMB_BATCH, EMB_BAG, seed=0)
    emb.train_step(feats, targets)
    emb_hashes = _tensor_hashes(_emb_leaves(emb.params()))
    if any(h != emb_hashes for h in comm.all_gather_object(emb_hashes)):
        raise AssertionError("the embedding replicas differ after one Adagrad step")
    emb_state = emb.shard_params(mesh_fsdp, host_fsdp)
    pinned_locals = [p for p, t in _leaves(emb_state) if t.to_local().is_pinned()]
    if sorted(pinned_locals) != ["opt/t2", "opt/t3", "tables/t2", "tables/t3"]:
        raise AssertionError(f"pinned DTensor locals: {pinned_locals}")
    if rank == 0:
        with open(os.path.join(ldir, "emb_hashes.json"), "w") as f:
            json.dump(emb_hashes, f)
    io.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot.take(os.path.join(ldir, "emb_row"), {"emb": PytreeState(emb_state)})
    out["emb_take_s"] = time.perf_counter() - t0
    out["emb_bytes_written"], out["emb_own_box_bytes"] = io.written["sharded"], _own_box_bytes(emb_state)
    if out["emb_bytes_written"] != out["emb_own_box_bytes"]:
        raise AssertionError(f"rank {rank} wrote {io.written} of embedding state")
    comm.barrier()

    # Across taxonomies: every table read dense and placed column-wise
    # (tests/test_embedding.py's recipe), in place in a fresh collection.
    col = EmbeddingCollection(_emb_tables(sharding="col"), device="cuda", seed=SEED + 1)
    snap = Snapshot(os.path.join(ldir, "emb_row"))
    t0 = time.perf_counter()
    with torch.no_grad():
        for p, t in _emb_leaves(col.params()).items():
            t.copy_(snap.read_object(f"0/emb/{p}"))
    out["emb_read_object_s"] = time.perf_counter() - t0
    _check_local_boxes("embedding row -> col", col.shard_params(mesh_fsdp, host_fsdp),
                        _emb_leaves(emb.params()))
    if not torch.equal(col.apply(feats), emb.apply(feats)):
        raise AssertionError("the column-wise tables look up other values")
    torch.cuda.synchronize()
    out.update(flash_launches=fa.launches, flash_routes=dict(fa.route_launches),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(_LAYOUTS_LINE + json.dumps(out), flush=True)


def phase_layouts(ctx: dict, workdir: str) -> dict:
    """Two ranks on the one card (``_layouts_rank``); then this process
    restores both world-2 snapshots into world 1 (2 -> 1): the MoE train
    state into a dense model and the row-wise tables into a collection
    whose t2 and t3 stay pinned, each bit for bit against rank 0's state
    at the take, in place."""
    import torch

    from tpusnap_torch import PytreeState, Snapshot, StateDict
    from tpusnap_torch.models import EmbeddingCollection, Transformer
    from tpusnap_torch.test_utils import run_subprocess_world

    t_phase = time.perf_counter()
    ldir = os.path.join(workdir, "layouts")
    os.makedirs(ldir)
    t0 = time.perf_counter()
    outputs = run_subprocess_world(
        _layouts_rank, world_size=2, args=[ldir], timeout=600,
        extra_env={"TPUSNAP_BARRIER_TIMEOUT_S": "120", "TPUSNAP_COMPRESS": "off"},
    )
    world_s = time.perf_counter() - t0
    ranks = []
    for r, text in enumerate(outputs):
        lines = [ln for ln in text.splitlines() if ln.startswith(_LAYOUTS_LINE)]
        if len(lines) != 1:
            raise AssertionError(f"rank {r} printed no result:\n{text[-4000:]}")
        ranks.append(json.loads(lines[0][len(_LAYOUTS_LINE):]))
    if sum(r["moe_bytes_written"] for r in ranks) != MOE_STATE_BYTES:
        raise AssertionError(f"the MoE boxes written sum to "
                             f"{[r['moe_bytes_written'] for r in ranks]}")
    if sum(r["emb_bytes_written"] for r in ranks) != EMB_STATE_BYTES:
        raise AssertionError(f"the embedding boxes written sum to "
                             f"{[r['emb_bytes_written'] for r in ranks]}")

    out = {}
    with open(os.path.join(ldir, "moe_hashes.json")) as f:
        moe_hashes = json.load(f)
    dense = Transformer(_moe_config(), device="cuda", seed=SEED + 7)
    target = StateDict(**dense.train_state())
    before = {p: id(t) for p, t in _leaves(target)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot(os.path.join(ldir, "moe_fsdp")).restore({"train": target})
    out["moe_2_to_1_restore_s"] = time.perf_counter() - t0
    if _state_hashes(dense) != moe_hashes or {p: id(t) for p, t in _leaves(target)} != before:
        raise AssertionError("the world-2 MoE snapshot restored into world 1 differs")
    del dense, target

    with open(os.path.join(ldir, "emb_hashes.json")) as f:
        emb_hashes = json.load(f)
    emb = EmbeddingCollection(_emb_tables(), device="cuda", seed=SEED + 2)
    before = {p: (id(t), t.data_ptr(), t.is_pinned() if not t.is_cuda else None)
              for p, t in _emb_leaves(emb.params()).items()}
    target = PytreeState(emb.params())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot(os.path.join(ldir, "emb_row")).restore({"emb": target})
    out["emb_2_to_1_restore_s"] = time.perf_counter() - t0
    leaves = _emb_leaves(target.tree)
    if {p: (id(t), t.data_ptr(), t.is_pinned() if not t.is_cuda else None)
            for p, t in leaves.items()} != before:
        raise AssertionError("the world-2 -> 1 embedding restore replaced or unpinned a tensor")
    if _tensor_hashes(leaves) != emb_hashes:
        raise AssertionError("the world-2 embedding snapshot restored into world 1 differs")
    del emb, target, leaves
    shutil.rmtree(ldir)
    return {
        "phase": "layouts", "world_size": 2,
        "moe_layout": "train_state_views at (data, fsdp, tensor) = (1, 2, 1), restored at (1, 1, 2)",
        "embedding_layout": "row-wise at (1, 2, 1); t2, t3 pinned over a 'cpu' mesh",
        "moe_bytes": MOE_STATE_BYTES, "embedding_bytes": EMB_STATE_BYTES,
        "tensors": {"moe": MOE_TENSORS, "embedding": 8}, "ranks": ranks, **out, "world_s": world_s,
        "seconds": time.perf_counter() - t_phase, "bit_exact": True, "in_place": True,
        "card": ctx["card"],
    }


# ---------------------------------------------------------------- lifecycle


_LIFE_TTL_S = 2.0
_LIFE_ENV = {
    "TPUSNAP_LIVENESS_TTL_S": str(_LIFE_TTL_S),
    "TPUSNAP_HEARTBEAT_INTERVAL_S": "0.1",
    "TPUSNAP_BARRIER_TIMEOUT_S": "120",
}
# The crash child is SIGKILLed after this many blob writes (of the train
# state's 28 with batching off; of the bulk's 32).
_CRASH_AFTER_WRITES = 10


_RING_LINE = "ring_rank "
# The ring's loss (the two ranks' group, and the ring of one) against the
# single-process dense model's on the same weights and tokens, relative.
# On an H100 (700 W): 1.0e-5 (group) and 1.4e-6 (ring of one), as both
# round P to bf16, at a block's running maximum or the row's. The loss
# alone moves little when a block is lost: the logits are held too.
RING_LOSS_RTOL = 1e-4
# Each rank's logits (and the ring of one's) against the dense model's at
# the same positions, per element: the largest |difference| allowed. On
# an H100 (700 W): 0.030, 0.042 and 0.031 on logits up to 5.8 in
# magnitude.
RING_LOGITS_ATOL = 0.2


def _ring_rank(rdir: str) -> None:
    """One rank of the ring phase's sequence-parallel forward (both ranks
    on the one card, gloo): the flagship at full width with ring
    attention, this rank's contiguous half of every sequence, the
    group's next-token loss; then (its launches read) this rank's logits
    against the dense model's at the same positions, per element.
    Prints one line ``ring_rank {json}``."""
    import importlib

    import torch
    import torch.distributed as dist

    from tpusnap_torch.models import Transformer, TransformerConfig
    from tpusnap_torch.ops import flash_attention as fa

    ra = importlib.import_module("tpusnap_torch.ops.ring_attention")
    if not torch.cuda.is_available():
        raise AssertionError("a rank of the ring phase sees no CUDA device")
    torch.cuda.set_device(0)
    rank, n = dist.get_rank(), dist.get_world_size()
    cfg = TransformerConfig(use_ring_attention=True)
    model = Transformer(cfg, device="cuda", seed=SEED)
    tokens = _tokens(cfg, 8, SEED)
    blk = cfg.max_seq_len // n
    mine = tokens[:, rank * blk : (rank + 1) * blk].contiguous()
    _reset_launches()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.loss(mine, ring_group=dist.group.WORLD)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
    out = {
        "rank": rank, "loss": loss.item(), "forward_s": forward_s,
        "ring_launches": ra.launches, "ring_routes": dict(ra.route_launches),
        "ring_modes": dict(ra.mode_launches), "ring_skips": ra.skips,
        "flash_launches": fa.launches,
    }
    with torch.no_grad():
        got = model(mine, ring_group=dist.group.WORLD)
        dense = Transformer(TransformerConfig(), device="cuda", seed=SEED)
        want = dense(tokens)[:, rank * blk : (rank + 1) * blk]
        out["logits_max_abs_err"] = (got - want).abs().max().item()
        out["logits_max_abs"] = want.abs().max().item()
    print(_RING_LINE + json.dumps(out), flush=True)


def _step_split(model, tokens, reps: int = 3) -> dict:
    """Device milliseconds of a train step's forward (the loss) and
    backward (every parameter's gradient), each between two CUDA events,
    median of ``reps``; the gradients are dropped, so the model does not
    change."""
    import torch

    leaves = list(model.parameters())
    fwd, bwd = [], []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss = model.loss(tokens)
        ev[1].record()
        torch.autograd.grad(loss, leaves)
        ev[2].record()
        ev[2].synchronize()
        fwd.append(ev[0].elapsed_time(ev[1]))
        bwd.append(ev[1].elapsed_time(ev[2]))
    return {"forward_ms": statistics.median(fwd), "backward_ms": statistics.median(bwd)}


def phase_ring(ctx: dict, workdir: str) -> dict:
    """Ring attention at the flagship's full width. (1) Two ranks on the
    one card split every sequence 512 + 512 and run the forward through
    the ring block kernel (K/V rotating through pinned host buffers over
    gloo): the group's loss must equal the single-process dense model's
    (flash kernel) within RING_LOSS_RTOL, and each rank's logits the
    dense model's at its positions within RING_LOGITS_ATOL per element,
    as must the ring of one's over the whole sequence; rank 0 launches 4
    (its future blocks skipped), rank 1 launches 8. (2) A ring-of-one replica trains
    3 Adam steps, its train state is taken and restored into a fresh
    ring model (bit for bit, Parameter identity, a post-restore step
    equal to a witness's) and into a fresh dense model (sequence
    parallelism is a layout of the computation, not of the state)."""
    import importlib

    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.models import Transformer, TransformerConfig
    from tpusnap_torch.test_utils import run_subprocess_world

    ra = importlib.import_module("tpusnap_torch.ops.ring_attention")
    t_phase = time.perf_counter()
    rdir = os.path.join(workdir, "ring")
    os.makedirs(rdir)
    t0 = time.perf_counter()
    outputs = run_subprocess_world(_ring_rank, world_size=2, args=[rdir], timeout=600)
    world_s = time.perf_counter() - t0
    ranks = []
    for r, text in enumerate(outputs):
        lines = [ln for ln in text.splitlines() if ln.startswith(_RING_LINE)]
        if len(lines) != 1:
            raise AssertionError(f"ring rank {r} printed no result:\n{text[-4000:]}")
        ranks.append(json.loads(lines[0][len(_RING_LINE):]))
    cfg_ring, cfg_dense = TransformerConfig(use_ring_attention=True), TransformerConfig()
    layers = cfg_ring.n_layers
    # Rank 0: its diagonal block alone (first+last); rank 1's block is in
    # its future and skipped. Rank 1: its diagonal block first, rank 0's
    # block (its past) last.
    expect = [(layers, layers, {"first+last": layers}),
              (2 * layers, 0, {"first": layers, "last": layers})]
    for r, (launches, skips, modes) in zip(ranks, expect):
        modes = {m: modes.get(m, 0) for m in ra.MODES}
        if (r["ring_launches"], r["ring_skips"], r["ring_modes"]) != (launches, skips, modes):
            raise AssertionError(
                f"ring rank {r['rank']}: {r['ring_launches']} launches {r['ring_modes']}, "
                f"{r['ring_skips']} skips; expected {launches} {modes} and {skips}"
            )
        if r["ring_routes"] != {"wgmma": launches, "simt": 0}:
            raise AssertionError(f"ring rank {r['rank']} launches by route {r['ring_routes']}")
        if r["flash_launches"]:
            raise AssertionError(f"ring rank {r['rank']} launched the flash kernel")
    if ranks[0]["loss"] != ranks[1]["loss"]:
        raise AssertionError(f"the ranks' group losses differ: {ranks}")
    tokens = _tokens(cfg_dense, 8, SEED)
    with torch.no_grad():
        dense, one = (Transformer(c, device="cuda", seed=SEED) for c in (cfg_dense, cfg_ring))
        dense_loss, one_block_loss = dense.loss(tokens).item(), one.loss(tokens).item()
        want = dense(tokens)
        one_logits_err = (one(tokens) - want).abs().max().item()
        del dense, one, want
    group_loss = ranks[0]["loss"]
    rel = abs(group_loss - dense_loss) / abs(dense_loss)
    one_rel = abs(one_block_loss - dense_loss) / abs(dense_loss)
    for what, loss, r in (("group", group_loss, rel), ("ring of one", one_block_loss, one_rel)):
        if not (loss == loss and r <= RING_LOSS_RTOL):
            raise AssertionError(
                f"ring {what} loss {loss!r} vs dense {dense_loss!r}: relative "
                f"{r} > {RING_LOSS_RTOL}"
            )
    logits_err = [r["logits_max_abs_err"] for r in ranks] + [one_logits_err]
    if not all(e <= RING_LOGITS_ATOL for e in logits_err):
        raise AssertionError(
            f"ring logits vs dense, max |err| (rank 0, rank 1, ring of one): "
            f"{logits_err} > {RING_LOGITS_ATOL}"
        )
    # The split of a train step, a ring-of-one model's against a dense
    # model's from the same seed on the same tokens, after a warm-up step
    # each (before the replica's counts start).
    step_split = {}
    for name, cfg in (("ring_of_one", cfg_ring), ("dense", cfg_dense)):
        split_model = Transformer(cfg, device="cuda", seed=SEED + 11)
        split_model.train_step(tokens, learning_rate=1e-3)
        step_split[name] = _step_split(split_model, tokens, reps=5)
        del split_model

    # (2) a ring-of-one replica trains, takes, restores into ring and dense.
    _reset_launches()
    model = Transformer(cfg_ring, device="cuda", seed=SEED + 11)
    losses, step_s = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(model.train_step(tokens, learning_rate=1e-3).item())
        step_s.append(time.perf_counter() - t0)
    if not all(x == x and abs(x) != float("inf") for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"ring replica losses {losses}")

    path = os.path.join(rdir, "replica")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot.take(path, {"train": StateDict(**model.train_state())})
    take_s = time.perf_counter() - t0
    want = _clone_state(model)
    ring_restore_s, ring_loss = _restore_and_check(
        path, want, Transformer(cfg_ring, device="cuda", seed=SEED + 12),
        Transformer(cfg_ring, device="cuda", seed=SEED + 13), tokens,
    )
    replica_launches, replica_routes = ra.launches, dict(ra.route_launches)
    replica_modes = dict(ra.mode_launches)
    if (replica_launches != layers * 5 or replica_routes["simt"]
            or replica_modes["first+last"] != replica_launches):
        raise AssertionError(
            f"ring replica: {replica_launches} launches {replica_routes} {replica_modes}; "
            f"expected {layers * 5} (3 steps, then one step of each restored model), all "
            f"wgmma, all first+last"
        )
    dense_restore_s, dense_step_loss = _restore_and_check(
        path, want, Transformer(cfg_dense, device="cuda", seed=SEED + 14),
        Transformer(cfg_dense, device="cuda", seed=SEED + 15), tokens,
    )
    shutil.rmtree(rdir)
    return {
        "phase": "ring", "config": "TransformerConfig(use_ring_attention=True), full width",
        "ranks": ranks, "world_s": world_s, "group_loss": group_loss,
        "dense_loss": dense_loss, "one_block_loss": one_block_loss,
        "group_vs_dense_rel": rel, "one_block_vs_dense_rel": one_rel, "rtol": RING_LOSS_RTOL,
        "logits_max_abs_err": logits_err, "logits_atol": RING_LOGITS_ATOL,
        "replica_losses": losses, "replica_step_s": step_s, "take_s": take_s,
        "ring_restore_s": ring_restore_s, "ring_post_restore_loss": ring_loss,
        "dense_restore_s": dense_restore_s, "dense_post_restore_loss": dense_step_loss,
        "replica_ring_launches": replica_launches, "replica_ring_routes": replica_routes,
        "replica_ring_modes": replica_modes, "step_split_ms": step_split,
        "bit_exact": True, "parameter_identity": True,
        "seconds": time.perf_counter() - t_phase, "card": ctx["card"],
    }


_SHARDED_STEP_LINE = "sharded_step_rank "
# tpusnap's default mesh for four devices (_default_mesh_shape), and the
# mesh shape the snapshot is restored into: a ring of 4.
SHARDED_MESH = (1, 2, 2)
RESHARD_MESH = (1, 4, 1)
# The MoE flagship's mesh: its expert dim rides "data" (two experts a rank).
MOE_MESH = (2, 2, 1)
SHARDED_LR = 1e-3
# Each leaf's gradient from the sharded step (the sum over its data x fsdp
# group) against the one-process witness's, as a relative Frobenius error.
# Both compute in bf16, and the ring's forward rounds P at other running
# maxima than the ring of one's, so values differ by a few units of bf16's
# roundoff u = 2**-8 = 3.9e-3 wherever they are rounded; a gradient is a
# sum over the 8192 positions of such terms, whose independent errors do
# not grow with its length. 1e-2 is about 2.5 u. On an H100 (700 W) the
# ring's worst leaf was 0.0087 (the embedding), and two correct
# one-process models, the dense flash one and the ring of one, differ by
# up to 0.0082 on the same weights and tokens: the gate sits just above
# bf16's own spread between implementations.
SHARDED_GRAD_RTOL = 1e-2


def _split_ms(splits: list) -> dict:
    """The median milliseconds of each stage over a run's steps."""
    return {k: 1e3 * statistics.median(s[k] for s in splits) for k in splits[0]}


def _ring_counts() -> dict:
    import importlib

    from tpusnap_torch.ops import flash_attention as fa

    ra = importlib.import_module("tpusnap_torch.ops.ring_attention")
    return {"ring_launches": ra.launches, "ring_routes": dict(ra.route_launches),
            "ring_modes": dict(ra.mode_launches), "ring_skips": ra.skips,
            "backward_steps": ra.backward_steps, "backward_skips": ra.backward_skips,
            "flash_launches": fa.launches, "flash_routes": dict(fa.route_launches)}


def _sharded_steps(step, state, tokens, n: int) -> tuple:
    import torch

    losses, walls, splits = [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(state, tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss.item())
        splits.append(dict(step.split))
    return losses, walls, splits


def _sharded_step_rank(sdir: str) -> None:
    """One of four ranks on the one card (gloo) in the sharded_step phase.
    (a) The ring flagship at SHARDED_MESH: 3 Adam steps of
    ``make_train_step(model, mesh)``, step 1's full gradients saved by rank
    0; (c) the state taken after step 3, step 4 as the witness, restores
    into fresh states at SHARDED_MESH (step 4 bit for bit) and
    RESHARD_MESH (step 4's loss); (b) the dense flagship (flash kernel) at
    SHARDED_MESH, 1 step; (d) the MoE flagship at MOE_MESH, 1 step. Prints
    ``sharded_step_rank {json}``."""
    import torch
    import torch.distributed as dist

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.models import (
        Transformer,
        TransformerConfig,
        init_train_state,
        make_mesh,
        make_train_step,
    )
    from tpusnap_torch.ops.ring_attention import ring_attention

    if not torch.cuda.is_available():
        raise AssertionError("a rank of the sharded_step phase sees no CUDA device")
    torch.cuda.set_device(0)
    rank = dist.get_rank()
    mesh = make_mesh("cuda", SHARDED_MESH)
    cfg_ring, cfg_dense = TransformerConfig(use_ring_attention=True), TransformerConfig()
    tokens = _tokens(cfg_ring, 8, SEED)
    out = {"rank": rank, "coordinate": mesh.get_coordinate()}

    # (a) the ring flagship
    model = Transformer(cfg_ring, device="cuda", seed=SEED)
    state = init_train_state(model, mesh)
    step = make_train_step(model, mesh, learning_rate=SHARDED_LR)
    # The ring under grad against the ring under no_grad, at this rank's
    # block of the flagship's attention, before the main path's counts.
    gen = torch.Generator(device="cuda").manual_seed(SEED + rank)
    blk = tuple(RING_BLOCK_SHAPE)
    q, k, v = (torch.randn(blk, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(3))
    with torch.no_grad():
        plain = ring_attention(q, k, v, group=step.ring_group)
    graded = ring_attention(*(t.requires_grad_(True) for t in (q, k, v)), group=step.ring_group)
    out["grad_output_bitwise_no_grad"] = bool(torch.equal(graded.detach(), plain))
    del q, k, v, plain, graded
    step.timed = step.keep_grads = True
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, walls, splits = _sharded_steps(step, state, tokens, 1)
    if rank == 0:
        torch.save({p: g.cpu() for p, g in step.grads.items()}, os.path.join(sdir, "grads_ring.pt"))
    step.keep_grads, step.grads = False, {}
    more = _sharded_steps(step, state, tokens, 2)
    out["ring"] = {"losses": losses + more[0], "step_s": walls + more[1],
                   "split_ms": _split_ms(splits + more[2]), **_ring_counts()}

    # (c) the state after step 3: taken, then step 4 from it three ways
    io = _IOCounter(rank)
    own = _own_box_bytes(state)
    path = os.path.join(sdir, "snap")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot.take(path, {"train": StateDict(**state)})
    take_s = time.perf_counter() - t0
    if io.written["sharded"] != own or io.written["replicated"] or io.written["rank"]:
        raise AssertionError(f"rank {rank} wrote {io.written}, its boxes are {own} bytes")
    taken = {p: t.to_local().clone() for p, t in _leaves(state)}
    dist.barrier()
    _reset_launches()
    witness = step(state, tokens)
    fresh = Transformer(cfg_ring, device="cuda", seed=SEED + 1)
    fresh_state = init_train_state(fresh, mesh)
    t0 = time.perf_counter()
    Snapshot(path).restore({"train": StateDict(**fresh_state)})
    restore_s = time.perf_counter() - t0
    if any(not torch.equal(t.to_local(), taken[p]) for p, t in _leaves(fresh_state)):
        raise AssertionError(f"rank {rank}: the restore at {SHARDED_MESH} differs from the take")
    again = make_train_step(fresh, mesh, learning_rate=SHARDED_LR)(fresh_state, tokens)
    same = torch.equal(again, witness) and all(
        torch.equal(t.to_local(), u.to_local())
        for (_, t), (_, u) in zip(_leaves(fresh_state), _leaves(state)))
    del fresh, fresh_state
    ring4 = make_mesh("cuda", RESHARD_MESH)
    other = Transformer(cfg_ring, device="cuda", seed=SEED + 2)
    other_state = init_train_state(other, ring4)
    t0 = time.perf_counter()
    Snapshot(path).restore({"train": StateDict(**other_state)})
    reshard_restore_s = time.perf_counter() - t0
    resharded = make_train_step(other, ring4, learning_rate=SHARDED_LR)(other_state, tokens)
    out["snapshot"] = {
        "bytes_written": io.written["sharded"], "own_box_bytes": own, "take_s": take_s,
        "restore_s": restore_s, "reshard_restore_s": reshard_restore_s,
        "witness_step4_loss": witness.item(), "restored_step4_loss": again.item(),
        "step4_bitwise": bool(same), "reshard_step4_loss": resharded.item(), **_ring_counts(),
    }
    del other, other_state, model, state, step
    dist.barrier()

    # (b) the dense flagship: the flash kernel at each rank's batch shard
    dense = Transformer(cfg_dense, device="cuda", seed=SEED)
    dstate = init_train_state(dense, mesh)
    dstep = make_train_step(dense, mesh, learning_rate=SHARDED_LR)
    dstep.timed = dstep.keep_grads = True
    _reset_launches()
    losses, walls, splits = _sharded_steps(dstep, dstate, tokens, 1)
    if rank == 0:
        torch.save({p: g.cpu() for p, g in dstep.grads.items()}, os.path.join(sdir, "grads_dense.pt"))
    out["dense"] = {"losses": losses, "step_s": walls, "split_ms": _split_ms(splits),
                    **_ring_counts()}
    del dense, dstate, dstep
    dist.barrier()

    # (d) the MoE flagship, its expert dim over data
    moe_mesh = make_mesh("cuda", MOE_MESH)
    moe = Transformer(_moe_config(), device="cuda", seed=SEED)
    mstate = init_train_state(moe, moe_mesh)
    mstep = make_train_step(moe, moe_mesh, learning_rate=SHARDED_LR)
    mstep.timed = mstep.keep_grads = True
    _reset_launches()
    losses, walls, splits = _sharded_steps(mstep, mstate, tokens, 1)
    if rank == 0:
        torch.save({p: g.cpu() for p, g in mstep.grads.items()}, os.path.join(sdir, "grads_moe.pt"))
    out["moe"] = {"losses": losses, "step_s": walls, "split_ms": _split_ms(splits),
                  "expert_box": list(mstate["params"]["layers"]["w1e"].to_local().shape),
                  **_ring_counts()}
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    dist.barrier()
    print(_SHARDED_STEP_LINE + json.dumps(out), flush=True)


def _grad_errors(got: dict, want: dict) -> dict:
    """Per leaf: ||got - want|| / ||want||, Frobenius, in f64."""
    return {p: ((got[p].double() - w.double().cpu()).norm() / w.double().norm()).item()
            for p, w in want.items()}


def _witness_grads(cfg, tokens) -> tuple:
    """One process, the whole batch: the loss and every parameter's
    gradient of ``cfg``'s flagship from SEED (the one-replica step's)."""
    import torch

    from tpusnap_torch.models import Transformer

    model = Transformer(cfg, device="cuda", seed=SEED)
    paths = [p for p, _ in _leaves(model.params())]
    loss = model.loss(tokens)
    grads = torch.autograd.grad(loss, [t for _, t in _leaves(model.params())])
    out = loss.item(), {p: g.cpu() for p, g in zip(paths, grads)}
    del model, loss, grads
    return out


def phase_sharded_step(ctx: dict, workdir: str) -> dict:
    """tpusnap's sharded train step on four ranks sharing the one card
    (gloo; ``_sharded_step_rank``): (a) the ring flagship at (1, 2, 2),
    its step-1 loss within RING_LOSS_RTOL of a one-process ring-of-one
    model's on the whole batch and its gradients within SHARDED_GRAD_RTOL
    per leaf, the ring block kernel's launches by mode (all wgmma), the
    backward's block steps, the ring's output under grad equal to its
    no_grad output bit for bit; (c) the state taken after step 3, each
    rank writing exactly its boxes, restored at (1, 2, 2) (step 4 bit for
    bit against the witness) and at (1, 4, 1) (step 4's loss within
    RING_LOSS_RTOL); (b) the dense flagship at (1, 2, 2) and (d) the MoE
    flagship at (2, 2, 1) (two experts a rank), one step each against the
    one-replica step with the same checks, the flash kernel's launches
    (all wgmma). Prints each part's step time and its split."""
    import torch

    from tpusnap_torch.models import TransformerConfig
    from tpusnap_torch.test_utils import run_subprocess_world

    t_phase = time.perf_counter()
    sdir = os.path.join(workdir, "sharded_step")
    os.makedirs(sdir)
    t0 = time.perf_counter()
    outputs = run_subprocess_world(
        _sharded_step_rank, world_size=4, args=[sdir], timeout=600,
        extra_env={"TPUSNAP_BARRIER_TIMEOUT_S": "120", "TPUSNAP_COMPRESS": "off"},
    )
    world_s = time.perf_counter() - t0
    ranks = []
    for r, text in enumerate(outputs):
        lines = [ln for ln in text.splitlines() if ln.startswith(_SHARDED_STEP_LINE)]
        if len(lines) != 1:
            raise AssertionError(f"sharded_step rank {r} printed no result:\n{text[-4000:]}")
        ranks.append(json.loads(lines[0][len(_SHARDED_STEP_LINE):]))
    layers = TransformerConfig().n_layers
    for r in ranks:
        f = r["coordinate"][1]  # the rank's place in its ring of 2
        ring, snap, dense = r["ring"], r["snapshot"], r["dense"]
        # Under grad the ring keeps its carry: first, then middle on rank
        # f = 1; a future block rotates past (skips) in both directions.
        expect = {"ring_launches": 3 * layers * (f + 1),
                  "ring_modes": {"first": 3 * layers, "middle": 3 * layers * f},
                  "ring_skips": 3 * layers * (1 - f), "backward_steps": 3 * layers * (f + 1),
                  "backward_skips": 3 * layers * (1 - f), "flash_launches": 0}
        # Step 4 at (1, 2, 2) twice, then in a ring of 4 as its rank.
        expect_c = {"ring_launches": 2 * layers * (f + 1) + layers * (r["rank"] + 1),
                    "ring_modes": {"first": 3 * layers, "middle": 2 * layers * f + layers * r["rank"]},
                    "backward_steps": 2 * layers * (f + 1) + layers * (r["rank"] + 1),
                    "flash_launches": 0}
        for what, got, want in (("(a)", ring, expect), ("(c)", snap, expect_c)):
            for key, value in want.items():
                have = got[key]
                if key == "ring_modes":
                    have = {m: n for m, n in have.items() if n}
                    value = {m: n for m, n in value.items() if n}
                if have != value:
                    raise AssertionError(f"rank {r['rank']} {what} {key}: {have}, expected {value}")
            if got["ring_routes"] != {"wgmma": got["ring_launches"], "simt": 0}:
                raise AssertionError(f"rank {r['rank']} {what} ring routes {got['ring_routes']}")
        for what, c in (("(b)", dense), ("(d)", r["moe"])):
            if (c["flash_launches"] != layers or c["ring_launches"]
                    or c["flash_routes"] != {"wgmma": layers, "simt": 0}):
                raise AssertionError(f"rank {r['rank']} {what}: {c['flash_launches']} flash "
                                     f"{c['flash_routes']}, {c['ring_launches']} ring launches; "
                                     f"expected {layers} wgmma, 0")
        if not r["grad_output_bitwise_no_grad"]:
            raise AssertionError(f"rank {r['rank']}: the ring's output under grad differs from no_grad")
        if not snap["step4_bitwise"] or snap["bytes_written"] != snap["own_box_bytes"]:
            raise AssertionError(f"rank {r['rank']} (c): {snap}")
    for key in ("ring", "dense", "moe"):
        if any(r[key]["losses"] != ranks[0][key]["losses"] for r in ranks):
            raise AssertionError(f"the ranks' {key} losses differ: {[r[key]['losses'] for r in ranks]}")
    ring_losses = ranks[0]["ring"]["losses"]
    if not all(x == x for x in ring_losses) or not ring_losses[-1] < ring_losses[0]:
        raise AssertionError(f"sharded ring losses {ring_losses}")
    if sum(r["snapshot"]["bytes_written"] for r in ranks) != FLAGSHIP_STATE_BYTES:
        raise AssertionError(f"the boxes written sum to {[r['snapshot']['bytes_written'] for r in ranks]}")

    cfg_ring, cfg_dense = TransformerConfig(use_ring_attention=True), TransformerConfig()
    tokens = _tokens(cfg_dense, 8, SEED)
    checks = {}
    one_loss, one_grads = _witness_grads(cfg_ring, tokens)
    dense_loss, dense_grads = _witness_grads(cfg_dense, tokens)
    ring_got = torch.load(os.path.join(sdir, "grads_ring.pt"))
    dense_got = torch.load(os.path.join(sdir, "grads_dense.pt"))
    checks["ring"] = {"loss": ring_losses[0], "witness_loss": one_loss,
                      "rel": abs(ring_losses[0] - one_loss) / abs(one_loss),
                      "grad_rel": _grad_errors(ring_got, one_grads),
                      # Two correct single-process models apart: the yardstick.
                      "dense_vs_ring_of_one_grad_rel": _grad_errors(dense_grads, one_grads)}
    checks["dense"] = {"loss": ranks[0]["dense"]["losses"][0], "witness_loss": dense_loss,
                       "rel": abs(ranks[0]["dense"]["losses"][0] - dense_loss) / abs(dense_loss),
                       "grad_rel": _grad_errors(dense_got, dense_grads)}
    del one_grads, dense_grads, ring_got, dense_got
    moe_loss, moe_grads = _witness_grads(_moe_config(), tokens)
    moe_got = torch.load(os.path.join(sdir, "grads_moe.pt"))
    checks["moe"] = {"loss": ranks[0]["moe"]["losses"][0], "witness_loss": moe_loss,
                     "rel": abs(ranks[0]["moe"]["losses"][0] - moe_loss) / abs(moe_loss),
                     "grad_rel": _grad_errors(moe_got, moe_grads)}
    del moe_grads, moe_got
    witness4 = ranks[0]["snapshot"]["witness_step4_loss"]
    reshard = [r["snapshot"]["reshard_step4_loss"] for r in ranks]
    checks["reshard_rel"] = max(abs(x - witness4) / abs(witness4) for x in reshard)
    for key in ("ring", "dense", "moe"):
        c = checks[key]
        if not c["rel"] <= RING_LOSS_RTOL:
            raise AssertionError(f"sharded {key} step-1 loss {c['loss']!r} vs one process "
                                 f"{c['witness_loss']!r}: relative {c['rel']} > {RING_LOSS_RTOL}")
        worst = max(c["grad_rel"].values())
        if not worst <= SHARDED_GRAD_RTOL:
            raise AssertionError(f"sharded {key} step-1 gradients vs one process: {c['grad_rel']} "
                                 f"(worst {worst} > {SHARDED_GRAD_RTOL})")
    if not checks["reshard_rel"] <= RING_LOSS_RTOL:
        raise AssertionError(f"step 4 at {RESHARD_MESH}: {reshard} vs witness {witness4}")
    shutil.rmtree(sdir)
    return {
        "phase": "sharded_step", "world_size": 4, "mesh": SHARDED_MESH,
        "reshard_mesh": RESHARD_MESH, "moe_mesh": MOE_MESH, "learning_rate": SHARDED_LR,
        "config": "TransformerConfig(use_ring_attention=True), TransformerConfig() and "
                  "TransformerConfig(n_experts=4), full width",
        "tensor_axis": "redundant compute, gradients summed over data x fsdp",
        "ranks": ranks, "checks": checks, "loss_rtol": RING_LOSS_RTOL,
        "grad_rtol": SHARDED_GRAD_RTOL, "world_s": world_s,
        "seconds": time.perf_counter() - t_phase, "card": ctx["card"],
    }


def _lifecycle_model(ctx: dict, workdir: str):
    """The flagship at full width from a seed, one Adam step (the flash
    kernel runs), its train state saved to a file (smoke setup) so that
    child processes hold the same bytes."""
    import torch

    from tpusnap_torch.models import Transformer

    model = Transformer(ctx["cfg"], device="cuda", seed=SEED + 7)
    model.train_step(ctx["tokens"], learning_rate=1e-3)
    torch.cuda.synchronize()
    state_file = os.path.join(workdir, "lifecycle_state.pt")
    torch.save({p: t.detach().cpu() for p, t in _leaves(model.train_state())}, state_file)
    return model, state_file


def _model_from(cfg, state_file: str):
    """A flagship on the card holding the saved train state."""
    import torch

    from tpusnap_torch.models import Transformer

    model = Transformer(cfg, device="cuda", seed=SEED + 9)
    saved = torch.load(state_file)
    with torch.no_grad():
        for p, t in _leaves(model.train_state()):
            t.copy_(saved[p])
    return model


def _payload_bytes_written() -> int:
    """Bytes the filesystem plugin has written in this process (payload
    and metadata; sidecars are not sampled)."""
    from tpusnap_torch import telemetry

    return telemetry.global_io_histograms_snapshot().get(
        "write.FSStoragePlugin", {}).get("bytes_total", 0)


def _crash_child(kind: str, path: str, state_file: str) -> None:
    """``chip_smoke.py --crash-child {train,bulk} PATH STATE_FILE``: a
    fresh interpreter holds the state on the card and takes it through
    ``chaos+fs://`` with ``crash_after_op``: the fault plan SIGKILLs it
    after its N-th blob write. ``bulk``: an async take of the 4 GiB bulk,
    then add_(1) on every tensor at once (a step in place); the kill comes
    during the drain."""
    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.models import TransformerConfig

    torch.cuda.set_device(0)
    opts = {"fault_plan": f"crash_after_op=write:{_CRASH_AFTER_WRITES}"}
    if kind == "train":
        model = _model_from(TransformerConfig(), state_file)
        torch.cuda.synchronize()
        Snapshot.take("chaos+fs://" + path, {"train": StateDict(**model.train_state())},
                      storage_options=opts)
    else:
        tensors = _bulk_tensors()
        pending = Snapshot.async_take("chaos+fs://" + path, {"bulk": StateDict(tensors)},
                                      storage_options=opts)
        for t in tensors.values():
            t.add_(1)
        pending.wait()
    raise SystemExit("the crash child was not killed")


def _run_crash_child(kind: str, path: str, state_file: str) -> float:
    # Batching and compression off, in the child and in the retake: slab
    # blobs are never journaled, and the retake must stage the same
    # bytes (after the compress phase, auto may choose to compress).
    env = dict(os.environ, TPUSNAP_DISABLE_BATCHING="1", TPUSNAP_COMPRESS="off")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--crash-child", kind, path, state_file],
        env=env, capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != -9:
        raise AssertionError(
            f"the {kind} crash child exited {proc.returncode}, not SIGKILL:\n{proc.stderr[-3000:]}"
        )
    return time.perf_counter() - t0


def _salvage_retake(path: str, state: dict) -> dict:
    """Take ``state`` over the torn ``path`` (batching and compression
    off, as the torn take): what it staged, salvaged and wrote."""
    import torch

    from tpusnap_torch import Snapshot, StateDict, telemetry
    from tpusnap_torch.knobs import override_batching_disabled, override_compress

    total = sum(t.numel() * t.element_size() for _, t in _leaves(state))
    c0 = {k: telemetry.counter_value(k) for k in
          ("salvage.bytes_salvaged", "salvage.blobs_salvaged", "scheduler.bytes_staged")}
    w0 = _payload_bytes_written()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with override_batching_disabled(True), override_compress(mode="off"):
        Snapshot.take(path, state)
    take_s = time.perf_counter() - t0
    meta = os.path.getsize(os.path.join(path, ".snapshot_metadata"))
    out = {k.split(".", 1)[1]: telemetry.counter_value(k) - v for k, v in c0.items()}
    out.update(state_bytes=total, bytes_written=_payload_bytes_written() - w0 - meta,
               take_s=take_s)
    if not 0 < out["bytes_written"] < total:
        raise AssertionError(f"the salvage retake wrote {out['bytes_written']} of {total} bytes")
    if out["bytes_written"] + out["bytes_salvaged"] != total:
        raise AssertionError(f"written + salvaged != state bytes: {out}")
    if out["bytes_staged"] != total:
        raise AssertionError(f"the retake staged {out['bytes_staged']} of {total} bytes")
    return out


def _check_torn(path: str) -> dict:
    """No metadata, and the port's fsck calls the directory torn."""
    from tpusnap_torch import fsck_snapshot

    if os.path.exists(os.path.join(path, ".snapshot_metadata")):
        raise AssertionError(f"{path}: a killed take left .snapshot_metadata")
    report = fsck_snapshot(path)
    if report.state != "torn":
        raise AssertionError(f"{path}: fsck says {report.summary()}")
    return {"fsck": report.state, "salvage_records": report.salvage_records,
            "salvage_bytes_present": report.salvage_bytes_present}


def _gc_and_check_clean(path: str) -> list:
    """A committed take: nothing missing; the only orphans allowed are
    ``.tmp.`` debris of the killed process's atomic writes, which gc
    reclaims; then no orphan is left and ``verify()`` is clean. Returns
    the debris reclaimed."""
    from tpusnap_torch import Snapshot, fsck_snapshot, gc_snapshot

    report = fsck_snapshot(path)
    if report.state != "committed" or report.missing_referenced:
        raise AssertionError(f"{path}: {report.summary()}")
    debris = sorted(report.orphans)
    if any(".tmp." not in p for p in debris):
        raise AssertionError(f"{path}: orphans that are not tmp debris: {debris}")
    gc = gc_snapshot(path, dry_run=False)
    if sorted(gc.reclaimed) != debris or gc.errors:
        raise AssertionError(f"{path}: gc reclaimed {gc.reclaimed}, errors {gc.errors}")
    after = fsck_snapshot(path)
    if after.state != "committed" or after.orphans:
        raise AssertionError(f"{path} after gc: {after.summary()}")
    if not Snapshot(path).verify().clean:
        raise AssertionError(f"{path}: verify() is not clean")
    return debris


def phase_crash(ctx: dict, workdir: str) -> dict:
    """One rank, a child process SIGKILLed mid-write (the train state),
    then mid-drain of an async take of the bulk stepped in place: each
    directory is torn, a retake salvages it, restores bit-exact."""
    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.models import Transformer

    t_phase = time.perf_counter()
    cfg, model, state_file = ctx["cfg"], ctx["life_model"], ctx["life_state_file"]
    out = {"phase": "crash"}
    path = os.path.join(workdir, "crash_train")
    out["child_s"] = _run_crash_child("train", path, state_file)
    out["torn"] = _check_torn(path)
    # The cli phase runs fsck, timeline and gc --torn on this torn take.
    ctx["cli_torn"] = os.path.join(workdir, "cli_torn")
    shutil.copytree(path, ctx["cli_torn"])
    want = _clone_state(model)
    out["retake"] = _salvage_retake(path, {"train": StateDict(**model.train_state())})
    fresh = Transformer(cfg, device="cuda", seed=SEED + 1)
    witness = Transformer(cfg, device="cuda", seed=SEED + 2)
    out["post_restore_loss"] = _check_restore(path, want, fresh, witness, _tokens(cfg, 8, SEED + 3))
    out["gc_reclaimed"] = _gc_and_check_clean(path)
    del fresh, witness
    shutil.rmtree(path)

    path = os.path.join(workdir, "crash_bulk")
    out["bulk_child_s"] = _run_crash_child("bulk", path, state_file)
    out["bulk_torn"] = _check_torn(path)
    bulk = _bulk_tensors()  # the state at the call
    out["bulk_retake"] = _salvage_retake(path, {"bulk": StateDict(bulk)})
    targets = StateDict({k: torch.zeros_like(v) for k, v in bulk.items()})
    Snapshot(path).restore({"bulk": targets})
    for k, v in bulk.items():
        if not torch.equal(targets[k], v):
            raise AssertionError(f"crash_bulk: {k} is not the state at the call")
    out["bulk_gc_reclaimed"] = _gc_and_check_clean(path)
    del bulk, targets
    shutil.rmtree(path)
    out.update(seconds=time.perf_counter() - t_phase, bit_exact=True, card=ctx["card"])
    return out

# The crash_matrix phase: tests/test_torch_crash_matrix.py's commit windows
# and tests/test_torch_delta_crash.py's delta windows on the card. A child
# lingers this long in its window after printing MARK; the parent SIGKILLs
# its process group at random.Random(seed).uniform(0, jitter max) after the
# MARK: seed 0 (1.27 s of 1.5) lands after the window, seed 1 (0.20 s) in it.
_MATRIX_WINDOWS = ("staging", "residual_io", "metadata", "durable", "journal")
_MATRIX_SEEDS = (0, 1)
_DELTA_WINDOWS = ("delta_micro", "delta_between", "delta_compact")
_DELTA_SEED = 1
_WINDOW_SLEEP_S = 1.2
# residual_io: the staging window of the async take (so the drain stages
# windows from the frozen device copies while the steps run), the delay
# before each blob write and the flagship steps taken after the return.
_RESIDUAL_WINDOW_BYTES = 128 << 20
_RESIDUAL_WRITE_DELAY_S = 0.15
_RESIDUAL_STEPS = 3
# The delta windows' state: w = pattern(seed) + k at step k, on the card.
_DELTA_SHAPE = (1024, 1024)
_MATRIX_ENV = {"TPUSNAP_DISABLE_BATCHING": "1", "TPUSNAP_COMPRESS": "off",
               "TPUSNAP_HEARTBEAT_INTERVAL_S": "0.05"}


def _mark_and_linger() -> None:
    print("MARK", flush=True)
    time.sleep(_WINDOW_SLEEP_S)


def _matrix_child(window: str, path: str, state_file: str) -> None:
    """``chip_smoke.py --matrix-child WINDOW PATH STATE_FILE``: a fresh
    interpreter loads the flagship's train state onto the card (batching
    off: one blob per tensor) and takes it, lingering in ``window`` after
    printing MARK. ``staging`` lingers right after the first device-to-host
    copy into a pinned buffer is enqueued on its side stream;
    ``residual_io`` async_takes, trains the flagship on the flash kernel
    (the state changes in place) while the slowed drain runs, then
    lingers; ``metadata``, ``durable`` and ``journal`` linger in the
    metadata writer (after a partial flushed temp write), in the durable
    flush of the created directories and in the journal write."""
    import asyncio

    import torch

    import tpusnap_torch.io_preparers.array as arr_mod
    import tpusnap_torch.lifecycle as lc_mod
    import tpusnap_torch.snapshot as snap_mod
    import tpusnap_torch.storage_plugins.fs as fs_mod
    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.models import TransformerConfig
    from tpusnap_torch.ops import flash_attention as fa

    torch.cuda.set_device(0)
    if window == "staging":
        orig_enqueue, fired = arr_mod.enqueue_dtoh, []

        def hooked_enqueue(*args, **kwargs):
            out = orig_enqueue(*args, **kwargs)
            if not fired:
                fired.append(True)
                _mark_and_linger()
            return out

        arr_mod.enqueue_dtoh = hooked_enqueue
    elif window == "residual_io":
        orig_write = fs_mod.FSStoragePlugin.write

        async def slow_write(self, write_io):
            await asyncio.sleep(_RESIDUAL_WRITE_DELAY_S)
            await orig_write(self, write_io)

        fs_mod.FSStoragePlugin.write = slow_write
        os.environ["TPUSNAP_ASYNC_STAGE_WINDOW_BYTES"] = str(_RESIDUAL_WINDOW_BYTES)
    elif window == "metadata":
        orig_meta = snap_mod._write_metadata

        def hooked_meta(storage, metadata, event_loop):
            tmp = os.path.join(path, ".snapshot_metadata.crashtmp")
            with open(tmp, "wb") as f:
                f.write(b"{" + b"x" * 100)
                f.flush()
                os.fsync(f.fileno())
            _mark_and_linger()
            os.unlink(tmp)
            return orig_meta(storage, metadata, event_loop)

        snap_mod._write_metadata = hooked_meta
    elif window == "durable":
        os.environ["TPUSNAP_DURABLE_COMMIT"] = "1"
        orig_flush = fs_mod.FSStoragePlugin.flush_created_dirs

        async def hooked_flush(self):
            _mark_and_linger()
            return await orig_flush(self)

        fs_mod.FSStoragePlugin.flush_created_dirs = hooked_flush
    elif window == "journal":
        orig_journal = lc_mod.write_journal

        def hooked_journal(storage, event_loop, journal):
            _mark_and_linger()
            return orig_journal(storage, event_loop, journal)

        lc_mod.write_journal = hooked_journal
    else:
        raise SystemExit(f"unknown window {window}")
    cfg = TransformerConfig()
    model = _model_from(cfg, state_file)
    state = {"train": StateDict(**model.train_state())}
    if window != "residual_io":
        torch.cuda.synchronize()
        Snapshot.take(path, state)
        raise SystemExit("the take finished before the kill")
    tokens = _tokens(cfg, 8, SEED + 11)
    torch.autograd.grad(model.loss(tokens), list(model.parameters()))  # warm-up: no update
    witness = dict(_leaves(model.train_state()))["params/embed"].clone()
    torch.cuda.synchronize()
    pending = Snapshot.async_take(path, state)
    _reset_launches()  # the path: the steps during the drain
    for _ in range(_RESIDUAL_STEPS):
        model.train_step(tokens, learning_rate=1e-3)
    torch.cuda.synchronize()
    stepped = not torch.equal(dict(_leaves(model.train_state()))["params/embed"], witness)
    print("FLASH " + json.dumps({"launches": fa.launches, "routes": dict(fa.route_launches),
                                 "stepped": stepped}), flush=True)
    _mark_and_linger()
    pending.wait()
    raise SystemExit("the async take finished before the kill")


def _delta_matrix_child(window: str, root: str, seed: str) -> None:
    """``chip_smoke.py --delta-matrix-child WINDOW ROOT SEED``: a stream of
    the CUDA tensor ``w = pattern(seed) + k`` micro-committed at steps 1..7,
    lingering inside a micro-commit's blob write (after one delta has
    committed), between two commits (after step 3) or as chain compaction
    (max_chain 2) starts to materialize."""
    import torch

    import tpusnap_torch.inspect as inspect_mod
    import tpusnap_torch.storage_plugins.fs as fs_mod
    from tpusnap_torch import Snapshot, StateDict

    torch.cuda.set_device(0)
    if window == "delta_micro":
        orig_write, fired = fs_mod.FSStoragePlugin.write, []

        async def hooked(self, write_io):
            root_s = getattr(self, "root", "")
            if (not fired and "delta-0000" in root_s and not root_s.endswith("delta-000001")
                    and not write_io.path.startswith(".tpusnap")):
                fired.append(True)
                _mark_and_linger()
            await orig_write(self, write_io)

        fs_mod.FSStoragePlugin.write = hooked
    elif window == "delta_compact":
        orig_mat = inspect_mod.materialize_snapshot

        def hooked_mat(*args, **kwargs):
            _mark_and_linger()
            return orig_mat(*args, **kwargs)

        inspect_mod.materialize_snapshot = hooked_mat
    elif window != "delta_between":
        raise SystemExit(f"unknown window {window}")
    pattern = _delta_pattern(int(seed))
    state = {"app": StateDict(w=pattern.clone(), step=0)}
    stream = Snapshot.stream(root, state, cadence_s=3600,
                             max_chain=2 if window == "delta_compact" else 100)
    for k in range(1, 8):
        state["app"]["w"] = pattern + float(k)
        state["app"]["step"] = k
        stream.commit_now()
        print(f"COMMIT {stream.seq} {k}", flush=True)
        if window == "delta_between" and k == 3:
            _mark_and_linger()
    raise SystemExit("the stream finished before the kill")


def _delta_pattern(seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(_DELTA_SHAPE, generator=gen, device="cuda")


def _kill_in_window(argv: list, seed: int, jitter_max_s: float) -> dict:
    """Start ``chip_smoke.py ARGV`` in its own process group, wait for its
    MARK (select with a deadline), SIGKILL the group after the seeded
    jitter; its output, the jitter and the seconds."""
    import random
    import select
    import signal

    env = dict(os.environ, **_MATRIX_ENV)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *argv], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True,
    )
    try:
        buf, eof = "", False
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline and "MARK" not in buf and not eof:
            ready, _, _ = select.select([proc.stdout], [], [], 0.5)
            if ready:
                chunk = os.read(proc.stdout.fileno(), 65536).decode("utf-8", errors="replace")
                eof = chunk == ""
                buf += chunk
        if "MARK" not in buf:
            raise AssertionError(f"{argv[:2]} never reached its window (eof={eof}, "
                                 f"exit {proc.poll()}):\n{buf[-3000:]}")
        jitter = random.Random(seed).uniform(0.0, jitter_max_s)
        time.sleep(jitter)
        os.killpg(proc.pid, signal.SIGKILL)
        rest, _ = proc.communicate(timeout=60)
        return {"out": buf + rest, "jitter_s": jitter, "rc": proc.returncode,
                "child_s": time.perf_counter() - t0}
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def _cli_rc(argv: list) -> tuple:
    """``python -m tpusnap_torch ARGV`` in process: (exit code, stdout)."""
    from tpusnap_torch.__main__ import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        rc = cli_main(argv)
    return rc, buf.getvalue()


def _matrix_verdict(path: str, want: dict, fresh, window: str, jitter: float) -> dict:
    """The invariant after a kill: .snapshot_metadata exists iff the
    snapshot restores bit-exact into CUDA targets and verify is clean;
    fsck says committed, torn (journal present; timeline then names what
    the killed take was doing) or empty/foreign."""
    import torch

    from tpusnap_torch import Snapshot, StateDict, fsck_snapshot, verify_snapshot

    t0 = time.perf_counter()
    report = fsck_snapshot(path)
    out = {"fsck": report.state}
    if os.path.exists(os.path.join(path, ".snapshot_metadata")):
        if report.state != "committed" or report.missing_referenced:
            raise AssertionError(f"{window}: committed but fsck says {report.summary()}")
        with torch.no_grad():
            for _, t in _leaves(fresh.train_state()):
                t.zero_()
        Snapshot(path).restore({"train": StateDict(**fresh.train_state())})
        for p, got in _leaves(fresh.train_state()):
            if not got.is_cuda or not torch.equal(got, want[p]):
                raise AssertionError(f"{window}: committed, but {p} is not the state taken")
        if not verify_snapshot(path).clean:
            raise AssertionError(f"{window}: committed, but verify is not clean")
        out.update(outcome="committed", bit_exact=True)
    else:
        try:
            Snapshot(path).metadata
        except RuntimeError as e:
            if "not a snapshot" not in str(e):
                raise
        else:
            raise AssertionError(f"{window}: no metadata, yet the snapshot opens")
        if os.path.exists(os.path.join(path, ".tpusnap", "journal")):
            if report.state != "torn":
                raise AssertionError(f"{window}: journal present, fsck says {report.summary()}")
            rc, text = _cli_rc(["timeline", path, "--json"])
            out["timeline_rc"] = rc
            if window == "journal":
                if rc not in (3, 4):
                    raise AssertionError(f"journal: timeline exit {rc}")
            else:
                r0 = (((json.loads(text) if text.strip() else {}).get("verdict") or {})
                      .get("ranks") or {}).get("0") or {}
                if rc != 4 or r0.get("phase") is None or r0.get("last_event") is None:
                    raise AssertionError(f"{window}: timeline exit {rc}, rank 0 {r0}")
                if window == "staging" and jitter >= 0.15 and not (
                        r0.get("inflight_op") and (r0.get("bytes_planned") or 0) > 0):
                    raise AssertionError(f"staging: timeline names no in-flight op: {r0}")
                out["timeline_phase"] = r0.get("phase")
        elif report.state not in ("empty", "foreign"):
            raise AssertionError(f"{window}: no journal, fsck says {report.summary()}")
        out.update(outcome="torn" if report.state == "torn" else report.state, bit_exact=None)
    out["check_s"] = time.perf_counter() - t0
    return out


def _delta_verdict(root: str, kill: dict, window: str) -> dict:
    """The chain's contract after a kill: the head restores into a CUDA
    target as the last committed step bit for bit (never older than the
    last printed commit), fsck names every member, a torn tail is torn and
    keeps its chain membership, and ``fsck ROOT`` exits 4 with a torn tail,
    0 without."""
    import re

    import torch

    from tpusnap_torch import Snapshot, StateDict, fsck_snapshot, resolve_chain, verify_snapshot

    t0 = time.perf_counter()
    printed = [int(m.group(2)) for m in re.finditer(r"COMMIT (\d+) (\d+)", kill["out"])]
    rep = resolve_chain(root)
    if rep.head is None:
        raise AssertionError(f"{window}: no head: {rep.summary()}")
    target = StateDict(w=torch.zeros(_DELTA_SHAPE, device="cuda"), step=-1)
    Snapshot(rep.head_path).restore({"app": target})
    k = target["step"]
    if k < (printed[-1] if printed else 0):
        raise AssertionError(f"{window}: restored step {k} < last printed {printed[-1]}")
    pattern = _delta_pattern(_DELTA_SEED)
    want = pattern + float(k) if k > 0 else pattern
    if not target["w"].is_cuda or not torch.equal(target["w"], want):
        raise AssertionError(f"{window}: the head is not step {k} bit for bit")
    if not verify_snapshot(rep.head_path).clean:
        raise AssertionError(f"{window}: the head does not verify clean")
    states = {}
    for name in sorted(os.listdir(root)):
        member = os.path.join(root, name)
        if os.path.isdir(member) and not name.startswith("."):
            states[name] = fsck_snapshot(member).state
    head = fsck_snapshot(rep.head_path)
    if head.state != "committed" or head.delta is None:
        raise AssertionError(f"{window}: head {head.summary()}")
    if rep.torn_tail:
        torn = fsck_snapshot(os.path.join(root, rep.torn_tail))
        if torn.state != "torn" or torn.delta is None or \
                "torn delta micro-commit" not in torn.summary():
            raise AssertionError(f"{window}: torn tail {torn.summary()}")
    rc, _ = _cli_rc(["fsck", root])
    if rc != (4 if rep.torn_tail else 0):
        raise AssertionError(f"{window}: fsck of the root exits {rc}")
    return {"outcome": "torn" if rep.torn_tail else "committed", "restored_step": k,
            "last_printed_step": printed[-1] if printed else 0, "bit_exact": True,
            "members": states, "fsck_root_rc": rc, "check_s": time.perf_counter() - t0}


def phase_crash_matrix(ctx: dict, workdir: str) -> dict:
    """tpusnap's commit-window crash matrix on the card: children load the
    flagship's train state onto the card and are SIGKILLed in each of the
    five commit windows at seeds 0 and 1 (the windows of one seed at once,
    each in its own process), then the delta stream in its three windows
    at seed 1. The parent holds each directory to the invariant. Nothing
    is caught: a broken invariant fails the run."""
    import torch

    from tpusnap_torch.models import Transformer

    t_phase = time.perf_counter()
    state_file = ctx["life_state_file"]
    want = {p: t.to("cuda") for p, t in torch.load(state_file).items()}
    fresh = Transformer(ctx["cfg"], device="cuda", seed=SEED + 13)
    runs, flash = [], {}
    for seed in _MATRIX_SEEDS:
        paths = {w: os.path.join(workdir, f"matrix_{w}_{seed}") for w in _MATRIX_WINDOWS}
        with ThreadPoolExecutor(max_workers=len(_MATRIX_WINDOWS)) as pool:
            kills = dict(zip(_MATRIX_WINDOWS, pool.map(
                lambda w: _kill_in_window(["--matrix-child", w, paths[w], state_file], seed, 1.5),
                _MATRIX_WINDOWS)))
        for window, kill in kills.items():
            row = {"window": window, "seed": seed, "jitter_s": kill["jitter_s"],
                   "child_s": kill["child_s"]}
            if kill["rc"] != -9:
                raise AssertionError(f"{window} child exited {kill['rc']}:\n{kill['out'][-3000:]}")
            if window == "residual_io":
                line = next(x for x in kill["out"].splitlines() if x.startswith("FLASH "))
                got = json.loads(line[len("FLASH "):])
                if not got["stepped"]:
                    raise AssertionError("residual_io: the steps did not change the state")
                row["flash_launches"] = got["launches"]
                flash[f"crash_matrix residual_io seed {seed}"] = (got["launches"], got["routes"])
            row.update(_matrix_verdict(paths[window], want, fresh, window, kill["jitter_s"]))
            runs.append(row)
            shutil.rmtree(paths[window], ignore_errors=True)  # a journal kill may leave none
    delta_runs = []
    roots = {w: os.path.join(workdir, f"matrix_{w}") for w in _DELTA_WINDOWS}
    with ThreadPoolExecutor(max_workers=len(_DELTA_WINDOWS)) as pool:
        kills = dict(zip(_DELTA_WINDOWS, pool.map(
            lambda w: _kill_in_window(["--delta-matrix-child", w, roots[w], str(_DELTA_SEED)],
                                      _DELTA_SEED, 0.8),
            _DELTA_WINDOWS)))
    for window, kill in kills.items():
        if kill["rc"] != -9:
            raise AssertionError(f"{window} child exited {kill['rc']}:\n{kill['out'][-3000:]}")
        row = {"window": window, "seed": _DELTA_SEED, "jitter_s": kill["jitter_s"],
               "child_s": kill["child_s"]}
        row.update(_delta_verdict(roots[window], kill, window))
        delta_runs.append(row)
        shutil.rmtree(roots[window])
    del fresh, want
    ctx["matrix_flash"] = flash
    outcomes = collections.Counter(r["outcome"] for r in runs + delta_runs)
    return {"phase": "crash_matrix", "runs": runs, "delta_runs": delta_runs,
            "outcomes": dict(outcomes), "seconds": time.perf_counter() - t_phase,
            "card": ctx["card"]}


def phase_chaos(ctx: dict, workdir: str) -> dict:
    """The train state through ``chaos+fs://`` under a seeded plan of
    transient errors (one per op and every 5th), latency and torn
    writes, batching off (one blob per tensor): take and restore converge
    under retry; the restore lands as many reads in place as a plain
    path's restore of the same snapshot; then an async take under chaos
    with a step at once."""
    import torch

    import tpusnap_torch.storage_plugins.fs as fs_mod
    from tpusnap_torch import Snapshot, StateDict, telemetry
    from tpusnap_torch.knobs import override_batching_disabled
    from tpusnap_torch.models import Transformer

    t_phase = time.perf_counter()
    # One warning per retried op would bury the run's output: the retries
    # are counted instead.
    logging.getLogger("tpusnap_torch.retry").setLevel(logging.ERROR)
    cfg, model = ctx["cfg"], ctx["life_model"]
    opts = {"fault_plan": "seed=5,transient_per_op=1,transient_every=5,latency_ms=1,torn_writes=1",
            "retry_backoff_base_sec": 0.02, "retry_backoff_cap_sec": 0.2}
    path = os.path.join(workdir, "chaos")
    url = "chaos+fs://" + path
    counters = ("retry.attempts", "retry.recovered", "faults.injected.write", "faults.injected.read")
    c0 = {k: telemetry.counter_value(k) for k in counters}
    want = _clone_state(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with override_batching_disabled(True):
        Snapshot.take(url, {"train": StateDict(**model.train_state())}, storage_options=opts)
    take_s = time.perf_counter() - t0
    reads = {}
    orig_read = fs_mod.FSStoragePlugin.read
    fresh = Transformer(cfg, device="cuda", seed=SEED + 1)
    for label, where, o in (("chaos", url, opts), ("plain", path, None)):
        seen = reads[label] = {"reads": 0, "in_place": 0}

        async def read(plugin, read_io, seen=seen):
            await orig_read(plugin, read_io)
            seen["reads"] += 1
            seen["in_place"] += bool(read_io.in_place)

        fs_mod.FSStoragePlugin.read = read
        try:
            with torch.no_grad():
                for _, t in _leaves(fresh.train_state()):
                    t.zero_()
            t0 = time.perf_counter()
            Snapshot(where, storage_options=o).restore({"train": StateDict(**fresh.train_state())})
            seen["restore_s"] = time.perf_counter() - t0
        finally:
            fs_mod.FSStoragePlugin.read = orig_read
        for p, got in _leaves(fresh.train_state()):
            if not torch.equal(got, want[p]):
                raise AssertionError(f"chaos ({label} restore): {p} differs")
    if not reads["chaos"]["in_place"] or reads["chaos"]["in_place"] != reads["plain"]["in_place"]:
        raise AssertionError(f"chaos: in-place reads not kept: {reads}")
    if not Snapshot(url, storage_options=opts).verify().clean:
        raise AssertionError("chaos: verify() is not clean")
    counts = {k: telemetry.counter_value(k) - v for k, v in c0.items()}
    if not counts["retry.attempts"] or not counts["faults.injected.read"]:
        raise AssertionError(f"chaos: the plan injected nothing: {counts}")

    # Async take under chaos with a train step at once.
    path_a = path + "_async"
    want_a = _clone_state(model)
    pending = Snapshot.async_take("chaos+fs://" + path_a, {"train": StateDict(**model.train_state())},
                                  storage_options=opts)
    model.train_step(ctx["tokens"], learning_rate=1e-3)
    pending.wait()
    witness = Transformer(cfg, device="cuda", seed=SEED + 2)
    async_loss = _check_restore(path_a, want_a, fresh, witness, _tokens(cfg, 8, SEED + 3))
    del fresh, witness
    for p in (path, path_a):
        shutil.rmtree(p)
    return {"phase": "chaos", "plan": opts["fault_plan"], "take_s": take_s, "counters": counts,
            "restores": reads, "async_post_restore_loss": async_loss,
            "seconds": time.perf_counter() - t_phase, "bit_exact": True, "card": ctx["card"]}


_LIVE_LINE = "liveness_rank "


def _die_at(window: str, marker: str) -> None:
    """Install rank 1's kill point for ``window`` (a hook in its own
    process): the first stage, the first blob write, or the first commit
    barrier of the take."""
    import tpusnap_torch.snapshot as snap_mod
    import tpusnap_torch.storage_plugins.fs as fs_mod
    from tpusnap_torch import scheduler
    from tpusnap_torch.comm import StoreComm

    def die():
        with open(marker, "w") as f:
            f.write(repr(time.time()))
        os.kill(os.getpid(), 9)

    if window == "stage":
        async def stage(pipeline, executor):
            die()

        scheduler._WritePipeline.stage = stage
    elif window == "write":
        orig_write = fs_mod.FSStoragePlugin.write

        async def write(plugin, write_io):
            await orig_write(plugin, write_io)
            if not write_io.path.startswith(".tpusnap/"):
                die()

        fs_mod.FSStoragePlugin.write = write
    elif window == "commit":
        orig_commit, orig_barrier = snap_mod._commit, StoreComm.barrier
        in_commit = []

        def commit(*a, **k):
            in_commit.append(True)
            return orig_commit(*a, **k)

        def barrier(self):
            if in_commit:
                die()
            return orig_barrier(self)

        snap_mod._commit, StoreComm.barrier = commit, barrier
    else:
        raise AssertionError(window)


def _liveness_rank(ldir: str, window: str, state_file: str) -> None:
    """One rank of a liveness world: rank 1 is SIGKILLed in ``window``;
    rank 0 must raise RankFailedError naming it within 3x the TTL, the
    merged flight timeline names it, the directory is torn."""
    from tpusnap_torch import RankFailedError, Snapshot, StateDict, fsck_snapshot
    from tpusnap_torch.flight import load_flight_logs, merge_timeline, postmortem_verdict
    from tpusnap_torch.models import TransformerConfig

    comm = _rank_comm("liveness")
    model = _model_from(TransformerConfig(), state_file)
    path = os.path.join(ldir, window)
    marker = os.path.join(ldir, f"{window}.killed_at")
    if comm.rank == 1:
        _die_at(window, marker)
    try:
        Snapshot.take(path, {"train": StateDict(**model.train_state())}, replicated=["**"])
    except RankFailedError as e:
        detect = time.time()
        with open(marker) as f:
            detect_s = detect - float(f.read())
        if e.ranks != [1]:
            raise AssertionError(f"RankFailedError named {e.ranks}")
        report = fsck_snapshot(path)
        logs = load_flight_logs(path, files=report.files)
        # The merged timeline's rank_dead events, by the rank they name
        # (``op`` is "rank<k>"; ``rank`` is the rank that logged it).
        named = sorted({ev.get("op") for ev in merge_timeline(logs) if ev.get("k") == "rank_dead"})
        verdict = postmortem_verdict(path, report.state, logs)
        print(_LIVE_LINE + json.dumps({
            "window": window, "detect_s": detect_s, "fsck": report.state,
            "salvage_records": report.salvage_records,
            "salvage_bytes_present": report.salvage_bytes_present,
            "timeline_rank_dead": named, "verdict_dead_ranks": verdict["dead_ranks"],
        }), flush=True)
        os._exit(0)  # the process group's exit barrier would wait on the dead peer
    raise AssertionError(f"rank {comm.rank} committed a take whose peer died at {window}")


def _run_worlds(fn, cases, args_of, env, line: str) -> dict:
    """Run one two-rank world per case, concurrently, each expected to end
    with rank 1 dead; returns rank 0's result line by case."""
    from tpusnap_torch.test_utils import run_subprocess_world

    def one(case):
        try:
            run_subprocess_world(fn, world_size=2, args=args_of(case), timeout=300,
                                 extra_env=env)
        except RuntimeError as e:
            text = str(e)
        else:
            raise AssertionError(f"{case}: rank 1 was not killed")
        if "ranks [1] failed" not in text:
            raise AssertionError(f"{case}: not only rank 1 failed:\n{text[-6000:]}")
        found = [ln for ln in text.splitlines() if ln.startswith(line)]
        if len(found) != 1:
            raise AssertionError(f"{case}: rank 0 printed no result:\n{text[-6000:]}")
        return json.loads(found[0][len(line):])

    with ThreadPoolExecutor(len(cases)) as pool:
        return dict(zip(cases, pool.map(one, cases)))


def phase_liveness(ctx: dict, workdir: str) -> dict:
    t_phase = time.perf_counter()
    ldir = os.path.join(workdir, "liveness")
    os.makedirs(ldir)
    windows = ["stage", "write", "commit"]
    # Batching off, as in the crash phase: slab blobs are named per take
    # and never journaled, so only standalone blobs are salvage evidence.
    env = dict(_LIFE_ENV, TPUSNAP_DISABLE_BATCHING="1")
    results = _run_worlds(_liveness_rank, windows,
                          lambda w: [ldir, w, ctx["life_state_file"]], env, _LIVE_LINE)
    for w, r in results.items():
        if r["detect_s"] > 3 * _LIFE_TTL_S:
            raise AssertionError(f"{w}: detection took {r['detect_s']} s > 3x TTL")
        if r["fsck"] != "torn" or "rank1" not in r["timeline_rank_dead"] \
                or 1 not in r["verdict_dead_ranks"] or not r["salvage_records"]:
            raise AssertionError(f"{w}: {r}")
    shutil.rmtree(ldir)
    return {"phase": "liveness", "ttl_s": _LIFE_TTL_S, "windows": results,
            "detect_s": {w: r["detect_s"] for w, r in results.items()},
            "seconds": time.perf_counter() - t_phase, "card": ctx["card"]}


_DEGRADE_LINE = "degrade_rank "


def _degrade_rank(ddir: str, case: str, state_file: str) -> None:
    """One rank of a degrade world (TPUSNAP_RANK_FAILURE=degrade, every
    value replicated): ``sync`` — rank 1 is killed by its fault plan
    after its first blob write and rank 0 adopts its units and commits;
    ``async`` — rank 1 stops on its first blob write (a wedge), rank 0
    runs a train step in place right after the call, then SIGKILLs rank
    1, and the degraded snapshot must hold the state at the call;
    ``dtensor`` — Shard(0) DTensor views: the take must refuse to degrade
    and abort to a torn directory."""
    import torch

    from tpusnap_torch import RankFailedError, Snapshot, StateDict, fsck_snapshot, telemetry
    from tpusnap_torch.models import Transformer, TransformerConfig
    from tpusnap_torch.ops import flash_attention as fa
    from tpusnap_torch.test_utils import world_mesh

    comm = _rank_comm("degrade")
    pids = comm.all_gather_object(os.getpid())
    cfg = TransformerConfig()
    model = _model_from(cfg, state_file)
    url = "chaos+fs://" + os.path.join(ddir, case)
    path = url.split("://", 1)[1]
    out = {"case": case}
    if case == "dtensor":
        views = _sharded_views(model, world_mesh("cuda"))
        try:
            Snapshot.take(url, {"train": views},
                          storage_options={"fault_plan": "rank=1,crash_after_op=write:1"})
        except RankFailedError as e:
            if "degrade refused" not in str(e):
                raise
            out.update(error=str(e)[:200], fsck=fsck_snapshot(path).state)
            if out["fsck"] != "torn":
                raise AssertionError(f"dtensor: fsck says {out['fsck']}")
            print(_DEGRADE_LINE + json.dumps(out), flush=True)
            os._exit(0)
        raise AssertionError("a sharded take whose peer died committed")
    want = _clone_state(model)
    a0 = telemetry.counter_value("degraded.adopted_bytes")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if case == "sync":
        snap = Snapshot.take(url, {"train": StateDict(**model.train_state())}, replicated=["**"],
                             storage_options={"fault_plan": "rank=1,crash_after_op=write:1"})
    else:
        pending = Snapshot.async_take(url, {"train": StateDict(**model.train_state())},
                                      replicated=["**"],
                                      storage_options={"fault_plan": "rank=1,wedge=write:1"})
        if comm.rank == 1:
            pending.wait()
            raise AssertionError("rank 1 committed through its wedge")
        model.train_step(_tokens(cfg, 8, SEED), learning_rate=1e-3)  # in place, at once
        torch.cuda.synchronize()
        os.kill(pids[1], 9)
        snap = pending.wait()
    out["take_s"] = time.perf_counter() - t0
    deg = (snap.metadata.extras or {}).get("degraded")
    if not deg or deg["dead_ranks"] != [1] or not deg["adopted_units"]:
        raise AssertionError(f"{case}: extras['degraded'] = {deg}")
    out["adopted_bytes"] = telemetry.counter_value("degraded.adopted_bytes") - a0
    out["adopted_units"] = len(deg["adopted_units"])
    fresh = Transformer(cfg, device="cuda", seed=SEED + 1)
    witness = Transformer(cfg, device="cuda", seed=SEED + 2)
    out["restore_s"], out["post_restore_loss"] = _restore_and_check(
        path, want, fresh, witness, _tokens(cfg, 8, SEED + 3))
    out["fsck_summary"] = fsck_snapshot(path).summary()[-160:]
    out["flash_launches"], out["flash_routes"] = fa.launches, dict(fa.route_launches)
    print(_DEGRADE_LINE + json.dumps(out), flush=True)
    os._exit(0)


def phase_degrade(ctx: dict, workdir: str) -> dict:
    t_phase = time.perf_counter()
    ddir = os.path.join(workdir, "degrade")
    os.makedirs(ddir)
    env = dict(_LIFE_ENV, TPUSNAP_RANK_FAILURE="degrade")
    cases = ["sync", "async", "dtensor"]
    results = _run_worlds(_degrade_rank, cases, lambda c: [ddir, c, ctx["life_state_file"]],
                          env, _DEGRADE_LINE)
    for c in ("sync", "async"):
        if results[c]["adopted_bytes"] <= 0 or "DEGRADED" not in results[c]["fsck_summary"]:
            raise AssertionError(f"{c}: {results[c]}")
    shutil.rmtree(ddir)
    return {"phase": "degrade", "cases": results,
            "adopted_bytes": {c: results[c]["adopted_bytes"] for c in ("sync", "async")},
            "seconds": time.perf_counter() - t_phase, "bit_exact": True, "card": ctx["card"]}


def phase_lifecycle_ab(ctx: dict, workdir: str) -> dict:
    """What the default layers cost (printed, not gated): the bulk take
    and the train state's take and restore with tpusnap's defaults
    against TPUSNAP_DISABLE_JOURNAL=1 TPUSNAP_TELEMETRY=0, compression off,
    after one warm-up round, three of each in turns (default, off, off,
    default, default, off); medians beside the runs."""
    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.knobs import (
        override_compress,
        override_journal_disabled,
        override_telemetry_enabled,
    )
    from tpusnap_torch.models import Transformer

    model = ctx["life_model"]
    bulk = _bulk_tensors()
    fresh = Transformer(ctx["cfg"], device="cuda", seed=SEED + 1)
    times = {"default": collections.defaultdict(list), "off": collections.defaultdict(list)}
    order = ["warmup", "default", "off", "off", "default", "default", "off"]
    for i, label in enumerate(order):
        off = label == "off"
        with override_journal_disabled(off), override_telemetry_enabled(not off), \
                override_compress(mode="off"):
            for name, state in (("bulk", {"bulk": StateDict(bulk)}),
                                ("train", {"train": StateDict(**model.train_state())})):
                path = os.path.join(workdir, f"ab_{name}_{i}")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                Snapshot.take(path, state)
                take_s = time.perf_counter() - t0
                restore_s = None
                if name == "train":
                    t0 = time.perf_counter()
                    Snapshot(path).restore({"train": StateDict(**fresh.train_state())})
                    restore_s = time.perf_counter() - t0
                shutil.rmtree(path)
                if label != "warmup":
                    times[label][f"{name}_take_s"].append(take_s)
                    if restore_s is not None:
                        times[label]["train_restore_s"].append(restore_s)
    del bulk, fresh
    medians = {label: {k: statistics.median(v) for k, v in t.items()} for label, t in times.items()}
    return {"phase": "lifecycle_ab", "off": "TPUSNAP_DISABLE_JOURNAL=1 TPUSNAP_TELEMETRY=0",
            "times": {k: dict(v) for k, v in times.items()}, "medians": medians,
            "card": ctx["card"]}


# ------------------------------------------------------------------- A8b


def _members_of(root: str) -> list:
    """(name, path, metadata) of every committed member under a stream
    root, oldest first."""
    from tpusnap_torch.delta import resolve_chain
    from tpusnap_torch.inspect import load_snapshot_metadata

    rep = resolve_chain(root)
    return [(m.name, os.path.join(root, m.name), load_snapshot_metadata(os.path.join(root, m.name)))
            for m in sorted(rep.members, key=lambda m: (m.seq or 0)) if m.state == "committed"]


def _restore_member(path: str, fresh) -> dict:
    """``path`` restored into ``fresh`` in place; its train state by path."""
    from tpusnap_torch import Snapshot, StateDict

    Snapshot(path).restore({"train": StateDict(**fresh.train_state())})
    return dict(_leaves(fresh.train_state()))


def _timed_steps(model, tokens, n: int, pace_s: float = 0.0, after=None) -> list:
    """``n`` train steps, each timed until the training stream has run it
    (not the whole device: a capture's copies on side streams are not the
    step's); ``after(i)`` runs after step ``i`` (outside the timing); the
    loop sleeps to ``pace_s`` a step."""
    import torch

    times = []
    for i in range(n):
        t0 = time.perf_counter()
        model.train_step(tokens, learning_rate=1e-3)
        torch.cuda.current_stream().synchronize()
        times.append(time.perf_counter() - t0)
        if after is not None:
            after(i)
        rest = pace_s - (time.perf_counter() - t0)
        if rest > 0:
            time.sleep(rest)
    return times


_DELTA_STEPS = 12
# Each training step is paced to this many seconds (a step plus its data
# wait), so the 12 steps span several 0.5 s cadences.
_DELTA_PACE_S = 0.25


def _free_running(model, tokens, root: str, side) -> dict:
    """A stream with no mark_step while the model trains on ``side`` (or
    the default stream): every tensor of every member must equal that
    tensor at some step boundary."""
    import contextlib

    import torch

    from tpusnap_torch import Snapshot, StateDict

    seen = []  # a device clone of the state at each boundary, in stream order

    def note(_i=None):
        seen.append(_clone_state(model))

    scope = torch.cuda.stream(side) if side is not None else contextlib.nullcontext()
    with scope:
        note()
        stream = Snapshot.stream(root, {"train": StateDict(**model.train_state())}, cadence_s=0.5)
        step_s = _timed_steps(model, tokens, _DELTA_STEPS, _DELTA_PACE_S, after=note)
        stream.close(final_commit=False)
    stream.raise_if_failed()
    members = _members_of(root)
    if len(members) < 3:
        raise AssertionError(f"free-running stream committed only {len(members)} members")
    fresh = model.__class__(model.config, device="cuda", seed=SEED + 11)
    mixed = 0
    for name, path, _ in members:
        got = _restore_member(path, fresh)
        which = set()
        for p, t in got.items():
            at = [i for i, b in enumerate(seen) if torch.equal(t, b[p])]
            if not at:
                raise AssertionError(f"free-running {name}: {p} is at no step boundary")
            which.add(at[0])
        mixed += len(which) > 1
    del fresh, seen
    torch.cuda.empty_cache()
    return {"members": len(members), "members_mixing_boundaries": mixed,
            "step_s": step_s, "stream_commits": stream.stats["commits"]}


def phase_delta(ctx: dict, workdir: str) -> dict:
    """Snapshot.stream of the flagship's train state while it trains:
    mark_step captures at every due boundary, compaction past a chain of
    4, an unchanged and a one-row micro-commit, every member restored
    bit-exact to its boundary; then free-running streams on the default
    stream and under a side stream, blob grain."""
    import torch

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.knobs import override_compress, override_delta_max_chain
    from tpusnap_torch.models import Transformer
    from tpusnap_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    cfg = ctx["cfg"]
    model = Transformer(cfg, device="cuda", seed=SEED + 21)
    tokens = _tokens(cfg, 8, SEED + 21)
    state_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(model.train_state()))
    out = {"phase": "delta", "state_bytes": state_bytes,
           "tensors": len(list(_leaves(model.train_state())))}
    out["step_s_no_stream"] = _timed_steps(model, tokens, 5)
    root = os.path.join(workdir, "delta")
    # Optimizer step -> device clones of the state at that step (the
    # one-row change adds a second state at the last step).
    boundaries = collections.defaultdict(list)

    def keep(_i=None):
        boundaries[int(model.opt_state["step"])].append(_clone_state(model))

    blocked = []
    # Every member is restored into a fresh model once it is committed and
    # must be its boundary bit for bit: the optimizer's step counter names
    # it. The steps check after each step while the stream's worker
    # commits in the background; a compaction (which retires the
    # superseded members) first checks, on the worker, any member the
    # steps have not reached yet.
    fresh = Transformer(cfg, device="cuda", seed=SEED + 22)
    checked = {}
    check_lock = threading.Lock()

    def check_members():
        from tpusnap_torch.delta import resolve_chain

        with check_lock:
            for m in resolve_chain(root).members:
                if m.state != "committed" or m.name in checked:
                    continue
                got = _restore_member(os.path.join(root, m.name), fresh)
                step = int(got["opt/step"])
                if not any(all(torch.equal(t, want[p]) for p, t in got.items())
                           for want in boundaries[step]):
                    raise AssertionError(f"delta member {m.name} is not the state at step {step}")
                checked[m.name] = {"name": m.name, "step": step,
                                   "payload_bytes": m.payload_bytes, "state_bytes": state_bytes}

    with override_compress(mode="off"), override_delta_max_chain(4):
        keep()
        t0 = time.perf_counter()
        stream = Snapshot.stream(root, {"train": StateDict(**model.train_state())}, cadence_s=0.5)
        out["base_s"] = time.perf_counter() - t0
        compact = stream._compact

        def checked_compact(head_snap):
            check_members()
            compact(head_snap)

        stream._compact = checked_compact

        def mark(i):
            keep()
            n = stream.stats["mark_step_captures"]
            t0 = time.perf_counter()
            stream.mark_step()
            if stream.stats["mark_step_captures"] > n:
                blocked.append({"step": int(model.opt_state["step"]),
                                "mark_step_s": time.perf_counter() - t0,
                                "capture_blocked_s": stream.stats["last_capture_blocked_s"]})
            check_members()

        out["step_s_streaming"] = _timed_steps(model, tokens, _DELTA_STEPS, _DELTA_PACE_S, mark)
        out["captures"] = blocked
        if len(blocked) < 2:
            raise AssertionError(f"only {len(blocked)} mark_step captures in {_DELTA_STEPS} steps")
        # The payload a commit wrote is read from the stream's own count:
        # a compaction at that commit materializes the member afterwards.
        stream.commit_now()  # catches up with the steps since the last capture
        check_members()
        stream.commit_now()
        check_members()
        out["unchanged_commit_bytes"] = stream.stats["last_commit_bytes"]
        if out["unchanged_commit_bytes"] != 0:
            raise AssertionError(f"an unchanged micro-commit wrote {out['unchanged_commit_bytes']}")
        with torch.no_grad():
            model.embed[3].add_(1.0)
        keep()  # the one-row state: the step counter is unchanged
        tile = int(os.environ.get("TPUSNAP_TILE_CHECKSUM_BYTES", 16 << 20))
        row_limit = min(tile, model.embed.numel() * model.embed.element_size())
        stream.commit_now()
        check_members()
        out["one_row_commit_bytes"] = stream.stats["last_commit_bytes"]
        if not 0 < out["one_row_commit_bytes"] <= row_limit:
            raise AssertionError(
                f"a one-row change wrote {out['one_row_commit_bytes']} bytes (limit {row_limit})")
        stream.close(final_commit=False)
        stream.raise_if_failed()
    out["compactions"] = stream.stats["compactions"]
    out["max_chain"] = 4
    members = _members_of(root)
    out["members"] = [checked[name] for name in sorted(checked)]
    out["retired_by_compaction"] = sorted(set(checked) - {name for name, _, _ in members})
    if stream.stats["compactions"] < 1:
        raise AssertionError(f"no compaction past a chain of 4: {stream.stats}")
    if len(checked) != stream.stats["commits"]:
        raise AssertionError(f"checked {len(checked)} of {stream.stats['commits']} members")
    # One step from the head (the one-row state) and one from its clone.
    witness = Transformer(cfg, device="cuda", seed=SEED + 23)
    step = int(model.opt_state["step"])
    out["post_restore_loss"] = _check_restore(members[-1][1], boundaries[step][-1], fresh,
                                              witness, _tokens(cfg, 8, SEED + 24))
    del fresh, witness, boundaries
    torch.cuda.empty_cache()
    out["free_running"] = {
        "default_stream": _free_running(model, tokens, os.path.join(workdir, "delta_free"), None),
        "side_stream": _free_running(model, tokens, os.path.join(workdir, "delta_side"),
                                     torch.cuda.Stream()),
    }
    out["flash_launches"] = fa.launches
    shutil.rmtree(workdir + "/delta", ignore_errors=True)
    out.update(seconds=time.perf_counter() - t_phase, bit_exact=True, card=ctx["card"])
    return out


_ELASTIC_LINE = "delta_elastic_rank "


def _delta_elastic_rank(edir: str, state_file: str) -> None:
    """One rank of the elastic stream: the flagship's train state as a
    full replica on each rank, ``replicated=["**"]``; one clean two-rank
    epoch, then rank 1 is SIGKILLed at its first blob write of the next
    epoch; rank 0 finishes that epoch degraded and streams on alone; the
    head restores bit for bit."""
    import torch

    import tpusnap_torch.storage_plugins.fs as fs_mod
    from tpusnap_torch import Snapshot, StateDict, telemetry
    from tpusnap_torch.delta import resolve_chain
    from tpusnap_torch.models import Transformer, TransformerConfig

    comm = _rank_comm("delta_elastic")
    cfg = TransformerConfig()
    model = _model_from(cfg, state_file)
    root = os.path.join(edir, "stream")
    marker = os.path.join(edir, "killed_at")
    armed = [False]
    if comm.rank == 1:
        orig_write = fs_mod.FSStoragePlugin.write

        async def write(plugin, write_io):
            await orig_write(plugin, write_io)
            if armed[0] and not write_io.path.startswith(".tpusnap/"):
                with open(marker, "w") as f:
                    f.write(repr(time.time()))
                os.kill(os.getpid(), 9)

        fs_mod.FSStoragePlugin.write = write

    def wait(pred, what, limit=240.0):
        t0 = time.monotonic()
        while not pred():
            if time.monotonic() - t0 > limit:
                raise AssertionError(f"rank {comm.rank}: no {what} in {limit} s")
            time.sleep(0.02)

    stream = Snapshot.stream(root, {"train": StateDict(**model.train_state())},
                             cadence_s=0.5, replicated=["**"])
    wait(lambda: stream.stats["commits"] >= 2, "base and first epoch")
    # The same in-place change of every tensor on both replicas right
    # after a commit: the next epoch has blobs to write on both ranks.
    with torch.no_grad():
        for _, t in _leaves(model.train_state()):
            t.add_(1)
    torch.cuda.synchronize()
    armed[0] = True
    if comm.rank == 1:
        time.sleep(600)
        os._exit(3)  # the hooked write kills this process first
    a0 = telemetry.counter_value("degraded.adopted_bytes")
    wait(lambda: stream.stats["degraded_epochs"] >= 1, "degraded epoch")
    detected = time.time()
    after = stream.stats["commits"]
    wait(lambda: stream.stats["commits"] > after, "solo epoch")
    if stream.members != [0]:
        raise AssertionError(f"members after the death: {stream.members}")
    stream.close(final_commit=False)
    rep = resolve_chain(root)
    if not rep.head or rep.torn_tail:
        raise AssertionError(rep.summary())
    worlds = [{"member": m.name, "world": m.world, "degraded": bool(m.degraded)}
              for m in rep.members if m.state == "committed"]
    want = _clone_state(model)
    fresh = Transformer(cfg, device="cuda", seed=SEED + 31)
    got = _restore_member(rep.head_path, fresh)
    for p, t in got.items():
        if not torch.equal(t, want[p]):
            raise AssertionError(f"elastic head: {p} differs")
    with open(marker) as f:
        killed_at = float(f.read())
    print(_ELASTIC_LINE + json.dumps({
        "detect_s": detected - killed_at,
        "adopted_bytes": telemetry.counter_value("degraded.adopted_bytes") - a0,
        "worlds": worlds, "epochs": stream.stats["epochs"],
        "degraded_epochs": stream.stats["degraded_epochs"], "summary": rep.summary(),
        "bit_exact": True,
    }), flush=True)
    os._exit(0)  # the process group's exit barrier would wait on the dead peer


def phase_delta_elastic(ctx: dict, workdir: str) -> dict:
    t_phase = time.perf_counter()
    edir = os.path.join(workdir, "delta_elastic")
    os.makedirs(edir)
    env = dict(_LIFE_ENV, TPUSNAP_RANK_FAILURE="degrade", TPUSNAP_COMPRESS="off")
    result = _run_worlds(_delta_elastic_rank, ["replicated"],
                         lambda _c: [edir, ctx["life_state_file"]], env,
                         _ELASTIC_LINE)["replicated"]
    if result["adopted_bytes"] <= 0 or result["degraded_epochs"] < 1:
        raise AssertionError(f"delta_elastic: {result}")
    shutil.rmtree(edir)
    result.update(phase="delta_elastic", ttl_s=_LIFE_TTL_S,
                  seconds=time.perf_counter() - t_phase, card=ctx["card"])
    return result


def phase_tier(ctx: dict, workdir: str) -> dict:
    """The write-back tier (both tiers on the one local disk): the 4 GiB
    bulk taken through a tier whose remote is in an outage, beside a
    plain take; the drain converges once the outage ends; local eviction;
    a restore through the tier URL from the remote. Then the train state
    through the tier, and train steps while its drain runs."""
    import torch

    from tpusnap_torch import Snapshot, StateDict, faults, gc_snapshot, telemetry, tiering
    from tpusnap_torch.knobs import override_compress, override_tier_outage

    t_phase = time.perf_counter()
    out = {"phase": "tier", "disk": "local and remote tiers share one local disk"}
    bulk = _bulk_tensors()
    nbytes = sum(t.numel() * t.element_size() for t in bulk.values())
    plain = os.path.join(workdir, "tier_plain")
    with override_compress(mode="off"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Snapshot.take(plain, {"bulk": StateDict(bulk)})
        out["plain_take_s"] = time.perf_counter() - t0
    shutil.rmtree(plain)
    url = (f"tier+local={os.path.join(workdir, 'tier_local')}"
           f"+remote=chaos+fs://{os.path.join(workdir, 'tier_remote')}/bulk")
    spec = tiering.parse_tier_url(url)
    # Every remote op fails for the first 10 s of the drain: an outage.
    opts = {"fault_plan": faults.FaultPlan(outage=("*", 0.0, 10.0))}
    ep0 = telemetry.counter_value("tier.degraded_episodes")
    with override_compress(mode="off"), override_tier_outage(
            threshold=1, backoff_cap_s=0.5, op_deadline_s=0.5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Snapshot.take(url, {"bulk": StateDict(bulk)}, storage_options=opts)
        out["outage_take_s"] = time.perf_counter() - t0
        out["durability_after_take"] = tiering.tier_state_of_dir(spec.local_dir)["durability"]
        t0 = time.perf_counter()
        if not tiering.drain_manager().wait_idle(timeout=300):
            raise AssertionError("the tier drain did not finish")
        out["drain_s"] = time.perf_counter() - t0
    out["degraded_episodes"] = telemetry.counter_value("tier.degraded_episodes") - ep0
    st = tiering.tier_state_of_dir(spec.local_dir)
    if st["durability"] != "remote-durable" or st["lag_bytes"] != 0 or out["degraded_episodes"] < 1:
        raise AssertionError(f"tier: {st}, {out}")
    with override_tier_outage(local_retention_s=0):
        gc = gc_snapshot(spec.local_dir, dry_run=False, evict_local=True)
    out["evicted_bytes"] = gc.bytes_reclaimed
    if gc.errors or gc.bytes_reclaimed < nbytes:
        raise AssertionError(f"tier eviction reclaimed {gc.bytes_reclaimed} of {nbytes}")
    f0 = telemetry.counter_value("tier.remote_fallback_reads")
    targets = StateDict({k: torch.zeros_like(v) for k, v in bulk.items()})
    t0 = time.perf_counter()
    Snapshot(url).restore({"bulk": targets})
    out["evicted_restore_s"] = time.perf_counter() - t0
    out["remote_reads"] = telemetry.counter_value("tier.remote_fallback_reads") - f0
    for k, v in bulk.items():
        if not torch.equal(targets[k], v):
            raise AssertionError(f"tier: {k} differs after the restore from the remote")
    del bulk, targets
    out.update(bytes=nbytes, outage_over_plain=out["outage_take_s"] / out["plain_take_s"])

    model, tokens = ctx["life_model"], ctx["tokens"]
    out["step_s_no_drain"] = _timed_steps(model, tokens, 5)
    turl = (f"tier+local={os.path.join(workdir, 'tier_local')}"
            f"+remote=fs://{os.path.join(workdir, 'tier_remote')}/train")
    with override_compress(mode="off"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Snapshot.take(turl, {"train": StateDict(**model.train_state())})
        out["train_take_s"] = time.perf_counter() - t0
        out["step_s_during_drain"] = _timed_steps(model, tokens, 5)
        out["drain_busy_after_steps"] = not tiering.drain_manager().wait_idle(timeout=0)
        if not tiering.drain_manager().wait_idle(timeout=300):
            raise AssertionError("the train state's drain did not finish")
    if tiering.tier_state_of_dir(tiering.parse_tier_url(turl).local_dir)["durability"] \
            != "remote-durable":
        raise AssertionError("the train state's tier is not remote-durable")
    # The remote-durable train state stays for the cli phase.
    shutil.rmtree(spec.local_dir)
    shutil.rmtree(os.path.join(workdir, "tier_remote", "bulk"))
    ctx["cli_tier"] = tiering.parse_tier_url(turl).local_dir
    out.update(seconds=time.perf_counter() - t_phase, bit_exact=True, card=ctx["card"])
    return out


def phase_cas(ctx: dict, workdir: str) -> dict:
    """Two job ids take the same train state into two directories with
    one TPUSNAP_CAS_DIR (batching off: slab blobs are named per take and
    never dedup): the second publishes nothing; each restores into CUDA
    tensors in place; deleting one and collecting the store keeps the
    shared blobs. Also the cost of the publisher's check for a gc sweep
    in flight (one per CAS payload write), with no sweep running."""
    import asyncio

    import torch

    from tpusnap_torch import Snapshot, StateDict, telemetry
    from tpusnap_torch.cas import BLOBS_DIR, CASStore, gc_store
    from tpusnap_torch.knobs import (
        override_batching_disabled,
        override_cas,
        override_compress,
        override_job_id,
    )
    from tpusnap_torch.models import Transformer

    t_phase = time.perf_counter()
    model, cfg = ctx["life_model"], ctx["cfg"]
    state_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(model.train_state()))
    store = os.path.join(workdir, "cas_store")
    want = _clone_state(model)
    out = {"phase": "cas", "state_bytes": state_bytes, "jobs": {}}

    def store_bytes():
        d = os.path.join(store, BLOBS_DIR)
        return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))

    with override_cas(store), override_batching_disabled(True), override_compress(mode="off"):
        for job in ("job_a", "job_b"):
            b0 = telemetry.counter_value("cas.bytes_published")
            s0 = telemetry.counter_value("cas.dedup_bytes_saved")
            w0 = (telemetry.counter_value("cas.blobs_published")
                  + telemetry.counter_value("cas.ref_hits"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with override_job_id(job):
                Snapshot.take(os.path.join(workdir, job), {"train": StateDict(**model.train_state())})
            out["jobs"][job] = {
                "take_s": time.perf_counter() - t0,
                "bytes_published": telemetry.counter_value("cas.bytes_published") - b0,
                "dedup_bytes_saved": telemetry.counter_value("cas.dedup_bytes_saved") - s0,
                "payload_writes": telemetry.counter_value("cas.blobs_published")
                + telemetry.counter_value("cas.ref_hits") - w0,
            }
        if out["jobs"]["job_b"]["bytes_published"] != 0:
            raise AssertionError(f"the second job published bytes: {out['jobs']}")

        async def sweep_checks(n):
            probe = CASStore(store)
            t0 = time.perf_counter()
            for _ in range(n):
                await probe.wait_out_sweep(time.time())
            took = time.perf_counter() - t0
            await probe.plugin.close()
            return took

        out["sweep_check_us"] = 1e6 * asyncio.run(sweep_checks(1000)) / 1000
        out["store_bytes"] = store_bytes()
        out["twice_state_bytes"] = 2 * state_bytes
        # Once: at most the state's bytes (equal tensors share a blob).
        if not 0 < out["store_bytes"] <= state_bytes:
            raise AssertionError(f"the store holds {out['store_bytes']} bytes of {state_bytes}")
        fresh = Transformer(cfg, device="cuda", seed=SEED + 41)
        witness = Transformer(cfg, device="cuda", seed=SEED + 42)
        for job in ("job_a", "job_b"):
            out["jobs"][job]["post_restore_loss"] = _check_restore(
                os.path.join(workdir, job), want, fresh, witness, _tokens(cfg, 8, SEED + 43))
        shutil.rmtree(os.path.join(workdir, "job_a"))
        gc = gc_store(store, dry_run=False, grace_s=0.0)
        out["gc_swept"] = len(gc.reclaimed)
        if gc.errors or store_bytes() != out["store_bytes"]:
            raise AssertionError(f"gc_store swept shared blobs: {gc.reclaimed} {gc.errors}")
        _check_restore(os.path.join(workdir, "job_b"), want, fresh, witness,
                       _tokens(cfg, 8, SEED + 44))
    del fresh, witness
    # job_b and the store stay for the cli phase.
    ctx["cli_cas"] = (os.path.join(workdir, "job_b"), store)
    out.update(seconds=time.perf_counter() - t_phase, bit_exact=True, card=ctx["card"])
    return out


# ------------------------------------------------- observe and the CLI

_OBSERVE_TRAIN_TAKES = 3
_AB_ROUNDS = 3
# The history file's event shape (the keys every event carries, in
# tpusnap's ``history.event_from_summary``): tpusnap's ``load_history``
# reads a line it can parse as a JSON object whose ``kind`` is one of its
# kinds; the port writes the same lines (held to tpusnap's on the CPU).
_HISTORY_KEYS = {"v", "ts", "kind", "rank", "world_size", "wall_s", "bytes", "throughput_gbps"}


class _env:
    """Set environment knobs for a scope; restore the old values after."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _take_report(path: str, kind: str = "take", heatmap: bool = False) -> dict:
    """``analyze`` of one take (its persisted spans and rollup) or of the
    last restore of ``path``: seconds and share per category. With
    ``heatmap`` the readers' access ledgers join in, as the CLI's."""
    from tpusnap_torch import Snapshot, access
    from tpusnap_torch.__main__ import _heatmap_metadata
    from tpusnap_torch.analyze import analyze
    from tpusnap_torch.progress import load_restore_traces
    from tpusnap_torch.telemetry import rollup_summaries

    if kind == "take":
        docs = {}
        tdir = os.path.join(path, ".tpusnap", "telemetry")
        for f in os.listdir(tdir):
            if f.startswith("rank_") and f.endswith(".json"):
                doc = json.load(open(os.path.join(tdir, f)))
                docs[doc["summary"]["rank"]] = doc
        rollup = (Snapshot(path).metadata.extras or {}).get("telemetry")
    else:
        docs = load_restore_traces(path)
        rollup = rollup_summaries([d["summary"] for d in docs.values()])
    hm = None
    if heatmap:
        records = access.load_ledger_records(path)
        hm = access.compute_heatmap(records, _heatmap_metadata(path)) if records else None
    report = analyze(rollup, docs, kind=kind, heatmap=hm)
    att = report["attribution"]
    return {
        "wall_s": att["wall_s"],
        "bound_by": report["bound_by"],
        "attributed_s": att["attributed_s"],
        "attributed_pct": att["attributed_pct"],
        "busy_s": att["busy_s"],
        "unattributed_s": att["unattributed_s"],
        "coverage": att["coverage"],
        "check_failed": report["check_failed"],
    }


def phase_observe(ctx: dict, workdir: str) -> dict:
    """Every consumer of the take's telemetry on, the flagship training
    between takes: three sync takes and one async take of the train
    state, a take and a restore of the 4 GiB bulk, two restores of the
    train state in place and one read_object; then the hooks' A/B and
    an autotuned take."""
    import torch

    from tpusnap_torch import (
        Snapshot,
        StateDict,
        access,
        compress,
        fleet,
        history,
        record_slo_step,
        slo,
    )
    from tpusnap_torch.__main__ import _heatmap_metadata
    from tpusnap_torch.__main__ import main as cli_main
    from tpusnap_torch.metrics_export import parse_prometheus_textfile
    from tpusnap_torch.models import Transformer

    t_phase = time.perf_counter()
    cfg, tokens = ctx["cfg"], ctx["tokens"]
    root = os.path.join(workdir, "observe")
    tele, metrics, fdir = (os.path.join(workdir, d) for d in ("observe_tele", "observe_metrics",
                                                              "observe_fleet"))
    os.makedirs(root)
    job = "smoke-observe"
    knobs_on = dict(
        TPUSNAP_TELEMETRY_DIR=tele, TPUSNAP_HISTORY="1", TPUSNAP_METRICS_EXPORT="prom,jsonl",
        TPUSNAP_METRICS_DIR=metrics, TPUSNAP_SLO_RPO_S="3600", TPUSNAP_SLO_RTO_S="3600",
        TPUSNAP_FLEET_DIR=fdir, TPUSNAP_JOB_ID=job, TPUSNAP_ACCESS_LEDGER="1",
        TPUSNAP_PROBE="1", TPUSNAP_COMPRESS="off",
    )
    out = {"phase": "observe", "knobs": sorted(knobs_on)}
    slo.reset_tracker()
    fleet.reset_publisher()
    history._reset_process_state()
    compress._reset_ceilings()
    model = Transformer(cfg, device="cuda", seed=SEED + 51)
    state_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(model.train_state()))
    prom_path = os.path.join(metrics, f"tpusnap_{job}_rank0.prom")

    def step():
        model.train_step(tokens, learning_rate=1e-3)
        torch.cuda.synchronize()
        record_slo_step(state_bytes)  # every parameter and moment moved

    def gauges():
        fams = parse_prometheus_textfile(open(prom_path).read())
        return {name: next(iter(fams[name]["samples"].values()))
                for name in ("tpusnap_rpo_seconds", "tpusnap_data_at_risk_bytes")}

    with _env(**knobs_on):
        takes, train_paths = [], []
        for i in range(_OBSERVE_TRAIN_TAKES):
            step()
            step()
            at_risk = slo.tracker().data_at_risk_bytes()
            if at_risk != 2 * state_bytes:
                raise AssertionError(f"record_slo_step: {at_risk} at risk, not 2 steps' bytes")
            path = os.path.join(root, f"train_{i}")
            want = _clone_state(model)
            t0 = time.perf_counter()
            Snapshot.take(path, {"train": StateDict(**model.train_state())})
            takes.append(time.perf_counter() - t0)
            train_paths.append((path, want))
            g = gauges()
            if g["tpusnap_data_at_risk_bytes"] != 0 or g["tpusnap_rpo_seconds"] > takes[-1] + 1.0:
                raise AssertionError(f"the commit did not reset the SLO gauges: {g}")
        out["train_take_s"] = takes
        step()
        apath = os.path.join(root, "train_async")
        want_async = _clone_state(model)
        t0 = time.perf_counter()
        pending = Snapshot.async_take(apath, {"train": StateDict(**model.train_state())})
        out["async_blocked_s"] = time.perf_counter() - t0
        model.train_step(tokens, learning_rate=1e-3)  # in place, at once
        pending.wait()
        out["async_total_s"] = time.perf_counter() - t0
        bulk = _bulk_tensors()
        bulk_bytes = sum(t.numel() * t.element_size() for t in bulk.values())
        bpath = os.path.join(workdir, "observe_bulk")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Snapshot.take(bpath, {"bulk": StateDict(bulk)})
        out["bulk_take_s"] = time.perf_counter() - t0
        targets = StateDict({k: torch.zeros_like(v) for k, v in bulk.items()})
        t0 = time.perf_counter()
        Snapshot(bpath).restore({"bulk": targets})
        out["bulk_restore_s"] = time.perf_counter() - t0
        for k, v in bulk.items():
            if not torch.equal(targets[k], v):
                raise AssertionError(f"observe bulk: {k} differs after the restore")
        out["bulk_take"] = _take_report(bpath)
        out["bulk_restore"] = _take_report(bpath, "restore")
        del bulk, targets
        shutil.rmtree(bpath)
        # Two restores of the last sync take into the live model, in place.
        last, want = train_paths[-1]
        restore_s = []
        for _ in range(2):
            ids = {p: t.data_ptr() for p, t in _leaves(model.train_state())}
            target = StateDict(**model.train_state())
            t0 = time.perf_counter()
            Snapshot(last).restore({"train": target})
            restore_s.append(time.perf_counter() - t0)
            for p, t in _leaves(model.train_state()):
                if t.data_ptr() != ids[p] or not torch.equal(t, want[p]):
                    raise AssertionError(f"observe restore: {p} not in place or not bit-exact")
            step()
        out["train_restore_s"] = restore_s
        out["train_take"] = _take_report(last)
        out["train_restore"] = _take_report(last, "restore")
        first, want0 = train_paths[0]
        got = Snapshot(first).read_object("0/train/params/ln_f")
        if not torch.equal(got, want0["params/ln_f"].cpu()):
            raise AssertionError("observe read_object differs")

        # What the hooks left.
        events = history.load_history(os.path.join(tele, "history.jsonl"))
        kinds = collections.Counter(e["kind"] for e in events)
        n_takes, n_restores = _OBSERVE_TRAIN_TAKES + 2, 3
        if kinds != {"take": n_takes, "restore": n_restores}:
            raise AssertionError(f"history holds {dict(kinds)}, not {n_takes} takes and "
                                 f"{n_restores} restores")
        for e in events:
            if not _HISTORY_KEYS <= set(e) or e["v"] != 1 or e.get("job_id") != job:
                raise AssertionError(f"a history event lacks tpusnap's fields: {sorted(e)}")
        train_events = [e for e in events if e["kind"] == "take" and e["bytes"] == state_bytes]
        if len(train_events) != _OBSERVE_TRAIN_TAKES + 1:
            raise AssertionError(
                f"{len(train_events)} take events wrote exactly the state's {state_bytes} bytes")
        fams = parse_prometheus_textfile(open(prom_path).read())
        need = {"tpusnap_take_seconds", "tpusnap_restore_seconds", "tpusnap_takes_total",
                "tpusnap_rpo_seconds", "tpusnap_data_at_risk_bytes",
                "tpusnap_estimated_rto_seconds", "tpusnap_slo_breach",
                "tpusnap_roofline_fraction", "tpusnap_restore_roofline_fraction"}
        if not need <= set(fams):
            raise AssertionError(f"the textfile lacks {sorted(need - set(fams))}")
        jsonl = [json.loads(x) for x in open(os.path.join(metrics, "events.jsonl"))]
        if collections.Counter(e["kind"] for e in jsonl) != kinds:
            raise AssertionError("the JSONL sink's events differ from the history's")
        sidecar = json.load(open(os.path.join(tele, "slo", "rank_0.json")))
        record = json.load(open(os.path.join(fdir, f"{job}.json")))
        if sidecar["breach"] != {"rpo": False, "rto": False} or record["job_id"] != job:
            raise AssertionError(f"SLO sidecar {sidecar['breach']}, fleet record {record['job_id']}")
        coverage = {}
        for name, p in (("restore", last), ("read_object", first)):
            hm = access.compute_heatmap(access.load_ledger_records(p), _heatmap_metadata(p))
            coverage[name] = hm["coverage"]
        if coverage["restore"] != 1.0 or not 0 < coverage["read_object"] < 1:
            raise AssertionError(f"access coverage {coverage}")
        ceilings = compress.pipe_ceilings_snapshot()
        lanes = {lane: gbps for (_, lane), gbps in ceilings.items()}
        if not {"write", "read"} <= set(lanes):
            raise AssertionError(f"probe ceilings {ceilings}")
        probe_w = [e["probe_write_gbps"] for e in events if e.get("probe_write_gbps")]
        probe_r = [e["probe_read_gbps"] for e in events if e.get("probe_read_gbps")]
        est = slo.estimate_rto(state_bytes, events, backend="FSStoragePlugin")
        out.update(
            history={"takes": kinds["take"], "restores": kinds["restore"],
                     "events_per_jsonl": len(jsonl)},
            access_coverage=coverage,
            probe={"write_gbps": probe_w, "read_gbps": probe_r, "ceilings": lanes},
            estimate_rto={"ok": est.ok, "seconds": est.seconds, "read_gbps": est.read_gbps,
                          "n_baseline": est.n_baseline, "measured_restore_s": restore_s},
            slo_sidecar={k: sidecar[k] for k in ("rpo_s", "data_at_risk_bytes",
                                                 "snapshot_bytes", "estimated_rto_s")},
            fleet_record=sorted(record),
            state_bytes=state_bytes, bulk_bytes=bulk_bytes,
        )

    # The hooks' cost: every hook but the probe on, against all off,
    # interleaved, the same train state each time.
    hooks_on = dict(knobs_on, TPUSNAP_PROBE="0")
    hooks_off = dict(TPUSNAP_TELEMETRY_DIR=tele, TPUSNAP_HISTORY="0", TPUSNAP_METRICS_EXPORT=None,
                     TPUSNAP_METRICS_DIR=None, TPUSNAP_SLO_RPO_S=None, TPUSNAP_SLO_RTO_S=None,
                     TPUSNAP_FLEET_DIR=None, TPUSNAP_JOB_ID=job, TPUSNAP_ACCESS_LEDGER="0",
                     TPUSNAP_PROBE="0", TPUSNAP_COMPRESS="off")
    ab = {"on": [], "off": []}
    for i in range(_AB_ROUNDS):
        for arm, env in (("on", hooks_on), ("off", hooks_off)) if i % 2 == 0 else (
                ("off", hooks_off), ("on", hooks_on)):
            path = os.path.join(workdir, f"observe_ab_{arm}_{i}")
            with _env(**env):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                Snapshot.take(path, {"train": StateDict(**model.train_state())})
                ab[arm].append(time.perf_counter() - t0)
            shutil.rmtree(path)
    out["ab_take_s"] = ab
    out["ab_median_s"] = {k: statistics.median(v) for k, v in ab.items()}

    # The tuner: the plan `tune` prints is the plan the autotuned take runs.
    with _env(**knobs_on):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["tune", "--kind", "take", "--json", "--backend", "FSStoragePlugin",
                           "--world-size", "1"])
        printed = json.loads(buf.getvalue())
        if rc != 0 or not printed["ok"]:
            raise AssertionError(f"tune exited {rc}: {printed}")
        with _env(TPUSNAP_AUTOTUNE="1"):
            Snapshot.take(os.path.join(root, "train_tuned"),
                          {"train": StateDict(**model.train_state())})
        event = history.load_history(os.path.join(tele, "history.jsonl"))[-1]
    tuned = event.get("tuned") or {}
    if tuned.get("plan_id") != printed["plan_id"]:
        raise AssertionError(f"the autotuned take ran plan {tuned}, tune printed {printed}")
    out["tuned"] = tuned
    ctx["observe"] = {"root": root, "tele": tele, "fleet": fdir, "metrics": metrics,
                      "snapshot": last, "other": first}
    out.update(seconds=time.perf_counter() - t_phase, card=ctx["card"])
    return out


def _cli_run(argv, env) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpusnap_torch", *argv], capture_output=True, text=True,
        timeout=600, env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    return {"rc": proc.returncode, "s": time.perf_counter() - t0,
            "out": proc.stdout, "err": proc.stderr}


_CLI_NO_CUDA = r"""
import json, sys, torch
from tpusnap_torch.__main__ import main
snap, leaf = sys.argv[1], sys.argv[2]
rcs = {c: main(a) for c, a in (("info", ["info", snap]), ("verify", ["verify", snap]),
                                ("fsck", ["fsck", snap]), ("cat", ["cat", snap, leaf]))}
print(json.dumps({"rcs": rcs, "cuda_initialized": torch.cuda.is_initialized()}))
"""


def phase_cli(ctx: dict, workdir: str) -> dict:
    """``python -m tpusnap_torch`` in subprocesses on what the observe,
    crash, tier, cas and delta phases left: every subcommand (lint over the
    package's own source),
    each exit code held to tpusnap's contract for that state; then one
    child calls ``main`` in process and must leave CUDA uninitialised."""
    import torch

    from tpusnap_torch import Snapshot, StateDict, slo
    from tpusnap_torch.fleet import evaluate_fleet, fold_fleet, read_fleet_records
    from tpusnap_torch.history import check_regression, load_history
    from tpusnap_torch.storage_plugins import fs as fs_mod

    t_phase = time.perf_counter()
    obs = ctx["observe"]
    snap, other = obs["snapshot"], obs["other"]
    torn, tier, cas_snap, store, delta_root = (
        ctx["cli_torn"], ctx["cli_tier"], ctx["cli_cas"][0], ctx["cli_cas"][1], ctx["cli_delta"])
    env = dict(os.environ, TPUSNAP_TELEMETRY_DIR=obs["tele"], TPUSNAP_FLEET_DIR=obs["fleet"],
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    env.pop("TPUSNAP_PROBE", None)
    empty = os.path.join(workdir, "cli_empty")
    os.makedirs(empty)
    leaf = "0/train/params/ln_f"

    # The verdicts each gate must report for this state, from the same
    # library calls under the same environment.
    with _env(TPUSNAP_TELEMETRY_DIR=obs["tele"], TPUSNAP_FLEET_DIR=obs["fleet"]):
        reg = check_regression(load_history())
        slo_verdict = slo.evaluate_records(slo.read_slo_records())["verdict"]
        fleet_verdict = evaluate_fleet(fold_fleet(read_fleet_records(obs["fleet"])))["verdict"]
        analyze_failed = _take_report(snap, heatmap=True)["check_failed"]
    history_rc = 2 if reg.regressed else (0 if reg.ok else 3)
    slo_rc = {"healthy": 0, "breach": 2}.get(slo_verdict, 3)
    fleet_rc = 2 if fleet_verdict == "breach" else 0
    analyze_rc = 2 if analyze_failed else 0

    expect = [
        ("info", ["info", snap], 0), ("ls", ["ls", "-l", snap], 0),
        ("verify", ["verify", snap], 0), ("cat", ["cat", snap, leaf], 0),
        ("diff", ["diff", "-q", other, snap], 2), ("trace", ["trace", snap], 0),
        ("trace --restore", ["trace", "--restore", snap], 0),
        ("history", ["history"], 0), ("history --check", ["history", "--check"], history_rc),
        ("analyze", ["analyze", snap], 0), ("analyze --check", ["analyze", "--check", snap],
                                            analyze_rc),
        ("tune", ["tune", "--kind", "take"], 0),
        ("timeline", ["timeline", snap], 0), ("timeline torn", ["timeline", torn], 4),
        ("fsck", ["fsck", snap], 0), ("fsck torn", ["fsck", torn], 4),
        ("fsck empty", ["fsck", empty], 3), ("gc", ["gc", snap], 0),
        ("gc --evict-local", ["gc", "--evict-local", tier], 0),
        ("drain --status", ["drain", "--status", tier], 0),
        ("drain nothing", ["drain", empty], 3),
        ("fsck --store", ["fsck", "--store", store], 0),
        ("gc --store", ["gc", "--store", store], 0),
        ("info cas", ["info", cas_snap], 0), ("info delta root", ["info", delta_root], 0),
        ("fsck delta root", ["fsck", delta_root], 0),
        ("slo", ["slo"], 0), ("slo --check", ["slo", "--check"], slo_rc),
        ("fleet", ["fleet"], 0), ("fleet --check", ["fleet", "--check"], fleet_rc),
        ("heatmap", ["heatmap", snap], 0),
        ("retain --dry-run", ["retain", obs["root"], "--keep", "2", "--dry-run"], 0),
        ("lint --check", ["lint", "--check"], 0),
    ]
    results = {}
    with ThreadPoolExecutor(max_workers=6) as pool:
        futures = {name: pool.submit(_cli_run, argv, env) for name, argv, _ in expect}
    for name, _argv, rc in expect:
        r = futures[name].result()
        results[name] = {"rc": r["rc"], "s": round(r["s"], 3)}
        if r["rc"] != rc:
            raise AssertionError(f"`{name}` exited {r['rc']}, not {rc}:\n{r['out'][-2000:]}"
                                 f"\n{r['err'][-2000:]}")
    checks = {"drain --status": "remote-durable", "fsck": "committed", "info cas": "cas:",
              "info delta root": "HEAD", "cat": f"# float32[{ctx['cfg'].d_model}]",
              "fsck torn": "torn"}
    for name, text in checks.items():
        if text not in futures[name].result()["out"]:
            raise AssertionError(f"`{name}` does not say {text!r}")
    # Commands that change what they touch, in turn.
    for name, argv, rc in (("materialize", ["materialize", snap], 0),
                           ("drain", ["drain", tier], 0),
                           ("gc --torn --force", ["gc", "--torn", "--force", torn], 0),
                           ("fsck after gc --torn", ["fsck", torn], 3)):
        r = _cli_run(argv, env)
        results[name] = {"rc": r["rc"], "s": round(r["s"], 3)}
        if r["rc"] != rc:
            raise AssertionError(f"`{name}` exited {r['rc']}, not {rc}:\n{r['err'][-2000:]}")

    # watch --once on a take in flight: its writes wait on a gate.
    live = os.path.join(workdir, "cli_live")
    gate, errors = threading.Event(), []
    orig = fs_mod.FSStoragePlugin.write

    async def held_write(self, write_io):
        import asyncio

        while not gate.is_set():
            await asyncio.sleep(0.02)
        await orig(self, write_io)

    def take():
        try:
            with _env(TPUSNAP_HEARTBEAT_INTERVAL_S="0.1", TPUSNAP_TELEMETRY_DIR=obs["tele"]):
                Snapshot.take(live, {"train": StateDict(**ctx["life_model"].train_state())})
        except BaseException as e:  # raised below
            errors.append(e)

    fs_mod.FSStoragePlugin.write = held_write
    t = threading.Thread(target=take)
    t.start()
    try:
        deadline = time.monotonic() + 120
        while not os.path.isdir(os.path.join(live, ".tpusnap", "progress")):
            if time.monotonic() > deadline or not t.is_alive():
                raise AssertionError("the live take never started its heartbeat")
            time.sleep(0.05)
        time.sleep(0.5)
        r = _cli_run(["watch", live, "--once"], env)
    finally:
        gate.set()
        fs_mod.FSStoragePlugin.write = orig
        t.join(300)
    if errors:
        raise errors[0]
    results["watch --once"] = {"rc": r["rc"], "s": round(r["s"], 3)}
    if r["rc"] != 0 or "running" not in r["out"] or "not yet written" not in r["out"]:
        raise AssertionError(f"watch --once on a live take:\n{r['out']}\n{r['err'][-2000:]}")

    # main() in process: no CUDA context.
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _CLI_NO_CUDA, snap, leaf], capture_output=True,
                          text=True, timeout=600, env=env)
    if proc.returncode != 0:
        raise AssertionError(f"the in-process CLI child failed:\n{proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    if child["cuda_initialized"] or set(child["rcs"].values()) != {0}:
        raise AssertionError(f"in-process CLI: {child}")
    results["in-process info/verify/fsck/cat"] = {"rc": child["rcs"],
                                                  "s": round(time.perf_counter() - t0, 3)}
    for p in (torn, empty, live, delta_root, cas_snap, store, obs["root"],
              os.path.join(workdir, "tier_local"), os.path.join(workdir, "tier_remote")):
        shutil.rmtree(p, ignore_errors=True)
    return {"phase": "cli", "commands": results,
            "gates": {"history --check": history_rc, "slo --check": slo_rc,
                      "fleet --check": fleet_rc, "analyze --check": analyze_rc},
            "cuda_initialized": child["cuda_initialized"],
            "seconds": time.perf_counter() - t_phase, "card": ctx["card"]}


def _run_main(module, argv) -> tuple:
    """``module.main(argv)`` in process with its stdout captured; returns
    (exit code, stdout, seconds). Its output is echoed to stderr when it
    fails."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    seconds = time.perf_counter() - t0
    if rc != 0:
        print(buf.getvalue()[-6000:], file=sys.stderr)
        raise AssertionError(f"{module.__name__}.main({argv}) exited {rc}")
    return rc, buf.getvalue(), seconds


def _logged_numbers(out: str, pattern: str) -> list:
    import re

    return [float(x) for x in re.findall(pattern, out)]


def phase_examples(ctx: dict, workdir: str) -> dict:
    """The port's four examples in process on the card (each in its own
    directory): simple and its resume, incremental, distributed at world 2
    and the flagship transformer example at full width with 4 experts,
    trained 3 epochs and resumed from epoch 2. Flash launches are counted
    over the transformer runs alone."""
    import torch

    from tpusnap_torch import Snapshot
    from tpusnap_torch.examples import distributed, incremental, simple, transformer
    from tpusnap_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    edir = os.path.join(workdir, "examples")
    seconds = {}
    sdir = os.path.join(edir, "simple")
    _, out, s1 = _run_main(simple, ["--work-dir", sdir])
    _, resumed, s2 = _run_main(simple, ["--work-dir", sdir, "--resume-from",
                                        os.path.join(sdir, "epoch_2")])
    if "epoch 4:" not in out or "at epoch 2" not in resumed or "epoch 3:" not in resumed:
        raise AssertionError(f"simple example: {out!r} then {resumed!r}")
    seconds["simple"] = s1 + s2
    _, out, seconds["incremental"] = _run_main(incremental,
                                               ["--work-dir", os.path.join(edir, "inc")])
    for line in ("incremental on", "0 corrupt", "bit-exact"):
        if line not in out:
            raise AssertionError(f"incremental example printed no {line!r}: {out!r}")
    _, out, seconds["distributed"] = _run_main(
        distributed, ["--world-size", "2", "--work-dir", os.path.join(edir, "ddp")])
    if not all(f"rank {r}: restore verified" in out for r in (0, 1)):
        raise AssertionError(f"distributed example: {out!r}")

    xdir, rdir = os.path.join(edir, "xf"), os.path.join(edir, "xf_resumed")
    _reset_launches()  # the examples path: the two transformer runs
    _, out, s1 = _run_main(transformer, ["--width", "full", "--work-dir", xdir])
    _, resumed, s2 = _run_main(transformer, ["--width", "full", "--work-dir", rdir,
                                             "--resume-from", os.path.join(xdir, "epoch_2")])
    launches, routes = fa.launches, dict(fa.route_launches)
    seconds["transformer"] = s1 + s2
    model, _ = transformer.build("full", "cuda")
    cfg = model.config
    steps = transformer.NUM_EPOCHS * transformer.STEPS_PER_EPOCH + transformer.STEPS_PER_EPOCH
    if launches != cfg.n_layers * steps:
        raise AssertionError(f"transformer example: {launches} flash launches, expected "
                             f"{cfg.n_layers} layers x {steps} steps")
    if "resumed at epoch 2" not in resumed or "epoch 3:" not in resumed \
            or "final snapshot committed" not in resumed:
        raise AssertionError(f"transformer example resume: {resumed!r}")
    losses = _logged_numbers(out + resumed, r"loss=([-0-9.e]+)\n")
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss in the transformer example: {losses}")
    snaps = [os.path.join(xdir, f"epoch_{e}") for e in (1, 2, 3)] + [os.path.join(rdir, "epoch_3")]
    for path in snaps:
        if not Snapshot(path).verify().clean:
            raise AssertionError(f"{path} does not scrub clean")
    # The resumed epoch_3 into a fresh model: in place, bit for bit.
    app_state = transformer.app_state_of(model)
    before = {p: id(t) for p, t in _leaves(model.train_state())}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = Snapshot(os.path.join(rdir, "epoch_3"))
    snap.restore(app_state)
    torch.cuda.synchronize()
    fresh_restore_s = time.perf_counter() - t0
    for p, t in _leaves(model.train_state()):
        if id(t) != before[p] or not torch.equal(t.cpu(), snap.read_object(f"0/train/{p}")):
            raise AssertionError(f"resumed epoch_3 restored {p} not in place or not bit for bit")
    if app_state["progress"]["epoch"] != 3:
        raise AssertionError(f"progress restored as {app_state['progress']}")
    state_bytes = _state_bytes(model.train_state())
    return {
        "phase": "examples", "seconds_by_example": seconds,
        "transformer": {
            "config": {"vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
                       "n_heads": cfg.n_heads, "n_layers": cfg.n_layers, "d_ff": cfg.d_ff,
                       "n_experts": cfg.n_experts, "tokens": list(transformer.WIDTHS["full"][1])},
            "train_state_bytes": state_bytes, "steps": steps, "losses": losses,
            "async_take_blocked_s": _logged_numbers(out + resumed, r"\(blocked ([0-9.]+) s\)"),
            "final_wait_s": _logged_numbers(out + resumed, r"\(wait ([0-9.]+) s\)"),
            "async_restore_s": _logged_numbers(resumed, r"\(restore ([0-9.]+) s\)"),
            "fresh_model_restore_s": fresh_restore_s,
            "verified_clean": len(snaps),
        },
        "flash_launches": launches, "flash_routes": routes,
        "seconds": time.perf_counter() - t_phase, "card": ctx["card"],
    }


# Each harness's arguments in the smoke and how they cut its defaults.
_HARNESSES = [
    ("load_tensor", ["--gb", "2"], "2 GiB, not the reference's 10 GB (the harness's default is 1)"),
    ("pinned_host", [], None),
    ("async_latency", ["--runs", "2"], "2 interleaved runs, not 3"),
    ("incremental", ["--gb", "0.5", "--runs", "2", "--chain-depth", "10"],
     "0.5 GiB frozen, not 2; 2 runs, not 3; chain depth 10, not 100"),
    ("replicated", [], None),
    ("sharded", ["--n-layers", "4", "--runs", "2"], "4 layers, not 8; 2 runs, not 3"),
    ("embedding", [], None),
    ("gcs_pipeline", [], None),
    ("dcp_compare", ["--d-model", "512", "--n-heads", "8", "--n-layers", "4", "--runs", "3"],
     "the flagship TransformerConfig() width (d_model 512, 8 heads, 4 layers), not d_model "
     "1024 x 16 heads x 8 layers; 3 sessions, not 5"),
    ("fleetsim", ["--jobs", "6", "--branch", "2", "--takes", "2"],
     "6 jobs and 2 branch jobs, not 8 and 4; 2 takes, not 3"),
]
def phase_benchmarks(ctx: dict, workdir: str) -> list:
    """Every benchmark harness of the port in process on the card, sizes
    cut as ``_HARNESSES`` lists; one line per harness (its own last line
    under ``"phase": "benchmarks"``). A harness whose correctness fields
    are not all true exits 1 (its ``ok``), which fails the phase."""
    import importlib

    lines = []
    for name, argv, cut in _HARNESSES:
        module = importlib.import_module(f"tpusnap_torch.benchmarks.{name}")
        _, out, seconds = _run_main(module, argv)
        last = json.loads(out.strip().splitlines()[-1])
        if last["bench"] != name or last["ok"] is not True:
            raise AssertionError(f"benchmark {name}: {out[-3000:]}")
        lines.append({"phase": "benchmarks", "harness": name, "argv": argv,
                      "reduced": {name: cut} if cut else {}, "seconds": seconds,
                      "card": ctx["card"], **last})
    return lines


def _reset_launches() -> None:
    """Set the flash and ring block kernels' launch counts to 0."""
    import importlib

    from tpusnap_torch.ops import flash_attention as fa

    ra = importlib.import_module("tpusnap_torch.ops.ring_attention")
    fa.launches = 0
    fa.route_launches = dict.fromkeys(fa.route_launches, 0)
    ra.launches = ra.skips = ra.backward_steps = ra.backward_skips = 0
    ra.route_launches = dict.fromkeys(ra.route_launches, 0)
    ra.mode_launches = dict.fromkeys(ra.mode_launches, 0)


def _check_routes(path: str, launches: int, routes: dict) -> None:
    if launches == 0:
        raise AssertionError(f"the {path} path launched no flash kernel")
    if routes != {"wgmma": launches, "simt": 0}:
        raise AssertionError(
            f"{path} flash launches by route {routes}: all {launches} must take "
            "the wgmma route"
        )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--crash-child"]:
        _crash_child(*sys.argv[2:5])
        return 1
    if sys.argv[1:2] == ["--matrix-child"]:
        _matrix_child(*sys.argv[2:5])
        return 1
    if sys.argv[1:2] == ["--delta-matrix-child"]:
        _delta_matrix_child(*sys.argv[2:5])
        return 1
    from tpusnap_torch.ops import flash_attention as fa

    card = nvidia_smi_line()
    ctx = {"card": card}
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    workdir = tempfile.mkdtemp(prefix="tpusnap_torch_smoke_")
    # History, access ledgers, SLO sidecars and restore traces are on by
    # default: keep them in the run's own directory (child processes
    # inherit it), unless the caller chose one.
    os.environ.setdefault("TPUSNAP_TELEMETRY_DIR", os.path.join(workdir, "telemetry"))
    try:
        emit(phase_build())
        result = phase_kernels()
        kernel_row = result["flash_attention_fwd"]
        emit(result)
        _reset_launches()  # the main path starts here
        emit(phase_train(ctx))
        emit(phase_snapshot(ctx, workdir))
        paths = {"train+snapshot": (fa.launches, dict(fa.route_launches))}
        emit(phase_bulk(ctx, workdir))
        _reset_launches()
        emit(phase_async_train(ctx, workdir))
        paths["async_train"] = (fa.launches, dict(fa.route_launches))
        emit(phase_async_bulk(ctx, workdir))
        emit(phase_chunked(ctx, workdir))
        _reset_launches()
        emit(phase_incremental(ctx, workdir))
        paths["incremental"] = (fa.launches, dict(fa.route_launches))
        emit(phase_compress(ctx, workdir))
        emit(phase_transforms(ctx, workdir))
        dist_line = phase_distributed(ctx, workdir)
        emit(dist_line)
        for r in dist_line["ranks"]:
            paths[f"distributed rank {r['rank']}"] = (r["flash_launches"], r["flash_routes"])
        _reset_launches()
        sharded_line = phase_sharded(ctx, workdir)
        paths["sharded parent"] = (fa.launches, dict(fa.route_launches))
        emit(sharded_line)
        for r in sharded_line["ranks"]:
            paths[f"sharded rank {r['rank']}"] = (r["flash_launches"], r["flash_routes"])
        _reset_launches()
        emit(phase_moe(ctx, workdir))
        paths["moe"] = (fa.launches, dict(fa.route_launches))
        emit(phase_embedding(ctx, workdir))
        layouts_line = phase_layouts(ctx, workdir)
        emit(layouts_line)
        for r in layouts_line["ranks"]:
            paths[f"layouts rank {r['rank']}"] = (r["flash_launches"], r["flash_routes"])
        _reset_launches()
        ring_line = phase_ring(ctx, workdir)
        emit(ring_line)
        ring_paths = {
            f"ring rank {r['rank']}": (r["ring_launches"], r["ring_routes"], r["ring_skips"],
                                       r["ring_modes"])
            for r in ring_line["ranks"]
        }
        ring_paths["ring replica"] = (
            ring_line["replica_ring_launches"], ring_line["replica_ring_routes"], 0,
            ring_line["replica_ring_modes"],
        )
        paths["ring replica dense restore"] = (fa.launches, dict(fa.route_launches))
        sharded_step_line = phase_sharded_step(ctx, workdir)
        emit(sharded_step_line)
        ring_backward = {}
        for r in sharded_step_line["ranks"]:
            for part in ("ring", "snapshot"):
                c = r[part]
                name = f"sharded_step {part} rank {r['rank']}"
                ring_paths[name] = (c["ring_launches"], c["ring_routes"], c["ring_skips"],
                                    c["ring_modes"])
                ring_backward[name] = c["backward_steps"]
            for part in ("dense", "moe"):
                c = r[part]
                paths[f"sharded_step {part} rank {r['rank']}"] = (c["flash_launches"],
                                                                  c["flash_routes"])
        _reset_launches()
        ctx["life_model"], ctx["life_state_file"] = _lifecycle_model(ctx, workdir)
        emit(phase_crash(ctx, workdir))
        emit(phase_crash_matrix(ctx, workdir))
        paths.update(ctx["matrix_flash"])
        emit(phase_chaos(ctx, workdir))
        paths["crash+chaos"] = (fa.launches, dict(fa.route_launches))
        emit(phase_liveness(ctx, workdir))
        degrade_line = phase_degrade(ctx, workdir)
        emit(degrade_line)
        for c in ("sync", "async"):
            r = degrade_line["cases"][c]
            paths[f"degrade {c} rank 0"] = (r["flash_launches"], r["flash_routes"])
        emit(phase_lifecycle_ab(ctx, workdir))
        _reset_launches()
        emit(phase_delta(ctx, workdir))
        paths["delta"] = (fa.launches, dict(fa.route_launches))
        emit(phase_delta_elastic(ctx, workdir))
        _reset_launches()
        emit(phase_tier(ctx, workdir))
        emit(phase_cas(ctx, workdir))
        paths["tier+cas"] = (fa.launches, dict(fa.route_launches))
        ctx["cli_delta"] = os.path.join(workdir, "delta_free")
        _reset_launches()
        emit(phase_observe(ctx, workdir))
        paths["observe"] = (fa.launches, dict(fa.route_launches))
        emit(phase_cli(ctx, workdir))
        ex_line = phase_examples(ctx, workdir)
        emit(ex_line)
        paths["examples"] = (ex_line["flash_launches"], ex_line["flash_routes"])
        t0 = time.perf_counter()
        for line in phase_benchmarks(ctx, workdir):
            emit(line)
        emit({"phase": "benchmarks", "harnesses": len(_HARNESSES),
              "seconds": time.perf_counter() - t0,
              "examples_and_benchmarks_s": ex_line["seconds"] + time.perf_counter() - t0,
              "card": card})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for path, (launches, routes) in paths.items():
        _check_routes(path, launches, routes)
    for path, (launches, routes, _, _) in ring_paths.items():
        if launches == 0 or routes != {"wgmma": launches, "simt": 0}:
            raise AssertionError(f"{path}: ring block launches {launches} by route {routes}")
    ring_row, ring_one = result["ring_block_attend"], result["ring_of_one_forward"]
    ring_modes = {
        mode: sum(modes[mode] for _, _, _, modes in ring_paths.values())
        for mode in ring_row["modes"]
    }
    main_path_launches = sum(n for n, _ in paths.values())
    main_path_routes = {
        r: sum(routes[r] for _, routes in paths.values()) for r in ("wgmma", "simt")
    }
    emit({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "kernel_route": "wgmma",
        "route_launches": main_path_routes,
        "source": "tpusnap_torch/csrc/flash_attention_wgmma.cu",
        "replaces": "tpusnap/ops/flash_attention.py:41",
        "launches": main_path_launches,
        "launches_by_path": {p: n for p, (n, _) in paths.items()},
        "max_abs_err": kernel_row["max_abs_err"],
        "max_err": kernel_row["max_abs_err"],
        "ms": kernel_row["ms"],
        "plain_ms": kernel_row["plain_ms"],
        "bound_ms": kernel_row["bound_ms"],
        "bound_by": kernel_row["bound_by"],
        "library_ms": kernel_row["library_ms"],
        "tflops": kernel_row["tflops"],
        "bound_share": kernel_row["bound_share"],
        "simt_ms": kernel_row["simt_ms"],
    }, {
        # The ring of one's launch (first+last at the flagship's shape, 20
        # of the main path's launches) gives the row's numbers; "modes"
        # has each mode's at the two-rank block (8, 512, 8, 64).
        "name": "ring_block_attend",
        "route": "cuda",
        "kernel_route": "wgmma",
        "route_launches": {
            r: sum(routes[r] for _, routes, _, _ in ring_paths.values())
            for r in ("wgmma", "simt")
        },
        "source": "tpusnap_torch/csrc/ring_block_wgmma.cu",
        "replaces": "tpusnap/ops/ring_attention.py:26",
        "launches": sum(n for n, _, _, _ in ring_paths.values()),
        "launches_by_path": {p: n for p, (n, _, _, _) in ring_paths.items()},
        "launches_by_mode": ring_modes,
        "skips_by_path": {p: k for p, (_, _, k, _) in ring_paths.items()},
        # The backward across ranks (plain PyTorch, no kernel): its block steps.
        "backward_steps_by_path": ring_backward,
        "max_abs_err": max(ring_row["max_abs_err"], ring_one["max_abs_err"]),
        "ms": ring_one["ms"],
        "cold_ms": ring_one["cold_ms"],
        "ms_of": "first+last at (8, 1024, 8, 64): ring_attention(q, k, v, group=None)",
        "plain_ms": ring_one["plain_ms"],
        "bound_ms": ring_one["bound_ms"],
        "bound_by": ring_one["bound_by"],
        "library_ms": ring_one["library_ms"],
        "bound_share": ring_one["bound_ms"] / ring_one["cold_ms"],
        "modes": {
            mode: {**row, "launches": ring_modes[mode]} for mode, row in ring_row["modes"].items()
        },
        # The backward across ranks' one block (plain PyTorch, no kernel).
        "backward_block": result["ring_backward_block"],
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0

if __name__ == "__main__":
    sys.exit(main())
