"""One run of one cell: set-up, the measured window, the check, the
result line.

``run()`` takes the cell's configuration, mix and metrics by name
(``registry``), builds the job from the seed, runs the window, then,
when ``trace``, a second window of at most ``TRACE_SECONDS`` under the
device trace (so that every host-clock reading, ``step_mfu``'s included,
comes from the untraced window and only the device's readings from the
traced one), and with the windows closed and the device's peak memory
read, checks what the timed path produced:

- the checkpoint path: what the kept snapshots or every restore give
  back, against a device copy of the state at the call, element by
  element (limit 0);
- the model step: the program's first three steps, taken in set-up by the
  window's own call on the window's own feed, against the plain
  reference from the same weights and batches (``checks.gaps``; limits in
  the configuration's file);
- no loss in the window is NaN or infinite, and no checkpoint call
  failed.
"""

from __future__ import annotations

import random
import sys
import time
from typing import Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tpusnap"})
TRAINING_STEPS = 3
TRACE_SECONDS = 20.0


class Refused(Exception):
    """The run cannot give a result (exit code 3)."""


def forbidden_modules() -> list:
    """Modules in this process whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _sync(device):
    import torch

    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def run(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device=None, overrides: Optional[dict] = None, bench: Optional[dict] = None) -> dict:
    """The result of one run. ``device`` defaults to the card;
    ``overrides`` (tests only) replace keys of the configuration and the
    mix: ``{"config": {...}, "mix": {...}}``."""
    import torch

    from . import checks, registry
    from . import job as jobs
    from .trace import DeviceTrace, breakdown

    bench = bench or registry.benchmark()
    cell = registry.cell(bench, cell_name)
    overrides = overrides or {}
    cfg = {**registry.config(cell["config"]), **overrides.get("config", {})}
    mix = {**registry.mix(cell["traffic"]), **overrides.get("mix", {})}
    ref = registry.reference(cfg["reference"])
    readers = {m["name"]: registry.metric(m["name"]) for m in registry.metrics_of(bench, cell_name, trace)}
    device = torch.device(device or "cuda")
    seed = seed % (1 << 63)
    sync = _sync(device)

    # Set-up: the weights and the feed from the seed, the first steps (the
    # check's readings), one checkpoint of the cell's kind, two more steps.
    job = jobs.Job(cfg, mix, seed, device, ref)
    program = job.first_steps(TRAINING_STEPS)
    policy = jobs.make_policy(job, mix, sampled=random.Random(seed).randint(1, 3))
    policy.setup()
    for _ in range(2):
        job.step()
    sync()
    setup_s = time.perf_counter() - t_start

    win = jobs.window(job, policy, seconds, sync)
    policy.drain()
    records = list(policy.records)
    tracer, traced_win = None, None
    if trace:
        tracer = DeviceTrace()
        tracer.start()
        traced_win = jobs.window(job, policy, min(seconds, TRACE_SECONDS), sync)
        sync()
        tracer.stop()
        policy.drain()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    checked = policy.verify()
    policy.cleanup()
    batches = job.batches[:TRAINING_STEPS].clone()
    failed = policy.failed
    del job, policy
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = ref.train(cfg, ref.init_weights(cfg, seed, device), batches, cfg["learning_rate"])
    found = checks.gaps(program, want)
    limits = cfg["limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in found.items()}
    if "ckpt_mismatch" in checked:
        compared["ckpt_mismatch"] = {"value": checked["ckpt_mismatch"], "limit": 0}
        compared["ckpt_checked"] = {"value": checked["ckpt_checked"], "limit": 1, "at_least": True}
    windows = [w for w in (win, traced_win) if w]
    losses = [x for w in windows for x in w["losses"]]
    bad_losses = sum(1 for x in losses if x != x or x in (float("inf"), float("-inf")))
    compared["nonfinite_losses"] = {"value": bad_losses, "limit": 0}
    compared["failed_calls"] = {"value": failed, "limit": 0}
    correct = all(c["value"] >= c["limit"] if c.get("at_least") else c["value"] <= c["limit"]
                  for c in compared.values())

    decisions = sorted({str((r.get("take_summary") or {}).get("compress", {}).get("reason"))
                        for r in records if "take_summary" in r})
    print(f"portbench: checkpoint calls (ms) {[round(1e3 * x) for x in win['stalls_s']]}; "
          f"compression decisions {decisions}", file=sys.stderr)
    t_reduce = time.perf_counter()
    traced = tracer.reduce() if tracer else None
    if traced:
        print(f"portbench: trace reduced in {time.perf_counter() - t_reduce:.1f} s", file=sys.stderr)
    run_data = {**win, "setup_s": setup_s, "records": records, "trace": traced,
                "config": cfg, "mix": mix}
    metrics = {}
    for m in registry.metrics_of(bench, cell_name, trace):
        value = readers[m["name"]](run_data)
        if value is None:
            if not trace:
                raise Refused(f"end-to-end metric {m['name']} has nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    attempted = sum(len(w["steps_s"]) + len(w["stalls_s"]) for w in windows)
    result = {"correct": correct, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"], dev["window_s"] = traced["busy_s"], traced["window_s"]
        result["breakdown"] = breakdown(traced)
    result["checks"] = compared
    # Whatever ran after the window (the check, the reference, the
    # readers) is held to the same rule as the window itself.
    leaked = forbidden_modules()
    if leaked:
        raise Refused(f"modules of JAX or the JAX package were loaded: {leaked}")
    return result
