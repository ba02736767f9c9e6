"""The training job a cell runs: the program's model that the cell's
configuration names (``model_of``), trained by its own ``train_step`` in
a closed loop, with the checkpoint calls that the cell's mix asks for.

Each step starts after the previous step's loss is on the host
(``.item()``), as a training loop that logs its loss does. The mixes'
``checkpoint`` policies:

- ``none``: steps only.
- ``async_take``: every ``every_steps`` steps, ``wait()`` on the previous
  pending snapshot, delete the one ``keep`` back, ``Snapshot.async_take``
  into fsspec's in-process memory filesystem.
- ``take``: every ``every_steps`` steps, delete the one ``keep`` back and
  ``Snapshot.take`` there (``replicated=["**"]`` when the mix says so).
- ``restore``: the state is taken once to the local filesystem in set-up;
  the window restores it in place into the live model, then runs
  ``every_steps`` steps, over and over.

The checkpoint calls' time is the stall; a step's time runs from its
start to its loss on the host. The benchmark keeps a device copy of the
state at each checkpoint call (``Witness``), outside the timed calls, to
judge what comes back.
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time
from typing import Dict, List, get_type_hints

import torch

from . import frozen
from .harness import Refused
from .trace import span

MEMORY_ROOT = "portbench/run"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def mismatches(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elements of ``a`` whose bytes differ from ``b``'s, as a device
    count (no synchronisation)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return torch.tensor(max(a.numel(), b.numel(), 1), device=a.device)
    n = a.element_size()
    view = {4: torch.int32, 2: torch.int16, 8: torch.int64, 1: torch.uint8}[n]
    return (a.contiguous().view(view) != b.contiguous().view(view)).sum()


# The keys of a configuration's file that the harness reads itself; every
# other key names a field of the model's config.
HARNESS_KEYS = ("name", "reference", "source", "source_values", "notes", "departures",
                "assumed", "reduced", "batch", "learning_rate", "flops_per_step",
                "train_state_bytes", "limits", "model")
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def model_of(cfg: dict):
    """The model class that the configuration names (``model``, a class
    exported by ``tpusnap_torch.models``; ``Transformer`` when absent) and
    its config (``<model>Config`` of the same module), built from every key
    of the configuration that names a field of it, dtype fields mapped
    from their names. A key that is neither the harness's nor a field is
    refused, so that a misspelt width cannot take its default.

    The job relies on ``cls(config, device=..., seed=...)``, ``params()``,
    ``train_state()`` and ``train_step(tokens, learning_rate=...)``."""
    from tpusnap_torch import models

    name = cfg.get("model", "Transformer")
    if name not in models.__all__ or f"{name}Config" not in models.__all__:
        raise Refused(f"configuration {cfg.get('name')!r}: model {name!r} is not a class of "
                      f"tpusnap_torch.models with a {name}Config beside it")
    cls, config_cls = getattr(models, name), getattr(models, f"{name}Config")
    types = get_type_hints(config_cls)
    fields = {f.name for f in dataclasses.fields(config_cls)}
    unplaced = sorted(set(cfg) - set(HARNESS_KEYS) - fields)
    if unplaced:
        raise Refused(f"configuration {cfg.get('name')!r}: keys {unplaced} are neither the "
                      f"harness's nor fields of {config_cls.__name__}")
    values = {}
    for key in fields & set(cfg):
        value = cfg[key]
        if types[key] is torch.dtype:
            if value not in DTYPES:
                raise Refused(f"configuration {cfg.get('name')!r}: {key} {value!r} is not one "
                              f"of {sorted(DTYPES)}")
            value = DTYPES[value]
        values[key] = value
    return cls, config_cls(**values)


class Job:
    """The model, its feed and its checkpoint policy for one run."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, ref) -> None:
        self.cfg, self.device, self.ref = cfg, device, ref
        cls, model_cfg = model_of(cfg)
        self.model = cls(model_cfg, device=device, seed=0)
        # The weights are the benchmark's, drawn on the device from the
        # seed, and copied into the program's parameters in place.
        self.start = ref.init_weights(cfg, seed, device)
        params = dict(_leaves(self.model.params()))
        if set(params) != set(self.start):
            raise RuntimeError(f"the model's parameters {sorted(params)} are not the "
                               f"reference's {sorted(self.start)}")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(self.start[name])
        n = mix["batches"]
        feed = frozen.tokens(cfg["vocab_size"], n, cfg["batch"], cfg["max_seq_len"], seed)
        self.batches = torch.from_numpy(feed).to(device)
        self.lr = cfg["learning_rate"]
        self.fed = 0
        self.app_state = None

    def state(self) -> Dict[str, torch.Tensor]:
        return dict(_leaves(self.model.train_state()))

    def step(self) -> float:
        """One training step on the next batch of the feed; its loss."""
        tokens = self.batches[self.fed % len(self.batches)]
        self.fed += 1
        return self.model.train_step(tokens, learning_rate=self.lr).item()

    def first_steps(self, n: int = 3) -> dict:
        """The program's readings of its first ``n`` steps: each loss, the
        first step's gradient per leaf as Adam holds it after one step
        (mu / (1 - b1)), and each parameter's change after ``n``."""
        losses = [self.step()]
        mu = dict(_leaves(self.model.train_state()["opt"]["mu"]))
        grads = {k: _norm(v / (1 - self.ref.ADAM_B1)) for k, v in mu.items()}
        losses += [self.step() for _ in range(n - 1)]
        params = dict(_leaves(self.model.params()))
        change = {k: _norm(params[k].detach() - self.start[k]) for k in params}
        self.start = None
        return {"losses": losses, "grad_norms": grads, "change_norms": change}

    def app(self, step: int) -> dict:
        from tpusnap_torch import StateDict

        if self.app_state is None:
            self.app_state = StateDict(**self.model.train_state())
        return {"train": self.app_state, "progress": StateDict(step=step)}


def _norm(t: torch.Tensor) -> float:
    return torch.linalg.vector_norm(t.detach(), dtype=torch.float64).item()


class Witness:
    """Device copies of the state, one slot per checkpoint kept for the
    check: the last two and one drawn from the seed."""

    def __init__(self, job: Job, sampled: int) -> None:
        self.job, self.sampled = job, sampled
        self.slots: Dict[int, dict] = {}  # checkpoint index -> copies
        self.steps: Dict[int, int] = {}

    def capture(self, index: int, step: int) -> None:
        keep = {self.sampled, index, index - 1}
        reuse = [i for i in self.slots if i not in keep]
        if reuse:
            slot = self.slots.pop(reuse[0])
            self.steps.pop(reuse[0])
            with torch.no_grad():
                for k, v in self.job.state().items():
                    slot[k].copy_(v)
        else:
            slot = {k: v.detach().clone() for k, v in self.job.state().items()}
        self.slots[index] = slot
        self.steps[index] = step


class Policy:
    """Base: no checkpoint."""

    kind = "none"

    def __init__(self, job: Job, mix: dict) -> None:
        self.job = job
        self.every = mix.get("every_steps", 0)
        self.records: List[dict] = []
        self.failed = 0

    def due(self, steps: int) -> bool:
        return False

    def setup(self) -> None:
        """Set-up work of the policy, outside the window."""

    def call(self, steps: int) -> float:
        """The checkpoint call due after ``steps`` window steps; its
        seconds."""
        return 0.0

    def drain(self) -> None:
        """After the window: wait for what is still in flight."""

    def verify(self) -> dict:
        """The check's counts of what came back wrong."""
        return {}

    def cleanup(self) -> None:
        """Delete what the policy wrote."""


class _MemoryPolicy(Policy):
    """Shared by the take and async_take policies: snapshots in fsspec's
    in-process memory filesystem, the one ``keep`` back deleted."""

    def __init__(self, job: Job, mix: dict, sampled: int) -> None:
        super().__init__(job, mix)
        import fsspec

        self.fs = fsspec.filesystem("memory")
        self.keep = mix["keep"]
        self.replicated = ["**"] if mix.get("replicated") else None
        self.index = 0
        self.witness = Witness(job, sampled)
        self.live: List[int] = []

    def url(self, index: int) -> str:
        return f"fsspec+memory://{MEMORY_ROOT}/{index}"

    def due(self, steps: int) -> bool:
        return steps > 0 and steps % self.every == 0

    def _delete_old(self) -> None:
        old = self.index - self.keep
        if old in self.live and old != self.witness.sampled:
            with span("delete"):
                self.fs.rm(f"/{MEMORY_ROOT}/{old}", recursive=True)
            self.live.remove(old)

    def _record(self, snap) -> None:
        from tpusnap_torch import scheduler, telemetry

        rollup = (snap.metadata.extras or {}).get("telemetry") or {}
        self.records.append({
            "rollup": rollup, "stats": dict(scheduler.LAST_EXECUTION_STATS.get("write") or {}),
            "take_summary": dict(telemetry.LAST_TAKE_SUMMARY or {}),
        })

    def setup(self) -> None:
        # One checkpoint of the cell's kind, deleted: warms the staging
        # pool, the pinned buffers and the thread pools.
        self.cleanup()
        first = self._take_once(self.url(0), 0)
        if self.kind == "async_take":
            first.wait()
        self.fs.rm(f"/{MEMORY_ROOT}/0", recursive=True)

    def verify(self) -> dict:
        """Restore each snapshot kept (the one drawn from the seed and the
        last two) into fresh device tensors and count the elements that
        differ from the state at its call."""
        from tpusnap_torch import Snapshot, StateDict

        bad = torch.zeros((), dtype=torch.int64, device=self.job.device)
        checked, steps_bad = 0, 0
        for index, copies in sorted(self.witness.slots.items()):
            if index not in self.live:
                continue
            target = _map(torch.empty_like, self.job.model.train_state())
            progress = StateDict(step=-1)
            Snapshot(self.url(index)).restore({"train": StateDict(**target), "progress": progress})
            got = dict(_leaves(target))
            for k, want in copies.items():
                bad += mismatches(got[k], want)
            steps_bad += progress["step"] != self.witness.steps[index]
            checked += 1
        return {"ckpt_mismatch": int(bad.item()) + steps_bad, "ckpt_checked": checked}

    def cleanup(self) -> None:
        if self.fs.exists(f"/{MEMORY_ROOT}"):
            self.fs.rm(f"/{MEMORY_ROOT}", recursive=True)


class TakePolicy(_MemoryPolicy):
    kind = "take"

    def _take_once(self, url: str, step: int):
        from tpusnap_torch import Snapshot

        with span("take"):
            return Snapshot.take(url, self.job.app(step), replicated=self.replicated)

    def call(self, steps: int) -> float:
        self.index += 1
        self.witness.capture(self.index, steps)
        t0 = time.perf_counter()
        try:
            self._delete_old()
            snap = self._take_once(self.url(self.index), steps)
        except Exception as e:  # noqa: BLE001 - a failed take is counted
            self.failed += 1
            _report(e)
            return time.perf_counter() - t0
        stall = time.perf_counter() - t0
        self.live.append(self.index)
        self._record(snap)
        return stall


class AsyncTakePolicy(_MemoryPolicy):
    kind = "async_take"

    def __init__(self, job: Job, mix: dict, sampled: int) -> None:
        super().__init__(job, mix, sampled)
        self.pending = None

    def _take_once(self, url: str, step: int):
        from tpusnap_torch import Snapshot

        with span("async_take"):
            return Snapshot.async_take(url, self.job.app(step), replicated=self.replicated)

    def _finish(self) -> None:
        pending, self.pending = self.pending, None
        try:
            with span("wait"):
                snap = pending.wait()
        except Exception as e:  # noqa: BLE001 - a failed take is counted
            self.failed += 1
            _report(e)
            return
        self.live.append(self.index)
        self._record(snap)

    def call(self, steps: int) -> float:
        self.witness.capture(self.index + 1, steps)
        t0 = time.perf_counter()
        if self.pending is not None:
            self._finish()
        self.index += 1
        try:
            self._delete_old()
            self.pending = self._take_once(self.url(self.index), steps)
        except Exception as e:  # noqa: BLE001 - a failed take is counted
            self.failed += 1
            _report(e)
        return time.perf_counter() - t0

    def drain(self) -> None:
        if self.pending is not None:
            self._finish()


class RestorePolicy(Policy):
    kind = "restore"

    def __init__(self, job: Job, mix: dict, sampled: int) -> None:
        super().__init__(job, mix)
        self.path = None
        self.bad = None
        self.taken_step = None

    def due(self, steps: int) -> bool:
        return steps % self.every == 0

    def setup(self) -> None:
        from tpusnap_torch import Snapshot

        self.path = tempfile.mkdtemp(prefix="portbench-")
        self.taken_step = self.job.fed
        Snapshot.take(self.path + "/snap", self.job.app(self.taken_step))
        self.copies = {k: v.detach().clone() for k, v in self.job.state().items()}
        self.bad = torch.zeros((), dtype=torch.int64, device=self.job.device)
        self.steps_bad = 0
        self._restore()  # warms the read path
        self.records.clear()

    def _restore(self) -> None:
        from tpusnap_torch import Snapshot, scheduler, telemetry

        app = self.job.app(-1)
        with span("restore"):
            t0 = time.perf_counter()
            Snapshot(self.path + "/snap").restore(app)
            seconds = time.perf_counter() - t0
        state = self.job.state()
        for k, want in self.copies.items():
            self.bad += mismatches(state[k], want)
        self.steps_bad += app["progress"]["step"] != self.taken_step
        self.records.append({
            "restore_s": seconds, "summary": dict(telemetry.LAST_RESTORE_SUMMARY or {}),
            "stats": dict(scheduler.LAST_EXECUTION_STATS.get("read") or {}),
        })

    def call(self, steps: int) -> float:
        t0 = time.perf_counter()
        try:
            self._restore()
        except Exception as e:  # noqa: BLE001 - a failed restore is counted
            self.failed += 1
            _report(e)
        return time.perf_counter() - t0

    def verify(self) -> dict:
        return {"ckpt_mismatch": int(self.bad.item()) + self.steps_bad,
                "ckpt_checked": len(self.records)}

    def cleanup(self) -> None:
        if self.path:
            shutil.rmtree(self.path, ignore_errors=True)


def _report(e: BaseException) -> None:
    import sys

    print(f"portbench: checkpoint call failed: {type(e).__name__}: {e}", file=sys.stderr)


POLICIES = {"none": Policy, "take": TakePolicy, "async_take": AsyncTakePolicy,
            "restore": RestorePolicy}


def make_policy(job: Job, mix: dict, sampled: int) -> Policy:
    cls = POLICIES[mix["checkpoint"]]
    return cls(job, mix) if cls is Policy else cls(job, mix, sampled)


def window(job: Job, policy: Policy, seconds: float, sync) -> dict:
    """Run the closed loop for ``seconds``: a checkpoint call where the
    policy says so, then a step, until the time is up. Every step and
    every call that starts inside the time runs to its end; the window
    ends with the last of them."""
    steps_s: List[float] = []
    stalls: List[float] = []
    losses: List[float] = []
    sync()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    n = 0
    while time.perf_counter() < deadline:
        if policy.due(n):
            stalls.append(policy.call(n))
            if time.perf_counter() >= deadline:
                break
        with span("train_step"):
            a = time.perf_counter()
            losses.append(job.step())
            steps_s.append(time.perf_counter() - a)
        n += 1
    t1 = time.perf_counter()
    return {"window_s": t1 - t0, "steps_s": steps_s, "stalls_s": stalls, "losses": losses,
            "tokens": n * job.cfg["batch"] * job.cfg["max_seq_len"]}
