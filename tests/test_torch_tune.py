"""The port's tuner, mirrored from tests/test_tune.py (planner
determinism, cell pinning, verdict-driven rules, the explicit-env-wins
overlay, the CLI exit-3 contract, the ``tuned`` stamp in the history
event, the probe's read lane on a fake clock), plus cross-package
checks: ``build_plan`` gives tpusnap's plan and ``plan_id`` on the same
inputs, and each of the five knobs the tuner sets is read through the
overlay by its getter.
"""

import asyncio
import json
import os

import numpy as np
import torch
import pytest

from tpusnap_torch import PytreeState, Snapshot
from tpusnap_torch import compress, knobs, telemetry
from tpusnap_torch.__main__ import main
from tpusnap_torch.history import history_path, load_history
from tpusnap_torch.knobs import (
    override_autotune,
    override_probe,
    override_telemetry_dir,
)
from tpusnap_torch.tune import MIN_EVENTS, build_plan, select_events

GiB = 1 << 30
MiB = 1 << 20


@pytest.fixture(autouse=True)
def _leave_no_probe_ceilings():
    """Every probe sample notes a read or write ceiling in its package's
    process-wide registry (both packages' when the shared TPUSNAP_PROBE
    makes a tpusnap take probe too); an SLO estimate in a later test file
    of the same worker would find it (ROADMAP.md C9). Cleared after each
    test, in both packages."""
    yield
    import sys

    from tpusnap_torch import compress as port_compress

    port_compress._reset_ceilings()
    jax_compress = sys.modules.get("tpusnap.compress")
    if jax_compress is not None:
        jax_compress._reset_ceilings()


def _events(n, kind="restore", plugin="FSStoragePlugin", world_size=1,
            bytes_=GiB, wall_s=2.0, **extra):
    return [
        {"kind": kind, "plugin": plugin, "world_size": world_size,
         "bytes": bytes_, "wall_s": wall_s, **extra}
        for _ in range(n)
    ]


# ------------------------------------------------------------ planner


def test_build_plan_deterministic(monkeypatch):
    """Same history + same ceilings → byte-identical plan (same
    plan_id, same knob values), call after call — the property that
    lets `history --check` group runs by the plan they ran under."""
    monkeypatch.delenv("TPUSNAP_PROBE_INTERVAL_BYTES", raising=False)
    events = _events(5)
    plans = [
        build_plan(events, "restore", ceilings={}, codec_gbps=0.0)
        for _ in range(2)
    ]
    for plan in plans:
        assert plan.ok
        assert plan.backend == "FSStoragePlugin"
        assert plan.world_size == 1
        assert plan.n_events == 5
    # 1 GiB median payload, 2 GiB default cadence: the probe-interval
    # rule fires (≥2x off) and proposes 1/8th of the payload.
    knob_envs = {k.env: k.value for k in plans[0].knobs}
    assert knob_envs == {"TPUSNAP_PROBE_INTERVAL_BYTES": str(GiB // 8)}
    assert plans[0].plan_id == plans[1].plan_id
    assert [k.to_json() for k in plans[0].knobs] == [
        k.to_json() for k in plans[1].knobs
    ]


def test_insufficient_history_not_ok():
    plan = build_plan(_events(MIN_EVENTS - 1), "restore", ceilings={},
                      codec_gbps=0.0)
    assert not plan.ok
    assert plan.plan_id is None
    assert plan.n_events == MIN_EVENTS - 1
    assert f"need {MIN_EVENTS}" in plan.reason
    assert "TPUSNAP_PROBE=1" in plan.reason


def test_cell_pins_to_newest_backend():
    """With no --backend, the cell pins to the NEWEST event's backend
    and drops other tiers — medians must never mix tiers."""
    events = _events(4, plugin="S3StoragePlugin") + _events(3)
    plan = build_plan(events, "restore", ceilings={}, codec_gbps=0.0)
    assert plan.backend == "FSStoragePlugin"
    assert plan.n_events == 3
    cell = select_events(events, "restore", backend="S3StoragePlugin")
    assert len(cell) == 4


def test_decode_verdict_flips_compression(monkeypatch):
    """analyze verdict 'decode' → the plan pins TPUSNAP_COMPRESS=off
    for this tier (the read pipe outruns the decompressor)."""
    monkeypatch.delenv("TPUSNAP_COMPRESS", raising=False)
    plan = build_plan(_events(3, bytes_=8 * GiB), "restore", ceilings={},
                      verdict="decode", codec_gbps=0.0)
    assert plan.ok
    by_env = {k.env: k for k in plan.knobs}
    assert by_env["TPUSNAP_COMPRESS"].value == "off"
    assert "decode" in by_env["TPUSNAP_COMPRESS"].rationale
    # And the verdict-free plan for the same cell proposes no flip.
    plain = build_plan(_events(3, bytes_=8 * GiB), "restore", ceilings={},
                       codec_gbps=0.0)
    assert "TPUSNAP_COMPRESS" not in {k.env for k in plain.knobs}
    assert plain.plan_id != plan.plan_id


# ------------------------------------------- explicit-env-wins overlay


def test_tuned_overlay_env_always_wins(monkeypatch):
    """apply_tuned_plan skips knobs the environment sets explicitly,
    and _env_get resolves env → overlay → default, so an operator's
    `export` beats the tuner per lookup."""
    monkeypatch.setenv("TPUSNAP_PROBE_INTERVAL_BYTES", "123")
    monkeypatch.delenv("TPUSNAP_STAGE_THREADS", raising=False)
    try:
        applied = knobs.apply_tuned_plan(
            "deadbeef0123",
            {"TPUSNAP_PROBE_INTERVAL_BYTES": "999",
             "TPUSNAP_STAGE_THREADS": "8"},
        )
        # Only the env-free knob landed; that subset is what the
        # history event's `tuned.knobs` stamp records.
        assert applied == {"TPUSNAP_STAGE_THREADS": "8"}
        assert knobs.tuned_plan() == {
            "plan_id": "deadbeef0123",
            "knobs": {"TPUSNAP_STAGE_THREADS": "8"},
        }
        assert knobs._env_get("TPUSNAP_PROBE_INTERVAL_BYTES") == "123"
        assert knobs._env_get("TPUSNAP_STAGE_THREADS") == "8"
        # The env value wins at the lookup layer; the knob's own 16 MiB
        # cadence floor still applies on top of whichever layer won.
        assert knobs.get_probe_interval_bytes() == 16 * MiB
    finally:
        knobs.clear_tuned_plan()
    assert knobs.tuned_plan() is None
    assert knobs._env_get("TPUSNAP_STAGE_THREADS") is None


def test_tuned_overlay_fully_shadowed_plan_is_not_a_plan(monkeypatch):
    """A plan whose every knob the env already sets applies nothing —
    tuned_plan() stays None so no bogus stamp rides the history."""
    monkeypatch.setenv("TPUSNAP_PROBE_INTERVAL_BYTES", "123")
    try:
        applied = knobs.apply_tuned_plan(
            "cafecafecafe", {"TPUSNAP_PROBE_INTERVAL_BYTES": "999"}
        )
        assert applied == {}
        assert knobs.tuned_plan() is None
    finally:
        knobs.clear_tuned_plan()


# ------------------------------------------------------------ CLI


def test_tune_cli_insufficient_history_exits_3(tmp_path, capsys):
    with override_telemetry_dir(str(tmp_path / "tele")):
        rc = main(["tune", "--check", "--kind", "restore"])
    assert rc == 3
    assert "no plan" in capsys.readouterr().out


def test_tune_cli_json_and_env_render(tmp_path, capsys):
    hist = tmp_path / "history.jsonl"
    with open(hist, "w") as f:
        for e in _events(3):
            f.write(json.dumps(e) + "\n")
    rc = main(["tune", "--file", str(hist), "--kind", "restore",
               "--json"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"]
    assert doc["cell"] == {
        "backend": "FSStoragePlugin", "kind": "restore", "world_size": 1,
    }
    assert doc["plan_id"]
    planned = {k["env"]: k["value"] for k in doc["knobs"]}
    assert "TPUSNAP_PROBE_INTERVAL_BYTES" in planned
    rc = main(["tune", "--file", str(hist), "--kind", "restore", "--env"])
    assert rc == 0
    out = capsys.readouterr().out
    for env, value in planned.items():
        assert f"export {env}={value}" in out


# -------------------------------------------- autotune reconcile stamp


def test_autotune_stamps_plan_into_history_event(tmp_path, monkeypatch):
    """TPUSNAP_AUTOTUNE end to end: seed a cell with clones of a REAL
    restore event (real plugin label — no label guessing), rerun the
    restore under autotune, and the new history event carries the
    ``tuned: {plan_id, knobs}`` stamp matching the CLI's plan. The
    overlay is scoped to the restore: cleared by the time it returns."""
    monkeypatch.delenv("TPUSNAP_PROBE_INTERVAL_BYTES", raising=False)
    compress._reset_ceilings()
    snap = str(tmp_path / "snap")
    state = {"w": torch.arange(65536, dtype=torch.float32)}
    with override_telemetry_dir(str(tmp_path / "tele")):
        Snapshot.take(snap, {"m": PytreeState(state)})
        Snapshot(snap).restore(
            {"m": PytreeState({"w": torch.zeros(65536, dtype=torch.float32)})}
        )
        base = [e for e in load_history() if e.get("kind") == "restore"][-1]
        assert "tuned" not in base  # autotune was off
        with open(history_path(), "a") as f:
            for _ in range(3):
                f.write(json.dumps(dict(base, bytes=GiB, wall_s=2.0)) + "\n")
        expected = build_plan(
            load_history(), "restore",
            ceilings=compress.pipe_ceilings_snapshot(),
        )
        assert expected.ok and expected.knobs, expected.reason
        with override_autotune(True):
            Snapshot(snap).restore(
                {"m": PytreeState({"w": torch.zeros(65536, dtype=torch.float32)})}
            )
        assert knobs.tuned_plan() is None
        ev = [e for e in load_history() if e.get("kind") == "restore"][-1]
    assert ev.get("tuned"), ev
    assert ev["tuned"]["plan_id"] == expected.plan_id
    assert ev["tuned"]["knobs"] == {
        k.env: k.value for k in expected.knobs
    }
    assert "TPUSNAP_PROBE_INTERVAL_BYTES" in ev["tuned"]["knobs"]


def test_autotune_off_by_default(tmp_path):
    compress._reset_ceilings()
    snap = str(tmp_path / "snap")
    state = {"w": torch.arange(4096, dtype=torch.float32)}
    with override_telemetry_dir(str(tmp_path / "tele")):
        Snapshot.take(snap, {"m": PytreeState(state)})
        Snapshot(snap).restore(
            {"m": PytreeState({"w": torch.zeros(4096, dtype=torch.float32)})}
        )
        ev = [e for e in load_history() if e.get("kind") == "restore"][-1]
    assert "tuned" not in ev


# --------------------------------------------- probe read-lane units


def test_probe_read_lane_units_fake_clock(monkeypatch):
    """Deterministic-clock unit check: with the storage legs pinned to
    0.125 s each, the probe's read sample must come out at exactly
    nbytes / 0.125 / 1e9 GB/s — and feed the ceiling registry's READ
    lane (the write leg feeds the write lane), which is what prices
    restore_roofline_fraction and the slo cold-start fallback."""
    from tpusnap_torch import scheduler as sched_mod
    from tpusnap_torch.io_types import StoragePlugin
    from tpusnap_torch.scheduler import _ProbeRunner

    class NullPlugin(StoragePlugin):
        async def write(self, write_io):
            pass

        async def read(self, read_io):
            pass

        async def delete(self, path):
            pass

    class FakeTime:
        def __init__(self, step):
            self.t, self.step = 0.0, step

        def monotonic(self):
            self.t += self.step
            return self.t

        def __getattr__(self, name):  # sleep etc. pass through
            import time as _real

            return getattr(_real, name)

    compress._reset_ceilings()
    try:
        with override_probe(True, interval_bytes=1 * MiB,
                            probe_bytes=8 * MiB):
            tele = telemetry.TakeTelemetry(rank=0, enabled=True)
            try:
                runner = _ProbeRunner(NullPlugin(), rank=0, tele=tele)
                monkeypatch.setattr(sched_mod, "time", FakeTime(0.125))
                runner.note_written(32 * MiB)  # past the 16 MiB floor
                assert runner.due
                asyncio.run(runner.run())
            finally:
                tele.finalize()
        assert runner.ran == 1
        assert not runner.due  # counter reset after the probe
        nbytes = runner.stream_bytes * _ProbeRunner._STREAMS
        assert nbytes == 8 * MiB
        want = round(nbytes / 0.125 / 1e9, 4)
        s = tele.summary()
        assert s["probe"]["probes"] == 1
        assert s["probe"]["read_gbps_p50"] == want
        assert s["probe"]["write_gbps_p50"] == want
        snap = compress.pipe_ceilings_snapshot()
        assert snap[(runner._label, "read")] == want
        assert snap[(runner._label, "write")] == want
    finally:
        compress._reset_ceilings()


# ------------------------------------------------------ cross-package

_PLAN_CASES = {
    "restore_probe_interval": dict(events=_events(5), kind="restore"),
    "take_stage_verdict": dict(events=_events(4, kind="take"), kind="take", verdict="stage"),
    "take_async_window": dict(
        events=_events(4, kind="take", wall_s=2.0, async_blocked_s=1.5), kind="take"
    ),
    "restore_storage_read_budget": dict(
        events=_events(3, budget_high_water_bytes=256 * MiB),
        kind="restore",
        verdict="storage_read",
    ),
    "restore_access_working_set": dict(
        events=_events(3, bytes_=8 * GiB, access_working_set_bytes=GiB,
                       access_bytes_read=GiB),
        kind="restore",
    ),
    "decode_verdict": dict(events=_events(3, bytes_=8 * GiB), kind="restore", verdict="decode"),
    "fast_pipe_bypasses": dict(
        events=_events(3, kind="take"), kind="take",
        ceilings={("FSStoragePlugin", "write"): 8.0}, codec_gbps=1.0,
    ),
    "slow_pipe_compresses": dict(
        events=_events(3, kind="take"), kind="take",
        ceilings={("FSStoragePlugin", "write"): 0.2}, codec_gbps=1.0,
    ),
    "other_world_size": dict(
        events=_events(3, world_size=4) + _events(3, world_size=2), kind="restore"
    ),
    "insufficient": dict(events=_events(1), kind="restore"),
}


@pytest.mark.parametrize("case", sorted(_PLAN_CASES))
def test_build_plan_matches_tpusnap(case, monkeypatch):
    """The same history, ceilings and verdict give tpusnap's plan: the
    same knobs, values, rationales and ``plan_id``."""
    from tpusnap.tune import build_plan as jax_build_plan

    for env in ("TPUSNAP_PROBE_INTERVAL_BYTES", "TPUSNAP_COMPRESS", "TPUSNAP_STAGE_THREADS",
                "TPUSNAP_ASYNC_STAGE_WINDOW_BYTES",
                "TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES"):
        monkeypatch.delenv(env, raising=False)
    kw = dict(_PLAN_CASES[case])
    kw.setdefault("ceilings", {})
    kw.setdefault("codec_gbps", 0.0)
    ours = build_plan(**kw)
    theirs = jax_build_plan(**kw)
    assert ours.to_json() == theirs.to_json()
    assert ours.plan_id == theirs.plan_id
    if case != "insufficient":
        assert ours.ok and ours.plan_id


_TUNED_KNOBS = {
    "TPUSNAP_STAGE_THREADS": ("3", lambda: knobs.get_stage_threads(), 3),
    "TPUSNAP_ASYNC_STAGE_WINDOW_BYTES": (
        str(64 * MiB), lambda: knobs.get_async_stage_window_bytes(), 64 * MiB
    ),
    "TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES": (
        str(512 * MiB), lambda: knobs.get_memory_budget_override_bytes(), 512 * MiB
    ),
    "TPUSNAP_COMPRESS": ("on", lambda: knobs.get_compress_mode(), "on"),
    "TPUSNAP_PROBE_INTERVAL_BYTES": (
        str(32 * MiB), lambda: knobs.get_probe_interval_bytes(), 32 * MiB
    ),
}


@pytest.mark.parametrize("env", sorted(_TUNED_KNOBS))
def test_tuned_knob_is_read_through_the_overlay(env, monkeypatch):
    """Every knob the tuner may set goes through the overlay: an applied
    plan changes what its getter returns, an explicit env var still
    wins, and clearing the plan restores the default."""
    value, getter, expected = _TUNED_KNOBS[env]
    monkeypatch.delenv(env, raising=False)
    default = getter()
    assert default != expected
    try:
        assert knobs.apply_tuned_plan("p1", {env: value}) == {env: value}
        assert getter() == expected
        explicit = {"TPUSNAP_COMPRESS": "off",
                    "TPUSNAP_MAX_PER_RANK_MEMORY_BUDGET_BYTES": str(256 * MiB)}
        monkeypatch.setenv(env, explicit.get(env, str(default)))
        assert getter() != expected
        monkeypatch.delenv(env)
        assert getter() == expected
    finally:
        knobs.clear_tuned_plan()
    assert getter() == default


def test_autotune_plan_id_matches_the_cli(tmp_path, monkeypatch, capsys):
    """With enough history, an autotuned take stamps the plan that
    ``tune --json`` prints for the same cell: same ``plan_id``."""
    monkeypatch.delenv("TPUSNAP_PROBE_INTERVAL_BYTES", raising=False)
    with override_telemetry_dir(str(tmp_path / "tele")):
        state = {"w": torch.arange(65536, dtype=torch.float32)}
        for i in range(MIN_EVENTS):
            Snapshot.take(str(tmp_path / f"s{i}"), {"m": PytreeState(dict(state))})
        assert main(["tune", "--kind", "take", "--json"]) == 0
        printed = json.loads(capsys.readouterr().out)
        with override_autotune(True):
            Snapshot.take(str(tmp_path / "tuned"), {"m": PytreeState(dict(state))})
        event = load_history(history_path())[-1]
    assert event["tuned"]["plan_id"] == printed["plan_id"]
    assert event["tuned"]["knobs"] == {k["env"]: k["value"] for k in printed["knobs"]}
