"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have; the sound run comes out correct.
The runs skip the look for a card and run at a tiny size on the CPU."""

import time

import pytest
import torch

from portbench import harness

from .conftest import TINY_RUN

CELLS = ["big.async_mem", "big.sync_mem", "big.resume_fs"]


def _run(cell):
    return harness.run(cell, 2**31 + 11, 2.0, False, time.perf_counter(), device="cpu",
                       overrides=TINY_RUN)


def _failed(result):
    return sorted(k for k, c in result["checks"].items()
                  if (c["value"] < c["limit"] if c.get("at_least") else c["value"] > c["limit"]))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_step_that_leaves_the_state_unchanged(cell, monkeypatch):
    from tpusnap_torch.models import Transformer

    def frozen_step(self, tokens, learning_rate=1e-3):
        with torch.no_grad():
            return self.loss(tokens)

    monkeypatch.setattr(Transformer, "train_step", frozen_step)
    result = _run(cell)
    assert not result["correct"] and {"grad_gap", "update_gap"} <= set(_failed(result))


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out(cell, monkeypatch):
    from tpusnap_torch.models import Transformer

    whole = Transformer.train_step

    def half_step(self, tokens, learning_rate=1e-3):
        return whole(self, tokens[: tokens.shape[0] // 2], learning_rate)

    monkeypatch.setattr(Transformer, "train_step", half_step)
    result = _run(cell)
    assert not result["correct"] and "grad_gap" in _failed(result)


@pytest.mark.parametrize("cell", ["big.async_mem", "big.sync_mem", "big.resume_fs"])
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    """A restore that brings back one element wrong."""
    from tpusnap_torch import Snapshot

    restore = Snapshot.restore

    def altered(self, app_state, *args, **kwargs):
        restore(self, app_state, *args, **kwargs)
        with torch.no_grad():
            app_state["train"]["params"]["ln_f"][0] += 1.0

    monkeypatch.setattr(Snapshot, "restore", altered)
    result = _run(cell)
    assert not result["correct"] and _failed(result) == ["ckpt_mismatch"]


@pytest.mark.parametrize("cell", ["big.async_mem", "big.sync_mem"])
def test_a_take_that_saves_an_altered_state(cell, monkeypatch):
    """A take whose snapshot differs from the state at the call."""
    from tpusnap_torch import Snapshot

    name = "async_take" if cell == "big.async_mem" else "take"
    take = getattr(Snapshot, name).__func__

    def altered(cls, path, app_state, *args, **kwargs):
        ln_f = app_state["train"]["params"]["ln_f"]
        with torch.no_grad():
            ln_f[0] += 1.0
        try:
            out = take(cls, path, app_state, *args, **kwargs)
            if hasattr(out, "wait"):
                out.wait()
            return out
        finally:
            with torch.no_grad():
                ln_f[0] -= 1.0

    monkeypatch.setattr(Snapshot, name, classmethod(altered))
    result = _run(cell)
    assert not result["correct"] and "ckpt_mismatch" in _failed(result)
