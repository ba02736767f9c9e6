"""Each end-to-end statistic is taken over the whole window, and the
trace's reduction names the host's activity in each idle gap."""

import statistics

import numpy as np
import pytest

from portbench import frozen, registry, trace


def _run(steps_s, stalls_s, window_s, batch=8, seq=1024):
    return {"steps_s": steps_s, "stalls_s": stalls_s, "window_s": window_s,
            "tokens": len(steps_s) * batch * seq, "setup_s": 12.5}


def test_tokens_per_s_counts_the_stall_inside_the_window():
    steps = [0.04] * 32
    clean = registry.metric("train_tokens_per_s")(_run(steps, [], 1.28))
    stalled = registry.metric("train_tokens_per_s")(_run(steps, [0.4], 1.68))
    assert clean == pytest.approx(32 * 8192 / 1.28)
    assert stalled == pytest.approx(32 * 8192 / 1.68)


def test_p95_is_of_every_step_in_the_window():
    steps = [0.040] * 95 + [0.090] * 5 + [0.2]
    got = registry.metric("step_ms_p95")(_run(steps, [], 10.0))
    assert got == pytest.approx(np.percentile(steps, 95) * 1e3)
    # The median of pieces would hide the slow steps of one piece.
    halves = [np.percentile(steps[:50], 95), np.percentile(steps[50:], 95)]
    assert got != pytest.approx(statistics.median(halves) * 1e3)


def test_stall_is_all_checkpoint_time_over_the_checkpoints():
    got = registry.metric("take_stall_ms")(_run([0.04] * 64, [0.15, 0.35, 0.1], 3.2))
    assert got == pytest.approx(200.0)
    assert registry.metric("take_stall_ms")(_run([0.04] * 4, [], 0.16)) is None


def test_setup_is_read_as_measured():
    assert registry.metric("setup_s")(_run([0.04], [], 0.04)) == 12.5


def test_trace_reduction_unions_busy_time_and_names_gaps():
    ms = 1_000_000
    device = [(0, 4 * ms, "k1"), (2 * ms, 6 * ms, "k2"), (10 * ms, 12 * ms, "k1")]
    host = [(0, 8 * ms, "train_step"), (6 * ms + 1, 9 * ms, "async_take")]
    got = trace.summarize(device, host, 0, 14 * ms)
    assert got["window_s"] == pytest.approx(0.014)
    assert got["busy_s"] == pytest.approx(0.008)
    assert got["ops"]["k1"] == [2, pytest.approx(0.006)]
    # Gap 6-10 ms: its middle (8 ms) lies in async_take; 12-14 ms in none.
    assert got["idle"] == {"async_take": pytest.approx(0.004), "harness": pytest.approx(0.002)}
    idle = registry.metric("device_idle_pct")({"trace": got})
    assert idle == pytest.approx(100 * 6 / 14)
    assert trace.kernel_time(got, "k2") == (1, pytest.approx(0.004))
    br = trace.breakdown(got)
    assert br["device_ops"][0][0] == "k1" and len(br["idle_gaps"]) == 2


def test_roofline_readers_stay_silent_without_their_kernels():
    run = {"trace": trace.summarize([(0, 10, "other_kernel")], [], 0, 10),
           "config": registry.config("transformer-big")}
    assert registry.metric("flash_fwd_roofline")(run) is None
    assert registry.metric("attn_bwd_roofline")(run) is None


def test_roofline_share_from_calls_and_device_time():
    cfg = registry.config("transformer-big")
    bound_ms = frozen.attention_bound((8, 1024, 16, 64), "bfloat16", True)[0]
    us = 1000
    device = [(i * 100 * us, i * 100 * us + 40 * us, "void flash_fwd_wgmma<bf16>") for i in range(4)]
    run = {"trace": trace.summarize(device, [], 0, 400 * us), "config": cfg}
    # Four calls of 0.040 ms against the bound at the configuration's shape.
    assert registry.metric("flash_fwd_roofline")(run) == pytest.approx(100 * bound_ms / 0.040, rel=1e-9)
    assert round(bound_ms, 4) == 0.0200


def _attention_trace():
    us = 1000
    device = [(i * 100 * us, i * 100 * us + 40 * us, "void flash_fwd_wgmma<bf16>") for i in range(4)]
    device += [(i * 100 * us + 50 * us, i * 100 * us + 90 * us, "void ring_grads_wgmma<bf16>")
               for i in range(4)]
    return trace.summarize(device, [], 0, 400 * us)


ROOFLINES = [("flash_fwd_roofline", frozen.attention_bound),
             ("attn_bwd_roofline", frozen.flash_backward_bound)]


@pytest.mark.parametrize("name,bound", ROOFLINES)
def test_roofline_at_the_flagships_square_heads(name, bound):
    """The flagship's reference has no ``attention_shape``: heads of
    d_model / n_heads, as the readers always counted."""
    cfg = registry.config("transformer-big")
    assert not hasattr(registry.reference(cfg["reference"]), "attention_shape")
    bound_ms = bound((8, 1024, 16, 64), "bfloat16", True)[0]
    run = {"trace": _attention_trace(), "config": cfg}
    assert registry.metric(name)(run) == pytest.approx(100 * bound_ms / 0.040, rel=1e-9)


@pytest.mark.parametrize("name,bound", ROOFLINES)
@pytest.mark.parametrize("shape", [(4, 2048, 8, 128), None])
def test_roofline_at_the_references_attention_shape(name, bound, shape, monkeypatch):
    """A reference that defines ``attention_shape`` sets the shape counted;
    one whose attention has no such shape (None) leaves the metric
    unread."""
    import types

    stub = types.SimpleNamespace(attention_shape=lambda cfg: shape)
    real = registry.reference
    monkeypatch.setattr(registry, "reference",
                        lambda name, base=registry.HERE: stub if name == "stub" else real(name, base))
    cfg = dict(registry.config("transformer-big"), reference="stub")
    got = registry.metric(name)({"trace": _attention_trace(), "config": cfg})
    if shape is None:
        assert got is None
    else:
        bound_ms = bound(shape, "bfloat16", True)[0]
        assert got == pytest.approx(100 * bound_ms / 0.040, rel=1e-9)
