"""The yardstick's arithmetic: FLOPs a step, kernel bounds, the feed."""

import numpy as np
import pytest

from portbench import frozen, registry

FLASH_SHAPE = (8, 1024, 8, 64)


def test_step_flops():
    cfg = registry.config("transformer-big")
    flops = 5882360365056
    assert registry.reference(cfg["reference"]).step_flops(cfg) == flops
    assert cfg["flops_per_step"] == flops
    # 6 T P_mm with P_mm = 6 (4 D^2 + 2 D F) + D V, and 6 B S^2 D L.
    T, D, F, V = 8 * 1024, 1024, 4096, 37000
    assert flops == 6 * T * (6 * (4 * D * D + 2 * D * F) + D * V) + 6 * 8 * 1024 ** 2 * D * 6


def test_flash_forward_bound():
    ms, by = frozen.attention_bound(FLASH_SHAPE, "bfloat16", True)
    assert by == "bytes" and round(ms, 4) == 0.0100
    # At Transformer big's 16 heads: twice the bytes of 8.
    ms, by = frozen.attention_bound((8, 1024, 16, 64), "bfloat16", True)
    assert by == "bytes" and round(ms, 4) == 0.0200
    assert frozen.attention_flops(FLASH_SHAPE, True) == 4 * 8 * 8 * 64 * (1024 * 1025 // 2)


def test_flash_backward_bound():
    ms, by = frozen.flash_backward_bound(FLASH_SHAPE, "bfloat16", True)
    assert by == "operations" and round(ms, 4) == 0.0217


def test_feed_is_the_smoke_generator_widened():
    one = frozen.tokens(32768, 1, 8, 1024, 7)
    rng = np.random.default_rng(7)
    assert np.array_equal(one[0], rng.integers(0, 32768, (8, 1024)))
    many = frozen.tokens(32768, 5, 8, 1024, 7)
    assert np.array_equal(many[0], one[0]) and many.shape == (5, 8, 1024)
    assert not np.array_equal(many[1], many[2])


def test_categories_follow_the_analyze_map():
    assert frozen.classify_span("dtoh") == "dtoh"
    assert frozen.classify_span("host_offload.dtoh") == "dtoh"
    assert frozen.classify_span("consume") == "consume"
    assert frozen.classify_span("comm.barrier") == "barrier"
    assert frozen.classify_span("stage_window") is None
