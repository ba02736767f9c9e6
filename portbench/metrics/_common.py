"""Helpers the metric readers share: means over a run's checkpoint
records, sums of the program's span seconds by category, and the
attention shape that the roofline readers count."""

from __future__ import annotations

import statistics
from typing import Iterable, Optional

from portbench import registry
from portbench.frozen import classify_span


def mean_ms(values: Iterable[Optional[float]]) -> Optional[float]:
    """The mean of the values that are there, in ms; None when none is."""
    got = [v for v in values if v is not None]
    return 1e3 * statistics.fmean(got) if got else None


def category_s(stages: dict, category: str, key: str) -> Optional[float]:
    """Seconds of a take's or restore's spans of ``category`` (the
    analyze category map), from its per-span ``stages``; None when it
    recorded none."""
    found = [agg[key] for name, agg in (stages or {}).items() if classify_span(name) == category]
    return sum(found) if found else None


def rate_gb_s(pairs: Iterable[tuple]) -> Optional[float]:
    """Sum of bytes over sum of seconds, in GB/s, over (bytes, seconds)
    pairs whose seconds were recorded."""
    pairs = [(b, s) for b, s in pairs if s]
    if not pairs:
        return None
    return sum(b for b, _ in pairs) / sum(s for _, s in pairs) / 1e9


def attention_shape(cfg: dict) -> Optional[tuple]:
    """The ``(batch, seq, heads, head_dim)`` that ``attention_bound`` and
    ``flash_backward_bound`` count for the model's attention: from the
    configuration's reference when it defines ``attention_shape(cfg)``
    (None where the attention is not of that form, as latent attention's
    unequal q/k and v heads), else heads of ``d_model // n_heads``."""
    hook = getattr(registry.reference(cfg["reference"]), "attention_shape", None)
    if hook is not None:
        return hook(cfg)
    return (cfg["batch"], cfg["max_seq_len"], cfg["n_heads"], cfg["d_model"] // cfg["n_heads"])
