"""Frozen copies of the arithmetic the benchmark measures with.

Each piece is copied from the program's tree so that a later change to
the program cannot move the yardstick; the line above each names the file
it came from. Edit nothing here: a changed copy changes every reading.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and dense
# bf16/f16 tensor-core FLOP/s; f32 outside the tensor cores.
# Copied from chip_smoke.py (HBM_BYTES_PER_S, PEAK_FLOPS).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


# Copied from chip_smoke.py (_tokens), widened to n batches drawn in one call
# (n = 1 gives _tokens' draw exactly) and left on the host.
def tokens(vocab_size: int, n: int, batch: int, seq: int, seed: int) -> np.ndarray:
    """``n`` batches of ``batch`` rows of ``seq`` token ids, uniform over
    the vocabulary, from ``numpy.random.default_rng(seed)``: int64
    ``[n, batch, seq]``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab_size, (n * batch, seq)).reshape(n, batch, seq)


# Copied from chip_smoke.py (attention_flops).
def attention_flops(shape, causal: bool) -> int:
    """FLOPs of QK^T and PV over the pairs the mask keeps (2 per
    multiply-add)."""
    b, s, h, d = shape
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * b * h * d * pairs


# Copied from chip_smoke.py (attention_bound).
def attention_bound(shape, dtype: str, causal: bool):
    """(least ms, "bytes" or "operations") for one attention forward at
    ``shape``: the larger of the bytes (q, k, v read once, o written
    once) over HBM and the operations these inputs need (the causal
    pairs only) over the peak rate of their type."""
    b, s, h, d = shape
    nbytes = 4 * b * s * h * d * _ITEMSIZE[dtype]
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * attention_flops(shape, causal) / PEAK_FLOPS[dtype]
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


# Copied from chip_smoke.py (flash_backward_bound).
def flash_backward_bound(shape, dtype: str, causal: bool):
    """(least ms, "bytes" or "operations") for flash attention's gradients
    at ``shape``: the larger of the bytes (q, k, v and dO read once, dq, dk
    and dv written once, all in the inputs' type) over HBM and the
    operations of the pairs the mask keeps (S, dP, dV, dQ and dK, 2 per
    multiply-add) over the peak rate of the inputs' type."""
    b, s, h, d = shape
    bytes_ms = 1e3 * 7 * b * s * h * d * _ITEMSIZE[dtype] / HBM_BYTES_PER_S
    ops_ms = 1e3 * 2.5 * attention_flops(shape, causal) / PEAK_FLOPS[dtype]
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


# Copied from tpusnap_torch/analyze.py (_CATEGORY_EXACT, _CATEGORY_PREFIX,
# EXCLUDED_SPANS, classify_span).
EXCLUDED_SPANS = frozenset({"stage_window", "stage_blocked", "async_blocked", "probe_roofline"})
_CATEGORY_EXACT = {
    "storage_write": "storage_write",
    "storage_read": "storage_read",
    "stage_buffer": "stage",
    "dtoh": "dtoh",
    "host_offload.dtoh": "dtoh",
    "checksum": "checksum",
    "checksum_late": "checksum",
    "cow_verify": "checksum",
    "compress": "compress",
    "consume": "consume",
    "restore.decode": "decode",
    "budget_wait": "budget_wait",
}
_CATEGORY_PREFIX = (("comm.", "barrier"), ("kv.", "barrier"))


def classify_span(name: str) -> Optional[str]:
    """Resource category of a span name, or None for container spans and
    names outside every category."""
    if name in EXCLUDED_SPANS:
        return None
    cat = _CATEGORY_EXACT.get(name)
    if cat is not None:
        return cat
    for prefix, c in _CATEGORY_PREFIX:
        if name.startswith(prefix):
            return c
    return None
