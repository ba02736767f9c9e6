#!/usr/bin/env python3
"""Where the ring block kernels' time goes, on one NVIDIA GPU:

    python3 ring_block_probe.py [--backward] [--tree DIR] [--out FILE]

It copies ``tpusnap_torch`` (of ``DIR``, a checkout of another commit,
when given; of this one otherwise) into a temporary directory, adds
``clock64`` stamps to the copy's kernel (the repo's sources have no
instrumentation knob), builds the copy and runs it in a process of its
own. The stamps go in at exact lines of the kernel's source
(``_instrument`` and ``_instrument_backward``): when those lines change,
the probe stops with the line it did not find, and its anchors change
with the kernel.

Forward (``csrc/ring_block_wgmma.cu``, the default): the clocks between
stamps are charged to the waits on Q (``wait_q``), on the carry in
(``carry_in``, its reads included), on the other warpgroup's turn
(``turn``), on ``full_k`` and ``full_v`` (``wait_k``, ``wait_v``), on the
QK^T and PV products (``wgmma_qk``, ``wgmma_pv``), to issuing the
products (``issue``), the softmax, the rescale and P's rounding
(``rescale_round``), the tiles past a warpgroup's last key
(``skipped_tiles``), the epilogue and the rest (``other``: between
items, and the end). One launch per case after a warm one; per case the
mean over warpgroups of each category's clocks and share, and the
slowest warpgroup's. The cases are the ring block kernel's launches on
the flagship's path: the two-rank block (8, 512, 8, 64) bf16 as middle
and last on a past block, first and first+last on the diagonal, middle
on the diagonal, and the ring of one's first+last launch at
(8, 1024, 8, 64).

``--backward`` (``csrc/ring_block_bwd_wgmma.cu``): each consumer
warpgroup's clocks go to the wait for its own tiles (``wait_own``), the
waits on the streamed tiles (``wait_tiles``), the first-stage products
(S and dP: ``stage1``), the recompute of P and dS and their rounding
(``recompute``), the second-stage products (dV, dK or dQ: ``stage2``),
the accumulators' read-modify-write or the gradients' store
(``epilogue``) and the rest (``other``: the per-tile barrier and row
statistics of the two-launch kernel, items, the end). Beside them, from
``%globaltimer`` and ``%smid``, each launch's span and its ``tail``: the
mean over SMs of the time from an SM's last finished tile to the
launch's end, as a share of the span. Both kernel generations have
anchors (the two-launch kernel of the parent commits and the one-launch
kernel): the probe finds which the source holds. The cases are the
flagship's ring blocks (8, 512, 8, 64) bf16, diagonal and past, added
into f32 accumulators, and (8, 1024, 8, 64) causal from offsets (0, 0),
the flash backward's call (written in bf16 where the kernel has a store
mode; added into f32 accumulators otherwise).

Prints one JSON object; ``--out`` writes it to a file too. Needs nvcc
(``CUDA_HOME``) and one card; imports neither JAX nor tpusnap.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL = os.path.join("tpusnap_torch", "csrc", "ring_block_wgmma.cu")
BWD_KERNEL = os.path.join("tpusnap_torch", "csrc", "ring_block_bwd_wgmma.cu")
NAMES = ["wait_q", "turn", "wait_k", "wait_v", "wgmma_qk", "softmax", "wgmma_pv",
         "rescale_round", "epilogue", "other", "issue", "carry_in", "skipped_tiles"]
SLOTS = 16  # per warpgroup: the 13 categories (from 1), items (14), tiles (15)
SEED = 0
RING_BLOCK_SHAPE = (8, 512, 8, 64)  # the flagship's two-rank ring block
SLICE_SHAPE = (8, 1024, 8, 64)  # the flagship's whole sequence: the ring of one


class _Source:
    def __init__(self, text: str, path: str = KERNEL) -> None:
        self.text = text
        self.path = path

    def rep(self, old: str, new: str) -> None:
        if self.text.count(old) != 1:
            raise RuntimeError(f"probe anchor not found once in {self.path}: {old[:80]!r}")
        self.text = self.text.replace(old, new)


def _instrument(text: str) -> str:
    """The kernel with clock64 stamps (``split``)."""
    s = _Source(text)
    s.rep("namespace {\n\nusing namespace tpusnap_ptx;",
          f"__device__ unsigned long long g_split[1024 * 2 * {SLOTS}];\n\n"
          "namespace {\n\nusing namespace tpusnap_ptx;")
    s.rep("    setmaxnreg_inc<kConsumerRegs>();\n    const int wg = threadIdx.x / 128;",
          "    setmaxnreg_inc<kConsumerRegs>();\n"
          f"    __shared__ unsigned int s_split[2][{SLOTS}];\n"
          "    const int wg = threadIdx.x / 128;\n"
          "    const bool stamper = threadIdx.x % 128 == 0;\n"
          f"    if (stamper) for (int c = 0; c < {SLOTS}; ++c) s_split[wg][c] = 0;\n"
          "    long long t_last = clock64(), t_now;\n"
          "#define STAMP(c) do { t_now = clock64(); if (stamper) s_split[wg][c] += "
          "unsigned(t_now - t_last); t_last = t_now; } while (0)")
    s.rep("      mbar_wait(&full_k[slot], ((kv0 + t) / kStages) & 1);\n      wgmma_fence();",
          "      mbar_wait(&full_k[slot], ((kv0 + t) / kStages) & 1);\n      STAMP(3);\n"
          "      wgmma_fence();")
    s.rep("        Mma<T>::ss(acc_s, da, db, kk > 0);\n      }\n      wgmma_commit();",
          "        Mma<T>::ss(acc_s, da, db, kk > 0);\n      }\n      wgmma_commit();\n"
          "      STAMP(11);")
    s.rep("      mbar_wait(&full_v[slot], ((kv0 + t) / kStages) & 1);\n      wgmma_fence();",
          "      mbar_wait(&full_v[slot], ((kv0 + t) / kStages) & 1);\n      STAMP(4);\n"
          "      wgmma_fence();")
    s.rep("        Mma<T>::rs(acc_o, a_p[j], db, 1);\n      }\n      wgmma_commit();",
          "        Mma<T>::rs(acc_o, a_p[j], db, 1);\n      }\n      wgmma_commit();\n"
          "      STAMP(11);")
    s.rep("      q_first = w.q_block0 + wg * 64;",
          "      STAMP(10);\n      if (stamper) s_split[wg][14] += 1;\n"
          "      q_first = w.q_block0 + wg * 64;")
    s.rep("      mbar_wait(bar_q, it & 1);\n      float alpha[2];\n      turn_begin();\n"
          "      issue_qk(0);",
          "      if (stamper) s_split[wg][15] += n_own;\n      mbar_wait(bar_q, it & 1);\n"
          "      STAMP(1);\n      float alpha[2];\n      turn_begin();\n      STAMP(2);\n"
          "      issue_qk(0);")
    s.rep("      wgmma_wait<0>();\n      fence_regs(acc_s);\n      softmax(0, alpha);",
          "      STAMP(12);\n      wgmma_wait<0>();\n      fence_regs(acc_s);\n      STAMP(5);\n"
          "      softmax(0, alpha);\n      STAMP(6);")
    s.rep("  // the carry's rescale\n      round_p();",
          "  // the carry's rescale\n      round_p();\n      STAMP(8);")
    s.rep("        turn_begin();\n        issue_qk(t);",
          "        turn_begin();\n        STAMP(2);\n        issue_qk(t);")
    s.rep("        wgmma_wait<1>();\n        fence_regs(acc_s);\n        softmax(t, alpha);\n"
          "        wgmma_wait<0>();\n        fence_regs(acc_o);\n#pragma unroll\n"
          "        for (int j = 0; j < kPSteps; ++j) fence_regs(a_p[j]);",
          "        wgmma_wait<1>();\n        fence_regs(acc_s);\n        STAMP(5);\n"
          "        softmax(t, alpha);\n        STAMP(6);\n        wgmma_wait<0>();\n"
          "        fence_regs(acc_o);\n#pragma unroll\n"
          "        for (int j = 0; j < kPSteps; ++j) fence_regs(a_p[j]);\n        STAMP(7);")
    s.rep("        round_p();\n      }\n", "        round_p();\n        STAMP(8);\n      }\n")
    s.rep("      turn_begin();\n      issue_pv(n_own - 1);\n      turn_end();\n"
          "      wgmma_wait<0>();\n      fence_regs(acc_o);",
          "      turn_begin();\n      STAMP(2);\n      issue_pv(n_own - 1);\n      turn_end();\n"
          "      wgmma_wait<0>();\n      fence_regs(acc_o);\n      STAMP(7);")
    s.rep("      kv0 += w.n_tiles;\n", "      kv0 += w.n_tiles;\n      STAMP(13);\n")
    s.rep("      ++it;\n    }\n    if (Cfg::kStaged",
          "      ++it;\n      STAMP(9);\n    }\n    if (Cfg::kStaged")
    s.rep("    if (wg == 0) turn_begin();\n  }\n}",
          "    if (wg == 0) turn_begin();\n    STAMP(10);\n"
          f"    if (stamper) for (int c = 0; c < {SLOTS}; ++c)\n"
          f"      g_split[(blockIdx.x * 2 + wg) * {SLOTS} + c] = s_split[wg][c];\n  }}\n}}")
    return s.text + (
        '\nextern "C" int tpusnap_ring_split_read(void* host) {\n'
        "  return int(cudaMemcpyFromSymbol(host, g_split, sizeof(g_split)));\n}\n"
        'extern "C" int tpusnap_ring_split_reset() {\n'
        f"  static unsigned long long zeros[1024 * 2 * {SLOTS}];\n"
        "  return int(cudaMemcpyToSymbol(g_split, zeros, sizeof(g_split)));\n}\n"
    )


# The backward split: per record (a consumer warpgroup of a CTA of one
# launch) the clocks of each category (slots 1-7), tiles (8), the first
# and last %globaltimer (9, 10), %smid + 1 (11) and items (12).
BWD_NAMES = ["wait_own", "wait_tiles", "stage1", "recompute", "stage2", "epilogue", "other"]
BWD_SLOTS = 16
BWD_MAX_CTAS = 2048  # per launch: (8, 1024, 8, 64) is 1024 CTAs of the two-launch kernel
BWD_RECORDS = 2 * BWD_MAX_CTAS * 2  # launches x CTAs x warpgroups

_BWD_HELPERS = (
    f"__device__ unsigned long long g_split[{BWD_RECORDS} * {BWD_SLOTS}];\n"
    "__device__ __forceinline__ unsigned long long probe_ns() {\n"
    "  unsigned long long t;\n"
    '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
    "  return t;\n}\n"
    "__device__ __forceinline__ unsigned probe_smid() {\n"
    "  unsigned id;\n"
    '  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));\n'
    "  return id;\n}\n"
    "#define STAMP(c) do { t_now = clock64(); if (stamper) s_split[c] += "
    "unsigned(t_now - t_last); t_last = t_now; } while (0)\n\n"
)


def _bwd_record(launch: str, wg: str) -> str:
    """Writes the stamper's record (launch part, CTA, warpgroup)."""
    return (
        "  if (stamper) {\n"
        f"    unsigned long long* rec = g_split + ((({launch}) * {BWD_MAX_CTAS} + blockIdx.x) * 2"
        f" + ({wg})) * {BWD_SLOTS};\n"
        "    for (int c = 1; c <= 8; ++c) rec[c] = s_split[c];\n"
        "    rec[9] = g_start;\n    rec[10] = probe_ns();\n"
        "    rec[11] = probe_smid() + 1;\n    rec[12] = s_split[12];\n  }\n"
    )


def _instrument_backward(text: str) -> str:
    """The backward block kernel with clock64 stamps: the two-launch kernel
    (a dK/dV and a dQ launch, one warpgroup a CTA) or the one-launch
    kernel (a producer warp, persistent CTAs, consumer warpgroups), by
    what the source holds."""
    s = _Source(text, BWD_KERNEL)
    s.rep("namespace {\n\nusing namespace tpusnap_ptx;",
          _BWD_HELPERS + "namespace {\n\nusing namespace tpusnap_ptx;")
    init = (
        "  const bool stamper = threadIdx.x % 128 == 0;\n"
        f"  __shared__ unsigned int s_split_all[2][{BWD_SLOTS}];\n"
        "  unsigned int* s_split = s_split_all[(threadIdx.x / 128) % 2];\n"
        f"  if (stamper) for (int c = 0; c < {BWD_SLOTS}; ++c) s_split[c] = 0;\n"
        "  const unsigned long long g_start = probe_ns();\n"
        "  long long t_last = clock64(), t_now;\n"
    )
    if "const Work w = work_of<kDQ>(p, b, h);\n  if (w.t_begin >= w.t_end) return;  //" in text:
        # The two-launch kernel (a dK/dV and a dQ launch): one warpgroup, one
        # own tile a CTA.
        s.rep("  const Work w = work_of<kDQ>(p, b, h);\n"
              "  if (w.t_begin >= w.t_end) return;  // nothing of this block reaches the tile\n",
              "  const Work w = work_of<kDQ>(p, b, h);\n"
              "  if (w.t_begin >= w.t_end) return;  // nothing of this block reaches the tile\n"
              + init + "  if (stamper) s_split[12] = 1;\n")
        s.rep("  __syncthreads();  // the barriers are initialised\n  mbar_wait(bar_a, 0);\n",
              "  __syncthreads();  // the barriers are initialised\n  mbar_wait(bar_a, 0);\n"
              "  STAMP(1);\n")
        s.rep("    if (threadIdx.x == 0 && i_t > 0 && t + 1 < w.t_end) load_streamed(t + 1);\n"
              "    mbar_wait(&full[slot], (i_t / kStages) & 1);\n",
              "    if (threadIdx.x == 0 && i_t > 0 && t + 1 < w.t_end) load_streamed(t + 1);\n"
              "    STAMP(7);\n    if (stamper) s_split[8] += 1;\n"
              "    mbar_wait(&full[slot], (i_t / kStages) & 1);\n    STAMP(2);\n")
        s.rep("    wgmma_commit();\n    wgmma_wait<0>();\n    fence_regs(acc_x);\n"
              "    fence_regs(acc_y);\n",
              "    wgmma_commit();\n    wgmma_wait<0>();\n    fence_regs(acc_x);\n"
              "    fence_regs(acc_y);\n    STAMP(3);\n")
        s.rep("    wgmma_fence();\n#pragma unroll\n    for (int j = 0; j < kKSteps; ++j) {\n"
              "      const uint64_t db1",
              "    STAMP(4);\n    wgmma_fence();\n#pragma unroll\n"
              "    for (int j = 0; j < kKSteps; ++j) {\n      const uint64_t db1")
        s.rep("      for (int j = 0; j < kKSteps; ++j) fence_regs(a_p[j]);\n    }\n  }\n",
              "      for (int j = 0; j < kKSteps; ++j) fence_regs(a_p[j]);\n    }\n"
              "    STAMP(5);\n  }\n")
        s.rep("      *reinterpret_cast<float2*>(p.dv + at) = gv;\n    }\n  }\n}\n",
              "      *reinterpret_cast<float2*>(p.dv + at) = gv;\n    }\n  }\n  STAMP(6);\n"
              + _bwd_record("kDQ ? 1 : 0", "0") + "}\n")
    elif "consume_item<T, D, true>(p, h, w, wg, half, sm, kv, own_it, acc_it);" in text:
        # The one-launch kernel: persistent CTAs, consumer warpgroups of
        # 64 own rows each; the stamps go through consume_item's arguments.
        indent = " " * 45  # consume_item's parameter lines
        s.rep(f"int& kv,\n{indent}int& own_it, int& acc_it) {{\n",
              f"int& kv,\n{indent}int& own_it, int& acc_it,"
              " long long& t_last, unsigned* s_split, bool stamper) {\n  long long t_now;\n"
              "  if (stamper) s_split[12] += 1;\n")
        s.rep("    mbar_wait(&sm.own_full[own_slot], (own_it / kOwnSlots) & 1);\n",
              "    mbar_wait(&sm.own_full[own_slot], (own_it / kOwnSlots) & 1);\n    STAMP(1);\n")
        s.rep("      mbar_wait(&sm.full[slot], (kv / Cfg::kStages) & 1);\n",
              "      mbar_wait(&sm.full[slot], (kv / Cfg::kStages) & 1);\n      STAMP(2);\n"
              "      if (stamper) s_split[8] += 1;\n")
        s.rep("        wgmma_wait<0>();\n        fence_regs(acc_x);\n        fence_regs(acc_y);\n",
              "        wgmma_wait<0>();\n        fence_regs(acc_x);\n        fence_regs(acc_y);\n"
              "        STAMP(3);\n")
        s.rep("        wgmma_fence();\n#pragma unroll\n"
              "        for (int j = 0; j < kKSteps; ++j) {\n          const uint64_t db1",
              "        STAMP(4);\n        wgmma_fence();\n#pragma unroll\n"
              "        for (int j = 0; j < kKSteps; ++j) {\n          const uint64_t db1")
        s.rep("          for (int j = 0; j < kKSteps; ++j) fence_regs(a_p[j]);\n"
              "        }\n      }\n",
              "          for (int j = 0; j < kKSteps; ++j) fence_regs(a_p[j]);\n        }\n"
              "        STAMP(5);\n      }\n")
        s.rep("    ++own_it;\n  }\n", "    ++own_it;\n  }\n  STAMP(7);\n")
        s.rep("    bulk_commit();\n  }\n}\n\n// Tensor maps:",
              "    bulk_commit();\n  }\n  STAMP(6);\n}\n\n// Tensor maps:")
        counters = "    int kv = 0, own_it = 0, acc_it = 0, items = 0;\n"
        s.rep("    const int wg = threadIdx.x / 128;\n" + counters,
              "    const int wg = threadIdx.x / 128;\n" + counters + init)
        for kind in ("true", "false"):
            s.rep(f"consume_item<T, D, {kind}>(p, h, w, wg, half, sm, kv, own_it, acc_it);",
                  f"consume_item<T, D, {kind}>(p, h, w, wg, half, sm, kv, own_it, acc_it,"
                  " t_last, s_split, stamper);")
        s.rep("    if (threadIdx.x % 128 == 0) bulk_wait_read();\n  }\n}\n",
              "    if (threadIdx.x % 128 == 0) bulk_wait_read();\n    STAMP(7);\n"
              + _bwd_record("0", "wg") + "  }\n}\n")
    else:
        raise RuntimeError(f"no known backward kernel in {BWD_KERNEL}")
    return s.text + (
        '\nextern "C" int tpusnap_ring_split_read(void* host) {\n'
        "  return int(cudaMemcpyFromSymbol(host, g_split, sizeof(g_split)));\n}\n"
        'extern "C" int tpusnap_ring_split_reset() {\n'
        f"  static unsigned long long zeros[{BWD_RECORDS} * {BWD_SLOTS}];\n"
        "  return int(cudaMemcpyToSymbol(g_split, zeros, sizeof(g_split)));\n}\n"
    )


def _scratch_copy(tree: str, backward: bool) -> str:
    """An instrumented copy of ``tree``'s package under a new temporary
    directory; its root."""
    root = tempfile.mkdtemp(prefix="ring_probe_")
    shutil.copytree(os.path.join(tree, "tpusnap_torch"), os.path.join(root, "tpusnap_torch"),
                    ignore=shutil.ignore_patterns("_build", "*.so", "__pycache__"))
    path = os.path.join(root, BWD_KERNEL if backward else KERNEL)
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(_instrument_backward(text) if backward else _instrument(text))
    return root


def _cases():
    """(label, shape, mode, q_offset, k_offset) of the flagship's launches."""
    s = RING_BLOCK_SHAPE[1]
    return [
        ("middle past", RING_BLOCK_SHAPE, "middle", s, 0),
        ("last past", RING_BLOCK_SHAPE, "last", s, 0),
        ("first diagonal", RING_BLOCK_SHAPE, "first", s, s),
        ("first+last diagonal", RING_BLOCK_SHAPE, "first+last", s, s),
        ("middle diagonal", RING_BLOCK_SHAPE, "middle", s, s),
        ("first+last ring of one", SLICE_SHAPE, "first+last", 0, 0),
    ]


def _inputs(shape, gen):
    """q, k, v as the model hands them over (head-split views of one fused
    bf16 qkv projection), a carry with some rows that have seen nothing,
    and an output buffer."""
    import torch

    b, s, h, d = shape
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    m = torch.randn((b, h, s), generator=gen, device="cuda")
    l = torch.rand((b, h, s), generator=gen, device="cuda") * 2 + 0.5
    o = torch.randn((b, s, h, d), generator=gen, device="cuda")
    m[:, :, 1::7], l[:, :, 1::7], o[:, 1::7] = -1e30, 0.0, 0.0
    return q, k, v, (m, l, o), torch.empty(q.shape, dtype=q.dtype, device="cuda")


def _child(root: str) -> dict:
    """In a process of its own: import the scratch copy at ``root``, build
    it, and split one launch of each case."""
    sys.path.insert(0, root)
    import torch

    ra = importlib.import_module("tpusnap_torch.ops.ring_attention")
    fa = importlib.import_module("tpusnap_torch.ops.flash_attention")
    if not ra.__file__.startswith(root):
        raise RuntimeError(f"imported {ra.__file__}, not the scratch copy")
    fa.build_library()
    lib = fa._load()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    with torch.no_grad():
        for label, shape, mode, q_off, k_off in _cases():
            q, k, v, carry, buf = _inputs(shape, gen)
            if mode == "first+last":
                carry = (None, None, None)

            def call():
                ra.attend_block(q, k, v, *carry, q_off, k_off, shape[-1] ** -0.5, True,
                                mode=mode, out=buf if "last" in mode else None)

            call()  # warm
            torch.cuda.synchronize()
            lib.tpusnap_ring_split_reset()
            call()
            torch.cuda.synchronize()
            raw = (ctypes.c_ulonglong * (1024 * 2 * SLOTS))()
            if lib.tpusnap_ring_split_read(raw) != 0:
                raise RuntimeError("reading the split buffer failed")
            b, s, h, _ = shape
            blocks = min((s + 127) // 128 * h * b, torch.cuda.get_device_properties(0)
                         .multi_processor_count)
            rows = [raw[i * SLOTS:(i + 1) * SLOTS] for i in range(2 * blocks)]
            totals = [sum(r[1:14]) for r in rows]
            mean = {n: statistics.mean(r[i + 1] for r in rows) for i, n in enumerate(NAMES)}
            slowest = rows[totals.index(max(totals))]
            out[label] = {
                "clocks_mean": statistics.mean(totals), "clocks_max": max(totals),
                "share": {n: mean[n] / statistics.mean(totals) for n in NAMES},
                "clocks": mean,
                "slowest": {n: slowest[i + 1] for i, n in enumerate(NAMES)},
                "items_per_warpgroup": statistics.mean(r[14] for r in rows),
                "tiles_per_warpgroup": statistics.mean(r[15] for r in rows),
            }
    return out


def _bwd_cases():
    """(label, shape, q_offset, k_offset) of the backward's calls."""
    s = RING_BLOCK_SHAPE[1]
    return [
        ("diagonal ring block", RING_BLOCK_SHAPE, s, s),
        ("past ring block", RING_BLOCK_SHAPE, s, 0),
        ("flash backward (0, 0)", SLICE_SHAPE, 0, 0),
    ]


def _bwd_summary(raw) -> dict:
    """Per launch of one call: the records' mean clocks by category, their
    shares, the slowest record, the span and the tail."""
    recs = [raw[i * BWD_SLOTS:(i + 1) * BWD_SLOTS] for i in range(BWD_RECORDS)]
    launches, bounds = {}, {}
    for part in (0, 1):
        rows = [r for i, r in enumerate(recs) if i // (2 * BWD_MAX_CTAS) == part and r[11]]
        if not rows:
            continue
        totals = [sum(r[1:8]) for r in rows]
        mean = {n: statistics.mean(r[i + 1] for r in rows) for i, n in enumerate(BWD_NAMES)}
        start, end = min(r[9] for r in rows), max(r[10] for r in rows)
        last = {}
        for r in rows:
            last[r[11]] = max(last.get(r[11], 0), r[10])
        span = max(end - start, 1)
        bounds[part] = (start, end)
        slowest = rows[totals.index(max(totals))]
        launches[f"launch {part}"] = {
            "records": len(rows), "sms": len(last), "span_us": span / 1e3,
            "tail_share": statistics.mean((end - t) / span for t in last.values()),
            "clocks_mean": statistics.mean(totals), "clocks_max": max(totals),
            "share": {n: mean[n] / statistics.mean(totals) for n in BWD_NAMES},
            "clocks": mean, "slowest": {n: slowest[i + 1] for i, n in enumerate(BWD_NAMES)},
            "tiles_per_record": statistics.mean(r[8] for r in rows),
            "items_per_record": statistics.mean(r[12] for r in rows),
        }
    if len(bounds) == 2:
        # The two-launch kernel: launch 0 computes dK and dV, launch 1 dQ.
        launches["gap_us"] = (bounds[1][0] - bounds[0][1]) / 1e3
        launches["call_span_us"] = (bounds[1][1] - bounds[0][0]) / 1e3
    return launches


def _bwd_child(root: str) -> dict:
    """In a process of its own: import the scratch copy at ``root``, build
    it, and split one call of each backward case."""
    import inspect

    sys.path.insert(0, root)
    import torch

    ra = importlib.import_module("tpusnap_torch.ops.ring_attention")
    fa = importlib.import_module("tpusnap_torch.ops.flash_attention")
    if not ra.__file__.startswith(root):
        raise RuntimeError(f"imported {ra.__file__}, not the scratch copy")
    fa.build_library()
    lib = fa._load()
    store_mode = "mode" in inspect.signature(ra.attend_block_grads).parameters
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    with torch.no_grad():
        for label, shape, q_off, k_off in _bwd_cases():
            b, s, h, d = shape
            qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
            q, k, v = (t.reshape(shape) for t in qkv.split(h * d, dim=-1))
            do = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            scale = d**-0.5
            lse, delta, _ = ra.row_stats(q, k, v, do, q_off, k_off, scale, True)
            store = store_mode and q_off == k_off == 0
            if store:
                grads = [torch.empty(shape, dtype=torch.bfloat16, device="cuda") for _ in range(3)]
                kwargs = {"mode": "store"}
            else:
                grads = [torch.randn(shape, generator=gen, device="cuda") for _ in range(3)]
                kwargs = {}

            def call():
                ra.attend_block_grads(q, k, v, do, lse, delta, *grads, q_off, k_off, scale, True,
                                      **kwargs)

            call()  # warm
            torch.cuda.synchronize()
            lib.tpusnap_ring_split_reset()
            call()
            torch.cuda.synchronize()
            raw = (ctypes.c_ulonglong * (BWD_RECORDS * BWD_SLOTS))()
            if lib.tpusnap_ring_split_read(raw) != 0:
                raise RuntimeError("reading the split buffer failed")
            out[label] = {"shape": list(shape), "offsets": [q_off, k_off],
                          "mode": "store" if store else "accumulate", **_bwd_summary(raw)}
    return out


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out")
    parser.add_argument("--backward", action="store_true",
                        help="split the backward block kernel instead of the forward one")
    parser.add_argument("--tree", default=HERE,
                        help="the checkout whose tpusnap_torch is instrumented (default: this one)")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if opts.child:
        print(json.dumps(_bwd_child(opts.child) if opts.backward else _child(opts.child)),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ring_block_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    result = {"card": _smi("name,power.limit"), "kernel": BWD_KERNEL if opts.backward else KERNEL,
              "tree": os.path.abspath(opts.tree)}
    root = _scratch_copy(opts.tree, opts.backward)
    try:
        argv = [sys.executable, os.path.abspath(__file__), "--child", root]
        proc = subprocess.run(argv + (["--backward"] if opts.backward else []),
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"probe child failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        result["split"] = json.loads(proc.stdout.strip().splitlines()[-1])
        result["sm_clock"] = _smi("clocks.sm,clocks.max.sm")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    text = json.dumps(result, indent=1)
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
