#!/usr/bin/env python3
"""Where the ring block kernel's time goes, on one NVIDIA GPU:

    python3 ring_block_probe.py [--out FILE]

It copies ``tpusnap_torch`` into a temporary directory, adds ``clock64``
stamps to the copy's ring block kernel (``csrc/ring_block_wgmma.cu``; the
repo's source has no instrumentation knob), builds the copy and runs it
in a process of its own. The stamps go in at exact lines of the kernel's
source (``_instrument``): when those lines change, the probe stops with
the line it did not find, and its anchors change with the kernel. The
stamps go to a debug buffer, and the clocks between them are charged to the waits on Q (``wait_q``), on the carry in
(``carry_in``, its reads included), on the other warpgroup's turn
(``turn``), on ``full_k`` and ``full_v`` (``wait_k``, ``wait_v``), on the
QK^T and PV products (``wgmma_qk``, ``wgmma_pv``), to issuing the
products (``issue``), the softmax, the rescale and P's rounding
(``rescale_round``), the tiles past a warpgroup's last key
(``skipped_tiles``), the epilogue and the rest (``other``: between
items, and the end). One launch per case after a warm one; per case the
mean over warpgroups of each category's clocks and share, and the
slowest warpgroup's.

The cases are the ring block kernel's launches on the flagship's path:
the two-rank block (8, 512, 8, 64) bf16 as middle and last on a past
block, first and first+last on the diagonal, middle on the diagonal, and
the ring of one's first+last launch at (8, 1024, 8, 64). Prints one JSON
object; ``--out`` writes it to a file too. Needs nvcc (``CUDA_HOME``)
and one card; imports neither JAX nor tpusnap.
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
NAMES = ["wait_q", "turn", "wait_k", "wait_v", "wgmma_qk", "softmax", "wgmma_pv",
         "rescale_round", "epilogue", "other", "issue", "carry_in", "skipped_tiles"]
SLOTS = 16  # per warpgroup: the 13 categories (from 1), items (14), tiles (15)
SEED = 0
RING_BLOCK_SHAPE = (8, 512, 8, 64)  # the flagship's two-rank ring block
SLICE_SHAPE = (8, 1024, 8, 64)  # the flagship's whole sequence: the ring of one


class _Source:
    def __init__(self, text: str) -> None:
        self.text = text

    def rep(self, old: str, new: str) -> None:
        if self.text.count(old) != 1:
            raise RuntimeError(f"probe anchor not found once in {KERNEL}: {old[:80]!r}")
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


def _scratch_copy() -> str:
    """An instrumented copy of the package under a new temporary
    directory; its root."""
    root = tempfile.mkdtemp(prefix="ring_probe_")
    shutil.copytree(os.path.join(HERE, "tpusnap_torch"), os.path.join(root, "tpusnap_torch"),
                    ignore=shutil.ignore_patterns("_build", "*.so", "__pycache__"))
    path = os.path.join(root, KERNEL)
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(_instrument(text))
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


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if opts.child:
        print(json.dumps(_child(opts.child)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ring_block_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    result = {"card": _smi("name,power.limit")}
    root = _scratch_copy()
    try:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
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
