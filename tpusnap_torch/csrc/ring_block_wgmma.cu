// Ring attention's block step on Hopper (sm_90a): one online-softmax update
// of a carry (m, l, o) by one K/V block, plain C interface.
//
// Replaces tpusnap/ops/ring_attention.py::_block_attend, an XLA device
// program (not a Pallas kernel) that ring_attention runs once per ring
// step. For a local query block q and one K/V block, both [b, s, h, d],
// and a carry m, l ([b, h, s] f32) and o ([b, s, h, d] f32, unnormalised):
//
//   s_ij  = q_i . k_j * scale, masked to -1e30 where the global position of
//           key j is past that of query i (causal);
//   m'    = max(m, max_j s_ij);  alpha = exp(m - m');
//   p_ij  = exp(s_ij - m'), 0 where masked;
//   l'    = l * alpha + sum_j p_ij;  o' = o * alpha + sum_j p_ij v_j.
//
// Global positions enter as delta = q_offset - k_offset (key j is masked
// for query i when j > i + delta). A block wholly in the future changes
// nothing; the caller skips such a middle step without a launch.
//
// Carry modes (the caller knows before a ring starts which of its steps
// launch): middle reads the carry and writes it back in place; first
// starts from the empty carry (m = -1e30, l = 0, o = 0) in registers and
// reads none; last reads the carry and writes the output o' / max(l',
// 1e-20) in q's type (IEEE division, round to nearest even: what
// ring_attention's _finish computes) instead of the carry; first+last (a
// ring of one) reads and writes no carry at all. The modes change what is
// read and written, never the tile arithmetic: first equals middle from
// the empty carry, and last equals middle followed by _finish, bit for
// bit. In every mode but middle an item whose keys are all in the future
// still takes one fully masked tile, which leaves the carry it starts from
// as it is, so that its rows are written.
//
// Two kernels, one entry point; the route is picked in Python and checked
// again here with the flash kernel's rule (wgmma_route in
// flash_attention.cuh):
//
// * wgmma (ring_block_wgmma below): bf16/f16 that a TMA tensor map can
//   describe, d <= 128. The flash kernel's design (flash_attention_wgmma.cu)
//   with the carry: persistent blocks, a producer warp keeping a 3-slot
//   K/V ring full with TMA, two consumer warpgroups of 64 query rows taking
//   turns on the tensor cores, S = Q K^T by wgmma from shared memory and
//   O += P V by wgmma with P (rounded to the input type, as the flash
//   kernel does) from registers. At d <= 64 the carry moves through shared
//   memory by TMA: the producer loads an item's incoming o (128 rows of
//   f32 in 32-column boxes swizzled by 128 bytes) beside its Q tile, on
//   Q's barrier, as soon as the consumers are done with the last item's Q,
//   so that it arrives while they finish that item; each consumer
//   warpgroup moves its rows into the accumulator layout while its first
//   QK^T runs, and at the end stages its outgoing o (or the output) in
//   shared memory for one TMA store, waiting for that store's reads only
//   before it stages the next item's. m and l (512 bytes an item) are
//   plain loads and stores. At d = 128 the K/V ring takes 224 KB and
//   leaves no room: each thread reads and writes its rows' carry directly
//   from the accumulator layout. The flash
//   kernel keeps its own source, untouched, so that its build and numerics
//   do not move; the tensor-map encoder is shared (tma_host.cuh).
// * simt (ring_block_simt below): f32, which has no tensor-core type that
//   keeps the f32 tolerance, and 16-bit layouts TMA cannot describe. The
//   flash SIMT kernel's tiling (flash_attention.cu) with the carry and the
//   same modes, for correctness only.
//
// What bounds it on this card: at the flagship's ring block (b=8, s=512,
// h=8, d=64, bf16) the least time is the bytes: 12.6 MB of q, k, v read
// once, plus what the mode moves of the f32 carry (16.8 MB of o and 0.5 MB
// of m and l read and written in the middle mode; half of that in first;
// in last half of that and 4.2 MB of output; only the output in
// first+last): 29.9, 21.3, 25.5 and 16.8 MB over HBM (8.9, 6.4, 7.6 and
// 5.0 us at 3.35 TB/s), against 2.2 GFLOP (diagonal block) or 4.3 GFLOP
// (past block) on the bf16 tensor cores (2.2 or 4.3 us at 989 TFLOP/s).
// The modes drop the carry passes that would otherwise run around the
// kernel (the fill of the empty carry, the division after the last step).
// Measured on the card, the bytes do not bound it: every mode runs at 2
// to 4x its bytes bound with the L2 flushed, and the modes differ by less
// than their bytes do. A consumer warpgroup's time goes to the softmax
// (about a third), the epilogue, issuing the products and waiting for K/V
// tiles (ring_block_probe.py).

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "hopper_ptx.cuh"
#include "tma_host.cuh"

namespace {

using namespace tpusnap_ptx;
using tpusnap_tma::make_map;

// Carry mode bits: kFirst reads no carry (it starts empty); kLast writes
// the normalised output instead of the carry. Neither is the middle mode.
constexpr int kFirst = 1;
constexpr int kLast = 2;

struct RingParams {
  const void* q;
  const void* k;
  const void* v;
  float* o;   // [b, s, h, d], contiguous (unused in first+last)
  float* m;   // [b, h, s], contiguous (unused in first+last)
  float* l;   // [b, h, s], contiguous (unused in first+last)
  void* out;  // [b, s, h, d] of q's type, contiguous (last modes only)
  // Element strides of the b, s and h dims of q, k, v (d is contiguous).
  int64_t q_b, q_s, q_h;
  int64_t k_b, k_s, k_h;
  int64_t v_b, v_s, v_h;
  int s, d;
  int delta;  // q_offset - k_offset, clamped to [-s, s]
  float scale;
  int causal;
  int mode;  // kFirst | kLast bits
};

__device__ __forceinline__ int64_t o_index(const RingParams& p, int h, int batch, int row,
                                           int head, int col) {
  return ((int64_t(batch) * p.s + row) * h + head) * p.d + col;
}
__device__ __forceinline__ int64_t ml_index(const RingParams& p, int h, int batch, int head,
                                            int row) {
  return (int64_t(batch) * h + head) * p.s + row;
}

// Keys past this local index hold nothing for a q tile ending at row
// q_end (exclusive): the causal limit in global positions, or s.
__device__ __forceinline__ int key_end(const RingParams& p, int q_end) {
  return p.causal ? max(0, min(p.s, q_end + p.delta)) : p.s;
}

// ---- wgmma route -----------------------------------------------------------

constexpr int kBlockQ = 128;  // two warpgroups of 64 rows
constexpr int kConsumerWarps = 8;
constexpr int kThreads = kConsumerWarps * 32 + 128;  // + one producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kRowBytes = 128;  // one 64-column swizzle atom row
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int kBlockK = 128;
  static constexpr int kStages = 3;  // K/V ring depth (227 KB at D=128)
  static constexpr int kChunks = D / 64;
  static constexpr int kQBytes = kBlockQ * D * 2;
  static constexpr int kKVBytes = kBlockK * D * 2;
  // The carry through shared memory and TMA: at D = 64 only (at D = 128
  // the K/V ring leaves no room for it).
  static constexpr bool kStaged = D == 64;
  static constexpr int kOChunks = D / 32;          // 32-column (128-byte) f32 boxes
  static constexpr int kOBoxBytes = 64 * 32 * 4;  // one warpgroup's 64 rows of one box
  static constexpr int kOInBytes = kStaged ? 2 * kOChunks * kOBoxBytes : 0;  // o in, 128 rows
  static constexpr int kStageBytes = kStaged ? kOChunks * kOBoxBytes : 0;   // out, per warpgroup
  static constexpr int kTileBytes = kQBytes + 2 * kStages * kKVBytes + kOInBytes + 2 * kStageBytes;
  static constexpr int kSmemBytes = kTileBytes + (2 + 3 * kStages) * 8;
};

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    ring_block_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_o,
                     const __grid_constant__ CUtensorMap tm_out, RingParams p, int b, int h) {
  using Cfg = Tile<D>;
  constexpr int kBlockK = Cfg::kBlockK;
  constexpr int kStages = Cfg::kStages;
  constexpr int kSRegs = kBlockK / 2;
  constexpr int kORegs = D / 2;
  constexpr int kPSteps = kBlockK / 16;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sK = sQ + Cfg::kQBytes;
  uint8_t* sV = sK + kStages * Cfg::kKVBytes;
  uint8_t* sOin = sV + kStages * Cfg::kKVBytes;
  uint8_t* sStage = sOin + Cfg::kOInBytes;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + Cfg::kTileBytes);
  uint64_t* q_empty = bar_q + 1;
  uint64_t* full_k = q_empty + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;
  const bool carry_in = !(p.mode & kFirst);
  const bool last = p.mode & kLast;
  const bool stage_in = Cfg::kStaged && carry_in;

  // Items are (128-row q tile, head, batch), longest first, in the flash
  // kernel's snake order. An item whose keys are all in the future has no
  // tiles and is skipped by producer and consumers alike in the middle
  // mode; the other modes give it one (fully masked) tile.
  const int nq = (p.s + kBlockQ - 1) / kBlockQ;
  const int n_items = nq * h * b;
  struct Item {
    int q_block0, head, batch, n_tiles;
  };
  auto item = [&](int i) {
    Item w;
    w.q_block0 = (nq - 1 - i / (h * b)) * kBlockQ;
    w.head = (i % (h * b)) % h;
    w.batch = (i % (h * b)) / h;
    w.n_tiles = max(p.mode ? 1 : 0, (key_end(p, w.q_block0 + kBlockQ) + kBlockK - 1) / kBlockK);
    return w;
  };
  auto item_of_round = [&](int rd) {
    return int(rd * gridDim.x + (rd % 2 ? gridDim.x - 1 - blockIdx.x : blockIdx.x));
  };
  const int rounds = (n_items + gridDim.x - 1) / gridDim.x;
  const int warp_id = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&full_v[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp_id >= kConsumerWarps) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp_id == kConsumerWarps && lane == 0) {
      int kv = 0;
      for (int rd = 0, it = 0; rd < rounds; ++rd) {
        if (item_of_round(rd) >= n_items) continue;
        const Item w = item(item_of_round(rd));
        if (w.n_tiles == 0) continue;
        if (it > 0) mbar_wait(q_empty, (it - 1) & 1);
        mbar_expect_tx(bar_q, Cfg::kQBytes + (stage_in ? Cfg::kOInBytes : 0));
        for (int c = 0; c < Cfg::kChunks; ++c)
          tma_load_4d(sQ + c * kBlockQ * kRowBytes, &tm_q, bar_q, c * 64, w.head, w.q_block0,
                      w.batch);
        if (stage_in) {
          // o in, on Q's barrier (rows past s come as zeros).
          for (int g = 0; g < 2; ++g)
            for (int c = 0; c < Cfg::kOChunks; ++c)
              tma_load_4d(sOin + (g * Cfg::kOChunks + c) * Cfg::kOBoxBytes, &tm_o, bar_q, c * 32,
                          w.head, w.q_block0 + g * 64, w.batch);
        }
        for (int t = 0; t < w.n_tiles; ++t, ++kv) {
          const int stage = kv % kStages;
          if (kv >= kStages) mbar_wait(&empty[stage], ((kv / kStages) + 1) & 1);
          uint8_t* k_dst = sK + stage * Cfg::kKVBytes;
          uint8_t* v_dst = sV + stage * Cfg::kKVBytes;
          mbar_expect_tx(&full_k[stage], Cfg::kKVBytes);
          for (int c = 0; c < Cfg::kChunks; ++c)
            tma_load_4d(k_dst + c * kBlockK * kRowBytes, &tm_k, &full_k[stage], c * 64, w.head,
                        t * kBlockK, w.batch);
          mbar_expect_tx(&full_v[stage], Cfg::kKVBytes);
          for (int c = 0; c < Cfg::kChunks; ++c)
            tma_load_4d(v_dst + c * kBlockK * kRowBytes, &tm_v, &full_v[stage], c * 64, w.head,
                        t * kBlockK, w.batch);
        }
        ++it;
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    const int warp = warp_id % 4;
    const int col_lane = 2 * (lane % 4);
    const float scale_log2 = p.scale * kLog2e;
    const uint32_t q_addr = smem_addr(sQ) + wg * 64 * kRowBytes;
    // This thread's two rows within its warpgroup's 64.
    const int local_a = warp * 16 + lane / 4, local_b = local_a + 8;
    uint8_t* stage = sStage + wg * Cfg::kStageBytes;

    float acc_s[kSRegs];
    float acc_o[kORegs];
    uint32_t a_p[kPSteps][4];
    // m_run: the running row max in the carry's units (scaled scores);
    // l_run: this thread's share of the row sum (the carry's l sits with
    // the row's first thread).
    float m_run[2], l_run[2];
    int kv0 = 0;
    int q_first = 0, row_a = 0, row_b = 0;

    auto issue_qk = [&](int t) {
      const int slot = (kv0 + t) % kStages;
      const uint32_t k_addr = smem_addr(sK + slot * Cfg::kKVBytes);
      mbar_wait(&full_k[slot], ((kv0 + t) / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da = smem_desc(q_addr + (kk / 4) * kBlockQ * kRowBytes + off, 16, 1024);
        const uint64_t db = smem_desc(k_addr + (kk / 4) * kBlockK * kRowBytes + off, 16, 1024);
        Mma<T>::ss(acc_s, da, db, kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int t) {
      const int slot = (kv0 + t) % kStages;
      const uint32_t v_addr = smem_addr(sV + slot * Cfg::kKVBytes);
      mbar_wait(&full_v[slot], ((kv0 + t) / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kPSteps; ++j) {
        const uint64_t db = smem_desc(v_addr + j * 16 * kRowBytes, kBlockK * kRowBytes, 1024);
        Mma<T>::rs(acc_o, a_p[j], db, 1);
      }
      wgmma_commit();
    };
    auto turn_begin = [&]() { named_barrier_sync(1 + wg, kConsumerWarps * 32); };
    auto turn_end = [&]() { named_barrier_arrive(2 - wg, kConsumerWarps * 32); };
    // The warpgroup's own 128 threads (the staging buffer's writers).
    auto warpgroup_sync = [&]() { named_barrier_sync(3 + wg, 128); };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // Mask (global positions), online softmax over S of tile t against the
    // carry: P in f32 in acc_s, and alpha = exp(m - m') for what O and l
    // hold so far. A row with nothing seen keeps m = -1e30 and alpha = 1.
    auto softmax = [&](int t, float (&alpha)[2]) {
      const int k0 = t * kBlockK;
      if (k0 + kBlockK > p.s || (p.causal && k0 + kBlockK - 1 > q_first + p.delta)) {
#pragma unroll
        for (int i = 0; i < kSRegs; ++i) {
          const int col = k0 + (i / 4) * 8 + col_lane + (i % 2);
          const int row = (i / 2) % 2 ? row_b : row_a;
          if (col >= p.s || (p.causal && col > row + p.delta)) acc_s[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kSRegs; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], acc_s[i]);
      float m_log2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r] * p.scale);  // scale > 0
        alpha[r] = exp2_approx((m_run[r] - m_new) * kLog2e);
        m_log2[r] = m_new * kLog2e;
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < kSRegs; ++i) {
        const int r = (i / 2) % 2;
        acc_s[i] = exp2_approx(fmaf(acc_s[i], scale_log2, -m_log2[r]));  // masked: 0
        l_run[r] += acc_s[i];
      }
    };
    auto round_p = [&]() {
#pragma unroll
      for (int j = 0; j < kPSteps; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          a_p[j][u] = pack2<T>(acc_s[8 * j + 2 * u], acc_s[8 * j + 2 * u + 1]);
    };

    if (wg == 1) turn_end();
    for (int rd = 0, it = 0; rd < rounds; ++rd) {
      if (item_of_round(rd) >= n_items) continue;
      const Item w = item(item_of_round(rd));
      if (w.n_tiles == 0) continue;
      q_first = w.q_block0 + wg * 64;
      row_a = q_first + local_a;
      row_b = q_first + local_b;
      // Causal: tiles past the last key this warpgroup's rows may see hold
      // only masked keys. At least one tile is taken; if it is all masked,
      // alpha = 1 and p = 0 leave the carry exactly as it was.
      int n_own = w.n_tiles;
      if (p.causal) {
        const int last_key = q_first + 63 + p.delta;
        n_own = last_key < 0 ? 1 : min(w.n_tiles, last_key / kBlockK + 1);
      }
      // The carry in: m and l of rows row_a, row_b and, unless it comes
      // staged with Q, o in the accumulator layout (pairs of columns as one
      // 8-byte load), before the waits so that the loads are in flight
      // while Q arrives. First reads none and starts from the empty carry,
      // m = -1e30, l = 0, o = 0: what a middle step reads from a fill.
      // (One predicated load rather than a branch for the first mode: the
      // branch costs 28 bytes of spills at D = 128.)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? row_b : row_a;
        const bool in = carry_in && row < p.s;
        m_run[r] = in ? p.m[ml_index(p, h, w.batch, w.head, row)] : -1e30f;
        l_run[r] = in && lane % 4 == 0 ? p.l[ml_index(p, h, w.batch, w.head, row)] : 0.f;
      }
      if (!stage_in) {
#pragma unroll
        for (int j = 0; j < kORegs; j += 2) {
          const int row = (j / 2) % 2 ? row_b : row_a;
          const int col = (j / 4) * 8 + col_lane;
          float2 v2 = make_float2(0.f, 0.f);
          if (carry_in && row < p.s && col < p.d)
            v2 = *reinterpret_cast<const float2*>(p.o + o_index(p, h, w.batch, row, w.head, col));
          acc_o[j] = v2.x;
          acc_o[j + 1] = v2.y;
        }
      }

      mbar_wait(bar_q, it & 1);
      float alpha[2];
      turn_begin();
      issue_qk(0);
      turn_end();
      if (stage_in) {
        // o in from shared memory (it came with Q) while the first QK^T
        // runs: from its swizzled boxes into the accumulator layout
        // (conflict-free 8-byte reads).
        const uint8_t* o_in = sOin + wg * Cfg::kOChunks * Cfg::kOBoxBytes;
#pragma unroll
        for (int j = 0; j < kORegs; j += 2) {
          const int local = (j / 2) % 2 ? local_b : local_a;
          const int col = (j / 4) * 8 + col_lane;
          const float2 v2 = *reinterpret_cast<const float2*>(
              o_in + (col / 32) * Cfg::kOBoxBytes + swizzled(local, (col % 32) * 4));
          acc_o[j] = v2.x;
          acc_o[j + 1] = v2.y;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc_s);
      softmax(0, alpha);
#pragma unroll
      for (int j = 0; j < kORegs; ++j) acc_o[j] *= alpha[(j / 2) % 2];  // the carry's rescale
      round_p();
      for (int t = 1; t < n_own; ++t) {
        turn_begin();
        issue_qk(t);
        issue_pv(t - 1);
        turn_end();
        wgmma_wait<1>();
        fence_regs(acc_s);
        softmax(t, alpha);
        wgmma_wait<0>();
        fence_regs(acc_o);
#pragma unroll
        for (int j = 0; j < kPSteps; ++j) fence_regs(a_p[j]);
        release(&empty[(kv0 + t - 1) % kStages]);
#pragma unroll
        for (int j = 0; j < kORegs; ++j) acc_o[j] *= alpha[(j / 2) % 2];
        round_p();
      }
      // Q and the carry in are read: the producer may load the next item's.
      release(q_empty);
      turn_begin();
      issue_pv(n_own - 1);
      turn_end();
      wgmma_wait<0>();
      fence_regs(acc_o);
      release(&empty[(kv0 + n_own - 1) % kStages]);
      for (int t = n_own; t < w.n_tiles; ++t) {
        turn_begin();
        turn_end();
        const int slot = (kv0 + t) % kStages;
        mbar_wait(&full_k[slot], ((kv0 + t) / kStages) & 1);
        mbar_wait(&full_v[slot], ((kv0 + t) / kStages) & 1);
        release(&empty[slot]);
      }
      kv0 += w.n_tiles;

      // Full row sums; the carry's m and l (not in the last modes) by each
      // row's first thread.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        const int row = r ? row_b : row_a;
        if (!last && row < p.s && lane % 4 == 0) {
          p.m[ml_index(p, h, w.batch, w.head, row)] = m_run[r];
          p.l[ml_index(p, h, w.batch, w.head, row)] = l_run[r];
        }
      }
      // Last: o / max(l, 1e-20) with IEEE rounding, then to T with round
      // to nearest even, as _finish computes it.
      float l_div[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) l_div[r] = fmaxf(l_run[r], 1e-20f);
      if (Cfg::kStaged) {
        // Stage this warpgroup's 64 rows (the f32 carry in 32-column
        // boxes, or the output in one 64-column box, both swizzled as
        // their tensor maps say) and store them with one thread's TMA.
        // The previous item's store must have read the buffer first.
        const bool issuer = threadIdx.x % 128 == 0;
        if (issuer) bulk_wait_read();
        warpgroup_sync();
#pragma unroll
        for (int j = 0; j < kORegs; j += 2) {
          const int r = (j / 2) % 2;
          const int local = r ? local_b : local_a;
          const int col = (j / 4) * 8 + col_lane;
          if (last)
            *reinterpret_cast<uint32_t*>(stage + swizzled(local, col * 2)) =
                pack2<T>(__fdiv_rn(acc_o[j], l_div[r]), __fdiv_rn(acc_o[j + 1], l_div[r]));
          else
            *reinterpret_cast<float2*>(stage + (col / 32) * Cfg::kOBoxBytes +
                                       swizzled(local, (col % 32) * 4)) =
                make_float2(acc_o[j], acc_o[j + 1]);
        }
        fence_proxy_async();
        warpgroup_sync();
        if (issuer) {
          if (last) {
            tma_store_4d(&tm_out, stage, 0, w.head, q_first, w.batch);
          } else {
            for (int c = 0; c < Cfg::kOChunks; ++c)
              tma_store_4d(&tm_o, stage + c * Cfg::kOBoxBytes, c * 32, w.head, q_first, w.batch);
          }
          bulk_commit();
        }
      } else {
        // Direct: pairs of columns as one 8-byte (carry) or 4-byte
        // (output) store.
#pragma unroll
        for (int j = 0; j < kORegs; j += 2) {
          const int r = (j / 2) % 2;
          const int row = r ? row_b : row_a;
          const int col = (j / 4) * 8 + col_lane;
          if (row >= p.s || col >= p.d) continue;
          const int64_t at = o_index(p, h, w.batch, row, w.head, col);
          if (last)
            *reinterpret_cast<uint32_t*>(static_cast<T*>(p.out) + at) =
                pack2<T>(__fdiv_rn(acc_o[j], l_div[r]), __fdiv_rn(acc_o[j + 1], l_div[r]));
          else
            *reinterpret_cast<float2*>(p.o + at) = make_float2(acc_o[j], acc_o[j + 1]);
        }
      }
      ++it;
    }
    if (Cfg::kStaged && threadIdx.x % 128 == 0) bulk_wait_read();  // before smem goes
    if (wg == 0) turn_begin();
  }
}

template <typename T, int D>
cudaError_t launch_wgmma(const RingParams& p, int b, int h, int dtype, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  CUtensorMap tm_o = {}, tm_out = {};  // zeros where the mode uses none
  if (!make_map(&tm_q, p.q, dtype, p.d, p.s, b, h, p.q_b, p.q_s, p.q_h, kBlockQ) ||
      !make_map(&tm_k, p.k, dtype, p.d, p.s, b, h, p.k_b, p.k_s, p.k_h, Tile<D>::kBlockK) ||
      !make_map(&tm_v, p.v, dtype, p.d, p.s, b, h, p.v_b, p.v_s, p.v_h, Tile<D>::kBlockK))
    return cudaErrorInvalidValue;
  if (Tile<D>::kStaged) {
    const bool carry_in = !(p.mode & kFirst), last = p.mode & kLast;
    const int64_t row_elems = int64_t(h) * p.d;
    if ((carry_in || !last) && !tpusnap_tma::make_f32_map(&tm_o, p.o, p.d, p.s, b, h))
      return cudaErrorInvalidValue;
    if (last && !make_map(&tm_out, p.out, dtype, p.d, p.s, b, h, p.s * row_elems, row_elems,
                          p.d, 64))
      return cudaErrorInvalidValue;
  }
  const int smem = Tile<D>::kSmemBytes + 1024;
  cudaError_t err = cudaFuncSetAttribute(ring_block_wgmma<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int items = (p.s + kBlockQ - 1) / kBlockQ * h * b;
  ring_block_wgmma<T, D><<<min(items, sms), kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, tm_out, p, b, h);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma_bucket(const RingParams& p, int b, int h, int dtype,
                                cudaStream_t stream) {
  if (p.d <= 64) return launch_wgmma<T, 64>(p, b, h, dtype, stream);
  return launch_wgmma<T, 128>(p, b, h, dtype, stream);
}

// ---- simt route ------------------------------------------------------------
//
// One CUDA block per (64-row q tile, head, batch), 8 warps of 8 rows; each
// lane owns key columns lane and lane + 32 of a 64-key tile and output
// columns lane + 32 c. Products and the softmax in f32 from shared memory,
// masked scores at -1e30 as in _block_attend. The carry modes as on the
// wgmma route.

constexpr int kSimtBlockQ = 64;
constexpr int kSimtBlockK = 64;
constexpr int kSimtWarps = 8;
constexpr int kSimtThreads = kSimtWarps * 32;
constexpr int kRowsPerWarp = kSimtBlockQ / kSimtWarps;
constexpr int kKtStride = kSimtBlockK + 1;  // padded: conflict-free
constexpr int kPStride = kSimtBlockK + 4;   // float4-aligned rows
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Round to nearest even, as torch's casts do.
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t simt_smem_floats() {
  return size_t(kSimtBlockQ) * D + size_t(D) * kKtStride + size_t(kSimtBlockK) * D +
         size_t(kSimtBlockQ) * kPStride;
}

template <typename T, int D>
__global__ void __launch_bounds__(kSimtThreads) ring_block_simt(RingParams p, int h) {
  constexpr int kCols = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Kt = Qs + kSimtBlockQ * D;
  float* Vs = Kt + D * kKtStride;
  float* Ps = Vs + kSimtBlockK * D;

  const int q0 = blockIdx.x * kSimtBlockQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int k_end = key_end(p, q0 + kSimtBlockQ);
  // Every key is in this tile's future: the middle mode leaves the carry
  // as it is; the others still write it (or the output).
  if (k_end == 0 && p.mode == 0) return;
  const bool carry_in = !(p.mode & kFirst);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * kRowsPerWarp;

  const T* q = static_cast<const T*>(p.q) + batch * p.q_b + head * p.q_h;
  const T* k = static_cast<const T*>(p.k) + batch * p.k_b + head * p.k_h;
  const T* v = static_cast<const T*>(p.v) + batch * p.v_b + head * p.v_h;

  for (int i = tid; i < kSimtBlockQ * D; i += kSimtThreads) {
    const int r = i / D, c = i % D, qi = q0 + r;
    Qs[i] = (qi < p.s && c < p.d) ? to_f32(q[qi * p.q_s + c]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    const bool in = carry_in && qi < p.s;  // first: the empty carry
    m[r] = in ? p.m[ml_index(p, h, batch, head, qi)] : kNegInf;
    l[r] = in ? p.l[ml_index(p, h, batch, head, qi)] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      acc[r][c] = in && col < p.d ? p.o[o_index(p, h, batch, qi, head, col)] : 0.f;
    }
  }

  for (int k0 = 0; k0 < k_end; k0 += kSimtBlockK) {
    __syncthreads();
    for (int i = tid; i < kSimtBlockK * D; i += kSimtThreads) {
      const int r = i / D, c = i % D, ki = k0 + r;
      const bool in = ki < p.s && c < p.d;
      Kt[c * kKtStride + r] = in ? to_f32(k[ki * p.k_s + c]) : 0.f;
      Vs[i] = in ? to_f32(v[ki * p.v_s + c]) : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    for (int c = 0; c < D; c += 4) {
      float ka[4], kb[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        ka[t] = Kt[(c + t) * kKtStride + lane];
        kb[t] = Kt[(c + t) * kKtStride + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&Qs[(row0 + r) * D + c]);
        s[r][0] += qv.x * ka[0] + qv.y * ka[1] + qv.z * ka[2] + qv.w * ka[3];
        s[r][1] += qv.x * kb[0] + qv.y * kb[1] + qv.z * kb[2] + qv.w * kb[3];
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = q0 + row0 + r;
      float sv[2];
      bool valid[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ki = k0 + lane + 32 * j;
        valid[j] = ki < p.s && (!p.causal || ki <= qi + p.delta);
        sv[j] = valid[j] ? s[r][j] * p.scale : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sv[0], sv[1])));
      const float alpha = expf(m[r] - m_new);
      const float p0 = valid[0] ? expf(sv[0] - m_new) : 0.f;
      const float p1 = valid[1] ? expf(sv[1] - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      Ps[(row0 + r) * kPStride + lane] = p0;
      Ps[(row0 + r) * kPStride + lane + 32] = p1;
    }
    __syncwarp();

    for (int j = 0; j < kSimtBlockK; j += 4) {
      float vv[4][kCols];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < kCols; ++c) vv[t][c] = Vs[(j + t) * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(&Ps[(row0 + r) * kPStride + j]);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[r][c] += pv.x * vv[0][c] + pv.y * vv[1][c] + pv.z * vv[2][c] + pv.w * vv[3][c];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= p.s) continue;
    if (p.mode & kLast) {  // o / max(l, 1e-20), IEEE rounding, as _finish
      const float l_div = fmaxf(l[r], 1e-20f);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        if (col < p.d)
          static_cast<T*>(p.out)[o_index(p, h, batch, qi, head, col)] =
              from_f32<T>(__fdiv_rn(acc[r][c], l_div));
      }
      continue;
    }
    if (lane == 0) {
      p.m[ml_index(p, h, batch, head, qi)] = m[r];
      p.l[ml_index(p, h, batch, head, qi)] = l[r];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < p.d) p.o[o_index(p, h, batch, qi, head, col)] = acc[r][c];
    }
  }
}

template <typename T, int D>
cudaError_t launch_simt(const RingParams& p, int b, int h, cudaStream_t stream) {
  const size_t smem = simt_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ring_block_simt<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + kSimtBlockQ - 1) / kSimtBlockQ, h, b);
  ring_block_simt<T, D><<<grid, kSimtThreads, smem, stream>>>(p, h);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt_bucket(const RingParams& p, int b, int h, cudaStream_t stream) {
  if (p.d <= 32) return launch_simt<T, 32>(p, b, h, stream);
  if (p.d <= 64) return launch_simt<T, 64>(p, b, h, stream);
  return launch_simt<T, 128>(p, b, h, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (of q, k, v and out; the
// carry is f32). strides: 9 element strides, (b, s, h) of q, k and v in
// that order; o, m, l and out are contiguous from 16-byte aligned bases.
// q_offset, k_offset: the global positions of the blocks' first rows.
// mode: 0 = middle, 1 = first, 2 = last, 3 = first+last (the kFirst and
// kLast bits); o, m and l may be null in first+last, out must be given
// exactly in the last modes. route: 0 = simt, 1 = wgmma; it must be the
// one wgmma_route gives. A call that breaks these rules returns
// cudaErrorInvalidValue without launching. Returns the CUDA error code of
// the launch (0 on success); the kernel runs on `stream` and is not
// synchronised.
extern "C" int tpusnap_ring_block_attend(const void* q, const void* k, const void* v, float* o,
                                         float* m, float* l, void* out,
                                         const int64_t* strides, int b, int s, int h, int d,
                                         int64_t q_offset, int64_t k_offset, float scale,
                                         int causal, int mode, int dtype, int route,
                                         void* stream) {
  if (d < 1 || d > 128 || s < 1 || b < 1 || h < 1) return int(cudaErrorInvalidValue);
  if (mode < 0 || mode > (kFirst | kLast)) return int(cudaErrorInvalidValue);
  const bool uses_carry = mode != (kFirst | kLast);
  if ((uses_carry && (o == nullptr || m == nullptr || l == nullptr)) ||
      ((mode & kLast) != 0) != (out != nullptr))
    return int(cudaErrorInvalidValue);
  RingParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.m = m;
  p.l = l;
  p.out = out;
  p.mode = mode;
  p.q_b = strides[0];
  p.q_s = strides[1];
  p.q_h = strides[2];
  p.k_b = strides[3];
  p.k_s = strides[4];
  p.k_h = strides[5];
  p.v_b = strides[6];
  p.v_s = strides[7];
  p.v_h = strides[8];
  p.s = s;
  p.d = d;
  const int64_t delta = q_offset - k_offset;
  p.delta = int(delta < -s ? -s : delta > s ? s : delta);
  p.scale = scale;
  p.causal = causal;

  tpusnap_flash::Params fp{};
  fp.q = q;
  fp.k = k;
  fp.v = v;
  fp.q_b = p.q_b;
  fp.q_s = p.q_s;
  fp.q_h = p.q_h;
  fp.k_b = p.k_b;
  fp.k_s = p.k_s;
  fp.k_h = p.k_h;
  fp.v_b = p.v_b;
  fp.v_s = p.v_s;
  fp.v_h = p.v_h;
  fp.s = s;
  fp.d = d;
  if (route != int(tpusnap_flash::wgmma_route(fp, b, h, dtype))) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype == tpusnap_flash::kBFloat16)
      return int(launch_wgmma_bucket<__nv_bfloat16>(p, b, h, dtype, st));
    return int(launch_wgmma_bucket<__half>(p, b, h, dtype, st));
  }
  cudaError_t err;
  switch (dtype) {
    case tpusnap_flash::kFloat32: err = launch_simt_bucket<float>(p, b, h, st); break;
    case tpusnap_flash::kFloat16: err = launch_simt_bucket<__half>(p, b, h, st); break;
    case tpusnap_flash::kBFloat16: err = launch_simt_bucket<__nv_bfloat16>(p, b, h, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return int(err);
}
