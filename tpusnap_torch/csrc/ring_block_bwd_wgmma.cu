// Attention's backward block on Hopper (sm_90a): one K/V block's share of
// attention's gradients, added into the ring's f32 accumulators or written
// once in the input type; and delta = rowsum(dO * O), the row term every
// backward needs. Plain C interface.
//
// Replaces the backward of tpusnap/ops/ring_attention.py::_block_attend
// (XLA's autodiff of the block step inside ring_attention's fori_loop, a
// compiled device program, not a Pallas kernel) and tpusnap's flash
// backward, tpusnap/ops/flash_attention.py::_flash_bwd (plain XLA autodiff
// of _attention_reference): the whole sequence is one diagonal block at
// offsets (0, 0). For a local query block q and one K/V block (all
// [b, s, h, d]), the upstream gradient dO of q's shape, the row
// log-sum-exp lse = m + log l and delta of the whole rows ([b, h, s] f32),
// it computes what ring_attention.block_grads computes:
//
//   P   = exp(Q K^T * scale - lse), 0 where key j is past query i in global
//         positions (causal: j > i + q_offset - k_offset) or past s;
//   dV  = P^T dO;
//   dS  = P * (dO V^T - delta);
//   dQ  = dS K * scale;   dK = dS^T Q * scale,
//
// and either adds it into f32 accumulators dq, dk, dv (accumulate: the
// ring's backward, one call per block step) or writes it in the input type
// (store: the flash backward and the ring of one, one call in all).
//
// Deterministic, no float atomics (a post-restore step is compared bit for
// bit, so every sum has one fixed order): each output element is written
// by one thread, once, after its sums. The work is two kinds of items in
// one launch, whose outputs are disjoint: a dK/dV item owns a tile of K
// and V and streams the query tiles that see it (S^T = K Q^T and
// dP^T = V dO^T, so that P^T and dS^T come out in the accumulator layout
// and feed dV += P^T dO and dK += dS^T Q from registers); a dQ item owns a
// tile of Q and dO and streams the key tiles it sees (S = Q K^T,
// dP = dO V^T, dQ += dS K). Both recompute P from lse. A causal block
// wholly in the queries' future is skipped by the caller without a launch.
//
// Two routes, picked in Python (ring_attention._grads_route) and checked
// again here with the flash kernel's rule (wgmma_route in
// flash_attention.cuh) over q, k, v and dO, and d <= 128:
//
// * wgmma (ring_grads_wgmma): bf16/f16 that a TMA tensor map can describe,
//   d <= 128 (templates at 64 and 128; a smaller d runs in the 64 one, the
//   tensor maps filling the columns past d with zeros). Persistent CTAs,
//   one per SM, walk the items longest first (under the causal mask the
//   first key tiles and the last query tiles see the most), alternating
//   the two kinds, so that one kind's tail fills with the other's work. A
//   producer warp keeps a ring of kStages slots of streamed tiles (Q and
//   dO, or K and V, 64 rows each, with the streamed queries' lse and delta
//   in the dK/dV items) full by TMA with mbarriers; the consumer
//   warpgroups (two at d = 64 on a 128-row own tile, one at d = 128, where
//   a dK/dV item's f32 dK and dV alone are 128 registers a thread) share
//   every streamed tile, so a streamed tile is loaded once per 128 own
//   rows. The first-stage products take both bf16/f16 operands from
//   shared memory, K-major, and are exact in f32; the second-stage
//   products take P and dS from registers, rounded to the input type as
//   the forward rounds P, and dO, Q or K as MN-major B operands. In
//   accumulate mode the producer prefetches each item's f32 accumulator
//   rows into L2 (cp.async.bulk.prefetch) when it loads the item's own
//   tiles, so their read overlaps the products and the read-modify-write
//   at the item's end finds them in L2; staging them in shared memory
//   does not fit at d = 128 (a dK/dV item's two 64 x 128 f32 tiles are
//   64 KB beside 160 KB of operand tiles). A consumer warpgroup skips the
//   products of a tile pair the mask removes whole.
// * simt (ring_grads_simt): f32 (no tensor-core type keeps the f32
//   tolerance), 16-bit layouts TMA cannot describe, and 128 < d <= 256.
//   The same two kinds of items in one launch (one CTA each), in f32 from
//   shared memory, for correctness only; 32-row tiles at d = 256, so that
//   they fit in 227 KB.
//
// What bounds it on this card: at the flagship's ring block (b=8, s=512,
// h=8, d=64, bf16) the function reads q, k, v and dO once (16.8 MB), lse
// and delta (0.26 MB), and reads and writes the f32 accumulators dq, dk and
// dv once each (50.3 MB): 67.4 MB over HBM, 20.1 us at 3.35 TB/s. Its
// operations are 10 per kept (query, key) pair and head_dim (S, dP, dV, dQ
// and dK, 2 per multiply-add): 5.4 GFLOP on the diagonal block, 10.7 GFLOP
// on a past one, 5.4 and 10.9 us at 989 TFLOP/s. So the bytes bound it in
// accumulate mode, most of them the accumulators'. In store mode at the
// flash backward's (8, 1024, 8, 64) causal the bytes are 29.4 MB (8.8 us)
// and the operations 21.5 GFLOP (21.7 us): the tensor cores bound it. The
// kernel recomputes S and dP in both kinds of items (14 operations a pair
// in all, not 10) to avoid atomics; the streamed tiles are re-read from
// L2, not HBM (one (batch, head)'s q, k, v and dO are 256 KB).
//
// attention_delta: delta[b, h, i] = sum over d of dO[b, i, h, :] * O[b, i,
// h, :], f32 products summed lane by lane in column order and then across
// the row's lanes in a fixed butterfly: each lane one 16-byte vector of a
// row where the rows are whole aligned vectors (d = 64 bf16: 8 lanes a row,
// 4 rows a warp), one warp a row otherwise. It reads dO and O once in their
// type and writes 4 bytes a row: 16.8 MB at (8, 1024, 8, 64) bf16, 5.0 us
// at 3.35 TB/s, the bytes bound it.

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_attention.cuh"
#include "hopper_ptx.cuh"
#include "tma_host.cuh"

namespace {

using namespace tpusnap_ptx;
using tpusnap_tma::make_map;

struct GradParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [b, h, s], contiguous
  const float* delta;  // [b, h, s], contiguous
  // [b, s, h, d], contiguous: f32 accumulators added in place, or (store)
  // the gradients in the input type, written.
  void* dq;
  void* dk;
  void* dv;
  // Element strides of the b, s and h dims of q, k, v and dO (d is
  // contiguous).
  int64_t q_b, q_s, q_h;
  int64_t k_b, k_s, k_h;
  int64_t v_b, v_s, v_h;
  int64_t o_b, o_s, o_h;
  int s, d;
  int shift;  // q_offset - k_offset, clamped to [-s, s]
  float scale;
  int causal;
  int store;
};

// Kernel launches made by tpusnap_ring_block_grads (one a call).
std::atomic<long long> g_grads_launches{0};

__device__ __forceinline__ int64_t acc_index(const GradParams& p, int h, int batch, int row,
                                             int head, int col) {
  return ((int64_t(batch) * p.s + row) * h + head) * p.d + col;
}
__device__ __forceinline__ int64_t row_index(const GradParams& p, int h, int batch, int head,
                                             int row) {
  return (int64_t(batch) * h + head) * p.s + row;
}

constexpr float kLog2e = 1.4426950408889634f;

// An item: the own tile (keys in a dK/dV item, queries in a dQ item) of
// one (head, batch) from row own0, and the range [t_begin, t_end) of
// streamed tiles of `tile` rows that reach it.
struct Item {
  int own0, head, batch, t_begin, t_end;
  bool dq;
};

// Item i of 2 * ceil(s / own_rows) * h * b: own-tile rank slowest, then the
// kind, then (head, batch); rank 0 is the longest under the causal mask
// (the first key tile, the last query tile).
__device__ __forceinline__ Item item_of(const GradParams& p, int b, int h, int own_rows,
                                        int tile, int i) {
  const int n_own = (p.s + own_rows - 1) / own_rows;
  const int hb = h * b;
  const int rank = i / (2 * hb);
  Item w;
  w.dq = (i / hb) % 2 == 1;
  w.head = (i % hb) % h;
  w.batch = (i % hb) / h;
  w.own0 = (w.dq ? n_own - 1 - rank : rank) * own_rows;
  if (w.dq) {
    // Keys past the last one the tile's last query may see hold nothing.
    const int key_end = p.causal ? max(0, min(p.s, w.own0 + own_rows + p.shift)) : p.s;
    w.t_begin = 0;
    w.t_end = (key_end + tile - 1) / tile;
  } else {
    // Queries before the first one that sees the tile's first key.
    const int q_begin = p.causal ? max(0, w.own0 - p.shift) : 0;
    w.t_begin = q_begin / tile;
    w.t_end = q_begin >= p.s ? w.t_begin : (p.s + tile - 1) / tile;
  }
  return w;
}

// Whether every (query, key) pair of a rows x rows tile pair is kept (no
// mask needed), whether any is, and whether one pair is.
__device__ __forceinline__ bool all_kept(const GradParams& p, int q_lo, int k_lo, int rows) {
  const int q_hi = q_lo + rows - 1, k_hi = k_lo + rows - 1;
  return q_hi < p.s && k_hi < p.s && (!p.causal || k_hi <= q_lo + p.shift);
}
__device__ __forceinline__ bool any_kept(const GradParams& p, int q_lo, int k_lo, int rows) {
  return q_lo < p.s && k_lo < p.s && (!p.causal || k_lo <= q_lo + rows - 1 + p.shift);
}
__device__ __forceinline__ bool kept(const GradParams& p, int q, int key) {
  return q < p.s && key < p.s && (!p.causal || key <= q + p.shift);
}

// ---- wgmma route -----------------------------------------------------------

constexpr int kTile = 64;       // rows of a streamed tile and of a warpgroup's own rows
constexpr int kRowBytes = 128;  // one 64-column (16-bit) or 32-column (f32) swizzle atom row
constexpr int kOwnSlots = 2;    // slots of the own tiles: the next item's load early
// Registers after setmaxnreg with two consumer warpgroups: the producer
// warpgroup gives most of its share to the consumers (128 * 40 + 256 * 232
// <= 65536).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int D>
struct GradTile {
  static constexpr int kWGs = D <= 64 ? 2 : 1;  // consumer warpgroups
  static constexpr int kOwn = kWGs * kTile;      // rows of an item's own tile
  static constexpr int kConsumerWarps = 4 * kWGs;
  static constexpr int kThreads = 128 * (kWGs + 1);  // + the producer warpgroup
  static constexpr int kStages = D <= 64 ? 4 : 3;     // slots of the streamed ring
  static constexpr int kChunks = D / 64;
  static constexpr int kOwnBytes = kOwn * D * 2;      // one own [kOwn, D] 16-bit tile
  static constexpr int kStreamBytes = kTile * D * 2;  // one streamed [64, D] tile
  static constexpr int kEpiTileBytes = kTile * D * 4;  // a warpgroup's [64, D] f32 tile
  static constexpr int kStatFloats = 2 * kTile;       // a slot's lse (log2 units) and delta
  // kOwnSlots slots of the two own tiles, kStages slots of two streamed
  // tiles, each consumer warpgroup's two epilogue tiles (dK and dV, or
  // dQ: f32 in 32-column boxes, or the input type in 64-column boxes),
  // the streamed slots' row statistics, then the barriers: own
  // full[kOwnSlots], own empty[kOwnSlots], full[kStages], empty[kStages],
  // acc full[kWGs]. 227 KB at d = 128.
  static constexpr int kSlotsOffset = kOwnSlots * 2 * kOwnBytes;
  static constexpr int kEpiOffset = kSlotsOffset + kStages * 2 * kStreamBytes;
  static constexpr int kStatsOffset = kEpiOffset + kWGs * 2 * kEpiTileBytes;
  static constexpr int kBarOffset = kStatsOffset + kStages * kStatFloats * 4;
  static constexpr int kSmemBytes = kBarOffset + (2 * kOwnSlots + 2 * kStages + kWGs) * 8;
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

// The shared memory and tensor maps both roles address.
template <int D>
struct GradSmem {
  uint8_t* own;    // slot i: K (dK/dV item) or Q (dQ item), then V or dO; each
                   // [chunk][kOwn rows][128 B], swizzled
  uint8_t* slots;  // slot i: streamed tile 1 (Q or K), then 2 (dO or V)
  uint8_t* epi;    // warpgroup w: tiles 2w and 2w + 1
  float* stats;    // slot i: lse [64], delta [64] of the streamed queries
  uint64_t* own_full;
  uint64_t* own_empty;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* acc_full;
  // dq, dk, dv: f32 (accumulate) or the input type (store), 64-row boxes.
  const CUtensorMap* out_q;
  const CUtensorMap* out_k;
  const CUtensorMap* out_v;
};

// P = exp(S * scale - lse) into x (0 where masked, if kMasked), and
// dS = P (dP - delta) into y. Rows of the accumulators are the warpgroup's
// own rows, columns the streamed tile's: a dQ item's lse and delta are its
// rows' (lse_r, delta_r), a dK/dV item's its columns' (8 pairs, lse2 and
// dlt2).
template <bool kDQ, bool kMasked>
__device__ __forceinline__ void p_and_ds(const GradParams& p, float (&x)[kTile / 2],
                                         float (&y)[kTile / 2], const float (&lse_r)[2],
                                         const float (&delta_r)[2],
                                         const float2 (&lse2)[kTile / 8],
                                         const float2 (&dlt2)[kTile / 8], int q_lo, int k_lo,
                                         int local_a, int local_b, int col_lane,
                                         float scale_log2) {
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) {
    const int row = (i / 2) % 2 ? local_b : local_a;
    const int col = (i / 4) * 8 + col_lane + (i % 2);
    const float lse = kDQ ? lse_r[(i / 2) % 2] : (i % 2 ? lse2[i / 4].y : lse2[i / 4].x);
    const float dlt = kDQ ? delta_r[(i / 2) % 2] : (i % 2 ? dlt2[i / 4].y : dlt2[i / 4].x);
    float pv = exp2_approx(fmaf(x[i], scale_log2, -lse));
    if (kMasked &&
        !(kDQ ? kept(p, q_lo + row, k_lo + col) : kept(p, q_lo + col, k_lo + row)))
      pv = 0.f;
    y[i] = pv * (y[i] - dlt);
    x[i] = pv;
  }
}

// One consumer warpgroup's share of an item: the 64 own rows from
// own0 + 64 half (warpgroup wg's epilogue tiles and barrier). kDQ = false:
// a dK/dV item (own K, V; streamed Q, dO). kDQ = true: a dQ item (own Q,
// dO; streamed K, V). `kv` counts the streamed tiles this CTA has
// consumed, `own_it` the own tiles, `acc_it` this warpgroup's epilogue
// tiles loaded.
template <typename T, int D, bool kDQ>
__device__ __forceinline__ void consume_item(const GradParams& p, int h, const Item& w, int wg,
                                             int half, const GradSmem<D>& sm, int& kv,
                                             int& own_it, int& acc_it) {
  using Cfg = GradTile<D>;
  constexpr int kSRegs = kTile / 2;  // a [64 x 64] f32 accumulator
  constexpr int kAccRegs = D / 2;    // a [64 x D] f32 accumulator
  constexpr int kKSteps = kTile / 16;
  constexpr int kOuts = kDQ ? 1 : 2;  // epilogue tiles: dQ, or dK and dV

  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const bool leader = threadIdx.x % 128 == 0;
  const int col_lane = 2 * (lane % 4);
  const int local_a = warp * 16 + lane / 4, local_b = local_a + 8;
  const int own_lo = w.own0 + half * kTile;
  const float scale_log2 = p.scale * kLog2e;
  uint8_t* epi = sm.epi + wg * 2 * Cfg::kEpiTileBytes;
  const CUtensorMap* out1 = kDQ ? sm.out_q : sm.out_k;

  const bool has_tiles = w.t_begin < w.t_end;
  if (!p.store && !has_tiles) return;  // nothing of this block reaches the tile
  float acc_1[kAccRegs];             // dK (dK/dV item) or dQ, unscaled
  float acc_2[kDQ ? 1 : kAccRegs];   // dV (dK/dV item)
#pragma unroll
  for (int j = 0; j < kAccRegs; ++j) acc_1[j] = 0.f;
#pragma unroll
  for (int j = 0; j < (kDQ ? 1 : kAccRegs); ++j) acc_2[j] = 0.f;

  // This warpgroup's accumulator rows into its epilogue tiles, issued by
  // one thread once the item's first products run (the previous item's
  // store must have read the tiles first), landing while the rest run.
  auto load_acc = [&]() {
    bulk_wait_read();
    mbar_expect_tx(&sm.acc_full[wg], kOuts * Cfg::kEpiTileBytes);
    for (int o = 0; o < kOuts; ++o)
      for (int c = 0; c < D / 32; ++c)
        tma_load_4d(epi + o * Cfg::kEpiTileBytes + c * kTile * kRowBytes, o ? sm.out_v : out1,
                    &sm.acc_full[wg], c * 32, w.head, own_lo, w.batch);
  };
  bool acc_pending = !p.store;
  if (has_tiles) {
    // A dQ item's rows: lse (in log2 units) and delta of rows a and b.
    float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
    if (kDQ) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = own_lo + (r ? local_b : local_a);
        if (row < p.s) {
          lse_r[r] = p.lse[row_index(p, h, w.batch, w.head, row)] * kLog2e;
          delta_r[r] = p.delta[row_index(p, h, w.batch, w.head, row)];
        }
      }
    }
    const int own_slot = own_it % kOwnSlots;
    const uint32_t a1_addr =
        smem_addr(sm.own + own_slot * 2 * Cfg::kOwnBytes) + half * kTile * kRowBytes;
    const uint32_t a2_addr = a1_addr + Cfg::kOwnBytes;
    mbar_wait(&sm.own_full[own_slot], (own_it / kOwnSlots) & 1);

    for (int t = w.t_begin; t < w.t_end; ++t, ++kv) {
      const int slot = kv % Cfg::kStages;
      mbar_wait(&sm.full[slot], (kv / Cfg::kStages) & 1);
      const int q_lo = kDQ ? own_lo : t * kTile, k_lo = kDQ ? t * kTile : own_lo;
      if (any_kept(p, q_lo, k_lo, kTile)) {
        const uint32_t b1_addr = smem_addr(sm.slots + slot * 2 * Cfg::kStreamBytes);
        const uint32_t b2_addr = b1_addr + Cfg::kStreamBytes;
        // X = A1 B1^T (S^T or S), Y = A2 B2^T (dP^T or dP): K-major
        // operands from shared memory, f32 accumulators.
        float acc_x[kSRegs], acc_y[kSRegs];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          Mma<T>::ss(acc_x, smem_desc(a1_addr + (kk / 4) * Cfg::kOwn * kRowBytes + off, 16, 1024),
                     smem_desc(b1_addr + (kk / 4) * kTile * kRowBytes + off, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          Mma<T>::ss(acc_y, smem_desc(a2_addr + (kk / 4) * Cfg::kOwn * kRowBytes + off, 16, 1024),
                     smem_desc(b2_addr + (kk / 4) * kTile * kRowBytes + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        if (acc_pending) {
          if (leader) load_acc();
          acc_pending = false;
        }
        // A dK/dV item's columns are queries: each thread's 16 columns'
        // lse and delta as 8 pairs (8-byte shared loads), read while the
        // products run.
        float2 col_lse[kTile / 8], col_delta[kTile / 8];
        if constexpr (!kDQ) {
          const float* row_stat = sm.stats + slot * Cfg::kStatFloats;
#pragma unroll
          for (int g = 0; g < kTile / 8; ++g) {
            col_lse[g] = *reinterpret_cast<const float2*>(row_stat + g * 8 + col_lane);
            col_delta[g] = *reinterpret_cast<const float2*>(row_stat + kTile + g * 8 + col_lane);
          }
        }
        wgmma_wait<0>();
        fence_regs(acc_x);
        fence_regs(acc_y);

        if (all_kept(p, q_lo, k_lo, kTile))
          p_and_ds<kDQ, false>(p, acc_x, acc_y, lse_r, delta_r, col_lse, col_delta, q_lo, k_lo,
                               local_a, local_b, col_lane, scale_log2);
        else
          p_and_ds<kDQ, true>(p, acc_x, acc_y, lse_r, delta_r, col_lse, col_delta, q_lo, k_lo,
                              local_a, local_b, col_lane, scale_log2);
        // P and dS rounded to the input type as A fragments over the
        // streamed tile's 64 rows (the products' K dimension).
        uint32_t a_p[kDQ ? 1 : kKSteps][4], a_ds[kKSteps][4];
#pragma unroll
        for (int j = 0; j < kKSteps; ++j)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if constexpr (!kDQ)
              a_p[j][u] = pack2<T>(acc_x[8 * j + 2 * u], acc_x[8 * j + 2 * u + 1]);
            a_ds[j][u] = pack2<T>(acc_y[8 * j + 2 * u], acc_y[8 * j + 2 * u + 1]);
          }
        // dK/dV: dV += P^T dO, dK += dS^T Q. dQ: dQ += dS K. The streamed
        // tile is the MN-major B operand: 16 of its rows a step.
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kKSteps; ++j) {
          const uint64_t db1 = smem_desc(b1_addr + j * 16 * kRowBytes, kTile * kRowBytes, 1024);
          Mma<T>::rs(acc_1, a_ds[j], db1, 1);
          if constexpr (!kDQ) {
            const uint64_t db2 = smem_desc(b2_addr + j * 16 * kRowBytes, kTile * kRowBytes, 1024);
            Mma<T>::rs(acc_2, a_p[j], db2, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_1);
#pragma unroll
        for (int j = 0; j < kKSteps; ++j) fence_regs(a_ds[j]);
        if constexpr (!kDQ) {
          fence_regs(acc_2);
#pragma unroll
          for (int j = 0; j < kKSteps; ++j) fence_regs(a_p[j]);
        }
      }
      // This warp is done with the slot: the producer may refill it.
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[slot]);
    }
    // Every product that reads the own tiles is done.
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.own_empty[own_slot]);
    ++own_it;
  }
  if (acc_pending && leader) load_acc();  // no tile pair of the item had a kept pair

  // The epilogue through this warpgroup's epilogue tiles, swizzled as
  // their tensor maps say, stored by one thread's TMA (rows past s and
  // columns past d are not written). dK and dQ scaled, as block_grads
  // scales them; pairs of columns at a time. Accumulate: the f32 rows
  // loaded at the item's start plus the sums. Store: the sums in the
  // input type (zeros for an item no tile reaches), written once.
  if (p.store) {
    if (leader) bulk_wait_read();  // the previous item's store has read the tiles
    named_barrier_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < kAccRegs; j += 2) {
      const int local = (j / 2) % 2 ? local_b : local_a;
      const int col = (j / 4) * 8 + col_lane;
      const int at = (col / 64) * kTile * kRowBytes + swizzled(local, (col % 64) * 2);
      *reinterpret_cast<uint32_t*>(epi + at) = pack2<T>(acc_1[j] * p.scale, acc_1[j + 1] * p.scale);
      if constexpr (!kDQ)
        *reinterpret_cast<uint32_t*>(epi + Cfg::kEpiTileBytes + at) =
            pack2<T>(acc_2[j], acc_2[j + 1]);
    }
  } else {
    mbar_wait(&sm.acc_full[wg], acc_it & 1);
    ++acc_it;
#pragma unroll
    for (int j = 0; j < kAccRegs; j += 2) {
      const int local = (j / 2) % 2 ? local_b : local_a;
      const int col = (j / 4) * 8 + col_lane;
      const int at = (col / 32) * kTile * kRowBytes + swizzled(local, (col % 32) * 4);
      float2* g = reinterpret_cast<float2*>(epi + at);
      float2 v = *g;
      v.x += acc_1[j] * p.scale;
      v.y += acc_1[j + 1] * p.scale;
      *g = v;
      if constexpr (!kDQ) {
        float2* gv = reinterpret_cast<float2*>(epi + Cfg::kEpiTileBytes + at);
        float2 u = *gv;
        u.x += acc_2[j];
        u.y += acc_2[j + 1];
        *gv = u;
      }
    }
  }
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (leader) {
    const int box_cols = p.store ? 64 : 32;
    for (int o = 0; o < kOuts; ++o)
      for (int c = 0; c < D / box_cols; ++c)
        tma_store_4d(o ? sm.out_v : out1, epi + o * Cfg::kEpiTileBytes + c * kTile * kRowBytes,
                     c * box_cols, w.head, own_lo, w.batch);
    bulk_commit();
  }
}

// Tensor maps: q, dO, k, v with kOwn-row boxes for the own tiles (own_*),
// then with 64-row boxes for the streamed ones (str_*); dq, dk, dv with
// 64-row boxes for the epilogue (out_*).
template <typename T, int D>
__global__ void __launch_bounds__(GradTile<D>::kThreads, 1)
    ring_grads_wgmma(const __grid_constant__ CUtensorMap own_q,
                     const __grid_constant__ CUtensorMap own_o,
                     const __grid_constant__ CUtensorMap own_k,
                     const __grid_constant__ CUtensorMap own_v,
                     const __grid_constant__ CUtensorMap str_q,
                     const __grid_constant__ CUtensorMap str_o,
                     const __grid_constant__ CUtensorMap str_k,
                     const __grid_constant__ CUtensorMap str_v,
                     const __grid_constant__ CUtensorMap out_q,
                     const __grid_constant__ CUtensorMap out_k,
                     const __grid_constant__ CUtensorMap out_v, GradParams p, int b, int h) {
  using Cfg = GradTile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  GradSmem<D> sm;
  sm.own = smem;
  sm.slots = smem + Cfg::kSlotsOffset;
  sm.epi = smem + Cfg::kEpiOffset;
  sm.stats = reinterpret_cast<float*>(smem + Cfg::kStatsOffset);
  sm.own_full = reinterpret_cast<uint64_t*>(smem + Cfg::kBarOffset);
  sm.own_empty = sm.own_full + kOwnSlots;
  sm.full = sm.own_empty + kOwnSlots;
  sm.empty = sm.full + Cfg::kStages;
  sm.acc_full = sm.empty + Cfg::kStages;
  sm.out_q = &out_q;
  sm.out_k = &out_k;
  sm.out_v = &out_v;

  // Persistent: round r of the CTAs takes items r * gridDim.x .. + gridDim.x
  // - 1, in CTA order on even rounds and in reverse on odd ones, so that
  // the short ends of the list even out the long ones.
  const int n_items = 2 * ((p.s + Cfg::kOwn - 1) / Cfg::kOwn) * h * b;
  const int rounds = (n_items + gridDim.x - 1) / gridDim.x;
  auto item_of_round = [&](int rd) {
    return int(rd * gridDim.x + (rd % 2 ? gridDim.x - 1 - blockIdx.x : blockIdx.x));
  };
  const int warp_id = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kOwnSlots; ++i) {
      mbar_init(&sm.own_full[i], 1);
      mbar_init(&sm.own_empty[i], Cfg::kConsumerWarps);
    }
    for (int i = 0; i < Cfg::kStages; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], Cfg::kConsumerWarps);
    }
    for (int i = 0; i < Cfg::kWGs; ++i) mbar_init(&sm.acc_full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp_id >= Cfg::kConsumerWarps) {
    // Producer: its first warp loads each item's own tiles and keeps the
    // streamed ring full; its lanes write the streamed queries' lse and
    // delta into the slot before lane 0 arrives on the slot's barrier.
    if constexpr (Cfg::kWGs == 2) setmaxnreg_dec<kProducerRegs>();
    if (warp_id != Cfg::kConsumerWarps) return;
    int kv = 0, own_it = 0;
    for (int rd = 0; rd < rounds; ++rd) {
      if (item_of_round(rd) >= n_items) continue;
      const Item w = item_of(p, b, h, Cfg::kOwn, kTile, item_of_round(rd));
      if (w.t_begin >= w.t_end) continue;
      const int own_slot = own_it % kOwnSlots;
      if (own_it >= kOwnSlots)
        mbar_wait(&sm.own_empty[own_slot], ((own_it / kOwnSlots) + 1) & 1);
      if (lane == 0) {
        const CUtensorMap* m1 = w.dq ? &own_q : &own_k;
        const CUtensorMap* m2 = w.dq ? &own_o : &own_v;
        uint8_t* a1 = sm.own + own_slot * 2 * Cfg::kOwnBytes;
        uint8_t* a2 = a1 + Cfg::kOwnBytes;
        mbar_expect_tx(&sm.own_full[own_slot], 2 * Cfg::kOwnBytes);
        for (int c = 0; c < Cfg::kChunks; ++c)
          tma_load_4d(a1 + c * Cfg::kOwn * kRowBytes, m1, &sm.own_full[own_slot], c * 64, w.head,
                      w.own0, w.batch);
        for (int c = 0; c < Cfg::kChunks; ++c)
          tma_load_4d(a2 + c * Cfg::kOwn * kRowBytes, m2, &sm.own_full[own_slot], c * 64, w.head,
                      w.own0, w.batch);
      }
      ++own_it;
      for (int t = w.t_begin; t < w.t_end; ++t, ++kv) {
        const int slot = kv % Cfg::kStages;
        // The streamed queries' lse and delta, read before the wait for
        // the slot so that the reads are in flight meanwhile.
        float stat[2][kTile / 32];
        if (!w.dq) {
#pragma unroll
          for (int u = 0; u < kTile / 32; ++u) {
            const int q = t * kTile + lane + 32 * u;
            const bool in = q < p.s;
            stat[0][u] = in ? p.lse[row_index(p, h, w.batch, w.head, q)] * kLog2e : 0.f;
            stat[1][u] = in ? p.delta[row_index(p, h, w.batch, w.head, q)] : 0.f;
          }
        }
        if (kv >= Cfg::kStages) mbar_wait(&sm.empty[slot], ((kv / Cfg::kStages) + 1) & 1);
        if (!w.dq) {
          float* row_stat = sm.stats + slot * Cfg::kStatFloats;
#pragma unroll
          for (int u = 0; u < kTile / 32; ++u) {
            row_stat[lane + 32 * u] = stat[0][u];
            row_stat[kTile + lane + 32 * u] = stat[1][u];
          }
          __syncwarp();
        }
        if (lane == 0) {
          const CUtensorMap* m1 = w.dq ? &str_k : &str_q;
          const CUtensorMap* m2 = w.dq ? &str_v : &str_o;
          uint8_t* b1 = sm.slots + slot * 2 * Cfg::kStreamBytes;
          uint8_t* b2 = b1 + Cfg::kStreamBytes;
          mbar_expect_tx(&sm.full[slot], 2 * Cfg::kStreamBytes);
          for (int c = 0; c < Cfg::kChunks; ++c)
            tma_load_4d(b1 + c * kTile * kRowBytes, m1, &sm.full[slot], c * 64, w.head,
                        t * kTile, w.batch);
          for (int c = 0; c < Cfg::kChunks; ++c)
            tma_load_4d(b2 + c * kTile * kRowBytes, m2, &sm.full[slot], c * 64, w.head,
                        t * kTile, w.batch);
        }
      }
    }
  } else {
    if constexpr (Cfg::kWGs == 2) setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    int kv = 0, own_it = 0, acc_it = 0, items = 0;
    for (int rd = 0; rd < rounds; ++rd) {
      if (item_of_round(rd) >= n_items) continue;
      const Item w = item_of(p, b, h, Cfg::kOwn, kTile, item_of_round(rd));
      // The two halves of an own tile differ by a tile of work under the
      // causal mask; the warpgroups swap halves every item, so that
      // neither runs ahead of the shared ring by more than that.
      const int half = Cfg::kWGs == 2 ? wg ^ (items++ & 1) : 0;
      if (w.dq)
        consume_item<T, D, true>(p, h, w, wg, half, sm, kv, own_it, acc_it);
      else
        consume_item<T, D, false>(p, h, w, wg, half, sm, kv, own_it, acc_it);
    }
    // The last stores must have read the epilogue tiles before the CTA's
    // shared memory goes.
    if (threadIdx.x % 128 == 0) bulk_wait_read();
  }
}

template <typename T, int D>
cudaError_t launch_wgmma(const GradParams& p, int b, int h, int dtype, cudaStream_t stream) {
  using Cfg = GradTile<D>;
  const void* base[4] = {p.q, p.dout, p.k, p.v};
  const int64_t st[4][3] = {{p.q_b, p.q_s, p.q_h},
                            {p.o_b, p.o_s, p.o_h},
                            {p.k_b, p.k_s, p.k_h},
                            {p.v_b, p.v_s, p.v_h}};
  CUtensorMap maps[11];
  for (int i = 0; i < 4; ++i)
    if (!make_map(&maps[i], base[i], dtype, p.d, p.s, b, h, st[i][0], st[i][1], st[i][2],
                  Cfg::kOwn) ||
        !make_map(&maps[4 + i], base[i], dtype, p.d, p.s, b, h, st[i][0], st[i][1], st[i][2],
                  kTile))
      return cudaErrorInvalidValue;
  // The outputs, contiguous [b, s, h, d]: f32 accumulators in 32-column
  // boxes, or the input type in 64-column boxes.
  void* outs[3] = {p.dq, p.dk, p.dv};
  const int64_t row = int64_t(h) * p.d;
  for (int i = 0; i < 3; ++i)
    if (!(p.store ? make_map(&maps[8 + i], outs[i], dtype, p.d, p.s, b, h, p.s * row, row, p.d,
                             kTile)
                  : tpusnap_tma::make_f32_map(&maps[8 + i], static_cast<float*>(outs[i]), p.d,
                                              p.s, b, h)))
      return cudaErrorInvalidValue;
  const int smem = Cfg::kSmemBytes + 1024;  // + room to align to 1024
  cudaError_t err = cudaFuncSetAttribute(ring_grads_wgmma<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int items = 2 * ((p.s + Cfg::kOwn - 1) / Cfg::kOwn) * h * b;
  ring_grads_wgmma<T, D><<<min(items, sms), Cfg::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7], maps[8], maps[9],
      maps[10], p, b, h);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma_bucket(const GradParams& p, int b, int h, int dtype,
                                cudaStream_t stream) {
  if (p.d <= 64) return launch_wgmma<T, 64>(p, b, h, dtype, stream);
  return launch_wgmma<T, 128>(p, b, h, dtype, stream);
}

// ---- simt route ------------------------------------------------------------
//
// The same two kinds of items in f32, one CTA of 8 warps each (even CTAs
// dK/dV, odd ones dQ, longest first): R-row own and streamed tiles (R = 64,
// 32 at d = 256), each warp R / 8 own rows; the streamed tiles are stored
// transposed ([d][R + 1], conflict-free both for the score dot products,
// lane = streamed row, and for the accumulation, lane = column). Scores,
// P and dS in f32 with expf, masked as block_grads masks.

constexpr int kSimtWarps = 8;
constexpr int kSimtThreads = kSimtWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <int D>
struct SimtTile {
  static constexpr int kRows = D <= 128 ? 64 : 32;
  static constexpr int kTStride = kRows + 1;  // padded transposed rows
  static constexpr int kPStride = kRows + 4;  // float4-aligned rows
  static constexpr size_t kSmemFloats = 2 * size_t(kRows) * D + 2 * size_t(D) * kTStride +
                                        2 * size_t(kRows) * kPStride + 2 * size_t(kRows);
};

template <typename T, int D, bool kDQ>
__device__ __forceinline__ void simt_item(const GradParams& p, int b, int h, int idx,
                                          float* smem) {
  using Cfg = SimtTile<D>;
  constexpr int R = Cfg::kRows;
  constexpr int kTStride = Cfg::kTStride, kPStride = Cfg::kPStride;
  constexpr int kRowsPerWarp = R / kSimtWarps;
  constexpr int kJ = R / 32;  // streamed rows a lane: lane + 32 j
  constexpr int kCols = D / 32;
  // idx counts this kind's items, longest first: item_of's numbering
  // restricted to one kind.
  const int hb = h * b;
  const Item w = item_of(p, b, h, R, R, (idx / hb) * 2 * hb + (kDQ ? hb : 0) + idx % hb);
  const bool has_tiles = w.t_begin < w.t_end;
  if (!p.store && !has_tiles) return;

  float* A1 = smem;                 // own tile 1, [R][D]
  float* A2 = A1 + R * D;           // own tile 2
  float* B1t = A2 + R * D;          // streamed tile 1, transposed [D][R + 1]
  float* B2t = B1t + D * kTStride;  // streamed tile 2
  float* Ps = B2t + D * kTStride;   // [R][R + 4]
  float* DSs = Ps + R * kPStride;   // [R][R + 4]
  float* sLse = DSs + R * kPStride;
  float* sDelta = sLse + R;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = warp * kRowsPerWarp;
  const T* q = static_cast<const T*>(p.q) + w.batch * p.q_b + w.head * p.q_h;
  const T* k = static_cast<const T*>(p.k) + w.batch * p.k_b + w.head * p.k_h;
  const T* v = static_cast<const T*>(p.v) + w.batch * p.v_b + w.head * p.v_h;
  const T* o = static_cast<const T*>(p.dout) + w.batch * p.o_b + w.head * p.o_h;
  const T* a1 = kDQ ? q : k;
  const T* a2 = kDQ ? o : v;
  const T* b1 = kDQ ? k : q;
  const T* b2 = kDQ ? v : o;
  const int64_t a1_s = kDQ ? p.q_s : p.k_s, a2_s = kDQ ? p.o_s : p.v_s;
  const int64_t b1_s = kDQ ? p.k_s : p.q_s, b2_s = kDQ ? p.v_s : p.o_s;

  for (int i = tid; i < R * D; i += kSimtThreads) {
    const int r = i / D, c = i % D, row = w.own0 + r;
    const bool in = row < p.s && c < p.d;
    A1[i] = in ? to_f32(a1[row * a1_s + c]) : 0.f;
    A2[i] = in ? to_f32(a2[row * a2_s + c]) : 0.f;
  }
  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = w.own0 + row0 + r;
    const bool in = kDQ && row < p.s;
    lse_r[r] = in ? p.lse[row_index(p, h, w.batch, w.head, row)] : 0.f;
    delta_r[r] = in ? p.delta[row_index(p, h, w.batch, w.head, row)] : 0.f;
  }
  float acc1[kRowsPerWarp][kCols], acc2[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc1[r][c] = acc2[r][c] = 0.f;

  for (int t = w.t_begin; t < w.t_end; ++t) {
    __syncthreads();
    for (int i = tid; i < R * D; i += kSimtThreads) {
      const int r = i / D, c = i % D, row = t * R + r;
      const bool in = row < p.s && c < p.d;
      B1t[c * kTStride + r] = in ? to_f32(b1[row * b1_s + c]) : 0.f;
      B2t[c * kTStride + r] = in ? to_f32(b2[row * b2_s + c]) : 0.f;
    }
    if (!kDQ && tid < R) {
      const int row = t * R + tid;
      sLse[tid] = row < p.s ? p.lse[row_index(p, h, w.batch, w.head, row)] : 0.f;
      sDelta[tid] = row < p.s ? p.delta[row_index(p, h, w.batch, w.head, row)] : 0.f;
    }
    __syncthreads();

    // X = A1 . B1 (scores), Y = A2 . B2 (dP), rows row0.. of the own tile
    // against streamed rows lane + 32 j.
    float x[kRowsPerWarp][kJ], y[kRowsPerWarp][kJ];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int j = 0; j < kJ; ++j) x[r][j] = y[r][j] = 0.f;
    for (int c = 0; c < D; c += 4) {
      float bb1[kJ][4], bb2[kJ][4];
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          bb1[j][u] = B1t[(c + u) * kTStride + lane + 32 * j];
          bb2[j][u] = B2t[(c + u) * kTStride + lane + 32 * j];
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 u1 = *reinterpret_cast<const float4*>(&A1[(row0 + r) * D + c]);
        const float4 u2 = *reinterpret_cast<const float4*>(&A2[(row0 + r) * D + c]);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          x[r][j] += u1.x * bb1[j][0] + u1.y * bb1[j][1] + u1.z * bb1[j][2] + u1.w * bb1[j][3];
          y[r][j] += u2.x * bb2[j][0] + u2.y * bb2[j][1] + u2.z * bb2[j][2] + u2.w * bb2[j][3];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int own = w.own0 + row0 + r, other = t * R + lane + 32 * j;
        const bool in = kDQ ? kept(p, own, other) : kept(p, other, own);
        const float lse = kDQ ? lse_r[r] : sLse[lane + 32 * j];
        const float dlt = kDQ ? delta_r[r] : sDelta[lane + 32 * j];
        const float pv = in ? expf(x[r][j] * p.scale - lse) : 0.f;
        Ps[(row0 + r) * kPStride + lane + 32 * j] = pv;
        DSs[(row0 + r) * kPStride + lane + 32 * j] = pv * (y[r][j] - dlt);
      }
    }
    __syncwarp();

    // acc1 += dS B1 (dK or dQ), acc2 += P B2 (dV).
    for (int jj = 0; jj < R; jj += 4) {
      float v1[4][kCols], v2[4][kCols];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          v1[u][c] = B1t[(lane + 32 * c) * kTStride + jj + u];
          v2[u][c] = kDQ ? 0.f : B2t[(lane + 32 * c) * kTStride + jj + u];
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 ds = *reinterpret_cast<const float4*>(&DSs[(row0 + r) * kPStride + jj]);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc1[r][c] += ds.x * v1[0][c] + ds.y * v1[1][c] + ds.z * v1[2][c] + ds.w * v1[3][c];
        if (!kDQ) {
          const float4 pv = *reinterpret_cast<const float4*>(&Ps[(row0 + r) * kPStride + jj]);
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc2[r][c] += pv.x * v2[0][c] + pv.y * v2[1][c] + pv.z * v2[2][c] + pv.w * v2[3][c];
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = w.own0 + row0 + r;
    if (row >= p.s) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col >= p.d) continue;
      const int64_t at = acc_index(p, h, w.batch, row, w.head, col);
      if (p.store) {
        static_cast<T*>(kDQ ? p.dq : p.dk)[at] = from_f32<T>(acc1[r][c] * p.scale);
        if (!kDQ) static_cast<T*>(p.dv)[at] = from_f32<T>(acc2[r][c]);
      } else {
        static_cast<float*>(kDQ ? p.dq : p.dk)[at] += acc1[r][c] * p.scale;
        if (!kDQ) static_cast<float*>(p.dv)[at] += acc2[r][c];
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kSimtThreads) ring_grads_simt(GradParams p, int b, int h) {
  extern __shared__ __align__(16) float smem[];
  if (blockIdx.x % 2)
    simt_item<T, D, true>(p, b, h, blockIdx.x / 2, smem);
  else
    simt_item<T, D, false>(p, b, h, blockIdx.x / 2, smem);
}

template <typename T, int D>
cudaError_t launch_simt(const GradParams& p, int b, int h, cudaStream_t stream) {
  const size_t smem = SimtTile<D>::kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ring_grads_simt<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int rows = SimtTile<D>::kRows;
  const int ctas = 2 * ((p.s + rows - 1) / rows) * h * b;
  ring_grads_simt<T, D><<<ctas, kSimtThreads, smem, stream>>>(p, b, h);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt_bucket(const GradParams& p, int b, int h, cudaStream_t stream) {
  if (p.d <= 32) return launch_simt<T, 32>(p, b, h, stream);
  if (p.d <= 64) return launch_simt<T, 64>(p, b, h, stream);
  if (p.d <= 128) return launch_simt<T, 128>(p, b, h, stream);
  return launch_simt<T, 256>(p, b, h, stream);
}

// The wgmma rule over three tensors (q, k and v, or dO three times).
bool tma_describes(const void* q, const void* k, const void* v, const int64_t* st, int b, int s,
                   int h, int d, int dtype) {
  tpusnap_flash::Params fp{};
  fp.q = q;
  fp.k = k;
  fp.v = v;
  fp.q_b = st[0];
  fp.q_s = st[1];
  fp.q_h = st[2];
  fp.k_b = st[3];
  fp.k_s = st[4];
  fp.k_h = st[5];
  fp.v_b = st[6];
  fp.v_s = st[7];
  fp.v_h = st[8];
  fp.s = s;
  fp.d = d;
  return tpusnap_flash::wgmma_route(fp, b, h, dtype);
}

// ---- delta -----------------------------------------------------------------

constexpr int kDeltaWarps = 8;

// Rows whose d elements are whole 16-byte vectors that 32 divides into
// (d * itemsize / 16 of 1, 2, 4, ..., 32), from 16-byte aligned bases and
// strides: each lane reads one vector of dO and one of O, and
// 32 / lanes rows share a warp. Other rows: one warp a row, a lane every
// 32nd element.
template <typename T>
__device__ __forceinline__ float dot16(const uint4& x, const uint4& y) {
  const T* a = reinterpret_cast<const T*>(&x);
  const T* b = reinterpret_cast<const T*>(&y);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < int(16 / sizeof(T)); ++i) sum += to_f32(a[i]) * to_f32(b[i]);
  return sum;
}

template <typename T>
__global__ void __launch_bounds__(kDeltaWarps * 32)
    attention_delta(const T* dout, const T* out, float* delta, int64_t do_b, int64_t do_s,
                    int64_t do_h, int64_t o_b, int64_t o_s, int64_t o_h, int b, int s, int h,
                    int d, int lanes) {
  // Row r of delta's [b, h, s] order: consecutive rows are consecutive
  // floats. `lanes` lanes a row (a power of two up to 32) on the vector
  // path, 0 on the element path (one warp a row).
  const int lane = threadIdx.x % 32;
  const int per_warp = lanes ? 32 / lanes : 1;
  const int64_t r = (int64_t(blockIdx.x) * kDeltaWarps + threadIdx.x / 32) * per_warp +
                    (lanes ? lane / lanes : 0);
  const int64_t rows = int64_t(b) * h * s;
  const int i = int(r % s), head = int((r / s) % h), batch = int(r / (int64_t(s) * h));
  const T* x = dout + batch * do_b + i * do_s + head * do_h;
  const T* y = out + batch * o_b + i * o_s + head * o_h;
  float sum = 0.f;
  if (r < rows) {
    if (lanes) {
      const int v = lane % lanes;
      sum = dot16<T>(reinterpret_cast<const uint4*>(x)[v], reinterpret_cast<const uint4*>(y)[v]);
    } else {
      for (int c = lane; c < d; c += 32) sum += to_f32(x[c]) * to_f32(y[c]);
    }
  }
  // Sums across the row's lanes in a fixed butterfly (the whole warp on
  // the element path).
  const int width = lanes ? lanes : 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < width) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (r < rows && lane % width == 0) delta[r] = sum;
}

template <typename T>
cudaError_t launch_delta(const void* dout, const void* out, float* delta, const int64_t* st,
                         int b, int s, int h, int d, cudaStream_t stream) {
  // The vector path when every row is whole, aligned 16-byte vectors.
  const int64_t row_bytes = int64_t(d) * sizeof(T);
  int lanes = row_bytes % 16 == 0 ? int(row_bytes / 16) : 0;
  if (lanes > 32 || (lanes & (lanes - 1)) != 0) lanes = 0;
  if (reinterpret_cast<uintptr_t>(dout) % 16 || reinterpret_cast<uintptr_t>(out) % 16) lanes = 0;
  const int sizes[3] = {b, s, h};
  for (int k = 0; k < 6; ++k)
    if (sizes[k % 3] > 1 && (st[k] * int64_t(sizeof(T))) % 16 != 0) lanes = 0;
  const int64_t rows = int64_t(b) * h * s;
  const int64_t per_block = int64_t(kDeltaWarps) * (lanes ? 32 / lanes : 1);
  attention_delta<T><<<unsigned((rows + per_block - 1) / per_block), kDeltaWarps * 32, 0,
                       stream>>>(static_cast<const T*>(dout), static_cast<const T*>(out), delta,
                                 st[0], st[1], st[2], st[3], st[4], st[5], b, s, h, d, lanes);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (of q, k, v and dout; lse
// and delta are f32). strides: 12 element strides, (b, s, h) of q, k, v and
// dout in that order; lse and delta [b, h, s] and dq, dk, dv [b, s, h, d]
// are contiguous. store = 0: dq, dk, dv are f32 accumulators from 16-byte
// aligned bases, added into; store = 1: they are of the input type from
// 4-byte aligned bases, written (not read). q_offset, k_offset: the global
// positions of the blocks' first rows. route: 0 = simt, 1 = wgmma; it must
// be the one the wgmma rule gives over q, k, v and dout with d <= 128. A
// call that breaks these rules returns cudaErrorInvalidValue without
// launching. Returns the CUDA error code of the launch (0 on success); the
// one kernel runs on `stream` and is not synchronised.
extern "C" int tpusnap_ring_block_grads(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* delta,
                                        void* dq, void* dk, void* dv, const int64_t* strides,
                                        int b, int s, int h, int d, int64_t q_offset,
                                        int64_t k_offset, float scale, int causal, int store,
                                        int dtype, int route, void* stream) {
  if (d < 1 || d > 256 || s < 1 || b < 1 || h < 1 || (store != 0 && store != 1))
    return int(cudaErrorInvalidValue);
  if (q == nullptr || k == nullptr || v == nullptr || dout == nullptr || lse == nullptr ||
      delta == nullptr || dq == nullptr || dk == nullptr || dv == nullptr)
    return int(cudaErrorInvalidValue);
  const void* outs[3] = {dq, dk, dv};
  for (const void* a : outs)
    if (reinterpret_cast<uintptr_t>(a) % (store ? 4 : 16) != 0) return int(cudaErrorInvalidValue);
  GradParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.q_b = strides[0];
  p.q_s = strides[1];
  p.q_h = strides[2];
  p.k_b = strides[3];
  p.k_s = strides[4];
  p.k_h = strides[5];
  p.v_b = strides[6];
  p.v_s = strides[7];
  p.v_h = strides[8];
  p.o_b = strides[9];
  p.o_s = strides[10];
  p.o_h = strides[11];
  p.s = s;
  p.d = d;
  const int64_t shift = q_offset - k_offset;
  p.shift = int(shift < -s ? -s : shift > s ? s : shift);
  p.scale = scale;
  p.causal = causal;
  p.store = store;

  const int64_t o_st[9] = {p.o_b, p.o_s, p.o_h, p.o_b, p.o_s, p.o_h, p.o_b, p.o_s, p.o_h};
  const bool wgmma = d <= 128 && tma_describes(q, k, v, strides, b, s, h, d, dtype) &&
                     tma_describes(dout, dout, dout, o_st, b, s, h, d, dtype);
  if (route != int(wgmma)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == 1) {
    if (dtype == tpusnap_flash::kBFloat16)
      err = launch_wgmma_bucket<__nv_bfloat16>(p, b, h, dtype, st);
    else
      err = launch_wgmma_bucket<__half>(p, b, h, dtype, st);
  } else {
    switch (dtype) {
      case tpusnap_flash::kFloat32: err = launch_simt_bucket<float>(p, b, h, st); break;
      case tpusnap_flash::kFloat16: err = launch_simt_bucket<__half>(p, b, h, st); break;
      case tpusnap_flash::kBFloat16: err = launch_simt_bucket<__nv_bfloat16>(p, b, h, st); break;
      default: return int(cudaErrorInvalidValue);
    }
  }
  if (err == cudaSuccess) g_grads_launches.fetch_add(1);
  return int(err);
}

// Kernel launches tpusnap_ring_block_grads has made in this process.
extern "C" long long tpusnap_ring_block_grads_kernel_launches() {
  return g_grads_launches.load();
}

// delta [b, h, s] f32, contiguous = rowsum(dout * out) over d. dout and out
// are [b, s, h, d] of one dtype (codes as above), contiguous in d; strides:
// (b, s, h) of dout, then of out. Returns the launch's CUDA error code
// (cudaErrorInvalidValue without launching for what it cannot take); not
// synchronised.
extern "C" int tpusnap_attention_delta(const void* dout, const void* out, float* delta,
                                       const int64_t* strides, int b, int s, int h, int d,
                                       int dtype, void* stream) {
  if (d < 1 || s < 1 || b < 1 || h < 1 || dout == nullptr || out == nullptr || delta == nullptr)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpusnap_flash::kFloat32:
      return int(launch_delta<float>(dout, out, delta, strides, b, s, h, d, st));
    case tpusnap_flash::kFloat16:
      return int(launch_delta<__half>(dout, out, delta, strides, b, s, h, d, st));
    case tpusnap_flash::kBFloat16:
      return int(launch_delta<__nv_bfloat16>(dout, out, delta, strides, b, s, h, d, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}
