// Ring attention's backward block step on Hopper (sm_90a): one K/V block's
// share of attention's gradients, added into the ring's f32 accumulators,
// plain C interface.
//
// Replaces the backward of tpusnap/ops/ring_attention.py::_block_attend:
// XLA's autodiff of the block step inside ring_attention's fori_loop (a
// compiled device program, not a Pallas kernel). For a local query block q
// and one K/V block (all [b, s, h, d]), the upstream gradient dO of q's
// shape, the row log-sum-exp lse = m + log l and delta = rowsum(dO * O) of
// the whole rows ([b, h, s] f32), it computes what
// ring_attention.block_grads computes and adds it in place:
//
//   P   = exp(Q K^T * scale - lse), 0 where key j is past query i in global
//         positions (causal: j > i + q_offset - k_offset) or past s;
//   dV += P^T dO;
//   dS  = P * (dO V^T - delta);
//   dQ += dS K * scale;   dK += dS^T Q * scale.
//
// Two launches per call, deterministic, no float atomics (a post-restore
// step is compared bit for bit, so every sum has one fixed order):
//
// * the dK/dV kernel: each CTA owns a 64-key tile of K and V and loops over
//   the 64-query tiles that can see it, computing S^T = K Q^T and
//   dP^T = V dO^T directly, so that P^T and dS^T come out in the
//   accumulator layout and feed dV += P^T dO and dK += dS^T Q from
//   registers;
// * the dQ kernel: each CTA owns a 64-query tile of Q and dO and loops over
//   the 64-key tiles it can see: S = Q K^T, dP = dO V^T, dQ += dS K.
//
// Both recompute P from lse. Each output element is written by one thread
// of one CTA, once, after its sums: the read-modify-write of the
// accumulators needs no ordering between CTAs. A CTA whose tile no query
// (or key) of this block reaches leaves its accumulators as they are; a
// block wholly in the queries' future is skipped by the caller without a
// launch.
//
// Two routes, picked in Python (ring_attention._grads_route) and checked
// again here with the flash kernel's rule (wgmma_route in
// flash_attention.cuh) over q, k, v and dO:
//
// * wgmma (ring_grads_wgmma): bf16/f16 that a TMA tensor map can describe,
//   d <= 128 (templates at 64 and 128; a smaller d runs in the 64 one, the
//   tensor maps filling the columns past d with zeros). One warpgroup per
//   CTA: thread 0 keeps a 2-slot ring of the streamed tiles (Q and dO, or
//   K and V) full with TMA while the warpgroup computes on the other slot;
//   the CTA's own two tiles arrive once. The first-stage products (S^T and
//   dP^T, or S and dP) take both bf16/f16 operands from shared memory,
//   K-major, and are exact in f32. The second-stage products take P and dS
//   from registers, rounded to the input type as the forward rounds P, and
//   dO, Q or K as MN-major B operands, as the forward's P V takes V.
// * simt (ring_grads_simt): f32 (no tensor-core type keeps the f32
//   tolerance) and 16-bit layouts TMA cannot describe. The same two
//   kernels in f32 from shared memory, for correctness only.
//
// What bounds it on this card: at the flagship's ring block (b=8, s=512,
// h=8, d=64, bf16) the function reads q, k, v and dO once (16.8 MB), lse
// and delta (0.26 MB), and reads and writes the f32 accumulators dq, dk and
// dv once each (50.3 MB): 67.4 MB over HBM, 20.1 us at 3.35 TB/s. Its
// operations are 10 per kept (query, key) pair and head_dim (S, dP, dV, dQ
// and dK, 2 per multiply-add): 5.4 GFLOP on the diagonal block, 10.7 GFLOP
// on a past one, 5.4 and 10.9 us at 989 TFLOP/s. So the bytes bound it,
// and most of them are the accumulators' f32 read and write, which the
// in-place interface keeps to one pass (block_grads and three adds make
// four). The kernels recompute S and dP in both launches (14 operations a
// pair in all, not 10) to avoid atomics; the streamed tiles are re-read
// from L2, not HBM (one (batch, head)'s q, k, v and dO are 256 KB).

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

struct GradParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [b, h, s], contiguous
  const float* delta;  // [b, h, s], contiguous
  float* dq;           // [b, s, h, d], contiguous, accumulated in place
  float* dk;
  float* dv;
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
};

__device__ __forceinline__ int64_t acc_index(const GradParams& p, int h, int batch, int row,
                                             int head, int col) {
  return ((int64_t(batch) * p.s + row) * h + head) * p.d + col;
}
__device__ __forceinline__ int64_t row_index(const GradParams& p, int h, int batch, int head,
                                             int row) {
  return (int64_t(batch) * h + head) * p.s + row;
}

constexpr int kTile = 64;  // rows of a CTA's own tile and of each streamed tile
constexpr float kLog2e = 1.4426950408889634f;

// A CTA's work: its own tile (64 keys in the dK/dV kernel, 64 queries in
// the dQ kernel) of one (head, batch), and the range [t_begin, t_end) of
// streamed tiles that reach it. The grid is 1-D with the tile slowest and
// the longest CTAs first: under the causal mask the first key tiles and the
// last query tiles see the most.
struct Work {
  int own0, head, batch, t_begin, t_end;
};

template <bool kDQ>
__device__ __forceinline__ Work work_of(const GradParams& p, int b, int h) {
  const int nt = (p.s + kTile - 1) / kTile;
  const int idx = blockIdx.x;
  const int bh = idx % (h * b);
  const int rank = idx / (h * b);
  Work w;
  w.head = bh % h;
  w.batch = bh / h;
  w.own0 = (kDQ ? nt - 1 - rank : rank) * kTile;
  if (kDQ) {
    // Keys past the last one the tile's last query may see hold nothing.
    const int key_end = p.causal ? max(0, min(p.s, w.own0 + kTile + p.shift)) : p.s;
    w.t_begin = 0;
    w.t_end = (key_end + kTile - 1) / kTile;
  } else {
    // Queries before the first one that sees the tile's first key.
    const int q_begin = p.causal ? max(0, w.own0 - p.shift) : 0;
    w.t_begin = q_begin / kTile;
    w.t_end = q_begin >= p.s ? w.t_begin : nt;
  }
  return w;
}

// True when every (query, key) pair of the tile pair is kept: no mask
// needed.
__device__ __forceinline__ bool all_kept(const GradParams& p, int q_lo, int k_lo) {
  const int q_hi = q_lo + kTile - 1, k_hi = k_lo + kTile - 1;
  return q_hi < p.s && k_hi < p.s && (!p.causal || k_hi <= q_lo + p.shift);
}
__device__ __forceinline__ bool kept(const GradParams& p, int q, int key) {
  return q < p.s && key < p.s && (!p.causal || key <= q + p.shift);
}

// ---- wgmma route -----------------------------------------------------------

constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;
constexpr int kRowBytes = 128;  // one 64-column swizzle atom row

template <int D>
struct GradTile {
  static constexpr int kChunks = D / 64;
  static constexpr int kTileBytes = kTile * D * 2;  // one [64, D] 16-bit tile
  // The CTA's two tiles, kStages slots of two streamed tiles, kStages
  // slots of the streamed tile's lse and delta (dK/dV kernel), barriers.
  static constexpr int kRowStatBytes = kStages * 2 * kTile * 4;
  static constexpr int kSmemBytes =
      2 * kTileBytes + kStages * 2 * kTileBytes + kRowStatBytes + (1 + kStages) * 8;
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

// kDQ = false: the dK/dV kernel (own: K, V; streamed: Q, dO).
// kDQ = true: the dQ kernel (own: Q, dO; streamed: K, V).
// Tensor maps: a1, a2 the CTA's own tiles, b1, b2 the streamed ones, in
// those orders.
template <typename T, int D, bool kDQ>
__global__ void __launch_bounds__(kThreads, 1)
    ring_grads_wgmma(const __grid_constant__ CUtensorMap tm_a1,
                     const __grid_constant__ CUtensorMap tm_a2,
                     const __grid_constant__ CUtensorMap tm_b1,
                     const __grid_constant__ CUtensorMap tm_b2, GradParams p, int b, int h) {
  using Cfg = GradTile<D>;
  constexpr int kSRegs = kTile / 2;  // a [64 x 64] f32 accumulator
  constexpr int kAccRegs = D / 2;    // a [64 x D] f32 accumulator
  constexpr int kKSteps = kTile / 16;

  const Work w = work_of<kDQ>(p, b, h);
  if (w.t_begin >= w.t_end) return;  // nothing of this block reaches the tile

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sA1 = smem;
  uint8_t* sA2 = sA1 + Cfg::kTileBytes;
  uint8_t* sB = sA2 + Cfg::kTileBytes;  // slot i: b1 at 2i, b2 at 2i + 1 tiles
  float* sRow = reinterpret_cast<float*>(sB + kStages * 2 * Cfg::kTileBytes);
  uint64_t* bar_a = reinterpret_cast<uint64_t*>(smem + 2 * Cfg::kTileBytes +
                                                kStages * 2 * Cfg::kTileBytes +
                                                Cfg::kRowStatBytes);
  uint64_t* full = bar_a + 1;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col_lane = 2 * (lane % 4);
  const int local_a = warp * 16 + lane / 4, local_b = local_a + 8;
  const float scale_log2 = p.scale * kLog2e;

  auto load_streamed = [&](int t) {
    const int slot = (t - w.t_begin) % kStages;
    uint8_t* b1 = sB + slot * 2 * Cfg::kTileBytes;
    uint8_t* b2 = b1 + Cfg::kTileBytes;
    mbar_expect_tx(&full[slot], 2 * Cfg::kTileBytes);
    for (int c = 0; c < Cfg::kChunks; ++c)
      tma_load_4d(b1 + c * kTile * kRowBytes, &tm_b1, &full[slot], c * 64, w.head, t * kTile,
                  w.batch);
    for (int c = 0; c < Cfg::kChunks; ++c)
      tma_load_4d(b2 + c * kTile * kRowBytes, &tm_b2, &full[slot], c * 64, w.head, t * kTile,
                  w.batch);
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_a, 1);
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
    mbar_expect_tx(bar_a, 2 * Cfg::kTileBytes);
    for (int c = 0; c < Cfg::kChunks; ++c)
      tma_load_4d(sA1 + c * kTile * kRowBytes, &tm_a1, bar_a, c * 64, w.head, w.own0, w.batch);
    for (int c = 0; c < Cfg::kChunks; ++c)
      tma_load_4d(sA2 + c * kTile * kRowBytes, &tm_a2, bar_a, c * 64, w.head, w.own0, w.batch);
    load_streamed(w.t_begin);
    if (w.t_begin + 1 < w.t_end) load_streamed(w.t_begin + 1);
  }

  // The dQ kernel's rows: lse (in log2 units) and delta of rows a and b.
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  if (kDQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w.own0 + (r ? local_b : local_a);
      if (row < p.s) {
        lse_r[r] = p.lse[row_index(p, h, w.batch, w.head, row)] * kLog2e;
        delta_r[r] = p.delta[row_index(p, h, w.batch, w.head, row)];
      }
    }
  }

  float acc_x[kSRegs], acc_y[kSRegs];
  float acc_1[kAccRegs];              // dK (dK/dV kernel) or dQ, unscaled
  float acc_2[kDQ ? 1 : kAccRegs];   // dV (dK/dV kernel)
#pragma unroll
  for (int j = 0; j < kAccRegs; ++j) acc_1[j] = 0.f;
#pragma unroll
  for (int j = 0; j < (kDQ ? 1 : kAccRegs); ++j) acc_2[j] = 0.f;
  uint32_t a_p[kKSteps][4], a_ds[kKSteps][4];

  const uint32_t a1_addr = smem_addr(sA1), a2_addr = smem_addr(sA2);
  __syncthreads();  // the barriers are initialised
  mbar_wait(bar_a, 0);

  for (int t = w.t_begin; t < w.t_end; ++t) {
    const int i_t = t - w.t_begin;
    const int slot = i_t % kStages;
    float* row_stat = sRow + slot * 2 * kTile;  // lse (log2 units) [64], delta [64]
    if (!kDQ) {
      // The streamed queries' lse and delta, one value a thread. Slot i_t %
      // 2 was last read in step i_t - 2, which every thread finished before
      // the barrier of step i_t - 1.
      const int i = threadIdx.x % kTile, q = t * kTile + i;
      float value = 0.f;
      if (q < p.s)
        value = threadIdx.x < kTile ? p.lse[row_index(p, h, w.batch, w.head, q)] * kLog2e
                                    : p.delta[row_index(p, h, w.batch, w.head, q)];
      row_stat[threadIdx.x] = value;
    }
    // Every thread is done with step i_t - 1 (its products have completed):
    // the slot it used may take step i_t + 1's tiles.
    __syncthreads();
    if (threadIdx.x == 0 && i_t > 0 && t + 1 < w.t_end) load_streamed(t + 1);
    mbar_wait(&full[slot], (i_t / kStages) & 1);

    const uint32_t b1_addr = smem_addr(sB + slot * 2 * Cfg::kTileBytes);
    const uint32_t b2_addr = b1_addr + Cfg::kTileBytes;
    // X = A1 B1^T (S^T or S), Y = A2 B2^T (dP^T or dP): K-major operands
    // from shared memory, f32 accumulators.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kTile * kRowBytes + (kk % 4) * 32;
      Mma<T>::ss(acc_x, smem_desc(a1_addr + off, 16, 1024), smem_desc(b1_addr + off, 16, 1024),
                 kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kTile * kRowBytes + (kk % 4) * 32;
      Mma<T>::ss(acc_y, smem_desc(a2_addr + off, 16, 1024), smem_desc(b2_addr + off, 16, 1024),
                 kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_x);
    fence_regs(acc_y);

    // P = exp(S * scale - lse) (0 where masked) into acc_x, dS = P (dP -
    // delta) into acc_y. Rows of the accumulators are the CTA's own tile,
    // columns the streamed one.
    const int q_lo = kDQ ? w.own0 : t * kTile, k_lo = kDQ ? t * kTile : w.own0;
    const bool full_tile = all_kept(p, q_lo, k_lo);
#pragma unroll
    for (int i = 0; i < kSRegs; ++i) {
      const int row = (i / 2) % 2 ? local_b : local_a;
      const int col = (i / 4) * 8 + col_lane + (i % 2);
      const float lse = kDQ ? lse_r[(i / 2) % 2] : row_stat[col];
      const float dlt = kDQ ? delta_r[(i / 2) % 2] : row_stat[kTile + col];
      float pv = exp2_approx(fmaf(acc_x[i], scale_log2, -lse));
      if (!full_tile && !(kDQ ? kept(p, q_lo + row, k_lo + col) : kept(p, q_lo + col, k_lo + row)))
        pv = 0.f;
      acc_y[i] = pv * (acc_y[i] - dlt);
      acc_x[i] = pv;
    }
    // P and dS rounded to the input type as A fragments over the streamed
    // tile's 64 rows (the products' K dimension).
#pragma unroll
    for (int j = 0; j < kKSteps; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if constexpr (!kDQ) a_p[j][u] = pack2<T>(acc_x[8 * j + 2 * u], acc_x[8 * j + 2 * u + 1]);
        a_ds[j][u] = pack2<T>(acc_y[8 * j + 2 * u], acc_y[8 * j + 2 * u + 1]);
      }
    // dK/dV: dV += P^T dO, dK += dS^T Q. dQ: dQ += dS K. The streamed tile
    // is the MN-major B operand: 16 of its rows a step.
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

  // Add into the accumulators: dK and dQ scaled, as block_grads scales
  // them; pairs of columns as one 8-byte load and store.
  float* dst1 = kDQ ? p.dq : p.dk;
#pragma unroll
  for (int j = 0; j < kAccRegs; j += 2) {
    const int row = w.own0 + ((j / 2) % 2 ? local_b : local_a);
    const int col = (j / 4) * 8 + col_lane;
    if (row >= p.s || col >= p.d) continue;
    const int64_t at = acc_index(p, h, w.batch, row, w.head, col);
    float2 g = *reinterpret_cast<const float2*>(dst1 + at);
    g.x += acc_1[j] * p.scale;
    g.y += acc_1[j + 1] * p.scale;
    *reinterpret_cast<float2*>(dst1 + at) = g;
    if constexpr (!kDQ) {
      float2 gv = *reinterpret_cast<const float2*>(p.dv + at);
      gv.x += acc_2[j];
      gv.y += acc_2[j + 1];
      *reinterpret_cast<float2*>(p.dv + at) = gv;
    }
  }
}

template <typename T, int D, bool kDQ>
cudaError_t launch_wgmma_one(const GradParams& p, int b, int h, int dtype, cudaStream_t stream) {
  // Own tiles first, then the streamed ones: K, V, Q, dO or Q, dO, K, V.
  const void* base[4] = {kDQ ? p.q : p.k, kDQ ? p.dout : p.v, kDQ ? p.k : p.q,
                         kDQ ? p.v : p.dout};
  const int64_t st[4][3] = {
      {kDQ ? p.q_b : p.k_b, kDQ ? p.q_s : p.k_s, kDQ ? p.q_h : p.k_h},
      {kDQ ? p.o_b : p.v_b, kDQ ? p.o_s : p.v_s, kDQ ? p.o_h : p.v_h},
      {kDQ ? p.k_b : p.q_b, kDQ ? p.k_s : p.q_s, kDQ ? p.k_h : p.q_h},
      {kDQ ? p.v_b : p.o_b, kDQ ? p.v_s : p.o_s, kDQ ? p.v_h : p.o_h}};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i)
    if (!make_map(&maps[i], base[i], dtype, p.d, p.s, b, h, st[i][0], st[i][1], st[i][2], kTile))
      return cudaErrorInvalidValue;
  const int smem = GradTile<D>::kSmemBytes + 1024;
  cudaError_t err = cudaFuncSetAttribute(ring_grads_wgmma<T, D, kDQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int ctas = (p.s + kTile - 1) / kTile * h * b;
  ring_grads_wgmma<T, D, kDQ><<<ctas, kThreads, smem, stream>>>(maps[0], maps[1], maps[2],
                                                                 maps[3], p, b, h);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_wgmma(const GradParams& p, int b, int h, int dtype, cudaStream_t stream) {
  cudaError_t err = launch_wgmma_one<T, D, false>(p, b, h, dtype, stream);
  if (err != cudaSuccess) return err;
  return launch_wgmma_one<T, D, true>(p, b, h, dtype, stream);
}

template <typename T>
cudaError_t launch_wgmma_bucket(const GradParams& p, int b, int h, int dtype,
                                cudaStream_t stream) {
  if (p.d <= 64) return launch_wgmma<T, 64>(p, b, h, dtype, stream);
  return launch_wgmma<T, 128>(p, b, h, dtype, stream);
}

// ---- simt route ------------------------------------------------------------
//
// The same two kernels in f32: one CTA of 8 warps per own 64-row tile, each
// warp 8 of its rows; the streamed tiles are stored transposed ([d][65],
// conflict-free both for the score dot products, lane = streamed row, and
// for the accumulation, lane = column). Scores, P and dS in f32 with expf,
// masked as block_grads masks.

constexpr int kSimtWarps = 8;
constexpr int kSimtThreads = kSimtWarps * 32;
constexpr int kRowsPerWarp = kTile / kSimtWarps;
constexpr int kTStride = kTile + 1;  // padded transposed rows
constexpr int kPStride = kTile + 4;  // float4-aligned rows

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int D>
constexpr size_t simt_smem_floats() {
  return 2 * size_t(kTile) * D + 2 * size_t(D) * kTStride + 2 * size_t(kTile) * kPStride +
         2 * size_t(kTile);
}

template <typename T, int D, bool kDQ>
__global__ void __launch_bounds__(kSimtThreads) ring_grads_simt(GradParams p, int b, int h) {
  constexpr int kCols = D / 32;
  const Work w = work_of<kDQ>(p, b, h);
  if (w.t_begin >= w.t_end) return;

  extern __shared__ __align__(16) float smem[];
  float* A1 = smem;                    // own tile 1, [64][D]
  float* A2 = A1 + kTile * D;          // own tile 2
  float* B1t = A2 + kTile * D;         // streamed tile 1, transposed [D][65]
  float* B2t = B1t + D * kTStride;     // streamed tile 2
  float* Ps = B2t + D * kTStride;      // [64][68]
  float* DSs = Ps + kTile * kPStride;  // [64][68]
  float* sLse = DSs + kTile * kPStride;
  float* sDelta = sLse + kTile;

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

  for (int i = tid; i < kTile * D; i += kSimtThreads) {
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
    for (int i = tid; i < kTile * D; i += kSimtThreads) {
      const int r = i / D, c = i % D, row = t * kTile + r;
      const bool in = row < p.s && c < p.d;
      B1t[c * kTStride + r] = in ? to_f32(b1[row * b1_s + c]) : 0.f;
      B2t[c * kTStride + r] = in ? to_f32(b2[row * b2_s + c]) : 0.f;
    }
    if (!kDQ && tid < kTile) {
      const int row = t * kTile + tid;
      sLse[tid] = row < p.s ? p.lse[row_index(p, h, w.batch, w.head, row)] : 0.f;
      sDelta[tid] = row < p.s ? p.delta[row_index(p, h, w.batch, w.head, row)] : 0.f;
    }
    __syncthreads();

    // X = A1 . B1 (scores), Y = A2 . B2 (dP), rows row0.. of the own tile
    // against streamed rows lane and lane + 32.
    float x[kRowsPerWarp][2], y[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) x[r][0] = x[r][1] = y[r][0] = y[r][1] = 0.f;
    for (int c = 0; c < D; c += 4) {
      float b1a[4], b1b[4], b2a[4], b2b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        b1a[u] = B1t[(c + u) * kTStride + lane];
        b1b[u] = B1t[(c + u) * kTStride + lane + 32];
        b2a[u] = B2t[(c + u) * kTStride + lane];
        b2b[u] = B2t[(c + u) * kTStride + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 u1 = *reinterpret_cast<const float4*>(&A1[(row0 + r) * D + c]);
        const float4 u2 = *reinterpret_cast<const float4*>(&A2[(row0 + r) * D + c]);
        x[r][0] += u1.x * b1a[0] + u1.y * b1a[1] + u1.z * b1a[2] + u1.w * b1a[3];
        x[r][1] += u1.x * b1b[0] + u1.y * b1b[1] + u1.z * b1b[2] + u1.w * b1b[3];
        y[r][0] += u2.x * b2a[0] + u2.y * b2a[1] + u2.z * b2a[2] + u2.w * b2a[3];
        y[r][1] += u2.x * b2b[0] + u2.y * b2b[1] + u2.z * b2b[2] + u2.w * b2b[3];
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int own = w.own0 + row0 + r, other = t * kTile + lane + 32 * j;
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
    for (int jj = 0; jj < kTile; jj += 4) {
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

  float* dst1 = kDQ ? p.dq : p.dk;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = w.own0 + row0 + r;
    if (row >= p.s) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col >= p.d) continue;
      const int64_t at = acc_index(p, h, w.batch, row, w.head, col);
      dst1[at] += acc1[r][c] * p.scale;
      if (!kDQ) p.dv[at] += acc2[r][c];
    }
  }
}

template <typename T, int D, bool kDQ>
cudaError_t launch_simt_one(const GradParams& p, int b, int h, cudaStream_t stream) {
  const size_t smem = simt_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ring_grads_simt<T, D, kDQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int ctas = (p.s + kTile - 1) / kTile * h * b;
  ring_grads_simt<T, D, kDQ><<<ctas, kSimtThreads, smem, stream>>>(p, b, h);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_simt(const GradParams& p, int b, int h, cudaStream_t stream) {
  cudaError_t err = launch_simt_one<T, D, false>(p, b, h, stream);
  if (err != cudaSuccess) return err;
  return launch_simt_one<T, D, true>(p, b, h, stream);
}

template <typename T>
cudaError_t launch_simt_bucket(const GradParams& p, int b, int h, cudaStream_t stream) {
  if (p.d <= 32) return launch_simt<T, 32>(p, b, h, stream);
  if (p.d <= 64) return launch_simt<T, 64>(p, b, h, stream);
  return launch_simt<T, 128>(p, b, h, stream);
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

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (of q, k, v and dout; lse,
// delta and the accumulators are f32). strides: 12 element strides, (b, s,
// h) of q, k, v and dout in that order; lse and delta [b, h, s] and dq,
// dk, dv [b, s, h, d] are contiguous, the accumulators from 16-byte
// aligned bases. q_offset, k_offset: the global positions of the blocks'
// first rows. route: 0 = simt, 1 = wgmma; it must be the one the wgmma
// rule gives over q, k, v and dout. A call that breaks these rules returns
// cudaErrorInvalidValue without launching. Returns the CUDA error code of
// the launches (0 on success); the two kernels run on `stream` and are not
// synchronised.
extern "C" int tpusnap_ring_block_grads(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* delta,
                                        float* dq, float* dk, float* dv, const int64_t* strides,
                                        int b, int s, int h, int d, int64_t q_offset,
                                        int64_t k_offset, float scale, int causal, int dtype,
                                        int route, void* stream) {
  if (d < 1 || d > 128 || s < 1 || b < 1 || h < 1) return int(cudaErrorInvalidValue);
  if (q == nullptr || k == nullptr || v == nullptr || dout == nullptr || lse == nullptr ||
      delta == nullptr || dq == nullptr || dk == nullptr || dv == nullptr)
    return int(cudaErrorInvalidValue);
  const void* accs[3] = {dq, dk, dv};
  for (const void* a : accs)
    if (reinterpret_cast<uintptr_t>(a) % 16 != 0) return int(cudaErrorInvalidValue);
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

  const int64_t o_st[9] = {p.o_b, p.o_s, p.o_h, p.o_b, p.o_s, p.o_h, p.o_b, p.o_s, p.o_h};
  const bool wgmma = tma_describes(q, k, v, strides, b, s, h, d, dtype) &&
                     tma_describes(dout, dout, dout, o_st, b, s, h, d, dtype);
  if (route != int(wgmma)) return int(cudaErrorInvalidValue);
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
