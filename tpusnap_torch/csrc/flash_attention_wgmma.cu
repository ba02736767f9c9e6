// Flash attention forward on Hopper's tensor cores (sm_90a): the wgmma
// route of tpusnap_flash_attention_fwd (flash_attention.cu).
//
// Replaces tpusnap/ops/flash_attention.py::_flash_fwd_kernel (the Pallas
// TPU kernel launched by _flash_forward) for bf16/f16 inputs:
// softmax(Q K^T * d^-1/2) V per (batch, head), causal or not, an online
// softmax in f32, keys past s masked (-inf here where the TPU kernel has
// -1e30: only a masked key's zero weight matters), a fully masked row
// giving 0, the output cast to the input dtype.
//
// What bounds it on this card: at the flagship shape (b=8, s=1024, h=8,
// d=64, bf16, causal) the least time is the 33.5 MB of q, k, v and o over
// HBM (10.0 us at 3.35 TB/s), just above the 8.6 GFLOP of the causal pairs
// over the bf16 tensor cores (8.7 us at 989 TFLOP/s). Beside those, every
// score costs one exp2 on the special-function unit (16 a clock per SM, so
// 67 M scores take about as long as their products at d=64) and a handful
// of f32 ALU operations. The design keeps the tensor cores, the exp2 unit
// and the copy engine busy at the same time:
//
// * Persistent blocks, one per SM: 2 consumer warpgroups of 64 query rows
//   each (wgmma's M) and 1 producer warpgroup (setmaxnreg moves its
//   registers to the consumers). Block i takes work items i, i + grid, ...,
//   an item being one (128-row q tile, head, batch), numbered longest
//   causal tile first so that the longest items do not form the tail.
// * The producer's one thread loads Q, then K and V tiles of kBlockK keys
//   into a ring of kStages slots with TMA (cp.async.bulk.tensor over a 4-D
//   (d, h, s, b) tensor map with the inputs' byte strides, so the head-split
//   views of the fused qkv product are read in place). TMA writes the
//   128-byte swizzle the wgmma descriptors read and fills the ragged s and d
//   edges with zeros; d is padded to D = 64, 128 or 256. mbarriers signal a
//   full slot to the consumers and an empty one back to the producer.
// * S = Q K^T: wgmma m64nKk16 with Q and K both K-major (d contiguous) in
//   shared memory. O += P V: wgmma m64nDk16 with A from registers: the f32
//   S accumulator after the softmax, rounded to bf16/f16 in place, is
//   already the A fragment; V is read MN-major through the descriptor's
//   transpose bit. O, m and l stay in registers.
// * Overlap: tile t's Q K^T is issued with tile t-1's P V behind it, and
//   tile t's softmax runs while that P V is on the tensor cores; the two
//   warpgroups take turns to issue (named barriers), so one's softmax runs
//   while the other's products hold the tensor cores.
// * Causal: the k loop stops at the diagonal tile and only tiles that cross
//   the diagonal or the end of s are masked elementwise.
// * Deterministic: one warpgroup owns each output row and sums in a fixed
//   order; no atomics, no split of the keys across blocks.

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
using tpusnap_flash::Params;

constexpr int kBlockQ = 128;                 // two warpgroups of 64 rows
constexpr int kConsumerWarps = 8;
constexpr int kThreads = kConsumerWarps * 32 + 128;  // + one producer warpgroup
// Registers after setmaxnreg: the producer warpgroup gives most of its
// share to the consumers (128 * 40 + 256 * 232 <= 65536).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kRowBytes = 128;               // one 64-column swizzle atom row
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int kBlockK = D <= 128 ? 128 : 64;
  static constexpr int kStages = D <= 128 ? 3 : 2;  // K/V ring depth (227 KB at D=128)
  static constexpr int kChunks = D / 64;  // 128-byte column chunks along d
  static constexpr int kQBytes = kBlockQ * D * 2;
  static constexpr int kKVBytes = kBlockK * D * 2;
  static constexpr int kTileBytes = kQBytes + 2 * kStages * kKVBytes;
  // Tiles, then the barriers: Q full, Q empty, K full[stages], V
  // full[stages], K/V empty[stages].
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
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, Params p, int b, int h) {
  using Cfg = Tile<D>;
  constexpr int kBlockK = Cfg::kBlockK;
  constexpr int kStages = Cfg::kStages;
  constexpr int kSRegs = kBlockK / 2;  // S accumulator floats per thread
  constexpr int kORegs = D / 2;        // O accumulator floats per thread
  constexpr int kPSteps = kBlockK / 16;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;  // [chunk][kBlockQ rows][128 B], swizzled
  uint8_t* sK = sQ + Cfg::kQBytes;  // [stage][chunk][kBlockK rows][128 B]
  uint8_t* sV = sK + kStages * Cfg::kKVBytes;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + Cfg::kTileBytes);
  uint64_t* q_empty = bar_q + 1;
  uint64_t* full_k = q_empty + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  // Persistent: an item is one (128-row q tile, head, batch), numbered
  // longest causal tile first. Round r of the blocks takes items
  // r * gridDim.x .. + gridDim.x - 1, in block order on even rounds and in
  // reverse on odd ones, so that the short ends of the list even out the
  // long ones (at the flagship shape 18 tiles for the busiest block
  // against 20 in plain round robin; 17.5 on average).
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
    const int k_end = p.causal ? min(p.s, w.q_block0 + kBlockQ) : p.s;
    w.n_tiles = (k_end + kBlockK - 1) / kBlockK;
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
    // Producer: one thread keeps the K/V ring full with TMA loads. The
    // 128-byte swizzle is the tensor maps'; ragged s and d edges arrive as
    // zeros.
    setmaxnreg_dec<kProducerRegs>();
    if (warp_id == kConsumerWarps && lane == 0) {
      int kv = 0;  // K/V tiles loaded so far: ring slot kv % kStages
      for (int rd = 0, it = 0; rd < rounds; ++rd) {
        if (item_of_round(rd) >= n_items) continue;
        const Item w = item(item_of_round(rd));
        if (it > 0) mbar_wait(q_empty, (it - 1) & 1);  // consumers are done with Q
        mbar_expect_tx(bar_q, Cfg::kQBytes);
        for (int c = 0; c < Cfg::kChunks; ++c)
          tma_load_4d(sQ + c * kBlockQ * kRowBytes, &tm_q, bar_q, c * 64, w.head, w.q_block0,
                      w.batch);
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
    // Consumers: warpgroup wg owns q rows q_first .. q_first + 63 of each
    // item.
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    const int warp = warp_id % 4;
    const int col_lane = 2 * (lane % 4);  // this thread's first column in each 8
    const float scale_log2 = p.scale * kLog2e;
    const uint32_t q_addr = smem_addr(sQ) + wg * 64 * kRowBytes;

    float acc_s[kSRegs];  // S of tile t, then its P in f32
    float acc_o[kORegs];
    uint32_t a_p[kPSteps][4];  // P of tile t in the input type: the A of P V
    float m_run[2], l_run[2];  // running row max; this thread's partial row sums
    int kv0 = 0;               // K/V tiles of earlier items: tile t is ring slot kv0 + t
    int q_first = 0, row_a = 0, row_b = 0;

    // S = Q K^T for tile t over D/16 steps of 16 along d (issued, not awaited).
    auto issue_qk = [&](int t) {
      const int slot = (kv0 + t) % kStages;
      const uint32_t k_addr = smem_addr(sK + slot * Cfg::kKVBytes);
      mbar_wait(&full_k[slot], ((kv0 + t) / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into the chunk
        const uint64_t da = smem_desc(q_addr + (kk / 4) * kBlockQ * kRowBytes + off, 16, 1024);
        const uint64_t db = smem_desc(k_addr + (kk / 4) * kBlockK * kRowBytes + off, 16, 1024);
        Mma<T>::ss(acc_s, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V for tile t over kBlockK/16 steps of 16 keys (issued, not
    // awaited); V MN-major: 8-key groups 1024 bytes apart, 64-column
    // chunks kBlockK rows apart.
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
    // The two warpgroups take turns to issue their products (named barrier
    // 1 + wg is this warpgroup's turn), so one's softmax runs while the
    // other's products hold the tensor cores.
    auto turn_begin = [&]() { named_barrier_sync(1 + wg, kConsumerWarps * 32); };
    auto turn_end = [&]() { named_barrier_arrive(2 - wg, kConsumerWarps * 32); };
    auto release = [&](uint64_t* bar) {  // this warp is done with what `bar` guards
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // Mask, online softmax over S of tile t: P in f32 in acc_s, and the
    // factor alpha that rescales what O holds so far.
    auto softmax = [&](int t, float (&alpha)[2]) {
      const int k0 = t * kBlockK;
      if (k0 + kBlockK > p.s || (p.causal && k0 + kBlockK - 1 > q_first)) {
#pragma unroll
        for (int i = 0; i < kSRegs; ++i) {
          const int col = k0 + (i / 4) * 8 + col_lane + (i % 2);
          const int row = (i / 2) % 2 ? row_b : row_a;
          if (col >= p.s || (p.causal && col > row)) acc_s[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};  // row max over the 4 threads of a row
#pragma unroll
      for (int i = 0; i < kSRegs; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], acc_s[i]);
      float m_scaled[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // nothing seen yet
        alpha[r] = exp2_approx((m_run[r] - m_use) * scale_log2);
        m_scaled[r] = m_use * scale_log2;
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < kSRegs; ++i) {
        const int r = (i / 2) % 2;
        acc_s[i] = exp2_approx(fmaf(acc_s[i], scale_log2, -m_scaled[r]));  // masked: 0
        l_run[r] += acc_s[i];
      }
    };
    // P in the input type: registers 8j..8j+7 of S are the A fragment of
    // the j-th 16-key step of P V.
    auto round_p = [&]() {
#pragma unroll
      for (int j = 0; j < kPSteps; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          a_p[j][u] = pack2<T>(acc_s[8 * j + 2 * u], acc_s[8 * j + 2 * u + 1]);
    };

    if (wg == 1) turn_end();  // warpgroup 0 goes first
    for (int rd = 0, it = 0; rd < rounds; ++rd) {
      if (item_of_round(rd) >= n_items) continue;
      const Item w = item(item_of_round(rd));
      q_first = w.q_block0 + wg * 64;
      row_a = q_first + warp * 16 + lane / 4;  // rows this thread holds
      row_b = row_a + 8;
      // Causal: the tiles past this warpgroup's last row hold only masked keys.
      const int n_own = p.causal ? min(w.n_tiles, (q_first + 63) / kBlockK + 1) : w.n_tiles;
#pragma unroll
      for (int j = 0; j < kORegs; ++j) acc_o[j] = 0.f;
      m_run[0] = m_run[1] = -INFINITY;
      l_run[0] = l_run[1] = 0.f;

      mbar_wait(bar_q, it & 1);
      float alpha[2];
      turn_begin();
      issue_qk(0);
      turn_end();
      wgmma_wait<0>();
      fence_regs(acc_s);
      softmax(0, alpha);  // O is still 0: no rescale
      round_p();
      // Tile t's Q K^T runs on the tensor cores while tile t-1's P V is
      // issued behind it; the softmax of tile t overlaps that P V.
      for (int t = 1; t < n_own; ++t) {
        turn_begin();
        issue_qk(t);
        issue_pv(t - 1);
        turn_end();
        wgmma_wait<1>();  // Q K^T of tile t is done
        fence_regs(acc_s);
        softmax(t, alpha);
        wgmma_wait<0>();  // P V of tile t-1 is done
        fence_regs(acc_o);
#pragma unroll
        for (int j = 0; j < kPSteps; ++j) fence_regs(a_p[j]);
        release(&empty[(kv0 + t - 1) % kStages]);
#pragma unroll
        for (int j = 0; j < kORegs; ++j) acc_o[j] *= alpha[(j / 2) % 2];
        round_p();
      }
      release(q_empty);  // every Q K^T of the item is done: the next Q may land
      turn_begin();
      issue_pv(n_own - 1);
      turn_end();
      wgmma_wait<0>();
      fence_regs(acc_o);
      release(&empty[(kv0 + n_own - 1) % kStages]);
      for (int t = n_own; t < w.n_tiles; ++t) {
        // Masked for every row here, but released in order: the slot's
        // earlier tile must not lose this warpgroup's arrival to this one.
        // An empty turn keeps both warpgroups at n_tiles + 1 turns an item.
        turn_begin();
        turn_end();
        const int slot = (kv0 + t) % kStages;
        mbar_wait(&full_k[slot], ((kv0 + t) / kStages) & 1);
        mbar_wait(&full_v[slot], ((kv0 + t) / kStages) & 1);
        release(&empty[slot]);
      }
      kv0 += w.n_tiles;

      // Epilogue: full row sums, acc / l, pairs of columns as one 4-byte store.
      T* o = static_cast<T*>(p.o) + w.batch * p.o_b + w.head * p.o_h;
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = l == 0.f ? 1.f : 1.f / l;  // fully masked row -> 0
        // The row's log-sum-exp in natural-log units: m_run is the raw
        // scores' max and l sums exp2((S - m) * scale * log2 e).
        const int row = r ? row_b : row_a;
        if (p.lse != nullptr && lane % 4 == 0 && row < p.s)
          p.lse[(int64_t(w.batch) * h + w.head) * p.s + row] = m_run[r] * p.scale + logf(l);
      }
#pragma unroll
      for (int j = 0; j < kORegs; j += 2) {
        const int r = (j / 2) % 2;
        const int row = r ? row_b : row_a;
        const int col = (j / 4) * 8 + col_lane;
        if (row < p.s && col < p.d)
          *reinterpret_cast<uint32_t*>(o + row * p.o_s + col) =
              pack2<T>(acc_o[j] * inv[r], acc_o[j + 1] * inv[r]);
      }
      ++it;
    }
    if (wg == 0) turn_begin();  // takes warpgroup 1's last turn_end
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int b, int h, int dtype, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, p.q, dtype, p.d, p.s, b, h, p.q_b, p.q_s, p.q_h, kBlockQ) ||
      !make_map(&tm_k, p.k, dtype, p.d, p.s, b, h, p.k_b, p.k_s, p.k_h, Tile<D>::kBlockK) ||
      !make_map(&tm_v, p.v, dtype, p.d, p.s, b, h, p.v_b, p.v_s, p.v_h, Tile<D>::kBlockK))
    return cudaErrorInvalidValue;
  const int smem = Tile<D>::kSmemBytes + 1024;  // + room to align to 1024
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int items = (p.s + kBlockQ - 1) / kBlockQ * h * b;
  flash_fwd_wgmma<T, D><<<min(items, sms), kThreads, smem, stream>>>(tm_q, tm_k, tm_v, p, b, h);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bucket(const Params& p, int b, int h, int dtype, cudaStream_t stream) {
  if (p.d <= 64) return launch<T, 64>(p, b, h, dtype, stream);
  if (p.d <= 128) return launch<T, 128>(p, b, h, dtype, stream);
  return launch<T, 256>(p, b, h, dtype, stream);
}

}  // namespace

namespace tpusnap_flash {

cudaError_t launch_wgmma(const Params& p, int b, int h, int dtype, cudaStream_t stream) {
  if (dtype == kBFloat16) return launch_bucket<__nv_bfloat16>(p, b, h, dtype, stream);
  if (dtype == kFloat16) return launch_bucket<__half>(p, b, h, dtype, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tpusnap_flash
