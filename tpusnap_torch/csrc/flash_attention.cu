// Flash attention forward for Hopper (sm_90a): the SIMT kernel and the C
// entry point that picks a route, plain C interface.
//
// Replaces tpusnap/ops/flash_attention.py::_flash_fwd_kernel (the Pallas TPU
// kernel launched by _flash_forward). Two kernels compute what
// _flash_forward returns — softmax(Q K^T * d^-1/2) V per (batch, head),
// causal or not, with an online softmax in f32:
//
// * the wgmma route (flash_attention_wgmma.cu): bf16/f16 inputs that a TMA
//   tensor map can describe (wgmma_route in flash_attention.cuh), products
//   on the tensor cores;
// * the simt route (this file): f32 inputs, which have no tensor-core type
//   that keeps the f32 tolerance, and 16-bit layouts TMA cannot describe.
//
// The entry point takes the route the caller chose and refuses it
// (cudaErrorInvalidValue) unless wgmma_route agrees: a dispatch, not a knob.
//
// The SIMT kernel:
//
// * One CUDA block per (64-row q tile, head, batch). Blocks run in parallel
//   in no order, so the TPU grid's sequential k axis becomes a loop inside
//   the block; the running max m, sum l and accumulator acc live in
//   registers for the whole loop.
// * Q, K and V are read directly in the [b, s, h, d] layout through their
//   strides (d must be contiguous): no transpose, no padding of d to 128 or
//   of s to a block multiple. Rows and columns past s and d are masked here.
// * The causal loop stops at the diagonal tile; the diagonal tile is masked
//   elementwise. A fully masked row gives 0, as on the TPU.
// * bf16, f16 and f32 inputs; products and the softmax in f32; output in the
//   input dtype. head_dim <= 256, bucketed to 32/64/128/256 at compile time.
//
// Its products are f32 FMAs from shared memory, on the CUDA cores: at the
// flagship shape (b=8, s=1024, h=8, d=64, causal) the 8.6 GFLOP alone need
// 0.128 ms at the 67 TFLOP/s f32 peak, so bf16/f16 inputs take the wgmma
// route. Tiles are staged in shared memory as f32: Q row-major (float4
// broadcast reads), K transposed with a padded stride (conflict-free column
// reads), V row-major, and P (the softmax numerators) per warp.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

using tpusnap_flash::Params;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 8
constexpr int kKtStride = kBlockK + 1;           // padded: conflict-free
constexpr int kPStride = kBlockK + 4;            // float4-aligned rows
constexpr float kNegInf = -1e30f;                // the TPU kernel's mask value

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
constexpr size_t smem_floats() {
  return size_t(kBlockQ) * D + size_t(D) * kKtStride + size_t(kBlockK) * D +
         size_t(kBlockQ) * kPStride;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int kCols = D / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [kBlockQ][D]
  float* Kt = Qs + kBlockQ * D;          // [D][kKtStride]
  float* Vs = Kt + D * kKtStride;        // [kBlockK][D]
  float* Ps = Vs + kBlockK * D;          // [kBlockQ][kPStride]

  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * kRowsPerWarp;  // this warp's first row in the tile

  const T* q = static_cast<const T*>(p.q) + batch * p.q_b + head * p.q_h;
  const T* k = static_cast<const T*>(p.k) + batch * p.k_b + head * p.k_h;
  const T* v = static_cast<const T*>(p.v) + batch * p.v_b + head * p.v_h;
  T* o = static_cast<T*>(p.o) + batch * p.o_b + head * p.o_h;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D, qi = q0 + r;
    Qs[i] = (qi < p.s && c < p.d) ? to_f32(q[qi * p.q_s + c]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int k_end = p.causal ? min(p.s, q0 + kBlockQ) : p.s;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's Kt/Vs reads are done
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D, ki = k0 + r;
      const bool in = ki < p.s && c < p.d;
      Kt[c * kKtStride + r] = in ? to_f32(k[ki * p.k_s + c]) : 0.f;
      Vs[i] = in ? to_f32(v[ki * p.v_s + c]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this warp's 8 rows; lane owns key columns lane, lane+32.
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

    // Mask, online softmax, P to shared memory, rescale acc.
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = q0 + row0 + r;
      float sv[2];
      bool valid[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ki = k0 + lane + 32 * j;
        valid[j] = ki < p.s && (!p.causal || ki <= qi);
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

    // acc += P V; lane owns output columns lane + 32*c.
    for (int j = 0; j < kBlockK; j += 4) {
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
    __syncwarp();  // Ps rows are rewritten by this warp next tile
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= p.s) continue;
    // m and l are the warp's: m is in the scaled scores' units.
    if (p.lse != nullptr && lane == 0)
      p.lse[(int64_t(batch) * gridDim.y + head) * p.s + qi] = m[r] + logf(l[r]);
    const float denom = l[r] == 0.f ? 1.f : l[r];  // fully masked row -> 0
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < p.d) o[qi * p.o_s + col] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int b, int h, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + kBlockQ - 1) / kBlockQ, h, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bucket(const Params& p, int b, int h, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 32>(p, b, h, stream);
  if (p.d <= 64) return launch<T, 64>(p, b, h, stream);
  if (p.d <= 128) return launch<T, 128>(p, b, h, stream);
  return launch<T, 256>(p, b, h, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. strides: 12 element
// strides, (b, s, h) of q, k, v and o in that order. lse: nullptr, or
// [b, h, s] f32 contiguous for the rows' log-sum-exp (the output is the
// same bit for bit either way). route: 0 = simt,
// 1 = wgmma; it must be the one wgmma_route gives, or the call returns
// cudaErrorInvalidValue without launching. Returns the CUDA error code of
// the launch (0 on success); the kernel runs on `stream` and is not
// synchronised.
extern "C" int tpusnap_flash_attention_fwd(const void* q, const void* k, const void* v,
                                           void* o, float* lse, const int64_t* strides, int b,
                                           int s, int h, int d, float scale, int causal,
                                           int dtype, int route, void* stream) {
  if (d < 1 || d > 256 || s < 1 || b < 1 || h < 1) return int(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
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
  p.scale = scale;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route != int(tpusnap_flash::wgmma_route(p, b, h, dtype))) return int(cudaErrorInvalidValue);
  if (route == 1) return int(tpusnap_flash::launch_wgmma(p, b, h, dtype, st));
  cudaError_t err;
  switch (dtype) {
    case tpusnap_flash::kFloat32: err = launch_bucket<float>(p, b, h, st); break;
    case tpusnap_flash::kFloat16: err = launch_bucket<__half>(p, b, h, st); break;
    case tpusnap_flash::kBFloat16: err = launch_bucket<__nv_bfloat16>(p, b, h, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return int(err);
}
