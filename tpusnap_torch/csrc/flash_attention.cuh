// What the two flash attention forward kernels share: their parameters,
// the rule that picks the tensor-core route, and its launcher.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpusnap_flash {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // The rows' log-sum-exp, [b, h, s] f32 contiguous: the natural log of the
  // row's sum of exp over the scaled scores (what the backward takes);
  // nullptr writes none.
  float* lse;
  // Element strides of the b, s and h dims (d is contiguous).
  int64_t q_b, q_s, q_h;
  int64_t k_b, k_s, k_h;
  int64_t v_b, v_s, v_h;
  int64_t o_b, o_s, o_h;
  int s, d;
  float scale;
  int causal;
};

// dtype codes of the C entry point.
constexpr int kFloat32 = 0;
constexpr int kFloat16 = 1;
constexpr int kBFloat16 = 2;

// The wgmma route takes bf16/f16 inputs whose rows, and every b/s/h
// stride of q, k and v, are whole positive multiples of 16 bytes from 16-byte
// aligned bases: what a TMA tensor map can describe. The strides of dims
// of size 1 are never used and do not count. Mirrors `_route` in
// tpusnap_torch/ops/flash_attention.py.
inline bool wgmma_route(const Params& p, int b, int h, int dtype) {
  if (dtype != kFloat16 && dtype != kBFloat16) return false;
  if ((p.d * 2) % 16 != 0) return false;
  const int64_t strides[9] = {p.q_b, p.q_s, p.q_h, p.k_b, p.k_s, p.k_h, p.v_b, p.v_s, p.v_h};
  const int sizes[3] = {b, p.s, h};
  for (int i = 0; i < 9; ++i)
    if (sizes[i % 3] > 1 && (strides[i] <= 0 || (strides[i] * 2) % 16 != 0)) return false;
  const void* bases[3] = {p.q, p.k, p.v};
  for (int i = 0; i < 3; ++i)
    if (reinterpret_cast<uintptr_t>(bases[i]) % 16 != 0) return false;
  return true;
}

// Launches the tensor-core kernel (flash_attention_wgmma.cu); the caller
// has checked wgmma_route. Returns the launch's CUDA error.
cudaError_t launch_wgmma(const Params& p, int b, int h, int dtype, cudaStream_t stream);

}  // namespace tpusnap_flash
