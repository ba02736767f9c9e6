// Host-side TMA descriptors for the wgmma kernels (flash_attention_wgmma.cu,
// ring_block_wgmma.cu, ring_block_bwd_wgmma.cu): libcuda's
// cuTensorMapEncodeTiled looked up at run time, the one tensor-map layout
// the kernels load q, k and v through, and the f32 one of the ring's carry
// and the backward's accumulators.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace tpusnap_tma {

// cuTensorMapEncodeTiled, looked up at run time so that the library needs
// no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A 4-D tensor map over one of q, k, v [b, s, h, d] (bf16 or f16) as
// (d, h, s, b) with its element strides st_b, st_s, st_h; each box is 64
// columns of d by `rows` rows of s, swizzled by 128 bytes. A stride of a
// dim of size 1 is never followed: it is replaced by the row's bytes,
// which TMA accepts.
inline bool make_map(CUtensorMap* map, const void* base, int dtype, int d, int s, int b, int h,
                     int64_t st_b, int64_t st_s, int64_t st_h, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row_bytes = cuuint64_t(d) * 2;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(h), cuuint64_t(s), cuuint64_t(b)};
  const cuuint64_t strides[3] = {h > 1 ? cuuint64_t(st_h) * 2 : row_bytes,
                                 s > 1 ? cuuint64_t(st_s) * 2 : row_bytes,
                                 b > 1 ? cuuint64_t(st_b) * 2 : row_bytes};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, dtype == tpusnap_flash::kBFloat16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                             : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(base), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS;
}

// A 4-D tensor map over an f32 [b, s, h, d] tensor (contiguous; the ring
// forward's carry o, the backward's accumulators) as (d, h, s, b): boxes of
// 32 columns (128 bytes) by 64 rows, swizzled by 128 bytes. d is a multiple
// of 8 on the wgmma routes, so every stride is a multiple of 16 bytes.
inline bool make_f32_map(CUtensorMap* map, float* base, int d, int s, int b, int h) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(h), cuuint64_t(s), cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(d) * 4, cuuint64_t(h) * d * 4,
                                 cuuint64_t(s) * h * d * 4};
  const cuuint32_t box[4] = {32, 1, 64, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tpusnap_tma
