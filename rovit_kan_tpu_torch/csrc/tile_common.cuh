// Basic pieces of every CUDA source of the ViT-block and attention kernels:
// the includes, the bf16 type, the block size and warp sum of the
// backwards' reduce kernel (block_bwd_common.cuh), and the shared-memory
// opt-in every launch takes. The tiled stages live in mma_common.cuh
// (bf16 mma.sync), tf32_common.cuh (3xTF32 mma.sync) and fma_common.cuh
// (the fp32 backward's FMA tiles). Everything sits in an anonymous
// namespace, so each source that includes this header gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
