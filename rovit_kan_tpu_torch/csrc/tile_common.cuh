// Shared-memory tiles for the ViT-block and attention kernels
// (vit_block_common.cuh, attention_common.cuh): the compute types, strides
// and alignment, conversions, warp reductions, the block-wide product and
// the tile copy. Everything sits in an anonymous namespace, so each source
// that includes this header gets its own copy.

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
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;          // output columns per product step

// Rows per CTA of the fp32 row-tiled forward kernels and queries per
// streamed forward attention CTA: the fp32 block forward's route. The other
// stages tile themselves (block_mma.cuh, block_bwd_mma.cuh,
// attention_mma.cuh, attention_tf32.cuh, the fp32 backward's fma files).
template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int kRows = 32; };

// Shared-memory row stride: the width plus 16 bytes, which keeps rows
// 16-byte aligned (vector copies) and staggers banks.
template <typename T>
__host__ __device__ constexpr int ld_of(int width) {
  return width + 16 / static_cast<int>(sizeof(T));
}
__host__ __device__ constexpr size_t align128(size_t bytes) {
  return (bytes + 127) & ~static_cast<size_t>(127);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);        // round to nearest even, as torch does
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// C[M x N] (+)= A[M x K] . B, all in shared memory, fp32 FMA (the fp32
// block forward's route; the other stages run mma.sync or fma_common.cuh).
// A is row-major [m][k] (lda). B_NK: B is stored [n][k] (a Linear weight,
// or the K of attention), else [k][n] (the V of attention). M and N are
// multiples of 4. A thread owns rows 4*tm..4*tm+3 and columns
// tn + j*N/4, so the threads of a warp read neighbouring B rows and write
// neighbouring C columns, and an accumulating call reads only what its
// owner wrote.
template <typename T, bool B_NK>
__device__ void block_gemm(const T* __restrict__ A, int lda,
                           const T* __restrict__ Bm, int ldb,
                           float* __restrict__ C, int ldc,
                           int M, int N, int K, bool accumulate) {
  static_assert(std::is_same<T, float>::value, "fp32 only");
  const int qn = N >> 2;
  const int tiles = (M >> 2) * qn;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int tm = t / qn;
    const int tn = t - tm * qn;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = accumulate ? C[(4 * tm + i) * ldc + tn + j * qn] : 0.f;
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = A[(4 * tm + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = B_NK ? Bm[(tn + j * qn) * ldb + k]
                    : Bm[k * ldb + tn + j * qn];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        C[(4 * tm + i) * ldc + tn + j * qn] = acc[i][j];
  }
}

// Copies rows x cols of T from global memory (row stride gstride) into
// shared memory (row stride ld) with 16-byte vectors; rows from valid_rows
// on are zero-filled. cols * sizeof(T) is a multiple of 16.
template <typename T>
__device__ void load_tile(T* __restrict__ dst, int ld,
                          const T* __restrict__ src, size_t gstride,
                          int rows, int valid_rows, int cols) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = cols / kVec;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i - r * vpr) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows) {
      v = *reinterpret_cast<const uint4*>(src + r * gstride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
