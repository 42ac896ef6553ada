// Pieces shared by the ViT-block kernels (vit_block_fwd.cu, vit_block_bwd.cu):
// row LayerNorm, and the first two stages of the forward (LN1 + qkv,
// attention), which the backward runs again to recompute what the forward
// does not keep. The route is chosen by the compute type:
//   bf16: block_mma.cuh's ln_qkv (mma.sync from registers, a cp.async ring
//         of Wqkv tiles), then attention_mma.cuh's forward with the block's
//         scale folded into its exp2 FMA and the output rounded to bf16;
//   fp32: ln_qkv_kernel below (FMA tiles from shared memory), then the
//         streamed attention stage of attention_common.cuh.
// The fp32 tiles and products are in tile_common.cuh.
//
// Rounding points are those of rovit_kan_tpu/ops/block_kernel.py: fp32
// statistics and accumulation, one rounding to the compute type T where the
// TPU kernel casts. Everything sits in an anonymous namespace, so each source
// that includes this header gets its own copy.

#pragma once

#include "attention_common.cuh"
#include "attention_mma.cuh"
#include "block_mma.cuh"

namespace {

// LayerNorm of `rows` rows of width D, one warp per row, fp32 statistics;
// writes the result rounded to T, and the row's mean and inverse standard
// deviation where mean_out is given. Rows from valid_rows on are written as
// 0.
template <typename S, typename T>
__device__ void layernorm_rows(const S* __restrict__ src, size_t src_ld,
                               int rows, int valid_rows,
                               const float* __restrict__ g,
                               const float* __restrict__ b,
                               T* __restrict__ dst, int dst_ld, int D,
                               float* mean_out = nullptr,
                               float* rstd_out = nullptr) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    T* out = dst + r * dst_ld;
    if (r >= valid_rows) {
      for (int c = lane; c < D; c += 32) out[c] = from_f<T>(0.f);
      if (mean_out != nullptr && lane == 0) {
        mean_out[r] = 0.f;
        rstd_out[r] = 0.f;
      }
      continue;
    }
    const S* in = src + r * src_ld;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += to_f(in[c]);
    const float mean = warp_sum(s) / D;
    float v = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = to_f(in[c]) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / D + kLnEps);
    for (int c = lane; c < D; c += 32) {
      out[c] = from_f<T>((to_f(in[c]) - mean) * rstd * g[c] + b[c]);
    }
    if (mean_out != nullptr && lane == 0) {
      mean_out[r] = mean;
      rstd_out[r] = rstd;
    }
  }
}

// ---- LN1 + qkv, fp32 -------------------------------------------------------

struct LnQkvLayout {
  size_t y, w, c, total;
};
template <typename T>
__host__ __device__ LnQkvLayout ln_qkv_layout(int D) {
  constexpr int R = Tile<T>::kRows;
  LnQkvLayout L;
  L.y = 0;
  L.w = L.y + align128(sizeof(T) * R * ld_of<T>(D));
  L.c = L.w + align128(sizeof(T) * kChunk * ld_of<T>(D));
  L.total = L.c + align128(sizeof(float) * R * (kChunk + 4));
  return L;
}

// A tile of rows: LN1 into shared memory, then the qkv product in 64-column
// steps. Where y_out is given, the rounded LN1 output is stored there too
// (the backward's weight grad of qkv reads it).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const T* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ b, const T* __restrict__ w,
              const float* __restrict__ bias, T* __restrict__ qkv,
              T* __restrict__ y_out, int M, int D) {
  constexpr int R = Tile<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  const LnQkvLayout L = ln_qkv_layout<T>(D);
  T* sY = reinterpret_cast<T*>(smem + L.y);
  T* sW = reinterpret_cast<T*>(smem + L.w);
  float* sC = reinterpret_cast<float*>(smem + L.c);
  const int ld = ld_of<T>(D);
  const int ldc = kChunk + 4;
  const int r0 = blockIdx.x * R;
  const int valid = min(R, M - r0);
  const int n_out = 3 * D;

  layernorm_rows<T, T>(x + static_cast<size_t>(r0) * D, D, R, valid, g, b,
                       sY, ld, D);
  if (y_out != nullptr) {
    __syncthreads();
    for (int i = threadIdx.x; i < valid * D; i += kThreads) {
      const int r = i / D;
      y_out[static_cast<size_t>(r0) * D + i] = sY[r * ld + i - r * D];
    }
  }
  for (int n0 = 0; n0 < n_out; n0 += kChunk) {
    __syncthreads();
    load_tile<T>(sW, ld, w + static_cast<size_t>(n0) * D, D, kChunk, kChunk,
                 D);
    __syncthreads();
    block_gemm<T, true>(sY, ld, sW, ld, sC, ldc, R, kChunk, D, false);
    __syncthreads();
    for (int i = threadIdx.x; i < valid * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int c = i - r * kChunk;
      qkv[static_cast<size_t>(r0 + r) * n_out + n0 + c] =
          from_f<T>(sC[r * ldc + c] + bias[n0 + c]);
    }
  }
}

// ---- attention views over the block's buffers ------------------------------

// Head `which` (0 q, 1 k, 2 v) of a (B, N, 3D) qkv buffer, or of a (B, N, D)
// buffer when which < 0.
template <typename E>
HeadView<E> block_heads(E* base, int N, int D, int hd, int which) {
  const long long width = which < 0 ? D : 3LL * D;
  return {base + (which < 0 ? 0 : which * D), N * width, hd, width};
}

// The first two forward stages, as both the forward and the backward launch
// them: x -> qkv (and the LN1 output where y_out is given) -> attn. A width
// the bf16 route does not take returns cudaErrorInvalidValue, unlaunched.
template <typename T>
cudaError_t launch_qkv_attention(const T* x, const float* ln1g,
                                 const float* ln1b, const T* wqkv,
                                 const float* bqkv, T* qkv, T* attn,
                                 T* y_out, int B, int N, int D, int heads,
                                 cudaStream_t stream) {
  const int M = B * N;
  const int hd = D / heads;
  const float scale =
      static_cast<float>(std::pow(static_cast<double>(hd), -0.5));
  const T* cq = qkv;
  cudaError_t e;
  if constexpr (std::is_same<T, bf16>::value) {
    e = launch_ln_qkv_mma(x, ln1g, ln1b, wqkv, bqkv, qkv, y_out, M, D,
                          stream);
    if (e != cudaSuccess) return e;
    return launch_attention_fwd_mma<bf16, true>(
        block_heads(cq, N, D, hd, 0), block_heads(cq, N, D, hd, 1),
        block_heads(cq, N, D, hd, 2), block_heads(attn, N, D, hd, -1), B,
        heads, N, hd, scale, stream);
  } else {
    constexpr int R = Tile<T>::kRows;
    const size_t sm1 = ln_qkv_layout<T>(D).total;
    if ((e = set_smem(ln_qkv_kernel<T>, sm1)) != cudaSuccess) return e;
    ln_qkv_kernel<T><<<(M + R - 1) / R, kThreads, sm1, stream>>>(
        x, ln1g, ln1b, wqkv, bqkv, qkv, y_out, M, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    return launch_attention_fwd<T, T>(
        block_heads(cq, N, D, hd, 0), block_heads(cq, N, D, hd, 1),
        block_heads(cq, N, D, hd, 2), block_heads(attn, N, D, hd, -1), B,
        heads, N, hd, scale, stream);
  }
}

// Shapes both kernels take: D a multiple of 64, a head width that is a
// multiple of 16 up to 128, hidden a multiple of D (and so of 64).
inline bool block_shape_ok(int B, int N, int D, int heads, int H) {
  return B >= 1 && N >= 1 && heads >= 1 && D % 64 == 0 && D % heads == 0 &&
         attention_head_ok(D / heads) && H % 64 == 0 && H % D == 0;
}

}  // namespace
