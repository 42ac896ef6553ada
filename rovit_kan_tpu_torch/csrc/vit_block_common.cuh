// Pieces shared by the ViT-block kernels (vit_block_fwd.cu, vit_block_bwd.cu):
// shared-memory products and copies, row LayerNorm, GELU, and the first two
// stages of the forward (LN1 + qkv, attention), which the backward runs again
// to recompute what the forward does not keep.
//
// Rounding points are those of rovit_kan_tpu/ops/block_kernel.py: fp32
// statistics and accumulation, one rounding to the compute type T where the
// TPU kernel casts. Everything sits in an anonymous namespace, so each source
// that includes this header gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
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
constexpr float kLnEps = 1e-6f;

// Rows per CTA of the row-tiled forward kernels and queries per attention
// CTA.
template <typename T> struct Tile;
template <> struct Tile<bf16> { static constexpr int kRows = 64; };
template <> struct Tile<float> { static constexpr int kRows = 32; };

// Shared-memory row stride: the width plus 16 bytes, which keeps rows
// 16-byte aligned (vector copies, WMMA) and staggers banks.
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

// C[M x N] (+)= A[M x K] . B, all in shared memory, fp32 result.
// A is row-major [m][k] (lda), or stored [k][m] when A_KM (a transposed
// operand, as in the backward's dS^T . Q). B_NK: B is stored [n][k] (a Linear
// weight, or the K of attention), else [k][n] (the V of attention). M, N, K
// are multiples of 16; every pointer is 32-byte aligned and every stride a
// multiple of 16 bytes. Each output tile always goes to the same warp (bf16)
// or thread (fp32), so an accumulating call reads only what its owner wrote.
template <typename T, bool B_NK, bool A_KM = false>
__device__ void block_gemm(const T* __restrict__ A, int lda,
                           const T* __restrict__ Bm, int ldb,
                           float* __restrict__ C, int ldc,
                           int M, int N, int K, bool accumulate) {
  if constexpr (std::is_same<T, bf16>::value) {
    namespace wmma = nvcuda::wmma;
    using ALayout = typename std::conditional<A_KM, wmma::col_major,
                                              wmma::row_major>::type;
    using BLayout = typename std::conditional<B_NK, wmma::col_major,
                                              wmma::row_major>::type;
    const int warp = threadIdx.x >> 5;
    const int tiles_n = N >> 4;
    const int tiles = (M >> 4) * tiles_n;
    for (int t = warp; t < tiles; t += kWarps) {
      const int tm = t / tiles_n;
      const int tn = t - tm * tiles_n;
      float* c = C + (tm * 16) * ldc + tn * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if (accumulate) {
        wmma::load_matrix_sync(acc, c, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(acc, 0.0f);
      }
      for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa;
        wmma::load_matrix_sync(fa, A_KM ? A + k * lda + tm * 16
                                        : A + (tm * 16) * lda + k, lda);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb;
        wmma::load_matrix_sync(fb, B_NK ? Bm + (tn * 16) * ldb + k
                                        : Bm + k * ldb + tn * 16, ldb);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
    }
  } else {
    // fp32: a thread owns rows 4*tm..4*tm+3 and columns tn + j*N/4, so the
    // threads of a warp read neighbouring B rows and write neighbouring C
    // columns.
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
          a[i] = A_KM ? A[k * lda + 4 * tm + i] : A[(4 * tm + i) * lda + k];
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

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// ---- LN1 + qkv -------------------------------------------------------------

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

// ---- attention per (query tile, head, image) -------------------------------

struct AttnLayout {
  size_t q, k, v, s, p, total;
  int np, ldh, lds, ldp, ldo;
};
template <typename T>
__host__ __device__ AttnLayout attn_layout(int N, int hd) {
  constexpr int QR = Tile<T>::kRows;
  AttnLayout L;
  L.np = (N + 15) & ~15;
  L.ldh = ld_of<T>(hd);
  L.lds = L.np + 4;
  L.ldp = ld_of<T>(L.np);
  L.ldo = hd + 4;
  const int s_cols = L.lds > L.ldo ? L.lds : L.ldo;   // S, then O
  L.q = 0;
  L.k = L.q + align128(sizeof(T) * QR * L.ldh);
  L.v = L.k + align128(sizeof(T) * L.np * L.ldh);
  L.s = L.v + align128(sizeof(T) * L.np * L.ldh);
  L.p = L.s + align128(sizeof(float) * QR * s_cols);
  L.total = L.p + align128(sizeof(T) * QR * L.ldp);
  return L;
}

// q, the image's whole K and V and the score tile sit in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ qkv, T* __restrict__ attn, int N,
                 int D, int heads, float scale) {
  constexpr int QR = Tile<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  const int hd = D / heads;
  const AttnLayout L = attn_layout<T>(N, hd);
  T* sQ = reinterpret_cast<T*>(smem + L.q);
  T* sK = reinterpret_cast<T*>(smem + L.k);
  T* sV = reinterpret_cast<T*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  T* sP = reinterpret_cast<T*>(smem + L.p);

  const int q0 = blockIdx.x * QR;
  const int h = blockIdx.y;
  const int img = blockIdx.z;
  const size_t row3 = 3 * static_cast<size_t>(D);
  const T* base = qkv + static_cast<size_t>(img) * N * row3;
  const int qvalid = min(QR, N - q0);

  load_tile<T>(sQ, L.ldh, base + q0 * row3 + h * hd, row3, QR, qvalid, hd);
  load_tile<T>(sK, L.ldh, base + D + h * hd, row3, L.np, N, hd);
  load_tile<T>(sV, L.ldh, base + 2 * D + h * hd, row3, L.np, N, hd);
  __syncthreads();
  block_gemm<T, true>(sQ, L.ldh, sK, L.ldh, sS, L.lds, QR, L.np, hd, false);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < QR; r += kWarps) {
    float* s = sS + r * L.lds;
    float m = -FLT_MAX;
    for (int c = lane; c < N; c += 32) m = fmaxf(m, s[c] * scale);
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float e = expf(s[c] * scale - m);
      s[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    T* p = sP + r * L.ldp;
    for (int c = lane; c < L.np; c += 32) {
      p[c] = from_f<T>(c < N ? s[c] / sum : 0.f);
    }
  }
  __syncthreads();
  block_gemm<T, false>(sP, L.ldp, sV, L.ldh, sS, L.ldo, QR, hd, L.np, false);
  __syncthreads();
  for (int i = threadIdx.x; i < qvalid * hd; i += kThreads) {
    const int r = i / hd;
    const int c = i - r * hd;
    attn[(static_cast<size_t>(img) * N + q0 + r) * D + h * hd + c] =
        from_f<T>(sS[r * L.ldo + c]);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The first two forward stages, as both the forward and the backward launch
// them: x -> qkv (and the LN1 output where y_out is given) -> attn.
template <typename T>
cudaError_t launch_qkv_attention(const T* x, const float* ln1g,
                                 const float* ln1b, const T* wqkv,
                                 const float* bqkv, T* qkv, T* attn,
                                 T* y_out, int B, int N, int D, int heads,
                                 cudaStream_t stream) {
  constexpr int R = Tile<T>::kRows;
  const int M = B * N;
  const int hd = D / heads;
  cudaError_t e;
  const size_t sm1 = ln_qkv_layout<T>(D).total;
  if ((e = set_smem(ln_qkv_kernel<T>, sm1)) != cudaSuccess) return e;
  ln_qkv_kernel<T><<<(M + R - 1) / R, kThreads, sm1, stream>>>(
      x, ln1g, ln1b, wqkv, bqkv, qkv, y_out, M, D);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t sm2 = attn_layout<T>(N, hd).total;
  if ((e = set_smem(attention_kernel<T>, sm2)) != cudaSuccess) return e;
  const dim3 grid2((N + R - 1) / R, heads, B);
  attention_kernel<T><<<grid2, kThreads, sm2, stream>>>(
      qkv, attn, N, D, heads,
      static_cast<float>(std::pow(static_cast<double>(hd), -0.5)));
  return cudaGetLastError();
}

// Shapes both kernels take: D a multiple of 64, a head width that is a
// multiple of 16, hidden a multiple of D (and so of 64).
inline bool block_shape_ok(int B, int N, int D, int heads, int H) {
  return B >= 1 && N >= 1 && heads >= 1 && D % 64 == 0 && D % heads == 0 &&
         (D / heads) % 16 == 0 && H % 64 == 0 && H % D == 0;
}

}  // namespace
