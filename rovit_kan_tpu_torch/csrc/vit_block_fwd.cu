// Forward of one pre-LN ViT block on Hopper (sm_90a), bf16 or fp32.
//
// Replaces rovit_kan_tpu/ops/block_kernel.py::_vit_block_kernel (the Pallas
// TPU kernel behind fused_vit_block). Same function and the same rounding
// points:
//   y   = LN1(x) in fp32, rounded to the compute type T
//   qkv = y . Wqkv^T + bqkv (fp32 accumulate, fp32 bias), rounded to T
//   per image and head: S = q . k^T * hd^-1/2 (fp32), softmax in fp32,
//       P rounded to T, O = P . v (fp32), rounded to T
//   x1  = x + (O . Wproj^T + bproj)          residual in fp32
//   z   = LN2(x1) rounded to T
//   h   = GELU(z . W1^T + b1) rounded to T
//   out = x1 + (h . W2^T + b2)               residual in fp32, one rounding
// LayerNorm is two-pass (mean, then mean of squared deviations) with
// rsqrtf(var + 1e-6). GELU uses CUDA's erff, which is exact to fp32; the TPU
// kernel uses the Abramowitz-Stegun 7.1.26 rational erf (|err| < 1.5e-7)
// because Pallas on the TPU has no erf, so the two differ below fp32 noise.
// The TPU kernel pads 197 tokens to 200 and masks keys with -1e30 for
// Mosaic's (8, 128) tiling; here loops run to N and the ragged edge is
// masked instead (pad rows of K and V are zero in shared memory, pad
// columns of P are zero).
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM):
// at the serving shape B=64, N=197, D=192, 3 heads, hidden 768, one call
// does 2*B*N*D*(3D + D + 2*4D) = 1.116e10 FLOP in the four products plus
// 4*B*N*N*D = 1.908e9 FLOP in attention, 1.307e10 FLOP in all: 13.2 us at
// the bf16 peak. It must move x in and out once (2 * 4.84 MB in bf16) plus
// 0.88 MB of bf16 weights, about 10.6 MB: 3.2 us at the HBM rate. So it is
// compute-bound, by a factor of four.
//
// First design, right before fast. Three launches per block call, each a
// grid of independent CTAs of 256 threads:
//   1. ln_qkv:    a tile of 64 rows (32 in fp32): LN1 into shared memory,
//                 then the qkv product in 64-column steps;
//   2. attention: one CTA per (64-query tile, head, image); q, the image's
//                 whole K and V (197 x 64, 25 KB each in bf16) and the
//                 64 x 208 score tile all sit in shared memory;
//   3. proj_mlp:  a tile of 64 rows (32 in fp32): proj, the fp32 residual,
//                 LN2, fc1, GELU (the 64 x 768 hidden tile stays in shared
//                 memory), fc2 and the second residual.
// qkv and the attention output go through device memory (2 x 7.3 MB in
// bf16 at B=64, mostly served from the 50 MB L2); every other intermediate
// stays on chip. bf16 products use the tensor cores through WMMA 16x16x16
// fragments read from shared memory; fp32 products are plain FMA loops (the
// TPU kernel's fp32 mode also stays out of reduced precision). Weights are
// streamed through shared memory in 64-row chunks, with no overlap of loads
// and math: wgmma, TMA and a persistent pipelined design are later work.
//
// Interface: plain C, loaded with ctypes. Each entry returns the first
// CUDA error (0 = success), checked with cudaGetLastError after every
// launch, so a launch refused for its resources is reported and never
// silently skipped. Nothing is allocated here and nothing synchronises.

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

// Rows per CTA of the row-tiled kernels and queries per attention CTA.
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
// A is row-major (lda). B_NK: B is stored [n][k] (a Linear weight, or the K
// of attention), else [k][n] (the V of attention). M, N, K are multiples of
// 16; every pointer is 32-byte aligned and every stride a multiple of 16
// bytes. Each output tile always goes to the same warp (bf16) or thread
// (fp32), so an accumulating call reads only what its owner wrote.
template <typename T, bool B_NK>
__device__ void block_gemm(const T* __restrict__ A, int lda,
                           const T* __restrict__ Bm, int ldb,
                           float* __restrict__ C, int ldc,
                           int M, int N, int K, bool accumulate) {
  if constexpr (std::is_same<T, bf16>::value) {
    namespace wmma = nvcuda::wmma;
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
      const bf16* a = A + (tm * 16) * lda;
      for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, a + k, lda);
        if constexpr (B_NK) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              fb;
          wmma::load_matrix_sync(fb, Bm + (tn * 16) * ldb + k, ldb);
          wmma::mma_sync(acc, fa, fb, acc);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, Bm + k * ldb + tn * 16, ldb);
          wmma::mma_sync(acc, fa, fb, acc);
        }
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
        for (int i = 0; i < 4; ++i) a[i] = A[(4 * tm + i) * lda + k];
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
// writes the result rounded to T. Rows from valid_rows on are written as 0.
template <typename S, typename T>
__device__ void layernorm_rows(const S* __restrict__ src, size_t src_ld,
                               int rows, int valid_rows,
                               const float* __restrict__ g,
                               const float* __restrict__ b,
                               T* __restrict__ dst, int dst_ld, int D) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    T* out = dst + r * dst_ld;
    if (r >= valid_rows) {
      for (int c = lane; c < D; c += 32) out[c] = from_f<T>(0.f);
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
  }
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// ---- 1. LN1 + qkv --------------------------------------------------------

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const T* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ b, const T* __restrict__ w,
              const float* __restrict__ bias, T* __restrict__ qkv, int M,
              int D) {
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

// ---- 2. attention per (query tile, head, image) --------------------------

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

// ---- 3. proj + residual + LN2 + fc1 + GELU + fc2 + residual ---------------

struct MlpLayout {
  size_t a, x, h, w, c, total;
};
template <typename T>
__host__ __device__ MlpLayout proj_mlp_layout(int D, int H) {
  constexpr int R = Tile<T>::kRows;
  MlpLayout L;
  L.a = 0;
  L.x = L.a + align128(sizeof(T) * R * ld_of<T>(D));
  L.h = L.x + align128(sizeof(float) * R * D);
  L.w = L.h + align128(sizeof(T) * R * ld_of<T>(H));
  L.c = L.w + align128(sizeof(T) * kChunk * ld_of<T>(D));
  L.total = L.c + align128(sizeof(float) * R * (kChunk + 4));
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
proj_mlp_kernel(const T* __restrict__ x, const T* __restrict__ attn,
                const T* __restrict__ wproj, const float* __restrict__ bproj,
                const float* __restrict__ g2, const float* __restrict__ bn2,
                const T* __restrict__ w1, const float* __restrict__ b1,
                const T* __restrict__ w2, const float* __restrict__ b2,
                T* __restrict__ out, int M, int D, int H) {
  constexpr int R = Tile<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpLayout L = proj_mlp_layout<T>(D, H);
  T* sA = reinterpret_cast<T*>(smem + L.a);        // attention out, then z
  float* sX = reinterpret_cast<float*>(smem + L.x);  // x, then x1
  T* sH = reinterpret_cast<T*>(smem + L.h);
  T* sW = reinterpret_cast<T*>(smem + L.w);
  float* sC = reinterpret_cast<float*>(smem + L.c);
  const int ld = ld_of<T>(D);
  const int ldh = ld_of<T>(H);
  const int ldc = kChunk + 4;
  const int r0 = blockIdx.x * R;
  const int valid = min(R, M - r0);

  load_tile<T>(sA, ld, attn + static_cast<size_t>(r0) * D, D, R, valid, D);
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D;
    sX[i] = r < valid ? to_f(x[static_cast<size_t>(r0) * D + i]) : 0.f;
  }

  // proj, and the first residual in fp32.
  for (int n0 = 0; n0 < D; n0 += kChunk) {
    __syncthreads();
    load_tile<T>(sW, ld, wproj + static_cast<size_t>(n0) * D, D, kChunk,
                 kChunk, D);
    __syncthreads();
    block_gemm<T, true>(sA, ld, sW, ld, sC, ldc, R, kChunk, D, false);
    __syncthreads();
    for (int i = threadIdx.x; i < R * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int c = i - r * kChunk;
      float* xr = sX + r * D + n0 + c;
      *xr = *xr + (sC[r * ldc + c] + bproj[n0 + c]);
    }
  }
  __syncthreads();
  layernorm_rows<float, T>(sX, D, R, R, g2, bn2, sA, ld, D);

  // fc1 + GELU; the hidden tile stays in shared memory.
  for (int n0 = 0; n0 < H; n0 += kChunk) {
    __syncthreads();
    load_tile<T>(sW, ld, w1 + static_cast<size_t>(n0) * D, D, kChunk, kChunk,
                 D);
    __syncthreads();
    block_gemm<T, true>(sA, ld, sW, ld, sC, ldc, R, kChunk, D, false);
    __syncthreads();
    for (int i = threadIdx.x; i < R * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int c = i - r * kChunk;
      sH[r * ldh + n0 + c] =
          from_f<T>(gelu_erf(sC[r * ldc + c] + b1[n0 + c]));
    }
  }

  // fc2 in D-wide slices of the hidden dimension, and the second residual.
  for (int n0 = 0; n0 < D; n0 += kChunk) {
    for (int k0 = 0; k0 < H; k0 += D) {
      __syncthreads();
      load_tile<T>(sW, ld, w2 + static_cast<size_t>(n0) * H + k0, H, kChunk,
                   kChunk, D);
      __syncthreads();
      block_gemm<T, true>(sH + k0, ldh, sW, ld, sC, ldc, R, kChunk, D,
                          k0 > 0);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < valid * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int c = i - r * kChunk;
      out[static_cast<size_t>(r0 + r) * D + n0 + c] = from_f<T>(
          sX[r * D + n0 + c] + (sC[r * ldc + c] + b2[n0 + c]));
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int run_block(const void* x, void* out, void* qkv, void* attn,
              const void* ln1g, const void* ln1b, const void* wqkv,
              const void* bqkv, const void* wproj, const void* bproj,
              const void* ln2g, const void* ln2b, const void* w1,
              const void* b1, const void* w2, const void* b2, int B, int N,
              int D, int heads, int H, void* stream_ptr) {
  if (B < 1 || N < 1 || heads < 1 || D % 64 != 0 || D % heads != 0 ||
      (D / heads) % 16 != 0 || H % 64 != 0 || H % D != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int R = Tile<T>::kRows;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = B * N;
  const int hd = D / heads;
  const int row_tiles = (M + R - 1) / R;
  cudaError_t e;

  const size_t sm1 = ln_qkv_layout<T>(D).total;
  if ((e = set_smem(ln_qkv_kernel<T>, sm1)) != cudaSuccess) return e;
  ln_qkv_kernel<T><<<row_tiles, kThreads, sm1, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln1g),
      static_cast<const float*>(ln1b), static_cast<const T*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<T*>(qkv), M, D);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t sm2 = attn_layout<T>(N, hd).total;
  if ((e = set_smem(attention_kernel<T>, sm2)) != cudaSuccess) return e;
  const dim3 grid2((N + R - 1) / R, heads, B);
  attention_kernel<T><<<grid2, kThreads, sm2, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(attn), N, D, heads,
      static_cast<float>(std::pow(static_cast<double>(hd), -0.5)));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t sm3 = proj_mlp_layout<T>(D, H).total;
  if ((e = set_smem(proj_mlp_kernel<T>, sm3)) != cudaSuccess) return e;
  proj_mlp_kernel<T><<<row_tiles, kThreads, sm3, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(attn),
      static_cast<const T*>(wproj), static_cast<const float*>(bproj),
      static_cast<const float*>(ln2g), static_cast<const float*>(ln2b),
      static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<T*>(out), M, D, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define VIT_BLOCK_ARGS                                                      \
  const void *x, void *out, void *qkv, void *attn, const void *ln1g,        \
      const void *ln1b, const void *wqkv, const void *bqkv,                 \
      const void *wproj, const void *bproj, const void *ln2g,               \
      const void *ln2b, const void *w1, const void *b1, const void *w2,     \
      const void *b2, int B, int N, int D, int heads, int H, void *stream
#define VIT_BLOCK_PASS                                                      \
  x, out, qkv, attn, ln1g, ln1b, wqkv, bqkv, wproj, bproj, ln2g, ln2b, w1,  \
      b1, w2, b2, B, N, D, heads, H, stream

extern "C" int vit_block_fwd_bf16(VIT_BLOCK_ARGS) {
  return run_block<bf16>(VIT_BLOCK_PASS);
}

extern "C" int vit_block_fwd_f32(VIT_BLOCK_ARGS) {
  return run_block<float>(VIT_BLOCK_PASS);
}

extern "C" const char* vit_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
