// The bf16 GEMM stages of the ViT-block forward on Hopper (sm_90a):
// LN1 + qkv (ln_qkv_mma_kernel, which the backward vit_block_bwd.cu also
// runs to recompute qkv) and proj + residual + LN2 + fc1 + GELU + fc2 +
// residual (proj_mlp_mma_kernel, with #3's a1 store behind kStoreA1), for a
// model width D of 64, 128 or 192. They replace the first design's WMMA
// stages; the fp32 route runs block_tf32.cuh's 3xTF32 stages, on this
// design. The note in vit_block_fwd.cu says what bounds them.
//
// Design. A CTA has W warps, 16 rows each; each stage has its own W:
//   - products are mma.sync.m16n8k16 bf16 -> fp32 with every accumulator in
//     registers; a warp's own rows are A fragments in registers (the LN
//     output, the attention output, LN2's z, the GELU output), the weights
//     B fragments read by ldmatrix from shared memory;
//   - the weights stream through a two-stage cp.async ring of tiles of 64
//     output columns (Wqkv, Wproj, W1 chunks, [64][D]) or of 64 hidden
//     columns (W2 chunks, [D][64]): tile 0 is issued before the rows come
//     in, and the copy of tile s + 1 runs under the products of tile s, one
//     __syncthreads per tile;
//   - every epilogue runs on the C fragments in registers: bias, the fp32
//     residual x1 (kept in shared memory, each element read back only by
//     the thread that wrote it), LN statistics reduced over the quad of
//     threads sharing a row, GELU, #3's a1 store and the final rounding;
//     fc1's output, rounded, is repacked as the A fragments of fc2 (a C
//     fragment pair of two 8-column blocks is the A fragment of one 16-deep
//     block), so fc2 runs chunk by chunk of the hidden dimension and the
//     (rows, H) hidden tile never exists;
//   - ln_qkv: W = 6 (96 rows); each warp's rows come in, and its qkv
//     (and y) go out, through a staging tile of its own as 16-byte vectors,
//     full 128-byte lines, where 4-byte accesses of the fragment layout
//     touched eight half-used sectors per instruction. Shared memory at
//     D = 192: the ring 2 x 25 KB and the staging 6 x 6.25 KB, 87.5 KB, two
//     CTAs an SM;
//   - proj_mlp: W = 3 (48 rows); its rows are read straight into
//     fragments. The ring 2 x 27 KB (a stage holds the larger of a
//     [64][200] and a [192][72] tile) and x1 48 x 200 fp32, 91.5 KB, two
//     CTAs an SM (at 255 registers a thread there is no room for staging).
//   On the card, more warps or stages than these did not pay for their
//     shared memory: a third ring stage, or proj_mlp's staging, left one
//     CTA an SM or made it slower; the chosen W were the fastest timed at
//     both main-path shapes.
// Rounding points are the TPU kernel's (rovit_kan_tpu/ops/block_kernel.py
// :98-149): LN in fp32, two-pass, rounded; qkv rounded after the fp32 bias;
// x1 = x + (acc + bproj) in fp32; a = acc + b1 in fp32, a1 = round(a),
// h = round(gelu_erf(a)); out = round(x1 + (acc + b2)). Only the order of
// the fp32 sums inside a product or a LayerNorm differs from the plain
// version's. Every element has one owner, so a repeated call gives the same
// bits, and the kStoreA1 instance computes #1's output with the same
// instructions.

#pragma once

#include "mma_common.cuh"

namespace {

constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

constexpr int kGemmCols = 64;                 // columns per weight tile

// The shape of a GEMM stage: W warps of 16 rows each, a two-stage ring, and
// for ln_qkv per warp a staging tile of its 16 rows (bf16, row stride kLdW)
// through which its rows come in and its outputs go out as 16-byte vectors.
template <int D, int W>
struct GemmPlan {
  static constexpr int kThreads = 32 * W;
  static constexpr int kRows = 16 * W;
  static constexpr int kLdW = D + 8;            // [64][D] tiles, staging
  static constexpr int kLdH = kGemmCols + 8;    // [D][64] W2 tiles
  static constexpr int kLdX = D + 8;            // x1 rows (fp32)
  static constexpr int kStageQkv = kGemmCols * kLdW;
  static constexpr int kStageMlp = kGemmCols * kLdW > D * kLdH
                                       ? kGemmCols * kLdW : D * kLdH;
  static constexpr int kStaging = 16 * kLdW;    // per warp (ln_qkv)
  static constexpr size_t kQkvSmem =
      sizeof(bf16) * (2 * kStageQkv + W * kStaging);
  static constexpr size_t kMlpSmem =
      2 * sizeof(bf16) * kStageMlp + sizeof(float) * kRows * kLdX;
};

// LayerNorm statistics of a warp's 16 rows, the thread's rows g and g + 8
// (half 0, 1), read by val(half, j) as the float2 of columns 8 j + 2 t and
// 8 j + 2 t + 1: two-pass fp32 mean and 1 / sqrt(var + eps) over the quad.
template <int D, typename Val>
__device__ __forceinline__ void layernorm_stats(Val val, float (&mean)[2],
                                                float (&rstd)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 v = val(half, j);
      s += v.x;
      s += v.y;
    }
    mean[half] = quad_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 v = val(half, j);
      const float dx = v.x - mean[half], dy = v.y - mean[half];
      q += dx * dx;
      q += dy * dy;
    }
    rstd[half] = rsqrtf(quad_sum(q) / D + kLnEps);
  }
}

// LayerNorm of those rows, the result rounded to bf16 as A fragments.
template <int D, typename Val>
__device__ __forceinline__ void layernorm_to_a(Val val,
                                               const float* __restrict__ g,
                                               const float* __restrict__ b,
                                               uint32_t (&a)[D / 16][4],
                                               int t) {
  float mean[2], rstd[2];
  layernorm_stats<D>(val, mean, rstd);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int half = e & 1;
      const int j = 2 * kk + (e >> 1);
      const int c = 8 * j + 2 * t;
      const float2 v = val(half, j);
      a[kk][e] = pack_bf16((v.x - mean[half]) * rstd[half] * g[c] + b[c],
                           (v.y - mean[half]) * rstd[half] * g[c + 1] +
                               b[c + 1]);
    }
  }
}

__device__ __forceinline__ float2 u32_to_f2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ uint32_t& u32_at(bf16* p) {
  return *reinterpret_cast<uint32_t*>(p);
}
__device__ __forceinline__ uint32_t load_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A warp's 16 rows of NC bf16 between global memory (row stride ldg) and
// its staging tile (row stride LD), as 16-byte vectors: four full 128-byte
// lines per instruction where NC is 64. Rows from `valid` on (all when
// valid <= 0) are zero-filled on the way in and skipped on the way out. The
// caller fences with __syncwarp on both sides.
template <int NC, int LD>
__device__ __forceinline__ void warp_rows_in(bf16* stg, const bf16* src,
                                             long long ldg, int valid,
                                             int lane) {
  constexpr int kVecs = NC / 8;
#pragma unroll
  for (int v = lane; v < 16 * kVecs; v += 32) {
    const int r = v / kVecs, c = (v - r * kVecs) * 8;
    *reinterpret_cast<uint4*>(stg + r * LD + c) =
        r < valid ? *reinterpret_cast<const uint4*>(src + r * ldg + c)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}
template <int NC, int LD>
__device__ __forceinline__ void warp_rows_out(bf16* dst, const bf16* stg,
                                              long long ldg, int valid,
                                              int lane) {
  constexpr int kVecs = NC / 8;
#pragma unroll
  for (int v = lane; v < 16 * kVecs; v += 32) {
    const int r = v / kVecs, c = (v - r * kVecs) * 8;
    if (r < valid) {
      *reinterpret_cast<uint4*>(dst + r * ldg + c) =
          *reinterpret_cast<const uint4*>(stg + r * LD + c);
    }
  }
}

// ---- LN1 + qkv -------------------------------------------------------------

// 16 W rows: LN1 into A fragments, then qkv = y . Wqkv^T + bqkv over 3D / 64
// weight tiles, each rounded after its fp32 bias. Where y_out is given, the
// rounded LN1 output is stored too (the backward's weight grad of qkv reads
// it).
template <int D, int W>
__global__ void __launch_bounds__(32 * W)
ln_qkv_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ b, const bf16* __restrict__ w,
                  const float* __restrict__ bias, bf16* __restrict__ qkv,
                  bf16* __restrict__ y_out, int M) {
  using P = GemmPlan<D, W>;
  constexpr int KB = D / 16;
  constexpr int kTiles = 3 * D / kGemmCols;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  auto stage = [&](int s) { return ring + (s & 1) * P::kStageQkv; };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  bf16* stg = ring + 2 * P::kStageQkv + warp * P::kStaging;
  const int row0 = blockIdx.x * P::kRows + 16 * warp;   // the warp's rows
  const int valid = min(16, M - row0);
  auto load_w = [&](int s) {
    load_tile_async<D, P::kLdW, P::kThreads>(
        stage(s), w + static_cast<size_t>(s) * kGemmCols * D, D, kGemmCols,
        kGemmCols);
    cp_async_commit();
  };

  // Tile 0 in flight while the rows load and LN1 runs.
  load_w(0);
  warp_rows_in<D, P::kLdW>(stg, x + static_cast<size_t>(row0) * D, D,
                           valid, lane);
  __syncwarp();
  uint32_t ya[KB][4];
  layernorm_to_a<D>(
      [&](int half, int j) {
        return u32_to_f2(u32_at(stg + (gq + 8 * half) * P::kLdW + 8 * j +
                                2 * t));
      },
      g, b, ya, t);
  if (y_out != nullptr) {
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        u32_at(stg + (gq + 8 * (e & 1)) * P::kLdW + 16 * kk + 8 * (e >> 1) +
               2 * t) = ya[kk][e];
      }
    }
    __syncwarp();
    warp_rows_out<D, P::kLdW>(y_out + static_cast<size_t>(row0) * D, stg,
                              D, valid, lane);
  }

  for (int s = 0; s < kTiles; ++s) {
    cp_async_wait_all();
    __syncthreads();           // tile s landed; tile s - 1's stage is free
    if (s + 1 < kTiles) load_w(s + 1);
    float acc[8][4];
    zero_acc<8>(acc);
    warp_mma_nk<P::kLdW, KB, 8>(acc, ya, stage(s), lane);
    __syncwarp();              // the staging tile's last stores are done
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 bb =
          *reinterpret_cast<const float2*>(bias + s * kGemmCols + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        u32_at(stg + (gq + 8 * half) * P::kLdW + c) =
            pack_bf16(acc[j][2 * half] + bb.x, acc[j][2 * half + 1] + bb.y);
      }
    }
    __syncwarp();
    warp_rows_out<kGemmCols, P::kLdW>(
        qkv + static_cast<size_t>(row0) * 3 * D + s * kGemmCols, stg,
        3 * D, valid, lane);
  }
}

// ---- proj + residual + LN2 + fc1 + GELU + fc2 + residual --------------------

// 16 W rows. Tiles 0..D/64-1 are Wproj's; then, for each 64-wide chunk j
// of the hidden dimension, W1's rows of the chunk and W2's columns of it.
// kStoreA1 (#3): also store the fc1 pre-activation a1 = round(acc + b1).
template <int D, bool kStoreA1, int W>
__global__ void __launch_bounds__(32 * W)
proj_mlp_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ attn,
                    const bf16* __restrict__ wproj,
                    const float* __restrict__ bproj,
                    const float* __restrict__ g2,
                    const float* __restrict__ bn2,
                    const bf16* __restrict__ w1, const float* __restrict__ b1,
                    const bf16* __restrict__ w2, const float* __restrict__ b2,
                    bf16* __restrict__ out, bf16* __restrict__ a1_out, int M,
                    int H) {
  using P = GemmPlan<D, W>;
  constexpr int KB = D / 16;
  constexpr int kProj = D / kGemmCols;
  const int tiles = kProj + 2 * (H / kGemmCols);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* sX = reinterpret_cast<float*>(smem + 2 * sizeof(bf16) *
                                                  P::kStageMlp);
  auto stage = [&](int s) { return ring + (s & 1) * P::kStageMlp; };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * P::kRows;
  const int lr[2] = {16 * warp + gq, 16 * warp + gq + 8};
  const bool ok[2] = {r0 + lr[0] < M, r0 + lr[1] < M};
  float* xr[2] = {sX + lr[0] * P::kLdX, sX + lr[1] * P::kLdX};
  auto load_w = [&](int s) {
    if (s < kProj) {
      load_tile_async<D, P::kLdW, P::kThreads>(
          stage(s), wproj + static_cast<size_t>(s) * kGemmCols * D, D,
          kGemmCols, kGemmCols);
    } else if (((s - kProj) & 1) == 0) {
      const int j = (s - kProj) >> 1;
      load_tile_async<D, P::kLdW, P::kThreads>(
          stage(s), w1 + static_cast<size_t>(j) * kGemmCols * D, D,
          kGemmCols, kGemmCols);
    } else {
      const int j = (s - kProj) >> 1;
      load_tile_async<kGemmCols, P::kLdH, P::kThreads>(
          stage(s), w2 + j * kGemmCols, H, D, D);
    }
    cp_async_commit();
  };
  auto step = [&](int s) {
    cp_async_wait_all();
    __syncthreads();           // tile s landed; tile s - 1's stage is free
    if (s + 1 < tiles) load_w(s + 1);
  };

  // Tile 0 in flight while the attention output's rows load.
  load_w(0);

  // proj, and x1 = x + (acc + bproj) in fp32.
  {
    uint32_t aa[KB][4];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        aa[kk][e] = ok[e & 1]
                        ? load_u32(attn +
                                   static_cast<size_t>(r0 + lr[e & 1]) * D +
                                   16 * kk + 8 * (e >> 1) + 2 * t)
                        : 0u;
      }
    }
    for (int s = 0; s < kProj; ++s) {
      step(s);
      float acc[8][4];
      zero_acc<8>(acc);
      warp_mma_nk<P::kLdW, KB, 8>(acc, aa, stage(s), lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = s * kGemmCols + 8 * j + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(bproj + c);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 xv =
              ok[half] ? u32_to_f2(load_u32(
                             x + static_cast<size_t>(r0 + lr[half]) * D + c))
                       : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(xr[half] + c) =
              make_float2(xv.x + (acc[j][2 * half] + bb.x),
                          xv.y + (acc[j][2 * half + 1] + bb.y));
        }
      }
    }
  }

  // LN2 from the x1 elements this thread wrote.
  uint32_t za[KB][4];
  layernorm_to_a<D>(
      [&](int half, int j) {
        return *reinterpret_cast<const float2*>(xr[half] + 8 * j + 2 * t);
      },
      g2, bn2, za, t);

  // fc1 + GELU chunk by chunk, each chunk's h fed straight to fc2.
  float acc2[D / 8][4];
  zero_acc<D / 8>(acc2);
  for (int j = 0; j < H / kGemmCols; ++j) {
    const int s = kProj + 2 * j;
    step(s);
    uint32_t ha[4][4];
    {
      float acc1[8][4];
      zero_acc<8>(acc1);
      warp_mma_nk<P::kLdW, KB, 8>(acc1, za, stage(s), lane);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = j * kGemmCols + 8 * jj + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(b1 + c);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float a0 = acc1[jj][2 * half] + bb.x;
          const float a1 = acc1[jj][2 * half + 1] + bb.y;
          if (kStoreA1 && ok[half]) {
            u32_at(a1_out + static_cast<size_t>(r0 + lr[half]) * H + c) =
                pack_bf16(a0, a1);
          }
          acc1[jj][2 * half] = gelu_erf(a0);
          acc1[jj][2 * half + 1] = gelu_erf(a1);
        }
      }
      c_to_a<8>(acc1, ha);                  // h, rounded
    }
    step(s + 1);
    warp_mma_nk<P::kLdH, 4, D / 8>(acc2, ha, stage(s + 1), lane);
  }

  // out = x1 + (acc + b2), rounded once.
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 bb = *reinterpret_cast<const float2*>(b2 + c);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (ok[half]) {
        const float2 x1 = *reinterpret_cast<const float2*>(xr[half] + c);
        u32_at(out + static_cast<size_t>(r0 + lr[half]) * D + c) =
            pack_bf16(x1.x + (acc2[j][2 * half] + bb.x),
                      x1.y + (acc2[j][2 * half + 1] + bb.y));
      }
    }
  }
}

// ---- launches --------------------------------------------------------------

template <int D, int W>
cudaError_t launch_ln_qkv_mma_d(const bf16* x, const float* g,
                                const float* b, const bf16* w,
                                const float* bias, bf16* qkv, bf16* y_out,
                                int M, cudaStream_t stream) {
  using P = GemmPlan<D, W>;
  const auto kernel = ln_qkv_mma_kernel<D, W>;
  cudaError_t e;
  if ((e = set_smem(kernel, P::kQkvSmem)) != cudaSuccess) return e;
  kernel<<<(M + P::kRows - 1) / P::kRows, P::kThreads, P::kQkvSmem,
           stream>>>(x, g, b, w, bias, qkv, y_out, M);
  return cudaGetLastError();
}

template <int D, bool kStoreA1, int W>
cudaError_t launch_proj_mlp_mma_d(const bf16* x, const bf16* attn,
                                  const bf16* wproj, const float* bproj,
                                  const float* g2, const float* bn2,
                                  const bf16* w1, const float* b1,
                                  const bf16* w2, const float* b2, bf16* out,
                                  bf16* a1, int M, int H,
                                  cudaStream_t stream) {
  using P = GemmPlan<D, W>;
  const auto kernel = proj_mlp_mma_kernel<D, kStoreA1, W>;
  cudaError_t e;
  if ((e = set_smem(kernel, P::kMlpSmem)) != cudaSuccess) return e;
  kernel<<<(M + P::kRows - 1) / P::kRows, P::kThreads, P::kMlpSmem,
           stream>>>(x, attn, wproj, bproj, g2, bn2, w1, b1, w2, b2, out,
                     a1, M, H);
  return cudaGetLastError();
}

// The warps of each stage's CTA.
constexpr int kQkvWarps = 6, kMlpWarps = 3;

// A width other than 64, 128 or 192 returns cudaErrorInvalidValue,
// unlaunched. The dispatchers are templates (T is bf16), so a source
// compiles only the kernels it launches.
template <typename T>
cudaError_t launch_ln_qkv_mma(const T* x, const float* g, const float* b,
                              const T* w, const float* bias, T* qkv,
                              T* y_out, int M, int D, cudaStream_t stream) {
  static_assert(std::is_same<T, bf16>::value, "bf16 only");
#define LN_QKV_CALL(DD)                                                     \
  launch_ln_qkv_mma_d<DD, kQkvWarps>(x, g, b, w, bias, qkv, y_out, M,       \
                                     stream)
  switch (D) {
    case 64: return LN_QKV_CALL(64);
    case 128: return LN_QKV_CALL(128);
    case 192: return LN_QKV_CALL(192);
    default: return cudaErrorInvalidValue;
  }
#undef LN_QKV_CALL
}

// a1 given: #3's instance, which also stores a1 (M, H).
template <typename T>
cudaError_t launch_proj_mlp_mma(const T* x, const T* attn, const T* wproj,
                                const float* bproj, const float* g2,
                                const float* bn2, const T* w1,
                                const float* b1, const T* w2,
                                const float* b2, T* out, T* a1, int M, int D,
                                int H, cudaStream_t stream) {
  static_assert(std::is_same<T, bf16>::value, "bf16 only");
#define PROJ_MLP_CALL(DD, A1)                                               \
  launch_proj_mlp_mma_d<DD, A1, kMlpWarps>(                                 \
      x, attn, wproj, bproj, g2, bn2, w1, b1, w2, b2, out, a1, M, H, stream)
  const bool store_a1 = a1 != nullptr;
  switch (D) {
    case 64:
      return store_a1 ? PROJ_MLP_CALL(64, true) : PROJ_MLP_CALL(64, false);
    case 128:
      return store_a1 ? PROJ_MLP_CALL(128, true) : PROJ_MLP_CALL(128, false);
    case 192:
      return store_a1 ? PROJ_MLP_CALL(192, true) : PROJ_MLP_CALL(192, false);
    default:
      return cudaErrorInvalidValue;
  }
#undef PROJ_MLP_CALL
}

}  // namespace
