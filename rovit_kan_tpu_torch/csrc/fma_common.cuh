// Register-blocked fp32 FMA products on Hopper (sm_90a): the GEMM engine of
// the fp32 route of the ViT-block backwards #2 and #4 (block_bwd_fma.cuh,
// attention_fma.cuh). The bf16 route runs mma.sync (mma_common.cuh); the
// fp32 forward stages (block_tf32.cuh) and #5/#6's fp32 kernels run 3xTF32
// mma.sync (attention_tf32.cuh).
//
// fp32 has no tensor-core path here (no TF32: the kernels keep fp32's
// rounding), so a product runs at the 67 TFLOP/s of the SMs' FMA pipes, and
// shared-memory traffic, not device memory, is what stands between it and
// that rate. The design:
//   - A CTA of NT threads is a TR x TC grid; thread (tr, tc) owns a TM x TN
//     micro-tile of the output, at least 32 accumulators in every product of
//     the stages on the main path, kept in registers from the first k-slice
//     through the fused epilogue.
//   - Operands sit in shared memory in one of two layouts: "k-contiguous"
//     ([row][k], as a Linear weight or a row tile is stored) or "k-major"
//     ([k][row], as a weight read transposed or a row tile read as the
//     depth of A^T . B). Every read is one float4: four k of one row from a
//     k-contiguous tile, four rows of one k from a k-major one. Per four
//     steps of depth a thread issues TM + TN float4 loads for 4 TM TN FMAs
//     (11-12 FMAs a load at the row stages' 4 x 12 and 4 x 8 tiles and the
//     attention's 4 x 8).
//   - Rows of a k-contiguous A go to lanes one apart (row tr + TR i), so the
//     lanes of a quarter-warp read consecutive rows, and a row stride of
//     4 mod 32 floats puts them in different bank groups; rows of a k-major
//     A, and B columns, go to lanes in quads (4 (tc + TC j) + c), so a
//     quarter-warp reads contiguous bytes of one k row, or one apart
//     (tc + TC j, the attention's S and dP) from a k-contiguous B.
//   - k-slices stream through a cp.async ring of kRingStages stages
//     (ring_run): the copy of slice i + 2 runs under the FMAs of slice i,
//     one __syncthreads per slice; rows past the end of a tile are
//     zero-filled by the copy, so they add nothing to any product.
// Every output element has one owner that adds its k in increasing order,
// so a repeated call gives the same bits. Everything sits in an anonymous
// namespace, so each source that includes this header gets its own copy.

#pragma once

#include "mma_common.cuh"

namespace {

constexpr int kRingStages = 3;

// The thread grid of a CTA of NT threads: TR threads along the rows and
// NT / TR along the columns. A warp is LR x 32 / LR threads (lane % LR
// along the rows, lane / LR along the columns); the warps tile the grid
// TR / LR along the rows.
template <int NT, int TR, int LR = 8>
struct FmaGrid {
  static constexpr int kTR = TR, kTC = NT / TR, kLC = 32 / LR;
  static_assert(TR % LR == 0 && kTC % kLC == 0 && NT % (TR * kLC) == 0,
                "whole warps");
  __device__ static int tr() {
    return threadIdx.x % LR + LR * ((threadIdx.x >> 5) % (TR / LR));
  }
  __device__ static int tc() {
    return (threadIdx.x & 31) / LR + kLC * ((threadIdx.x >> 5) / (TR / LR));
  }
  // The warp's index along the rows and along the columns.
  __device__ static int wm() { return (threadIdx.x >> 5) % (TR / LR); }
  __device__ static int wn() { return (threadIdx.x >> 5) / (TR / LR); }
};

// Micro-tile element (i, j) of a thread: row fma_row<..>(i) and column
// fma_col<..>(j) of the product's output.
template <int TR, bool kQuadRows>
__device__ __forceinline__ int fma_row(int tr, int i) {
  return kQuadRows ? 4 * (tr + TR * (i >> 2)) + (i & 3) : tr + TR * i;
}
template <int TC>
__device__ __forceinline__ int fma_col(int tc, int j) {
  return 4 * (tc + TC * (j >> 2)) + (j & 3);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc += A . B over `depth` (a multiple of 4), both operands in shared
// memory. kAKM: A is k-major ([k][row], lda), its rows in quads; else
// k-contiguous ([row][k]), rows tr + TR i. kBKN: B is k-major ([k][col],
// ldb); else k-contiguous ([col][k]). Columns are in quads, or with
// kStrided (k-contiguous B only) one apart, column tc + TC j.
template <int TR, int TC, int TM, int TN, bool kAKM, bool kBKN,
          bool kStrided = false>
__device__ __forceinline__ void fma_tile(float (&acc)[TM][TN],
                                         const float* __restrict__ A,
                                         int lda, const float* __restrict__ B,
                                         int ldb, int tr, int tc, int depth) {
  static_assert(TN % 4 == 0 && (!kAKM || TM % 4 == 0), "quads");
  static_assert(!(kStrided && kBKN), "strided columns: B k-contiguous");
#pragma unroll 4
  for (int k = 0; k < depth; k += 4) {
    float a[TM][4];                                   // a[row][k]
    if constexpr (kAKM) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const float4 v = lds4(A + (k + kk) * lda + 4 * (tr + TR * q));
          a[4 * q][kk] = v.x;
          a[4 * q + 1][kk] = v.y;
          a[4 * q + 2][kk] = v.z;
          a[4 * q + 3][kk] = v.w;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = lds4(A + (tr + TR * i) * lda + k);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
    }
    if constexpr (kStrided) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 v = lds4(B + (tc + TC * j) * ldb + k);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][j] = fmaf(a[i][0], v.x, acc[i][j]);
          acc[i][j] = fmaf(a[i][1], v.y, acc[i][j]);
          acc[i][j] = fmaf(a[i][2], v.z, acc[i][j]);
          acc[i][j] = fmaf(a[i][3], v.w, acc[i][j]);
        }
      }
      continue;
    }
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      float b[4][4];                                  // b[col][k]
      const int c0 = 4 * (tc + TC * q);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if constexpr (kBKN) {
          const float4 v = lds4(B + (k + t) * ldb + c0);
          b[0][t] = v.x;
          b[1][t] = v.y;
          b[2][t] = v.z;
          b[3][t] = v.w;
        } else {
          const float4 v = lds4(B + (c0 + t) * ldb + k);
          b[t][0] = v.x;
          b[t][1] = v.y;
          b[t][2] = v.z;
          b[t][3] = v.w;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][4 * q + c] = fmaf(a[i][kk], b[c][kk], acc[i][4 * q + c]);
    }
  }
}

// acc += A . B over depth 8 TNA, where A is the warp's own registers:
// a[TM][TNA], the micro-tile of a strided-column product (fma_tile with
// kStrided) on the same thread grid, rows tr + TR i, column k in the lane
// of the same lane % LR whose tc is k % 8, at a[i][k / 8]; B is k-major in
// shared memory, acc's columns in quads, only those below `cols`. The
// eight column threads of a row must be the lanes of one warp (LR = 4):
// this is FlashAttention-2's reuse of S and dP, in registers, as the A
// operand of the next products, each A value fetched by shuffle.
template <int TM, int TNA, int TN>
__device__ __forceinline__ void fma_regs_a(float (&acc)[TM][TN],
                                           const float (&a)[TM][TNA],
                                           const float* __restrict__ B,
                                           int ldb, int tc, int cols) {
  constexpr int TC = 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < TNA; ++j) {
#pragma unroll 2
    for (int src = 0; src < TC; ++src) {
      const int k = src + TC * j;
      float av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        av[i] = __shfl_sync(0xffffffffu, a[i][j], (lane & 3) | (src << 2));
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const int c0 = 4 * (tc + TC * q);
        if (c0 >= cols) break;
        const float4 v = lds4(B + k * ldb + c0);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][4 * q] = fmaf(av[i], v.x, acc[i][4 * q]);
          acc[i][4 * q + 1] = fmaf(av[i], v.y, acc[i][4 * q + 1]);
          acc[i][4 * q + 2] = fmaf(av[i], v.z, acc[i][4 * q + 2]);
          acc[i][4 * q + 3] = fmaf(av[i], v.w, acc[i][4 * q + 3]);
        }
      }
    }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void fma_zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// Copies ROWS x cols fp32 (cols a multiple of 4, COLS unless given; global
// row stride gs) into shared memory (row stride ld) with NT threads, as
// 16-byte cp.async copies, without waiting or committing; rows from
// valid_rows on and columns from valid_cols on are zero-filled. src must be
// a mapped address.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void tile_async(float* dst, int ld,
                                           const float* src, long long gs,
                                           int valid_rows, int valid_cols,
                                           int cols = COLS) {
  const int kVecs = cols / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * kVecs; i += NT) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 4;
    const bool ok = r < valid_rows && c < valid_cols;
    cp_async16(dst + r * ld + c, ok ? src + r * gs + c : src, ok);
  }
}

// Streams n k-slices through a ring of kRingStages stages of `stage`
// floats at `ring`: load(i, p) issues slice i's copies into p, use(i, p)
// consumes them. The copies of slice i + 2 run under use(i); one
// __syncthreads per slice, and one at the end, after which the ring may be
// refilled.
template <typename Load, typename Use>
__device__ __forceinline__ void ring_run(float* ring, int stage, int n,
                                         Load load, Use use) {
#pragma unroll
  for (int i = 0; i < kRingStages - 1; ++i) {
    if (i < n) load(i, ring + i * stage);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kRingStages - 2>();
    __syncthreads();
    const int next = i + kRingStages - 1;
    if (next < n) load(next, ring + (next % kRingStages) * stage);
    cp_async_commit();
    use(i, ring + (i % kRingStages) * stage);
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace
