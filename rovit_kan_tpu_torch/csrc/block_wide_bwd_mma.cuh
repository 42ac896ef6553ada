// The bf16 stages of the ViT-block backwards #2 and #4 at every width
// block_wide_mma.cuh's forward takes (D past 192, a multiple of 64 up to
// 768: the small and base presets' 384 and 768 among them), on Hopper
// (sm_90a): the wide counterparts of block_bwd_mma.cuh's mlp_bwd and
// qkv_bwd, on block_wide_mma.cuh's GEMM and row kernels. The attention
// backward (attention_mma.cuh), the weight grads (block_bwd_mma.cuh's
// wgrad over row splits: 64 x 384 tiles at D = 384 as before, 64 x 128
// tiles where 128 divides D, 64 x 64 tiles elsewhere, so no tile outgrows
// shared memory at 768) and the ordered reduce (block_bwd_common.cuh) are
// the narrow route's.
//
// Why split. mlp_bwd keeps dz (16 x D / 2 fp32 a warp) and qkv_bwd keeps dy
// (16 x D a warp) in registers across their products, and mlp_bwd already
// takes 162 KB of shared memory and 168 registers at D = 192; neither
// doubles. Here each product is a GEMM over 128-row output tiles and the
// LayerNorm backwards are row kernels that add each row's statistics over
// its whole width, so the columns of dz and dy are split across CTAs and
// the row sums across a warp's lanes. Between them values pass through
// device memory in fp32 (x1, dz, dy, dx1) or rounded where the TPU kernel
// casts (block_kernel.py:455-546: z, gb, h1, da1b, dx1b, the attention
// output's grad), so the rounding points are the fused stages'.
//
// mlp (launch_mlp_bwd_wide), six launches:
//   1. proj again: x1 = x + (attn . Wproj^T + bproj) in fp32, into dx1's
//      buffer (the GEMM of the forward);
//   2. LN2 again: z = round(LN2(x1)), and gb = round(g) (ln_rows);
//   3. mlp_grad (this file): per 128 x 64 tile of the hidden dimension,
//      a1 = z . W1^T + b1 (#2; #4 reads its saved a1) and dh = gb . W2,
//      two products into two register tiles, then h1 = round(GELU(a1)),
//      da1 = dh * GELU'(a1) (one erff for both), da1b = round(da1) and
//      b1's fp32 column sums of da1 (the tile's two row halves added in
//      order);
//   4. dz = da1b . W1 in fp32 (GEMM, W1 read [K][N]);
//   5. ln2_bwd_rows (this file): per row the LN2 statistics again from x1,
//      dx1 = g + rstd (dz g2 - mean(dz g2) - xhat mean(dz g2 xhat)) in fp32
//      over x1 and rounded into dx1b; the tile's column sums of g (b2),
//      dz xhat (ln2 scale), dz (ln2 bias) and dx1 (bproj);
//   6. dattn = round(dx1b . Wproj) (GEMM, Wproj read [K][N]).
// qkv (launch_qkv_bwd_wide), two launches:
//   1. dy = dqkv . Wqkv in fp32 (GEMM over K = 3D, Wqkv read [K][N]);
//   2. ln1_bwd_rows (this file): per row the LN1 statistics again from x,
//      dx = round(dx1 + rstd (dy g1 - mean(dy g1) - xhat mean(dy g1 xhat))),
//      (#4) y = round(LN1(x)) for the qkv weight grad; the tile's column
//      sums of dy xhat (ln1 scale) and dy (ln1 bias).
// Every row kernel and the mlp_grad tiles cover 128 rows, so each 128-row
// tile writes one partial row ([b2 | b1 | ln2 scale | ln2 bias | bproj],
// [ln1 scale | ln1 bias]) that the ordered reduce adds: lanes in a fixed
// butterfly, warps in index order through shared memory, tiles in order.
// No atomics, so a repeated call gives the same bits.
//
// What bounds it: at (64, 197, 384) #2 needs the forward's products but fc2
// again and two products for each forward product, 3 x 4.84e10 - 2 M D H =
// 1.30e11 FLOP, 0.132 ms at the bf16 peak; its own bytes (x, g, dx,
// weights, grads: 49 MB) take 0.015 ms, so operations bound it.

#pragma once

#include "block_bwd_common.cuh"
#include "block_wide_mma.cuh"

namespace {

constexpr int kWideTileRows = kGmRows;     // rows of a partial-sum tile

struct MlpGradArgs {
  const bf16 *z, *w1, *gb, *w2, *a1_in;    // a1_in: #4's saved a1, or null
  const float* b1;
  bf16 *h1, *da1;                          // (M, H) each
  float* part;                             // per tile [b2 | b1 | ...]
  int M, D, H;
};

// mlp_grad's tiles of the hidden dimension: 128 x 64, since a CTA keeps two
// accumulator tiles (64 columns were faster than 128 on an H100 SXM).
constexpr int kMlpGradCols = 64;

// One 128 x 64 tile of the hidden dimension: a1 (or the saved a1) and dh,
// then h1, da1b and b1's partial of the tile's 64 columns.
template <bool kResidual>
__global__ void __launch_bounds__(kGmThreads, 2)
mlp_grad_wide_kernel(MlpGradArgs g) {
  constexpr int BN = kMlpGradCols;
  using P1 = GmPlan<BN, false>;
  using P2 = GmPlan<BN, true>;
  static_assert(P1::MI == P2::MI && P1::NI == P2::NI, "one warp tile");
  constexpr int MI = P1::MI, NI = P1::NI;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kWideTileRows;
  float a[MI][NI][4], dh[MI][NI][4];
  if constexpr (!kResidual) {
    zero_tile(a);
    gemm_tile<BN, false>(a, ring, g.z, g.D, g.w1, g.D, g.M, g.D, m0, n0);
  }
  zero_tile(dh);
  gemm_tile<BN, true>(dh, ring, g.gb, g.D, g.w2, g.H, g.M, g.D, m0, n0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * P1::WM, wn = (warp & 3) * P1::WN;
  float col[NI][2];
#pragma unroll
  for (int j = 0; j < NI; ++j) col[j][0] = col[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm + 16 * i + gq + 8 * half;
      const bool ok = r < g.M;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = n0 + wn + 8 * j + 2 * t;
        const size_t o = static_cast<size_t>(r) * g.H + c;
        float av[2];
        if constexpr (kResidual) {
          const float2 v = ok ? u32_to_f2(load_u32(g.a1_in + o))
                              : make_float2(0.f, 0.f);
          av[0] = v.x;
          av[1] = v.y;
        } else {
          const float2 bb = *reinterpret_cast<const float2*>(g.b1 + c);
          av[0] = a[i][j][2 * half] + bb.x;
          av[1] = a[i][j][2 * half + 1] + bb.y;
        }
        const float2 v0 = gelu_and_grad(av[0]);
        const float2 v1 = gelu_and_grad(av[1]);
        const float d0 = ok ? dh[i][j][2 * half] * v0.y : 0.f;
        const float d1 = ok ? dh[i][j][2 * half + 1] * v1.y : 0.f;
        col[j][0] += d0;
        col[j][1] += d1;
        if (ok) {
          u32_at(g.h1 + o) = pack_bf16(v0.x, v1.x);
          u32_at(g.da1 + o) = pack_bf16(d0, d1);
        }
      }
    }
  }
  // b1's partial: the eight lanes of a column, then the tile's two row
  // halves in order (the ring is free: gemm_tile ends past a barrier).
  float* sCol = reinterpret_cast<float*>(smem);           // [2][BN]
#pragma unroll
  for (int j = 0; j < NI; ++j) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const float v = column_sum8(col[j][w]);
      if (lane < 4) sCol[(warp >> 2) * BN + wn + 8 * j + 2 * lane + w] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < BN) {
    g.part[static_cast<size_t>(blockIdx.y) * (4 * g.D + g.H) + g.D + n0 +
           threadIdx.x] = sCol[threadIdx.x] + sCol[BN + threadIdx.x];
  }
}

// A warp's K column sums, acc[k] held as a row's columns (row_has), into
// its rows [K][D] of shared memory.
template <int K>
__device__ __forceinline__ void store_row_sums(const float (&acc)[K][kRowV][4],
                                               float* sAcc, int D, int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < kRowV; ++i) {
      if (!row_has(D, lane, i)) continue;
      *reinterpret_cast<float4*>(sAcc + k * D + 4 * (lane + 32 * i)) =
          make_float4(acc[k][i][0], acc[k][i][1], acc[k][i][2],
                      acc[k][i][3]);
    }
}

// The LN2 backward over a tile of 128 rows, 16 a warp, a row at a time:
// x1 (fp32) read from x1dx1 and overwritten by dx1; dx1b = round(dx1). The
// tile's partials [b2 (D) | - (H) | ln2 scale | ln2 bias | bproj] into
// part's row blockIdx.x. A row's columns are held as ln_rows_kernel holds
// them, and so are each lane's column sums, in registers, added in row
// order; the warps' sums then meet in shared memory and are added in index
// order. One instance takes every D (a multiple of 64 up to kWideMaxD).
__global__ void __launch_bounds__(32 * kRowWarps)
ln2_bwd_rows_kernel(float* __restrict__ x1dx1, const float* __restrict__ dz,
                    const float* __restrict__ g,
                    const float* __restrict__ ln2g, bf16* __restrict__ dx1b,
                    float* __restrict__ part, int M, int D, int H) {
  constexpr int kRowsPerWarp = kWideTileRows / kRowWarps;
  extern __shared__ __align__(16) float sW[];             // [warps][4][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[4][kRowV][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < kRowV; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][i][e] = 0.f;
  const int r0 = blockIdx.x * kWideTileRows + kRowsPerWarp * warp;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = r0 + rr;
    if (row >= M) break;
    const size_t base = static_cast<size_t>(row) * D;
    float xv[kRowV][4], dv[kRowV][4];
#pragma unroll
    for (int i = 0; i < kRowV; ++i) {
      if (row_has(D, lane, i)) {
        const int c = 4 * (lane + 32 * i);
        load4(x1dx1 + base + c, xv[i]);
        load4(dz + base + c, dv[i]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) xv[i][e] = dv[i][e] = 0.f;
      }
    }
    float mean, rstd;
    wide_row_stats(xv, D, mean, rstd);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < kRowV; ++i) {
      if (!row_has(D, lane, i)) continue;
      float gs[4];
      load4(ln2g + 4 * (lane + 32 * i), gs);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xv[i][e] = (xv[i][e] - mean) * rstd;             // xhat
        const float d = dv[i][e] * gs[e];
        m1 += d;
        m2 += d * xv[i][e];
      }
    }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
#pragma unroll
    for (int i = 0; i < kRowV; ++i) {
      if (!row_has(D, lane, i)) continue;
      const int c = 4 * (lane + 32 * i);
      float gv[4], gs[4], o[4];
      load4(g + base + c, gv);
      load4(ln2g + c, gs);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[e] = gv[e] + rstd * (dv[i][e] * gs[e] - m1 - xv[i][e] * m2);
        acc[0][i][e] += gv[e];
        acc[1][i][e] += dv[i][e] * xv[i][e];
        acc[2][i][e] += dv[i][e];
        acc[3][i][e] += o[e];
      }
      *reinterpret_cast<float4*>(x1dx1 + base + c) =
          make_float4(o[0], o[1], o[2], o[3]);
      store4_bf16(dx1b + base + c, o[0], o[1], o[2], o[3]);
    }
  }
  store_row_sums<4>(acc, sW + warp * 4 * D, D, lane);
  __syncthreads();
  float* pt = part + static_cast<size_t>(blockIdx.x) * (4 * D + H);
  for (int i = threadIdx.x; i < 4 * D; i += 32 * kRowWarps) {
    const int k = i / D, c = i % D;
    const int off = k == 0 ? 0 : k * D + H;   // b2 | ln2 scale | bias | bproj
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) s += sW[(w * 4 + k) * D + c];
    pt[off + c] = s;
  }
}

// The LN1 backward over a tile of 128 rows: dx = round(dx1 + LN1's input
// grad of dy); (#4) y = round(LN1(x)). The tile's partials [ln1 scale (D) |
// ln1 bias (D)] into part's row blockIdx.x, summed as ln2_bwd_rows_kernel
// sums its own.
template <bool kResidual>
__global__ void __launch_bounds__(32 * kRowWarps)
ln1_bwd_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ dy,
                    const float* __restrict__ dx1,
                    const float* __restrict__ ln1g,
                    const float* __restrict__ ln1b, bf16* __restrict__ dx,
                    bf16* __restrict__ y_out, float* __restrict__ part,
                    int M, int D) {
  constexpr int kRowsPerWarp = kWideTileRows / kRowWarps;
  extern __shared__ __align__(16) float sW[];             // [warps][2][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[2][kRowV][4];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int i = 0; i < kRowV; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][i][e] = 0.f;
  const int r0 = blockIdx.x * kWideTileRows + kRowsPerWarp * warp;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = r0 + rr;
    if (row >= M) break;
    const size_t base = static_cast<size_t>(row) * D;
    float xv[kRowV][4], dv[kRowV][4];
#pragma unroll
    for (int i = 0; i < kRowV; ++i) {
      if (row_has(D, lane, i)) {
        const int c = 4 * (lane + 32 * i);
        load4(x + base + c, xv[i]);
        load4(dy + base + c, dv[i]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) xv[i][e] = dv[i][e] = 0.f;
      }
    }
    float mean, rstd;
    wide_row_stats(xv, D, mean, rstd);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < kRowV; ++i) {
      if (!row_has(D, lane, i)) continue;
      float gs[4];
      load4(ln1g + 4 * (lane + 32 * i), gs);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xv[i][e] = (xv[i][e] - mean) * rstd;             // xhat
        const float d = dv[i][e] * gs[e];
        m1 += d;
        m2 += d * xv[i][e];
      }
    }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
#pragma unroll
    for (int i = 0; i < kRowV; ++i) {
      if (!row_has(D, lane, i)) continue;
      const int c = 4 * (lane + 32 * i);
      float d1[4], gs[4], o[4];
      load4(dx1 + base + c, d1);
      load4(ln1g + c, gs);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[e] = d1[e] + rstd * (dv[i][e] * gs[e] - m1 - xv[i][e] * m2);
        acc[0][i][e] += dv[i][e] * xv[i][e];
        acc[1][i][e] += dv[i][e];
      }
      store4_bf16(dx + base + c, o[0], o[1], o[2], o[3]);
      if constexpr (kResidual) {
        const float4 bb = *reinterpret_cast<const float4*>(ln1b + c);
        store4_bf16(y_out + base + c, xv[i][0] * gs[0] + bb.x,
                    xv[i][1] * gs[1] + bb.y, xv[i][2] * gs[2] + bb.z,
                    xv[i][3] * gs[3] + bb.w);
      }
    }
  }
  store_row_sums<2>(acc, sW + warp * 2 * D, D, lane);
  __syncthreads();
  float* pt = part + static_cast<size_t>(blockIdx.x) * 2 * D;
  for (int i = threadIdx.x; i < 2 * D; i += 32 * kRowWarps) {
    const int k = i / D, c = i % D;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) s += sW[(w * 2 + k) * D + c];
    pt[i] = s;
  }
}

// ---- launches ---------------------------------------------------------------

// The backward's wide widths: the forward's.
inline bool bwd_wide_width(int D) { return wide_width(D); }

template <bool kResidual>
cudaError_t launch_mlp_grad_wide(const MlpGradArgs& a, cudaStream_t stream) {
  constexpr int BN = kMlpGradCols;
  constexpr size_t kSmem = GmPlan<BN, false>::kSmem > GmPlan<BN, true>::kSmem
                               ? GmPlan<BN, false>::kSmem
                               : GmPlan<BN, true>::kSmem;
  if (a.H % BN != 0 || a.D % kGmBK != 0) return cudaErrorInvalidValue;
  const auto kernel = mlp_grad_wide_kernel<kResidual>;
  cudaError_t e;
  if ((e = set_smem(kernel, kSmem)) != cudaSuccess) return e;
  kernel<<<dim3(a.H / BN, (a.M + kWideTileRows - 1) / kWideTileRows),
           kGmThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

// x1 is kept in dx1 (fp32, (M, D)), which ends holding dx1; dz is scratch
// (M, D) fp32; part has a row of 4D + H per 128-row tile. a1_in given: #4.
inline cudaError_t launch_mlp_bwd_wide(
    const bf16* x, const bf16* attn, const float* g, const bf16* wproj,
    const float* bproj, const float* ln2g, const float* ln2b,
    const bf16* w1, const float* b1, const bf16* w2, const bf16* a1_in,
    bf16* z, bf16* h1, bf16* gb, bf16* da1, float* dx1, bf16* dx1b, bf16* go,
    float* dz, float* part, int M, int D, int H, cudaStream_t stream) {
  if (!bwd_wide_width(D)) return cudaErrorInvalidValue;
  cudaError_t e = launch_proj_wide(x, attn, wproj, bproj, dx1, M, D, stream);
  if (e != cudaSuccess) return e;
  e = launch_ln_rows<float>(dx1, ln2g, ln2b, z, g, gb, M, D, stream);
  if (e != cudaSuccess) return e;
  MlpGradArgs m = {z, w1, gb, w2, a1_in, b1, h1, da1, part, M, D, H};
  e = a1_in != nullptr ? launch_mlp_grad_wide<true>(m, stream)
                       : launch_mlp_grad_wide<false>(m, stream);
  if (e != cudaSuccess) return e;
  GemmArgs d = {};
  d.a = da1; d.lda = H; d.b = w1; d.ldb = D;
  d.M = M; d.N = D; d.K = H; d.out = dz;
  e = launch_gemm<true, kEpiF32>(d, stream);
  if (e != cudaSuccess) return e;
  const auto rows = ln2_bwd_rows_kernel;
  const size_t smem = sizeof(float) * kRowWarps * 4 * D;
  if ((e = set_smem(rows, smem)) != cudaSuccess) return e;
  rows<<<(M + kWideTileRows - 1) / kWideTileRows, 32 * kRowWarps, smem,
         stream>>>(dx1, dz, g, ln2g, dx1b, part, M, D, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  GemmArgs o = {};
  o.a = dx1b; o.lda = D; o.b = wproj; o.ldb = D;
  o.M = M; o.N = D; o.K = D; o.out = go;
  return launch_gemm<true, kEpiRound>(o, stream);
}

// dy (scratch, (M, D) fp32) = dqkv . Wqkv, then the LN1 backward; y_out
// given: #4, which also stores the rounded LN1 output.
inline cudaError_t launch_qkv_bwd_wide(const bf16* x, const bf16* dqkv,
                                       const float* dx1, const float* ln1g,
                                       const float* ln1b, const bf16* wqkv,
                                       bf16* dx, bf16* y_out, float* dy,
                                       float* part, int M, int D,
                                       cudaStream_t stream) {
  if (!bwd_wide_width(D)) return cudaErrorInvalidValue;
  GemmArgs d = {};
  d.a = dqkv; d.lda = 3 * D; d.b = wqkv; d.ldb = D;
  d.M = M; d.N = D; d.K = 3 * D; d.out = dy;
  cudaError_t e = launch_gemm<true, kEpiF32>(d, stream);
  if (e != cudaSuccess) return e;
  const size_t smem = sizeof(float) * kRowWarps * 2 * D;
  const dim3 grid((M + kWideTileRows - 1) / kWideTileRows);
  if (y_out != nullptr) {
    const auto rows = ln1_bwd_rows_kernel<true>;
    if ((e = set_smem(rows, smem)) != cudaSuccess) return e;
    rows<<<grid, 32 * kRowWarps, smem, stream>>>(x, dy, dx1, ln1g, ln1b, dx,
                                                 y_out, part, M, D);
  } else {
    const auto rows = ln1_bwd_rows_kernel<false>;
    if ((e = set_smem(rows, smem)) != cudaSuccess) return e;
    rows<<<grid, 32 * kRowWarps, smem, stream>>>(x, dy, dx1, ln1g, ln1b, dx,
                                                 y_out, part, M, D);
  }
  return cudaGetLastError();
}

}  // namespace
