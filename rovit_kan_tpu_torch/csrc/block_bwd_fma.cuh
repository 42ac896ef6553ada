// The fp32 GEMM stages of the ViT-block backwards #2 and #4 on Hopper
// (sm_90a), for a model width D = 64 G (G of 1 to 5, every width the fp32
// route takes): mlp_bwd (proj recompute, LN2, the MLP backward, the LN2
// backward and the attention output's grad), qkv_bwd (dy = dqkv . Wqkv,
// the LN1 backward, dx) and the four weight grads dW = A^T . B over row
// splits. They replace the first design's 16-row stages on
// tile_common.cuh's block_gemm, whose 4 x 4 micro-tiles left most threads
// of a CTA idle at those row counts and whose CTAs each read every weight
// from L2. vit_block_bwd_f32.cu's note says what bounds the backward.
//
// Design, on fma_common.cuh's engine (register micro-tiles, float4 reads of
// k-contiguous or k-major padded tiles, a three-stage cp.async ring of
// 16-deep k-slices):
//   - mlp_bwd and qkv_bwd: 64 rows a CTA (197 CTAs at (64, 197)), 256
//     threads as a 16 x 16 grid (128 as 8 x 16 at G = 1), so every product
//     gives each thread at least 32 accumulators: the D-wide products (proj,
//     dz, dattn, dy) 4 rows x 4G columns, the hidden chunks 128 (64 at
//     G = 1) columns wide, 4 x 8. Both operands of a product stream
//     through the ring: the CTA's rows (attn, g, z, dx1, dqkv: [64][16]
//     slices from device memory, where a row tile this CTA wrote is read
//     back from L2) and the weight's slice ([n][16] of a weight used as
//     W^T, [16][n] of one used as W). A CTA reads each weight once per
//     product, a quarter of the first design's L2 traffic at four times the
//     rows. Shared memory at D = 192: the ring 3 x 20 KB, the chunk's da1
//     [64][132] 33 KB, 99 KB in all, two CTAs an SM.
//   - mlp_bwd: x1 = x + (attn . Wproj^T + bproj) in registers, LN2 over
//     the 16 threads of a row (shuffles, then the four warps through shared
//     memory), z and x1 out (x1 to dx1_out, which the thread that wrote it
//     reads back and overwrites with dx1). Per hidden chunk:
//     dh = g . W2[:, chunk] into the da1 tile, a1 = z . W1[chunk]^T + b1
//     (#2; #4 reads its saved a1), h1 = GELU(a1) and da1 = dh GELU'(a1)
//     (one erff), da1 over dh in the tile, then dz += da1 . W1[chunk] with
//     dz (64 x D) in registers over the chunks, so no (rows, H) tile
//     exists. The LN2 backward runs on dz's registers; dattn = dx1 . Wproj.
//   - qkv_bwd: dy = dqkv . Wqkv (3D deep) in registers, the LN1 statistics
//     again from x, the LN1 backward and dx; #4 also stores the LN1 output.
//   - wgrad: a 64 x D output tile of one of the four weight grads per CTA,
//     4 x 4G micro-tiles (8 x 4 at G = 1) from k-major slices of both
//     operands (32 rows of the product's depth each), over about seven row
//     splits at D = 192 (36 tiles x 7, 252 CTAs, two an SM), fp32 partials
//     7 x 1.77 MB.
// Rows past B*N are zero-filled by the ring's copies and masked in every
// store and column sum; a ragged last hidden chunk (H not a multiple of the
// chunk) is zero-filled and masked the same way. Every cross-row sum is a
// per-CTA fp32 partial: a thread's rows, then shuffles, then the warps in
// index order through shared memory, then block_bwd_common.cuh's ordered
// reduce. No atomics: a repeated call gives the same bits. fp32 has no
// rounding points: only the order of the sums differs from the plain
// version.

#pragma once

#include "block_bwd_common.cuh"
#include "fma_common.cuh"

namespace {

// The shape of mlp_bwd and qkv_bwd at D = 64 G.
template <int G>
struct FmaRowPlan {
  static constexpr int D = 64 * G;
  static constexpr int kThreads = G == 1 ? 128 : 256;
  static constexpr int kRows = 64;
  static constexpr int kChunk = kThreads / 2;      // hidden columns a step
  static constexpr int kTR = kThreads / 16;        // x 16 column threads
  static constexpr int kTM = kRows / kTR;          // rows a thread
  static constexpr int kTN = 4 * G;                // columns, D-wide products
  static constexpr int kTNC = kChunk / 16;         // columns, chunk products
  static constexpr int kBK = 16;                   // depth of a ring stage
  static constexpr int kLdK = kBK + 4;             // [n][16] slices
  static constexpr int kLdD = D + 4, kLdC = kChunk + 4;
  static constexpr int kWide = D > kChunk ? D : kChunk;
  static constexpr int kSliceA = kRows * kLdK;     // the rows' slice
  // A stage: the rows' slice and a weight slice, [kWide][16] (a [16][D + 4]
  // or [16][kChunk + 4] one is smaller).
  static constexpr int kStage = kSliceA + kWide * kLdK;
  static constexpr int kRing = kRingStages * kStage;
  static constexpr int kRed = kRows * 8;           // row sums [64][4][2]
  static constexpr int kCol = (kTR / 8) * kWide;   // column sums
  static constexpr size_t kSmemQkv = sizeof(float) * (kRing + kRed + kCol);
  // mlp_bwd adds the chunk's da1 tile and each row's LN2 mean and rstd.
  static constexpr size_t kSmemMlp =
      kSmemQkv + sizeof(float) * (kRows * kLdC + 2 * kRows);
  // mlp_bwd's and qkv_bwd's CTAs an SM, which caps their registers at 128
  // a thread: two up to D = 192, where ptxas's spills cost less than the
  // second CTA gains (timed on the card against one CTA an SM at 254
  // registers and no spills).
  static constexpr int kMinCtas = G <= 3 ? 2 : 1;
  using Grid = FmaGrid<kThreads, kTR>;
};

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ float4 ld4_if(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float4*>(p)
            : make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float f4_at(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

// Sums v[n][i], the thread's part of row tr + TR i of NV row sums, over the
// 16 column threads of the row: lanes ^8 and ^16, then the four warps
// along the row in order through red ([64][4][NV]). Every thread of the row
// ends with the sums; two __syncthreads.
template <class P, int NV>
__device__ __forceinline__ void fma_row_sums(float (&v)[NV][P::kTM],
                                             float* red) {
  const int tr = P::Grid::tr(), wn = P::Grid::wn();
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int i = 0; i < P::kTM; ++i) {
      v[n][i] += __shfl_xor_sync(0xffffffffu, v[n][i], 8);
      v[n][i] += __shfl_xor_sync(0xffffffffu, v[n][i], 16);
    }
  if ((threadIdx.x & 24) == 0) {
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int i = 0; i < P::kTM; ++i)
        red[((tr + P::kTR * i) * 4 + wn) * NV + n] = v[n][i];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int i = 0; i < P::kTM; ++i) {
      const float* p = red + (tr + P::kTR * i) * 4 * NV + n;
      v[n][i] = ((p[0] + p[NV]) + p[2 * NV]) + p[3 * NV];
    }
  __syncthreads();
}

// Column sums over the CTA's rows: v[j] is the thread's sum over its rows
// of column fma_col(tc, j); lanes ^1 ^2 ^4 (the eight rows of a warp),
// then the TR / 8 warps along the rows in order through red; columns below
// cvalid are written to dst. Two __syncthreads.
template <class P, int TN>
__device__ __forceinline__ void fma_col_sums(float (&v)[TN], float* red,
                                             float* dst, int cvalid) {
  constexpr int kWidth = 16 * TN;
  const int tc = P::Grid::tc(), wm = P::Grid::wm();
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    v[j] += __shfl_xor_sync(0xffffffffu, v[j], 1);
    v[j] += __shfl_xor_sync(0xffffffffu, v[j], 2);
    v[j] += __shfl_xor_sync(0xffffffffu, v[j], 4);
    if ((threadIdx.x & 7) == 0) red[wm * kWidth + fma_col<16>(tc, j)] = v[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cvalid; c += P::kThreads) {
    float s = red[c];
#pragma unroll
    for (int w = 1; w < P::kTR / 8; ++w) s += red[w * kWidth + c];
    dst[c] = s;
  }
  __syncthreads();
}

// acc = rows . W over D, the rows ([M][ld_rows], from row r0, `valid` of
// them) and W's slices through the ring: W^T ([D][D], kBKN false: the
// weight is [n][k]) or W ([depth][D], kBKN true). Depth K.
template <class P, bool kBKN, int K>
__device__ __forceinline__ void fma_rows_by_weight(
    float (&acc)[P::kTM][P::kTN], float* ring, const float* rows,
    int ld_rows, int valid, const float* w) {
  constexpr int BK = P::kBK, NT = P::kThreads, D = P::D;
  const int tr = P::Grid::tr(), tc = P::Grid::tc();
  fma_zero(acc);
  ring_run(
      ring, P::kStage, K / BK,
      [&](int i, float* st) {
        tile_async<64, BK, NT>(st, P::kLdK, rows + i * BK, ld_rows, valid,
                               BK);
        if constexpr (kBKN) {
          tile_async<BK, D, NT>(st + P::kSliceA, P::kLdD,
                                w + static_cast<size_t>(i) * BK * D, D, BK,
                                D);
        } else {
          tile_async<D, BK, NT>(st + P::kSliceA, P::kLdK, w + i * BK, K, D,
                                BK);
        }
      },
      [&](int, float* st) {
        fma_tile<P::kTR, 16, P::kTM, P::kTN, false, kBKN>(
            acc, st, P::kLdK, st + P::kSliceA, kBKN ? P::kLdD : P::kLdK,
            tr, tc, BK);
      });
}

// part: per CTA, [b2 (D) | b1 (H) | ln2 scale (D) | ln2 bias (D) |
// bproj (D)]. a1_in given: #4, which reads the saved a1 in place of
// z . W1^T + b1. x1 passes through dx1_out.
template <int G>
__global__ void __launch_bounds__(FmaRowPlan<G>::kThreads,
                                  FmaRowPlan<G>::kMinCtas)
mlp_bwd_fma_kernel(const float* __restrict__ x,
                   const float* __restrict__ attn,
                   const float* __restrict__ g,
                   const float* __restrict__ wproj,
                   const float* __restrict__ bproj,
                   const float* __restrict__ ln2g,
                   const float* __restrict__ ln2b,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2,
                   const float* __restrict__ a1_in, float* __restrict__ z_out,
                   float* __restrict__ h1_out, float* __restrict__ da1_out,
                   float* __restrict__ dx1_out, float* __restrict__ go_out,
                   float* __restrict__ part, int M, int H) {
  using P = FmaRowPlan<G>;
  constexpr int D = P::D, TR = P::kTR, TM = P::kTM, TN = P::kTN,
                TNC = P::kTNC, CW = P::kChunk, BK = P::kBK, NT = P::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* sRed = ring + P::kRing;
  float* sCol = sRed + P::kRed;
  float* sDA = sCol + P::kCol;                     // [64][kLdC]
  float* sStat = sDA + P::kRows * P::kLdC;         // [64][2]
  const int tr = P::Grid::tr(), tc = P::Grid::tc();
  const int r0 = blockIdx.x * P::kRows;
  const int valid = min(P::kRows, M - r0);
  const size_t row0 = static_cast<size_t>(r0) * D;
  float* pt = part + static_cast<size_t>(blockIdx.x) * (4 * D + H);
  const bool residual = a1_in != nullptr;

  for (int c = threadIdx.x; c < D; c += NT) {                // b2
    float s = 0.f;
    for (int r = 0; r < valid; ++r) {
      s += g[row0 + static_cast<size_t>(r) * D + c];
    }
    pt[c] = s;
  }

  // proj, and the first residual in fp32: x1 = x + (attn . Wproj^T + bproj).
  float acc[TM][TN];
  fma_rows_by_weight<P, false, D>(acc, ring, attn + row0, D, valid, wproj);
  float mu[1][TM], var[1][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tr + TR * i;
    const bool ok = r < valid;
    mu[0][i] = 0.f;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int c = fma_col<16>(tc, 4 * q);
      const float4 xv = ld4_if(x + row0 + r * D + c, ok);
      const float4 bv = *reinterpret_cast<const float4*>(bproj + c);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float& v = acc[i][4 * q + t];
        v = ok ? f4_at(xv, t) + (v + f4_at(bv, t)) : 0.f;
        mu[0][i] += v;
      }
    }
  }
  // LN2, two-pass statistics as the forward's (layernorm_stats).
  fma_row_sums<P, 1>(mu, sRed);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    mu[0][i] /= D;
    var[0][i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float d = acc[i][j] - mu[0][i];
      var[0][i] += d * d;
    }
  }
  fma_row_sums<P, 1>(var, sRed);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tr + TR * i;
    const float mean = mu[0][i];
    const float rstd = rsqrtf(var[0][i] / D + kLnEps);
    if (tc == 0) {
      sStat[2 * r] = mean;
      sStat[2 * r + 1] = rstd;
    }
    if (r >= valid) continue;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int c = fma_col<16>(tc, 4 * q);
      float zv[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        zv[t] = (acc[i][4 * q + t] - mean) * rstd * ln2g[c + t] + ln2b[c + t];
      }
      const size_t o = row0 + r * D + c;
      st4(z_out + o, zv[0], zv[1], zv[2], zv[3]);
      st4(dx1_out + o, acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
          acc[i][4 * q + 3]);
    }
  }
  // z_out is read back by the fc1 products below only after the first
  // ring_run's __syncthreads.

  // The MLP backward in hidden chunks of CW columns; dz = da1 . W1 stays in
  // registers.
  float dz[TM][TN];
  fma_zero(dz);
  const float* g_rows = g + row0;
  const float* z_rows = z_out + row0;
  for (int c0 = 0; c0 < H; c0 += CW) {
    const int cv = min(CW, H - c0);
    float ac[TM][TNC];
    // dh = g . W2[:, chunk], into the da1 tile.
    fma_zero(ac);
    ring_run(
        ring, P::kStage, D / BK,
        [&](int i, float* st) {
          tile_async<64, BK, NT>(st, P::kLdK, g_rows + i * BK, D, valid, BK);
          tile_async<BK, CW, NT>(st + P::kSliceA, P::kLdC,
                                 w2 + static_cast<size_t>(i) * BK * H + c0,
                                 H, BK, cv);
        },
        [&](int, float* st) {
          fma_tile<TR, 16, TM, TNC, false, true>(
            ac, st, P::kLdK, st + P::kSliceA, P::kLdC, tr, tc, BK);
        });
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < TNC / 4; ++q) {
        const int c = fma_col<16>(tc, 4 * q);
        st4(sDA + (tr + TR * i) * P::kLdC + c, ac[i][4 * q], ac[i][4 * q + 1],
            ac[i][4 * q + 2], ac[i][4 * q + 3]);
      }
    // a1 = z . W1[chunk]^T + b1 (#2).
    if (!residual) {
      fma_zero(ac);
      ring_run(
          ring, P::kStage, D / BK,
          [&](int i, float* st) {
            tile_async<64, BK, NT>(st, P::kLdK, z_rows + i * BK, D, valid,
                                   BK);
            tile_async<CW, BK, NT>(st + P::kSliceA, P::kLdK,
                                   w1 + static_cast<size_t>(c0) * D + i * BK,
                                   D, cv, BK);
          },
          [&](int, float* st) {
            fma_tile<TR, 16, TM, TNC, false, false>(
                ac, st, P::kLdK, st + P::kSliceA, P::kLdK, tr, tc, BK);
          });
    }
    // h1 = GELU(a1), da1 = dh * GELU'(a1); da1 over dh in the tile.
    float cs[TNC];
#pragma unroll
    for (int j = 0; j < TNC; ++j) cs[j] = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = tr + TR * i;
#pragma unroll
      for (int q = 0; q < TNC / 4; ++q) {
        const int c = fma_col<16>(tc, 4 * q);
        const bool ok = r < valid && c < cv;
        const size_t o = static_cast<size_t>(r0 + r) * H + c0 + c;
        float4 a;
        if (residual) {
          a = ld4_if(a1_in + o, ok);
        } else {
          const float4 bv = ld4_if(b1 + c0 + c, c < cv);
          a = make_float4(ac[i][4 * q] + bv.x, ac[i][4 * q + 1] + bv.y,
                          ac[i][4 * q + 2] + bv.z, ac[i][4 * q + 3] + bv.w);
        }
        float* da_p = sDA + r * P::kLdC + c;
        const float4 dh = *reinterpret_cast<const float4*>(da_p);
        float h[4], da[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 v = gelu_and_grad(f4_at(a, t));
          h[t] = v.x;
          da[t] = ok ? f4_at(dh, t) * v.y : 0.f;
          cs[4 * q + t] += da[t];
        }
        st4(da_p, da[0], da[1], da[2], da[3]);
        if (ok) {
          st4(h1_out + o, h[0], h[1], h[2], h[3]);
          st4(da1_out + o, da[0], da[1], da[2], da[3]);
        }
      }
    }
    fma_col_sums<P, TNC>(cs, sCol, pt + D + c0, cv);        // b1
    // dz += da1 . W1[chunk].
    ring_run(
        ring, P::kStage, cv / BK,
        [&](int i, float* st) {
          tile_async<BK, D, NT>(st, P::kLdD,
                                w1 + static_cast<size_t>(c0 + i * BK) * D, D,
                                BK, D);
        },
        [&](int i, float* st) {
          fma_tile<TR, 16, TM, TN, false, true>(
              dz, sDA + i * BK, P::kLdC, st, P::kLdD, tr, tc, BK);
        });
  }

  // LN2 backward on dz's registers: xhat2 from x1 (dx1_out) and the row
  // statistics; the scale and bias grads' partials; then
  // dx1 = g + rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat)),
  // dxh = dz * ln2 scale.
  float c1[TN], c2[TN], rs[2][TM];
#pragma unroll
  for (int j = 0; j < TN; ++j) c1[j] = c2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tr + TR * i;
    const bool ok = r < valid;
    const float mean = sStat[2 * r], rstd = sStat[2 * r + 1];
    rs[0][i] = rs[1][i] = 0.f;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int c = fma_col<16>(tc, 4 * q);
      const float4 x1 = ld4_if(dx1_out + row0 + r * D + c, ok);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float xh = ok ? (f4_at(x1, t) - mean) * rstd : 0.f;
        const float d = dz[i][4 * q + t];
        c1[4 * q + t] += d * xh;
        c2[4 * q + t] += d;
        const float dxh = d * ln2g[c + t];
        rs[0][i] += dxh;
        rs[1][i] += dxh * xh;
      }
    }
  }
  fma_col_sums<P, TN>(c1, sCol, pt + D + H, D);               // ln2 scale
  fma_col_sums<P, TN>(c2, sCol, pt + 2 * D + H, D);           // ln2 bias
  fma_row_sums<P, 2>(rs, sRed);
#pragma unroll
  for (int j = 0; j < TN; ++j) c1[j] = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tr + TR * i;
    const bool ok = r < valid;
    const float mean = sStat[2 * r], rstd = sStat[2 * r + 1];
    const float m1 = rs[0][i] / D, m2 = rs[1][i] / D;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int c = fma_col<16>(tc, 4 * q);
      const size_t o = row0 + r * D + c;
      const float4 x1 = ld4_if(dx1_out + o, ok);
      const float4 gv = ld4_if(g + o, ok);
      float v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float xh = (f4_at(x1, t) - mean) * rstd;
        const float dxh = dz[i][4 * q + t] * ln2g[c + t];
        v[t] = ok ? f4_at(gv, t) + rstd * (dxh - m1 - xh * m2) : 0.f;
        c1[4 * q + t] += v[t];
      }
      if (ok) st4(dx1_out + o, v[0], v[1], v[2], v[3]);
    }
  }
  fma_col_sums<P, TN>(c1, sCol, pt + 3 * D + H, D);           // bproj

  // dattn = dx1 . Wproj: the attention output's grad (dx1_out is complete
  // after fma_col_sums' __syncthreads).
  fma_rows_by_weight<P, true, D>(acc, ring, dx1_out + row0, D, valid, wproj);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tr + TR * i;
    if (r >= valid) continue;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      st4(go_out + row0 + r * D + fma_col<16>(tc, 4 * q), acc[i][4 * q],
          acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
    }
  }
}

// part: per CTA, [ln1 scale (D) | ln1 bias (D)]. y_out given: #4, which
// also stores the LN1 output for the qkv weight grad (#2 has it from its
// forward recompute).
template <int G>
__global__ void __launch_bounds__(FmaRowPlan<G>::kThreads,
                                  FmaRowPlan<G>::kMinCtas)
qkv_bwd_fma_kernel(const float* __restrict__ x,
                   const float* __restrict__ dqkv,
                   const float* __restrict__ dx1,
                   const float* __restrict__ ln1g,
                   const float* __restrict__ ln1b,
                   const float* __restrict__ wqkv, float* __restrict__ dx,
                   float* __restrict__ y_out, float* __restrict__ part,
                   int M) {
  using P = FmaRowPlan<G>;
  constexpr int D = P::D, TR = P::kTR, TM = P::kTM, TN = P::kTN;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* sRed = ring + P::kRing;
  float* sCol = sRed + P::kRed;
  const int tr = P::Grid::tr(), tc = P::Grid::tc();
  const int r0 = blockIdx.x * P::kRows;
  const int valid = min(P::kRows, M - r0);
  const size_t row0 = static_cast<size_t>(r0) * D;
  float* pt = part + static_cast<size_t>(blockIdx.x) * 2 * D;

  // dy = dqkv . Wqkv over the 3D depth.
  float dy[TM][TN];
  fma_rows_by_weight<P, true, 3 * D>(dy, ring,
                                     dqkv + static_cast<size_t>(r0) * 3 * D,
                                     3 * D, valid, wqkv);
  // The LN1 statistics again (two-pass, as layernorm_stats).
  float mu[1][TM], var[1][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tr + TR * i;
    mu[0][i] = 0.f;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const float4 xv =
          ld4_if(x + row0 + r * D + fma_col<16>(tc, 4 * q), r < valid);
      mu[0][i] += ((xv.x + xv.y) + xv.z) + xv.w;
    }
  }
  fma_row_sums<P, 1>(mu, sRed);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tr + TR * i;
    mu[0][i] /= D;
    var[0][i] = 0.f;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const float4 xv =
          ld4_if(x + row0 + r * D + fma_col<16>(tc, 4 * q), r < valid);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float d = f4_at(xv, t) - mu[0][i];
        var[0][i] += d * d;
      }
    }
  }
  fma_row_sums<P, 1>(var, sRed);
  float mean[TM], rstd[TM], rs[2][TM];
  float c1[TN], c2[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) c1[j] = c2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tr + TR * i;
    const bool ok = r < valid;
    mean[i] = mu[0][i];
    rstd[i] = rsqrtf(var[0][i] / D + kLnEps);
    rs[0][i] = rs[1][i] = 0.f;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int c = fma_col<16>(tc, 4 * q);
      const size_t o = row0 + r * D + c;
      const float4 xv = ld4_if(x + o, ok);
      float y[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float xh = ok ? (f4_at(xv, t) - mean[i]) * rstd[i] : 0.f;
        y[t] = xh * ln1g[c + t] + ln1b[c + t];
        const float d = dy[i][4 * q + t];
        c1[4 * q + t] += d * xh;
        c2[4 * q + t] += d;
        const float dyh = d * ln1g[c + t];
        rs[0][i] += dyh;
        rs[1][i] += dyh * xh;
      }
      if (y_out != nullptr && ok) st4(y_out + o, y[0], y[1], y[2], y[3]);
    }
  }
  fma_col_sums<P, TN>(c1, sCol, pt, D);                        // ln1 scale
  fma_col_sums<P, TN>(c2, sCol, pt + D, D);                    // ln1 bias
  fma_row_sums<P, 2>(rs, sRed);
  // dx = dx1 + rstd * (dyh - mean(dyh) - xhat * mean(dyh * xhat)),
  // dyh = dy * ln1 scale.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tr + TR * i;
    if (r >= valid) continue;
    const float m1 = rs[0][i] / D, m2 = rs[1][i] / D;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int c = fma_col<16>(tc, 4 * q);
      const size_t o = row0 + r * D + c;
      const float4 xv = *reinterpret_cast<const float4*>(x + o);
      const float4 dv = *reinterpret_cast<const float4*>(dx1 + o);
      float v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float xh = (f4_at(xv, t) - mean[i]) * rstd[i];
        const float dyh = dy[i][4 * q + t] * ln1g[c + t];
        v[t] = f4_at(dv, t) + rstd[i] * (dyh - m1 - xh * m2);
      }
      st4(dx + o, v[0], v[1], v[2], v[3]);
    }
  }
}

// ---- weight grads dW = A^T . B over row splits -----------------------------

// A 64 x D tile of one job's output per CTA, its depth (the rows of the
// split) in k-major slices of 32 rows of both operands.
template <int G>
struct FmaWgPlan {
  static constexpr int D = 64 * G;
  static constexpr int kThreads = G == 1 ? 128 : 256;
  static constexpr int kTR = kThreads / 16;
  static constexpr int kTM = 64 / kTR, kTN = 4 * G;
  static constexpr int kDepth = 32;
  static constexpr int kLdA = 64 + 4, kLdB = D + 4;
  static constexpr int kStage = kDepth * (kLdA + kLdB);
  static constexpr size_t kSmem = sizeof(float) * kRingStages * kStage;
  static constexpr int kCtas = 264;         // about two CTAs an SM
  using Grid = FmaGrid<kThreads, kTR>;
};

template <int G>
__global__ void __launch_bounds__(FmaWgPlan<G>::kThreads)
wgrad_fma_kernel(WgJobs jobs) {
  using P = FmaWgPlan<G>;
  constexpr int D = P::D, TM = P::kTM, TN = P::kTN, K = P::kDepth,
                NT = P::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  int j = 0;
  while (j + 1 < jobs.count && jobs.job[j + 1].tile_begin <= blockIdx.x) ++j;
  const WgJob J = jobs.job[j];
  const int local = blockIdx.x - J.tile_begin;
  const int tiles_in = J.n_in / D;
  const int to = local / tiles_in;
  const int ti = local - to * tiles_in;
  const int m_begin = blockIdx.y * jobs.rows_per_split;
  const int m_end = min(jobs.M, m_begin + jobs.rows_per_split);
  const float* A = static_cast<const float*>(J.a) + to * 64;
  const float* Bm = static_cast<const float*>(J.b) + ti * D;
  const int tr = P::Grid::tr(), tc = P::Grid::tc();

  float acc[TM][TN];
  fma_zero(acc);
  ring_run(
      ring, P::kStage, (m_end - m_begin + K - 1) / K,
      [&](int i, float* st) {
        const int m0 = m_begin + i * K;
        tile_async<K, 64, NT>(st, P::kLdA,
                              A + static_cast<size_t>(m0) * J.n_out, J.n_out,
                              m_end - m0, 64);
        tile_async<K, D, NT>(st + K * P::kLdA, P::kLdB,
                             Bm + static_cast<size_t>(m0) * J.n_in, J.n_in,
                             m_end - m0, D);
      },
      [&](int, float* st) {
        fma_tile<P::kTR, 16, TM, TN, true, true>(
            acc, st, P::kLdA, st + K * P::kLdA, P::kLdB, tr, tc, K);
      });
  float* out = J.part +
               static_cast<size_t>(blockIdx.y) * J.n_out * J.n_in +
               static_cast<size_t>(to) * 64 * J.n_in + ti * D;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      st4(out + static_cast<size_t>(fma_row<P::kTR, true>(tr, i)) * J.n_in +
              fma_col<16>(tc, 4 * q),
          acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
          acc[i][4 * q + 3]);
    }
}

// ---- launches --------------------------------------------------------------

// The widths the fp32 stages take: D = 64 G, G of 1 to 5, every width whose
// first-design stages fit in shared memory.
#define FMA_WIDTH_DISPATCH(D_VAR, CALL)                                     \
  switch (D_VAR) {                                                          \
    case 64: return CALL(1);                                                \
    case 128: return CALL(2);                                               \
    case 192: return CALL(3);                                               \
    case 256: return CALL(4);                                               \
    case 320: return CALL(5);                                               \
    default: return cudaErrorInvalidValue;                                  \
  }

inline bool bwd_fma_width_ok(int D) { return D % 64 == 0 && D <= 320; }

template <int G>
cudaError_t launch_mlp_bwd_fma_g(const float* x, const float* attn,
                                 const float* g, const float* wproj,
                                 const float* bproj, const float* ln2g,
                                 const float* ln2b, const float* w1,
                                 const float* b1, const float* w2,
                                 const float* a1_in, float* z, float* h1,
                                 float* da1, float* dx1, float* go,
                                 float* part, int M, int H,
                                 cudaStream_t stream) {
  using P = FmaRowPlan<G>;
  cudaError_t e;
  if ((e = set_smem(mlp_bwd_fma_kernel<G>, P::kSmemMlp)) != cudaSuccess) {
    return e;
  }
  mlp_bwd_fma_kernel<G><<<(M + P::kRows - 1) / P::kRows, P::kThreads,
                          P::kSmemMlp, stream>>>(
      x, attn, g, wproj, bproj, ln2g, ln2b, w1, b1, w2, a1_in, z, h1, da1,
      dx1, go, part, M, H);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_qkv_bwd_fma_g(const float* x, const float* dqkv,
                                 const float* dx1, const float* ln1g,
                                 const float* ln1b, const float* wqkv,
                                 float* dx, float* y_out, float* part, int M,
                                 cudaStream_t stream) {
  using P = FmaRowPlan<G>;
  cudaError_t e;
  if ((e = set_smem(qkv_bwd_fma_kernel<G>, P::kSmemQkv)) != cudaSuccess) {
    return e;
  }
  qkv_bwd_fma_kernel<G><<<(M + P::kRows - 1) / P::kRows, P::kThreads,
                          P::kSmemQkv, stream>>>(x, dqkv, dx1, ln1g, ln1b,
                                                 wqkv, dx, y_out, part, M);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_wgrad_fma_g(const WgJobs& jobs, int tiles, int splits,
                               cudaStream_t stream) {
  using P = FmaWgPlan<G>;
  cudaError_t e;
  if ((e = set_smem(wgrad_fma_kernel<G>, P::kSmem)) != cudaSuccess) return e;
  wgrad_fma_kernel<G><<<dim3(tiles, splits), P::kThreads, P::kSmem,
                        stream>>>(jobs);
  return cudaGetLastError();
}

// a1_in given: #4's instance, which reads the saved a1.
inline cudaError_t launch_mlp_bwd_fma(const float* x, const float* attn,
                                      const float* g, const float* wproj,
                                      const float* bproj, const float* ln2g,
                                      const float* ln2b, const float* w1,
                                      const float* b1, const float* w2,
                                      const float* a1_in, float* z,
                                      float* h1, float* da1, float* dx1,
                                      float* go, float* part, int M, int D,
                                      int H, cudaStream_t stream) {
#define MLP_BWD_FMA_CALL(GG)                                                \
  launch_mlp_bwd_fma_g<GG>(x, attn, g, wproj, bproj, ln2g, ln2b, w1, b1,    \
                           w2, a1_in, z, h1, da1, dx1, go, part, M, H,      \
                           stream)
  FMA_WIDTH_DISPATCH(D, MLP_BWD_FMA_CALL)
#undef MLP_BWD_FMA_CALL
}

// y_out given: #4's instance, which stores the LN1 output.
inline cudaError_t launch_qkv_bwd_fma(const float* x, const float* dqkv,
                                      const float* dx1, const float* ln1g,
                                      const float* ln1b, const float* wqkv,
                                      float* dx, float* y_out, float* part,
                                      int M, int D, cudaStream_t stream) {
#define QKV_BWD_FMA_CALL(GG)                                                \
  launch_qkv_bwd_fma_g<GG>(x, dqkv, dx1, ln1g, ln1b, wqkv, dx, y_out, part, \
                           M, stream)
  FMA_WIDTH_DISPATCH(D, QKV_BWD_FMA_CALL)
#undef QKV_BWD_FMA_CALL
}

inline cudaError_t launch_wgrad_fma(const WgJobs& jobs, int tiles,
                                    int splits, int D, cudaStream_t stream) {
#define WGRAD_FMA_CALL(GG) launch_wgrad_fma_g<GG>(jobs, tiles, splits, stream)
  FMA_WIDTH_DISPATCH(D, WGRAD_FMA_CALL)
#undef WGRAD_FMA_CALL
}

#undef FMA_WIDTH_DISPATCH

}  // namespace
