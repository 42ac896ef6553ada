// The bf16 GEMM stages of the ViT-block backwards #2 and #4 on Hopper
// (sm_90a), for a model width D of 64, 128 or 192: mlp_bwd (proj
// recompute, LN2, the MLP backward, the LN2 backward and the attention
// output's grad), qkv_bwd (dy = dqkv . Wqkv, the LN1 backward, dx) and the
// four weight grads dW = A^T . B over row splits. They replace the first
// design's WMMA stages; the fp32 route keeps its FMA stages
// (vit_block_bwd.cu, whose note says what bounds the backward).
//
// Design, with block_mma.cuh's machinery (mma.sync.m16n8k16 bf16 -> fp32,
// ldmatrix operands, two-stage cp.async rings of 64-column weight tiles, one
// __syncthreads per tile, epilogues on C fragments in registers):
//   - mlp_bwd: 6 pairs of warps, 16 rows a pair (96 rows, 132 CTAs at
//     (64, 197), one wave). The two warps of a pair share the rows' staging
//     tiles and split every product's output columns, so an SM holds twelve
//     warps where a warp per 16 rows gave six (which took 0.160 ms against
//     the pair's 0.130 on an H100 SXM at (64, 197, 192)). Per pair: x1 = x + (attn . Wproj^T + bproj) in fp32 (kept
//     in dx1_out, which each thread reads back and overwrites with its dx1),
//     LN2 statistics over quads and then over the pair, z and gb rounded into
//     staging tiles. Then per 64-wide hidden chunk j, two ring tiles: W2's
//     columns of the chunk ([D][64]) give dh = gb . W2[:, j]; W1's rows of
//     it ([64][D]) give a1 = z . W1[j]^T + b1 (#2; #4 reads its saved a1),
//     h1 = round(GELU(a1)) and da1 = dh * GELU'(a1) (one erff for both),
//     whose fp32 values feed b1's partial and whose rounding the pair
//     exchanges through shared memory for dz += da1b . W1[j] (the same tile
//     read through ldmatrix.trans). dz (16 x D / 2 fp32 a warp, 48 registers
//     at D = 192) stays in registers over the chunks, so the (rows, H) tiles
//     never reach shared memory; z and gb come from their staging tiles by
//     ldmatrix per product. The LN2 backward runs on dz's C fragments (quad
//     reductions, then the pair's), dx1 goes out in fp32 and rounded, and
//     dattn = dx1b . Wproj comes from Wproj's column tiles. Rows in and out
//     move as 16-byte vectors through the staging tiles. Shared memory at
//     D = 192: the ring 2 x 27 KB, per pair the z, gb and two chunk tiles
//     17 KB, 162 KB; ptxas: 168 registers, 76 bytes of spills.
//   - qkv_bwd: 4 warps (64 rows). Each ring stage holds 64 rows of Wqkv
//     ([64][D], the K = 3D dimension streamed in 64-deep chunks) and the
//     CTA's 64 rows of the same 64 dqkv columns; dy (16 x D) accumulates in
//     registers; the LN1 backward runs on its C fragments; x and (#4) the
//     rounded LN1 output pass through a per-warp staging tile. 93 KB at
//     D = 192, two CTAs an SM.
//   - wgrad: a 64 x D output tile of one of the four weight grads per CTA
//     of 8 warps (32 x D / 4 each), over one of seven row splits at
//     D = 192; the rows are the product's depth, streamed 64 at a time
//     through a two-stage cp.async ring of both operands' row-major tiles,
//     A^T's fragments by ldmatrix.trans. 36 tiles x 7 splits, 252 CTAs;
//     fp32 partials 7 x 1.77 MB. Each tile reads its operands' rows from L2
//     once, so wider tiles read less: on an H100 SXM at (64, 197, 192),
//     64 x 64 tiles over 4 splits took 0.077 ms, 64 x D tiles over 11
//     splits 0.068 and over 7 splits 0.057.
// Rounding points are the TPU kernel's (block_kernel.py:455-546): g, x1,
// dz, da1 and dx1 stay fp32 and are rounded once where the kernel casts
// (gb, h1, da1b, dx1b, dattn); a1 is fp32 in #2 and the saved bf16 in #4;
// every bias and LayerNorm grad sums fp32 values. Every cross-row sum is a
// per-CTA fp32 partial: shuffles inside a warp, then the warps in index
// order through shared memory, then vit_block_bwd.cu's ordered reduce. No
// atomics: a repeated call gives the same bits.

#pragma once

#include "block_bwd_common.cuh"
#include "block_mma.cuh"
#include "block_wide_mma.cuh"

namespace {

// mlp_bwd's pairs of warps (96 rows) and qkv_bwd's warps (64 rows) a CTA.
constexpr int kMlpBwdPairs = 6, kQkvBwdWarps = 4;

// A pair of warps per 16 rows: the two warps of pair q share the rows'
// staging tiles and split every product's output columns, warp h of the
// pair owning columns 32 h .. 32 h + 31 of each 64-column group (of D, and
// of a hidden chunk). At this row count a warp per 16 rows would leave
// only six warps an SM (M = 12,608 over 132 SMs); the pair gives twelve,
// and each warp's dz holds D / 2 columns (48 registers at D = 192).
template <int D, int P>
struct MlpBwdPlan {
  static constexpr int kThreads = 64 * P;
  static constexpr int kRows = 16 * P;
  static constexpr int kLdW = D + 8;            // [64][D] tiles, [16][D] rows
  static constexpr int kLdH = kGemmCols + 8;    // [D][64] tiles, [16][64] rows
  static constexpr int kStage = kGemmCols * kLdW > D * kLdH
                                    ? kGemmCols * kLdW : D * kLdH;
  // Per pair: the z (then dx1b) and gb tiles [16][D], and two [16][64]
  // chunk tiles (h1 and the attention output's grad; da1b).
  static constexpr int kPairT = 2 * 16 * kLdW + 2 * 16 * kLdH;
  static constexpr size_t kRing = 2 * sizeof(bf16) * kStage;
  // b1's warp partials [2][2 P][32], the row-sum exchange [P][4][2][16].
  static constexpr size_t kSmem = kRing + sizeof(bf16) * P * kPairT +
                                  sizeof(float) * (2 * 2 * P * 32 +
                                                   P * 4 * 2 * 16);
};

// Rows 8 half .. 8 half + 7 of a 16-row staging tile (row stride LD) in
// from global memory (row stride ldg) or out to it, NC bf16 each, as
// 16-byte vectors; rows from `valid` on are zero-filled in and skipped out.
// The trip count is a constant, so every load of a copy can be in flight
// at once.
template <int NC, int LD>
__device__ __forceinline__ void half_rows_in(bf16* stg, const bf16* src,
                                             long long ldg, int half,
                                             int valid, int lane) {
  constexpr int kVecs = NC / 8;
  static_assert(8 * kVecs % 32 == 0, "whole trips");
#pragma unroll
  for (int it = 0; it < 8 * kVecs / 32; ++it) {
    const int v = 32 * it + lane;
    const int r = 8 * half + v / kVecs, c = (v % kVecs) * 8;
    *reinterpret_cast<uint4*>(stg + r * LD + c) =
        r < valid ? *reinterpret_cast<const uint4*>(src + r * ldg + c)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}
template <int NC, int LD>
__device__ __forceinline__ void half_rows_out(bf16* dst, const bf16* stg,
                                              long long ldg, int half,
                                              int valid, int lane) {
  constexpr int kVecs = NC / 8;
#pragma unroll
  for (int it = 0; it < 8 * kVecs / 32; ++it) {
    const int v = 32 * it + lane;
    const int r = 8 * half + v / kVecs, c = (v % kVecs) * 8;
    if (r < valid) {
      *reinterpret_cast<uint4*>(dst + r * ldg + c) =
          *reinterpret_cast<const uint4*>(stg + r * LD + c);
    }
  }
}

// The two warps of pair q meet (named barrier q + 1; 0 is __syncthreads').
__device__ __forceinline__ void pair_sync(int q) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(q + 1) : "memory");
}

// acc[NB] += A . B over depth 16 KB: a_frag(kk, a) gives A's 16-deep block
// kk; B columns n0 .. n0 + 8 NB - 1 of a [n][k] tile (kKN false) or a
// [k][n] tile (kKN true, through ldmatrix.trans), row stride LD.
template <int LD, int KB, int NB, bool kKN, typename AFrag>
__device__ __forceinline__ void warp_mma_cols(float (&acc)[NB][4],
                                              AFrag a_frag,
                                              const bf16* tile, int n0,
                                              int lane) {
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
    uint32_t a[4];
    a_frag(kk, a);
#pragma unroll
    for (int p = 0; p < NB / 2; ++p) {
      uint32_t b[4];
      if constexpr (kKN) {
        ldsm_x4_t(b, bkn_addr<LD>(tile, 16 * kk, n0 + 16 * p, lane));
      } else {
        ldsm_x4(b, bnk_addr<LD>(tile, n0 + 16 * p, 16 * kk, lane));
      }
      mma_bf16(acc[2 * p], a, b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// The A fragments of a warp's 16 rows of a row-major tile in shared memory
// (row stride LD), one 16-deep block kk at a time by ldmatrix, as
// warp_mma_cols takes them, so the rows hold no registers between
// products.
template <int LD>
__device__ __forceinline__ auto smem_rows(const bf16* rows, int lane) {
  return [=](int kk, uint32_t (&a)[4]) {
    ldsm_x4(a, a_addr<LD>(rows, 0, 16 * kk, lane));
  };
}

// part: per CTA, [b2 (D) | b1 (H) | ln2 scale (D) | ln2 bias (D) |
// bproj (D)]. Tiles 0..G-1 (G = D / 64) are Wproj's rows; then for each
// hidden chunk j, W2's columns and W1's rows of it; then Wproj's columns.
template <int D, bool kResidual, int P>
__global__ void __launch_bounds__(64 * P)
mlp_bwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ attn,
                   const float* __restrict__ g, const bf16* __restrict__ wproj,
                   const float* __restrict__ bproj,
                   const float* __restrict__ ln2g,
                   const float* __restrict__ ln2b,
                   const bf16* __restrict__ w1, const float* __restrict__ b1,
                   const bf16* __restrict__ w2,
                   const bf16* __restrict__ a1_in, bf16* __restrict__ z_out,
                   bf16* __restrict__ h1_out, bf16* __restrict__ gb_out,
                   bf16* __restrict__ da1_out, float* __restrict__ dx1_out,
                   bf16* __restrict__ dx1b_out, bf16* __restrict__ go_out,
                   float* __restrict__ part, int M, int H) {
  using Pl = MlpBwdPlan<D, P>;
  constexpr int KB = D / 16, G = D / kGemmCols;
  constexpr int LW = Pl::kLdW, LH = Pl::kLdH;
  const int nh = H / kGemmCols;
  const int tiles = 2 * G + 2 * nh;
  const int h_tiles = G + 2 * nh;           // first of Wproj's column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* sT = reinterpret_cast<bf16*>(smem + Pl::kRing);
  float* sB1 = reinterpret_cast<float*>(sT + P * Pl::kPairT);   // [2][2P][32]
  float* sEx = sB1 + 2 * 2 * P * 32;                            // [P][4][2][16]
  auto stage = [&](int s) { return ring + (s & 1) * Pl::kStage; };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = warp >> 1, h = warp & 1;     // pair, column half
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * Pl::kRows + 16 * q;     // the pair's rows
  const int valid = min(16, M - row0);
  const bool ok[2] = {gq < valid, gq + 8 < valid};
  const int lr[2] = {gq, gq + 8};
  const size_t grow = static_cast<size_t>(row0);
  bf16* sZ = sT + q * Pl::kPairT;            // attn, then z, then dx1b
  bf16* sG = sZ + 16 * LW;                   // gb, then the partials
  bf16* sH = sG + 16 * LW;                   // h1, then dattn, a chunk
  bf16* sA = sH + 16 * LH;                   // da1b, a chunk
  float* ex = sEx + q * 4 * 2 * 16;          // [quantity][half h][row]
  float* pt = part + static_cast<size_t>(blockIdx.x) * (4 * D + H);
  const int cown = 32 * h;                   // own columns of a 64 group

  auto load_w = [&](int s) {
    if (s < G) {
      load_tile_async<D, LW, Pl::kThreads>(
          stage(s), wproj + static_cast<size_t>(s) * kGemmCols * D, D,
          kGemmCols, kGemmCols);
    } else if (s < h_tiles) {
      const int j = (s - G) >> 1;
      if (((s - G) & 1) == 0) {
        load_tile_async<kGemmCols, LH, Pl::kThreads>(
            stage(s), w2 + j * kGemmCols, H, D, D);
      } else {
        load_tile_async<D, LW, Pl::kThreads>(
            stage(s), w1 + static_cast<size_t>(j) * kGemmCols * D, D,
            kGemmCols, kGemmCols);
      }
    } else {
      load_tile_async<kGemmCols, LH, Pl::kThreads>(
          stage(s), wproj + (s - h_tiles) * kGemmCols, D, D, D);
    }
    cp_async_commit();
  };
  auto step = [&](int s) {
    cp_async_wait_all();
    __syncthreads();           // tile s landed; tile s - 1's stage is free
    if (s + 1 < tiles) load_w(s + 1);
  };
  // The pair's row sums of quantity k: this warp's quad sums v[half] in,
  // the two warps' sums added in warp order out.
  auto row_total = [&](int k, float (&v)[2]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) v[half] = quad_sum(v[half]);
    if (t == 0) {
      ex[(k * 2 + h) * 16 + gq] = v[0];
      ex[(k * 2 + h) * 16 + gq + 8] = v[1];
    }
    pair_sync(q);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      v[half] = ex[k * 32 + lr[half]] + ex[k * 32 + 16 + lr[half]];
    }
  };
  // b1's CTA partial of chunk j: for each column its owning warps' sums,
  // pairs in order.
  auto flush_b1 = [&](int j) {
    const float* src = sB1 + (j & 1) * 2 * P * 32;
    for (int c = threadIdx.x; c < kGemmCols; c += Pl::kThreads) {
      const int hc = c >> 5;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < P; ++w) s += src[(2 * w + hc) * 32 + (c & 31)];
      pt[D + j * kGemmCols + c] = s;
    }
  };

  // Tile 0 in flight while the rows come in; g rounded into sG.
  load_w(0);
  half_rows_in<D, LW>(sZ, attn + grow * D, D, h, valid, lane);
  constexpr int kVec4 = D / 4;
#pragma unroll
  for (int it = 0; it < 8 * kVec4 / 32; ++it) {
    const int v = 32 * it + lane;
    const int r = 8 * h + v / kVec4, c = (v % kVec4) * 4;
    const float4 f =
        r < valid ? *reinterpret_cast<const float4*>(g + (grow + r) * D + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<uint2*>(sG + r * LW + c) =
        make_uint2(pack_bf16(f.x, f.y), pack_bf16(f.z, f.w));
  }
  pair_sync(q);
  half_rows_out<D, LW>(gb_out + grow * D, sG, D, h, valid, lane);

  // proj on the own columns: x1 = x + (attn . Wproj^T + bproj) in fp32,
  // kept in registers through LN2 and stored to dx1_out, which the LN2
  // backward reads back and overwrites with dx1.
  float x1[G][4][4];
  {
    uint32_t aa[KB][4];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      ldsm_x4(aa[kk], a_addr<LW>(sZ, 0, 16 * kk, lane));
    }
    auto from_regs = [&](int kk, uint32_t (&a)[4]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = aa[kk][i];
    };
#pragma unroll
    for (int s = 0; s < G; ++s) {
      step(s);
      zero_acc<4>(x1[s]);
      warp_mma_cols<LW, KB, 4, false>(x1[s], from_regs, stage(s), cown,
                                      lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = s * kGemmCols + cown + 8 * j + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(bproj + c);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 xv =
              ok[half] ? u32_to_f2(load_u32(x + (grow + lr[half]) * D + c))
                       : make_float2(0.f, 0.f);
          float* e = x1[s][j] + 2 * half;
          e[0] = xv.x + (e[0] + bb.x);
          e[1] = xv.y + (e[1] + bb.y);
          if (ok[half]) {
            *reinterpret_cast<float2*>(dx1_out + (grow + lr[half]) * D + c) =
                make_float2(e[0], e[1]);
          }
        }
      }
    }
  }

  // LN2 statistics over the pair's two halves, two-pass; z rounded into sZ
  // over attn (every warp's proj fragments were loaded before step 0).
  float mean[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f};
#pragma unroll
  for (int s = 0; s < G; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mean[e >> 1] += x1[s][j][e];
  row_total(0, mean);
#pragma unroll
  for (int half = 0; half < 2; ++half) mean[half] /= D;
#pragma unroll
  for (int s = 0; s < G; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = x1[s][j][e] - mean[e >> 1];
        rstd[e >> 1] += d * d;
      }
  row_total(1, rstd);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    rstd[half] = rsqrtf(rstd[half] / D + kLnEps);
  }
#pragma unroll
  for (int s = 0; s < G; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = s * kGemmCols + cown + 8 * j + 2 * t;
      const float2 gg = *reinterpret_cast<const float2*>(ln2g + c);
      const float2 bb = *reinterpret_cast<const float2*>(ln2b + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* e = x1[s][j] + 2 * half;
        u32_at(sZ + lr[half] * LW + c) = pack_bf16(
            (e[0] - mean[half]) * rstd[half] * gg.x + bb.x,
            (e[1] - mean[half]) * rstd[half] * gg.y + bb.y);
      }
    }
  }
  pair_sync(q);
  half_rows_out<D, LW>(z_out + grow * D, sZ, D, h, valid, lane);

  // The MLP backward chunk by chunk of the hidden dimension.
  float dz[G][4][4];
#pragma unroll
  for (int s = 0; s < G; ++s) zero_acc<4>(dz[s]);
  for (int j = 0; j < nh; ++j) {
    const int s = G + 2 * j;
    const size_t hcol = static_cast<size_t>(j) * kGemmCols;
    step(s);                                   // W2's columns of chunk j
    if (j > 0) flush_b1(j - 1);
    float dh[4][4];
    zero_acc<4>(dh);
    warp_mma_cols<LH, KB, 4, true>(dh, smem_rows<LW>(sG, lane), stage(s), cown,
                                   lane);
    step(s + 1);                               // W1's rows of chunk j
    float a[4][4];
    if constexpr (kResidual) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 v =
              ok[half] ? u32_to_f2(load_u32(a1_in + (grow + lr[half]) * H +
                                            hcol + cown + 8 * jj + 2 * t))
                       : make_float2(0.f, 0.f);
          a[jj][2 * half] = v.x;
          a[jj][2 * half + 1] = v.y;
        }
      }
    } else {
      zero_acc<4>(a);
      warp_mma_cols<LW, KB, 4, false>(a, smem_rows<LW>(sZ, lane), stage(s + 1),
                                      cown, lane);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float2 bb = *reinterpret_cast<const float2*>(
            b1 + hcol + cown + 8 * jj + 2 * t);
        a[jj][0] += bb.x;
        a[jj][1] += bb.y;
        a[jj][2] += bb.x;
        a[jj][3] += bb.y;
      }
    }
    // h1 = round(GELU(a1)) into sH; da1 = dh * GELU'(a1) in fp32 (b1's
    // partial), rounded into sA.
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = cown + 8 * jj + 2 * t;
        const float2 v0 = gelu_and_grad(a[jj][2 * half]);
        const float2 v1 = gelu_and_grad(a[jj][2 * half + 1]);
        u32_at(sH + lr[half] * LH + c) = pack_bf16(v0.x, v1.x);
        dh[jj][2 * half] = ok[half] ? dh[jj][2 * half] * v0.y : 0.f;
        dh[jj][2 * half + 1] = ok[half] ? dh[jj][2 * half + 1] * v1.y : 0.f;
        u32_at(sA + lr[half] * LH + c) =
            pack_bf16(dh[jj][2 * half], dh[jj][2 * half + 1]);
      }
    }
    warp_col_partial<4>(dh, ok, sB1 + ((j & 1) * 2 * P + warp) * 32, lane);
    pair_sync(q);
    half_rows_out<kGemmCols, LH>(h1_out + grow * H + hcol, sH, H, h, valid,
                                 lane);
    half_rows_out<kGemmCols, LH>(da1_out + grow * H + hcol, sA, H, h, valid,
                                 lane);
    // dz += da1b . W1[chunk j, :] on the own columns, W1's tile read as
    // [k][n].
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) smem_rows<LH>(sA, lane)(kk, da[kk]);
    auto da_frag = [&](int kk, uint32_t (&f)[4]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = da[kk][i];
    };
#pragma unroll
    for (int g2 = 0; g2 < G; ++g2) {
      warp_mma_cols<LW, 4, 4, true>(dz[g2], da_frag, stage(s + 1),
                                    g2 * kGemmCols + cown, lane);
    }
  }

  // LN2 backward on dz's fragments: dxh = dz * ln2 scale,
  // dx1 = g + rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat)), the
  // means over the pair's two halves; x1 read back from dx1_out.
  float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
  for (int s = 0; s < G; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = s * kGemmCols + cown + 8 * j + 2 * t;
      const float2 gg = *reinterpret_cast<const float2*>(ln2g + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 v =
            ok[half] ? *reinterpret_cast<const float2*>(
                           dx1_out + (grow + lr[half]) * D + c)
                     : make_float2(0.f, 0.f);
        x1[s][j][2 * half] = (v.x - mean[half]) * rstd[half];     // xhat
        x1[s][j][2 * half + 1] = (v.y - mean[half]) * rstd[half];
        const float d0 = dz[s][j][2 * half] * gg.x;
        const float d1 = dz[s][j][2 * half + 1] * gg.y;
        m1[half] += d0;
        m1[half] += d1;
        m2[half] += d0 * x1[s][j][2 * half];
        m2[half] += d1 * x1[s][j][2 * half + 1];
      }
    }
  }
  row_total(2, m1);
  row_total(3, m2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    m1[half] /= D;
    m2[half] /= D;
  }
  // dx1 (fp32 out, rounded into sZ over z, which every warp of the pair is
  // done with since the row sums met); this warp's partials
  // [b2 | ln2 scale | ln2 bias | bproj] over its own D / 2 columns into sG.
  float* wp = reinterpret_cast<float*>(sG) + h * 4 * (D / 2);
#pragma unroll
  for (int s = 0; s < G; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = s * kGemmCols + cown + 8 * j + 2 * t;
      const int lc = s * 32 + 8 * j + 2 * t;               // own column
      const float2 gg = *reinterpret_cast<const float2*>(ln2g + c);
      float qv[4][2][2];                  // quantity, half, column
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 gv =
            ok[half] ? *reinterpret_cast<const float2*>(
                           g + (grow + lr[half]) * D + c)
                     : make_float2(0.f, 0.f);
        const float gw[2] = {gv.x, gv.y};
        const float gs[2] = {gg.x, gg.y};
        float d1[2];
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const float dzv = dz[s][j][2 * half + w];
          const float xh = x1[s][j][2 * half + w];
          d1[w] = ok[half] ? gw[w] + rstd[half] * (dzv * gs[w] - m1[half] -
                                                   xh * m2[half])
                           : 0.f;
          qv[0][half][w] = gw[w];
          qv[1][half][w] = ok[half] ? dzv * xh : 0.f;
          qv[2][half][w] = ok[half] ? dzv : 0.f;
          qv[3][half][w] = d1[w];
        }
        if (ok[half]) {
          *reinterpret_cast<float2*>(dx1_out + (grow + lr[half]) * D + c) =
              make_float2(d1[0], d1[1]);
        }
        u32_at(sZ + lr[half] * LW + c) = pack_bf16(d1[0], d1[1]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const float v = column_sum8(qv[k][0][w] + qv[k][1][w]);
          if (lane < 4) wp[k * (D / 2) + lc + w] = v;
        }
      }
    }
  }
  pair_sync(q);
  half_rows_out<D, LW>(dx1b_out + grow * D, sZ, D, h, valid, lane);

  // dattn = dx1b . Wproj over Wproj's column tiles, own columns, rounded.
  for (int n = 0; n < G; ++n) {
    const int s = h_tiles + n;
    step(s);
    if (n == 0) {
      // Every warp's partials are in: b1's last chunk, then the others,
      // pairs in order, each column from the warp that owns it.
      flush_b1(nh - 1);
      const int off[4] = {0, D + H, 2 * D + H, 3 * D + H};
      for (int i = threadIdx.x; i < 4 * D; i += Pl::kThreads) {
        const int k = i / D, c = i % D;
        const int hc = (c >> 5) & 1;
        const int lc = (c >> 6) * 32 + (c & 31);
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < P; ++w) {
          sum += reinterpret_cast<const float*>(
              sT + w * Pl::kPairT + 16 * LW)[hc * 4 * (D / 2) +
                                             k * (D / 2) + lc];
        }
        pt[off[k] + c] = sum;
      }
    }
    float acc[4][4];
    zero_acc<4>(acc);
    warp_mma_cols<LH, KB, 4, true>(acc, smem_rows<LW>(sZ, lane), stage(s), cown,
                                   lane);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        u32_at(sH + lr[half] * LH + cown + 8 * jj + 2 * t) =
            pack_bf16(acc[jj][2 * half], acc[jj][2 * half + 1]);
      }
    }
    pair_sync(q);
    half_rows_out<kGemmCols, LH>(go_out + grow * D + n * kGemmCols, sH, D,
                                 h, valid, lane);
  }
}

// ---- qkv and LN1 backward ---------------------------------------------------

template <int D, int W>
struct QkvBwdPlan {
  static constexpr int kThreads = 32 * W;
  static constexpr int kRows = 16 * W;
  static constexpr int kLdW = D + 8;            // [64][D] Wqkv rows, x rows
  static constexpr int kLdQ = kGemmCols + 8;    // [rows][64] dqkv columns
  static constexpr int kStage = kGemmCols * kLdW + kRows * kLdQ;
  static constexpr size_t kSmem =
      sizeof(bf16) * (2 * kStage + W * 16 * kLdW);
  // After the products the ring holds each warp's dx staging tile, then the
  // warps' [ln1 scale | ln1 bias] partials.
  static_assert(sizeof(bf16) * W * 16 * kLdW + sizeof(float) * W * 2 * D <=
                    sizeof(bf16) * 2 * kStage,
                "epilogue scratch exceeds the ring");
};

// part: per CTA, [ln1 scale (D) | ln1 bias (D)]. kResidual (#4): also store
// the LN1 output, rounded, to y_out for the qkv weight grad.
template <int D, bool kResidual, int W>
__global__ void __launch_bounds__(32 * W)
qkv_bwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dqkv,
                   const float* __restrict__ dx1,
                   const float* __restrict__ ln1g,
                   const float* __restrict__ ln1b,
                   const bf16* __restrict__ wqkv, bf16* __restrict__ dx,
                   bf16* __restrict__ y_out, float* __restrict__ part,
                   int M) {
  using P = QkvBwdPlan<D, W>;
  constexpr int NB = D / 8, LW = P::kLdW, LQ = P::kLdQ;
  constexpr int kTiles = 3 * D / kGemmCols;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  auto stage = [&](int s) { return ring + (s & 1) * P::kStage; };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * P::kRows;
  const int row0 = r0 + 16 * warp;
  const int valid = min(16, M - row0);
  const bool ok[2] = {gq < valid, gq + 8 < valid};
  const int lr[2] = {gq, gq + 8};
  const size_t grow = static_cast<size_t>(row0);
  bf16* sXw = ring + 2 * P::kStage + warp * 16 * LW;
  auto load_w = [&](int s) {
    bf16* st = stage(s);
    load_tile_async<D, LW, P::kThreads>(
        st, wqkv + static_cast<size_t>(s) * kGemmCols * D, D, kGemmCols,
        kGemmCols);
    load_tile_async<kGemmCols, LQ, P::kThreads>(
        st + kGemmCols * LW,
        dqkv + static_cast<size_t>(r0) * 3 * D + s * kGemmCols, 3 * D,
        P::kRows, M - r0);
    cp_async_commit();
  };

  load_w(0);
  warp_rows_in<D, LW>(sXw, x + grow * D, D, valid, lane);

  // dy = dqkv . Wqkv, 64 deep at a time.
  float dy[NB][4];
  zero_acc<NB>(dy);
  for (int s = 0; s < kTiles; ++s) {
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < kTiles) load_w(s + 1);
    warp_mma_cols<LW, 4, NB, true>(
        dy, smem_rows<LQ>(stage(s) + kGemmCols * LW + 16 * warp * LQ, lane),
        stage(s), 0, lane);
  }
  __syncwarp();

  // LN1 statistics again, as the forward's.
  auto x_at = [&](int half, int j) {
    return u32_to_f2(u32_at(sXw + lr[half] * LW + 8 * j + 2 * t));
  };
  float mean[2], rstd[2];
  layernorm_stats<D>(x_at, mean, rstd);
  float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 gg = *reinterpret_cast<const float2*>(ln1g + c);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 v = x_at(half, j);
      const float d0 = dy[j][2 * half] * gg.x;
      const float d1 = dy[j][2 * half + 1] * gg.y;
      m1[half] += d0;
      m1[half] += d1;
      m2[half] += d0 * ((v.x - mean[half]) * rstd[half]);
      m2[half] += d1 * ((v.y - mean[half]) * rstd[half]);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    m1[half] = quad_sum(m1[half]) / D;
    m2[half] = quad_sum(m2[half]) / D;
  }
  __syncthreads();                  // every warp is done with the ring
  bf16* sD = ring + warp * 16 * LW;
  float* sP = reinterpret_cast<float*>(ring + W * 16 * LW);   // [W][2D]
  // dx = dx1 + rstd * (dyh - mean(dyh) - xhat * mean(dyh * xhat)),
  // dyh = dy * ln1 scale; (#4) y = xhat * ln1 scale + ln1 bias over x.
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 gg = *reinterpret_cast<const float2*>(ln1g + c);
    const float2 bb = *reinterpret_cast<const float2*>(ln1b + c);
    float q[2][2][2];                     // quantity, half, column
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 v = x_at(half, j);
      const float2 d1v =
          ok[half] ? *reinterpret_cast<const float2*>(
                         dx1 + (grow + lr[half]) * D + c)
                   : make_float2(0.f, 0.f);
      const float xh[2] = {(v.x - mean[half]) * rstd[half],
                           (v.y - mean[half]) * rstd[half]};
      const float gs[2] = {gg.x, gg.y};
      const float d1[2] = {d1v.x, d1v.y};
      float o[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const float dyv = dy[j][2 * half + w];
        const float dyh = dyv * gs[w];
        o[w] = d1[w] + rstd[half] * (dyh - m1[half] - xh[w] * m2[half]);
        q[0][half][w] = ok[half] ? dyv * xh[w] : 0.f;
        q[1][half][w] = ok[half] ? dyv : 0.f;
      }
      u32_at(sD + lr[half] * LW + c) = pack_bf16(o[0], o[1]);
      if constexpr (kResidual) {
        u32_at(sXw + lr[half] * LW + c) =
            pack_bf16(xh[0] * gg.x + bb.x, xh[1] * gg.y + bb.y);
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const float s = column_sum8(q[k][0][w] + q[k][1][w]);
        if (lane < 4) sP[(warp * 2 + k) * D + c + w] = s;
      }
    }
  }
  __syncwarp();
  warp_rows_out<D, LW>(dx + grow * D, sD, D, valid, lane);
  if constexpr (kResidual) {
    warp_rows_out<D, LW>(y_out + grow * D, sXw, D, valid, lane);
  }
  __syncthreads();
  float* pt = part + static_cast<size_t>(blockIdx.x) * 2 * D;
  for (int i = threadIdx.x; i < 2 * D; i += P::kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) s += sP[w * 2 * D + i];
    pt[i] = s;
  }
}

// ---- weight grads dW = A^T . B over row splits ------------------------------

constexpr int kWgTile = 64;       // output rows of a tile (fp32: square)
constexpr int kWgDepth = 64;      // rows per ring stage
constexpr int kWgThreads = 256;   // 8 warps: 2 x 4, 32 x D / 4 outputs each
constexpr int kWgCtas = 252;      // seven splits of 36 tiles at D = 192
// At D = 384 (72 tiles): 32-deep stages, 58 KB where 64-deep ones took
// 116 KB, so two CTAs fit an SM, and row splits to at most 264 CTAs (two
// an SM on 132 SMs): three splits, one wave. On an H100 SXM this was the
// fastest of 32- and 64-deep stages over 2 to 11 splits.
constexpr int kWgWideDepth = 32;
constexpr int kWgWideCtas = 264;

// kDepth: rows per ring stage (kWgDepth but where a width's launch picks
// another).
template <int D, int kDepth = kWgDepth>
struct WgPlan {
  static constexpr int kLdA = kWgTile + 8;
  static constexpr int kLdB = D + 8;
  static constexpr int kStage = kDepth * (kLdA + kLdB);
  static constexpr size_t kSmem = 2 * sizeof(bf16) * kStage;
};

// One 64 x D output tile of a weight grad (rows `to` of n_out, columns
// `ti` of n_in in steps of D) over one row split. A tile as wide as the
// model reads each row of the A operand's 64 columns and the B operand's D
// columns once for 64 x D outputs: at D = 192 the four grads' 36 tiles read
// 232 MB from L2 where 64 x 64 tiles read 348 MB.
template <int D, int kDepth = kWgDepth>
__global__ void __launch_bounds__(kWgThreads) wgrad_mma_kernel(WgJobs jobs) {
  using P = WgPlan<D, kDepth>;
  constexpr int NB = D / 32;                 // 8-column blocks per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  auto sA = [&](int s) { return ring + (s & 1) * P::kStage; };
  auto sB = [&](int s) { return sA(s) + kDepth * P::kLdA; };
  int jb = 0;
  while (jb + 1 < jobs.count && jobs.job[jb + 1].tile_begin <= blockIdx.x) {
    ++jb;
  }
  const WgJob J = jobs.job[jb];
  const int local = blockIdx.x - J.tile_begin;
  const int tiles_in = J.n_in / D;
  const int to = local / tiles_in;
  const int ti = local - to * tiles_in;
  const int m_begin = blockIdx.y * jobs.rows_per_split;
  const int m_end = min(jobs.M, m_begin + jobs.rows_per_split);
  const int steps = (m_end - m_begin + kDepth - 1) / kDepth;
  const bf16* A = static_cast<const bf16*>(J.a) + to * kWgTile;
  const bf16* Bm = static_cast<const bf16*>(J.b) + ti * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int wo = (warp >> 2) * 32, wi = (warp & 3) * (D / 4);
  auto load = [&](int s) {
    const int m0 = m_begin + s * kDepth;
    const int rows = min(kDepth, m_end - m0);
    load_tile_async<kWgTile, P::kLdA, kWgThreads>(
        sA(s), A + static_cast<size_t>(m0) * J.n_out, J.n_out, kDepth,
        rows);
    load_tile_async<D, P::kLdB, kWgThreads>(
        sB(s), Bm + static_cast<size_t>(m0) * J.n_in, J.n_in, kDepth,
        rows);
    cp_async_commit();
  };

  float acc[2][NB][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) zero_acc<NB>(acc[i]);
  if (steps > 0) load(0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();           // step s landed; step s - 1's stage is free
    if (s + 1 < steps) load(s + 1);
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldsm_x4_t(a[i], akm_addr<P::kLdA>(sA(s), 16 * kk, wo + 16 * i, lane));
      }
#pragma unroll
      for (int p = 0; p < NB / 2; ++p) {
        uint32_t b[4];
        ldsm_x4_t(b, bkn_addr<P::kLdB>(sB(s), 16 * kk, wi + 16 * p, lane));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * p], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  float* out = J.part +
               static_cast<size_t>(blockIdx.y) * J.n_out * J.n_in +
               static_cast<size_t>(to) * kWgTile * J.n_in + ti * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wo + 16 * i + gq + 8 * half;
        const int c = wi + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * J.n_in +
                                   c) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
  }
}

// ---- launches ---------------------------------------------------------------

// The widths the bf16 backward takes: these stages at 64, 128 and 192,
// block_wide_bwd_mma.cuh's past 192 up to 768 (with this file's wgrad);
// any other returns cudaErrorInvalidValue before any launch.
inline bool bwd_mma_width_ok(int D) {
  return D == 64 || D == 128 || D == 192 || wide_width(D);
}

// The columns of the weight grads' output tiles at width D: D up to 192 and
// at 384, else 128 where it divides D and 64 elsewhere. At (64, 197, 384)
// on an H100 64 x 128 tiles (216 in one row split) took #4 1-3% and #2
// about 1% longer than 64 x 384 tiles (72 over three splits), so 384 keeps
// its instance. A 64 x D tile at D = 768 would take about 232 KB of shared
// memory, over the 227 KB a block can have; the narrower tiles keep each
// CTA's sum over its row split, so the partials and their ordered reduce
// are as before.
inline int wgrad_cols(int D) {
  if (D <= 192 || D == 384) return D;
  return D % 128 == 0 ? 128 : 64;
}

template <int D, bool kResidual>
cudaError_t launch_mlp_bwd_mma_d(const bf16* x, const bf16* attn,
                                 const float* g, const bf16* wproj,
                                 const float* bproj, const float* ln2g,
                                 const float* ln2b, const bf16* w1,
                                 const float* b1, const bf16* w2,
                                 const bf16* a1_in, bf16* z, bf16* h1,
                                 bf16* gb, bf16* da1, float* dx1, bf16* dx1b,
                                 bf16* go, float* part, int M, int H,
                                 cudaStream_t stream) {
  using P = MlpBwdPlan<D, kMlpBwdPairs>;
  const auto kernel = mlp_bwd_mma_kernel<D, kResidual, kMlpBwdPairs>;
  cudaError_t e;
  if ((e = set_smem(kernel, P::kSmem)) != cudaSuccess) return e;
  kernel<<<(M + P::kRows - 1) / P::kRows, P::kThreads, P::kSmem, stream>>>(
      x, attn, g, wproj, bproj, ln2g, ln2b, w1, b1, w2, a1_in, z, h1, gb, da1,
      dx1, dx1b, go, part, M, H);
  return cudaGetLastError();
}

template <int D, bool kResidual>
cudaError_t launch_qkv_bwd_mma_d(const bf16* x, const bf16* dqkv,
                                 const float* dx1, const float* ln1g,
                                 const float* ln1b, const bf16* wqkv,
                                 bf16* dx, bf16* y_out, float* part, int M,
                                 cudaStream_t stream) {
  using P = QkvBwdPlan<D, kQkvBwdWarps>;
  const auto kernel = qkv_bwd_mma_kernel<D, kResidual, kQkvBwdWarps>;
  cudaError_t e;
  if ((e = set_smem(kernel, P::kSmem)) != cudaSuccess) return e;
  kernel<<<(M + P::kRows - 1) / P::kRows, P::kThreads, P::kSmem, stream>>>(
      x, dqkv, dx1, ln1g, ln1b, wqkv, dx, y_out, part, M);
  return cudaGetLastError();
}

template <int D, int kDepth = kWgDepth>
cudaError_t launch_wgrad_mma_d(const WgJobs& jobs, int tiles, int splits,
                               cudaStream_t stream) {
  using P = WgPlan<D, kDepth>;
  const auto kernel = wgrad_mma_kernel<D, kDepth>;
  cudaError_t e;
  if ((e = set_smem(kernel, P::kSmem)) != cudaSuccess) return e;
  kernel<<<dim3(tiles, splits), kWgThreads, P::kSmem, stream>>>(jobs);
  return cudaGetLastError();
}

// The weight grads' tiles: 64 x cols each (cols = wgrad_cols(D) divides
// every n_in). At 384 columns a CTA holds 2 x 12 accumulator blocks a warp
// and a 58 KB ring.
inline cudaError_t launch_wgrad_mma(const WgJobs& jobs, int tiles,
                                    int splits, int cols,
                                    cudaStream_t stream) {
  switch (cols) {
    case 64: return launch_wgrad_mma_d<64>(jobs, tiles, splits, stream);
    case 128: return launch_wgrad_mma_d<128>(jobs, tiles, splits, stream);
    case 192: return launch_wgrad_mma_d<192>(jobs, tiles, splits, stream);
    case 384:
      return launch_wgrad_mma_d<384, kWgWideDepth>(jobs, tiles, splits,
                                                   stream);
    default: return cudaErrorInvalidValue;
  }
}

// a1_in given: #4's instance, which reads the saved a1.
template <typename T>
cudaError_t launch_mlp_bwd_mma(const T* x, const T* attn, const float* g,
                               const T* wproj, const float* bproj,
                               const float* ln2g, const float* ln2b,
                               const T* w1, const float* b1, const T* w2,
                               const T* a1_in, T* z, T* h1, T* gb, T* da1,
                               float* dx1, T* dx1b, T* go, float* part, int M,
                               int D, int H, cudaStream_t stream) {
  static_assert(std::is_same<T, bf16>::value, "bf16 only");
#define MLP_BWD_CALL(DD, RES)                                               \
  launch_mlp_bwd_mma_d<DD, RES>(x, attn, g, wproj, bproj, ln2g, ln2b, w1,   \
                                b1, w2, a1_in, z, h1, gb, da1, dx1, dx1b,   \
                                go, part, M, H, stream)
  const bool res = a1_in != nullptr;
  switch (D) {
    case 64: return res ? MLP_BWD_CALL(64, true) : MLP_BWD_CALL(64, false);
    case 128: return res ? MLP_BWD_CALL(128, true) : MLP_BWD_CALL(128, false);
    case 192: return res ? MLP_BWD_CALL(192, true) : MLP_BWD_CALL(192, false);
    default: return cudaErrorInvalidValue;
  }
#undef MLP_BWD_CALL
}

// y_out given: #4's instance, which stores the rounded LN1 output.
template <typename T>
cudaError_t launch_qkv_bwd_mma(const T* x, const T* dqkv, const float* dx1,
                               const float* ln1g, const float* ln1b,
                               const T* wqkv, T* dx, T* y_out, float* part,
                               int M, int D, cudaStream_t stream) {
  static_assert(std::is_same<T, bf16>::value, "bf16 only");
#define QKV_BWD_CALL(DD, RES)                                               \
  launch_qkv_bwd_mma_d<DD, RES>(x, dqkv, dx1, ln1g, ln1b, wqkv, dx, y_out,  \
                                part, M, stream)
  const bool res = y_out != nullptr;
  switch (D) {
    case 64: return res ? QKV_BWD_CALL(64, true) : QKV_BWD_CALL(64, false);
    case 128: return res ? QKV_BWD_CALL(128, true) : QKV_BWD_CALL(128, false);
    case 192: return res ? QKV_BWD_CALL(192, true) : QKV_BWD_CALL(192, false);
    default: return cudaErrorInvalidValue;
  }
#undef QKV_BWD_CALL
}

}  // namespace
