// The fp32 GEMM stages of the ViT-block forward on Hopper (sm_90a), with
// every product in 3xTF32 mma.sync: LN1 + qkv (ln_qkv_tf32_kernel, which
// the fp32 backward vit_block_bwd_f32.cu also runs to recompute qkv) and
// proj + residual + LN2 + fc1 + GELU + fc2 + residual
// (proj_mlp_tf32_kernel, with #3's a1 store behind kStoreA1), for a model
// width D of 64 to 320 in steps of 64 and any hidden width that is a
// multiple of 64. The bf16 route is block_mma.cuh; the attention stage
// between the two is attention_tf32.cuh's forward. The note in
// vit_block_fwd.cu says what bounds the block.
//
// Why 3xTF32: an fp32 product on the FMA units spends one instruction per
// 32 multiply-adds a warp, and the first design's FMA stages reached 16% of
// the 67 TFLOP/s FMA peak; one m16n8k8 TF32 product is 1,024 multiply-adds
// a warp per instruction. A single TF32 product keeps 11 significant bits,
// outside fp32's tolerances, so each product is three (tf32_common.cuh):
// lo . hi, hi . lo, then hi . hi, accumulated in fp32, about 2^-21 relative.
//
// Design. A CTA has W warps, 16 rows each; a warp's rows are its own from
// the first load to the last store, so they need no barrier but __syncwarp:
//   - the weights stream through one ring of kTf32Stages stages, each a
//     "piece" of 64 output rows by 32 input columns of a Linear weight
//     ([n][k], fp32), by cp.async, kTf32Stages - 1 pieces ahead of the
//     products, one __syncthreads per piece; every warp runs its 16 rows
//     against each piece (8 column blocks by 4 depth blocks);
//   - operands are split into TF32 hi and lo parts as their fragments are
//     loaded: the B fragments from the piece; the A fragments from the
//     warp's rows in shared memory (fp32, row stride D + 4, so the
//     fragment loads are free of bank conflicts). Split once and kept in
//     registers, 16 rows x D = 192 would take 192 registers a thread (48
//     for the bf16 route's A fragments). Splitting each piece once per CTA
//     into hi and lo planes that every warp reads (two 8-byte loads a B
//     fragment, no split) ran both stages slower on the card, at both
//     main-path shapes: it doubles the shared-memory reads of B;
//   - LayerNorm is applied where an A fragment is loaded: the rows stay as
//     x (ln_qkv) or x1 (proj_mlp) in shared memory, the row's mean and
//     1 / sqrt(var + eps) in registers (two-pass fp32, reduced over the
//     quad of threads sharing a row), g and b in shared memory; every load
//     computes (v - mean) * rstd * g + b by the same instructions, so every
//     product reads the same LN output;
//   - ln_qkv: for each 64-column tile of qkv, the warp accumulates its 16 x
//     64 block over the D / 32 pieces of the tile and adds the fp32 bias in
//     registers; where y_out is given the LN1 output is stored first;
//   - proj_mlp: proj over all D output columns at once (D / 8 C fragments,
//     96 registers at D = 192), pieces in k-slice order; then x1 = x +
//     (acc + bproj) in fp32 overwrites the warp's attention rows in shared
//     memory, and LN2's statistics come from the same registers. Then, for
//     each 64-wide chunk of the hidden dimension, fc1 (D / 32 pieces of
//     W1) gives a = acc + b1 in C fragments; #3 stores a there; h =
//     gelu_erf(a) stays in registers and feeds fc2 as A fragments
//     (tf32_c_to_a, the k order permuted within each 8-deep block), against
//     2 D / 64 pieces of W2 read by tf32_b_nk_perm (one 8-byte load per B
//     fragment, pieces at row stride 40), into D / 8 C fragments that the
//     same registers as proj's accumulators hold; no hidden tile exists;
//     out = x1 + (acc + b2) once at the end.
//   Shared memory at D = 192, W = 3 (48 rows): the ring 3 x 10 KB, the rows
//   48 x 196 fp32 (36.75 KB) and LN's g and b (1.5 KB), 68.3 KB; proj_mlp's
//   254 registers a thread leave room for two CTAs an SM. Wave arithmetic
//   on 132 SMs: at (64, 197), M = 12,608 rows, each stage has 263 CTAs, in
//   proj_mlp's 264 slots one wave; at (32, 577), 385 CTAs, 1.46 waves. On
//   the card 2 or 4 warps a CTA, or a fourth stage, ran slower.
//
// Rounding points are the TPU kernel's fp32 mode (rovit_kan_tpu/ops/
// block_kernel.py:98-149): nothing is rounded to a narrower type; the biases
// and both residuals are fp32 adds on the fp32 products, x1 = x + (acc +
// bproj), a = acc + b1, out = x1 + (acc + b2). Only the products' rounding
// (3xTF32) and the order of fp32 sums inside a product or a LayerNorm
// differ from the plain version. Every element has one owner and every
// sum a fixed order: a repeated call gives the same bits, and the
// kStoreA1 instance computes #1's output with the same instructions.

#pragma once

#include "block_mma.cuh"
#include "tf32_common.cuh"

namespace {

// A weight piece: 64 output rows by 32 input columns of a Linear weight.
// Scalar fragment loads (tf32_b_nk) read it at row stride 36 (4 mod 32:
// conflict-free), 8-byte loads (tf32_b_nk_perm) at 40 (8 mod 32).
constexpr int kPieceN = 64, kPieceK = 32;
constexpr int kLdPiece = kPieceK + 4;
constexpr int kLdPiecePerm = kPieceK + 8;
constexpr int kPieceFloats = kPieceN * kLdPiecePerm;
constexpr int kTf32Stages = 3;

template <int D, int W>
struct Tf32Plan {
  static constexpr int kThreads = 32 * W;
  static constexpr int kRows = 16 * W;
  static constexpr int kLdX = D + 4;
  static constexpr int kRingFloats = kTf32Stages * kPieceFloats;
  static constexpr size_t kSmem =
      sizeof(float) * (kRingFloats + kRows * kLdX + 2 * D);
};

// Issues the copy of one piece (rows of the weight at stride ld_src) into a
// ring stage of row stride LD, with NT threads.
template <int LD, int NT>
__device__ __forceinline__ void load_piece(float* dst, const float* src,
                                           long long ld_src) {
  constexpr int kVecs = kPieceK / 4;                  // 16 bytes each
  for (int i = threadIdx.x; i < kPieceN * kVecs; i += NT) {
    const int r = i / kVecs, c = (i - r * kVecs) * 4;
    cp_async16(dst + r * LD + c, src + r * ld_src + c, true);
  }
}

// Issues the copy of a warp's 16 rows of D fp32 (from src, row stride D)
// into its rows of shared memory (row stride LD); rows from `valid` on are
// zero-filled (the source then is `base`, which is mapped).
template <int D, int LD>
__device__ __forceinline__ void warp_rows_async(float* dst, const float* src,
                                                const float* base, int valid,
                                                int lane) {
  constexpr int kVecs = D / 4;
  for (int i = lane; i < 16 * kVecs; i += 32) {
    const int r = i / kVecs, c = (i - r * kVecs) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c,
               ok ? src + static_cast<size_t>(r) * D + c : base, ok);
  }
}

// Issues the copy of LayerNorm's g and b (D fp32 each) with NT threads.
template <int D, int NT>
__device__ __forceinline__ void ln_params_async(float* sg, float* sb,
                                                const float* g,
                                                const float* b) {
  for (int i = threadIdx.x; i < D / 2; i += NT) {
    const int c = (i % (D / 4)) * 4;
    cp_async16(i < D / 4 ? sg + c : sb + c, (i < D / 4 ? g : b) + c, true);
  }
}

__device__ __forceinline__ float ln_apply(float v, float mean, float rstd,
                                          float g, float b) {
  return fmaf((v - mean) * rstd, g, b);
}

// LayerNorm statistics of a thread's two rows g and g + 8.
struct RowStats {
  float mean0, rstd0, mean1, rstd1;
};

// The A fragment of the warp's 16 rows (row stride LD) at depth k0..k0+7,
// LayerNorm applied with the rows' statistics and the columns' sg and sb,
// split.
template <int LD>
__device__ __forceinline__ void tf32_a_ln(Tf32Frag<4>& a, const float* rows,
                                          const float* sg, const float* sb,
                                          RowStats st, int k0, int g,
                                          int tq) {
  const float* p = rows + g * LD + k0 + tq;
  const float g0 = sg[k0 + tq], g1 = sg[k0 + tq + 4];
  const float b0 = sb[k0 + tq], b1 = sb[k0 + tq + 4];
  split_tf32(ln_apply(p[0], st.mean0, st.rstd0, g0, b0), a.hi[0], a.lo[0]);
  split_tf32(ln_apply(p[8 * LD], st.mean1, st.rstd1, g0, b0), a.hi[1],
             a.lo[1]);
  split_tf32(ln_apply(p[4], st.mean0, st.rstd0, g1, b1), a.hi[2], a.lo[2]);
  split_tf32(ln_apply(p[8 * LD + 4], st.mean1, st.rstd1, g1, b1), a.hi[3],
             a.lo[3]);
}

// The statistics of those rows, read by val(half, j) as in
// layernorm_stats.
template <int D, typename Val>
__device__ __forceinline__ RowStats row_stats(Val val) {
  float mean[2], rstd[2];
  layernorm_stats<D>(val, mean, rstd);
  return {mean[0], rstd[0], mean[1], rstd[1]};
}

// Issues the copy of piece p of ln_qkv's Wqkv (64-column tile p / (D / 32),
// k slice p % (D / 32)) into its ring stage, or nothing past the last; one
// commit either way, so the ring's group count stays one a piece.
template <int D, int NT>
__device__ __forceinline__ void issue_qkv_piece(float* ring, const float* w,
                                                int p) {
  constexpr int KS = D / kPieceK;
  if (p < 3 * D / kPieceN * KS) {
    const int ct = p / KS, ks = p - ct * KS;
    load_piece<kLdPiece, NT>(
        ring + (p % kTf32Stages) * kPieceFloats,
        w + static_cast<size_t>(ct) * kPieceN * D + ks * kPieceK, D);
  }
  cp_async_commit();
}

// acc[NB0 .. NB0 + 7] += A . piece^T over the piece's 32 columns: A from
// a_frag(kb, a) for depth block kb = 0..3 of the piece.
template <int NB, typename AFrag>
__device__ __forceinline__ void piece_mma(float (&acc)[NB][4], int nb0,
                                          AFrag a_frag, const float* piece,
                                          int g, int tq) {
#pragma unroll
  for (int kb = 0; kb < kPieceK / 8; ++kb) {
    Tf32Frag<4> a;
    a_frag(kb, a);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      Tf32Frag<2> b;
      tf32_b_nk<kLdPiece>(b, piece, 8 * nb, 8 * kb, g, tq);
      mma_3xtf32(acc[nb0 + nb], a, b);
    }
  }
}

// ---- LN1 + qkv -------------------------------------------------------------

// 16 W rows: LN1, then qkv = y . Wqkv^T + bqkv over 3D / 64 column tiles of
// D / 32 pieces each. Where y_out is given, the LN1 output is stored too
// (the backward's weight grad of qkv reads it). The minimum of two CTAs an
// SM changes no occupancy (the kernel takes under 100 registers), but
// without it ptxas spilled around the fp32 division's slow-path call in
// the LN statistics at W = 3.
template <int D, int W>
__global__ void __launch_bounds__(32 * W, 2)
ln_qkv_tf32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ b, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ qkv,
                   float* __restrict__ y_out, int M) {
  using P = Tf32Plan<D, W>;
  constexpr int KS = D / kPieceK;                   // pieces per tile
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float* xw = ring + P::kRingFloats + 16 * warp * P::kLdX;   // own rows
  float* sg = ring + P::kRingFloats + P::kRows * P::kLdX;
  float* sb = sg + D;
  const int row0 = blockIdx.x * P::kRows + 16 * warp;
  const int valid = min(16, M - row0);

  // The rows and LN1's parameters, then the ring's first pieces.
  warp_rows_async<D, P::kLdX>(xw, x + static_cast<size_t>(row0) * D, x,
                              valid, lane);
  ln_params_async<D, P::kThreads>(sg, sb, g, b);
  cp_async_commit();
  for (int p = 0; p < kTf32Stages - 1; ++p) {
    issue_qkv_piece<D, P::kThreads>(ring, w, p);
  }
  cp_async_wait<kTf32Stages - 1>();
  __syncthreads();

  const RowStats st = row_stats<D>([&](int half, int j) {
    return *reinterpret_cast<const float2*>(xw + (gq + 8 * half) * P::kLdX +
                                            8 * j + 2 * tq);
  });
  if (y_out != nullptr) {
#pragma unroll 4
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float mean = half ? st.mean1 : st.mean0;
        const float rstd = half ? st.rstd1 : st.rstd0;
        const float2 v = *reinterpret_cast<const float2*>(
            xw + (gq + 8 * half) * P::kLdX + c);
        if (gq + 8 * half < valid) {
          *reinterpret_cast<float2*>(
              y_out + static_cast<size_t>(row0 + gq + 8 * half) * D + c) =
              make_float2(ln_apply(v.x, mean, rstd, sg[c], sb[c]),
                          ln_apply(v.y, mean, rstd, sg[c + 1], sb[c + 1]));
        }
      }
    }
  }

  for (int ct = 0; ct < 3 * D / kPieceN; ++ct) {
    float acc[8][4];
    zero_acc(acc);
    for (int ks = 0; ks < KS; ++ks) {
      const int p = ct * KS + ks;
      cp_async_wait<kTf32Stages - 2>();
      __syncthreads();           // piece p landed; piece p - 1's stage free
      issue_qkv_piece<D, P::kThreads>(ring, w, p + kTf32Stages - 1);
      piece_mma(acc, 0,
                [&](int kb, Tf32Frag<4>& a) {
                  tf32_a_ln<P::kLdX>(a, xw, sg, sb, st,
                                     ks * kPieceK + 8 * kb, gq, tq);
                },
                ring + (p % kTf32Stages) * kPieceFloats, gq, tq);
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int c = ct * kPieceN + 8 * nb + 2 * tq;
      const float2 bb = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (gq + 8 * half < valid) {
          *reinterpret_cast<float2*>(
              qkv + static_cast<size_t>(row0 + gq + 8 * half) * 3 * D + c) =
              make_float2(acc[nb][2 * half] + bb.x,
                          acc[nb][2 * half + 1] + bb.y);
        }
      }
    }
  }
}

// ---- proj + residual + LN2 + fc1 + GELU + fc2 + residual --------------------

// 16 W rows. Pieces 0..D/32 * D/64 - 1 are Wproj's, in k-slice order; then,
// for each 64-wide chunk j of the hidden dimension, W1's D / 32 pieces of
// its rows j * 64.., and W2's 2 D / 64 pieces of its columns j * 64..
// kStoreA1 (#3): also store the fc1 pre-activation a1 = acc + b1.
template <int D, bool kStoreA1, int W>
__global__ void __launch_bounds__(32 * W)
proj_mlp_tf32_kernel(const float* __restrict__ x,
                     const float* __restrict__ attn,
                     const float* __restrict__ wproj,
                     const float* __restrict__ bproj,
                     const float* __restrict__ g2,
                     const float* __restrict__ bn2,
                     const float* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out,
                     float* __restrict__ a1_out, int M, int H) {
  using P = Tf32Plan<D, W>;
  constexpr int KS = D / kPieceK;                   // pieces per D of depth
  constexpr int NT = D / kPieceN;                   // 64-column tiles of D
  constexpr int kProj = KS * NT;
  constexpr int kChunkPieces = KS + 2 * NT;         // W1's, then W2's
  const int pieces = kProj + H / kPieceN * kChunkPieces;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float* xw = ring + P::kRingFloats + 16 * warp * P::kLdX;   // own rows
  float* sg = ring + P::kRingFloats + P::kRows * P::kLdX;
  float* sb = sg + D;
  const int row0 = blockIdx.x * P::kRows + 16 * warp;
  const int valid = min(16, M - row0);
  auto issue = [&](int p) {
    if (p < pieces) {
      float* dst = ring + (p % kTf32Stages) * kPieceFloats;
      if (p < kProj) {
        const int ks = p / NT, nt = p - ks * NT;
        load_piece<kLdPiece, P::kThreads>(
            dst, wproj + static_cast<size_t>(nt) * kPieceN * D + ks * kPieceK,
            D);
      } else {
        const int q = p - kProj, j = q / kChunkPieces;
        const int r = q - j * kChunkPieces;
        if (r < KS) {
          load_piece<kLdPiece, P::kThreads>(
              dst, w1 + static_cast<size_t>(j) * kPieceN * D + r * kPieceK,
              D);
        } else {
          const int nt = (r - KS) >> 1, kk = (r - KS) & 1;
          load_piece<kLdPiecePerm, P::kThreads>(
              dst, w2 + static_cast<size_t>(nt) * kPieceN * H +
                       j * kPieceN + kk * kPieceK,
              H);
        }
      }
    }
    cp_async_commit();
  };
  int p = 0;
  auto next = [&]() {
    cp_async_wait<kTf32Stages - 2>();
    __syncthreads();             // piece p landed; piece p - 1's stage free
    issue(p + kTf32Stages - 1);
    return ring + (p++ % kTf32Stages) * kPieceFloats;
  };

  // The attention output's rows and LN2's parameters, then the first
  // pieces.
  warp_rows_async<D, P::kLdX>(xw, attn + static_cast<size_t>(row0) * D,
                              attn, valid, lane);
  ln_params_async<D, P::kThreads>(sg, sb, g2, bn2);
  cp_async_commit();
  for (int s = 0; s < kTf32Stages - 1; ++s) issue(s);

  // proj over all D columns; then x1 = x + (acc + bproj) in fp32, in the
  // same registers and over the warp's attention rows.
  float acc[D / 8][4];
  zero_acc(acc);
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      piece_mma(acc, 8 * nt,
                [&](int kb, Tf32Frag<4>& a) {
                  tf32_a_rows<P::kLdX>(a, xw, 0, ks * kPieceK + 8 * kb, gq,
                                       tq);
                },
                next(), gq, tq);
    }
  }
  __syncwarp();                  // the warp's attention rows are read
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * tq;
    const float2 bb = *reinterpret_cast<const float2*>(bproj + c);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 xv =
          gq + 8 * half < valid
              ? *reinterpret_cast<const float2*>(
                    x + static_cast<size_t>(row0 + gq + 8 * half) * D + c)
              : make_float2(0.f, 0.f);
      acc[j][2 * half] = xv.x + (acc[j][2 * half] + bb.x);
      acc[j][2 * half + 1] = xv.y + (acc[j][2 * half + 1] + bb.y);
      *reinterpret_cast<float2*>(xw + (gq + 8 * half) * P::kLdX + c) =
          make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
  const RowStats st = row_stats<D>([&](int half, int j) {
    return make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
  });
  __syncwarp();                  // x1 is in the warp's rows

  // fc1 + GELU chunk by chunk, each chunk's h fed straight to fc2.
  zero_acc(acc);
  for (int j = 0; j < H / kPieceN; ++j) {
    float h[8][4];
    zero_acc(h);
    for (int ks = 0; ks < KS; ++ks) {
      piece_mma(h, 0,
                [&](int kb, Tf32Frag<4>& a) {
                  tf32_a_ln<P::kLdX>(a, xw, sg, sb, st,
                                     ks * kPieceK + 8 * kb, gq, tq);
                },
                next(), gq, tq);
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int c = j * kPieceN + 8 * nb + 2 * tq;
      const float2 bb = *reinterpret_cast<const float2*>(b1 + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float a0 = h[nb][2 * half] + bb.x;
        const float a1 = h[nb][2 * half + 1] + bb.y;
        if (kStoreA1 && gq + 8 * half < valid) {
          *reinterpret_cast<float2*>(
              a1_out + static_cast<size_t>(row0 + gq + 8 * half) * H + c) =
              make_float2(a0, a1);
        }
        h[nb][2 * half] = gelu_erf(a0);
        h[nb][2 * half + 1] = gelu_erf(a1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float* piece = next();
#pragma unroll
        for (int kb = 0; kb < kPieceK / 8; ++kb) {
          Tf32Frag<4> a;
          tf32_c_to_a(a, h[4 * kk + kb]);
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            Tf32Frag<2> b;
            tf32_b_nk_perm<kLdPiecePerm>(b, piece, 8 * nb, 8 * kb, gq, tq);
            mma_3xtf32(acc[8 * nt + nb], a, b);
          }
        }
      }
    }
  }

  // out = x1 + (acc + b2).
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * tq;
    const float2 bb = *reinterpret_cast<const float2*>(b2 + c);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (gq + 8 * half < valid) {
        const float2 x1 = *reinterpret_cast<const float2*>(
            xw + (gq + 8 * half) * P::kLdX + c);
        *reinterpret_cast<float2*>(
            out + static_cast<size_t>(row0 + gq + 8 * half) * D + c) =
            make_float2(x1.x + (acc[j][2 * half] + bb.x),
                        x1.y + (acc[j][2 * half + 1] + bb.y));
      }
    }
  }
}

// ---- launches --------------------------------------------------------------

// The warps of each stage's CTA.
constexpr int kQkvTf32Warps = 3, kMlpTf32Warps = 3;

template <int D, int W>
cudaError_t launch_ln_qkv_tf32_d(const float* x, const float* g,
                                 const float* b, const float* w,
                                 const float* bias, float* qkv,
                                 float* y_out, int M, cudaStream_t stream) {
  using P = Tf32Plan<D, W>;
  const auto kernel = ln_qkv_tf32_kernel<D, W>;
  cudaError_t e;
  if ((e = set_smem(kernel, P::kSmem)) != cudaSuccess) return e;
  kernel<<<(M + P::kRows - 1) / P::kRows, P::kThreads, P::kSmem, stream>>>(
      x, g, b, w, bias, qkv, y_out, M);
  return cudaGetLastError();
}

template <int D, bool kStoreA1, int W>
cudaError_t launch_proj_mlp_tf32_d(const float* x, const float* attn,
                                   const float* wproj, const float* bproj,
                                   const float* g2, const float* bn2,
                                   const float* w1, const float* b1,
                                   const float* w2, const float* b2,
                                   float* out, float* a1, int M, int H,
                                   cudaStream_t stream) {
  using P = Tf32Plan<D, W>;
  const auto kernel = proj_mlp_tf32_kernel<D, kStoreA1, W>;
  cudaError_t e;
  if ((e = set_smem(kernel, P::kSmem)) != cudaSuccess) return e;
  kernel<<<(M + P::kRows - 1) / P::kRows, P::kThreads, P::kSmem, stream>>>(
      x, attn, wproj, bproj, g2, bn2, w1, b1, w2, b2, out, a1, M, H);
  return cudaGetLastError();
}

// The widths the fp32 stages take: D of 64 to 320 in steps of 64, a hidden
// width that is a multiple of 64.
inline bool tf32_block_width_ok(int D, int H) {
  return D % 64 == 0 && D >= 64 && D <= 320 && H % 64 == 0 && H >= 64;
}

#define TF32_BLOCK_DISPATCH(D_VAR, CALL)                                    \
  switch (D_VAR) {                                                          \
    case 64: return CALL(64);                                               \
    case 128: return CALL(128);                                             \
    case 192: return CALL(192);                                             \
    case 256: return CALL(256);                                             \
    case 320: return CALL(320);                                             \
    default: return cudaErrorInvalidValue;                                  \
  }

// The dispatchers are templates (T is float), so a source compiles only the
// kernels it launches. A width tf32_block_width_ok refuses returns
// cudaErrorInvalidValue, unlaunched.
template <typename T>
cudaError_t launch_ln_qkv_tf32(const T* x, const float* g, const float* b,
                               const T* w, const float* bias, T* qkv,
                               T* y_out, int M, int D, cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value, "fp32 only");
#define LN_QKV_CALL(DD)                                                     \
  launch_ln_qkv_tf32_d<DD, kQkvTf32Warps>(x, g, b, w, bias, qkv, y_out, M,  \
                                          stream)
  TF32_BLOCK_DISPATCH(D, LN_QKV_CALL)
#undef LN_QKV_CALL
}

// a1 given: #3's instance, which also stores a1 (M, H).
template <typename T>
cudaError_t launch_proj_mlp_tf32(const T* x, const T* attn, const T* wproj,
                                 const float* bproj, const float* g2,
                                 const float* bn2, const T* w1,
                                 const float* b1, const T* w2,
                                 const float* b2, T* out, T* a1, int M,
                                 int D, int H, cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value, "fp32 only");
  if (!tf32_block_width_ok(D, H)) return cudaErrorInvalidValue;
#define PROJ_MLP_CALL(DD)                                                   \
  (a1 != nullptr                                                            \
       ? launch_proj_mlp_tf32_d<DD, true, kMlpTf32Warps>(                   \
             x, attn, wproj, bproj, g2, bn2, w1, b1, w2, b2, out, a1, M, H, \
             stream)                                                        \
       : launch_proj_mlp_tf32_d<DD, false, kMlpTf32Warps>(                  \
             x, attn, wproj, bproj, g2, bn2, w1, b1, w2, b2, out, a1, M, H, \
             stream))
  TF32_BLOCK_DISPATCH(D, PROJ_MLP_CALL)
#undef PROJ_MLP_CALL
}

#undef TF32_BLOCK_DISPATCH

}  // namespace
