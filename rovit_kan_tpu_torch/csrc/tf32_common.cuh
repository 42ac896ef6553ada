// Register-level pieces of the 3xTF32 mma.sync kernels (attention_tf32.cuh
// and the fp32 block stages of block_tf32.cuh): the TF32 split of an fp32
// value, the m16n8k8 TF32 product and its three-product fp32-accurate form,
// fragment loads from fp32 tiles in shared memory, the repack of a C
// fragment as the next product's A fragment, and an asynchronous fp32 tile
// copy. Everything sits in an anonymous namespace, so each source that
// includes this header gets its own copy.
//
// 3xTF32: x = hi + lo + e with hi = rna(x), lo = rna(x - hi), each a TF32
// value (the fp32 bits with the low 13 mantissa bits zero), |e| <= 2^-22 |x|
// (rna: to nearest, ties away from zero; x - hi is exact in fp32). Then
// a . b = a_hi b_hi + a_hi b_lo + a_lo b_hi + (a_lo b_lo + the e terms),
// and the first three are three TF32 tensor-core products accumulated in
// fp32, the two small ones first: about 2^-21 relative per product against
// fp32's 2^-24, where a single TF32 product keeps 2^-11. Every fp32 product
// of these kernels takes the three; none takes one alone.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32): lane = 4 g + tq. A holds
// (row g, k tq), (g + 8, tq), (g, tq + 4), (g + 8, tq + 4); B (b0, b1) holds
// (k tq, column g) and (k tq + 4, g); C holds rows g, g, g + 8, g + 8 and
// columns 2 tq, 2 tq + 1, 2 tq, 2 tq + 1.
// A C fragment feeds the next product from registers, with no shuffle,
// when that product's k order is the permutation kappa = tq -> column 2 tq,
// kappa = tq + 4 -> column 2 tq + 1 of the C block: then a = (c0, c2, c1,
// c3), and the B fragment reads rows 2 tq and 2 tq + 1 of its [k][n] tile
// (tf32_b_kn_perm), or columns 2 tq and 2 tq + 1 of its [n][k] tile, one
// 8-byte load (tf32_b_nk_perm: a Linear weight, W2 in the block's fc2).
// The sum over one k block is then taken in another order, which the
// hardware does not define anyway.

#pragma once

#include "mma_common.cuh"

namespace {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), by two integer operations on its bits: half a TF32 ulp added
// to the magnitude, then the low 13 bits cleared (a carry moves into the
// exponent, as the rounding does). The same value for every finite x. On
// sm_90a cvt.rna.tf32.f32 compiles to a longer sequence that also handles
// NaN and inf (FSETP, SEL, VIADD, LOP3 and IMAD per value in the SASS), and
// the attention kernels ran markedly slower with it.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// An operand fragment of R registers as its TF32 high and low parts.
template <int R>
struct Tf32Frag {
  uint32_t hi[R], lo[R];
};

// d += a . b, one m16n8k8 TF32 product with fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32: lo . hi, hi . lo, then hi . hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const Tf32Frag<4>& a,
                                           const Tf32Frag<2>& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// The A fragment of rows row0..row0+15 at depth k0..k0+7 of a row-major
// fp32 tile (row stride LD), split.
template <int LD>
__device__ __forceinline__ void tf32_a_rows(Tf32Frag<4>& a, const float* t,
                                            int row0, int k0, int g,
                                            int tq) {
  const float* p = t + (row0 + g) * LD + k0 + tq;
  split_tf32(p[0], a.hi[0], a.lo[0]);
  split_tf32(p[8 * LD], a.hi[1], a.lo[1]);
  split_tf32(p[4], a.hi[2], a.lo[2]);
  split_tf32(p[8 * LD + 4], a.hi[3], a.lo[3]);
}

// The B fragment of columns n0..n0+7 at depth k0..k0+7 of a tile stored
// [n][k] (K in q . k^T), split.
template <int LD>
__device__ __forceinline__ void tf32_b_nk(Tf32Frag<2>& b, const float* t,
                                          int n0, int k0, int g, int tq) {
  const float* p = t + (n0 + g) * LD + k0 + tq;
  split_tf32(p[0], b.hi[0], b.lo[0]);
  split_tf32(p[4], b.hi[1], b.lo[1]);
}

// The B fragment of columns n0..n0+7 over tile rows k0..k0+7 of a tile
// stored [k][n] (V in P . V), in the permuted k order of tf32_c_to_a.
template <int LD>
__device__ __forceinline__ void tf32_b_kn_perm(Tf32Frag<2>& b,
                                               const float* t, int k0,
                                               int n0, int g, int tq) {
  const float* p = t + (k0 + 2 * tq) * LD + n0 + g;
  split_tf32(p[0], b.hi[0], b.lo[0]);
  split_tf32(p[LD], b.hi[1], b.lo[1]);
}

// The same from a tile stored [n][k] (a Linear weight): columns k0 + 2 tq
// and k0 + 2 tq + 1 of row n0 + g, one 8-byte load (LD even, k0 a multiple
// of 8). With LD = 8 mod 32 each half-warp's 16 loads cover the 32 banks.
template <int LD>
__device__ __forceinline__ void tf32_b_nk_perm(Tf32Frag<2>& b,
                                               const float* t, int n0,
                                               int k0, int g, int tq) {
  const float2 v =
      *reinterpret_cast<const float2*>(t + (n0 + g) * LD + k0 + 2 * tq);
  split_tf32(v.x, b.hi[0], b.lo[0]);
  split_tf32(v.y, b.hi[1], b.lo[1]);
}

// A C fragment (16 rows x 8 columns, fp32) as the split A fragment of an
// 8-deep product whose k order is the permutation above.
__device__ __forceinline__ void tf32_c_to_a(Tf32Frag<4>& a,
                                            const float (&c)[4]) {
  split_tf32(c[0], a.hi[0], a.lo[0]);
  split_tf32(c[2], a.hi[1], a.lo[1]);
  split_tf32(c[1], a.hi[2], a.lo[2]);
  split_tf32(c[3], a.hi[3], a.lo[3]);
}

// Copies ROWS rows of COLS fp32 (global row stride sr elements) into a tile
// of row stride LD with NT threads, rows from `valid` on zero-filled by
// cp.async's source size 0, without waiting. fma_common.cuh's tile_async
// does the same with a runtime row stride and width; in this loader's
// place it ran #5 and #6 slower on the card at head width 64, and so did
// a fully unrolled tile_async.
template <int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void load_rows_f32_async(float* dst,
                                                    const float* src,
                                                    long long sr,
                                                    int valid) {
  constexpr int kVecs = COLS / 4;                     // 16 bytes each
  static_assert(ROWS * kVecs % NT == 0, "whole iterations");
#pragma unroll
  for (int it = 0; it < ROWS * kVecs / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, ok ? src + r * sr + c : src, ok);
  }
}

}  // namespace
