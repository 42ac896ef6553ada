// Register-level pieces of the bf16 mma.sync kernels (attention_mma.cuh and
// the ViT block's GEMM stages in block_mma.cuh): PTX wrappers for cp.async,
// ldmatrix and mma.sync.m16n8k16, fragment addresses and repacking, quad
// reductions, an asynchronous tile copy and one warp's product of its 16
// rows against a [n][k] tile in shared memory. Everything sits in an
// anonymous namespace, so each source that includes this header gets its
// own copy.

#pragma once

#include "tile_common.cuh"

namespace {

// ---- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src
// must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a . b, one m16n8k16 bf16 product with fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t. A C fragment
// c[4] holds rows g, g, g + 8, g + 8 and columns 2t, 2t + 1, 2t, 2t + 1 of
// its 16 x 8 block; an A fragment a[4] holds (row g, k 2t..2t+1),
// (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); a B fragment (b0, b1)
// holds (k 2t..2t+1, column g) and (k 2t + 8.., g).

// The lane's ldmatrix row address for the A fragment of rows row0..+15,
// depth k0..+15, of a row-major tile.
template <int LD>
__device__ __forceinline__ const bf16* a_addr(const bf16* t, int row0,
                                              int k0, int lane) {
  return t + (row0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8;
}
// B fragments of two 8-column blocks n0..n0+15 at depth k0..+15, from a
// tile stored [n][k] (K in q . k^T, a Linear weight): r[0..1] block n0,
// r[2..3] block n0 + 8.
template <int LD>
__device__ __forceinline__ const bf16* bnk_addr(const bf16* t, int n0,
                                                int k0, int lane) {
  return t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 +
         ((lane >> 3) & 1) * 8;
}
// The same from a tile stored [k][n] (V in P . V), through ldmatrix.trans.
template <int LD>
__device__ __forceinline__ const bf16* bkn_addr(const bf16* t, int k0,
                                                int n0, int lane) {
  return t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
         (lane >> 4) * 8;
}

// The A fragment of rows row0..row0+15, depth k0..k0+15, of a tile stored
// [k][row] (an operand read transposed, as A^T in the weight grads'
// A^T . B), through ldmatrix.trans.
template <int LD>
__device__ __forceinline__ const bf16* akm_addr(const bf16* t, int k0,
                                                int row0, int lane) {
  return t + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * LD + row0 +
         ((lane >> 3) & 1) * 8;
}

// C fragments of NB 8-column blocks (fp32) rounded to bf16 as the A
// fragments of NB / 2 16-deep blocks.
template <int NB>
__device__ __forceinline__ void c_to_a(const float (&c)[NB][4],
                                       uint32_t (&a)[NB / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The sum of v over the eight lanes that share t = lane & 3 (the rows of
// a C fragment column), left in every lane.
__device__ __forceinline__ float column_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Column sums of a warp's 16 rows of C fragments acc[NB] (fp32, before any
// rounding), rows where !ok[half] left out: the two rows a thread holds,
// then the eight threads of a column; lanes 0-3 write the 8 NB sums to dst.
template <int NB>
__device__ __forceinline__ void warp_col_partial(const float (&acc)[NB][4],
                                                 const bool (&ok)[2],
                                                 float* dst, int lane) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const float v = column_sum8((ok[0] ? acc[j][w] : 0.f) +
                                  (ok[1] ? acc[j][2 + w] : 0.f));
      if (lane < 4) dst[8 * j + 2 * lane + w] = v;
    }
  }
}

// ---- tiles and products of the GEMM stages ---------------------------------

// Copies rows x COLS bf16 (global row stride gs elements) into a tile of row
// stride LD with NT threads, without waiting; rows from `valid` on are
// zero-filled.
template <int COLS, int LD, int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long gs, int rows,
                                                int valid) {
  constexpr int kVecs = COLS / 8;                     // 16 bytes each
  for (int i = threadIdx.x; i < rows * kVecs; i += NT) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, ok ? src + r * gs + c : src, ok);
  }
}

// acc[NB] += A . W^T for one warp: A its 16 rows over depth 16 KB, held as
// A fragments a[KB]; W rows 0..8 NB - 1 of a [n][k] tile (row stride LD)
// over the same depth.
template <int LD, int KB, int NB>
__device__ __forceinline__ void warp_mma_nk(float (&acc)[NB][4],
                                            const uint32_t (&a)[KB][4],
                                            const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
    for (int p = 0; p < NB / 2; ++p) {
      uint32_t b[4];
      ldsm_x4(b, bnk_addr<LD>(tile, 16 * p, 16 * kk, lane));
      mma_bf16(acc[2 * p], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a[kk], b[2], b[3]);
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero_acc(float (&acc)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
}

}  // namespace
