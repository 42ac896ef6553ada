// Softmax attention in bf16 on Hopper (sm_90a) with mma.sync: the forward
// and the two backward stages of the attention-only kernels #5 and #6
// (attention.cu), with S, P, dS and every accumulator in registers. They
// are also the bf16 ViT block's attention stages (the forward in #1, #3 and
// #2's recompute, through vit_block_common.cuh; the backward in #2 and #4,
// vit_block_bwd.cu), where q is not pre-scaled: a compile-time switch
// (kScaled) folds the block's hd^-1/2 into the row max and the exp2 FMA,
// rounds the forward's output once to bf16, multiplies dS by the scale in
// fp32 before it is rounded, and adds each backward CTA's fp32 column sums
// of dQ, dK and dV (the qkv bias grad's partials); #5's and #6's instances
// keep their instructions.
//
// Replaces the streamed stages of the first design for the bf16 entries of
// attention.cu (rovit_kan_tpu/ops/attention.py::_attention_kernel and
// ::_attention_bwd_kernel) and for the bf16 block. Those stages kept S, P
// and the output accumulator in shared memory, ran WMMA from shared memory
// and loaded tiles synchronously, and reached 1.5-2.4% of their bounds.
// The fp32 entries run the same design on 3xTF32 products
// (attention_tf32.cuh); the fp32 block forward keeps attention_common.cuh's
// streamed forward.
//
// What bounds #5/#6 (attention.cu's note): at (32, 3, 577, 64) #5 moves
// 35.5 MB (10.6 us at 3.35 TB/s) for 8.2 GFLOP (8.3 us at 989 TFLOP/s), #6
// does 20.5 GFLOP (20.7 us). Both are near the machine balance, so neither
// shared-memory round trips of S nor load stalls can be afforded. The design:
//   - a CTA owns 64 rows (queries; keys on the backward's key side), four
//     warps of 16 rows each, 128 threads; at (32, 3, 577, 64) 960 CTAs;
//   - its own rows' operands go once through shared memory into registers
//     as mma A fragments (ldmatrix); a head width above 64 keeps them in
//     shared memory and reloads them per product, to leave registers for the
//     accumulators;
//   - the other side streams in 64-row tiles through a two-stage cp.async
//     ring: the copy of tile j + 1 runs under the products of tile j, one
//     __syncthreads per tile; rows past N are zero-filled by cp.async's
//     source size 0 and masked in registers;
//   - products are mma.sync.m16n8k16 bf16 -> fp32; S (and dP) come out as C
//     fragments in registers, P (and dS) are formed there in fp32, rounded
//     to bf16 and repacked as the A fragments of the next product
//     (FlashAttention-2's register reuse: a C fragment pair of two 8-column
//     blocks is the A fragment of one 16-deep block), so nothing N x N or
//     16 x 64 touches shared memory;
//   - the row max and sums live in registers, reduced across the quad of
//     threads that shares a row with two shuffles.
// Shared memory: four 64-row tiles (the ring) and, on the key side, two
// 64-float stat rows per stage: 36 KB (forward, query side) and 38 KB (key
// side) at head width 64, so up to six CTAs fit an SM.
//
// Rounding points are the TPU kernels' and the streamed stages': P is
// normalized in fp32 (exp(S - m) times 1 / l) before it is rounded, so the
// forward makes two passes over the keys (statistics, then P . V) and the
// backward's query side two (m, l and a = sum of exp(S - m) * dP, then
// dS = P (dP - a / l) rounded and dQ += dS . K). The key side reads m, 1 / l
// and D = a / l from `stats` and forms P^T and dS^T itself, dV += P^T . dO
// and dK += dS^T . Q over the query tiles in order. exp(S - m) is
// exp2f(S log2(e) - m log2(e)), one FMA with the prescaled row max before
// the ex2 (the plain versions' torch.exp differs by fp32 rounding, well
// inside the tolerances). Every output element has one owner that sums in a
// fixed order: no atomics, the same bits on every call.

#pragma once

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;   // own rows per CTA, and tile rows
constexpr float kLog2e = 1.4426950408889634f;

// A 64-row tile of head width HD in shared memory: rows padded by 16 bytes,
// so the eight row addresses of an ldmatrix fall in distinct bank groups.
template <int HD>
struct MmaTile {
  static constexpr int kLd = HD + 8;
  static constexpr int kElems = kMmaRows * kLd;
  static constexpr size_t kBytes = sizeof(bf16) * kElems;
};

// A head width above 64 keeps the own rows' A fragments in shared memory.
template <int HD>
__host__ __device__ constexpr bool resident() { return HD <= 64; }

// acc[NB] = A . B^T over depth HD: A the warp's 16 own rows (a_frag(kk, a)
// gives depth block kk), B rows n0..n0 + 8 NB - 1 of a streamed [n][HD]
// tile.
template <int HD, int NB, typename AFrag>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], AFrag a_frag,
                                        const bf16* tile, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    a_frag(kk, a);
#pragma unroll
    for (int p = 0; p < NB / 2; ++p) {
      uint32_t b[4];
      ldsm_x4(b, bnk_addr<MmaTile<HD>::kLd>(tile, n0 + 16 * p, 16 * kk,
                                            lane));
      mma_bf16(acc[2 * p], a, b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// acc[HD / 8] += P . T: P the warp's 16 rows over the depth rows k0..k0 +
// 16 KB - 1 of a streamed [k][HD] tile, as A fragments p[KB].
template <int HD, int KB>
__device__ __forceinline__ void mma_pv(float (&acc)[HD / 8][4],
                                       const uint32_t (&p)[KB][4],
                                       const bf16* tile, int k0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      uint32_t b[4];
      ldsm_x4_t(b, bkn_addr<MmaTile<HD>::kLd>(tile, k0 + 16 * kk, 16 * n,
                                              lane));
      mma_bf16(acc[2 * n], p[kk], b[0], b[1]);
      mma_bf16(acc[2 * n + 1], p[kk], b[2], b[3]);
    }
  }
}

// Copies 64 rows of HD bf16 (row stride sr elements) into a tile, rows from
// `valid` on zero-filled, without waiting.
template <int HD>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                long long sr, int valid) {
  constexpr int kVecs = HD / 8;                       // 16 bytes each
#pragma unroll
  for (int it = 0; it < kMmaRows * kVecs / kMmaThreads; ++it) {
    const int i = it * kMmaThreads + threadIdx.x;
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * MmaTile<HD>::kLd + c, ok ? src + r * sr + c : src,
               ok);
  }
}

// Sets the columns of C fragments at or past `valid` (local to the tile) to
// -inf, so exp gives 0 there.
template <int NB>
__device__ __forceinline__ void mask_columns(float (&s)[NB][4], int col0,
                                             int valid, int t) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int c = col0 + 8 * j + 2 * t;
    if (c >= valid) s[j][0] = s[j][2] = -INFINITY;
    if (c + 1 >= valid) s[j][1] = s[j][3] = -INFINITY;
  }
}

// Stores the warp's 16 rows of C fragments acc[HD / 8] as E (fp32 or bf16)
// to rows row0.. of a dense (B, heads, N, HD) view, rows past N skipped.
template <int HD, typename E>
__device__ __forceinline__ void store_rows(HeadView<E> out, int b, int h,
                                           int row0, int N,
                                           const float (&acc)[HD / 8][4],
                                           int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= N) continue;
    E* dst = out.row(b, h, r) + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float x = acc[j][2 * half], y = acc[j][2 * half + 1];
      if constexpr (std::is_same<E, float>::value) {
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(x, y);
      } else {
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(x, y);
      }
    }
  }
}

// ---- forward (#5) ----------------------------------------------------------

template <int HD>
constexpr size_t fwd_mma_smem() { return 4 * MmaTile<HD>::kBytes; }

// out = softmax(q k^T * scale) v for one (64-query tile, head, image),
// stored as OutT (fp32 for #5, bf16 for the ViT block, rounded once).
// Steps 0..nt-1 stream K for the statistics, steps nt..2nt-1 K and V.
// kScaled (the block, whose q is not pre-scaled): the row max is that of
// the unscaled S (the same element, as scale > 0) and the exp2 FMA's
// multiplier is scale log2(e), passed as scale_log2e; without it (#5) the
// multiplier is the constant log2(e) and scale_log2e is not read, so #5
// keeps its instructions and its bits.
template <int HD, typename OutT, bool kScaled>
__global__ void __launch_bounds__(kMmaThreads)
attn_fwd_mma_kernel(HeadView<const bf16> q, HeadView<const bf16> k,
                    HeadView<const bf16> v, HeadView<OutT> out, int N,
                    float scale_log2e) {
  const float c2 = kScaled ? scale_log2e : kLog2e;
  using TL = MmaTile<HD>;
  constexpr int LD = TL::kLd;
  constexpr int KB = HD / 16;
  constexpr int NB = kMmaRows / 8;                    // S blocks per tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);         // [stage][K, V]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int nt = (N + kMmaRows - 1) / kMmaRows;
  auto sK = [&](int s) { return ring + (2 * (s & 1)) * TL::kElems; };
  auto sV = [&](int s) { return ring + (2 * (s & 1) + 1) * TL::kElems; };
  auto load_step = [&](int s) {
    const int k0 = (s < nt ? s : s - nt) * kMmaRows;
    const int kv = min(kMmaRows, N - k0);
    load_rows_async<HD>(sK(s), k.row(b, h, k0), k.sr, kv);
    if (s >= nt) load_rows_async<HD>(sV(s), v.row(b, h, k0), v.sr, kv);
    cp_async_commit();
  };

  // Q through stage 1's K buffer into registers, beside step 0's K.
  load_rows_async<HD>(sK(1), q.row(b, h, q0), q.sr, min(kMmaRows, N - q0));
  load_step(0);
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[KB][4];
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
    ldsm_x4(qa[kk], a_addr<LD>(sK(1), 16 * warp, 16 * kk, lane));
  }
  auto q_frag = [&](int kk, uint32_t (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qa[kk][i];
  };

  float m[2] = {-INFINITY, -INFINITY};    // rows g, g + 8
  float l[2] = {0.f, 0.f};                // this thread's columns only
  float inv_l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int s = 0; s < 2 * nt; ++s) {
    cp_async_wait_all();
    __syncthreads();             // step s landed; step s - 1's stage is free
    if (s + 1 < 2 * nt) load_step(s + 1);
    const int kv = min(kMmaRows, N - (s < nt ? s : s - nt) * kMmaRows);
    float sc[NB][4];
    mma_abt<HD, NB>(sc, q_frag, sK(s), 0, lane);
    if (kv < kMmaRows) mask_columns<NB>(sc, 0, kv, t);
    if (s < nt) {
      // 1. Online row max and sum.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          mx = fmaxf(mx, fmaxf(sc[j][2 * half], sc[j][2 * half + 1]));
        }
        const float mn = fmaxf(m[half], quad_max(mx));
        const float mn2 = mn * c2;
        float e = 0.f;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          e += exp2f(fmaf(sc[j][2 * half], c2, -mn2)) +
               exp2f(fmaf(sc[j][2 * half + 1], c2, -mn2));
        }
        l[half] = l[half] * exp2f((m[half] - mn) * c2) + e;
        m[half] = mn;
      }
      if (s == nt - 1) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          inv_l[half] = 1.f / quad_sum(l[half]);
          m[half] *= c2;                      // pass 2 reads m c2
        }
      }
    } else {
      // 2. P = exp(S - m) / l in fp32, rounded, and O += P . V.
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = exp2f(fmaf(sc[j][e], c2, -m[e >> 1])) *
                     inv_l[e >> 1];
        }
      }
      uint32_t pa[NB / 2][4];
      c_to_a<NB>(sc, pa);
      mma_pv<HD, NB / 2>(o, pa, sV(s), 0, lane);
    }
  }
  store_rows<HD, OutT>(out, b, h, q0 + 16 * warp, N, o, g, t);
}

// ---- backward (#6) ---------------------------------------------------------

// The CTA's column sums: the warps' partials (kMmaWarps rows of HD in
// scratch) added in warp order.
template <int HD>
__device__ __forceinline__ void cta_col_sum(const float* scratch,
                                            float* dst) {
  for (int c = threadIdx.x; c < HD; c += kMmaThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) s += scratch[w * HD + c];
    dst[c] = s;
  }
}
// The block backward's per-CTA row of column sums: [dq | dk | dv], each D
// wide, at row (image, tile) of B * ceil(N / 64) rows.
__device__ __forceinline__ float* part_row(float* part, int b, int D) {
  return part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 3 * D;
}


// Keys (queries on the key side) per chunk of a streamed tile: the products
// of a 64-row tile run in 64 / (8 * kChunkNB) chunks, which bounds the live
// S and dP fragments.
template <int HD>
__host__ __device__ constexpr int chunk_nb() { return HD <= 64 ? 4 : 2; }

// Query side: ring [stage][K, V], then (head width above 64) Q and dO.
template <int HD>
constexpr size_t bwd_q_mma_smem() {
  return (resident<HD>() ? 4 : 6) * MmaTile<HD>::kBytes;
}
// Key side: ring [stage][Q, dO], the stage's m, l and D rows, then (head
// width above 64) K and V.
template <int HD>
constexpr size_t bwd_kv_mma_smem() {
  return (resident<HD>() ? 4 : 6) * MmaTile<HD>::kBytes +
         2 * 3 * kMmaRows * sizeof(float);
}

// stats: three planes of [B][heads][N] fp32: m log2(e) (m the row max of
// S), 1 / l and D = rowsum(P * dP).
__device__ __forceinline__ size_t mma_stat_index(int b, int h, int n, int N) {
  return (static_cast<size_t>(b) * gridDim.y + h) * N + n;
}

// dQ and the row statistics for one (64-query tile, head, image). Steps
// 0..nt-1 give m, l and a = sum of exp(S - m) * dP; steps nt..2nt-1 give
// dS = P (dP - a / l), rounded, and dQ += dS . K. kScaled (the block): S
// is scaled by `scale` inside the exp2 FMA (multiplier scale_log2e, and the
// stored m is m scale log2(e)), dS is multiplied by `scale` before it is
// rounded, and part gets the CTA's column sums of dQ; without it (#6)
// neither scale nor part is read.
template <int HD, bool kScaled>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_q_mma_kernel(HeadView<const bf16> q, HeadView<const bf16> k,
                      HeadView<const bf16> v, HeadView<const bf16> g_in,
                      HeadView<bf16> dq, float* __restrict__ stats,
                      float* __restrict__ part, int N, float scale,
                      float scale_log2e) {
  const float c2 = kScaled ? scale_log2e : kLog2e;
  using TL = MmaTile<HD>;
  constexpr int LD = TL::kLd;
  constexpr int KB = HD / 16;
  constexpr int CN = chunk_nb<HD>();
  constexpr bool kRes = resident<HD>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);         // [stage][K, V]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int nt = (N + kMmaRows - 1) / kMmaRows;
  auto sK = [&](int s) { return ring + (2 * (s & 1)) * TL::kElems; };
  auto sV = [&](int s) { return ring + (2 * (s & 1) + 1) * TL::kElems; };
  auto load_step = [&](int s) {
    const int k0 = (s < nt ? s : s - nt) * kMmaRows;
    const int kv = min(kMmaRows, N - k0);
    load_rows_async<HD>(sK(s), k.row(b, h, k0), k.sr, kv);
    load_rows_async<HD>(sV(s), v.row(b, h, k0), v.sr, kv);
    cp_async_commit();
  };

  // Q and dO: through stage 1 into registers, or kept past the ring.
  bf16* sQ = kRes ? sK(1) : ring + 4 * TL::kElems;
  bf16* sG = kRes ? sV(1) : ring + 5 * TL::kElems;
  const int qv = min(kMmaRows, N - q0);
  load_rows_async<HD>(sQ, q.row(b, h, q0), q.sr, qv);
  load_rows_async<HD>(sG, g_in.row(b, h, q0), g_in.sr, qv);
  load_step(0);
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[kRes ? KB : 1][4], ga[kRes ? KB : 1][4];
  if constexpr (kRes) {
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      ldsm_x4(qa[kk], a_addr<LD>(sQ, 16 * warp, 16 * kk, lane));
      ldsm_x4(ga[kk], a_addr<LD>(sG, 16 * warp, 16 * kk, lane));
    }
  }
  auto q_frag = [&](int kk, uint32_t (&a)[4]) {
    if constexpr (kRes) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qa[kk][i];
    } else {
      ldsm_x4(a, a_addr<LD>(sQ, 16 * warp, 16 * kk, lane));
    }
  };
  auto g_frag = [&](int kk, uint32_t (&a)[4]) {
    if constexpr (kRes) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ga[kk][i];
    } else {
      ldsm_x4(a, a_addr<LD>(sG, 16 * warp, 16 * kk, lane));
    }
  };

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f}, a_sum[2] = {0.f, 0.f};
  float inv_l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  float dqa[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
  }

  for (int s = 0; s < 2 * nt; ++s) {
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < 2 * nt) load_step(s + 1);
    const int kv = min(kMmaRows, N - (s < nt ? s : s - nt) * kMmaRows);
#pragma unroll 1
    for (int c0 = 0; c0 < kMmaRows; c0 += 8 * CN) {
      float sc[CN][4], dp[CN][4];
      mma_abt<HD, CN>(sc, q_frag, sK(s), c0, lane);
      mma_abt<HD, CN>(dp, g_frag, sV(s), c0, lane);
      if (kv < kMmaRows) mask_columns<CN>(sc, c0, kv, t);
      if (s < nt) {
        // 1. m, l and a, rescaled as m grows.
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            mx = fmaxf(mx, fmaxf(sc[j][2 * half], sc[j][2 * half + 1]));
          }
          const float mn = fmaxf(m[half], quad_max(mx));
          const float mn2 = mn * c2;
          float e = 0.f, a = 0.f;
#pragma unroll
          for (int j = 0; j < CN; ++j) {
#pragma unroll
            for (int w = 0; w < 2; ++w) {
              const float x = exp2f(fmaf(sc[j][2 * half + w], c2, -mn2));
              e += x;
              a += x * dp[j][2 * half + w];
            }
          }
          const float corr = exp2f((m[half] - mn) * c2);
          l[half] = l[half] * corr + e;
          a_sum[half] = a_sum[half] * corr + a;
          m[half] = mn;
        }
      } else {
        // 2. dS = P (dP - D), rounded, and dQ += dS . K.
#pragma unroll
        for (int j = 0; j < CN; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                exp2f(fmaf(sc[j][e], c2, -m[e >> 1])) * inv_l[e >> 1];
            const float ds = p * (dp[j][e] - dsum[e >> 1]);
            sc[j][e] = kScaled ? ds * scale : ds;
          }
        }
        uint32_t da[CN / 2][4];
        c_to_a<CN>(sc, da);
        mma_pv<HD, CN / 2>(dqa, da, sK(s), c0, lane);
      }
    }
    if (s == nt - 1) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float lt = quad_sum(l[half]);
        inv_l[half] = 1.f / lt;
        dsum[half] = quad_sum(a_sum[half]) / lt;
        m[half] *= c2;                        // pass 2 reads m c2
      }
      const size_t plane = static_cast<size_t>(gridDim.z) * gridDim.y * N;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = q0 + 16 * warp + g + 8 * half;
        if (t == 0 && r < N) {
          const size_t i = mma_stat_index(b, h, r, N);
          stats[i] = m[half];
          stats[plane + i] = inv_l[half];
          stats[2 * plane + i] = dsum[half];
        }
      }
    }
  }
  store_rows<HD, bf16>(dq, b, h, q0 + 16 * warp, N, dqa, g, t);
  if constexpr (kScaled) {
    const int r0 = q0 + 16 * warp + g;
    const bool ok[2] = {r0 < N, r0 + 8 < N};
    float* scratch = reinterpret_cast<float*>(smem);
    const int D = gridDim.y * HD;
    __syncthreads();                          // the ring is free
    warp_col_partial<HD / 8>(dqa, ok, scratch + warp * HD, lane);
    __syncthreads();
    cta_col_sum<HD>(scratch, part_row(part, b, D) + h * HD);
  }
}

// dK and dV for one (64-key tile, head, image), over the query tiles in
// order: S^T = K . Q^T and dP^T = V . dO^T, P^T and dS^T from the stored
// m log2(e) (m scale log2(e) with kScaled), 1 / l and D, dV += P^T
// (rounded) . dO and dK += dS^T (rounded) . Q; kScaled as the query side,
// part getting the CTA's column sums of dK and dV.
template <int HD, bool kScaled>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_kv_mma_kernel(HeadView<const bf16> q, HeadView<const bf16> k,
                       HeadView<const bf16> v, HeadView<const bf16> g_in,
                       HeadView<bf16> dk, HeadView<bf16> dv,
                       const float* __restrict__ stats,
                       float* __restrict__ part, int N, float scale,
                       float scale_log2e) {
  const float c2 = kScaled ? scale_log2e : kLog2e;
  using TL = MmaTile<HD>;
  constexpr int LD = TL::kLd;
  constexpr int KB = HD / 16;
  constexpr int CN = chunk_nb<HD>();
  constexpr bool kRes = resident<HD>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);         // [stage][Q, dO]
  float* sStat = reinterpret_cast<float*>(smem + 4 * TL::kBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int nt = (N + kMmaRows - 1) / kMmaRows;
  const size_t plane = static_cast<size_t>(gridDim.z) * gridDim.y * N;
  auto sQ = [&](int s) { return ring + (2 * (s & 1)) * TL::kElems; };
  auto sG = [&](int s) { return ring + (2 * (s & 1) + 1) * TL::kElems; };
  auto sSt = [&](int s) { return sStat + (s & 1) * 3 * kMmaRows; };
  auto load_step = [&](int s) {
    const int r0 = s * kMmaRows;
    const int qv = min(kMmaRows, N - r0);
    load_rows_async<HD>(sQ(s), q.row(b, h, r0), q.sr, qv);
    load_rows_async<HD>(sG(s), g_in.row(b, h, r0), g_in.sr, qv);
    const float* src = stats + mma_stat_index(b, h, r0, N);
    for (int i = threadIdx.x; i < 3 * kMmaRows; i += kMmaThreads) {
      const int p = i / kMmaRows, r = i - p * kMmaRows;
      const bool ok = r < qv;
      cp_async4(sSt(s) + i, ok ? src + p * plane + r : src, ok);
    }
    cp_async_commit();
  };

  // K and V: through stage 1 into registers, or kept past the stat rows.
  bf16* sKo = kRes ? sQ(1)
                   : reinterpret_cast<bf16*>(smem + 4 * TL::kBytes +
                                             2 * 3 * kMmaRows *
                                                 sizeof(float));
  bf16* sVo = kRes ? sG(1) : sKo + TL::kElems;
  const int kvalid = min(kMmaRows, N - k0);
  load_rows_async<HD>(sKo, k.row(b, h, k0), k.sr, kvalid);
  load_rows_async<HD>(sVo, v.row(b, h, k0), v.sr, kvalid);
  load_step(0);
  cp_async_wait_all();
  __syncthreads();
  uint32_t ka[kRes ? KB : 1][4], va[kRes ? KB : 1][4];
  if constexpr (kRes) {
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      ldsm_x4(ka[kk], a_addr<LD>(sKo, 16 * warp, 16 * kk, lane));
      ldsm_x4(va[kk], a_addr<LD>(sVo, 16 * warp, 16 * kk, lane));
    }
  }
  auto k_frag = [&](int kk, uint32_t (&a)[4]) {
    if constexpr (kRes) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ka[kk][i];
    } else {
      ldsm_x4(a, a_addr<LD>(sKo, 16 * warp, 16 * kk, lane));
    }
  };
  auto v_frag = [&](int kk, uint32_t (&a)[4]) {
    if constexpr (kRes) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = va[kk][i];
    } else {
      ldsm_x4(a, a_addr<LD>(sVo, 16 * warp, 16 * kk, lane));
    }
  };

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
  }
  const bool key_ok[2] = {k0 + 16 * warp + g < N, k0 + 16 * warp + g + 8 < N};

  for (int s = 0; s < nt; ++s) {
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < nt) load_step(s + 1);
    const int qv = min(kMmaRows, N - s * kMmaRows);
    const float* sM = sSt(s);
    const float* sL = sM + kMmaRows;
    const float* sD = sL + kMmaRows;
#pragma unroll 1
    for (int c0 = 0; c0 < kMmaRows; c0 += 8 * CN) {
      float st[CN][4], dpt[CN][4];
      mma_abt<HD, CN>(st, k_frag, sQ(s), c0, lane);
      mma_abt<HD, CN>(dpt, v_frag, sG(s), c0, lane);
#pragma unroll
      for (int j = 0; j < CN; ++j) {
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int c = c0 + 8 * j + 2 * t + w;     // query within the tile
          const bool q_ok = c < qv;
          const float mq = sM[c], il = sL[c], dq_ = sD[c];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = 2 * half + w;
            const bool ok = q_ok && key_ok[half];
            const float p =
                ok ? exp2f(fmaf(st[j][e], c2, -mq)) * il : 0.f;
            st[j][e] = p;
            const float ds = p * (dpt[j][e] - dq_);
            dpt[j][e] = ok ? (kScaled ? ds * scale : ds) : 0.f;
          }
        }
      }
      uint32_t pa[CN / 2][4], da[CN / 2][4];
      c_to_a<CN>(st, pa);
      c_to_a<CN>(dpt, da);
      mma_pv<HD, CN / 2>(dva, pa, sG(s), c0, lane);
      mma_pv<HD, CN / 2>(dka, da, sQ(s), c0, lane);
    }
  }
  store_rows<HD, bf16>(dk, b, h, k0 + 16 * warp, N, dka, g, t);
  store_rows<HD, bf16>(dv, b, h, k0 + 16 * warp, N, dva, g, t);
  if constexpr (kScaled) {
    float* scratch = reinterpret_cast<float*>(smem);
    const int D = gridDim.y * HD;
    float* dst = part_row(part, b, D) + h * HD;
    __syncthreads();                          // the ring is free
    warp_col_partial<HD / 8>(dka, key_ok, scratch + warp * HD, lane);
    warp_col_partial<HD / 8>(dva, key_ok, scratch + (kMmaWarps + warp) * HD,
                         lane);
    __syncthreads();
    cta_col_sum<HD>(scratch, dst + D);
    cta_col_sum<HD>(scratch + kMmaWarps * HD, dst + 2 * D);
  }
}

// ---- launches --------------------------------------------------------------

template <int HD, typename OutT, bool kScaled>
cudaError_t launch_fwd_mma_hd(HeadView<const bf16> q, HeadView<const bf16> k,
                              HeadView<const bf16> v, HeadView<OutT> out,
                              int B, int heads, int N, float scale_log2e,
                              cudaStream_t stream) {
  constexpr size_t sm = fwd_mma_smem<HD>();
  const auto kernel = attn_fwd_mma_kernel<HD, OutT, kScaled>;
  cudaError_t e;
  if ((e = set_smem(kernel, sm)) != cudaSuccess) return e;
  const dim3 grid((N + kMmaRows - 1) / kMmaRows, heads, B);
  kernel<<<grid, kMmaThreads, sm, stream>>>(q, k, v, out, N, scale_log2e);
  return cudaGetLastError();
}

template <int HD, bool kScaled>
cudaError_t launch_bwd_mma_hd(HeadView<const bf16> q, HeadView<const bf16> k,
                              HeadView<const bf16> v, HeadView<const bf16> g,
                              HeadView<bf16> dq, HeadView<bf16> dk,
                              HeadView<bf16> dv, float* stats, float* part,
                              int B, int heads, int N, float scale,
                              cudaStream_t stream) {
  const dim3 grid((N + kMmaRows - 1) / kMmaRows, heads, B);
  constexpr size_t smq = bwd_q_mma_smem<HD>();
  constexpr size_t smk = bwd_kv_mma_smem<HD>();
  const auto qk = attn_bwd_q_mma_kernel<HD, kScaled>;
  const auto kvk = attn_bwd_kv_mma_kernel<HD, kScaled>;
  const float c2 = scale * kLog2e;
  cudaError_t e;
  if ((e = set_smem(qk, smq)) != cudaSuccess) return e;
  qk<<<grid, kMmaThreads, smq, stream>>>(q, k, v, g, dq, stats, part, N,
                                         scale, c2);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = set_smem(kvk, smk)) != cudaSuccess) return e;
  kvk<<<grid, kMmaThreads, smk, stream>>>(q, k, v, g, dk, dv, stats, part,
                                          N, scale, c2);
  return cudaGetLastError();
}

// The head widths attention_head_ok takes: every multiple of 16 to 128.
#define ATTN_MMA_DISPATCH(HD_VAR, CALL)                                     \
  switch (HD_VAR) {                                                         \
    case 16: return CALL(16);                                               \
    case 32: return CALL(32);                                               \
    case 48: return CALL(48);                                               \
    case 64: return CALL(64);                                               \
    case 80: return CALL(80);                                               \
    case 96: return CALL(96);                                               \
    case 112: return CALL(112);                                             \
    case 128: return CALL(128);                                             \
    default: return cudaErrorInvalidValue;                                  \
  }

// The dispatchers are templates, so a source that includes this header
// compiles only the kernels it launches. #5: OutT float, kScaled false
// (scale not read); the ViT block: bf16 and true.
template <typename OutT, bool kScaled>
cudaError_t launch_attention_fwd_mma(HeadView<const bf16> q,
                                     HeadView<const bf16> k,
                                     HeadView<const bf16> v,
                                     HeadView<OutT> out, int B, int heads,
                                     int N, int hd, float scale,
                                     cudaStream_t stream) {
  const float c2 = scale * kLog2e;
#define ATTN_FWD_CALL(HD)                                                   \
  launch_fwd_mma_hd<HD, OutT, kScaled>(q, k, v, out, B, heads, N, c2,       \
                                       stream)
  ATTN_MMA_DISPATCH(hd, ATTN_FWD_CALL)
#undef ATTN_FWD_CALL
}

template <typename T>
cudaError_t launch_attention_bwd_mma(HeadView<const T> q,
                                     HeadView<const T> k,
                                     HeadView<const T> v,
                                     HeadView<const T> g,
                                     HeadView<T> dq, HeadView<T> dk,
                                     HeadView<T> dv, float* stats, int B,
                                     int heads, int N, int hd,
                                     cudaStream_t stream) {
  static_assert(std::is_same<T, bf16>::value, "bf16 only");
#define ATTN_BWD_CALL(HD)                                                   \
  launch_bwd_mma_hd<HD, false>(q, k, v, g, dq, dk, dv, stats, nullptr, B,   \
                               heads, N, 1.0f, stream)
  ATTN_MMA_DISPATCH(hd, ATTN_BWD_CALL)
#undef ATTN_BWD_CALL
}

// The ViT block's attention backward (#2, #4): q not pre-scaled, so the
// block's scale is folded into the exp2 FMA and dS is multiplied by it in
// fp32 before it is rounded; part gets B * ceil(N / 64) rows of
// [dq | dk | dv] column sums (3 * heads * hd fp32) from the fp32
// accumulators, for the qkv bias grad.
template <typename T>
cudaError_t launch_attention_bwd_block_mma(
    HeadView<const T> q, HeadView<const T> k, HeadView<const T> v,
    HeadView<const T> g, HeadView<T> dq, HeadView<T> dk, HeadView<T> dv,
    float* stats, float* part, int B, int heads, int N, int hd, float scale,
    cudaStream_t stream) {
  static_assert(std::is_same<T, bf16>::value, "bf16 only");
#define ATTN_BWD_CALL(HD)                                                   \
  launch_bwd_mma_hd<HD, true>(q, k, v, g, dq, dk, dv, stats, part, B,       \
                              heads, N, scale, stream)
  ATTN_MMA_DISPATCH(hd, ATTN_BWD_CALL)
#undef ATTN_BWD_CALL
}

#undef ATTN_MMA_DISPATCH

}  // namespace
