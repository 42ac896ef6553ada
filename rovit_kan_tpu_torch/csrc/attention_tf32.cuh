// Softmax attention in fp32 on Hopper (sm_90a) with 3xTF32 mma.sync: the
// forward and the two backward stages of the attention-only kernels #5 and
// #6 in fp32 (attention.cu), with S, P, dS and every accumulator in
// registers; the forward is also the attention stage of the fp32 ViT-block
// forwards #1 and #3 and of #2's recompute (vit_block_common.cuh), with the
// block's scale folded in (kScaled). The fp32 block backward's attention
// stage is attention_fma.cuh's.
//
// Replaces rovit_kan_tpu/ops/attention.py::_attention_kernel and
// ::_attention_bwd_kernel for fp32 inputs, with scale 1 (q comes
// pre-scaled), and the attention part of block_kernel.py's fp32 kernels,
// where q is scaled by hd^-1/2 inside the softmax. It took the place of
// the first design's streamed FMA stages (S, P and dS through shared
// memory: 2.6x and 2.3x PyTorch's fp32 SDPA at (32, 3, 577, 64), and 2.1x
// and more the block's layer forward).
//
// What bounds #5/#6 in fp32 at (B, heads, N, hd) = (32, 3, 577, 64): #5 two
// N x N x hd products, 8.18 GFLOP, #6 five (S again, dV, dP, dQ, dK),
// 20.5 GFLOP, of fp32-accurate products, against 56.7 MB and 99.3 MB of
// inputs and outputs (17 and 30 us at 3.35 TB/s). On the FMA units (67
// TFLOP/s) that is 0.122 and 0.305 ms; as 3xTF32, three tensor-core
// products each at the 495 TFLOP/s TF32 peak, 0.050 and 0.124 ms, about
// 165 TFLOP/s of fp32-accurate products. Both are operations-bound.
//
// Why 3xTF32: an FMA design spends one instruction per 32 multiply-adds a
// warp, and the fp32 FMA kernels of this card's block backward reached
// about a third of the FMA peak; PyTorch's fp32 SDPA (the memory-efficient
// CUTLASS kernel, OpMultiplyAddFastF32) is itself a 3xTF32 tensor-core
// kernel, so an FMA kernel cannot reach it. One m16n8k8 product is 1,024
// multiply-adds a warp per instruction. A single TF32 product keeps 11
// significant bits (about three decimal digits), far outside fp32's
// tolerances; 3xTF32 drops only lo . lo and keeps about 2^-21 relative per
// product (tf32_common.cuh).
//
// The design is attention_mma.cuh's, in fp32:
//   - a CTA of 4 warps owns 64 rows (queries; keys on the backward's key
//     side), each warp 16; the other side streams in 64-row fp32 tiles by
//     cp.async (a two-stage ring in the forward, one stage in the
//     backward), rows past N zero-filled by the source size 0 and masked
//     in registers; tiles have a row stride of hd + 4 floats, so every
//     fragment load is free of bank conflicts;
//   - products are mma.sync.m16n8k8 TF32 triples (lo . hi, hi . lo,
//     hi . hi) accumulated in fp32; each operand is split into its TF32
//     high and low parts as its fragment is loaded (the forward's own q
//     rows once, into registers, at a head width up to 64). Splitting each
//     streamed tile once on arrival into hi and lo planes instead doubled
//     the forward's shared memory and ran slower on the card;
//   - S (and dP) come out as C fragments; P (and dS) are formed there in
//     fp32 and feed the next product from registers with no shuffle: its k
//     order is the key permutation tq -> 2 tq, tq + 4 -> 2 tq + 1, so the A
//     fragment is (c0, c2, c1, c3) and the B fragment reads tile rows 2 tq
//     and 2 tq + 1. The key side does the same with S^T and dP^T (rows =
//     keys) for P^T . dO and dS^T . Q;
//   - row max and sums are reduced over the quad by shuffles; the forward
//     makes two passes over the keys (statistics, then P normalized in
//     fp32 and O += P . V), because the TPU kernel normalizes P before the
//     product; the backward's query side two (m, l and a = sum of
//     exp(S - m) dP, then dS = P (dP - a / l) and dQ += dS . K), storing
//     m log2(e), 1 / l and D = a / l in `stats`; the key side reads them,
//     forms P^T and dS^T itself and adds dV += P^T . dO and dK += dS^T . Q
//     over the query tiles in order. rowsum(P dP) is summed as the TPU
//     kernel's, not as dO . O: #6 receives no O.
// The backward's own rows stay in shared memory and are split at each A
// fragment load (in registers they would take 128 at head width 64; split
// once into hi and lo planes in shared memory they cost a CTA an SM and ran
// #6 slower); its products run over chunks of 64 keys (32 above a head
// width of 64) on the query side and of 32 queries on the key side, which
// bounds the live S and dP fragments (64-query chunks spilled the key side
// at 255 registers, and 32-key chunks on the query side, each ran #6
// slower). Shared memory at head width 64:
// 70 KB (forward, query side and key side); at 128, 169, 135 and 136 KB.
//
// Rounding: every product in 3xTF32 with fp32 accumulation; P and dS in
// fp32; nothing rounded to the input type, since it is fp32; dq, dk, dv
// stored once in fp32. exp(S - m) is exp2f(S log2(e) - m log2(e)). In the
// block (kScaled) P is still normalized in fp32 before P . V, the TPU
// kernel's order (rovit_kan_tpu/ops/block_kernel.py:118-128), and O is
// stored once in fp32; the only change is that the scale sits in the exp2
// FMA, exp2f(S scale log2(e) - m scale log2(e)), instead of multiplying S
// first, with m the row max of the unscaled S. Each
// output element has one owner that sums in a fixed order: no atomics, the
// same bits on every call. The query side's S and the key side's S^T take
// their small products in another order, so their P may differ in the last
// bits, well inside the tolerances.

#pragma once

#include "attention_mma.cuh"
#include "tf32_common.cuh"

namespace {

// A 64-row fp32 tile of head width HD in shared memory, rows padded by 4
// floats: the fragment loads' 32 addresses fall in 32 banks.
template <int HD>
struct Tf32Tile {
  static constexpr int kLd = HD + 4;
  static constexpr int kElems = kMmaRows * kLd;
  static constexpr size_t kBytes = sizeof(float) * kElems;
};

// The forward keeps its q rows' split A fragments in registers up to a
// head width of 64 (64 registers), and reloads them above.
template <int HD>
__host__ __device__ constexpr bool tf32_resident() { return HD <= 64; }

// 8-column blocks per chunk of a backward tile's products: the query side
// takes 64 keys a chunk up to a head width of 64, the key side 32 queries
// at every width (its dK and dV accumulators leave no room for more).
template <int HD, bool kKeySide>
__host__ __device__ constexpr int tf32_chunk_nb() {
  return HD <= 64 && !kKeySide ? 8 : 4;
}

template <int HD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long sr, int valid) {
  load_rows_f32_async<kMmaRows, HD, Tf32Tile<HD>::kLd, kMmaThreads>(
      dst, src, sr, valid);
}

// acc[NB] = A . B^T over depth HD: A the warp's 16 own rows (a_frag(kk, a)
// gives depth block kk, split), B rows n0..n0 + 8 NB - 1 of a streamed
// [n][HD] tile.
template <int HD, int NB, typename AFrag>
__device__ __forceinline__ void tf32_abt(float (&acc)[NB][4], AFrag a_frag,
                                         const float* tile, int n0, int g,
                                         int tq) {
  zero_acc(acc);
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    Tf32Frag<4> a;
    a_frag(kk, a);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      Tf32Frag<2> b;
      tf32_b_nk<Tf32Tile<HD>::kLd>(b, tile, n0 + 8 * j, 8 * kk, g, tq);
      mma_3xtf32(acc[j], a, b);
    }
  }
}

// acc[HD / 8] += P . T: P the warp's 16 rows over tile rows k0..k0 + 8 KB
// - 1, as C fragments p[KB] (fp32), T a streamed [k][HD] tile.
template <int HD, int KB>
__device__ __forceinline__ void tf32_pv(float (&acc)[HD / 8][4],
                                        const float (&p)[KB][4],
                                        const float* tile, int k0, int g,
                                        int tq) {
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    Tf32Frag<4> a;
    tf32_c_to_a(a, p[kb]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      Tf32Frag<2> b;
      tf32_b_kn_perm<Tf32Tile<HD>::kLd>(b, tile, k0 + 8 * kb, 8 * n, g,
                                        tq);
      mma_3xtf32(acc[n], a, b);
    }
  }
}

// ---- forward (#5) ----------------------------------------------------------

template <int HD>
constexpr size_t fwd_tf32_smem() {
  return (tf32_resident<HD>() ? 4 : 5) * Tf32Tile<HD>::kBytes;
}

// out = softmax(q k^T * scale) v for one (64-query tile, head, image),
// fp32. Steps 0..nt-1 stream K for the statistics, steps nt..2nt-1 K and V.
// kScaled (the ViT block, whose q is not pre-scaled): the row max is that
// of the unscaled S (the same element, as scale > 0) and the exp2 FMA's
// multiplier is scale log2(e), passed as scale_log2e; without it (#5) the
// multiplier is the constant log2(e) and scale_log2e is not read, so #5
// keeps its instructions and its bits.
template <int HD, bool kScaled>
__global__ void __launch_bounds__(kMmaThreads)
attn_fwd_tf32_kernel(HeadView<const float> q, HeadView<const float> k,
                     HeadView<const float> v, HeadView<float> out, int N,
                     float scale_log2e) {
  const float c2 = kScaled ? scale_log2e : kLog2e;
  using TL = Tf32Tile<HD>;
  constexpr int LD = TL::kLd;
  constexpr int KB = HD / 8;
  constexpr int NB = kMmaRows / 8;                    // S blocks per tile
  constexpr bool kRes = tf32_resident<HD>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);       // [stage][K, V]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int nt = (N + kMmaRows - 1) / kMmaRows;
  auto sK = [&](int s) { return ring + (2 * (s & 1)) * TL::kElems; };
  auto sV = [&](int s) { return ring + (2 * (s & 1) + 1) * TL::kElems; };
  auto load_step = [&](int s) {
    const int k0 = (s < nt ? s : s - nt) * kMmaRows;
    const int kv = min(kMmaRows, N - k0);
    load_tile_f32<HD>(sK(s), k.row(b, h, k0), k.sr, kv);
    if (s >= nt) load_tile_f32<HD>(sV(s), v.row(b, h, k0), v.sr, kv);
    cp_async_commit();
  };

  // Q through stage 1's K buffer into registers, or kept past the ring.
  float* sQ = kRes ? sK(1) : ring + 4 * TL::kElems;
  load_tile_f32<HD>(sQ, q.row(b, h, q0), q.sr, min(kMmaRows, N - q0));
  load_step(0);
  cp_async_wait_all();
  __syncthreads();
  Tf32Frag<4> qa[kRes ? KB : 1];
  if constexpr (kRes) {
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      tf32_a_rows<LD>(qa[kk], sQ, 16 * warp, 8 * kk, g, tq);
    }
  }
  auto q_frag = [&](int kk, Tf32Frag<4>& a) {
    if constexpr (kRes) {
      a = qa[kk];
    } else {
      tf32_a_rows<LD>(a, sQ, 16 * warp, 8 * kk, g, tq);
    }
  };

  float m[2] = {-INFINITY, -INFINITY};    // rows g, g + 8
  float l[2] = {0.f, 0.f};                // this thread's columns only
  float inv_l[2] = {0.f, 0.f};
  float o[HD / 8][4];
  zero_acc(o);

  for (int s = 0; s < 2 * nt; ++s) {
    cp_async_wait_all();
    __syncthreads();             // step s landed; step s - 1's stage is free
    if (s + 1 < 2 * nt) load_step(s + 1);
    const int kv = min(kMmaRows, N - (s < nt ? s : s - nt) * kMmaRows);
    float sc[NB][4];
    tf32_abt<HD, NB>(sc, q_frag, sK(s), 0, g, tq);
    if (kv < kMmaRows) mask_columns<NB>(sc, 0, kv, tq);
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
      // 2. P = exp(S - m) / l in fp32, and O += P . V.
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = exp2f(fmaf(sc[j][e], c2, -m[e >> 1])) *
                     inv_l[e >> 1];
        }
      }
      tf32_pv<HD, NB>(o, sc, sV(s), 0, g, tq);
    }
  }
  store_rows<HD, float>(out, b, h, q0 + 16 * warp, N, o, g, tq);
}

// ---- backward (#6) ---------------------------------------------------------

// The backward streams through one stage (a copy waits for the products
// of the tile before it), which keeps shared memory at four tiles so that
// three CTAs share an SM and hide each other's copies: faster on the card
// than a two-stage ring at two CTAs an SM.
// Query side: K and V, then Q and dO.
template <int HD>
constexpr size_t bwd_q_tf32_smem() { return 4 * Tf32Tile<HD>::kBytes; }
// Key side: Q and dO, the tile's m, 1 / l and D rows, then K and V.
template <int HD>
constexpr size_t bwd_kv_tf32_smem() {
  return 4 * Tf32Tile<HD>::kBytes + 3 * kMmaRows * sizeof(float);
}

// dQ and the row statistics for one (64-query tile, head, image). Steps
// 0..nt-1 give m, l and a = sum of exp(S - m) * dP; steps nt..2nt-1 give
// dS = P (dP - a / l) and dQ += dS . K.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_q_tf32_kernel(HeadView<const float> q, HeadView<const float> k,
                       HeadView<const float> v, HeadView<const float> g_in,
                       HeadView<float> dq, float* __restrict__ stats, int N) {
  using TL = Tf32Tile<HD>;
  constexpr int LD = TL::kLd;
  constexpr int CN = tf32_chunk_nb<HD, false>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + TL::kElems;
  float* sQ = sK + 2 * TL::kElems;
  float* sG = sK + 3 * TL::kElems;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int nt = (N + kMmaRows - 1) / kMmaRows;
  auto load_step = [&](int s) {
    const int k0 = (s < nt ? s : s - nt) * kMmaRows;
    const int kv = min(kMmaRows, N - k0);
    load_tile_f32<HD>(sK, k.row(b, h, k0), k.sr, kv);
    load_tile_f32<HD>(sV, v.row(b, h, k0), v.sr, kv);
    cp_async_commit();
  };

  const int qv = min(kMmaRows, N - q0);
  load_tile_f32<HD>(sQ, q.row(b, h, q0), q.sr, qv);
  load_tile_f32<HD>(sG, g_in.row(b, h, q0), g_in.sr, qv);
  load_step(0);
  auto q_frag = [&](int kk, Tf32Frag<4>& a) {
    tf32_a_rows<LD>(a, sQ, 16 * warp, 8 * kk, g, tq);
  };
  auto g_frag = [&](int kk, Tf32Frag<4>& a) {
    tf32_a_rows<LD>(a, sG, 16 * warp, 8 * kk, g, tq);
  };

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f}, a_sum[2] = {0.f, 0.f};
  float inv_l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  float dqa[HD / 8][4];
  zero_acc(dqa);

  for (int s = 0; s < 2 * nt; ++s) {
    cp_async_wait_all();
    __syncthreads();                          // step s landed
    const int kv = min(kMmaRows, N - (s < nt ? s : s - nt) * kMmaRows);
#pragma unroll 1
    for (int c0 = 0; c0 < kMmaRows; c0 += 8 * CN) {
      float sc[CN][4], dp[CN][4];
      tf32_abt<HD, CN>(sc, q_frag, sK, c0, g, tq);
      tf32_abt<HD, CN>(dp, g_frag, sV, c0, g, tq);
      if (kv < kMmaRows) mask_columns<CN>(sc, c0, kv, tq);
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
          const float mn2 = mn * kLog2e;
          float e = 0.f, a = 0.f;
#pragma unroll
          for (int j = 0; j < CN; ++j) {
#pragma unroll
            for (int w = 0; w < 2; ++w) {
              const float x = exp2f(fmaf(sc[j][2 * half + w], kLog2e, -mn2));
              e += x;
              a += x * dp[j][2 * half + w];
            }
          }
          const float corr = exp2f((m[half] - mn) * kLog2e);
          l[half] = l[half] * corr + e;
          a_sum[half] = a_sum[half] * corr + a;
          m[half] = mn;
        }
      } else {
        // 2. dS = P (dP - D) in fp32, and dQ += dS . K.
#pragma unroll
        for (int j = 0; j < CN; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                exp2f(fmaf(sc[j][e], kLog2e, -m[e >> 1])) * inv_l[e >> 1];
            sc[j][e] = p * (dp[j][e] - dsum[e >> 1]);
          }
        }
        tf32_pv<HD, CN>(dqa, sc, sK, c0, g, tq);
      }
    }
    if (s == nt - 1) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float lt = quad_sum(l[half]);
        inv_l[half] = 1.f / lt;
        dsum[half] = quad_sum(a_sum[half]) / lt;
        m[half] *= kLog2e;                    // pass 2 reads m log2(e)
      }
      const size_t plane = static_cast<size_t>(gridDim.z) * gridDim.y * N;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = q0 + 16 * warp + g + 8 * half;
        if (tq == 0 && r < N) {
          const size_t i = mma_stat_index(b, h, r, N);
          stats[i] = m[half];
          stats[plane + i] = inv_l[half];
          stats[2 * plane + i] = dsum[half];
        }
      }
    }
    __syncthreads();                          // step s is read
    if (s + 1 < 2 * nt) load_step(s + 1);
  }
  store_rows<HD, float>(dq, b, h, q0 + 16 * warp, N, dqa, g, tq);
}

// CTAs an SM that the key side's register cap is set for: three fit in
// shared memory up to a head width of 64 (70 KB each, a cap of 168
// registers); above it two fit at most (86 and 102 KB at 80 and 96, 136 KB
// at 128), so the cap is lifted rather than spill the dK and dV
// accumulators for CTAs that cannot share the SM.
template <int HD>
__host__ __device__ constexpr int bwd_kv_tf32_ctas() {
  return HD <= 64 ? 3 : 1;
}

// dK and dV for one (64-key tile, head, image), over the query tiles in
// order: S^T = K . Q^T and dP^T = V . dO^T, P^T and dS^T from the stored
// m log2(e), 1 / l and D, dV += P^T . dO and dK += dS^T . Q.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, bwd_kv_tf32_ctas<HD>())
attn_bwd_kv_tf32_kernel(HeadView<const float> q, HeadView<const float> k,
                        HeadView<const float> v, HeadView<const float> g_in,
                        HeadView<float> dk, HeadView<float> dv,
                        const float* __restrict__ stats, int N) {
  using TL = Tf32Tile<HD>;
  constexpr int LD = TL::kLd;
  constexpr int CN = tf32_chunk_nb<HD, true>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sG = sQ + TL::kElems;
  float* sM = sQ + 2 * TL::kElems;            // m log2(e), then 1 / l, D
  float* sKo = sM + 3 * kMmaRows;
  float* sVo = sKo + TL::kElems;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int nt = (N + kMmaRows - 1) / kMmaRows;
  const size_t plane = static_cast<size_t>(gridDim.z) * gridDim.y * N;
  auto load_step = [&](int s) {
    const int r0 = s * kMmaRows;
    const int qv = min(kMmaRows, N - r0);
    load_tile_f32<HD>(sQ, q.row(b, h, r0), q.sr, qv);
    load_tile_f32<HD>(sG, g_in.row(b, h, r0), g_in.sr, qv);
    const float* src = stats + mma_stat_index(b, h, r0, N);
    for (int i = threadIdx.x; i < 3 * kMmaRows; i += kMmaThreads) {
      const int p = i / kMmaRows, r = i - p * kMmaRows;
      const bool ok = r < qv;
      cp_async4(sM + i, ok ? src + p * plane + r : src, ok);
    }
    cp_async_commit();
  };

  const int kvalid = min(kMmaRows, N - k0);
  load_tile_f32<HD>(sKo, k.row(b, h, k0), k.sr, kvalid);
  load_tile_f32<HD>(sVo, v.row(b, h, k0), v.sr, kvalid);
  load_step(0);
  auto k_frag = [&](int kk, Tf32Frag<4>& a) {
    tf32_a_rows<LD>(a, sKo, 16 * warp, 8 * kk, g, tq);
  };
  auto v_frag = [&](int kk, Tf32Frag<4>& a) {
    tf32_a_rows<LD>(a, sVo, 16 * warp, 8 * kk, g, tq);
  };

  float dka[HD / 8][4], dva[HD / 8][4];
  zero_acc(dka);
  zero_acc(dva);
  const bool key_ok[2] = {k0 + 16 * warp + g < N, k0 + 16 * warp + g + 8 < N};

  const float* sL = sM + kMmaRows;
  const float* sD = sL + kMmaRows;
  for (int s = 0; s < nt; ++s) {
    cp_async_wait_all();
    __syncthreads();                          // step s landed
    const int qv = min(kMmaRows, N - s * kMmaRows);
#pragma unroll 1
    for (int c0 = 0; c0 < kMmaRows; c0 += 8 * CN) {
      float st[CN][4], dpt[CN][4];
      tf32_abt<HD, CN>(st, k_frag, sQ, c0, g, tq);
      tf32_abt<HD, CN>(dpt, v_frag, sG, c0, g, tq);
#pragma unroll
      for (int j = 0; j < CN; ++j) {
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int c = c0 + 8 * j + 2 * tq + w;    // query within the tile
          const bool q_ok = c < qv;
          const float mq = sM[c], il = sL[c], dq_ = sD[c];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = 2 * half + w;
            const bool ok = q_ok && key_ok[half];
            const float p =
                ok ? exp2f(fmaf(st[j][e], kLog2e, -mq)) * il : 0.f;
            st[j][e] = p;
            dpt[j][e] = ok ? p * (dpt[j][e] - dq_) : 0.f;
          }
        }
      }
      tf32_pv<HD, CN>(dva, st, sG, c0, g, tq);
      tf32_pv<HD, CN>(dka, dpt, sQ, c0, g, tq);
    }
    __syncthreads();                          // step s is read
    if (s + 1 < nt) load_step(s + 1);
  }
  store_rows<HD, float>(dk, b, h, k0 + 16 * warp, N, dka, g, tq);
  store_rows<HD, float>(dv, b, h, k0 + 16 * warp, N, dva, g, tq);
}

// ---- launches --------------------------------------------------------------

template <int HD, bool kScaled>
cudaError_t launch_fwd_tf32_hd(HeadView<const float> q,
                               HeadView<const float> k,
                               HeadView<const float> v, HeadView<float> out,
                               int B, int heads, int N, float scale_log2e,
                               cudaStream_t stream) {
  constexpr size_t sm = fwd_tf32_smem<HD>();
  const auto kernel = attn_fwd_tf32_kernel<HD, kScaled>;
  cudaError_t e;
  if ((e = set_smem(kernel, sm)) != cudaSuccess) return e;
  const dim3 grid((N + kMmaRows - 1) / kMmaRows, heads, B);
  kernel<<<grid, kMmaThreads, sm, stream>>>(q, k, v, out, N, scale_log2e);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_tf32_hd(HeadView<const float> q,
                               HeadView<const float> k,
                               HeadView<const float> v,
                               HeadView<const float> g, HeadView<float> dq,
                               HeadView<float> dk, HeadView<float> dv,
                               float* stats, int B, int heads, int N,
                               cudaStream_t stream) {
  const dim3 grid((N + kMmaRows - 1) / kMmaRows, heads, B);
  constexpr size_t smq = bwd_q_tf32_smem<HD>();
  constexpr size_t smk = bwd_kv_tf32_smem<HD>();
  const auto qk = attn_bwd_q_tf32_kernel<HD>;
  const auto kvk = attn_bwd_kv_tf32_kernel<HD>;
  cudaError_t e;
  if ((e = set_smem(qk, smq)) != cudaSuccess) return e;
  qk<<<grid, kMmaThreads, smq, stream>>>(q, k, v, g, dq, stats, N);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = set_smem(kvk, smk)) != cudaSuccess) return e;
  kvk<<<grid, kMmaThreads, smk, stream>>>(q, k, v, g, dk, dv, stats, N);
  return cudaGetLastError();
}

// The head widths attention_head_ok takes: every multiple of 16 to 128.
#define ATTN_TF32_DISPATCH(HD_VAR, CALL)                                    \
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
// compiles only the kernels it launches. #5: kScaled false (scale not
// read), out fp32 and contiguous; the ViT block (#1, #3, #2's recompute):
// kScaled true, out a strided view of the block's (B, N, D) buffer.
template <typename T, bool kScaled>
cudaError_t launch_attention_fwd_tf32(HeadView<const T> q,
                                      HeadView<const T> k,
                                      HeadView<const T> v,
                                      HeadView<float> out, int B, int heads,
                                      int N, int hd, float scale,
                                      cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value, "fp32 only");
  const float c2 = scale * kLog2e;
#define ATTN_FWD_CALL(HD)                                                   \
  launch_fwd_tf32_hd<HD, kScaled>(q, k, v, out, B, heads, N, c2, stream)
  ATTN_TF32_DISPATCH(hd, ATTN_FWD_CALL)
#undef ATTN_FWD_CALL
}

// #6: g, dq, dk, dv contiguous; stats 3 * B * heads * N fp32 of scratch.
template <typename T>
cudaError_t launch_attention_bwd_tf32(HeadView<const T> q,
                                      HeadView<const T> k,
                                      HeadView<const T> v,
                                      HeadView<const T> g, HeadView<T> dq,
                                      HeadView<T> dk, HeadView<T> dv,
                                      float* stats, int B, int heads, int N,
                                      int hd, cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value, "fp32 only");
#define ATTN_BWD_CALL(HD)                                                   \
  launch_bwd_tf32_hd<HD>(q, k, v, g, dq, dk, dv, stats, B, heads, N, stream)
  ATTN_TF32_DISPATCH(hd, ATTN_BWD_CALL)
#undef ATTN_BWD_CALL
}

#undef ATTN_TF32_DISPATCH

}  // namespace
