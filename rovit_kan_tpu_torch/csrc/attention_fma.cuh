// The fp32 attention backward of the ViT-block backwards #2 and #4 on Hopper
// (sm_90a): the query side (attn_bwd_q_fma_kernel) and the key side
// (attn_bwd_kv_fma_kernel) of FlashAttention-2's split, with the block's
// scale hd^-1/2 and the fp32 column sums of dQ, dK and dV that give the qkv
// bias grad. It replaced, inside the block, the streamed backward stages of
// the first design (32-row tiles, 4 x 4 FMA micro-tiles in a 256-thread
// CTA, S, dP and dS through shared memory); #6's fp32 instance
// (attention.cu) runs attention_tf32.cuh's 3xTF32 kernels.
//
// Work at (64, 197, 192), 3 heads: the query side's S twice (once for the
// row statistics, once for dS), dP and dQ, the key side's S, dP, dK and
// dV: eight 64 x 64 x hd products per (query tile, key tile), 12.9 GFLOP
// with the 197 tokens padded to 256, 0.19 ms at the 67 TFLOP/s fp32 FMA
// peak (the 6.7 GFLOP the unpadded S, dP, dQ, dK and dV need: 0.10 ms);
// its bytes (q, k, v, dO, O, dq, dk, dv, 4.8 MB a side) take 0.002 ms, so
// it is compute-bound.
//
// Design, on fma_common.cuh's engine: a CTA of 4 warps owns 64 rows (query
// rows on the query side, key rows on the key side) as a 16 x 8 grid of
// threads, each warp 4 rows of lanes by 8 columns; a thread holds 4 rows x
// 8 columns of S and of dP (columns one apart, 32 accumulators each) and
// 4 x hd / 8 of its output. The eight column threads of a row are lanes of
// one warp, so the row statistics need only shuffles, and S, P and dS stay
// in registers: the next product (dQ = dS . K, dV = P^T . dO,
// dK = dS^T . Q) takes its A operand from them by shuffle (fma_regs_a)
// and its B from the shared tile, so nothing N x N, and no S or P tile,
// is in shared memory. rowsum(P dP) is dO . O, from the forward's output O
// (the recompute's, or #4's saved one), so the query side's first pass
// needs S alone. The key side computes S^T = K . Q^T and dP^T = V . dO^T
// directly (rows = keys), with the same k order as the query side's S and
// dP, so the same bits. The CTA's own 64 rows stay in shared memory; the
// other side's tiles come in one at a time by cp.async, with the query
// tile's stored statistics beside it on the key side: four [64][68] tiles,
// 70-71 KB at hd = 64, so three CTAs share an SM (registers capped at 168,
// with a few spills) and hide each other's copies. That ran faster on the
// card than two CTAs an SM with a two-stage ring under each (107 KB, 255
// registers). Head widths go in two instances (HDC 64 and 128, the rest of
// the registers unused), and the shuffled products are unrolled two of
// eight source lanes at a time: fully unrolled, the key side ran slower on
// the card (its code, we suppose, too large for the instruction cache).
// Rounding: none (fp32). P = exp(S scale - m) / l is formed in fp32, and
// dS = P (dP - rowsum) scale, as the plain version, whose
// rowsum(P dP) differs from dO . O by the order of the sums. Pad rows and
// columns of every tile are zero-filled by the copies and masked (P = 0,
// dS = 0), so ragged N adds nothing to any grad. Each output element has
// one owner that adds its k in increasing order, so a repeated call gives
// the same bits.

#pragma once

#include "attention_common.cuh"
#include "fma_common.cuh"

namespace {

// The head widths go in two classes, HDC = 64 (16-64) and 128 (80-128):
// a kernel's registers hold HDC / 4 output columns a thread, of which the
// first hd / 4 are used, and its shared tiles are [64][hd + 4].
template <int HDC>
struct AttnFmaPlan {
  static constexpr int kThreads = 128, kRows = 64;
  static constexpr int kTR = 16, kTC = 8;       // warps of 4 x 8 lanes
  static constexpr int kTM = kRows / kTR;       // rows a thread
  static constexpr int kTS = kRows / kTC;       // S columns a thread
  static constexpr int kTO = HDC / kTC;         // output columns a thread
  using Grid = FmaGrid<kThreads, kTR, 4>;
  // The CTA's two tiles, then one stage of the other side's two tiles
  // (and, on the key side, the query tile's three statistics), then the
  // column-sum scratch (4 warps x hd).
  __host__ __device__ static int ld(int hd) { return hd + 4; }
  __host__ __device__ static int tile(int hd) { return kRows * ld(hd); }
  __host__ __device__ static int stage(int hd) {
    return 2 * tile(hd) + 3 * kRows;
  }
  static size_t smem(int hd) {
    return sizeof(float) * (2 * tile(hd) + stage(hd) + 4 * hd);
  }
  // Three CTAs an SM at hd <= 64 (their 70 KB fit three times in 228 KB).
  static constexpr int kMinCtas = HDC == 64 ? 3 : 1;
};

// Column sums of v (rows tr + 16 i, those below `valid`; the first hd
// columns) over the CTA's 64 rows into dst[0 .. hd): the thread's rows,
// lanes ^1 ^2, then the four warps in order.
template <int HDC>
__device__ __forceinline__ void attn_col_sums(
    const float (&v)[4][HDC / 8], int valid, int hd, float* red, float* dst) {
  using P = AttnFmaPlan<HDC>;
  const int tr = P::Grid::tr(), tc = P::Grid::tc();
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < P::kTO; ++j) {
    const int c = fma_col<8>(tc, j);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) s += tr + 16 * i < valid ? v[i][j] : 0.f;
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if ((threadIdx.x & 3) == 0 && c < hd) red[warp * hd + c] = s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < hd; c += P::kThreads) {
    dst[c] = ((red[c] + red[hd + c]) + red[2 * hd + c]) + red[3 * hd + c];
  }
}

// Rows `valid` of the output micro-tile v (its first hd columns) to a head
// view's rows from r0.
template <int HDC>
__device__ __forceinline__ void attn_store(const float (&v)[4][HDC / 8],
                                           HeadView<float> out, int b, int h,
                                           int r0, int valid, int hd) {
  using P = AttnFmaPlan<HDC>;
  const int tr = P::Grid::tr(), tc = P::Grid::tc();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    if (r >= valid) continue;
    float* row = out.row(b, h, r0 + r);
#pragma unroll
    for (int q = 0; q < P::kTO / 4; ++q) {
      const int c = fma_col<8>(tc, 4 * q);
      if (c >= hd) break;
      *reinterpret_cast<float4*>(row + c) = make_float4(
          v[i][4 * q], v[i][4 * q + 1], v[i][4 * q + 2], v[i][4 * q + 3]);
    }
  }
}

// Query side, per (64-query tile, head, image). Each row's
// rowsum(P dP) = dO . O (O the attention output the forward stored), from
// the CTA's dO tile; then over the key tiles twice: pass 1 gives m and l
// from S alone (online, rescaled as m grows), pass 2 dS and dQ += dS . K.
// Stores the statistics (stats: three planes of [B][heads][N]: m, l,
// dO . O) and dQ's column sums into part's dq slice (per (image, tile),
// [dq | dk | dv], 3 heads hd wide).
template <int HDC>
__global__ void __launch_bounds__(128, AttnFmaPlan<HDC>::kMinCtas)
attn_bwd_q_fma_kernel(HeadView<const float> q, HeadView<const float> k,
                      HeadView<const float> v, HeadView<const float> g,
                      HeadView<const float> o, HeadView<float> dq,
                      float* __restrict__ stats, float* __restrict__ part,
                      int N, int hd, float scale) {
  using P = AttnFmaPlan<HDC>;
  constexpr int TM = P::kTM, TS = P::kTS, TO = P::kTO;
  const int LD = P::ld(hd), tile = P::tile(hd), stage = P::stage(hd);
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sG = sQ + tile;
  float* ring = sG + tile;
  float* sRed = ring + stage;
  const int tr = P::Grid::tr(), tc = P::Grid::tc();
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int qvalid = min(64, N - q0);
  const int nt = (N + 63) / 64;

  tile_async<64, HDC, 128>(sQ, LD, q.row(b, h, q0), q.sr, qvalid, hd, hd);
  tile_async<64, HDC, 128>(sG, LD, g.row(b, h, q0), g.sr, qvalid, hd, hd);
  auto load_kv = [&](int s) {
    const int k0 = (s < nt ? s : s - nt) * 64;
    float* st = ring;
    tile_async<64, HDC, 128>(st, LD, k.row(b, h, k0), k.sr, N - k0, hd, hd);
    tile_async<64, HDC, 128>(st + tile, LD, v.row(b, h, k0), v.sr, N - k0,
                             hd, hd);
  };
  load_kv(0);
  cp_async_commit();

  // rowsum(P dP) = dO . O over the thread's columns, then the row's eight
  // lanes.
  float a[TM], m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tr + 16 * i;
    a[i] = 0.f;
    m[i] = -FLT_MAX;
    l[i] = 0.f;
    if (r >= qvalid) continue;
    const float* orow = o.row(b, h, q0 + r);
    const float* grow = g.row(b, h, q0 + r);
    for (int c = 4 * tc; c < hd; c += 32) {
      const float4 ov = *reinterpret_cast<const float4*>(orow + c);
      const float4 gv = *reinterpret_cast<const float4*>(grow + c);
      a[i] += ((ov.x * gv.x + ov.y * gv.y) + ov.z * gv.z) + ov.w * gv.w;
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    a[i] += __shfl_xor_sync(0xffffffffu, a[i], 4);
    a[i] += __shfl_xor_sync(0xffffffffu, a[i], 8);
    a[i] += __shfl_xor_sync(0xffffffffu, a[i], 16);
  }

  float acc[TM][TO];
  fma_zero(acc);
  for (int s = 0; s < 2 * nt; ++s) {
    cp_async_wait<0>();
    __syncthreads();
    const float* sK = ring;
    const float* sV = sK + tile;
    const int kvalid = N - (s < nt ? s : s - nt) * 64;
    float S[TM][TS];
    fma_zero(S);
    fma_tile<16, 8, TM, TS, false, false, true>(S, sQ, LD, sK, LD, tr, tc,
                                                hd);
    if (s < nt) {
      // 1. m and l, rescaled as m grows.
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float mx = -FLT_MAX;
#pragma unroll
        for (int j = 0; j < TS; ++j) {
          if (tc + 8 * j < kvalid) mx = fmaxf(mx, S[i][j] * scale);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float mn = fmaxf(m[i], mx);
        float e = 0.f;
#pragma unroll
        for (int j = 0; j < TS; ++j) {
          if (tc + 8 * j < kvalid) e += expf(S[i][j] * scale - mn);
        }
        e += __shfl_xor_sync(0xffffffffu, e, 4);
        e += __shfl_xor_sync(0xffffffffu, e, 8);
        e += __shfl_xor_sync(0xffffffffu, e, 16);
        l[i] = l[i] * expf(m[i] - mn) + e;
        m[i] = mn;
      }
    } else {
      // 2. dP = dO . V^T, dS = P (dP - rowsum) scale in place of S, then
      // dQ += dS . K.
      float dP[TM][TS];
      fma_zero(dP);
      fma_tile<16, 8, TM, TS, false, false, true>(dP, sG, LD, sV, LD, tr,
                                                  tc, hd);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TS; ++j) {
          const float p = expf(S[i][j] * scale - m[i]) / l[i];
          S[i][j] = tc + 8 * j < kvalid ? p * (dP[i][j] - a[i]) * scale
                                        : 0.f;
        }
      fma_regs_a(acc, S, sK, LD, tc, hd);
    }
    __syncthreads();
    if (s + 1 < 2 * nt) load_kv(s + 1);
    cp_async_commit();
  }

  attn_store<HDC>(acc, dq, b, h, q0, qvalid, hd);
  const size_t plane = static_cast<size_t>(gridDim.z) * gridDim.y * N;
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = tr + 16 * i;
      if (r >= qvalid) continue;
      const size_t idx = stat_index(b, h, q0 + r, N);
      stats[idx] = m[i];
      stats[plane + idx] = l[i];
      stats[2 * plane + idx] = a[i];
    }
  }
  const int D = gridDim.y * hd;
  attn_col_sums<HDC>(acc, qvalid, hd, sRed,
                     part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) *
                                3 * D + h * hd);
}

// Key side, per (64-key tile, head, image), over the query tiles: S^T and
// dP^T, P^T and dS^T from the stored statistics, dV += P^T . dO and
// dK += dS^T . Q; dK's and dV's column sums into part's dk and dv slices.
template <int HDC>
__global__ void __launch_bounds__(128, AttnFmaPlan<HDC>::kMinCtas)
attn_bwd_kv_fma_kernel(HeadView<const float> q, HeadView<const float> k,
                       HeadView<const float> v, HeadView<const float> g,
                       HeadView<float> dk, HeadView<float> dv,
                       const float* __restrict__ stats,
                       float* __restrict__ part, int N, int hd, float scale) {
  using P = AttnFmaPlan<HDC>;
  constexpr int TM = P::kTM, TS = P::kTS, TO = P::kTO;
  const int LD = P::ld(hd), tile = P::tile(hd), stage = P::stage(hd);
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + tile;
  float* ring = sV + tile;
  float* sRed = ring + stage;
  const int tr = P::Grid::tr(), tc = P::Grid::tc();
  const int k0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int kvalid = min(64, N - k0);
  const int nt = (N + 63) / 64;
  const size_t plane = static_cast<size_t>(gridDim.z) * gridDim.y * N;

  tile_async<64, HDC, 128>(sK, LD, k.row(b, h, k0), k.sr, kvalid, hd, hd);
  tile_async<64, HDC, 128>(sV, LD, v.row(b, h, k0), v.sr, kvalid, hd, hd);
  auto load_q = [&](int t) {
    const int q0 = t * 64;
    float* st = ring;
    tile_async<64, HDC, 128>(st, LD, q.row(b, h, q0), q.sr, N - q0, hd, hd);
    tile_async<64, HDC, 128>(st + tile, LD, g.row(b, h, q0), g.sr, N - q0,
                             hd, hd);
    float* sst = st + 2 * tile;               // m, l, rowsum of each query
    for (int i = threadIdx.x; i < 3 * 64; i += 128) {
      const int p = i / 64, r = i - p * 64;
      const bool ok = q0 + r < N;
      cp_async4(sst + i,
                ok ? stats + p * plane + stat_index(b, h, q0 + r, N) : stats,
                ok);
    }
  };
  load_q(0);
  cp_async_commit();

  float accK[TM][TO], accV[TM][TO];
  fma_zero(accK);
  fma_zero(accV);
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    const float* sQ = ring;
    const float* sG = sQ + tile;
    const float* sM = sG + tile;
    const int qvalid = N - t * 64;
    float S[TM][TS], dP[TM][TS];               // transposed: [key][query]
    fma_zero(S);
    fma_zero(dP);
    fma_tile<16, 8, TM, TS, false, false, true>(S, sK, LD, sQ, LD, tr, tc,
                                                hd);
    fma_tile<16, 8, TM, TS, false, false, true>(dP, sV, LD, sG, LD, tr, tc,
                                                hd);
#pragma unroll
    for (int j = 0; j < TS; ++j) {
      const int c = tc + 8 * j;
      const float mq = sM[c], lq = sM[64 + c], aq = sM[128 + c];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const bool ok = tr + 16 * i < kvalid && c < qvalid;
        const float p = expf(S[i][j] * scale - mq) / lq;
        S[i][j] = ok ? p : 0.f;
        dP[i][j] = ok ? p * (dP[i][j] - aq) * scale : 0.f;
      }
    }
    fma_regs_a(accV, S, sG, LD, tc, hd);      // dV += P^T . dO
    fma_regs_a(accK, dP, sQ, LD, tc, hd);     // dK += dS^T . Q
    __syncthreads();
    if (t + 1 < nt) load_q(t + 1);
    cp_async_commit();
  }

  attn_store<HDC>(accK, dk, b, h, k0, kvalid, hd);
  attn_store<HDC>(accV, dv, b, h, k0, kvalid, hd);
  const int D = gridDim.y * hd;
  float* pt = part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 3 * D +
              h * hd;
  attn_col_sums<HDC>(accK, kvalid, hd, sRed, pt + D);
  __syncthreads();
  attn_col_sums<HDC>(accV, kvalid, hd, sRed, pt + 2 * D);
}

template <int HDC>
cudaError_t launch_attention_bwd_fma_hdc(
    HeadView<const float> q, HeadView<const float> k, HeadView<const float> v,
    HeadView<const float> g, HeadView<const float> o, HeadView<float> dq,
    HeadView<float> dk, HeadView<float> dv, float* stats, float* part, int B,
    int heads, int N, int hd, float scale, cudaStream_t stream) {
  const size_t sm = AttnFmaPlan<HDC>::smem(hd);
  const dim3 grid((N + 63) / 64, heads, B);
  cudaError_t e;
  if ((e = set_smem(attn_bwd_q_fma_kernel<HDC>, sm)) != cudaSuccess) return e;
  attn_bwd_q_fma_kernel<HDC><<<grid, 128, sm, stream>>>(
      q, k, v, g, o, dq, stats, part, N, hd, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = set_smem(attn_bwd_kv_fma_kernel<HDC>, sm)) != cudaSuccess) return e;
  attn_bwd_kv_fma_kernel<HDC><<<grid, 128, sm, stream>>>(
      q, k, v, g, dk, dv, stats, part, N, hd, scale);
  return cudaGetLastError();
}

// The block's fp32 attention backward: both sides at any head width
// attention_head_ok takes. o: the forward's attention output. stats:
// 3 * B * heads * N floats of scratch; part gets B * ceil(N / 64) rows of
// [dq | dk | dv] column sums (3 heads hd).
inline cudaError_t launch_attention_bwd_block_fma(
    HeadView<const float> q, HeadView<const float> k, HeadView<const float> v,
    HeadView<const float> g, HeadView<const float> o, HeadView<float> dq,
    HeadView<float> dk, HeadView<float> dv, float* stats, float* part, int B,
    int heads, int N, int hd, float scale, cudaStream_t stream) {
  if (!attention_head_ok(hd)) return cudaErrorInvalidValue;
  return hd <= 64
             ? launch_attention_bwd_fma_hdc<64>(q, k, v, g, o, dq, dk, dv,
                                                stats, part, B, heads, N, hd,
                                                scale, stream)
             : launch_attention_bwd_fma_hdc<128>(q, k, v, g, o, dq, dk, dv,
                                                 stats, part, B, heads, N, hd,
                                                 scale, stream);
}

}  // namespace
