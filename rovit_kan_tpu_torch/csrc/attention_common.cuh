// Streamed softmax attention on Hopper (sm_90a), bf16 or fp32: the forward
// and the two backward stages, as the ViT-block kernels run them inside a
// block (vit_block_fwd.cu, vit_block_bwd.cu, through vit_block_common.cuh)
// and the attention-only kernels run them alone (attention.cu). One device
// code for both, reading its operands through strided views.
//
// Per (query tile, head, image) the forward keeps only the query tile and
// one 64-key tile of K and V in shared memory, so shared memory does not
// grow with the sequence: 72 KB in bf16 at a head width of 64; the largest
// stage, the backward's key side in bf16 at head width 128, takes 191 KB,
// within the 227 KB a block may have, for any N. Two passes over the key
// tiles keep the TPU kernels' rounding points exactly:
//   1. S = q . k^T (fp32) tile by tile, each row's max m and sum l of
//      exp(S * scale - m), rescaled as m grows;
//   2. S again, P = exp(S * scale - m) / l in fp32, rounded to the compute
//      type T, O += P . V (fp32).
// Only l's summation order differs from the whole-row softmax (fp32 noise);
// P is normalized in fp32 before it is rounded, as block_kernel.py:118-128
// and attention.py:57-60 do, at the cost of computing S twice.
//
// The backward follows FlashAttention-2's split with nothing N x N in
// memory and no atomics:
//   query side, per query tile: pass 1 gives m, l and
//     rowsum(P * dP) = (sum of exp(S * scale - m) * dP) / l with dP = dO . V^T,
//     rescaled as m grows; pass 2 forms dS = P * (dP - rowsum) * scale,
//     rounded to T, and dQ += dS . K; it stores m, l and the row sum;
//   key side, per key tile, over the query tiles: S and dP again, P and dS
//     from the stored statistics (the same arithmetic on the same values,
//     so the same bits as the query side), dV += P^T . dO with P rounded,
//     dK += dS^T . Q.
// Each output element is summed by one owner in a fixed order, so two runs
// give the same bits. bf16 products use WMMA from shared memory; fp32
// products are FMA loops. Pad rows of every tile are zero in shared memory
// and masked (P = 0, dS = 0), so ragged N needs no padding in memory.

#pragma once

#include "tile_common.cuh"

namespace {

constexpr int kKeyTile = 64;        // keys per step of the forward

// One operand of attention: element (b, h, n, d) at
// ptr[b * sb + h * sh + n * sr + d]. A head's row of hd values is
// contiguous, and ptr and every stride keep rows 16-byte aligned.
template <typename E>
struct HeadView {
  E* ptr;
  long long sb, sh, sr;
  __device__ E* row(int b, int h, int n) const {
    return ptr + b * sb + h * sh + n * sr;
  }
};

// One key tile's part of each query row's running statistics: the max m of
// S * scale, l = sum of exp(S * scale - m) and, when dp is given,
// a = sum of exp(S * scale - m) * dP, l and a rescaled as m grows. A warp
// owns rows warp, warp + 8, ...
__device__ void online_row_stats(const float* __restrict__ s_tile,
                                 const float* __restrict__ dp_tile, int ld,
                                 int rows, int kvalid, float scale,
                                 float* __restrict__ m_row,
                                 float* __restrict__ l_row,
                                 float* __restrict__ a_row) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const float* s = s_tile + r * ld;
    const float m_old = m_row[r];
    float tmax = -FLT_MAX;
    for (int c = lane; c < kvalid; c += 32) tmax = fmaxf(tmax, s[c] * scale);
    const float m = fmaxf(m_old, warp_max(tmax));
    float e = 0.f, a = 0.f;
    for (int c = lane; c < kvalid; c += 32) {
      const float x = expf(s[c] * scale - m);
      e += x;
      if (dp_tile != nullptr) a += x * dp_tile[r * ld + c];
    }
    e = warp_sum(e);
    if (dp_tile != nullptr) a = warp_sum(a);
    if (lane == 0) {
      const float corr = expf(m_old - m);
      m_row[r] = m;
      l_row[r] = l_row[r] * corr + e;
      if (a_row != nullptr) a_row[r] = a_row[r] * corr + a;
    }
  }
}

// ---- forward ---------------------------------------------------------------

struct AttnFwdLayout {
  size_t q, k, v, s, p, o, m, l, total;
  int ldh, lds, ldp, ldo;
};
template <typename T>
__host__ __device__ AttnFwdLayout attn_fwd_layout(int hd) {
  constexpr int QR = Tile<T>::kRows;
  constexpr int KT = kKeyTile;
  AttnFwdLayout L;
  L.ldh = ld_of<T>(hd);
  L.lds = KT + 4;
  L.ldp = ld_of<T>(KT);
  L.ldo = hd + 4;
  L.q = 0;
  L.k = L.q + align128(sizeof(T) * QR * L.ldh);
  L.v = L.k + align128(sizeof(T) * KT * L.ldh);
  L.s = L.v + align128(sizeof(T) * KT * L.ldh);
  L.p = L.s + align128(sizeof(float) * QR * L.lds);
  L.o = L.p + align128(sizeof(T) * QR * L.ldp);
  L.m = L.o + align128(sizeof(float) * QR * L.ldo);
  L.l = L.m + align128(sizeof(float) * QR);
  L.total = L.l + align128(sizeof(float) * QR);
  return L;
}

// O = softmax(q k^T * scale) v for one (query tile, head, image); O is
// stored as O_T (the compute type inside the block, fp32 for the
// attention-only kernel).
template <typename T, typename O_T>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(HeadView<const T> q, HeadView<const T> k,
                HeadView<const T> v, HeadView<O_T> out, int N, int hd,
                float scale) {
  constexpr int QR = Tile<T>::kRows;
  constexpr int KT = kKeyTile;
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnFwdLayout L = attn_fwd_layout<T>(hd);
  T* sQ = reinterpret_cast<T*>(smem + L.q);
  T* sK = reinterpret_cast<T*>(smem + L.k);
  T* sV = reinterpret_cast<T*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  T* sP = reinterpret_cast<T*>(smem + L.p);
  float* sO = reinterpret_cast<float*>(smem + L.o);
  float* sM = reinterpret_cast<float*>(smem + L.m);
  float* sL = reinterpret_cast<float*>(smem + L.l);
  const int q0 = blockIdx.x * QR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qvalid = min(QR, N - q0);

  load_tile<T>(sQ, L.ldh, q.row(b, h, q0), q.sr, QR, qvalid, hd);
  for (int r = threadIdx.x; r < QR; r += kThreads) {
    sM[r] = -FLT_MAX;
    sL[r] = 0.f;
  }
  // 1. Row statistics.
  for (int k0 = 0; k0 < N; k0 += KT) {
    const int kvalid = min(KT, N - k0);
    __syncthreads();
    load_tile<T>(sK, L.ldh, k.row(b, h, k0), k.sr, KT, kvalid, hd);
    __syncthreads();
    block_gemm<T, true>(sQ, L.ldh, sK, L.ldh, sS, L.lds, QR, KT, hd, false);
    __syncthreads();
    online_row_stats(sS, nullptr, L.lds, QR, kvalid, scale, sM, sL, nullptr);
  }
  // 2. P, rounded, and O += P . V.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < N; k0 += KT) {
    const int kvalid = min(KT, N - k0);
    __syncthreads();
    load_tile<T>(sK, L.ldh, k.row(b, h, k0), k.sr, KT, kvalid, hd);
    load_tile<T>(sV, L.ldh, v.row(b, h, k0), v.sr, KT, kvalid, hd);
    __syncthreads();
    block_gemm<T, true>(sQ, L.ldh, sK, L.ldh, sS, L.lds, QR, KT, hd, false);
    __syncthreads();
    for (int r = warp; r < QR; r += kWarps) {
      const float* s = sS + r * L.lds;
      const float m = sM[r];
      const float l = sL[r];
      T* p = sP + r * L.ldp;
      for (int c = lane; c < KT; c += 32) {
        p[c] = from_f<T>(c < kvalid ? expf(s[c] * scale - m) / l : 0.f);
      }
    }
    __syncthreads();
    block_gemm<T, false>(sP, L.ldp, sV, L.ldh, sO, L.ldo, QR, hd, KT,
                         k0 > 0);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < qvalid * hd; i += kThreads) {
    const int r = i / hd;
    const int c = i - r * hd;
    out.row(b, h, q0 + r)[c] = from_f<O_T>(sO[r * L.ldo + c]);
  }
}

template <typename T, typename O_T>
cudaError_t launch_attention_fwd(HeadView<const T> q, HeadView<const T> k,
                                 HeadView<const T> v, HeadView<O_T> out,
                                 int B, int heads, int N, int hd, float scale,
                                 cudaStream_t stream) {
  constexpr int QR = Tile<T>::kRows;
  const size_t sm = attn_fwd_layout<T>(hd).total;
  cudaError_t e;
  if ((e = set_smem(attn_fwd_kernel<T, O_T>, sm)) != cudaSuccess) return e;
  const dim3 grid((N + QR - 1) / QR, heads, B);
  attn_fwd_kernel<T, O_T><<<grid, kThreads, sm, stream>>>(q, k, v, out, N,
                                                          hd, scale);
  return cudaGetLastError();
}

// ---- backward ----------------------------------------------------------------

// Both sides: tiles of BT queries and BT keys (Tile<T>::kRows).
struct AttnBwdLayout {
  size_t a, b, c, d, s, dp, t1, t2, acc1, acc2, st, total;
  int ldh, lds, ldt, ldo;
};
// Query side: a = Q, b = dO, c = K, d = V, t1 = dS, acc1 = dQ.
// Key side:   a = Q, b = dO, c = K, d = V, t1 = P, t2 = dS, acc1 = dK,
//             acc2 = dV.
template <typename T>
__host__ __device__ AttnBwdLayout attn_bwd_layout(int hd, bool key_side) {
  constexpr int BT = Tile<T>::kRows;
  AttnBwdLayout L;
  L.ldh = ld_of<T>(hd);
  L.lds = BT + 4;
  L.ldt = ld_of<T>(BT);
  L.ldo = hd + 4;
  const size_t tile = align128(sizeof(T) * BT * L.ldh);
  const size_t score = align128(sizeof(float) * BT * L.lds);
  const size_t lo = align128(sizeof(T) * BT * L.ldt);
  const size_t acc = align128(sizeof(float) * BT * L.ldo);
  L.a = 0;
  L.b = L.a + tile;
  L.c = L.b + tile;
  L.d = L.c + tile;
  L.s = L.d + tile;
  L.dp = L.s + score;
  L.t1 = L.dp + score;
  L.t2 = L.t1 + lo;
  L.acc1 = L.t2 + (key_side ? lo : 0);
  L.acc2 = L.acc1 + acc;
  L.st = L.acc2 + (key_side ? acc : 0);
  L.total = L.st + align128(sizeof(float) * 3 * BT);
  return L;
}

// stats: three planes of [B][heads][N] fp32: m, l, rowsum(P * dP).
__device__ __forceinline__ size_t stat_index(int b, int h, int n, int N) {
  return (static_cast<size_t>(b) * gridDim.y + h) * N + n;
}

// part (optional): per (image, tile), [dq | dk | dv] column sums over the
// tile's rows, each heads * hd wide; this side fills the dq slice of its
// head.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_q_kernel(HeadView<const T> q, HeadView<const T> k,
                  HeadView<const T> v, HeadView<const T> g, HeadView<T> dq,
                  float* __restrict__ stats, float* __restrict__ part, int N,
                  int hd, float scale) {
  constexpr int BT = Tile<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnBwdLayout L = attn_bwd_layout<T>(hd, false);
  T* sQ = reinterpret_cast<T*>(smem + L.a);
  T* sG = reinterpret_cast<T*>(smem + L.b);
  T* sK = reinterpret_cast<T*>(smem + L.c);
  T* sV = reinterpret_cast<T*>(smem + L.d);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sD = reinterpret_cast<float*>(smem + L.dp);
  T* sDS = reinterpret_cast<T*>(smem + L.t1);
  float* sDQ = reinterpret_cast<float*>(smem + L.acc1);
  float* sM = reinterpret_cast<float*>(smem + L.st);
  float* sL = sM + BT;
  float* sA = sL + BT;
  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qvalid = min(BT, N - q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_tile<T>(sQ, L.ldh, q.row(b, h, q0), q.sr, BT, qvalid, hd);
  load_tile<T>(sG, L.ldh, g.row(b, h, q0), g.sr, BT, qvalid, hd);
  for (int r = threadIdx.x; r < BT; r += kThreads) {
    sM[r] = -FLT_MAX;
    sL[r] = 0.f;
    sA[r] = 0.f;
  }
  // 1. m, l and rowsum(P * dP).
  for (int k0 = 0; k0 < N; k0 += BT) {
    const int kvalid = min(BT, N - k0);
    __syncthreads();
    load_tile<T>(sK, L.ldh, k.row(b, h, k0), k.sr, BT, kvalid, hd);
    load_tile<T>(sV, L.ldh, v.row(b, h, k0), v.sr, BT, kvalid, hd);
    __syncthreads();
    block_gemm<T, true>(sQ, L.ldh, sK, L.ldh, sS, L.lds, BT, BT, hd, false);
    block_gemm<T, true>(sG, L.ldh, sV, L.ldh, sD, L.lds, BT, BT, hd, false);
    __syncthreads();
    online_row_stats(sS, sD, L.lds, BT, kvalid, scale, sM, sL, sA);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BT; r += kThreads) sA[r] /= sL[r];
  // 2. dS, rounded, and dQ += dS . K.
  for (int k0 = 0; k0 < N; k0 += BT) {
    const int kvalid = min(BT, N - k0);
    __syncthreads();
    load_tile<T>(sK, L.ldh, k.row(b, h, k0), k.sr, BT, kvalid, hd);
    load_tile<T>(sV, L.ldh, v.row(b, h, k0), v.sr, BT, kvalid, hd);
    __syncthreads();
    block_gemm<T, true>(sQ, L.ldh, sK, L.ldh, sS, L.lds, BT, BT, hd, false);
    block_gemm<T, true>(sG, L.ldh, sV, L.ldh, sD, L.lds, BT, BT, hd, false);
    __syncthreads();
    for (int r = warp; r < BT; r += kWarps) {
      const float* s = sS + r * L.lds;
      const float* dp = sD + r * L.lds;
      const float m = sM[r];
      const float l = sL[r];
      const float dot = sA[r];
      T* ds = sDS + r * L.ldt;
      for (int c = lane; c < BT; c += 32) {
        float val = 0.f;
        if (c < kvalid) {
          const float p = expf(s[c] * scale - m) / l;
          val = p * (dp[c] - dot) * scale;
        }
        ds[c] = from_f<T>(val);
      }
    }
    __syncthreads();
    block_gemm<T, false>(sDS, L.ldt, sK, L.ldh, sDQ, L.ldo, BT, hd, BT,
                         k0 > 0);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < qvalid * hd; i += kThreads) {
    const int r = i / hd;
    const int c = i - r * hd;
    dq.row(b, h, q0 + r)[c] = from_f<T>(sDQ[r * L.ldo + c]);
  }
  const size_t plane = static_cast<size_t>(gridDim.z) * gridDim.y * N;
  for (int r = threadIdx.x; r < qvalid; r += kThreads) {
    const size_t i = stat_index(b, h, q0 + r, N);
    stats[i] = sM[r];
    stats[plane + i] = sL[r];
    stats[2 * plane + i] = sA[r];
  }
  if (part != nullptr) {
    const int D = gridDim.y * hd;
    column_sums(sDQ, L.ldo, qvalid, hd,
                part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) *
                           3 * D + h * hd);
  }
}

// part (optional): as attn_bwd_q_kernel; this side fills the dk and dv
// slices of its head.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kv_kernel(HeadView<const T> q, HeadView<const T> k,
                   HeadView<const T> v, HeadView<const T> g, HeadView<T> dk,
                   HeadView<T> dv, const float* __restrict__ stats,
                   float* __restrict__ part, int N, int hd, float scale) {
  constexpr int BT = Tile<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnBwdLayout L = attn_bwd_layout<T>(hd, true);
  T* sQ = reinterpret_cast<T*>(smem + L.a);
  T* sG = reinterpret_cast<T*>(smem + L.b);
  T* sK = reinterpret_cast<T*>(smem + L.c);
  T* sV = reinterpret_cast<T*>(smem + L.d);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sD = reinterpret_cast<float*>(smem + L.dp);
  T* sP = reinterpret_cast<T*>(smem + L.t1);          // [query][key]
  T* sDS = reinterpret_cast<T*>(smem + L.t2);         // [query][key]
  float* sDK = reinterpret_cast<float*>(smem + L.acc1);
  float* sDV = reinterpret_cast<float*>(smem + L.acc2);
  float* sM = reinterpret_cast<float*>(smem + L.st);
  float* sL = sM + BT;
  float* sA = sL + BT;
  const int k0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvalid = min(BT, N - k0);
  const size_t plane = static_cast<size_t>(gridDim.z) * gridDim.y * N;

  load_tile<T>(sK, L.ldh, k.row(b, h, k0), k.sr, BT, kvalid, hd);
  load_tile<T>(sV, L.ldh, v.row(b, h, k0), v.sr, BT, kvalid, hd);
  for (int q0 = 0; q0 < N; q0 += BT) {
    const int qvalid = min(BT, N - q0);
    __syncthreads();
    load_tile<T>(sQ, L.ldh, q.row(b, h, q0), q.sr, BT, qvalid, hd);
    load_tile<T>(sG, L.ldh, g.row(b, h, q0), g.sr, BT, qvalid, hd);
    for (int r = threadIdx.x; r < BT; r += kThreads) {
      const bool ok = r < qvalid;
      const size_t i = ok ? stat_index(b, h, q0 + r, N) : 0;
      sM[r] = ok ? stats[i] : 0.f;
      sL[r] = ok ? stats[plane + i] : 1.f;
      sA[r] = ok ? stats[2 * plane + i] : 0.f;
    }
    __syncthreads();
    block_gemm<T, true>(sQ, L.ldh, sK, L.ldh, sS, L.lds, BT, BT, hd, false);
    block_gemm<T, true>(sG, L.ldh, sV, L.ldh, sD, L.lds, BT, BT, hd, false);
    __syncthreads();
    for (int i = threadIdx.x; i < BT * BT; i += kThreads) {
      const int r = i / BT;
      const int c = i - r * BT;
      float p = 0.f, ds = 0.f;
      if (r < qvalid && c < kvalid) {
        p = expf(sS[r * L.lds + c] * scale - sM[r]) / sL[r];
        ds = p * (sD[r * L.lds + c] - sA[r]) * scale;
      }
      sP[r * L.ldt + c] = from_f<T>(p);
      sDS[r * L.ldt + c] = from_f<T>(ds);
    }
    __syncthreads();
    block_gemm<T, false, true>(sP, L.ldt, sG, L.ldh, sDV, L.ldo, BT, hd, BT,
                               q0 > 0);
    block_gemm<T, false, true>(sDS, L.ldt, sQ, L.ldh, sDK, L.ldo, BT, hd, BT,
                               q0 > 0);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kvalid * hd; i += kThreads) {
    const int r = i / hd;
    const int c = i - r * hd;
    dk.row(b, h, k0 + r)[c] = from_f<T>(sDK[r * L.ldo + c]);
    dv.row(b, h, k0 + r)[c] = from_f<T>(sDV[r * L.ldo + c]);
  }
  if (part != nullptr) {
    const int D = gridDim.y * hd;
    float* pt = part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) *
                           3 * D + h * hd;
    column_sums(sDK, L.ldo, kvalid, hd, pt + D);
    column_sums(sDV, L.ldo, kvalid, hd, pt + 2 * D);
  }
}

// Both sides of the backward: the query side, then the key side reading its
// statistics (stats: 3 * B * heads * N floats of scratch). part, when
// given, holds B * ceil(N / Tile<T>::kRows) rows of 3 * heads * hd fp32.
template <typename T>
cudaError_t launch_attention_bwd(HeadView<const T> q, HeadView<const T> k,
                                 HeadView<const T> v, HeadView<const T> g,
                                 HeadView<T> dq, HeadView<T> dk,
                                 HeadView<T> dv, float* stats, float* part,
                                 int B, int heads, int N, int hd, float scale,
                                 cudaStream_t stream) {
  constexpr int BT = Tile<T>::kRows;
  const dim3 grid((N + BT - 1) / BT, heads, B);
  cudaError_t e;
  const size_t smq = attn_bwd_layout<T>(hd, false).total;
  if ((e = set_smem(attn_bwd_q_kernel<T>, smq)) != cudaSuccess) return e;
  attn_bwd_q_kernel<T><<<grid, kThreads, smq, stream>>>(
      q, k, v, g, dq, stats, part, N, hd, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t smk = attn_bwd_layout<T>(hd, true).total;
  if ((e = set_smem(attn_bwd_kv_kernel<T>, smk)) != cudaSuccess) return e;
  attn_bwd_kv_kernel<T><<<grid, kThreads, smk, stream>>>(
      q, k, v, g, dk, dv, stats, part, N, hd, scale);
  return cudaGetLastError();
}

// Head widths the attention stages take.
inline bool attention_head_ok(int hd) {
  return hd >= 16 && hd <= 128 && hd % 16 == 0;
}

}  // namespace
