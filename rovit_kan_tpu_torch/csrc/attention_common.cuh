// Streamed softmax attention on Hopper (sm_90a), fp32: the forward stage of
// the fp32 ViT-block kernels (#1, #3 and #2's recompute, through
// vit_block_common.cuh), and the operand view and statistics layout that
// every attention route shares. The bf16 routes run attention_mma.cuh, the
// fp32 attention-only kernels #5/#6 attention_tf32.cuh and the fp32 block
// backward attention_fma.cuh.
//
// Per (query tile, head, image) the forward keeps only the query tile and
// one 64-key tile of K and V in shared memory, so shared memory does not
// grow with the sequence, within the 227 KB a block may have for any N.
// Two passes over the key tiles keep the TPU kernels' rounding points
// exactly:
//   1. S = q . k^T (fp32) tile by tile, each row's max m and sum l of
//      exp(S * scale - m), rescaled as m grows;
//   2. S again, P = exp(S * scale - m) / l in fp32, rounded to the compute
//      type T, O += P . V (fp32).
// Only l's summation order differs from the whole-row softmax (fp32 noise);
// P is normalized in fp32 before it is rounded, as block_kernel.py:118-128
// and attention.py:57-60 do, at the cost of computing S twice. Products are
// FMA loops (tile_common.cuh). Pad rows of every tile are zero in shared
// memory and masked, so ragged N needs no padding in memory.

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
// S * scale and l = sum of exp(S * scale - m), l rescaled as m grows. A
// warp owns rows warp, warp + 8, ...
__device__ void online_row_stats(const float* __restrict__ s_tile, int ld,
                                 int rows, int kvalid, float scale,
                                 float* __restrict__ m_row,
                                 float* __restrict__ l_row) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const float* s = s_tile + r * ld;
    const float m_old = m_row[r];
    float tmax = -FLT_MAX;
    for (int c = lane; c < kvalid; c += 32) tmax = fmaxf(tmax, s[c] * scale);
    const float m = fmaxf(m_old, warp_max(tmax));
    float e = 0.f;
    for (int c = lane; c < kvalid; c += 32) e += expf(s[c] * scale - m);
    e = warp_sum(e);
    if (lane == 0) {
      m_row[r] = m;
      l_row[r] = l_row[r] * expf(m_old - m) + e;
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
    online_row_stats(sS, L.lds, QR, kvalid, scale, sM, sL);
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

// stats: three planes of [B][heads][N] fp32 (the backward's row
// statistics, written by its query side and read by its key side).
__device__ __forceinline__ size_t stat_index(int b, int h, int n, int N) {
  return (static_cast<size_t>(b) * gridDim.y + h) * N + n;
}

// Head widths the attention stages take.
inline bool attention_head_ok(int hd) {
  return hd >= 16 && hd <= 128 && hd % 16 == 0;
}

}  // namespace
