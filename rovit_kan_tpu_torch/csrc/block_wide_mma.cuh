// The bf16 stages of the ViT-block forward at every width past 192 up to
// 768 that block_shape_ok admits (D a multiple of 64: the small and base
// presets' 384 and 768, and 256, 320, 448, 512, ...; hidden H a multiple of
// D), on Hopper (sm_90a): a tiled mma.sync GEMM with the block's
// epilogues, and a LayerNorm over rows. vit_block_fwd.cu runs them for #1 and #3, and the
// backward vit_block_bwd.cu for its recompute (block_wide_bwd_mma.cuh
// holds the backward's own wide stages).
//
// Why not block_mma.cuh's stages at these widths. Those keep a warp's rows
// whole in registers: proj_mlp's fc2 accumulators are 16 x D fp32 a warp,
// 16 D / 32 registers a thread (96 at D = 192, where the stage already
// uses 255; 192 at D = 384, 384 at D = 768), and its shared memory (a ring
// of [64][D + 8] tiles and the 48 x (D + 8) fp32 x1) grows with D, to
// 181.5 KB at D = 384 and 361.5 KB at D = 768 against the 227 KB a block
// can have. So here every product is one GEMM over output tiles of
// 128 x 128, its depth streamed 64 at a time, so neither the
// registers nor the shared memory grow with D, and the values between the
// products pass through device memory at the TPU kernel's own rounding
// points (rovit_kan_tpu/ops/block_kernel.py:98-149): y = LN1(x) and
// z = LN2(x1) rounded to bf16, qkv rounded, x1 in fp32, h = GELU(a)
// rounded. A split stage so keeps the fused stages' bits up to the order
// of the fp32 sums inside a product or a LayerNorm.
//
// Seven launches for #1: LN1 (ln_rows), qkv (GEMM, bias and rounding),
// attention (attention_mma.cuh, unchanged: head width 64), proj (GEMM,
// x1 = x + (acc + bproj) in fp32), LN2 (ln_rows over x1), fc1 (GEMM,
// h = round(GELU(acc + b1)); #3 also stores a1 = round(acc + b1) from the
// same registers, so its output keeps #1's bits) and fc2 (GEMM,
// out = round(x1 + (acc + b2))).
//
// The GEMM (gemm_tile, gemm_mma_kernel): a CTA of 8 warps owns a 128 x 128
// output tile (128 x 64 where the product's N is not a multiple of 128:
// qkv at D = 320, 448, ... and every N = D there), each warp 64 x 32 (or
// 64 x 16) with every accumulator in registers;
// A [rows][K] and B ([N][K], a Linear weight, or [K][N], read through
// ldmatrix.trans) stream through a three-stage cp.async ring of 64-deep
// tiles (108 KB, two CTAs an SM), one __syncthreads a step;
// mma.sync.m16n8k16 bf16 -> fp32.
// Padded rows (+8 elements) keep every ldmatrix conflict-free. Rows past M
// are zero-filled in and skipped out. Every element's sum runs over K in
// the same order whatever the tiling, so the tiling changes no bit. wgmma
// and TMA are later work.
//
// At D = 384 and 768 every N is a multiple of 128 and every lane of a
// LayerNorm row holds a group, so neither the 128 x 64 tiles nor the idle
// lanes reach those widths.
//
// What bounds it: at (64, 197, 384) one #1 does 2 M D 12 D = 4.46e10 FLOP
// in the four products plus 4 B N^2 D = 3.82e9 in attention, 4.84e10 in
// all, 49.0 us at the bf16 peak (989 TFLOP/s); at D = 768 1.86e11, 188.2 us.
// With every intermediate through device memory (x read twice; out, y,
// qkv, attn, z and h written once and read once; x1 written once and read
// twice) it moves about 56 D bytes a row: 0.27 GB at (64, 197, 384), 0.081
// ms at 3.35 TB/s if none of it stayed in the 50 MB L2. The function's own
// bytes (x in, out, weights: 22.9 MB at D = 384) take 6.8 us, so its bound
// is the operations'; the split's extra traffic is the price of the
// registers and shared memory above, and the LayerNorm launches are
// bytes-bound.

#pragma once

#include "block_mma.cuh"

namespace {

// ---- the GEMM --------------------------------------------------------------

constexpr int kGmRows = 128;       // rows of a CTA's output tile
constexpr int kGmCols = 128;       // its columns (mlp_grad's: 64)
constexpr int kGmBK = 64;          // depth of a ring stage
constexpr int kGmStages = 3;       // cp.async ring stages
constexpr int kGmThreads = 256;    // 8 warps: 2 along the rows x 4 along N

// A CTA's 128 x BN output tile, each warp's 64 x BN / 4, and the ring.
template <int BN, bool kKN>
struct GmPlan {
  static constexpr int kLdA = kGmBK + 8;                  // [128][BK]
  static constexpr int kLdB = kKN ? BN + 8 : kGmBK + 8;   // [BK][BN] | [BN][BK]
  static constexpr int kA = kGmRows * kLdA;
  static constexpr int kB = kKN ? kGmBK * kLdB : BN * kLdB;
  static constexpr int kStage = kA + kB;
  static constexpr int WM = kGmRows / 2, WN = BN / 4;     // a warp's tile
  static constexpr int MI = WM / 16, NI = WN / 8;         // its mma blocks
  static constexpr size_t kSmem = sizeof(bf16) * kGmStages * kStage;
  static_assert(NI % 2 == 0, "B fragments come in pairs of 8 columns");
};

template <int MI, int NI>
__device__ __forceinline__ void zero_tile(float (&acc)[MI][NI][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i) zero_acc<NI>(acc[i]);
}

// acc += A[m0 .. m0 + 127, :] . B over the CTA's output columns
// n0 .. n0 + BN - 1, depth K: A (M, K) row-major with row stride lda; B
// stored [N][K] (kKN false: a Linear weight (out, in), the product
// A . B^T) or [K][N] (kKN true), row stride ldb. Warp w adds its tile
// (rows 64 (w / 4).., columns BN / 4 (w % 4)..) in the C fragment layout of
// mma_common.cuh. Rows of A past M are zero-filled. Leaves the ring drained
// and every thread past it, so the caller may reuse the shared memory.
template <int BN, bool kKN>
__device__ __forceinline__ void gemm_tile(
    float (&acc)[GmPlan<BN, kKN>::MI][GmPlan<BN, kKN>::NI][4], bf16* smem,
    const bf16* __restrict__ A, long long lda, const bf16* __restrict__ B,
    long long ldb, int M, int K, int m0, int n0) {
  using P = GmPlan<BN, kKN>;
  constexpr int BK = kGmBK, S = kGmStages;
  constexpr int kVa = BK / 8;                          // 16-byte vectors
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * P::WM, wn = (warp & 3) * P::WN;
  const int steps = K / BK;
  auto load = [&](int kt) {
    bf16* sa = smem + (kt % S) * P::kStage;
    bf16* sb = sa + P::kA;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = tid; i < kGmRows * kVa; i += kGmThreads) {
      const int r = i / kVa, c = (i % kVa) * 8;
      const bool ok = m0 + r < M;
      cp_async16(sa + r * P::kLdA + c,
                 ok ? A + static_cast<long long>(m0 + r) * lda + k0 + c : A,
                 ok);
    }
    if constexpr (kKN) {
      constexpr int kVb = BN / 8;
#pragma unroll
      for (int i = tid; i < BK * kVb; i += kGmThreads) {
        const int r = i / kVb, c = (i % kVb) * 8;
        cp_async16(sb + r * P::kLdB + c,
                   B + static_cast<long long>(k0 + r) * ldb + n0 + c, true);
      }
    } else {
#pragma unroll
      for (int i = tid; i < BN * kVa; i += kGmThreads) {
        const int r = i / kVa, c = (i % kVa) * 8;
        cp_async16(sb + r * P::kLdB + c,
                   B + static_cast<long long>(n0 + r) * ldb + k0 + c, true);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();           // step kt landed; step kt - 1's stage is free
    if (kt + S - 1 < steps) load(kt + S - 1);
    cp_async_commit();
    const bf16* sa = smem + (kt % S) * P::kStage;
    const bf16* sb = sa + P::kA;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[P::MI][4];
#pragma unroll
      for (int i = 0; i < P::MI; ++i) {
        ldsm_x4(a[i], a_addr<P::kLdA>(sa, wm + 16 * i, 16 * kk, lane));
      }
#pragma unroll
      for (int p = 0; p < P::NI / 2; ++p) {
        uint32_t b[4];
        if constexpr (kKN) {
          ldsm_x4_t(b, bkn_addr<P::kLdB>(sb, 16 * kk, wn + 16 * p, lane));
        } else {
          ldsm_x4(b, bnk_addr<P::kLdB>(sb, wn + 16 * p, 16 * kk, lane));
        }
#pragma unroll
        for (int i = 0; i < P::MI; ++i) {
          mma_bf16(acc[i][2 * p], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// The epilogues. Element (r, c) of the product is acc + (for the biased
// ones) bias[c], in fp32:
enum GemmEpi {
  kEpiQkv,     // out (bf16) = round(acc + bias)
  kEpiProj,    // out (fp32) = x + (acc + bias), x bf16 (M, N)
  kEpiFc1,     // out (bf16) = round(GELU(acc + bias)); a1 = round(acc + bias)
               // where given (#3)
  kEpiFc2,     // out (bf16) = round(x1 + (acc + bias)), x1 fp32 (M, N)
  kEpiRound,   // out (bf16) = round(acc)
  kEpiF32      // out (fp32) = acc
};

struct GemmArgs {
  const bf16* a;          // (M, K), row stride lda
  const bf16* b;          // [N][K] or [K][N], row stride ldb
  long long lda, ldb;
  int M, N, K;
  const float* bias;      // (N)
  const bf16* xres;       // kEpiProj's x
  const float* fres;      // kEpiFc2's x1
  void* out;              // (M, N), row stride N
  bf16* a1;               // kEpiFc1's a1 (#3), or null
};

template <int BN, bool kKN, int kEpi>
__global__ void __launch_bounds__(kGmThreads, 2) gemm_mma_kernel(GemmArgs g) {
  using P = GmPlan<BN, kKN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kGmRows;
  float acc[P::MI][P::NI][4];
  zero_tile(acc);
  gemm_tile<BN, kKN>(acc, reinterpret_cast<bf16*>(smem), g.a, g.lda, g.b,
                     g.ldb, g.M, g.K, m0, n0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * P::WM, wn = (warp & 3) * P::WN;
#pragma unroll
  for (int i = 0; i < P::MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm + 16 * i + gq + 8 * half;
      if (r >= g.M) continue;
#pragma unroll
      for (int j = 0; j < P::NI; ++j) {
        const int c = n0 + wn + 8 * j + 2 * t;
        const size_t o = static_cast<size_t>(r) * g.N + c;
        const float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
        bf16* ob = static_cast<bf16*>(g.out);
        float* of = static_cast<float*>(g.out);
        if constexpr (kEpi == kEpiRound) {
          u32_at(ob + o) = pack_bf16(v0, v1);
        } else if constexpr (kEpi == kEpiF32) {
          *reinterpret_cast<float2*>(of + o) = make_float2(v0, v1);
        } else {
          const float2 bb = *reinterpret_cast<const float2*>(g.bias + c);
          const float a0 = v0 + bb.x, a1 = v1 + bb.y;
          if constexpr (kEpi == kEpiQkv) {
            u32_at(ob + o) = pack_bf16(a0, a1);
          } else if constexpr (kEpi == kEpiProj) {
            const float2 xv = u32_to_f2(load_u32(g.xres + o));
            *reinterpret_cast<float2*>(of + o) =
                make_float2(xv.x + a0, xv.y + a1);
          } else if constexpr (kEpi == kEpiFc1) {
            if (g.a1 != nullptr) u32_at(g.a1 + o) = pack_bf16(a0, a1);
            u32_at(ob + o) = pack_bf16(gelu_erf(a0), gelu_erf(a1));
          } else {
            const float2 x1 = *reinterpret_cast<const float2*>(g.fres + o);
            u32_at(ob + o) = pack_bf16(x1.x + a0, x1.y + a1);
          }
        }
      }
    }
  }
}

// The tiling (128 x 128 tiles of 8 warps, 64-deep stages in a ring of
// three: 108 KB, two CTAs an SM) was the fastest, at every product of both
// presets on an H100 SXM, of the tilings tried: 128 x 64 and 128 x 256
// tiles, 4 or 8 warps, 32-deep stages in a ring of four. A 128 x 128 tile
// does 64 FLOP a byte it brings from L2, which caps these products well
// under the tensor cores' rate. An N that 128 does not divide (any D an
// odd multiple of 64) takes 128 x 64 tiles; the sum over K runs in the same
// order either way, so the tile width changes no bit.
template <int BN, bool kKN, int kEpi>
cudaError_t launch_gemm_bn(const GemmArgs& g, cudaStream_t stream) {
  using P = GmPlan<BN, kKN>;
  const auto kernel = gemm_mma_kernel<BN, kKN, kEpi>;
  cudaError_t e;
  if ((e = set_smem(kernel, P::kSmem)) != cudaSuccess) return e;
  kernel<<<dim3(g.N / BN, (g.M + kGmRows - 1) / kGmRows), kGmThreads,
           P::kSmem, stream>>>(g);
  return cudaGetLastError();
}

template <bool kKN, int kEpi>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  if (g.M < 1 || g.N % 64 != 0 || g.K % kGmBK != 0) {
    return cudaErrorInvalidValue;
  }
  return g.N % kGmCols == 0 ? launch_gemm_bn<kGmCols, kKN, kEpi>(g, stream)
                            : launch_gemm_bn<64, kKN, kEpi>(g, stream);
}

// ---- LayerNorm over rows ---------------------------------------------------

constexpr int kRowWarps = 8;       // a row a warp, 8 rows a CTA

template <typename In>
__device__ __forceinline__ void load4(const In* p, float (&v)[4]) {
  if constexpr (std::is_same<In, float>::value) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = u32_to_f2(u.x), hi = u32_to_f2(u.y);
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
}
__device__ __forceinline__ void store4_bf16(bf16* p, float a, float b,
                                            float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(a, b), pack_bf16(c, d));
}

// The widest D of the wide stages, and the 4-column groups a lane holds of
// a row at most: lane l holds columns 4 (l + 32 i) .. + 3 for the i with
// 4 (l + 32 i) < D, so a D that 128 does not divide leaves the upper lanes
// of the last group idle.
constexpr int kWideMaxD = 768;
constexpr int kRowV = kWideMaxD / 128;

// Whether lane `lane` holds group i of a row of D.
__device__ __forceinline__ bool row_has(int D, int lane, int i) {
  return 4 * (lane + 32 * i) < D;
}

// Two-pass fp32 mean and 1 / sqrt(var + eps) of a row of D held as
// v[kRowV][4] by the 32 lanes of a warp (groups a lane does not hold are
// zero, and add nothing to either sum).
__device__ __forceinline__ void wide_row_stats(const float (&v)[kRowV][4],
                                               int D, float& mean,
                                               float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kRowV; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s += v[i][e];
  }
  mean = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kRowV; ++i) {
    if (!row_has(D, lane, i)) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = v[i][e] - mean;
      q += d * d;
    }
  }
  rstd = rsqrtf(warp_sum(q) / D + kLnEps);
}

// y = round(LN(x) * g + b) for rows of D (x bf16, or the fp32 x1), a row a
// warp, lane l holding columns 4 (l + 32 i) .. + 3. Where cp_dst is given,
// the fp32 rows cp_src are also copied to it rounded (the backward's gb).
// One instance a type takes every D (a multiple of 64 up to kWideMaxD).
template <typename In>
__global__ void __launch_bounds__(32 * kRowWarps)
ln_rows_kernel(const In* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ b, bf16* __restrict__ y,
               const float* __restrict__ cp_src, bf16* __restrict__ cp_dst,
               int M, int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const size_t base = static_cast<size_t>(row) * D;
  float v[kRowV][4];
#pragma unroll
  for (int i = 0; i < kRowV; ++i) {
    if (row_has(D, lane, i)) {
      load4(x + base + 4 * (lane + 32 * i), v[i]);
    } else {
      v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
    }
  }
  float mean, rstd;
  wide_row_stats(v, D, mean, rstd);
#pragma unroll
  for (int i = 0; i < kRowV; ++i) {
    if (!row_has(D, lane, i)) continue;
    const int c = 4 * (lane + 32 * i);
    const float4 gg = *reinterpret_cast<const float4*>(g + c);
    const float4 bb = *reinterpret_cast<const float4*>(b + c);
    store4_bf16(y + base + c, (v[i][0] - mean) * rstd * gg.x + bb.x,
                (v[i][1] - mean) * rstd * gg.y + bb.y,
                (v[i][2] - mean) * rstd * gg.z + bb.z,
                (v[i][3] - mean) * rstd * gg.w + bb.w);
    if (cp_dst != nullptr) {
      const float4 f = *reinterpret_cast<const float4*>(cp_src + base + c);
      store4_bf16(cp_dst + base + c, f.x, f.y, f.z, f.w);
    }
  }
}

// The widths the wide stages take: past block_mma.cuh's 192, a multiple of
// 64 up to kWideMaxD (block_shape_ok checks the rest of the shape).
inline bool wide_width(int D) {
  return D > 192 && D <= kWideMaxD && D % 64 == 0;
}

template <typename In>
cudaError_t launch_ln_rows(const In* x, const float* g, const float* b,
                           bf16* y, const float* cp_src, bf16* cp_dst, int M,
                           int D, cudaStream_t stream) {
  if (D % 64 != 0 || D > kWideMaxD) return cudaErrorInvalidValue;
  const dim3 grid((M + kRowWarps - 1) / kRowWarps);
  ln_rows_kernel<In><<<grid, 32 * kRowWarps, 0, stream>>>(
      x, g, b, y, cp_src, cp_dst, M, D);
  return cudaGetLastError();
}

// ---- the forward's wide stages ---------------------------------------------

// LN1 + qkv: y = round(LN1(x)) into y (the forward's scratch; the
// backward's qkv weight-grad operand), qkv = round(y . Wqkv^T + bqkv).
inline cudaError_t launch_ln_qkv_wide(const bf16* x, const float* g,
                                      const float* b, const bf16* w,
                                      const float* bias, bf16* qkv, bf16* y,
                                      int M, int D, cudaStream_t stream) {
  if (y == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = launch_ln_rows<bf16>(x, g, b, y, nullptr, nullptr, M, D,
                                       stream);
  if (e != cudaSuccess) return e;
  GemmArgs q = {};
  q.a = y; q.lda = D; q.b = w; q.ldb = D;
  q.M = M; q.N = 3 * D; q.K = D;
  q.bias = bias; q.out = qkv;
  return launch_gemm<false, kEpiQkv>(q, stream);
}

// x1 = x + (attn . Wproj^T + bproj) in fp32 into x1 (M, D).
inline cudaError_t launch_proj_wide(const bf16* x, const bf16* attn,
                                    const bf16* wproj, const float* bproj,
                                    float* x1, int M, int D,
                                    cudaStream_t stream) {
  GemmArgs p = {};
  p.a = attn; p.lda = D; p.b = wproj; p.ldb = D;
  p.M = M; p.N = D; p.K = D;
  p.bias = bproj; p.xres = x; p.out = x1;
  return launch_gemm<false, kEpiProj>(p, stream);
}

// proj + residual, LN2, fc1 + GELU (and #3's a1), fc2 + residual: four
// launches through the scratch x1 (M, D) fp32, z (M, D) and h (M, H).
inline cudaError_t launch_proj_mlp_wide(
    const bf16* x, const bf16* attn, const bf16* wproj, const float* bproj,
    const float* g2, const float* bn2, const bf16* w1, const float* b1,
    const bf16* w2, const float* b2, bf16* out, bf16* a1, float* x1, bf16* z,
    bf16* h, int M, int D, int H, cudaStream_t stream) {
  cudaError_t e = launch_proj_wide(x, attn, wproj, bproj, x1, M, D, stream);
  if (e != cudaSuccess) return e;
  e = launch_ln_rows<float>(x1, g2, bn2, z, nullptr, nullptr, M, D, stream);
  if (e != cudaSuccess) return e;
  GemmArgs f1 = {};
  f1.a = z; f1.lda = D; f1.b = w1; f1.ldb = D;
  f1.M = M; f1.N = H; f1.K = D;
  f1.bias = b1; f1.out = h; f1.a1 = a1;
  e = launch_gemm<false, kEpiFc1>(f1, stream);
  if (e != cudaSuccess) return e;
  GemmArgs f2 = {};
  f2.a = h; f2.lda = H; f2.b = w2; f2.ldb = H;
  f2.M = M; f2.N = D; f2.K = H;
  f2.bias = b2; f2.fres = x1; f2.out = out;
  return launch_gemm<false, kEpiFc2>(f2, stream);
}

// The forward's scratch at a wide D: y, x1 (fp32), z and h.
struct WideFwdWork {
  bf16* y;
  float* x1;
  bf16 *z, *h;
  size_t total;
};

inline WideFwdWork carve_wide_fwd(char* base, int M, int D, int H) {
  WideFwdWork w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base == nullptr ? nullptr : base + off;
    off += (bytes + 255) & ~static_cast<size_t>(255);
    return p;
  };
  const size_t m = static_cast<size_t>(M);
  w.y = reinterpret_cast<bf16*>(take(sizeof(bf16) * m * D));
  w.x1 = reinterpret_cast<float*>(take(sizeof(float) * m * D));
  w.z = reinterpret_cast<bf16*>(take(sizeof(bf16) * m * D));
  w.h = reinterpret_cast<bf16*>(take(sizeof(bf16) * m * H));
  w.total = off;
  return w;
}

}  // namespace
