// Backward of one pre-LN ViT block on Hopper (sm_90a), bf16 or fp32.
//
// Replaces rovit_kan_tpu/ops/block_kernel.py::_vit_block_bwd_kernel, the
// recompute backward of fused_vit_block's custom VJP: the forward saves only
// x and the parameters; the backward recomputes the forward, then walks
// MLP -> LN2 -> proj -> attention -> qkv -> LN1 and returns dx (in x's type)
// and the 12 parameter grads in fp32, summed over the batch, weights in the
// nn.Linear (out, in) layout. Rounding points are the TPU kernel's: g, dx1
// and dz stay fp32; da1, dx1, the attention-output grad, dqkv and dS are
// rounded to the compute type T before their products; P is fp32 in
// dS = P * (dP - rowsum(P * dP)) * scale and rounded in dV = P^T . dO.
//
// What bounds it on an H100 SXM: at the training shape B=64, N=197, D=192,
// 3 heads, hidden 768 the work it needs is the recompute of every forward
// product but fc2 (no gradient reads the block's output), then two products
// per forward product: 3 x 1.306e10 - 2*M*D*hidden = 3.547e10 FLOP
// (M = B*N), 0.0359 ms at the bf16 tensor-core peak (989 TFLOP/s),
// 0.529 ms at the fp32 peak (67 TFLOP/s). Its bytes (x, g, dx, weights,
// grads: 22 MB in bf16) take 0.0066 ms at 3.35 TB/s, so it is
// compute-bound.
//
// The TPU kernel keeps every intermediate of a chunk of images in VMEM and
// adds its weight grads with += over a grid that runs in sequence. Here
// CTAs run concurrently, so nothing is carried between them: intermediates
// go through device memory (about 150 MB of scratch at B=64 in bf16,
// mostly L2-resident in turn, and nothing of size N x N), every cross-row
// sum is written as per-CTA fp32 partials, and one last launch adds the
// partials in a fixed order. There are no atomics, so two runs give the
// same bits. Eight launches; the route is chosen by the compute type.
//
// bf16 (D of 64, 128 or 192; any other width returns cudaErrorInvalidValue
// before any launch), mma.sync with register accumulators throughout:
//   1-2. ln_qkv and attention of the forward (vit_block_common.cuh:
//        block_mma.cuh's ln_qkv and attention_mma.cuh's forward), which
//        also store the LN1 output for the qkv weight grad;
//   3. mlp_bwd (block_bwd_mma.cuh, 96 rows a CTA): proj and the residual,
//      LN2, then per 64-wide hidden chunk fc1/GELU, dh = g . W2 and
//      da1, with dz = da1 . W1 accumulated in registers (no hidden tile),
//      the LN2 backward on dz's fragments, dattn = dx1 . Wproj; stores the
//      operands of the weight grads;
//   4. attn_bwd_q, per (64-query tile, head, image), over the key tiles:
//      S, the fp32 P, dP = dO . V^T, dS = P (dP - rowsum(P dP)) scale and
//      dQ = dS . K in registers; stores each row's softmax statistics and
//      dQ's per-tile column sums (FlashAttention-2's split: the query side
//      owns dQ);
//   5. attn_bwd_kv, per (64-key tile, head, image), over the query tiles:
//      P and dS again from those statistics, dK = dS^T . Q and
//      dV = P^T . dO and their column sums (4-5: attention_mma.cuh's
//      backward, #6's kernels with the block's scale switched in);
//   6. qkv_bwd (block_bwd_mma.cuh, 64 rows a CTA): dy = dqkv . Wqkv over
//      64-deep chunks of 3D, the LN1 backward on dy's fragments, dx;
//   7. wgrad (block_bwd_mma.cuh): the four weight grads dW = A^T . B as
//      64x64 output tiles over about four row splits, fp32 partial tiles;
//   8. reduce: every partial summed in order into the 12 grads.
// fp32, the first design: 16-row tiles of FMA products from shared memory
// for 3 and 6, the streamed attention backward of attention_common.cuh for
// 4-5, 64x64 FMA weight-grad tiles over 512-row splits for 7.
// Pad rows of every attention tile are zero in shared memory and pad
// probabilities and dS are exactly zero, and rows past B*N are zero-filled
// or masked in every row stage, so ragged shapes add nothing to any grad.
//
// The saved-residual backward (#4). vit_block_bwd_res_* replaces
// rovit_kan_tpu/ops/block_kernel.py::_vit_block_bwd_res_kernel, which reads
// qkv, the attention output and the fc1 pre-activation a1 that #3 stored (in
// T) instead of recomputing them. The same stages with three changes: no
// ln_qkv or attention-forward launch (the attention backward streams q, k
// and v from the saved qkv); mlp_bwd recomputes proj and LN2 from x and the
// saved attention output but reads a1 in place of the fc1 product, so
// h1 = GELU(a1) and GELU'(a1) see a1 rounded to T, as the TPU kernel's do;
// and qkv_bwd, which recomputes the LN1 statistics anyway, also stores the
// rounded LN1 output for the qkv weight grad. Six launches; the same
// partial sums and ordered reduce, so a repeated call gives the same bits.
// Its needed work is two products per forward product (2 x 1.306e10 FLOP),
// the proj recompute (2*M*D^2) and one S rebuild (2*B*heads*N^2*hd):
// 2.80e10 FLOP, 0.0283 ms at the bf16 peak, 0.418 ms at fp32's; its bytes
// (x, g, dx, the saved 8D per row, weights, grads: 61 MB in bf16) take
// 0.018 ms, so it is compute-bound.
//
// Interface: plain C, loaded with ctypes, as vit_block_fwd.cu. The caller
// allocates the scratch (vit_block_bwd_workspace_* bytes); every launch is
// followed by cudaGetLastError and the first error is returned.

#include "vit_block_common.cuh"
#include "block_bwd_mma.cuh"

namespace {

// The fp32 route's stages: rows per CTA of mlp_bwd and qkv_bwd, rows per
// weight-grad step, and about this many rows per weight-grad split.
constexpr int kRowsF32 = 16;
constexpr int kWgRows = 32;
constexpr int kSplitRows = 512;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ float gelu_grad(float a) {
  return 0.5f * (1.0f + erff(a * 0.70710678118654752f)) +
         a * 0.3989422804014327f * expf(-0.5f * a * a);
}

// ---- 3. MLP, LN2 and proj backward by row tiles ----------------------------

struct MlpBwdLayout {
  size_t x, a, g, da, w, c1, c2, dz, st, total;
};
template <typename T>
__host__ __device__ MlpBwdLayout mlp_bwd_layout(int D, int H) {
  constexpr int R = kRowsF32;
  const int w1 = kChunk * ld_of<T>(D);
  const int w2 = D * ld_of<T>(kChunk);
  MlpBwdLayout L;
  L.x = 0;
  L.a = L.x + align128(sizeof(float) * R * D);
  L.g = L.a + align128(sizeof(T) * R * ld_of<T>(D));
  L.da = L.g + align128(sizeof(T) * R * ld_of<T>(D));
  L.w = L.da + align128(sizeof(T) * R * ld_of<T>(H));
  L.c1 = L.w + align128(sizeof(T) * (w1 > w2 ? w1 : w2));
  L.c2 = L.c1 + align128(sizeof(float) * R * (kChunk + 4));
  L.dz = L.c2 + align128(sizeof(float) * R * (kChunk + 4));
  L.st = L.dz + align128(sizeof(float) * R * (D + 4));
  L.total = L.st + align128(sizeof(float) * 2 * R);
  return L;
}

// part: per tile, [b2 (D) | b1 (H) | ln2 scale (D) | ln2 bias (D) | bproj (D)]
// kResidual (#4): read the saved fc1 pre-activation a1_in in place of
// z . W1^T + b1 (the recompute backward #2 passes null).
template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads)
mlp_bwd_kernel(const T* __restrict__ x, const T* __restrict__ attn,
               const float* __restrict__ g, const T* __restrict__ wproj,
               const float* __restrict__ bproj,
               const float* __restrict__ ln2g, const float* __restrict__ ln2b,
               const T* __restrict__ w1, const float* __restrict__ b1,
               const T* __restrict__ w2, const T* __restrict__ a1_in,
               T* __restrict__ z_out,
               T* __restrict__ h1_out, T* __restrict__ gb_out,
               T* __restrict__ da1_out, float* __restrict__ dx1_out,
               T* __restrict__ dx1b_out, T* __restrict__ go_out,
               float* __restrict__ part, int M, int D, int H) {
  constexpr int R = kRowsF32;
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpBwdLayout L = mlp_bwd_layout<T>(D, H);
  float* sX = reinterpret_cast<float*>(smem + L.x);  // x, x1, xhat2, dx1
  T* sA = reinterpret_cast<T*>(smem + L.a);          // attn, z, dx1 rounded
  T* sG = reinterpret_cast<T*>(smem + L.g);          // g rounded
  T* sDA = reinterpret_cast<T*>(smem + L.da);        // da1 rounded
  T* sW = reinterpret_cast<T*>(smem + L.w);
  float* sC1 = reinterpret_cast<float*>(smem + L.c1);
  float* sC2 = reinterpret_cast<float*>(smem + L.c2);
  float* sDZ = reinterpret_cast<float*>(smem + L.dz);
  float* sMu = reinterpret_cast<float*>(smem + L.st);
  float* sRs = sMu + R;
  const int ld = ld_of<T>(D);
  const int ldh = ld_of<T>(H);
  const int ldk = ld_of<T>(kChunk);
  const int ldc = kChunk + 4;
  const int ldz = D + 4;
  const int r0 = blockIdx.x * R;
  const int valid = min(R, M - r0);
  const size_t row0 = static_cast<size_t>(r0) * D;
  const size_t hrow0 = static_cast<size_t>(r0) * H;
  float* pt = part + static_cast<size_t>(blockIdx.x) * (4 * D + H);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_tile<T>(sA, ld, attn + row0, D, R, valid, D);
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const bool ok = r < valid;
    sX[i] = ok ? to_f(x[row0 + i]) : 0.f;
    const T gb = from_f<T>(ok ? g[row0 + i] : 0.f);
    sG[r * ld + c] = gb;
    if (ok) gb_out[row0 + i] = gb;
  }
  for (int c = threadIdx.x; c < D; c += kThreads) {      // b2
    float s = 0.f;
    for (int r = 0; r < valid; ++r) s += g[row0 + static_cast<size_t>(r) * D + c];
    pt[c] = s;
  }

  // proj, and the first residual in fp32 (as the forward).
  for (int n0 = 0; n0 < D; n0 += kChunk) {
    __syncthreads();
    load_tile<T>(sW, ld, wproj + static_cast<size_t>(n0) * D, D, kChunk,
                 kChunk, D);
    __syncthreads();
    block_gemm<T, true>(sA, ld, sW, ld, sC1, ldc, R, kChunk, D, false);
    __syncthreads();
    for (int i = threadIdx.x; i < R * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int c = i - r * kChunk;
      sX[r * D + n0 + c] += sC1[r * ldc + c] + bproj[n0 + c];
    }
  }
  __syncthreads();
  layernorm_rows<float, T>(sX, D, R, valid, ln2g, ln2b, sA, ld, D, sMu, sRs);
  __syncthreads();
  for (int i = threadIdx.x; i < valid * D; i += kThreads) {
    const int r = i / D;
    z_out[row0 + i] = sA[r * ld + i - r * D];
  }

  // fc1 + GELU and the MLP backward in 64-column steps of the hidden
  // dimension: a1 = z . W1^T + b1 (or the saved a1), h1 = GELU(a1),
  // dh = g . W2[:, step], da1 = dh * GELU'(a1).
  for (int n0 = 0; n0 < H; n0 += kChunk) {
    __syncthreads();
    if constexpr (!kResidual) {
      load_tile<T>(sW, ld, w1 + static_cast<size_t>(n0) * D, D, kChunk,
                   kChunk, D);
      __syncthreads();
      block_gemm<T, true>(sA, ld, sW, ld, sC1, ldc, R, kChunk, D, false);
      __syncthreads();
    }
    load_tile<T>(sW, ldk, w2 + n0, H, D, D, kChunk);
    __syncthreads();
    block_gemm<T, false>(sG, ld, sW, ldk, sC2, ldc, R, kChunk, D, false);
    __syncthreads();
    for (int i = threadIdx.x; i < R * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int c = i - r * kChunk;
      float a;
      if constexpr (kResidual) {
        a = r < valid
                ? to_f(a1_in[hrow0 + static_cast<size_t>(r) * H + n0 + c])
                : 0.f;
      } else {
        a = sC1[r * ldc + c] + b1[n0 + c];
      }
      const float da = r < valid ? sC2[r * ldc + c] * gelu_grad(a) : 0.f;
      sC2[r * ldc + c] = da;
      const T dab = from_f<T>(da);
      sDA[r * ldh + n0 + c] = dab;
      if (r < valid) {
        h1_out[hrow0 + static_cast<size_t>(r) * H + n0 + c] =
            from_f<T>(gelu_erf(a));
        da1_out[hrow0 + static_cast<size_t>(r) * H + n0 + c] = dab;
      }
    }
    __syncthreads();
    column_sums(sC2, ldc, valid, kChunk, pt + D + n0);  // b1
  }

  // dz = da1 . W1 in 64-column steps of D and D-deep slices of the hidden
  // dimension.
  for (int n0 = 0; n0 < D; n0 += kChunk) {
    for (int k0 = 0; k0 < H; k0 += D) {
      __syncthreads();
      load_tile<T>(sW, ldk, w1 + static_cast<size_t>(k0) * D + n0, D, D, D,
                   kChunk);
      __syncthreads();
      block_gemm<T, false>(sDA + k0, ldh, sW, ldk, sDZ + n0, ldz, R, kChunk,
                           D, k0 > 0);
    }
  }
  __syncthreads();

  // LN2 backward. xhat2 replaces x1 first, for the scale grad.
  for (int r = warp; r < valid; r += kWarps) {
    for (int c = lane; c < D; c += 32) {
      sX[r * D + c] = (sX[r * D + c] - sMu[r]) * sRs[r];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < valid; ++r) {
      const float dz = sDZ[r * ldz + c];
      s1 += dz * sX[r * D + c];
      s2 += dz;
    }
    pt[D + H + c] = s1;                                   // ln2 scale
    pt[2 * D + H + c] = s2;                               // ln2 bias
  }
  __syncthreads();
  // dx1 = g + rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat)),
  // dxh = dz * ln2 scale.
  for (int r = warp; r < valid; r += kWarps) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float dxh = sDZ[r * ldz + c] * ln2g[c];
      s1 += dxh;
      s2 += dxh * sX[r * D + c];
    }
    const float m1 = warp_sum(s1) / D;
    const float m2 = warp_sum(s2) / D;
    for (int c = lane; c < D; c += 32) {
      const float dxh = sDZ[r * ldz + c] * ln2g[c];
      const size_t gi = row0 + static_cast<size_t>(r) * D + c;
      const float dx1 =
          g[gi] + sRs[r] * (dxh - m1 - sX[r * D + c] * m2);
      sX[r * D + c] = dx1;
      dx1_out[gi] = dx1;
      const T b = from_f<T>(dx1);
      sA[r * ld + c] = b;
      dx1b_out[gi] = b;
    }
  }
  __syncthreads();
  column_sums(sX, D, valid, D, pt + 3 * D + H);          // bproj

  // dattn = dx1 . Wproj, rounded: the attention output's grad.
  for (int n0 = 0; n0 < D; n0 += kChunk) {
    __syncthreads();
    load_tile<T>(sW, ldk, wproj + n0, D, D, D, kChunk);
    __syncthreads();
    block_gemm<T, false>(sA, ld, sW, ldk, sC1, ldc, R, kChunk, D, false);
    __syncthreads();
    for (int i = threadIdx.x; i < valid * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int c = i - r * kChunk;
      go_out[row0 + static_cast<size_t>(r) * D + n0 + c] =
          from_f<T>(sC1[r * ldc + c]);
    }
  }
}

// ---- 6. qkv and LN1 backward by row tiles ---------------------------------

struct QkvBwdLayout {
  size_t dq, x, dy, w, st, total;
};
template <typename T>
__host__ __device__ QkvBwdLayout qkv_bwd_layout(int D) {
  constexpr int R = kRowsF32;
  QkvBwdLayout L;
  L.dq = 0;
  L.x = L.dq + align128(sizeof(T) * R * ld_of<T>(3 * D));
  L.dy = L.x + align128(sizeof(float) * R * D);
  L.w = L.dy + align128(sizeof(float) * R * (D + 4));
  L.st = L.w + align128(sizeof(T) * D * ld_of<T>(kChunk));
  L.total = L.st + align128(sizeof(float) * R);
  return L;
}

// part: per tile, [ln1 scale (D) | ln1 bias (D)]
// kResidual (#4): also store the LN1 output, rounded to T, to y_out for the
// qkv weight grad (#2 has it from its forward recompute).
template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads)
qkv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dqkv,
               const float* __restrict__ dx1, const float* __restrict__ ln1g,
               const float* __restrict__ ln1b, const T* __restrict__ wqkv,
               T* __restrict__ dx, T* __restrict__ y_out,
               float* __restrict__ part, int M, int D) {
  constexpr int R = kRowsF32;
  extern __shared__ __align__(128) unsigned char smem[];
  const QkvBwdLayout L = qkv_bwd_layout<T>(D);
  T* sDQ = reinterpret_cast<T*>(smem + L.dq);
  float* sX = reinterpret_cast<float*>(smem + L.x);   // x, then xhat1
  float* sDY = reinterpret_cast<float*>(smem + L.dy);
  T* sW = reinterpret_cast<T*>(smem + L.w);
  float* sRs = reinterpret_cast<float*>(smem + L.st);
  const int ld3 = ld_of<T>(3 * D);
  const int ldk = ld_of<T>(kChunk);
  const int ldy = D + 4;
  const int r0 = blockIdx.x * R;
  const int valid = min(R, M - r0);
  const size_t row0 = static_cast<size_t>(r0) * D;
  float* pt = part + static_cast<size_t>(blockIdx.x) * 2 * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_tile<T>(sDQ, ld3, dqkv + static_cast<size_t>(r0) * 3 * D, 3 * D, R,
               valid, 3 * D);
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    sX[i] = i / D < valid ? to_f(x[row0 + i]) : 0.f;
  }
  // dy = dqkv . Wqkv in 64-column steps of D and D-deep slices of 3D.
  for (int n0 = 0; n0 < D; n0 += kChunk) {
    for (int k0 = 0; k0 < 3 * D; k0 += D) {
      __syncthreads();
      load_tile<T>(sW, ldk, wqkv + static_cast<size_t>(k0) * D + n0, D, D, D,
                   kChunk);
      __syncthreads();
      block_gemm<T, false>(sDQ + k0, ld3, sW, ldk, sDY + n0, ldy, R, kChunk,
                           D, k0 > 0);
    }
  }
  __syncthreads();
  // LN1 statistics again (as layernorm_rows computes them), xhat1 in place.
  for (int r = warp; r < valid; r += kWarps) {
    float* xr = sX + r * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += xr[c];
    const float mean = warp_sum(s) / D;
    float v = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = xr[c] - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / D + kLnEps);
    for (int c = lane; c < D; c += 32) {
      xr[c] = (xr[c] - mean) * rstd;
      if constexpr (kResidual) {
        y_out[row0 + static_cast<size_t>(r) * D + c] =
            from_f<T>(xr[c] * ln1g[c] + ln1b[c]);
      }
    }
    if (lane == 0) sRs[r] = rstd;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < valid; ++r) {
      const float dy = sDY[r * ldy + c];
      s1 += dy * sX[r * D + c];
      s2 += dy;
    }
    pt[c] = s1;
    pt[D + c] = s2;
  }
  // dx = dx1 + rstd * (dyh - mean(dyh) - xhat * mean(dyh * xhat)),
  // dyh = dy * ln1 scale.
  for (int r = warp; r < valid; r += kWarps) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float dyh = sDY[r * ldy + c] * ln1g[c];
      s1 += dyh;
      s2 += dyh * sX[r * D + c];
    }
    const float m1 = warp_sum(s1) / D;
    const float m2 = warp_sum(s2) / D;
    for (int c = lane; c < D; c += 32) {
      const float dyh = sDY[r * ldy + c] * ln1g[c];
      const size_t gi = row0 + static_cast<size_t>(r) * D + c;
      dx[gi] = from_f<T>(dx1[gi] +
                         sRs[r] * (dyh - m1 - sX[r * D + c] * m2));
    }
  }
}

// ---- 7. weight grads dW = A^T . B over row splits -------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(WgJobs jobs) {
  static_assert(std::is_same<T, float>::value, "fp32 only");
  constexpr int ld = ld_of<T>(kWgTile);
  __shared__ __align__(128) unsigned char smem[2 * kWgRows * ld * sizeof(T)];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + kWgRows * ld;
  int j = 0;
  while (j + 1 < jobs.count && jobs.job[j + 1].tile_begin <= blockIdx.x) ++j;
  const WgJob J = jobs.job[j];
  const int local = blockIdx.x - J.tile_begin;
  const int tiles_in = J.n_in / kWgTile;
  const int to = local / tiles_in;
  const int ti = local - to * tiles_in;
  const int m_begin = blockIdx.y * jobs.rows_per_split;
  const int m_end = min(jobs.M, m_begin + jobs.rows_per_split);
  const T* A = static_cast<const T*>(J.a) + to * kWgTile;
  const T* Bm = static_cast<const T*>(J.b) + ti * kWgTile;
  float* out = J.part +
               static_cast<size_t>(blockIdx.y) * J.n_out * J.n_in +
               static_cast<size_t>(to) * kWgTile * J.n_in + ti * kWgTile;

  const int tm = threadIdx.x >> 4;     // rows 4*tm .. 4*tm+3
  const int tn = threadIdx.x & 15;     // columns tn + 16*j
  float acc[4][4] = {};
  for (int m0 = m_begin; m0 < m_end; m0 += kWgRows) {
    const int rows = min(kWgRows, m_end - m0);
    __syncthreads();
    load_tile<T>(sA, ld, A + static_cast<size_t>(m0) * J.n_out, J.n_out,
                 kWgRows, rows, kWgTile);
    load_tile<T>(sB, ld, Bm + static_cast<size_t>(m0) * J.n_in, J.n_in,
                 kWgRows, rows, kWgTile);
    __syncthreads();
    for (int k = 0; k < kWgRows; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f(sA[k * ld + 4 * tm + i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = to_f(sB[k * ld + tn + 16 * q]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[static_cast<size_t>(4 * tm + i) * J.n_in + tn + 16 * q] =
          acc[i][q];
}

// ---- 8. partial sums, in order ---------------------------------------------

struct RedSeg {
  const float* src;
  float* dst;
  long long part_stride;
  int n, nparts, block_begin;
};
struct RedSegs {
  RedSeg seg[12];
  int count;
};

// kWide (the bf16 route): a segment of 32 or more partials gets a warp per
// element, lane l adding partials l, l + 32, ... in order and the lanes
// then added by a fixed butterfly, so the few columns of a bias or
// LayerNorm grad over hundreds of row tiles do not wait on one thread's
// chain of loads; every other segment, and every segment of the fp32 route,
// a thread per element adding its partials in order.
__host__ __device__ inline bool reduce_wide(const RedSeg& S) {
  return S.nparts >= 32;
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads) reduce_kernel(RedSegs segs) {
  int j = 0;
  while (j + 1 < segs.count && segs.seg[j + 1].block_begin <= blockIdx.x) ++j;
  const RedSeg S = segs.seg[j];
  if (kWide && reduce_wide(S)) {
    const int e = ((blockIdx.x - S.block_begin) * kThreads + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (e >= S.n) return;                    // the whole warp
    float s = 0.f;
    for (int p = lane; p < S.nparts; p += 32) {
      s += S.src[p * S.part_stride + e];
    }
    s = warp_sum(s);
    if (lane == 0) S.dst[e] = s;
    return;
  }
  const int i = (blockIdx.x - S.block_begin) * kThreads + threadIdx.x;
  if (i >= S.n) return;
  float s = 0.f;
  for (int p = 0; p < S.nparts; ++p) s += S.src[p * S.part_stride + i];
  S.dst[i] = s;
}

// ---- scratch and launches ---------------------------------------------------

struct Sizes {
  int B, N, D, heads, H, M, hd, mlp_tiles, qkv_tiles, attn_tiles, splits,
      rows_per_split;
};
// The row tiles of mlp_bwd and qkv_bwd, the attention backward's tile and
// the weight grads' row splits of each route. bf16: the mma.sync stages'
// CTAs, and splits that give the weight grads about kWgCtas CTAs; fp32:
// 16-row tiles and splits of about kSplitRows rows.
template <typename T>
Sizes sizes_of(int B, int N, int D, int heads, int H) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  Sizes s;
  s.B = B; s.N = N; s.D = D; s.heads = heads; s.H = H;
  s.M = B * N;
  s.hd = D / heads;
  int mlp_rows = kRowsF32, qkv_rows = kRowsF32, depth = kWgRows;
  int attn_rows;
  if constexpr (kMma) {
    mlp_rows = 16 * kMlpBwdPairs;
    qkv_rows = 16 * kQkvBwdWarps;
    attn_rows = kMmaRows;
    depth = kWgDepth;
  } else {
    attn_rows = Tile<T>::kRows;
  }
  s.mlp_tiles = (s.M + mlp_rows - 1) / mlp_rows;
  s.qkv_tiles = (s.M + qkv_rows - 1) / qkv_rows;
  s.attn_tiles = (N + attn_rows - 1) / attn_rows;
  int splits;
  if (kMma) {
    const int tiles = (4 * D * D + 2 * H * D) / (kWgTile * D);
    splits = (kWgCtas + tiles - 1) / tiles;
    const int most = (s.M + depth - 1) / depth;
    splits = splits > most ? most : splits;
  } else {
    splits = (s.M + kSplitRows - 1) / kSplitRows;
    splits = splits > 64 ? 64 : splits;
  }
  splits = splits < 1 ? 1 : splits;
  s.rows_per_split = round_up((s.M + splits - 1) / splits, depth);
  s.splits = (s.M + s.rows_per_split - 1) / s.rows_per_split;
  return s;
}

template <typename T>
struct Work {
  T *qkv, *attn, *y, *z, *h1, *gb, *da1, *dx1b, *go, *dqkv;
  float *dx1, *stats, *part_mlp, *part_qkv, *part_attn, *part_w;
  size_t total;
};

// Carves the scratch out of `base` (or only sizes it when base is null).
// The residual backward (#4) reads qkv and attn from the caller and carves
// neither.
template <typename T>
Work<T> carve(char* base, const Sizes& s, bool residual) {
  Work<T> w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base == nullptr ? nullptr : base + off;
    off += (bytes + 255) & ~static_cast<size_t>(255);
    return p;
  };
  const size_t M = s.M, D = s.D, H = s.H;
  w.qkv = residual ? nullptr
                   : reinterpret_cast<T*>(take(sizeof(T) * M * 3 * D));
  w.attn = residual ? nullptr : reinterpret_cast<T*>(take(sizeof(T) * M * D));
  w.y = reinterpret_cast<T*>(take(sizeof(T) * M * D));
  w.z = reinterpret_cast<T*>(take(sizeof(T) * M * D));
  w.h1 = reinterpret_cast<T*>(take(sizeof(T) * M * H));
  w.gb = reinterpret_cast<T*>(take(sizeof(T) * M * D));
  w.da1 = reinterpret_cast<T*>(take(sizeof(T) * M * H));
  w.dx1b = reinterpret_cast<T*>(take(sizeof(T) * M * D));
  w.go = reinterpret_cast<T*>(take(sizeof(T) * M * D));
  w.dqkv = reinterpret_cast<T*>(take(sizeof(T) * M * 3 * D));
  w.dx1 = reinterpret_cast<float*>(take(sizeof(float) * M * D));
  w.stats = reinterpret_cast<float*>(take(sizeof(float) * 3 * M * s.heads));
  w.part_mlp = reinterpret_cast<float*>(
      take(sizeof(float) * s.mlp_tiles * (4 * D + H)));
  w.part_qkv =
      reinterpret_cast<float*>(take(sizeof(float) * s.qkv_tiles * 2 * D));
  w.part_attn = reinterpret_cast<float*>(
      take(sizeof(float) * s.B * s.attn_tiles * 3 * D));
  w.part_w = reinterpret_cast<float*>(
      take(sizeof(float) * s.splits * (3 * D * D + D * D + 2 * H * D)));
  w.total = off;
  return w;
}

template <typename T>
size_t workspace_bytes(int B, int N, int D, int heads, int H, bool residual) {
  if (!block_shape_ok(B, N, D, heads, H)) return 0;
  return carve<T>(nullptr, sizes_of<T>(B, N, D, heads, H), residual).total;
}

// qkv_in, attn_in, a1_in: the residuals #3 saved (#4), or all null to
// recompute them (#2).
template <typename T>
int run_bwd(const void* x_, const void* g_, const void* qkv_in,
            const void* attn_in, const void* a1_in, void* dx_, float* grads,
            void* work_, const void* ln1g_, const void* ln1b_,
            const void* wqkv_, const void* bqkv_, const void* wproj_,
            const void* bproj_, const void* ln2g_, const void* ln2b_,
            const void* w1_, const void* b1_, const void* w2_,
            const void* b2_, int B, int N, int D, int heads, int H,
            void* stream_ptr) {
  (void)b2_;   // the forward's last bias has no part in any grad
  constexpr bool kMma = std::is_same<T, bf16>::value;
  if (!block_shape_ok(B, N, D, heads, H) ||
      (kMma && !bwd_mma_width_ok(D))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Sizes s = sizes_of<T>(B, N, D, heads, H);
  const bool residual = qkv_in != nullptr;
  const Work<T> w = carve<T>(static_cast<char*>(work_), s, residual);
  const T* qkv = residual ? static_cast<const T*>(qkv_in) : w.qkv;
  const T* attn = residual ? static_cast<const T*>(attn_in) : w.attn;
  const T* x = static_cast<const T*>(x_);
  const float* g = static_cast<const float*>(g_);
  const float* ln1g = static_cast<const float*>(ln1g_);
  const float* ln1b = static_cast<const float*>(ln1b_);
  const T* wqkv = static_cast<const T*>(wqkv_);
  const float* bqkv = static_cast<const float*>(bqkv_);
  const T* wproj = static_cast<const T*>(wproj_);
  const float* bproj = static_cast<const float*>(bproj_);
  const float* ln2g = static_cast<const float*>(ln2g_);
  const float* ln2b = static_cast<const float*>(ln2b_);
  const T* w1 = static_cast<const T*>(w1_);
  const float* b1 = static_cast<const float*>(b1_);
  const T* w2 = static_cast<const T*>(w2_);
  const float scale =
      static_cast<float>(std::pow(static_cast<double>(s.hd), -0.5));
  cudaError_t e;

  // 1-2. the forward's first two stages, keeping the LN1 output (#2 only).
  if (!residual) {
    e = launch_qkv_attention<T>(x, ln1g, ln1b, wqkv, bqkv, w.qkv, w.attn,
                                w.y, B, N, D, heads, stream);
    if (e != cudaSuccess) return e;
  }

  // 3. MLP, LN2 and proj.
  const T* a1 = static_cast<const T*>(a1_in);
  if constexpr (kMma) {
    e = launch_mlp_bwd_mma(x, attn, g, wproj, bproj, ln2g, ln2b, w1, b1, w2,
                           a1, w.z, w.h1, w.gb, w.da1, w.dx1, w.dx1b, w.go,
                           w.part_mlp, s.M, D, H, stream);
    if (e != cudaSuccess) return e;
  } else {
    const size_t sm3 = mlp_bwd_layout<T>(D, H).total;
    const auto mlp_bwd = residual ? mlp_bwd_kernel<T, true>
                                  : mlp_bwd_kernel<T, false>;
    if ((e = set_smem(mlp_bwd, sm3)) != cudaSuccess) return e;
    mlp_bwd<<<s.mlp_tiles, kThreads, sm3, stream>>>(
        x, attn, g, wproj, bproj, ln2g, ln2b, w1, b1, w2, a1, w.z, w.h1,
        w.gb, w.da1, w.dx1, w.dx1b, w.go, w.part_mlp, s.M, D, H);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }

  // 4-5. attention, query side then key side: in bf16 attention_mma.cuh's
  // backward with the block's scale, in fp32 attention_common.cuh's.
  const int hd = s.hd;
  const T* cgo = w.go;
  if constexpr (kMma) {
    e = launch_attention_bwd_block_mma<T>(
        block_heads(qkv, N, D, hd, 0), block_heads(qkv, N, D, hd, 1),
        block_heads(qkv, N, D, hd, 2), block_heads(cgo, N, D, hd, -1),
        block_heads(w.dqkv, N, D, hd, 0), block_heads(w.dqkv, N, D, hd, 1),
        block_heads(w.dqkv, N, D, hd, 2), w.stats, w.part_attn, B, heads, N,
        hd, scale, stream);
  } else {
    e = launch_attention_bwd<T>(
        block_heads(qkv, N, D, hd, 0), block_heads(qkv, N, D, hd, 1),
        block_heads(qkv, N, D, hd, 2), block_heads(cgo, N, D, hd, -1),
        block_heads(w.dqkv, N, D, hd, 0), block_heads(w.dqkv, N, D, hd, 1),
        block_heads(w.dqkv, N, D, hd, 2), w.stats, w.part_attn, B, heads, N,
        hd, scale, stream);
  }
  if (e != cudaSuccess) return e;

  // 6. qkv, LN1 and dx (and, for #4, the LN1 output).
  T* y_out = residual ? w.y : nullptr;
  if constexpr (kMma) {
    e = launch_qkv_bwd_mma(x, w.dqkv, w.dx1, ln1g, ln1b, wqkv,
                           static_cast<T*>(dx_), y_out, w.part_qkv, s.M, D,
                           stream);
    if (e != cudaSuccess) return e;
  } else {
    const size_t sm6 = qkv_bwd_layout<T>(D).total;
    const auto qkv_bwd = residual ? qkv_bwd_kernel<T, true>
                                  : qkv_bwd_kernel<T, false>;
    if ((e = set_smem(qkv_bwd, sm6)) != cudaSuccess) return e;
    qkv_bwd<<<s.qkv_tiles, kThreads, sm6, stream>>>(
        x, w.dqkv, w.dx1, ln1g, ln1b, wqkv, static_cast<T*>(dx_), y_out,
        w.part_qkv, s.M, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }

  // Grad offsets in the flat output, in the wrapper's PKEYS order.
  const size_t DD = static_cast<size_t>(D);
  const size_t HH = static_cast<size_t>(H);
  float* d_ln1g = grads;
  float* d_ln1b = d_ln1g + DD;
  float* d_wqkv = d_ln1b + DD;
  float* d_bqkv = d_wqkv + 3 * DD * DD;
  float* d_wproj = d_bqkv + 3 * DD;
  float* d_bproj = d_wproj + DD * DD;
  float* d_ln2g = d_bproj + DD;
  float* d_ln2b = d_ln2g + DD;
  float* d_w1 = d_ln2b + DD;
  float* d_b1 = d_w1 + HH * DD;
  float* d_w2 = d_b1 + HH;
  float* d_b2 = d_w2 + DD * HH;

  // 7. weight grads, split over rows.
  float* pw_qkv = w.part_w;
  float* pw_proj = pw_qkv + s.splits * 3 * DD * DD;
  float* pw_w1 = pw_proj + s.splits * DD * DD;
  float* pw_w2 = pw_w1 + s.splits * HH * DD;
  WgJobs jobs;
  jobs.count = 4;
  jobs.M = s.M;
  jobs.rows_per_split = s.rows_per_split;
  const WgJob list[4] = {{w.dqkv, w.y, pw_qkv, 3 * D, D, 0},
                         {w.dx1b, attn, pw_proj, D, D, 0},
                         {w.da1, w.z, pw_w1, H, D, 0},
                         {w.gb, w.h1, pw_w2, D, H, 0}};
  int tiles = 0;
  for (int i = 0; i < 4; ++i) {
    jobs.job[i] = list[i];
    jobs.job[i].tile_begin = tiles;
    const int tile_in = kMma ? D : kWgTile;   // bf16: 64 x D tiles
    tiles += (list[i].n_out / kWgTile) * (list[i].n_in / tile_in);
  }
  if constexpr (kMma) {
    e = launch_wgrad_mma(jobs, tiles, s.splits, D, stream);
    if (e != cudaSuccess) return e;
  } else {
    wgrad_kernel<T><<<dim3(tiles, s.splits), kThreads, 0, stream>>>(jobs);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  // 8. every partial, in order.
  const long long mlp_w = 4 * D + H;
  const RedSeg segs[12] = {
      {w.part_qkv, d_ln1g, 2 * D, D, s.qkv_tiles, 0},
      {w.part_qkv + D, d_ln1b, 2 * D, D, s.qkv_tiles, 0},
      {pw_qkv, d_wqkv, 3 * D * D, 3 * D * D, s.splits, 0},
      {w.part_attn, d_bqkv, 3 * D, 3 * D, B * s.attn_tiles, 0},
      {pw_proj, d_wproj, D * D, D * D, s.splits, 0},
      {w.part_mlp + 3 * D + H, d_bproj, mlp_w, D, s.mlp_tiles, 0},
      {w.part_mlp + D + H, d_ln2g, mlp_w, D, s.mlp_tiles, 0},
      {w.part_mlp + 2 * D + H, d_ln2b, mlp_w, D, s.mlp_tiles, 0},
      {pw_w1, d_w1, H * D, H * D, s.splits, 0},
      {w.part_mlp + D, d_b1, mlp_w, H, s.mlp_tiles, 0},
      {pw_w2, d_w2, D * H, D * H, s.splits, 0},
      {w.part_mlp, d_b2, mlp_w, D, s.mlp_tiles, 0}};
  RedSegs red;
  red.count = 12;
  int blocks = 0;
  for (int i = 0; i < 12; ++i) {
    red.seg[i] = segs[i];
    red.seg[i].block_begin = blocks;
    const int threads = kMma && reduce_wide(segs[i]) ? 32 * segs[i].n
                                                     : segs[i].n;
    blocks += (threads + kThreads - 1) / kThreads;
  }
  reduce_kernel<kMma><<<blocks, kThreads, 0, stream>>>(red);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define VIT_BLOCK_BWD_ARGS                                                  \
  const void *x, const void *g, void *dx, void *grads, void *work,          \
      const void *ln1g, const void *ln1b, const void *wqkv,                 \
      const void *bqkv, const void *wproj, const void *bproj,               \
      const void *ln2g, const void *ln2b, const void *w1, const void *b1,   \
      const void *w2, const void *b2, int B, int N, int D, int heads,       \
      int H, void *stream
#define VIT_BLOCK_BWD_PASS                                                  \
  dx, static_cast<float*>(grads), work, ln1g, ln1b, wqkv, bqkv, wproj,      \
      bproj, ln2g, ln2b, w1, b1, w2, b2, B, N, D, heads, H, stream

extern "C" int vit_block_bwd_bf16(VIT_BLOCK_BWD_ARGS) {
  return run_bwd<bf16>(x, g, nullptr, nullptr, nullptr, VIT_BLOCK_BWD_PASS);
}

extern "C" int vit_block_bwd_f32(VIT_BLOCK_BWD_ARGS) {
  return run_bwd<float>(x, g, nullptr, nullptr, nullptr, VIT_BLOCK_BWD_PASS);
}

extern "C" size_t vit_block_bwd_workspace_bf16(int B, int N, int D,
                                               int heads, int H) {
  return workspace_bytes<bf16>(B, N, D, heads, H, false);
}

extern "C" size_t vit_block_bwd_workspace_f32(int B, int N, int D,
                                              int heads, int H) {
  return workspace_bytes<float>(B, N, D, heads, H, false);
}

// #4: qkv (B*N, 3D), attn (B*N, D) and a1 (B*N, H) in T, as #3 stored them.
extern "C" int vit_block_bwd_res_bf16(const void* qkv, const void* attn,
                                      const void* a1, VIT_BLOCK_BWD_ARGS) {
  return run_bwd<bf16>(x, g, qkv, attn, a1, VIT_BLOCK_BWD_PASS);
}

extern "C" int vit_block_bwd_res_f32(const void* qkv, const void* attn,
                                     const void* a1, VIT_BLOCK_BWD_ARGS) {
  return run_bwd<float>(x, g, qkv, attn, a1, VIT_BLOCK_BWD_PASS);
}

extern "C" size_t vit_block_bwd_res_workspace_bf16(int B, int N, int D,
                                                   int heads, int H) {
  return workspace_bytes<bf16>(B, N, D, heads, H, true);
}

extern "C" size_t vit_block_bwd_res_workspace_f32(int B, int N, int D,
                                                  int heads, int H) {
  return workspace_bytes<float>(B, N, D, heads, H, true);
}

extern "C" const char* vit_block_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
