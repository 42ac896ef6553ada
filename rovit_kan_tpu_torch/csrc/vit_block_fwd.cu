// Forward of one pre-LN ViT block on Hopper (sm_90a), bf16 or fp32.
//
// Replaces rovit_kan_tpu/ops/block_kernel.py::_vit_block_kernel (the Pallas
// TPU kernel behind fused_vit_block). Same function and the same rounding
// points:
//   y   = LN1(x) in fp32, rounded to the compute type T
//   qkv = y . Wqkv^T + bqkv (fp32 accumulate, fp32 bias), rounded to T
//   per image and head: S = q . k^T * hd^-1/2 (fp32), softmax in fp32,
//       P rounded to T, O = P . v (fp32), rounded to T
//   x1  = x + (O . Wproj^T + bproj)          residual in fp32
//   z   = LN2(x1) rounded to T
//   h   = GELU(z . W1^T + b1) rounded to T
//   out = x1 + (h . W2^T + b2)               residual in fp32, one rounding
// LayerNorm is two-pass (mean, then mean of squared deviations) with
// rsqrtf(var + 1e-6). GELU uses CUDA's erff, which is exact to fp32; the TPU
// kernel uses the Abramowitz-Stegun 7.1.26 rational erf (|err| < 1.5e-7)
// because Pallas on the TPU has no erf, so the two differ below fp32 noise.
// The TPU kernel pads 197 tokens to 200 and masks keys with -1e30 for
// Mosaic's (8, 128) tiling; here loops run to N and the ragged edge is
// masked instead (pad rows of K and V are zero in shared memory, pad
// columns of P are zero).
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM):
// at the serving shape B=64, N=197, D=192, 3 heads, hidden 768, one call
// does 2*B*N*D*(3D + D + 2*4D) = 1.116e10 FLOP in the four products plus
// 4*B*N*N*D = 1.908e9 FLOP in attention, 1.307e10 FLOP in all: 13.2 us at
// the bf16 peak. It must move x in and out once (2 * 4.84 MB in bf16) plus
// 0.88 MB of bf16 weights, about 10.6 MB: 3.2 us at the HBM rate. So it is
// compute-bound, by a factor of four.
//
// First design, right before fast. Three launches per block call, each a
// grid of independent CTAs of 256 threads:
//   1. ln_qkv:    a tile of 64 rows (32 in fp32): LN1 into shared memory,
//                 then the qkv product in 64-column steps;
//   2. attention: one CTA per (64-query tile, head, image), streaming
//                 64-key tiles of K and V through shared memory in two
//                 passes (row statistics, then P . V), so any sequence
//                 length fits (attention_common.cuh, shared with the
//                 attention-only kernel #5 in attention.cu);
//   3. proj_mlp:  a tile of 64 rows (32 in fp32): proj, the fp32 residual,
//                 LN2, fc1, GELU (the 64 x 768 hidden tile stays in shared
//                 memory), fc2 and the second residual.
// qkv and the attention output go through device memory (2 x 7.3 MB in
// bf16 at B=64, mostly served from the 50 MB L2); every other intermediate
// stays on chip. bf16 products use the tensor cores through WMMA 16x16x16
// fragments read from shared memory; fp32 products are plain FMA loops (the
// TPU kernel's fp32 mode also stays out of reduced precision). Weights are
// streamed through shared memory in 64-row chunks, with no overlap of loads
// and math: wgmma, TMA and a persistent pipelined design are later work.
//
// The helpers and the first two stages live in vit_block_common.cuh, which
// the backward (vit_block_bwd.cu) shares.
//
// The residual-saving forward (#3). vit_block_res_fwd_* replaces
// rovit_kan_tpu/ops/block_kernel.py::_vit_block_res_kernel, the forward that
// runs under differentiation with ROVIT_BLOCK_RESIDUAL_BWD=1: the same three
// launches, with qkv (rows, 3D) and the attention output (rows, D), which
// already pass through device memory, returned to the caller, and proj_mlp
// also storing the fc1 pre-activation a1 (rows, H) in T, rounded after the
// fp32 bias add, from the same registers the GELU reads. The output is
// computed by the same instructions, so it has #1's bits. On the TPU the
// spills shrank the VMEM image chunk; here they are one extra (rows, 4D)
// store on top of #1 (19.4 MB at B=64 in bf16). The work stays #1's
// 1.306e10 FLOP (0.0132 ms at the bf16 peak), but x, out and the 38.7 MB of
// returned intermediates (49 MB in bf16) take 0.0147 ms at the HBM rate, so
// bytes bound it in bf16 by a hair; in fp32 operations do (0.195 ms).
//
// Interface: plain C, loaded with ctypes. Each entry returns the first
// CUDA error (0 = success), checked with cudaGetLastError after every
// launch, so a launch refused for its resources is reported and never
// silently skipped. Nothing is allocated here and nothing synchronises.

#include "vit_block_common.cuh"

namespace {

// ---- 3. proj + residual + LN2 + fc1 + GELU + fc2 + residual ---------------

struct MlpLayout {
  size_t a, x, h, w, c, total;
};
template <typename T>
__host__ __device__ MlpLayout proj_mlp_layout(int D, int H) {
  constexpr int R = Tile<T>::kRows;
  MlpLayout L;
  L.a = 0;
  L.x = L.a + align128(sizeof(T) * R * ld_of<T>(D));
  L.h = L.x + align128(sizeof(float) * R * D);
  L.w = L.h + align128(sizeof(T) * R * ld_of<T>(H));
  L.c = L.w + align128(sizeof(T) * kChunk * ld_of<T>(D));
  L.total = L.c + align128(sizeof(float) * R * (kChunk + 4));
  return L;
}

// kStoreA1 (#3): also store the fc1 pre-activation to a1_out.
template <typename T, bool kStoreA1>
__global__ void __launch_bounds__(kThreads)
proj_mlp_kernel(const T* __restrict__ x, const T* __restrict__ attn,
                const T* __restrict__ wproj, const float* __restrict__ bproj,
                const float* __restrict__ g2, const float* __restrict__ bn2,
                const T* __restrict__ w1, const float* __restrict__ b1,
                const T* __restrict__ w2, const float* __restrict__ b2,
                T* __restrict__ out, T* __restrict__ a1_out, int M, int D,
                int H) {
  constexpr int R = Tile<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpLayout L = proj_mlp_layout<T>(D, H);
  T* sA = reinterpret_cast<T*>(smem + L.a);        // attention out, then z
  float* sX = reinterpret_cast<float*>(smem + L.x);  // x, then x1
  T* sH = reinterpret_cast<T*>(smem + L.h);
  T* sW = reinterpret_cast<T*>(smem + L.w);
  float* sC = reinterpret_cast<float*>(smem + L.c);
  const int ld = ld_of<T>(D);
  const int ldh = ld_of<T>(H);
  const int ldc = kChunk + 4;
  const int r0 = blockIdx.x * R;
  const int valid = min(R, M - r0);

  load_tile<T>(sA, ld, attn + static_cast<size_t>(r0) * D, D, R, valid, D);
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D;
    sX[i] = r < valid ? to_f(x[static_cast<size_t>(r0) * D + i]) : 0.f;
  }

  // proj, and the first residual in fp32.
  for (int n0 = 0; n0 < D; n0 += kChunk) {
    __syncthreads();
    load_tile<T>(sW, ld, wproj + static_cast<size_t>(n0) * D, D, kChunk,
                 kChunk, D);
    __syncthreads();
    block_gemm<T, true>(sA, ld, sW, ld, sC, ldc, R, kChunk, D, false);
    __syncthreads();
    for (int i = threadIdx.x; i < R * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int c = i - r * kChunk;
      float* xr = sX + r * D + n0 + c;
      *xr = *xr + (sC[r * ldc + c] + bproj[n0 + c]);
    }
  }
  __syncthreads();
  layernorm_rows<float, T>(sX, D, R, R, g2, bn2, sA, ld, D);

  // fc1 + GELU; the hidden tile stays in shared memory. With kStoreA1
  // the pre-activation is stored too, rounded to T.
  for (int n0 = 0; n0 < H; n0 += kChunk) {
    __syncthreads();
    load_tile<T>(sW, ld, w1 + static_cast<size_t>(n0) * D, D, kChunk, kChunk,
                 D);
    __syncthreads();
    block_gemm<T, true>(sA, ld, sW, ld, sC, ldc, R, kChunk, D, false);
    __syncthreads();
    for (int i = threadIdx.x; i < R * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int c = i - r * kChunk;
      const float a = sC[r * ldc + c] + b1[n0 + c];
      sH[r * ldh + n0 + c] = from_f<T>(gelu_erf(a));
      if (kStoreA1 && r < valid) {
        a1_out[static_cast<size_t>(r0 + r) * H + n0 + c] = from_f<T>(a);
      }
    }
  }

  // fc2 in D-wide slices of the hidden dimension, and the second residual.
  for (int n0 = 0; n0 < D; n0 += kChunk) {
    for (int k0 = 0; k0 < H; k0 += D) {
      __syncthreads();
      load_tile<T>(sW, ld, w2 + static_cast<size_t>(n0) * H + k0, H, kChunk,
                   kChunk, D);
      __syncthreads();
      block_gemm<T, true>(sH + k0, ldh, sW, ld, sC, ldc, R, kChunk, D,
                          k0 > 0);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < valid * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int c = i - r * kChunk;
      out[static_cast<size_t>(r0 + r) * D + n0 + c] = from_f<T>(
          sX[r * D + n0 + c] + (sC[r * ldc + c] + b2[n0 + c]));
    }
  }
}

// qkv, attn: the first two stages' outputs (scratch for #1, returned by
// #3); a1: the fc1 pre-activation, stored only when given (#3).
template <typename T>
int run_block(const void* x, void* out, void* qkv, void* attn, void* a1,
              const void* ln1g, const void* ln1b, const void* wqkv,
              const void* bqkv, const void* wproj, const void* bproj,
              const void* ln2g, const void* ln2b, const void* w1,
              const void* b1, const void* w2, const void* b2, int B, int N,
              int D, int heads, int H, void* stream_ptr) {
  if (!block_shape_ok(B, N, D, heads, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int R = Tile<T>::kRows;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = B * N;
  const int row_tiles = (M + R - 1) / R;
  cudaError_t e = launch_qkv_attention<T>(
      static_cast<const T*>(x), static_cast<const float*>(ln1g),
      static_cast<const float*>(ln1b), static_cast<const T*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<T*>(qkv),
      static_cast<T*>(attn), nullptr, B, N, D, heads, stream);
  if (e != cudaSuccess) return e;

  const size_t sm3 = proj_mlp_layout<T>(D, H).total;
  const auto proj_mlp = a1 != nullptr ? proj_mlp_kernel<T, true>
                                      : proj_mlp_kernel<T, false>;
  if ((e = set_smem(proj_mlp, sm3)) != cudaSuccess) return e;
  proj_mlp<<<row_tiles, kThreads, sm3, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(attn),
      static_cast<const T*>(wproj), static_cast<const float*>(bproj),
      static_cast<const float*>(ln2g), static_cast<const float*>(ln2b),
      static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<T*>(out), static_cast<T*>(a1), M, D, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define VIT_BLOCK_ARGS                                                      \
  const void *x, void *out, void *qkv, void *attn, const void *ln1g,        \
      const void *ln1b, const void *wqkv, const void *bqkv,                 \
      const void *wproj, const void *bproj, const void *ln2g,               \
      const void *ln2b, const void *w1, const void *b1, const void *w2,     \
      const void *b2, int B, int N, int D, int heads, int H, void *stream
#define VIT_BLOCK_PARAMS                                                    \
  ln1g, ln1b, wqkv, bqkv, wproj, bproj, ln2g, ln2b, w1, b1, w2, b2, B, N, D, \
      heads, H, stream

extern "C" int vit_block_fwd_bf16(VIT_BLOCK_ARGS) {
  return run_block<bf16>(x, out, qkv, attn, nullptr, VIT_BLOCK_PARAMS);
}

extern "C" int vit_block_fwd_f32(VIT_BLOCK_ARGS) {
  return run_block<float>(x, out, qkv, attn, nullptr, VIT_BLOCK_PARAMS);
}

// #3: as vit_block_fwd_*, plus the fc1 pre-activation a1 (B*N, H) in T.
extern "C" int vit_block_res_fwd_bf16(void* a1, VIT_BLOCK_ARGS) {
  return run_block<bf16>(x, out, qkv, attn, a1, VIT_BLOCK_PARAMS);
}

extern "C" int vit_block_res_fwd_f32(void* a1, VIT_BLOCK_ARGS) {
  return run_block<float>(x, out, qkv, attn, a1, VIT_BLOCK_PARAMS);
}

extern "C" const char* vit_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
