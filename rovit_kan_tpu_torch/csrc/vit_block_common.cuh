// Pieces shared by the ViT-block kernels (vit_block_fwd.cu, and the
// backwards vit_block_bwd.cu and vit_block_bwd_f32.cu): the first two
// stages of the forward (LN1 + qkv, attention), which the recompute
// backward runs again to recompute what the forward does not keep. The
// route is chosen by the compute type:
//   bf16: block_mma.cuh's ln_qkv (mma.sync from registers, a cp.async ring
//         of Wqkv tiles), then attention_mma.cuh's forward with the block's
//         scale folded into its exp2 FMA and the output rounded to bf16;
//   fp32: block_tf32.cuh's ln_qkv (3xTF32 mma.sync, a cp.async ring of
//         Wqkv pieces), then attention_tf32.cuh's forward with the block's
//         scale folded into its exp2 FMA, the output stored once in fp32.
//
// Rounding points are those of rovit_kan_tpu/ops/block_kernel.py: fp32
// statistics and accumulation, one rounding to the compute type T where the
// TPU kernel casts. Everything sits in an anonymous namespace, so each source
// that includes this header gets its own copy.

#pragma once

#include "attention_common.cuh"
#include "attention_mma.cuh"
#include "attention_tf32.cuh"
#include "block_mma.cuh"
#include "block_tf32.cuh"

namespace {

// ---- attention views over the block's buffers ------------------------------

// Head `which` (0 q, 1 k, 2 v) of a (B, N, 3D) qkv buffer, or of a (B, N, D)
// buffer when which < 0.
template <typename E>
HeadView<E> block_heads(E* base, int N, int D, int hd, int which) {
  const long long width = which < 0 ? D : 3LL * D;
  return {base + (which < 0 ? 0 : which * D), N * width, hd, width};
}

// The first two forward stages, as both the forward and the backward launch
// them: x -> qkv (and the LN1 output where y_out is given) -> attn. A width
// the route does not take returns cudaErrorInvalidValue, unlaunched.
template <typename T>
cudaError_t launch_qkv_attention(const T* x, const float* ln1g,
                                 const float* ln1b, const T* wqkv,
                                 const float* bqkv, T* qkv, T* attn,
                                 T* y_out, int B, int N, int D, int heads,
                                 cudaStream_t stream) {
  const int M = B * N;
  const int hd = D / heads;
  const float scale =
      static_cast<float>(std::pow(static_cast<double>(hd), -0.5));
  const T* cq = qkv;
  cudaError_t e;
  if constexpr (std::is_same<T, bf16>::value) {
    e = launch_ln_qkv_mma(x, ln1g, ln1b, wqkv, bqkv, qkv, y_out, M, D,
                          stream);
    if (e != cudaSuccess) return e;
    return launch_attention_fwd_mma<bf16, true>(
        block_heads(cq, N, D, hd, 0), block_heads(cq, N, D, hd, 1),
        block_heads(cq, N, D, hd, 2), block_heads(attn, N, D, hd, -1), B,
        heads, N, hd, scale, stream);
  } else {
    e = launch_ln_qkv_tf32(x, ln1g, ln1b, wqkv, bqkv, qkv, y_out, M, D,
                           stream);
    if (e != cudaSuccess) return e;
    return launch_attention_fwd_tf32<float, true>(
        block_heads(cq, N, D, hd, 0), block_heads(cq, N, D, hd, 1),
        block_heads(cq, N, D, hd, 2), block_heads(attn, N, D, hd, -1), B,
        heads, N, hd, scale, stream);
  }
}

// Shapes every block kernel takes: D a multiple of 64, a head width that
// is a multiple of 16 up to 128, hidden a multiple of D (and so of 64).
// Each route narrows D further (block_mma.cuh, block_tf32.cuh, the
// backwards' width checks) and refuses the rest unlaunched.
inline bool block_shape_ok(int B, int N, int D, int heads, int H) {
  return B >= 1 && N >= 1 && heads >= 1 && D % 64 == 0 && D % heads == 0 &&
         attention_head_ok(D / heads) && H % 64 == 0 && H % D == 0;
}

}  // namespace
