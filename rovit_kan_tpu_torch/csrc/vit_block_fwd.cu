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
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 495 TFLOP/s TF32,
// 67 TFLOP/s fp32 FMA, 3.35 TB/s HBM): at the serving shape B=64, N=197,
// D=192, 3 heads, hidden 768 (M = B*N = 12,608 rows), one call does
// 2*M*D*(3D + D + 2*4D) = 1.116e10 FLOP in the four products plus
// 4*B*N*N*D = 1.908e9 FLOP in attention, 1.307e10 FLOP in all: 13.2 us at
// the bf16 peak. It must move x in and out once (2 * 4.84 MB in bf16) plus
// 0.88 MB of bf16 weights, about 10.6 MB: 3.2 us at the HBM rate. So it is
// compute-bound, by a factor of four. By stage, with qkv and the attention
// output through device memory between them: ln_qkv 2.79e9 FLOP (2.8 us)
// but x in and qkv out, 19.6 MB (5.8 us), so bytes bound it; attention
// 1.91e9 FLOP (1.9 us) for 19.4 MB (5.8 us), bytes again; proj_mlp 8.37e9
// FLOP (8.5 us) for 15.2 MB (4.5 us), operations. At the long shape (32,
// 577, 192): 2.45e10 FLOP, 24.8 us for the block; by stage 8.5 (bytes), 8.5
// (bytes) and 12.4 us (operations). In fp32 every product is three TF32
// products (3xTF32), so the bound is three times the FLOP at the TF32
// peak: 79.2 us at (64, 197) and 148.5 us at (32, 577) (on the FMA units
// 195 and 366 us); by stage at (64, 197) ln_qkv 16.9 us, attention 11.6
// (its 38.7 MB of fp32 bytes take 11.6 too) and proj_mlp 50.7 us.
//
// Three launches per block call (seven at the bf16 wide widths). The route
// is chosen by the compute type.
//
// bf16 (D of 64, 128 or 192 on the stages below; past 192, every multiple
// of 64 up to 768 (the small and base presets' 384 and 768 among them) on
// block_wide_mma.cuh's seven launches, whose note says why and what bounds
// them; any other width returns cudaErrorInvalidValue before any launch):
//   1. ln_qkv:    block_mma.cuh, 96 rows per CTA of 6 warps: LN1 into mma
//                 A fragments in registers, then qkv over 64-column tiles
//                 of Wqkv that a two-stage cp.async ring brings in under
//                 the products (mma.sync m16n8k16, accumulators and
//                 epilogue in registers, rows in and out as 16-byte
//                 vectors through a per-warp staging tile); 87.5 KB of
//                 shared memory, two CTAs an SM;
//   2. attention: attention_mma.cuh's forward (#5's kernel) over the qkv
//                 buffer's strided head views, with the block's scale
//                 hd^-1/2 folded into its row max and exp2 FMA and the
//                 output rounded once to bf16; 64 queries per CTA of 4
//                 warps, S, P and O in registers, K and V through a
//                 two-stage cp.async ring, 36 KB, six CTAs an SM;
//   3. proj_mlp:  block_mma.cuh, 48 rows per CTA: proj and the fp32
//                 residual, LN2 from registers, then fc1 + GELU and fc2
//                 chunk by chunk of the hidden dimension (each 64-wide h
//                 chunk is repacked in registers as fc2's A fragments, so
//                 no hidden tile exists), the weights through the same kind
//                 of ring; 91.5 KB, two CTAs an SM.
//   Wave arithmetic on 132 SMs: at (64, 197) ln_qkv has
//   ceil(12,608 / 96) = 132 CTAs, one an SM; proj_mlp ceil(12,608 / 48) =
//   263, one wave of its 264 slots (the 64-row tile of the first design
//   gave 197 CTAs of one per SM, two waves, the second 65/132 full);
//   attention 4 x 3 x 64 = 768 CTAs in 792 slots. At (32, 577): ln_qkv 193
//   CTAs, one wave; proj_mlp 385, 1.46 waves (three CTAs on 121 SMs, two on
//   11; the first design's 289 CTAs of one per SM ran in three waves, the
//   last 25/132 full); attention 10 x 3 x 32 = 960 CTAs, 1.2 waves.
//   qkv and the attention output go through device memory (2 x 7.3 MB at
//   B=64, mostly served from the 50 MB L2), as #3 returns them anyway.
//
// fp32 (D of 64 to 320 in steps of 64; a wider D returns
// cudaErrorInvalidValue before any launch): the same three launches, every
// product in 3xTF32 mma.sync.m16n8k8 (tf32_common.cuh):
//   1. ln_qkv:    block_tf32.cuh, 48 rows per CTA of 3 warps: the rows
//                 stay as x in shared memory and LN1 is applied where each
//                 A fragment is loaded; Wqkv streams through a three-stage
//                 cp.async ring of 64 x 32 pieces; accumulators and bias in
//                 registers; 68.3 KB;
//   2. attention: attention_tf32.cuh's forward (#5's kernel) over the qkv
//                 buffer's strided head views, with the block's scale
//                 hd^-1/2 folded into its row max and exp2 FMA, O stored
//                 once in fp32 into the (B, N, D) buffer;
//   3. proj_mlp:  block_tf32.cuh, 48 rows per CTA: proj over all D columns
//                 in registers and the fp32 residual x1 over the warp's
//                 rows in shared memory, LN2 applied at each A fragment
//                 load, then fc1 + GELU and fc2 chunk by chunk of 64 hidden
//                 columns (fc1's C fragments are fc2's A fragments, in the
//                 permuted k order of tf32_c_to_a, so no hidden tile
//                 exists); the same ring; 68.3 KB, two CTAs an SM (its
//                 254 registers a thread allow no third).
//   Wave arithmetic on 132 SMs: at (64, 197) ln_qkv and proj_mlp have
//   ceil(12,608 / 48) = 263 CTAs, one wave of proj_mlp's 264 slots (ln_qkv,
//   under 100 registers, fits three CTAs an SM), attention 4 x 3 x 64 = 768
//   CTAs; at (32, 577) 385 CTAs, 1.46 waves of proj_mlp's slots, and
//   attention 10 x 3 x 32.
//
// The first two stages live in vit_block_common.cuh, which the backward
// (vit_block_bwd.cu) shares to recompute qkv and the attention output.
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
// bytes bound it in bf16 by a hair; in fp32 operations do (0.0792 ms as
// 3xTF32, 0.195 on the FMA units).
//
// Interface: plain C, loaded with ctypes. Each entry returns the first
// CUDA error (0 = success), checked with cudaGetLastError after every
// launch, so a launch refused for its resources is reported and never
// silently skipped. Nothing is allocated here and nothing synchronises: the
// caller gives the wide stages' scratch (vit_block_fwd_workspace_bf16
// bytes).

#include "vit_block_common.cuh"

namespace {

// qkv, attn: the first two stages' outputs (scratch for #1, returned by
// #3); a1: the fc1 pre-activation, stored only when given (#3); work: the
// wide bf16 stages' scratch (workspace_bytes), unread elsewhere.
template <typename T>
int run_block(const void* x, void* out, void* qkv, void* attn, void* a1,
              void* work,
              const void* ln1g, const void* ln1b, const void* wqkv,
              const void* bqkv, const void* wproj, const void* bproj,
              const void* ln2g, const void* ln2b, const void* w1,
              const void* b1, const void* w2, const void* b2, int B, int N,
              int D, int heads, int H, void* stream_ptr) {
  if (!block_shape_ok(B, N, D, heads, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = B * N;
  if constexpr (std::is_same<T, bf16>::value) {
    if (wide_width(D)) {
      const WideFwdWork w =
          carve_wide_fwd(static_cast<char*>(work), M, D, H);
      cudaError_t e = launch_qkv_attention<T>(
          static_cast<const T*>(x), static_cast<const float*>(ln1g),
          static_cast<const float*>(ln1b), static_cast<const T*>(wqkv),
          static_cast<const float*>(bqkv), static_cast<T*>(qkv),
          static_cast<T*>(attn), w.y, B, N, D, heads, stream);
      if (e != cudaSuccess) return e;
      return static_cast<int>(launch_proj_mlp_wide(
          static_cast<const T*>(x), static_cast<const T*>(attn),
          static_cast<const T*>(wproj), static_cast<const float*>(bproj),
          static_cast<const float*>(ln2g), static_cast<const float*>(ln2b),
          static_cast<const T*>(w1), static_cast<const float*>(b1),
          static_cast<const T*>(w2), static_cast<const float*>(b2),
          static_cast<T*>(out), static_cast<T*>(a1), w.x1, w.z, w.h, M, D,
          H, stream));
    }
  }
  cudaError_t e = launch_qkv_attention<T>(
      static_cast<const T*>(x), static_cast<const float*>(ln1g),
      static_cast<const float*>(ln1b), static_cast<const T*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<T*>(qkv),
      static_cast<T*>(attn), nullptr, B, N, D, heads, stream);
  if (e != cudaSuccess) return e;

  if constexpr (std::is_same<T, bf16>::value) {
    return static_cast<int>(launch_proj_mlp_mma(
        static_cast<const T*>(x), static_cast<const T*>(attn),
        static_cast<const T*>(wproj), static_cast<const float*>(bproj),
        static_cast<const float*>(ln2g), static_cast<const float*>(ln2b),
        static_cast<const T*>(w1), static_cast<const float*>(b1),
        static_cast<const T*>(w2), static_cast<const float*>(b2),
        static_cast<T*>(out), static_cast<T*>(a1), M, D, H, stream));
  } else {
    return static_cast<int>(launch_proj_mlp_tf32(
        static_cast<const T*>(x), static_cast<const T*>(attn),
        static_cast<const T*>(wproj), static_cast<const float*>(bproj),
        static_cast<const float*>(ln2g), static_cast<const float*>(ln2b),
        static_cast<const T*>(w1), static_cast<const float*>(b1),
        static_cast<const T*>(w2), static_cast<const float*>(b2),
        static_cast<T*>(out), static_cast<T*>(a1), M, D, H, stream));
  }
}

}  // namespace

#define VIT_BLOCK_ARGS                                                      \
  const void *x, void *out, void *qkv, void *attn, void *work,              \
      const void *ln1g,                                                     \
      const void *ln1b, const void *wqkv, const void *bqkv,                 \
      const void *wproj, const void *bproj, const void *ln2g,               \
      const void *ln2b, const void *w1, const void *b1, const void *w2,     \
      const void *b2, int B, int N, int D, int heads, int H, void *stream
#define VIT_BLOCK_PARAMS                                                    \
  ln1g, ln1b, wqkv, bqkv, wproj, bproj, ln2g, ln2b, w1, b1, w2, b2, B, N, D, \
      heads, H, stream

extern "C" int vit_block_fwd_bf16(VIT_BLOCK_ARGS) {
  return run_block<bf16>(x, out, qkv, attn, nullptr, work, VIT_BLOCK_PARAMS);
}

extern "C" int vit_block_fwd_f32(VIT_BLOCK_ARGS) {
  return run_block<float>(x, out, qkv, attn, nullptr, work,
                          VIT_BLOCK_PARAMS);
}

// #3: as vit_block_fwd_*, plus the fc1 pre-activation a1 (B*N, H) in T.
extern "C" int vit_block_res_fwd_bf16(void* a1, VIT_BLOCK_ARGS) {
  return run_block<bf16>(x, out, qkv, attn, a1, work, VIT_BLOCK_PARAMS);
}

extern "C" int vit_block_res_fwd_f32(void* a1, VIT_BLOCK_ARGS) {
  return run_block<float>(x, out, qkv, attn, a1, work, VIT_BLOCK_PARAMS);
}

// Bytes of the scratch `work` that #1 and #3 take in bf16: y, x1, z and h
// at the wide widths, none at the others (nor in fp32).
extern "C" size_t vit_block_fwd_workspace_bf16(int B, int N, int D,
                                               int heads, int H) {
  if (!block_shape_ok(B, N, D, heads, H) || !wide_width(D)) return 0;
  return carve_wide_fwd(nullptr, B * N, D, H).total;
}

extern "C" const char* vit_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
