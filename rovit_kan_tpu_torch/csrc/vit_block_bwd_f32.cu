// Backward of one pre-LN ViT block on Hopper (sm_90a): the fp32 route of #2
// and #4 (vit_block_bwd.cu has the bf16 route and says what the two
// replace: rovit_kan_tpu/ops/block_kernel.py::_vit_block_bwd_kernel and
// ::_vit_block_bwd_res_kernel). Reached when a caller forces the fused
// block in fp32 (use_pallas_block with mixed precision off); "auto" sends
// fp32 to plain PyTorch.
//
// What bounds it on an H100 SXM: fp32 has no tensor-core path here, so the
// products run on the FMA pipes. At B=64, N=197, D=192, 3 heads, hidden 768
// #2 needs 3.547e10 FLOP (the forward recomputed without fc2, then two
// products per forward product), 0.529 ms at the 67 TFLOP/s fp32 peak; #4
// 2.80e10, 0.418 ms. By stage (M = B*N = 12,608): mlp_bwd 13.0 GFLOP
// (0.195 ms), qkv_bwd 2.79 (0.042), the four weight grads 11.2 (0.167),
// the attention backward 6.7 needed (0.100). Their bytes (x, g, dx, the
// weights and grads, 20-60 MB) take under 0.02 ms at 3.35 TB/s, so every
// stage is compute-bound, and what keeps a stage from the FMA peak is how
// many FMAs each shared-memory load feeds and how many threads have work.
//
// Stages (eight launches for #2, six for #4, as the bf16 route):
//   1-2. #2 only: ln_qkv_tf32_kernel and attn_fwd_tf32_kernel through
//        vit_block_common.cuh (#1's fp32 stages, 3xTF32 mma.sync), ln_qkv
//        also storing the LN1 output for the qkv weight grad;
//   3. mlp_bwd_fma_kernel (block_bwd_fma.cuh, 64 rows a CTA);
//   4-5. attn_bwd_q_fma_kernel, attn_bwd_kv_fma_kernel (attention_fma.cuh,
//        64-row query and key tiles, S, P and dS in registers);
//   6. qkv_bwd_fma_kernel (block_bwd_fma.cuh, 64 rows a CTA);
//   7. wgrad_fma_kernel (block_bwd_fma.cuh, 64 x D tiles over about two
//      CTAs an SM of row splits);
//   8. reduce_kernel<false> (block_bwd_common.cuh): every partial in order.
// In fp32 g and dx1 are their own rounded copies, so the weight grads read
// them in place. No atomics: a repeated call gives the same bits.
//
// Widths: D = 64 G with G of 1 to 5 (every width whose first-design stages
// fit in shared memory), hidden a multiple of D, head widths 16-128 in
// steps of 16, any B, N and heads; any other D returns
// cudaErrorInvalidValue before any launch.
//
// Interface: plain C, loaded with ctypes, as vit_block_bwd.cu. The caller
// allocates the scratch (the *_workspace_f32 bytes); every launch is
// followed by cudaGetLastError and the first error is returned.

#include "vit_block_common.cuh"
#include "attention_fma.cuh"
#include "block_bwd_fma.cuh"

namespace {

// 64-row tiles of mlp_bwd, qkv_bwd and the attention backward, and row
// splits that give the weight grads about FmaWgPlan::kCtas CTAs.
Sizes sizes_of(int B, int N, int D, int heads, int H) {
  Sizes s = base_sizes(B, N, D, heads, H);
  s.mlp_tiles = (s.M + 63) / 64;
  s.qkv_tiles = s.mlp_tiles;
  s.attn_tiles = (N + 63) / 64;
  const int tiles = (4 * D * D + 2 * H * D) / (64 * D);
  set_splits(s, FmaWgPlan<1>::kCtas / tiles, FmaWgPlan<1>::kDepth);
  return s;
}

size_t workspace_bytes(int B, int N, int D, int heads, int H, bool residual) {
  if (!block_shape_ok(B, N, D, heads, H) || !bwd_fma_width_ok(D)) return 0;
  return carve<float>(nullptr, sizes_of(B, N, D, heads, H), residual).total;
}

// qkv_in, attn_in, a1_in: the residuals #3 saved (#4), or all null to
// recompute them (#2).
int run_bwd(const void* x_, const void* g_, const void* qkv_in,
            const void* attn_in, const void* a1_in, void* dx_, float* grads,
            void* work_, const void* ln1g_, const void* ln1b_,
            const void* wqkv_, const void* bqkv_, const void* wproj_,
            const void* bproj_, const void* ln2g_, const void* ln2b_,
            const void* w1_, const void* b1_, const void* w2_,
            const void* b2_, int B, int N, int D, int heads, int H,
            void* stream_ptr) {
  (void)b2_;   // the forward's last bias has no part in any grad
  if (!block_shape_ok(B, N, D, heads, H) || !bwd_fma_width_ok(D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Sizes s = sizes_of(B, N, D, heads, H);
  const bool residual = qkv_in != nullptr;
  const Work<float> w = carve<float>(static_cast<char*>(work_), s, residual);
  const float* qkv = residual ? static_cast<const float*>(qkv_in) : w.qkv;
  const float* attn = residual ? static_cast<const float*>(attn_in) : w.attn;
  const float* x = static_cast<const float*>(x_);
  const float* g = static_cast<const float*>(g_);
  const float* ln1g = static_cast<const float*>(ln1g_);
  const float* ln1b = static_cast<const float*>(ln1b_);
  const float* wqkv = static_cast<const float*>(wqkv_);
  const float* wproj = static_cast<const float*>(wproj_);
  const float scale =
      static_cast<float>(std::pow(static_cast<double>(s.hd), -0.5));
  cudaError_t e;

  // 1-2. the forward's first two stages, keeping the LN1 output (#2 only).
  if (!residual) {
    e = launch_qkv_attention<float>(x, ln1g, ln1b, wqkv,
                                    static_cast<const float*>(bqkv_), w.qkv,
                                    w.attn, w.y, B, N, D, heads, stream);
    if (e != cudaSuccess) return e;
  }

  // 3. MLP, LN2 and proj.
  e = launch_mlp_bwd_fma(
      x, attn, g, wproj, static_cast<const float*>(bproj_),
      static_cast<const float*>(ln2g_), static_cast<const float*>(ln2b_),
      static_cast<const float*>(w1_), static_cast<const float*>(b1_),
      static_cast<const float*>(w2_), static_cast<const float*>(a1_in), w.z,
      w.h1, w.da1, w.dx1, w.go, w.part_mlp, s.M, D, H, stream);
  if (e != cudaSuccess) return e;

  // 4-5. attention, query side then key side, with the block's scale (O,
  // the attention output, gives each query's rowsum(P dP) = dO . O).
  const int hd = s.hd;
  const float* cgo = w.go;
  e = launch_attention_bwd_block_fma(
      block_heads(qkv, N, D, hd, 0), block_heads(qkv, N, D, hd, 1),
      block_heads(qkv, N, D, hd, 2), block_heads(cgo, N, D, hd, -1),
      block_heads(attn, N, D, hd, -1), block_heads(w.dqkv, N, D, hd, 0),
      block_heads(w.dqkv, N, D, hd, 1), block_heads(w.dqkv, N, D, hd, 2),
      w.stats, w.part_attn, B, heads, N, hd, scale, stream);
  if (e != cudaSuccess) return e;

  // 6. qkv, LN1 and dx (and, for #4, the LN1 output).
  e = launch_qkv_bwd_fma(x, w.dqkv, w.dx1, ln1g, ln1b, wqkv,
                         static_cast<float*>(dx_), residual ? w.y : nullptr,
                         w.part_qkv, s.M, D, stream);
  if (e != cudaSuccess) return e;

  // 7. weight grads, split over rows, 64 x D tiles.
  Partials p;
  WgJobs jobs;
  const int tiles = wgrad_jobs(jobs, s, {w.dqkv, w.y, w.dx1, attn, w.da1,
                                         w.z, g, w.h1}, w.part_w, p);
  e = launch_wgrad_fma(jobs, tiles, s.splits, D, stream);
  if (e != cudaSuccess) return e;

  // 8. every partial, in order.
  row_partials(p, w, s);
  return launch_reduce<false>(p, grads_of(grads, D, H), D, H, stream);
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

extern "C" int vit_block_bwd_f32(VIT_BLOCK_BWD_ARGS) {
  return run_bwd(x, g, nullptr, nullptr, nullptr, VIT_BLOCK_BWD_PASS);
}

extern "C" size_t vit_block_bwd_workspace_f32(int B, int N, int D,
                                              int heads, int H) {
  return workspace_bytes(B, N, D, heads, H, false);
}

// #4: qkv (B*N, 3D), attn (B*N, D) and a1 (B*N, H) in fp32, as #3 stored
// them.
extern "C" int vit_block_bwd_res_f32(const void* qkv, const void* attn,
                                     const void* a1, VIT_BLOCK_BWD_ARGS) {
  return run_bwd(x, g, qkv, attn, a1, VIT_BLOCK_BWD_PASS);
}

extern "C" size_t vit_block_bwd_res_workspace_f32(int B, int N, int D,
                                                  int heads, int H) {
  return workspace_bytes(B, N, D, heads, H, true);
}

extern "C" const char* vit_block_bwd_f32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
