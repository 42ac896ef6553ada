// Backward of one pre-LN ViT block on Hopper (sm_90a): the bf16 route. The
// fp32 route is vit_block_bwd_f32.cu, the same eight launches with FMA
// stages; both share block_bwd_common.cuh (scratch, weight-grad jobs, the
// ordered reduce).
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
// same bits. Eight launches.
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
// allocates the scratch (vit_block_bwd_workspace_bf16 bytes); every launch is
// followed by cudaGetLastError and the first error is returned.

#include "vit_block_common.cuh"
#include "block_bwd_mma.cuh"

namespace {

// The mma.sync stages' row tiles and attention tiles, and row splits that
// give the weight grads about kWgCtas CTAs.
Sizes sizes_of(int B, int N, int D, int heads, int H) {
  Sizes s = base_sizes(B, N, D, heads, H);
  s.mlp_tiles = (s.M + 16 * kMlpBwdPairs - 1) / (16 * kMlpBwdPairs);
  s.qkv_tiles = (s.M + 16 * kQkvBwdWarps - 1) / (16 * kQkvBwdWarps);
  s.attn_tiles = (N + kMmaRows - 1) / kMmaRows;
  const int tiles = (4 * D * D + 2 * H * D) / (kWgTile * D);
  set_splits(s, (kWgCtas + tiles - 1) / tiles, kWgDepth);
  return s;
}

size_t workspace_bytes(int B, int N, int D, int heads, int H, bool residual) {
  if (!block_shape_ok(B, N, D, heads, H)) return 0;
  return carve<bf16>(nullptr, sizes_of(B, N, D, heads, H), residual).total;
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
  using T = bf16;
  (void)b2_;   // the forward's last bias has no part in any grad
  if (!block_shape_ok(B, N, D, heads, H) || !bwd_mma_width_ok(D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Sizes s = sizes_of(B, N, D, heads, H);
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
  e = launch_mlp_bwd_mma(x, attn, g, wproj, bproj, ln2g, ln2b, w1, b1, w2,
                         static_cast<const T*>(a1_in), w.z, w.h1, w.gb,
                         w.da1, w.dx1, w.dx1b, w.go, w.part_mlp, s.M, D, H,
                         stream);
  if (e != cudaSuccess) return e;

  // 4-5. attention, query side then key side: attention_mma.cuh's backward
  // with the block's scale.
  const int hd = s.hd;
  const T* cgo = w.go;
  e = launch_attention_bwd_block_mma<T>(
      block_heads(qkv, N, D, hd, 0), block_heads(qkv, N, D, hd, 1),
      block_heads(qkv, N, D, hd, 2), block_heads(cgo, N, D, hd, -1),
      block_heads(w.dqkv, N, D, hd, 0), block_heads(w.dqkv, N, D, hd, 1),
      block_heads(w.dqkv, N, D, hd, 2), w.stats, w.part_attn, B, heads, N,
      hd, scale, stream);
  if (e != cudaSuccess) return e;

  // 6. qkv, LN1 and dx (and, for #4, the LN1 output).
  e = launch_qkv_bwd_mma(x, w.dqkv, w.dx1, ln1g, ln1b, wqkv,
                         static_cast<T*>(dx_), residual ? w.y : nullptr,
                         w.part_qkv, s.M, D, stream);
  if (e != cudaSuccess) return e;

  // 7. weight grads, split over rows, 64 x D tiles.
  Partials p;
  WgJobs jobs;
  const int tiles = wgrad_jobs(jobs, s, {w.dqkv, w.y, w.dx1b, attn, w.da1,
                                         w.z, w.gb, w.h1}, w.part_w, p);
  e = launch_wgrad_mma(jobs, tiles, s.splits, D, stream);
  if (e != cudaSuccess) return e;

  // 8. every partial, in order.
  row_partials(p, w, s);
  return launch_reduce<true>(p, grads_of(grads, D, H), D, H, stream);
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
  return run_bwd(x, g, nullptr, nullptr, nullptr, VIT_BLOCK_BWD_PASS);
}

extern "C" size_t vit_block_bwd_workspace_bf16(int B, int N, int D,
                                               int heads, int H) {
  return workspace_bytes(B, N, D, heads, H, false);
}

// #4: qkv (B*N, 3D), attn (B*N, D) and a1 (B*N, H) in bf16, as #3 stored
// them.
extern "C" int vit_block_bwd_res_bf16(const void* qkv, const void* attn,
                                      const void* a1, VIT_BLOCK_BWD_ARGS) {
  return run_bwd(x, g, qkv, attn, a1, VIT_BLOCK_BWD_PASS);
}

extern "C" size_t vit_block_bwd_res_workspace_bf16(int B, int N, int D,
                                                   int heads, int H) {
  return workspace_bytes(B, N, D, heads, H, true);
}

extern "C" const char* vit_block_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
