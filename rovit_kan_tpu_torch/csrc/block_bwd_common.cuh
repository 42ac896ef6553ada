// Pieces both routes of the ViT-block backwards #2 and #4 share
// (vit_block_bwd.cu: bf16, vit_block_bwd_f32.cu: fp32): the weight-grad
// jobs, the 12 grads' places in the flat output, and the last launch, which
// adds every per-CTA fp32 partial in a fixed order (no atomics, so a
// repeated call gives the same bits). Everything sits in an anonymous
// namespace, so each source that includes this header gets its own copy.

#pragma once

#include "tile_common.cuh"

namespace {

// gelu_erf(a) and its derivative Phi(a) + a phi(a) from one erff.
__device__ __forceinline__ float2 gelu_and_grad(float a) {
  const float e = erff(a * 0.70710678118654752f);
  return make_float2(0.5f * a * (1.0f + e),
                     0.5f * (1.0f + e) +
                         a * 0.3989422804014327f * expf(-0.5f * a * a));
}

// One weight grad dW = A^T . B over the rows, as fp32 partials per row
// split.
struct WgJob {
  const void* a;      // (M, n_out), T
  const void* b;      // (M, n_in), T
  float* part;        // [splits][n_out][n_in]
  int n_out, n_in, tile_begin;
};
struct WgJobs {
  WgJob job[4];
  int count, M, rows_per_split;
};

// The four weight grads' operands (T, (M, width) each): dWqkv = dqkv^T . y,
// dWproj = dx1^T . attn, dW1 = da1^T . z, dW2 = g^T . h1 (dx1 and g rounded
// to T: dx1b and gb).
struct WgOperands {
  const void *dqkv, *y, *dx1b, *attn, *da1, *z, *gb, *h1;
};

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// A backward's shape, and its stages' tile counts and row splits (set by
// each route's sizes_of).
// wide: the bf16 route's wide stages (block_wide_bwd_mma.cuh), which take
// an fp32 (M, D) scratch for dz and dy. wg_cols: the columns of a weight
// grad's output tile (64 rows by wg_cols, wg_cols dividing D): D itself
// unless a route's sizes_of picks fewer.
struct Sizes {
  int B, N, D, heads, H, M, hd, mlp_tiles, qkv_tiles, attn_tiles, splits,
      rows_per_split, wg_cols;
  bool wide;
};
inline Sizes base_sizes(int B, int N, int D, int heads, int H) {
  Sizes s = {};
  s.B = B; s.N = N; s.D = D; s.heads = heads; s.H = H;
  s.M = B * N;
  s.hd = D / heads;
  s.wg_cols = D;
  return s;
}
// About `splits` row splits of the weight grads, each a multiple of `depth`
// rows (a ring stage), at least one and at most one stage each.
inline void set_splits(Sizes& s, int splits, int depth) {
  const int most = (s.M + depth - 1) / depth;
  splits = splits > most ? most : splits;
  splits = splits < 1 ? 1 : splits;
  s.rows_per_split = round_up((s.M + splits - 1) / splits, depth);
  s.splits = (s.M + s.rows_per_split - 1) / s.rows_per_split;
}

// The scratch: what the stages pass on, and the partials.
template <typename T>
struct Work {
  T *qkv, *attn, *y, *z, *h1, *gb, *da1, *dx1b, *go, *dqkv;
  float *dx1, *dz, *stats, *part_mlp, *part_qkv, *part_attn, *part_w;
  size_t total;
};

// Carves the scratch out of `base` (or only sizes it when base is null).
// The residual backward (#4) reads qkv and attn from the caller and carves
// neither; in fp32 the rounded copies gb and dx1b are g and dx1 themselves
// and are not carved (null).
template <typename T>
Work<T> carve(char* base, const Sizes& s, bool residual) {
  constexpr bool kCopies = !std::is_same<T, float>::value;
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
  w.gb = kCopies ? reinterpret_cast<T*>(take(sizeof(T) * M * D)) : nullptr;
  w.da1 = reinterpret_cast<T*>(take(sizeof(T) * M * H));
  w.dx1b = kCopies ? reinterpret_cast<T*>(take(sizeof(T) * M * D)) : nullptr;
  w.go = reinterpret_cast<T*>(take(sizeof(T) * M * D));
  w.dqkv = reinterpret_cast<T*>(take(sizeof(T) * M * 3 * D));
  w.dx1 = reinterpret_cast<float*>(take(sizeof(float) * M * D));
  w.dz = s.wide ? reinterpret_cast<float*>(take(sizeof(float) * M * D))
                : nullptr;
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

// The 12 grads in the flat output, in the wrapper's PKEYS order.
struct Grads {
  float *ln1g, *ln1b, *wqkv, *bqkv, *wproj, *bproj, *ln2g, *ln2b, *w1, *b1,
      *w2, *b2;
};
inline Grads grads_of(float* flat, int D, int H) {
  const size_t DD = static_cast<size_t>(D), HH = static_cast<size_t>(H);
  Grads g;
  g.ln1g = flat;
  g.ln1b = g.ln1g + DD;
  g.wqkv = g.ln1b + DD;
  g.bqkv = g.wqkv + 3 * DD * DD;
  g.wproj = g.bqkv + 3 * DD;
  g.bproj = g.wproj + DD * DD;
  g.ln2g = g.bproj + DD;
  g.ln2b = g.ln2g + DD;
  g.w1 = g.ln2b + DD;
  g.b1 = g.w1 + HH * DD;
  g.w2 = g.b1 + HH;
  g.b2 = g.w2 + DD * HH;
  return g;
}

// ---- partial sums, in order ---------------------------------------------

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

// Where the partials are: per mlp_bwd tile [b2 (D) | b1 (H) | ln2 scale (D)
// | ln2 bias (D) | bproj (D)]; per qkv_bwd tile [ln1 scale (D) | ln1 bias
// (D)]; per (image, attention tile) [dq | dk | dv] column sums (3D); per
// row split the four weight grads, [splits][n_out][n_in] each.
struct Partials {
  const float *mlp, *qkv, *attn, *w_qkv, *w_proj, *w1, *w2;
  int mlp_tiles, qkv_tiles, attn_parts, splits;
};

// The four weight-grad jobs over 64 x wg_cols output tiles (wg_cols
// divides every n_in), their partials carved from part_w (recorded in p).
// Returns the tile count.
inline int wgrad_jobs(WgJobs& jobs, const Sizes& s, const WgOperands& o,
                      float* part_w, Partials& p) {
  const size_t D = s.D, H = s.H;
  float* pw_qkv = part_w;
  float* pw_proj = pw_qkv + s.splits * 3 * D * D;
  float* pw_w1 = pw_proj + s.splits * D * D;
  float* pw_w2 = pw_w1 + s.splits * H * D;
  p.w_qkv = pw_qkv;
  p.w_proj = pw_proj;
  p.w1 = pw_w1;
  p.w2 = pw_w2;
  const WgJob list[4] = {{o.dqkv, o.y, pw_qkv, 3 * s.D, s.D, 0},
                         {o.dx1b, o.attn, pw_proj, s.D, s.D, 0},
                         {o.da1, o.z, pw_w1, s.H, s.D, 0},
                         {o.gb, o.h1, pw_w2, s.D, s.H, 0}};
  jobs.count = 4;
  jobs.M = s.M;
  jobs.rows_per_split = s.rows_per_split;
  int tiles = 0;
  for (int i = 0; i < 4; ++i) {
    jobs.job[i] = list[i];
    jobs.job[i].tile_begin = tiles;
    tiles += (list[i].n_out / 64) * (list[i].n_in / s.wg_cols);
  }
  return tiles;
}

// The partials of the row stages and the attention backward (the weight
// grads' are set by wgrad_jobs).
template <typename T>
void row_partials(Partials& p, const Work<T>& w, const Sizes& s) {
  p.mlp = w.part_mlp;
  p.qkv = w.part_qkv;
  p.attn = w.part_attn;
  p.mlp_tiles = s.mlp_tiles;
  p.qkv_tiles = s.qkv_tiles;
  p.attn_parts = s.B * s.attn_tiles;
  p.splits = s.splits;
}

// 8. every partial, in order, into the 12 grads.
template <bool kWide>
cudaError_t launch_reduce(const Partials& p, const Grads& gr, int D, int H,
                          cudaStream_t stream) {
  const long long mlp_w = 4 * D + H;
  const RedSeg segs[12] = {
      {p.qkv, gr.ln1g, 2 * D, D, p.qkv_tiles, 0},
      {p.qkv + D, gr.ln1b, 2 * D, D, p.qkv_tiles, 0},
      {p.w_qkv, gr.wqkv, 3 * D * D, 3 * D * D, p.splits, 0},
      {p.attn, gr.bqkv, 3 * D, 3 * D, p.attn_parts, 0},
      {p.w_proj, gr.wproj, D * D, D * D, p.splits, 0},
      {p.mlp + 3 * D + H, gr.bproj, mlp_w, D, p.mlp_tiles, 0},
      {p.mlp + D + H, gr.ln2g, mlp_w, D, p.mlp_tiles, 0},
      {p.mlp + 2 * D + H, gr.ln2b, mlp_w, D, p.mlp_tiles, 0},
      {p.w1, gr.w1, H * D, H * D, p.splits, 0},
      {p.mlp + D, gr.b1, mlp_w, H, p.mlp_tiles, 0},
      {p.w2, gr.w2, D * H, D * H, p.splits, 0},
      {p.mlp, gr.b2, mlp_w, D, p.mlp_tiles, 0}};
  RedSegs red;
  red.count = 12;
  int blocks = 0;
  for (int i = 0; i < 12; ++i) {
    red.seg[i] = segs[i];
    red.seg[i].block_begin = blocks;
    const int threads = kWide && reduce_wide(segs[i]) ? 32 * segs[i].n
                                                      : segs[i].n;
    blocks += (threads + kThreads - 1) / kThreads;
  }
  reduce_kernel<kWide><<<blocks, kThreads, 0, stream>>>(red);
  return cudaGetLastError();
}

}  // namespace
