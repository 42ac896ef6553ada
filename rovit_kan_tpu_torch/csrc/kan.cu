// One KAN layer on Hopper (sm_90a), fp32 throughout: forward (#8) and
// backward (#9). The whole head's kernels (#10/#11) are kan_module.cu; the
// basis recursion and the shape limits both use are kan_common.cuh.
//
// Replaces rovit_kan_tpu/ops/kan_kernel.py::_kan_kernel (#8) and
// _kan_layer_bwd_kernel (#9). One layer computes
//   a[b][o] = bias[o] + sum_i (x[b][i] W[o][i]
//                              + sum_k basis_k(tanh x[b][i]) S[i][o][k])
// with the cubic B-spline basis of kan_common.cuh. Layouts are the port's:
// S (in, out, K), W (out, in) as nn.Linear keeps it, bias (out).
//
// The TPU kernels run their products at Precision.HIGHEST; Hopper's tensor
// cores have no IEEE fp32 mode, so every product here is an fp32 FMA on the
// CUDA cores.
//
// What bounds it on an H100 SXM: the layer 192 -> 64 with 7 bases at B = 64
// is 1.26e7 FLOP forward (0.19 us at 67 TFLOP/s) and twice that backward,
// on ~0.4 MB of weights (0.12 us at 3.35 TB/s): bound by operations, and all
// of it far below a launch's few microseconds. So these kernels are
// latency-bound: the design keeps each launch short and makes no more
// launches than the function needs.
//
// Design:
// - A row-tile CTA owns kRows batch rows; the layer's 393 KB of weights do
//   not fit in 227 KB of shared memory, so they are staged chunk by chunk of
//   inputs from L2 (every CTA reads the same ones), with cp.async into two
//   buffers: chunk c + 1 is in flight while chunk c is used.
// - Forward: the tile's features (the bases of tanh x and x itself) go to
//   shared memory up front; thread (o, s) sums output column o for the
//   tile's rows over the chunk's inputs i = s mod (256 / out), and the
//   splits s are added in a fixed order at the end.
// - Backward (dx): thread (i, k) forms q[r][i][k] = sum_o g[r][o] M[o][i][k]
//   (M is S and, at k = K, W), then thread (r, i) combines q with the basis
//   derivatives of ops/spline.py::bspline_basis_and_deriv_list and
//   (1 - t^2).
// - Weight gradients: the TPU kernel adds them over a grid that runs in
//   order; CTAs here run in parallel, so each weight element belongs to one
//   thread, which loops over the whole batch in order. No atomics: a
//   repeated call gives the same bits. #9 does its rows and its weight
//   gradients in one launch (two kinds of CTA).
//
// Interface: plain C, loaded with ctypes; each function returns the first
// CUDA error of its launches (0 = success), cudaErrorInvalidValue for a
// shape the kernels do not take.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <cstddef>

#include "kan_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;            // batch rows of a row-tile CTA
constexpr int kChunk = 64;          // most inputs per staged weight chunk
constexpr int kSlab = 16384;        // floats of one staged weight buffer
constexpr int kAcc = 12;            // weight-gradient sums per thread
constexpr int kBatchChunk = 16;     // batch rows per weight-gradient step
// Basis features of the tile's rows (kRows x up to 256 inputs x 11), or the
// backward's transposed gradient and q.
constexpr int kFeat = kRows * 256 * (kMaxBasis + 1);
// Shared scratch of a row-tile CTA: the features and two weight buffers
// (chunk c + 1 is copied while chunk c is used).
constexpr int kScratch = kFeat + 2 * kSlab;

// n floats rounded up to 16 bytes, so that every shared array starts
// aligned.
__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

struct Kan {
  int n_layers;
  int nb;                           // bases per input
  int B;
  int dims[kMaxLayers + 1];
  float knots[kMaxKnots];           // nb + 4 used
  const float* S[kMaxLayers];       // (in, out, nb)
  const float* W[kMaxLayers];       // (out, in)
  const float* bias[kMaxLayers];    // (out)
};

struct Grads {
  float* S[kMaxLayers];
  float* W[kMaxLayers];
  float* bias[kMaxLayers];
};

// Row stride of a staged S chunk: the out * nb floats of one input, padded
// so that one input's rows start (nb + 1) banks after the previous one's.
__device__ __forceinline__ int slab_stride(int dout, int nb) {
  const int dn = dout * nb;
  return dn + ((((nb + 1) - dn) % 32) + 32) % 32;
}

// acc[r] += v[r] * w for the tile's kRows rows, v in shared memory (16-byte
// aligned for kRows % 4 == 0), loaded as wide as kRows allows.
__device__ __forceinline__ void fma_rows(const float* v, float w,
                                         float (&acc)[kRows]) {
  if constexpr (kRows % 4 == 0) {
#pragma unroll
    for (int r = 0; r < kRows; r += 4) {
      const float4 x = *reinterpret_cast<const float4*>(v + r);
      acc[r] = fmaf(x.x, w, acc[r]);
      acc[r + 1] = fmaf(x.y, w, acc[r + 1]);
      acc[r + 2] = fmaf(x.z, w, acc[r + 2]);
      acc[r + 3] = fmaf(x.w, w, acc[r + 3]);
    }
  } else if constexpr (kRows % 2 == 0) {
#pragma unroll
    for (int r = 0; r < kRows; r += 2) {
      const float2 x = *reinterpret_cast<const float2*>(v + r);
      acc[r] = fmaf(x.x, w, acc[r]);
      acc[r + 1] = fmaf(x.y, w, acc[r + 1]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = fmaf(v[r], w, acc[r]);
  }
}

// Starts the asynchronous copy (cp.async) of a chunk of inputs' weights
// into shared memory: S[i0 .. i0 + icn) (contiguous in global memory) into
// the slab rows, 16 bytes a copy where aligned, and W[:, i0 .. i0 + icn)
// into wt, at wt[ii * wi + o * wo]. No copy waits on another; the copies
// form one group of the pipeline.
__device__ __forceinline__ void stage_weights(const Kan& P, int l, int i0,
                                              int icn, int sstride,
                                              float* slab, float* wt, int wi,
                                              int wo) {
  const int din = P.dims[l];
  const int dout = P.dims[l + 1];
  const int dn = dout * P.nb;
  const float* src = P.S[l] + static_cast<size_t>(i0) * dn;
  if ((dn & 3) == 0 && (sstride & 3) == 0 &&
      (reinterpret_cast<size_t>(src) & 15) == 0) {
    const int dn4 = dn >> 2;
    for (int ii = 0; ii < icn; ++ii) {
      for (int j = threadIdx.x; j < dn4; j += kThreads) {
        __pipeline_memcpy_async(slab + ii * sstride + 4 * j,
                                src + static_cast<size_t>(ii) * dn + 4 * j,
                                4 * sizeof(float));
      }
    }
  } else {
    for (int ii = 0; ii < icn; ++ii) {
      for (int j = threadIdx.x; j < dn; j += kThreads) {
        __pipeline_memcpy_async(slab + ii * sstride + j,
                                src + static_cast<size_t>(ii) * dn + j,
                                sizeof(float));
      }
    }
  }
  const float* W = P.W[l];
  for (int e = threadIdx.x; e < icn * dout; e += kThreads) {
    const int o = e / icn;
    const int ii = e - o * icn;
    __pipeline_memcpy_async(wt + ii * wi + o * wo,
                            W + static_cast<size_t>(o) * din + i0 + ii,
                            sizeof(float));
  }
  __pipeline_commit();
}

// Stages chunk c + 1 (when there is one) into the other buffer, then waits
// for chunk c's copies and for every thread.
__device__ __forceinline__ void next_chunk(const Kan& P, int l, int c,
                                           int nchunks, int ic, int sstride,
                                           float* const (&slabs)[2], int wi,
                                           int wo) {
  const int din = P.dims[l];
  if (c + 1 < nchunks) {
    float* nxt = slabs[(c + 1) & 1];
    const int i1 = (c + 1) * ic;
    stage_weights(P, l, i1, min(ic, din - i1), sstride, nxt,
                  nxt + ic * sstride, wi, wo);
    __pipeline_wait_prior(1);
  } else {
    __pipeline_wait_prior(0);
  }
  __syncthreads();
}

// a[r][o] (pre-activation of layer l) for the tile's rows, from h[r][i];
// both in shared memory, row-major. sm: kScratch floats of scratch.
__device__ void layer_forward(const Kan& P, int l, const float* h, float* a,
                              float* sm) {
  const int din = P.dims[l];
  const int dout = P.dims[l + 1];
  const int nb = P.nb;
  const int nb1 = nb + 1;
  const int tid = threadIdx.x;
  const int sstride = slab_stride(dout, nb);
  const int ic = min(kChunk, kSlab / (sstride + dout));
  const int nchunks = (din + ic - 1) / ic;
  // Features of up to fc inputs at a time, a whole number of chunks.
  int fc = kFeat / (kRows * nb1);
  if (fc < din) fc = fc / ic * ic;
  float* feat = sm;                       // [fc * nb1][kRows]
  float* const slabs[2] = {sm + kFeat, sm + kFeat + kSlab};
  const int nsplit = kThreads / dout;
  const int o = tid % dout;
  const int s = tid / dout;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  __syncthreads();                        // h written by the caller
  stage_weights(P, l, 0, min(ic, din), sstride, slabs[0],
                slabs[0] + ic * sstride, dout, 1);
  for (int c = 0; c < nchunks; ++c) {
    const int i0 = c * ic;
    const int icn = min(ic, din - i0);
    const int f0 = i0 % fc;
    if (f0 == 0) {
      const int fcn = min(fc, din - i0);
      for (int e = tid; e < kRows * fcn; e += kThreads) {
        const int r = e / fcn;
        const int ii = e - r * fcn;
        const float x = h[r * din + i0 + ii];
        float b[kMaxBasis], db[kMaxBasis];
        bspline<false>(tanhf(x), P.nb, P.knots, b, db);
        float* f = feat + ii * nb1 * kRows + r;
#pragma unroll
        for (int k = 0; k < kMaxBasis; ++k) {
          if (k < nb) f[k * kRows] = b[k];
        }
        f[nb * kRows] = x;
      }
    }
    next_chunk(P, l, c, nchunks, ic, sstride, slabs, dout, 1);
    const float* slab = slabs[c & 1];
    const float* wt = slab + ic * sstride;
    if (s < nsplit) {
      for (int ii = s; ii < icn; ii += nsplit) {
        const float* sw = slab + ii * sstride + o * nb;
        const float* f = feat + (f0 + ii) * nb1 * kRows;
#pragma unroll
        for (int k = 0; k < kMaxBasis + 1; ++k) {
          if (k <= nb) {
            const float w = (k < nb) ? sw[k] : wt[ii * dout + o];
            fma_rows(f + k * kRows, w, acc);
          }
        }
      }
    }
    __syncthreads();
  }
  float* red = slabs[0];                  // [nsplit][kRows][dout]
  if (s < nsplit) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) red[(s * kRows + r) * dout + o] = acc[r];
  }
  __syncthreads();
  const float* __restrict__ bias = P.bias[l];
  for (int e = tid; e < kRows * dout; e += kThreads) {
    const int r = e / dout;
    const int oo = e - r * dout;
    float v = 0.f;
    for (int q = 0; q < nsplit; ++q) v += red[(q * kRows + r) * dout + oo];
    a[e] = v + bias[oo];
  }
  __syncthreads();
}

// Gradient at layer l's input for the tile's rows: h[r][i] the layer's
// input and gc[r][o] the gradient at its output (shared memory, written
// before a barrier). Writes dh[r][i] (times relu'(h) when relu_mask) to
// out[r * din + i] for r < store_rows. sm: kScratch floats of scratch.
__device__ void layer_backward_rows(const Kan& P, int l, const float* h,
                                    const float* gc, float* out,
                                    int store_rows, bool relu_mask,
                                    float* sm) {
  const int din = P.dims[l];
  const int dout = P.dims[l + 1];
  const int nb = P.nb;
  const int nb1 = nb + 1;
  const int tid = threadIdx.x;
  const int sstride = slab_stride(dout, nb);
  const int ic = min(kThreads / nb1, kSlab / (sstride + dout));
  const int pc = ic * nb1;
  const int nchunks = (din + ic - 1) / ic;
  float* gT = sm;                         // [dout][kRows]
  float* q = gT + kMaxOut * kRows;        // [kRows][pc]
  float* const slabs[2] = {sm + kFeat, sm + kFeat + kSlab};

  for (int e = tid; e < kRows * dout; e += kThreads) {
    const int r = e / dout;
    const int o = e - r * dout;
    gT[o * kRows + r] = gc[e];
  }
  stage_weights(P, l, 0, min(ic, din), sstride, slabs[0],
                slabs[0] + ic * sstride, 1, ic);
  for (int c = 0; c < nchunks; ++c) {
    const int i0 = c * ic;
    const int icn = min(ic, din - i0);
    next_chunk(P, l, c, nchunks, ic, sstride, slabs, 1, ic);
    if (tid < icn * nb1) {
      const int ii = tid / nb1;
      const int k = tid - ii * nb1;
      const float* slab = slabs[c & 1];
      const float* col = (k < nb) ? slab + ii * sstride + k
                                  : slab + ic * sstride + ii;
      const int step = (k < nb) ? nb : ic;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int o = 0; o < dout; ++o) {
        fma_rows(gT + o * kRows, col[o * step], acc);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) q[r * pc + tid] = acc[r];
    }
    __syncthreads();
    if (tid < kRows * icn) {
      const int r = tid / icn;
      const int ii = tid - r * icn;
      const float x = h[r * din + i0 + ii];
      const float t = tanhf(x);
      float b[kMaxBasis], db[kMaxBasis];
      bspline<true>(t, P.nb, P.knots, b, db);
      const float* qq = q + r * pc + ii * nb1;
      float sp = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxBasis; ++k) {
        if (k < nb) sp = __fadd_rn(sp, __fmul_rn(qq[k], db[k]));
      }
      float v = __fadd_rn(qq[nb],
                          __fmul_rn(sp, __fsub_rn(1.f, __fmul_rn(t, t))));
      if (relu_mask) v = __fmul_rn(v, x > 0.f ? 1.f : 0.f);
      if (r < store_rows) out[r * din + i0 + ii] = v;
    }
  }
  __syncthreads();
}

// Inputs per weight-gradient CTA of a layer.
__host__ __device__ __forceinline__ int wgrad_chunk(int din, int dout,
                                                     int nb) {
  const int nb1 = nb + 1;
  int ic = (kThreads / dout) * kAcc / nb1;
  if (ic > kThreads / nb1) ic = kThreads / nb1;
  if (ic > din) ic = din;
  return ic < 1 ? 1 : ic;
}

// Weight gradients of layer l for inputs [chunk * ic, ...): each (i, o, k)
// belongs to one thread, which sums over the batch in order.
__device__ void layer_wgrad(const Kan& P, int l, int chunk,
                            const float* __restrict__ h,
                            const float* __restrict__ g, const Grads& G,
                            float* sm) {
  const int din = P.dims[l];
  const int dout = P.dims[l + 1];
  const int nb = P.nb;
  const int nb1 = nb + 1;
  const int B = P.B;
  const int tid = threadIdx.x;
  const int ic = wgrad_chunk(din, dout, nb);
  const int pstride = (ic * nb1 + 7) / 8 * 8 + kAcc;
  const int i0 = chunk * ic;
  const int icn = min(ic, din - i0);
  const int pcn = icn * nb1;
  const int nsplit = kThreads / dout;
  const int o = tid % dout;
  const int s = tid / dout;
  const int p0 = s * kAcc;
  float* feat = sm;                       // [kBatchChunk][pstride]
  float* gs = sm + kBatchChunk * pstride; // [kBatchChunk][dout]

  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
  float accb = 0.f;

  for (int b0 = 0; b0 < B; b0 += kBatchChunk) {
    const int bn = min(kBatchChunk, B - b0);
    __syncthreads();
    for (int e = tid; e < bn * icn; e += kThreads) {
      const int bb = e / icn;
      const int ii = e - bb * icn;
      const float x = h[static_cast<size_t>(b0 + bb) * din + i0 + ii];
      float b[kMaxBasis], db[kMaxBasis];
      bspline<false>(tanhf(x), P.nb, P.knots, b, db);
      float* f = feat + bb * pstride + ii * nb1;
#pragma unroll
      for (int k = 0; k < kMaxBasis; ++k) {
        if (k < nb) f[k] = b[k];
      }
      f[nb] = x;
    }
    for (int e = tid; e < bn * dout; e += kThreads) {
      gs[e] = g[static_cast<size_t>(b0) * dout + e];
    }
    __syncthreads();
    if (s < nsplit && p0 < pcn) {
      for (int bb = 0; bb < bn; ++bb) {
        const float gv = gs[bb * dout + o];
        const float4* f4 =
            reinterpret_cast<const float4*>(feat + bb * pstride + p0);
#pragma unroll
        for (int j = 0; j < kAcc / 4; ++j) {
          const float4 fv = f4[j];
          acc[4 * j] = fmaf(fv.x, gv, acc[4 * j]);
          acc[4 * j + 1] = fmaf(fv.y, gv, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(fv.z, gv, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(fv.w, gv, acc[4 * j + 3]);
        }
        accb += gv;
      }
    }
  }
  if (s < nsplit) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int p = p0 + j;
      if (p < pcn) {
        const int ii = p / nb1;
        const int k = p - ii * nb1;
        const int i = i0 + ii;
        if (k < nb) {
          G.S[l][(static_cast<size_t>(i) * dout + o) * nb + k] = acc[j];
        } else {
          G.W[l][static_cast<size_t>(o) * din + i] = acc[j];
        }
      }
    }
    if (chunk == 0 && s == 0) G.bias[l][o] = accb;
  }
}

// Rows [row0, row0 + kRows) of a (B, width) matrix into shared memory, rows
// past the batch zero.
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int row0, int nrows, int width,
                                          float* dst) {
  for (int e = threadIdx.x; e < kRows * width; e += kThreads) {
    const int r = e / width;
    dst[e] = (r < nrows) ? src[static_cast<size_t>(row0) * width + e] : 0.f;
  }
}

__device__ __forceinline__ void store_rows(const float* src, int row0,
                                           int nrows, int width,
                                           float* __restrict__ dst) {
  for (int e = threadIdx.x; e < nrows * width; e += kThreads) {
    dst[static_cast<size_t>(row0) * width + e] = src[e];
  }
}

// #8: one layer, rows in tiles of kRows.
__global__ void __launch_bounds__(kThreads)
kan_layer_fwd_kernel(Kan P, const float* __restrict__ x,
                     float* __restrict__ y) {
  float* sm = shared_floats();
  const int din = P.dims[0];
  const int dout = P.dims[1];
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, P.B - row0);
  float* h = sm;
  float* a = h + align4(kRows * din);
  float* scratch = a + align4(kRows * dout);
  load_rows(x, row0, nrows, din, h);
  layer_forward(P, 0, h, a, scratch);
  store_rows(a, row0, nrows, dout, y);
}

// #9: CTAs below n_row_tiles give dx for a row tile; the others give the
// weight gradients of an input chunk.
__global__ void __launch_bounds__(kThreads)
kan_layer_bwd_kernel(Kan P, const float* __restrict__ x,
                     const float* __restrict__ g, float* __restrict__ dx,
                     Grads G, int n_row_tiles) {
  float* sm = shared_floats();
  const int din = P.dims[0];
  const int dout = P.dims[1];
  if (static_cast<int>(blockIdx.x) >= n_row_tiles) {
    layer_wgrad(P, 0, blockIdx.x - n_row_tiles, x, g, G, sm);
    return;
  }
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, P.B - row0);
  float* h = sm;
  float* gc = h + align4(kRows * din);
  float* scratch = gc + align4(kRows * dout);
  load_rows(x, row0, nrows, din, h);
  load_rows(g, row0, nrows, dout, gc);
  __syncthreads();
  layer_backward_rows(P, 0, h, gc, dx + static_cast<size_t>(row0) * din,
                      nrows, false, scratch);
}

// ---------------------------------------------------------------- host

int wgrad_ctas(const Kan& P, int l) {
  const int ic = wgrad_chunk(P.dims[l], P.dims[l + 1], P.nb);
  return (P.dims[l] + ic - 1) / ic;
}

size_t wgrad_smem(const Kan& P) {
  size_t most = 0;
  for (int l = 0; l < P.n_layers; ++l) {
    const int ic = wgrad_chunk(P.dims[l], P.dims[l + 1], P.nb);
    const int pstride = (ic * (P.nb + 1) + 7) / 8 * 8 + kAcc;
    const size_t floats = static_cast<size_t>(kBatchChunk) *
                          (pstride + P.dims[l + 1]);
    if (floats > most) most = floats;
  }
  return most * sizeof(float);
}

template <typename Kernel>
int set_smem(Kernel* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// Fills P from the C arguments; false for a shape the kernels do not take.
bool make_kan(Kan& P, int B, const int* dims, int n_layers,
              const float* knots, int n_knots) {
  const int nb = n_knots - 4;
  if (B < 1 || n_layers < 1 || n_layers > kMaxLayers || nb < 1 ||
      nb > kMaxBasis) {
    return false;
  }
  P.n_layers = n_layers;
  P.nb = nb;
  P.B = B;
  for (int l = 0; l <= kMaxLayers; ++l) {
    P.dims[l] = (l <= n_layers) ? dims[l] : 0;
  }
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || dims[l] > kMaxIn) return false;
    if (l > 0 && dims[l] > kMaxOut) return false;
  }
  for (int i = 0; i < kMaxKnots; ++i) {
    P.knots[i] = (i < n_knots) ? knots[i] : 0.f;
  }
  for (int l = 0; l < kMaxLayers; ++l) {
    P.S[l] = P.W[l] = P.bias[l] = nullptr;
  }
  return true;
}

int row_tiles(int B) { return (B + kRows - 1) / kRows; }

}  // namespace

extern "C" int kan_layer_fwd(const float* x, const float* S, const float* W,
                             const float* bias, float* y, int B, int din,
                             int dout, const float* knots, int n_knots,
                             void* stream_ptr) {
  Kan P;
  const int dims[2] = {din, dout};
  if (!make_kan(P, B, dims, 1, knots, n_knots)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  P.S[0] = S;
  P.W[0] = W;
  P.bias[0] = bias;
  const size_t smem =
      (align4(kRows * din) + align4(kRows * dout) + kScratch) * sizeof(float);
  int e = set_smem(kan_layer_fwd_kernel, smem);
  if (e) return e;
  kan_layer_fwd_kernel<<<row_tiles(B), kThreads, smem,
                         static_cast<cudaStream_t>(stream_ptr)>>>(P, x, y);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kan_layer_bwd(const float* x, const float* g, const float* S,
                             const float* W, float* dx, float* dS, float* dW,
                             float* db, int B, int din, int dout,
                             const float* knots, int n_knots,
                             void* stream_ptr) {
  Kan P;
  const int dims[2] = {din, dout};
  if (!make_kan(P, B, dims, 1, knots, n_knots)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  P.S[0] = S;
  P.W[0] = W;
  Grads G = {};
  G.S[0] = dS;
  G.W[0] = dW;
  G.bias[0] = db;
  size_t smem =
      (align4(kRows * din) + align4(kRows * dout) + kScratch) * sizeof(float);
  const size_t wsmem = wgrad_smem(P);
  if (wsmem > smem) smem = wsmem;
  int e = set_smem(kan_layer_bwd_kernel, smem);
  if (e) return e;
  const int tiles = row_tiles(B);
  kan_layer_bwd_kernel<<<tiles + wgrad_ctas(P, 0), kThreads, smem,
                         static_cast<cudaStream_t>(stream_ptr)>>>(
      P, x, g, dx, G, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
