// The KAN head on Hopper (sm_90a), fp32 throughout: the whole head's
// forward (#10) and recompute backward (#11), and one KAN layer's forward
// (#8) and backward (#9), all on thread-block clusters.
//
// Replaces rovit_kan_tpu/ops/kan_kernel.py::_kan_module_kernel (#10),
// _kan_module_bwd_kernel (#11), _kan_kernel (#8) and _kan_layer_bwd_kernel
// (#9). Layer l computes
//   a[b][o] = bias[o] + sum_i (h[b][i] W[o][i]
//                              + sum_k basis_k(tanh h[b][i]) S[i][o][k])
// with the basis of kan_common.cuh, ReLU between layers and, with the head
// (#10/#11), 3 * sigmoid at the end; #11 walks back through 3 sigmoid',
// each layer and relu' (0 at 0) to dx and every layer's dS, dW and db.
// Without the head (the plan's switch, one layer only) the same kernels
// are #8 and #9: the forward writes a itself, and the backward's top
// gradient is g, so it recomputes no forward: the bases and their
// derivatives, dx and the weight gradients, the TPU #9's work. Layouts are
// the port's: S (in, out, K), W (out, in) as nn.Linear keeps it, bias (out).
//
// The TPU kernels run their products at Precision.HIGHEST; Hopper's tensor
// cores have no IEEE fp32 mode, so every product is an fp32 FMA.
//
// What bounds it on an H100 SXM: the flagship head [192, 64, 16, 1] with 7
// bases at B = 64 is 1.37e7 FLOP forward (0.20 us at 67 TFLOP/s) and
// 4.1e7 backward (0.61 us), on ~0.43 MB of weights; its layer 192 -> 64 is
// 1.26e7 forward and twice that backward: all far below a launch.
// What a launch does take is latency: the basis recursion's IEEE divisions
// (a chain of microseconds per (row, input)), the weights' trip from L2,
// and the barriers between layers. The design spreads those over many SMs
// and pays each once:
// - A cluster of C CTAs takes a group of R batch rows. Rank j owns a
//   contiguous slice of every width (the plan's bounds): of layer 0's
//   inputs, and of each later layer's inputs, which are the previous
//   layer's outputs. It evaluates the bases of its own (row, input) pairs
//   once, keeps them in shared memory, and stages only its slice of each
//   layer's S and W, with 16 bytes of weights per (input, output) row in
//   [input][k / 4][output][k % 4] order (4-byte cp.async from the (in, out,
//   K) rows; W as the last k).
// - Forward, per layer: rank j sums its inputs into a partial
//   pre-activation of every output (thread tile 4 rows x 1 or 2); after
//   a cluster barrier, rank j adds the C partials of its own outputs in rank
//   order through distributed shared memory, plus the bias, so a repeated
//   call gives the same bits; the ReLU and the next layer's bases follow in
//   the same thread. The owner of the last outputs applies 3 * sigmoid
//   (#10), forms the top gradient (#11), or writes a (#8). (Storing the
//   partials into the owners before the barrier, in place of these loads
//   after it, ran slower on the card.)
// - Backward (#11), per layer from the last: every rank gathers the
//   layer's output gradient (R x out) from the owners' slices and keeps
//   it, then forms dh for its inputs (q = g M through the staged weights,
//   combined with the kept basis derivatives and 1 - t^2; times relu' it is
//   its slice of the previous layer's output gradient, or dx at layer 0).
//   After the chain, one pass forms every layer's dS and dW for the rank's
//   inputs (summed over the group's rows in order) and db for its outputs,
//   the small layers' tiles beside layer 0's. Nothing goes through global
//   scratch. #9 reads its group's rows of g straight into that kept
//   gradient and needs no cluster barrier: no rank reads another's memory.
// - Weights stream through two shared buffers in the order the layers use
//   them (forward 0..L-1, then backward L-1..0; #9 only its backward): the
//   next chunk's copy runs under the current chunk's work and the barriers
//   between. On the flagship every rank's slice of a layer is one chunk.
// - #10 and #8 run a cluster per row group. #11 and #9 run waves of at
//   most slots clusters (8, ops/kan_kernel.py::BWD_SLOTS), in order on the
//   stream: cluster s of a wave keeps its group's weight gradients in fp32
//   slot s, the first wave storing, each later one adding to what the same
//   thread stored there, so slot s sums groups s, s + slots, ... in order. With
//   one group (B <= R) the slot is the gradients themselves: one launch.
//   With more, kan_grad_reduce_kernel adds the slots in order. The slots'
//   memory does not grow with the batch. No atomics anywhere.
// - The basis recursion's IEEE divisions are its latency: each is a
//   reciprocal, Newton steps and a check that branches to a slow path, one
//   after another (clock64 stamps put the first design's bases at tens of
//   thousands of cycles a CTA per layer). Every denominator is a knot
//   difference b, so RecipDiv takes y = RN(1 / b) from a table the host
//   fills and forms q = RN(a y), r = a - b q (exact in one FMA), RN(q + r y):
//   by Markstein's theorem (y within half an ulp of 1 / b, q within an ulp
//   of a / b) that is RN(a / b), the bits of __fdiv_rn, wherever no step
//   leaves the normal range. It is used where that holds for every step of
//   a pair: denominators in [2^-8, 2^8] (the host checks) and every
//   |t - knot| zero or at least 2^-40 (the kernel checks per pair), so
//   every numerator is 0 (taken as q, which keeps its sign) or at least
//   2^-100; other pairs take IeeeDiv. Where nb is the one the kernel fixes
//   at compile time (3, 7 or 10: K1P - 1, at most 10) and the knots
//   increase strictly, the recursion is straight-line code; other basis
//   counts and repeated knots run it with nb known at run time. (Sending
//   those to IeeeDiv alone made the flagship's #10 13% slower on an H100:
//   its kernels lost 21 registers and spilled.) The card tests
//   hold the kernels' outputs with and without the table bit for bit, in
//   each form.
// The host's plan (ops/kan_kernel.py::module_plan) gives R, C, the groups,
// the slots, the chunks, the bounds and the head switch, which picks the
// kernels' kHead instance, so that the switch compiles away (read at run
// time in one instance it cost #11 2% on an H100, its registers
// unchanged); the entry points check the plan against the shapes and
// recompute its shared-memory size. ptxas spills 4 bytes in #11's instance
// at 8 feature slots: each variant that removed them ran #11 slower on an
// H100.
//
// Interface: plain C, loaded with ctypes; each function returns the first
// CUDA error of its launches (0 = success), cudaErrorInvalidValue for a
// shape or plan the kernels do not take.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <cstddef>

#include "kan_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;
constexpr int kMaxRows = 64;            // rows of a group
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 512;
// Outputs of a thread's tile in the forward partial products (with 4
// rows): #10 (16 rows a group, 256 threads) and #11 (64 rows, 512 threads)
// each ran fastest on the card with its own; and in the weight gradients
// (with K1P k of one input).
constexpr int kFwdOuts10 = 1;
constexpr int kFwdOuts11 = 2;
constexpr int kGradOuts = 2;
constexpr int kSmemFloats = 232448 / 4; // 227 KB, Hopper's most per CTA
constexpr int kMaxDevices = 64;

struct Plan {
  int n_layers, nb, B, R, C;
  int groups, slots;                    // row groups; #11's clusters a launch
  int group0, first;                    // this launch's first group; 1: wave 0
  int dims[kMaxLayers + 1];
  // Rank j owns [bounds[d][j], bounds[d][j + 1]) of width d.
  int bounds[kMaxLayers + 1][kMaxCluster + 1];
  int ic[kMaxLayers];                   // inputs per staged weight chunk
  float knots[kMaxKnots];
  int recip;                            // 1: RecipDiv where it is exact
  int distinct;                         // 1: the knots increase strictly
  float rcp[kDivSlots];                 // RN(1 / (k[j + d] - k[j]))
  const float* S[kMaxLayers];
  const float* W[kMaxLayers];
  const float* bias[kMaxLayers];
  // Shared memory, offsets in floats: each layer's kept features and (#11)
  // basis derivatives and gathered output gradient, two weight buffers,
  // two partial buffers, two gradient slices.
  int feat[kMaxLayers], der[kMaxLayers], ga[kMaxLayers];
  int slab[2], part[2], slice[2];
  int head;                             // 1: 3 * sigmoid at the end (#10/#11)
};

// Where layer l's dS, dW and db go: ptr[3 l + {0, 1, 2}] + slot * stride.
struct Grads {
  float* ptr[3 * kMaxLayers];
  long long stride;                     // 0 with one slot
};

__device__ __forceinline__ int lo_of(const Plan& P, int d, int j) {
  return P.bounds[d][j];
}

__device__ __forceinline__ int n_of(const Plan& P, int d, int j) {
  return P.bounds[d][j + 1] - P.bounds[d][j];
}

__device__ __forceinline__ int chunks_of(const Plan& P, int l, int rank) {
  return (n_of(P, l, rank) + P.ic[l] - 1) / P.ic[l];
}

// The layers whose forward a kernel runs: all, but #9's backward none
// (without the head there is one layer, make_plan checks, and its top
// gradient needs no forward).
template <bool kBwd, bool kHead>
__device__ __forceinline__ int forward_layers(const Plan& P) {
  return kBwd && !kHead ? 0 : P.n_layers;
}

// Job j of the weight stream: (layer, chunk). Forward layers 0..F-1 (F =
// forward_layers), then, with kBwd, backward layers L-1..0. False past the
// last job.
template <bool kBwd, bool kHead>
__device__ __forceinline__ bool job_of(const Plan& P, int rank, int j,
                                       int& l, int& c) {
  for (int pass = 0; pass < (kBwd ? 2 : 1); ++pass) {
    const int n_pass =
        pass == 0 ? forward_layers<kBwd, kHead>(P) : P.n_layers;
    for (int s = 0; s < n_pass; ++s) {
      l = pass == 0 ? s : P.n_layers - 1 - s;
      const int n = chunks_of(P, l, rank);
      if (j < n) {
        c = j;
        return true;
      }
      j -= n;
    }
  }
  return false;
}

// Starts the copy of job j's weights into buffer j % 2, as one cp.async
// group (empty past the last job).
template <bool kBwd, bool kHead, int NT, int K1P>
__device__ void issue(const Plan& P, int rank, int j, float* sm) {
  int l, c;
  if (job_of<kBwd, kHead>(P, rank, j, l, c)) {
    const int nb = P.nb;
    const int din = P.dims[l];
    const int dout = P.dims[l + 1];
    const int i0 = lo_of(P, l, rank) + c * P.ic[l];
    const int icn = min(P.ic[l], n_of(P, l, rank) - c * P.ic[l]);
    const float* __restrict__ S = P.S[l];
    const float* __restrict__ W = P.W[l];
    float* slab = sm + P.slab[j & 1];
    for (int p = threadIdx.x; p < icn * dout; p += NT) {
      const int ii = p / dout;
      const int o = p - ii * dout;
      const float* src = S + (static_cast<size_t>(i0 + ii) * dout + o) * nb;
      float* dst = slab + ii * K1P * dout + 4 * o;
      for (int k = 0; k < nb; ++k) {
        __pipeline_memcpy_async(dst + (k >> 2) * 4 * dout + (k & 3), src + k,
                                sizeof(float));
      }
      __pipeline_memcpy_async(dst + (nb >> 2) * 4 * dout + (nb & 3),
                              W + static_cast<size_t>(o) * din + i0 + ii,
                              sizeof(float));
      for (int k = nb + 1; k < K1P; ++k) {
        dst[(k >> 2) * 4 * dout + (k & 3)] = 0.f;
      }
    }
  }
  __pipeline_commit();
}

// The weight stream's consumer side: waits for job jn's copies and for
// every thread (so the other buffer is free), starts job jn + 1's copy
// there, and returns jn's buffer.
template <bool kBwd, bool kHead, int NT, int K1P>
__device__ __forceinline__ const float* next_job(const Plan& P, int rank,
                                                 int& jn, float* sm) {
  __pipeline_wait_prior(0);
  __syncthreads();
  issue<kBwd, kHead, NT, K1P>(P, rank, jn + 1, sm);
  return sm + P.slab[jn++ & 1];
}

// a / b from y = RN(1 / b): see the source note. With kDistinctKnots the
// plan has checked that the knots increase strictly.
template <bool kDistinctKnots>
struct RecipDiv {
  static constexpr bool kDistinct = kDistinctKnots;
  const float* y;
  __device__ __forceinline__ float operator()(float a, float b,
                                              int slot) const {
    const float yy = y[slot];
    const float q = __fmul_rn(a, yy);
    const float r = __fmaf_rn(-q, b, a);
    return a == 0.f ? q : __fmaf_rn(r, yy, q);
  }
};

// Whether RecipDiv gives __fdiv_rn's bits at every step of t's basis.
__device__ __forceinline__ bool recip_exact(const Plan& P, float t) {
  const int nk = P.nb + 4;
  const float x = fminf(fmaxf(t, P.knots[0]), P.knots[nk - 1]);
  bool ok = P.recip != 0;
#pragma unroll
  for (int i = 0; i < kMaxKnots; ++i) {
    const float d = fabsf(__fsub_rn(x, P.knots[i]));
    ok = ok && (i >= nk || d == 0.f || d >= 0x1p-40f);
  }
  return ok;
}

// The number of bases whose recursion a kernel of K1P feature slots
// compiles with nb fixed: the most that K1P holds.
__host__ __device__ constexpr int fixed_nb(int k1p) {
  return k1p - 1 < kMaxBasis ? k1p - 1 : kMaxBasis;
}

// Features of one (row, input) pair of a layer's slice: F[ii][k][r] =
// basis_k(tanh x) for k < nb, x at k = nb, 0 past it; with kDeriv also
// D[ii][k][r] = d basis_k / dt, and 1 - t^2 at k = nb. The basis takes
// RecipDiv where that is exact, with nb fixed at compile time where it is
// fixed_nb(K1P) and the knots increase strictly; out of line, so that each
// kernel holds one copy of each form of the recursion.
template <bool kDeriv, int K1P>
__device__ __noinline__ void put_features(const Plan& P, float* F, float* D,
                                          int ii, int r, float x) {
  const int R = P.R;
  const int nb = P.nb;
  const float t = tanhf(x);
  float b[kMaxBasis], db[kMaxBasis];
  if (!recip_exact(P, t)) {
    bspline<kDeriv>(t, nb, P.knots, b, db);
  } else if (nb == fixed_nb(K1P) && P.distinct) {
    bspline<kDeriv, RecipDiv<true>, fixed_nb(K1P)>(t, nb, P.knots, b, db,
                                                   RecipDiv<true>{P.rcp});
  } else {
    bspline<kDeriv>(t, nb, P.knots, b, db, RecipDiv<false>{P.rcp});
  }
  float* f = F + ii * K1P * R + r;
#pragma unroll
  for (int k = 0; k < kMaxBasis; ++k) {
    if (k < nb) f[k * R] = b[k];
  }
  f[nb * R] = x;
  for (int k = nb + 1; k < K1P; ++k) f[k * R] = 0.f;
  if (kDeriv) {
    float* d = D + ii * K1P * R + r;
#pragma unroll
    for (int k = 0; k < kMaxBasis; ++k) {
      if (k < nb) d[k * R] = db[k];
    }
    d[nb * R] = __fsub_rn(1.f, __fmul_rn(t, t));
    for (int k = nb + 1; k < K1P; ++k) d[k * R] = 0.f;
  }
}

// Layer 0's features for the rank's inputs, from the group's rows of x
// (rows past the batch are 0).
template <bool kDeriv, int NT, int K1P>
__device__ void input_features(const Plan& P, int rank, int row0,
                               const float* __restrict__ x, float* sm) {
  const int R = P.R;
  const int d0 = P.dims[0];
  const int lo = lo_of(P, 0, rank);
  const int n = n_of(P, 0, rank);
  for (int p = threadIdx.x; p < n * R; p += NT) {
    const int ii = p / R;
    const int r = p - ii * R;
    const int row = row0 + r;
    const float v =
        row < P.B ? x[static_cast<size_t>(row) * d0 + lo + ii] : 0.f;
    put_features<kDeriv, K1P>(P, sm + P.feat[0], sm + P.der[0], ii, r, v);
  }
}

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float* acc, const float4& f, float w) {
  acc[0] = fmaf(f.x, w, acc[0]);
  acc[1] = fmaf(f.y, w, acc[1]);
  acc[2] = fmaf(f.z, w, acc[2]);
  acc[3] = fmaf(f.w, w, acc[3]);
}

// The rank's partial pre-activation of every output of layer l over one
// chunk of its inputs, into part[o][r] (row stride R + 4): the first chunk
// stores, later ones add. Thread tile: rows r0..r0+3 of the TO outputs
// oa + j oq.
template <int NT, int K1P, int TO>
__device__ void forward_partial(const Plan& P, int l, const float* F,
                                const float* M, int c0, int icn, bool first,
                                float* part) {
  const int R = P.R;
  const int ps = R + 4;
  const int dout = P.dims[l + 1];
  const int oq = (dout + TO - 1) / TO;
  for (int t = threadIdx.x; t < (R >> 2) * oq; t += NT) {
    const int oa = t % oq;
    const int r0 = (t / oq) * 4;
    float acc[TO][4];
#pragma unroll
    for (int h = 0; h < TO; ++h) {
      const int o = oa + h * oq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[h][j] = (first || o >= dout) ? 0.f : part[o * ps + r0 + j];
      }
    }
    for (int ii = 0; ii < icn; ++ii) {
      const float* f = F + (c0 + ii) * K1P * R + r0;
      const float* m = M + ii * K1P * dout;
#pragma unroll
      for (int kq = 0; kq < K1P / 4; ++kq) {
        float4 w[TO];
#pragma unroll
        for (int h = 0; h < TO; ++h) {
          const int o = oa + h * oq;
          const float* mo = m + (kq * dout + o) * 4;
          w[h] = o < dout ? *reinterpret_cast<const float4*>(mo)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 fv =
              *reinterpret_cast<const float4*>(f + (4 * kq + kk) * R);
#pragma unroll
          for (int h = 0; h < TO; ++h) fma4(acc[h], fv, lane(w[h], kk));
        }
      }
    }
#pragma unroll
    for (int h = 0; h < TO; ++h) {
      const int o = oa + h * oq;
      if (o < dout) {
#pragma unroll
        for (int j = 0; j < 4; ++j) part[o * ps + r0 + j] = acc[h][j];
      }
    }
  }
}

// Layer l's pre-activation of the rank's outputs: the C partials in rank
// order (through distributed shared memory; ranks with no inputs of the
// layer hold none), plus the bias. Then either the ReLU and the next
// layer's features, or, after the last layer, 3 * sigmoid into y (#10), a
// itself into y (#8), or the top gradient ((g * 3) * s) * (1 - s) into the
// rank's gradient slice (#11).
template <bool kBwd, bool kHead, int NT, int K1P>
__device__ void reduce_layer(const Plan& P, cg::cluster_group& cluster,
                             int rank, int l, int row0, float* sm,
                             const float* __restrict__ g,
                             float* __restrict__ y) {
  const int R = P.R;
  const int ps = R + 4;
  const int L = P.n_layers;
  const int lo = lo_of(P, l + 1, rank);
  const int m = n_of(P, l + 1, rank);
  float* part = sm + P.part[l & 1];
  const float* __restrict__ bias = P.bias[l];
  for (int p = threadIdx.x; p < m * R; p += NT) {
    const int oo = p / R;
    const int r = p - oo * R;
    const int o = lo + oo;
    // Every remote load first, then the sum in rank order.
    float pv[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      pv[q] = (q < P.C && n_of(P, l, q) > 0)
                  ? cluster.map_shared_rank(part, q)[o * ps + r]
                  : 0.f;
    }
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < P.C && n_of(P, l, q) > 0) v = __fadd_rn(v, pv[q]);
    }
    const float a = __fadd_rn(v, bias[o]);
    if (l < L - 1) {
      put_features<kBwd, K1P>(P, sm + P.feat[l + 1], sm + P.der[l + 1], oo,
                              r, fmaxf(a, 0.f));
    } else {
      const int row = row0 + r;
      const int dl = P.dims[L];
      if (kBwd) {
        const float gv =
            row < P.B ? g[static_cast<size_t>(row) * dl + o] : 0.f;
        const float s = sigmoid(a);
        sm[P.slice[l & 1] + oo * R + r] = __fmul_rn(
            __fmul_rn(__fmul_rn(gv, 3.f), s), __fsub_rn(1.f, s));
      } else if (row < P.B) {
        y[static_cast<size_t>(row) * dl + o] =
            kHead ? __fmul_rn(3.f, sigmoid(a)) : a;
      }
    }
  }
}

// The output gradient of layer l, ga[l][o][r] (row stride R + 4) over all
// of its outputs, from the owners' slices.
template <int NT>
__device__ void gather(const Plan& P, cg::cluster_group& cluster,
                       int l, float* sm) {
  const int R4 = P.R >> 2;
  const int ps = P.R + 4;
  const int d = l + 1;
  float* ga = sm + P.ga[l];
  float* slice = sm + P.slice[l & 1];
  for (int e = threadIdx.x; e < P.dims[d] * R4; e += NT) {
    const int o = e / R4;
    const int r4 = e - o * R4;
    int q = 0;
    while (P.bounds[d][q + 1] <= o) ++q;       // the owner of output o
    const float4* src =
        reinterpret_cast<const float4*>(cluster.map_shared_rank(slice, q));
    *reinterpret_cast<float4*>(ga + o * ps + 4 * r4) =
        src[(o - P.bounds[d][q]) * R4 + r4];
  }
}

// #9's output gradient of layer l, ga[l][o][r] (row stride R + 4): the
// group's rows of g itself (rows past the batch are 0).
template <int NT>
__device__ void load_grad(const Plan& P, int l, int row0,
                          const float* __restrict__ g, float* sm) {
  const int R = P.R;
  const int dout = P.dims[l + 1];
  float* ga = sm + P.ga[l];
  for (int e = threadIdx.x; e < R * dout; e += NT) {
    const int r = e / dout;
    const int o = e - r * dout;
    const int row = row0 + r;
    ga[o * (R + 4) + r] =
        row < P.B ? g[static_cast<size_t>(row) * dout + o] : 0.f;
  }
}

// The weight gradients of the rank's slices of every layer, summed over
// the group's rows in order: dS and dW for its inputs (thread tile one
// input x K1P k x the kGradOuts outputs oa + j oq), db for its outputs.
// The layers' tiles share one pass, so the small layers' run under the
// first's. The first wave stores them in the cluster's slot; with kAdd a
// later one adds to what the same thread of the wave before stored there
// (a form of its own, so that the first wave's keeps its registers).
template <int NT, int K1P, bool kAdd>
__device__ void weight_grads(const Plan& P, const Grads& G, int rank,
                             int slot, const float* sm) {
  constexpr int TO = kGradOuts;
  const int R = P.R;
  const int ps = R + 4;
  const int nb = P.nb;
  const size_t off = static_cast<size_t>(slot) * G.stride;
  int tiles = 0;
  for (int l = 0; l < P.n_layers; ++l) {
    tiles += n_of(P, l, rank) * ((P.dims[l + 1] + TO - 1) / TO);
  }
  for (int t0 = threadIdx.x; t0 < tiles; t0 += NT) {
    int l = 0;
    int t = t0;
    for (int c = n_of(P, 0, rank) * ((P.dims[1] + TO - 1) / TO); t >= c;
         c = n_of(P, l, rank) * ((P.dims[l + 1] + TO - 1) / TO)) {
      t -= c;
      ++l;
    }
    const int din = P.dims[l];
    const int dout = P.dims[l + 1];
    const int oq = (dout + TO - 1) / TO;
    const float* ga = sm + P.ga[l];
    const int oa = t % oq;
    const int ii = t / oq;
    const float* f = sm + P.feat[l] + ii * K1P * R;
    const float* gr[TO];
#pragma unroll
    for (int h = 0; h < TO; ++h) {
      // A row past the outputs reads row oa, and is not stored.
      const int o = oa + h * oq;
      gr[h] = ga + (o < dout ? o : oa) * ps;
    }
    float acc[TO][K1P];
#pragma unroll
    for (int h = 0; h < TO; ++h) {
#pragma unroll
      for (int k = 0; k < K1P; ++k) acc[h][k] = 0.f;
    }
    for (int r = 0; r < R; r += 4) {
      float4 gv[TO];
#pragma unroll
      for (int h = 0; h < TO; ++h) {
        gv[h] = *reinterpret_cast<const float4*>(gr[h] + r);
      }
#pragma unroll
      for (int k = 0; k < K1P; ++k) {
        const float4 fv = *reinterpret_cast<const float4*>(f + k * R + r);
#pragma unroll
        for (int h = 0; h < TO; ++h) {
          acc[h][k] = fmaf(fv.x, gv[h].x, acc[h][k]);
          acc[h][k] = fmaf(fv.y, gv[h].y, acc[h][k]);
          acc[h][k] = fmaf(fv.z, gv[h].z, acc[h][k]);
          acc[h][k] = fmaf(fv.w, gv[h].w, acc[h][k]);
        }
      }
    }
    const int i = lo_of(P, l, rank) + ii;
    float* __restrict__ dS = G.ptr[3 * l] + off;
    float* __restrict__ dW = G.ptr[3 * l + 1] + off;
#pragma unroll
    for (int h = 0; h < TO; ++h) {
      const int o = oa + h * oq;
      if (o >= dout) continue;
      float* ds = dS + (static_cast<size_t>(i) * dout + o) * nb;
      float* dw = dW + static_cast<size_t>(o) * din + i;
#pragma unroll
      for (int k = 0; k < K1P; ++k) {
        if (k < nb) ds[k] = kAdd ? __fadd_rn(ds[k], acc[h][k]) : acc[h][k];
        if (k == nb) *dw = kAdd ? __fadd_rn(*dw, acc[h][k]) : acc[h][k];
      }
    }
  }
  for (int l = 0; l < P.n_layers; ++l) {
    const int olo = lo_of(P, l + 1, rank);
    for (int oo = threadIdx.x; oo < n_of(P, l + 1, rank); oo += NT) {
      const float* gr = sm + P.ga[l] + (olo + oo) * ps;
      float s = 0.f;
      for (int r = 0; r < R; ++r) s = __fadd_rn(s, gr[r]);
      float* db = G.ptr[3 * l + 2] + off + olo + oo;
      *db = kAdd ? __fadd_rn(*db, s) : s;
    }
  }
}

// dh for one chunk of the rank's inputs of layer l: q[r][k] = sum_o
// ga[o][r] M[o][k] (thread tile 2 rows x one input x K1P), then
// dh = q[nb] + (sum_k q[k] basis'_k) (1 - t^2), as ops/spline.py's
// derivative list gives it. Times relu'(h) it is the rank's slice of layer
// l - 1's output gradient; at layer 0 it is dx.
template <int NT, int K1P>
__device__ void input_grads(const Plan& P, int rank, int l, const float* M,
                            int c0, int icn, int row0, float* sm,
                            float* __restrict__ dx) {
  const int R = P.R;
  const int R2 = R >> 1;
  const int ps = R + 4;
  const int nb = P.nb;
  const int dout = P.dims[l + 1];
  const float* F = sm + P.feat[l];
  const float* D = sm + P.der[l];
  const float* ga = sm + P.ga[l];
  for (int t = threadIdx.x; t < R2 * icn; t += NT) {
    const int r0 = (t % R2) * 2;
    const int ii = t / R2;
    const float* m = M + ii * K1P * dout;
    float q[2][K1P];
#pragma unroll
    for (int k = 0; k < K1P; ++k) q[0][k] = q[1][k] = 0.f;
    for (int o = 0; o < dout; ++o) {
      const float2 gv = *reinterpret_cast<const float2*>(ga + o * ps + r0);
#pragma unroll
      for (int kq = 0; kq < K1P / 4; ++kq) {
        const float4 w =
            *reinterpret_cast<const float4*>(m + (kq * dout + o) * 4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float wk = lane(w, kk);
          q[0][4 * kq + kk] = fmaf(gv.x, wk, q[0][4 * kq + kk]);
          q[1][4 * kq + kk] = fmaf(gv.y, wk, q[1][4 * kq + kk]);
        }
      }
    }
    const int iis = c0 + ii;              // input within the rank's slice
    const float* d = D + iis * K1P * R + r0;
    float sp[2] = {0.f, 0.f};
    float qn[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < K1P; ++k) {
      if (k < nb && k < kMaxBasis) {
        const float2 dv = *reinterpret_cast<const float2*>(d + k * R);
        sp[0] = __fadd_rn(sp[0], __fmul_rn(q[0][k], dv.x));
        sp[1] = __fadd_rn(sp[1], __fmul_rn(q[1][k], dv.y));
      }
      if (k == nb) {
        qn[0] = q[0][k];
        qn[1] = q[1][k];
      }
    }
    const float2 tt = *reinterpret_cast<const float2*>(d + nb * R);
    const float2 hv =
        *reinterpret_cast<const float2*>(F + (iis * K1P + nb) * R + r0);
    const float t2[2] = {tt.x, tt.y};
    const float h[2] = {hv.x, hv.y};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = __fadd_rn(qn[j], __fmul_rn(sp[j], t2[j]));
      if (l > 0) {
        v = __fmul_rn(v, h[j] > 0.f ? 1.f : 0.f);
        sm[P.slice[(l - 1) & 1] + iis * R + r0 + j] = v;
      } else if (row0 + r0 + j < P.B) {
        dx[static_cast<size_t>(row0 + r0 + j) * P.dims[0] +
           lo_of(P, 0, rank) + iis] = v;
      }
    }
  }
}

// #10 (#8 without kHead): one cluster per group of R rows.
template <int K1P, bool kHead>
__global__ void __launch_bounds__(kFwdThreads)
kan_module_fwd_kernel(const __grid_constant__ Plan P,
                      const float* __restrict__ x, float* __restrict__ y) {
  constexpr int NT = kFwdThreads;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x) / P.C * P.R;
  float* sm = shared_floats();
  int jn = 0;
  issue<false, kHead, NT, K1P>(P, rank, 0, sm);
  input_features<false, NT, K1P>(P, rank, row0, x, sm);
  for (int l = 0; l < P.n_layers; ++l) {
    for (int c = 0; c < chunks_of(P, l, rank); ++c) {
      const float* M = next_job<false, kHead, NT, K1P>(P, rank, jn, sm);
      const int c0 = c * P.ic[l];
      forward_partial<NT, K1P, kFwdOuts10>(
          P, l, sm + P.feat[l], M, c0, min(P.ic[l], n_of(P, l, rank) - c0),
          c == 0, sm + P.part[l & 1]);
    }
    cluster.sync();
    reduce_layer<false, kHead, NT, K1P>(P, cluster, rank, l, row0, sm,
                                        nullptr, y);
  }
  cluster.sync();       // no CTA leaves while another reads its partials
}

// #11: the forward recomputed as #10 (with the basis derivatives kept),
// then the chain back; cluster s of the launch takes group group0 + s and
// keeps its weight gradients in slot s. #9 (without kHead): the bases and
// their derivatives, then its one layer's backward from g.
template <int K1P, bool kHead>
__global__ void __launch_bounds__(kBwdThreads, 1)
kan_module_bwd_kernel(const __grid_constant__ Plan P,
                      const float* __restrict__ x,
                      const float* __restrict__ g, float* __restrict__ dx,
                      const __grid_constant__ Grads G) {
  constexpr int NT = kBwdThreads;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int slot = static_cast<int>(blockIdx.x) / P.C;
  const int row0 = (P.group0 + slot) * P.R;
  float* sm = shared_floats();
  int jn = 0;
  const int nf = forward_layers<true, kHead>(P);
  issue<true, kHead, NT, K1P>(P, rank, 0, sm);
  input_features<true, NT, K1P>(P, rank, row0, x, sm);
  for (int l = 0; l < nf; ++l) {
    for (int c = 0; c < chunks_of(P, l, rank); ++c) {
      const float* M = next_job<true, kHead, NT, K1P>(P, rank, jn, sm);
      const int c0 = c * P.ic[l];
      forward_partial<NT, K1P, kFwdOuts11>(
          P, l, sm + P.feat[l], M, c0, min(P.ic[l], n_of(P, l, rank) - c0),
          c == 0, sm + P.part[l & 1]);
    }
    cluster.sync();
    reduce_layer<true, kHead, NT, K1P>(P, cluster, rank, l, row0, sm, g,
                                       nullptr);
  }
  for (int l = kHead ? P.n_layers - 1 : 0; l >= 0; --l) {
    if (!kHead) {
      load_grad<NT>(P, l, row0, g, sm);  // read after next_job's barrier
    } else {
      cluster.sync();   // every slice of layer l's output gradient written
      gather<NT>(P, cluster, l, sm);
    }
    for (int c = 0; c < chunks_of(P, l, rank); ++c) {
      const float* M = next_job<true, kHead, NT, K1P>(P, rank, jn, sm);
      const int c0 = c * P.ic[l];
      input_grads<NT, K1P>(P, rank, l, M, c0,
                           min(P.ic[l], n_of(P, l, rank) - c0), row0, sm,
                           dx);
    }
  }
  __syncthreads();      // every layer's output gradient gathered
  if (P.first) {
    weight_grads<NT, K1P, false>(P, G, rank, slot, sm);
  } else {
    weight_grads<NT, K1P, true>(P, G, rank, slot, sm);
  }
  // No CTA leaves while another reads its slices (#9 reads none).
  if (kHead) cluster.sync();
}

// The weight gradients of the slots: out = sum over slots in order of each
// slot's sums (n floats a slot, segment s at off[s]).
struct Segments {
  float* out[3 * kMaxLayers];
  long long off[3 * kMaxLayers + 1];
  int n;
};

__global__ void __launch_bounds__(256)
kan_grad_reduce_kernel(const float* __restrict__ part, int slots,
                       const __grid_constant__ Segments seg) {
  const long long n = seg.off[seg.n];
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * 256) {
    float v = part[e];
    for (int si = 1; si < slots; ++si) v = __fadd_rn(v, part[si * n + e]);
    int s = 0;
    while (e >= seg.off[s + 1]) ++s;
    seg.out[s][e - seg.off[s]] = v;
  }
}

// ---------------------------------------------------------------- host

// Fills P from the C arguments and the plan ([R, C, groups, slots, shared
// floats, reciprocal basis (0 or 1), head (0 or 1; 0 only with one layer),
// ic[kMaxLayers], bounds[(L + 1) (C + 1)]]), and lays out shared memory;
// false for a shape or plan the kernels do not take.
bool make_plan(Plan& P, int B, const int* dims, int n_layers,
               const float* knots, int n_knots, const int* plan, bool bwd) {
  const int nb = n_knots - 4;
  if (B < 1 || n_layers < 1 || n_layers > kMaxLayers || nb < 1 ||
      nb > kMaxBasis) {
    return false;
  }
  P = Plan{};
  P.n_layers = n_layers;
  P.nb = nb;
  P.B = B;
  P.R = plan[0];
  P.C = plan[1];
  P.groups = plan[2];
  P.slots = plan[3];
  P.head = plan[6];
  if (P.R < 8 || P.R > kMaxRows || P.R % 8 || P.C < 1 ||
      P.C > kMaxCluster || P.groups != (B + P.R - 1) / P.R ||
      P.slots < 1 || P.slots > P.groups ||
      !(P.head == 1 || (P.head == 0 && n_layers == 1))) {
    return false;
  }
  for (int l = 0; l <= n_layers; ++l) {
    P.dims[l] = dims[l];
    if (dims[l] < 1 || dims[l] > kMaxIn) return false;
    if (l > 0 && dims[l] > kMaxOut) return false;
  }
  const int* bounds = plan + 7 + kMaxLayers;
  int nmax[kMaxLayers + 1] = {};
  for (int d = 0; d <= n_layers; ++d) {
    for (int j = 0; j <= P.C; ++j) {
      P.bounds[d][j] = bounds[d * (P.C + 1) + j];
      if (j > 0 && P.bounds[d][j] < P.bounds[d][j - 1]) return false;
      if (j > 0) nmax[d] = max(nmax[d], P.bounds[d][j] - P.bounds[d][j - 1]);
    }
    if (P.bounds[d][0] != 0 || P.bounds[d][P.C] != dims[d]) return false;
  }
  for (int i = 0; i < n_knots; ++i) P.knots[i] = knots[i];
  // RecipDiv's table, and whether every denominator is in [2^-8, 2^8].
  P.recip = plan[5] != 0;
  P.distinct = 1;
  for (int i = 0; i + 1 < n_knots; ++i) {
    if (!(knots[i + 1] > knots[i])) P.distinct = 0;
  }
  for (int d = 1; d <= 3; ++d) {
    for (int j = 0; j <= kMaxBasis && j + d < n_knots; ++j) {
      if (knots[j + d] == knots[j]) continue;
      const float den = knots[j + d] - knots[j];
      const float mag = den < 0.f ? -den : den;
      if (!(mag >= 0x1p-8f && mag <= 0x1p8f)) P.recip = 0;
      P.rcp[div_slot(j, d)] = 1.f / den;
    }
  }
  const int k1p = (nb + 4) / 4 * 4;
  int off = 0;
  long long slab = 0;
  int most_out = 0;
  for (int l = 0; l < n_layers; ++l) {
    P.ic[l] = plan[7 + l];
    if (P.ic[l] < 1) return false;
    P.feat[l] = off;
    off += nmax[l] * k1p * P.R;
    slab = max(slab, static_cast<long long>(min(P.ic[l], nmax[l])) * k1p *
                         dims[l + 1]);
    most_out = max(most_out, dims[l + 1]);
  }
  for (int l = 0; l < n_layers; ++l) {
    P.der[l] = off;
    if (bwd) off += nmax[l] * k1p * P.R;
  }
  if (slab > kSmemFloats) return false;
  for (int s = 0; s < 2; ++s) {
    P.slab[s] = off;
    off += static_cast<int>(slab);
  }
  for (int s = 0; s < 2; ++s) {
    P.part[s] = off;
    off += (P.R + 4) * most_out;
  }
  int most_slice = 0;
  for (int d = 1; d <= n_layers; ++d) most_slice = max(most_slice, nmax[d]);
  for (int s = 0; s < 2; ++s) {
    P.slice[s] = off;
    if (bwd) off += P.R * most_slice;
  }
  for (int l = 0; l < n_layers; ++l) {
    P.ga[l] = off;
    if (bwd) off += (P.R + 4) * dims[l + 1];
  }
  return off == plan[4] && off <= kSmemFloats;
}

// Launches kKernel on clusters clusters of P.C CTAs. The kernel's dynamic
// shared memory limit and its permission for a non-portable cluster size
// are set once per device. A failed call clears the runtime's last error,
// so that the next launch does not report it.
template <auto kKernel, typename... Args>
int launch_clusters(const Plan& P, int clusters, int threads,
                    int smem_floats, cudaStream_t stream, Args... args) {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  int e = static_cast<int>(cudaGetDevice(&dev));
  if (!e && !(dev < kMaxDevices && ready[dev])) {
    e = static_cast<int>(cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemFloats * static_cast<int>(sizeof(float))));
    if (!e) {
      e = static_cast<int>(cudaFuncSetAttribute(
          kKernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
    }
    if (!e && dev < kMaxDevices) ready[dev] = true;
  }
  if (e) {
    cudaGetLastError();
    return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * P.C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_floats) * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = static_cast<int>(cudaLaunchKernelEx(&cfg, kKernel, P, args...));
  const int last = static_cast<int>(cudaGetLastError());
  return e ? e : last;
}

// The instances of P's feature slots (K1P) with or without the head.
template <bool kHead>
int launch_fwd(const Plan& P, int smem_floats, cudaStream_t stream,
               const float* x, float* y) {
  const int k1p = (P.nb + 4) / 4 * 4;
  if (k1p == 4) {
    return launch_clusters<kan_module_fwd_kernel<4, kHead>>(
        P, P.groups, kFwdThreads, smem_floats, stream, x, y);
  }
  if (k1p == 8) {
    return launch_clusters<kan_module_fwd_kernel<8, kHead>>(
        P, P.groups, kFwdThreads, smem_floats, stream, x, y);
  }
  return launch_clusters<kan_module_fwd_kernel<12, kHead>>(
      P, P.groups, kFwdThreads, smem_floats, stream, x, y);
}

template <bool kHead>
int launch_bwd(const Plan& P, int clusters, int smem_floats,
               cudaStream_t stream, const float* x, const float* g,
               float* dx, const Grads& G) {
  const int k1p = (P.nb + 4) / 4 * 4;
  if (k1p == 4) {
    return launch_clusters<kan_module_bwd_kernel<4, kHead>>(
        P, clusters, kBwdThreads, smem_floats, stream, x, g, dx, G);
  }
  if (k1p == 8) {
    return launch_clusters<kan_module_bwd_kernel<8, kHead>>(
        P, clusters, kBwdThreads, smem_floats, stream, x, g, dx, G);
  }
  return launch_clusters<kan_module_bwd_kernel<12, kHead>>(
      P, clusters, kBwdThreads, smem_floats, stream, x, g, dx, G);
}

void set_weights(Plan& P, const void* const* params) {
  for (int l = 0; l < P.n_layers; ++l) {
    P.S[l] = static_cast<const float*>(params[3 * l]);
    P.W[l] = static_cast<const float*>(params[3 * l + 1]);
    P.bias[l] = static_cast<const float*>(params[3 * l + 2]);
  }
}

}  // namespace

extern "C" int kan_module_fwd(const float* x, const void* const* params,
                              float* y, int B, const int* dims, int n_layers,
                              const float* knots, int n_knots,
                              const int* plan, void* stream_ptr) {
  Plan P;
  if (!make_plan(P, B, dims, n_layers, knots, n_knots, plan, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  set_weights(P, params);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return P.head ? launch_fwd<true>(P, plan[4], stream, x, y)
                : launch_fwd<false>(P, plan[4], stream, x, y);
}

// partials: with plan[3] > 1 slots, plan[3] x (every gradient's size)
// floats of fp32 sums; unused (may be null) with one slot.
extern "C" int kan_module_bwd(const float* x, const float* g,
                              const void* const* params, float* dx,
                              void* const* grads, float* partials, int B,
                              const int* dims, int n_layers,
                              const float* knots, int n_knots,
                              const int* plan, void* stream_ptr) {
  Plan P;
  if (!make_plan(P, B, dims, n_layers, knots, n_knots, plan, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  set_weights(P, params);
  const int slots = P.slots;
  Grads G = {};
  Segments seg = {};
  seg.n = 3 * n_layers;
  for (int l = 0; l < n_layers; ++l) {
    const long long sizes[3] = {
        static_cast<long long>(dims[l]) * dims[l + 1] * P.nb,
        static_cast<long long>(dims[l + 1]) * dims[l], dims[l + 1]};
    for (int s = 0; s < 3; ++s) {
      seg.out[3 * l + s] = static_cast<float*>(grads[3 * l + s]);
      seg.off[3 * l + s + 1] = seg.off[3 * l + s] + sizes[s];
    }
  }
  if (slots > 1 && partials == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int s = 0; s < seg.n; ++s) {
    G.ptr[s] = slots > 1 ? partials + seg.off[s] : seg.out[s];
  }
  G.stride = slots > 1 ? seg.off[seg.n] : 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int e = 0;
  // Waves of at most slots clusters, in order on the stream: wave w takes
  // groups w slots .. w slots + slots - 1, so slot s sums groups s,
  // s + slots, ... in order.
  for (P.group0 = 0; !e && P.group0 < P.groups; P.group0 += slots) {
    P.first = P.group0 == 0;
    const int clusters = min(slots, P.groups - P.group0);
    e = P.head ? launch_bwd<true>(P, clusters, plan[4], stream, x, g, dx, G)
               : launch_bwd<false>(P, clusters, plan[4], stream, x, g, dx,
                                   G);
  }
  if (e || slots == 1) return e;
  const long long n = seg.off[seg.n];
  const int blocks = static_cast<int>(min((n + 255) / 256, 1024LL));
  kan_grad_reduce_kernel<<<blocks, 256, 0, stream>>>(partials, slots, seg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kan_module_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
