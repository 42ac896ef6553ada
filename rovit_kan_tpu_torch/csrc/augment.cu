// Training augmentation in one launch on Hopper (sm_90a): uint8 (B, H, W, 3)
// images plus (B, 8) per-image factors -> ImageNet-normalized (B, H, W, 3)
// in fp32 or bf16.
//
// Replaces rovit_kan_tpu/ops/augment_kernel.py::_augment_kernel. Per image:
//   x = u8 / 255 (rounded to the compute type C) -> h-flip, v-flip ->
//   x = clip(x * fb) -> pivot = sum(x * w_c / (H W)) in fp32, rounded to C ->
//   x = clip((x - pivot) * fc + pivot) -> gray = sum_c x_c * round_C(w_c)
//   in fp32, rounded to C -> x = clip((x - gray) * fs + gray) ->
//   (x - mean_c) / std_c in fp32
// with every blend computed op by op in C (each product and sum rounded),
// as the TPU kernel and the plain version (ops/augment_kernel.py) do. The
// TPU kernel turns the flips and the grayscale into matmuls with constant
// matrices because Mosaic has no lane reversal; here a flip is index math
// and the grayscale a three-term sum. Products and sums use the _rn
// intrinsics, so the compiler contracts nothing into an FMA that the plain
// version does not do.
//
// What bounds it on an H100 SXM: at B = 64, 224 x 224 it must read 9.6 MB
// of uint8 and write 38.5 MB of fp32, 48.2 MB in all: 0.0144 ms at
// 3.35 TB/s (70.8 MB and 0.0211 ms at B = 32, 384 x 384). Its ~30
// operations per pixel channel are below the compute line, so it is bound
// by bytes, and the design reads each image from device memory once and
// writes each output once, in one launch:
// - A thread-block cluster of C CTAs takes one image (the host's plan,
//   ops/augment_kernel.py::augment_plan: C = 8 where a CTA's band fits the
//   shared memory that keeps five CTAs on an SM, as at 224 px, else 16, as
//   at 384 px). Rank j owns the output rows [j H / C, (j + 1) H / C). A
//   vertical flip maps them onto one contiguous band of source rows, which
//   the CTA copies into shared memory by one bulk copy (cp.async.bulk,
//   completion on an mbarrier) where its address and length are multiples
//   of 16 bytes (every band's when W * 3 is a multiple of 16, as at 224 and
//   384 px, and the images' address is), else by 4-byte or 1-byte loads. A
//   band larger than the plan's chunk (past 512 px) is walked in chunks,
//   read once for the sum and again, from L2, for the output, the last
//   chunk kept for the second walk.
// - The pivot is deterministic without atomics or scratch: each CTA sums
//   its source band (flips permute pixels within a channel, so the bands'
//   sums add up to the image's) in one fixed order, per-thread strided
//   partials, a warp shuffle tree, then the warps in order; after a cluster
//   barrier every CTA reads the C partials through distributed shared
//   memory and adds them in rank order, so every CTA holds the same bits
//   and a repeated call gives them again.
// - x after the brightness, and after the contrast blend, is a function of
//   the byte alone, so each CTA tabulates both over the 256 byte values
//   (the same operations, so the same bits) and looks them up: the per-
//   pixel work is the grayscale, the saturation blend and the
//   normalization.
// - The output band is contiguous. A thread computes G pixels (4 in fp32,
//   8 in bf16: 48 bytes); a warp stages its 32 groups in shared memory and
//   copies them out in 16-byte streaming stores, each store instruction
//   writing 512 contiguous bytes (a thread's own three 16-byte stores
//   would touch 12 cache lines apiece). The ragged ends of a band go out
//   in scalars. 48 registers a thread keep five CTAs on an SM, so that
//   every cluster of the batch is resident at once.
//
// Interface: plain C, loaded with ctypes; returns the launch's CUDA error
// (0 = success), cudaErrorInvalidValue for a shape or plan it does not take.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
// A chunk's shared memory at most (ops/augment_kernel.py::SMEM_BUDGET).
constexpr int kSmemBudget = 96 * 1024;
// A warp's output staging: 32 groups of 48 bytes (ops/augment_kernel.py::
// STAGE_BYTES is kWarps of them).
constexpr int kStage = 32 * 48;
constexpr int kMaxDevices = 64;

__device__ const float kGray[3] = {0.299f, 0.587f, 0.114f};
__device__ const float kMean[3] = {0.485f, 0.456f, 0.406f};
__device__ const float kStd[3] = {0.229f, 0.224f, 0.225f};

struct Plan {
  int B, H, W;
  int C;                 // CTAs a cluster, one cluster an image
  int chunk_rows;        // output rows a chunk (1 when chunk_cols < W)
  int chunk_cols;        // output columns a chunk
  int smem;              // dynamic shared bytes a CTA: chunk, then staging
};

// One chunk of a band: the output pixels [q0, q0 + n) of the image (row-
// major, contiguous) and the first source pixel ps0 of their source, which
// is contiguous too (whole rows, or part of one row).
struct Chunk {
  long long q0, ps0;
  int n;
};

// Chunk k of the band [r0, r1), as ops/augment_kernel.py::band_chunks.
__device__ __forceinline__ Chunk chunk_at(const Plan& P, int r0, int r1,
                                          int k, bool hflip, bool vflip) {
  const int ncol = (P.W + P.chunk_cols - 1) / P.chunk_cols;
  const int y0 = r0 + (k / ncol) * P.chunk_rows;
  const int y1 = min(y0 + P.chunk_rows, r1);
  const int x0 = (k % ncol) * P.chunk_cols;
  const int x1 = min(x0 + P.chunk_cols, P.W);
  const int sy0 = vflip ? P.H - y1 : y0;
  const int sx0 = hflip ? P.W - x1 : x0;
  Chunk c;
  c.q0 = static_cast<long long>(y0) * P.W + x0;
  c.ps0 = static_cast<long long>(sy0) * P.W + sx0;
  c.n = (y1 - y0) * (x1 - x0);
  return c;
}

__device__ __forceinline__ int n_chunks(const Plan& P, int r0, int r1) {
  const int ncol = (P.W + P.chunk_cols - 1) / P.chunk_cols;
  return (r1 - r0 + P.chunk_rows - 1) / P.chunk_rows * ncol;
}

// The value rounded to the compute type C, held as a float.
template <typename C>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (std::is_same<C, bf16>::value) {
    return __bfloat162float(__float2bfloat16(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

// u8 -> /255 in C -> brightness in C, clipped: the value the pivot sums.
template <typename C>
__device__ __forceinline__ float bright(int u, float fb) {
  const float x = rnd<C>(__fmul_rn(static_cast<float>(u), 1.0f / 255.0f));
  return clip01(rnd<C>(__fmul_rn(x, fb)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// Copies chunk c's source bytes into band, by one bulk copy where their
// address and length are multiples of 16; every thread returns once they
// are there. phase is the mbarrier's parity, flipped per bulk copy.
__device__ __forceinline__ void load_chunk(uint8_t* band, const uint8_t* src,
                                           const Chunk& c, uint64_t* bar,
                                           uint32_t& phase) {
  const uint8_t* g = src + c.ps0 * 3;
  const int nbytes = c.n * 3;
  if (((reinterpret_cast<uintptr_t>(g) | nbytes) & 15) == 0) {
    const uint32_t b = smem_addr(bar);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(b), "r"(nbytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          :: "r"(smem_addr(band)), "l"(g), "r"(nbytes), "r"(b)
          : "memory");
    }
    while (!mbar_try_wait(b, phase)) {
    }
    phase ^= 1u;
    return;
  }
  if ((reinterpret_cast<uintptr_t>(g) & 3) == 0) {
    const int nw = nbytes >> 2;
    for (int i = threadIdx.x; i < nw; i += kThreads) {
      reinterpret_cast<uint32_t*>(band)[i] =
          reinterpret_cast<const uint32_t*>(g)[i];
    }
    for (int i = 4 * nw + threadIdx.x; i < nbytes; i += kThreads) {
      band[i] = g[i];
    }
  } else {
    for (int i = threadIdx.x; i < nbytes; i += kThreads) band[i] = g[i];
  }
  __syncthreads();
}

template <typename O>
__device__ __forceinline__ O store_as(float v) {
  if constexpr (std::is_same<O, bf16>::value) {
    return __float2bfloat16(v);
  } else {
    return v;
  }
}

// 3 G values (G pixels) as three 16-byte words at d.
template <typename O>
__device__ __forceinline__ void pack_group(uint4* d, const float* v) {
  if constexpr (std::is_same<O, bf16>::value) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        __nv_bfloat162 h = __floats2bfloat162_rn(v[8 * s + 2 * i],
                                                 v[8 * s + 2 * i + 1]);
        w[i] = *reinterpret_cast<uint32_t*>(&h);
      }
      d[s] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      d[s] = make_uint4(__float_as_uint(v[4 * s]), __float_as_uint(v[4 * s + 1]),
                        __float_as_uint(v[4 * s + 2]),
                        __float_as_uint(v[4 * s + 3]));
    }
  }
}

// Constants of the per-pixel chain, in registers.
struct Pixel {
  float fs, wg[3], mean[3], istd[3];
};

// The grayscale, saturation blend and normalization of one pixel whose
// three bytes are at px, from the contrast table xc.
template <typename C>
__device__ __forceinline__ void pixel(const Pixel& k, const float* xc,
                                      const uint8_t* px, float* o) {
  const float v[3] = {xc[px[0]], xc[px[1]], xc[px[2]]};
  float gray = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) gray = __fadd_rn(gray, __fmul_rn(v[c], k.wg[c]));
  gray = rnd<C>(gray);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float s = clip01(rnd<C>(__fadd_rn(
        rnd<C>(__fmul_rn(rnd<C>(__fsub_rn(v[c], gray)), k.fs)), gray)));
    o[c] = __fmul_rn(__fsub_rn(s, k.mean[c]), k.istd[c]);
  }
}

// A chunk's output pixels, in global order: aligned groups of G through
// the warp's staging buffer, the ragged ends in scalars. The output is the
// wrapper's own allocation, 16-byte aligned.
template <typename C, typename O>
__device__ __forceinline__ void write_pixels(const Pixel& k, const float* xc,
                                             const uint8_t* band,
                                             uint4* stage, O* out,
                                             long long img0, const Chunk& c,
                                             int H, int W, bool hflip,
                                             bool vflip) {
  constexpr int G = 16 / sizeof(O);
  // Global pixel indices: [p0, a0) and [a1, p1) in scalars, [a0, a1) in
  // aligned groups of G.
  const long long p0 = img0 + c.q0;
  const long long p1 = p0 + c.n;
  long long a0 = (p0 + G - 1) / G * G;
  long long a1 = p1 / G * G;
  if (a0 > a1) a0 = a1 = p1;
  const int ng = static_cast<int>((a1 - a0) / G);
  const int lane = threadIdx.x & 31;
  for (int g0 = threadIdx.x - lane; g0 < ng; g0 += kThreads) {
    const int g = g0 + lane;
    if (g < ng) {
      const long long q = a0 + static_cast<long long>(g) * G - img0;
      int y = static_cast<int>(q / W);
      int x = static_cast<int>(q - static_cast<long long>(y) * W);
      float v[3 * G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int sy = vflip ? H - 1 - y : y;
        const int sx = hflip ? W - 1 - x : x;
        const int off = static_cast<int>(
            (static_cast<long long>(sy) * W + sx - c.ps0) * 3);
        pixel<C>(k, xc, band + off, v + 3 * j);
        if (++x == W) {
          x = 0;
          ++y;
        }
      }
      pack_group<O>(stage + 3 * lane, v);
    }
    __syncwarp();
    // The warp's groups g0.. are 48 * min(32, ng - g0) contiguous bytes.
    uint4* dst = reinterpret_cast<uint4*>(
        out + (a0 + static_cast<long long>(g0) * G) * 3);
    const int nv = 3 * min(32, ng - g0);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int j = lane + 32 * i;
      if (j < nv) __stcs(dst + j, stage[j]);
    }
    __syncwarp();
  }
  const int nhead = static_cast<int>(a0 - p0);
  const int nends = nhead + static_cast<int>(p1 - a1);
  for (int i = threadIdx.x; i < nends; i += kThreads) {
    const long long pg = i < nhead ? p0 + i : a1 + (i - nhead);
    const long long q = pg - img0;
    const int y = static_cast<int>(q / W);
    const int x = static_cast<int>(q - static_cast<long long>(y) * W);
    const int sy = vflip ? H - 1 - y : y;
    const int sx = hflip ? W - 1 - x : x;
    const int off = static_cast<int>(
        (static_cast<long long>(sy) * W + sx - c.ps0) * 3);
    float v[3];
    pixel<C>(k, xc, band + off, v);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[pg * 3 + ch] = store_as<O>(v[ch]);
  }
}

template <typename C, typename O>
__global__ void __launch_bounds__(kThreads, 5)
augment_cluster_kernel(const uint8_t* __restrict__ images,
                       const float* __restrict__ factors, O* __restrict__ out,
                       const Plan P) {
  extern __shared__ __align__(128) uint8_t band[];
  __shared__ float lut[4][256];   // bright(u) w_c / (H W) by channel; xc(u)
  __shared__ float red[kWarps];
  __shared__ float part;
  __shared__ __align__(8) uint64_t bar;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int img = blockIdx.x / P.C;
  const long long HW = static_cast<long long>(P.H) * P.W;
  const float* f = factors + img * 8;
  const bool hflip = f[0] > 0.f;
  const bool vflip = f[1] > 0.f;
  const float fb = rnd<C>(f[2]);
  const float fc = rnd<C>(f[3]);
  Pixel k;
  k.fs = rnd<C>(f[4]);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    k.wg[c] = rnd<C>(kGray[c]);
    k.mean[c] = kMean[c];
    k.istd[c] = __fdiv_rn(1.0f, kStd[c]);
  }
  const uint8_t* src = images + img * HW * 3;
  const int r0 = static_cast<int>(static_cast<long long>(rank) * P.H / P.C);
  const int r1 =
      static_cast<int>(static_cast<long long>(rank + 1) * P.H / P.C);
  const int nk = n_chunks(P, r0, r1);
  uint4* stage = reinterpret_cast<uint4*>(band + P.smem - kWarps * kStage) +
                 (threadIdx.x >> 5) * (kStage / 16);

  float wmean[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    wmean[c] = __fdiv_rn(kGray[c], static_cast<float>(HW));
  }
  for (int u = threadIdx.x; u < 256; u += kThreads) {
    const float b = bright<C>(u, fb);
#pragma unroll
    for (int c = 0; c < 3; ++c) lut[c][u] = __fmul_rn(b, wmean[c]);
  }
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(&bar)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Pass 1: this band's share of the pivot. Word i of a chunk holds bytes
  // 4i..4i+3, of channels (i + b) % 3 (a chunk starts at a pixel).
  uint32_t phase = 0;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kc = 0; kc < nk; ++kc) {
    if (kc) __syncthreads();          // every thread done with the last one
    const Chunk c = chunk_at(P, r0, r1, kc, hflip, vflip);
    load_chunk(band, src, c, &bar, phase);
    const int nbytes = c.n * 3;
    const int nw = nbytes >> 2;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(band);
    int ch = threadIdx.x % 3;
    for (int i = threadIdx.x; i < nw; i += kThreads) {
      const uint32_t w = words[i];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        int cb = ch + b;
        cb = cb >= 3 ? cb - 3 : cb;
        cb = cb >= 3 ? cb - 3 : cb;
        acc[b] = __fadd_rn(acc[b], lut[cb][(w >> (8 * b)) & 0xffu]);
      }
      ch += kThreads % 3;
      ch = ch >= 3 ? ch - 3 : ch;
    }
    const int i = 4 * nw + threadIdx.x;
    if (i < nbytes) acc[0] = __fadd_rn(acc[0], lut[i % 3][band[i]]);
  }
  float s = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float p = red[0];
    for (int w = 1; w < kWarps; ++w) p = __fadd_rn(p, red[w]);
    part = p;
  }
  cluster.sync();                     // every rank's partial is written
  float total = 0.f;
  for (int q = 0; q < P.C; ++q) {
    total = __fadd_rn(total, *cluster.map_shared_rank(&part, q));
  }
  const float pv = rnd<C>(total);
  // Done with the other ranks' shared memory; the matching wait is at the
  // end, so no CTA leaves while another still reads its partial.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  for (int u = threadIdx.x; u < 256; u += kThreads) {
    const float b = bright<C>(u, fb);
    lut[3][u] = clip01(rnd<C>(__fadd_rn(
        rnd<C>(__fmul_rn(rnd<C>(__fsub_rn(b, pv)), fc)), pv)));
  }
  __syncthreads();

  // Pass 2: the outputs, chunks in reverse order, so the chunk pass 1 left
  // in shared memory is written first.
  const float* xc = lut[3];
  for (int kc = nk - 1; kc >= 0; --kc) {
    const Chunk c = chunk_at(P, r0, r1, kc, hflip, vflip);
    if (kc != nk - 1) {
      __syncthreads();
      load_chunk(band, src, c, &bar, phase);
    }
    write_pixels<C, O>(k, xc, band, stage, out, img * HW, c, P.H, P.W,
                       hflip, vflip);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Launches the kernel on B clusters of P.C CTAs. Its dynamic shared memory
// limit and its permission for a cluster past 8 CTAs are set once per
// device; a failed call clears the runtime's last error, so that the next
// launch does not report it.
template <typename C, typename O>
int launch(const Plan& P, const void* images, const void* factors, void* out,
           cudaStream_t stream) {
  auto kernel = augment_cluster_kernel<C, O>;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  int e = static_cast<int>(cudaGetDevice(&dev));
  if (!e && !(dev < kMaxDevices && ready[dev])) {
    e = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBudget + kWarps * kStage));
    if (!e) {
      e = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
    }
    if (!e && dev < kMaxDevices) ready[dev] = true;
  }
  if (e) {
    cudaGetLastError();
    return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.B * P.C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(P.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const uint8_t*>(images),
      static_cast<const float*>(factors), static_cast<O*>(out), P));
  const int last = static_cast<int>(cudaGetLastError());
  return e ? e : last;
}

// The plan's checks: what the kernel's indexing assumes.
bool valid(const Plan& P) {
  if (P.B < 1 || P.H < 1 || P.W < 1 || P.C < 1 || P.C > kMaxCluster ||
      static_cast<long long>(P.B) * P.C > INT_MAX) {
    return false;
  }
  if (P.chunk_cols < 1 || P.chunk_cols > P.W || P.chunk_rows < 1 ||
      (P.chunk_cols < P.W && P.chunk_rows != 1)) {
    return false;
  }
  const long long band = (3LL * P.chunk_rows * P.chunk_cols + 15) / 16 * 16;
  return band <= kSmemBudget && P.smem == band + kWarps * kStage;
}

}  // namespace

extern "C" int augment_fwd(const void* images, const void* factors,
                           void* out, int B, int H, int W, int bf16_compute,
                           int bf16_out, int cluster, int chunk_rows,
                           int chunk_cols, int smem, void* stream_ptr) {
  const Plan P = {B, H, W, cluster, chunk_rows, chunk_cols, smem};
  if (!valid(P)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (bf16_compute) {
    return bf16_out ? launch<bf16, bf16>(P, images, factors, out, s)
                    : launch<bf16, float>(P, images, factors, out, s);
  }
  return bf16_out ? launch<float, bf16>(P, images, factors, out, s)
                  : launch<float, float>(P, images, factors, out, s);
}

extern "C" const char* augment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
