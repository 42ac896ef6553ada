// Training augmentation in one pass on Hopper (sm_90a): uint8 (B, H, W, 3)
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
// What bounds it on an H100 SXM: at B=64, 224 x 224 it must read 9.6 MB of
// uint8 and write 38.5 MB of fp32, 48.2 MB in all: 0.0144 ms at 3.35 TB/s;
// its ~30 operations per pixel channel are far below the compute line. So
// it is bound by bytes. Two launches: the contrast pivot is a per-image
// reduction (flips do not change it), so a first launch with one CTA per
// image sums it, and a second, elementwise launch of (pixel tiles x B)
// CTAs keeps every SM busy and writes each output once.
//
// Interface: plain C, loaded with ctypes; returns the first CUDA error of
// either launch (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kPivotThreads = 1024;

__device__ const float kGray[3] = {0.299f, 0.587f, 0.114f};
__device__ const float kMean[3] = {0.485f, 0.456f, 0.406f};
__device__ const float kStd[3] = {0.229f, 0.224f, 0.225f};

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
__device__ __forceinline__ float bright(uint8_t u, float fb) {
  const float x = rnd<C>(__fmul_rn(static_cast<float>(u), 1.0f / 255.0f));
  return clip01(rnd<C>(__fmul_rn(x, fb)));
}

template <typename C>
__global__ void __launch_bounds__(kPivotThreads)
pivot_kernel(const uint8_t* __restrict__ images,
             const float* __restrict__ factors, float* __restrict__ pivot,
             int HW) {
  __shared__ float red[kPivotThreads / 32];
  const int img = blockIdx.x;
  const float fb = rnd<C>(factors[img * 8 + 2]);
  const uint8_t* src = images + static_cast<size_t>(img) * HW * 3;
  float wmean[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) wmean[c] = __fdiv_rn(kGray[c],
                                                   static_cast<float>(HW));
  float s = 0.f;
  for (int i = threadIdx.x; i < HW * 3; i += kPivotThreads) {
    s = __fadd_rn(s, __fmul_rn(bright<C>(src[i], fb), wmean[i % 3]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    s = red[threadIdx.x];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (threadIdx.x == 0) pivot[img] = rnd<C>(s);
  }
}

template <typename O>
__device__ __forceinline__ O store_as(float v) {
  if constexpr (std::is_same<O, bf16>::value) {
    return __float2bfloat16(v);
  } else {
    return v;
  }
}

template <typename C, typename O>
__global__ void __launch_bounds__(kThreads)
augment_kernel(const uint8_t* __restrict__ images,
               const float* __restrict__ factors,
               const float* __restrict__ pivot, O* __restrict__ out, int H,
               int W) {
  const int img = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= H * W) return;
  const float* f = factors + img * 8;
  const int y = p / W;
  const int x = p - y * W;
  const int sy = f[1] > 0.f ? H - 1 - y : y;
  const int sx = f[0] > 0.f ? W - 1 - x : x;
  const size_t base = static_cast<size_t>(img) * H * W * 3;
  const uint8_t* src = images + base + (static_cast<size_t>(sy) * W + sx) * 3;
  const float fb = rnd<C>(f[2]);
  const float fc = rnd<C>(f[3]);
  const float fs = rnd<C>(f[4]);
  const float pv = pivot[img];

  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float b = bright<C>(src[c], fb);
    v[c] = clip01(rnd<C>(__fadd_rn(
        rnd<C>(__fmul_rn(rnd<C>(__fsub_rn(b, pv)), fc)), pv)));
  }
  float gray = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gray = __fadd_rn(gray, __fmul_rn(v[c], rnd<C>(kGray[c])));
  }
  gray = rnd<C>(gray);
  O* dst = out + base + static_cast<size_t>(p) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float s = clip01(rnd<C>(__fadd_rn(
        rnd<C>(__fmul_rn(rnd<C>(__fsub_rn(v[c], gray)), fs)), gray)));
    dst[c] = store_as<O>(
        __fmul_rn(__fsub_rn(s, kMean[c]), __fdiv_rn(1.0f, kStd[c])));
  }
}

template <typename C, typename O>
int run(const void* images, const void* factors, void* out, void* pivot,
        int B, int H, int W, cudaStream_t stream) {
  pivot_kernel<C><<<B, kPivotThreads, 0, stream>>>(
      static_cast<const uint8_t*>(images), static_cast<const float*>(factors),
      static_cast<float*>(pivot), H * W);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  augment_kernel<C, O><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(images), static_cast<const float*>(factors),
      static_cast<const float*>(pivot), static_cast<O*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int augment_fwd(const void* images, const void* factors,
                           void* out, void* pivot, int B, int H, int W,
                           int bf16_compute, int bf16_out, void* stream_ptr) {
  if (B < 1 || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (bf16_compute) {
    return bf16_out ? run<bf16, bf16>(images, factors, out, pivot, B, H, W, s)
                    : run<bf16, float>(images, factors, out, pivot, B, H, W,
                                       s);
  }
  return bf16_out ? run<float, bf16>(images, factors, out, pivot, B, H, W, s)
                  : run<float, float>(images, factors, out, pivot, B, H, W, s);
}

extern "C" const char* augment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
