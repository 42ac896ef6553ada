// The port's host-side image preprocessing engine: a multithreaded uint8
// bilinear batch resize (NHWC, RGB) and the ImageNet normalization.
//
// The port's copy of rovit_kan_tpu/native/preprocess.cpp, with the same
// C ABI and the same arithmetic, so the dataset loads the reference's uint8
// pixels (data/resize.py is the same resize in numpy). One C call does a
// whole batch: ctypes releases the GIL for its duration and a std::thread
// pool fans out across the images.
//
// Resampling: separable bilinear with half-pixel centres (align_corners =
// False), no antialias, every intermediate in float32, rounded by adding
// 0.5 and truncating. The library is built with -ffp-contract=off
// (native/__init__.py): a contracted fused multiply-add in
// `top + fx * (...)` rounds once where the reference rounds twice, which
// moves some pixels by one.
//
// Exported C ABI (ctypes):
//   void resize_batch_u8(const uint8_t** srcs, const int64_t* src_hw,
//                        int64_t n, uint8_t* dst, int64_t dst_h,
//                        int64_t dst_w, int64_t n_threads);
//   void normalize_batch_u8(const uint8_t* src, float* dst, int64_t n,
//                           int64_t hw, const float* mean,
//                           const float* inv_std, int64_t n_threads);

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cmath>
#include <thread>
#include <vector>

namespace {

// Bilinear resize of one image.
void resize_image(const uint8_t* src, int64_t sh, int64_t sw,
                  uint8_t* dst, int64_t dh, int64_t dw) {
  const float scale_y = static_cast<float>(sh) / dh;
  const float scale_x = static_cast<float>(sw) / dw;

  // Precompute x-axis sample positions/weights once per image.
  std::vector<int64_t> x0(dw), x1(dw);
  std::vector<float> wx(dw);
  for (int64_t x = 0; x < dw; ++x) {
    float sx = (x + 0.5f) * scale_x - 0.5f;
    sx = std::max(0.0f, std::min(sx, static_cast<float>(sw - 1)));
    x0[x] = static_cast<int64_t>(sx);
    x1[x] = std::min(x0[x] + 1, sw - 1);
    wx[x] = sx - x0[x];
  }

  for (int64_t y = 0; y < dh; ++y) {
    float sy = (y + 0.5f) * scale_y - 0.5f;
    sy = std::max(0.0f, std::min(sy, static_cast<float>(sh - 1)));
    const int64_t y0 = static_cast<int64_t>(sy);
    const int64_t y1 = std::min(y0 + 1, sh - 1);
    const float fy = sy - y0;

    const uint8_t* row0 = src + y0 * sw * 3;
    const uint8_t* row1 = src + y1 * sw * 3;
    uint8_t* out = dst + y * dw * 3;

    for (int64_t x = 0; x < dw; ++x) {
      const float fx = wx[x];
      const int64_t a = x0[x] * 3, b = x1[x] * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = row0[a + c] + fx * (row0[b + c] - row0[a + c]);
        const float bot = row1[a + c] + fx * (row1[b + c] - row1[a + c]);
        const float v = top + fy * (bot - top);
        out[x * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

template <typename Fn>
void parallel_for(int64_t n, int64_t n_threads, Fn fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&] {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  const int64_t k = std::min<int64_t>(n_threads, n);
  std::vector<std::thread> threads;
  threads.reserve(k);
  for (int64_t t = 0; t < k; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// srcs: n pointers to (src_hw[2i], src_hw[2i+1], 3) uint8 RGB images.
// dst:  (n, dst_h, dst_w, 3) uint8 output batch.
void resize_batch_u8(const uint8_t** srcs, const int64_t* src_hw, int64_t n,
                     uint8_t* dst, int64_t dst_h, int64_t dst_w,
                     int64_t n_threads) {
  const int64_t out_stride = dst_h * dst_w * 3;
  parallel_for(n, n_threads, [&](int64_t i) {
    resize_image(srcs[i], src_hw[2 * i], src_hw[2 * i + 1],
                 dst + i * out_stride, dst_h, dst_w);
  });
}

// uint8 (n, H, W, 3) -> normalized float32 (x/255 - mean) * inv_std.
void normalize_batch_u8(const uint8_t* src, float* dst, int64_t n,
                        int64_t hw, const float* mean, const float* inv_std,
                        int64_t n_threads) {
  const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
  const float s0 = inv_std[0], s1 = inv_std[1], s2 = inv_std[2];
  parallel_for(n, n_threads, [&](int64_t i) {
    const uint8_t* in = src + i * hw * 3;
    float* out = dst + i * hw * 3;
    for (int64_t p = 0; p < hw; ++p) {
      out[p * 3 + 0] = (in[p * 3 + 0] * (1.0f / 255.0f) - m0) * s0;
      out[p * 3 + 1] = (in[p * 3 + 1] * (1.0f / 255.0f) - m1) * s1;
      out[p * 3 + 2] = (in[p * 3 + 2] * (1.0f / 255.0f) - m2) * s2;
    }
  });
}

}  // extern "C"
