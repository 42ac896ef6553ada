// The operand view and statistics layout that every softmax-attention
// route on Hopper (sm_90a) shares: HeadView, the stats index of the fp32
// block backward's attention stage (attention_fma.cuh) and the head widths
// every route takes. The routes: bf16 attention_mma.cuh (#5/#6 and the
// bf16 block kernels' attention stages), fp32 attention_tf32.cuh (#5/#6,
// and the forward stage of the fp32 block kernels #1, #3 and #2's
// recompute) and attention_fma.cuh (the fp32 block backward's attention
// stage, #2/#4).

#pragma once

#include "tile_common.cuh"

namespace {

// One operand of attention: element (b, h, n, d) at
// ptr[b * sb + h * sh + n * sr + d]. A head's row of hd values is
// contiguous, and ptr and every stride keep rows 16-byte aligned.
template <typename E>
struct HeadView {
  E* ptr;
  long long sb, sh, sr;
  __device__ E* row(int b, int h, int n) const {
    return ptr + b * sb + h * sh + n * sr;
  }
};

// stats: three planes of [B][heads][N] fp32 (attention_fma.cuh's row
// statistics, written by its query side and read by its key side).
__device__ __forceinline__ size_t stat_index(int b, int h, int n, int N) {
  return (static_cast<size_t>(b) * gridDim.y + h) * N + n;
}

// Head widths the attention stages take.
inline bool attention_head_ok(int hd) {
  return hd >= 16 && hd <= 128 && hd % 16 == 0;
}

}  // namespace
