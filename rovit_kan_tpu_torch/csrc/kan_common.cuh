// The KAN kernels' limits of the shapes they take, the cubic B-spline basis
// and its derivative, and 3 * sigmoid's sigmoid. Its one includer is
// kan_module.cu (the whole head, #10/#11, and one layer, #8/#9).
//
// The basis is the recursion of ops/spline.py step by step: the half-open
// degree-0 intervals after a clamp of t to the knot range, zero-denominator
// guards, every step an _rn intrinsic, so that the compiler contracts none
// of them into an FMA the plain version does not do. The interval test
// compares t with the knots themselves (never index arithmetic), so t = 1
// (tanh of |x| >= 10) gives all-zero bases as the plain version does.
// The divisions go through a Div: IeeeDiv is __fdiv_rn; kan_module.cu also
// passes one that gives the same bits from a reciprocal table where that is
// proven (its note says when). Everything sits in an anonymous namespace.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 4;
constexpr int kMaxBasis = 10;
constexpr int kMaxKnots = kMaxBasis + 4;
constexpr int kMaxIn = 1024;        // widest layer input
constexpr int kMaxOut = 256;        // widest layer output

// The reciprocal slot of the denominator k[j + d] - k[j] of degree d.
__host__ __device__ constexpr int div_slot(int j, int d) {
  return (d - 1) * (kMaxBasis + 1) + j;
}
constexpr int kDivSlots = 3 * (kMaxBasis + 1);

// a / b as the recursion writes it. A Div's kDistinct says that the caller
// has checked that no two knots coincide, so no denominator is zero.
struct IeeeDiv {
  static constexpr bool kDistinct = false;
  __device__ __forceinline__ float operator()(float a, float b, int) const {
    return __fdiv_rn(a, b);
  }
};

// Basis values (and, with kDeriv, d/dt) at t of the nb bases on the knots
// k[0 .. nb + 4), unrolled to kMaxBasis with run-time guards; with kNB > 0
// the caller fixes nb = kNB at compile time and the guards on it vanish.
template <bool kDeriv, typename Div = IeeeDiv, int kNB = 0>
__device__ __forceinline__ void bspline(float t, int nb_arg, const float* k,
                                        float (&b)[kMaxBasis],
                                        float (&db)[kMaxBasis],
                                        Div div = Div()) {
  const int nb = kNB > 0 ? kNB : nb_arg;
  const int nk = nb + 4;
  const float lo = k[0];
  const float hi = k[nk - 1];
  const float in_range = (t >= lo && t <= hi) ? 1.f : 0.f;
  const float x = fminf(fmaxf(t, lo), hi);
#pragma unroll
  for (int i = 0; i < kMaxBasis; ++i) {
    b[i] = (i < nb && x >= k[i] && x < k[i + 1]) ? 1.f : 0.f;
    db[i] = 0.f;
  }
#pragma unroll
  for (int d = 1; d <= 3; ++d) {
    // Ascending i: the new b[i] reads the old b[i] and b[i + 1].
#pragma unroll
    for (int i = 0; i < kMaxBasis; ++i) {
      const float b1 = (i + 1 < kMaxBasis) ? b[i + 1] : 0.f;
      const float db1 = (i + 1 < kMaxBasis) ? db[i + 1] : 0.f;
      float term = 0.f;
      float dterm = 0.f;
      // The guards of ops/spline.py; with kNB and kDistinct they are
      // known at compile time, so the recursion is straight-line code.
      if (i < nb) {
        if (Div::kDistinct || k[i + d] != k[i]) {
          const float den = __fsub_rn(k[i + d], k[i]);
          const float left = div(__fsub_rn(x, k[i]), den, div_slot(i, d));
          term = __fmul_rn(left, b[i]);
          if (kDeriv) {
            dterm = __fadd_rn(div(b[i], den, div_slot(i, d)),
                              __fmul_rn(left, db[i]));
          }
        }
        if (i + d + 1 < nk && i + 1 < nb &&
            (Div::kDistinct || k[i + d + 1] != k[i + 1])) {
          const float den = __fsub_rn(k[i + d + 1], k[i + 1]);
          const float right =
              div(__fsub_rn(k[i + d + 1], x), den, div_slot(i + 1, d));
          term = __fadd_rn(term, __fmul_rn(right, b1));
          if (kDeriv) {
            const float b1_den = div(b1, den, div_slot(i + 1, d));
            dterm = __fadd_rn(__fsub_rn(dterm, b1_den),
                              __fmul_rn(right, db1));
          }
        }
      }
      b[i] = term;
      db[i] = dterm;
    }
  }
  if (kDeriv) {
#pragma unroll
    for (int i = 0; i < kMaxBasis; ++i) db[i] = __fmul_rn(db[i], in_range);
  }
}

__device__ __forceinline__ float sigmoid(float a) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-a)));
}

__device__ __forceinline__ float* shared_floats() {
  extern __shared__ float4 smem4[];
  return reinterpret_cast<float*>(smem4);
}

}  // namespace
