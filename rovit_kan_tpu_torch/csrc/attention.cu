// Attention alone on Hopper (sm_90a), bf16 or fp32: softmax(q k^T) v with q
// pre-scaled, forward and backward.
//
// Replaces rovit_kan_tpu/ops/attention.py::_attention_kernel (#5, the
// forward of fused_attention) and ::_attention_bwd_kernel (#6, its custom-VJP
// backward), with scale 1 (q comes pre-scaled, and the scale's own gradient
// comes from autograd of q * scale outside), over strided (B, heads, N, hd)
// views. The route is chosen by dtype:
//   bf16: attention_mma.cuh, mma.sync.m16n8k16 two-pass kernels with S, P,
//         dS and the accumulators in registers and a cp.async ring;
//   fp32: attention_tf32.cuh, the same design on 3xTF32 mma.sync.m16n8k8
//         products (each fp32 operand split into TF32 high and low parts,
//         three tensor-core products); the source notes say how.
// Rounding points are the TPU kernels':
//   forward:  S = q . k^T in fp32, softmax in fp32, P rounded to the input
//             type T, O = P . v accumulated and returned in fp32;
//   backward: g (fp32) is cast to T by the wrapper; dV = P^T . g with P
//             rounded, dP = g . V^T, dS = P * (dP - rowsum(P * dP)) with P
//             in fp32, rounded to T, dQ = dS . K, dK = dS^T . Q, all fp32
//             accumulated and stored once in T (the TPU kernel stores fp32
//             and casts to the input type after: the same single rounding).
// In fp32 nothing is rounded to T, and each product is 3xTF32 (about 2^-21
// relative per product against fp32's 2^-24).
// rowsum(P * dP) is summed per key tile as exp(S - m) * dP rescaled with the
// row max, then divided by the row sum l: P * dP summed in another order,
// not the dO . O identity, so it does not depend on O's rounding.
// The TPU kernels pad N to a multiple of 128 lanes and carry G heads per
// program for the TPU's layout; here the grid is (query or key tile, head,
// image) and the ragged edge is masked.
//
// What bounds them on an H100 SXM (989 TFLOP/s dense bf16, 495 TF32,
// 67 TFLOP/s fp32 FMA, 3.35 TB/s HBM), at (B, heads, N, hd) =
// (32, 3, 577, 64):
//   #5: 4 * B * heads * N^2 * hd = 8.18e9 FLOP, 8.3 us at the bf16 peak;
//       q, k, v in (bf16) and an fp32 out, 35.5 MB, 10.6 us at the HBM
//       rate: bytes-bound in bf16, about 10.6 us; in fp32 three TF32
//       products each, 49.6 us (122 us on the FMA units).
//   #6: five N x N x hd products (S again, dV, dP, dQ, dK),
//       10 * B * heads * N^2 * hd = 2.05e10 FLOP, 20.7 us; q, k, v (bf16)
//       and g (fp32) in, dq, dk, dv out in bf16, 56.7 MB, 16.9 us:
//       operations-bound, about 20.7 us; in fp32 124 us as 3xTF32.
// Both recompute S (the forward twice, the backward three times) to keep
// P normalized in fp32 before it is rounded; S, P and dS stay in registers.
// wgmma and TMA come later.
//
// Interface: plain C, loaded with ctypes. q, k, v are read through strides
// (elements; the last dimension contiguous); out, g, dq, dk, dv are
// contiguous (B, heads, N, hd); stats is 3 * B * heads * N fp32 of scratch.
// Each entry returns the first CUDA error (0 = success), checked after every
// launch; a shape it does not take returns cudaErrorInvalidValue before any
// launch. Nothing is allocated here and nothing synchronises.

#include "attention_common.cuh"
#include "attention_mma.cuh"
#include "attention_tf32.cuh"

namespace {

struct Strides {
  long long sb, sh, sr;
};

template <typename E>
HeadView<E> strided(E* ptr, Strides s) {
  return {ptr, s.sb, s.sh, s.sr};
}

template <typename E>
HeadView<E> dense(E* ptr, int heads, int N, int hd) {
  return {ptr, static_cast<long long>(heads) * N * hd,
          static_cast<long long>(N) * hd, hd};
}

bool attention_shape_ok(int B, int heads, int N, int hd) {
  return B >= 1 && heads >= 1 && N >= 1 && attention_head_ok(hd);
}

template <typename T>
int run_fwd(const void* q, const void* k, const void* v, void* out, int B,
            int heads, int N, int hd, Strides sq, Strides sk, Strides sv,
            void* stream) {
  if (!attention_shape_ok(B, heads, N, hd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (std::is_same<T, bf16>::value) {
    return static_cast<int>(launch_attention_fwd_mma<float, false>(
        strided(static_cast<const T*>(q), sq),
        strided(static_cast<const T*>(k), sk),
        strided(static_cast<const T*>(v), sv),
        dense(static_cast<float*>(out), heads, N, hd), B, heads, N, hd, 1.0f,
        static_cast<cudaStream_t>(stream)));
  } else {
    return static_cast<int>(launch_attention_fwd_tf32<T, false>(
        strided(static_cast<const T*>(q), sq),
        strided(static_cast<const T*>(k), sk),
        strided(static_cast<const T*>(v), sv),
        dense(static_cast<float*>(out), heads, N, hd), B, heads, N, hd, 1.0f,
        static_cast<cudaStream_t>(stream)));
  }
}

template <typename T>
int run_bwd(const void* q, const void* k, const void* v, const void* g,
            void* dq, void* dk, void* dv, void* stats, int B, int heads,
            int N, int hd, Strides sq, Strides sk, Strides sv, void* stream) {
  if (!attention_shape_ok(B, heads, N, hd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (std::is_same<T, bf16>::value) {
    return static_cast<int>(launch_attention_bwd_mma(
        strided(static_cast<const T*>(q), sq),
        strided(static_cast<const T*>(k), sk),
        strided(static_cast<const T*>(v), sv),
        dense(static_cast<const T*>(g), heads, N, hd),
        dense(static_cast<T*>(dq), heads, N, hd),
        dense(static_cast<T*>(dk), heads, N, hd),
        dense(static_cast<T*>(dv), heads, N, hd), static_cast<float*>(stats),
        B, heads, N, hd, static_cast<cudaStream_t>(stream)));
  } else {
    return static_cast<int>(launch_attention_bwd_tf32<T>(
        strided(static_cast<const T*>(q), sq),
        strided(static_cast<const T*>(k), sk),
        strided(static_cast<const T*>(v), sv),
        dense(static_cast<const T*>(g), heads, N, hd),
        dense(static_cast<T*>(dq), heads, N, hd),
        dense(static_cast<T*>(dk), heads, N, hd),
        dense(static_cast<T*>(dv), heads, N, hd), static_cast<float*>(stats),
        B, heads, N, hd, static_cast<cudaStream_t>(stream)));
  }
}

}  // namespace

#define ATTN_STRIDE_ARGS                                                    \
  long long q_sb, long long q_sh, long long q_sr, long long k_sb,           \
      long long k_sh, long long k_sr, long long v_sb, long long v_sh,       \
      long long v_sr
#define ATTN_STRIDES                                                        \
  Strides{q_sb, q_sh, q_sr}, Strides{k_sb, k_sh, k_sr},                     \
      Strides{v_sb, v_sh, v_sr}

extern "C" int attention_fwd_bf16(const void* q, const void* k,
                                  const void* v, void* out, int B, int heads,
                                  int N, int hd, ATTN_STRIDE_ARGS,
                                  void* stream) {
  return run_fwd<bf16>(q, k, v, out, B, heads, N, hd, ATTN_STRIDES, stream);
}

extern "C" int attention_fwd_f32(const void* q, const void* k, const void* v,
                                 void* out, int B, int heads, int N, int hd,
                                 ATTN_STRIDE_ARGS, void* stream) {
  return run_fwd<float>(q, k, v, out, B, heads, N, hd, ATTN_STRIDES, stream);
}

extern "C" int attention_bwd_bf16(const void* q, const void* k,
                                  const void* v, const void* g, void* dq,
                                  void* dk, void* dv, void* stats, int B,
                                  int heads, int N, int hd, ATTN_STRIDE_ARGS,
                                  void* stream) {
  return run_bwd<bf16>(q, k, v, g, dq, dk, dv, stats, B, heads, N, hd,
                       ATTN_STRIDES, stream);
}

extern "C" int attention_bwd_f32(const void* q, const void* k, const void* v,
                                 const void* g, void* dq, void* dk, void* dv,
                                 void* stats, int B, int heads, int N, int hd,
                                 ATTN_STRIDE_ARGS, void* stream) {
  return run_bwd<float>(q, k, v, g, dq, dk, dv, stats, B, heads, N, hd,
                        ATTN_STRIDES, stream);
}

extern "C" const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
