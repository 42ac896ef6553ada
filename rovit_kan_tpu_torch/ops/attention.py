"""Attention alone: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``rovit_kan_tpu/ops/attention.py::fused_attention`` and its
custom VJP: ``softmax(q k^T) v`` over ``(B, heads, N, head_dim)`` with q
already multiplied by ``head_dim ** -0.5``. The TPU kernels
``_attention_kernel`` (#5) and ``_attention_bwd_kernel`` (#6) are replaced
on Hopper by ``csrc/attention.cu``: in bf16 the mma.sync kernels of
``csrc/attention_mma.cuh`` (whose forward the bf16 block kernels share), in
fp32 the same design on 3xTF32 mma.sync products in
``csrc/attention_tf32.cuh``; the source notes there say what bounds them
and how they are tiled.

Rounding points are the TPU kernels': S and the softmax in fp32, P rounded
to the input dtype before ``P v``, every product accumulated in fp32, the
forward's output fp32 (the caller casts). On the card an fp32 product is
three TF32 tensor-core products of the operands' high and low parts (about
2^-21 relative per product, where fp32 keeps 2^-24); the plain versions
here are true fp32. The backward casts the fp32
cotangent to the input dtype, recomputes P, and returns dq, dk, dv in the
input dtype: ``dV = P_lo^T g``, ``dP = g V^T``,
``dS = P (dP - rowsum(P dP))`` rounded, ``dQ = dS K``, ``dK = dS^T Q``, with
no scale on dS (the scale's own gradient comes from autograd of
``q * scale`` outside).

Under autograd the call is ``FusedAttention``, which saves only q, k and v.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

#: Launches of the CUDA attention forward (#5) since import, one per wrapper
#: call on a CUDA tensor. The CPU path never touches it.
LAUNCHES = 0
#: Launches of the CUDA attention backward (#6), counted the same way.
BWD_LAUNCHES = 0

MAX_HEAD_DIM = 128


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: operands upcast exactly,
    S and the softmax in fp32, P rounded to q's dtype, fp32 output."""
    f32 = torch.float32
    s = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    return torch.matmul(p.to(f32), v.to(f32))


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, g: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Plain PyTorch version of the backward kernel, rounding where
    ``_attention_bwd_kernel`` does: g cast to the input dtype, P fp32 in dS
    and rounded in dV, dS rounded before its products. Returns dq, dk, dv
    in the input dtype."""
    cd = q.dtype
    f32 = torch.float32

    def up(t):                           # rounded to cd, then exact in fp32
        return t.to(cd).to(f32)

    qf, kf, vf, gf = up(q), up(k), up(v), up(g)
    s = torch.matmul(qf, kf.transpose(-1, -2))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)                      # fp32
    dv = torch.matmul(up(p).transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = up(p * (dp - (p * dp).sum(dim=-1, keepdim=True)))
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(cd), dk.to(cd), dv.to(cd)


def _check_cuda_args(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> None:
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_attention takes bf16 or fp32, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} must match q: want {tuple(q.shape)} {q.dtype} on "
                f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if q.dim() != 4 or min(q.shape) < 1:
        raise ValueError(f"q, k, v must be (B, heads, N, head_dim), got "
                         f"shape {tuple(q.shape)}")
    hd = q.shape[-1]
    if hd % 16 or hd > MAX_HEAD_DIM:
        raise ValueError(f"unsupported head_dim {hd}: the kernel needs a "
                         f"multiple of 16 up to {MAX_HEAD_DIM}")


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it: the last dimension contiguous, the
    pointer and the other strides 16-byte aligned (a view of the model's qkv
    buffer qualifies); otherwise a contiguous copy."""
    size = t.element_size()
    ok = t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        n == 1 or (s * size) % 16 == 0
        for n, s in zip(t.shape[:3], t.stride()[:3]))
    return t if ok else t.contiguous()


_STRIDES = [ctypes.c_longlong] * 9
_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + _STRIDES \
    + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + _STRIDES \
    + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _library():
    from rovit_kan_tpu_torch.ops import _build
    lib = _build.load("attention")
    for suffix in ("bf16", "f32"):
        for kind, argtypes in (("fwd", _FWD_ARGTYPES),
                               ("bwd", _BWD_ARGTYPES)):
            fn = getattr(lib, f"attention_{kind}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.attention_error_string.argtypes = [ctypes.c_int]
    lib.attention_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, what: str, shape) -> None:
    if rc != 0:
        msg = _library().attention_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg}) "
                           f"at (B, heads, N, head_dim)={tuple(shape)}")


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def _launch(q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    _check_cuda_args(q, k, v)
    q, k, v = (_kernel_view(t) for t in (q, k, v))
    B, h, N, hd = q.shape
    suffix = "bf16" if q.dtype == torch.bfloat16 else "f32"
    with torch.cuda.device(q.device):
        out = torch.empty((B, h, N, hd), dtype=torch.float32,
                          device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(_library(), f"attention_fwd_{suffix}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, h, N, hd, *_strides(q, k, v), stream)
    _raise_on(rc, "attention_fwd", q.shape)
    LAUNCHES += 1
    return out


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    global BWD_LAUNCHES
    _check_cuda_args(q, k, v)
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(f"g must be a {tuple(q.shape)} tensor on "
                         f"{q.device}, got {tuple(g.shape)} on {g.device}")
    q, k, v = (_kernel_view(t) for t in (q, k, v))
    B, h, N, hd = q.shape
    suffix = "bf16" if q.dtype == torch.bfloat16 else "f32"
    with torch.cuda.device(q.device):
        gb = g.to(q.dtype).contiguous()     # the TPU kernel's cast of g
        dq, dk, dv = (torch.empty((B, h, N, hd), dtype=q.dtype,
                                  device=q.device) for _ in range(3))
        stats = torch.empty(3 * B * h * N, dtype=torch.float32,
                            device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(_library(), f"attention_bwd_{suffix}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gb.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            B, h, N, hd, *_strides(q, k, v), stream)
    _raise_on(rc, "attention_bwd", q.shape)
    BWD_LAUNCHES += 1
    return dq, dk, dv


def _forward(q, k, v, plain: bool) -> torch.Tensor:
    if q.device.type == "cpu" or plain:
        return attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda, got "
                         f"{q.device}")
    return _launch(q, k, v)


def _backward(q, k, v, g, plain: bool):
    if q.device.type == "cpu" or plain:
        return attention_backward_reference(q, k, v, g)
    return _launch_bwd(q, k, v, g)


class FusedAttention(torch.autograd.Function):
    """Attention under autograd: ``apply(q, k, v, plain)``. The forward
    saves q, k and v and nothing else; the backward recomputes P (kernel #6
    on the card, its plain version on the CPU or when ``plain``)."""

    @staticmethod
    def forward(ctx, q, k, v, plain):
        ctx.save_for_backward(q, k, v)
        ctx.plain = plain
        return _forward(q, k, v, plain)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, g, ctx.plain)
        return dq, dk, dv, None


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def fused_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Softmax attention ``softmax(q k^T) v`` with q pre-scaled.

    Args:
        q, k, v: ``(B, heads, N, head_dim)``, bf16 or fp32, one dtype;
            q already multiplied by ``head_dim ** -0.5``.

    Returns:
        ``(B, heads, N, head_dim)`` in fp32. A CPU tensor runs the plain
        versions; a CUDA tensor launches the kernels or raises. When grad is
        enabled and an input needs it, the call goes through
        ``FusedAttention``.
    """
    if _needs_grad(q, k, v):
        return FusedAttention.apply(q, k, v, False)
    return _forward(q, k, v, plain=False)


def plain_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """``fused_attention`` through the plain versions on any device, forward
    and backward: the yardstick that the kernels are held against."""
    if _needs_grad(q, k, v):
        return FusedAttention.apply(q, k, v, True)
    return _forward(q, k, v, plain=True)
