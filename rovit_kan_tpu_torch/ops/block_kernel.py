"""Whole-ViT-block forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``rovit_kan_tpu/ops/block_kernel.py::fused_vit_block``, whose
TPU kernel ``_vit_block_kernel`` is replaced on Hopper by
``csrc/vit_block_fwd.cu`` (the source note there says what bounds it and how
it is tiled). One pre-LN block:

    x1 = x + proj(MHA(LN1(x)));  out = x1 + fc2(GELU(fc1(LN2(x1))))

with the TPU kernel's rounding points: LN in fp32, matmul operands in the
compute dtype (bf16, or fp32 for fp32 input) with fp32 accumulation and fp32
bias adds, qkv / softmax probabilities / the attention output / the GELU
output rounded to the compute dtype, both residual adds in fp32, and one
rounding to ``x.dtype`` at the store.

``params`` carries the 12 tensors under the JAX names (``ln1_scale``,
``wqkv``, ...), but every weight is in ``nn.Linear`` layout ``(out, in)``,
not the JAX ``(in, out)``. ``prepare_block_params`` casts the weights to the
compute dtype once, which the kernel requires.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
import torch.nn.functional as F

PKEYS = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wproj", "bproj",
         "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")
WEIGHT_KEYS = ("wqkv", "wproj", "w1", "w2")
LN_EPS = 1e-6

#: Launches of the CUDA block kernel since import (one per wrapper call on a
#: CUDA tensor). The CPU path never touches it.
LAUNCHES = 0


def prepare_block_params(params: Dict[str, torch.Tensor],
                         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Weights cast to the compute ``dtype``, LN parameters and biases fp32,
    all detached and contiguous: the layout the kernel takes."""
    return {k: v.detach().to(dtype if k in WEIGHT_KEYS else torch.float32)
            .contiguous() for k, v in params.items()}


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two-pass fp32 LayerNorm, ``(x - mu) * rsqrt(var + eps) * g + b``."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * g + b


def block_reference(x: torch.Tensor, params: Dict[str, torch.Tensor],
                    heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its rounding points.

    Products take operands rounded to the compute dtype and accumulate in
    fp32 (the operands are upcast, so no product is TF32 or bf16-output)."""
    cd = x.dtype
    f32 = torch.float32
    B, N, D = x.shape
    hd = D // heads

    def mm(a, w):                       # a (.., in) @ w(out, in)^T, fp32 acc
        return torch.matmul(a.to(cd).to(f32), w.to(cd).to(f32).t())

    xf = x.to(f32)
    y = _ln(xf, params["ln1_scale"].float(), params["ln1_bias"].float())
    qkv = (mm(y, params["wqkv"]) + params["bqkv"].float()).to(cd)
    q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * hd ** -0.5
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(cd)
    o = torch.matmul(p.to(f32), v.to(f32))                 # (B, h, N, hd)
    attn = o.transpose(1, 2).reshape(B, N, D).to(cd)
    x1 = xf + (mm(attn, params["wproj"]) + params["bproj"].float())
    z = _ln(x1, params["ln2_scale"].float(), params["ln2_bias"].float())
    h1 = F.gelu(mm(z, params["w1"]) + params["b1"].float()).to(cd)
    out = x1 + (mm(h1, params["w2"]) + params["b2"].float())
    return out.to(x.dtype)


def _check_cuda_args(x: torch.Tensor, params: Dict[str, torch.Tensor],
                     heads: int) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_vit_block takes bf16 or fp32, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, N, D) tensor, got "
                         f"shape {tuple(x.shape)}")
    B, N, D = x.shape
    hidden = params["w1"].shape[0]
    if heads < 1 or D % heads or D % 64 or (D // heads) % 16 \
            or hidden % D or min(B, N) < 1:
        raise ValueError(
            f"unsupported block shape B={B} N={N} D={D} heads={heads} "
            f"hidden={hidden}: the kernel needs D % 64 == 0, a head width "
            f"that is a multiple of 16, and hidden % D == 0")
    want = {"ln1_scale": (D,), "ln1_bias": (D,), "wqkv": (3 * D, D),
            "bqkv": (3 * D,), "wproj": (D, D), "bproj": (D,),
            "ln2_scale": (D,), "ln2_bias": (D,), "w1": (hidden, D),
            "b1": (hidden,), "w2": (D, hidden), "b2": (D,)}
    for k, shape in want.items():
        t = params[k]
        dtype = x.dtype if k in WEIGHT_KEYS else torch.float32
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"param {k}: want contiguous {shape} {dtype} on {x.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()}); "
                f"use prepare_block_params")
    if torch.is_grad_enabled() and (x.requires_grad or any(
            params[k].requires_grad for k in PKEYS)):
        raise NotImplementedError(
            "the CUDA block kernel has no backward yet; run it under "
            "torch.no_grad() or torch.inference_mode()")


_FN_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _library():
    from rovit_kan_tpu_torch.ops import _build
    lib = _build.load("vit_block_fwd")
    for name in ("vit_block_fwd_bf16", "vit_block_fwd_f32"):
        fn = getattr(lib, name)
        fn.argtypes = _FN_ARGTYPES
        fn.restype = ctypes.c_int
    lib.vit_block_error_string.argtypes = [ctypes.c_int]
    lib.vit_block_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, params: Dict[str, torch.Tensor],
            heads: int) -> torch.Tensor:
    global LAUNCHES
    _check_cuda_args(x, params, heads)
    B, N, D = x.shape
    hidden = params["w1"].shape[0]
    lib = _library()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        qkv = torch.empty((B * N, 3 * D), dtype=x.dtype, device=x.device)
        attn = torch.empty((B * N, D), dtype=x.dtype, device=x.device)
        fn = (lib.vit_block_fwd_bf16 if x.dtype == torch.bfloat16
              else lib.vit_block_fwd_f32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
                *(params[k].data_ptr() for k in PKEYS),
                B, N, D, heads, hidden, stream)
    if rc != 0:
        msg = lib.vit_block_error_string(rc).decode()
        raise RuntimeError(f"vit_block_fwd launch failed: CUDA error {rc} "
                           f"({msg}) at B={B} N={N} D={D} heads={heads}")
    LAUNCHES += 1
    return out


def fused_vit_block(x: torch.Tensor, params: Dict[str, torch.Tensor],
                    heads: int = 3) -> torch.Tensor:
    """One pre-LN ViT block, fused.

    Args:
        x: ``(B, N, D)`` tokens, bf16 or fp32.
        params: the 12 block tensors (``PKEYS``), weights ``(out, in)``.
            On the card they must come from ``prepare_block_params``.
        heads: attention head count.

    Returns:
        ``(B, N, D)`` in ``x.dtype``. A CPU tensor runs ``block_reference``;
        a CUDA tensor launches the kernel or raises.
    """
    if x.device.type == "cpu":
        return block_reference(x, params, heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_vit_block runs on cpu or cuda, got "
                         f"{x.device}")
    return _launch(x, params, heads)
