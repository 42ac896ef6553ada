"""Whole-ViT-block forward and backward: the CUDA kernels' wrappers and
their plain versions.

Counterpart of ``rovit_kan_tpu/ops/block_kernel.py::fused_vit_block`` and its
custom VJP. The TPU kernel ``_vit_block_kernel`` is replaced on Hopper by
``csrc/vit_block_fwd.cu`` and the recompute backward ``_vit_block_bwd_kernel``
by ``csrc/vit_block_bwd.cu`` (bf16) and ``csrc/vit_block_bwd_f32.cu`` (fp32);
the saved-residual pair ``_vit_block_res_kernel`` /
``_vit_block_bwd_res_kernel`` by the ``vit_block_res_fwd_*`` and
``vit_block_bwd_res_*`` entries of the same sources (the source notes there
say what bounds them and how they are tiled). One pre-LN block:

    x1 = x + proj(MHA(LN1(x)));  out = x1 + fc2(GELU(fc1(LN2(x1))))

with the TPU kernel's rounding points: LN in fp32, matmul operands in the
compute dtype (bf16, or fp32 for fp32 input) with fp32 accumulation and fp32
bias adds, qkv / softmax probabilities / the attention output / the GELU
output rounded to the compute dtype, both residual adds in fp32, and one
rounding to ``x.dtype`` at the store. The backward recomputes that forward
and rounds where ``_vit_block_bwd_kernel`` does (see
``block_backward_reference``).

``params`` carries the 12 tensors under the JAX names (``ln1_scale``,
``wqkv``, ...), but every weight is in ``nn.Linear`` layout ``(out, in)``,
not the JAX ``(in, out)``. ``prepare_block_params`` casts the weights to the
compute dtype once, which the kernels require.

The forward kernel #1 is the custom op ``rovit_kan_torch::vit_block_fwd``
(``torch.library.custom_op``, CUDA only, with a fake that gives x's shape
and dtype), so ``torch.export`` records it as one node of a graph and a
loaded artifact calls it again; the op's implementation is the checks and
the ctypes launch. Importing this module registers the op. Eager calls on
the card go through the op too; the other kernels are plain ctypes calls.

Under autograd the block is ``FusedViTBlock``: the forward saves only ``x``
and the parameters (the recompute contract of the JAX custom VJP), and the
backward gives ``dx`` and the 12 parameter grads, summed over the batch.
With ``ROVIT_BLOCK_RESIDUAL_BWD=1`` (read each time the forward runs, the
counterpart of the JAX package reading it at trace time) the forward is the
residual kernel #3, which also returns qkv, the attention output and the fc1
pre-activation a1 in the compute dtype; they are saved, and the backward is
#4, which reads them instead of recomputing the forward. Inference never
takes #3.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

PKEYS = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wproj", "bproj",
         "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")
WEIGHT_KEYS = ("wqkv", "wproj", "w1", "w2")
LN_EPS = 1e-6
#: The widest D each route's kernels take, forward (#1, #3) and backward
#: (#2, #4) alike: bf16 ``csrc/block_mma.cuh`` up to 192 and
#: ``block_wide_mma.cuh`` / ``block_wide_bwd_mma.cuh`` past it
#: (``wide_width``, ``bwd_mma_width_ok``), fp32 ``block_tf32.cuh``
#: ``tf32_block_width_ok`` and ``block_bwd_fma.cuh`` ``bwd_fma_width_ok``.
BLOCK_MAX_WIDTH = {torch.bfloat16: 768, torch.float32: 320}


def block_width_ok(D: int, dtype: torch.dtype,
                   heads: Optional[int] = None) -> bool:
    """Whether the block kernels take width ``D`` in ``dtype`` (and, where
    given, ``heads`` heads): the C++ checks, ``block_shape_ok``'s D a
    multiple of 64 and a head width that is a multiple of 16 up to 128, and
    the route's widest D."""
    if D % 64 or not 64 <= D <= BLOCK_MAX_WIDTH.get(dtype, 0):
        return False
    return heads is None or (heads >= 1 and D % heads == 0
                             and (D // heads) % 16 == 0
                             and D // heads <= 128)


#: Launches of the CUDA block forward since import (one per wrapper call on
#: a CUDA tensor). The CPU path never touches it.
LAUNCHES = 0
#: Launches of the CUDA block backward, counted the same way.
BWD_LAUNCHES = 0
#: Launches of the residual-saving forward (#3) and of the backward that
#: reads its residuals (#4), counted the same way.
RES_LAUNCHES = 0
BWD_RES_LAUNCHES = 0


def _residual_bwd() -> bool:
    """``ROVIT_BLOCK_RESIDUAL_BWD=1`` selects the saved-residual pair (#3 and
    #4) under autograd; the recompute backward (#2) is the default, as in the
    JAX package."""
    return os.environ.get("ROVIT_BLOCK_RESIDUAL_BWD", "0") == "1"


def prepare_block_params(params: Dict[str, torch.Tensor],
                         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Weights cast to the compute ``dtype``, LN parameters and biases fp32,
    all detached and contiguous: the layout the kernels take."""
    return {k: v.detach().to(dtype if k in WEIGHT_KEYS else torch.float32)
            .contiguous() for k, v in params.items()}


def _ln_stats(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """Two-pass fp32 LayerNorm ``(x - mu) * rsqrt(var + eps) * g + b``, with
    its normalized input and inverse std."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + LN_EPS)
    xhat = (x - mu) * inv
    return xhat * g + b, xhat, inv


def _forward_parts(x: torch.Tensor, params: Dict[str, torch.Tensor],
                   heads: int):
    """The forward with the kernels' rounding points: the fp32 output, qkv
    ``(B, N, 3D)`` and the attention output ``(B, N, D)`` in the compute
    dtype, and the fc1 pre-activation a1 ``(B, N, H)`` in fp32.

    Products take operands rounded to the compute dtype and accumulate in
    fp32 (the operands are upcast, so no product is TF32 or bf16-output)."""
    cd = x.dtype
    f32 = torch.float32
    B, N, D = x.shape
    hd = D // heads

    def mm(a, w):                       # a (.., in) @ w(out, in)^T, fp32 acc
        return torch.matmul(a.to(cd).to(f32), w.to(cd).to(f32).t())

    xf = x.to(f32)
    y = _ln_stats(xf, params["ln1_scale"].float(),
                  params["ln1_bias"].float())[0]
    qkv = (mm(y, params["wqkv"]) + params["bqkv"].float()).to(cd)
    q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * hd ** -0.5
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(cd)
    o = torch.matmul(p.to(f32), v.to(f32))                 # (B, h, N, hd)
    attn = o.transpose(1, 2).reshape(B, N, D).to(cd)
    x1 = xf + (mm(attn, params["wproj"]) + params["bproj"].float())
    z = _ln_stats(x1, params["ln2_scale"].float(),
                  params["ln2_bias"].float())[0]
    a1 = mm(z, params["w1"]) + params["b1"].float()
    h1 = F.gelu(a1).to(cd)
    out = x1 + (mm(h1, params["w2"]) + params["b2"].float())
    return out, qkv, attn, a1


def block_reference(x: torch.Tensor, params: Dict[str, torch.Tensor],
                    heads: int) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (#1), with its rounding
    points (``_forward_parts``)."""
    return _forward_parts(x, params, heads)[0].to(x.dtype)


def block_residual_reference(x: torch.Tensor, params: Dict[str, torch.Tensor],
                             heads: int):
    """Plain version of the residual-saving forward (#3): ``(out, qkv, attn,
    a1)``, the last three in the compute dtype, a1 rounded after its fp32
    bias add; ``out`` is ``block_reference``'s."""
    out, qkv, attn, a1 = _forward_parts(x, params, heads)
    return out.to(x.dtype), qkv, attn, a1.to(x.dtype)


def _ln_grad(dz: torch.Tensor, xhat: torch.Tensor, inv: torch.Tensor,
             g: torch.Tensor) -> torch.Tensor:
    """Input gradient of LayerNorm for the upstream gradient ``dz``."""
    dxhat = dz * g
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return inv * (dxhat - m1 - xhat * m2)


def _gelu_grad(a: torch.Tensor) -> torch.Tensor:
    """d/da of the exact (erf) GELU: Phi(a) + a * phi(a)."""
    return (0.5 * (1.0 + torch.erf(a * 2.0 ** -0.5))
            + a * 0.3989422804014327 * torch.exp(-0.5 * a * a))


def _backward_from(x: torch.Tensor, g: torch.Tensor, qkv: torch.Tensor,
                   attn: torch.Tensor, a1: torch.Tensor,
                   params: Dict[str, torch.Tensor], heads: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The backward both kernels share, from the forward's qkv and attention
    output (compute dtype) and its fc1 pre-activation ``a1`` (fp32, as the
    backward reads it). Rebuilds both LayerNorms from ``x``, x1 from ``x``
    and ``attn`` (one proj product), and S and the fp32 P from q and k."""
    cd = x.dtype
    f32 = torch.float32
    B, N, D = x.shape
    hd = D // heads
    M = B * N
    scale = hd ** -0.5
    P = {k: v.float() for k, v in params.items()}

    def mm(a, b):                       # operands rounded to cd, fp32 acc
        return torch.matmul(a.to(cd).to(f32), b.to(cd).to(f32))

    def heads_of(t):                    # (M, D) -> (B, h, N, hd)
        return t.reshape(B, N, heads, hd).transpose(1, 2)

    def rows_of(t):                     # (B, h, N, hd) -> (M, D)
        return t.transpose(1, 2).reshape(M, D)

    # What the forward leaves, and what is rebuilt from x.
    xf = x.to(f32).reshape(M, D)
    y, yhat1, inv1 = _ln_stats(xf, P["ln1_scale"], P["ln1_bias"])
    yb = y.to(cd)
    qkv = qkv.reshape(M, 3 * D)
    attn = attn.reshape(M, D)
    a1 = a1.reshape(M, -1)
    q, k, v = (heads_of(qkv[:, i * D:(i + 1) * D]) for i in range(3))
    s = mm(q, k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)                   # fp32
    p_lo = p.to(cd)
    x1 = xf + (mm(attn, P["wproj"].t()) + P["bproj"])
    z, xhat2, inv2 = _ln_stats(x1, P["ln2_scale"], P["ln2_bias"])
    zb = z.to(cd)
    h1 = F.gelu(a1).to(cd)

    # Backward.
    gf = g.to(f32).reshape(M, D)
    gb = gf.to(cd)
    grads = {"w2": mm(gb.t(), h1), "b2": gf.sum(0)}
    da1 = mm(gb, P["w2"]) * _gelu_grad(a1)
    da1b = da1.to(cd)
    grads["w1"] = mm(da1b.t(), zb)
    grads["b1"] = da1.sum(0)
    dz = mm(da1b, P["w1"])
    grads["ln2_scale"] = (dz * xhat2).sum(0)
    grads["ln2_bias"] = dz.sum(0)
    dx1 = gf + _ln_grad(dz, xhat2, inv2, P["ln2_scale"])
    dx1b = dx1.to(cd)
    grads["wproj"] = mm(dx1b.t(), attn)
    grads["bproj"] = dx1.sum(0)
    go = heads_of(mm(dx1b, P["wproj"]).to(cd))

    dv = mm(p_lo.transpose(-1, -2), go)
    dp = mm(go, v.transpose(-1, -2))
    ds = (p * (dp - (p * dp).sum(dim=-1, keepdim=True)) * scale).to(cd)
    dq = mm(ds, k)
    dk = mm(ds.transpose(-1, -2), q)
    dqkv = torch.cat([rows_of(dq), rows_of(dk), rows_of(dv)], dim=1)
    dqkvb = dqkv.to(cd)
    grads["bqkv"] = dqkv.sum(0)
    grads["wqkv"] = mm(dqkvb.t(), yb)
    dy = mm(dqkvb, P["wqkv"])
    grads["ln1_scale"] = (dy * yhat1).sum(0)
    grads["ln1_bias"] = dy.sum(0)
    dx = dx1 + _ln_grad(dy, yhat1, inv1, P["ln1_scale"])
    return dx.reshape(B, N, D).to(x.dtype), {k: grads[k] for k in PKEYS}


def block_backward_reference(x: torch.Tensor, g: torch.Tensor,
                             params: Dict[str, torch.Tensor], heads: int
                             ) -> Tuple[torch.Tensor,
                                        Dict[str, torch.Tensor]]:
    """Plain PyTorch version of the recompute backward kernel (#2).

    Recomputes the forward, then walks MLP -> LN2 -> proj -> attention ->
    qkv -> LN1, rounding where ``_vit_block_bwd_kernel`` does: ``g``, ``dx1``
    and ``dz`` stay fp32; ``da1``, ``dx1``, the attention-output gradient,
    ``dqkv`` and ``ds`` are rounded to the compute dtype before their
    products; ``p`` is fp32 in ``ds = p * (dp - rowsum(p * dp)) * scale`` and
    rounded in ``dV = p^T gO``; a1 stays fp32 into GELU and GELU'. Bias and
    LayerNorm grads sum fp32 values.

    Returns ``dx`` in ``x.dtype`` and the 12 grads in fp32, weights in the
    ``(out, in)`` layout of their parameters."""
    _, qkv, attn, a1 = _forward_parts(x, params, heads)
    return _backward_from(x, g, qkv, attn, a1, params, heads)


def block_backward_residual_reference(
        x: torch.Tensor, g: torch.Tensor, qkv: torch.Tensor,
        attn: torch.Tensor, a1: torch.Tensor, params: Dict[str, torch.Tensor],
        heads: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain version of the saved-residual backward (#4): the recompute
    backward's walk and rounding, from the residuals #3 saved (``qkv``,
    ``attn``, ``a1`` in the compute dtype). GELU and GELU' read a1 as it was
    stored, so in bf16 the grads are not #2's bits; in fp32 they are the
    same math."""
    return _backward_from(x, g, qkv, attn, a1.float(), params, heads)


def param_shapes(D: int, hidden: int) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the 12 block tensors (and of their grads), in ``PKEYS``
    order: the order the backward kernel packs the grads in one buffer."""
    return {"ln1_scale": (D,), "ln1_bias": (D,), "wqkv": (3 * D, D),
            "bqkv": (3 * D,), "wproj": (D, D), "bproj": (D,),
            "ln2_scale": (D,), "ln2_bias": (D,), "w1": (hidden, D),
            "b1": (hidden,), "w2": (D, hidden), "b2": (D,)}


def _check_width(x: torch.Tensor, backward: bool) -> None:
    """A width the route's forward (or ``backward``) does not take raises a
    ValueError naming the widths it takes."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_vit_block takes bf16 or fp32, got {x.dtype}")
    D = x.shape[-1]
    if not block_width_ok(D, x.dtype):
        raise ValueError(
            f"unsupported block width D={D} in {x.dtype}: the "
            f"{str(x.dtype).replace('torch.', '')} "
            f"{'backward' if backward else 'forward'} stages take D a "
            f"multiple of 64 from 64 to {BLOCK_MAX_WIDTH[x.dtype]}")


def _check_cuda_args(x: torch.Tensor, params: Dict[str, torch.Tensor],
                     heads: int, backward: bool = False) -> None:
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, N, D) tensor, got "
                         f"shape {tuple(x.shape)}")
    B, N, D = x.shape
    hidden = params["w1"].shape[0]
    _check_width(x, backward)
    if heads < 1 or D % heads or (D // heads) % 16 \
            or D // heads > 128 or hidden % D or min(B, N) < 1:
        raise ValueError(
            f"unsupported block shape B={B} N={N} D={D} heads={heads} "
            f"hidden={hidden}: the kernel needs a head width that is a "
            f"multiple of 16 up to 128, and hidden % D == 0")
    for k, shape in param_shapes(D, hidden).items():
        t = params[k]
        dtype = x.dtype if k in WEIGHT_KEYS else torch.float32
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"param {k}: want contiguous {shape} {dtype} on {x.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()}); "
                f"use prepare_block_params")


def _check_bwd_args(x: torch.Tensor, g: torch.Tensor,
                    params: Dict[str, torch.Tensor], heads: int) -> None:
    """What the backward kernel takes: the forward's arguments at a width
    the backward takes (``block_width_ok``), plus an fp32 contiguous
    gradient of x's shape on x's device."""
    _check_cuda_args(x, params, heads, backward=True)
    if g.dtype != torch.float32 or g.shape != x.shape \
            or g.device != x.device or not g.is_contiguous():
        raise ValueError(
            f"g must be a contiguous fp32 {tuple(x.shape)} tensor on "
            f"{x.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")


def _check_residuals(x: torch.Tensor, qkv: torch.Tensor, attn: torch.Tensor,
                     a1: torch.Tensor, hidden: int) -> None:
    """What #4 takes besides #2's arguments: the three residuals #3 returns,
    contiguous, in x's dtype, on x's device."""
    B, N, D = x.shape
    for name, t, width in (("qkv", qkv, 3 * D), ("attn", attn, D),
                           ("a1", a1, hidden)):
        if tuple(t.shape) != (B, N, width) or t.dtype != x.dtype \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {(B, N, width)} {x.dtype} "
                f"tensor on {x.device}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")


_FWD_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_WS_ARGTYPES = [ctypes.c_int] * 5


@functools.lru_cache(maxsize=None)
def _library():
    from rovit_kan_tpu_torch.ops import _build
    lib = _build.load("vit_block_fwd")
    for name, extra in (("vit_block_fwd", 0), ("vit_block_res_fwd", 1)):
        for suffix in ("bf16", "f32"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * extra + _FWD_ARGTYPES
            fn.restype = ctypes.c_int
    lib.vit_block_fwd_workspace_bf16.argtypes = _WS_ARGTYPES
    lib.vit_block_fwd_workspace_bf16.restype = ctypes.c_size_t
    lib.vit_block_error_string.argtypes = [ctypes.c_int]
    lib.vit_block_error_string.restype = ctypes.c_char_p
    return lib


# The backward's two routes are two sources, built in parallel: the bf16
# mma.sync stages (vit_block_bwd.cu) and the fp32 FMA stages
# (vit_block_bwd_f32.cu).
_BWD_SOURCES = {"bf16": ("vit_block_bwd", "vit_block_bwd_error_string"),
                "f32": ("vit_block_bwd_f32",
                        "vit_block_bwd_f32_error_string")}


@functools.lru_cache(maxsize=None)
def _bwd_library(suffix: str):
    from rovit_kan_tpu_torch.ops import _build
    source, error_string = _BWD_SOURCES[suffix]
    lib = _build.load(source)
    for name, extra in (("vit_block_bwd", 0), ("vit_block_bwd_res", 3)):
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * extra + _BWD_ARGTYPES
        fn.restype = ctypes.c_int
        ws = getattr(lib, f"{name}_workspace_{suffix}")
        ws.argtypes = _WS_ARGTYPES
        ws.restype = ctypes.c_size_t
    err = getattr(lib, error_string)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    lib.error_string = err
    return lib


def _run_fwd(x: torch.Tensor, params: Dict[str, torch.Tensor], heads: int,
             residual: bool):
    """Launches #1, or #3 when ``residual``; returns ``(out, qkv, attn,
    a1)``, the last three ``(B * N, width)`` (a1 None for #1)."""
    _check_cuda_args(x, params, heads)
    B, N, D = x.shape
    hidden = params["w1"].shape[0]
    lib = _library()
    suffix = "bf16" if x.dtype == torch.bfloat16 else "f32"
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        qkv = torch.empty((B * N, 3 * D), dtype=x.dtype, device=x.device)
        attn = torch.empty((B * N, D), dtype=x.dtype, device=x.device)
        a1 = (torch.empty((B * N, hidden), dtype=x.dtype, device=x.device)
              if residual else None)
        # The wide bf16 stages' scratch (none at the other widths).
        nbytes = (lib.vit_block_fwd_workspace_bf16(B, N, D, heads, hidden)
                  if suffix == "bf16" else 0)
        work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x.data_ptr(), out.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
                work.data_ptr(), *(params[k].data_ptr() for k in PKEYS),
                B, N, D, heads, hidden, stream)
        rc = (getattr(lib, f"vit_block_res_fwd_{suffix}")(a1.data_ptr(), *args)
              if residual else getattr(lib, f"vit_block_fwd_{suffix}")(*args))
    if rc != 0:
        msg = lib.vit_block_error_string(rc).decode()
        name = "vit_block_res_fwd" if residual else "vit_block_fwd"
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({msg}) at B={B} N={N} D={D} heads={heads}")
    return out, qkv, attn, a1


def _launch(x: torch.Tensor, params: Dict[str, torch.Tensor],
            heads: int) -> torch.Tensor:
    """Kernel #1: the block's output."""
    global LAUNCHES
    out = _run_fwd(x, params, heads, residual=False)[0]
    LAUNCHES += 1
    return out


@torch.library.custom_op("rovit_kan_torch::vit_block_fwd", mutates_args=(),
                         device_types="cuda")
def _vit_block_fwd_op(x: torch.Tensor, params: List[torch.Tensor],
                      heads: int) -> torch.Tensor:
    """Kernel #1 as an opaque op: the checks, the launch on the current
    stream and the error raise, ``params`` in ``PKEYS`` order."""
    return _launch(x, dict(zip(PKEYS, params)), heads)


@_vit_block_fwd_op.register_fake
def _(x, params, heads):
    _check_cuda_args(x, dict(zip(PKEYS, params)), heads)
    return torch.empty_like(x)


# The overload itself: calling it skips the op object's Python wrapper.
_VIT_BLOCK_FWD = torch.ops.rovit_kan_torch.vit_block_fwd.default


def _launch_res(x: torch.Tensor, params: Dict[str, torch.Tensor],
                heads: int):
    """Kernel #3: ``(out, qkv, attn, a1)``, the residuals ``(B, N, .)`` in
    x's dtype; ``out`` has #1's bits."""
    global RES_LAUNCHES
    out, qkv, attn, a1 = _run_fwd(x, params, heads, residual=True)
    RES_LAUNCHES += 1
    B, N, _ = x.shape
    return out, qkv.view(B, N, -1), attn.view(B, N, -1), a1.view(B, N, -1)


def _run_bwd(x: torch.Tensor, g: torch.Tensor,
             params: Dict[str, torch.Tensor], heads: int, saved=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Launches #2, or #4 from ``saved`` = ``(qkv, attn, a1)``."""
    _check_bwd_args(x, g, params, heads)
    B, N, D = x.shape
    hidden = params["w1"].shape[0]
    if saved is not None:
        _check_residuals(x, *saved, hidden)
    name = "vit_block_bwd" if saved is None else "vit_block_bwd_res"
    suffix = "bf16" if x.dtype == torch.bfloat16 else "f32"
    lib = _bwd_library(suffix)
    shapes = param_shapes(D, hidden)
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
        nbytes = getattr(lib, f"{name}_workspace_{suffix}")(
            B, N, D, heads, hidden)
        work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"{name}_{suffix}")(
            *(t.data_ptr() for t in saved or ()),
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), flat.data_ptr(),
            work.data_ptr(), *(params[k].data_ptr() for k in PKEYS),
            B, N, D, heads, hidden, stream)
    if rc != 0:
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({msg}) at B={B} N={N} D={D} heads={heads}")
    grads = {k: t.view(s) for (k, s), t in
             zip(shapes.items(), torch.split(flat, sizes))}
    return dx, grads


def _launch_bwd(x: torch.Tensor, g: torch.Tensor,
                params: Dict[str, torch.Tensor], heads: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Kernel #2: dx and the 12 grads."""
    global BWD_LAUNCHES
    out = _run_bwd(x, g, params, heads)
    BWD_LAUNCHES += 1
    return out


def _launch_bwd_res(x: torch.Tensor, g: torch.Tensor, qkv: torch.Tensor,
                    attn: torch.Tensor, a1: torch.Tensor,
                    params: Dict[str, torch.Tensor], heads: int
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Kernel #4: dx and the 12 grads from #3's residuals."""
    global BWD_RES_LAUNCHES
    out = _run_bwd(x, g, params, heads, (qkv, attn, a1))
    BWD_RES_LAUNCHES += 1
    return out


def _runs_plain(x: torch.Tensor, plain: bool) -> bool:
    """True where the plain versions run: a CPU tensor, or ``plain``."""
    if x.device.type == "cpu" or plain:
        return True
    if x.device.type != "cuda":
        raise ValueError(f"fused_vit_block runs on cpu or cuda, got "
                         f"{x.device}")
    return False


def _forward(x, params, heads, plain: bool):
    if _runs_plain(x, plain):
        return block_reference(x, params, heads)
    return _VIT_BLOCK_FWD(x, [params[k] for k in PKEYS], heads)


def _forward_res(x, params, heads, plain: bool):
    if _runs_plain(x, plain):
        return block_residual_reference(x, params, heads)
    return _launch_res(x, params, heads)


def _backward(x, g, params, heads, plain: bool, saved=None):
    if _runs_plain(x, plain):
        if saved is None:
            return block_backward_reference(x, g, params, heads)
        return block_backward_residual_reference(x, g, *saved, params, heads)
    g = g.to(torch.float32).contiguous()
    if saved is None:
        return _launch_bwd(x, g, params, heads)
    return _launch_bwd_res(x, g, *saved, params, heads)


class FusedViTBlock(torch.autograd.Function):
    """The block under autograd: ``apply(x, heads, kernel_params, plain,
    *params)`` with the 12 parameters in ``PKEYS`` order.

    By default the forward saves ``x`` and the parameters and nothing else,
    and the backward recomputes the forward (kernel #2 on the card, its plain
    version on the CPU or when ``plain``). With ``ROVIT_BLOCK_RESIDUAL_BWD=1``
    the forward is #3 and also saves its qkv, attention output and a1, and
    the backward is #4 (or their plain versions). ``kernel_params`` is the
    parameters already cast by ``prepare_block_params`` (a cache the caller
    keeps), or None to cast them here; the grads go to ``params``, each in
    its own dtype."""

    @staticmethod
    def forward(ctx, x, heads, kernel_params, plain, *params):
        if not _runs_plain(x, plain):
            # A width the backward does not take is refused here, before
            # the forward launches.
            _check_width(x, backward=True)
        kp = kernel_params
        if kp is None:
            raw = dict(zip(PKEYS, params))
            kp = (raw if x.device.type == "cpu" or plain
                  else prepare_block_params(raw, x.dtype))
        ctx.heads, ctx.kernel_params, ctx.plain = heads, kp, plain
        ctx.residual = _residual_bwd()
        if ctx.residual:
            out, *saved = _forward_res(x, kp, heads, plain)
            ctx.save_for_backward(x, *saved, *params)
            return out
        ctx.save_for_backward(x, *params)
        return _forward(x, kp, heads, plain)

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        saved, params = ((rest[:3], rest[3:]) if ctx.residual
                         else (None, rest))
        dx, grads = _backward(x, g, ctx.kernel_params, ctx.heads, ctx.plain,
                              saved)
        return (dx.to(x.dtype), None, None, None,
                *(grads[k].to(p.dtype) for k, p in zip(PKEYS, params)))


def _needs_grad(x: torch.Tensor, params: Dict[str, torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(params[k].requires_grad for k in PKEYS))


def fused_vit_block(x: torch.Tensor, params: Dict[str, torch.Tensor],
                    heads: int = 3,
                    kernel_params: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """One pre-LN ViT block, fused.

    Args:
        x: ``(B, N, D)`` tokens, bf16 or fp32.
        params: the 12 block tensors (``PKEYS``), weights ``(out, in)``.
            Without autograd on the card they must come from
            ``prepare_block_params``, unless ``kernel_params`` does.
        heads: attention head count.
        kernel_params: ``params`` already cast by ``prepare_block_params``
            (a cache); the kernels read these when given.

    Returns:
        ``(B, N, D)`` in ``x.dtype``. A CPU tensor runs the plain versions;
        a CUDA tensor launches the kernels or raises. When grad is enabled
        and ``x`` or a parameter needs it, the call goes through
        ``FusedViTBlock`` and the grads reach ``params``.
    """
    if _needs_grad(x, params):
        return FusedViTBlock.apply(x, heads, kernel_params, False,
                                   *(params[k] for k in PKEYS))
    return _forward(x, kernel_params if kernel_params is not None else params,
                    heads, plain=False)


def plain_vit_block(x: torch.Tensor, params: Dict[str, torch.Tensor],
                    heads: int = 3,
                    kernel_params: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """``fused_vit_block`` through the plain versions on any device, forward
    and backward: the yardstick that the kernels are held against."""
    if _needs_grad(x, params):
        return FusedViTBlock.apply(x, heads, kernel_params, True,
                                   *(params[k] for k in PKEYS))
    return _forward(x, kernel_params if kernel_params is not None else params,
                    heads, plain=True)
