"""Whole augmentation chain in one kernel: the CUDA kernel's wrapper and its
plain version.

Counterpart of ``rovit_kan_tpu/ops/augment_kernel.py``, whose TPU kernel
``_augment_kernel`` is replaced on Hopper by ``csrc/augment.cu`` (the source
note there says what bounds it). uint8 ``(B, H, W, 3)`` images go to
ImageNet-normalized floats through, per image:

    /255 -> h-flip -> v-flip -> brightness, clip -> contrast around the
    ITU-R 601 grayscale mean, clip -> saturation blend, clip -> normalize

The random factors are an explicit ``(B, 8)`` input (``draw_factors``), so
the kernel, its plain version and the JAX package can be fed the same
augmentation. The rounding points are the TPU kernel's: u8/255 rounded to
the compute dtype; exact flips; ``x * fb``, the contrast blend and the
saturation blend computed op by op in the compute dtype, each clipped to
[0, 1]; the pivot an fp32 sum of ``x * w_c / (H * W)`` rounded to the
compute dtype; the grayscale an fp32 sum of ``x * w_c`` with the weights
rounded once to the compute dtype; the normalization in fp32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rovit_kan_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

GRAY_W = (0.299, 0.587, 0.114)

#: Launches of the CUDA augment kernel since import (one per wrapper call on
#: a CUDA tensor). The CPU path never touches it.
LAUNCHES = 0


def draw_factors(generator: torch.Generator, B: int,
                 brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2) -> torch.Tensor:
    """``(B, 8)`` fp32 per-image factors on the generator's device: the
    h-flip and v-flip coins (0/1), the brightness, contrast and saturation
    factors uniform in ``[1 - a, 1 + a]``, then three zeros (the layout of
    the JAX package's ``_draw_factors``)."""
    dev = generator.device
    u = torch.rand((5, B), generator=generator, device=dev)
    coins = (u[:2] < 0.5).float()
    jitter = [(1.0 - a) + (2.0 * a) * u[2 + i]
              for i, a in enumerate((brightness, contrast, saturation))]
    return torch.cat([coins, torch.stack(jitter),
                      torch.zeros((3, B), device=dev)]).t().contiguous()


def augment_reference(images_u8: torch.Tensor, factors: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its rounding points."""
    cd = compute_dtype
    f32 = torch.float32
    B, H, W, _ = images_u8.shape
    dev = images_u8.device
    f = factors.to(f32)
    x = (images_u8.to(f32) * (1.0 / 255.0)).to(cd)
    fh = (f[:, 0] > 0)[:, None, None, None]
    x = torch.where(fh, x.flip(2), x)
    fv = (f[:, 1] > 0)[:, None, None, None]
    x = torch.where(fv, x.flip(1), x)
    fb, fc, fs = (f[:, i].to(cd)[:, None, None, None] for i in (2, 3, 4))

    x = (x * fb).clamp(0.0, 1.0)
    wmean = torch.tensor(GRAY_W, dtype=f32, device=dev) / (H * W)
    pivot = (x.to(f32) * wmean).sum(dim=(1, 2, 3)).to(cd)[:, None, None,
                                                          None]
    x = ((x - pivot) * fc + pivot).clamp(0.0, 1.0)
    wg = torch.tensor(GRAY_W, dtype=f32, device=dev).to(cd).to(f32)
    gray = (x.to(f32) * wg).sum(dim=-1, keepdim=True).to(cd)
    x = ((x - gray) * fs + gray).clamp(0.0, 1.0)

    mean = torch.tensor(IMAGENET_MEAN, dtype=f32, device=dev)
    istd = 1.0 / torch.tensor(IMAGENET_STD, dtype=f32, device=dev)
    return ((x.to(f32) - mean) * istd).to(out_dtype)


def _check_cuda_args(images_u8: torch.Tensor, factors: torch.Tensor,
                     compute_dtype: torch.dtype,
                     out_dtype: torch.dtype) -> None:
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 \
            or images_u8.shape[-1] != 3 or not images_u8.is_contiguous():
        raise ValueError(f"images must be contiguous uint8 (B, H, W, 3), "
                         f"got {images_u8.dtype} {tuple(images_u8.shape)}")
    B, H, W, _ = images_u8.shape
    if min(B, H, W) < 1:
        raise ValueError(f"empty image batch {tuple(images_u8.shape)}")
    if factors.dtype != torch.float32 or tuple(factors.shape) != (B, 8) \
            or factors.device != images_u8.device \
            or not factors.is_contiguous():
        raise ValueError(f"factors must be contiguous fp32 ({B}, 8) on "
                         f"{images_u8.device}, got {factors.dtype} "
                         f"{tuple(factors.shape)} on {factors.device}")
    for name, dt in (("compute_dtype", compute_dtype),
                     ("out_dtype", out_dtype)):
        if dt not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{name} must be bf16 or fp32, got {dt}")


@functools.lru_cache(maxsize=None)
def _library():
    from rovit_kan_tpu_torch.ops import _build
    lib = _build.load("augment")
    lib.augment_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.augment_fwd.restype = ctypes.c_int
    lib.augment_error_string.argtypes = [ctypes.c_int]
    lib.augment_error_string.restype = ctypes.c_char_p
    return lib


def _launch(images_u8, factors, compute_dtype, out_dtype):
    global LAUNCHES
    _check_cuda_args(images_u8, factors, compute_dtype, out_dtype)
    B, H, W, _ = images_u8.shape
    lib = _library()
    with torch.cuda.device(images_u8.device):
        out = torch.empty((B, H, W, 3), dtype=out_dtype,
                          device=images_u8.device)
        pivot = torch.empty(B, dtype=torch.float32, device=images_u8.device)
        stream = torch.cuda.current_stream(images_u8.device).cuda_stream
        rc = lib.augment_fwd(images_u8.data_ptr(), factors.data_ptr(),
                             out.data_ptr(), pivot.data_ptr(), B, H, W,
                             int(compute_dtype == torch.bfloat16),
                             int(out_dtype == torch.bfloat16), stream)
    if rc != 0:
        msg = lib.augment_error_string(rc).decode()
        raise RuntimeError(f"augment launch failed: CUDA error {rc} ({msg}) "
                           f"at B={B} H={H} W={W}")
    LAUNCHES += 1
    return out


def fused_augment_batch(images_u8: torch.Tensor, factors: torch.Tensor,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """uint8 ``(B, H, W, 3)`` -> augmented, normalized ``(B, H, W, 3)`` in
    ``out_dtype``, with the ``(B, 8)`` ``factors`` of ``draw_factors``.
    A CPU tensor runs ``augment_reference``; a CUDA tensor launches the
    kernel or raises."""
    if images_u8.device.type == "cpu":
        return augment_reference(images_u8, factors, compute_dtype,
                                 out_dtype)
    if images_u8.device.type != "cuda":
        raise ValueError(f"fused_augment_batch runs on cpu or cuda, got "
                         f"{images_u8.device}")
    return _launch(images_u8, factors.to(torch.float32).contiguous(),
                   compute_dtype, out_dtype)
