"""Whole augmentation chain in one kernel: the CUDA kernel's wrapper and its
plain version.

Counterpart of ``rovit_kan_tpu/ops/augment_kernel.py``, whose TPU kernel
``_augment_kernel`` is replaced on Hopper by ``csrc/augment.cu``: one launch
on thread-block clusters, a cluster an image under ``augment_plan`` (the
source note there says what bounds it). uint8 ``(B, H, W, 3)`` images go to
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
from typing import List, NamedTuple, Tuple

import torch

from rovit_kan_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

GRAY_W = (0.299, 0.587, 0.114)

#: CTAs of a cluster, which takes one image (``csrc/augment.cu``): the
#: portable 8, or 16 where a band of 8 would not leave five CTAs an SM.
CLUSTERS = (8, 16)
#: A chunk's shared memory at most: a 512-px band of 8 in one chunk.
SMEM_BUDGET = 96 * 1024
#: Output staging after the chunk: 48 bytes for each of a warp's 32 threads,
#: for each of the kernel's 8 warps.
STAGE_BYTES = 8 * 32 * 48
#: The kernel's static shared memory: four 256-entry fp32 tables, the warp
#: sums, the partial and the mbarrier.
STATIC_SMEM = 4 * 256 * 4 + 8 * 4 + 4 + 8
#: The largest band that keeps five CTAs on an SM (228 KB of shared memory
#: an SM, 1 KB of it reserved for each CTA), where the kernel's 48 registers
#: a thread put every cluster of a 64-image batch on the card at once.
FIVE_CTA_BAND = 228 * 1024 // 5 - 1024 - STATIC_SMEM - STAGE_BYTES

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


class AugmentPlan(NamedTuple):
    """The launch plan of ``csrc/augment.cu`` (``augment_plan``)."""
    cluster: int                 # CTAs a cluster, one cluster an image
    bounds: Tuple[int, ...]      # rank j owns output rows [b[j], b[j + 1])
    chunk_rows: int              # output rows a chunk (1 if chunk_cols < W)
    chunk_cols: int              # output columns a chunk
    chunk_bytes: int             # source bytes of the largest chunk
    smem_bytes: int              # dynamic shared memory a CTA: the chunk
                                 # (to 16 bytes), then the output staging

    def rows(self, H: int, rank: int, vflip: bool) -> Tuple[int, int]:
        """Rank ``rank``'s source rows: its output rows, mirrored under the
        v-flip."""
        r0, r1 = self.bounds[rank], self.bounds[rank + 1]
        return (H - r1, H - r0) if vflip else (r0, r1)


@functools.lru_cache(maxsize=64)
def augment_plan(B: int, H: int, W: int) -> AugmentPlan:
    """How the kernel splits a batch of ``(B, H, W, 3)`` images: a cluster
    of C CTAs an image (8, or 16 where a band of 8 exceeds
    ``FIVE_CTA_BAND``: 224 px takes 8, 384 px 16), rank j owning the output
    rows ``[j H // C, (j + 1) H // C)`` (as ``kan_kernel.module_plan``
    splits a width), its band of source rows walked in chunks of at most
    ``SMEM_BUDGET`` bytes: whole rows where one row fits, else pieces of
    one row. A band that fits one chunk is read once; a larger one twice
    (the sum, then the output). The kernel decides per chunk, from its
    source's address and length, between one bulk copy (both multiples of
    16 bytes: every chunk of a batch when ``W * 3 % 16 == 0`` and chunks
    are whole rows) and 4-byte or 1-byte loads."""
    if min(B, H, W) < 1:
        raise ValueError(f"empty image batch ({B}, {H}, {W}, 3)")
    c = CLUSTERS[-(-H // CLUSTERS[0]) * 3 * W > FIVE_CTA_BAND]
    bounds = tuple(j * H // c for j in range(c + 1))
    w3 = 3 * W
    if w3 <= SMEM_BUDGET:
        chunk_rows, chunk_cols = min(-(-H // c), SMEM_BUDGET // w3), W
    else:
        chunk_rows, chunk_cols = 1, SMEM_BUDGET // 3
    chunk_bytes = 3 * chunk_rows * chunk_cols
    return AugmentPlan(c, bounds, chunk_rows, chunk_cols, chunk_bytes,
                       -(-chunk_bytes // 16) * 16 + STAGE_BYTES)


def band_chunks(plan: AugmentPlan, H: int, W: int, rank: int, hflip: bool,
                vflip: bool) -> List[Tuple[int, int, int]]:
    """The chunks of rank ``rank``'s band in the order of the kernel's first
    walk (the second walks them backwards): ``(q0, n, ps0)``, the output
    pixels ``[q0, q0 + n)`` of the image (row-major) and the first source
    pixel of their contiguous source (``csrc/augment.cu::chunk_at``)."""
    r0, r1 = plan.bounds[rank], plan.bounds[rank + 1]
    ncol = -(-W // plan.chunk_cols)
    out = []
    for k in range(-(-(r1 - r0) // plan.chunk_rows) * ncol):
        y0 = r0 + (k // ncol) * plan.chunk_rows
        y1 = min(y0 + plan.chunk_rows, r1)
        x0 = (k % ncol) * plan.chunk_cols
        x1 = min(x0 + plan.chunk_cols, W)
        sy0 = H - y1 if vflip else y0
        sx0 = W - x1 if hflip else x0
        out.append((y0 * W + x0, (y1 - y0) * (x1 - x0), sy0 * W + sx0))
    return out


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
    lib.augment_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    lib.augment_fwd.restype = ctypes.c_int
    lib.augment_error_string.argtypes = [ctypes.c_int]
    lib.augment_error_string.restype = ctypes.c_char_p
    return lib


def _launch(images_u8, factors, compute_dtype, out_dtype):
    global LAUNCHES
    _check_cuda_args(images_u8, factors, compute_dtype, out_dtype)
    B, H, W, _ = images_u8.shape
    plan = augment_plan(B, H, W)
    lib = _library()
    with torch.cuda.device(images_u8.device):
        out = torch.empty((B, H, W, 3), dtype=out_dtype,
                          device=images_u8.device)
        stream = torch.cuda.current_stream(images_u8.device).cuda_stream
        rc = lib.augment_fwd(images_u8.data_ptr(), factors.data_ptr(),
                             out.data_ptr(), B, H, W,
                             int(compute_dtype == torch.bfloat16),
                             int(out_dtype == torch.bfloat16), plan.cluster,
                             plan.chunk_rows, plan.chunk_cols,
                             plan.smem_bytes, stream)
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
