"""Preprocessing and augmentation: uint8 NHWC -> ImageNet-normalized float.

Counterpart of ``rovit_kan_tpu/ops/preprocess.py``. Images stay NHWC, the
JAX package's layout. The training augmentations (``random_flips``,
``color_jitter``, ``augment_batch``) are the fp32 chain of plain ops that
the trainer takes when the fused augment kernel is off; they read the
per-image random factors from an explicit ``(B, 8)`` tensor (the layout of
``ops.augment_kernel.draw_factors``: h-flip, v-flip, brightness, contrast,
saturation), so they can be fed the JAX package's draws.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_float(images_u8: torch.Tensor) -> torch.Tensor:
    return images_u8.to(torch.float32) / 255.0


def normalize(images: torch.Tensor) -> torch.Tensor:
    """[0,1] float images (B,H,W,3) -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype,
                        device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def eval_batch(images_u8: torch.Tensor) -> torch.Tensor:
    """Inference pipeline: normalize only."""
    return normalize(to_float(images_u8))


def resize_bilinear(t: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``(B, C, H, W)`` resampled to ``size`` as ``jax.image.resize(...,
    "bilinear")`` resamples the last two axes: half-pixel centres, and a
    triangle kernel widened by the scale where the grid shrinks
    (antialiased)."""
    return F.interpolate(t, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)


def random_flips(images: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Per-image horizontal, then vertical flip where the coin
    (``factors[:, 0]``, ``factors[:, 1]``) is set."""
    fh = (factors[:, 0] > 0)[:, None, None, None]
    images = torch.where(fh, images.flip(2), images)
    fv = (factors[:, 1] > 0)[:, None, None, None]
    return torch.where(fv, images.flip(1), images)


def _grayscale(images: torch.Tensor) -> torch.Tensor:
    return (0.299 * images[..., 0] + 0.587 * images[..., 1]
            + 0.114 * images[..., 2])


def color_jitter(images: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Per-image brightness, contrast and saturation (``factors[:, 2:5]``)
    on [0, 1] images, torchvision ColorJitter semantics: each op blends
    against statistics of the current image and clips before the next."""
    fb, fc, fs = (factors[:, i][:, None, None, None].to(images.dtype)
                  for i in (2, 3, 4))
    images = torch.clamp(images * fb, 0.0, 1.0)
    pivot = _grayscale(images).mean(dim=(1, 2))[:, None, None, None]
    images = torch.clamp((images - pivot) * fc + pivot, 0.0, 1.0)
    gray3 = _grayscale(images)[..., None]
    images = (images - gray3) * fs + gray3
    return torch.clamp(images, 0.0, 1.0)


def augment_batch(images_u8: torch.Tensor,
                  factors: torch.Tensor) -> torch.Tensor:
    """Full augmented-train pipeline in fp32: flips + jitter + normalize."""
    x = random_flips(to_float(images_u8), factors)
    return normalize(color_jitter(x, factors))
