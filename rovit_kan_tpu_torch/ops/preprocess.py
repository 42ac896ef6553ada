"""Inference preprocessing: uint8 NHWC -> ImageNet-normalized float.

Counterpart of ``rovit_kan_tpu/ops/preprocess.py`` (``to_float``,
``normalize``, ``eval_batch``). Images stay NHWC, the JAX package's layout.
The training augmentations come with the training slice.
"""
from __future__ import annotations

import torch

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
