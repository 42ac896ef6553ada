"""Transform factories over the port's preprocessing ops.

Counterpart of ``rovit_kan_tpu/data/transforms.py``: callables over uint8
NHWC batches built from ``ops/preprocess.py``. The augmented pipeline
(flips, color jitter, ImageNet normalization) reads its random factors from
a ``torch.Generator``, as ``ops.augment_kernel.draw_factors`` draws them (the
JAX package threads a PRNG key); the original and inference pipelines
normalize only. The trainer and the engine call the ops directly; these
factories serve code written against the reference's API.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from rovit_kan_tpu_torch.ops.augment_kernel import draw_factors
from rovit_kan_tpu_torch.ops.mixing import cutmix_or_mixup  # noqa: F401
from rovit_kan_tpu_torch.ops.preprocess import augment_batch, eval_batch


def augmented_transforms(seed: int = 0) -> Callable:
    """Train-time pipeline: random flips, color jitter and normalization.
    Returns ``fn(images_u8, generator=None) -> float32 normalized batch``;
    without a generator the factory's own, seeded from ``seed``, draws the
    factors (fresh draws per call)."""
    own = {}

    def apply(images_u8: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None:
            if images_u8.device not in own:
                own[images_u8.device] = torch.Generator(
                    images_u8.device).manual_seed(seed)
            generator = own[images_u8.device]
        factors = draw_factors(generator, images_u8.shape[0])
        return augment_batch(images_u8, factors.to(images_u8.device))

    return apply


def original_transforms() -> Callable:
    """Deterministic pipeline for the Original-Image test set: normalize
    only. Returns ``fn(images_u8) -> float32 batch``."""
    return eval_batch


def inference_transforms() -> Callable:
    """Inference pipeline (the same as ``original_transforms``)."""
    return eval_batch
