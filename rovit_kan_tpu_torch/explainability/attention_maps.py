"""Attention rollout for the ViT backbone, batched.

Counterpart of ``rovit_kan_tpu/explainability/attention_maps.py``: the
rollout is the product over the blocks of the row-normalized ``A + I``
after the heads are fused (mean, max or min); the CLS row's patch columns
reshape to the patch grid, are resized bilinearly to the image and
min-max normalized; a JET overlay and a three-panel figure show it.

The model returns each block's fp32 softmax weights when asked
(``return_attention=True``, every block on the plain path), and the rollout
runs on the device the weights are on, in fp32. Its products are fp32
matmuls: on the card they are TF32 only where
``torch.set_float32_matmul_precision`` asks for it. ``apply_discard``
zeroes the lowest ``discard_ratio`` share of each row (the CLS column kept),
the intent the reference documents and the JAX package implements; off by
default, as there. matplotlib is imported only to draw.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from rovit_kan_tpu_torch import resolve_device
from rovit_kan_tpu_torch.ops.preprocess import resize_bilinear


def resize_maps(maps: torch.Tensor, image_size: int) -> torch.Tensor:
    """``(B, g, g)`` maps resized to ``(B, image_size, image_size)``, as
    ``jax.image.resize(..., "bilinear")`` resizes them."""
    return resize_bilinear(maps[:, None], (image_size, image_size))[:, 0]


def attention_rollout(attention: torch.Tensor, head_fusion: str = "mean",
                      image_size: int = 224, discard_ratio: float = 0.9,
                      apply_discard: bool = False) -> torch.Tensor:
    """Batched attention rollout.

    Args:
        attention: ``(depth, B, heads, N, N)`` per-block softmax attention.
        head_fusion: ``"mean"``, ``"max"`` or ``"min"`` over the heads.
        apply_discard: zero the lowest ``discard_ratio`` share of each
            fused row (never the CLS column) before normalizing.

    Returns:
        ``(B, image_size, image_size)`` fp32 maps in [0, 1], on the
        attention's device.
    """
    attention = attention.float()
    depth, B, _, N, _ = attention.shape
    if head_fusion == "max":
        fused = attention.amax(dim=2)
    elif head_fusion == "min":
        fused = attention.amin(dim=2)
    else:
        fused = attention.mean(dim=2)                  # (depth, B, N, N)

    if apply_discard:
        k = max(1, int(N * (1.0 - discard_ratio)))
        thresh = torch.sort(fused, dim=-1).values[..., N - k, None]
        keep = fused >= thresh
        keep[..., 0] = True
        fused = fused * keep

    eye = torch.eye(N, dtype=fused.dtype, device=fused.device)
    a = fused + eye
    a = a / a.sum(dim=-1, keepdim=True)

    rollout = eye.expand(B, N, N)
    for layer in range(depth):
        rollout = torch.bmm(rollout, a[layer])

    cls_attn = rollout[:, 0, 1:]                       # (B, N-1)
    g = math.isqrt(cls_attn.shape[-1])
    maps = resize_maps(cls_attn.reshape(B, g, g), image_size)
    mn = maps.amin(dim=(1, 2), keepdim=True)
    mx = maps.amax(dim=(1, 2), keepdim=True)
    return (maps - mn) / (mx - mn + 1e-8)


def overlay_heatmap(image: np.ndarray, heatmap: np.ndarray,
                    alpha: float = 0.5) -> np.ndarray:
    """JET-colormap overlay of a [0, 1] map on an image (uint8 or [0, 1]
    float), in [0, 1]."""
    import matplotlib.cm as cm
    colored = cm.jet(np.clip(heatmap, 0, 1))[..., :3]      # (H, W, 3)
    image = np.asarray(image, np.float32)
    if image.max() > 1.0:
        image = image / 255.0
    out = (1 - alpha) * image + alpha * colored
    return np.clip(out, 0, 1)


def three_panel(image_display: np.ndarray, heatmap: np.ndarray,
                method: str, save_path: Optional[Path] = None,
                title: str = ""):
    """Original, heatmap and overlay side by side; saved and closed when
    ``save_path`` is given (returns None), else the figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(14, 5))
    img = np.asarray(image_display, np.float32)
    if img.max() > 1.0:
        img = img / 255.0
    axes[0].imshow(img)
    axes[0].set_title("Original")
    im = axes[1].imshow(heatmap, cmap="jet")
    axes[1].set_title(method)
    fig.colorbar(im, ax=axes[1], fraction=0.046)
    axes[2].imshow(overlay_heatmap(img, heatmap))
    axes[2].set_title("Overlay")
    for ax in axes:
        ax.axis("off")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig


def model_device(model: torch.nn.Module, device) -> torch.device:
    """``device`` resolved, and checked to be where ``model``'s
    parameters are (the explainability classes never move a model)."""
    dev = resolve_device(device)
    have = next(model.parameters()).device
    if have.type != dev.type or (dev.index is not None
                                 and have.index != dev.index):
        raise ValueError(f"the model's parameters are on {have}, not on "
                         f"the requested {dev}")
    return have


class ViTAttentionRollout:
    """Rollout maps of a ``RoViTKAN`` (the object API of the JAX class).
    Runs on the card unless ``device="cpu"``; the model must be there."""

    def __init__(self, model, discard_ratio: float = 0.9,
                 apply_discard: bool = False, device="cuda"):
        self.model = model
        self.device = model_device(model, device)
        self.discard_ratio = discard_ratio
        self.apply_discard = apply_discard

    @torch.no_grad()
    def maps(self, images, head_fusion: str = "mean") -> torch.Tensor:
        """``(B, H, W)`` fp32 maps on the device for normalized images
        ``(B, H, W, 3)`` (numpy or a tensor)."""
        x = torch.as_tensor(images).to(self.device, torch.float32)
        attention = self.model(x, return_attention=True)["attention"]
        return attention_rollout(attention, head_fusion=head_fusion,
                                 image_size=x.shape[1],
                                 discard_ratio=self.discard_ratio,
                                 apply_discard=self.apply_discard)

    def generate(self, images, head_fusion: str = "mean") -> np.ndarray:
        """``maps`` as a numpy ``(B, H, W)`` array in [0, 1]."""
        return self.maps(images, head_fusion).cpu().numpy()

    def visualize(self, image_display: np.ndarray, attention_map: np.ndarray,
                  save_path: Optional[Path] = None, title: str = ""):
        """Three panels: original, rollout, overlay."""
        return three_panel(image_display, attention_map, "Attention rollout",
                           save_path, title)
