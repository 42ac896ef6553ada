"""Grad-CAM++ on the last transformer block's ``norm1`` output.

Counterpart of ``rovit_kan_tpu/explainability/gradcam.py``: alpha = g^2 /
(2 g^2 + sum_tokens(a g^3)) with a zero-denominator guard, token weights
sum_channels(alpha relu(g)), CAM = sum_channels(w a) without the CLS token,
ReLU, the patch grid resized bilinearly, min-max normalized.

No hooks: the model adds a zero ``(B, N, D)`` fp32 perturbation to the tap
(``gradcam_perturbation``), returns the tap as ``norm1_tap``, and the
gradient of the summed target logits with respect to the perturbation is
the tap's gradient (``torch.autograd.grad``, so no parameter's ``.grad`` is
written). The blocks before the tap run without autograd (on the card, the
fused block's forward kernel as an inference call), the last block plain;
one call serves the batch with a target class per image. The model runs in
eval mode for the call, and each module's mode is put back after.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from rovit_kan_tpu_torch.explainability.attention_maps import (
    model_device,
    overlay_heatmap,
    resize_maps,
    three_panel,
)


def _cam_from_grads(acts: torch.Tensor, grads: torch.Tensor,
                    image_size: int) -> torch.Tensor:
    """Grad-CAM++ maps ``(B, image_size, image_size)`` from the tap's
    activations and gradients ``(B, N, D)``."""
    g2 = grads ** 2
    g3 = grads ** 3
    denom = 2.0 * g2 + torch.sum(acts * g3, dim=1, keepdim=True)
    denom = torch.where(denom != 0.0, denom, torch.ones_like(denom))
    alpha = g2 / denom                                     # (B, N, D)
    weights = torch.sum(alpha * torch.relu(grads), dim=2, keepdim=True)
    cam = torch.sum(weights * acts, dim=2)                 # (B, N)
    cam = torch.relu(cam[:, 1:])                           # drop CLS
    B = cam.shape[0]
    g = math.isqrt(cam.shape[-1])
    cam = resize_maps(cam.reshape(B, g, g), image_size)
    mn = cam.amin(dim=(1, 2), keepdim=True)
    mx = cam.amax(dim=(1, 2), keepdim=True)
    return torch.where(mx > mn, (cam - mn) / (mx - mn + 1e-12),
                       torch.zeros_like(cam))


def gradcam_taps(model, x: torch.Tensor, class_idx: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tap's activations and gradients ``(B, N, D)`` fp32 and the
    target classes ``(B,)``: ``class_idx`` where it is >= 0, else each
    row's argmax."""
    B = x.shape[0]
    vit = model.backbone.model
    N = (model.image_size // vit.patch_embed.patch_size) ** 2 + 1
    D = vit.pos_embed.shape[-1]
    perturb = torch.zeros((B, N, D), dtype=torch.float32, device=x.device,
                          requires_grad=True)
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    try:
        with torch.enable_grad():
            out = model(x, gradcam_perturbation=perturb)
            logits = out["cls_logits"]
            idx = torch.where(class_idx >= 0, class_idx,
                              torch.argmax(logits, dim=-1))
            picked = torch.gather(logits, 1, idx[:, None])
            # Each image reaches the tap only through its own row, so the
            # sum gives every image its own target's gradient.
            (grads,) = torch.autograd.grad(picked.sum(), inputs=[perturb])
    finally:
        for m, training in modes:
            m.training = training
    return out["norm1_tap"].detach(), grads, idx


def make_gradcam_fn(model) -> Callable:
    """``fn(x, class_idx) -> (cams, idx)`` for normalized images ``x``
    ``(B, H, W, 3)`` on the model's device and ``class_idx`` ``(B,)`` int
    (-1 for the predicted class)."""

    def _gradcam(x: torch.Tensor, class_idx: torch.Tensor):
        acts, grads, idx = gradcam_taps(model, x, class_idx)
        return _cam_from_grads(acts, grads, model.image_size), idx

    return _gradcam


def _targets(class_idx, B: int, device) -> torch.Tensor:
    if class_idx is None:
        return torch.full((B,), -1, dtype=torch.long, device=device)
    return torch.as_tensor(np.asarray(class_idx), dtype=torch.long,
                           device=device)


def gradcam_plus_plus(model, x, class_idx: Optional[np.ndarray] = None,
                      device="cuda") -> np.ndarray:
    """One batched Grad-CAM++ call. ``class_idx``: a target class per image,
    or None for the predicted class. Returns ``(B, H, W)`` numpy maps in
    [0, 1]. Runs on the card unless ``device="cpu"``; the model must be
    there."""
    return GradCAMPlusPlus(model, device).compute(x, class_idx)


class GradCAMPlusPlus:
    """Grad-CAM++ of a ``RoViTKAN`` (the object API of the JAX class). Runs
    on the card unless ``device="cpu"``; the model must be there."""

    def __init__(self, model, device="cuda"):
        self.model = model
        self.device = model_device(model, device)
        self._fn = make_gradcam_fn(model)

    def maps(self, images, class_idx=None) -> torch.Tensor:
        """``(B, H, W)`` fp32 maps on the device for normalized images
        ``(B, H, W, 3)`` (numpy or a tensor)."""
        x = torch.as_tensor(images).to(self.device, torch.float32)
        cams, _ = self._fn(x, _targets(class_idx, x.shape[0], self.device))
        return cams

    def compute(self, images, class_idx=None) -> np.ndarray:
        """``maps`` as a numpy ``(B, H, W)`` array in [0, 1]."""
        return self.maps(images, class_idx).cpu().numpy()

    def overlay_on_image(self, image: np.ndarray, cam: np.ndarray,
                         alpha: float = 0.5) -> np.ndarray:
        return overlay_heatmap(image, cam, alpha)

    def visualize(self, image_display: np.ndarray, cam: np.ndarray,
                  save_path: Optional[Path] = None, title: str = ""):
        """Three panels: original, Grad-CAM++, overlay."""
        return three_panel(image_display, cam, "Grad-CAM++", save_path,
                           title)
