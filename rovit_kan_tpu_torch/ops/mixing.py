"""CutMix / MixUp with the random draws as explicit inputs.

Counterpart of ``rovit_kan_tpu/ops/mixing.py`` (``cutmix_or_mixup``,
``_cutmix_spec``, ``_mixup_spec``). One coin per batch picks CutMix or
MixUp; both are the same blend ``a * x + b * x[perm]``, with ``a = 1 - mask``
and ``b = mask`` for CutMix's box and ``a = lam``, ``b = 1 - lam`` for MixUp.
Severity labels are never mixed; the classification labels come back as
``labels_a`` (the batch's) and ``labels_b`` (permuted), with ``lam``.

The draws (the coin, the permutation, lam and the CutMix box) come in as a
dict, so the JAX package's draws can be handed to the port; ``draw_mix``
makes them from a ``torch.Generator``. For CutMix, lam is recomputed from
the realised box, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch


def _uniform(generator: torch.Generator) -> float:
    return float(torch.rand((), generator=generator,
                            device=generator.device))


def _gamma(generator: torch.Generator, alpha: float) -> float:
    """One Gamma(alpha, 1) variate (Marsaglia and Tsang; alpha < 1 through
    Gamma(alpha + 1) * U ** (1 / alpha))."""
    if alpha < 1.0:
        u = _uniform(generator)
        return _gamma(generator, alpha + 1.0) * u ** (1.0 / alpha)
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        z = float(torch.randn((), generator=generator,
                              device=generator.device))
        v = (1.0 + c * z) ** 3
        if v <= 0.0:
            continue
        u = _uniform(generator)
        if math.log(max(u, 1e-300)) < 0.5 * z * z + d - d * v \
                + d * math.log(v):
            return d * v


def _beta(generator: torch.Generator, a: float, b: float) -> float:
    x = _gamma(generator, a)
    y = _gamma(generator, b)
    return x / (x + y)


def cutmix_box(lam0: float, cy: int, cx: int, H: int,
               W: int) -> Tuple[int, int, int, int]:
    """The CutMix box ``(y0, y1, x0, x1)`` for a drawn lam and centre, cut
    as the JAX package cuts it (side ``int(H * sqrt(1 - lam))``, clipped to
    the image)."""
    ratio = torch.sqrt(torch.tensor(1.0 - lam0, dtype=torch.float32))
    cut_h = int(torch.tensor(float(H), dtype=torch.float32) * ratio)
    cut_w = int(torch.tensor(float(W), dtype=torch.float32) * ratio)
    return (min(max(cy - cut_h // 2, 0), H), min(max(cy + cut_h // 2, 0), H),
            min(max(cx - cut_w // 2, 0), W), min(max(cx + cut_w // 2, 0), W))


def draw_mix(generator: torch.Generator, B: int, H: int, W: int,
             cutmix_alpha: float = 1.0, mixup_alpha: float = 0.2,
             use_cutmix: bool = True, use_mixup: bool = True
             ) -> Optional[Dict]:
    """One batch's mixing draws: ``{"cutmix": bool, "perm": (B,) int64,
    "lam": float, "box": (y0, y1, x0, x1)}`` (``box`` only for CutMix), or
    None when both mixes are off. Scalars are drawn on the generator's
    device and read back, so a CPU generator keeps the step free of
    device syncs."""
    if not use_cutmix and not use_mixup:
        return None
    pick = (_uniform(generator) < 0.5) if use_cutmix and use_mixup \
        else use_cutmix
    perm = torch.randperm(B, generator=generator, device=generator.device)
    if not pick:
        return {"cutmix": False, "perm": perm,
                "lam": _beta(generator, mixup_alpha, mixup_alpha)}
    lam0 = _beta(generator, cutmix_alpha, cutmix_alpha)
    cy = int(torch.randint(0, H, (), generator=generator,
                           device=generator.device))
    cx = int(torch.randint(0, W, (), generator=generator,
                           device=generator.device))
    return {"cutmix": True, "perm": perm, "lam": lam0,
            "box": cutmix_box(lam0, cy, cx, H, W)}


def cutmix_spec(box: Tuple[int, int, int, int], H: int, W: int,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The box as a ``(1, H, W, 1)`` fp32 mask, and lam recomputed from the
    realised area (fp32)."""
    y0, y1, x0, x1 = box
    mask = torch.zeros((1, H, W, 1), dtype=torch.float32, device=device)
    mask[:, y0:y1, x0:x1] = 1.0
    area = torch.full((), float((y1 - y0) * (x1 - x0)), dtype=torch.float32,
                      device=device)
    return mask, 1.0 - area / (H * W)


def cutmix_or_mixup(images: torch.Tensor, labels: torch.Tensor,
                    mix: Optional[Dict]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Apply the drawn mix. Returns ``(mixed, labels_a, labels_b, lam)``
    with ``lam`` an fp32 scalar tensor; ``mix=None`` passes the batch
    through with lam 1."""
    dev = images.device
    if mix is None:
        return images, labels, labels, torch.ones((), device=dev)
    B, H, W, _ = images.shape
    perm = mix["perm"].to(dev)
    if mix["cutmix"]:
        b, lam = cutmix_spec(mix["box"], H, W, dev)
        a = 1.0 - b
    else:
        lam = torch.full((), mix["lam"], dtype=torch.float32, device=dev)
        a, b = lam, 1.0 - lam
    mixed = a.to(images.dtype) * images + b.to(images.dtype) * images[perm]
    return mixed, labels, labels[perm], lam
