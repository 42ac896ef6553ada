"""PyTorch/CUDA port of RoViT-KAN.

A second package beside ``rovit_kan_tpu`` (the JAX reference). Module names
mirror the JAX package, so ``rovit_kan_tpu_torch.models.vit`` is the
counterpart of ``rovit_kan_tpu.models.vit``. The port imports torch and
numpy only, never jax or the JAX package; its tests hold it against the
reference on the CPU.

Entry points (``build_model``, ``InferenceEngine``, ``load_jax_params``)
run on the GPU unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and no
    card is visible, so an entry point never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    return dev
