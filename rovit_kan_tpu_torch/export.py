"""Ahead-of-time export of the serving function: a ``torch.export`` artifact.

Counterpart of ``rovit_kan_tpu/export.py``. The serving function
(``serving.build_serving_forward``: uint8 normalization on the device, the
forward and the derived predictions, with the calibration temperature baked
in) is traced by ``torch.export.export`` at a fixed ``(batch_size, S, S, 3)``
uint8 shape and serialized with ``torch.export.save`` into one blob that
holds the graph and the weights. The fused blocks' weights go in already in
the kernels' layout (the compute dtype, contiguous), cast once, as the
engine's cache holds them, so the artifact casts nothing per batch that the
engine does not.

Loading needs torch and the port's op library, and no model code, no config
and no checkpoint. On the card the graph calls the hand-written forward
kernels as custom ops: ``rovit_kan_torch::vit_block_fwd`` (#1),
``attention_fwd`` (#5) and ``kan_module_fwd`` (#10), which importing
``rovit_kan_tpu_torch.ops.block_kernel``, ``ops.attention`` and
``ops.kan_kernel`` registers; ``load_serving`` imports them. A model on the
CPU exports its plain path, which calls no op.

A MoE model (``moe_experts > 1``, any ``moe_every``) exports the same way:
its routing (a stable sort of each expert's scores, one-hot dispatch and
combine, ``models/moe.py``) traces at the fixed shape, and its MoE blocks
run plain as they do in the engine, while its dense blocks call #1 (or #5
and #10 where the model's flags take them), as in a dense artifact.

Fixed shapes are deliberate (the ``InferenceEngine`` contract): another
batch size fails the artifact's shape guard, so a partial batch is padded
at the call site. The artifact runs on the device of the model it was
exported from; JAX's ``platforms`` has no counterpart and is refused.
"""
from __future__ import annotations

import copy
import importlib
import io
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from rovit_kan_tpu_torch.models.vit import Block
from rovit_kan_tpu_torch.ops.block_kernel import prepare_block_params
from rovit_kan_tpu_torch.serving import build_serving_forward

#: The modules whose import registers the custom ops an artifact may call.
OP_MODULES = ("rovit_kan_tpu_torch.ops.block_kernel",
              "rovit_kan_tpu_torch.ops.attention",
              "rovit_kan_tpu_torch.ops.kan_kernel")


def refuse_platforms(platforms) -> None:
    """Raise for any ``platforms`` but None (no torch counterpart)."""
    if platforms is not None:
        raise ValueError(
            f"platforms={platforms!r} has no torch.export counterpart: the "
            f"artifact runs on the device of the model it is exported from, "
            f"so put the model on that device (device='cuda' or 'cpu') and "
            f"pass platforms=None")


class _Serving(nn.Module):
    """``build_serving_forward`` as a module, so its weights are lifted."""

    def __init__(self, model: nn.Module, temperature: float):
        super().__init__()
        self.model = model
        self._forward = build_serving_forward(model, temperature)

    def forward(self, images_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._forward(images_u8)


def _in_kernel_layout(model: nn.Module) -> nn.Module:
    """A copy of ``model`` to trace: eval mode, no parameter needing grad,
    and each fused block's weights cast once into the kernels' layout, so
    the cast ``Block.kernel_params`` traces is the identity."""
    model = copy.deepcopy(model).eval().requires_grad_(False)
    for blk in model.modules():
        if isinstance(blk, Block) and blk.use_fused_block:
            raw = blk.block_params()
            for key, t in prepare_block_params(raw, blk.dtype).items():
                raw[key].data = t
    return model


def export_serving(model: nn.Module, batch_size: int = 64,
                   platforms: Optional[Sequence[str]] = None,
                   temperature: float = 1.0) -> bytes:
    """Trace and serialize the serving function with the weights baked in.

    Args:
        model: a built RoViT-KAN (or a variant), on the device the artifact
            will run on.
        batch_size: fixed serving batch.
        platforms: must be None (no torch counterpart; see the module
            docstring).
        temperature: calibration temperature baked into the artifact
            (``cls_probs = softmax(logits / T)``; argmax invariant).

    Returns:
        The ``torch.export.save`` bytes of the ``ExportedProgram``.
    """
    refuse_platforms(platforms)
    device = next(model.parameters()).device
    size = model.image_size
    example = torch.zeros((batch_size, size, size, 3), dtype=torch.uint8,
                          device=device)
    program = torch.export.export(
        _Serving(_in_kernel_layout(model), temperature), (example,),
        strict=False)
    program.example_inputs = None      # keep a batch of zeros out of the blob
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def _input_device(program) -> torch.device:
    names = set(program.graph_signature.user_inputs)
    (node,) = [n for n in program.graph.nodes
               if n.op == "placeholder" and n.name in names]
    return node.meta["val"].device


def load_serving(blob: bytes
                 ) -> Callable[[np.ndarray], Dict[str, torch.Tensor]]:
    """Deserialize an exported serving artifact into a callable ``(uint8
    NHWC images, numpy or tensor) -> {cls_probs, cls_pred, kan_severity,
    ...}`` that runs under ``torch.inference_mode`` on the artifact's
    device. The batch must match the exported shape exactly. The
    callable's ``program`` is the loaded ``ExportedProgram``."""
    for name in OP_MODULES:
        importlib.import_module(name)
    program = torch.export.load(io.BytesIO(blob))
    module = program.module()
    device = _input_device(program)

    def call(images_u8) -> Dict[str, torch.Tensor]:
        x = torch.as_tensor(images_u8).to(device)
        with torch.inference_mode():
            return dict(module(x))

    call.program = program
    return call


def save_exported(path, model: nn.Module, batch_size: int = 64,
                  platforms: Optional[Sequence[str]] = None,
                  temperature: float = 1.0) -> int:
    """Export and write to ``path``; returns the artifact size in bytes."""
    blob = export_serving(model, batch_size, platforms,
                          temperature=temperature)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(blob)
    return len(blob)


def load_exported(path) -> Callable[[np.ndarray], Dict[str, torch.Tensor]]:
    return load_serving(Path(path).read_bytes())
