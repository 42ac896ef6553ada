"""RoViT-KAN multi-task model assembly in PyTorch.

Counterpart of ``rovit_kan_tpu/models/rovit_kan.py``. The forward always
emits every output with a fixed shape (``features``, ``cls_logits``,
``ordinal_logits``, ``mu``, ``log_var``, ``kan_severity``); a head disabled
by its ``with_*`` toggle has no parameters and its slot is zeros, marked
absent by ``head_mask``. Submodule names give the reference's state_dict
keys (``backbone.model.blocks.{i}.attn.qkv.weight``,
``kan_module.kan_layers.{i}.spline_weights``, ...).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from rovit_kan_tpu_torch import resolve_device
from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.models.heads import (
    ClassificationHead,
    OrdinalHead,
    UncertaintyHead,
)
from rovit_kan_tpu_torch.models.kan import KANLayer, KANSeverityModule
from rovit_kan_tpu_torch.models.vit import DeiTTinyBackbone
from rovit_kan_tpu_torch.ops.ordinal import (
    cumulative_to_class_probs,
    ordinal_expected_severity,
)


class RoViTKAN(nn.Module):
    """ViT backbone + classification, ordinal, uncertainty and KAN heads."""

    def __init__(self, embed_dim: int = 192, depth: int = 12,
                 num_heads: int = 3, mlp_ratio: float = 4.0,
                 image_size: int = 224, patch_size: int = 16,
                 num_classes: int = 4, hidden_dim: int = 128,
                 dropout: float = 0.3,
                 kan_layers: Sequence[int] = (192, 64, 16, 1),
                 kan_num_knots: int = 5, kan_degree: int = 3,
                 with_ordinal: bool = True, with_uncertainty: bool = True,
                 with_kan: bool = True, dtype: torch.dtype = torch.float32,
                 use_pallas_block: bool = False,
                 use_pallas_kan: bool = False):
        super().__init__()
        self.image_size = image_size
        self.num_classes = num_classes
        self.with_ordinal = with_ordinal
        self.with_uncertainty = with_uncertainty
        self.with_kan = with_kan
        self.backbone = DeiTTinyBackbone(
            image_size=image_size, patch_size=patch_size,
            embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            mlp_ratio=mlp_ratio, dtype=dtype,
            use_fused_block=use_pallas_block)
        self.classification_head = ClassificationHead(
            embed_dim, hidden_dim, num_classes, dropout)
        if with_ordinal:
            self.ordinal_head = OrdinalHead(embed_dim, hidden_dim,
                                            num_classes, dropout)
        if with_uncertainty:
            self.uncertainty_head = UncertaintyHead(embed_dim, hidden_dim,
                                                    dropout)
        if with_kan:
            self.kan_module = KANSeverityModule(tuple(kan_layers),
                                                kan_num_knots, kan_degree,
                                                use_fused=use_pallas_kan)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """x: ``(B, H, W, 3)`` normalized images (NHWC). ``generator``
        draws the heads' dropout masks in training mode."""
        feats = self.backbone(x)                       # (B, D) fp32
        B = feats.shape[0]

        def zeros(width):
            return feats.new_zeros((B, width))

        out = {"features": feats,
               "cls_logits": self.classification_head(feats, generator)}
        out["ordinal_logits"] = (self.ordinal_head(feats, generator)
                                 if self.with_ordinal
                                 else zeros(self.num_classes - 1))
        if self.with_uncertainty:
            out["mu"], out["log_var"] = self.uncertainty_head(feats,
                                                              generator)
        else:
            out["mu"], out["log_var"] = zeros(1), zeros(1)
        out["kan_severity"] = (self.kan_module(feats) if self.with_kan
                               else zeros(1))
        return out

    @property
    def head_mask(self) -> Dict[str, bool]:
        """Static per-head presence flags consumed by the joint loss."""
        return {"ordinal": self.with_ordinal,
                "uncertainty": self.with_uncertainty,
                "kan": self.with_kan}


def _resolve_fused_block(setting, *, inference: bool, dtype: torch.dtype,
                         embed_dim: int, device: torch.device) -> bool:
    """Block-kernel policy: ``rovit_kan_tpu``'s ``_resolve_pallas_block``
    with "tpu" read as "cuda" (bf16 on the card, for inference, or for
    training at d <= 512, where the backward kernel runs too); True/False
    force one implementation."""
    if setting == "auto":
        return (dtype == torch.bfloat16 and device.type == "cuda"
                and (bool(inference) or embed_dim <= 512))
    return bool(setting)


_SQRT2 = math.sqrt(2.0)


def _trunc_normal_(t: torch.Tensor, std: float,
                   generator: torch.Generator) -> None:
    """In-place N(0, std^2) truncated at two standard deviations
    (inverse-CDF sampling, as flax's ``truncated_normal``)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / _SQRT2))
    hi = 0.5 * (1.0 + math.erf(2.0 / _SQRT2))
    u = torch.rand(t.shape, generator=generator) * (hi - lo) + lo
    t.copy_(torch.erfinv(2.0 * u - 1.0) * (_SQRT2 * std))


def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Random weights from ``seed`` with the JAX package's initializers:
    Linear weights lecun_normal (truncated normal, std 1/sqrt(fan_in)
    corrected for the truncation), zero biases, unit LayerNorm, CLS and
    position embeddings truncated N(0, 0.02^2), spline coefficients
    N(0, 0.1^2). Drawn on the CPU, so the weights do not depend on the
    device."""
    g = torch.Generator().manual_seed(seed)
    lecun_std_scale = 1.0 / 0.87962566103423978
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                w = torch.empty(mod.weight.shape)
                _trunc_normal_(w, lecun_std_scale / math.sqrt(mod.in_features),
                               g)
                mod.weight.copy_(w)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, KANLayer):
                mod.spline_weights.copy_(
                    torch.randn(mod.spline_weights.shape, generator=g) * 0.1)
        vit = model.backbone.model
        for p in (vit.cls_token, vit.pos_embed):
            w = torch.empty(p.shape)
            _trunc_normal_(w, 0.02, g)
            p.copy_(w)


def build_model(config: Config, *, with_ordinal: Optional[bool] = None,
                with_uncertainty: Optional[bool] = None,
                with_kan: Optional[bool] = None,
                dtype: Optional[torch.dtype] = None, inference: bool = False,
                device="cuda", seed: int = 0) -> RoViTKAN:
    """RoViTKAN from a Config, with weights drawn from ``seed``, in eval mode
    when ``inference``. Head toggles default to ``config.model.with_*``.
    Runs on the card unless ``device="cpu"``; raises when CUDA is asked for
    and absent, and for options whose kernels are not ported yet.
    ``tpu.use_pallas_kan`` passes through as it is (no "auto"), as in the
    JAX ``build_model``: the KAN kernels when true."""
    dev = resolve_device(device)
    m, tpu = config.model, config.tpu
    if tpu.use_pallas_attention is True or tpu.remat_backbone \
            or m.moe_experts > 1:
        raise NotImplementedError(
            "the port has no attention-only kernel, remat or MoE yet: set "
            "tpu.use_pallas_attention to 'auto' or False, "
            "tpu.remat_backbone to False and model.moe_experts to 0")
    if dtype is None:
        dtype = (torch.bfloat16 if config.flags.mixed_precision
                 else torch.float32)
    model = RoViTKAN(
        embed_dim=m.embed_dim, depth=m.depth, num_heads=m.num_heads,
        mlp_ratio=m.mlp_ratio, image_size=config.data.image_size,
        patch_size=m.patch_size, num_classes=m.num_classes,
        hidden_dim=m.hidden_dim, dropout=m.dropout,
        kan_layers=tuple(m.kan_layers), kan_num_knots=m.kan_num_knots,
        kan_degree=m.kan_degree,
        with_ordinal=m.with_ordinal if with_ordinal is None else with_ordinal,
        with_uncertainty=(m.with_uncertainty if with_uncertainty is None
                          else with_uncertainty),
        with_kan=m.with_kan if with_kan is None else with_kan,
        dtype=dtype,
        use_pallas_block=_resolve_fused_block(
            tpu.use_pallas_block, inference=inference, dtype=dtype,
            embed_dim=m.embed_dim, device=dev),
        use_pallas_kan=tpu.use_pallas_kan)
    init_weights(model, seed)
    model.train(not inference)
    return model.to(dev)


@torch.no_grad()
def predict(model: RoViTKAN, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Eval-mode forward plus the derived predictions (softmax, argmax,
    ordinal class probabilities and expected severity, uncertainty std)."""
    model.eval()
    out = model(x)
    out["cls_probs"] = torch.softmax(out["cls_logits"], dim=-1)
    out["cls_pred"] = torch.argmax(out["cls_logits"], dim=-1)
    if model.with_ordinal:
        out["ordinal_probs"] = cumulative_to_class_probs(out["ordinal_logits"])
        out["ordinal_severity"] = ordinal_expected_severity(
            out["ordinal_logits"])
    if model.with_uncertainty:
        out["uncertainty_std"] = torch.exp(0.5 * out["log_var"])
    return out


def count_parameters(model: nn.Module) -> Dict[str, int]:
    """Per-component parameter counts; 5,706,394 in all for the flagship."""
    by_comp = {name: sum(p.numel() for p in child.parameters())
               for name, child in model.named_children()}
    by_comp["total"] = sum(p.numel() for p in model.parameters())
    return by_comp
