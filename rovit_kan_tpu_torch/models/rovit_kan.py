"""RoViT-KAN multi-task model assembly in PyTorch.

Counterpart of ``rovit_kan_tpu/models/rovit_kan.py``. The forward always
emits every output with a fixed shape (``features``, ``cls_logits``,
``ordinal_logits``, ``mu``, ``log_var``, ``kan_severity``); a head disabled
by its ``with_*`` toggle has no parameters and its slot is zeros, marked
absent by ``head_mask``. Submodule names give the reference's state_dict
keys (``backbone.model.blocks.{i}.attn.qkv.weight``,
``kan_module.kan_layers.{i}.spline_weights``, ...); a MoE block's experts
sit under ``backbone.model.blocks.{i}.moe`` (``gate.weight``, ``w1``, ``b1``,
``w2``, ``b2``).
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
from rovit_kan_tpu_torch.models.moe import MoEMlp
from rovit_kan_tpu_torch.models.vit import DeiTTinyBackbone
from rovit_kan_tpu_torch.ops.block_kernel import block_width_ok
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
                 use_pallas_attention: bool = False,
                 use_pallas_block: bool = False,
                 use_pallas_kan: bool = False, remat: bool = False,
                 moe_experts: int = 0, moe_every: int = 2,
                 moe_capacity_factor: float = 2.0):
        super().__init__()
        self.image_size = image_size
        self.num_classes = num_classes
        self.with_ordinal = with_ordinal
        self.with_uncertainty = with_uncertainty
        self.with_kan = with_kan
        self.backbone = DeiTTinyBackbone(
            image_size=image_size, patch_size=patch_size,
            embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            mlp_ratio=mlp_ratio, dtype=dtype, use_pallas=use_pallas_attention,
            use_fused_block=use_pallas_block, remat=remat,
            moe_experts=moe_experts, moe_every=moe_every,
            moe_capacity_factor=moe_capacity_factor)
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
                generator: Optional[torch.Generator] = None,
                return_attention: bool = False,
                gradcam_perturbation: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """x: ``(B, H, W, 3)`` normalized images (NHWC). ``generator``
        draws the heads' dropout masks in training mode.
        ``return_attention`` adds ``attention``, the blocks' fp32 softmax
        weights ``(depth, B, heads, N, N)``; ``gradcam_perturbation``, a
        ``(B, N, D)`` fp32 tensor added to the last block's ``norm1``
        output, adds that sum as ``norm1_tap`` (``models/vit.py`` says which
        blocks then run plain)."""
        taps = None
        if return_attention or gradcam_perturbation is not None:
            taps = self.backbone(x, return_attention=return_attention,
                                 gradcam_perturbation=gradcam_perturbation)
            feats = taps["features"]
        else:
            feats = self.backbone(x)                   # (B, D) fp32
        out = self.heads(feats, generator)
        if taps is not None:
            out.update({k: v for k, v in taps.items() if k != "features"})
        return out

    def heads(self, feats: torch.Tensor,
              generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
        """The output dict from the fp32 CLS feature ``(B, D)``: the
        feature itself and every head's output (zeros for a head that is
        off)."""
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


def _resolve_fused_attention(setting, *, image_size: int, patch_size: int,
                             inference: bool, dtype: torch.dtype,
                             device: torch.device) -> bool:
    """Attention-kernel policy: ``rovit_kan_tpu``'s
    ``_resolve_pallas_attention`` with "tpu" read as "cuda" (bf16 inference
    at >= 512 tokens on the card). The 512-token threshold is the crossover
    measured on the TPU; the port keeps it until a benchmark on the H100
    moves it. True/False force one implementation."""
    if setting == "auto":
        n_tokens = (image_size // patch_size) ** 2 + 1
        return (bool(inference) and n_tokens >= 512
                and dtype == torch.bfloat16 and device.type == "cuda")
    return bool(setting)


def _resolve_fused_block(setting, *, inference: bool, dtype: torch.dtype,
                         embed_dim: int, device: torch.device,
                         num_heads: Optional[int] = None) -> bool:
    """Block-kernel policy: ``rovit_kan_tpu``'s ``_resolve_pallas_block``
    with "tpu" read as "cuda": bf16 on the card, for inference at any width
    and for training at d <= 512, where the backward kernel runs too. It
    returns that rule wherever the bf16 kernels take the width
    (``block_width_ok``: D a multiple of 64 up to 768, with ``num_heads``
    where given a head width that is a multiple of 16 up to 128), which
    every preset and every width the JAX rule sends to its kernel up to
    768 does, and stays on the plain block where they do not (D past 768,
    or a shape ``block_shape_ok`` refuses). True/False force one
    implementation; a forced kernel refuses a width it does not take,
    before any launch."""
    if setting == "auto":
        return (dtype == torch.bfloat16 and device.type == "cuda"
                and block_width_ok(embed_dim, torch.bfloat16, num_heads)
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
    N(0, 0.1^2); each expert's ``w1``/``w2`` lecun_normal over its own
    fan-in (D, H: the JAX ``batch_axis=0``), zero ``b1``/``b2``. Drawn on the
    CPU, so the weights do not depend on the device."""
    g = torch.Generator().manual_seed(seed)
    lecun_std_scale = 1.0 / 0.87962566103423978

    def lecun_(p: torch.Tensor, fan_in: int) -> None:
        w = torch.empty(p.shape)
        _trunc_normal_(w, lecun_std_scale / math.sqrt(fan_in), g)
        p.copy_(w)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                lecun_(mod.weight, mod.in_features)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, MoEMlp):
                lecun_(mod.w1, mod.w1.shape[1])
                lecun_(mod.w2, mod.w2.shape[1])
                mod.b1.zero_()
                mod.b2.zero_()
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
                device="cuda", seed: int = 0,
                act_sharding=None) -> RoViTKAN:
    """RoViTKAN from a Config, with weights drawn from ``seed``, in eval mode
    when ``inference``. Head toggles default to ``config.model.with_*``.
    Runs on the card unless ``device="cpu"``; raises when CUDA is asked for
    and absent. ``tpu.use_pallas_kan`` passes through as it is (no "auto"),
    as in the JAX ``build_model``: the KAN kernels when true; so do
    ``tpu.remat_backbone`` and ``model.moe_experts``, ``moe_every`` and
    ``moe_capacity_factor`` (``models/vit.py``). ``act_sharding``: the
    sequence-parallel layout (``parallel/tensor.py::seq_sharding``), taken
    when the model is wrapped in ``TensorParallel``; a forced
    ``use_pallas_block=True`` refuses it, since the whole-block kernels
    take a whole block."""
    dev = resolve_device(device)
    m, tpu = config.model, config.tpu
    if act_sharding is not None and tpu.use_pallas_block is True:
        raise ValueError(
            "use_pallas_block=True forces the whole-block kernels (#1-#4), "
            "which take a whole block; under sequence parallelism each rank "
            "holds a shard of the block's weights and tokens. Leave it "
            '"auto": the sharded block runs its heads\' attention core '
            "through #5/#6")
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
        use_pallas_attention=_resolve_fused_attention(
            tpu.use_pallas_attention, image_size=config.data.image_size,
            patch_size=m.patch_size, inference=inference, dtype=dtype,
            device=dev),
        use_pallas_block=_resolve_fused_block(
            tpu.use_pallas_block, inference=inference, dtype=dtype,
            embed_dim=m.embed_dim, device=dev, num_heads=m.num_heads),
        use_pallas_kan=tpu.use_pallas_kan, remat=tpu.remat_backbone,
        moe_experts=m.moe_experts, moe_every=m.moe_every,
        moe_capacity_factor=m.moe_capacity_factor)
    model.backbone.model.act_sharding = act_sharding
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
    """Per-component parameter counts; 5,706,394 in all for the flagship,
    18,142,234 with ``moe_experts = 8``."""
    by_comp = {name: sum(p.numel() for p in child.parameters())
               for name, child in model.named_children()}
    by_comp["total"] = sum(p.numel() for p in model.parameters())
    return by_comp
