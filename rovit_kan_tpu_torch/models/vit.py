"""DeiT-Tiny / ViT backbone in PyTorch.

Counterpart of ``rovit_kan_tpu/models/vit.py``: 16x16 patches embedded by one
Linear over pixels flattened in (row, col, channel) order (NHWC input, the JAX
layout), a CLS token, learned position embeddings, pre-LN blocks with
LayerNorm eps 1e-6 in fp32 and exact (erf) GELU, and a final fp32 LayerNorm
whose CLS row is the feature.

Parameters are fp32; ``dtype`` is the compute dtype of the trunk. The cast
points follow the JAX module: patch embedding and blocks compute in ``dtype``,
the CLS and position embeddings are cast to it before the add, and the final
norm and the features are fp32.

With ``use_fused_block`` every block goes through
``ops.block_kernel.fused_vit_block`` (the CUDA kernels on the card, their
plain versions on the CPU), with the block's weights cast once per weight
version. In training that call is ``FusedViTBlock``, whose backward is the
fused recompute backward, and the grads reach the fp32 parameters; the
unfused path is plain autograd. Attention maps and the Grad-CAM tap come
with the explainability slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rovit_kan_tpu_torch.ops.block_kernel import (
    fused_vit_block,
    prepare_block_params,
)

LN_EPS = 1e-6


def _linear(x: torch.Tensor, layer: nn.Linear,
            dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` with input, weight and bias in ``dtype`` (flax
    ``nn.Dense(dtype=...)`` over fp32 params)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm computed in fp32 whatever the input dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps)


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding as one matmul over (row, col,
    channel)-flattened patches."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 192,
                 in_chans: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = nn.Linear(patch_size * patch_size * in_chans, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        p = self.patch_size
        gh, gw = H // p, W // p
        x = x.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, gh * gw, p * p * C)
        return _linear(x, self.proj, self.dtype)


class Attention(nn.Module):
    """Multi-head self-attention (the unfused path)."""

    def __init__(self, dim: int = 192, num_heads: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        h = self.num_heads
        hd = D // h
        qkv = _linear(x, self.qkv, self.dtype)
        q, k, v = qkv.reshape(B, N, 3, h, hd).permute(2, 0, 3, 1, 4)
        logits = torch.matmul((q * hd ** -0.5).float(),
                              k.float().transpose(-1, -2))
        weights = torch.softmax(logits, dim=-1)
        out = torch.matmul(weights.to(v.dtype).float(), v.float())
        out = out.to(self.dtype).transpose(1, 2).reshape(B, N, D)
        return _linear(out, self.proj, self.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int = 192, hidden: int = 768,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(_linear(x, self.fc1, self.dtype))   # exact erf GELU
        return _linear(x, self.fc2, self.dtype)


class Block(nn.Module):
    """Pre-LN transformer block: x += MHA(LN(x)); x += MLP(LN(x)).

    ``use_fused_block`` routes the whole block through ``block_fn``
    (``fused_vit_block``, or ``plain_vit_block`` to hold it against the
    plain versions); the parameters are the same either way."""

    def __init__(self, dim: int = 192, num_heads: int = 3,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32,
                 use_fused_block: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_fused_block = use_fused_block
        self.block_fn = fused_vit_block
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        self._kernel_params: Optional[Dict[str, torch.Tensor]] = None
        self._kernel_key: Optional[Tuple] = None

    def block_params(self) -> Dict[str, torch.Tensor]:
        """The block's fp32 parameters under the kernel's names."""
        return {"ln1_scale": self.norm1.weight, "ln1_bias": self.norm1.bias,
                "wqkv": self.attn.qkv.weight, "bqkv": self.attn.qkv.bias,
                "wproj": self.attn.proj.weight, "bproj": self.attn.proj.bias,
                "ln2_scale": self.norm2.weight, "ln2_bias": self.norm2.bias,
                "w1": self.mlp.fc1.weight, "b1": self.mlp.fc1.bias,
                "w2": self.mlp.fc2.weight, "b2": self.mlp.fc2.bias}

    def kernel_params(self) -> Dict[str, torch.Tensor]:
        """The block's tensors in the kernel's layout, cast once and reused
        until a parameter is replaced or modified in place."""
        raw = self.block_params()
        key = (self.dtype,) + tuple((t.data_ptr(), t._version)
                                    for t in raw.values())
        if key != self._kernel_key:
            # Ordinary tensors even under inference_mode, so the cache can
            # also serve a later call outside it.
            with torch.inference_mode(False), torch.no_grad():
                self._kernel_params = prepare_block_params(raw, self.dtype)
            self._kernel_key = key
        return self._kernel_params

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_fused_block:
            return self.block_fn(x.to(self.dtype), self.block_params(),
                                 self.num_heads,
                                 kernel_params=self.kernel_params())
        y = _layer_norm(x, self.norm1).to(self.dtype)
        x = x + self.attn(y)
        z = _layer_norm(x, self.norm2)
        return x + self.mlp(z.to(self.dtype))


class VisionTransformer(nn.Module):
    """ViT trunk returning the fp32 CLS feature ``(B, D)``."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 192, depth: int = 12, num_heads: int = 3,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32,
                 use_fused_block: bool = False):
        super().__init__()
        n_patches = (image_size // patch_size) ** 2
        self.image_size = image_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1,
                                                  embed_dim))
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio, dtype, use_fused_block)
            for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``(B, H, W, 3)`` normalized images (NHWC)."""
        B = x.shape[0]
        x = self.patch_embed(x)
        cls = self.cls_token.expand(B, -1, -1).to(x.dtype)
        x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return _layer_norm(x, self.norm)[:, 0]


class DeiTTinyBackbone(nn.Module):
    """The reference's backbone wrapper: the trunk lives under ``model``, so
    state_dict keys read ``backbone.model.blocks.{i}...``."""

    def __init__(self, **kw):
        super().__init__()
        self.model = VisionTransformer(**kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)
