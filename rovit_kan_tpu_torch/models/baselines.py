"""Baseline classifier backbones in PyTorch.

Counterpart of ``rovit_kan_tpu/models/baselines.py``: ResNet-50,
EfficientNet-B0, MobileNetV3-Large, VGG-16, Swin-Tiny and a plain DeiT-Tiny,
written from their published specifications (no pretrained weights), and
``BaselineModel``, which puts a linear classifier on any of them and emits
the flagship's output dict with the non-classification slots zeroed.

Submodules carry the JAX module names (``layer1_0.conv1``, ``block3.se.fc1``,
``stage0_block1.attn.rel_bias``, ``vit.blocks.0``), so
``models/convert.py::load_baseline_variables`` maps a JAX ``{"params",
"batch_stats"}`` tree onto them mechanically. Inputs are NHWC, as everywhere
in the port; a convnet views them as NCHW at its entry (a permute, which is
channels-last in memory) and pools back to ``(B, C)``. The convnets and
Swin compute in fp32; only DeiT takes another ``dtype`` (its bf16 FPS twin).

``BatchNorm`` is the port's own: it normalizes with the biased batch
variance ``E[x^2] - E[x]^2`` in training and updates its running statistics
with that same variance (flax ``BatchNorm(momentum=0.9)``), where
``nn.BatchNorm2d`` would keep the unbiased one. Its buffers never enter the
optimizer. Over a data mesh of N > 1 ranks (``sync_batchnorm``) its
training moments are the global batch's, as in the JAX package's SPMD step:
the per-channel sums of x and x^2 and the element count are all-reduced
(one collective, whose backward is an all-reduce of their gradients), so
the moments and the running statistics are one device's. Swin's
relative-position index and shifted-window masks are numpy
constants of the block's shape, held as non-persistent buffers.

Every backbone takes ``image_size``: VGG-16's first dense layer, Swin's
windows and DeiT's position embedding depend on it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from rovit_kan_tpu_torch.models.heads import dropout
from rovit_kan_tpu_torch.models.rovit_kan import _trunc_normal_
from rovit_kan_tpu_torch.models.vit import LN_EPS, VisionTransformer

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, dtype=float32)`` over the channels of an
    NCHW tensor: fp32 statistics, ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``; in training mode the biased batch variance, also folded
    into ``running_var``."""

    def __init__(self, channels: int, zero_scale: bool = False):
        super().__init__()
        self.zero_scale = zero_scale          # ResNet's bn3 starts at 0
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        #: The data mesh whose global batch the moments cover (None: this
        #: process's rows; ``sync_batchnorm`` sets it).
        self.mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            dims = (0, 2, 3)
            if self.mesh is None:
                mean = x.mean(dims)
                var = torch.clamp((x * x).mean(dims) - mean * mean,
                                  min=0.0)
            else:
                count = torch.full_like(x[0, :, 0, 0],
                                        float(x.numel() // x.shape[1]))
                s, s2, n = _RankSum.apply(self.mesh, torch.stack(
                    [x.sum(dims), (x * x).sum(dims), count]))
                mean = s / n
                var = torch.clamp(s2 / n - mean * mean, min=0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class _RankSum(torch.autograd.Function):
    """``t`` summed over the ranks of ``mesh``; the gradient, a sum over
    the ranks too."""

    @staticmethod
    def forward(ctx, mesh, t):
        ctx.mesh = mesh
        return mesh.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh.all_reduce_(g.clone())


def sync_batchnorm(model: nn.Module, mesh) -> nn.Module:
    """Every ``BatchNorm`` of ``model`` takes its training moments over the
    global batch of ``mesh``'s ranks (its own rows on a mesh of 1 or
    None, with no collective)."""
    mesh = mesh if mesh is not None and mesh.size > 1 else None
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.mesh = mesh
    return model


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """The NHWC input as an NCHW tensor (channels-last in memory)."""
    return x.permute(0, 3, 1, 2)


# ---------------------------------------------------------------- ResNet50
class _Bottleneck(nn.Module):
    def __init__(self, inp: int, features: int, strides: int = 1,
                 expansion: int = 4):
        super().__init__()
        out = features * expansion
        self.conv1 = nn.Conv2d(inp, features, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, strides, 1, bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = BatchNorm(out, zero_scale=True)
        # The JAX block projects the shortcut wherever the shapes differ.
        self.project = strides != 1 or inp != out
        if self.project:
            self.downsample_conv = nn.Conv2d(inp, out, 1, strides, bias=False)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.project:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(residual + y)


class ResNet50(nn.Module):
    """Standard ResNet-50 (He et al. 2015), 23.5M params at 4 classes."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 image_size: int = 224):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        self.names = []
        inp = 64
        for stage, n_blocks in enumerate(stage_sizes):
            for b in range(n_blocks):
                strides = 2 if stage > 0 and b == 0 else 1
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, _Bottleneck(inp, 64 * 2 ** stage,
                                                  strides))
                self.names.append(name)
                inp = 64 * 2 ** stage * 4
        self.out_dim = inp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(_nchw(x))))
        x = F.max_pool2d(x, 3, 2, 1)                  # pads with -inf
        for name in self.names:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))                     # (B, 2048)


# ---------------------------------------------------- EfficientNet-B0 bits
# F.hardswish is the JAX module's x * relu6(x + 3) / 6, F.hardsigmoid its
# relu6(x + 3) / 6.
class _SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced: int,
                 gate: Callable = torch.sigmoid, act: Callable = F.silu):
        super().__init__()
        self.gate, self.act = gate, act
        self.fc1 = nn.Linear(channels, reduced)
        self.fc2 = nn.Linear(reduced, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc2(self.act(self.fc1(x.mean(dim=(2, 3)))))
        return x * self.gate(s)[:, :, None, None]


class _MBConv(nn.Module):
    """Inverted residual block with a depthwise conv and SE (the
    EfficientNet and MobileNetV3 building block)."""

    def __init__(self, inp: int, features: int, expand: float, kernel: int,
                 strides: int, se_ratio: float = 0.25,
                 se_from_input: bool = True, act: Callable = F.silu,
                 se_gate: Callable = torch.sigmoid):
        super().__init__()
        mid = int(inp * expand)
        self.act = act
        self.residual = strides == 1 and inp == features
        self.expand, self.squeeze = mid != inp, se_ratio > 0
        if self.expand:
            self.expand_conv = nn.Conv2d(inp, mid, 1, bias=False)
            self.expand_bn = BatchNorm(mid)
        self.dw_conv = nn.Conv2d(mid, mid, kernel, strides, kernel // 2,
                                 groups=mid, bias=False)
        self.dw_bn = BatchNorm(mid)
        if self.squeeze:
            base = inp if se_from_input else mid
            self.se = _SqueezeExcite(mid, max(1, int(base * se_ratio)),
                                     gate=se_gate, act=act)
        self.project_conv = nn.Conv2d(mid, features, 1, bias=False)
        self.project_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.expand:
            x = self.act(self.expand_bn(self.expand_conv(x)))
        x = self.act(self.dw_bn(self.dw_conv(x)))
        if self.squeeze:
            x = self.se(x)
        x = self.project_bn(self.project_conv(x))
        if self.residual:
            x = x + residual
        return x


class EfficientNetB0(nn.Module):
    """EfficientNet-B0 (Tan & Le 2019), 4.0M params at 4 classes."""
    # (expand, features, repeats, strides, kernel)
    BLOCKS = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
              (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
              (6, 320, 1, 1, 3))

    def __init__(self, blocks: Sequence[Tuple] = BLOCKS,
                 image_size: int = 224):
        super().__init__()
        self.stem_conv = nn.Conv2d(3, 32, 3, 2, 1, bias=False)
        self.stem_bn = BatchNorm(32)
        self.n_blocks = 0
        inp = 32
        for expand, feat, reps, strides, kernel in blocks:
            for r in range(reps):
                self.add_module(f"block{self.n_blocks}", _MBConv(
                    inp, feat, expand, kernel, strides if r == 0 else 1,
                    se_ratio=0.25, se_from_input=True, act=F.silu))
                self.n_blocks += 1
                inp = feat
        self.head_conv = nn.Conv2d(inp, 1280, 1, bias=False)
        self.head_bn = BatchNorm(1280)
        self.out_dim = 1280

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.stem_bn(self.stem_conv(_nchw(x))))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        x = F.silu(self.head_bn(self.head_conv(x)))
        return x.mean(dim=(2, 3))                     # (B, 1280)


class MobileNetV3Large(nn.Module):
    """MobileNetV3-Large (Howard et al. 2019), 4.2M params at 4 classes.
    The JAX blocks, not torchvision's: SE reduced from the expanded width,
    with the block's own activation and a hard-sigmoid gate."""
    # (kernel, expand_size, features, se, activation, strides)
    BLOCKS = ((3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
              (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
              (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
              (3, 240, 80, False, "hswish", 2),
              (3, 200, 80, False, "hswish", 1),
              (3, 184, 80, False, "hswish", 1),
              (3, 184, 80, False, "hswish", 1),
              (3, 480, 112, True, "hswish", 1),
              (3, 672, 112, True, "hswish", 1),
              (5, 672, 160, True, "hswish", 2),
              (5, 960, 160, True, "hswish", 1),
              (5, 960, 160, True, "hswish", 1))

    def __init__(self, blocks: Sequence[Tuple] = BLOCKS,
                 image_size: int = 224):
        super().__init__()
        self.stem_conv = nn.Conv2d(3, 16, 3, 2, 1, bias=False)
        self.stem_bn = BatchNorm(16)
        inp = 16
        for i, (k, exp_size, feat, se, act_name, strides) in enumerate(
                blocks):
            act = F.hardswish if act_name == "hswish" else F.relu
            # The JAX expression: mid = int(inp * (exp_size / inp)).
            self.add_module(f"block{i}", _MBConv(
                inp, feat, exp_size / inp, k, strides,
                se_ratio=0.25 if se else 0.0, se_from_input=False, act=act,
                se_gate=F.hardsigmoid))
            inp = feat
        self.n_blocks = len(blocks)
        self.head_conv = nn.Conv2d(inp, 960, 1, bias=False)
        self.head_bn = BatchNorm(960)
        self.pre_logits = nn.Linear(960, 1280)
        self.out_dim = 1280

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.hardswish(self.stem_bn(self.stem_conv(_nchw(x))))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        x = F.hardswish(self.head_bn(self.head_conv(x)))
        return F.hardswish(self.pre_logits(x.mean(dim=(2, 3))))  # (B, 1280)


# ----------------------------------------------------------------- VGG16
class VGG16(nn.Module):
    """VGG-16 (Simonyan & Zisserman 2014), 134M params at 4 classes at 224
    px: the torchvision layout (conv-relu stacks, no BatchNorm, two 4096
    dense layers, dropout 0.5 after the first). The flatten is in (H, W, C)
    order, as in the JAX module."""
    CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M")

    def __init__(self, cfg: Sequence = CFG, image_size: int = 224):
        super().__init__()
        self.cfg = tuple(cfg)
        inp, side, ci = 3, image_size, 0
        for v in self.cfg:
            if v == "M":
                side //= 2
            else:
                self.add_module(f"conv{ci}", nn.Conv2d(inp, v, 3, padding=1))
                inp, ci = v, ci + 1
        self.fc1 = nn.Linear(side * side * inp, 4096)
        self.fc2 = nn.Linear(4096, 4096)
        self.out_dim = 4096

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, ci = _nchw(x), 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"conv{ci}")(x))
                ci += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (B, 7*7*512)
        x = dropout(F.relu(self.fc1(x)), 0.5, self.training, generator)
        return F.relu(self.fc2(x))                            # (B, 4096)


# -------------------------------------------------------------- Swin-Tiny
def _rel_pos_index(ws: int) -> np.ndarray:
    """Static (ws^2, ws^2) index into the (2ws-1)^2 relative-bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel[..., 0] + rel[..., 1]


def _shift_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """Static (nW, ws^2, ws^2) additive attention mask of a shifted window:
    tokens from different pre-roll regions must not attend to each other."""
    img = np.zeros((H, W), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    wins = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3) \
        .reshape(-1, ws * ws)
    diff = wins[:, None, :] != wins[:, :, None]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)                  # (B*nW, N, C)


def _window_reverse(w: torch.Tensor, ws: int, H: int, W: int
                    ) -> torch.Tensor:
    B = w.shape[0] // ((H // ws) * (W // ws))
    x = w.reshape(B, H // ws, W // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


class _WindowAttention(nn.Module):
    """Window attention as matmuls and a softmax: fp32 logits plus the
    relative-position bias (and the shift mask), softmax in fp32."""

    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_bias = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, heads))
        self.register_buffer("rel_index", torch.tensor(_rel_pos_index(ws)),
                             persistent=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        Bn, N, C = x.shape
        h = self.heads
        hd = C // h
        q, k, v = self.qkv(x).reshape(Bn, N, 3, h, hd).permute(2, 0, 3, 1, 4)
        s = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2))
        bias = self.rel_bias[self.rel_index].permute(2, 0, 1)   # (h, N, N)
        s = s + bias[None]
        if mask is not None:                                     # (nW, N, N)
            nW = mask.shape[0]
            s = (s.reshape(Bn // nW, nW, h, N, N) + mask[None, :, None]
                 ).reshape(Bn, h, N, N)
        o = torch.matmul(torch.softmax(s, dim=-1), v)
        return self.proj(o.transpose(1, 2).reshape(Bn, N, C))


class _SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int, shift: int, side: int):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _WindowAttention(dim, heads, ws)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)
        self.register_buffer(
            "mask", torch.tensor(_shift_mask(side, side, ws, shift))
            if shift else None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, H, W, C)
        B, H, W, C = x.shape
        s = self.shift
        y = self.norm1(x)
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y = self.attn(_window_partition(y, self.ws), self.mask)
        y = _window_reverse(y, self.ws, H, W)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y
        z = F.gelu(self.fc1(self.norm2(x)))                # exact (erf)
        return x + self.fc2(z)


class _PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, H // 2, W // 2, 4 * C)
        return self.reduction(self.norm(x))


class SwinTiny(nn.Module):
    """Swin-Tiny (Liu et al. 2021): patch 4, embed 96, depths (2, 2, 6, 2),
    heads (3, 6, 12, 24), window 7; 27.5M params at 4 classes. A stage's
    window is the largest divisor of its feature side that is at most 7
    (224 px gives 56/28/14/7); a block shifts by half a window when its
    index is odd and the window is smaller than the side. No stochastic
    depth, as in the JAX module."""

    def __init__(self, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 image_size: int = 224):
        super().__init__()
        self.patch_embed = nn.Conv2d(3, embed_dim, 4, 4)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.names = []
        side = image_size // 4
        for si, (depth, n_heads) in enumerate(zip(depths, heads)):
            dim = embed_dim * 2 ** si
            ws = min(window, side)
            while side % ws:
                ws -= 1
            for bi in range(depth):
                shift = ws // 2 if (bi % 2 == 1 and ws < side) else 0
                name = f"stage{si}_block{bi}"
                self.add_module(name, _SwinBlock(dim, n_heads, ws, shift,
                                                 side))
                self.names.append(name)
            if si < len(depths) - 1:
                name = f"merge{si}"
                self.add_module(name, _PatchMerging(dim))
                self.names.append(name)
                side //= 2
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.out_dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_norm(self.patch_embed(_nchw(x)).permute(0, 2, 3, 1))
        for name in self.names:
            x = getattr(self, name)(x)
        return self.norm(x).mean(dim=(1, 2))                # (B, 768)


class DeiTTinyClassifier(nn.Module):
    """Plain DeiT-Tiny: the port's ViT trunk (depth 12, d 192, 3 heads) at
    ``image_size``, returning the fp32 CLS feature."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 use_fused_block: bool = False, image_size: int = 224):
        super().__init__()
        self.vit = VisionTransformer(image_size=image_size, dtype=dtype,
                                     use_fused_block=use_fused_block)
        self.out_dim = 192

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.vit(x)                                  # (B, 192)


BACKBONES: Dict[str, Callable[..., nn.Module]] = {
    "deit_tiny": DeiTTinyClassifier,
    "resnet50": ResNet50,
    "efficientnet_b0": EfficientNetB0,
    "mobilenetv3_large": MobileNetV3Large,
    "vgg16": VGG16,
    "swin_tiny": SwinTiny,
}


class BaselineModel(nn.Module):
    """Backbone plus a linear classifier, emitting the flagship's output dict
    with the non-classification slots zeroed (``head_mask`` marks them
    absent). ``dtype`` and ``use_fused_block`` apply to a DeiT backbone
    only (its blocks through the block kernel); the other backbones compute
    in fp32 and refuse another dtype. ``twin`` gives such a model on this
    one's parameters."""

    with_kan = False          # the evaluator's severity-fallback flag

    def __init__(self, backbone_name: str = "deit_tiny", num_classes: int = 4,
                 dtype: torch.dtype = torch.float32,
                 use_fused_block: bool = False, image_size: int = 224):
        super().__init__()
        self.backbone_name = backbone_name
        self.num_classes = num_classes
        self.image_size = image_size
        if backbone_name == "deit_tiny":
            kw = {"dtype": dtype, "use_fused_block": use_fused_block}
        elif dtype != torch.float32 or use_fused_block:
            raise ValueError(f"{backbone_name} computes in fp32 on the plain "
                             f"path; dtype {dtype} and use_fused_block "
                             f"{use_fused_block} apply to deit_tiny only")
        else:
            kw = {}
        self.backbone = BACKBONES[backbone_name](image_size=image_size, **kw)
        self.classifier = nn.Linear(self.backbone.out_dim, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """x: ``(B, H, W, 3)`` normalized images. ``generator`` draws VGG's
        dropout mask in training mode."""
        if isinstance(self.backbone, VGG16):
            feats = self.backbone(x, generator)
        else:
            feats = self.backbone(x)
        feats = feats.float()
        B = feats.shape[0]
        return {"features": feats,
                "cls_logits": self.classifier(feats),
                "ordinal_logits": feats.new_zeros((B, self.num_classes - 1)),
                "mu": feats.new_zeros((B, 1)),
                "log_var": feats.new_zeros((B, 1)),
                "kan_severity": feats.new_zeros((B, 1))}

    @property
    def head_mask(self) -> Dict[str, bool]:
        return {"ordinal": False, "uncertainty": False, "kan": False}

    def twin(self, dtype: torch.dtype, use_fused_block: bool
             ) -> "BaselineModel":
        """The same baseline in ``dtype`` with ``use_fused_block``, in eval
        mode, on this model's own parameter and buffer tensors (shared, not
        copied): it sees every later update, and the fused blocks'
        cast-weight cache keys on these tensors."""
        with torch.device("meta"):
            twin = BaselineModel(self.backbone_name, self.num_classes, dtype,
                                 use_fused_block, self.image_size)
        owners = dict(twin.named_modules())
        for kind, named in (("_parameters", self.named_parameters()),
                            ("_buffers", self.named_buffers())):
            for key, t in named:
                path, _, leaf = key.rpartition(".")
                getattr(owners[path], kind)[leaf] = t
        return twin.eval()


_LECUN_SCALE = 1.0 / 0.87962566103423978   # truncated normal's std at 2


@torch.no_grad()
def init_baseline_weights(model: nn.Module, seed: int = 0) -> None:
    """Random weights from ``seed`` with flax's initializers, drawn on the
    CPU: conv and dense weights lecun_normal (fan_in = k * k * in / groups,
    a normal truncated at two standard deviations and corrected for it),
    zero biases, BatchNorm scale 1 (ResNet's ``bn3`` 0), bias 0, running
    mean 0 and variance 1, unit LayerNorms, Swin's relative-position tables
    and DeiT's CLS and position embeddings truncated N(0, 0.02^2)."""
    g = torch.Generator().manual_seed(seed)

    def trunc(p: torch.Tensor, std: float) -> None:
        w = torch.empty(p.shape)
        _trunc_normal_(w, std, g)
        p.copy_(w)

    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            trunc(mod.weight, _LECUN_SCALE / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(0.0 if mod.zero_scale else 1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
        elif isinstance(mod, _WindowAttention):
            trunc(mod.rel_bias, 0.02)
        elif isinstance(mod, VisionTransformer):
            trunc(mod.cls_token, 0.02)
            trunc(mod.pos_embed, 0.02)
