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
fused recompute backward, and the grads reach the fp32 parameters. With
``use_pallas`` (and the block unfused) each attention's ``softmax(q k^T) v``
goes through ``ops.attention.fused_attention`` (kernels #5/#6 on the card);
the fused block wins where both are on, as in the JAX ``Block``. The rest of
the unfused path is plain autograd.

The explainability taps are call-time arguments, as in the JAX module, and
never change a module's settings (another thread may serve from the same
model). ``return_attention`` runs every block on the plain path and returns
each block's fp32 softmax weights; ``gradcam_perturbation`` is added to the
last block's fp32 ``norm1`` output, whose sum is the Grad-CAM++ tap, and
runs only that block plain (its attention core still through
``fused_attention`` where the model was built with it). The blocks before
the tap do not depend on the perturbation, so they run without autograd:
the fused block there is an inference call of the forward kernel, and the
gradient of a call with a perturbation reaches the perturbation and what
follows the tap, not the blocks before it. A call without either returns
what it always did.

With ``moe_experts > 1`` every ``moe_every``-th block (blocks
``moe_every - 1``, ``2 * moe_every - 1``, ...) has the expert-choice
``MoEMlp`` (``models/moe.py``) in place of its dense MLP; such a block always
runs plain (its attention core through ``fused_attention`` where asked), as
in the JAX ``Block``. ``remat`` recomputes each plain block in the backward
(``torch.utils.checkpoint``) instead of keeping its activations, on calls
that record gradients and ask for no tap; a fused block is left alone, since
its backward already keeps only the block's input and recomputes the rest.
Gradients are the same bits with remat on and off.

Under tensor parallelism (``parallel/tensor.py::TensorParallel``) the trunk
and every block hold the mesh's ``ModelAxis`` as ``tp``, and the blocks hold
their rank's shards of the four Megatron layers. A block then runs sharded
(``Block._tp_forward``): qkv and fc1 on its columns, one all-gather of qkv,
the attention core on the heads its row slice of proj reads (through
``fused_attention`` where the block would run fused or with fused
attention), proj and fc2 as fp32 partials summed over ``"model"`` and
rounded once. A MoE block's FFN stays replicated. Under sequence
parallelism (``act_sharding``, which ``build_model`` sets) ``embed`` pads
the stream to a multiple of the model axis and keeps the rank's tokens,
and ``features`` gathers the real tokens back. The explainability taps
run there too: each rank computes its heads' softmax weights on the plain
core and the ranks sum them, zeros elsewhere, into every head's maps over
the real tokens; the norm1 tap is the replicated fp32 ``norm1`` output plus
the perturbation, and under sequence parallelism the perturbation is cut to
the rank's tokens (its gradient gathered back whole) and the tap gathered
and cut at the real tokens, as the JAX model slices at ``n_valid``.

Under the GPipe pipeline (``parallel/pipeline.py::Pipeline``) the trunk
holds the mesh's ``PipeAxis`` as ``pipe`` and only its stage's blocks have
weights: ``embed`` and ``features`` run on every pipe rank alike, and the
block stack runs through ``PipeAxis.run``, each block of the stage through
the ordinary ``Block.forward`` a microbatch at a time; on the 3-D mesh the
stage's blocks also hold the ``ModelAxis`` as ``tp`` and their shards, and
run sharded. The taps raise there, as the JAX ``pipelined_forward``
takes none.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rovit_kan_tpu_torch.models.moe import MoEMlp
from rovit_kan_tpu_torch.ops.attention import fused_attention
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
    """Multi-head self-attention (the block's unfused path).

    ``use_fused`` routes ``softmax(q k^T) v`` through ``attn_fn``
    (``fused_attention``, or ``plain_attention`` to hold it against the
    plain versions) on the pre-scaled q; both give fp32, cast to ``dtype``
    after."""

    def __init__(self, dim: int = 192, num_heads: int = 3,
                 dtype: torch.dtype = torch.float32, use_fused: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_fused = use_fused
        self.attn_fn = fused_attention
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def sharded_core(self, qkv: torch.Tensor, tp, fused: bool,
                     return_weights: bool = False):
        """This rank's columns ``[r*D/t, (r+1)*D/t)`` of the attention
        output, in ``dtype``, from the whole ``qkv (B, N, 3D)``: the core
        runs on the heads those columns cross, over the first ``n_valid``
        tokens where filler pads the stream (the filler rows get zeros).
        With ``return_weights`` the core runs plain and also returns every
        head's fp32 softmax weights ``(B, heads, n, n)`` over the real
        tokens: each head's from the rank whose columns hold its first
        column, zeros elsewhere, summed over ``"model"`` (a sum with
        zeros, so the bits are the owner's)."""
        B, N, D3 = qkv.shape
        D, h = D3 // 3, self.num_heads
        hd = D // h
        lo, hi = tp.cols(D)
        h0, h1 = lo // hd, -(-hi // hd)
        n = tp.n_valid or N
        q, k, v = qkv.reshape(B, N, 3, h, hd)[:, :n, :, h0:h1].permute(
            2, 0, 3, 1, 4)
        if fused and not return_weights:
            out = self.attn_fn(q * hd ** -0.5, k, v)
        else:
            logits = torch.matmul((q * hd ** -0.5).float(),
                                  k.float().transpose(-1, -2))
            weights = torch.softmax(logits, dim=-1)
            out = torch.matmul(weights.to(v.dtype).float(), v.float())
        out = out.to(self.dtype).transpose(1, 2).reshape(
            B, n, (h1 - h0) * hd)[..., lo - h0 * hd:hi - h0 * hd]
        if n < N:
            out = torch.cat([out, out.new_zeros(B, N - n, hi - lo)], 1)
        if not return_weights:
            return out
        owned = -(-lo // hd)                # the first head starting here
        whole = weights.new_zeros(B, h, n, n)
        whole[:, owned:h1] = weights.detach()[:, owned - h0:]
        return out, tp.mesh.all_reduce_(whole, "model")

    def forward(self, x: torch.Tensor, return_weights: bool = False):
        """The attention output; with ``return_weights``, also the fp32
        softmax weights ``(B, heads, N, N)`` from the plain path, taken
        before their cast to the compute dtype."""
        B, N, D = x.shape
        h = self.num_heads
        hd = D // h
        qkv = _linear(x, self.qkv, self.dtype)
        q, k, v = qkv.reshape(B, N, 3, h, hd).permute(2, 0, 3, 1, 4)
        weights = None
        if self.use_fused and not return_weights:
            out = self.attn_fn(q * hd ** -0.5, k, v)
        else:
            logits = torch.matmul((q * hd ** -0.5).float(),
                                  k.float().transpose(-1, -2))
            weights = torch.softmax(logits, dim=-1)
            out = torch.matmul(weights.to(v.dtype).float(), v.float())
        out = out.to(self.dtype).transpose(1, 2).reshape(B, N, D)
        out = _linear(out, self.proj, self.dtype)
        return (out, weights) if return_weights else out


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


def _row_partial(x: torch.Tensor, layer: nn.Linear,
                 dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel layer's partial ``x W^T`` in fp32, without the bias:
    the operands rounded to ``dtype`` and multiplied and summed in fp32, so
    the sum over the ranks rounds once, as the one-card GEMM does."""
    return F.linear(x.to(dtype).float(), layer.weight.to(dtype).float())


def _row_output(tp, partial: torch.Tensor, layer: nn.Linear,
                dtype: torch.dtype) -> torch.Tensor:
    """The partials summed over the model axis (this rank's tokens of the
    sum under sequence parallelism), plus the bias, rounded to ``dtype``
    once."""
    out = tp.row_output(partial)
    return (out + layer.bias.to(dtype).float()).to(dtype)


class Block(nn.Module):
    """Pre-LN transformer block: x += MHA(LN(x)); x += MLP(LN(x)).

    ``use_fused_block`` routes the whole block through ``block_fn``
    (``fused_vit_block``, or ``plain_vit_block`` to hold it against the
    plain versions); otherwise ``use_pallas`` routes the attention core
    through ``fused_attention``. The parameters are the same either way.
    ``num_experts > 1`` puts a ``MoEMlp`` (under ``moe``) in place of the
    dense MLP and the block never runs fused."""

    def __init__(self, dim: int = 192, num_heads: int = 3,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32,
                 use_fused_block: bool = False, use_pallas: bool = False,
                 num_experts: int = 0, moe_capacity_factor: float = 2.0):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_fused_block = use_fused_block and num_experts <= 1
        self.block_fn = fused_vit_block
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, dtype, use_fused=use_pallas)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        hidden = int(dim * mlp_ratio)
        if num_experts > 1:
            self.moe = MoEMlp(dim, hidden, num_experts, moe_capacity_factor,
                              dtype)
        else:
            self.mlp = Mlp(dim, hidden, dtype)
        self._kernel_params: Optional[Dict[str, torch.Tensor]] = None
        self._kernel_key: Optional[Tuple] = None
        #: The model axis under tensor parallelism (``parallel/tensor.py``).
        self.tp = None

    @property
    def runs_fused(self) -> bool:
        """Whether a call without taps runs the whole-block kernels: not on
        a tensor-parallel shard."""
        return self.use_fused_block and self.tp is None

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
        until a parameter is replaced or modified in place. While
        ``torch.export`` traces, the tensors have no data pointers, so the
        cast is traced instead of cached; ``export.export_serving`` casts
        the weights beforehand, so there it is the identity."""
        raw = self.block_params()
        if torch.compiler.is_exporting():
            return prepare_block_params(raw, self.dtype)
        key = (self.dtype,) + tuple((t.data_ptr(), t._version)
                                    for t in raw.values())
        if key != self._kernel_key:
            # Ordinary tensors even under inference_mode, so the cache can
            # also serve a later call outside it.
            with torch.inference_mode(False), torch.no_grad():
                self._kernel_params = prepare_block_params(raw, self.dtype)
            self._kernel_key = key
        return self._kernel_params

    def forward(self, x: torch.Tensor, return_weights: bool = False,
                norm1_perturbation: Optional[torch.Tensor] = None):
        """The block's output. With ``return_weights`` or
        ``norm1_perturbation`` the block runs plain and returns ``(out,
        weights, tap)``: the fp32 softmax weights (None unless asked for)
        and the fp32 ``norm1`` output plus the perturbation."""
        taps = return_weights or norm1_perturbation is not None
        if self.tp is not None:
            return self._tp_forward(x, return_weights, norm1_perturbation)
        if self.use_fused_block and not taps:
            return self.block_fn(x.to(self.dtype), self.block_params(),
                                 self.num_heads,
                                 kernel_params=self.kernel_params())
        y = _layer_norm(x, self.norm1)
        if norm1_perturbation is not None:
            y = y + norm1_perturbation
        tap = y
        attn = self.attn(y.to(self.dtype), return_weights)
        attn_out, weights = attn if return_weights else (attn, None)
        x = x + attn_out
        z = _layer_norm(x, self.norm2)
        if hasattr(self, "moe"):
            # Routing sees the fp32 norm2 output, as in the JAX block.
            out = x + self.moe(z)
        else:
            out = x + self.mlp(z.to(self.dtype))
        return (out, weights, tap) if taps else out

    def _tp_forward(self, x: torch.Tensor, return_weights: bool = False,
                    norm1_perturbation: Optional[torch.Tensor] = None):
        """The block on this rank's shards (``parallel/tensor.py``): ``x``
        is the whole stream, or this rank's tokens of it under sequence
        parallelism. The taps are ``forward``'s: the weights of every head
        (``Attention.sharded_core``), and the fp32 ``norm1`` output plus
        the perturbation (both this rank's tokens under sequence
        parallelism); the tap's gradient is ``column_linear``'s, the
        ranks' fp32 partials summed once and rounded where the one-card
        GEMM rounds."""
        tp, dt = self.tp, self.dtype
        taps = return_weights or norm1_perturbation is not None
        fused = self.use_fused_block or self.attn.use_fused
        tap = _layer_norm(x, self.norm1)
        if norm1_perturbation is not None:
            tap = tap + norm1_perturbation
        y = tap.to(dt)
        qkv = tp.gather_columns(tp.column_linear(y, self.attn.qkv, dt))
        a = self.attn.sharded_core(qkv, tp, fused, return_weights)
        a, weights = a if return_weights else (a, None)
        x = x + _row_output(tp, _row_partial(a, self.attn.proj, dt),
                            self.attn.proj, dt)
        z = _layer_norm(x, self.norm2)
        if hasattr(self, "moe"):
            # The FFN is replicated; under sequence parallelism it routes
            # over the whole sequence, filler masked out of the gate.
            if tp.seq:
                y = self.moe(tp.gather_tokens(z), n_valid=tp.n_valid)
                out = x + tp.own_tokens(y)
            else:
                out = x + self.moe(z)
        else:
            h = F.gelu(tp.column_linear(z.to(dt), self.mlp.fc1, dt))  # erf
            out = x + _row_output(tp, _row_partial(h, self.mlp.fc2, dt),
                                  self.mlp.fc2, dt)
        return (out, weights, tap) if taps else out


class VisionTransformer(nn.Module):
    """ViT trunk returning the fp32 CLS feature ``(B, D)``. Raises
    ValueError for ``moe_every < 1`` with ``moe_experts > 1``."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 192, depth: int = 12, num_heads: int = 3,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32,
                 use_fused_block: bool = False, use_pallas: bool = False,
                 remat: bool = False, moe_experts: int = 0,
                 moe_every: int = 2, moe_capacity_factor: float = 2.0):
        super().__init__()
        if moe_experts > 1 and moe_every < 1:
            raise ValueError(f"moe_every must be >= 1 with moe_experts > 1 "
                             f"(got moe_every={moe_every})")
        n_patches = (image_size // patch_size) ** 2
        self.image_size = image_size
        self.remat = remat
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1,
                                                  embed_dim))
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio, dtype, use_fused_block,
                  use_pallas,
                  num_experts=(moe_experts if moe_experts > 1
                               and (i + 1) % moe_every == 0 else 0),
                  moe_capacity_factor=moe_capacity_factor)
            for i in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        #: The model axis under tensor parallelism, and the sequence-
        #: parallel layout ``build_model`` was given (``parallel/tensor.py``).
        self.tp = None
        self.act_sharding = None
        #: The pipe axis under the pipeline (``parallel/pipeline.py``).
        self.pipe = None

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The tokens the first block takes: the patches embedded, the CLS
        token before them and the position embeddings added, in the
        compute dtype; under sequence parallelism, padded and cut to this
        rank's tokens."""
        B = x.shape[0]
        x = self.patch_embed(x)
        cls = self.cls_token.expand(B, -1, -1).to(x.dtype)
        x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        if self.tp is not None and self.tp.seq:
            x = self.tp.split_tokens(x)
        return x

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The fp32 CLS feature of the last block's tokens (the final
        norm); under sequence parallelism the real tokens are gathered
        first."""
        if self.tp is not None and self.tp.seq:
            x = self.tp.gather_replicated(x)
        return _layer_norm(x, self.norm)[:, 0]

    def forward(self, x: torch.Tensor, return_attention: bool = False,
                gradcam_perturbation: Optional[torch.Tensor] = None):
        """x: ``(B, H, W, 3)`` normalized images (NHWC).

        Returns the fp32 CLS feature ``(B, D)``. With ``return_attention``
        or ``gradcam_perturbation`` (a ``(B, N, D)`` fp32 tensor added to the
        last block's ``norm1`` output; pass zeros and differentiate with
        respect to it), returns a dict of ``features`` and what was asked
        for: ``attention`` ``(depth, B, heads, N, N)`` fp32, ``norm1_tap``
        ``(B, N, D)`` fp32."""
        taps = return_attention or gradcam_perturbation is not None
        if taps and self.pipe is not None:
            raise NotImplementedError(
                "the explainability taps are not ported under the "
                "pipeline: run them on the model whole "
                "(Pipeline.full_module)")
        x = self.embed(x)
        if taps:
            return self._forward_taps(x, return_attention,
                                      gradcam_perturbation)
        if self.pipe is not None:
            return self.features(self.pipe.run(x, self.blocks, self.remat))
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat and not blk.runs_fused:
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
        return self.features(x)

    def _forward_taps(self, x: torch.Tensor, return_attention: bool,
                      perturbation: Optional[torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        maps, out = [], {}
        last = len(self.blocks) - 1
        seq = self.tp is not None and self.tp.seq
        if seq and perturbation is not None:
            perturbation = self.tp.split_tap(perturbation)
        for i, blk in enumerate(self.blocks):
            perturb = perturbation if i == last else None
            if return_attention or perturb is not None:
                x, weights, tap = blk(x, return_attention, perturb)
                if return_attention:
                    maps.append(weights)
                if perturb is not None:
                    # Every rank's real tokens under sequence parallelism.
                    out["norm1_tap"] = (self.tp.gather_replicated(tap)
                                        if seq else tap)
            else:
                # Before the tap: nothing here depends on the perturbation.
                with torch.no_grad():
                    x = blk(x)
        out["features"] = self.features(x)
        if return_attention:
            out["attention"] = torch.stack(maps)
        return out


class DeiTTinyBackbone(nn.Module):
    """The reference's backbone wrapper: the trunk lives under ``model``, so
    state_dict keys read ``backbone.model.blocks.{i}...``."""

    def __init__(self, **kw):
        super().__init__()
        self.model = VisionTransformer(**kw)

    def forward(self, x: torch.Tensor, **taps):
        return self.model(x, **taps)
