"""Tensor and sequence parallelism over the 2-D ``("data", "model")`` mesh,
and expert parallelism over the ``("data", "expert")`` mesh.

Counterpart of ``rovit_kan_tpu/parallel/tensor.py``. The JAX package gives
GSPMD a ``PartitionSpec`` per leaf and lets XLA insert the collectives; the
port runs one process per card and does both by hand: ``TensorParallel``
keeps each rank's shard of each leaf, and the model's blocks call the
Megatron collectives over the ``"model"`` axis of ``parallel/mesh.py``.

The rules are the JAX ``_RULES``, read on the JAX layout, which
``models/convert.py`` maps to the port's (a Linear weight is the JAX kernel
transposed, so "column" is dimension 0 of a torch weight):

- ``attn.qkv`` and ``mlp.fc1``: weight and bias sharded by column (each
  rank computes a contiguous slice of the output features);
- ``attn.proj`` and ``mlp.fc2``: weight sharded by row (each rank holds a
  contiguous slice of the input features), bias replicated;
- every other leaf (patch embedding, LayerNorms, CLS and position
  embeddings, MoE experts, heads, KAN) replicated.

A dimension that the model axis does not divide falls back to replicated
alone (``shard_params``, the JAX per-axis fallback). The sharded block needs
all four of its Linear pairs sharded; ``TensorParallel`` refuses a block
whose rule fell back.

The sharded block (``models/vit.py::Block``), on model rank r of t:

    y = LN1(x) -> qkv on this rank's columns (B, N, 3D/t) (y's gradient:
    the fp32 partials all-reduced) -> all-gather over "model" (B, N, 3D) -> the
    attention core on the heads that proj's row slice [r*D/t, (r+1)*D/t)
    reads -> proj on those rows, an fp32 partial -> all-reduce in fp32 ->
    + bias, rounded to the compute dtype once -> residual; LN2 -> fc1 on
    this rank's columns -> GELU -> fc2 partial -> all-reduce -> + bias.

The JAX ``[q | k | v]`` column layout is not aligned to heads, hence the
all-gather of qkv. Where t does not divide the head count (the flagship's 3
heads over t = 2: rank 0 runs heads {0, 1}, rank 1 heads {1, 2}) a head
runs on two ranks, and the gather's backward, a reduce-scatter, sums its two
gradients. The attention core is ``ops/attention.py::fused_attention`` (#5,
#6) where the model's policy takes the fused block or fused attention, and
the plain core elsewhere; the whole-block kernels #1-#4 take a whole block
and never run on a sharded one.

Sequence parallelism (``seq_sharding``, the model's ``act_sharding``): the
residual stream between blocks is sharded over tokens on ``"model"``, after
padding with filler tokens until t divides the token count (197 -> 198 at
224 px). LayerNorms and residual adds run on the rank's tokens; each
column-parallel input is all-gathered over tokens (its gradient
reduce-scattered) and each row-parallel output reduce-scattered over tokens
(its gradient all-gathered). The attention core runs on the first
``n_valid`` tokens, so filler tokens are never keys, and their rows get
zeros; a MoE block gathers its tokens and masks the filler out of its gate
(``models/moe.py``); the filler rows are dropped before the final norm. The
replicated backbone leaves that act on the rank's tokens (everything but
the final norm) then hold partial gradients, summed over ``"model"`` before
the data axis's reduce (``training/optimizer.py::reduce_grads``).

Every collective's sum runs in fp32 and rounds to the compute dtype once,
after the sum, where the one-process GEMM rounds: the row-parallel outputs
in the forward and the column-parallel inputs' gradients in the backward.

Expert parallelism (``make_moe_mesh``, ``moe_param_specs``,
``ExpertParallel``): the JAX ``moe_param_specs`` shards the stacked expert
leaves of every MoE block on their expert dim over ``"expert"``, the gate
and every dense leaf replicated. ``ExpertParallel`` keeps rank r's experts
and gives each ``MoEMlp`` an ``ExpertAxis``: the layer routes the rows of
its data index with the whole gate, runs its own experts, and sums the
ranks' fp32 partials of the combine over ``"expert"`` (``models/moe.py``).
The layer's replicated inputs, ``x`` and the gate weight, enter through
``_ExpertInput``, whose backward sums their partial gradients over
``"expert"`` once; every other replicated leaf's gradient is whole and
equal on the expert ranks, so the data axis alone reduces it. The JAX
package lets GSPMD turn the dispatch and combine into all-to-alls; the
port's one all-reduce of the combine a MoE layer computes the same sums.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn as nn

from rovit_kan_tpu_torch.models.convert import _jax_path
from rovit_kan_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_2d_mesh,
    make_moe_mesh,
)

#: (JAX path suffix, JAX leaf name) -> the JAX spec, one entry a JAX dim.
_RULES = (
    (("attn", "qkv"), "kernel", (None, "model")),
    (("attn", "qkv"), "bias", ("model",)),
    (("attn", "proj"), "kernel", ("model", None)),
    (("attn", "proj"), "bias", ()),
    (("mlp", "fc1"), "kernel", (None, "model")),
    (("mlp", "fc1"), "bias", ("model",)),
    (("mlp", "fc2"), "kernel", ("model", None)),
    (("mlp", "fc2"), "bias", ()),
)

#: The backbone's final LayerNorm: it runs on the gathered tokens, so its
#: gradient is whole on every model rank even under sequence parallelism.
FINAL_NORM = "backbone.model.norm."

Specs = Dict[str, Optional[int]]


def path_spec(path: Tuple[str, ...]) -> Tuple[Optional[str], ...]:
    """The JAX Megatron rule of the leaf at a JAX ``path``: one axis name (or
    None) a JAX dim, ``()`` for a replicated leaf."""
    for suffix, leaf, spec in _RULES:
        if path[-1] == leaf and path[-1 - len(suffix):-1] == suffix:
            return spec
    return ()


def jax_spec(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The JAX ``param_specs`` entry of a port leaf, one axis name (or None)
    a JAX dim, with trailing Nones dropped as ``PartitionSpec`` prints."""
    return path_spec(_jax_path(name, ndim)[0])


def _rule_dim(name: str, ndim: int) -> Optional[int]:
    path, transpose = _jax_path(name, ndim)
    spec = jax_spec(name, ndim)
    if "model" not in spec:
        return None
    d = spec.index("model")
    return ndim - 1 - d if transpose else d


def shapes_of(model_or_state) -> Dict[str, Tuple[int, ...]]:
    """Each leaf's whole shape: a model's or state_dict's, or, for a
    ``TensorParallel`` wrapper, the unsharded model's."""
    full = getattr(model_or_state, "full_shapes", None)
    if full is not None:
        return dict(full)
    if isinstance(model_or_state, nn.Module):
        return {k: tuple(p.shape)
                for k, p in model_or_state.named_parameters()}
    return {k: tuple(v.shape) for k, v in dict(model_or_state).items()}


def param_specs(model_or_state) -> Specs:
    """Each leaf's name -> the port dimension the Megatron rules shard over
    ``"model"``, or None (replicated): the JAX ``param_specs`` in the port's
    layout, before any divisibility fallback."""
    return {k: _rule_dim(k, len(s))
            for k, s in shapes_of(model_or_state).items()}


def mesh_specs(shapes: Dict[str, Tuple[int, ...]], specs: Specs,
               mesh: Mesh, axis: str = "model") -> Specs:
    """``specs`` with the JAX per-axis fallback: a dimension ``axis`` does
    not divide is replicated."""
    t = mesh.axis_size(axis)
    return {k: (d if d is not None and shapes[k][d] % t == 0 else None)
            for k, d in ((k, specs.get(k)) for k in shapes)}


def shard_params(state, mesh: Mesh, specs: Optional[Specs] = None,
                 axis: str = "model") -> Dict[str, torch.Tensor]:
    """This rank's part of each tensor of a whole state_dict under
    ``specs`` (default: ``param_specs``) over ``axis`` with the per-axis
    fallback: a contiguous chunk of each sharded leaf, the tensor itself
    otherwise."""
    shapes = shapes_of(state)
    eff = mesh_specs(shapes, param_specs(state) if specs is None else specs,
                     mesh, axis)
    n, r = mesh.axis_size(axis), mesh.axis_rank(axis)
    return {k: (v.chunk(n, eff[k])[r] if eff[k] is not None else v)
            for k, v in state.items()}


def megatron_specs(model: nn.Module, mesh: Mesh,
                   specs: Optional[Specs] = None) -> Specs:
    """``specs`` (default: ``param_specs``) over the mesh's ``"model"`` axis
    with the per-axis fallback; raises ValueError where a block's Megatron
    pair fell back, since the sharded block needs all of them sharded."""
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    out = mesh_specs(shapes, param_specs(model) if specs is None else specs,
                     mesh)
    for i, blk in enumerate(model.backbone.model.blocks):
        pre = f"backbone.model.blocks.{i}."
        dense = ("attn.qkv", "attn.proj") + (
            () if hasattr(blk, "moe") else ("mlp.fc1", "mlp.fc2"))
        off = [k for k in dense if out[pre + k + ".weight"] is None]
        if off:
            raise ValueError(
                f"tensor parallelism over {mesh.model_size} ranks: "
                f"block {i}'s {off} do not divide (d = "
                f"{blk.norm1.normalized_shape[0]}); the sharded block "
                f"needs every Megatron pair sharded")
    return out


def partial_leaf(name: str, model_sharded: Iterable[str]) -> bool:
    """Whether a leaf's gradient is a partial sum on each model rank under
    sequence parallelism: a replicated backbone leaf other than the final
    norm (it acts on the rank's tokens only)."""
    return (name.startswith("backbone.") and name not in model_sharded
            and not name.startswith(FINAL_NORM))


def flat_order(names: List[str], data_sharded=frozenset(),
               model_sharded=frozenset()) -> List[str]:
    """The optimizer's parameter order over a sharded model: the backbone's
    data-sharded leaves, its data-whole ones, the heads' data-whole ones,
    the heads' data-sharded ones (so the data-whole leaves, whose gradients
    are all-reduced over ``"data"``, are one slice); within each, the
    model-sharded leaves, then the ones ``partial_leaf`` names, then the
    rest, each in the model's order."""
    def key(k):
        bb, d = k.startswith("backbone."), k in data_sharded
        major = (0 if d else 1) if bb else (3 if d else 2)
        minor = (0 if k in model_sharded else
                 1 if partial_leaf(k, model_sharded) else 2)
        return major, minor
    return sorted(names, key=key)


@dataclasses.dataclass(frozen=True)
class SeqSharding:
    """Sequence parallelism's layout of the ``(B, N, D)`` residual stream:
    batch over ``batch_axis`` (None on a mesh without it), tokens over
    ``axis``. What the JAX ``seq_sharding`` gives the model as
    ``act_sharding``."""
    mesh: Mesh
    axis: str = "model"
    batch_axis: Optional[str] = "data"


def seq_sharding(mesh: Mesh, axis: str = "model",
                 batch_axis: str = "data") -> SeqSharding:
    """The sequence-parallel layout for ``build_model(cfg,
    act_sharding=...)``: tokens over ``axis``, batch over ``batch_axis``
    where the mesh has it."""
    b = batch_axis if batch_axis in mesh.axis_names else None
    return SeqSharding(mesh, axis, b)


# -- the Megatron conjugate operators ----------------------------------------

class _ColumnInput(torch.autograd.Function):
    """The input gradient of a column-parallel layer ``out = y W_r^T + b_r``
    (the layer itself runs on ``y`` detached, so autograd gives it only the
    weight and bias gradients): identity on ``out`` forward; backward, this
    rank's partial ``g W_r`` in fp32, summed over ``"model"`` (all-reduced,
    or reduce-scattered over tokens under sequence parallelism) and rounded
    to ``y``'s dtype once, where the one-card GEMM rounds."""

    @staticmethod
    def forward(ctx, out, y, weight, axis):
        ctx.save_for_backward(weight)
        ctx.axis, ctx.dtype = axis, y.dtype
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        weight, = ctx.saved_tensors
        partial = torch.matmul(g.float(), weight.to(g.dtype).float())
        ax = ctx.axis
        if ax.seq:
            gy = ax.mesh.reduce_scatter(partial, 1, "model")
        else:
            gy = ax.mesh.all_reduce_(partial, "model")
        return g, gy.to(ctx.dtype), None, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over ``"model"`` forward (in fp32, rounded once),
    identity backward (after a row-parallel layer)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.to(torch.float32, copy=True),
                                "model").to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    """All-gather over ``"model"`` along ``dim`` forward; the gradient
    reduce-scattered back (each rank's use of the whole is a partial)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(x, dim, "model").contiguous()

    @staticmethod
    def backward(ctx, g):
        out = ctx.mesh.reduce_scatter(g.float(), ctx.dim, "model")
        return out.to(g.dtype).contiguous(), None, None


class _ScatterModel(torch.autograd.Function):
    """Reduce-scatter over ``"model"`` along ``dim`` forward (in fp32,
    rounded once); the gradient all-gathered back."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        out = mesh.reduce_scatter(x.float(), dim, "model")
        return out.to(x.dtype).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_gather(g, ctx.dim, "model").contiguous(),
                None, None)


class _GatherReplicated(torch.autograd.Function):
    """All-gather over ``"model"`` along ``dim`` for a computation every
    rank repeats alike: the gradient is the same on every rank, and each
    keeps its own chunk of it."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(x, dim, "model").contiguous()

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return (g.chunk(m.model_size, ctx.dim)[m.model_rank].contiguous(),
                None, None)


class _SplitTap(torch.autograd.Function):
    """The whole ``(B, N, D)`` Grad-CAM perturbation padded with zero
    filler and cut to this rank's tokens forward; backward, every rank's
    gradient of its tokens gathered over ``"model"`` and cut back to the
    real tokens, so each rank holds the whole gradient."""

    @staticmethod
    def forward(ctx, p, axis):
        ctx.axis = axis
        return axis.split_tokens(p).contiguous()

    @staticmethod
    def backward(ctx, g):
        ax = ctx.axis
        whole = ax.mesh.all_gather(g.contiguous(), 1, "model")
        return whole[:, :ax.n_tokens].contiguous(), None


class ModelAxis:
    """What a sharded block and the trunk need of the model axis: this
    rank's place on it, whether the residual stream is token-sharded
    (``seq``), the real token count and the padded one, and the
    collectives."""

    def __init__(self, mesh: Mesh, seq: bool, n_tokens: int):
        self.mesh = mesh
        self.size, self.rank = mesh.model_size, mesh.model_rank
        self.seq = seq
        self.n_tokens = n_tokens
        self.n_padded = (-(-n_tokens // self.size) * self.size if seq
                         else n_tokens)
        #: The real tokens where filler pads the stream, else None.
        self.n_valid = n_tokens if self.n_padded != n_tokens else None

    def cols(self, width: int) -> Tuple[int, int]:
        """This rank's contiguous slice of ``width`` features."""
        per = width // self.size
        return self.rank * per, (self.rank + 1) * per

    def column_linear(self, y: torch.Tensor, layer: nn.Linear,
                      dtype: torch.dtype) -> torch.Tensor:
        """A column-parallel layer on this rank's rows of its weight, in
        ``dtype``: on every rank's tokens under sequence parallelism (``y``
        gathered), else on ``y``; ``y``'s gradient is ``_ColumnInput``'s."""
        y0 = y.detach()
        full = (self.mesh.all_gather(y0, 1, "model") if self.seq
                else y0).to(dtype)
        out = torch.nn.functional.linear(full, layer.weight.to(dtype),
                                         layer.bias.to(dtype))
        return _ColumnInput.apply(out, y, layer.weight, self)

    def row_output(self, partial: torch.Tensor) -> torch.Tensor:
        """A row-parallel layer's fp32 partials summed over the ranks: this
        rank's tokens of the sum under sequence parallelism."""
        if self.seq:
            return _ScatterModel.apply(partial, self.mesh, 1)
        return _ReduceFromModel.apply(partial, self.mesh)

    def gather_columns(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's columns of ``t`` along its last dim."""
        return _GatherModel.apply(t, self.mesh, t.dim() - 1)

    def split_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The whole stream ``(B, N, D)`` padded with zero filler tokens to
        ``n_padded``; this rank's contiguous chunk of it."""
        pad = self.n_padded - x.shape[1]
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[0], pad, x.shape[2])], 1)
        return x.chunk(self.size, 1)[self.rank]

    def split_tap(self, p: torch.Tensor) -> torch.Tensor:
        """This rank's tokens of the whole perturbation ``p``, whose
        gradient comes back whole (``_SplitTap``)."""
        return _SplitTap.apply(p, self)

    def gather_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's tokens, for a layer that needs the whole sequence
        (its gradient reduce-scattered back)."""
        return _GatherModel.apply(x, self.mesh, 1)

    def own_tokens(self, x: torch.Tensor) -> torch.Tensor:
        return x.chunk(self.size, 1)[self.rank]

    def gather_replicated(self, x: torch.Tensor) -> torch.Tensor:
        """The whole stream's real tokens on every rank, for the final norm
        and the heads, which every rank runs alike."""
        return _GatherReplicated.apply(x, self.mesh, 1)[:, :self.n_tokens]


# -- the layout of a sharded training state ----------------------------------

class ShardedState:
    """The whole-state conversions a sharded wrapper shares (``FSDP``,
    ``TensorParallel``, ``ExpertParallel``, ``pipeline.Pipeline``): the
    one-process optimizer layout of its flat buffers. A subclass gives
    ``mesh``, ``full_shapes``, ``named_parameters``, ``state_tensors``,
    ``gather_full`` and ``local``."""

    def full_order(self) -> List[str]:
        """The one-process ``FlatAdamW``'s parameter order."""
        return sorted(self.full_shapes,
                      key=lambda k: not k.startswith("backbone."))

    @staticmethod
    def _split(flat: torch.Tensor, names: List[str],
               shapes: Dict[str, Tuple[int, ...]]
               ) -> Dict[str, torch.Tensor]:
        sizes = [int(torch.Size(shapes[k]).numel()) for k in names]
        return {k: t.view(shapes[k])
                for k, t in zip(names, torch.split(flat, sizes))}

    def gather_flat(self, flat: torch.Tensor) -> Optional[torch.Tensor]:
        """A buffer in the layout of the optimizer over this wrapper (its
        parameters, moments or gradients) whole, in the one-process
        optimizer's layout, on the host of rank 0; None on the others.
        Collective, as ``gather_full``."""
        names = [k for k, _ in self.named_parameters()]
        local = {k: tuple(v.shape) for k, v in self.state_tensors().items()}
        full = self.gather_full(self._split(flat, names, local))
        return None if full is None else torch.cat(
            [full[k].reshape(-1) for k in self.full_order()])

    def full_opt_state(self, state: Dict) -> Optional[Dict]:
        """The optimizer's state (``FlatAdamW.state_dict`` over this
        wrapper) in the one-process optimizer's layout, on rank 0; None on
        the others. Collective, as ``gather_full``."""
        out = {**state, "names": self.full_order()}
        for key in ("mu", "nu", "acc"):
            if state.get(key) is not None:
                out[key] = self.gather_flat(state[key])
        return out if self.mesh.global_rank == 0 else None

    def local_opt_state(self, state: Dict) -> Dict:
        """A one-process optimizer state cut to this rank's layout; raises
        ValueError where it was written for other parameters."""
        order = self.full_order()
        if list(state["names"]) != order or state["mu"].numel() != sum(
                int(torch.Size(s).numel())
                for s in self.full_shapes.values()):
            raise ValueError("optimizer state of another structure: other "
                             "parameters")
        names = [k for k, _ in self.named_parameters()]
        out = {**state, "names": names}
        for key in ("mu", "nu", "acc"):
            if state.get(key) is None:
                continue
            part = self.local(self._split(state[key], order,
                                          self.full_shapes))
            out[key] = torch.cat([part[k].reshape(-1) for k in names])
        return out


class ShardedModel(ShardedState):
    """The model's interface of a wrapper that holds this rank's part of
    the model over one axis of the mesh (``shard_axis``), where the train
    and eval steps and the optimizer take the model (``TensorParallel``,
    ``ExpertParallel``, ``pipeline.Pipeline``): ``_params``, this rank's
    tensors by name, ``model_sharded`` those that are its own (the others
    whole on every rank; the flat AdamW sums their squares over
    ``shard_axis``). A subclass sets ``model``, ``mesh``, ``model_sharded``,
    ``partial`` and ``_params``."""

    #: The mesh axis the leaves are sharded over.
    shard_axis = "model"

    def named_parameters(self) -> List[Tuple[str, torch.Tensor]]:
        return [(k, self._params[k]) for k in
                flat_order(list(self._params), (), self.model_sharded)]

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        """The trained tensors (shards and whole leaves) in the model's
        order."""
        return dict(self._params)

    @property
    def leaf_axes(self) -> Dict[str, Tuple[str, ...]]:
        """Each of this rank's cut leaves -> the mesh axes beside the data
        axis it is cut over (the flat AdamW sums its squares over them,
        ``fsdp.sharded_size`` divides its bytes by them): ``shard_axis``
        for each of ``model_sharded``."""
        return {k: (self.shard_axis,) for k in self.model_sharded}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self._params.items()}

    def parameters(self):
        return iter(self._params.values())

    def train(self, mode: bool = True) -> "AxisSharded":
        self.model.train(mode)
        return self

    def eval(self) -> "AxisSharded":
        return self.train(False)

    @property
    def head_mask(self) -> Dict[str, bool]:
        return self.model.head_mask

    @property
    def backbone(self) -> nn.Module:
        return self.model.backbone

    @property
    def image_size(self) -> int:
        return self.model.image_size

    def modules(self):
        return self.model.modules()

    def __call__(self, x: torch.Tensor, generator=None,
                 **taps) -> Dict[str, torch.Tensor]:
        """The model's outputs; ``taps`` (``return_attention``,
        ``gradcam_perturbation``) as ``RoViTKAN.forward`` takes them."""
        return self.model(x, generator=generator, **taps)


class AxisSharded(ShardedModel):
    """A ``ShardedModel`` whose sharded leaves are each cut contiguously
    along ``specs[name]`` over ``shard_axis``, and its whole-state
    conversions. A subclass also sets ``specs`` and ``axis`` (what
    ``_attach`` gives the modules) and gives ``_attach``."""

    def _cut(self) -> None:
        """Keep this rank's chunk of each sharded leaf (the model's
        parameters are then the shards; ``full_shapes`` keeps the whole
        shapes) and attach the axis."""
        self.full_shapes = {k: tuple(p.shape)
                            for k, p in self._params.items()}
        self.device = next(self.model.parameters()).device
        n = self.mesh.axis_size(self.shard_axis)
        r = self.mesh.axis_rank(self.shard_axis)
        with torch.no_grad():
            for k in self.model_sharded:
                p = self._params[k]
                p.data = p.data.chunk(n, self.specs[k])[r].clone()
        self._attach(self.axis)

    def _attach(self, axis) -> None:
        raise NotImplementedError

    def full_leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``name`` whole from this rank's chunk ``t`` (collective
        over ``shard_axis``; ``t`` itself for a replicated leaf)."""
        d = self.specs.get(name)
        if d is None:
            return t
        return self.mesh.all_gather(t, d, self.shard_axis).contiguous()

    def local(self, full: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """This rank's part of each tensor of a whole state_dict (no
        collective)."""
        n = self.mesh.axis_size(self.shard_axis)
        r = self.mesh.axis_rank(self.shard_axis)
        return {k: (v.chunk(n, self.specs[k])[r]
                    if k in self.model_sharded else v)
                for k, v in full.items()}

    @torch.no_grad()
    def gather_full(self, state: Optional[Dict[str, torch.Tensor]]
                    ) -> Optional[Dict[str, torch.Tensor]]:
        """A shard-level state_dict whole, on the host of rank 0; None on
        the other ranks. Every rank must call it."""
        if state is None:
            return None
        keep = self.mesh.global_rank == 0
        out = {}
        for k, v in state.items():
            v = self.full_leaf(k, v.to(self.device))
            if keep:
                out[k] = v.detach().to("cpu", copy=True)
        return out if keep else None

    @contextlib.contextmanager
    def full_module(self, weights: Optional[Dict[str, torch.Tensor]] = None,
                    keep: bool = False):
        """The model whole and unsharded meanwhile (its blocks run as on
        one card): each sharded leaf gathered (from ``weights``, a
        ``state_dict``-layout dict, where given; the live shards else) and
        each whole leaf from ``weights`` where given. With ``keep``, the
        module's weights at the exit become the shards' (and the whole
        leaves stay as they were left). At the exit the module is sharded
        again, its fused blocks' weight caches cleared."""
        src = self.state_dict() if weights is None else weights
        kept = {}
        try:
            for k, p in self._params.items():
                kept[k] = p.data
                if k in self.model_sharded:
                    p.data = self.full_leaf(k, src[k].to(self.device))
                elif weights is not None:
                    p.data = weights[k].to(self.device, copy=True)
            self._attach(None)
            yield self.model
            if keep:
                with torch.no_grad():
                    for k in self.model_sharded:
                        kept[k].copy_(self.local(
                            {k: self._params[k].data})[k])
        finally:
            for k, p in self._params.items():
                p.data = kept[k]
            self._attach(self.axis)


class TensorParallel(AxisSharded):
    """A ``RoViTKAN`` whose blocks are sharded over the mesh's ``"model"``
    axis by ``specs`` (default: ``param_specs`` with the fallback), with
    sequence parallelism where ``seq`` (default: the model's
    ``act_sharding``) is given.

    It stands where the model stands in ``make_train_step``,
    ``make_eval_step`` and ``build_optimizer``, as ``parallel/fsdp.py::
    FSDP`` does: ``tp(x, generator)``, ``train()``, ``eval()``,
    ``head_mask``, ``parameters()``. Built from a model whose weights are
    the same on every rank, it replaces each sharded leaf's data with this
    rank's contiguous chunk (the model's parameters are then the shards;
    ``full_shapes`` keeps the whole shapes) and gives the trunk and its
    blocks the ``ModelAxis``. ``named_parameters`` is ``flat_order``'s:
    ``model_sharded`` names the sharded leaves, ``partial`` the leaves whose
    gradients are partial under sequence parallelism. ``full_module``
    gathers the model whole and unsharded for a while. The explainability
    taps run on it as on the model (``models/vit.py``), so
    ``explainability/`` takes it as it takes a model."""

    shard_axis = "model"

    def __init__(self, model: nn.Module, mesh: Mesh,
                 specs: Optional[Specs] = None,
                 seq: Optional[SeqSharding] = None):
        if "model" not in mesh.axis_names:
            raise ValueError(f"tensor parallelism needs a 'model' axis on "
                             f"the mesh (got {mesh.axis_names})")
        vit = model.backbone.model
        seq = seq if seq is not None else getattr(vit, "act_sharding", None)
        self.model, self.mesh, self.seq = model, mesh, seq
        self._params = dict(model.named_parameters())
        self.specs = megatron_specs(model, mesh, specs)
        self.model_sharded = frozenset(
            k for k, d in self.specs.items() if d is not None)
        self.partial = (frozenset(k for k in self._params
                                  if partial_leaf(k, self.model_sharded))
                        if seq is not None else frozenset())
        self.axis = ModelAxis(mesh, seq is not None, vit.pos_embed.shape[1])
        self._cut()

    def _attach(self, axis: Optional[ModelAxis]) -> None:
        vit = self.model.backbone.model
        vit.tp = axis
        for blk in vit.blocks:
            blk.tp = axis
            blk._kernel_params = blk._kernel_key = None


# -- expert parallelism -------------------------------------------------------

def moe_param_specs(model_or_state) -> Specs:
    """Each leaf's name -> the port dimension sharded over ``"expert"``, or
    None: the JAX ``moe_param_specs``, ``w1``, ``b1``, ``w2`` and ``b2`` of
    every MoE block on dim 0 (the experts, the same dim in both layouts),
    the gate and every dense leaf replicated."""
    return {k: (0 if ".moe." in f".{k}" and k.rsplit(".", 1)[-1] in
                ("w1", "b1", "w2", "b2") else None)
            for k in shapes_of(model_or_state)}


class _ExpertInput(torch.autograd.Function):
    """Identity forward on an input every expert rank holds whole (the MoE
    layer's ``x`` and its gate weight); backward, this rank's gradient, a
    partial since its experts see only their slots, summed over
    ``"expert"`` in fp32."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        total = ctx.mesh.all_reduce_(g.to(torch.float32, copy=True)
                                     .contiguous(), "expert")
        return total.to(g.dtype), None


class _ReduceFromExpert(torch.autograd.Function):
    """The ranks' fp32 partials of the combine summed over ``"expert"``
    forward; identity backward (every rank's output gradient is whole)."""

    @staticmethod
    def forward(ctx, partial, mesh):
        return mesh.all_reduce_(partial.to(torch.float32, copy=True)
                                .contiguous(), "expert")

    @staticmethod
    def backward(ctx, g):
        return g, None


class ExpertAxis:
    """What a sharded ``MoEMlp`` needs of the ``"expert"`` axis: this
    rank's experts and the two collectives (``models/moe.py``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.size = mesh.axis_size("expert")
        self.rank = mesh.axis_rank("expert")

    def experts(self, num_experts: int) -> Tuple[int, int]:
        """This rank's contiguous experts ``[lo, hi)``."""
        per = num_experts // self.size
        return self.rank * per, (self.rank + 1) * per

    def input(self, t: torch.Tensor) -> torch.Tensor:
        return _ExpertInput.apply(t, self.mesh)

    def combine(self, partial: torch.Tensor) -> torch.Tensor:
        return _ReduceFromExpert.apply(partial, self.mesh)


class ExpertParallel(AxisSharded):
    """A MoE ``RoViTKAN`` whose experts are sharded over the mesh's
    ``"expert"`` axis by ``specs`` (default: ``moe_param_specs``): rank r
    keeps experts ``[r*E/ep, (r+1)*E/ep)`` of every MoE block, the gate and
    every dense leaf whole, and each ``MoEMlp`` gets the ``ExpertAxis``
    (``models/moe.py``). The interface is ``TensorParallel``'s; the dense
    leaves' gradients are whole and equal on every expert rank, so only
    the data axis reduces them, and the experts' squares are summed over
    ``"expert"`` in the flat AdamW's norm. Refuses a mesh without the axis,
    a model without MoE blocks and an expert count the axis does not
    divide."""

    shard_axis = "expert"

    def __init__(self, model: nn.Module, mesh: Mesh,
                 specs: Optional[Specs] = None):
        if "expert" not in mesh.axis_names:
            raise ValueError(f"expert parallelism needs an 'expert' axis on "
                             f"the mesh (got {mesh.axis_names})")
        vit = model.backbone.model
        self.model, self.mesh = model, mesh
        self._params = dict(model.named_parameters())
        shapes = {k: tuple(p.shape) for k, p in self._params.items()}
        self.specs = mesh_specs(shapes,
                                moe_param_specs(model) if specs is None
                                else specs, mesh, "expert")
        moes = [(i, blk.moe) for i, blk in enumerate(vit.blocks)
                if hasattr(blk, "moe")]
        if not moes:
            raise ValueError("expert parallelism needs MoE blocks "
                             "(moe_experts > 1)")
        for i, moe in moes:
            if self.specs[f"backbone.model.blocks.{i}.moe.w1"] is None:
                raise ValueError(
                    f"expert parallelism over {mesh.axis_size('expert')} "
                    f"ranks: "
                    f"block {i}'s {moe.num_experts} experts do not divide")
        self.model_sharded = frozenset(
            k for k, d in self.specs.items() if d is not None)
        self.partial = frozenset()
        self.axis = ExpertAxis(mesh)
        self._cut()

    def _attach(self, axis: Optional[ExpertAxis]) -> None:
        for blk in self.model.backbone.model.blocks:
            if hasattr(blk, "moe"):
                blk.moe.ep = axis


def shard_state(state, tp: ShardedState):
    """A whole ``training.trainer.TrainState`` (the one-process layout) cut
    to the rank of ``tp`` (a ``TensorParallel``, ``ExpertParallel`` or
    ``pipeline.Pipeline`` wrapper): the parameters and the EMA by ``local``, the flat
    AdamW's moments by ``local_opt_state``; the step count as it is."""
    return dataclasses.replace(
        state, params=tp.local(state.params),
        opt_state=tp.local_opt_state(state.opt_state),
        ema_params=(None if state.ema_params is None
                    else tp.local(state.ema_params)))
