"""Fully sharded data parallelism (ZeRO-3) over the data mesh.

Counterpart of ``rovit_kan_tpu/parallel/fsdp.py``. The parameters, their
gradients, the AdamW moments and the EMA are sharded over the data ranks
instead of copied to each, so a rank's training state is about 1/N of it.

The rule is the JAX package's (``fsdp_param_specs``): a leaf with fewer
than ``min_size`` elements stays whole on every rank, and so does one with
no dimension that the mesh size divides (and that is at least the mesh
size); any other leaf is split along its largest such dimension, the
highest index winning a tie. The rule reads each leaf in the JAX layout,
which ``models/convert.py`` maps to the port's: a Linear weight is the
transpose of the JAX kernel, so the JAX ``qkv/kernel (192, 576)``, split on
its dim 1, is the port's ``attn.qkv.weight (576, 192)`` split on dim 0.
Every other leaf has the JAX shape. So rank r's shard of a leaf holds the
elements JAX's device r holds.

XLA derives the ZeRO-3 schedule from the layout; the port runs it by hand
(``FSDP``), one unit per natural group of the model: the patch embedding
with the CLS and position embeddings; each block; the final norm, the
heads and the KAN module together. A unit's sharded weights are
all-gathered just before its forward and freed after it, gathered again
for its backward, and its gradient is reduce-scattered into this rank's
shard as soon as its backward ends. At most one unit is gathered at a
time (``FSDP.live`` counts them). A fused block unit runs the block
kernels on the gathered weights: #1 in the forward, #2 (or #3/#4 with
``ROVIT_BLOCK_RESIDUAL_BWD=1``) in the backward, the launches of the
data-parallel step. Each weight is cast to the compute dtype on the shard
before the gather, the per-element cast of ``prepare_block_params``, so the
gather of a bf16 block moves half the bytes; nothing cast is kept between
gathers, so no cache can serve weights from before an update. Every other
unit runs its forward without autograd and, in the backward, again with
autograd on the re-gathered weights (the random state its dropout draws
from put back first), so that only the unit's input is kept between the
two.

Whole leaves keep data parallelism's ``all_reduce`` of their gradient
(``training/trainer.py``).

FSDP+TP (``fsdp_param_specs(..., tp=True)`` on a 2-D mesh, ``FSDP(model,
mesh, specs, tp=TensorParallel(...))``): the Megatron rule of
``parallel/tensor.py`` claims its dimension first, and the JAX rule then
shards the largest dimension left over the data axis (its sizes read on the
whole leaf). The units gather and reduce-scatter over ``"data"`` only, each
on the leaf that is already this rank's tensor-parallel shard; a block unit
then runs the sharded block (``models/vit.py``) with its collectives over
``"model"``, never the fused block. ``local``, ``gather_full`` and
``full_module`` go through both axes.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn as nn

from rovit_kan_tpu_torch.models.convert import _jax_path
from rovit_kan_tpu_torch.models.heads import GlobalRows
from rovit_kan_tpu_torch.ops.block_kernel import (
    PKEYS,
    WEIGHT_KEYS,
    _backward,
    _forward,
    _forward_res,
    _residual_bwd,
    plain_vit_block,
)
from rovit_kan_tpu_torch.parallel.mesh import Mesh
from rovit_kan_tpu_torch.parallel.tensor import (
    ShardedState,
    flat_order,
    jax_spec,
    shapes_of,
)

MIN_SIZE = 4096

#: The model's outputs, in the order the last unit returns them.
OUTPUT_KEYS = ("features", "cls_logits", "ordinal_logits", "mu", "log_var",
               "kan_severity")

Specs = Dict[str, Optional[int]]


def _tree(model_or_state) -> Dict[str, torch.Tensor]:
    if isinstance(model_or_state, nn.Module):
        return dict(model_or_state.named_parameters())
    if hasattr(model_or_state, "state_tensors"):
        return model_or_state.state_tensors()
    return dict(model_or_state)


def _jax_rule(shape: Tuple[int, ...], n: int, min_size: int,
              claimed: Optional[int] = None) -> Optional[int]:
    """The JAX ``fsdp_param_specs`` rule on a JAX-layout shape: the dim to
    shard, or None; ``claimed``: a dim the Megatron rule took."""
    numel = 1
    for s in shape:
        numel *= s
    if numel < min_size or n == 1:
        return None
    free = [(s, d) for d, s in enumerate(shape)
            if d != claimed and s % n == 0 and s >= n]
    return max(free)[1] if free else None


def fsdp_param_specs(model_or_state, mesh: Mesh, *,
                     min_size: int = MIN_SIZE, tp: bool = False) -> Specs:
    """Each parameter's name -> the port dimension sharded over the data
    axis, or None where the leaf stays whole. ``model_or_state``: a
    ``RoViTKAN``, its state_dict or its ``TensorParallel`` wrapper (the
    whole shapes are all that is read). ``tp``: the Megatron rule claims
    its dimension first."""
    if tp and "model" not in mesh.axis_names:
        raise ValueError(
            f"tp=True needs a 'model' axis on the mesh (got "
            f"{mesh.axis_names}); the Megatron rules would emit specs "
            f"referencing a missing axis")
    specs = {}
    for name, shape in shapes_of(model_or_state).items():
        ndim = len(shape)
        _, transpose = _jax_path(name, ndim)
        spec = jax_spec(name, ndim) if tp else ()
        claimed = spec.index("model") if "model" in spec else None
        d = _jax_rule(shape[::-1] if transpose else shape, mesh.size,
                      min_size, claimed)
        specs[name] = None if d is None else (
            ndim - 1 - d if transpose else d)
    return specs


def sharded_size(model_or_state, specs: Specs, mesh: Mesh,
                 model_specs: Optional[Specs] = None) -> int:
    """Per-rank bytes of ``model_or_state``'s whole leaves under ``specs``
    (each sharded leaf divided by the data axis) and ``model_specs`` (by
    the axes the wrapper cuts the leaf over, its ``leaf_axes``: ``"model"``,
    ``"expert"``, ``"pipe"``, or both ``"pipe"`` and ``"model"`` on the 3-D
    mesh; ``"model"`` for a module or a state_dict): the JAX
    ``sharded_size``."""
    model_specs = model_specs or {}
    # A wrapper's module holds every leaf (a pipeline stage's others
    # emptied): its dtypes give the element sizes.
    tree = getattr(model_or_state, "model", model_or_state)
    axis = getattr(model_or_state, "shard_axis", "model")
    leaf_axes = getattr(model_or_state, "leaf_axes", {})
    sizes = {k: t.element_size() for k, t in _tree(tree).items()}
    total = 0
    for k, shape in shapes_of(model_or_state).items():
        n = int(torch.Size(shape).numel()) * sizes[k]
        n //= mesh.size if specs.get(k) is not None else 1
        if model_specs.get(k) is not None:
            for a in leaf_axes.get(k, (axis,)):
                n //= mesh.axis_size(a)
        total += n
    return total


def _rng_of(generator, device: torch.device) -> torch.Generator:
    if isinstance(generator, GlobalRows):
        return generator.generator
    if generator is not None:
        return generator
    if device.type == "cuda":
        return torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
    return torch.default_generator


class _Unit:
    """A group of parameters gathered together: ``names`` (the model's
    parameter names), ``run(x, generator)`` its forward, ``block`` a fused
    block (kernels in both directions), ``random`` whether its forward
    draws dropout masks."""

    def __init__(self, names: List[str], run, block=None,
                 random: bool = False):
        self.names, self.run, self.block, self.random = (names, run, block,
                                                         random)


class _UnitFunction(torch.autograd.Function):
    """One unit under autograd: ``apply(fsdp, unit, generator, train, x,
    *params)`` -> the unit's outputs; ``train``: whether the call records
    gradients. The parameters are inputs so that the call is recorded;
    their gradients reach the shards (and the whole leaves' ``.grad``)
    inside ``backward``, which returns none for them."""

    @staticmethod
    def forward(ctx, fsdp, unit, generator, train, x, *params):
        ctx.fsdp, ctx.unit, ctx.generator = fsdp, unit, generator
        ctx.x_grad = ctx.needs_input_grad[4]
        ctx.save_for_backward(x)
        if unit.block is not None:
            with fsdp._gathered_block(unit, x.dtype) as kp:
                blk = unit.block
                plain = blk.block_fn is plain_vit_block
                ctx.saved = None
                if train and _residual_bwd():
                    out, *ctx.saved = _forward_res(x, kp, blk.num_heads,
                                                   plain)
                    return out
                return _forward(x, kp, blk.num_heads, plain)
        if unit.random and train:
            ctx.rng = _rng_of(generator, x.device).get_state()
        with fsdp._gathered(unit):
            return unit.run(x, generator)

    @staticmethod
    def backward(ctx, *grads):
        fsdp, unit = ctx.fsdp, ctx.unit
        x, = ctx.saved_tensors
        n_params = len(unit.names)
        if unit.block is not None:
            blk = unit.block
            plain = blk.block_fn is plain_vit_block
            with fsdp._gathered_block(unit, x.dtype) as kp:
                dx, g = _backward(x, grads[0], kp, blk.num_heads, plain,
                                  ctx.saved)
            fsdp._reduce(dict(zip(unit.names, (g[k] for k in PKEYS))))
            return (None,) * 4 + (dx.to(x.dtype),) + (None,) * n_params
        with fsdp._gathered(unit), torch.enable_grad():
            xd = x.detach().requires_grad_(ctx.x_grad)
            if unit.random:
                rng = _rng_of(ctx.generator, x.device)
                after = rng.get_state()
                rng.set_state(ctx.rng)
            outs = unit.run(xd, ctx.generator)
            if unit.random:
                rng.set_state(after)
            outs = outs if isinstance(outs, tuple) else (outs,)
            # The module's parameters: the gathered weights the rerun used.
            params = [fsdp._params[k] for k in unit.names]
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if o.requires_grad]
            inputs = ([xd] if ctx.x_grad else []) + params
            got = torch.autograd.grad([o for o, _ in pairs],
                                      inputs, [g for _, g in pairs],
                                      allow_unused=True)
        dx = got[0] if ctx.x_grad else None
        fsdp._reduce(dict(zip(unit.names, got[-n_params:])))
        return (None,) * 4 + (dx,) + (None,) * n_params


class FSDP(ShardedState):
    """A ``RoViTKAN`` whose parameters are sharded over ``mesh`` by
    ``specs`` (default: ``fsdp_param_specs(model, mesh)``); with ``tp``, a
    ``TensorParallel`` wrapper of ``model``, the leaves it holds are its
    shards (module docstring).

    It stands where the model stands in ``make_train_step``,
    ``make_eval_step`` and ``build_optimizer``: ``fsdp(x, generator)``,
    ``train()``, ``eval()``, ``head_mask``, ``parameters()``. Its
    ``named_parameters`` are what the optimizer owns: this rank's shard of
    each sharded leaf (under the leaf's name) and each whole leaf, in the
    order the optimizer's flat buffer needs (the backbone's shards, the
    backbone's whole leaves, the heads' whole leaves, the heads' shards:
    the whole leaves, whose gradients are all-reduced, are one slice).
    ``state_dict`` is the same tensors in the model's order.

    Built from a model whose weights are the same on every rank; it takes
    its shards and frees the model's copy of each sharded leaf (the
    module's parameter keeps its name with no elements). ``full_module``
    gathers them back for a while (initialisation, evaluation after
    training). The taps of ``models/vit.py`` are not taken here."""

    #: The most units gathered at once in a forward or a backward.
    MAX_LIVE = 1

    def __init__(self, model: nn.Module, mesh: Mesh,
                 specs: Optional[Specs] = None, tp=None):
        self.model, self.mesh, self.tp = model, mesh, tp
        self.specs = (fsdp_param_specs(tp or model, mesh, tp=tp is not None)
                      if specs is None else dict(specs))
        self.device = next(model.parameters()).device
        self._params = dict(model.named_parameters())
        self.shapes = {k: tuple(p.shape) for k, p in self._params.items()}
        self.full_shapes = self.shapes if tp is None else tp.full_shapes
        #: The leaves sharded over "model", and those whose gradients are
        #: partial over it (``parallel/tensor.py``).
        self.model_sharded = frozenset() if tp is None else tp.model_sharded
        self.partial = frozenset() if tp is None else tp.partial
        self.shards: Dict[str, nn.Parameter] = {}
        self._empty = {}
        with torch.no_grad():
            for k, p in self._params.items():
                d = self.specs.get(k)
                if d is None:
                    continue
                self.shards[k] = nn.Parameter(
                    p.detach().chunk(mesh.size, d)[mesh.rank].clone())
                self._empty[k] = p.new_empty(0)
                p.data = self._empty[k]
        self.live = 0
        self.peak_live = 0
        self.units = self._make_units()

    # -- the model's interface ---------------------------------------------
    def named_parameters(self) -> List[Tuple[str, torch.Tensor]]:
        items = self.state_tensors()
        return [(k, items[k]) for k in flat_order(
            list(items), frozenset(self.shards), self.model_sharded)]

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        """The trained tensors in the model's order: shards and whole
        leaves."""
        return {k: self.shards.get(k, p) for k, p in self._params.items()}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.state_tensors().items()}

    def parameters(self) -> Iterator[torch.Tensor]:
        return iter(self.state_tensors().values())

    def train(self, mode: bool = True) -> "FSDP":
        self.model.train(mode)
        return self

    def eval(self) -> "FSDP":
        return self.train(False)

    @property
    def head_mask(self) -> Dict[str, bool]:
        return self.model.head_mask

    def __call__(self, x: torch.Tensor,
                 generator=None) -> Dict[str, torch.Tensor]:
        """The model's output dict, unit by unit."""
        train = torch.is_grad_enabled()
        for unit in self.units:
            if unit.block is not None:
                x = x.to(unit.block.dtype)
            x = _UnitFunction.apply(self, unit, generator, train, x,
                                    *(self._param(k) for k in unit.names))
        return dict(zip(OUTPUT_KEYS, x))

    # -- units ---------------------------------------------------------------
    def _make_units(self) -> List[_Unit]:
        model = self.model
        vit = model.backbone.model
        pre = "backbone.model."
        names = list(self._params)

        def under(*prefixes):
            return [k for k in names if k.startswith(prefixes)]

        units = [_Unit(under(pre + "patch_embed.", pre + "cls_token",
                             pre + "pos_embed"),
                       lambda x, g: vit.embed(x))]
        for i, blk in enumerate(vit.blocks):
            mine = under(f"{pre}blocks.{i}.")
            if blk.runs_fused:
                full = {id(p): k for k, p in self._params.items()}
                bp = blk.block_params()
                mine = [full[id(bp[key])] for key in PKEYS]
                units.append(_Unit(mine, None, block=blk))
            else:
                units.append(_Unit(mine, lambda x, g, blk=blk: blk(x)))

        def head(x, g):
            out = model.heads(vit.features(x), g)
            return tuple(out[k] for k in OUTPUT_KEYS)

        taken = {k for u in units for k in u.names}
        units.append(_Unit([k for k in names if k not in taken], head,
                           random=True))
        return units

    def _param(self, name: str) -> torch.Tensor:
        return self.shards.get(name, self._params[name])

    def _full(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_gather(shard, self.specs[name]).contiguous()

    @contextlib.contextmanager
    def _count(self):
        self.live += 1
        self.peak_live = max(self.peak_live, self.live)
        try:
            yield
        finally:
            self.live -= 1

    @contextlib.contextmanager
    def _gathered(self, unit: _Unit):
        """The unit's sharded parameters whole in the module meanwhile."""
        with self._count():
            try:
                for k in unit.names:
                    if k in self.shards:
                        self._params[k].data = self._full(
                            k, self.shards[k].detach())
                yield
            finally:
                for k in unit.names:
                    if k in self.shards:
                        self._params[k].data = self._empty[k]

    @contextlib.contextmanager
    def _gathered_block(self, unit: _Unit, dtype: torch.dtype):
        """The fused block's tensors in the kernel's layout
        (``prepare_block_params``): each weight cast on the shard, then
        gathered."""
        with self._count():
            kp = {}
            for key, name in zip(PKEYS, unit.names):
                want = dtype if key in WEIGHT_KEYS else torch.float32
                t = self._param(name).detach().to(want)
                kp[key] = (self._full(name, t) if name in self.shards
                           else t.contiguous())
            yield kp

    @torch.no_grad()
    def _reduce(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        """Each sharded leaf's full gradient summed over the ranks into its
        shard's ``.grad``; each whole leaf's added to its ``.grad`` (summed
        over the ranks later, with the rest of the whole leaves')."""
        for k, g in grads.items():
            if g is None:
                continue
            if k in self.shards:
                g = self.mesh.reduce_scatter(g.float(), self.specs[k])
            p = self._param(k)
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.add_(g)

    # -- whole tensors -----------------------------------------------------
    def local(self, full: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """This rank's part of each tensor of a full state_dict (no
        collective)."""
        if self.tp is not None:
            full = self.tp.local(full)
        n, r = self.mesh.size, self.mesh.rank
        return {k: (v.chunk(n, self.specs[k])[r] if k in self.shards else v)
                for k, v in full.items()}

    @torch.no_grad()
    def gather_full(self, state: Optional[Dict[str, torch.Tensor]]
                    ) -> Optional[Dict[str, torch.Tensor]]:
        """A shard-level state_dict (``state_dict``'s layout) whole, on the
        host of rank 0; None on the other ranks. Every rank must call it:
        each sharded leaf is one gather, and only rank 0 keeps the result,
        so the other ranks hold one leaf at a time."""
        if state is None:
            return None
        keep = self.mesh.global_rank == 0
        out = {}
        for k, v in state.items():
            if k in self.shards:
                v = self._full(k, v.to(self.device))
            if self.tp is not None:
                v = self.tp.full_leaf(k, v.to(self.device))
            if keep:
                out[k] = v.detach().to("cpu", copy=True)
        return out if keep else None

    @contextlib.contextmanager
    def full_module(self, weights: Optional[Dict[str, torch.Tensor]] = None,
                    keep: bool = False):
        """The model whole meanwhile: each sharded leaf gathered (from
        ``weights``, a ``state_dict``-layout dict, where given; the live
        shards else) and each whole leaf from ``weights`` where given. With
        ``keep``, the module's weights at the exit become the shards' (and
        the whole leaves stay as they were left). The module is as before
        at the exit, its fused blocks' weight caches cleared. Under FSDP+TP
        the module is also gathered over "model" and unsharded meanwhile
        (``TensorParallel.full_module``)."""
        src = self.state_dict() if weights is None else weights
        kept = {}
        try:
            for k, p in self._params.items():
                kept[k] = p.data
                if k in self.shards:
                    p.data = self._full(k, src[k].to(self.device))
                elif weights is not None:
                    p.data = weights[k].to(self.device, copy=True)
            with (contextlib.nullcontext(self.model) if self.tp is None
                  else self.tp.full_module(keep=keep)) as model:
                yield model
            if keep:
                with torch.no_grad():
                    for k, s in self.shards.items():
                        s.copy_(self._params[k].data.chunk(
                            self.mesh.size, self.specs[k])[self.mesh.rank])
        finally:
            for k, p in self._params.items():
                p.data = kept[k]
            for blk in self.model.backbone.model.blocks:
                blk._kernel_params = blk._kernel_key = None
