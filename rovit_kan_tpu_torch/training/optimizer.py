"""AdamW over one flat parameter buffer, with two learning-rate groups.

Counterpart of ``rovit_kan_tpu/training/optimizer.py`` with its flat update
(``_flat_adamw``): per step, in this order,

    global-norm clip -> Adam with bias correction -> + wd * p (decoupled
    decay) -> x per-element group factor (``backbone_scale`` for
    ``backbone.*``, 1 otherwise) -> x (-lr)

as a handful of vector passes over one fp32 buffer. Building the optimizer
moves every parameter's storage into that buffer (each ``nn.Parameter``
becomes a view of it) and gives each parameter a gradient that is a view of
a second flat buffer, which autograd accumulates into in place. So build it
after the model is on its device, and zero gradients with ``zero_grad``.

The update itself is applied to each parameter in place (one
``_foreach_add_``), so every parameter's version counter moves.

``learning_rate`` and ``backbone_scale`` are plain attributes, set between
steps (``set_hyperparams``): 0 freezes the backbone (its update is exactly
zero, decay included) and ``zero_backbone_grads`` keeps its Adam moments
cold meanwhile, as ``requires_grad=False`` would.

With ``accum_steps = k > 1`` a step is ``optax.MultiSteps``: the gradients of
k micro-batches are averaged (the running mean ``acc + (g - acc) / (n + 1)``)
and only every k-th call updates the parameters and moves the step count;
``applied`` says whether the last call did.

Under FSDP (``parallel/fsdp.py``) the optimizer is built over the ``FSDP``
wrapper: the flat buffer holds this rank's shard of each sharded leaf and
each whole leaf, the whole leaves in one slice (``replicated``), so the
moments, the accumulator and the EMA shrink with it. The update is the same
per element; only the global norm changes: the squares of the sharded part
are summed over the ranks (one ``all_reduce``) and the whole leaves' added
once.

Under tensor parallelism (``parallel/tensor.py``) the buffer holds this
rank's shards of the leaves sharded over ``"model"`` (``model_sharded``):
their squares are summed over ``"model"`` (over both axes for a leaf FSDP
also shards over ``"data"``), and each replicated leaf counts once. The
leaves whose gradients are partial over ``"model"`` under sequence
parallelism (``partial``) are summed over it by ``reduce_grads``, before the
data axis's reduce.

Under expert parallelism and the pipeline the second axis is ``"expert"`` or
``"pipe"`` (the wrapper's ``shard_axis``): ``model_sharded`` then names the
rank's experts (``parallel/tensor.py::ExpertParallel``) or its stage's
blocks (``parallel/pipeline.py::Pipeline``), whose squares are summed over
that axis, and every other leaf counts once. On the 3-D ``("data", "pipe",
"model")`` mesh a stage's Megatron-sharded block leaves are summed over
``"pipe"`` and ``"model"``, its block leaves whole on the model axis
(LayerNorms, proj and fc2 biases) over ``"pipe"`` only. Each wrapper says
which axes each of its leaves is cut over (``leaf_axes``); the data axis
alone reduces the gradients.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from rovit_kan_tpu_torch.config import Config


class FlatAdamW:
    """AdamW over one flat buffer; see the module docstring."""

    def __init__(self, model: nn.Module, learning_rate: float,
                 backbone_scale: float = 0.1, *, weight_decay: float = 1e-4,
                 clip: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, accum_steps: int = 1,
                 mesh=None, sharded=(), leaf_axes=None, partial=(),
                 shard_axis: str = "model"):
        named: List[Tuple[str, nn.Parameter]] = [
            (k, p) for k, p in model.named_parameters() if p.requires_grad]
        # Backbone first, so its grads are one leading slice.
        named.sort(key=lambda kp: not kp[0].startswith("backbone."))
        self.names = [k for k, _ in named]
        #: The slice of whole leaves when ``sharded`` names the leaves of
        #: which this buffer holds a shard (None: every leaf is whole).
        self.replicated = None
        self.mesh = mesh
        #: The axis ``partial`` refers to.
        self.shard_axis = shard_axis
        leaf_axes = dict(leaf_axes or {})
        offs = [0]
        for _, p in named:
            offs.append(offs[-1] + p.numel())

        def runs(pred) -> List[slice]:
            """The flat slices of the leaves ``pred`` takes, adjacent
            leaves merged."""
            out = []
            for i, k in enumerate(self.names):
                if not pred(k):
                    continue
                if out and out[-1].stop == offs[i]:
                    out[-1] = slice(out[-1].start, offs[i + 1])
                else:
                    out.append(slice(offs[i], offs[i + 1]))
            return out

        if sharded:
            whole = [i for i, k in enumerate(self.names) if k not in sharded]
            if whole != list(range(whole[0], whole[-1] + 1)):
                raise ValueError("the whole leaves must be one run of the "
                                 "parameter order")
            self.replicated = slice(offs[whole[0]], offs[whole[-1] + 1])
        #: The norm's slices by the axes their squares are summed over
        #: (``"data"`` for the ``sharded`` leaves, then each leaf's
        #: ``leaf_axes``), and the slices of whole leaves (``step``).
        axes_of = {k: (("data",) if k in sharded else ())
                   + tuple(leaf_axes.get(k, ())) for k in self.names}
        groups = sorted({a for a in axes_of.values() if a},
                        key=lambda a: ("data" not in a, -len(a), a))
        self._norm_groups = [(a, runs(lambda k, a=a: axes_of[k] == a))
                             for a in groups]
        self._whole_runs = runs(lambda k: not axes_of[k])
        #: The slices ``reduce_grads`` sums over ``shard_axis`` first.
        self.partial_runs = runs(lambda k: k in partial)
        self.n_backbone = sum(p.numel() for k, p in named
                              if k.startswith("backbone."))
        with torch.no_grad():
            self.flat = torch.cat([p.detach().float().reshape(-1)
                                   for _, p in named])
        self.grad = torch.zeros_like(self.flat)
        off = 0
        for _, p in named:
            n = p.numel()
            p.data = self.flat[off:off + n].view_as(p)
            p.grad = self.grad[off:off + n].view_as(p)
            off += n
        self.params = [p for _, p in named]
        self._sizes = [p.numel() for p in self.params]
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = 0
        self.learning_rate = float(learning_rate)
        self.backbone_scale = float(backbone_scale)
        self.weight_decay = float(weight_decay)
        self.clip = float(clip)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self._factors = torch.ones_like(self.flat)
        self._factor_scale = None
        self.accum_steps = int(accum_steps)
        self.acc = (torch.zeros_like(self.flat) if self.accum_steps > 1
                    else None)
        self.mini_step = 0

    @property
    def applied(self) -> bool:
        """Whether the last ``step`` updated the parameters (always, unless
        it was an accumulation micro-step)."""
        return self.mini_step == 0

    def reset(self) -> None:
        """Fresh moments, step count and accumulator."""
        self.mu.zero_()
        self.nu.zero_()
        self.count = 0
        self.mini_step = 0
        if self.acc is not None:
            self.acc.zero_()

    def state_dict(self) -> Dict:
        """The optimizer's state: the parameter names in flat order, the
        moments, the step count and, with accumulation, the running mean
        and the micro-step. The tensors are the live buffers."""
        return {"names": list(self.names), "mu": self.mu, "nu": self.nu,
                "count": self.count, "accum_steps": self.accum_steps,
                "acc": self.acc, "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Copies ``state`` in; raises ValueError where it was written for
        other parameters or another ``accum_steps``."""
        if list(state["names"]) != self.names \
                or state["mu"].numel() != self.mu.numel() \
                or int(state.get("accum_steps", 1)) != self.accum_steps:
            raise ValueError("optimizer state of another structure: other "
                             "parameters or another accum_steps")
        self.mu.copy_(state["mu"])
        self.nu.copy_(state["nu"])
        self.count = int(state["count"])
        self.mini_step = int(state.get("mini_step", 0))
        if self.acc is not None:
            self.acc.copy_(state["acc"])

    def zero_grad(self) -> None:
        self.grad.zero_()

    def _group_factors(self) -> torch.Tensor:
        if self._factor_scale != self.backbone_scale:
            self._factors[:self.n_backbone] = self.backbone_scale
            self._factor_scale = self.backbone_scale
        return self._factors

    @torch.no_grad()
    def step(self) -> Optional[torch.Tensor]:
        """One update from the grads; returns the global grad norm before
        clipping (a 0-dim tensor, not synchronised), or None on an
        accumulation micro-step, which only adds the grads to the mean."""
        g = self.grad
        if self.acc is not None:
            self.acc.add_((g - self.acc) / (self.mini_step + 1))
            self.mini_step = (self.mini_step + 1) % self.accum_steps
            if self.mini_step:
                return None
            g = self.acc.clone()
            self.acc.zero_()
        sq = g * g
        if not self._norm_groups:
            gnorm = torch.sqrt(torch.sum(sq))
        else:
            shards = None
            for axes, slices in self._norm_groups:
                part = sum(torch.sum(sq[sl]) for sl in slices)
                for axis in axes:
                    self.mesh.all_reduce_(part, axis)
                shards = part if shards is None else shards + part
            whole = sum(torch.sum(sq[sl]) for sl in self._whole_runs)
            gnorm = torch.sqrt(shards + whole)
        g = g * (self.clip / torch.clamp(gnorm, min=self.clip))
        self.count += 1
        self.mu.mul_(self.b1).add_((1.0 - self.b1) * g)
        self.nu.mul_(self.b2).add_((1.0 - self.b2) * g * g)
        c = torch.tensor(float(self.count), dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(self.b1, dtype=torch.float32) ** c)
        bc2 = float(1.0 - torch.tensor(self.b2, dtype=torch.float32) ** c)
        u = (self.mu / bc1) / (torch.sqrt(self.nu / bc2) + self.eps)
        u = (u + self.weight_decay * self.flat) * self._group_factors() \
            * (-self.learning_rate)
        # Through the parameters, not the flat buffer: an in-place update of
        # each parameter bumps its version counter, which the fused block's
        # cast-weight cache (models/vit.py) keys on.
        torch._foreach_add_(self.params, [
            t.view_as(p) for t, p in zip(torch.split(u, self._sizes),
                                         self.params)])
        return gnorm


def build_optimizer(model: nn.Module, config: Config) -> FlatAdamW:
    """The flat AdamW with the config's learning rate, weight decay and
    clip, the backbone at 0.1 of the learning rate, and gradient
    accumulation over ``train.accum_steps`` micro-batches. ``model`` may be
    a sharded wrapper (``FSDP``, ``TensorParallel``, ``ExpertParallel``,
    ``Pipeline``): the buffer then holds its shards."""
    shards = getattr(model, "shards", None)
    shard_axis = getattr(model, "shard_axis", "model")
    leaf_axes = getattr(model, "leaf_axes", None)
    if leaf_axes is None:
        leaf_axes = {k: (shard_axis,)
                     for k in getattr(model, "model_sharded", ())}
    return FlatAdamW(model, config.train.learning_rate, 0.1,
                     weight_decay=config.train.weight_decay,
                     clip=config.flags.gradient_clip,
                     accum_steps=getattr(config.train, "accum_steps", 1),
                     mesh=model.mesh if shards or leaf_axes else None,
                     sharded=frozenset(shards or ()), leaf_axes=leaf_axes,
                     partial=getattr(model, "partial", frozenset()),
                     shard_axis=shard_axis)


def reduce_grads(optimizer: FlatAdamW, mesh) -> None:
    """Sum the gradients over the ranks: the leaves partial over the second
    axis (sequence parallelism) over it first; then, over "data", what every
    data index holds whole: the whole buffer under data parallelism, the
    whole leaves' slice under FSDP (whose shards were reduce-scattered in
    the backward)."""
    for sl in optimizer.partial_runs:
        mesh.all_reduce_(optimizer.grad[sl], optimizer.shard_axis)
    r = optimizer.replicated
    mesh.all_reduce_(optimizer.grad if r is None else optimizer.grad[r])


def set_hyperparams(optimizer: FlatAdamW, learning_rate: float,
                    backbone_scale: float) -> FlatAdamW:
    """Sets the head learning rate and the backbone's factor (0 frozen, 0.1
    live); under accumulation they apply from the next update on."""
    optimizer.learning_rate = float(learning_rate)
    optimizer.backbone_scale = float(backbone_scale)
    return optimizer


def zero_backbone_grads(optimizer: FlatAdamW, live: float) -> None:
    """Multiply the backbone's grads by ``live`` (0.0 frozen, 1.0 after)."""
    if live != 1.0:
        optimizer.grad[:optimizer.n_backbone].mul_(float(live))


def cosine_schedule(lr0: float, epoch: int, total_epochs: int,
                    eta_min: float = 1e-6) -> float:
    """torch CosineAnnealingLR value for a 1-indexed epoch:
    ``eta_min + 0.5 * (lr0 - eta_min) * (1 + cos(pi * (epoch - 1) / T))``."""
    t = epoch - 1
    return eta_min + 0.5 * (lr0 - eta_min) * (
        1.0 + math.cos(math.pi * t / total_epochs))


def cosine_lr(config: Config, epoch: int) -> float:
    """The config's cosine schedule, stepped once per epoch."""
    return cosine_schedule(config.train.learning_rate, epoch,
                           config.train.epochs)
