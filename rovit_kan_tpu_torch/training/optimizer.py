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
                 eps: float = 1e-8, accum_steps: int = 1):
        named: List[Tuple[str, nn.Parameter]] = [
            (k, p) for k, p in model.named_parameters() if p.requires_grad]
        # Backbone first, so its grads are one leading slice.
        named.sort(key=lambda kp: not kp[0].startswith("backbone."))
        self.names = [k for k, _ in named]
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
        gnorm = torch.sqrt(torch.sum(g * g))
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
    accumulation over ``train.accum_steps`` micro-batches."""
    return FlatAdamW(model, config.train.learning_rate, 0.1,
                     weight_decay=config.train.weight_decay,
                     clip=config.flags.gradient_clip,
                     accum_steps=getattr(config.train, "accum_steps", 1))


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
