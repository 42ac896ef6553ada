"""The train and eval steps of the curriculum trainer.

Counterpart of ``make_train_step`` and ``make_eval_step`` in
``rovit_kan_tpu/training/trainer.py``. One train step, for every curriculum
stage and freeze state:

    uint8 batch -> augment (the fused kernel where the model is bf16 on the
    card, else the fp32 chain of plain ops) -> CutMix/MixUp when ``use_mix``
    -> forward with dropout -> stage-masked joint loss -> backward ->
    backbone grads times ``backbone_live`` -> flat AdamW -> accuracy (and
    the EMA when ``train.ema_decay > 0``)

The random draws (augment factors, the mix, dropout masks) come from
generators the step owns, or from ``draws`` when the caller hands them in,
so a test can feed the JAX package's draws. ``Trainer.fit`` comes with the
trainer slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.ops.augment_kernel import (
    draw_factors,
    fused_augment_batch,
)
from rovit_kan_tpu_torch.ops.mixing import cutmix_or_mixup, draw_mix
from rovit_kan_tpu_torch.ops.preprocess import augment_batch, eval_batch
from rovit_kan_tpu_torch.training.losses import joint_loss
from rovit_kan_tpu_torch.training.optimizer import (
    FlatAdamW,
    zero_backbone_grads,
)


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _model_dtype(model: nn.Module) -> torch.dtype:
    return model.backbone.model.patch_embed.dtype


def use_fused_augment(model: nn.Module, config: Config) -> bool:
    """``tpu.fused_augment``: True/False force it; "auto" takes the kernel
    exactly where the model computes in bf16 on the card (the kernel's
    default compute type is bf16)."""
    fa = config.tpu.fused_augment
    if isinstance(fa, bool):
        return fa
    return (_device_of(model).type == "cuda"
            and _model_dtype(model) == torch.bfloat16)


class TrainStep:
    """``step(batch, stage, backbone_live, use_mix, draws=None)`` ->
    metrics (0-dim tensors: the five losses and ``accuracy``).

    ``batch``: ``images`` uint8 ``(B, H, W, 3)``, ``labels`` int,
    ``severity`` float, all on the model's device. ``draws``: ``factors``
    ``(B, 8)``, ``mix`` (``ops.mixing.draw_mix``'s dict or None) and
    ``dropout`` (a ``torch.Generator`` on the device, or None for the
    step's own)."""

    def __init__(self, model: nn.Module, optimizer: FlatAdamW,
                 config: Config, focal_alpha=None,
                 generator: Optional[torch.Generator] = None):
        self.model = model
        self.optimizer = optimizer
        self.config = config
        dev = _device_of(model)
        self.alpha = (None if focal_alpha is None else
                      torch.as_tensor(np.asarray(focal_alpha, np.float32),
                                      device=dev))
        self.fused_augment = use_fused_augment(model, config)
        #: ``(images_u8, factors) -> normalized images``; a caller may put
        #: the kernel's plain version here to hold the step against it.
        self.augment = (fused_augment_batch if self.fused_augment
                        else augment_batch)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(
                int(config.train.seeds[0]))
        self.generator = generator
        # The mix's few scalars come from a CPU generator, so drawing them
        # never waits on the device.
        self.mix_generator = torch.Generator().manual_seed(
            generator.initial_seed())
        self.ema_decay = float(getattr(config.train, "ema_decay", 0.0))
        self.ema = ({k: v.detach().clone() for k, v in
                     model.state_dict().items()}
                    if self.ema_decay > 0 else None)

    def draw(self, B: int, H: int, W: int, use_mix) -> Dict:
        fl = self.config.flags
        mix = None
        if use_mix and (fl.use_cutmix or fl.use_mixup):
            mix = draw_mix(self.mix_generator, B, H, W, fl.cutmix_alpha,
                           fl.mixup_alpha, fl.use_cutmix, fl.use_mixup)
        return {"factors": draw_factors(self.generator, B), "mix": mix,
                "dropout": None}

    def __call__(self, batch: Dict[str, torch.Tensor], stage,
                 backbone_live, use_mix,
                 draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        model, opt, lc = self.model, self.optimizer, self.config.loss
        images = batch["images"]
        B, H, W, _ = images.shape
        if draws is None:
            draws = self.draw(B, H, W, use_mix)
        x = self.augment(images, draws["factors"])
        labels = batch["labels"]
        mix = draws["mix"] if use_mix else None
        x, la, lb, lam = cutmix_or_mixup(x, labels, mix)

        model.train()
        opt.zero_grad()
        out = model(x, generator=draws.get("dropout") or self.generator)
        losses = joint_loss(
            out, labels, batch["severity"], stage,
            lambda_ord=lc.lambda_ord, mu_unc=lc.mu_unc, nu_kan=lc.nu_kan,
            focal_gamma=lc.focal_gamma, focal_alpha=self.alpha,
            head_mask=model.head_mask,
            mixup={"labels_a": la, "labels_b": lb, "lam": lam})
        losses["total_loss"].backward()
        zero_backbone_grads(opt, float(backbone_live))
        opt.step()

        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["accuracy"] = (out["cls_logits"].detach().argmax(-1)
                               == labels).float().mean()
        if self.ema is not None:
            d = self.ema_decay
            with torch.no_grad():
                for k, v in model.state_dict().items():
                    self.ema[k].mul_(d).add_((1.0 - d) * v.float())
        return metrics


def make_train_step(model: nn.Module, optimizer: FlatAdamW, config: Config,
                    focal_alpha=None,
                    generator: Optional[torch.Generator] = None
                    ) -> TrainStep:
    """The train step (see ``TrainStep``)."""
    return TrainStep(model, optimizer, config, focal_alpha, generator)


def make_eval_step(model: nn.Module, config: Config, focal_alpha=None):
    """``eval_step(batch) -> dict``: deterministic forward, the stage-4 loss
    over the rows ``batch["valid"]`` marks, and ``correct`` and ``n`` for
    the accuracy."""
    lc = config.loss
    alpha = (None if focal_alpha is None else
             torch.as_tensor(np.asarray(focal_alpha, np.float32),
                             device=_device_of(model)))

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        out = model(eval_batch(batch["images"]))
        valid = batch["valid"].float()
        losses = joint_loss(out, batch["labels"], batch["severity"], 4,
                            lambda_ord=lc.lambda_ord, mu_unc=lc.mu_unc,
                            nu_kan=lc.nu_kan, focal_gamma=lc.focal_gamma,
                            focal_alpha=alpha, head_mask=model.head_mask,
                            valid=valid)
        correct = ((out["cls_logits"].argmax(-1) == batch["labels"]).float()
                   * valid).sum()
        return {**losses, "correct": correct,
                "n": torch.clamp(valid.sum(), min=1.0)}

    return eval_step
