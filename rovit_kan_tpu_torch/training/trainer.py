"""The curriculum trainer: its train and eval steps and the epoch loop.

Counterpart of ``rovit_kan_tpu/training/trainer.py``. One train step, for
every curriculum stage and freeze state:

    uint8 batch -> augment (the fused kernel on the card under
    ``flags.mixed_precision``, else the fp32 chain of plain ops; the switch
    is ``train.fused_augment``) -> CutMix/MixUp when ``use_mix`` -> forward
    with dropout -> stage-masked joint loss -> backward ->
    backbone grads times ``backbone_live`` -> flat AdamW -> accuracy (and
    the EMA when ``train.ema_decay > 0``)

The random draws (augment factors, the mix, dropout masks) come from
generators the step owns, or from ``draws`` when the caller hands them in,
so a test can feed the JAX package's draws.

``Trainer.fit`` runs the epochs: the curriculum stage, the cosine learning
rate and the backbone freeze per epoch, validation, the best checkpoint
(with a disk-write cooldown), early stopping, ``resume`` and SIGTERM
preemption, as the JAX ``Trainer``. Over a ``DeviceLoader`` an epoch is a
loop of steps over on-device gathers (the JAX package compiles it into one
``lax.scan``), with the same batches and numbers. Data, tensor and pipeline
parallelism are not ported.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from pathlib import Path
from typing import Any, Dict, Optional

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
    build_optimizer,
    cosine_lr,
    set_hyperparams,
    zero_backbone_grads,
)
from rovit_kan_tpu_torch.utils.profiling import StepTimer


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def use_fused_augment(model: nn.Module, config: Config) -> bool:
    """The augment kernel's switch, read as the JAX ``make_train_step`` reads
    it: ``train.fused_augment`` (absent means "auto"); True/False force it;
    "auto" takes the kernel where the model is on the card and
    ``flags.mixed_precision`` is set (the JAX package's "tpu" backend read
    as "cuda"). ``tpu.fused_augment`` is not read."""
    fa = getattr(config.train, "fused_augment", "auto")
    if isinstance(fa, bool):
        return fa
    return (_device_of(model).type == "cuda"
            and bool(config.flags.mixed_precision))


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
        # Under gradient accumulation the parameters move only on the
        # applying call; the EMA freezes on the micro-steps in between.
        if self.ema is not None and opt.applied:
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


@dataclasses.dataclass
class TrainState:
    """What ``Trainer`` trains: the model's parameters (its ``state_dict``),
    the flat AdamW's state (``FlatAdamW.state_dict``), the EMA of the
    parameters (None when ``train.ema_decay`` is 0) and the step count.

    A state the trainer returns holds its live tensors, which the next
    epoch updates in place; ``copy`` takes a snapshot."""
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0

    def copy(self) -> "TrainState":
        def snap(tree):
            if tree is None:
                return None
            return {k: v.detach().clone() if torch.is_tensor(v)
                    else copy.copy(v) for k, v in tree.items()}
        return TrainState(snap(self.params), snap(self.opt_state),
                          snap(self.ema_params), self.step)


_EVAL_KEYS = ("total_loss", "cls_loss", "ord_loss", "unc_loss", "kan_loss")


class Trainer:
    """Epoch-driven fit loop over a model on its device (the JAX
    ``Trainer`` without meshes). ``train_loader`` yields fixed-shape batches
    (``data.dataset.Loader``'s numpy dicts, or a ``DeviceLoader``) and must
    drop its last partial batch; ``val_loader`` may pad it and mark it in
    ``valid``."""

    def __init__(self, model: nn.Module, train_loader, val_loader,
                 config: Config, logger=None, focal_alpha=None,
                 seed: int = 42):
        self.model = model
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.config = config
        self.logger = logger
        self.focal_alpha = focal_alpha
        self.seed = seed
        self.device = _device_of(model)
        self.optimizer = build_optimizer(model, config)
        self.train_step = make_train_step(
            model, self.optimizer, config, focal_alpha,
            generator=torch.Generator(self.device).manual_seed(seed))
        self.eval_step = make_eval_step(model, config, focal_alpha)
        self._use_mix = 1 if (config.flags.use_mixup
                              or config.flags.use_cutmix) else 0
        self.best_val_loss = float("inf")
        self.epochs_without_improvement = 0
        self.history: Dict[str, list] = {}
        self.step_timer = StepTimer(warmup=1, device=self.device)
        self._step = 0
        self._state: Optional[TrainState] = None

    # -- state -------------------------------------------------------------
    def _live(self) -> TrainState:
        """The state being trained, as references to its tensors."""
        self._state = TrainState(
            params=self.model.state_dict(),
            opt_state=self.optimizer.state_dict(),
            ema_params=self.train_step.ema, step=self._step)
        return self._state

    @torch.no_grad()
    def _install(self, state: TrainState) -> None:
        """Make ``state`` the one being trained (a no-op for the live
        state)."""
        if state is self._state:
            return
        for k, v in self.model.state_dict().items():
            v.copy_(state.params[k])
        self.optimizer.load_state_dict(state.opt_state)
        ema = state.ema_params
        if self.train_step.ema is not None:
            src = ema if ema is not None else state.params
            self.train_step.ema = {k: v.detach().to(self.device,
                                                    torch.float32,
                                                    copy=True)
                                   for k, v in src.items()}
        self._step = state.step
        self._live()

    def init_state(self, params: Optional[Dict[str, torch.Tensor]] = None
                   ) -> TrainState:
        """Fresh training from ``params`` (a state_dict), or from weights
        drawn from the trainer's seed: fresh optimizer, the EMA seeded with
        the parameters, the step's generators reseeded."""
        from rovit_kan_tpu_torch.models.rovit_kan import init_weights
        with torch.no_grad():
            if params is None:
                init_weights(self.model, self.seed)
            else:
                for k, v in self.model.state_dict().items():
                    v.copy_(params[k])
        self.optimizer.reset()
        if self.train_step.ema is not None:
            self.train_step.ema = {k: v.detach().clone().float() for k, v in
                                   self.model.state_dict().items()}
        self.train_step.generator.manual_seed(self.seed)
        self.train_step.mix_generator.manual_seed(self.seed)
        self._step = 0
        return self._live()

    @staticmethod
    def eval_params(state: TrainState) -> Dict[str, torch.Tensor]:
        """The weights validation and checkpoints see: the EMA when on, the
        live parameters otherwise."""
        return (state.ema_params if state.ema_params is not None
                else state.params)

    def _epoch_knobs(self, epoch: int):
        """Per-epoch (stage, lr, backbone_scale, backbone_live)."""
        cfg = self.config
        stage = cfg.get_stage_for_epoch(epoch)
        lr = cosine_lr(cfg, epoch)
        frozen = (cfg.flags.freeze_backbone_epochs > 0
                  and epoch <= cfg.flags.freeze_backbone_epochs)
        backbone_scale = 0.0 if frozen else 0.1
        backbone_live = 0.0 if frozen else 1.0
        return stage, lr, backbone_scale, backbone_live

    # -- epochs ------------------------------------------------------------
    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        dev = self.device
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v).to(dev, non_blocking=True)
            out[k] = t.long() if k == "labels" else t
        return out

    def _device_batches(self, loader, drop_valid: bool = True):
        """Batches on the device, the next one's copy issued before the
        current one is yielded."""
        pending = None
        for batch in loader:
            if drop_valid:
                batch = {k: v for k, v in batch.items() if k != "valid"}
            nxt = self._to_device(batch)
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending

    @staticmethod
    def _means(per_step) -> Dict[str, float]:
        """Each metric's mean over the steps, with one device->host copy."""
        keys = list(per_step[0])
        vals = torch.stack([torch.stack([m[k].float() for k in keys])
                            for m in per_step]).double().cpu()
        return dict(zip(keys, vals.mean(0).tolist()))

    def train_epoch(self, state: TrainState, epoch: int):
        # Training needs full batches: zero-padded tail rows would enter the
        # loss (and leak into real rows through CutMix/MixUp).
        if getattr(self.train_loader, "drop_last", True) is False:
            raise ValueError(
                "train_loader must use drop_last=True — padded tail rows "
                "would be trained on (eval loaders may pad; training must "
                "not)")
        self._install(state)
        stage, lr, bb_scale, bb_live = self._epoch_knobs(epoch)
        set_hyperparams(self.optimizer, lr, bb_scale)
        loader = self.train_loader
        if hasattr(loader, "epoch_index_plan"):
            # Device-resident set: the plan's rows gathered on the device.
            plan = torch.from_numpy(loader.epoch_index_plan()).to(self.device)
            batches = (loader.gather(row) for row in plan)
        else:
            batches = self._device_batches(loader)
        per_step = []
        total = len(loader)
        milestone = total // 10      # 0 for < 10-batch epochs: no prints
        self.step_timer.start()
        for i, batch in enumerate(batches):
            per_step.append(self.train_step(batch, stage, bb_live,
                                            self._use_mix))
            self._step += 1
            if milestone and (i + 1) % milestone == 0:
                print(f"  Batch {i + 1}/{total} "
                      f"({100.0 * (i + 1) / total:.0f}%) "
                      f"loss {float(per_step[-1]['total_loss']):.4f}")
        epoch_s = self.step_timer.stop()
        avg = self._means(per_step) if per_step else {}
        avg["lr"] = lr
        avg["stage"] = stage
        if per_step:
            avg["images_per_sec"] = (len(per_step)
                                     * self.config.train.batch_size / epoch_s)
        return self._live(), avg

    @torch.no_grad()
    def _with_weights(self, weights: Dict[str, torch.Tensor], fn):
        """``fn()`` with ``weights`` in the model, then its own back."""
        live = self.model.state_dict()
        if all(weights[k].data_ptr() == v.data_ptr()
               for k, v in live.items()):
            return fn()
        kept = {k: v.clone() for k, v in live.items()}
        try:
            for k, v in live.items():
                v.copy_(weights[k])
            return fn()
        finally:
            for k, v in live.items():
                v.copy_(kept[k])

    def val_epoch(self, state: TrainState) -> Dict[str, float]:
        return self._with_weights(self.eval_params(state), self._validate)

    def _validate(self) -> Dict[str, float]:
        loader = self.val_loader
        if hasattr(loader, "eval_index_plan"):
            idx, valid = loader.eval_index_plan()
            idx = torch.from_numpy(idx).to(self.device)
            valid = torch.from_numpy(valid).to(self.device)
            batches = (loader.gather(i, v) for i, v in zip(idx, valid))
        else:
            batches = self._device_batches(loader, drop_valid=False)
        per_batch = [self.eval_step(b) for b in batches]
        if not per_batch:
            return {"accuracy": 0.0}
        avg = self._means([{k: m[k] for k in _EVAL_KEYS}
                           for m in per_batch])
        correct = torch.stack([m["correct"] for m in per_batch]).sum()
        n = torch.stack([m["n"] for m in per_batch]).sum()
        avg["accuracy"] = float(correct) / max(float(n), 1.0)
        return avg

    # -- fit ---------------------------------------------------------------
    def resume(self, name: str = "best_model"):
        """Restore a saved checkpoint; returns ``(state, next_epoch)`` for
        continuing ``fit``. The optimizer state is restored where it fits
        this optimizer (same parameters, same ``accum_steps``), else the
        parameters alone with a fresh optimizer; the EMA is seeded from the
        parameters where the checkpoint has none. The best loss and the
        early-stopping counter continue from the checkpoint."""
        from rovit_kan_tpu_torch.utils.checkpoint import load_checkpoint
        ck = load_checkpoint(self._ckpt_dir() / name)
        self.init_state(ck["params"])
        opt_state = ck.get("opt_state")
        try:
            if opt_state is None:
                raise ValueError("no optimizer state")
            self.optimizer.load_state_dict(opt_state)
        except ValueError:
            print("resume: optimizer state structure mismatch; restoring "
                  "params only (fresh optimizer)")
        if self.train_step.ema is not None:
            if ck.get("ema_params") is None:
                print("resume: checkpoint has no EMA tree; seeding EMA "
                      "from the restored params")
            else:
                self.train_step.ema = {
                    k: v.to(self.device, torch.float32)
                    for k, v in ck["ema_params"].items()}
        self.best_val_loss = ck.get("best_val_loss", float("inf"))
        # Early-stop patience continues where it left off (a preempt/resume
        # cycle must not grant fresh patience).
        self.epochs_without_improvement = ck.get(
            "epochs_without_improvement", 0)
        return self._live(), ck.get("epoch", 0) + 1

    def _install_preempt_handler(self):
        """Graceful preemption: SIGTERM sets a flag; ``fit`` checkpoints the
        current state as ``preempt_model`` at the next epoch boundary and
        returns. Main thread only; returns a token for the restore, or
        None."""
        import signal
        import threading

        if threading.current_thread() is not threading.main_thread():
            return None

        def _on_preempt(signum, frame):
            self._preempt_requested = True
            print("Preemption signal received — will checkpoint and stop "
                  "at the next epoch boundary")

        try:
            # A tuple, so a C-installed (None) previous handler is restored
            # to SIG_DFL rather than taken for "never installed".
            return ("installed", signal.signal(signal.SIGTERM, _on_preempt))
        except ValueError:
            return None

    def _restore_preempt_handler(self, token):
        import signal
        if token is not None:
            prev = token[1]
            signal.signal(signal.SIGTERM,
                          prev if prev is not None else signal.SIG_DFL)

    def fit(self, state: Optional[TrainState] = None,
            epochs: Optional[int] = None,
            start_epoch: int = 1) -> Dict[str, Any]:
        from rovit_kan_tpu_torch.utils.checkpoint import (
            discard_staging,
            wait_for_checkpoints,
        )
        cfg = self.config
        if state is None:
            state = self.init_state()
        epochs = epochs or cfg.train.epochs
        self._preempt_requested = False
        _prev_sigterm = self._install_preempt_handler()
        # A fresh fit starts with fresh patience and best loss; a resumed
        # fit (start_epoch > 1) keeps what resume() restored.
        if start_epoch == 1:
            self.epochs_without_improvement = 0
            self.best_val_loss = float("inf")
        # A resumed run replays the batch order it would have seen.
        if start_epoch > 1 and hasattr(self.train_loader, "set_epoch"):
            self.train_loader.set_epoch(start_epoch - 1)

        history: Dict[str, list] = {"train": [], "val": []}
        best_state = state.copy()
        preempted = False
        improved = False    # did THIS fit ever beat best_val_loss?
        # Disk-write cooldown: the best state updates in memory on every
        # improvement; the disk write is throttled and a pending best is
        # flushed before fit returns (and on preemption).
        ckpt_interval = cfg.train.checkpoint_min_interval_s
        last_ckpt_t = float("-inf")
        pending_best = None           # (epoch, val_metrics) awaiting flush
        try:
            for epoch in range(start_epoch, epochs + 1):
                t0 = time.time()
                state, train_m = self.train_epoch(state, epoch)
                val_m = self.val_epoch(state)
                dt = time.time() - t0

                if self.logger is not None:
                    self.logger.log_epoch(epoch, train_m["stage"], train_m,
                                          val_m)
                history["train"].append(train_m)
                history["val"].append(val_m)
                print(f"Epoch {epoch:3d} stage {train_m['stage']} "
                      f"train_loss {train_m['total_loss']:.4f} "
                      f"val_loss {val_m['total_loss']:.4f} "
                      f"val_acc {val_m['accuracy']:.4f} ({dt:.1f}s)")

                if val_m["total_loss"] < self.best_val_loss:
                    self.best_val_loss = val_m["total_loss"]
                    self.epochs_without_improvement = 0
                    improved = True
                    best_state = state.copy()
                    if time.time() - last_ckpt_t >= ckpt_interval:
                        # The write overlaps the next epochs; fit joins it
                        # before returning.
                        self.save_checkpoint(state, epoch, val_m,
                                             block=False)
                        last_ckpt_t = time.time()
                        pending_best = None
                    else:
                        pending_best = (epoch, val_m)
                else:
                    self.epochs_without_improvement += 1
                    if self.epochs_without_improvement \
                            >= cfg.train.early_stop_patience:
                        print(f"Early stopping at epoch {epoch}")
                        break

                if self._preempt_requested and epoch < epochs:
                    # (A signal during the final epoch is completion.) Save
                    # the current state, so a resumed run continues where
                    # this one stopped, and any deferred best first.
                    if pending_best is not None:
                        self.save_checkpoint(best_state, *pending_best)
                        pending_best = None
                    self.save_checkpoint(state, epoch, val_m,
                                         name="preempt_model")
                    print(f"Preempted at epoch {epoch}: state saved as "
                          f"preempt_model; resume with --resume")
                    preempted = True
                    break
        finally:
            self._restore_preempt_handler(_prev_sigterm)

        if not preempted:
            if pending_best is not None:
                # Readers (evaluation, serving) load best_model from disk.
                self.save_checkpoint(best_state, *pending_best)
            # A completed fit invalidates a stale preemption checkpoint.
            discard_staging(self._ckpt_dir() / "preempt_model")
        wait_for_checkpoints()

        self.history = history
        # "improved" tells a resumed caller whether best_state is really the
        # best: if no epoch beat the restored best loss, the best lives only
        # in the on-disk best_model.
        return {"state": state, "best_state": best_state,
                "history": history, "best_val_loss": self.best_val_loss,
                "preempted": preempted, "improved": improved}

    # -- checkpoints -------------------------------------------------------
    def _ckpt_dir(self) -> Path:
        d = Path(self.config.paths.checkpoints_dir)
        d.mkdir(parents=True, exist_ok=True)
        return d

    def save_checkpoint(self, state: TrainState, epoch: int,
                        metrics: Dict[str, float], name: str = "best_model",
                        block: bool = True) -> None:
        from rovit_kan_tpu_torch.utils.checkpoint import save_checkpoint
        save_checkpoint(self._ckpt_dir() / name, state.params,
                        opt_state=state.opt_state, epoch=epoch,
                        best_val_loss=self.best_val_loss, metrics=metrics,
                        config=self.config, ema_params=state.ema_params,
                        epochs_without_improvement=(
                            self.epochs_without_improvement),
                        block=block)

    def load_checkpoint(self, name: str = "best_model") -> Dict[str, Any]:
        from rovit_kan_tpu_torch.utils.checkpoint import load_checkpoint
        return load_checkpoint(self._ckpt_dir() / name)
