"""Train RoViT-KAN end to end on one card, then evaluate it on the test set.

    python -m rovit_kan_tpu_torch.cli.train --data_root DATA [--seed 42] \
        [--output_dir outputs/train] [--epochs N] [--batch_size B] \
        [--synthetic [--synthetic_per_class N]] [--fast] [--cpu] [--resume] \
        [--device_cache] [--all_seeds] [--patience P] [--ema_decay D] \
        [--checkpoint_min_interval S]

The single-card flow of the JAX package's ``scripts/train.py``. A run:
dataloaders over ``DATA/Augmented Image`` (train and validation, a seeded
80/20 split) and ``DATA/Original Image`` (test), with ``--device_cache``
the whole set on the card; the focal alpha from the train split's class
weights; the model, the ``ExperimentLogger`` and the ``Trainer``; ``fit``
(``--resume`` continues from a preemption checkpoint or ``best_model``);
the training curves; and the ``Evaluator`` on the test set with the best
weights (the EMA when ``--ema_decay`` is on). ``--all_seeds`` runs every
seed of ``train.seeds`` and writes ``seed_summary.json``. ``--fast`` sets
the JAX script's smoke-run config (64 px, depth 2, width 32, fp32, 2
epochs at batch 8).

Runs on the card unless ``--cpu`` is given. Not ported yet: the wider
presets (``--preset small`` and ``base`` exit: the fused block's widths stop
at 320), the mesh, pipeline, tensor, sequence, FSDP, MoE, expert and
multi-host flags, ``--device_cache_sharded``, ``--profile_dir`` and
``--pretrained_npz``; XLA's ``--matmul_precision`` has no counterpart.
"""
from __future__ import annotations

import argparse
import copy
import json
from pathlib import Path

#: Backbone widths of the presets this CLI refuses.
_WIDE_PRESETS = {"small": 384, "base": 768}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_root", type=Path, default=Path("data"))
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output_dir", type=Path, default=Path("outputs/train"))
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--preset", default="tiny",
                   choices=["tiny", "small", "base"],
                   help="backbone width preset; only 'tiny' (DeiT-Tiny) is "
                        "ported")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic dataset under data_root")
    p.add_argument("--synthetic_per_class", type=int, default=None,
                   help="augmented images per class for --synthetic "
                        "(default 64, 8 with --fast)")
    p.add_argument("--patience", type=int, default=None,
                   help="override config.train.early_stop_patience")
    p.add_argument("--ema_decay", type=float, default=None,
                   help="EMA of params for eval/checkpoint (e.g. 0.999); "
                        "0/absent = off")
    p.add_argument("--checkpoint_min_interval", type=float, default=None,
                   help="min seconds between best-model disk writes "
                        "(config.train.checkpoint_min_interval_s)")
    p.add_argument("--fast", action="store_true",
                   help="tiny model + 2 epochs (smoke test)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the preemption or best_model "
                        "checkpoint in output_dir")
    p.add_argument("--device_cache", action="store_true",
                   help="keep the whole uint8 dataset on the card "
                        "(DeviceLoader: no host decode or copy per step)")
    p.add_argument("--all_seeds", action="store_true",
                   help="run every seed in config.train.seeds (default "
                        "[42, 123, 999]) and report mean/std test metrics")
    return p.parse_args(argv)


def build_config(args: argparse.Namespace):
    """The run's ``Config``: the flagship, the paths under ``output_dir``
    and the flags' overrides, as the JAX script sets them."""
    from rovit_kan_tpu_torch.config import get_config

    config = get_config(args.preset)
    config.paths.checkpoints_dir = args.output_dir / "checkpoints"
    config.paths.results_dir = args.output_dir / "results"
    config.paths.logs_dir = args.output_dir / "logs"
    if args.epochs:
        config.train.epochs = args.epochs
    if args.batch_size:
        config.train.batch_size = args.batch_size
    if args.fast:
        config.data.image_size = 64
        config.train.epochs = args.epochs or 2
        config.train.batch_size = args.batch_size or 8
        config.train.stage_1_epochs = 1
        config.train.stage_2_epochs = 1
        config.train.stage_3_epochs = 1
        config.flags.freeze_backbone_epochs = 1
        config.flags.mixed_precision = False
        config.model.depth = 2
        config.model.embed_dim = 32
        config.model.num_heads = 2
        config.model.hidden_dim = 16
        config.model.kan_layers = [32, 8, 1]
        config.tpu.use_pallas_attention = False
        config.tpu.use_pallas_kan = False
    if args.patience is not None:
        config.train.early_stop_patience = args.patience
    if args.ema_decay is not None:
        config.train.ema_decay = args.ema_decay
    if args.checkpoint_min_interval is not None:
        config.train.checkpoint_min_interval_s = args.checkpoint_min_interval
    return config


def run_one(config, seed: int, out_dir: Path, aug_root: Path,
            orig_root: Path, device: str, resume: bool, device_cache: bool):
    """One training run and its test evaluation; returns the test metrics,
    or None when the run was preempted."""
    from rovit_kan_tpu_torch.data.dataset import create_dataloaders
    from rovit_kan_tpu_torch.evaluation.evaluator import (
        Evaluator,
        load_model_for_evaluation,
    )
    from rovit_kan_tpu_torch.models.rovit_kan import (
        build_model,
        count_parameters,
    )
    from rovit_kan_tpu_torch.results.logger import ExperimentLogger
    from rovit_kan_tpu_torch.training.trainer import Trainer
    from rovit_kan_tpu_torch.utils.checkpoint import promote_staging

    cfg = copy.deepcopy(config)
    cfg.paths.checkpoints_dir = out_dir / "checkpoints"
    cfg.paths.results_dir = out_dir / "results"
    cfg.paths.logs_dir = out_dir / "logs"

    train_l, val_l, test_l = create_dataloaders(
        aug_root, orig_root, cfg.data.class_names, cfg.data.severity_map,
        batch_size=cfg.train.batch_size,
        train_val_split=cfg.data.train_val_split, seed=seed,
        image_size=cfg.data.image_size, prefetch=cfg.data.prefetch_batches,
        num_workers=cfg.data.num_workers)
    # Focal alpha from the train split's class weights.
    focal_alpha = train_l.dataset.get_class_weights()
    cfg.loss.focal_alpha = focal_alpha.tolist()
    if device_cache:
        from rovit_kan_tpu_torch.data.device_cache import (
            device_cache_loaders,
        )
        train_l, val_l, test_l = device_cache_loaders(
            train_l.dataset, val_l.dataset, test_l.dataset,
            cfg.train.batch_size, seed=seed, device=device)
        print(f"Device cache: {train_l.nbytes / 1e6:.0f} MB train split "
              f"resident on the card")

    model = build_model(cfg, device=device, seed=seed)
    logger = ExperimentLogger(cfg.paths.logs_dir, "train")
    trainer = Trainer(model, train_l, val_l, cfg, logger=logger,
                      focal_alpha=focal_alpha, seed=seed)

    start_epoch = 1
    ck_dir = Path(cfg.paths.checkpoints_dir)
    # A preemption checkpoint is by construction the latest state, so it
    # wins over best_model (a completed fit deletes it). Either must be a
    # committed checkpoint: a crash mid-write leaves a torso that is never
    # loaded.
    resume_name = None
    if promote_staging(ck_dir / "preempt_model"):
        resume_name = "preempt_model"
    elif promote_staging(ck_dir / "best_model"):
        resume_name = "best_model"
    elif resume and ((ck_dir / "preempt_model").exists()
                     or (ck_dir / "best_model").exists()):
        print("WARNING: checkpoint directory holds only torn "
              "(unfinalized) checkpoints — starting fresh")
    if resume and resume_name:
        state, start_epoch = trainer.resume(resume_name)
        # Epochs the previous process logged past this restore point were
        # discarded by the restore: drop their CSV rows.
        dropped = logger.truncate_from(start_epoch)
        if dropped:
            print(f"Dropped {dropped} stale epoch rows past the restore "
                  f"point from {logger.csv_path}")
        print(f"Resumed from epoch {start_epoch - 1} ({resume_name})")
    else:
        state = trainer.init_state()
        if logger.reset():
            # A fresh run into a directory holding a previous run's CSV
            # replaces it; appending would mix two epoch lineages.
            print(f"Replaced previous epoch CSV at {logger.csv_path}")
    print("Parameters:", count_parameters(model)["total"])

    result = trainer.fit(state, start_epoch=start_epoch)
    if result["preempted"]:
        # A half-trained model must never produce "final" metrics.
        print("Run preempted — skipping final evaluation; re-run with "
              "--resume to continue")
        return None
    logger.plot_training_curves()

    # Evaluate the weights model selection and the checkpoint use: the EMA
    # when it is on.
    if (resume_name == "preempt_model" and start_epoch > 1
            and not result["improved"] and (ck_dir / "best_model").exists()):
        # Resumed from a preemption checkpoint and no epoch beat the
        # restored best: the true best lives on disk.
        _, eval_weights = load_model_for_evaluation(
            ck_dir / "best_model", cfg, device=device)
    else:
        eval_weights = trainer.eval_params(result["best_state"])
    evaluator = Evaluator(model, eval_weights, test_l, cfg,
                          output_dir=cfg.paths.results_dir)
    return evaluator.evaluate()


def main(argv=None):
    """Run the training; returns the test metrics (``--all_seeds``: the
    seed summary), or None when preempted."""
    args = parse_args(argv)
    if args.preset in _WIDE_PRESETS:
        raise SystemExit(
            f"--preset {args.preset} (d={_WIDE_PRESETS[args.preset]}) is not "
            f"ported: the fused ViT block's widths stop at 320; use --preset "
            f"tiny")
    import numpy as np

    from rovit_kan_tpu_torch import resolve_device
    from rovit_kan_tpu_torch.data.synthetic import generate_synthetic_dataset

    device = "cpu" if args.cpu else "cuda"
    resolve_device(device)
    np.random.seed(args.seed)
    config = build_config(args)

    aug_root = args.data_root / "Augmented Image"
    orig_root = args.data_root / "Original Image"
    if args.synthetic:
        n = args.synthetic_per_class or (8 if args.fast else 64)
        generate_synthetic_dataset(aug_root, n_per_class=n,
                                   size=config.data.image_size,
                                   class_names=config.data.class_names,
                                   seed=args.seed)
        generate_synthetic_dataset(orig_root, n_per_class=max(n // 2, 2),
                                   size=config.data.image_size,
                                   class_names=config.data.class_names,
                                   seed=args.seed + 1)

    def run(seed, out_dir):
        return run_one(config, seed, out_dir, aug_root, orig_root, device,
                       args.resume, args.device_cache)

    if not args.all_seeds:
        metrics = run(args.seed, args.output_dir)
        if metrics is not None:
            print("Done. Test accuracy:", metrics["accuracy"])
        return metrics

    # Multi-seed sweep over config.train.seeds.
    all_metrics = {}
    for seed in config.train.seeds:
        print(f"===== seed {seed} =====")
        m = run(seed, args.output_dir / f"seed_{seed}")
        if m is None:             # preempted: stop the sweep cleanly
            print(f"Sweep preempted at seed {seed}; re-run with --resume")
            return None
        all_metrics[seed] = m
    keys = ("accuracy", "macro_f1", "weighted_f1", "mae", "spearman_rho",
            "brier_score", "ece")
    summary = {}
    for k in keys:
        vals = np.asarray([m[k] for m in all_metrics.values()], np.float64)
        summary[k] = {"mean": float(vals.mean()), "std": float(vals.std()),
                      "per_seed": {str(s): float(m[k])
                                   for s, m in all_metrics.items()}}
    args.output_dir.mkdir(parents=True, exist_ok=True)
    (args.output_dir / "seed_summary.json").write_text(
        json.dumps(summary, indent=2))
    print("Seed sweep summary (mean ± std):")
    for k in keys:
        print(f"  {k:14s} {summary[k]['mean']:.4f} ± {summary[k]['std']:.4f}")
    return summary


if __name__ == "__main__":
    main()
