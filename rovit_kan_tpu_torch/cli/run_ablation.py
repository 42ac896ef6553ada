"""Run the six-variant ablation study, on one card or several.

    python -m rovit_kan_tpu_torch.cli.run_ablation [--data-root data] \
        [--output-dir outputs/ablation] [--batch-size 32] [--epochs 50] \
        [--seed 42] [--patience P] [--checkpoint-min-interval S] [--fast] \
        [--synthetic [--n-per-class N]] [--tiny] [--device-cache] [--cpu] \
        [--devices N] [--multihost]

The flow of the JAX package's ``scripts/run_ablation.py``: the dataset
under ``DATA/Augmented Image`` (``--synthetic`` generates it first), a
70/15/15 split from ``np.random.RandomState(seed).permutation``, the focal
alpha from the train split's class weights, and ``run_ablation_study``
over the six variants. ``--fast`` runs 5 epochs over at most 1,000 samples
at batch 64; ``--tiny`` a 64-px model of depth 2 and width 32 in fp32 for at
most 4 epochs at batch 8. Below the config's last curriculum stage the
stage boundaries are spread evenly over the epochs (not with ``--tiny``).
``--device-cache`` keeps the splits on the card (``DeviceLoader``).

``--devices N`` (default -1, every visible card) trains every variant data
parallel over N ranks, one process per card (``cli.train``'s launch: N
workers with ``--multihost``, rank r on ``cuda:r``; ``--cpu --devices N``
on the CPU); rank 0 writes the files. ``--multihost`` joins a torchrun job
instead.

Runs on the card unless ``--cpu`` is given. Not ported: the pipelined
variant of the JAX study.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from rovit_kan_tpu_torch.cli import (
    MULTIHOST_HELP,
    data_parallel_size,
    spawn_workers,
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data-root", type=Path, default=Path("data"))
    p.add_argument("--output-dir", type=Path,
                   default=Path("outputs/ablation"))
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--patience", type=int, default=None,
                   help="early-stop patience (epochs without val "
                        "improvement); default keeps the config value")
    p.add_argument("--checkpoint-min-interval", type=float, default=None,
                   help="min seconds between best-model disk writes "
                        "(config.train.checkpoint_min_interval_s)")
    p.add_argument("--fast", action="store_true",
                   help="5 epochs / 1000-sample subset / bs=64")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic dataset under data-root")
    p.add_argument("--n-per-class", type=int, default=None,
                   help="synthetic images per class (default: 64, or 8 "
                        "with --tiny)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model + 64px (smoke test)")
    p.add_argument("--device-cache", action="store_true",
                   help="keep the uint8 splits on the card (DeviceLoader)")
    p.add_argument("--devices", type=int, default=-1,
                   help="data-parallel mesh size (-1 = all): one process "
                        "per card")
    p.add_argument("--multihost", action="store_true", help=MULTIHOST_HELP)
    return p.parse_args(argv)


def build_config(args: argparse.Namespace):
    """``(config, epochs, max_samples)`` as the JAX script sets them from
    the flags."""
    from rovit_kan_tpu_torch.config import get_config

    config = get_config()
    epochs = args.epochs
    batch_size = args.batch_size
    max_samples = None
    if args.fast:
        epochs = 5
        max_samples = 1000
        batch_size = 64
    if args.tiny:
        config.data.image_size = 64
        config.model.depth = 2
        config.model.embed_dim = 32
        config.model.num_heads = 2
        config.model.hidden_dim = 16
        config.model.kan_layers = [32, 8, 1]
        config.flags.mixed_precision = False
        config.flags.freeze_backbone_epochs = 1
        config.train.stage_1_epochs = 1
        config.train.stage_2_epochs = 2
        config.train.stage_3_epochs = 3
        config.tpu.use_pallas_attention = False
        config.tpu.use_pallas_kan = False
        epochs = min(epochs, 4)
        batch_size = min(batch_size, 8)
    config.train.batch_size = batch_size
    config.train.epochs = epochs
    if args.patience is not None:
        config.train.early_stop_patience = args.patience
    if args.checkpoint_min_interval is not None:
        config.train.checkpoint_min_interval_s = args.checkpoint_min_interval
    # The curriculum's boundaries spread over the epoch budget: at the
    # config's 10/25/40 a short run would never leave stage 1.
    if epochs < config.train.stage_4_epochs and not args.tiny:
        config.train.stage_1_epochs = max(1, epochs // 4)
        config.train.stage_2_epochs = max(2, epochs // 2)
        config.train.stage_3_epochs = max(3, 3 * epochs // 4)
        config.train.stage_4_epochs = epochs
    return config, epochs, max_samples


def split_indices(n: int, seed: int, max_samples=None):
    """The seeded 70/15/15 train, validation and test indices of ``n``
    samples, cut to the first ``max_samples`` of the permutation."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(n)
    if max_samples and len(order) > max_samples:
        order = order[:max_samples]
    n = len(order)
    n_train, n_val = int(0.7 * n), int(0.15 * n)
    return (order[:n_train], order[n_train:n_train + n_val],
            order[n_train + n_val:])


def main(argv=None):
    """Run the study; returns the ``AblationExperiment`` (None in the
    process that started the ranks of ``--devices N``)."""
    args = parse_args(argv)
    mesh = None
    if args.multihost:
        from rovit_kan_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(args.devices, device="cpu" if args.cpu else None)
    else:
        n = data_parallel_size(args.devices, args.cpu)
        if n > 1:
            spawn_workers(
                [sys.executable, "-m", "rovit_kan_tpu_torch.cli.run_ablation",
                 *(sys.argv[1:] if argv is None else argv), "--multihost"],
                n)
            return None
    from rovit_kan_tpu_torch import resolve_device
    from rovit_kan_tpu_torch.data.dataset import (
        Loader,
        RoseLeafDataset,
        Subset,
    )
    from rovit_kan_tpu_torch.data.synthetic import generate_synthetic_dataset
    from rovit_kan_tpu_torch.experiments.ablation import run_ablation_study
    from rovit_kan_tpu_torch.parallel.multihost import barrier, process_index

    device = "cpu" if args.cpu else "cuda"
    resolve_device(device)
    if mesh is not None:
        device = str(mesh.device)
    config, epochs, max_samples = build_config(args)

    root = args.data_root / "Augmented Image"
    if args.synthetic and process_index() == 0:
        n = args.n_per_class or (8 if args.tiny else 64)
        generate_synthetic_dataset(root, n_per_class=n,
                                   size=config.data.image_size,
                                   class_names=config.data.class_names,
                                   seed=args.seed)
    barrier()                     # the other ranks read rank 0's images

    ds = RoseLeafDataset(root, config.data.class_names,
                         config.data.severity_map,
                         image_size=config.data.image_size, mode="augmented")
    train_idx, val_idx, test_idx = split_indices(len(ds), args.seed,
                                                 max_samples)
    train_ds = Subset(ds, train_idx)
    val_ds = Subset(ds, val_idx)
    test_ds = Subset(ds, test_idx)

    batch_size = config.train.batch_size
    if args.device_cache:
        from rovit_kan_tpu_torch.data.device_cache import (
            device_cache_loaders,
        )
        train_l, val_l, test_l = device_cache_loaders(
            train_ds, val_ds, test_ds, batch_size, seed=args.seed,
            device=device, mesh=mesh)
    else:
        train_l = Loader(train_ds, batch_size, shuffle=True, drop_last=True,
                         seed=args.seed)
        val_l = Loader(val_ds, batch_size)
        test_l = Loader(test_ds, batch_size)

    focal_alpha = train_ds.get_class_weights()
    exp = run_ablation_study(config, train_l, val_l, test_l,
                             args.output_dir, focal_alpha=focal_alpha,
                             epochs=epochs, device=device, seed=args.seed,
                             mesh=mesh)
    print("Ablation study complete:", args.output_dir)
    return exp


if __name__ == "__main__":
    main()
