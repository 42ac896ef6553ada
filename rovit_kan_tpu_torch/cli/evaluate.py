"""Evaluate a checkpoint on the Original-Image test set, on one card.

    python -m rovit_kan_tpu_torch.cli.evaluate --checkpoint CK --data_root DATA \
        [--batch_size 32] [--output_dir outputs/eval] [--image_size S] [--cpu] \
        [--calibrate [--store_temperature]] [--device_metrics auto|on|off] \
        [--matmul_precision P]

The flow of the JAX package's ``scripts/evaluate.py``: the model and its
weights come from the checkpoint (at ``--image_size`` through the position
embedding's resolution transfer), the test set from ``DATA/Original
Image``. ``--calibrate`` fits a temperature on the validation split of
``DATA/Augmented Image``; ``--store_temperature`` writes it into the
checkpoint's sidecar, which ``load_engine`` then applies, and refuses a
degenerate fit, leaving the sidecar unchanged. ``--device_metrics`` computes
the metrics on the device (``auto``: when more than one card is visible) and
writes ``test_metrics_device.json``; otherwise ``Evaluator.evaluate`` writes
``test_metrics.json``, the report and the figures. ``--matmul_precision``
sets ``torch.set_float32_matmul_precision`` for the plain path. Runs on the
card unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from rovit_kan_tpu_torch.cli import (
    MATMUL_PRECISION,
    MATMUL_PRECISION_HELP,
    set_matmul_precision,
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", type=Path, required=True)
    p.add_argument("--data_root", type=Path, default=Path("data"))
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--output_dir", type=Path, default=Path("outputs/eval"))
    p.add_argument("--image_size", type=int, default=None,
                   help="evaluate at a different resolution than trained "
                        "(pos-embed interpolation); default: the "
                        "checkpoint's native size")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--calibrate", action="store_true",
                   help="fit temperature scaling on the validation split "
                        "(Augmented tree) before evaluating: ECE/Brier "
                        "improve, argmax metrics are unchanged; records "
                        "pre/post ECE and the fitted T in the results")
    p.add_argument("--store_temperature", action="store_true",
                   help="with --calibrate: write the fitted T into the "
                        "checkpoint's meta sidecar so serving applies it")
    p.add_argument("--device_metrics", choices=["auto", "on", "off"],
                   default="auto",
                   help="compute the metrics on the device "
                        "(ops/device_metrics.py) instead of gathering "
                        "predictions to the host; 'auto' switches it on "
                        "when more than one card is visible")
    p.add_argument("--matmul_precision", default=None,
                   choices=sorted(MATMUL_PRECISION),
                   help=MATMUL_PRECISION_HELP)
    return p.parse_args(argv)


def main(argv=None):
    """Run the evaluation; returns the ``Evaluator`` (its ``temperature``
    and ``temperature_degenerate`` after ``--calibrate``)."""
    args = parse_args(argv)
    set_matmul_precision(args.matmul_precision)
    import torch

    from rovit_kan_tpu_torch.config import get_config
    from rovit_kan_tpu_torch.data.dataset import (
        Loader,
        RoseLeafDataset,
        create_dataloaders,
    )
    from rovit_kan_tpu_torch.evaluation.evaluator import (
        Evaluator,
        load_model_for_evaluation,
    )

    device = "cpu" if args.cpu else "cuda"
    config = get_config()
    # The architecture, with its native image size, comes from the config
    # in the checkpoint's sidecar; --image_size transfers the position
    # embedding to another size.
    model, params = load_model_for_evaluation(
        args.checkpoint, config, image_size=args.image_size, device=device)
    size = model.image_size
    config.data.image_size = size

    test_ds = RoseLeafDataset(args.data_root / "Original Image",
                              config.data.class_names,
                              config.data.severity_map, image_size=size)
    if len(test_ds) == 0:
        raise SystemExit(
            f"no images found under {args.data_root / 'Original Image'} "
            f"(expected class-per-folder JPEGs)")
    loader = Loader(test_ds, args.batch_size)

    evaluator = Evaluator(model, params, loader, config,
                          output_dir=args.output_dir)
    if args.calibrate:
        _, val_loader, _ = create_dataloaders(
            args.data_root / "Augmented Image",
            args.data_root / "Original Image",
            config.data.class_names, config.data.severity_map,
            batch_size=args.batch_size, image_size=size)
        t = evaluator.fit_temperature(val_loader)
        print(f"Fitted temperature on validation split: T={t:.4f}")
        if args.store_temperature:
            if evaluator.temperature_degenerate:
                # A perfectly separated validation set drives the fit to
                # T -> 0; stored, it would make serving emit saturated 0/1
                # confidences on any out-of-distribution input.
                print("Refusing --store_temperature: the fit is degenerate "
                      "(validation perfectly separated — raw T hit the "
                      "floor). The checkpoint sidecar is unchanged; "
                      "load_engine keeps T=1.0.")
            else:
                from rovit_kan_tpu_torch.utils.checkpoint import update_meta
                update_meta(args.checkpoint, temperature=t)
                print("Stored T in the checkpoint sidecar: load_engine now "
                      "calibrates by default")
    use_device = (args.device_metrics == "on"
                  or (args.device_metrics == "auto" and not args.cpu
                      and torch.cuda.device_count() > 1))
    if use_device:
        m = evaluator.evaluate_on_device()
        print("On-device metrics (no host gather):")
        for key, v in m.items():
            if key != "confusion_matrix":
                print(f"  {key:16s} {v:.4f}")
        args.output_dir.mkdir(parents=True, exist_ok=True)
        with open(args.output_dir / "test_metrics_device.json", "w") as f:
            json.dump({k: (v.tolist() if hasattr(v, "tolist") else v)
                       for k, v in m.items()}, f, indent=2)
    else:
        evaluator.evaluate()
    return evaluator


if __name__ == "__main__":
    main()
