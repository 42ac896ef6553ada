"""Export a trained checkpoint to a self-contained ``torch.export`` serving
artifact, on one card.

    python -m rovit_kan_tpu_torch.cli.export_model CHECKPOINT OUT.pt2 \
        [--batch-size 64] [--temperature T] [--verify] [--cpu]

The flow of the JAX package's ``scripts/export_model.py``. The model is
rebuilt from the checkpoint with ``inference=True``, so on the card the
"auto" policy puts the fused block (#1) into the artifact, as the custom op
``rovit_kan_torch::vit_block_fwd``. The weights and the calibration
temperature (default: the checkpoint sidecar's, else 1.0) are baked in.
``rovit_kan_tpu_torch.export.load_exported`` loads the artifact with torch
and the port's op library alone. ``--verify`` reloads it and holds its
outputs against the live model's serving forward on random uint8 images at
rtol = atol = 1e-5. Runs on the card unless ``--cpu`` is given;
``--platforms`` has no torch counterpart and is refused.
"""
from __future__ import annotations

import argparse
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("checkpoint", type=Path,
                   help="checkpoint directory (e.g. outputs/train/"
                        "checkpoints/best_model)")
    p.add_argument("out", type=Path, help="output artifact path (.pt2)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--platforms", nargs="+", default=None,
                   help="refused: an artifact runs on the device it was "
                        "exported on (the card, or the CPU with --cpu)")
    p.add_argument("--verify", action="store_true",
                   help="reload the artifact and check its outputs against "
                        "the live model on random inputs")
    p.add_argument("--cpu", action="store_true",
                   help="export the plain path on the CPU")
    p.add_argument("--temperature", type=float, default=None,
                   help="calibration temperature baked into the artifact "
                        "(softmax(logits/T); argmax unchanged). Default: "
                        "the checkpoint sidecar's (cli.evaluate "
                        "--store_temperature), else 1.0")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Export (and verify); returns the artifact's size in bytes."""
    args = parse_args(argv)
    from rovit_kan_tpu_torch.export import refuse_platforms
    refuse_platforms(args.platforms)

    import numpy as np
    import torch

    from rovit_kan_tpu_torch.evaluation.evaluator import \
        load_model_for_evaluation
    from rovit_kan_tpu_torch.export import load_exported, save_exported
    from rovit_kan_tpu_torch.serving import build_serving_forward
    from rovit_kan_tpu_torch.utils.checkpoint import load_meta

    device = "cpu" if args.cpu else "cuda"
    model, _ = load_model_for_evaluation(args.checkpoint, device=device)
    temperature = args.temperature
    if temperature is None:
        temperature = float(load_meta(args.checkpoint).get("temperature",
                                                           1.0))
    n = save_exported(args.out, model, args.batch_size,
                      temperature=temperature)
    t_note = f", T={temperature:.4f}" if temperature != 1.0 else ""
    print(f"Exported {args.out} ({n / 1e6:.1f} MB, batch={args.batch_size}, "
          f"image_size={model.image_size}, {device}{t_note})")

    if args.verify:
        size = model.image_size
        x = np.random.RandomState(0).randint(
            0, 256, (args.batch_size, size, size, 3)).astype(np.uint8)
        got = load_exported(args.out)(x)
        with torch.inference_mode():
            want = build_serving_forward(model, temperature)(
                torch.from_numpy(x).to(device))
        for k, v in want.items():
            np.testing.assert_allclose(got[k].cpu().numpy(), v.cpu().numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        print(f"Verified: {sorted(want)} match the live model")
    return n


if __name__ == "__main__":
    main()
