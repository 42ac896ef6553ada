"""Convert a PyTorch checkpoint to the ``.npz`` weight format.

    python -m rovit_kan_tpu_torch.cli.convert_checkpoint \
        --input best_model.pth --output weights.npz [--depth 12]

The counterpart of the JAX package's ``scripts/convert_checkpoint.py``: a
reference RoViTKAN ``best_model.pth`` (keys under ``backbone.model.``, the
full model) or a bare timm ``deit_tiny_patch16_224`` state_dict (the
backbone only) becomes the JAX param tree, written as the JAX package's
``.npz``, so one file serves ``cli.train --pretrained_npz`` in both
packages. Runs on the CPU.
"""
from __future__ import annotations

import argparse
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", type=Path, required=True)
    p.add_argument("--output", type=Path, required=True)
    p.add_argument("--depth", type=int, default=12)
    return p.parse_args(argv)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def main(argv=None) -> dict:
    """Convert and write; returns the param tree."""
    args = parse_args(argv)
    from rovit_kan_tpu_torch.models.convert import (
        convert_reference_checkpoint,
        convert_timm_vit,
        load_torch_checkpoint,
        save_npz,
    )

    sd = load_torch_checkpoint(args.input)
    if any(k.startswith("backbone.model.") for k in sd):
        params = convert_reference_checkpoint(sd, depth=args.depth)
        kind = "reference RoViTKAN"
    else:
        params = {"backbone": convert_timm_vit(sd, depth=args.depth)}
        kind = "timm ViT backbone"
    save_npz(params, args.output)
    n = sum(v.size for _, v in _leaves(params))
    print(f"Converted {kind}: {n:,} params -> {args.output}")
    return params


if __name__ == "__main__":
    main()
