"""Explainability figures for a checkpoint, on one card.

    python -m rovit_kan_tpu_torch.cli.visualize --checkpoint CK \
        [--data_root data] [--output_dir outputs/viz] [--num_samples 8] \
        [--image_size 224] [--cpu]

The flow of the JAX package's ``scripts/visualize.py``: the model from the
checkpoint (``load_model_for_evaluation``), ``num_samples`` images of
``DATA/Original Image`` spread over the set by ``linspace``, one batched
attention rollout and one batched Grad-CAM++ call with the labels as
targets, then per sample ``attention_NN.png`` and ``gradcam_NN.png``, the
``summary_grid.png`` of overlays and, when the model has a KAN head, the
four KAN figures. Each figure is guarded, so one failure does not stop the
rest. matplotlib is imported only to draw: where it does not import, one
warning names the figures not written, and the maps are still computed.

Runs on the card unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import warnings
from pathlib import Path

import numpy as np

KAN_FIGURES = ("kan_splines.png", "kan_trajectory.png",
               "kan_severity_violin.png", "kan_weights.png")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", type=Path, required=True)
    p.add_argument("--data_root", type=Path, default=Path("data"))
    p.add_argument("--output_dir", type=Path, default=Path("outputs/viz"))
    p.add_argument("--num_samples", type=int, default=8)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    return p.parse_args(argv)


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where it does not
    import."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def main(argv=None):
    """Compute the maps and write the figures; returns ``(attention maps,
    Grad-CAM++ maps)``, numpy ``(n, H, W)``."""
    args = parse_args(argv)
    import torch

    from rovit_kan_tpu_torch.config import get_config
    from rovit_kan_tpu_torch.data.dataset import RoseLeafDataset
    from rovit_kan_tpu_torch.evaluation.evaluator import (
        load_model_for_evaluation,
    )
    from rovit_kan_tpu_torch.explainability import (
        GradCAMPlusPlus,
        KANVisualizer,
        ViTAttentionRollout,
    )
    from rovit_kan_tpu_torch.explainability.attention_maps import (
        overlay_heatmap,
    )
    from rovit_kan_tpu_torch.ops.preprocess import eval_batch

    device = "cpu" if args.cpu else "cuda"
    config = get_config()
    config.data.image_size = args.image_size
    out = args.output_dir
    out.mkdir(parents=True, exist_ok=True)

    model, _ = load_model_for_evaluation(args.checkpoint, config,
                                         device=device)
    size = model.image_size

    ds = RoseLeafDataset(args.data_root / "Original Image",
                         config.data.class_names, config.data.severity_map,
                         image_size=size)
    n = min(args.num_samples, len(ds))
    # Spread the samples across the classes.
    idxs = np.linspace(0, len(ds) - 1, n).astype(int)
    images = np.stack([ds[i][0] for i in idxs])
    labels = np.array([ds[i][1] for i in idxs])

    x = eval_batch(torch.from_numpy(images).to(
        next(model.parameters()).device))

    # Batched rollout and Grad-CAM++ for every sample.
    roller = ViTAttentionRollout(model, device=device)
    attn_maps = roller.generate(x)
    gc = GradCAMPlusPlus(model, device=device)
    cams = gc.compute(x, class_idx=labels)
    with torch.inference_mode():
        preds = model(x)["cls_logits"].argmax(1).cpu().numpy()

    plt = _pyplot()
    if plt is None:
        names = [f"{kind}_NN.png" for kind in ("attention", "gradcam")]
        names.append("summary_grid.png")
        if getattr(model, "with_kan", False):
            names += KAN_FIGURES
        warnings.warn(f"matplotlib is not installed: figures "
                      f"{', '.join(names)} not written")
        print(f"Wrote {len(list(out.glob('*.png')))} figures to {out}")
        return attn_maps, cams

    # Each figure is guarded, so one failure does not stop the rest.
    def guarded(desc, fn):
        try:
            fn()
        except Exception as e:          # noqa: BLE001 — reported, run goes on
            print(f"  [visualize] {desc} failed: {type(e).__name__}: {e}")

    for j in range(n):
        cname = config.data.class_names[labels[j]]
        guarded(f"attention {j}", lambda j=j, cname=cname: roller.visualize(
            images[j], attn_maps[j],
            save_path=out / f"attention_{j:02d}.png",
            title=f"{cname} (pred: "
                  f"{config.data.class_names[preds[j]]})"))
        guarded(f"gradcam {j}", lambda j=j, cname=cname: gc.visualize(
            images[j], cams[j], save_path=out / f"gradcam_{j:02d}.png",
            title=cname))

    # Summary grid: image, rollout overlay and Grad-CAM++ overlay a row.
    fig, axes = plt.subplots(n, 3, figsize=(10, 3.2 * n), squeeze=False)
    for j in range(n):
        img = images[j] / 255.0
        axes[j][0].imshow(img)
        axes[j][0].set_ylabel(config.data.class_names[labels[j]], fontsize=8)
        axes[j][1].imshow(overlay_heatmap(img, attn_maps[j]))
        axes[j][2].imshow(overlay_heatmap(img, cams[j]))
        for ax in axes[j]:
            ax.set_xticks([])
            ax.set_yticks([])
    axes[0][0].set_title("Original")
    axes[0][1].set_title("Attention rollout")
    axes[0][2].set_title("Grad-CAM++")
    fig.tight_layout()
    fig.savefig(out / "summary_grid.png", dpi=120, bbox_inches="tight")
    plt.close(fig)

    # The KAN figures, once a run, where the model has a KAN head.
    if getattr(model, "with_kan", False):
        with torch.inference_mode():
            outs = model(x)
        viz = KANVisualizer(model.kan_module, degree=model.kan_module.degree,
                            output_dir=out)
        guarded("kan splines", viz.plot_spline_activations)
        guarded("kan trajectory", lambda: viz.plot_severity_trajectory(
            outs["features"], labels))
        guarded("kan violin", lambda: viz.plot_severity_distribution(
            outs["kan_severity"][:, 0].cpu().numpy(), labels,
            config.data.class_names))
        guarded("kan heatmap", viz.plot_spline_weights_heatmap)

    print(f"Wrote {len(list(out.glob('*.png')))} figures to {out}")
    return attn_maps, cams


if __name__ == "__main__":
    main()
