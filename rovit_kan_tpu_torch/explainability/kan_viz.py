"""KAN interpretability: learned spline curves, activation trajectories,
severity distributions, spline weight heatmaps.

Counterpart of ``rovit_kan_tpu/explainability/kan_viz.py``. The inputs are
the port's ``KANSeverityModule`` or its ``state_dict``; the trajectory
replays the stack with the plain ``kan_layer_apply`` on the features'
device, and the spline curves evaluate the coefficients on a [-1, 1] grid
(``ops/spline.py::spline_curve``). matplotlib is imported only inside the
plotting methods.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from rovit_kan_tpu_torch.models.kan import KANLike, kan_layer_params
from rovit_kan_tpu_torch.ops.spline import (
    kan_layer_apply,
    make_knots,
    spline_curve,
)


def _knots(spline_weights: torch.Tensor, degree: int) -> np.ndarray:
    """The knot vector of coefficients ``(in, out, K)``: ``K`` bases of
    degree ``degree`` come from ``K - degree + 1`` knots."""
    return make_knots(spline_weights.shape[-1] - degree + 1, degree)


@torch.no_grad()
def kan_trajectory(kan: KANLike, features: torch.Tensor,
                   degree: int = 3) -> List[np.ndarray]:
    """Per-layer activations, the input and the final score included."""
    layers = kan_layer_params(kan)
    knots = _knots(layers[0][0], degree)
    acts = [features.detach().cpu().numpy()]
    x = features
    for i, (spline, weight, bias) in enumerate(layers):
        x = kan_layer_apply(x, spline, weight.t(), bias, knots, degree)
        x = torch.relu(x) if i < len(layers) - 1 else 3.0 * torch.sigmoid(x)
        acts.append(x.cpu().numpy())
    return acts


class KANVisualizer:
    """Figure suite for a trained KAN severity module."""

    def __init__(self, kan: KANLike, degree: int = 3,
                 output_dir: Optional[Path] = None):
        self.kan = kan
        self.layers = kan_layer_params(kan)
        self.degree = degree
        self.knots = _knots(self.layers[0][0], degree)
        self.output_dir = Path(output_dir) if output_dir else None

    def _spline_weights(self, layer_idx: int) -> np.ndarray:
        return self.layers[layer_idx][0].detach().cpu().numpy()

    def _finish(self, fig, name: str):
        import matplotlib.pyplot as plt
        if self.output_dir is not None:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            path = self.output_dir / name
            fig.savefig(path, dpi=120, bbox_inches="tight")
            plt.close(fig)
            return path
        return fig

    @staticmethod
    def _pyplot():
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt

    def plot_spline_activations(self, layer_idx: int = 0,
                                max_curves: int = 16,
                                name: str = "kan_splines.png"):
        """Grid of the largest-magnitude learned spline curves of one
        layer."""
        plt = self._pyplot()
        w = self._spline_weights(layer_idx)
        in_f, out_f, _ = w.shape
        pairs = [(i, j) for i in range(in_f) for j in range(out_f)]
        order = np.argsort(-np.abs(w).sum(-1).ravel())[:max_curves]
        pairs = [pairs[k] for k in order]
        cols = 4
        rows = (len(pairs) + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(3.2 * cols, 2.4 * rows),
                                 squeeze=False)
        for ax, (i, j) in zip(axes.flat, pairs):
            x, y = spline_curve(w, self.knots, i, j, degree=self.degree)
            ax.plot(x, y)
            ax.set_title(f"$\\phi_{{{i},{j}}}$", fontsize=9)
            ax.grid(alpha=0.3)
        for ax in axes.flat[len(pairs):]:
            ax.axis("off")
        fig.suptitle(f"KAN layer {layer_idx} learned splines")
        fig.tight_layout()
        return self._finish(fig, name)

    def plot_severity_trajectory(self, features: torch.Tensor,
                                 severities: np.ndarray,
                                 name: str = "kan_trajectory.png"):
        """Mean activation of consecutive KAN layers, coloured by
        severity."""
        plt = self._pyplot()
        acts = kan_trajectory(self.kan, features, self.degree)
        means = [a.mean(axis=1) for a in acts]
        n_steps = len(means) - 1
        fig, axes = plt.subplots(1, n_steps, figsize=(4.5 * n_steps, 4),
                                 squeeze=False)
        sc = None
        for s in range(n_steps):
            ax = axes[0, s]
            sc = ax.scatter(means[s], means[s + 1], c=severities,
                            cmap="viridis", s=18, alpha=0.8)
            ax.set_xlabel(f"layer {s} mean act")
            ax.set_ylabel(f"layer {s + 1} mean act")
            ax.grid(alpha=0.3)
        fig.colorbar(sc, ax=axes[0, -1], label="severity")
        fig.suptitle("KAN activation trajectory")
        fig.tight_layout()
        return self._finish(fig, name)

    def plot_severity_distribution(self, severity_pred: np.ndarray,
                                   class_idx: np.ndarray,
                                   class_names: Sequence[str],
                                   name: str = "kan_severity_violin.png"):
        """Per-class violin plot of predicted severities."""
        plt = self._pyplot()
        groups = [np.asarray(severity_pred)[np.asarray(class_idx) == i]
                  for i in range(len(class_names))]
        fig, ax = plt.subplots(figsize=(8, 4.5))
        present = [g for g in groups if g.size > 0]
        if present:
            ax.violinplot(present, showmedians=True,
                          positions=[i for i, g in enumerate(groups)
                                     if g.size > 0])
        ax.set_xticks(range(len(class_names)))
        ax.set_xticklabels(class_names, rotation=20, ha="right")
        ax.set_ylabel("KAN predicted severity")
        ax.set_title("Severity distribution by class")
        ax.grid(alpha=0.3, axis="y")
        fig.tight_layout()
        return self._finish(fig, name)

    def plot_spline_weights_heatmap(self, name: str = "kan_weights.png"):
        """Basis-averaged |spline weight| heatmap per layer."""
        plt = self._pyplot()
        n = len(self.layers)
        fig, axes = plt.subplots(1, n, figsize=(5 * n, 4), squeeze=False)
        for i, ax in enumerate(axes[0]):
            w = np.abs(self._spline_weights(i)).mean(axis=-1)
            im = ax.imshow(w.T, aspect="auto", cmap="viridis")
            ax.set_xlabel("in feature")
            ax.set_ylabel("out feature")
            ax.set_title(f"kan_layers.{i}")
            fig.colorbar(im, ax=ax, fraction=0.046)
        fig.suptitle("KAN spline weight magnitudes (basis-averaged)")
        fig.tight_layout()
        return self._finish(fig, name)
