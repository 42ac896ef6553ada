"""Experiment logger: the per-epoch CSV, JSON metrics, text summaries and
training curves.

A copy of ``rovit_kan_tpu/results/logger.py`` (numpy and the standard
library; the port keeps its own copy): the same 14-column epoch CSV (epoch,
stage, six train metrics, six val metrics), ``reset``, ``truncate_from``,
``save_metrics``, ``log_experiment``, ``save_comparison_table`` and
``plot_training_curves``. The plot imports matplotlib only when it is
drawn; on a machine without it the plot is skipped with a warning and
everything else is logged."""
from __future__ import annotations

import csv
import json
import warnings
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

CSV_COLUMNS = [
    "epoch", "stage",
    "train_total_loss", "train_cls_loss", "train_ord_loss",
    "train_unc_loss", "train_kan_loss", "train_accuracy",
    "val_total_loss", "val_cls_loss", "val_ord_loss",
    "val_unc_loss", "val_kan_loss", "val_accuracy",
]


def _scalar(x) -> float:
    if hasattr(x, "item"):
        return float(x.item())
    return float(x)


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    if hasattr(x, "item") and getattr(x, "ndim", None) == 0:
        return x.item()
    return x


class ExperimentLogger:
    def __init__(self, log_dir, experiment_name: str = "experiment"):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.experiment_name = experiment_name
        self.csv_path = self.log_dir / f"{experiment_name}_epochs.csv"
        self._csv_started = False

    def log_epoch(self, epoch: int, stage: int,
                  train_metrics: Dict[str, Any],
                  val_metrics: Dict[str, Any]) -> None:
        row = {
            "epoch": epoch, "stage": stage,
            **{f"train_{k}": _scalar(train_metrics.get(k, 0.0))
               for k in ("total_loss", "cls_loss", "ord_loss", "unc_loss",
                         "kan_loss", "accuracy")},
            **{f"val_{k}": _scalar(val_metrics.get(k, 0.0))
               for k in ("total_loss", "cls_loss", "ord_loss", "unc_loss",
                         "kan_loss", "accuracy")},
        }
        mode = "a" if self._csv_started or self.csv_path.exists() else "w"
        with open(self.csv_path, mode, newline="") as f:
            w = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
            if mode == "w":
                w.writeheader()
            w.writerow(row)
        self._csv_started = True

    def reset(self) -> bool:
        """Delete the epoch CSV so a FRESH (non-resumed) run replaces any
        previous run's rows instead of appending after them. ``log_epoch``
        appends whenever the file exists — correct for resumes within one
        lineage, but a fresh retrain into the same directory (ablation
        regeneration, a re-launched train.py without --resume) would
        otherwise produce a CSV with two concatenated epoch lineages.
        Returns True when an old CSV was removed."""
        existed = self.csv_path.exists()
        if existed:
            self.csv_path.unlink()
        self._csv_started = False
        return existed

    def truncate_from(self, start_epoch: int) -> int:
        """Drop CSV rows with ``epoch >= start_epoch``; returns #dropped.

        A resumed run re-trains (and re-logs) every epoch from its restore
        point, but epochs the *previous* process logged past its last
        checkpoint are stale — their training progress was discarded by the
        restore. Without this, a preempt/resume cycle leaves the CSV with
        duplicated, diverging epoch rows (two epoch-19..23 lineages), which
        poisons ``plot_training_curves`` and any golden-CSV comparison.
        ``train.py --resume`` calls this with the trainer's resume epoch
        before the first ``log_epoch``."""
        if not self.csv_path.exists():
            return 0
        with open(self.csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
        keep = [r for r in rows if int(r["epoch"]) < start_epoch]
        if len(keep) == len(rows):
            return 0
        with open(self.csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
            w.writeheader()
            w.writerows(keep)
        self._csv_started = True
        return len(rows) - len(keep)

    def save_metrics(self, metrics: Dict[str, Any],
                     filename: str = "metrics.json") -> Path:
        p = self.log_dir / filename
        p.write_text(json.dumps(_jsonable(metrics), indent=2))
        return p

    def log_experiment(self, name: str, config_summary: str,
                       results: Dict[str, Any]) -> Path:
        p = self.log_dir / f"{name}_summary.txt"
        lines = [f"Experiment: {name}", "=" * 60, config_summary, "-" * 60]
        lines += [f"{k}: {v}" for k, v in _jsonable(results).items()]
        p.write_text("\n".join(lines) + "\n")
        return p

    def print_table(self, rows, headers) -> None:
        widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
                  for i, h in enumerate(headers)] if rows else [len(str(h)) for h in headers]
        fmt = "  ".join(f"{{:<{w}}}" for w in widths)
        print(fmt.format(*headers))
        print(fmt.format(*("-" * w for w in widths)))
        for r in rows:
            print(fmt.format(*[str(c) for c in r]))

    def plot_training_curves(self, csv_path: Optional[Path] = None,
                             out_name: Optional[str] = None) -> Optional[Path]:
        """2x3 grid: total/cls/ord/unc/kan loss and accuracy; returns the
        PNG's path, or None when there is nothing to draw or no
        matplotlib."""
        try:
            import matplotlib
        except ImportError:
            warnings.warn("matplotlib is not installed: training curves not "
                          "drawn")
            return None
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        csv_path = Path(csv_path or self.csv_path)
        if not csv_path.exists():
            return None
        with open(csv_path) as f:
            rows = list(csv.DictReader(f))
        if not rows:
            return None
        epochs = [int(r["epoch"]) for r in rows]

        fig, axes = plt.subplots(2, 3, figsize=(16, 9))
        panels = [("total_loss", "Total loss"), ("cls_loss", "Classification"),
                  ("ord_loss", "Ordinal"), ("unc_loss", "Uncertainty"),
                  ("kan_loss", "KAN"), ("accuracy", "Accuracy")]
        for ax, (key, title) in zip(axes.flat, panels):
            ax.plot(epochs, [float(r[f"train_{key}"]) for r in rows],
                    label="train")
            ax.plot(epochs, [float(r[f"val_{key}"]) for r in rows],
                    label="val")
            ax.set_title(title)
            ax.set_xlabel("epoch")
            ax.legend()
            ax.grid(alpha=0.3)
        fig.suptitle(self.experiment_name)
        fig.tight_layout()
        out = self.log_dir / (out_name or f"{self.experiment_name}_curves.png")
        fig.savefig(out, dpi=120)
        plt.close(fig)
        return out

    def save_comparison_table(self, rows, headers,
                              filename: str = "comparison.csv") -> Path:
        p = self.log_dir / filename
        with open(p, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(headers)
            w.writerows(rows)
        return p
