"""Test-set evaluation: batched forward on the model's device -> metrics ->
report, JSON and figures; and rebuilding a trained model from a checkpoint.

Counterpart of ``rovit_kan_tpu/evaluation/evaluator.py``:

- ``Evaluator`` loops the test loader (the port's numpy ``Loader`` or its
  ``DeviceLoader``; fixed-shape batches with a ``valid`` mask on the padded
  tail), takes softmax and argmax for the class predictions, the KAN head's
  severity and the uncertainty std ``exp(0.5 * log_var)``;
- when the model has no KAN head, severity metrics score the ground truth
  (``severity_fallback``, flagged as ``severity_is_fallback``), the
  reference's artifact kept as in the JAX package;
- it computes accuracy, macro/weighted F1, MAE, Spearman rho, Brier, ECE,
  per-class metrics, the parameter count and the bs=1 FPS, fits a
  calibration temperature on a validation loader, and computes the same
  metrics on the device (``evaluate_on_device``, ``ops/device_metrics.py``);
- it prints a report and writes ``evaluation_results.txt``,
  ``test_metrics.json`` and four figures (PNG and PDF). matplotlib is
  imported only to draw them; without it the figures are skipped with one
  warning and everything else is written.

Under a process group (data-parallel ranks) every rank fits T on what its
loader yields and process 0's T is broadcast to all of them, as the JAX
package does, so ``--store_temperature`` persists the value every rank
serves.
"""
from __future__ import annotations

import copy
import json
import warnings
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.evaluation import metrics as M
from rovit_kan_tpu_torch.evaluation.calibration import (
    apply_temperature,
    fit_temperature_report,
    reliability_curve,
)
from rovit_kan_tpu_torch.models.convert import transfer_resolution
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN, build_model
from rovit_kan_tpu_torch.ops.preprocess import eval_batch
from rovit_kan_tpu_torch.parallel.multihost import broadcast_one_to_all
from rovit_kan_tpu_torch.utils.checkpoint import load_checkpoint

FIGURES = ("confusion_matrix", "confidence_histogram", "reliability_diagram",
           "severity_scatter")


class Evaluator:
    """``Evaluator(model, params, test_loader, config, output_dir=None,
    class_names=None)``: ``params`` is a state dict (what
    ``load_model_for_evaluation`` returns, or ``Trainer.eval_params``),
    loaded into ``model`` when given; the model is put in eval mode and runs
    on the device its parameters are on."""

    def __init__(self, model, params, test_loader, config: Config,
                 output_dir=None, class_names=None):
        if params is not None:
            model.load_state_dict(params)
        self.model = model.eval()
        self.params = params if params is not None else model.state_dict()
        self.device = next(model.parameters()).device
        self.test_loader = test_loader
        self.config = config
        self.output_dir = Path(output_dir or config.paths.results_dir)
        self.class_names = list(class_names or config.data.class_names)
        # Confidence temperature (evaluation/calibration.py): 1.0 = raw.
        self.temperature = 1.0

    # -- forward -------------------------------------------------------------
    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    @torch.inference_mode()
    def _forward_t(self, images_u8, temp: float) -> Dict[str, torch.Tensor]:
        out = self.model(eval_batch(self._on_device(images_u8)))
        logits = out["cls_logits"].float()
        # A divide by a device scalar, as the JAX evaluator divides (a CPU
        # scalar would make the card multiply by its reciprocal).
        t = torch.tensor(temp, dtype=torch.float32, device=self.device)
        return {
            "cls_logits": logits,
            "cls_probs": torch.softmax(logits / t, dim=-1),
            "kan_severity": out["kan_severity"][:, 0],
            "uncertainty_std": torch.exp(0.5 * out["log_var"][:, 0]),
        }

    def _forward(self, images_u8) -> Dict[str, torch.Tensor]:
        return self._forward_t(images_u8, self.temperature)

    def _outputs(self, loader, temp: Optional[float] = None):
        """Each batch's outputs and its ``labels``, ``severity`` and
        ``valid``, all on the device, concatenated over the loader."""
        temp = self.temperature if temp is None else temp
        parts: Dict[str, list] = {}
        for batch in loader:
            out = self._forward_t(batch["images"], temp)
            n = out["cls_logits"].shape[0]
            out["labels"] = self._on_device(batch["labels"]).long()
            out["severity"] = self._on_device(batch["severity"]).float()
            out["valid"] = (self._on_device(batch["valid"]).float()
                            if "valid" in batch else
                            torch.ones(n, device=self.device))
            for k, v in out.items():
                parts.setdefault(k, []).append(v)
        return {k: torch.cat(v) for k, v in parts.items()}

    @staticmethod
    def _host(cat: Dict[str, torch.Tensor], *keys) -> Tuple[np.ndarray, ...]:
        keep = cat["valid"] > 0
        return tuple(cat[k][keep].cpu().numpy() for k in keys)

    # -- calibration ---------------------------------------------------------
    def fit_temperature(self, val_loader) -> float:
        """Fit temperature scaling on a *validation* loader (never the test
        set) and arm it for later ``evaluate`` calls; returns T.

        Degenerate fits (a perfectly separated validation set) are clamped
        to ``calibration.T_FLOOR`` and flagged on
        ``self.temperature_degenerate``, so callers that persist T
        (``--store_temperature``) can refuse.

        Under a process group, process 0's T and flag are broadcast to every
        process: all ranks agree on (and return) the same T."""
        cat = self._outputs(val_loader, temp=1.0)
        logits, labels = self._host(cat, "cls_logits", "labels")
        rep = fit_temperature_report(logits, labels)
        t, degenerate = broadcast_one_to_all(
            (rep["temperature"], bool(rep["degenerate"])))
        self.temperature_degenerate = degenerate
        self.temperature = t
        return self.temperature

    def calibrated_metrics(self, val_loader) -> Dict[str, float]:
        """Fit T on the *validation* loader and re-score the test logits the
        last ``evaluate`` gathered (no second test pass): ``{temperature,
        temperature_degenerate, ece_calibrated, brier_calibrated}``.
        Accuracy, F1 and the confusion matrix do not move under a positive
        scalar divide."""
        if not hasattr(self, "_arrays"):
            raise RuntimeError("call evaluate() before calibrated_metrics()")
        d = self._arrays
        t = self.fit_temperature(val_loader)
        probs = apply_temperature(d["logits"], t)
        return {
            "temperature": float(t),
            "temperature_degenerate": bool(
                getattr(self, "temperature_degenerate", False)),
            "ece_calibrated": M.ece(probs, d["labels"]),
            "brier_calibrated": M.brier_score(probs, d["labels"]),
        }

    # -- metrics -------------------------------------------------------------
    def _collect(self) -> Dict[str, np.ndarray]:
        cat = self._outputs(self.test_loader)
        probs, logits, labels, sev_t, sev_p, unc = self._host(
            cat, "cls_probs", "cls_logits", "labels", "severity",
            "kan_severity", "uncertainty_std")
        return {"probs": probs, "logits": logits, "labels": labels,
                "severity_true": sev_t, "severity_pred": sev_p,
                "uncertainty": unc}

    def evaluate_on_device(self, severity_fallback: Optional[bool] = None
                           ) -> Dict[str, Any]:
        """The metric suite on the device (``ops/device_metrics.py``, with
        Spearman's average-tie ranks) over the concatenated outputs: nothing
        is read back until ``all_metrics`` returns. ``severity_fallback``
        follows ``evaluate``'s convention (True for a model without a KAN
        head), so both paths report the same MAE and rho for one checkpoint;
        the dict flags it as ``severity_is_fallback``."""
        from rovit_kan_tpu_torch.ops.device_metrics import all_metrics

        if severity_fallback is None:
            severity_fallback = not getattr(self.model, "with_kan", True)
        cat = self._outputs(self.test_loader)
        m = all_metrics(cat["cls_probs"], cat["labels"],
                        cat["severity"] if severity_fallback
                        else cat["kan_severity"],
                        cat["severity"], cat["valid"],
                        num_classes=len(self.class_names))
        out = {k: (v.cpu().numpy() if k == "confusion_matrix" else float(v))
               for k, v in m.items()}
        out["severity_is_fallback"] = bool(severity_fallback)
        return out

    def evaluate(self, run_fps: bool = True,
                 severity_fallback: Optional[bool] = None,
                 save: bool = True) -> Dict[str, Any]:
        """Full evaluation pass. ``severity_fallback`` defaults to True when
        the model has no KAN head."""
        if severity_fallback is None:
            severity_fallback = not getattr(self.model, "with_kan", True)

        d = self._collect()
        preds = d["probs"].argmax(axis=1)
        sev_pred = (d["severity_true"] if severity_fallback
                    else d["severity_pred"])

        k = len(self.class_names)
        n_params = M.count_params(self.params)
        results: Dict[str, Any] = {
            "accuracy": M.accuracy(d["labels"], preds),
            "macro_f1": M.macro_f1(d["labels"], preds, k),
            "weighted_f1": M.weighted_f1(d["labels"], preds, k),
            "mae": M.mae(d["severity_true"], sev_pred),
            "spearman_rho": M.spearman_rho(d["severity_true"], sev_pred),
            "brier_score": M.brier_score(d["probs"], d["labels"]),
            "ece": M.ece(d["probs"], d["labels"]),
            "mean_uncertainty": float(d["uncertainty"].mean()),
            "params": n_params,
            "params_m": n_params / 1e6,
            "n_test": int(d["labels"].size),
            "severity_is_fallback": bool(severity_fallback),
            "per_class": M.per_class_metrics(d["labels"], preds,
                                             self.class_names),
            "confusion_matrix": M.compute_confusion_matrix(
                d["labels"], preds, k).tolist(),
        }
        # Alias kept for drop-in compatibility with the reference's recorded
        # test_metrics.json files (both keys appear there).
        results["spearman"] = results["spearman_rho"]
        results["temperature"] = float(self.temperature)
        if self.temperature != 1.0:
            # The probabilities above carry T; record the raw-confidence ECE
            # and Brier beside them so the calibration delta is visible.
            raw = apply_temperature(d["logits"], 1.0)
            results["ece_precalibration"] = M.ece(raw, d["labels"])
            results["brier_precalibration"] = M.brier_score(raw, d["labels"])
        if run_fps:
            # A failure of the FPS run must not void the metrics above:
            # record it beside a null fps.
            try:
                results["fps"] = self._fps()
            except Exception as e:      # noqa: BLE001 — recorded in results
                warnings.warn(f"fps benchmark failed ({type(e).__name__}); "
                              f"recording fps=None: {e}")
                results["fps"] = None
                results["fps_error"] = f"{type(e).__name__}: {e}"

        self._print_report(results)
        if save:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            self._save_report(results)
            self._save_figures(d, results)
        self._arrays = d
        return results

    def _fps(self) -> float:
        """bs=1 inference FPS, the input already on the model's device."""
        size = self.config.data.image_size
        dummy = torch.zeros((1, size, size, 3), dtype=torch.uint8,
                            device=self.device)
        return float(M.fps_benchmark(self._forward, dummy))

    # -- report --------------------------------------------------------------
    def _print_report(self, r: Dict[str, Any]) -> None:
        print("=" * 60)
        print("Evaluation results")
        print("=" * 60)
        for key in ("accuracy", "macro_f1", "weighted_f1", "mae",
                    "spearman_rho", "brier_score", "ece", "fps", "params",
                    "n_test"):
            if key in r:
                v = r[key]
                print(f"  {key:16s} {v:.4f}" if isinstance(v, float)
                      else f"  {key:16s} {v}")
        if r.get("severity_is_fallback"):
            print("  NOTE: severity metrics use the ground-truth fallback "
                  "(no KAN head)")
        print("  Per-class:")
        for name, m in r["per_class"].items():
            print(f"    {name:16s} P={m['precision']:.4f} R={m['recall']:.4f}"
                  f" F1={m['f1']:.4f} n={m['support']}")

    def _save_report(self, r: Dict[str, Any]) -> None:
        txt = self.output_dir / "evaluation_results.txt"
        lines = ["Evaluation results", "=" * 60]
        for key, v in r.items():
            if key in ("per_class", "confusion_matrix"):
                continue
            lines.append(f"{key}: {v}")
        lines.append("per_class:")
        for name, m in r["per_class"].items():
            lines.append(f"  {name}: {m}")
        txt.write_text("\n".join(lines) + "\n")
        (self.output_dir / "test_metrics.json").write_text(
            json.dumps(r, indent=2))

    def _save_figures(self, d: Dict[str, np.ndarray],
                      r: Dict[str, Any]) -> None:
        """Confusion matrix, confidence histogram, reliability diagram and
        severity scatter, PNG + PDF; skipped, with one warning, where
        matplotlib does not import."""
        try:
            import matplotlib
        except ImportError:
            warnings.warn(f"matplotlib is not installed: figures "
                          f"{', '.join(FIGURES)} not drawn")
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        def save(fig, name):
            fig.tight_layout()
            for ext in ("png", "pdf"):
                fig.savefig(self.output_dir / f"{name}.{ext}", dpi=120)
            plt.close(fig)

        cm = np.asarray(r["confusion_matrix"])
        fig, ax = plt.subplots(figsize=(6, 5))
        im = ax.imshow(cm, cmap="Blues")
        ax.set_xticks(range(len(self.class_names)))
        ax.set_yticks(range(len(self.class_names)))
        ax.set_xticklabels(self.class_names, rotation=45, ha="right")
        ax.set_yticklabels(self.class_names)
        for i in range(cm.shape[0]):
            for j in range(cm.shape[1]):
                ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                        color="white" if cm[i, j] > cm.max() / 2 else "black")
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        ax.set_title("Confusion matrix")
        fig.colorbar(im)
        save(fig, "confusion_matrix")

        conf = d["probs"].max(axis=1)
        correct = d["probs"].argmax(axis=1) == d["labels"]
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist(conf[correct], bins=20, alpha=0.6, label="correct")
        if (~correct).any():
            ax.hist(conf[~correct], bins=20, alpha=0.6, label="incorrect")
        ax.set_xlabel("Confidence")
        ax.set_ylabel("Count")
        ax.set_title("Prediction confidence")
        ax.legend()
        save(fig, "confidence_histogram")

        # Reliability diagram: per-bin accuracy vs confidence against the
        # y=x diagonal, annotated with ECE (and the pre-calibration ECE when
        # a temperature is armed).
        rc = reliability_curve(d["probs"], d["labels"])
        centers = (rc["edges"][:-1] + rc["edges"][1:]) / 2
        width = rc["edges"][1] - rc["edges"][0]
        fig, ax = plt.subplots(figsize=(6, 5))
        filled = ~np.isnan(rc["accuracy"])
        ax.bar(centers[filled], rc["accuracy"][filled], width=width * 0.92,
               alpha=0.75, edgecolor="black", linewidth=0.5,
               label="accuracy")
        ax.bar(centers[filled], (rc["confidence"] - rc["accuracy"])[filled],
               bottom=rc["accuracy"][filled], width=width * 0.92,
               alpha=0.35, color="red", edgecolor="red", linewidth=0.5,
               label="gap")
        ax.plot([0, 1], [0, 1], "k--", alpha=0.6)
        title = f"Reliability diagram (ECE {r['ece']:.4f}"
        if "ece_precalibration" in r:
            title += (f", pre-calibration {r['ece_precalibration']:.4f}, "
                      f"T={r['temperature']:.3f}")
        ax.set_title(title + ")")
        ax.set_xlabel("Confidence")
        ax.set_ylabel("Accuracy")
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        ax.legend(loc="upper left")
        save(fig, "reliability_diagram")

        fig, ax = plt.subplots(figsize=(6, 4))
        jitter = np.random.RandomState(0).uniform(
            -0.08, 0.08, d["severity_true"].shape)
        ax.scatter(d["severity_true"] + jitter, d["severity_pred"], s=10,
                   alpha=0.5)
        lim = max(3.0, float(d["severity_pred"].max(initial=0.0)))
        ax.plot([0, lim], [0, lim], "k--", alpha=0.5)
        ax.set_xlabel("True severity")
        ax.set_ylabel("KAN predicted severity")
        ax.set_title("Severity prediction")
        save(fig, "severity_scatter")


def load_model_for_evaluation(checkpoint_path,
                              config: Optional[Config] = None,
                              image_size: Optional[int] = None,
                              use_ema: bool = True, device="cuda",
                              **model_kwargs
                              ) -> Tuple[RoViTKAN, Dict[str, torch.Tensor]]:
    """Rebuild the model from a checkpoint in eval mode on ``device`` and
    return ``(model, state_dict)``.

    The architecture comes from the config stored in the checkpoint's
    sidecar when there is one, else from ``config``. With an EMA in the
    checkpoint, its weights are loaded (the trainer validated and picked the
    best epoch with them) unless ``use_ema=False``. ``image_size`` serves at
    another resolution than the checkpoint was trained at: the position
    embedding is resampled by ``transfer_resolution``."""
    ck = load_checkpoint(checkpoint_path)
    if ck.get("config"):
        config = Config.from_dict(ck["config"])
    elif config is None:
        raise ValueError("checkpoint has no embedded config; pass one")
    state = (ck["ema_params"] if use_ema and ck.get("ema_params") is not None
             else ck["params"])
    if image_size is not None and image_size != config.data.image_size:
        config = copy.deepcopy(config)     # never mutate a caller's config
        config.data.image_size = image_size
        state = transfer_resolution(state, image_size,
                                    config.model.patch_size)
    model = build_model(config, **{"inference": True, "device": device,
                                   **model_kwargs})
    model.load_state_dict(state)
    return model, state
