"""Ablation study: six canonical variants, skip-resume, comparison tables.

Counterpart of ``rovit_kan_tpu/experiments/ablation.py``:

- ``AblationConfig``, the per-variant toggles, and the six
  ``CANONICAL_VARIANTS``: full, without the ordinal, uncertainty or KAN
  head, without the curriculum, and classification only;
- each variant trains in its own directory from a deep copy of the config,
  with the ``model.with_*`` toggles stored in its checkpoints so that
  evaluation and serving rebuild its architecture;
- resume by skip: a variant whose committed ``best_model`` and cached
  ``test_metrics.json`` exist is not trained again, unless a pending
  ``preempt_model`` says its training is unfinished; then the fit resumes
  from that checkpoint, and a preempted fit exits without caching;
- evaluation of the weights model selection used (the EMA when on, or the
  on-disk best after a resume that did not improve), a temperature fitted
  on the validation loader beside the raw metrics, the training curves;
- the CSV summary, the comparison table and the component importance
  (accuracy deltas against the full model).

Variants without a head are other modules (the ``with_*`` flags of
``RoViTKAN``); the curriculum toggle is a config flag the same train step
reads. Runs on the card unless ``device="cpu"``.

``mesh=`` (a data mesh, one process per card, or a 2-D mesh) goes through
to every variant's ``Trainer``: every rank runs the same study over the
same loaders, and rank 0 alone writes the files (the epoch CSV, the
metrics, the curves, the summary), behind the checkpoints' barriers. Where
the trainer holds a rank's stage or shards (a pipeline, expert or model
axis), the selected weights are evaluated on the model whole
(``full_module``), as the JAX harness merges the pipelined tree
(``merge_params``).
"""
from __future__ import annotations

import contextlib
import copy
import csv
import json
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.evaluation.evaluator import (
    Evaluator,
    load_model_for_evaluation,
)
from rovit_kan_tpu_torch.models.rovit_kan import build_model
from rovit_kan_tpu_torch.parallel.multihost import barrier, process_index
from rovit_kan_tpu_torch.results.logger import ExperimentLogger
from rovit_kan_tpu_torch.training.trainer import Trainer
from rovit_kan_tpu_torch.utils.checkpoint import promote_staging


@dataclass
class AblationConfig:
    """Per-variant toggles."""
    name: str
    use_ordinal: bool = True
    use_uncertainty: bool = True
    use_kan: bool = True
    use_curriculum: bool = True
    description: str = ""


CANONICAL_VARIANTS: List[AblationConfig] = [
    AblationConfig("full_model", description="Full RoViT-KAN"),
    AblationConfig("no_ordinal", use_ordinal=False,
                   description="Without ordinal head"),
    AblationConfig("no_uncertainty", use_uncertainty=False,
                   description="Without uncertainty head"),
    AblationConfig("no_kan", use_kan=False,
                   description="Without KAN module"),
    AblationConfig("no_curriculum", use_curriculum=False,
                   description="Without curriculum learning"),
    AblationConfig("classification_only", use_ordinal=False,
                   use_uncertainty=False, use_kan=False,
                   description="Classification head only"),
]

CSV_FIELDS = ["experiment", "accuracy", "macro_f1", "weighted_f1", "mae",
              "spearman_rho", "brier_score", "ece", "ece_calibrated",
              "temperature", "temperature_degenerate", "fps", "params"]


class AblationExperiment:
    """Runs the variant suite over shared loaders."""

    def __init__(self, config: Config, train_loader, val_loader, test_loader,
                 output_dir, focal_alpha: Optional[np.ndarray] = None,
                 variants: Optional[List[AblationConfig]] = None,
                 device="cuda", seed: int = 42, run_fps: bool = True,
                 mesh=None):
        self.base_config = config
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.test_loader = test_loader
        self.output_dir = Path(output_dir)
        self.focal_alpha = focal_alpha
        self.variants = variants or CANONICAL_VARIANTS
        self.device = device if mesh is None else mesh.device
        self.mesh = mesh
        self.seed = seed
        self.run_fps = run_fps
        self.results: Dict[str, Dict] = {}

    def _exp_config(self, variant: AblationConfig) -> Config:
        """A deep copy of the config with the variant's paths, curriculum
        flag and head toggles."""
        cfg = copy.deepcopy(self.base_config)
        exp_dir = self.output_dir / variant.name
        cfg.paths.checkpoints_dir = exp_dir
        cfg.paths.results_dir = exp_dir
        cfg.paths.logs_dir = exp_dir
        cfg.flags.curriculum = variant.use_curriculum
        # Stored in the checkpoint, so evaluation and serving rebuild the
        # variant's architecture.
        cfg.model.with_ordinal = variant.use_ordinal
        cfg.model.with_uncertainty = variant.use_uncertainty
        cfg.model.with_kan = variant.use_kan
        return cfg

    def run_single_experiment(self, variant: AblationConfig,
                              epochs: Optional[int] = None) -> Dict:
        cfg = self._exp_config(variant)
        exp_dir = self.output_dir / variant.name
        exp_dir.mkdir(parents=True, exist_ok=True)

        # Resume by skip. The checkpoint must be committed (promote_staging
        # adopts a committed write that was not yet swapped in). A pending
        # preempt_model vetoes the skip: the variant's training is
        # unfinished, and the cached metrics may belong to an older run.
        cached = exp_dir / "test_metrics.json"
        ckpt = exp_dir / "best_model"
        preempt_pending = promote_staging(exp_dir / "preempt_model")
        if cached.exists() and not preempt_pending and promote_staging(ckpt):
            print(f"[{variant.name}] cached results found — skipping retrain")
            metrics = json.loads(cached.read_text())
            self.results[variant.name] = metrics
            return metrics

        print(f"=== Ablation: {variant.name} ({variant.description}) ===")
        model = build_model(cfg, with_ordinal=variant.use_ordinal,
                            with_uncertainty=variant.use_uncertainty,
                            with_kan=variant.use_kan, device=self.device,
                            seed=self.seed)
        main = process_index() == 0
        logger = ExperimentLogger(exp_dir, variant.name) if main else None
        trainer = Trainer(model, self.train_loader, self.val_loader, cfg,
                          logger=logger, focal_alpha=self.focal_alpha,
                          seed=self.seed, mesh=self.mesh)
        preempt = exp_dir / "preempt_model"
        resumed = preempt_pending            # never restore a torn write
        if resumed:
            print(f"[{variant.name}] preemption checkpoint found — "
                  f"resuming")
            state, start_epoch = trainer.resume("preempt_model")
            # Rows the preempted process logged past its checkpoint.
            if main:
                logger.truncate_from(start_epoch)
            fit = trainer.fit(state, epochs=epochs,
                              start_epoch=start_epoch)
        else:
            # A fresh run replaces an earlier run's epoch CSV rather than
            # appending a second lineage to it.
            if main:
                logger.reset()
            fit = trainer.fit(epochs=epochs)
        if fit.get("preempted"):
            # A half-trained variant is never cached; its preemption
            # checkpoint stays, and the next run resumes it.
            raise SystemExit(
                f"[{variant.name}] preempted mid-training — results NOT "
                f"cached; re-run to continue")

        whole = contextlib.nullcontext()
        if resumed and not fit["improved"] and promote_staging(ckpt):
            # No epoch after the resume beat the restored best loss: the
            # best weights are the ones on disk.
            _, eval_weights = load_model_for_evaluation(
                ckpt, cfg, device=self.device)
        else:
            eval_weights = trainer.eval_params(fit["best_state"])
            if trainer.sharded is not None:
                # A rank's stage or shards (a pipeline or expert mesh):
                # evaluated on the model whole, as the JAX harness merges
                # the pipelined tree.
                whole = trainer.sharded.full_module(eval_weights)
                eval_weights = None
        with whole:
            evaluator = Evaluator(model, eval_weights, self.test_loader,
                                  cfg, output_dir=exp_dir)
            metrics = evaluator.evaluate(
                run_fps=self.run_fps, **({} if main else {"save": False}))
            # The raw `ece` stays comparable with the reference's CSVs;
            # `ece_calibrated` is what one validation-fitted scalar buys.
            metrics.update(evaluator.calibrated_metrics(self.val_loader))
        metrics["experiment"] = variant.name
        metrics["best_val_loss"] = fit["best_val_loss"]
        if main:
            logger.save_metrics(metrics, "test_metrics.json")
            if preempt.exists():
                # The variant is complete: a stale preemption checkpoint
                # would make the next run resume a finished training.
                shutil.rmtree(preempt)
            logger.plot_training_curves()
        self.results[variant.name] = metrics
        return metrics

    def run_all_experiments(self, epochs: Optional[int] = None) -> Dict:
        for variant in self.variants:
            self.run_single_experiment(variant, epochs=epochs)
        return self.results

    def save_summary_csv(self) -> Path:
        """``ablation_results.csv``: one row per variant."""
        path = self.output_dir / "ablation_results.csv"
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=CSV_FIELDS, extrasaction="ignore")
            w.writeheader()
            for name, m in self.results.items():
                w.writerow({"experiment": name,
                            **{k: m.get(k, "") for k in CSV_FIELDS[1:]}})
        return path

    def print_comparison(self) -> None:
        """The variants side by side."""
        cols = ["experiment", "accuracy", "macro_f1", "mae", "brier_score",
                "ece", "ece_calibrated", "params"]
        print(f"{'experiment':22s} " + " ".join(f"{c:>12s}" for c in cols[1:]))
        for name, m in self.results.items():
            vals = []
            for c in cols[1:]:
                v = m.get(c, "")
                vals.append(f"{v:12.4f}" if isinstance(v, float)
                            else f"{v!s:>12s}")
            print(f"{name:22s} " + " ".join(vals))

    def get_component_importance(self) -> Dict[str, float]:
        """Accuracy delta of each single-component removal against the full
        model."""
        if "full_model" not in self.results:
            return {}
        full_acc = self.results["full_model"]["accuracy"]
        deltas = {}
        component_of = {"no_ordinal": "ordinal_head",
                        "no_uncertainty": "uncertainty_head",
                        "no_kan": "kan_module",
                        "no_curriculum": "curriculum"}
        for variant, comp in component_of.items():
            if variant in self.results:
                deltas[comp] = full_acc - self.results[variant]["accuracy"]
        return deltas


def run_ablation_study(config: Config, train_loader, val_loader, test_loader,
                       output_dir, focal_alpha=None, epochs=None,
                       variants=None, device="cuda", seed: int = 42,
                       run_fps: bool = True, mesh=None
                       ) -> AblationExperiment:
    """Every variant, then the CSV, the comparison table and
    ``component_importance.json`` (rank 0 writes them)."""
    exp = AblationExperiment(config, train_loader, val_loader, test_loader,
                             output_dir, focal_alpha=focal_alpha,
                             variants=variants, device=device, seed=seed,
                             run_fps=run_fps, mesh=mesh)
    exp.run_all_experiments(epochs=epochs)
    main = process_index() == 0
    if main:
        exp.save_summary_csv()
    exp.print_comparison()
    importance = exp.get_component_importance()
    if importance:
        print("Component importance (accuracy delta vs full):")
        for comp, d in sorted(importance.items(), key=lambda kv: -kv[1]):
            print(f"  {comp:20s} {d:+.4f}")
    if main:
        (Path(output_dir) / "component_importance.json").write_text(
            json.dumps(importance, indent=2))
    barrier()
    return exp
