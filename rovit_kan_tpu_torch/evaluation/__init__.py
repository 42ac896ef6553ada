"""Evaluation of the port: host metrics, calibration, the ``Evaluator``
and the checkpoint loader."""
from rovit_kan_tpu_torch.evaluation.metrics import (  # noqa: F401
    accuracy,
    macro_f1,
    weighted_f1,
    mae,
    spearman_rho,
    brier_score,
    ece,
    count_params,
    compute_confusion_matrix,
    per_class_metrics,
    fps_benchmark,
)
from rovit_kan_tpu_torch.evaluation.evaluator import (  # noqa: F401
    Evaluator,
    load_model_for_evaluation,
)
