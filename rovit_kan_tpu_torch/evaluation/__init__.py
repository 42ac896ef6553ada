"""Evaluation of the port: for now the checkpoint loader."""
from rovit_kan_tpu_torch.evaluation.evaluator import (  # noqa: F401
    load_model_for_evaluation,
)
