"""Experiment harnesses of the port: the six-variant ablation study."""
from rovit_kan_tpu_torch.experiments.ablation import (  # noqa: F401
    CANONICAL_VARIANTS,
    AblationConfig,
    AblationExperiment,
    run_ablation_study,
)
