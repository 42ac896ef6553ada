"""Experiment harnesses of the port: the six-variant ablation study and the
baseline comparison."""
from rovit_kan_tpu_torch.experiments.ablation import (  # noqa: F401
    CANONICAL_VARIANTS,
    AblationConfig,
    AblationExperiment,
    run_ablation_study,
)
from rovit_kan_tpu_torch.experiments.baselines import (  # noqa: F401
    BaselineExperiment,
    run_baseline_experiments,
)
