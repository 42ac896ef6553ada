"""Experiment logging of the port."""
from rovit_kan_tpu_torch.results.logger import ExperimentLogger  # noqa: F401
