"""Command-line entry points of the port: ``python -m
rovit_kan_tpu_torch.cli.<name>`` for ``train``, ``evaluate``,
``export_model``, ``serve``, ``bench``, ``profile_train``, ``visualize``,
``run_ablation``, ``run_baselines`` (``--cpu`` off the card) and
``convert_checkpoint`` (CPU only)."""
from __future__ import annotations

#: ``--matmul_precision``'s values (the JAX scripts' XLA precisions) and the
#: ``torch.set_float32_matmul_precision`` setting each maps to.
MATMUL_PRECISION = {"bfloat16": "medium", "tensorfloat32": "high",
                    "float32": "highest"}
MATMUL_PRECISION_HELP = (
    "fp32 matmul precision of the plain PyTorch path (bfloat16, "
    "tensorfloat32 or float32: torch.set_float32_matmul_precision medium, "
    "high or highest); the hand-written kernels keep their own arithmetic")


def set_matmul_precision(name) -> None:
    """Apply ``--matmul_precision`` (None leaves torch's setting)."""
    if name is not None:
        import torch
        torch.set_float32_matmul_precision(MATMUL_PRECISION[name])
