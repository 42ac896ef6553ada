"""The port and its smoke script import neither JAX nor the JAX package."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "rovit_kan_tpu")
FILES = sorted((ROOT / "rovit_kan_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_has_modules():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for want in ("rovit_kan_tpu_torch/models/rovit_kan.py",
                 "rovit_kan_tpu_torch/ops/block_kernel.py",
                 "rovit_kan_tpu_torch/serving.py",
                 "rovit_kan_tpu_torch/ops/augment_kernel.py",
                 "rovit_kan_tpu_torch/ops/mixing.py",
                 "rovit_kan_tpu_torch/training/losses.py",
                 "rovit_kan_tpu_torch/training/optimizer.py",
                 "rovit_kan_tpu_torch/training/trainer.py",
                 "rovit_kan_tpu_torch/ops/kan_kernel.py",
                 "rovit_kan_tpu_torch/ops/attention.py",
                 "rovit_kan_tpu_torch/explainability/kan_viz.py",
                 "rovit_kan_tpu_torch/data/dataset.py",
                 "rovit_kan_tpu_torch/data/device_cache.py",
                 "rovit_kan_tpu_torch/utils/checkpoint.py",
                 "rovit_kan_tpu_torch/results/logger.py",
                 "rovit_kan_tpu_torch/evaluation/evaluator.py",
                 "rovit_kan_tpu_torch/evaluation/metrics.py",
                 "rovit_kan_tpu_torch/evaluation/calibration.py",
                 "rovit_kan_tpu_torch/ops/device_metrics.py",
                 "rovit_kan_tpu_torch/cli/train.py",
                 "rovit_kan_tpu_torch/cli/evaluate.py",
                 "chip_smoke.py"):
        assert want in names


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"
