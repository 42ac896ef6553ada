"""The stage labels of ``chip_smoke.py`` name kernels that exist.

``chip_smoke.py`` reads each stage's device time from a torch.profiler
table by a label (``BLOCK_STAGES``, ``BWD_STAGES``): a substring of the
kernel's demangled name. A kernel renamed in ``rovit_kan_tpu_torch/csrc``
would leave its label matching nothing, and the stage's column would only
fail on the card. This test holds every label's kernel name (the identifier
before ``<``, after any ``namespace)::`` prefix) against the ``__global__``
kernels of the sources, on the CPU.
"""
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

CSRC = ROOT / "rovit_kan_tpu_torch" / "csrc"
_KERNEL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def _kernels():
    names = set()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        names.update(_KERNEL.findall(path.read_text()))
    return names


def _labels():
    for table in ("BLOCK_STAGES", "BWD_STAGES"):
        for dtype, stages in getattr(chip_smoke, table).items():
            for stage, label in stages.items():
                yield pytest.param(
                    label, id=f"{table}-{str(dtype).replace('torch.', '')}-"
                              f"{stage}")


def test_the_sources_have_kernels():
    assert {"mlp_bwd_fma_kernel", "attn_bwd_q_fma_kernel",
            "mlp_bwd_mma_kernel", "reduce_kernel"} <= _kernels()


@pytest.mark.parametrize("label", list(_labels()))
def test_stage_label_names_a_kernel(label):
    name = label.split("namespace)::")[-1].split("<")[0]
    assert re.fullmatch(r"\w+", name), label
    assert name in _kernels(), f"{label!r}: no __global__ {name} in {CSRC}"
