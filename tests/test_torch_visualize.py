"""``cli.visualize`` on the CPU, against the JAX ``scripts/visualize.py``.

A checkpoint from a tiny ``cli.train --fast --synthetic --cpu`` run (64 px,
depth 2, width 32, fp32; its weights perturbed, see ``run``); ``cli.visualize --cpu`` over 5 of its test
images writes the JAX script's figure names (its f-strings and the JAX
``KANVisualizer``'s default names, read from their sources), and its
rollout and Grad-CAM++ maps agree within 1e-4 with the JAX classes run on
the same images and weights (``to_jax_params``). Without matplotlib it
warns once, naming the figures, writes none, and returns the same maps.
"""
import ast
import inspect
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.config import Config as JaxConfig
from rovit_kan_tpu.explainability import GradCAMPlusPlus as JaxGradCAM
from rovit_kan_tpu.explainability import ViTAttentionRollout as JaxRollout
from rovit_kan_tpu.explainability.kan_viz import KANVisualizer as JaxKANViz
from rovit_kan_tpu.models.rovit_kan import build_model as jax_build_model
from rovit_kan_tpu_torch.cli import train as cli_train
from rovit_kan_tpu_torch.cli import visualize as cli
from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.data.dataset import RoseLeafDataset
from rovit_kan_tpu_torch.evaluation.evaluator import load_model_for_evaluation
from rovit_kan_tpu_torch.models.convert import to_jax_params
from rovit_kan_tpu_torch.ops.preprocess import eval_batch
from rovit_kan_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_meta,
    save_checkpoint,
)

JAX_SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / \
    "visualize.py"
N = 5


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("viz")
    cli_train.main(["--data_root", str(tmp / "data"), "--output_dir",
                    str(tmp / "train"), "--synthetic", "--fast", "--cpu",
                    "--epochs", "1"])
    ck = tmp / "train" / "checkpoints" / "best_model"
    # One epoch with the backbone frozen leaves every LayerNorm at unit
    # scale and zero bias, so the tap's channels sum to zero and each
    # Grad-CAM++ map is rounding noise. Weights perturbed off the fit's
    # give maps the two packages can be held to.
    rng = np.random.RandomState(0)
    params = {k: v + torch.from_numpy(rng.normal(0, 0.05, tuple(v.shape))
                                      .astype(np.float32))
              for k, v in load_checkpoint(ck)["params"].items()}
    save_checkpoint(ck, params,
                    config=Config.from_dict(load_meta(ck)["config"]))
    argv = ["--checkpoint", str(ck), "--data_root", str(tmp / "data"),
            "--num_samples", str(N), "--image_size", "64", "--cpu"]
    maps = cli.main(argv + ["--output_dir", str(tmp / "out")])
    return tmp, ck, argv, maps


def jax_script_names(n: int, with_kan: bool) -> set:
    """The PNG names the JAX script writes for ``n`` samples."""
    names = set()
    for node in ast.walk(ast.parse(JAX_SCRIPT.read_text())):
        # The paths written: ``out / "name.png"`` and ``out / f"..."``.
        if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div)
                and ast.unparse(node.right).endswith(".png'")):
            continue
        names |= {eval(compile(ast.Expression(node.right), "f", "eval"),
                       {"j": j}) for j in range(n)}
    if with_kan:
        names |= {inspect.signature(getattr(JaxKANViz, m))
                  .parameters["name"].default
                  for m in ("plot_spline_activations",
                            "plot_severity_trajectory",
                            "plot_severity_distribution",
                            "plot_spline_weights_heatmap")}
    return names


def test_writes_the_jax_scripts_files(run):
    tmp, _, _, (attn, cams) = run
    want = jax_script_names(N, with_kan=True)
    assert "summary_grid.png" in want and "gradcam_04.png" in want
    assert {p.name for p in (tmp / "out").glob("*.png")} == want
    for maps in (attn, cams):
        assert maps.shape == (N, 64, 64)
        assert maps.min() >= 0.0 and maps.max() <= 1.0 + 1e-6


def test_maps_match_jax(run):
    tmp, ck, _, (attn, cams) = run
    model, _ = load_model_for_evaluation(ck, device="cpu")
    ds = RoseLeafDataset(tmp / "data" / "Original Image",
                         Config().data.class_names, Config().data.severity_map,
                         image_size=64)
    idxs = np.linspace(0, len(ds) - 1, N).astype(int)
    images = np.stack([ds[i][0] for i in idxs])
    labels = np.array([ds[i][1] for i in idxs])
    x = eval_batch(torch.from_numpy(images)).numpy()
    jm = jax_build_model(JaxConfig.from_dict(load_meta(ck)["config"]),
                         inference=True)
    params = to_jax_params(model)
    np.testing.assert_allclose(
        attn, JaxRollout(jm, params).generate(jnp.asarray(x)), atol=1e-4,
        rtol=0)
    np.testing.assert_allclose(
        cams, JaxGradCAM(jm, params).compute(jnp.asarray(x),
                                             class_idx=labels),
        atol=1e-4, rtol=0)


def test_without_matplotlib(run, tmp_path, monkeypatch):
    _, _, argv, (attn, cams) = run
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.warns(UserWarning) as rec:
        got = cli.main(argv + ["--output_dir", str(tmp_path)])
    assert len(rec) == 1
    for name in ("attention_NN.png", "gradcam_NN.png", "summary_grid.png",
                 "kan_trajectory.png"):
        assert name in str(rec[0].message)
    assert not list(tmp_path.glob("*.png"))
    np.testing.assert_array_equal(got[0], attn)
    np.testing.assert_array_equal(got[1], cams)
