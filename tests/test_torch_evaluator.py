"""The port's ``Evaluator`` against the JAX ``Evaluator``.

The JAX evaluator test's tiny model (d=32, depth 1, 32 px, KAN (32, 8, 1)),
fp32, its weights handed to the port by ``load_jax_params``; 12 synthetic
images read by each package's own ``Loader`` at batch 5, so the last batch
is padded. ``evaluate`` agrees exactly on the counts (n_test, confusion
matrix, support, accuracy, F1s) and within 2e-5 on every float, the
full-model fp32 tolerance (docs/VALIDATION.md:772-774);
``evaluate_on_device`` within 1e-5; the fitted temperature and the
calibrated metrics within 1e-4, the golden-section tolerance. The report,
the JSON, the figures and the run without matplotlib are checked on the
port alone.
"""
import json
import sys

import jax
import numpy as np
import pytest
import torch

from rovit_kan_tpu.config import get_config as jax_get_config
from rovit_kan_tpu.data.dataset import Loader as JaxLoader
from rovit_kan_tpu.data.dataset import RoseLeafDataset as JaxDataset
from rovit_kan_tpu.evaluation.evaluator import Evaluator as JaxEvaluator
from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
from rovit_kan_tpu_torch.config import get_config
from rovit_kan_tpu_torch.data.dataset import Loader, RoseLeafDataset
from rovit_kan_tpu_torch.data.synthetic import generate_synthetic_dataset
from rovit_kan_tpu_torch.evaluation.evaluator import (
    FIGURES,
    Evaluator,
    load_model_for_evaluation,
)
from rovit_kan_tpu_torch.models.convert import load_jax_params
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN
from rovit_kan_tpu_torch.utils.checkpoint import save_checkpoint

KW = dict(embed_dim=32, depth=1, num_heads=2, image_size=32, patch_size=16,
          kan_layers=(32, 8, 1), hidden_dim=16)
FLOAT_KEYS = ("mae", "spearman_rho", "spearman", "brier_score", "ece",
              "mean_uncertainty", "params_m", "temperature")
EXACT_KEYS = ("n_test", "accuracy", "macro_f1", "weighted_f1", "params",
              "severity_is_fallback", "confusion_matrix")
DEVICE_KEYS = ("accuracy", "macro_f1", "mae", "spearman_rho", "brier_score",
               "ece")


def _cfgs(tmp):
    jcfg, cfg = jax_get_config(), get_config()
    for c in (jcfg, cfg):
        c.data.image_size = 32
        c.paths.results_dir = tmp / "results"
    return jcfg, cfg


def _pair(with_kan: bool, seed: int):
    jm = JaxRoViTKAN(use_pallas_attention=False, use_pallas_kan=False,
                     with_kan=with_kan, **KW)
    params = jm.init(jax.random.PRNGKey(seed),
                     np.zeros((1, 32, 32, 3), np.float32))["params"]
    # Spread the outputs away from the uniform ones of a fresh init: at seed
    # 2 the model predicts three classes, the fitted T lies inside the
    # search bracket, and no argmax, rank or bin sits at a tie (asserted
    # below).
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.1, a.shape).astype(np.float32), params)
    model = load_jax_params(RoViTKAN(with_kan=with_kan, **KW), params,
                            device="cpu")
    return jm, params, model


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    jcfg, cfg = _cfgs(tmp)
    root = generate_synthetic_dataset(tmp / "orig", n_per_class=3, size=32)
    jloader = JaxLoader(JaxDataset(root, jcfg.data.class_names,
                                   jcfg.data.severity_map, image_size=32),
                        batch_size=5)
    loader = Loader(RoseLeafDataset(root, cfg.data.class_names,
                                    cfg.data.severity_map, image_size=32),
                    batch_size=5)           # 12 images -> a padded batch
    jm, params, model = _pair(True, 2)
    jev = JaxEvaluator(jm, params, jloader, jcfg, output_dir=tmp / "jax")
    ev = Evaluator(model, model.state_dict(), loader, cfg,
                   output_dir=tmp / "port")
    return dict(tmp=tmp, root=root, jcfg=jcfg, cfg=cfg, jloader=jloader,
                loader=loader, jev=jev, ev=ev,
                want=jev.evaluate(run_fps=False, save=False),
                got=ev.evaluate(run_fps=False))


def _gaps(x):
    x = np.sort(np.asarray(x, np.float64).ravel())
    return np.diff(x)


def test_inputs_sit_clear_of_ties(setup):
    """The exact comparisons below need every argmax, rank and bin to be
    decided by more than the forward's fp32 noise."""
    d = setup["ev"]._arrays
    top2 = np.sort(d["probs"], axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-4
    assert _gaps(d["severity_pred"]).min() > 1e-4
    conf = d["probs"].max(axis=1)
    edges = np.linspace(0.0, 1.0, 11)
    assert np.abs(conf[:, None] - edges[None, :]).min() > 1e-4


def test_evaluate_matches_jax(setup):
    got, want = setup["got"], setup["want"]
    assert set(got) == set(want)
    for k in EXACT_KEYS:
        assert got[k] == want[k], k
    assert got["per_class"].keys() == want["per_class"].keys()
    for name, m in want["per_class"].items():
        assert got["per_class"][name] == m, name
    for k in FLOAT_KEYS:
        assert got[k] == pytest.approx(want[k], abs=2e-5), k
    assert got["n_test"] == 12 and not got["severity_is_fallback"]


def test_evaluate_on_device_matches_jax(setup):
    got = setup["ev"].evaluate_on_device()
    want = setup["jev"].evaluate_on_device()
    assert set(got) == set(want)
    for k in DEVICE_KEYS:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k
    np.testing.assert_array_equal(got["confusion_matrix"],
                                  want["confusion_matrix"])
    assert got["confusion_matrix"].dtype == np.float32
    assert got["severity_is_fallback"] is want["severity_is_fallback"]
    # And the port's two paths agree with each other.
    host = setup["got"]
    for k in DEVICE_KEYS:
        assert got[k] == pytest.approx(host[k], abs=1e-5), k


def test_severity_fallback_on_both_paths(setup):
    jm, params, model = _pair(False, 3)
    jev = JaxEvaluator(jm, params, setup["jloader"], setup["jcfg"])
    ev = Evaluator(model, model.state_dict(), setup["loader"], setup["cfg"])
    got, want = (e.evaluate(run_fps=False, save=False) for e in (ev, jev))
    assert got["severity_is_fallback"] and want["severity_is_fallback"]
    for k in ("mae", "spearman_rho"):
        assert got[k] == pytest.approx(want[k], abs=2e-5), k
    assert got["mae"] == 0.0 and got["spearman_rho"] == pytest.approx(1.0)
    for fallback in (None, False):
        g = ev.evaluate_on_device(severity_fallback=fallback)
        w = jev.evaluate_on_device(severity_fallback=fallback)
        assert g["severity_is_fallback"] is w["severity_is_fallback"]
        for k in DEVICE_KEYS:
            assert g[k] == pytest.approx(w[k], abs=1e-5), (fallback, k)
    assert g["mae"] > 0.0


def test_fit_temperature_and_calibrated_metrics(setup):
    """T fitted on a validation loader (the same 12 images here) and the
    calibrated re-scoring, against the JAX evaluator; then an evaluate with
    T armed reports the pre-calibration ECE and Brier beside it."""
    ev, jev = setup["ev"], setup["jev"]
    got = ev.calibrated_metrics(setup["loader"])
    want = jev.calibrated_metrics(setup["jloader"])
    assert set(got) == set(want)
    for k in ("temperature", "ece_calibrated", "brier_calibrated"):
        assert got[k] == pytest.approx(want[k], abs=1e-4), k
    assert got["temperature_degenerate"] is want["temperature_degenerate"] \
        is False
    assert ev.temperature == got["temperature"] != 1.0
    r = ev.evaluate(run_fps=False, save=False)
    w = jev.evaluate(run_fps=False, save=False)
    assert set(r) == set(w)
    for k in ("ece", "brier_score", "ece_precalibration",
              "brier_precalibration"):
        assert r[k] == pytest.approx(w[k], abs=1e-4), k
    assert r["ece_precalibration"] == pytest.approx(setup["got"]["ece"],
                                                    abs=1e-6)
    for e in (ev, jev):
        e.temperature = 1.0


def test_report_json_and_figures(setup):
    out = setup["tmp"] / "port"
    assert (out / "evaluation_results.txt").exists()
    saved = json.loads((out / "test_metrics.json").read_text())
    assert set(saved) == set(setup["got"])
    for name in FIGURES:
        for ext in ("png", "pdf"):
            assert (out / f"{name}.{ext}").stat().st_size > 0, (name, ext)


def test_without_matplotlib(setup, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    ev = Evaluator(setup["ev"].model, None, setup["loader"], setup["cfg"],
                   output_dir=tmp_path)
    with pytest.warns(UserWarning) as rec:
        r = ev.evaluate(run_fps=False)
    assert len(rec) == 1 and all(n in str(rec[0].message) for n in FIGURES)
    assert (tmp_path / "evaluation_results.txt").exists()
    assert json.loads((tmp_path / "test_metrics.json").read_text()) \
        == json.loads(json.dumps(r))
    assert not list(tmp_path.glob("*.png")) + list(tmp_path.glob("*.pdf"))
    for k in EXACT_KEYS + FLOAT_KEYS:
        assert r[k] == setup["got"][k], k


def test_fps_failure_is_recorded(setup, monkeypatch):
    ev = setup["ev"]

    def broken():
        raise RuntimeError("no card")

    monkeypatch.setattr(ev, "_fps", broken)
    with pytest.warns(UserWarning, match="fps benchmark failed"):
        r = ev.evaluate(run_fps=True, save=False)
    assert r["fps"] is None and r["fps_error"] == "RuntimeError: no card"


def test_load_at_another_resolution_feeds_evaluator(setup, tmp_path):
    cfg = get_config()
    m = cfg.model
    m.embed_dim, m.depth, m.num_heads = 32, 1, 2
    m.kan_layers, m.hidden_dim = [32, 8, 1], 16
    cfg.data.image_size = 32
    cfg.flags.mixed_precision = False
    model = setup["ev"].model
    save_checkpoint(tmp_path / "ck", model.state_dict(), config=cfg)
    m64, state = load_model_for_evaluation(tmp_path / "ck", image_size=64,
                                           device="cpu")
    assert m64.image_size == 64
    assert state["backbone.model.pos_embed"].shape == (1, 17, 32)
    loader = Loader(RoseLeafDataset(setup["root"], cfg.data.class_names,
                                    cfg.data.severity_map, image_size=64),
                    batch_size=5)
    cfg.data.image_size = 64
    r = Evaluator(m64, state, loader, cfg).evaluate(run_fps=True, save=False)
    assert r["n_test"] == 12 and np.isfinite(r["ece"])
    assert r["fps"] > 0 and "fps_error" not in r
    assert not m64.training
    torch.testing.assert_close(m64.state_dict()["backbone.model.pos_embed"],
                               state["backbone.model.pos_embed"])
