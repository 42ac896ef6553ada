"""The port's host metrics against ``rovit_kan_tpu.evaluation.metrics``.

The numpy metrics are a copy, so each must give the JAX module's result
exactly on seeded arrays, ties and a class absent from the labels included.
``count_params`` counts the port's modules and state dicts and must give
the JAX count (the flagship's from ``jax.eval_shape``, which runs no init
compute); ``fps_benchmark`` makes its 10 + 100 forwards and returns a
finite, positive rate.
"""
import math

import jax
import numpy as np
import pytest
import torch

from rovit_kan_tpu.config import get_config as jax_get_config
from rovit_kan_tpu.evaluation import metrics as JM
from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
from rovit_kan_tpu.models.rovit_kan import build_model as jax_build_model
from rovit_kan_tpu_torch.config import get_config
from rovit_kan_tpu_torch.evaluation import metrics as M
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN, build_model

NAMES = ["Healthy Leaf", "Leaf Holes", "Black Spot", "Dry Leaf"]


def _cases():
    """(labels, preds, probs, severity true, severity pred) per case."""
    rng = np.random.RandomState(0)
    out = []
    for n, k_seen in ((50, 4), (37, 3), (1, 1), (0, 0)):
        labels = rng.randint(0, max(k_seen, 1), n)        # class 3 absent
        logits = rng.randn(n, 4)
        logits[np.arange(n), labels] += 1.0
        probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
                 ).astype(np.float32)
        preds = probs.argmax(1)
        sev_t = labels.astype(np.float32)
        sev_p = np.round(sev_t + rng.randn(n) * 0.8, 1).astype(np.float32)
        out.append((labels, preds, probs, sev_t, sev_p))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_host_metrics_equal_jax(case):
    labels, preds, probs, sev_t, sev_p = CASES[case]
    for fn in ("accuracy", "mae", "spearman_rho"):
        a, b = (labels, preds) if fn == "accuracy" else (sev_t, sev_p)
        assert getattr(M, fn)(a, b) == getattr(JM, fn)(a, b), fn
    for fn in ("macro_f1", "weighted_f1"):
        for k in (None, 4):
            if labels.size or k:
                assert getattr(M, fn)(labels, preds, k) \
                    == getattr(JM, fn)(labels, preds, k), (fn, k)
    np.testing.assert_array_equal(M.compute_confusion_matrix(labels, preds, 4),
                                  JM.compute_confusion_matrix(labels, preds, 4))
    assert M.per_class_metrics(labels, preds, NAMES) \
        == JM.per_class_metrics(labels, preds, NAMES)
    np.testing.assert_array_equal(M._rank(sev_p), JM._rank(sev_p))
    if labels.size:
        for fn in ("brier_score", "ece"):
            assert getattr(M, fn)(probs, labels) \
                == getattr(JM, fn)(probs, labels), fn
        assert M.ece(probs, labels, n_bins=15) \
            == JM.ece(probs, labels, n_bins=15)


def test_rank_ties_and_spearman_against_scipy():
    from scipy.stats import rankdata, spearmanr
    a = np.array([3, 1, 1, 2, 3, 3, 0, 2], np.float64)
    b = np.array([0.5, 0.1, 0.2, 0.2, 0.9, 0.9, 0.0, 0.3])
    np.testing.assert_array_equal(M._rank(a), rankdata(a))
    assert M.spearman_rho(a, b) == pytest.approx(spearmanr(a, b).statistic,
                                                 abs=1e-12)


def test_count_params_tiny_model():
    kw = dict(embed_dim=32, depth=1, num_heads=2, image_size=32,
              patch_size=16, kan_layers=(32, 8, 1), hidden_dim=16)
    params = JaxRoViTKAN(**kw).init(
        jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))["params"]
    model = RoViTKAN(**kw)
    assert M.count_params(model) == M.count_params(model.state_dict()) \
        == JM.count_params(params)


def test_count_params_flagship():
    shapes = jax.eval_shape(jax_build_model(jax_get_config()).init,
                            jax.random.PRNGKey(0),
                            np.zeros((1, 224, 224, 3), np.float32))["params"]
    model = build_model(get_config(), device="cpu")
    assert M.count_params(model) == M.count_params(model.state_dict()) \
        == JM.count_params(shapes) == 5_706_394


def test_fps_benchmark_counts_forwards():
    calls = []

    def forward(x):
        calls.append(torch.is_inference_mode_enabled())
        return {"out": x.float().sum(dim=(1, 2, 3))}

    fps = M.fps_benchmark(forward, np.zeros((1, 8, 8, 3), np.uint8))
    assert len(calls) == 110 and all(calls)
    assert math.isfinite(fps) and fps > 0
    calls.clear()
    fps2 = M.fps_benchmark(forward, torch.zeros(2, 8, 8, 3), warmup=0,
                           iters=10, n_chunks=5)
    assert len(calls) == 10 and math.isfinite(fps2) and fps2 > 0
