"""The port's InferenceEngine and MicroBatcher.

The engine is held against the JAX package's ``build_serving_forward`` on
the same weights (fp32, 2e-5), with a partial batch and a calibration
temperature; the MicroBatcher's coalescing, FIFO carry and cancellation are
checked with a gated stand-in engine.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
from rovit_kan_tpu.serving import build_serving_forward as jax_forward
from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.models.convert import load_jax_params
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN, build_model
from rovit_kan_tpu_torch.serving import (
    InferenceEngine,
    MicroBatcher,
    build_serving_forward,
)

KW = dict(embed_dim=32, depth=1, num_heads=2, image_size=32, patch_size=16,
          kan_layers=(32, 8, 1), hidden_dim=16)
TEMPERATURE = 1.7


def _imgs(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 32, 32, 3)) \
        .astype(np.uint8)


@pytest.fixture(scope="module")
def pair():
    jm = JaxRoViTKAN(**KW)
    params = jm.init(jax.random.PRNGKey(3),
                     np.zeros((1, 32, 32, 3), np.float32))["params"]
    rng = np.random.RandomState(3)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), params)
    model = load_jax_params(RoViTKAN(**KW), params, device="cpu")
    engine = InferenceEngine(model, batch_size=8, temperature=TEMPERATURE,
                             device="cpu")
    engine.warmup()
    return jm, params, engine


def test_engine_matches_jax_serving(pair):
    jm, params, engine = pair
    imgs = _imgs(5)                           # partial batch, padded to 8
    want = jax_forward(jm, temperature=TEMPERATURE)(params,
                                                    jnp.asarray(imgs))
    got = engine.predict(imgs)
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        np.testing.assert_allclose(got[k], v, atol=2e-5, rtol=0, err_msg=k)


def test_oversize_request_splits_and_stats(pair):
    _, _, engine = pair
    imgs = _imgs(19, seed=1)
    out = engine.predict(imgs)
    assert out["cls_pred"].shape == (19,)
    assert out["ordinal_probs"].shape == (19, 4)
    first = engine.predict(imgs[:8])
    np.testing.assert_allclose(out["kan_severity"][:8], first["kan_severity"],
                               atol=1e-6)
    s = engine.stats()
    assert s["requests"] >= 4 and s["images_per_sec"] > 0
    assert s["temperature"] == TEMPERATURE


def test_temperature_validated():
    model = RoViTKAN(**KW)
    for bad in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="temperature"):
            build_serving_forward(model, bad)


def test_microbatcher_matches_engine(pair):
    _, _, engine = pair
    imgs = _imgs(6, seed=2)
    direct = engine.predict(imgs)
    batcher = MicroBatcher(engine)
    try:
        futs = [batcher.submit(imgs[i:i + 1]) for i in range(6)]
        got = [f.result(timeout=60) for f in futs]
    finally:
        batcher.close()
    for i, g in enumerate(got):
        for k, v in direct.items():
            np.testing.assert_allclose(g[k][0], v[i], atol=1e-6, err_msg=k)
    with pytest.raises(ValueError):
        MicroBatcher(engine).submit(np.zeros((1, 16, 16, 3), np.uint8))


class _GatedEngine:
    """Predict-only stand-in whose first call waits for ``gate``; each image
    carries its id in pixel (0, 0, 0)."""
    batch_size = 4

    def __init__(self):
        self.batches = []
        self.gate = threading.Event()

    def predict(self, imgs):
        self.batches.append(imgs[:, 0, 0, 0].tolist())
        if len(self.batches) == 1:
            assert self.gate.wait(30)
        return {"id": imgs[:, 0, 0, 0].astype(np.int32)}


def _req(*ids):
    out = np.zeros((len(ids), 2, 2, 3), np.uint8)
    out[:, 0, 0, 0] = ids
    return out


def _wait_for(cond):
    deadline = time.monotonic() + 30
    while not cond():
        assert time.monotonic() < deadline
        time.sleep(0.005)


def test_microbatcher_coalesces_in_fifo_order():
    engine = _GatedEngine()
    batcher = MicroBatcher(engine)
    try:
        a = batcher.submit(_req(0))
        _wait_for(lambda: len(engine.batches) == 1)     # worker is busy
        b = batcher.submit(_req(1, 2, 3))
        c = batcher.submit(_req(4, 5))                  # does not fit b
        d = batcher.submit(_req(6))
        engine.gate.set()
        results = [f.result(timeout=30)["id"].tolist() for f in (a, b, c, d)]
    finally:
        batcher.close()
    assert results == [[0], [1, 2, 3], [4, 5], [6]]
    # c is carried and LEADS the next batch, ahead of d.
    assert engine.batches == [[0], [1, 2, 3], [4, 5, 6]]
    assert batcher.batches_run == 3 and batcher.requests_coalesced == 4


def test_microbatcher_drops_cancelled_requests():
    engine = _GatedEngine()
    batcher = MicroBatcher(engine)
    try:
        a = batcher.submit(_req(0))
        _wait_for(lambda: len(engine.batches) == 1)
        b = batcher.submit(_req(1))
        assert b.cancel()
        c = batcher.submit(_req(2))
        engine.gate.set()
        assert c.result(timeout=30)["id"].tolist() == [2]
        assert a.result(timeout=30)["id"].tolist() == [0]
    finally:
        batcher.close()
    assert b.cancelled()
    assert engine.batches == [[0], [2]]
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(_req(3))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible, so the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(Config())
    model = RoViTKAN(**KW)
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(model)
    with pytest.raises(RuntimeError, match="cuda"):
        load_jax_params(model, {})
