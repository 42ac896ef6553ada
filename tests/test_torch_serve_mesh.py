"""Serving over a mesh: ``InferenceEngine(mesh=)`` and ``load_engine(mesh=)``
against the one-process engine and the JAX ``InferenceEngine(mesh=
make_mesh(2))``.

- without ranks: a ``batch_size`` the data axis does not divide is
  refused; a one-rank mesh serves the plain engine's bits; a leader does
  not follow;
- one two-rank gloo launch (``python tests/test_torch_serve_mesh.py
  TASK``, ``test_torch_expert.py``'s ``start_ranks``), on the JAX serving
  test's toy (d = 32, one block, 2 heads, 32 px, batch 8), rank 1 built
  from other weights (the engine broadcasts rank 0's): rank 0 serves full,
  partial and oversize requests, two batches dispatched before either is
  fetched, ``predict_stream`` and a ``MicroBatcher`` with four client
  threads, while rank 1 follows; the outputs against the one-process
  engine on the same weights (1e-6) and against the JAX engine on
  ``make_mesh(2)`` (2e-5, the engine's tolerance); ``stats()`` counts the
  images served, not the padding; ``close()`` releases the follower; then
  ``load_engine(mesh=)`` on a checkpoint whose sidecar stores a
  temperature, and an engine on a data 1 x model 2 mesh, whose two ranks
  share a data index and serve the same rows.
"""
from __future__ import annotations

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN
from rovit_kan_tpu_torch.parallel.mesh import Mesh
from rovit_kan_tpu_torch.serving import InferenceEngine, MicroBatcher

KW = dict(embed_dim=32, depth=1, num_heads=2, image_size=32, patch_size=16,
          kan_layers=(32, 8, 1), hidden_dim=16)
BATCH = 8
TEMPERATURE = 1.7
SIZES = (8, 5, 19)              # full, partial, oversize
CLIENTS = ((3, 5, 2), (1, 8, 4), (6, 2), (7, 1, 3))


def _imgs(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 32, 32, 3)) \
        .astype(np.uint8)


def _model(seed: int) -> RoViTKAN:
    from rovit_kan_tpu_torch.models.rovit_kan import init_weights
    model = RoViTKAN(**KW, dropout=0.0)
    init_weights(model, seed)
    return model


def _config() -> Config:
    cfg = Config()
    cfg.data.image_size = 32
    cfg.model.embed_dim, cfg.model.depth, cfg.model.num_heads = 32, 1, 2
    cfg.model.hidden_dim, cfg.model.kan_layers = 16, [32, 8, 1]
    cfg.flags.mixed_precision = False
    return cfg


def serve(engine, batcher_cls=MicroBatcher) -> dict:
    """Rank 0's calls (or the one-process engine's, or the JAX engine's
    with the JAX ``MicroBatcher``): the requests of ``SIZES`` through
    ``predict``, two dispatched before either is fetched,
    ``predict_stream``, a ``batcher_cls`` with ``CLIENTS`` threads, and the
    stats after each part."""
    out = {"predict": [engine.predict(_imgs(n, 10 + n)) for n in SIZES]}
    out["stats_predict"] = engine.stats()
    a, b = engine.dispatch(_imgs(8, 1)), engine.dispatch(_imgs(3, 2))
    out["depth2"] = [engine.fetch(a), engine.fetch(b)]
    out["stream"] = list(engine.predict_stream(
        [_imgs(4, 3), _imgs(8, 4), _imgs(11, 5)]))
    batcher = batcher_cls(engine, window_ms=2.0)
    got = {}

    def client(c, sizes):
        got[c] = [batcher.predict(_imgs(n, 100 * c + i))
                  for i, n in enumerate(sizes)]
    threads = [threading.Thread(target=client, args=(c, sizes))
               for c, sizes in enumerate(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    batcher.close()
    out["batcher"] = [got[c] for c in range(len(CLIENTS))]
    out["batcher_stats"] = batcher.stats()
    out["stats"] = engine.stats()
    return out


def _flat(out: dict) -> list:
    """Every served dict of ``serve``'s results, in one order."""
    return (out["predict"] + out["depth2"] + out["stream"]
            + [d for c in out["batcher"] for d in c])


# -- without ranks ------------------------------------------------------------

def test_refusals_and_one_rank_mesh():
    """A batch the data axis does not divide is refused before any
    collective, and so is the card where none is visible, whatever the
    mesh's device; a one-rank mesh serves the plain engine's bits; a
    leader does not follow, and a closed engine serves no more."""
    from rovit_kan_tpu_torch.parallel.mesh import make_mesh
    model = _model(0)
    two = Mesh(2, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="batch_size 7 is not divisible by "
                       "the mesh's data axis \\(2\\)"):
        InferenceEngine(model, batch_size=7, device="cpu", mesh=two)
    # A mesh on the CPU does not move an engine asked for the card there:
    # no card is visible (RuntimeError), or the mesh's rank is elsewhere.
    with pytest.raises((RuntimeError, ValueError),
                       match="torch.cuda.is_available|mesh's rank is on"):
        InferenceEngine(model, batch_size=8, mesh=two)
    plain = InferenceEngine(model, batch_size=BATCH, device="cpu")
    one = InferenceEngine(model, batch_size=BATCH, device="cpu",
                          mesh=make_mesh(1, device="cpu"))
    assert one.mesh is None and one.leader
    imgs = _imgs(13)
    want, got = plain.predict(imgs), one.predict(imgs)
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    with pytest.raises(RuntimeError, match="rank 0 leads"):
        one.follow()
    one.close()
    with pytest.raises(RuntimeError, match="closed"):
        one.predict(imgs)


# -- the ranks ----------------------------------------------------------------

def _worker(task_path: str) -> None:
    from rovit_kan_tpu_torch.parallel.mesh import make_2d_mesh, make_mesh
    from rovit_kan_tpu_torch.serving import load_engine
    task = torch.load(task_path, weights_only=False)
    mesh = make_mesh(2, device="cpu")
    # Rank 1 starts from other weights: the engine serves rank 0's.
    model = _model(0 if mesh.rank == 0 else 7)
    out = {}
    engine = InferenceEngine(model, batch_size=BATCH,
                             temperature=TEMPERATURE if mesh.rank == 0
                             else 1.0, device="cpu", mesh=mesh)
    if engine.leader:
        out["served"] = serve(engine)
        engine.close()
    else:
        engine.follow()
        out["followed"] = engine._closed
    out["weights"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["temperature"] = engine.temperature
    loaded = load_engine(task["checkpoint"], batch_size=BATCH, device="cpu",
                         mesh=mesh)
    if loaded.leader:
        out["loaded"] = [loaded.predict(_imgs(n, 20 + n)) for n in SIZES]
        out["loaded_temperature"] = loaded.temperature
        loaded.close()
    else:
        loaded.follow()
    # Data 1 x model 2: both ranks serve all eight rows of each batch.
    shared = InferenceEngine(_model(0), batch_size=BATCH, device="cpu",
                             mesh=make_2d_mesh(1, 2, device="cpu"))
    if shared.leader:
        out["shared"] = [shared.predict(_imgs(n, 30 + n)) for n in SIZES]
        shared.close()
    else:
        shared.follow()
    torch.save(out, Path(task_path).parent / f"out{mesh.rank}.pt")


def _jax_engine(model, temperature: float):
    """The JAX ``InferenceEngine`` on ``make_mesh(2)`` with the port
    model's weights."""
    from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
    from rovit_kan_tpu.parallel.mesh import make_mesh as jax_mesh
    from rovit_kan_tpu.serving import InferenceEngine as JaxEngine
    from rovit_kan_tpu_torch.models.convert import to_jax_params
    jm = JaxRoViTKAN(**KW, dropout=0.0, use_pallas_block=False,
                     use_pallas_kan=False, use_pallas_attention=False)
    return JaxEngine(jm, to_jax_params(model), batch_size=BATCH,
                     mesh=jax_mesh(2), temperature=temperature)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    from rovit_kan_tpu_torch.utils.checkpoint import (
        save_checkpoint,
        update_meta,
    )
    from test_torch_expert import join, start_ranks
    tmp = tmp_path_factory.mktemp("serve_mesh")
    ckpt = tmp / "best_model"
    save_checkpoint(ckpt, _model(4).state_dict(), config=_config())
    update_meta(ckpt, temperature=2.5)
    procs = start_ranks(__file__, {"checkpoint": str(ckpt)}, tmp, 2)
    try:
        model = _model(0)
        single = serve(InferenceEngine(model, batch_size=BATCH,
                                       temperature=TEMPERATURE,
                                       device="cpu"))
        from rovit_kan_tpu.serving import MicroBatcher as JaxBatcher
        jax_out = serve(_jax_engine(model, TEMPERATURE), JaxBatcher)
        from rovit_kan_tpu_torch.serving import load_engine
        loaded = load_engine(ckpt, batch_size=BATCH, device="cpu")
        single_loaded = [loaded.predict(_imgs(n, 20 + n)) for n in SIZES]
        shared = InferenceEngine(model, batch_size=BATCH, device="cpu")
        single_shared = [shared.predict(_imgs(n, 30 + n)) for n in SIZES]
        ranks = join(procs, tmp)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {"ranks": ranks, "single": single, "jax": jax_out,
            "single_loaded": single_loaded, "single_shared": single_shared}


def _assert_served(got: list, want: list, atol: float) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            assert g[k].shape == v.shape and g[k].dtype == v.dtype, k
            np.testing.assert_allclose(g[k], v, atol=atol, rtol=0,
                                       err_msg=k)


def test_mesh_engine_matches_one_process(launched):
    """Every request rank 0 served (full, partial, oversize, depth 2,
    ``predict_stream``, the ``MicroBatcher``'s clients) against the
    one-process engine on the same weights (1e-6), rank 1 having started
    from other weights and another temperature."""
    got, want = launched["ranks"][0]["served"], launched["single"]
    _assert_served(_flat(got), _flat(want), 1e-6)
    assert [d["cls_probs"].shape[0] for d in got["predict"]] == list(SIZES)
    w0, w1 = (launched["ranks"][r]["weights"] for r in range(2))
    assert all(torch.equal(w0[k], w1[k]) for k in w0)
    assert launched["ranks"][1]["temperature"] == TEMPERATURE


def test_mesh_engine_matches_jax_mesh_engine(launched):
    """The same requests against the JAX ``InferenceEngine(mesh=
    make_mesh(2))`` on the same weights, its ``MicroBatcher`` in front
    (2e-5), and the same count of images served (the batchers' batches
    depend on the clients' timing)."""
    got, want = launched["ranks"][0]["served"], launched["jax"]
    _assert_served(_flat(got), _flat(want), 2e-5)
    assert got["stats"]["images_served"] == want["stats"]["images_served"]


def test_stats_count_served_images_and_close_releases(launched):
    """``stats()`` on rank 0 counts the images served, not the padding of
    the partial batches; the follower's ``follow()`` returned on
    ``close()``."""
    got = launched["ranks"][0]["served"]
    n_predict = sum(SIZES)
    assert got["stats_predict"]["images_served"] == n_predict
    assert got["stats_predict"]["requests"] == 1 + 1 + 3
    n = n_predict + 8 + 3 + 4 + 8 + 11 + sum(map(sum, CLIENTS))
    assert got["stats"]["images_served"] == n
    assert launched["single"]["stats"]["images_served"] == n
    assert got["batcher_stats"]["requests_coalesced"] == sum(
        map(len, CLIENTS))
    assert launched["ranks"][1]["followed"] is True


def test_load_engine_on_the_mesh(launched):
    """``load_engine(mesh=)`` adopts the sidecar's temperature and serves
    the one-process ``load_engine``'s outputs (1e-6)."""
    r0 = launched["ranks"][0]
    assert r0["loaded_temperature"] == 2.5
    _assert_served(r0["loaded"], launched["single_loaded"], 1e-6)


def test_ranks_sharing_a_data_index(launched):
    """On data 1 x model 2 both ranks serve every row of each batch: rank
    0's outputs are the one-process engine's (1e-6)."""
    _assert_served(launched["ranks"][0]["shared"],
                   launched["single_shared"], 1e-6)


if __name__ == "__main__":
    _worker(sys.argv[1])
