"""The port's checkpoints, ``load_model_for_evaluation`` and ``load_engine``
against the JAX package.

The sidecar must carry the JAX sidecar's keys and values for the same save;
the checkpoint's ``model.pt`` must be a reference-layout state_dict that the
JAX package's ``load_torch_checkpoint`` and ``convert_reference_checkpoint``
turn into the model's JAX tree exactly; saves must be atomic (a torso is
never restored, a committed stage is adopted); and an engine loaded from a
checkpoint must serve what the JAX serving forward computes on the same
weights (fp32, 2e-5), at the trained size and at another one through
``transfer_resolution``, with the sidecar's calibration temperature.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.config import get_config
from rovit_kan_tpu.models.convert import (
    convert_reference_checkpoint,
    load_torch_checkpoint,
)
from rovit_kan_tpu.models.convert import \
    transfer_resolution as jax_transfer_resolution
from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
from rovit_kan_tpu.serving import build_serving_forward as jax_forward
from rovit_kan_tpu.utils import checkpoint as jck
from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.evaluation.evaluator import \
    load_model_for_evaluation
from rovit_kan_tpu_torch.models.convert import load_jax_params, to_jax_params
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN
from rovit_kan_tpu_torch.serving import load_engine
from rovit_kan_tpu_torch.utils import checkpoint as tck

KW = dict(embed_dim=32, depth=1, num_heads=2, image_size=32, patch_size=16,
          kan_layers=(32, 8, 1), hidden_dim=16)
TEMPERATURE = 1.7


def _config(cfg):
    m = cfg.model
    m.embed_dim, m.depth, m.num_heads = 32, 1, 2
    m.kan_layers, m.hidden_dim = [32, 8, 1], 16
    cfg.data.image_size = 32
    cfg.flags.mixed_precision = False
    return cfg


@pytest.fixture(scope="module")
def pair():
    jm = JaxRoViTKAN(**KW)
    params = jm.init(jax.random.PRNGKey(5),
                     np.zeros((1, 32, 32, 3), np.float32))["params"]
    rng = np.random.RandomState(5)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), params)
    return jm, params, load_jax_params(RoViTKAN(**KW), params, device="cpu")


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_sidecar_matches_jax(tmp_path, pair):
    _, params, model = pair
    metrics = {"total_loss": np.float32(0.5), "accuracy": 0.75}
    kw = dict(epoch=3, best_val_loss=0.5, metrics=metrics,
              epochs_without_improvement=1)
    jck.save_checkpoint(tmp_path / "j" / "best_model", params,
                        config=_config(get_config()), **kw)
    tck.save_checkpoint(tmp_path / "t" / "best_model", model.state_dict(),
                        config=_config(Config()), **kw)
    want = json.loads((tmp_path / "j" / "best_model.meta.json").read_text())
    got = json.loads((tmp_path / "t" / "best_model.meta.json").read_text())
    assert got == want
    assert tck.load_meta(tmp_path / "t" / "best_model") == want
    merged = tck.update_meta(tmp_path / "t" / "best_model", temperature=1.5)
    assert merged == {**want, "temperature": 1.5}
    assert tck.load_checkpoint(tmp_path / "t" / "best_model")[
        "temperature"] == 1.5


def test_checkpoint_read_by_convert_reference_checkpoint(tmp_path, pair):
    """``model.pt`` is the reference trainer's format: the JAX converter
    reads it back to the model's tree, and ``load_checkpoint`` to the same
    state_dict, optimizer state and EMA."""
    _, params, model = pair
    opt = {"names": ["a"], "mu": torch.arange(3.0), "nu": torch.ones(3),
           "count": 4, "accum_steps": 1, "acc": None, "mini_step": 0}
    ema = {k: v * 2 for k, v in model.state_dict().items()}
    path = tmp_path / "best_model"
    tck.save_checkpoint(path, model.state_dict(), opt_state=opt,
                        ema_params=ema, epoch=2)
    sd = load_torch_checkpoint(path / "model.pt")
    got = dict(_flat(convert_reference_checkpoint(sd, depth=KW["depth"])))
    want = dict(_flat(params))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg="/".join(k))
    ck = tck.load_checkpoint(path)
    assert ck["epoch"] == 2 and ck["opt_state"]["count"] == 4
    assert torch.equal(ck["opt_state"]["mu"], opt["mu"])
    for k, v in model.state_dict().items():
        assert torch.equal(ck["params"][k], v), k
        assert torch.equal(ck["ema_params"][k], ema[k]), k


def test_saves_are_atomic_and_committed_stages_adopted(tmp_path):
    path = tmp_path / "best_model"
    stage = tmp_path / "best_model.next"
    a = {"w": torch.zeros(3)}
    tck.save_checkpoint(path, a, epoch=1)
    assert tck.is_finalized(path) and not stage.exists()

    # A torso (a crash mid-write) is never adopted or restored.
    stage.mkdir()
    assert not tck.is_finalized(stage)
    assert tck.promote_staging(path)
    assert torch.equal(tck.load_checkpoint(path)["params"]["w"], a["w"])

    # An asynchronous save returns after copying to the host: later
    # changes to the live tensor do not reach the checkpoint, and the
    # committed one survives until the swap.
    live = torch.ones(3)
    tck.save_checkpoint(path, {"w": live}, epoch=2, block=False)
    live.add_(5.0)
    tck.wait_for_checkpoints()
    ck = tck.load_checkpoint(path)
    assert ck["epoch"] == 2 and torch.equal(ck["params"]["w"], torch.ones(3))

    # A committed stage whose swap never ran (a hard kill) is adopted,
    # unless the final's sidecar is newer.
    shutil.copytree(path, stage)
    (tmp_path / "best_model.next.meta.json").write_text(json.dumps(
        {"epoch": 3}))
    assert tck.promote_staging(path)
    assert tck.load_meta(path) == {"epoch": 3} and not stage.exists()
    shutil.copytree(path, stage)
    (tmp_path / "best_model.next.meta.json").write_text(json.dumps(
        {"epoch": 1}))
    tck.promote_staging(path)
    assert tck.load_meta(path) == {"epoch": 3} and stage.exists()

    # A half swap (data renamed, sidecar not) is finished.
    shutil.rmtree(stage)
    assert tck.promote_staging(path)
    assert tck.load_meta(path) == {"epoch": 1}

    tck.discard_staging(path)
    assert not any(tmp_path.iterdir())


def _serve_ref(jm, params, imgs, size):
    if size != 32:
        params = jax_transfer_resolution(params, size, 16)
        jm = JaxRoViTKAN(**{**KW, "image_size": size})
    return jax_forward(jm, temperature=TEMPERATURE)(params, jnp.asarray(imgs))


@pytest.mark.parametrize("size", [32, 64])
def test_load_engine_matches_jax_serving(tmp_path, pair, size):
    """The sidecar's temperature is adopted; at 64 px the position
    embedding goes through ``transfer_resolution``."""
    jm, params, model = pair
    path = tmp_path / "best_model"
    tck.save_checkpoint(path, model.state_dict(), config=_config(Config()))
    tck.update_meta(path, temperature=TEMPERATURE)
    engine = load_engine(path, batch_size=8,
                         image_size=None if size == 32 else size,
                         device="cpu")
    assert engine.temperature == TEMPERATURE
    assert engine.model.image_size == size and not engine.model.training
    imgs = np.random.RandomState(size).randint(
        0, 256, (5, size, size, 3)).astype(np.uint8)
    want = _serve_ref(jm, params, imgs, size)
    got = engine.predict(imgs)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), atol=2e-5, rtol=0,
                                   err_msg=k)


def test_evaluation_loads_the_ema(tmp_path, pair):
    """With an EMA in the checkpoint the evaluator loads it, unless
    ``use_ema=False``; without an embedded config it needs one."""
    _, params, model = pair
    ema = {k: v + 0.01 for k, v in model.state_dict().items()}
    path = tmp_path / "best_model"
    tck.save_checkpoint(path, model.state_dict(), ema_params=ema,
                        config=_config(Config()))
    m, sd = load_model_for_evaluation(path, device="cpu")
    assert not m.training
    for k, v in m.state_dict().items():
        assert torch.equal(v, ema[k]) and torch.equal(sd[k], ema[k]), k
    raw, _ = load_model_for_evaluation(path, use_ema=False, device="cpu")
    want = dict(_flat(params))
    for k, v in _flat(to_jax_params(raw)):
        np.testing.assert_array_equal(v, want[k])
    bare = tmp_path / "bare"
    tck.save_checkpoint(bare, model.state_dict())
    with pytest.raises(ValueError, match="config"):
        load_model_for_evaluation(bare, device="cpu")
    m2, _ = load_model_for_evaluation(bare, _config(Config()), device="cpu")
    assert m2.image_size == 32
