"""The port's RoViTKAN against the JAX model on the same weights.

JAX params (small: d=32, depth 2, 2 heads, 32 px, KAN (32, 8, 1), hidden 16,
every leaf perturbed off its init so biases and LayerNorms are not trivial)
go through ``load_jax_params``; all six outputs must match at 2e-5 in fp32
(the JAX converter's precedent, tests/test_convert.py), and at 5e-2 in bf16
against the JAX model with the fused block kernel (interpret mode here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.config import Config as JaxConfig
from rovit_kan_tpu.models.convert import convert_reference_checkpoint
from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
from rovit_kan_tpu.models.rovit_kan import predict as jax_predict
from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.models.convert import load_jax_params, to_jax_params
from rovit_kan_tpu_torch.models.rovit_kan import (
    RoViTKAN,
    _resolve_fused_block,
    build_model,
    count_parameters,
    predict,
)
from rovit_kan_tpu_torch.ops import block_kernel as bk

KW = dict(embed_dim=32, depth=2, num_heads=2, image_size=32, patch_size=16,
          kan_layers=(32, 8, 1), hidden_dim=16)
OUTPUTS = ("features", "cls_logits", "ordinal_logits", "mu", "log_var",
           "kan_severity")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def jax_params():
    m = JaxRoViTKAN(**KW)
    params = m.init(jax.random.PRNGKey(0),
                    np.zeros((1, 32, 32, 3), np.float32))["params"]
    rng = np.random.RandomState(0)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(
            np.float32), params)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).normal(0, 1, (4, 32, 32, 3)).astype(
        np.float32)


def test_fp32_outputs_match_jax(jax_params, images):
    want = JaxRoViTKAN(**KW).apply({"params": jax_params},
                                   jnp.asarray(images), deterministic=True)
    model = load_jax_params(RoViTKAN(**KW), jax_params, device="cpu").eval()
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert set(got) == set(OUTPUTS)
    for k in OUTPUTS:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-5, rtol=0, err_msg=k)


def test_predict_matches_jax(jax_params, images):
    want = jax_predict(JaxRoViTKAN(**KW), jax_params, jnp.asarray(images))
    model = load_jax_params(RoViTKAN(**KW), jax_params, device="cpu")
    got = predict(model, torch.from_numpy(images))
    np.testing.assert_array_equal(got["cls_pred"].numpy(),
                                  np.asarray(want["cls_pred"]))
    for k in ("cls_probs", "ordinal_probs", "ordinal_severity",
              "uncertainty_std"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-5, rtol=0, err_msg=k)


def test_bf16_fused_block_matches_jax(jax_params, images):
    jm = JaxRoViTKAN(**KW, dtype=jnp.bfloat16, use_pallas_block=True)
    want = jm.apply({"params": jax_params}, jnp.asarray(images),
                    deterministic=True)
    model = RoViTKAN(**KW, dtype=torch.bfloat16, use_pallas_block=True)
    model = load_jax_params(model, jax_params, device="cpu").eval()
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert bk.LAUNCHES == 0          # the CPU path is the plain block
    for k in OUTPUTS:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=5e-2, rtol=0, err_msg=k)


def test_kernel_weights_cached_per_version(jax_params):
    model = RoViTKAN(**KW, dtype=torch.bfloat16, use_pallas_block=True)
    blk = model.backbone.model.blocks[0]
    first = blk.kernel_params()
    assert blk.kernel_params() is first                 # reused
    assert first["wqkv"].dtype == torch.bfloat16
    assert first["bqkv"].dtype == torch.float32
    load_jax_params(model, jax_params, device="cpu")    # in-place copy
    second = blk.kernel_params()
    assert second is not first
    np.testing.assert_array_equal(
        second["w1"].float().numpy(),
        torch.from_numpy(np.asarray(
            jax_params["backbone"]["blocks_0"]["mlp"]["fc1"]["kernel"]).T)
        .to(torch.bfloat16).float().numpy())


def test_to_jax_params_round_trip(jax_params):
    model = load_jax_params(RoViTKAN(**KW), jax_params, device="cpu")
    back = dict(_flatten(to_jax_params(model)))
    want = dict(_flatten(jax_params))
    assert back.keys() == want.keys()
    for k, v in want.items():
        assert back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v, err_msg="/".join(k))


def test_state_dict_uses_reference_names(jax_params):
    """The port's state_dict goes through the JAX package's converter of
    reference checkpoints and gives back the JAX tree; only the patch
    embedding changes form (a Linear here, a conv in the reference)."""
    model = load_jax_params(RoViTKAN(**KW), jax_params, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    w = sd["backbone.model.patch_embed.proj.weight"]       # (D, p*p*3)
    sd["backbone.model.patch_embed.proj.weight"] = w.reshape(
        w.shape[0], 16, 16, 3).transpose(0, 3, 1, 2)       # (D, 3, p, p)
    got = dict(_flatten(convert_reference_checkpoint(sd, depth=2)))
    want = dict(_flatten(jax_params))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg="/".join(k))


def test_flagship_parameter_count():
    model = build_model(Config(), inference=True, device="cpu")
    counts = count_parameters(model)
    assert counts["total"] == 5_706_394
    assert counts["backbone"] == 5_524_416
    assert not model.training


def test_ablation_heads_fixed_shapes():
    model = RoViTKAN(**KW, with_ordinal=False, with_kan=False).eval()
    assert model.head_mask == {"ordinal": False, "uncertainty": True,
                               "kan": False}
    assert not hasattr(model, "kan_module")
    with torch.no_grad():
        out = model(torch.zeros(3, 32, 32, 3))
    assert out["ordinal_logits"].shape == (3, 3)
    assert out["kan_severity"].shape == (3, 1)
    assert not out["ordinal_logits"].any() and not out["kan_severity"].any()
    assert out["mu"].shape == (3, 1)


def test_block_policy_and_unported_options():
    bf16, cuda, cpu = torch.bfloat16, torch.device("cuda"), torch.device(
        "cpu")
    assert _resolve_fused_block("auto", inference=True, dtype=bf16,
                                embed_dim=192, device=cuda)
    assert not _resolve_fused_block("auto", inference=True, dtype=bf16,
                                    embed_dim=192, device=cpu)
    assert not _resolve_fused_block("auto", inference=True,
                                    dtype=torch.float32, embed_dim=192,
                                    device=cuda)
    assert not _resolve_fused_block("auto", inference=False, dtype=bf16,
                                    embed_dim=768, device=cuda)
    assert _resolve_fused_block(True, inference=False, dtype=bf16,
                                embed_dim=768, device=cpu)
    cfg = Config()
    cfg.tpu.use_pallas_attention = True          # no attention-only kernel
    with pytest.raises(NotImplementedError):
        build_model(cfg, device="cpu")


def test_config_dict_saved_by_jax_loads():
    """The port's config copy keeps every section and field name, so a
    config dict saved by the JAX package loads unchanged."""
    jcfg = JaxConfig()
    jcfg.model.depth = 7
    jcfg.tpu.use_pallas_block = False
    d = jcfg.to_dict()
    cfg = Config.from_dict(d)
    assert cfg.to_dict() == d
    assert cfg.model.depth == 7 and cfg.tpu.use_pallas_block is False
