"""The port's RoViTKAN against the JAX model on the same weights.

JAX params (small: d=32, depth 2, 2 heads, 32 px, KAN (32, 8, 1), hidden 16,
every leaf perturbed off its init so biases and LayerNorms are not trivial)
go through ``load_jax_params``; all six outputs must match at 2e-5 in fp32
(the JAX converter's precedent, tests/test_convert.py), and at 5e-2 in bf16
against the JAX model with the fused block kernel (interpret mode here).
The block policy against the JAX rule (the port's "auto" takes what the
JAX rule takes at every preset width), ``build_model`` with remat and with
MoE (the fused block on the dense blocks only), and the wrapper's refusal
of other widths before any launch.
"""
import re
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.config import Config as JaxConfig
from rovit_kan_tpu.models.convert import convert_reference_checkpoint
from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
from rovit_kan_tpu.models.rovit_kan import _resolve_pallas_block
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
from rovit_kan_tpu_torch.ops.attention import fused_attention

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


def _widths(dtype) -> list:
    """Every width of a multiple of 64 up to 1,024 that
    ``block_width_ok`` takes in ``dtype``."""
    return [d for d in range(64, 1025, 64) if bk.block_width_ok(d, dtype)]


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
    # At every preset width (tiny 192, small 384, base 768) "auto" takes
    # what the JAX rule takes: its kernel for bf16 inference at any width
    # and for training at d <= 512.
    with mock.patch.object(jax, "default_backend", lambda: "tpu"):
        for d in (192, 384, 768):
            for inference in (True, False):
                jax_rule = _resolve_pallas_block(
                    "auto", inference=inference, dtype=jnp.bfloat16,
                    embed_dim=d)
                assert jax_rule == (inference or d <= 512)
                assert _resolve_fused_block(
                    "auto", inference=inference, dtype=bf16, embed_dim=d,
                    device=cuda) == jax_rule, (d, inference)
                assert _resolve_fused_block(True, inference=inference,
                                            dtype=bf16, embed_dim=d,
                                            device=cuda)
        for d in _widths(bf16):
            assert _resolve_fused_block("auto", inference=False, dtype=bf16,
                                        embed_dim=d, device=cuda) == (
                d <= 512)
        # A width the bf16 stages do not take stays on the plain block: past
        # 768, or a head width the kernels refuse (256 in one head).
        assert not _resolve_fused_block("auto", inference=True, dtype=bf16,
                                        embed_dim=832, device=cuda)
        assert not _resolve_fused_block("auto", inference=True, dtype=bf16,
                                        embed_dim=256, device=cuda,
                                        num_heads=1)
    cfg = Config()
    cfg.tpu.use_pallas_attention = True          # kernels #5/#6
    cfg.tpu.use_pallas_block = False
    for blk in build_model(cfg, device="cpu").backbone.model.blocks:
        assert blk.attn.use_fused and not blk.use_fused_block
        assert blk.attn.attn_fn is fused_attention
    # Remat and MoE build (they raised NotImplementedError before their
    # port): a forced fused block stays on the dense blocks only, and the
    # experts sit in every second block, as in the JAX model.
    cfg = Config()
    cfg.tpu.remat_backbone = True
    assert build_model(cfg, device="cpu").backbone.model.remat
    cfg = Config()
    cfg.model.moe_experts = 4
    cfg.tpu.use_pallas_block = True
    blocks = build_model(cfg, device="cpu").backbone.model.blocks
    assert [hasattr(b, "moe") for b in blocks] == [i % 2 == 1
                                                   for i in range(12)]
    assert [b.use_fused_block for b in blocks] == [i % 2 == 0
                                                   for i in range(12)]


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 832),
                                     (torch.bfloat16, 768),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 384)])
def test_block_kernel_refuses_unsupported_widths(dtype, D):
    """A width the route's stages do not take is refused by the wrapper's
    checks, naming the widths (``block_width_ok``: a multiple of 64 up to
    768 in bf16, 320 in fp32), before anything is launched (no card is
    needed to reach the check): the forward's, the backward's, the op's
    while export traces and the training forward of ``FusedViTBlock``'s,
    before its launch. bf16 d = 768 (the base preset) and 256 are taken by
    both directions since the wide stages take every width up to 768."""
    heads = D // 64
    params = bk.prepare_block_params(
        {k: torch.zeros(s) for k, s in bk.param_shapes(D, 4 * D).items()},
        dtype)
    x = torch.zeros(2, 5, D, dtype=dtype)
    takes = bk.block_width_ok(D, dtype, heads)
    assert takes == (dtype == torch.bfloat16 and D <= 768)
    top = bk.BLOCK_MAX_WIDTH[dtype]
    g = torch.zeros(2, 5, D)
    from torch._subclasses.fake_tensor import FakeTensorMode
    if takes:
        bk._check_cuda_args(x, params, heads)
        bk._check_bwd_args(x, g, params, heads)
    else:
        with pytest.raises(ValueError,
                           match=rf"D={D}.*forward.*multiple of 64 from 64 "
                                 rf"to {top}"):
            bk._check_cuda_args(x, params, heads)
        with pytest.raises(ValueError,
                           match=rf"D={D}.*backward.*multiple of 64 from 64 "
                                 rf"to {top}"):
            bk._check_bwd_args(x, g, params, heads)
    # The forced kernel's op refuses a forward width the same way while
    # export traces; the training forward refuses the backward's width.
    with FakeTensorMode():
        fx = torch.empty((2, 5, D), dtype=dtype, device="cuda")
        fp = [torch.empty(t.shape, dtype=t.dtype, device="cuda")
              for t in (params[k] for k in bk.PKEYS)]
        if takes:
            assert bk._VIT_BLOCK_FWD(fx, fp, heads).shape == fx.shape
        else:
            with pytest.raises(ValueError, match=f"D={D}"):
                bk._VIT_BLOCK_FWD(fx, fp, heads)
            with pytest.raises(ValueError, match=rf"D={D}.*backward"):
                bk.FusedViTBlock.forward(types.SimpleNamespace(), fx, heads,
                                         dict(zip(bk.PKEYS, fp)), False, *fp)
    for check in (bk._check_cuda_args,
                  lambda xx, p, h: bk._check_bwd_args(
                      xx, torch.zeros(xx.shape), p, h)):
        for d in _widths(dtype):                  # the widths it takes pass
            p = bk.prepare_block_params(
                {k: torch.zeros(s)
                 for k, s in bk.param_shapes(d, 4 * d).items()}, dtype)
            check(torch.zeros(1, 3, d, dtype=dtype), p, d // 64)


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
