"""The block kernels at the widths the JAX block rule sends to its kernel
that no preset has (d = 256, 320, 448, 512, ...), in the port against the
JAX package.

- "auto": the port's ``_resolve_fused_block`` against the JAX
  ``_resolve_pallas_block`` with "tpu" read as "cuda" (the JAX backend
  patched to "tpu"), at d in {64, 192, 256, 320, 384, 448, 512, 640, 768,
  832} (heads of 64), inference and training, bf16 and fp32, without
  compute: the port takes the JAX rule wherever ``block_width_ok`` holds
  and stays plain only where it does not (bf16 past 768; fp32 "auto" is
  plain in both packages);
- a forced kernel at d = 832 refuses, naming the widths it takes;
- one forward at d = 320 (5 heads of 64), depth 1, 32 px, fp32, on the
  fused block against the JAX ``use_pallas_block=True`` model (the Pallas
  kernel in interpret mode; the port's CPU path is the kernels' plain
  versions), 2e-5;
- one train step at d = 256 (4 heads of 64) with the backbone live, as
  ``tests/test_torch_presets.py`` steps the small preset: the loss within
  1e-4 and every gradient within 1e-3 of its leaf's largest
  (``run_pair``), the parameters after it within 2e-5.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
from rovit_kan_tpu.models.rovit_kan import _resolve_pallas_block
from rovit_kan_tpu_torch.models.convert import load_jax_params, to_jax_params
from rovit_kan_tpu_torch.models.rovit_kan import (
    RoViTKAN,
    _resolve_fused_block,
    init_weights,
)
from rovit_kan_tpu_torch.ops import block_kernel as bk
from test_torch_model import OUTPUTS
from test_torch_train_step import assert_params_match, run_pair

WIDTHS = (64, 192, 256, 320, 384, 448, 512, 640, 768, 832)


def width_kw(D: int, depth: int) -> dict:
    """A model of width ``D`` (heads of 64, hidden 4D) at 32 px."""
    return dict(embed_dim=D, num_heads=D // 64, depth=depth, image_size=32,
                patch_size=16, kan_layers=(D, 8, 1), hidden_dim=16)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_auto_follows_the_jax_rule_where_the_kernels_take_the_width(dtype):
    tdt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    jdt = {"bf16": jnp.bfloat16, "fp32": jnp.float32}[dtype]
    cuda = torch.device("cuda")
    with mock.patch.object(jax, "default_backend", lambda: "tpu"):
        for D in WIDTHS:
            for inference in (True, False):
                jax_rule = _resolve_pallas_block(
                    "auto", inference=inference, dtype=jdt, embed_dim=D)
                takes = bk.block_width_ok(D, torch.bfloat16, D // 64)
                assert takes == (D <= 768)
                got = _resolve_fused_block(
                    "auto", inference=inference, dtype=tdt, embed_dim=D,
                    device=cuda, num_heads=D // 64)
                # Plain only where the JAX rule or the predicate refuses.
                assert got == (jax_rule and takes), (D, inference)
    # On the CPU "auto" is plain, as the JAX rule off the TPU.
    assert not _resolve_fused_block("auto", inference=True, dtype=tdt,
                                    embed_dim=320, device=torch.device("cpu"))


def test_forced_kernel_refuses_832():
    D, heads = 832, 13
    params = bk.prepare_block_params(
        {k: torch.zeros(s) for k, s in bk.param_shapes(D, 4 * D).items()},
        torch.bfloat16)
    x = torch.zeros(1, 5, D, dtype=torch.bfloat16)
    for check in (lambda: bk._check_cuda_args(x, params, heads),
                  lambda: bk._check_bwd_args(x, torch.zeros(x.shape), params,
                                             heads)):
        with pytest.raises(ValueError, match=r"unsupported block width "
                                             r"D=832 .* multiple of 64 from "
                                             r"64 to 768"):
            check()


def test_forward_at_320_matches_jax():
    kw = dict(width_kw(320, 1), use_pallas_block=True)
    seed_model = RoViTKAN(**kw)
    init_weights(seed_model, seed=4)
    rng = np.random.RandomState(4)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.02, a.shape).astype(np.float32), to_jax_params(seed_model))
    images = rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = JaxRoViTKAN(**kw).apply({"params": params}, jnp.asarray(images),
                                   deterministic=True)
    model = load_jax_params(RoViTKAN(**kw), params, device="cpu").eval()
    assert all(b.use_fused_block for b in model.backbone.model.blocks)
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert bk.LAUNCHES == 0
    for k in OUTPUTS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-5, rtol=0, err_msg=k)


def test_step_at_256_matches_jax():
    kw = width_kw(256, 2)
    jlosses, tlosses, jparams, model = run_pair(1, fused=True, model_kw=kw,
                                                live_from=0)
    assert all(b.use_fused_block for b in model.backbone.model.blocks)
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-4, rtol=1e-4)
    assert_params_match(model, jparams)
