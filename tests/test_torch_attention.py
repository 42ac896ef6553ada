"""The port's attention-only path against the JAX package's.

The plain versions of kernels #5/#6 (``attention_reference``,
``attention_backward_reference``, which ``fused_attention`` and
``FusedAttention`` take on the CPU) against the Pallas kernels in interpret
mode (``rovit_kan_tpu.ops.attention.fused_attention`` and its ``jax.vjp``),
as tests/test_attention.py runs them; the resolution transfer that carries a
224-px model to 384 px (577 tokens); the attention policy; the small model
and four train steps with ``use_pallas_attention=True`` against the JAX
model with the same flags.

Tolerances: fp32 forward ``rtol=1e-4, atol=1e-5`` and backward ``rtol=2e-3,
atol=2e-4`` (tests/test_attention.py:18, :51-52); bf16 operands within 5e-2
of the fp32 result (tests/test_attention.py:98); bf16 against the bf16
kernel within two bf16 ulps at each output's largest magnitude, since both
round at the same points and differ only where an fp32 sum in another order
crosses a rounding boundary; the model at 2e-5 (fp32) and 5e-2 (bf16), the
precedents of tests/test_torch_model.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.models import convert as jconvert
from rovit_kan_tpu.models import rovit_kan as jrk
from rovit_kan_tpu.ops.attention import fused_attention as jax_attention
from rovit_kan_tpu.serving import build_serving_forward as jax_serving
from rovit_kan_tpu_torch.models.convert import (
    POS_EMBED_KEY,
    interpolate_pos_embed,
    load_jax_params,
    to_jax_params,
    transfer_resolution,
)
from rovit_kan_tpu_torch.models.rovit_kan import (
    RoViTKAN,
    _resolve_fused_attention,
)
from rovit_kan_tpu_torch.ops import attention as at
from rovit_kan_tpu_torch.serving import InferenceEngine
from test_torch_train_step import assert_params_match, run_pair

SHAPES = [(2, 3, 13, 8), (1, 3, 197, 64), (1, 3, 577, 64)]
KW = dict(embed_dim=32, depth=2, num_heads=2, image_size=32, patch_size=16,
          kan_layers=(32, 8, 1), hidden_dim=16)
OUTPUTS = ("features", "cls_logits", "ordinal_logits", "mu", "log_var",
           "kan_severity")


def _qkvg(shape):
    rng = np.random.RandomState(sum(shape))
    q = rng.randn(*shape).astype(np.float32) * shape[-1] ** -0.5
    return (q, *(rng.randn(*shape).astype(np.float32) for _ in range(3)))


def _bf16_ulps(want, n=2.0):
    top = float(np.abs(want).max())
    return n * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_matches_jax(shape):
    q, k, v, _ = _qkvg(shape)
    want = np.asarray(jax_attention(*(jnp.asarray(a) for a in (q, k, v))))
    got = at.fused_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.dtype == torch.float32 and at.LAUNCHES == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)

    want16 = np.asarray(jax_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))))
    got16 = at.fused_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got16.dtype == torch.float32
    assert np.abs(got16.numpy() - want).max() < 5e-2
    assert np.abs(got16.numpy() - want16).max() <= _bf16_ulps(want16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES[:2],
                         ids=lambda s: "x".join(map(str, s)))
def test_backward_matches_jax_vjp(shape, dtype):
    q, k, v, g = _qkvg(shape)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _, vjp = jax.vjp(jax_attention, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = [np.asarray(t, np.float32) for t in vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (q, k, v)]
    at.fused_attention(*leaves).backward(torch.from_numpy(g))
    assert at.BWD_LAUNCHES == 0
    for name, t, w in zip("qkv", leaves, want):
        assert t.grad.dtype == dtype, name
        got = t.grad.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, w, rtol=2e-3, atol=2e-4,
                                       err_msg=name)
        else:
            assert np.abs(got - w).max() <= _bf16_ulps(w), name


def test_plain_attention_is_the_reference_under_autograd():
    q, k, v, g = _qkvg((1, 2, 9, 16))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = at.plain_attention(*leaves)
    out.backward(torch.from_numpy(g))
    torch.testing.assert_close(out.detach(), at.attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v))), rtol=0, atol=0)
    want = at.attention_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v, g)))
    for t, w in zip(leaves, want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)


@pytest.mark.parametrize("grids", [(14, 24), (24, 14)],
                         ids=["224to384", "384to224"])
def test_transfer_resolution_matches_jax(grids):
    src, dst = (16 * n for n in grids)
    small = dict(KW, depth=1)
    model = RoViTKAN(**dict(small, image_size=src))
    with torch.no_grad():
        model.backbone.model.pos_embed.normal_(0, 0.02, generator=torch
                                                .Generator().manual_seed(0))
    state = model.state_dict()
    moved = transfer_resolution(state, dst, 16)
    assert moved[POS_EMBED_KEY].shape == (1, (dst // 16) ** 2 + 1, 32)
    assert state[POS_EMBED_KEY].shape == (1, (src // 16) ** 2 + 1, 32)
    want = jconvert.transfer_resolution(to_jax_params(model), dst, 16)
    np.testing.assert_allclose(moved[POS_EMBED_KEY].numpy(),
                               want["backbone"]["pos_embed"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(
        interpolate_pos_embed(state[POS_EMBED_KEY], (dst // 16) ** 2 + 1)
        .numpy(), jconvert.interpolate_pos_embed(
            state[POS_EMBED_KEY].numpy(), (dst // 16) ** 2 + 1),
        rtol=0, atol=1e-6)
    target = RoViTKAN(**dict(small, image_size=dst))
    target.load_state_dict(moved, strict=True)     # every other weight fits
    for key, value in state.items():
        if key != POS_EMBED_KEY:
            assert moved[key] is value


@pytest.mark.parametrize("backend", ["cpu", "tpu"])
def test_policy_matches_jax(monkeypatch, backend):
    """The JAX policy with the backend pinned, "tpu" read as "cuda", over
    the grid of tests/test_model.py's policy test."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    device = torch.device("cuda" if backend == "tpu" else "cpu")
    dtypes = ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32))
    for setting in (True, False, "auto"):
        for size in (224, 384):
            for inference in (True, False):
                for tdt, jdt in dtypes:
                    want = jrk._resolve_pallas_attention(
                        setting, image_size=size, patch_size=16,
                        inference=inference, dtype=jdt)
                    got = _resolve_fused_attention(
                        setting, image_size=size, patch_size=16,
                        inference=inference, dtype=tdt, device=device)
                    assert got is want, (setting, size, inference, tdt)
    assert _resolve_fused_attention(
        "auto", image_size=384, patch_size=16, inference=True,
        dtype=torch.bfloat16, device=device) is (backend == "tpu")


@pytest.fixture(scope="module")
def jax_params():
    m = jrk.RoViTKAN(**KW)
    params = m.init(jax.random.PRNGKey(0),
                    np.zeros((1, 32, 32, 3), np.float32))["params"]
    rng = np.random.RandomState(0)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(
            np.float32), params)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_model_with_fused_attention_matches_jax(jax_params, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    images = np.random.RandomState(1).normal(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    flags = dict(use_pallas_attention=True, use_pallas_block=False)
    want = jrk.RoViTKAN(**KW, dtype=jdt, **flags).apply(
        {"params": jax_params}, jnp.asarray(images), deterministic=True)
    model = load_jax_params(RoViTKAN(**KW, dtype=dtype, **flags), jax_params,
                            device="cpu").eval()
    for blk in model.backbone.model.blocks:
        assert blk.attn.use_fused and not blk.use_fused_block
        assert blk.attn.attn_fn is at.fused_attention
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert at.LAUNCHES == 0
    atol = 2e-5 if dtype == torch.float32 else 5e-2
    for key in OUTPUTS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=atol, rtol=0, err_msg=key)


def test_attention_train_steps_match_jax():
    """Four steps over stages 1-4 (backbone live from the third), both sides
    with ``use_pallas_attention=True`` and the block unfused: the JAX step
    through the Pallas forward and backward (interpret mode), the port's
    through ``FusedAttention``'s plain versions; every step's loss and
    gradients and the final parameters held as in
    tests/test_torch_train_fused.py."""
    jlosses, tlosses, jparams, model = run_pair(4, fused=False,
                                                attention=True)
    assert all(b.attn.use_fused for b in model.backbone.model.blocks)
    assert at.LAUNCHES == 0 and at.BWD_LAUNCHES == 0
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-4, rtol=1e-4)
    assert_params_match(model, jparams)


def test_engine_serves_the_transferred_384px_model_as_jax():
    """The deployment recipe end to end at 577 tokens: a 224-px model's
    weights carried to 384 px (the JAX tree by the JAX
    ``transfer_resolution``, the port's state_dict by its own), served by
    ``InferenceEngine`` through ``fused_attention`` with a padded partial
    batch, against the JAX serving forward with the Pallas attention on the
    same weights: fp32, 2e-5 (tests/test_torch_serving.py)."""
    small = dict(KW, depth=1, image_size=224)
    params = jrk.RoViTKAN(**small).init(
        jax.random.PRNGKey(5), np.zeros((1, 224, 224, 3), np.float32))[
            "params"]
    rng = np.random.RandomState(5)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), params)
    big = dict(small, image_size=384, use_pallas_attention=True)
    jm = jrk.RoViTKAN(**big)
    images = rng.randint(0, 256, (3, 384, 384, 3)).astype(np.uint8)
    want = jax_serving(jm)(jconvert.transfer_resolution(params, 384, 16),
                           jnp.asarray(images))
    src = load_jax_params(RoViTKAN(**small), params, device="cpu")
    model = RoViTKAN(**big)
    model.load_state_dict(transfer_resolution(src.state_dict(), 384, 16))
    engine = InferenceEngine(model, batch_size=4, device="cpu")
    got = engine.predict(images)
    assert at.LAUNCHES == 0 and set(got) == set(want)
    for key, value in want.items():
        value = np.asarray(value)
        assert got[key].shape == value.shape, key
        np.testing.assert_allclose(got[key], value, atol=2e-5, rtol=0,
                                   err_msg=key)
