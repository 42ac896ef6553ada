"""The port's explainability against the JAX package's, on the CPU.

The tiny model of tests/test_explainability.py (d=32, depth 2, 2 heads,
32 px, so a 2 x 2 patch grid and 5 tokens), its JAX weights perturbed off
their init and loaded into the port by ``load_jax_params``; seeded numpy
inputs through both packages. Tolerances: ``attention_rollout`` and
``_cam_from_grads`` 1e-5; the model's ``attention`` and ``norm1_tap`` 2e-5
(fp32, also with ``use_pallas_block=True``, where the blocks before the tap
run the plain version of #1 here and the Pallas kernel in interpret mode in
JAX); the tap's gradient 1e-4 of its largest magnitude against ``jax.grad``
with respect to ``gradcam_perturbation``; the rollout and Grad-CAM++ maps
1e-4. bf16 with the fused block: the tap within 2e-2 and its gradient
within 1e-1 of their largest magnitudes (measured 0.7% and 5.3%; both
packages' bf16 gradients lie within 1e-1 of the fp32 one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.explainability.attention_maps import (
    ViTAttentionRollout as JaxRollout,
)
from rovit_kan_tpu.explainability.attention_maps import (
    attention_rollout as jax_rollout,
)
from rovit_kan_tpu.explainability.gradcam import (
    GradCAMPlusPlus as JaxGradCAM,
)
from rovit_kan_tpu.explainability.gradcam import _cam_from_grads as jax_cam
from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
from rovit_kan_tpu_torch.explainability import (
    GradCAMPlusPlus,
    ViTAttentionRollout,
    attention_rollout,
    gradcam_plus_plus,
)
from rovit_kan_tpu_torch.explainability.gradcam import (
    _cam_from_grads,
    gradcam_taps,
)
from rovit_kan_tpu_torch.models.convert import load_jax_params
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN
from rovit_kan_tpu_torch.ops import block_kernel as bk

KW = dict(embed_dim=32, depth=2, num_heads=2, image_size=32, patch_size=16,
          kan_layers=(32, 8, 1), hidden_dim=16)
N_TOKENS = 5
OUTPUTS = ("features", "cls_logits", "ordinal_logits", "mu", "log_var",
           "kan_severity")


@pytest.fixture(scope="module")
def params():
    p = jax.jit(JaxRoViTKAN(**KW).init)(
        jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))["params"]
    rng = np.random.RandomState(0)
    return jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), p)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).randn(3, 32, 32, 3).astype(np.float32)


def port_model(params, **kw):
    return load_jax_params(RoViTKAN(**KW, **kw), params, device="cpu").eval()


@pytest.fixture(scope="module")
def jax_taps(params, images):
    """``jax_taps(**model_kw)``: the JAX model's attention, tap and tap
    gradient (the summed argmax logits differentiated with respect to a
    zero perturbation), computed once per model."""
    done = {}

    def get(**kw):
        key = tuple(sorted(kw.items(), key=str))
        if key not in done:
            done[key] = _jax_taps(params, images, **kw)
        return done[key]

    return get


def _jax_taps(params, images, **kw):
    """The JAX model's attention, tap and tap gradient: ``KW`` with ``kw``
    over it (flags, or another width at 32 px)."""
    model = JaxRoViTKAN(**{**KW, **kw})

    x = jnp.asarray(images)

    def target(p):
        out = model.apply({"params": params}, x, deterministic=True,
                          gradcam_perturbation=p)
        logits = out["cls_logits"]
        idx = jnp.argmax(logits, axis=-1)
        return jnp.take_along_axis(logits, idx[:, None], -1).sum(), out

    zeros = jnp.zeros((images.shape[0], N_TOKENS, model.embed_dim))
    (_, out), grads = jax.jit(jax.value_and_grad(target, has_aux=True))(
        zeros)
    attention = jax.jit(lambda: model.apply(
        {"params": params}, x, deterministic=True,
        return_attention=True)["attention"])()
    return (np.asarray(attention, np.float32),
            np.asarray(out["norm1_tap"], np.float32),
            np.asarray(grads, np.float32))


def random_attention(seed: int, N: int = 17) -> np.ndarray:
    logits = np.random.RandomState(seed).randn(3, 2, 2, N, N)
    a = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return a.astype(np.float32)


@pytest.mark.parametrize("size", [4, 32, 2], ids=["grid", "up", "down"])
@pytest.mark.parametrize("discard", [False, True], ids=["all", "discard"])
@pytest.mark.parametrize("fusion", ["mean", "max", "min"])
def test_attention_rollout_matches_jax(fusion, discard, size):
    a = random_attention(2)                    # 16 patches: a 4 x 4 grid
    want = jax_rollout(jnp.asarray(a), head_fusion=fusion, image_size=size,
                       apply_discard=discard)
    got = attention_rollout(torch.from_numpy(a), head_fusion=fusion,
                            image_size=size, apply_discard=discard)
    assert got.shape == (2, size, size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_cam_from_grads_matches_jax():
    rng = np.random.RandomState(3)
    acts = rng.randn(2, 17, 8).astype(np.float32)
    grads = rng.randn(2, 17, 8).astype(np.float32)
    grads[1, :, :4] = 0.0                      # zero denominators
    cam = jax.jit(jax_cam, static_argnums=2)
    for size in (4, 32, 3):
        want = cam(jnp.asarray(acts), jnp.asarray(grads), size)
        got = _cam_from_grads(torch.from_numpy(acts),
                              torch.from_numpy(grads), size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
    flat = _cam_from_grads(torch.ones(1, 5, 8), torch.ones(1, 5, 8), 4)
    assert not flat.any()                      # mx == mn gives zeros


@pytest.mark.parametrize("fused_block", [False, True],
                         ids=["plain", "fused_block"])
def test_taps_and_gradient_match_jax(params, images, jax_taps,
                                     fused_block):
    attention, tap, grads = jax_taps(use_pallas_block=fused_block)
    model = port_model(params, use_pallas_block=fused_block)
    x = torch.from_numpy(images)
    with torch.no_grad():
        with_attention = model(x, return_attention=True)
        out = model(x, gradcam_perturbation=torch.zeros(3, N_TOKENS, 32))
    assert "norm1_tap" not in with_attention
    got = with_attention["attention"]
    assert got.shape == (2, 3, 2, N_TOKENS, N_TOKENS)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), attention, atol=2e-5, rtol=0)
    assert "attention" not in out
    np.testing.assert_allclose(out["norm1_tap"].numpy(), tap, atol=2e-5,
                               rtol=0)

    acts, got, idx = gradcam_taps(model, torch.from_numpy(images),
                                  torch.full((3,), -1))
    np.testing.assert_allclose(acts.numpy(), tap, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), grads,
                               atol=1e-4 * np.abs(grads).max(), rtol=0)
    assert bk.LAUNCHES == 0 and bk.BWD_LAUNCHES == 0


def test_bf16_taps_match_jax(params, images, jax_taps):
    _, tap, grads = jax_taps(dtype=jnp.bfloat16, use_pallas_block=True)
    _, _, exact = jax_taps(use_pallas_block=False)
    model = port_model(params, dtype=torch.bfloat16, use_pallas_block=True)
    acts, got, _ = gradcam_taps(model, torch.from_numpy(images),
                                torch.full((3,), -1))
    np.testing.assert_allclose(acts.numpy(), tap,
                               atol=2e-2 * np.abs(tap).max(), rtol=0)
    for g in (got.numpy(), grads):
        np.testing.assert_allclose(g, exact, atol=1e-1 * np.abs(exact).max(),
                                   rtol=0)
    np.testing.assert_allclose(got.numpy(), grads,
                               atol=1e-1 * np.abs(grads).max(), rtol=0)


@pytest.mark.parametrize("targets", [None, np.array([1, 2, 0])],
                         ids=["argmax", "given"])
def test_maps_match_jax(params, images, targets):
    jm = JaxRoViTKAN(**KW)
    model = port_model(params)
    if targets is None:
        want = JaxRollout(jm, params).generate(jnp.asarray(images))
        got = ViTAttentionRollout(model, device="cpu").generate(images)
        assert got.shape == (3, 32, 32)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    want = JaxGradCAM(jm, params).compute(jnp.asarray(images),
                                          class_idx=targets)
    got = GradCAMPlusPlus(model, device="cpu").compute(images, targets)
    assert got.shape == (3, 32, 32) and got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(
        gradcam_plus_plus(model, images, targets, device="cpu"), got)


def test_default_forward_unchanged(params, images):
    """A call without taps returns the six outputs, and the tapped call
    adds an exact zero: the same bits."""
    model = port_model(params)
    x = torch.from_numpy(images)
    with torch.no_grad():
        plain = model(x)
        tapped = model(x, return_attention=True,
                       gradcam_perturbation=torch.zeros(3, N_TOKENS, 32))
    assert set(plain) == set(OUTPUTS)
    assert set(tapped) == set(OUTPUTS) | {"attention", "norm1_tap"}
    for k in OUTPUTS:
        assert torch.equal(plain[k], tapped[k]), k


def test_gradcam_leaves_model_as_it_was(params, images):
    model = port_model(params, use_pallas_block=True).train()
    model.classification_head.eval()           # a mixed mode survives too
    modes = [m.training for m in model.modules()]
    GradCAMPlusPlus(model, device="cpu").compute(images)
    assert [m.training for m in model.modules()] == modes
    assert all(p.grad is None for p in model.parameters())
    assert all(b.use_fused_block for b in model.backbone.model.blocks)


def test_entry_points_run_on_the_card_unless_asked(params):
    model = port_model(params)
    for cls in (ViTAttentionRollout, GradCAMPlusPlus):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(model)
