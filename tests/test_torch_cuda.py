"""Port tests that need an NVIDIA GPU: the CUDA block kernel against its
plain version, and the served model through the kernel. They skip where
``torch.cuda.is_available()`` is False. This file imports neither jax nor
the JAX package, so it runs on a GPU machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: fp32 1e-4 (sums in another order); bf16 two bf16 ulps at the
largest output magnitude (both sides round at the same points, so they
differ only where an fp32 sum crosses a rounding boundary).
"""
import numpy as np
import pytest
import torch

from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN, init_weights
from rovit_kan_tpu_torch.ops import block_kernel as bk
from rovit_kan_tpu_torch.serving import InferenceEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(rng, D, hidden, dtype, device):
    def t(*shape, scale=0.05, center=0.0):
        return torch.tensor(center + rng.normal(0, scale, shape),
                            dtype=torch.float32)
    raw = {"ln1_scale": t(D, scale=0.02, center=1.0),
           "ln1_bias": t(D, scale=0.02), "wqkv": t(3 * D, D),
           "bqkv": t(3 * D, scale=0.02), "wproj": t(D, D),
           "bproj": t(D, scale=0.02),
           "ln2_scale": t(D, scale=0.02, center=1.0),
           "ln2_bias": t(D, scale=0.02), "w1": t(hidden, D),
           "b1": t(hidden, scale=0.02), "w2": t(D, hidden),
           "b2": t(D, scale=0.02)}
    return bk.prepare_block_params({k: v.to(device) for k, v in raw.items()},
                                   dtype)


def _tol(ref, dtype):
    if dtype == torch.float32:
        return 1e-4
    top = float(ref.float().abs().max())
    return 2.0 * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(3, 37, 64, 2), (2, 197, 192, 3),
                                   (1, 5, 128, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, shape, dtype):
    B, N, D, heads = shape
    rng = np.random.RandomState(sum(shape))
    p = _params(rng, D, 4 * D, dtype, cuda)
    x = torch.tensor(rng.normal(0, 1, (B, N, D)), dtype=torch.float32)
    x = x.to(cuda, dtype)
    before = bk.LAUNCHES
    with torch.inference_mode():
        got = bk.fused_vit_block(x, p, heads)
        want = bk.block_reference(x, p, heads)
    torch.cuda.synchronize()
    assert bk.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= _tol(want, dtype), err


def test_kernel_refuses_what_it_does_not_take(cuda):
    rng = np.random.RandomState(0)
    p = _params(rng, 64, 256, torch.bfloat16, cuda)
    x = torch.zeros(2, 5, 64, dtype=torch.bfloat16, device=cuda)
    with torch.inference_mode():
        with pytest.raises(ValueError):
            bk.fused_vit_block(x, p, 3)                  # 64 % 3
        with pytest.raises(ValueError):
            bk.fused_vit_block(x.float(), p, 2)          # bf16 weights
    with pytest.raises(NotImplementedError):
        bk.fused_vit_block(x.float().requires_grad_(),
                           _params(rng, 64, 256, torch.float32, cuda), 2)


def test_served_model_through_the_kernel(cuda):
    kw = dict(embed_dim=64, depth=2, num_heads=2, image_size=32,
              kan_layers=(64, 8, 1), hidden_dim=16, dtype=torch.bfloat16,
              use_pallas_block=True)
    model = RoViTKAN(**kw)
    init_weights(model, seed=0)
    engine = InferenceEngine(model, batch_size=8, device="cuda")
    imgs = np.random.RandomState(1).randint(0, 256, (5, 32, 32, 3)).astype(
        np.uint8)
    before = bk.LAUNCHES
    served = engine.predict(imgs)
    assert bk.LAUNCHES == before + 2                    # one per block
    for blk in model.backbone.model.blocks:
        blk.block_fn = bk.block_reference
    plain = engine.predict(imgs)
    for k, v in served.items():
        assert v.shape == plain[k].shape and np.isfinite(v).all()
    np.testing.assert_allclose(served["cls_probs"].sum(-1), 1.0, atol=1e-5)
    # Two blocks of bf16 noise at d=64; the outputs stay close.
    np.testing.assert_allclose(served["cls_probs"], plain["cls_probs"],
                               atol=2e-2)
