"""The port's augmentation against the JAX package's.

The factors come from the JAX package's ``_draw_factors`` (the key splits
both JAX paths draw with) and go to both sides, so outputs compare image for
image. Tolerances: fp32 compute against the JAX kernel (interpret mode) and
against the JAX fp32 chain ``augment_batch``, 2e-5 (the JAX package's own
precedent, tests/test_augment_kernel.py); bf16 compute against the JAX bf16
kernel, stated below from the rounding points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.ops import preprocess as jax_pre
from rovit_kan_tpu.ops.augment_kernel import _draw_factors
from rovit_kan_tpu.ops.augment_kernel import \
    fused_augment_batch as jax_fused_augment
from rovit_kan_tpu_torch.ops import augment_kernel as ak
from rovit_kan_tpu_torch.ops import preprocess as pre

B, H, W = 4, 32, 32


def _case(seed):
    key = jax.random.PRNGKey(seed)
    imgs = np.random.RandomState(seed).randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)
    factors = np.array(_draw_factors(key, B, 0.2, 0.2, 0.2))
    return key, imgs, factors


@pytest.mark.parametrize("seed", [3, 11])
def test_fp32_matches_jax_kernel_and_chain(seed):
    key, imgs, factors = _case(seed)
    want_kernel = np.asarray(jax_fused_augment(
        key, jnp.asarray(imgs), compute_dtype=jnp.float32, interpret=True))
    want_chain = np.asarray(jax_pre.augment_batch(key, jnp.asarray(imgs)))
    u8, f = torch.from_numpy(imgs), torch.from_numpy(factors)
    got_kernel = ak.fused_augment_batch(u8, f, compute_dtype=torch.float32)
    got_chain = pre.augment_batch(u8, f)
    assert got_kernel.dtype == torch.float32 and ak.LAUNCHES == 0
    np.testing.assert_allclose(got_kernel.numpy(), want_kernel, atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got_chain.numpy(), want_chain, atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got_kernel.numpy(), got_chain.numpy(),
                               atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", [4, 5])
def test_bf16_matches_jax_kernel(seed):
    """bf16 compute: both round at the same points. The JAX kernel's flips
    and grayscale are matmuls with fp32 accumulation and its pivot an fp32
    sum in another order, so a value can land one bf16 ulp of [0, 1] (2^-8)
    away at each of the three rounded blends: 3 * 2^-8 / 0.224 (the smallest
    std) = 0.0523, tighter than the JAX package's own 0.08 against fp32."""
    key, imgs, factors = _case(seed)
    want = np.asarray(jax_fused_augment(key, jnp.asarray(imgs),
                                        interpret=True))
    got = ak.fused_augment_batch(torch.from_numpy(imgs),
                                 torch.from_numpy(factors))
    np.testing.assert_allclose(got.numpy(), want, atol=3 * 2.0 ** -8 / 0.224)


def test_bf16_output_and_flips():
    _, imgs, factors = _case(6)
    img = np.zeros_like(imgs)
    img[:, 2, 3, :] = 255                         # one bright pixel
    factors[:, :2] = [[0, 0], [1, 0], [0, 1], [1, 1]]
    out = ak.fused_augment_batch(torch.from_numpy(img),
                                 torch.from_numpy(factors),
                                 out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (B, H, W, 3)
    for b, (fh, fv) in enumerate(factors[:, :2]):
        y, x = np.unravel_index(int(out[b].float().sum(-1).argmax()), (H, W))
        assert (y, x) == (H - 1 - 2 if fv else 2, W - 1 - 3 if fh else 3)


def test_draw_factors_layout():
    f = ak.draw_factors(torch.Generator().manual_seed(0), 1000)
    assert f.shape == (1000, 8) and f.dtype == torch.float32
    assert set(np.unique(f[:, :2].numpy())) == {0.0, 1.0}
    assert 0.4 < float(f[:, 0].mean()) < 0.6
    jit = f[:, 2:5]
    assert float(jit.min()) >= 0.8 and float(jit.max()) <= 1.2
    assert not f[:, 5:].any()
    again = ak.draw_factors(torch.Generator().manual_seed(0), 1000)
    assert torch.equal(f, again)


def test_augment_launch_checks():
    """The augment wrapper's argument checks, on CPU tensors."""
    u8 = torch.zeros(2, 8, 8, 3, dtype=torch.uint8)
    f = torch.zeros(2, 8)
    ak._check_cuda_args(u8, f, torch.bfloat16, torch.float32)   # accepted
    with pytest.raises(ValueError, match="uint8"):
        ak._check_cuda_args(u8.float(), f, torch.bfloat16, torch.float32)
    with pytest.raises(ValueError, match="uint8"):
        ak._check_cuda_args(u8[..., :2].contiguous(), f, torch.bfloat16,
                            torch.float32)
    with pytest.raises(ValueError, match="factors"):
        ak._check_cuda_args(u8, f[:1], torch.bfloat16, torch.float32)
    with pytest.raises(ValueError, match="factors"):
        ak._check_cuda_args(u8, f.double(), torch.bfloat16, torch.float32)
    with pytest.raises(TypeError):
        ak._check_cuda_args(u8, f, torch.float16, torch.float32)
