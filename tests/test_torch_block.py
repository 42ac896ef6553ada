"""The port's block (plain version on the CPU) against the JAX package's
fused_vit_block, whose Pallas kernel runs in interpret mode here.

Same seeded numpy inputs on both sides; the JAX weights are (in, out), the
port's (out, in). Tolerances: fp32 1e-4 (the JAX kernel's own fp32 precedent
against XLA is 2e-4, tests/test_block_kernel.py), bf16 5e-2 (its bf16
precedent): both sides round at the same points, so bf16 differs only where
an fp32 sum in another order crosses a rounding boundary.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.ops.block_kernel import fused_vit_block as jax_block
from rovit_kan_tpu_torch.ops import block_kernel as bk

CASES = [(2, 17, 64, 2), (2, 197, 192, 3)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4, 0.0),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2, 5e-2)}


def _jax_params(rng, D, hidden):
    def t(*shape, scale=0.05):
        return rng.normal(0, scale, shape).astype(np.float32)
    return {"ln1_scale": 1.0 + t(D, scale=0.02), "ln1_bias": t(D, scale=0.02),
            "wqkv": t(D, 3 * D), "bqkv": t(3 * D, scale=0.02),
            "wproj": t(D, D), "bproj": t(D, scale=0.02),
            "ln2_scale": 1.0 + t(D, scale=0.02), "ln2_bias": t(D, scale=0.02),
            "w1": t(D, hidden), "b1": t(hidden, scale=0.02),
            "w2": t(hidden, D), "b2": t(D, scale=0.02)}


def _torch_params(p, dtype):
    return bk.prepare_block_params(
        {k: torch.from_numpy(np.ascontiguousarray(v.T) if k in bk.WEIGHT_KEYS
                             else v) for k, v in p.items()}, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", CASES, ids=lambda s: "x".join(map(str, s)))
def test_cpu_block_matches_jax_kernel(shape, dtype):
    B, N, D, heads = shape
    jdt, tdt, atol, rtol = DTYPES[dtype]
    rng = np.random.RandomState(sum(shape))
    p = _jax_params(rng, D, 4 * D)
    x = rng.normal(0, 1, (B, N, D)).astype(np.float32)
    want = np.asarray(jax_block(jnp.asarray(x, jdt),
                                {k: jnp.asarray(v) for k, v in p.items()},
                                heads), np.float32)
    got = bk.fused_vit_block(torch.from_numpy(x).to(tdt),
                             _torch_params(p, tdt), heads)
    assert got.dtype == tdt and got.shape == (B, N, D)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=rtol)
    assert bk.LAUNCHES == 0          # the CPU path never counts a launch


def test_cpu_path_takes_unprepared_params():
    """On the CPU the plain version casts fp32 weights itself."""
    rng = np.random.RandomState(5)
    p = _jax_params(rng, 64, 256)
    x = torch.from_numpy(rng.normal(0, 1, (1, 9, 64)).astype(np.float32))
    raw = {k: torch.from_numpy(np.ascontiguousarray(v.T)
                               if k in bk.WEIGHT_KEYS else v)
           for k, v in p.items()}
    for dtype in (torch.float32, torch.bfloat16):
        a = bk.fused_vit_block(x.to(dtype), raw, 2)
        b = bk.fused_vit_block(x.to(dtype), _torch_params(p, dtype), 2)
        assert torch.equal(a, b)


def test_launch_checks_reject_what_the_kernel_does_not_take():
    """The argument checks the wrapper runs before a launch (exercised here
    on CPU tensors; on the card they guard the kernel)."""
    rng = np.random.RandomState(6)
    p = _torch_params(_jax_params(rng, 64, 256), torch.bfloat16)
    x = torch.zeros(2, 5, 64, dtype=torch.bfloat16)
    bk._check_cuda_args(x, p, 2)                         # accepted
    with pytest.raises(ValueError, match="unsupported block shape"):
        bk._check_cuda_args(x, p, 3)                     # 64 % 3
    with pytest.raises(ValueError, match="prepare_block_params"):
        bk._check_cuda_args(x.float(), p, 2)             # bf16 weights
    with pytest.raises(TypeError):
        bk._check_cuda_args(x.half(), p, 2)
    with pytest.raises(ValueError, match="contiguous"):
        bk._check_cuda_args(x.transpose(0, 1), p, 2)
    # Under autograd the block runs and its grads come from the backward's
    # plain version (the kernel's counterpart on the card).
    p32 = {k: v.clone().requires_grad_() for k, v in
           _torch_params(_jax_params(rng, 64, 256), torch.float32).items()}
    x32 = torch.from_numpy(rng.normal(0, 1, (2, 5, 64)).astype(
        np.float32)).requires_grad_()
    bk._check_cuda_args(x32, p32, 2)                     # accepted too
    g = torch.from_numpy(rng.normal(0, 1, (2, 5, 64)).astype(np.float32))
    bk.fused_vit_block(x32, p32, 2).backward(g)
    dx, grads = bk.block_backward_reference(x32.detach(), g, p32, 2)
    assert torch.equal(x32.grad, dx)
    for k in bk.PKEYS:
        assert torch.equal(p32[k].grad, grads[k]), k
