"""The block's backward in the port against the JAX package's.

``jax.vjp`` through the JAX ``fused_vit_block`` (its Pallas backward kernel
``_vit_block_bwd_kernel`` runs in interpret mode here) against the port's
``FusedViTBlock`` backward on the CPU, which is ``block_backward_reference``,
the plain version of the CUDA kernel #2. Same seeded numpy inputs; the JAX
weight grads are ``(in, out)``, the port's ``(out, in)``.

Tolerances, relative to the largest magnitude of each output: fp32 1e-3 (the
JAX package's own precedent for fused against XLA grads,
tests/test_block_kernel.py); bf16 1e-2 (both sides round at the same points,
so they differ only where an fp32 sum in another order crosses a bf16
rounding boundary, which moves a rounded intermediate by one ulp, 2^-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.ops.block_kernel import fused_vit_block as jax_block
from rovit_kan_tpu_torch.ops import block_kernel as bk

# The earlier shapes, then one whose last 64-row tile of the CUDA stages is
# ragged (65 tokens) at a head width other than 64 (48).
CASES = [(2, 17, 64, 2), (2, 197, 192, 3), (1, 65, 192, 4)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _inputs(shape):
    B, N, D, heads = shape
    rng = np.random.RandomState(sum(shape) + 7)

    def t(*s, scale=0.05):
        return rng.normal(0, scale, s).astype(np.float32)
    p = {"ln1_scale": 1.0 + t(D, scale=0.02), "ln1_bias": t(D, scale=0.02),
         "wqkv": t(D, 3 * D), "bqkv": t(3 * D, scale=0.02),
         "wproj": t(D, D), "bproj": t(D, scale=0.02),
         "ln2_scale": 1.0 + t(D, scale=0.02), "ln2_bias": t(D, scale=0.02),
         "w1": t(D, 4 * D), "b1": t(4 * D, scale=0.02),
         "w2": t(4 * D, D), "b2": t(D, scale=0.02)}
    x = rng.normal(0, 1, (B, N, D)).astype(np.float32)
    g = rng.normal(0, 1, (B, N, D)).astype(np.float32)
    return p, x, g


def _port_params(p, requires_grad=False):
    return {k: torch.from_numpy(np.ascontiguousarray(v.T)
                                if k in bk.WEIGHT_KEYS else v.copy())
            .requires_grad_(requires_grad) for k, v in p.items()}


def _close(got, want, rel, name):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    tol = rel * max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{name}: max |err| {err} > {tol}"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", CASES, ids=lambda s: "x".join(map(str, s)))
def test_backward_matches_jax_kernel(shape, dtype):
    jdt, tdt, rel = DTYPES[dtype]
    heads = shape[3]
    p, x, g = _inputs(shape)
    _, vjp = jax.vjp(lambda xx, pp: jax_block(xx, pp, heads),
                     jnp.asarray(x, jdt),
                     {k: jnp.asarray(v) for k, v in p.items()})
    want_dx, want = vjp(jnp.asarray(g, jdt))

    params = _port_params(p, requires_grad=True)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    bk.fused_vit_block(xt, params, heads).backward(torch.from_numpy(g).to(tdt))
    assert xt.grad.dtype == tdt
    _close(xt.grad.float().numpy(), want_dx, rel, "dx")
    for k in bk.PKEYS:
        got = params[k].grad
        assert got.dtype == torch.float32, k
        got = got.numpy().T if k in bk.WEIGHT_KEYS else got.numpy()
        _close(got, want[k], rel, k)
    assert bk.LAUNCHES == 0 and bk.BWD_LAUNCHES == 0


@pytest.mark.parametrize("shape", CASES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_is_autograd_of_the_plain_forward(shape):
    """fp32: the hand-written backward equals autograd through
    ``block_reference`` (sums in another order only)."""
    heads = shape[3]
    p, x, g = _inputs(shape)
    params = _port_params(p, requires_grad=True)
    xt = torch.from_numpy(x).requires_grad_()
    bk.block_reference(xt, params, heads).backward(torch.from_numpy(g))
    with torch.no_grad():
        dx, grads = bk.block_backward_reference(
            torch.from_numpy(x), torch.from_numpy(g), params, heads)
    _close(dx.numpy(), xt.grad.numpy(), 1e-5, "dx")
    for k in bk.PKEYS:
        _close(grads[k].numpy(), params[k].grad.numpy(), 1e-5, k)


def test_backward_launch_checks():
    """The backward wrapper's argument checks, on CPU tensors: the forward's
    checks plus an fp32 gradient of x's shape."""
    p, x, g = _inputs((2, 5, 64, 2))
    params = bk.prepare_block_params(_port_params(p), torch.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gt = torch.from_numpy(g)
    bk._check_bwd_args(xb, gt, params, 2)                 # accepted
    with pytest.raises(ValueError, match="g must be"):
        bk._check_bwd_args(xb, gt.to(torch.bfloat16), params, 2)
    with pytest.raises(ValueError, match="g must be"):
        bk._check_bwd_args(xb, gt[:, :4], params, 2)
    with pytest.raises(ValueError, match="unsupported block shape"):
        bk._check_bwd_args(xb, gt, params, 3)
    with pytest.raises(TypeError):
        bk._check_bwd_args(xb.half(), gt, params, 2)
