"""The saved-residual block pair in the port against the JAX package's.

``_fused_block_res_impl`` and ``_fused_block_bwd_res_impl`` (the Pallas
kernels ``_vit_block_res_kernel`` / ``_vit_block_bwd_res_kernel``, in
interpret mode here) against the plain versions of the port's kernels #3 and
#4, ``block_residual_reference`` and ``block_backward_residual_reference``;
then ``FusedViTBlock`` and four train steps with ``ROVIT_BLOCK_RESIDUAL_BWD=1``
against ``jax.grad`` and the JAX train step with the same opt-in. Same seeded
numpy inputs; the JAX weights are ``(in, out)``, the port's ``(out, in)``;
the JAX residuals carry 8-row token padding, so they compare ``[:, :N]``.

Tolerances: the forward's as tests/test_torch_block.py (fp32 1e-4, bf16
5e-2), the residuals within the same; the backward's as
tests/test_torch_block_bwd.py, relative to each output's largest magnitude
(fp32 1e-3, bf16 1e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rovit_kan_tpu.ops.block_kernel as jbk
from rovit_kan_tpu_torch.ops import block_kernel as bk
from test_torch_block_bwd import CASES, _close, _inputs, _port_params

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4, 0.0, 1e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2, 5e-2, 1e-2)}
ids = dict(ids=lambda s: "x".join(map(str, s)))


def _jax_residuals(p, x, jdt, heads):
    return jbk._fused_block_res_impl(
        jnp.asarray(x, jdt), *(jnp.asarray(p[k]) for k in jbk._PKEYS),
        heads=heads, interpret=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", CASES, **ids)
def test_residual_forward_matches_jax_kernel(shape, dtype):
    jdt, tdt, atol, rtol, _ = DTYPES[dtype]
    B, N, D, heads = shape
    p, x, _ = _inputs(shape)
    want = [np.asarray(t, np.float32)[:, :N]
            for t in _jax_residuals(p, x, jdt, heads)]
    got = bk.block_residual_reference(
        torch.from_numpy(x).to(tdt),
        bk.prepare_block_params(_port_params(p), tdt), heads)
    for name, g, w, width in zip(("out", "qkv", "attn", "a1"), got, want,
                                 (D, 3 * D, D, 4 * D)):
        assert g.dtype == tdt and g.shape == (B, N, width), name
        np.testing.assert_allclose(g.float().numpy(), w, atol=atol,
                                   rtol=rtol, err_msg=name)
    # #3's output is #1's.
    assert torch.equal(got[0], bk.block_reference(
        torch.from_numpy(x).to(tdt),
        bk.prepare_block_params(_port_params(p), tdt), heads))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", CASES, **ids)
def test_residual_backward_matches_jax_kernel(shape, dtype):
    """Both backwards read the same residuals: the JAX forward's."""
    jdt, tdt, _, _, rel = DTYPES[dtype]
    B, N, D, heads = shape
    p, x, g = _inputs(shape)
    _, qkv, attn, a1 = _jax_residuals(p, x, jdt, heads)
    want_dx, want = jbk._fused_block_bwd_res_impl(
        jnp.asarray(x, jdt), jnp.asarray(g), qkv, attn, a1,
        *(jnp.asarray(p[k]) for k in jbk._PKEYS), heads=heads,
        interpret=True)

    def port(t):
        return torch.from_numpy(np.array(t, np.float32)[:, :N].copy()).to(tdt)

    dx, grads = bk.block_backward_residual_reference(
        torch.from_numpy(x).to(tdt), torch.from_numpy(g), port(qkv),
        port(attn), port(a1), bk.prepare_block_params(_port_params(p), tdt),
        heads)
    assert dx.dtype == tdt
    _close(dx.float().numpy(), want_dx, rel, "dx")
    for k in bk.PKEYS:
        assert grads[k].dtype == torch.float32, k
        got = grads[k].numpy()
        _close(got.T if k in bk.WEIGHT_KEYS else got, want[k], rel, k)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_with_residual_opt_in_matches_jax_grad(monkeypatch, dtype):
    """``FusedViTBlock`` with the env var set takes the residual pair (its
    plain versions on the CPU) and its grads match ``jax.grad`` through the
    JAX block with the same opt-in, set before the JAX step is traced."""
    jdt, tdt, _, _, rel = DTYPES[dtype]
    shape = CASES[0]
    heads = shape[3]
    p, x, g = _inputs(shape)
    monkeypatch.setenv("ROVIT_BLOCK_RESIDUAL_BWD", "1")
    traced = []
    real_jax_bwd = jbk._fused_block_bwd_res_impl
    monkeypatch.setattr(jbk, "_fused_block_bwd_res_impl",
                        lambda *a, **k: traced.append(1) or
                        real_jax_bwd(*a, **k))

    def loss(xx, pp):
        out = jbk.fused_vit_block(xx, pp, heads).astype(jnp.float32)
        return jnp.sum(out * jnp.asarray(g))

    want_dx, want = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x, jdt), {k: jnp.asarray(v) for k, v in p.items()})
    assert traced

    calls = []
    real = bk.block_backward_residual_reference
    monkeypatch.setattr(bk, "block_backward_residual_reference",
                        lambda *a: calls.append(1) or real(*a))
    params = _port_params(p, requires_grad=True)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    (bk.fused_vit_block(xt, params, heads).float()
     * torch.from_numpy(g)).sum().backward()
    assert calls == [1]
    _close(xt.grad.float().numpy(), want_dx, rel, "dx")
    for k in bk.PKEYS:
        got = params[k].grad.numpy()
        _close(got.T if k in bk.WEIGHT_KEYS else got, want[k], rel, k)
    assert bk.RES_LAUNCHES == 0 and bk.BWD_RES_LAUNCHES == 0


def test_residual_opt_in_is_read_at_each_forward(monkeypatch):
    """The env var is read each time the forward runs; without grad the
    block never saves residuals (inference keeps #1)."""
    p, x, g = _inputs((1, 9, 64, 2))
    params = _port_params(p, requires_grad=True)
    saved = []
    real = bk.block_residual_reference
    monkeypatch.setattr(bk, "block_residual_reference",
                        lambda *a: saved.append(1) or real(*a))
    xt = torch.from_numpy(x)
    bk.fused_vit_block(xt, params, 2).sum().backward()
    assert saved == []
    monkeypatch.setenv("ROVIT_BLOCK_RESIDUAL_BWD", "1")
    with torch.no_grad():
        bk.fused_vit_block(xt, params, 2)
    assert saved == []
    bk.fused_vit_block(xt, params, 2).sum().backward()
    assert saved == [1]


def test_residual_launch_checks():
    """#4's wrapper checks the residuals before a launch (here on CPU
    tensors): shapes ``(B, N, 3D)``, ``(B, N, D)``, ``(B, N, H)`` in x's
    dtype, contiguous."""
    B, N, D = 2, 5, 64
    x = torch.zeros(B, N, D, dtype=torch.bfloat16)
    res = [torch.zeros(B, N, w, dtype=torch.bfloat16)
           for w in (3 * D, D, 4 * D)]
    bk._check_residuals(x, *res, 4 * D)                  # accepted
    with pytest.raises(ValueError, match="qkv must be"):
        bk._check_residuals(x, res[0].float(), *res[1:], 4 * D)
    with pytest.raises(ValueError, match="attn must be"):
        bk._check_residuals(x, res[0], res[1][:, :4], res[2], 4 * D)
    with pytest.raises(ValueError, match="a1 must be"):
        bk._check_residuals(x, *res[:2], res[2].transpose(0, 1), 4 * D)


def test_train_steps_with_residual_opt_in_match_jax(monkeypatch):
    """Four fused fp32 train steps over stages 1-4 with the opt-in on both
    sides (tests/test_torch_train_fused.py's pair): per-step loss 1e-4,
    every step's gradients 1e-3 of each parameter's largest magnitude,
    final parameters 2e-5; both sides through their residual backward."""
    from test_torch_train_step import assert_params_match, run_pair
    monkeypatch.setenv("ROVIT_BLOCK_RESIDUAL_BWD", "1")
    traced, calls = [], []
    real_jax_bwd = jbk._fused_block_bwd_res_impl
    monkeypatch.setattr(jbk, "_fused_block_bwd_res_impl",
                        lambda *a, **k: traced.append(1) or
                        real_jax_bwd(*a, **k))
    real = bk.block_backward_residual_reference
    monkeypatch.setattr(bk, "block_backward_residual_reference",
                        lambda *a: calls.append(1) or real(*a))
    jlosses, tlosses, jparams, model = run_pair(4, fused=True)
    assert traced and len(calls) == 4 * len(model.backbone.model.blocks)
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-4, rtol=1e-4)
    assert_params_match(model, jparams)
