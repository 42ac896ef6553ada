"""The port's KAN kernels' plain versions (#8-#11) and the KAN slice against
the JAX package.

Seeded numpy inputs go through the JAX functions (the Pallas kernels in
interpret mode, as tests/test_spline.py runs them) and through the port's
``fused_kan_layer`` / ``fused_kan_module``, which run their plain versions
on CPU tensors, forward and under autograd (the hand-written backward).
Tolerances are tests/test_spline.py's: values rtol 1e-4 / atol 1e-5,
gradients atol 1e-4. TF32 is off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.models.kan import KANSeverityModule as JaxKAN
from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
from rovit_kan_tpu.ops.kan_kernel import fused_kan_layer as jax_layer
from rovit_kan_tpu.ops.kan_kernel import fused_kan_module as jax_module
from rovit_kan_tpu.ops.spline import (
    bspline_basis_and_deriv_list as jax_basis_and_deriv,
)
from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.models.convert import load_jax_params
from rovit_kan_tpu_torch.models.kan import KANSeverityModule
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN, build_model
from rovit_kan_tpu_torch.ops import kan_kernel as kk
from rovit_kan_tpu_torch.ops.spline import (
    bspline_basis_and_deriv_list,
    make_knots,
)
from test_torch_train_step import assert_params_match, run_pair

torch.backends.cuda.matmul.allow_tf32 = False
KNOTS = make_knots(5, 3)
VALUES = dict(rtol=1e-4, atol=1e-5)
GRADS = dict(rtol=0, atol=1e-4)


def _np(t):
    return t.detach().numpy()


def knot_inputs():
    """For each interior knot, the float32 nearest atanh(knot) on which
    jnp.tanh and torch.tanh agree bit for bit (on the knot itself where
    such an input exists): both sides then see the same t at the knot, where
    the truncated basis may jump."""
    out = []
    for kv in KNOTS[1:-1]:
        x0 = np.float32(np.arctanh(np.float64(kv)))
        cands = [x0]
        up = down = x0
        for _ in range(16):
            up = np.nextafter(up, np.float32(9))
            down = np.nextafter(down, np.float32(-9))
            cands += [up, down]
        c = np.asarray(cands, np.float32)
        tj = np.asarray(jnp.tanh(jnp.asarray(c)))
        tt = torch.tanh(torch.from_numpy(c)).numpy()
        agree = np.nonzero(tj == tt)[0]
        on = [i for i in agree if tt[i] == kv]
        out.append(c[on[0] if on else agree[0]])
    return np.asarray(out, np.float32)


def test_basis_and_deriv_matches_jax():
    rng = np.random.RandomState(0)
    t = np.concatenate([rng.uniform(-1.2, 1.2, 196), KNOTS,
                        [-1.5, 1.5, np.nextafter(np.float32(1), 0)]]
                       ).astype(np.float32).reshape(-1, 7)
    jb, jdb = jax_basis_and_deriv(jnp.asarray(t), KNOTS, 3)
    tb, tdb = bspline_basis_and_deriv_list(torch.from_numpy(t), KNOTS, 3)
    assert len(tb) == len(jb) == 7
    for a, b in zip(tb + tdb, jb + jdb):
        np.testing.assert_allclose(_np(a), np.asarray(b), **VALUES)
    # Outside the knot range the clamp's VJP zeroes every derivative.
    assert all(float(d.flatten()[-3:-1].abs().max()) == 0 for d in tdb)


def _layer_inputs(rng, B, fin, fout):
    x = rng.randn(B, fin).astype(np.float32)
    s = (0.1 * rng.randn(fin, fout, 7)).astype(np.float32)
    wl = (0.1 * rng.randn(fin, fout)).astype(np.float32)     # JAX (in, out)
    b = rng.randn(fout).astype(np.float32)
    return x, s, wl, b


def _leaves(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
            for a in arrays]


@pytest.mark.parametrize("B,fin,fout", [(4, 192, 64), (3, 16, 1)])
def test_layer_matches_jax_fused_layer(B, fin, fout):
    """#8/#9's plain versions against the Pallas layer and its VJP."""
    rng = np.random.RandomState(2)
    x, s, wl, b = _layer_inputs(rng, B, fin, fout)
    g = rng.randn(B, fout).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: jax_layer(*a, KNOTS), jnp.asarray(x),
                        jnp.asarray(s), jnp.asarray(wl), jnp.asarray(b))
    jdx, jds, jdw, jdb = vjp(jnp.asarray(g))

    tx, ts, tw, tb = _leaves(x, s, wl.T, b)
    got = kk.fused_kan_layer(tx, ts, tw, tb, KNOTS)
    np.testing.assert_allclose(_np(got), np.asarray(want), **VALUES)
    got.backward(torch.from_numpy(g))
    for a, ref in ((tx.grad, jdx), (ts.grad, jds), (tw.grad.t(), jdw),
                   (tb.grad, jdb)):
        np.testing.assert_allclose(_np(a), np.asarray(ref), **GRADS)
    # The plain versions called directly give the same values.
    ref = kk.kan_layer_backward_reference(tx.detach(), torch.from_numpy(g),
                                          ts.detach(), tw.detach(), KNOTS)
    for a, b2 in zip(ref, (tx.grad, ts.grad, tw.grad, tb.grad)):
        assert torch.equal(a, b2)
    assert (kk.LAYER_LAUNCHES, kk.LAYER_BWD_LAUNCHES) == (0, 0)


def _module_inputs(dims, case, B=10):
    rng = np.random.RandomState(len(dims) * 10 + len(case))
    x = rng.randn(B, dims[0]).astype(np.float32)
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        params += [(0.3 * rng.randn(a, b, 7)).astype(np.float32),
                   (rng.randn(a, b) / np.sqrt(a)).astype(np.float32),
                   (0.1 * rng.randn(b)).astype(np.float32)]
    if case == "saturated":              # tanh gives exactly +-1
        x[:, ::2] = np.sign(x[:, ::2]) * (10.0 + np.abs(x[:, ::2]))
    elif case == "knots":                # t on (or next to) every knot
        k = knot_inputs()
        x.reshape(-1)[:x.size // k.size * k.size] = np.resize(
            k, x.size // k.size * k.size)
    elif case == "zero_layer":           # layer 0's pre-activation is 0
        for p in params[0:3]:
            p[...] = 0.0
    return x, params, rng.randn(B, dims[-1]).astype(np.float32)


@pytest.mark.parametrize("case", ["normal", "saturated", "knots",
                                  "zero_layer"])
@pytest.mark.parametrize("dims", [(24, 8, 1), (32, 16, 4, 1)],
                         ids=lambda d: "-".join(map(str, d)))
def test_module_matches_jax_fused_module(dims, case):
    """#10/#11's plain versions against the Pallas module and its VJP."""
    x, params, g = _module_inputs(dims, case)
    want, vjp = jax.vjp(
        lambda xx, *p: jax_module(xx, tuple(p), dims, KNOTS),
        jnp.asarray(x), *map(jnp.asarray, params))
    jgrads = vjp(jnp.asarray(g))

    torch_params = [p.T if i % 3 == 1 else p for i, p in enumerate(params)]
    tx, *tp = _leaves(x, *torch_params)
    got = kk.fused_kan_module(tx, tp, KNOTS)
    np.testing.assert_allclose(_np(got), np.asarray(want), **VALUES)
    assert float(got.detach().min()) >= 0.0
    assert float(got.detach().max()) <= 3.0
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jgrads[0]), **GRADS)
    for i, (p, ref) in enumerate(zip(tp, jgrads[1:])):
        a = p.grad.t() if i % 3 == 1 else p.grad
        np.testing.assert_allclose(_np(a), np.asarray(ref), **GRADS,
                                   err_msg=f"param {i}")
    if case == "zero_layer":            # relu'(0) = 0: nothing reaches layer 0
        assert not tx.grad.any()
        assert not any(p.grad.any() for p in tp[:3])
    assert (kk.LAUNCHES, kk.BWD_LAUNCHES) == (0, 0)


def test_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros(3, 24)
    params = [torch.zeros(24, 8, 7), torch.zeros(8, 24), torch.zeros(8)]
    with pytest.raises(TypeError):
        kk.fused_kan_module(x.double(), params, KNOTS)
    with pytest.raises(TypeError):
        kk.fused_kan_layer(x.bfloat16(), *params, KNOTS)
    with pytest.raises(ValueError):
        kk.fused_kan_module(x.to("meta"), [p.to("meta") for p in params],
                            KNOTS)


def _jax_kan_params(dims, seed=0):
    kan = JaxKAN(dims, use_pallas=False)
    x = np.zeros((1, dims[0]), np.float32)
    params = kan.init(jax.random.PRNGKey(seed), x)["params"]
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), params)


def load_kan(module: KANSeverityModule, params) -> KANSeverityModule:
    with torch.no_grad():
        for i, layer in enumerate(module.kan_layers):
            p = params[f"kan_layers_{i}"]
            layer.spline_weights.copy_(torch.from_numpy(
                np.asarray(p["spline_weights"])))
            layer.linear.weight.copy_(torch.from_numpy(
                np.asarray(p["kernel"]).T))
            layer.linear.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
    return module


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "kernel"])
def test_activation_trajectory_matches_jax(fused):
    dims = (16, 8, 1)
    params = _jax_kan_params(dims)
    x = np.random.RandomState(5).randn(4, 16).astype(np.float32)
    want = JaxKAN(dims, use_pallas=fused).apply(
        {"params": params}, jnp.asarray(x),
        method=JaxKAN.activation_trajectory)
    kan = load_kan(KANSeverityModule(dims, use_fused=fused), params)
    got = kan.activation_trajectory(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), **VALUES)
    assert kk.LAYER_LAUNCHES == 0


KW = dict(embed_dim=32, depth=2, num_heads=2, image_size=32, patch_size=16,
          kan_layers=(32, 8, 1), hidden_dim=16)


def test_model_with_kan_kernel_matches_jax():
    """The whole model with ``use_pallas_kan`` against the JAX model with the
    same flag, forward, in fp32 (2e-5, the model tests' precedent)."""
    jm = JaxRoViTKAN(**KW, use_pallas_kan=True)
    params = jm.init(jax.random.PRNGKey(0),
                     np.zeros((1, 32, 32, 3), np.float32))["params"]
    images = np.random.RandomState(1).normal(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    want = jm.apply({"params": params}, jnp.asarray(images),
                    deterministic=True)
    model = load_jax_params(RoViTKAN(**KW, use_pallas_kan=True), params,
                            device="cpu").eval()
    assert model.kan_module.use_fused
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=2e-5, rtol=0, err_msg=k)
    assert kk.LAUNCHES == 0


def test_build_model_takes_the_kan_flag():
    cfg = Config()
    cfg.model.embed_dim, cfg.model.depth, cfg.model.num_heads = 32, 1, 2
    cfg.model.kan_layers = [32, 8, 1]
    cfg.data.image_size = 32
    cfg.tpu.use_pallas_kan = True
    model = build_model(cfg, device="cpu")
    assert model.kan_module.use_fused
    assert all(layer.use_fused for layer in model.kan_module.kan_layers)
    cfg.tpu.use_pallas_kan = False
    assert not build_model(cfg, device="cpu").kan_module.use_fused


def test_train_steps_with_kan_kernel_match_jax():
    """Four steps over stages 1-4 through the KAN kernels' plain versions
    against the JAX step through the Pallas KAN kernels (interpret mode):
    at stage 4 the KAN loss is live, so #11's gradients reach the update.
    Per-step loss 1e-4 and gradients (run_pair), final params 2e-5."""
    jlosses, tlosses, jparams, model = run_pair(4, fused=False, kan=True)
    assert model.kan_module.use_fused
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-4, rtol=1e-4)
    assert_params_match(model, jparams)
