"""Port tests that need an NVIDIA GPU: the CUDA kernels (block forward #1,
block backward #2, attention forward #5 and backward #6, augment #7, the KAN
kernels #8-#11) against their plain versions, the served model through the
block kernel, and small train steps through #1, #2 and #7 and through #5,
#6 and #7. They skip where
``torch.cuda.is_available()`` is False. This file imports neither jax nor
the JAX package, so it runs on a GPU machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: fp32 1e-4 (sums in another order); bf16 two bf16 ulps at the
largest output magnitude (both sides round at the same points, so they
differ only where an fp32 sum crosses a rounding boundary). The backward's
and the augment's tolerances are stated beside their tests.
"""
import numpy as np
import pytest
import torch

from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN, init_weights
from rovit_kan_tpu_torch.ops import attention as at
from rovit_kan_tpu_torch.ops import augment_kernel as ak
from rovit_kan_tpu_torch.ops import block_kernel as bk
from rovit_kan_tpu_torch.ops import kan_kernel as kk
from rovit_kan_tpu_torch.ops.mixing import draw_mix
from rovit_kan_tpu_torch.ops.spline import make_knots
from rovit_kan_tpu_torch.serving import InferenceEngine
from rovit_kan_tpu_torch.training.optimizer import build_optimizer
from rovit_kan_tpu_torch.training.trainer import make_train_step

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
                                   (1, 5, 128, 4), (2, 577, 192, 3),
                                   (1, 1024, 128, 2)],
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
    # Under autograd the block runs both kernels and the grads reach the
    # fp32 parameters.
    p32 = {k: v.clone().requires_grad_()
           for k, v in _params(rng, 64, 256, torch.float32, cuda).items()}
    x32 = torch.tensor(rng.normal(0, 1, (2, 5, 64)), dtype=torch.float32,
                       device=cuda, requires_grad=True)
    g = torch.tensor(rng.normal(0, 1, (2, 5, 64)), dtype=torch.float32,
                     device=cuda)
    fwd, bwd = bk.LAUNCHES, bk.BWD_LAUNCHES
    bk.fused_vit_block(x32, p32, 2).backward(g)
    torch.cuda.synchronize()
    assert (bk.LAUNCHES, bk.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    with torch.no_grad():
        dx, grads = bk.block_backward_reference(x32.detach(), g, p32, 2)
    _assert_grads(x32.grad, {k: p32[k].grad for k in bk.PKEYS}, dx, grads,
                  torch.float32)


def _bwd_tol(ref, dtype):
    """Backward tolerance relative to the largest magnitude of each output:
    fp32 1e-4 (sums in another order, over up to B*N rows); bf16 1e-2, since
    a rounding boundary crossed by an fp32 sum in another order moves one
    rounded intermediate (da1, dx1, dO, dS, dqkv) by one bf16 ulp (2^-8 of
    it), and that ulp then enters the sums over rows."""
    top = float(ref.float().abs().max())
    return (1e-4 if dtype == torch.float32 else 1e-2) * max(top, 1e-6)


def _assert_grads(dx, grads, want_dx, want_grads, dtype):
    pairs = [("dx", dx, want_dx)] + [(k, grads[k], want_grads[k])
                                     for k in bk.PKEYS]
    for name, got, want in pairs:
        assert got.shape == want.shape, name
        assert torch.isfinite(got.float()).all(), name
        err = float((got.float() - want.float()).abs().max())
        assert err <= _bwd_tol(want, dtype), (name, err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(3, 37, 64, 2), (2, 197, 192, 3),
                                   (1, 5, 128, 4), (2, 577, 192, 3),
                                   (1, 1024, 128, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_backward_kernel_matches_plain(cuda, shape, dtype):
    B, N, D, heads = shape
    rng = np.random.RandomState(sum(shape) + 1)
    p = _params(rng, D, 4 * D, dtype, cuda)
    x = torch.tensor(rng.normal(0, 1, (B, N, D)), dtype=torch.float32)
    x = x.to(cuda, dtype)
    g = torch.tensor(rng.normal(0, 1, (B, N, D)), dtype=torch.float32,
                     device=cuda)
    before = bk.BWD_LAUNCHES
    dx, grads = bk._launch_bwd(x, g, p, heads)
    torch.cuda.synchronize()
    assert bk.BWD_LAUNCHES == before + 1
    assert dx.dtype == dtype
    want_dx, want = bk.block_backward_reference(x, g, p, heads)
    _assert_grads(dx, grads, want_dx, want, dtype)
    again = bk._launch_bwd(x, g, p, heads)[1]        # no atomics: same bits
    for k in bk.PKEYS:
        assert torch.equal(again[k], grads[k]), k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(2, 3, 197, 64), (2, 3, 577, 64),
                                   (3, 2, 37, 32), (1, 2, 77, 128),
                                   (1, 2, 1024, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_kernels_match_plain(cuda, shape, dtype):
    """#5 and #6 against their plain versions: the forward's fp32 output
    within 1e-4 (fp32) or two bf16 ulps at its largest magnitude (bf16:
    both round P at the same point); dq, dk, dv within ``_bwd_tol``; the
    same bits on a repeated call."""
    rng = np.random.RandomState(sum(shape))

    def t(scale=1.0, dt=dtype):
        return torch.tensor(rng.normal(0, scale, shape), dtype=torch.float32,
                            device=cuda).to(dt)

    q, k, v, g = t(shape[-1] ** -0.5), t(), t(), t(dt=torch.float32)
    fwd, bwd = at.LAUNCHES, at.BWD_LAUNCHES
    out = at._launch(q, k, v)
    grads = at._launch_bwd(q, k, v, g)
    torch.cuda.synchronize()
    assert (at.LAUNCHES, at.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    ref = at.attention_reference(q, k, v)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= _tol(ref, dtype)
    want = at.attention_backward_reference(q, k, v, g)
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == dtype and got.shape == q.shape, name
        assert torch.isfinite(got.float()).all(), name
        err = float((got.float() - w.float()).abs().max())
        assert err <= _bwd_tol(w, dtype), (name, err)
    assert torch.equal(at._launch(q, k, v), out)
    for a, b in zip(at._launch_bwd(q, k, v, g), grads):
        assert torch.equal(a, b)


def test_attention_refuses_what_it_does_not_take(cuda):
    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=cuda)

    for hd in (24, 8, 256):                          # not a multiple of 16
        x = z(1, 2, 5, hd)                           # or above 128
        with pytest.raises(ValueError):
            at.fused_attention(x, x, x)
    with pytest.raises(TypeError):
        x = z(1, 2, 5, 32, dtype=torch.float16)
        at.fused_attention(x, x, x)
    with pytest.raises(ValueError):
        at.fused_attention(z(1, 2, 5, 32), z(1, 2, 6, 32), z(1, 2, 5, 32))
    # The kernels read the model's qkv buffer through strides: the same bits
    # as on contiguous copies. Under autograd #5 and #6 each launch once.
    rng = np.random.RandomState(5)
    qkv = torch.tensor(rng.normal(0, 1, (2, 9, 3, 2, 32)),
                       dtype=torch.bfloat16, device=cuda)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    assert not k.is_contiguous()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fwd, bwd = at.LAUNCHES, at.BWD_LAUNCHES
    out = at.fused_attention(*leaves)
    g = torch.ones_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    assert (at.LAUNCHES, at.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    assert torch.equal(at._launch(q, k, v), at._launch(
        *(x.contiguous() for x in (q, k, v))))
    for leaf, want in zip(leaves, at._launch_bwd(
            *(x.contiguous() for x in (q, k, v)), g)):
        assert torch.equal(leaf.grad, want)


def test_train_step_through_the_attention_kernels(cuda):
    """One small bf16 step with ``use_pallas_attention=True`` and the block
    unfused, through #5, #6 and #7, against the same step through their
    plain versions: loss within 1e-2 relative, gradient within 5e-2 in L2,
    as the block's step above."""
    kw = dict(embed_dim=64, depth=2, num_heads=2, image_size=32,
              kan_layers=(64, 8, 1), hidden_dim=16, dropout=0.0,
              dtype=torch.bfloat16, use_pallas_attention=True)
    cfg = Config()
    rng = np.random.RandomState(4)
    labels = torch.tensor(rng.randint(0, 4, 8), device=cuda)
    batch = {"images": torch.tensor(rng.randint(0, 256, (8, 32, 32, 3)),
                                    dtype=torch.uint8, device=cuda),
             "labels": labels, "severity": labels.float()}
    draws = {"factors": ak.draw_factors(
                 torch.Generator(cuda).manual_seed(0), 8),
             "mix": draw_mix(torch.Generator().manual_seed(1), 8, 32, 32),
             "dropout": None}

    def run(plain):
        model = RoViTKAN(**kw)
        init_weights(model, seed=0)
        model.to(cuda)
        for blk in model.backbone.model.blocks:
            assert blk.attn.use_fused and not blk.use_fused_block
            if plain:
                blk.attn.attn_fn = at.plain_attention
        opt = build_optimizer(model, cfg)
        step = make_train_step(model, opt, cfg)
        if plain:
            step.augment = ak.augment_reference
        before = (at.LAUNCHES, at.BWD_LAUNCHES, ak.LAUNCHES, bk.LAUNCHES)
        loss = float(step(batch, 4, 1.0, 1, draws=draws)["total_loss"])
        torch.cuda.synchronize()
        after = (at.LAUNCHES, at.BWD_LAUNCHES, ak.LAUNCHES, bk.LAUNCHES)
        return loss, opt.grad.clone(), tuple(
            a - b for a, b in zip(after, before))

    lk, gk, nk = run(False)
    lp, gp, npl = run(True)
    assert nk == (2, 2, 1, 0) and npl == (0, 0, 0, 0)
    assert np.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp)
    assert float((gk - gp).norm()) <= 5e-2 * float(gp.norm())


def _augment_tol(compute_dtype):
    """Both sides round at the same points; the pivot is a sum of H*W*3
    terms in another order, and a rounding boundary it crosses moves each of
    the three rounded blends by at most one ulp of [0, 1] (2^-8 in bf16),
    scaled by 1/std (<= 1/0.224) in the normalization. fp32: sum order."""
    return 3 * 2.0 ** -8 / 0.224 if compute_dtype == torch.bfloat16 else 1e-5


@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(3, 32, 32), (2, 224, 224)],
                         ids=lambda s: "x".join(map(str, s)))
def test_augment_kernel_matches_plain(cuda, shape, compute):
    B, H, W = shape
    rng = np.random.RandomState(B * H)
    imgs = torch.tensor(rng.randint(0, 256, (B, H, W, 3)), dtype=torch.uint8,
                        device=cuda)
    factors = ak.draw_factors(torch.Generator(cuda).manual_seed(B), B)
    factors[:, :2] = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]][:B],
                                  device=cuda)        # every flip case
    for out_dtype in (torch.float32, torch.bfloat16):
        before = ak.LAUNCHES
        got = ak.fused_augment_batch(imgs, factors, compute, out_dtype)
        torch.cuda.synchronize()
        assert ak.LAUNCHES == before + 1
        want = ak.augment_reference(imgs, factors, compute, out_dtype)
        assert got.dtype == out_dtype and got.shape == (B, H, W, 3)
        tol = _augment_tol(compute)
        if out_dtype == torch.bfloat16:
            tol += 2.0 ** -6                # one ulp of the bf16 store at |v| < 4
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol, err


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
        blk.block_fn = bk.plain_vit_block
    plain = engine.predict(imgs)
    for k, v in served.items():
        assert v.shape == plain[k].shape and np.isfinite(v).all()
    np.testing.assert_allclose(served["cls_probs"].sum(-1), 1.0, atol=1e-5)
    # Two blocks of bf16 noise at d=64; the outputs stay close.
    np.testing.assert_allclose(served["cls_probs"], plain["cls_probs"],
                               atol=2e-2)


def test_train_step_through_the_kernels(cuda):
    """One small bf16 train step through #1, #2 and #7 against the same step
    through their plain versions (same weights, same draws). Both round at
    the same points, so they differ where an fp32 sum in another order
    crosses a bf16 rounding boundary, carried through two blocks and the
    heads: loss within 1e-2 relative, gradient within 5e-2 in L2."""
    kw = dict(embed_dim=64, depth=2, num_heads=2, image_size=32,
              kan_layers=(64, 8, 1), hidden_dim=16, dropout=0.0,
              dtype=torch.bfloat16, use_pallas_block=True)
    cfg = Config()
    rng = np.random.RandomState(3)
    labels = torch.tensor(rng.randint(0, 4, 8), device=cuda)
    batch = {"images": torch.tensor(rng.randint(0, 256, (8, 32, 32, 3)),
                                    dtype=torch.uint8, device=cuda),
             "labels": labels, "severity": labels.float()}
    draws = {"factors": ak.draw_factors(
                 torch.Generator(cuda).manual_seed(0), 8),
             "mix": draw_mix(torch.Generator().manual_seed(1), 8, 32, 32),
             "dropout": None}

    def run(plain):
        model = RoViTKAN(**kw)
        init_weights(model, seed=0)
        model.to(cuda)
        if plain:
            for blk in model.backbone.model.blocks:
                blk.block_fn = bk.plain_vit_block
        opt = build_optimizer(model, cfg)
        step = make_train_step(model, opt, cfg)
        assert step.fused_augment
        if plain:
            step.augment = ak.augment_reference
        before = (bk.LAUNCHES, bk.BWD_LAUNCHES, ak.LAUNCHES)
        loss = float(step(batch, 4, 1.0, 1, draws=draws)["total_loss"])
        torch.cuda.synchronize()
        after = (bk.LAUNCHES, bk.BWD_LAUNCHES, ak.LAUNCHES)
        return loss, opt.grad.clone(), tuple(
            a - b for a, b in zip(after, before))

    lk, gk, nk = run(False)
    lp, gp, npl = run(True)
    assert nk == (2, 2, 1) and npl == (0, 0, 0)
    assert np.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp)
    assert float((gk - gp).norm()) <= 5e-2 * float(gp.norm())


def _kan_params(rng, dims, device):
    """Flat (spline_weights, weight, bias) per layer, fp32 on ``device``."""
    out = []
    for a, b in zip(dims[:-1], dims[1:]):
        out += [rng.normal(0, 0.1, (a, b, 7)), rng.normal(0, a ** -0.5,
                                                          (b, a)),
                rng.normal(0, 0.1, (b,))]
    return [torch.tensor(t, dtype=torch.float32, device=device) for t in out]


def _kan_x(rng, B, width, device):
    """Normal inputs with the edge cases: |x| >= 10 (tanh exactly +-1) and
    x at the knots' atanh (t on a knot)."""
    x = rng.normal(0, 1.5, (B, width))
    x.flat[:4] = [10.0, -10.0, 12.0, -30.0]
    knots = make_knots().astype(np.float64)[1:-1]
    x.flat[4:4 + knots.size] = np.arctanh(knots)
    return torch.tensor(x, dtype=torch.float32, device=device)


def _kan_tol(ref):
    """1e-4 of the largest magnitude: fp32 sums in another order."""
    return 1e-4 * max(float(ref.abs().max()), 1e-6)


KAN_DIMS = [(192, 64, 16, 1), (24, 8, 1), (32, 16, 4, 1)]


@pytest.mark.parametrize("B", [1, 37, 64, 300])
@pytest.mark.parametrize("dims", KAN_DIMS, ids=lambda d: "-".join(map(str, d)))
def test_kan_module_kernels_match_plain(cuda, dims, B):
    rng = np.random.RandomState(B + sum(dims))
    params = _kan_params(rng, dims, cuda)
    x = _kan_x(rng, B, dims[0], cuda)
    g = torch.tensor(rng.normal(0, 1, (B, dims[-1])), dtype=torch.float32,
                     device=cuda)
    knots = make_knots()
    fwd, bwd = kk.LAUNCHES, kk.BWD_LAUNCHES
    y = kk._launch_module(x, params, knots, 3)
    dx, grads = kk._launch_module_bwd(x, g, params, knots, 3)
    torch.cuda.synchronize()
    assert (kk.LAUNCHES, kk.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    want_y = kk.kan_module_reference(x, params, knots)
    want_dx, want = kk.kan_module_backward_reference(x, g, params, knots)
    for name, got, ref in [("y", y, want_y), ("dx", dx, want_dx)] + [
            (f"grad{i}", a, b) for i, (a, b) in enumerate(zip(grads, want))]:
        assert got.shape == ref.shape and torch.isfinite(got).all(), name
        err = float((got - ref).abs().max())
        assert err <= _kan_tol(ref), (name, err)
    dx2, grads2 = kk._launch_module_bwd(x, g, params, knots, 3)
    assert torch.equal(dx2, dx)                       # no atomics: same bits
    for a, b in zip(grads2, grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B", [1, 37, 64, 300])
@pytest.mark.parametrize("shape", [(192, 64), (16, 1), (64, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kan_layer_kernels_match_plain(cuda, shape, B):
    rng = np.random.RandomState(B * 7 + shape[0])
    s, w, b = _kan_params(rng, shape, cuda)
    x = _kan_x(rng, B, shape[0], cuda)
    g = torch.tensor(rng.normal(0, 1, (B, shape[1])), dtype=torch.float32,
                     device=cuda)
    knots = make_knots()
    fwd, bwd = kk.LAYER_LAUNCHES, kk.LAYER_BWD_LAUNCHES
    y = kk._launch_layer(x, s, w, b, knots, 3)
    got = kk._launch_layer_bwd(x, g, s, w, knots, 3)
    torch.cuda.synchronize()
    assert (kk.LAYER_LAUNCHES, kk.LAYER_BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    want_y = kk.kan_layer_reference(x, s, w, b, knots)
    want = kk.kan_layer_backward_reference(x, g, s, w, knots)
    assert float((y - want_y).abs().max()) <= _kan_tol(want_y)
    for name, a, ref in zip(("dx", "ds", "dw", "db"), got, want):
        assert a.shape == ref.shape and torch.isfinite(a).all(), name
        assert float((a - ref).abs().max()) <= _kan_tol(ref), name
    again = kk._launch_layer_bwd(x, g, s, w, knots, 3)
    for a, b in zip(again, got):
        assert torch.equal(a, b)


def test_kan_kernels_refuse_what_they_do_not_take(cuda):
    rng = np.random.RandomState(0)
    params = _kan_params(rng, (24, 8, 1), cuda)
    knots = make_knots()
    x = torch.zeros(3, 24, device=cuda)
    with pytest.raises(TypeError):
        kk.fused_kan_module(x.bfloat16(), params, knots)
    with pytest.raises(TypeError):
        kk.fused_kan_layer(x.bfloat16(), *params[:3], knots)
    with pytest.raises(ValueError):                      # degree 2
        kk.fused_kan_module(x, params, make_knots(6, 2), degree=2)
    with pytest.raises(ValueError):                      # five layers
        kk.fused_kan_module(torch.zeros(3, 8, device=cuda),
                            _kan_params(rng, (8,) * 6, cuda), knots)
    with pytest.raises(ValueError):                      # too wide an output
        kk.fused_kan_module(x, _kan_params(rng, (24, 300, 1), cuda), knots)
    # Under autograd the module runs #10 and #11 and the grads reach the
    # parameters.
    leaves = [p.clone().requires_grad_() for p in params]
    xg = torch.tensor(rng.normal(0, 1, (5, 24)), dtype=torch.float32,
                      device=cuda, requires_grad=True)
    fwd, bwd = kk.LAUNCHES, kk.BWD_LAUNCHES
    kk.fused_kan_module(xg, leaves, knots).sum().backward()
    torch.cuda.synchronize()
    assert (kk.LAUNCHES, kk.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    want_dx, want = kk.kan_module_backward_reference(
        xg.detach(), torch.ones(5, 1, device=cuda), params, knots)
    assert float((xg.grad - want_dx).abs().max()) <= _kan_tol(want_dx)
    for p, ref in zip(leaves, want):
        assert float((p.grad - ref).abs().max()) <= _kan_tol(ref)
