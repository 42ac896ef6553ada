"""Port tests that need an NVIDIA GPU: the CUDA kernels (block forward #1,
block backward #2 and the residual forward #3 from one row to 1,024 tokens
at head widths 16-128, the fp32 #1 and #3 also at the edges of their 3xTF32
tiles and refusing D past 320, the residual backward #4, attention forward #5 and
backward #6 at every head width they take and on the model's strided qkv
views, augment #7, the KAN kernels #8-#11) against their plain versions,
with the same bits on a repeated call, the served model through the block
kernel, and small train steps through
#1, #2 and #7 and through #5, #6 and #7. They skip where
``torch.cuda.is_available()`` is False. This file imports neither jax nor
the JAX package, so it runs on a GPU machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: fp32 1e-4 (sums in another order); bf16 two bf16 ulps at the
largest output magnitude (both sides round at the same points, so they
differ only where an fp32 sum crosses a rounding boundary). The backward's
and the augment's tolerances are stated beside their tests.
"""
import ctypes

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


# (B, N, D, heads) of the block kernels: earlier slices' shapes, then one
# row (head width 16), head widths 48, 96 and 128, and a row count below
# one CTA's 48 rows and under any tile.
BLOCK_SHAPES = [(3, 37, 64, 2), (2, 197, 192, 3), (1, 5, 128, 4),
                (2, 577, 192, 3), (1, 1024, 128, 2), (1, 1, 64, 4),
                (3, 129, 192, 4), (2, 65, 192, 2), (1, 200, 128, 1),
                (1, 3, 192, 3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", BLOCK_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, shape, dtype):
    """#1 within ``_tol`` of ``block_reference``; the same bits on a
    repeated call."""
    B, N, D, heads = shape
    rng = np.random.RandomState(sum(shape))
    p = _params(rng, D, 4 * D, dtype, cuda)
    x = torch.tensor(rng.normal(0, 1, (B, N, D)), dtype=torch.float32)
    x = x.to(cuda, dtype)
    before = bk.LAUNCHES
    with torch.inference_mode():
        got = bk.fused_vit_block(x, p, heads)
        want = bk.block_reference(x, p, heads)
        again = bk.fused_vit_block(x, p, heads)
    torch.cuda.synchronize()
    assert bk.LAUNCHES == before + 2
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= _tol(want, dtype), err
    assert torch.equal(again, got)                   # the same bits


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


def test_backward_kernels_refuse_what_the_bf16_stages_do_not_take(cuda):
    """The bf16 backwards' mma.sync stages take D of 64, 128 and 192; a
    width the wrapper's checks pass (D = 256) is refused by the library,
    unlaunched, not run on other stages. fp32 still takes it."""
    rng = np.random.RandomState(5)
    B, N, D, heads = 1, 9, 256, 2
    x = torch.tensor(rng.normal(0, 1, (B, N, D)), dtype=torch.float32)
    g = torch.tensor(rng.normal(0, 1, (B, N, D)), dtype=torch.float32,
                     device=cuda)
    p16 = _params(rng, D, 4 * D, torch.bfloat16, cuda)
    x16 = x.to(cuda, torch.bfloat16)
    saved = tuple(torch.zeros(B, N, w, dtype=torch.bfloat16, device=cuda)
                  for w in (3 * D, D, 4 * D))
    before = (bk.BWD_LAUNCHES, bk.BWD_RES_LAUNCHES)
    with pytest.raises(RuntimeError, match="invalid argument"):
        bk._launch_bwd(x16, g, p16, heads)
    with pytest.raises(RuntimeError, match="invalid argument"):
        bk._launch_bwd_res(x16, g, *saved, p16, heads)
    assert (bk.BWD_LAUNCHES, bk.BWD_RES_LAUNCHES) == before
    p32 = _params(rng, D, 4 * D, torch.float32, cuda)
    x32 = x.to(cuda)
    dx, grads = bk._launch_bwd(x32, g, p32, heads)
    torch.cuda.synchronize()
    want_dx, want = bk.block_backward_reference(x32, g, p32, heads)
    _assert_grads(dx, grads, want_dx, want, torch.float32)


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
@pytest.mark.parametrize("shape", BLOCK_SHAPES,
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
@pytest.mark.parametrize("shape", BLOCK_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_residual_forward_kernel_matches_plain(cuda, shape, dtype):
    """#3: the output has #1's bits; qkv, attn and a1 within ``_tol`` of
    ``block_residual_reference``'s; the same bits on a repeated call."""
    B, N, D, heads = shape
    rng = np.random.RandomState(sum(shape) + 2)
    p = _params(rng, D, 4 * D, dtype, cuda)
    x = torch.tensor(rng.normal(0, 1, (B, N, D)), dtype=torch.float32)
    x = x.to(cuda, dtype)
    before = (bk.LAUNCHES, bk.RES_LAUNCHES)
    with torch.no_grad():
        got = bk._launch_res(x, p, heads)
        plain_out = bk._launch(x, p, heads)
        want = bk.block_residual_reference(x, p, heads)
        again = bk._launch_res(x, p, heads)
    torch.cuda.synchronize()
    assert (bk.LAUNCHES, bk.RES_LAUNCHES) == (before[0] + 1, before[1] + 2)
    assert torch.equal(got[0], plain_out)
    for a, b in zip(again, got):                     # the same bits
        assert torch.equal(a, b)
    for name, g, w, width in zip(("out", "qkv", "attn", "a1"), got, want,
                                 (D, 3 * D, D, 4 * D)):
        assert g.dtype == dtype and g.shape == (B, N, width), name
        assert torch.isfinite(g.float()).all(), name
        err = float((g.float() - w.float()).abs().max())
        assert err <= _tol(w, dtype), (name, err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", BLOCK_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_residual_backward_kernel_matches_plain(cuda, shape, dtype):
    """#4 from #3's residuals against ``block_backward_residual_reference``
    on the same residuals, within ``_bwd_tol``; the same bits on repeat."""
    B, N, D, heads = shape
    rng = np.random.RandomState(sum(shape) + 3)
    p = _params(rng, D, 4 * D, dtype, cuda)
    x = torch.tensor(rng.normal(0, 1, (B, N, D)), dtype=torch.float32)
    x = x.to(cuda, dtype)
    g = torch.tensor(rng.normal(0, 1, (B, N, D)), dtype=torch.float32,
                     device=cuda)
    with torch.no_grad():
        _, qkv, attn, a1 = bk._launch_res(x, p, heads)
        before = (bk.BWD_LAUNCHES, bk.BWD_RES_LAUNCHES)
        dx, grads = bk._launch_bwd_res(x, g, qkv, attn, a1, p, heads)
        torch.cuda.synchronize()
        assert (bk.BWD_LAUNCHES, bk.BWD_RES_LAUNCHES) == (before[0],
                                                          before[1] + 1)
        assert dx.dtype == dtype
        want_dx, want = bk.block_backward_residual_reference(
            x, g, qkv, attn, a1, p, heads)
        _assert_grads(dx, grads, want_dx, want, dtype)
        again = bk._launch_bwd_res(x, g, qkv, attn, a1, p, heads)
    assert torch.equal(again[0], dx)
    for k in bk.PKEYS:
        assert torch.equal(again[1][k], grads[k]), k


# (B, N, D, heads, hidden / D) at the edges of the fp32 backward's tiles
# (csrc/block_bwd_fma.cuh, attention_fma.cuh): B*N one row under, at and
# over a multiple of its 64-row tiles; N of 63, 64, 65 and 577 (64-row
# query and key tiles); D 64, 128 and 192 with 1-4 heads; a hidden width
# that leaves a ragged last 128-wide chunk (192, 320); D 256 and 320, the
# widest the fp32 route takes (at hidden widths the fp32 #3 takes too).
FP32_EDGE_SHAPES = [(1, 127, 64, 1, 4), (2, 64, 64, 4, 4),
                    (1, 129, 128, 2, 4), (2, 63, 128, 4, 4),
                    (1, 64, 192, 4, 4), (3, 65, 192, 3, 4),
                    (1, 577, 64, 2, 4), (1, 65, 128, 1, 2),
                    (1, 63, 192, 2, 1), (2, 65, 192, 3, 3),
                    (1, 64, 256, 4, 2), (1, 33, 320, 5, 1)]


@pytest.mark.parametrize("residual", [False, True],
                         ids=["recompute", "residual"])
@pytest.mark.parametrize("shape", FP32_EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_fp32_backward_kernels_at_tile_edges(cuda, shape, residual):
    """fp32 #2 (or #4 from #3's residuals) within ``_bwd_tol`` of its plain
    version at the edges of the FMA stages' tiles; the same bits on a
    repeated call."""
    B, N, D, heads, mult = shape
    rng = np.random.RandomState(sum(shape) + 5)
    p = _params(rng, D, mult * D, torch.float32, cuda)
    x = torch.tensor(rng.normal(0, 1, (B, N, D)), dtype=torch.float32,
                     device=cuda)
    g = torch.tensor(rng.normal(0, 1, (B, N, D)), dtype=torch.float32,
                     device=cuda)
    with torch.no_grad():
        if residual:
            saved = bk._launch_res(x, p, heads)[1:]
            run = lambda: bk._launch_bwd_res(x, g, *saved, p, heads)
            want_dx, want = bk.block_backward_residual_reference(
                x, g, *saved, p, heads)
        else:
            run = lambda: bk._launch_bwd(x, g, p, heads)
            want_dx, want = bk.block_backward_reference(x, g, p, heads)
        dx, grads = run()
        again_dx, again = run()
    torch.cuda.synchronize()
    _assert_grads(dx, grads, want_dx, want, torch.float32)
    assert torch.equal(again_dx, dx)
    for k in bk.PKEYS:
        assert torch.equal(again[k], grads[k]), k


# (B, N, D, heads, hidden / D) at the edges of the fp32 forward's tiles
# (csrc/block_tf32.cuh: 48 rows a CTA, 16 a warp; 64 x 32 weight pieces;
# attention_tf32.cuh's 64-row query and key tiles): B*N one row under, at
# and over a CTA's 48 and 96 rows; N of 1, 63, 65 and 577; D 64 to 320 with
# 1 to 5 heads (head widths 16 to 128); hidden 1 to 4 x D.
FP32_FWD_EDGE_SHAPES = [(1, 47, 64, 1, 1), (1, 48, 64, 4, 2),
                        (1, 49, 128, 2, 3), (3, 32, 192, 3, 4),
                        (1, 95, 192, 2, 4), (1, 97, 256, 4, 2),
                        (1, 1, 320, 5, 1), (2, 63, 128, 8, 4),
                        (1, 65, 192, 3, 2), (1, 577, 64, 1, 4),
                        (1, 65, 320, 5, 3), (2, 63, 256, 2, 1)]


@pytest.mark.parametrize("shape", FP32_FWD_EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_fp32_forward_kernels_at_tile_edges(cuda, shape):
    """fp32 #1 within 1e-4 of ``block_reference`` at the edges of the
    3xTF32 stages' tiles; #3's output has #1's bits and its qkv, attn and a1
    are within 1e-4 of ``block_residual_reference``'s; a repeated call of
    each gives the same bits."""
    B, N, D, heads, mult = shape
    rng = np.random.RandomState(sum(shape) + 7)
    p = _params(rng, D, mult * D, torch.float32, cuda)
    x = torch.tensor(rng.normal(0, 1, (B, N, D)), dtype=torch.float32,
                     device=cuda)
    before = (bk.LAUNCHES, bk.RES_LAUNCHES)
    with torch.no_grad():
        out1 = bk._launch(x, p, heads)
        again1 = bk._launch(x, p, heads)
        res = bk._launch_res(x, p, heads)
        again3 = bk._launch_res(x, p, heads)
        want = bk.block_residual_reference(x, p, heads)
    torch.cuda.synchronize()
    assert (bk.LAUNCHES, bk.RES_LAUNCHES) == (before[0] + 2, before[1] + 2)
    assert torch.equal(again1, out1)
    assert torch.equal(res[0], out1)                 # #3 keeps #1's bits
    for a, b in zip(again3, res):
        assert torch.equal(a, b)
    for name, g, w, width in zip(("out", "qkv", "attn", "a1"), res, want,
                                 (D, 3 * D, D, mult * D)):
        assert g.shape == (B, N, width), name
        assert torch.isfinite(g).all(), name
        err = float((g - w).abs().max())
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("D", [384, 448, 512])
def test_fp32_forward_refuses_widths_past_320(cuda, D):
    """The fp32 stages take D of 64 to 320 (block_tf32.cuh); a wider D that
    the wrapper's checks pass is refused by the library before any launch,
    for #1 and #3, and no launch is counted."""
    rng = np.random.RandomState(D)
    heads = D // 64
    p = _params(rng, D, D, torch.float32, cuda)
    x = torch.zeros(1, 5, D, dtype=torch.float32, device=cuda)
    before = (bk.LAUNCHES, bk.RES_LAUNCHES)
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="invalid argument"):
            bk._launch(x, p, heads)
        with pytest.raises(RuntimeError, match="invalid argument"):
            bk._launch_res(x, p, heads)
    torch.cuda.synchronize()
    assert (bk.LAUNCHES, bk.RES_LAUNCHES) == before


def test_residual_block_under_autograd(cuda, monkeypatch):
    """With ``ROVIT_BLOCK_RESIDUAL_BWD=1`` the block under autograd runs #3
    and #4 (no #1 or #2) and its grads match the plain residual pair's;
    without grad it still runs #1."""
    monkeypatch.setenv("ROVIT_BLOCK_RESIDUAL_BWD", "1")
    rng = np.random.RandomState(4)
    p32 = {k: v.clone().requires_grad_()
           for k, v in _params(rng, 64, 256, torch.float32, cuda).items()}
    x = torch.tensor(rng.normal(0, 1, (2, 5, 64)), dtype=torch.float32,
                     device=cuda, requires_grad=True)
    g = torch.tensor(rng.normal(0, 1, (2, 5, 64)), dtype=torch.float32,
                     device=cuda)
    counts = (bk.LAUNCHES, bk.BWD_LAUNCHES, bk.RES_LAUNCHES,
              bk.BWD_RES_LAUNCHES)
    bk.fused_vit_block(x, p32, 2).backward(g)
    with torch.no_grad():
        bk.fused_vit_block(x, p32, 2)
    torch.cuda.synchronize()
    assert (bk.LAUNCHES, bk.BWD_LAUNCHES, bk.RES_LAUNCHES,
            bk.BWD_RES_LAUNCHES) == (counts[0] + 1, counts[1],
                                     counts[2] + 1, counts[3] + 1)
    with torch.no_grad():
        _, *saved = bk.block_residual_reference(x, p32, 2)
        dx, grads = bk.block_backward_residual_reference(x.detach(), g,
                                                         *saved, p32, 2)
    _assert_grads(x.grad, {k: p32[k].grad for k in bk.PKEYS}, dx, grads,
                  torch.float32)


# Every head width the kernels take at every edge of the 64-row tiles
# (one row, one ragged tile, exactly one tile, one past it, the model's 197
# and 577 tokens, 16 tiles), beside the shapes of earlier slices.
ATTN_SHAPES = [(2, 3, 197, 64), (2, 3, 577, 64), (3, 2, 37, 32),
               (1, 2, 77, 128), (1, 2, 1024, 128)] + [
    (2, 2, n, hd) for hd in range(16, 129, 16)
    for n in (1, 15, 64, 65, 197, 577, 1024)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", ATTN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_kernels_match_plain(cuda, shape, dtype):
    """#5 and #6 against their plain versions: the forward's fp32 output
    within 1e-4 (fp32) or two bf16 ulps at its largest magnitude (bf16:
    both round P at the same point); dq, dk, dv within ``_bwd_tol``; the
    same bits on a repeated call; one launch each per call."""
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
    assert (at.LAUNCHES, at.BWD_LAUNCHES) == (fwd + 2, bwd + 2)


@pytest.mark.parametrize("shape", [(2, 3, 197, 64), (2, 3, 577, 64),
                                   (2, 2, 65, 16), (1, 2, 200, 128),
                                   (3, 4, 129, 48)],
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_forward_keeps_scale_one(cuda, shape):
    """The bf16 #5 shares its forward with the ViT block's attention stage,
    which folds hd^-1/2 into the exp2 FMA behind a compile-time switch; #5
    keeps scale 1. On q that is not pre-scaled (logits hd^1/2 times larger
    than the model's), #5 is softmax(q k^T) v: within two bf16 ulps of
    ``attention_reference``, far from the scaled softmax, and the same bits
    on a repeated call."""
    rng = np.random.RandomState(sum(shape) + 7)
    q, k, v = (torch.tensor(rng.normal(0, 1, shape), dtype=torch.float32,
                            device=cuda).to(torch.bfloat16)
               for _ in range(3))
    out = at._launch(q, k, v)
    ref = at.attention_reference(q, k, v)
    scaled = at.attention_reference(
        (q.float() * shape[-1] ** -0.5).to(torch.bfloat16), k, v)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= _tol(ref, torch.bfloat16)
    assert float((out - scaled).abs().max()) > 10 * _tol(ref, torch.bfloat16)
    assert torch.equal(at._launch(q, k, v), out)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(4, 197, 3, 64), (2, 577, 3, 64),
                                   (2, 65, 2, 128), (3, 15, 4, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_kernels_read_the_qkv_buffer(cuda, shape, dtype):
    """q, k, v as the model passes them: strided views of one
    ``(B, N, 3, heads, hd)`` qkv buffer, read in place (no copy). The same
    bits as on contiguous copies, within the plain versions' tolerance, the
    same bits on repeat, one launch each per call."""
    B, N, heads, hd = shape
    rng = np.random.RandomState(N + hd)
    qkv = torch.tensor(rng.normal(0, 1, (B, N, 3, heads, hd)),
                       dtype=torch.float32, device=cuda)
    qkv[:, :, 0] *= hd ** -0.5
    qkv = qkv.to(dtype)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    assert not q.is_contiguous() and at._kernel_view(q) is q
    g = torch.tensor(rng.normal(0, 1, (B, heads, N, hd)),
                     dtype=torch.float32, device=cuda)
    dense = [x.contiguous() for x in (q, k, v)]
    fwd, bwd = at.LAUNCHES, at.BWD_LAUNCHES
    out = at._launch(q, k, v)
    grads = at._launch_bwd(q, k, v, g)
    torch.cuda.synchronize()
    assert (at.LAUNCHES, at.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    assert torch.equal(out, at._launch(*dense))
    assert torch.equal(out, at._launch(q, k, v))
    ref = at.attention_reference(*dense)
    assert float((out - ref).abs().max()) <= _tol(ref, dtype)
    want = at.attention_backward_reference(*dense, g)
    for name, got, again, d, w in zip(("dq", "dk", "dv"), grads,
                                      at._launch_bwd(q, k, v, g),
                                      at._launch_bwd(*dense, g), want):
        assert torch.equal(got, again) and torch.equal(got, d), name
        err = float((got.float() - w.float()).abs().max())
        assert err <= _bwd_tol(w, dtype), (name, err)


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_train_step_through_the_attention_kernels(cuda, dtype):
    """One small step with ``use_pallas_attention=True`` and the block
    unfused, through #5, #6 and (bf16 only: the trainer takes the augment
    kernel on the card under ``flags.mixed_precision``, which the fp32 arm
    clears) #7, against the same step through their plain versions: bf16
    loss within 1e-2 relative and gradient within 5e-2 in L2, as the block's
    step above; fp32 (the 3xTF32 kernels, about 2^-21 relative per product)
    loss within 1e-4 and gradient within 1e-3."""
    kw = dict(embed_dim=64, depth=2, num_heads=2, image_size=32,
              kan_layers=(64, 8, 1), hidden_dim=16, dropout=0.0,
              dtype=dtype, use_pallas_attention=True)
    cfg = Config()
    cfg.flags.mixed_precision = dtype == torch.bfloat16
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
        if plain and step.fused_augment:
            step.augment = ak.augment_reference
        before = (at.LAUNCHES, at.BWD_LAUNCHES, ak.LAUNCHES, bk.LAUNCHES)
        loss = float(step(batch, 4, 1.0, 1, draws=draws)["total_loss"])
        torch.cuda.synchronize()
        after = (at.LAUNCHES, at.BWD_LAUNCHES, ak.LAUNCHES, bk.LAUNCHES)
        return loss, opt.grad.clone(), tuple(
            a - b for a, b in zip(after, before))

    lk, gk, nk = run(False)
    lp, gp, npl = run(True)
    assert nk == (2, 2, int(dtype == torch.bfloat16), 0)
    assert npl == (0, 0, 0, 0)
    loss_tol, grad_tol = (1e-2, 5e-2) if dtype == torch.bfloat16 else \
        (1e-4, 1e-3)
    assert np.isfinite(lk) and abs(lk - lp) <= loss_tol * abs(lp)
    assert float((gk - gp).norm()) <= grad_tol * float(gp.norm())


def _augment_tol(compute_dtype):
    """Both sides round at the same points; the pivot is a sum of H*W*3
    terms in another order, and a rounding boundary it crosses moves each of
    the three rounded blends by at most one ulp of [0, 1] (2^-8 in bf16),
    scaled by 1/std (<= 1/0.224) in the normalization. fp32: sum order."""
    return 3 * 2.0 ** -8 / 0.224 if compute_dtype == torch.bfloat16 else 1e-5


@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(3, 32, 32), (2, 224, 224),
                                   (64, 224, 224), (32, 384, 384),
                                   (3, 33, 35), (2, 7, 5)],
                         ids=lambda s: "x".join(map(str, s)))
def test_augment_kernel_matches_plain(cuda, shape, compute):
    """#7 against its plain version at the main path's shapes, a shape with
    no bulk copies (W * 3 % 16 != 0) and one with fewer rows than the
    cluster has CTAs; the same bits on a repeated call; one kernel, of the
    cluster design, a call; and no memory allocated but the output."""
    from torch.profiler import ProfilerActivity, profile
    B, H, W = shape
    rng = np.random.RandomState(B * H)
    imgs = torch.tensor(rng.randint(0, 256, (B, H, W, 3)), dtype=torch.uint8,
                        device=cuda)
    factors = ak.draw_factors(torch.Generator(cuda).manual_seed(B), B)
    coins = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [0.0, 0.0]],
                         device=cuda)
    factors[:, :2] = coins.repeat(-(-B // 4), 1)[:B]    # every flip case
    for out_dtype in (torch.float32, torch.bfloat16):
        before = ak.LAUNCHES
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda)
        base = torch.cuda.memory_allocated(cuda)
        got = ak.fused_augment_batch(imgs, factors, compute, out_dtype)
        torch.cuda.synchronize()
        used = torch.cuda.max_memory_allocated(cuda) - base
        assert used <= -(-got.numel() * got.element_size() // 512) * 512, used
        assert ak.LAUNCHES == before + 1
        want = ak.augment_reference(imgs, factors, compute, out_dtype)
        assert got.dtype == out_dtype and got.shape == (B, H, W, 3)
        tol = _augment_tol(compute)
        if out_dtype == torch.bfloat16:
            tol += 2.0 ** -6                # one ulp of the bf16 store at |v| < 4
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol, err
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            again = ak.fused_augment_batch(imgs, factors, compute, out_dtype)
            torch.cuda.synchronize()
        assert torch.equal(got, again)
        kernels = [e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   for _ in range(e.count)]
        assert len(kernels) == 1 and "augment_cluster_kernel" in kernels[0], \
            kernels


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


def test_train_step_through_the_residual_kernels(cuda, monkeypatch):
    """One small bf16 train step with ``ROVIT_BLOCK_RESIDUAL_BWD=1``: #3 and
    #4 per block (no #1 or #2) and #7, against the same step through the
    plain residual pair and the plain augment; the tolerances of
    ``test_train_step_through_the_kernels``."""
    monkeypatch.setenv("ROVIT_BLOCK_RESIDUAL_BWD", "1")
    kw = dict(embed_dim=64, depth=2, num_heads=2, image_size=32,
              kan_layers=(64, 8, 1), hidden_dim=16, dropout=0.0,
              dtype=torch.bfloat16, use_pallas_block=True)
    cfg = Config()
    rng = np.random.RandomState(5)
    labels = torch.tensor(rng.randint(0, 4, 8), device=cuda)
    batch = {"images": torch.tensor(rng.randint(0, 256, (8, 32, 32, 3)),
                                    dtype=torch.uint8, device=cuda),
             "labels": labels, "severity": labels.float()}
    draws = {"factors": ak.draw_factors(
                 torch.Generator(cuda).manual_seed(0), 8),
             "mix": draw_mix(torch.Generator().manual_seed(1), 8, 32, 32),
             "dropout": None}

    def counts():
        return (bk.LAUNCHES, bk.BWD_LAUNCHES, bk.RES_LAUNCHES,
                bk.BWD_RES_LAUNCHES, ak.LAUNCHES)

    def run(plain):
        model = RoViTKAN(**kw)
        init_weights(model, seed=0)
        model.to(cuda)
        if plain:
            for blk in model.backbone.model.blocks:
                blk.block_fn = bk.plain_vit_block
        opt = build_optimizer(model, cfg)
        step = make_train_step(model, opt, cfg)
        if plain:
            step.augment = ak.augment_reference
        before = counts()
        loss = float(step(batch, 4, 1.0, 1, draws=draws)["total_loss"])
        torch.cuda.synchronize()
        return loss, opt.grad.clone(), tuple(
            a - b for a, b in zip(counts(), before))

    lk, gk, nk = run(False)
    lp, gp, npl = run(True)
    assert nk == (0, 0, 2, 2, 1) and npl == (0, 0, 0, 0, 0)
    assert np.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp)
    assert float((gk - gp).norm()) <= 5e-2 * float(gp.norm())


def _kan_params(rng, dims, device, bases=7):
    """Flat (spline_weights, weight, bias) per layer, fp32 on ``device``."""
    out = []
    for a, b in zip(dims[:-1], dims[1:]):
        out += [rng.normal(0, 0.1, (a, b, bases)), rng.normal(0, a ** -0.5,
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


# The flagship head and small ones, then widths that #10/#11's cluster of
# 16 does not divide.
KAN_DIMS = [(192, 64, 16, 1), (24, 8, 1), (32, 16, 4, 1), (200, 60, 13, 3)]


def _check_module_kernels(x, g, params, knots, widen=lambda t: t):
    """#10/#11 on (x, g) against their plain versions on ``widen``'s
    tensors, each output within 1e-4 of its largest magnitude; one launch
    counted each; the same bits on a repeated call, and with the basis's
    reciprocal divisions off (every division __fdiv_rn)."""
    fwd, bwd = kk.LAUNCHES, kk.BWD_LAUNCHES
    y = kk._launch_module(x, params, knots, 3)
    dx, grads = kk._launch_module_bwd(x, g, params, knots, 3)
    torch.cuda.synchronize()
    assert (kk.LAUNCHES, kk.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    wx, wg, wp = widen(x), widen(g), [widen(p) for p in params]
    want_y = kk.kan_module_reference(wx, wp, knots)
    want_dx, want = kk.kan_module_backward_reference(wx, wg, wp, knots)
    for name, got, ref in [("y", y, want_y), ("dx", dx, want_dx)] + [
            (f"grad{i}", a, b) for i, (a, b) in enumerate(zip(grads, want))]:
        assert got.shape == ref.shape and torch.isfinite(got).all(), name
        err = float((got.to(ref.dtype) - ref).abs().max())
        assert err <= _kan_tol(ref), (name, err)
    dx2, grads2 = kk._launch_module_bwd(x, g, params, knots, 3)
    assert torch.equal(dx2, dx)                       # no atomics: same bits
    for a, b in zip(grads2, grads):
        assert torch.equal(a, b)
    assert torch.equal(kk._launch_module(x, params, knots, 3, False), y)
    dx3, grads3 = kk._launch_module_bwd(x, g, params, knots, 3, False)
    assert torch.equal(dx3, dx)
    for a, b in zip(grads3, grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B", [1, 37, 64, 300, 1000])
@pytest.mark.parametrize("dims", KAN_DIMS, ids=lambda d: "-".join(map(str, d)))
def test_kan_module_kernels_match_plain(cuda, dims, B):
    """#10/#11 against their plain versions; B = 300 and 1,000 span several
    row groups of #11 (its second launch adds their weight gradients in
    order)."""
    rng = np.random.RandomState(B + sum(dims))
    params = _kan_params(rng, dims, cuda)
    x = _kan_x(rng, B, dims[0], cuda)
    g = torch.tensor(rng.normal(0, 1, (B, dims[-1])), dtype=torch.float32,
                     device=cuda)
    _check_module_kernels(x, g, params, make_knots())


def _repeated_knot():
    knots = make_knots()
    knots[5] = knots[4]
    return knots


# Knot vectors beside the flagship's: 3 bases (the K1P = 4 kernels, whose
# recursion fixes nb = 3), 6 and 9 (nb known only at run time, through the
# reciprocal divider's general form), and 7 bases with a repeated knot (the
# general form with its zero-denominator guards).
OTHER_KNOTS = {"3-bases": make_knots(1), "6-bases": make_knots(4),
               "9-bases": make_knots(7), "repeated-knot": _repeated_knot()}


@pytest.mark.parametrize("knots", list(OTHER_KNOTS))
@pytest.mark.parametrize("B", [37, 300])
def test_kan_module_kernels_at_other_basis_counts(cuda, B, knots):
    """#10/#11 on each form of the basis recursion against the plain
    version, and bit for bit with the reciprocal divider off."""
    knots = OTHER_KNOTS[knots]
    dims = KAN_DIMS[2]
    rng = np.random.RandomState(B + len(knots))
    params = _kan_params(rng, dims, cuda, bases=len(knots) - 4)
    x = _kan_x(rng, B, dims[0], cuda)
    g = torch.tensor(rng.normal(0, 1, (B, dims[-1])), dtype=torch.float32,
                     device=cuda)
    _check_module_kernels(x, g, params, knots)


def _widest_head(B, device):
    """The widest head the kernels take, seeded by ``B``: widths, knots
    (10 bases), x, g and the flat parameters, spline weights scaled by
    fan-in."""
    dims = (1024, 256, 256, 256, 256)
    rng = np.random.RandomState(B)
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        params += [rng.normal(0, 0.1 * (64 / a) ** 0.5, (a, b, 10)),
                   rng.normal(0, a ** -0.5, (b, a)), rng.normal(0, 0.1, (b,))]
    params = [torch.tensor(t, dtype=torch.float32, device=device)
              for t in params]
    x = torch.tensor(rng.normal(0, 1.0, (B, dims[0])), dtype=torch.float32,
                     device=device)
    g = torch.tensor(rng.normal(0, 1, (B, dims[-1])), dtype=torch.float32,
                     device=device)
    return dims, make_knots(8), x, g, params


@pytest.mark.parametrize("B", [1, 37, 64])
def test_kan_module_kernels_at_the_widest_shape(cuda, B):
    """The widest head the kernels take (4 layers, 1,024 inputs, 256
    outputs, 10 bases) against its plain version run in fp64, at batches of
    one row group of #11: at this width two fp32 orders of summation, the
    kernels' and the fp32 plain version's, sat up to 1.6e-4 of the largest
    output apart on the card. fp64 holds an fp32 evaluation only
    where no layer's input reaches |h| = 8.66, past which the fp32 tanh is
    exactly 1 and the basis is cut off; with spline weights scaled by fan-in
    (N(0, 0.1^2 64 / in)) and x ~ N(0, 1) the inputs stay below that, which
    the test checks. Larger batches are left to the other shapes: the
    truncated recursion of ops/spline.py jumps at the knots k[nb] ..
    k[nb + 2], and with 256 inputs a layer and hundreds of rows some input
    lands within rounding of one, where any two evaluations can differ by
    O(1) (found on the card at B = 300: one row whose every layer agreed
    with the plain version on the same input, while the chained outputs
    did not; a small shift of the input removed it)."""
    dims, knots, x, g, params = _widest_head(B, cuda)
    h = x.double()
    for layer in range(len(dims) - 1):
        assert float(h.abs().max()) < 8.5, (layer, float(h.abs().max()))
        h = torch.relu(kk.kan_layer_reference(
            h, *[p.double() for p in params[3 * layer:3 * layer + 3]],
            knots))
    _check_module_kernels(x, g, params, knots, lambda t: t.double())


def test_kan_module_kernels_walk_row_groups_at_the_widest_shape(cuda):
    """The widest head at B = 1,000: 125 row groups of 8 rows, which #11
    runs in 16 waves of 8 clusters. Its weight-gradient sums take 8 fp32
    copies of the gradients whatever the batch (not one a group); and the
    batch's
    results are, bit for bit, those of one launch a group (each held
    against the plain version by the test above) composed in the kernels'
    order: dx and y row by row, each slot's groups added in order, then
    the slots in order."""
    B = 1000
    dims, knots, x, g, params = _widest_head(B, cuda)
    plan = kk.module_plan(B, dims, 10, True)
    assert (plan.groups, plan.slots) == (125, kk.BWD_SLOTS)
    n = sum(p.numel() for p in params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    dx, grads = kk._launch_module_bwd(x, g, params, knots, 3)
    torch.cuda.synchronize()
    used = torch.cuda.max_memory_allocated(cuda) - base
    # dx, the gradients and the slots' sums, and 1 MiB for the allocator.
    assert used <= 4 * (dx.numel() + (1 + plan.slots) * n) + 2 ** 20, used
    y = kk._launch_module(x, params, knots, 3)
    fwd_rows = kk.module_plan(B, dims, 10, False).rows
    for r in range(0, B, fwd_rows):
        assert torch.equal(
            kk._launch_module(x[r:r + fwd_rows], params, knots, 3),
            y[r:r + fwd_rows])
    slots = [None] * plan.slots
    for gi in range(plan.groups):
        rows = slice(gi * plan.rows, (gi + 1) * plan.rows)
        one = kk.module_plan(plan.rows, dims, 10, True)
        assert (one.rows, one.groups, one.slots) == (plan.rows, 1, 1)
        dx_g, grads_g = kk._launch_module_bwd(
            x[rows].contiguous(), g[rows].contiguous(), params, knots, 3)
        assert torch.equal(dx_g, dx[rows])
        s = gi % plan.slots
        slots[s] = grads_g if slots[s] is None else [
            a + b for a, b in zip(slots[s], grads_g)]
    total = slots[0]
    for more in slots[1:]:
        total = [a + b for a, b in zip(total, more)]
    for i, (a, b) in enumerate(zip(grads, total)):
        assert torch.isfinite(a).all() and torch.equal(a, b), i


def _kernels_of_one_call(fn):
    """The device kernels one call of ``fn`` launches, by profiler name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            for _ in range(e.count)]


@pytest.mark.parametrize("B", [1, 64, 65, 1000])
def test_kan_module_backward_launches(cuda, B):
    """#11 is one kernel launch while the batch fits one row group of the
    plan (64 rows at the flagship's widths); past it, one a wave of at most
    8 clusters, then the ordered add of their slots' weight gradients."""
    dims = KAN_DIMS[0]
    knots = make_knots()
    rng = np.random.RandomState(B)
    params = _kan_params(rng, dims, cuda)
    x = _kan_x(rng, B, dims[0], cuda)
    g = torch.ones(B, 1, device=cuda)
    kernels = _kernels_of_one_call(
        lambda: kk._launch_module_bwd(x, g, params, knots, 3))
    groups = kk.module_plan(B, dims, 7, True).groups
    assert groups == (1 if B <= 64 else -(-B // 64))
    waves = -(-groups // kk.BWD_SLOTS)
    assert len(kernels) == (1 if groups == 1 else waves + 1), kernels
    assert any("kan_module_bwd_kernel" in k for k in kernels)


@pytest.mark.parametrize("B", [1, 37, 64, 300])
@pytest.mark.parametrize("shape", [(192, 64), (16, 1), (64, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kan_layer_kernels_match_plain(cuda, shape, B):
    """#8/#9, kan_module.cu's kernels on a one-layer plan without the head,
    against their plain versions; the same bits on repeat and with the
    reciprocal divider off; #9 one kernel launch while the batch fits one
    row group (``LAYER_BWD_ROWS``), past it one a wave of at most 8
    clusters and the ordered add of the slots."""
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
    for a, b_ in zip(again, got):
        assert torch.equal(a, b_)
    assert torch.equal(kk._launch_layer(x, s, w, b, knots, 3, False), y)
    for a, b_ in zip(kk._launch_layer_bwd(x, g, s, w, knots, 3, False), got):
        assert torch.equal(a, b_)
    kernels = _kernels_of_one_call(
        lambda: kk._launch_layer_bwd(x, g, s, w, knots, 3))
    plan = kk.module_plan(B, shape, 7, True, False)
    assert plan.groups == -(-B // kk.LAYER_BWD_ROWS) and not plan.head
    waves = -(-plan.groups // kk.BWD_SLOTS)
    assert len(kernels) == (1 if plan.groups == 1 else waves + 1), kernels
    assert any("kan_module_bwd_kernel" in k for k in kernels)


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
    # No plan without the head past one layer, and the entry point refuses
    # one made by hand (cudaErrorInvalidValue).
    with pytest.raises(ValueError, match="one layer"):
        kk._fwd(x, params, knots, 3, True, head=False)
    plan = kk.module_plan(3, (24, 8, 1), 7, False)._replace(head=False)
    y = torch.empty(3, 1, device=cuda)
    rc = kk._module_library().kan_module_fwd(
        x.data_ptr(), kk._c_array(ctypes.c_void_p,
                                  [p.data_ptr() for p in params]),
        y.data_ptr(), 3, kk._c_array(ctypes.c_int, (24, 8, 1)), 2,
        kk._c_knots(tuple(float(v) for v in knots)), len(knots),
        kk._c_array(ctypes.c_int, plan.ints()), None)
    assert rc == 1
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
