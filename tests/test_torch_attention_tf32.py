"""The rounding model of the fp32 attention kernels #5/#6 on the card.

``csrc/attention_tf32.cuh`` takes every fp32 product of #5 and #6 as three
TF32 tensor-core products (3xTF32): each operand x is split into
hi = rna(x) and lo = rna(x - hi), TF32 values (the fp32 bits with the low
13 mantissa bits zero; rna rounds to nearest, ties away from zero), and
a . b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32. The card checks
the kernels against the plain fp32 versions within 1e-4 (forward) and 1e-4
of each gradient's largest magnitude (backward). These tests emulate the
split and the products with numpy and torch on the CPU, and hold the
emulated forward and backward against ``attention_reference`` /
``attention_backward_reference`` and against the JAX ``fused_attention``
and its ``jax.vjp`` (Pallas in interpret mode, as tests/test_attention.py
runs them), at least 10x inside the card's tolerances. The emulation lives
here; the port's plain versions stay true fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.ops.attention import fused_attention as jax_attention
from rovit_kan_tpu_torch.ops import attention as at

FWD_TOL = 1e-4          # chip_smoke.py FP32_TOL, absolute
BWD_TOL = 1e-4          # chip_smoke.py bwd_tol: of each gradient's max
MARGIN = 10.0
SHAPES = [(2, 3, 197, 64), (2, 3, 577, 64), (2, 2, 65, 16), (1, 2, 77, 128)]


def tf32_rna(x):
    """``tf32_common.cuh::tf32_rna`` on fp32 bits: half a TF32 ulp added to
    the magnitude, then the low 13 bits cleared."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def split(x):
    hi = tf32_rna(x)
    lo = tf32_rna((np.asarray(x, np.float32) - hi).astype(np.float32))
    return hi, lo


def rna_by_value(x):
    """Round to 11 significant bits, ties away from zero, in float64: an
    independent statement of what cvt.rna.tf32.f32 computes."""
    x = np.asarray(x, np.float64)
    _, e = np.frexp(x)                       # x = f 2^e, 0.5 <= |f| < 1
    ulp = np.ldexp(1.0, e - 11)
    return np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp


def mm3(a, b):
    """a @ b with every product in 3xTF32: the two small products first,
    then hi . hi, each accumulated in fp32."""
    (ah, al), (bh, bl) = (tuple(torch.from_numpy(p) for p in split(t.numpy()))
                          for t in (a, b))
    return (al @ bh + ah @ bl) + ah @ bh


def forward_3x(q, k, v):
    s = mm3(q, k.transpose(-1, -2))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return mm3(e / e.sum(dim=-1, keepdim=True), v)


def backward_3x(q, k, v, g):
    s = mm3(q, k.transpose(-1, -2))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = mm3(g, v.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dv = mm3(p.transpose(-1, -2).contiguous(), g)
    dq = mm3(ds, k)
    dk = mm3(ds.transpose(-1, -2).contiguous(), q)
    return dq, dk, dv


def _qkvg(shape):
    rng = np.random.RandomState(sum(shape) + 3)
    q = rng.normal(0, shape[-1] ** -0.5, shape).astype(np.float32)
    return (q, *(rng.normal(0, 1, shape).astype(np.float32)
                 for _ in range(3)))


def _worst_grad(got, want):
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               / float(np.abs(np.asarray(b)).max())
               for a, b in zip(got, want))


def test_split_is_rna_and_exact_to_2_22():
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.normal(0, 1, 200_000), rng.normal(0, 1e-3, 50_000),
        rng.uniform(-300, 300, 50_000),
        rng.normal(0, 1, 10_000) * 2.0 ** rng.randint(-60, 60, 10_000),
    ]).astype(np.float32)
    # Ties: low 13 bits exactly half a TF32 ulp round away from zero.
    ties = (np.arange(1, 2001, dtype=np.uint32) << 13 | np.uint32(0x1000)
            | np.uint32(0x3f800000)).view(np.float32)
    x = np.concatenate([x, ties, -ties])
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1fff)).any()
    np.testing.assert_array_equal(hi.astype(np.float64), rna_by_value(x))
    np.testing.assert_array_equal(
        lo.astype(np.float64),
        rna_by_value(x.astype(np.float64) - hi.astype(np.float64)))
    assert (np.abs(hi[-2 * len(ties):]) > np.abs(x[-2 * len(ties):])).all()
    rel = np.abs(x.astype(np.float64) - hi - lo) / np.abs(x)
    rel_hi = np.abs(x.astype(np.float64) - hi) / np.abs(x)
    print(f"split: max |x - hi - lo| / |x| = {rel.max():.3e} "
          f"(2^-22 = {2.0 ** -22:.3e}); hi alone {rel_hi.max():.3e}")
    assert rel.max() <= 2.0 ** -22


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_3xtf32_forward_inside_the_card_tolerance(shape):
    q, k, v, _ = _qkvg(shape)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = forward_3x(qt, kt, vt).numpy()
    plain = at.attention_reference(qt, kt, vt).numpy()
    want = np.asarray(jax_attention(*(jnp.asarray(a) for a in (q, k, v))))
    err_plain = float(np.abs(got - plain).max())
    err_jax = float(np.abs(got - want).max())
    print(f"forward {shape}: 3xTF32 vs plain {err_plain:.3e}, vs JAX "
          f"{err_jax:.3e}, tolerance {FWD_TOL:.0e}")
    assert max(err_plain, err_jax) * MARGIN <= FWD_TOL


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_3xtf32_backward_inside_the_card_tolerance(shape):
    q, k, v, g = _qkvg(shape)
    qt, kt, vt, gt = (torch.from_numpy(a) for a in (q, k, v, g))
    got = [t.numpy() for t in backward_3x(qt, kt, vt, gt)]
    plain = [t.numpy() for t in at.attention_backward_reference(
        qt, kt, vt, gt)]
    _, vjp = jax.vjp(jax_attention, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    err_plain, err_jax = _worst_grad(got, plain), _worst_grad(got, want)
    print(f"backward {shape}: 3xTF32 vs plain {err_plain:.3e}, vs JAX "
          f"{err_jax:.3e} of each gradient's max, tolerance {BWD_TOL:.0e}")
    assert max(err_plain, err_jax) * MARGIN <= BWD_TOL


def mm1(a, b):
    """a @ b as one TF32 product (hi . hi), accumulated in fp32."""
    return torch.from_numpy(tf32_rna(a.numpy())) @ torch.from_numpy(
        tf32_rna(b.numpy()))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_a_single_tf32_product_misses_the_forward_tolerance(shape):
    """Why three products in the forward: hi . hi alone (plain TF32) leaves
    #5's output outside the card's absolute 1e-4, so the card's check would
    catch a forward that dropped the lo terms."""
    q, k, v, _ = (torch.from_numpy(a) for a in _qkvg(shape))
    s = mm1(q, k.transpose(-1, -2))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    got = mm1(e / e.sum(dim=-1, keepdim=True), v)
    err = float((got - at.attention_reference(q, k, v)).abs().max())
    print(f"forward {shape} with one TF32 product: {err:.3e}, tolerance "
          f"{FWD_TOL:.0e}")
    assert err > FWD_TOL


def test_a_single_tf32_product_misses_the_tolerance():
    """Why three products: hi . hi alone (plain TF32) leaves the backward
    outside the card's tolerance."""
    q, k, v, g = (torch.from_numpy(a) for a in _qkvg(SHAPES[0]))
    s = mm1(q, k.transpose(-1, -2))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = mm1(g, v.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    got = (mm1(ds, k), mm1(ds.transpose(-1, -2).contiguous(), q),
           mm1(p.transpose(-1, -2).contiguous(), g))
    err = _worst_grad([t.numpy() for t in got],
                      [t.numpy() for t in at.attention_backward_reference(
                          q, k, v, g)])
    print(f"backward with one TF32 product: {err:.3e} of each gradient's max")
    assert err > BWD_TOL
