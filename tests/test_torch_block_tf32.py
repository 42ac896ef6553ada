"""The rounding model of the fp32 ViT-block forward #1 (and #3) on the card.

``csrc/block_tf32.cuh`` and ``csrc/attention_tf32.cuh`` take every fp32
product of the block forward as three TF32 tensor-core products (3xTF32,
the split and products of ``test_torch_attention_tf32.py``): LN1's output
by Wqkv, q by k with the block's scale hd^-1/2 in the exp2 of the softmax,
the fp32-normalized P by v, the attention output by Wproj, LN2's output by
W1, and the GELU output by W2 with its k order permuted inside each 8-deep
block (the kernel feeds fc1's C fragments to fc2 as A fragments:
k = tq -> column 2 tq, k = tq + 4 -> column 2 tq + 1). The card holds #1
against ``block_reference`` within 1e-4 (chip_smoke.py ``FP32_TOL``). These
tests emulate those products on the CPU and hold the emulated forward
against ``block_reference`` and the JAX ``fused_vit_block`` (Pallas in
interpret mode, as tests/test_torch_block.py runs it), at least 10x inside
that tolerance; show that one TF32 product alone misses it; and hold the
index map of the permuted [n][k] B loader (``tf32_b_nk_perm``) against a
product done by hand.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.ops.block_kernel import fused_vit_block as jax_block
from rovit_kan_tpu_torch.ops import block_kernel as bk
from test_torch_attention_tf32 import mm1, mm3, tf32_rna
from test_torch_block import _jax_params, _torch_params

FP32_TOL = 1e-4            # chip_smoke.py FP32_TOL, absolute
MARGIN = 10.0
LOG2E = 1.4426950408889634
# (B, N, D, heads, hidden / D): the CPU tests' two block shapes and the
# widest model the fp32 stages take.
SHAPES = [(2, 17, 64, 2, 4), (2, 197, 192, 3, 4), (1, 33, 320, 5, 4)]
# fc2's k order inside an 8-deep block: k = tq reads column 2 tq, k = tq + 4
# column 2 tq + 1.
PERM8 = [0, 2, 4, 6, 1, 3, 5, 7]


def _ln(x, g, b):
    """Two-pass fp32 LayerNorm as the kernel applies it at each A fragment
    load: fma((v - mean) * rstd, g, b)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + bk.LN_EPS)) * g + b


def _perm_k(n):
    """The kernel's k order over n (a multiple of 8) columns."""
    return np.concatenate([8 * i + np.asarray(PERM8) for i in range(n // 8)])


def block_model(x, p, heads, mm=mm3):
    """The fp32 block forward with every product through ``mm`` (3xTF32 by
    default), at the kernels' rounding points: nothing rounded below fp32,
    P normalized before P . V, exp(S - m) as exp2(S c - m c) with c = scale
    log2(e) and m the row max of the unscaled S, fc2's k order permuted."""
    B, N, D = x.shape
    hd = D // heads
    c2 = hd ** -0.5 * LOG2E
    y = _ln(x, p["ln1_scale"], p["ln1_bias"])
    qkv = mm(y, p["wqkv"].t().contiguous()) + p["bqkv"]
    q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = mm(q.contiguous(), k.transpose(-1, -2).contiguous())
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2(s * c2 - m * c2)
    o = mm(e / e.sum(dim=-1, keepdim=True), v.contiguous())
    attn = o.transpose(1, 2).reshape(B, N, D)
    x1 = x + (mm(attn, p["wproj"].t().contiguous()) + p["bproj"])
    z = _ln(x1, p["ln2_scale"], p["ln2_bias"])
    h = torch.nn.functional.gelu(mm(z, p["w1"].t().contiguous()) + p["b1"])
    perm = torch.from_numpy(_perm_k(h.shape[-1]))
    fc2 = mm(h[..., perm].contiguous(), p["w2"][:, perm].t().contiguous())
    return x1 + (fc2 + p["b2"])


def _case(shape):
    B, N, D, heads, mult = shape
    rng = np.random.RandomState(sum(shape))
    jp = _jax_params(rng, D, mult * D)
    x = rng.normal(0, 1, (B, N, D)).astype(np.float32)
    return jp, x, _torch_params(jp, torch.float32), heads


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_3xtf32_block_inside_the_card_tolerance(shape):
    jp, x, p, heads = _case(shape)
    xt = torch.from_numpy(x)
    got = block_model(xt, p, heads).numpy()
    plain = bk.block_reference(xt, p, heads).numpy()
    want = np.asarray(jax_block(jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in jp.items()},
                                heads))
    err_plain = float(np.abs(got - plain).max())
    err_jax = float(np.abs(got - want).max())
    print(f"block {shape}: 3xTF32 vs plain {err_plain:.3e}, vs JAX "
          f"{err_jax:.3e}, tolerance {FP32_TOL:.0e}")
    assert max(err_plain, err_jax) * MARGIN <= FP32_TOL


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_a_single_tf32_product_misses_the_block_tolerance(shape):
    """Why three products: hi . hi alone (plain TF32) leaves the block's
    output outside the card's 1e-4, so the card's check would catch a
    kernel that dropped the lo terms."""
    _, x, p, heads = _case(shape)
    xt = torch.from_numpy(x)
    err = float((block_model(xt, p, heads, mm=mm1)
                 - bk.block_reference(xt, p, heads)).abs().max())
    print(f"block {shape} with one TF32 product: {err:.3e}, tolerance "
          f"{FP32_TOL:.0e}")
    assert err > FP32_TOL


def _lanes():
    return [(lane >> 2, lane & 3) for lane in range(32)]


def test_permuted_nk_b_loader_index_map():
    """One m16n8k8 step of fc2 by hand: the C fragment of an 8-column block
    of h, repacked as an A fragment by ``tf32_c_to_a`` (a = c0, c2, c1,
    c3), times the B fragment that ``tf32_b_nk_perm`` reads from W2 stored
    [n][k] (row n0 + g, columns k0 + 2 tq and k0 + 2 tq + 1), laid out as
    the PTX ISA's m16n8k8 .tf32 fragments, gives h . W2^T over that block.
    The operands are integers below 2^11, exact in TF32, so the check is
    exact."""
    rng = np.random.RandomState(0)
    h = rng.randint(-50, 50, (16, 8)).astype(np.float32)     # 16 rows x k
    w2 = rng.randint(-50, 50, (8, 24)).astype(np.float32)    # [n][k], k0=16
    k0 = 16
    # C fragment of h (rows g, g, g + 8, g + 8; columns 2 tq, 2 tq + 1).
    c = {(g, tq): (h[g, 2 * tq], h[g, 2 * tq + 1], h[g + 8, 2 * tq],
                   h[g + 8, 2 * tq + 1]) for g, tq in _lanes()}
    # tf32_c_to_a: a = (c0, c2, c1, c3).
    a = {lt: (v[0], v[2], v[1], v[3]) for lt, v in c.items()}
    # tf32_b_nk_perm: (b0, b1) = W2[n0 + g][k0 + 2 tq], [.. + 1], n0 = 0.
    b = {(g, tq): (w2[g, k0 + 2 * tq], w2[g, k0 + 2 * tq + 1])
         for g, tq in _lanes()}
    # The PTX layouts: A (row g, k tq) a0, (g + 8, tq) a1, (g, tq + 4) a2,
    # (g + 8, tq + 4) a3; B (k tq, column g) b0, (k tq + 4, g) b1.
    A = np.zeros((16, 8), np.float32)
    Bm = np.zeros((8, 8), np.float32)
    for (g, tq), v in a.items():
        A[g, tq], A[g + 8, tq], A[g, tq + 4], A[g + 8, tq + 4] = v
    for (g, tq), v in b.items():
        Bm[tq, g], Bm[tq + 4, g] = v
    np.testing.assert_array_equal(tf32_rna(A), A)            # exact in TF32
    np.testing.assert_array_equal(A @ Bm, h @ w2[:, k0:k0 + 8].T)
    # The same map is the permutation the model above applies.
    np.testing.assert_array_equal(A, h[:, PERM8])
    np.testing.assert_array_equal(Bm, w2[:, k0 + np.asarray(PERM8)].T)
