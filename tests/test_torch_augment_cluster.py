"""The partition of the augment kernel #7 (``csrc/augment.cu``), modelled
in torch and held against the JAX package.

The model runs the launch plan of ``ops/augment_kernel.py::augment_plan`` as
the kernel does: a cluster an image; rank j's band of output rows, its
chunks (``band_chunks``) copied from the flipped source band; each rank's
fp32 partial of the pivot over its source bytes, the partials added in rank
order and rounded to the compute type; the brightness and the contrast
blend tabulated over the 256 byte values; the grayscale, the saturation
blend and the normalization per output pixel, read through the chunk's
index map. Seeded numpy images and the JAX package's ``_draw_factors`` (the
flip coins set to every case) go through the model, through the JAX
``_fused_augment_impl`` (the Pallas kernel in interpret mode, as
tests/test_torch_augment.py runs it) and through ``augment_reference``.
Tolerances are tests/test_torch_augment.py's: fp32 compute 2e-5; bf16
compute 3 * 2^-8 / 0.224 = 0.0523 (the pivot's sum in another order can
move each of the three rounded blends by one bf16 ulp of [0, 1], over the
smallest std). The plan is also checked to own every output row once, to
read every source row once a pass, and to fit a CTA's shared memory; its
chunks, under the kernel's rule for a bulk copy (a source address and
length that are multiples of 16 bytes), all go by bulk copy wherever
``W * 3 % 16 == 0``, as at the main path's shapes.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.ops.augment_kernel import _draw_factors
from rovit_kan_tpu.ops.augment_kernel import \
    _fused_augment_impl as jax_augment
from rovit_kan_tpu_torch.ops import augment_kernel as ak
from rovit_kan_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

F32 = torch.float32
TOL = {torch.float32: 2e-5, torch.bfloat16: 3 * 2.0 ** -8 / 0.224}
COINS = [[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]


def _bright(fb, cd):
    """x = u / 255 then the brightness, for each byte value u, in ``cd``."""
    x = (torch.arange(256).to(F32) * (1.0 / 255.0)).to(cd)
    return (x * fb).clamp(0.0, 1.0)


def cluster_augment(images_u8, factors, cd, out_dtype=torch.float32):
    """#7's arithmetic under its plan: the outputs and each image's pivot."""
    B, H, W, _ = images_u8.shape
    plan = ak.augment_plan(B, H, W)
    f = factors.to(F32)
    wmean = torch.tensor(ak.GRAY_W, dtype=F32) / (H * W)
    wg = torch.tensor(ak.GRAY_W, dtype=F32).to(cd).to(F32)
    mean = torch.tensor(IMAGENET_MEAN, dtype=F32)
    istd = 1.0 / torch.tensor(IMAGENET_STD, dtype=F32)
    out = torch.full((B, H * W, 3), float("nan"), dtype=out_dtype)
    pivots = []
    for b in range(B):
        hflip, vflip = bool(f[b, 0] > 0), bool(f[b, 1] > 0)
        fb, fc, fs = (f[b, i].to(cd) for i in (2, 3, 4))
        bright = _bright(fb, cd)
        lut = bright.to(F32)[None, :] * wmean[:, None]      # (channel, u)
        src = images_u8[b].reshape(-1).long()
        chunks = [ak.band_chunks(plan, H, W, j, hflip, vflip)
                  for j in range(plan.cluster)]
        total = torch.zeros((), dtype=F32)
        for rank_chunks in chunks:                 # rank order
            part = torch.zeros((), dtype=F32)
            for _, n, ps0 in rank_chunks:
                band = src[3 * ps0:3 * (ps0 + n)]
                part = part + lut[torch.arange(3 * n) % 3, band].sum()
            total = total + part
        pivot = total.to(cd)
        pivots.append(pivot)
        xc = ((bright - pivot) * fc + pivot).clamp(0.0, 1.0)
        for rank_chunks in chunks:
            for q0, n, ps0 in reversed(rank_chunks):
                band = src[3 * ps0:3 * (ps0 + n)]
                q = torch.arange(q0, q0 + n)
                y, x = q // W, q % W
                sy = H - 1 - y if vflip else y
                sx = W - 1 - x if hflip else x
                off = 3 * (sy * W + sx - ps0)
                assert int(off.min()) >= 0 and int(off.max()) < 3 * n
                v = xc[band[off[:, None] + torch.arange(3)]]
                vf = v.to(F32)
                gray = ((vf[:, 0] * wg[0] + vf[:, 1] * wg[1])
                        + vf[:, 2] * wg[2]).to(cd)[:, None]
                s = ((v - gray) * fs + gray).clamp(0.0, 1.0)
                assert bool(out[b, q].isnan().all())     # written once
                out[b, q] = ((s.to(F32) - mean) * istd).to(out_dtype)
    assert not bool(out.isnan().any())                   # every pixel
    return out.reshape(B, H, W, 3), torch.stack(pivots)


def plain_pivots(images_u8, factors, cd):
    """Each image's pivot as ``augment_reference`` forms it."""
    B, H, W, _ = images_u8.shape
    f = factors.to(F32)
    x = (images_u8.to(F32) * (1.0 / 255.0)).to(cd)
    x = torch.where((f[:, 0] > 0)[:, None, None, None], x.flip(2), x)
    x = torch.where((f[:, 1] > 0)[:, None, None, None], x.flip(1), x)
    x = (x * f[:, 2].to(cd)[:, None, None, None]).clamp(0.0, 1.0)
    wmean = torch.tensor(ak.GRAY_W, dtype=F32) / (H * W)
    return (x.to(F32) * wmean).sum(dim=(1, 2, 3)).to(cd)


def _case(seed, B, H, W):
    imgs = np.random.RandomState(seed).randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)
    factors = np.array(_draw_factors(jax.random.PRNGKey(seed), B, 0.2, 0.2,
                                     0.2))
    factors[:, :2] = np.array(COINS * B)[:B]             # every flip case
    return imgs, factors


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 32, 32), (3, 33, 35), (2, 7, 5),
                                   (1, 224, 224)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cluster_model_matches_jax_and_plain(shape, cd):
    imgs, factors = _case(sum(shape), *shape)
    jd = jnp.float32 if cd == torch.float32 else jnp.bfloat16
    want_jax = np.asarray(jax_augment(jnp.asarray(imgs),
                                      jnp.asarray(factors), jnp.float32, jd,
                                      True))
    u8, f = torch.from_numpy(imgs), torch.from_numpy(factors)
    got, pivots = cluster_augment(u8, f, cd)
    plain = ak.augment_reference(u8, f, cd)
    np.testing.assert_allclose(got.numpy(), want_jax, rtol=0, atol=TOL[cd])
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=TOL[cd])
    # Only the pivot's summation order differs: where it lands on the same
    # bits, so does every output of the image.
    same = pivots == plain_pivots(u8, f, cd)
    if cd == torch.bfloat16:
        assert bool(same.all())
    for b in torch.nonzero(same).flatten().tolist():
        assert torch.equal(got[b], plain[b])


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 600, 1201), (1, 3, 40001),
                                   (2, 700, 1024)],
                         ids=lambda s: "x".join(map(str, s)))
def test_chunked_bands_match_plain(shape, cd):
    """Bands past one chunk: whole rows walked in chunks (1,201 px: two a
    band, 1-byte loads; 1,024 px: bulk copies, a ragged last chunk) and one
    row too wide for a chunk, walked in pieces of it."""
    plan = ak.augment_plan(*shape)
    assert len(ak.band_chunks(plan, *shape[1:], plan.cluster - 1, False,
                              False)) > 1
    imgs, factors = _case(7, *shape)
    u8, f = torch.from_numpy(imgs), torch.from_numpy(factors)
    for out_dtype in (torch.float32, torch.bfloat16):
        got, _ = cluster_augment(u8, f, cd, out_dtype)
        want = ak.augment_reference(u8, f, cd, out_dtype)
        tol = TOL[cd] + (2.0 ** -6 if out_dtype == torch.bfloat16 else 0)
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   rtol=0, atol=tol)


# H and W from 1 to 1,024: every value to 40, then around powers of two,
# the main path's 224 and 384, and 600; W also past one chunk's row.
SIZES = sorted(set(range(1, 41)) | {
    47, 63, 64, 65, 95, 96, 97, 127, 128, 129, 191, 192, 193, 223, 224, 225,
    255, 256, 257, 383, 384, 385, 511, 512, 513, 600, 767, 768, 769, 1000,
    1023, 1024})
WIDE = (32768, 32769, 40000, 100003)


def _bulk_copies(plan, B, H, W):
    """Whether every chunk of a 16-byte aligned batch goes by one bulk copy
    under the kernel's rule (``csrc/augment.cu::load_chunk``: the source's
    address and length multiples of 16 bytes), under every flip. The first
    two images both aligned means ``H * W * 3 % 16 == 0``, and so every
    image."""
    return all((b * H * W * 3 + 3 * ps0) % 16 == 0 and 3 * n % 16 == 0
               for b in range(min(B, 2)) for j in range(plan.cluster)
               for h, v in itertools.product((False, True), repeat=2)
               for _, n, ps0 in ak.band_chunks(plan, H, W, j, h, v))


def _intervals_partition(intervals, lo, hi):
    """Whether the [a, a + n) cover [lo, hi) once."""
    pos = lo
    for a, n in sorted(intervals):
        if a != pos or n < 1:
            return False
        pos = a + n
    return pos == hi


@pytest.mark.parametrize("B", [1, 64])
def test_plan_covers_every_row_once_within_shared_memory(B):
    for H, W in itertools.chain(itertools.product(SIZES, SIZES),
                                itertools.product((1, 2, 3, 9), WIDE)):
        plan = ak.augment_plan(B, H, W)
        c = plan.cluster
        assert c == (8 if -(-H // 8) * 3 * W <= ak.FIVE_CTA_BAND else 16)
        bounds = plan.bounds
        assert bounds[0] == 0 and bounds[-1] == H
        assert all(a <= b for a, b in zip(bounds, bounds[1:]))
        assert max(b - a for a, b in zip(bounds, bounds[1:])) == -(-H // c)
        assert plan.smem_bytes % 16 == 0
        assert plan.chunk_bytes <= ak.SMEM_BUDGET
        assert plan.chunk_bytes + ak.STAGE_BYTES <= plan.smem_bytes \
            < plan.chunk_bytes + 16 + ak.STAGE_BYTES
        assert plan.smem_bytes + ak.STATIC_SMEM <= 227 * 1024
        whole_rows = plan.chunk_cols == W
        assert whole_rows or plan.chunk_rows == 1
        for hflip, vflip in itertools.product((False, True), repeat=2):
            src_rows = []
            for j in range(c):
                r0, r1 = bounds[j], bounds[j + 1]
                s0, s1 = plan.rows(H, j, vflip)
                assert s1 - s0 == r1 - r0 and (vflip or s0 == r0)
                src_rows.append((s0, s1 - s0))
                chunks = ak.band_chunks(plan, H, W, j, hflip, vflip)
                assert _intervals_partition([(q0, n) for q0, n, _ in chunks],
                                            r0 * W, r1 * W)
                assert _intervals_partition([(p, n) for _, n, p in chunks],
                                            s0 * W, s1 * W)
                for _, n, _ in chunks:
                    assert 3 * n <= plan.chunk_bytes
            # Every source row read once a pass (ranks with no rows aside).
            assert _intervals_partition([r for r in src_rows if r[1]], 0, H)
        if whole_rows and W * 3 % 16 == 0:
            assert _bulk_copies(plan, B, H, W)
        # A band is read once where it fits one chunk, else twice.
        chunked = -(-H // c) * W * 3 > ak.SMEM_BUDGET
        assert chunked == any(
            len(ak.band_chunks(plan, H, W, j, False, False)) > 1
            for j in range(c))


def test_plan_at_the_main_path_shapes():
    """The flagship's band is 28 rows x 672 B on 8 CTAs; the 384-px step's
    would be 48 x 1,152 B on 8, past the band that keeps five CTAs on an
    SM, so it takes 16 CTAs of 24 rows: one bulk copy a CTA, one read of
    each image."""
    p224 = ak.augment_plan(64, 224, 224)
    assert (p224.cluster, p224.chunk_rows, p224.chunk_bytes) == \
        (8, 28, 18816)
    assert _bulk_copies(p224, 64, 224, 224)
    p384 = ak.augment_plan(32, 384, 384)
    assert (p384.cluster, p384.chunk_rows, p384.chunk_bytes) == \
        (16, 24, 27648)
    assert _bulk_copies(p384, 32, 384, 384)
    assert 18816 <= ak.FIVE_CTA_BAND < 55296
    assert 5 * (27648 + ak.STAGE_BYTES + ak.STATIC_SMEM + 1024) \
        <= 228 * 1024
    odd = ak.augment_plan(3, 33, 35)
    assert not _bulk_copies(odd, 3, 33, 35) and odd.chunk_rows == 5
