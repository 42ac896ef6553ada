"""The port's CutMix / MixUp against the JAX package's, on the JAX draws.

The JAX package draws inside ``cutmix_or_mixup`` from one key; the test
reproduces its key splits (``mixing.py``: the coin from the first half of
the split, both specs from the second) and hands the coin, the permutation,
lam and the CutMix box to the port. Mixed images, ``labels_b`` and lam must
agree to fp32 rounding (1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.ops import mixing as jmix
from rovit_kan_tpu_torch.ops import mixing as mix

B, H, W = 6, 32, 32


def jax_draws(key, B=B, H=H, W=W, alpha_cut=1.0, alpha_mix=0.2):
    """The draws ``cutmix_or_mixup(key, ...)`` makes on a (B, H, W) batch,
    as the port's dict."""
    k_choice, k_mix = jax.random.split(key)
    pick = bool(jax.random.bernoulli(k_choice, 0.5))
    if not pick:
        perm, lam = jmix._mixup_spec(k_mix, B, alpha_mix)
        return {"cutmix": False, "perm": torch.from_numpy(np.array(perm)),
                "lam": float(lam)}
    k_lam, k_perm, k_x, k_y = jax.random.split(k_mix, 4)
    lam0 = jax.random.beta(k_lam, alpha_cut, alpha_cut)
    ratio = jnp.sqrt(1.0 - lam0)
    cut_h = int((H * ratio).astype(jnp.int32))
    cut_w = int((W * ratio).astype(jnp.int32))
    cy = int(jax.random.randint(k_y, (), 0, H))
    cx = int(jax.random.randint(k_x, (), 0, W))
    box = (int(np.clip(cy - cut_h // 2, 0, H)),
           int(np.clip(cy + cut_h // 2, 0, H)),
           int(np.clip(cx - cut_w // 2, 0, W)),
           int(np.clip(cx + cut_w // 2, 0, W)))
    return {"cutmix": True,
            "perm": torch.from_numpy(np.array(
                jax.random.permutation(k_perm, B))),
            "lam": float(lam0), "box": box}


@pytest.mark.parametrize("seed", range(8))
def test_mix_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (B, H, W, 3)).astype(np.float32)
    labels = rng.randint(0, 4, B).astype(np.int32)
    want, la, lb, lam = jmix.cutmix_or_mixup(key, jnp.asarray(x),
                                             jnp.asarray(labels))
    draws = jax_draws(key)
    got, ga, gb, glam = mix.cutmix_or_mixup(
        torch.from_numpy(x), torch.from_numpy(labels).long(), draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(la))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(lb))
    assert glam.dtype == torch.float32
    np.testing.assert_allclose(float(glam), float(lam), atol=1e-6)


def test_no_mix_passes_through():
    x = torch.randn(B, H, W, 3)
    labels = torch.arange(B)
    got, la, lb, lam = mix.cutmix_or_mixup(x, labels, None)
    assert got is x and torch.equal(la, labels) and torch.equal(lb, labels)
    assert float(lam) == 1.0


def test_draw_mix_from_a_generator():
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(40):
        d = mix.draw_mix(g, B, H, W)
        seen.add(d["cutmix"])
        assert sorted(d["perm"].tolist()) == list(range(B))
        assert 0.0 <= d["lam"] <= 1.0
        if d["cutmix"]:
            y0, y1, x0, x1 = d["box"]
            assert 0 <= y0 <= y1 <= H and 0 <= x0 <= x1 <= W
    assert seen == {True, False}
    assert mix.draw_mix(g, B, H, W, use_cutmix=False,
                        use_mixup=False) is None
    only = mix.draw_mix(g, B, H, W, use_mixup=False)
    assert only["cutmix"]


def test_beta_draws_have_the_right_mean():
    g = torch.Generator().manual_seed(1)
    for a in (0.2, 1.0):
        draws = [mix._beta(g, a, a) for _ in range(2000)]
        assert abs(np.mean(draws) - 0.5) < 0.03
        assert min(draws) >= 0.0 and max(draws) <= 1.0
