"""The small and base presets (d = 384 and 768, 6 and 12 heads of 64,
hidden 4d) in the port against the JAX package, on the fused block.

Both sides run ``use_pallas_block=True`` at depth 2 and 32 px, the weights
the JAX tree's carried across by ``load_jax_params``: the JAX block is the
Pallas kernel in interpret mode, the port's the kernels' plain versions
(the CPU path of the wide stages the card runs). The forward in fp32 at
2e-5 (the repo's full-model precedent, docs/VALIDATION.md); one small train
step with the backbone live, so the block's backward reaches the update,
against the JAX ``make_train_step``: the loss within 1e-4 and every
gradient within 1e-3 of its leaf's largest (``run_pair``), the parameters
after it within 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
from rovit_kan_tpu_torch.config import get_config
from rovit_kan_tpu_torch.models.convert import load_jax_params, to_jax_params
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN, init_weights
from rovit_kan_tpu_torch.ops import block_kernel as bk
from test_torch_model import OUTPUTS
from test_torch_train_step import assert_params_match, run_pair


def preset_kw(preset: str) -> dict:
    """The preset's model widths at depth 2, 32 px, on the fused block."""
    m = get_config(preset).model
    return dict(embed_dim=m.embed_dim, num_heads=m.num_heads, depth=2,
                image_size=32, patch_size=m.patch_size,
                kan_layers=tuple(m.kan_layers), hidden_dim=m.hidden_dim,
                use_pallas_block=True)


@pytest.mark.parametrize("preset", ["small", "base"])
def test_preset_forward_matches_jax(preset):
    kw = preset_kw(preset)
    # Seeded weights with every leaf moved off its init, in the JAX tree
    # (the port's initializers are the JAX package's; to_jax_params is
    # load_jax_params' inverse, held by tests/test_torch_model.py).
    seed_model = RoViTKAN(**kw)
    init_weights(seed_model, seed=3)
    rng = np.random.RandomState(3)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.02, a.shape).astype(np.float32), to_jax_params(seed_model))
    images = rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = JaxRoViTKAN(**kw).apply({"params": params}, jnp.asarray(images),
                                   deterministic=True)
    model = load_jax_params(RoViTKAN(**kw), params, device="cpu").eval()
    assert all(b.use_fused_block for b in model.backbone.model.blocks)
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert bk.LAUNCHES == 0
    for k in OUTPUTS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-5, rtol=0, err_msg=k)


def test_small_preset_steps_match_jax():
    kw = preset_kw("small")
    kw.pop("use_pallas_block")
    jlosses, tlosses, jparams, model = run_pair(1, fused=True, model_kw=kw,
                                                live_from=0)
    assert all(b.use_fused_block for b in model.backbone.model.blocks)
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-4, rtol=1e-4)
    assert_params_match(model, jparams)
