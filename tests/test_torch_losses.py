"""The port's joint loss and flat AdamW against the JAX package's.

``joint_loss`` at every curriculum stage, with and without the mix dict and
the ``valid`` mask, with each head toggled off: 1e-6 (fp32, the same
reductions). The flat AdamW over three updates of a converted parameter
tree, the backbone frozen (scale 0, grads zeroed) for the first and live at
0.1 after, against the JAX ``build_optimizer(flat=True)``: 1e-6 on every
parameter (only the global-norm summation order differs).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.config import Config as JaxConfig
from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
from rovit_kan_tpu.training import losses as jl
from rovit_kan_tpu.training import optimizer as jopt
from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.models.convert import load_jax_params, to_jax_params
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN
from rovit_kan_tpu_torch.training import losses as tl
from rovit_kan_tpu_torch.training import optimizer as topt

KW = dict(embed_dim=64, depth=1, num_heads=2, image_size=32, patch_size=16,
          kan_layers=(64, 8, 1), hidden_dim=16)
B = 8


def _outputs(rng):
    return {"cls_logits": rng.normal(0, 2, (B, 4)).astype(np.float32),
            "ordinal_logits": rng.normal(0, 2, (B, 3)).astype(np.float32),
            "mu": rng.normal(0, 1, (B, 1)).astype(np.float32),
            "log_var": rng.normal(0, 1, (B, 1)).astype(np.float32),
            "kan_severity": rng.uniform(0, 3, (B, 1)).astype(np.float32)}


HEADS = [{"ordinal": o, "uncertainty": u, "kan": k}
         for o, u, k in [(True, True, True), (False, True, True),
                         (True, False, True), (True, True, False)]]


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
@pytest.mark.parametrize("mixed,masked",
                         list(itertools.product([False, True], repeat=2)))
def test_joint_loss_matches_jax(stage, mixed, masked):
    rng = np.random.RandomState(stage + 2 * mixed + 4 * masked)
    out = _outputs(rng)
    labels = rng.randint(0, 4, B).astype(np.int32)
    sev = labels.astype(np.float32)
    alpha = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    mix = valid = None
    if mixed:
        mix = {"labels_a": labels, "labels_b": labels[rng.permutation(B)],
               "lam": np.float32(rng.uniform())}
    if masked:
        valid = (rng.uniform(size=B) > 0.3).astype(np.float32)
    for heads in HEADS:
        kw = dict(lambda_ord=1.0, mu_unc=0.5, nu_kan=0.5, focal_gamma=2.0,
                  head_mask=heads)
        want = jl.joint_loss(
            {k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(labels),
            jnp.asarray(sev), stage, focal_alpha=jnp.asarray(alpha),
            mixup=None if mix is None else
            {k: jnp.asarray(v) for k, v in mix.items()},
            valid=None if valid is None else jnp.asarray(valid), **kw)
        t = torch.from_numpy
        got = tl.joint_loss(
            {k: t(v) for k, v in out.items()}, t(labels).long(), t(sev),
            stage, focal_alpha=t(alpha),
            mixup=None if mix is None else
            {"labels_a": t(mix["labels_a"]).long(),
             "labels_b": t(mix["labels_b"]).long(),
             "lam": torch.tensor(mix["lam"])},
            valid=None if valid is None else t(valid), **kw)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       atol=1e-6, rtol=1e-6,
                                       err_msg=f"{k} {heads}")


def test_single_losses_match_jax():
    rng = np.random.RandomState(9)
    out = _outputs(rng)
    labels = rng.randint(0, 4, B).astype(np.int32)
    sev = labels.astype(np.float32)
    t, j = torch.from_numpy, jnp.asarray
    pairs = [
        (tl.focal_loss(t(out["cls_logits"]), t(labels).long()),
         jl.focal_loss(j(out["cls_logits"]), j(labels))),
        (tl.ordinal_bce_loss(t(out["ordinal_logits"]), t(sev)),
         jl.ordinal_bce_loss(j(out["ordinal_logits"]), j(sev))),
        (tl.uncertainty_loss(t(out["mu"]), t(out["log_var"]), t(sev)),
         jl.uncertainty_loss(j(out["mu"]), j(out["log_var"]), j(sev))),
        (tl.kan_regression_loss(t(out["kan_severity"]), t(sev)),
         jl.kan_regression_loss(j(out["kan_severity"]), j(sev)))]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), atol=1e-6)


@pytest.fixture(scope="module")
def jax_tree():
    m = JaxRoViTKAN(**KW)
    params = m.init(jax.random.PRNGKey(0),
                    np.zeros((1, 32, 32, 3), np.float32))["params"]
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), params)
    grads = [jax.tree.map(lambda a: rng.normal(0, s, a.shape).astype(
        np.float32), params) for s in (0.01, 1.0, 0.1)]
    return params, grads


def test_flat_adamw_matches_jax(jax_tree):
    params, grads = jax_tree
    jcfg = JaxConfig()
    jcfg.train.learning_rate = 1e-3
    tx = jopt.build_optimizer(jcfg, flat=True)
    state = tx.init(params)
    jp = jax.tree.map(jnp.asarray, params)

    cfg = Config()
    cfg.train.learning_rate = 1e-3
    model = load_jax_params(RoViTKAN(**KW), params, device="cpu")
    opt = topt.build_optimizer(model, cfg)
    holder = RoViTKAN(**KW)

    for i, (g, scale, live) in enumerate(zip(grads, (0.0, 0.1, 0.1),
                                             (0.0, 1.0, 1.0))):
        state = jopt.set_hyperparams(state, 1e-3, scale)
        jg = jopt.zero_backbone_grads(jax.tree.map(jnp.asarray, g), live)
        updates, state = tx.update(jg, state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)

        topt.set_hyperparams(opt, 1e-3, scale)
        load_jax_params(holder, g, device="cpu")
        opt.zero_grad()
        src = dict(holder.named_parameters())
        for name, p in model.named_parameters():
            p.grad.copy_(src[name].detach())
        topt.zero_backbone_grads(opt, live)
        opt.step()

        got = to_jax_params(model)
        for (path, want), (_, have) in zip(
                jax.tree_util.tree_flatten_with_path(jp)[0],
                jax.tree_util.tree_flatten_with_path(got)[0]):
            np.testing.assert_allclose(np.asarray(have), np.asarray(want),
                                       atol=1e-6, rtol=0,
                                       err_msg=f"update {i} {path}")
    frozen = to_jax_params(model)["backbone"]["pos_embed"]
    assert not np.allclose(frozen, params["backbone"]["pos_embed"])


def test_optimizer_schedule_and_refusals():
    cfg = Config()
    assert topt.cosine_lr(cfg, 1) == pytest.approx(cfg.train.learning_rate)
    assert topt.cosine_lr(cfg, cfg.train.epochs + 1) == pytest.approx(1e-6)
    assert topt.cosine_schedule(1.0, 2, 4, 0.0) == pytest.approx(
        jopt.cosine_schedule(1.0, 2, 4, 0.0))
    # Gradient accumulation is built (optax.MultiSteps semantics, held in
    # tests/test_torch_trainer.py); a state of another structure is refused.
    cfg.train.accum_steps = 2
    opt = topt.build_optimizer(RoViTKAN(**KW), cfg)
    assert opt.accum_steps == 2 and opt.applied
    one = topt.build_optimizer(RoViTKAN(**KW), Config())
    with pytest.raises(ValueError, match="another structure"):
        opt.load_state_dict(one.state_dict())


def test_frozen_backbone_does_not_move():
    model = RoViTKAN(**KW)
    opt = topt.build_optimizer(model, Config())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    topt.set_hyperparams(opt, 1e-3, 0.0)
    model(torch.randn(2, 32, 32, 3))["cls_logits"].sum().backward()
    topt.zero_backbone_grads(opt, 0.0)
    opt.step()
    moved = {k for k, v in model.state_dict().items()
             if not torch.equal(v, before[k])}
    assert moved and all(not k.startswith("backbone.") for k in moved)
