"""The port's train step against the JAX package's ``make_train_step``.

Both start from the same weights (the JAX tree through ``load_jax_params``)
with dropout 0, augmentation and mixing on, and take the same batches over
curriculum stages 1, 2, 3, 4, 4, 4 with the backbone frozen (grads zeroed,
scale 0) for the first two steps. On the CPU the JAX step takes the fp32
augment chain ``augment_batch``. Its draws are rebuilt from its own key
splits (``trainer.py``: ``rng, k_aug, k_mix, k_drop = split(rng, 4)``) and
handed to the port as ``draws``. Tolerances are the repo's precedents
(tests/test_train_parity.py): per-step loss 1e-4, final parameters 2e-5.
Every step's gradients are held too, since Adam's update is blind to the
scale of a gradient: the JAX side's optimizer is wrapped to keep the
gradients it was given, and each parameter's gradient must agree within
1e-3 of its largest magnitude (the fused-versus-XLA gradient precedent,
tests/test_block_kernel.py).
This file runs both sides unfused; tests/test_torch_train_fused.py runs them
through the fused block.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rovit_kan_tpu.config import Config as JaxConfig
from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
from rovit_kan_tpu.ops.augment_kernel import _draw_factors
from rovit_kan_tpu.training import optimizer as jopt
from rovit_kan_tpu.training.trainer import TrainState
from rovit_kan_tpu.training.trainer import \
    make_train_step as jax_make_train_step
from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.models.convert import (
    _jax_path,
    load_jax_params,
    to_jax_params,
)
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN
from rovit_kan_tpu_torch.ops import augment_kernel as ak
from rovit_kan_tpu_torch.ops import block_kernel as bk
from rovit_kan_tpu_torch.ops import kan_kernel as kk
from rovit_kan_tpu_torch.training import optimizer as topt
from rovit_kan_tpu_torch.training.trainer import (
    make_eval_step,
    make_train_step,
    use_fused_augment,
)
from test_torch_mixing import jax_draws

KW = dict(embed_dim=64, depth=2, num_heads=2, image_size=32, patch_size=16,
          kan_layers=(64, 8, 1), hidden_dim=16, dropout=0.0)
B, IMG, LR = 8, 32, 5e-4
STAGES = (1, 2, 3, 4, 4, 4)
ALPHA = np.asarray([1.1, 0.9, 1.0, 1.2], np.float32)


def _batch(step):
    rng = np.random.RandomState(100 + step)
    images = rng.randint(0, 256, (B, IMG, IMG, 3)).astype(np.uint8)
    labels = rng.randint(0, 4, B).astype(np.int32)
    return images, labels, labels.astype(np.float32)


def _keeping_grads(tx):
    """``tx`` whose state also holds the last gradients it was given."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def assert_grads_match(model, jgrads, step):
    """Each parameter's gradient against the JAX step's, in the JAX
    layout, within 1e-3 of its largest magnitude."""
    for name, p in model.named_parameters():
        path, transpose = _jax_path(name, p.dim())
        want = jgrads
        for key in path:
            want = want[key]
        want = np.asarray(want)
        got = p.grad.detach().numpy()
        got = got.T if transpose else got
        np.testing.assert_allclose(
            got, want, rtol=0, atol=1e-3 * max(np.abs(want).max(), 1e-12),
            err_msg=f"step {step}: {name}")


def run_pair(n_steps, fused, kan=False, attention=False):
    """Take ``n_steps`` on both sides, holding every step's gradients;
    ``fused`` routes both through the block kernel, ``kan`` through the KAN
    kernels, ``attention`` through the attention-only kernels. Returns (jax
    losses, port losses, jax params, port model)."""
    jcfg = JaxConfig()
    jcfg.flags.mixed_precision = False
    jcfg.train.learning_rate = LR
    flags = dict(use_pallas_block=fused, use_pallas_kan=kan,
                 use_pallas_attention=attention)
    jmodel = JaxRoViTKAN(**KW, **flags)
    params = jmodel.init(jax.random.PRNGKey(0),
                         np.zeros((1, IMG, IMG, 3), np.float32))["params"]
    pert = np.random.RandomState(0)
    params = jax.tree.map(lambda a: np.asarray(a) + pert.normal(
        0, 0.02, a.shape).astype(np.float32), params)
    tx = _keeping_grads(jopt.build_optimizer(jcfg, flat=True))
    state = TrainState(params=jax.tree.map(jnp.asarray, params),
                       opt_state=tx.init(params), rng=jax.random.PRNGKey(7),
                       step=jnp.zeros((), jnp.int32))
    jstep, _ = jax_make_train_step(jmodel, tx, jcfg, focal_alpha=ALPHA)

    cfg = Config()
    cfg.flags.mixed_precision = False
    cfg.train.learning_rate = LR
    model = load_jax_params(RoViTKAN(**KW, **flags), params, device="cpu")
    opt = topt.build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg, focal_alpha=ALPHA)
    assert not step.fused_augment            # fp32 on the CPU: plain chain

    jlosses, tlosses = [], []
    for i, stage in zip(range(n_steps), STAGES):
        live = 1.0 if i >= 2 else 0.0
        images, labels, sev = _batch(i)
        _, k_aug, k_mix, _ = jax.random.split(state.rng, 4)
        draws = {"factors": torch.from_numpy(np.array(
                     _draw_factors(k_aug, B, 0.2, 0.2, 0.2))),
                 "mix": jax_draws(k_mix, B, IMG, IMG), "dropout": None}

        state = state.replace(opt_state=(jopt.set_hyperparams(
            state.opt_state[0], LR, 0.1 * live), state.opt_state[1]))
        state, jm = jstep(state, {"images": jnp.asarray(images),
                                  "labels": jnp.asarray(labels),
                                  "severity": jnp.asarray(sev)},
                          jnp.int32(stage), jnp.float32(live),
                          jnp.float32(1.0))
        jlosses.append(float(jm["total_loss"]))

        topt.set_hyperparams(opt, LR, 0.1 * live)
        tm = step({"images": torch.from_numpy(images),
                   "labels": torch.from_numpy(labels).long(),
                   "severity": torch.from_numpy(sev)}, stage, live, 1,
                  draws=draws)
        tlosses.append(float(tm["total_loss"]))
        np.testing.assert_allclose(float(tm["accuracy"]),
                                   float(jm["accuracy"]), atol=1e-6)
        assert_grads_match(model, state.opt_state[1], i)
    assert ak.LAUNCHES == 0 and bk.LAUNCHES == 0 and bk.BWD_LAUNCHES == 0
    assert kk.LAUNCHES == 0 and kk.BWD_LAUNCHES == 0
    return np.asarray(jlosses), np.asarray(tlosses), state.params, model


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_params_match(model, jparams, atol=2e-5):
    got = dict(_flat(to_jax_params(model)))
    want = dict(_flat(jparams))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=atol, err_msg="/".join(k))


def test_unfused_steps_match_jax():
    jlosses, tlosses, jparams, model = run_pair(len(STAGES), fused=False)
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-4, rtol=1e-4)
    assert_params_match(model, jparams)


def test_step_draws_its_own_randomness_and_learns():
    """Without ``draws`` the step uses its generators: reproducible from
    the seed; on one repeated batch with mixing off the loss falls."""
    cfg = Config()
    cfg.flags.mixed_precision = False
    cfg.train.learning_rate = 1e-3

    def losses(seed):
        torch.manual_seed(0)
        model = RoViTKAN(**KW)
        opt = topt.build_optimizer(model, cfg)
        step = make_train_step(model, opt, cfg,
                               generator=torch.Generator().manual_seed(seed))
        images, labels, sev = _batch(0)
        batch = {"images": torch.from_numpy(images),
                 "labels": torch.from_numpy(labels).long(),
                 "severity": torch.from_numpy(sev)}
        return [float(step(batch, 4, 1.0, 0)["total_loss"])
                for _ in range(4)]

    a, b = losses(3), losses(3)
    assert a == b
    assert a[-1] < a[0]


def test_eval_step_masks_padding():
    cfg = Config()
    model = RoViTKAN(**KW)
    ev = make_eval_step(model, cfg, focal_alpha=ALPHA)
    images, labels, sev = _batch(1)
    batch = {"images": torch.from_numpy(images),
             "labels": torch.from_numpy(labels).long(),
             "severity": torch.from_numpy(sev),
             "valid": torch.ones(B)}
    full = ev(batch)
    assert float(full["n"]) == B and not model.training
    half = dict(batch, valid=torch.tensor([1.0] * 4 + [0.0] * 4))
    part = ev(half)
    sub = ev({k: v[:4] for k, v in batch.items()})
    np.testing.assert_allclose(float(part["total_loss"]),
                               float(sub["total_loss"]), atol=1e-6)
    assert float(part["correct"]) == float(sub["correct"])


def test_ema_follows_the_parameters():
    cfg = Config()
    cfg.train.ema_decay = 0.75
    model = RoViTKAN(**KW)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    opt = topt.build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg)
    images, labels, sev = _batch(2)
    step({"images": torch.from_numpy(images),
          "labels": torch.from_numpy(labels).long(),
          "severity": torch.from_numpy(sev)}, 4, 1.0, 1)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(step.ema[k], 0.75 * start[k] + 0.25 * v)


class _Chose(Exception):
    """Raised by the spies below with the augment the JAX step traced."""


def _jax_augment_choice(monkeypatch, jcfg, backend):
    """Which augment the JAX ``make_train_step`` traces under ``jcfg`` on
    ``backend``: spies stand in for both augment functions and stop the
    step at its first call."""
    import types
    from rovit_kan_tpu.training import trainer as jtrainer

    def spy(name):
        def fn(*args, **kwargs):
            raise _Chose(name)
        return fn

    monkeypatch.setattr(jtrainer, "fused_augment_batch", spy("fused"))
    monkeypatch.setattr(jtrainer, "augment_batch", spy("plain"))
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: backend)
        _, step_fn = jax_make_train_step(JaxRoViTKAN(**KW), optax.sgd(0.0),
                                         jcfg)
    state = types.SimpleNamespace(rng=jax.random.PRNGKey(0))
    try:
        step_fn(state, {"images": np.zeros((1, IMG, IMG, 3), np.uint8)},
                4, 1.0, 1.0)
    except _Chose as chose:
        return str(chose) == "fused"
    raise AssertionError("the JAX step traced no augment")


_UNSET = "unset"


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("mixed_precision", [True, False],
                         ids=["mp", "no_mp"])
@pytest.mark.parametrize("tpu_fa", [True, False],
                         ids=["tpu_on", "tpu_off"])
@pytest.mark.parametrize("train_fa", [_UNSET, True, False, "auto"],
                         ids=["train_unset", "train_on", "train_off",
                              "train_auto"])
def test_fused_augment_policy(monkeypatch, train_fa, tpu_fa,
                              mixed_precision, dtype, device):
    """The port takes the augment kernel exactly where the JAX step does:
    ``train.fused_augment`` forces it; unset or "auto" means the accelerator
    and ``flags.mixed_precision``, whatever the model's dtype;
    ``tpu.fused_augment`` is read by neither. A model on the card is
    held against the JAX step on the "tpu" backend, a CPU model against the
    "cpu" backend; the port's model reports its device, so no card is
    needed."""
    from rovit_kan_tpu_torch.training import trainer as ttrainer
    jcfg, cfg = JaxConfig(), Config()
    for c in (jcfg, cfg):
        c.flags.mixed_precision = mixed_precision
        c.tpu.fused_augment = tpu_fa
        if train_fa is not _UNSET:
            c.train.fused_augment = train_fa
    want = _jax_augment_choice(monkeypatch, jcfg,
                               "tpu" if device == "cuda" else "cpu")
    model = _policy_model(dtype)
    monkeypatch.setattr(ttrainer, "_device_of",
                        lambda m: torch.device(device))
    assert use_fused_augment(model, cfg) == want


@functools.lru_cache(maxsize=None)
def _policy_model(dtype):
    return RoViTKAN(**KW, dtype=dtype)
