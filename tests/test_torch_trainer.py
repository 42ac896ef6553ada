"""The port's ``Trainer`` against the JAX package's.

Both fit the tests/test_trainer.py configuration (32 px, batch 8, four
epochs over curriculum stages 1-4, the backbone frozen in epoch 1, fp32)
from the same weights, over the same two batches, dropout 0 and the JAX
step's augment and mix draws handed to the port (rebuilt from its key
splits, as tests/test_torch_train_step.py does). Tolerances are the repo's
precedents (tests/test_train_parity.py): per-epoch losses 1e-4, final
parameters 2e-5; the validation accuracy, the learning rate, the stage, the
best epoch and the epoch the run stopped at must be equal.
"""
import csv
import os
import signal

import jax
import numpy as np
import pytest
import torch

from rovit_kan_tpu.config import get_config
from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
from rovit_kan_tpu.ops.augment_kernel import _draw_factors
from rovit_kan_tpu.parallel.mesh import make_mesh
from rovit_kan_tpu.results import logger as jlog
from rovit_kan_tpu.training import optimizer as jopt
from rovit_kan_tpu.training.trainer import Trainer as JaxTrainer
from rovit_kan_tpu.utils import checkpoint as jck
from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.models.convert import load_jax_params
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN
from rovit_kan_tpu_torch.results import logger as tlog
from rovit_kan_tpu_torch.training import optimizer as topt
from rovit_kan_tpu_torch.training.trainer import Trainer, make_train_step
from rovit_kan_tpu_torch.utils import checkpoint as tck
from test_torch_mixing import jax_draws
from test_torch_train_step import assert_params_match

KW = dict(embed_dim=32, depth=1, num_heads=2, image_size=32, patch_size=16,
          kan_layers=(32, 8, 1), hidden_dim=16, dropout=0.0)
B = 8


def _fields(cfg, tmp):
    cfg.data.image_size = 32
    cfg.train.batch_size = B
    cfg.train.epochs = 4
    cfg.train.stage_1_epochs = 1
    cfg.train.stage_2_epochs = 2
    cfg.train.stage_3_epochs = 3
    cfg.train.early_stop_patience = 2
    cfg.train.learning_rate = 1e-3
    cfg.flags.freeze_backbone_epochs = 1
    cfg.flags.mixed_precision = False
    cfg.paths.checkpoints_dir = tmp
    return cfg


class _FakeLoader:
    """Numpy batches, as ``data.dataset.Loader`` yields them; sends SIGTERM
    to this process when epoch ``signal_epoch`` starts."""

    def __init__(self, batches, signal_epoch=None):
        self.batches = batches
        self.signal_epoch = signal_epoch
        self.epoch = 0

    def __iter__(self):
        self.epoch += 1
        if self.epoch == self.signal_epoch:
            os.kill(os.getpid(), signal.SIGTERM)
        return iter([dict(b) for b in self.batches])

    def __len__(self):
        return len(self.batches)


def _batches(n=2):
    rng = np.random.RandomState(0)
    return [{"images": rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8),
             "labels": rng.randint(0, 4, (B,)).astype(np.int32),
             "severity": rng.randint(0, 4, (B,)).astype(np.float32),
             "valid": np.ones(B, np.float32)} for _ in range(n)]


def _jax_draw_stream(rng):
    """The JAX train step's draws, step after step, from its state's key
    (``rng, k_aug, k_mix, k_drop = split(rng, 4)`` per step)."""
    while True:
        rng, k_aug, k_mix, _ = jax.random.split(rng, 4)
        yield {"factors": torch.from_numpy(np.array(
                   _draw_factors(k_aug, B, 0.2, 0.2, 0.2))),
               "mix": jax_draws(k_mix, B, 32, 32), "dropout": None}


def _pair(tmp, signal_epoch=None):
    """A JAX trainer and a port trainer from the same weights; the port's
    step draws what the JAX step draws, restarting where the JAX trainer
    restarts its key (init_state and resume)."""
    batches = _batches()
    jtr = JaxTrainer(JaxRoViTKAN(**KW), _FakeLoader(batches, signal_epoch),
                     _FakeLoader(batches), _fields(get_config(), tmp / "j"),
                     mesh=make_mesh(1), seed=0)
    jstate = jtr.init_state()
    key = np.asarray(jstate.rng).copy()     # the JAX fit donates its state
    params = jax.tree.map(np.array, jstate.params)
    model = load_jax_params(RoViTKAN(**KW), params, device="cpu")
    tr = Trainer(model, _FakeLoader(batches, signal_epoch),
                 _FakeLoader(batches), _fields(Config(), tmp / "t"), seed=0)
    stream = {"it": _jax_draw_stream(key)}
    tr.train_step.draw = lambda *args: next(stream["it"])
    real_init = tr.init_state

    def init_state(p=None):        # the JAX trainer restarts its key here
        stream["it"] = _jax_draw_stream(key)
        return real_init(p)

    tr.init_state = init_state
    return jtr, jstate, tr, tr.init_state(model.state_dict())


def _assert_histories_match(th, jh):
    assert len(th["train"]) == len(jh["train"])
    for t, j in zip(th["train"], jh["train"]):
        assert t["stage"] == j["stage"] and t["lr"] == j["lr"]
        for k in ("total_loss", "cls_loss", "ord_loss", "unc_loss",
                  "kan_loss", "accuracy"):
            np.testing.assert_allclose(t[k], j[k], atol=1e-4, rtol=1e-4,
                                       err_msg=k)
    for t, j in zip(th["val"], jh["val"]):
        assert t["accuracy"] == pytest.approx(j["accuracy"], abs=1e-6)
        for k in ("total_loss", "cls_loss", "ord_loss", "unc_loss",
                  "kan_loss"):
            np.testing.assert_allclose(t[k], j[k], atol=1e-4, rtol=1e-4,
                                       err_msg=k)


class _ShiftingLoader(_FakeLoader):
    """Validation batches whose labels and severities move away from the
    training ones from epoch 2 on, so the validation loss rises there."""

    def __iter__(self):
        self.epoch += 1
        if self.epoch == 1:
            return iter([dict(b) for b in self.batches])
        return iter([dict(b, labels=(b["labels"] + 2) % 4,
                          severity=3.0 - b["severity"])
                     for b in self.batches])


@pytest.mark.parametrize("early_stop", [False, True],
                         ids=["four-epochs", "early-stop"])
def test_port_fit_matches_jax_fit(tmp_path, early_stop):
    """Four epochs; or, with the validation batches shifting from epoch 2
    on and a patience of 1, a run that stops early (at the same epoch on
    both sides)."""
    jtr, jstate, tr, state = _pair(tmp_path)
    if early_stop:
        for t in (jtr, tr):
            t.config.train.early_stop_patience = 1
            t.val_loader = _ShiftingLoader(_batches())
    jtr.logger = jlog.ExperimentLogger(tmp_path / "j", "run")
    tr.logger = tlog.ExperimentLogger(tmp_path / "t", "run")
    jres = jtr.fit(jstate)
    res = tr.fit(state)
    _assert_histories_match(res["history"], jres["history"])
    # The epoch CSVs: the same columns and epochs, values within 1e-4.
    with open(tmp_path / "t" / "run_epochs.csv") as f:
        trows = list(csv.DictReader(f))
    with open(tmp_path / "j" / "run_epochs.csv") as f:
        jrows = list(csv.DictReader(f))
    assert len(trows) == len(jrows) == len(res["history"]["train"])
    for t, j in zip(trows, jrows):
        assert list(t) == list(j) and t["epoch"] == j["epoch"]
        np.testing.assert_allclose([float(t[k]) for k in t],
                                   [float(j[k]) for k in j], atol=1e-4)
    assert res["best_val_loss"] == pytest.approx(jres["best_val_loss"],
                                                 rel=1e-4)
    assert res["improved"] == jres["improved"] and not res["preempted"]
    # The best epoch, from the sidecars of the two best_model checkpoints.
    jmeta = jck.load_meta(tmp_path / "j" / "best_model")
    tmeta = tck.load_meta(tmp_path / "t" / "best_model")
    assert tmeta["epoch"] == jmeta["epoch"]
    assert tmeta["epochs_without_improvement"] == \
        jmeta["epochs_without_improvement"]
    assert (len(res["history"]["train"]) < 4) == early_stop
    assert_params_match(tr.model, jres["state"].params)
    # best_state is a snapshot of the best epoch, not the live state.
    assert res["best_state"].params is not res["state"].params


def test_fit_refuses_a_padding_train_loader(tmp_path):
    model = RoViTKAN(**KW)
    loader = _FakeLoader(_batches())
    loader.drop_last = False
    tr = Trainer(model, loader, loader, _fields(Config(), tmp_path), seed=0)
    with pytest.raises(ValueError, match="drop_last"):
        tr.fit()


def test_accumulation_matches_jax_multisteps(tmp_path):
    """``accum_steps=2`` over two gradients against the JAX flat AdamW
    wrapped in ``optax.MultiSteps`` over the same gradients: no update after
    the first, then the update of their mean (1e-6); and against one step
    of the mean at ``accum_steps=1``."""
    cfg = _fields(Config(), tmp_path)
    jcfg = _fields(get_config(), tmp_path)
    rng = np.random.RandomState(0)
    model = RoViTKAN(**KW)
    grads = [{k: rng.normal(0, 1, p.shape).astype(np.float32)
              for k, p in model.named_parameters()} for _ in range(2)]

    def port(accum, steps):
        torch.manual_seed(0)
        m = RoViTKAN(**KW)
        cfg.train.accum_steps = accum
        opt = topt.build_optimizer(m, cfg)
        topt.set_hyperparams(opt, 1e-3, 0.1)
        start = {k: v.clone() for k, v in m.state_dict().items()}
        for g in steps:
            opt.zero_grad()
            for k, p in m.named_parameters():
                p.grad.copy_(torch.from_numpy(g[k]))
            opt.step()
            yield {k: (m.state_dict()[k] - start[k]).numpy()
                   for k in start}, opt

    mean = {k: (grads[0][k] + grads[1][k]) / 2 for k in grads[0]}
    (full, _), = port(1, [mean])
    (first, opt), (second, _) = port(2, grads)
    assert opt.applied and opt.count == 1
    assert all(np.abs(v).max() == 0.0 for v in first.values())
    for k in full:
        np.testing.assert_allclose(second[k], full[k], atol=1e-6, err_msg=k)

    # The JAX MultiSteps over the same gradients, in its layout.
    from rovit_kan_tpu_torch.models.convert import _jax_path
    jcfg.train.accum_steps = 2
    tx = jopt.build_optimizer(jcfg, flat=True)
    torch.manual_seed(0)
    m0 = RoViTKAN(**KW)

    def tree(values):
        out = {}
        for k, p in m0.named_parameters():
            path, transpose = _jax_path(k, p.dim())
            node = out
            for part in path[:-1]:
                node = node.setdefault(part, {})
            v = values[k]
            node[path[-1]] = np.ascontiguousarray(v.T if transpose else v)
        return out

    params = tree({k: v.detach().numpy() for k, v in m0.named_parameters()})
    state = jopt.set_hyperparams(tx.init(params), 1e-3, 0.1)
    for g in grads:
        up, state = tx.update(tree(g), state, params)
    got = tree(second)

    def flat(t, prefix=()):
        for k, v in sorted(t.items()):
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), np.asarray(v)

    want = dict(flat(up))
    for k, v in flat(got):
        np.testing.assert_allclose(v, want[k], atol=1e-6, err_msg=str(k))


def test_accumulated_half_batches_match_one_step_at_twice_the_batch(
        tmp_path):
    """Two train steps over the halves of a batch at ``accum_steps=2`` move
    the parameters as one step over the whole batch does (every loss term
    is a batch mean, so the mean of the halves' gradients is the whole
    batch's gradient; sums in another order: 1e-6)."""
    b = _batches(1)[0]
    batch = {"images": torch.from_numpy(b["images"]),
             "labels": torch.from_numpy(b["labels"]).long(),
             "severity": torch.from_numpy(b["severity"])}
    factors = torch.rand((B, 8), generator=torch.Generator().manual_seed(1))
    factors[:, :2] = (factors[:, :2] < 0.5).float()

    def run(accum):
        cfg = _fields(Config(), tmp_path)
        cfg.train.accum_steps = accum
        torch.manual_seed(0)
        model = RoViTKAN(**KW)
        opt = topt.build_optimizer(model, cfg)
        step = make_train_step(model, opt, cfg)
        n = B // accum
        for i in range(accum):
            part = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            step(part, 4, 1.0, 0, draws={"factors": factors[i * n:(i + 1) * n],
                                         "mix": None, "dropout": None})
        assert opt.applied and opt.count == 1
        return model.state_dict()

    whole, halves = run(1), run(2)
    for k, v in whole.items():
        torch.testing.assert_close(halves[k], v, atol=1e-6, rtol=0)


def test_ema_freezes_on_accumulation_micro_steps(tmp_path):
    """With accum_steps=2 and ema_decay 0.5 the EMA stays put on the first
    call and moves on the second, to 0.5 * start + 0.5 * the parameters."""
    cfg = _fields(Config(), tmp_path)
    cfg.train.accum_steps = 2
    cfg.train.ema_decay = 0.5
    torch.manual_seed(0)
    model = RoViTKAN(**KW)
    opt = topt.build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg)
    b = _batches(1)[0]
    batch = {"images": torch.from_numpy(b["images"]),
             "labels": torch.from_numpy(b["labels"]).long(),
             "severity": torch.from_numpy(b["severity"])}
    start = {k: v.clone() for k, v in step.ema.items()}
    step(batch, 1, 1.0, 0)
    assert not opt.applied
    for k, v in step.ema.items():
        assert torch.equal(v, start[k]), k
        assert torch.equal(model.state_dict()[k], start[k]), k
    step(batch, 1, 1.0, 0)
    assert opt.applied and opt.count == 1
    moved = False
    for k, v in model.state_dict().items():
        torch.testing.assert_close(step.ema[k], 0.5 * start[k] + 0.5 * v)
        moved |= not torch.equal(v, start[k])
    assert moved
