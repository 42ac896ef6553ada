"""The port's ``Trainer`` against the JAX package's: device-resident
epochs, and preemption with resume.

The pairs of tests/test_torch_trainer.py (same weights, batches and draws;
per-epoch losses 1e-4, final parameters 2e-5): over ``DeviceLoader``s, the
port's loop of on-device gathers against the JAX trainer's one-``lax.scan``
epochs; and a SIGTERM in epoch 2, the preemption checkpoint and
``resume``.
"""
import signal

import numpy as np
import pytest

from rovit_kan_tpu.data.device_cache import DeviceLoader as JaxDeviceLoader
from rovit_kan_tpu_torch.data.device_cache import DeviceLoader
from test_torch_train_step import assert_params_match
from test_torch_trainer import B, _assert_histories_match, _pair


class _ArrayDS:
    def __init__(self, n=20):
        rng = np.random.RandomState(0)
        self.imgs = rng.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
        self.labels = rng.randint(0, 4, n)

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return self.imgs[i], int(self.labels[i]), float(self.labels[i])


def test_device_resident_epochs_match_jax_scanned_epochs(tmp_path):
    """Over ``DeviceLoader``s (20 images: two shuffled full batches per
    epoch, a padded validation tail) the port's loop of on-device gathers
    against the JAX trainer's one-``lax.scan`` epochs, two epochs."""
    ds = _ArrayDS()
    jtr, jstate, tr, state = _pair(tmp_path)
    for t in (jtr, tr):
        t.config.train.epochs = 2
    jtr.train_loader = JaxDeviceLoader(ds, B, shuffle=True, drop_last=True,
                                       seed=7)
    jtr.val_loader = JaxDeviceLoader(ds, B)
    tr.train_loader = DeviceLoader(ds, B, shuffle=True, drop_last=True,
                                   seed=7, device="cpu")
    tr.val_loader = DeviceLoader(ds, B, device="cpu")
    jres = jtr.fit(jstate)
    res = tr.fit(state)
    _assert_histories_match(res["history"], jres["history"])
    assert_params_match(tr.model, jres["state"].params)


def test_port_preemption_and_resume_match_jax(tmp_path):
    """SIGTERM in epoch 2 on both sides: the current state is saved as
    preempt_model and fit returns; resume continues at epoch 3 with the
    best loss and the patience counter restored, and the resumed run (the
    JAX trainer restarts its key) matches; a completed fit removes the
    preemption checkpoint; the default SIGTERM handler is back."""
    jtr, jstate, tr, state = _pair(tmp_path, signal_epoch=2)
    jres = jtr.fit(jstate)
    res = tr.fit(state)
    assert res["preempted"] and jres["preempted"]
    assert len(res["history"]["train"]) == 2
    _assert_histories_match(res["history"], jres["history"])
    assert (tmp_path / "t" / "preempt_model").exists()
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL,
                                                signal.default_int_handler)

    jstate2, jnext = jtr.resume("preempt_model")
    state2, tnext = tr.resume("preempt_model")
    assert tnext == jnext == 3
    assert tr.best_val_loss == pytest.approx(jtr.best_val_loss, rel=1e-4)
    assert tr.epochs_without_improvement == jtr.epochs_without_improvement
    assert_params_match(tr.model, jstate2.params)
    assert tr.optimizer.count == int(jstate2.opt_state.inner_state.count)
    jres2 = jtr.fit(jstate2, start_epoch=jnext)
    res2 = tr.fit(state2, start_epoch=tnext)
    assert not res2["preempted"]
    _assert_histories_match(res2["history"], jres2["history"])
    assert_params_match(tr.model, jres2["state"].params)
    assert not (tmp_path / "t" / "preempt_model").exists()
