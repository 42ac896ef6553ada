"""The port's train step through the fused block against the JAX step
through its fused block (Pallas forward and backward kernels in interpret
mode), both fp32, four steps over stages 1-4 with the backbone live from the
third, so the fused backward's grads reach the updates: per-step loss at
1e-4 and final parameters at 2e-5, the precedents of
tests/test_train_parity.py. See tests/test_torch_train_step.py."""
import numpy as np

from test_torch_train_step import assert_params_match, run_pair


def test_fused_steps_match_jax():
    jlosses, tlosses, jparams, model = run_pair(4, fused=True)
    assert all(b.use_fused_block for b in model.backbone.model.blocks)
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-4, rtol=1e-4)
    assert_params_match(model, jparams)
