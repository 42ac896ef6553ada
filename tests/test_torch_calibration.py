"""The port's temperature scaling against
``rovit_kan_tpu.evaluation.calibration``.

The module is a numpy copy, so every function must give the JAX module's
result exactly: the known-temperature recovery, both degenerate fits of
``tests/test_calibration.py`` (saturated NLL, and the bracket's low edge)
with their warning, a healthy fit, ``apply_temperature`` and
``reliability_curve`` with its NaN bins.
"""
import warnings

import numpy as np
import pytest

from rovit_kan_tpu.evaluation import calibration as JC
from rovit_kan_tpu_torch.evaluation import calibration as C


def _calibrated_logits(n=4000, k=4, seed=0):
    """Logits whose softmax is the label-generating distribution: the
    NLL-optimal temperature for these is 1."""
    rng = np.random.RandomState(seed)
    logits = rng.normal(0.0, 1.5, (n, k))
    z = logits - logits.max(axis=1, keepdims=True)
    p = np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)
    labels = np.array([rng.choice(k, p=pi) for pi in p])
    return logits, labels


def _saturated(seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 4, 512)
    logits = rng.normal(0.0, 0.5, (512, 4))
    logits[np.arange(512), labels] += 20.0
    return logits, labels


def _bracket_edge(seed=1):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 4, 512)
    logits = rng.normal(0.0, 0.1, (512, 4))
    logits[np.arange(512), labels] += 2.0
    return logits, labels


def test_constants_equal():
    assert C.T_FLOOR == JC.T_FLOOR and C.NLL_SATURATED == JC.NLL_SATURATED


@pytest.mark.parametrize("scale", [3.0, 0.5, 1.0])
def test_known_temperature_recovered_and_equal(scale):
    logits, labels = _calibrated_logits()
    got = C.fit_temperature_report(logits * scale, labels)
    assert got == JC.fit_temperature_report(logits * scale, labels)
    assert got["temperature"] == pytest.approx(scale, rel=0.1)
    assert not got["degenerate"]
    assert C.fit_temperature(logits * scale, labels) \
        == JC.fit_temperature(logits * scale, labels)


@pytest.mark.parametrize("make", [_saturated, _bracket_edge])
def test_degenerate_fits_equal_and_flagged(make):
    logits, labels = make()
    with pytest.warns(UserWarning, match="Degenerate temperature fit"):
        got = C.fit_temperature_report(logits, labels)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JC.fit_temperature_report(logits, labels)
    assert got == want
    assert got["degenerate"] is True and got["temperature"] >= C.T_FLOOR


def test_apply_temperature_equal():
    logits, _ = _calibrated_logits(n=257)
    for t in (1.0, 2.5, 0.3):
        got = C.apply_temperature(logits, t)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, JC.apply_temperature(logits, t))


def test_reliability_curve_equal_with_nan_bins():
    logits, labels = _calibrated_logits(n=300)
    probs = C.apply_temperature(logits * 0.2, 1.0)     # low confidences only
    for n_bins in (10, 7):
        got = C.reliability_curve(probs, labels, n_bins=n_bins)
        want = JC.reliability_curve(probs, labels, n_bins=n_bins)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.isnan(got["accuracy"]).any()
        assert got["fraction"].sum() == pytest.approx(1.0)
