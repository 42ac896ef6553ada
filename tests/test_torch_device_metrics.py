"""The port's on-device metrics against ``rovit_kan_tpu.ops.device_metrics``
on the CPU, within 1e-6: padded rows (``valid = 0``), tied severities,
confidences at each of the JAX ECE edges' fp32 bits and one ulp either
side, and the invariance of every metric to padding. The confusion matrix
is equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.ops import device_metrics as JD
from rovit_kan_tpu_torch.ops import device_metrics as D

SCALARS = ("accuracy", "macro_f1", "mae", "spearman_rho", "brier_score",
           "ece")


def _data(n=100, pad=0, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 4, n)
    logits = rng.randn(n, 4)
    logits[np.arange(n), labels] += 1.5
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True))
    sev_true = labels.astype(np.float32)                   # 4 tie groups
    sev_pred = np.round(sev_true + rng.randn(n) * 0.7, 1)  # more ties
    valid = np.ones(n, np.float32)
    if pad:
        probs = np.concatenate([probs, rng.dirichlet(np.ones(4), pad)])
        labels = np.concatenate([labels, rng.randint(0, 4, pad)])
        sev_true = np.concatenate([sev_true, np.zeros(pad)])
        sev_pred = np.concatenate([sev_pred, rng.randn(pad) * 5])
        valid = np.concatenate([valid, np.zeros(pad, np.float32)])
    return (probs.astype(np.float32), labels.astype(np.int32),
            sev_pred.astype(np.float32), sev_true.astype(np.float32), valid)


def _both(probs, labels, sev_pred, sev_true, valid):
    got = D.all_metrics(*(torch.from_numpy(np.asarray(a)) for a in
                          (probs, labels, sev_pred, sev_true, valid)))
    want = JD.all_metrics(*(jnp.asarray(a) for a in
                            (probs, labels, sev_pred, sev_true, valid)))
    return got, want


def _hold(got, want):
    for k in SCALARS:
        assert got[k].shape == () and got[k].dtype == torch.float32, k
        assert float(got[k]) == pytest.approx(float(want[k]), abs=1e-6), k
    np.testing.assert_array_equal(got["confusion_matrix"].numpy(),
                                  np.asarray(want["confusion_matrix"]))
    assert got["confusion_matrix"].dtype == torch.float32


@pytest.mark.parametrize("pad", [0, 1, 28])
def test_all_metrics_match_jax(pad):
    _hold(*_both(*_data(pad=pad)))


def test_padding_invariance():
    a = D.all_metrics(*(torch.from_numpy(x) for x in _data()))
    b = D.all_metrics(*(torch.from_numpy(x) for x in _data(pad=28)))
    for k in SCALARS:
        assert float(a[k]) == pytest.approx(float(b[k]), abs=1e-6), k
    torch.testing.assert_close(a["confusion_matrix"], b["confusion_matrix"],
                               rtol=0, atol=0)


def test_tied_severities_match_jax_and_scipy():
    from scipy.stats import spearmanr
    rng = np.random.RandomState(1)
    a = rng.randint(0, 4, 60).astype(np.float32)
    b = rng.randint(0, 4, 60).astype(np.float32)
    np.testing.assert_array_equal(D._average_ranks(torch.from_numpy(a)),
                                  np.asarray(JD._average_ranks(
                                      jnp.asarray(a))))
    got = float(D.spearman_rho(torch.from_numpy(a), torch.from_numpy(b)))
    assert got == pytest.approx(float(JD.spearman_rho(jnp.asarray(a),
                                                      jnp.asarray(b))),
                                abs=1e-6)
    assert got == pytest.approx(spearmanr(a, b).statistic, abs=1e-5)


@pytest.mark.parametrize("n_bins", [10, 15])
def test_bin_edges_are_jax_bits(n_bins):
    got = D.bin_edges(n_bins).numpy()
    want = np.asarray(jnp.linspace(0.0, 1.0, n_bins + 1))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if n_bins == 10:
        assert got.view(np.uint32)[9] == 0x3F666667
        assert torch.linspace(0.0, 1.0, 11).numpy().view(np.uint32)[9] \
            == 0x3F666666


def test_ece_at_each_edge_and_one_ulp_either_side():
    """Top-class confidences at every interior edge's bits and one ulp
    below and above it (where the (lo, hi] bins must split exactly as
    JAX's), the top class right or wrong."""
    edges = np.asarray(jnp.linspace(0.0, 1.0, 11))
    conf = []
    for e in edges[3:10]:                        # above 1/4: a top class
        conf += [np.nextafter(e, np.float32(0)), e,
                 np.nextafter(e, np.float32(1))]
    conf = np.asarray(conf + [1.0], np.float32)
    n = conf.size
    probs = np.zeros((n, 4), np.float32)
    probs[:, 0] = conf
    probs[:, 1:] = ((1.0 - conf) / 3.0)[:, None]
    labels = np.where(np.arange(n) % 2 == 0, 0, 1).astype(np.int32)
    valid = np.ones(n, np.float32)
    valid[-1] = 0.0
    for v in (None, valid):
        got = D.ece(torch.from_numpy(probs), torch.from_numpy(labels),
                    valid=None if v is None else torch.from_numpy(v))
        want = JD.ece(jnp.asarray(probs), jnp.asarray(labels),
                      valid=None if v is None else jnp.asarray(v))
        assert float(got) == pytest.approx(float(want), abs=1e-6)
    # Each confidence lands in JAX's bin: the torch/numpy edge 0.9 would put
    # the edge's own value in the bin above.
    c = torch.from_numpy(conf)
    e = D.bin_edges(10)
    got_bin = ((c[:, None] > e[None, :-1]) & (c[:, None] <= e[None, 1:])
               ).float().argmax(1)
    want_bin = np.searchsorted(edges, conf, side="left") - 1
    np.testing.assert_array_equal(got_bin.numpy(), want_bin)
