"""The port's KAN explainability against the JAX package: the activation
trajectory (tests/test_explainability.py's check, 1e-5), the spline curves,
the spline-weight access, and the four figures."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.explainability.kan_viz import \
    kan_trajectory as jax_kan_trajectory
from rovit_kan_tpu.models.kan import get_spline_weights as jax_spline_weights
from rovit_kan_tpu.ops.spline import spline_curve as jax_spline_curve
from rovit_kan_tpu_torch.explainability.kan_viz import (
    KANVisualizer,
    kan_trajectory,
)
from rovit_kan_tpu_torch.models.kan import (
    KANSeverityModule,
    get_spline_weights,
)
from rovit_kan_tpu_torch.ops.spline import make_knots, spline_curve
from test_torch_kan_kernel import _jax_kan_params, load_kan

DIMS = (16, 8, 1)


@pytest.fixture(scope="module")
def pair():
    params = _jax_kan_params(DIMS, seed=1)
    return params, load_kan(KANSeverityModule(DIMS), params)


@pytest.mark.parametrize("source", ["module", "state_dict"])
def test_kan_trajectory_matches_jax(pair, source):
    params, kan = pair
    x = np.random.RandomState(5).randn(4, 16).astype(np.float32)
    want = jax_kan_trajectory(params, jnp.asarray(x))
    got = kan_trajectory(kan if source == "module" else kan.state_dict(),
                         torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    assert got[-1].min() >= 0.0 and got[-1].max() <= 3.0


def test_spline_weights_and_curves_match_jax(pair):
    params, kan = pair
    want = jax_spline_weights(params)
    for got in (get_spline_weights(kan),
                get_spline_weights(kan.state_dict())):
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    knots = make_knots()
    for i, j in ((0, 0), (3, 5), (15, 7)):
        x, y = spline_curve(get_spline_weights(kan)[0], knots, i, j)
        jx, jy = jax_spline_curve(want[0], knots, i, j)
        np.testing.assert_allclose(x, jx, atol=1e-6)
        np.testing.assert_allclose(y, jy, rtol=1e-4, atol=1e-5)


def test_kan_visualizer_figures(pair, tmp_path):
    _, kan = pair
    x = torch.from_numpy(np.random.RandomState(6).randn(12, 16).astype(
        np.float32))
    viz = KANVisualizer(kan, output_dir=tmp_path)
    sev = np.random.RandomState(7).randint(0, 4, 12)
    paths = [viz.plot_spline_activations(),
             viz.plot_severity_trajectory(x, sev),
             viz.plot_severity_distribution(sev + 0.1, sev,
                                            ["a", "b", "c", "d"]),
             viz.plot_spline_weights_heatmap()]
    for p in paths:
        assert p.exists() and p.stat().st_size > 0
    # A state_dict works as well as the module.
    viz = KANVisualizer(kan.state_dict())
    assert [tuple(t.shape) for t in viz.layers[1]] == [(8, 1, 7), (1, 8),
                                                      (1,)]
    np.testing.assert_array_equal(viz.knots, make_knots())


@pytest.mark.parametrize("num_knots", [3, 5, 8])
def test_knots_follow_the_coefficients(num_knots):
    """The knot vector comes from the coefficients' basis count, so a head
    built with another knot count replays as the module computes it."""
    torch.manual_seed(0)
    kan = KANSeverityModule(DIMS, num_knots=num_knots)
    with torch.no_grad():
        for layer in kan.kan_layers:
            layer.spline_weights.normal_(0, 0.1)
    np.testing.assert_array_equal(KANVisualizer(kan).knots,
                                  make_knots(num_knots))
    x = torch.from_numpy(np.random.RandomState(8).randn(6, 16).astype(
        np.float32))
    with torch.no_grad():
        want = [a.numpy() for a in kan.activation_trajectory(x)]
    for a, b in zip(kan_trajectory(kan, x), want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
