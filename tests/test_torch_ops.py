"""Port's plain ops against the JAX package's: spline basis, KAN layer,
ordinal math and preprocessing, fp32 at 1e-6, on the same seeded inputs."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.ops import ordinal as j_ord
from rovit_kan_tpu.ops import preprocess as j_pre
from rovit_kan_tpu.ops import spline as j_spl
from rovit_kan_tpu_torch.ops import ordinal as t_ord
from rovit_kan_tpu_torch.ops import preprocess as t_pre
from rovit_kan_tpu_torch.ops import spline as t_spl

TOL = 1e-6


def test_knots_and_basis_count():
    for nk, deg in [(5, 3), (4, 2), (7, 1)]:
        np.testing.assert_array_equal(t_spl.make_knots(nk, deg),
                                      j_spl.make_knots(nk, deg))
        assert t_spl.num_basis_functions(nk, deg) == \
            j_spl.num_basis_functions(nk, deg)


@pytest.mark.parametrize("degree", [1, 3])
def test_bspline_basis_matches_jax(degree):
    knots = j_spl.make_knots(5, degree)
    # Interior points, both ends, every knot exactly, and out-of-range
    # values that the clamp must catch.
    x = np.concatenate([
        np.random.RandomState(0).uniform(-1.3, 1.3, 200),
        knots, [-1.0, 1.0, -5.0, 5.0]]).astype(np.float32).reshape(1, -1)
    want = np.asarray(j_spl.bspline_basis(jnp.asarray(x), knots, degree))
    got = t_spl.bspline_basis(torch.from_numpy(x), knots, degree).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    got_list = t_spl.bspline_basis_list(torch.from_numpy(x), knots, degree)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got_list],
                                           -1), got)


def test_kan_layer_apply_matches_jax():
    rng = np.random.RandomState(1)
    B, fin, fout = 8, 24, 5
    knots = j_spl.make_knots(5, 3)
    x = rng.normal(0, 1.5, (B, fin)).astype(np.float32)
    ws = rng.normal(0, 0.1, (fin, fout, 7)).astype(np.float32)
    wl = rng.normal(0, 0.3, (fin, fout)).astype(np.float32)
    bl = rng.normal(0, 0.1, (fout,)).astype(np.float32)
    want = np.asarray(j_spl.kan_layer_apply(
        jnp.asarray(x), jnp.asarray(ws), jnp.asarray(wl), jnp.asarray(bl),
        knots, 3))
    got = t_spl.kan_layer_apply(*(torch.from_numpy(a)
                                  for a in (x, ws, wl, bl)), knots, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_ordinal_matches_jax():
    logits = np.random.RandomState(2).normal(0, 3, (16, 3)).astype(
        np.float32)
    for jf, tf in [(j_ord.cumulative_to_class_probs,
                    t_ord.cumulative_to_class_probs),
                   (j_ord.ordinal_expected_severity,
                    t_ord.ordinal_expected_severity)]:
        want = np.asarray(jf(jnp.asarray(logits)))
        got = tf(torch.from_numpy(logits)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_preprocess_matches_jax():
    imgs = np.random.RandomState(3).randint(0, 256, (2, 8, 8, 3)).astype(
        np.uint8)
    t = torch.from_numpy(imgs)
    np.testing.assert_allclose(t_pre.to_float(t).numpy(),
                               np.asarray(j_pre.to_float(jnp.asarray(imgs))),
                               atol=TOL, rtol=0)
    got = t_pre.eval_batch(t)
    assert got.dtype == torch.float32 and got.shape == (2, 8, 8, 3)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_pre.eval_batch(jnp.asarray(imgs))),
        atol=TOL, rtol=0)
    f = np.random.RandomState(4).uniform(0, 1, (2, 4, 4, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        t_pre.normalize(torch.from_numpy(f)).numpy(),
        np.asarray(j_pre.normalize(jnp.asarray(f))), atol=TOL, rtol=0)


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """A built kernel library is keyed on its source and on every header
    it includes, so an edited header rebuilds instead of loading a stale
    library."""
    from rovit_kan_tpu_torch.ops import _build
    (tmp_path / "a.cu").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text('#include "c.cuh"\nint b;\n')
    (tmp_path / "c.cuh").write_text("int c;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("a")
    (tmp_path / "c.cuh").write_text("int c2;\n")       # nested header edit
    second = _build.library_path("a")
    assert first != second and second.name.startswith("a-")
    assert _build.library_path("a") == second          # stable
    real = Path(_build.__file__).resolve().parent.parent / "csrc"
    monkeypatch.setattr(_build, "CSRC", real)
    block = ["vit_block_common.cuh", "attention_common.cuh",
             "tile_common.cuh", "attention_mma.cuh", "mma_common.cuh",
             "attention_tf32.cuh", "tf32_common.cuh", "block_mma.cuh",
             "block_tf32.cuh"]
    assert [h.name for h in _build._headers(real / "vit_block_fwd.cu",
                                            [])] == block
    bwd = block + ["block_bwd_mma.cuh", "block_bwd_common.cuh"]
    assert [h.name for h in _build._headers(real / "vit_block_bwd.cu",
                                            [])] == bwd
    bwd32 = block + ["attention_fma.cuh", "fma_common.cuh",
                     "block_bwd_fma.cuh", "block_bwd_common.cuh"]
    assert [h.name for h in _build._headers(real / "vit_block_bwd_f32.cu",
                                            [])] == bwd32
    assert [h.name for h in _build._headers(real / "attention.cu", [])] \
        == ["attention_common.cuh", "tile_common.cuh", "attention_mma.cuh",
            "mma_common.cuh", "attention_tf32.cuh", "tf32_common.cuh"]
