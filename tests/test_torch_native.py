"""The port's C++ resize engine against its numpy copy and the JAX engine.

``rovit_kan_tpu_torch/native`` builds ``native/preprocess.cpp`` with g++ at
first use and resizes the dataset's images. Its uint8 bits must be those of
``data/resize.py`` and of the JAX package's engine (which builds the same
C++ without ``-ffp-contract=off``; on x86-64 its baseline ISA has no fused
multiply-add, so the two agree there): shrinking, enlarging, non-square,
one-pixel-wide images, at 1, 2 and 8 threads. ``normalize_batch`` equals
the JAX engine's exactly. An edited source builds a new library; a missing
or failing compiler raises. The loaders' batches are the numpy copy's and
the JAX package's, byte for byte.
"""
import shutil

import numpy as np
import pytest

from rovit_kan_tpu import native as jax_native
from rovit_kan_tpu_torch import native
from rovit_kan_tpu_torch.data import dataset as ds_mod
from rovit_kan_tpu_torch.data.resize import resize_image

CASES = {"down_384_224": ((384, 384), 224), "up_100_224": ((100, 100), 224),
         "333x500": ((333, 500), 224), "1xN": ((1, 57), 224),
         "Nx1": ((45, 1), 16), "1x1": ((1, 1), 8)}


def _images(hw, n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (*hw, 3)).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("threads", [1, 2, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_resize_bits(case, threads):
    hw, size = CASES[case]
    images = _images(hw)
    got = native.resize_batch(images, size, n_threads=threads)
    assert got.shape == (3, size, size, 3) and got.dtype == np.uint8
    for g, im in zip(got, images):
        np.testing.assert_array_equal(g, resize_image(im, size))
    if jax_native.available():
        np.testing.assert_array_equal(
            got, jax_native.resize_batch(images, size, n_threads=threads))


def test_mixed_sizes_in_one_batch():
    images = [im for hw, _ in CASES.values() for im in _images(hw, 1)]
    got = native.resize_batch(images, 64, n_threads=4)
    for g, im in zip(got, images):
        np.testing.assert_array_equal(g, resize_image(im, 64))


def test_normalize_equals_jax_engine():
    if not jax_native.available():
        pytest.skip("the JAX engine did not build here")
    rng = np.random.RandomState(2)
    batch = rng.randint(0, 256, (5, 33, 17, 3)).astype(np.uint8)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    for threads in (1, 3):
        got = native.normalize_batch(batch, mean, std, n_threads=threads)
        want = jax_native.normalize_batch(batch, mean, std, n_threads=threads)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_build_flags_and_place():
    assert "-ffp-contract=off" in native.CXX_FLAGS
    assert not any(f.startswith("-march") for f in native.CXX_FLAGS)
    lib = native.build()
    assert lib.parent.name == "_build" and lib.exists()
    assert lib == native.library_path()


def test_edited_source_rebuilds(tmp_path, monkeypatch):
    src = tmp_path / "preprocess.cpp"
    shutil.copy(native.SOURCE, src)
    monkeypatch.setattr(native, "SOURCE", src)
    first = native.build()
    assert native.build() == first            # unchanged: reused
    src.write_text(src.read_text() + "\n// edited\n")
    second = native.library_path()
    assert second != first and not second.exists()
    assert native.build() == second and second.exists()
    second.unlink()


def test_missing_or_failing_compiler_raises(tmp_path, monkeypatch):
    src = tmp_path / "preprocess.cpp"
    src.write_text(native.SOURCE.read_text() + "\n// not built yet\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", "no-such-compiler-for-this-test")
    with pytest.raises(RuntimeError, match="no-such-compiler.* not found"):
        native.resize_batch(_images((8, 8), 1), 4)
    monkeypatch.setattr(native, "CXX", "g++")
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.build()


def _loader_batches(root, monkeypatch, resize=None):
    if resize is not None:
        monkeypatch.setattr(ds_mod, "resize_batch", resize)
    loaders = ds_mod.create_dataloaders(
        root / "Augmented Image", root / "Original Image",
        ["a", "b"], {"a": 0, "b": 1}, batch_size=4, image_size=24,
        prefetch=0, num_workers=2)
    return [[b for b in loader] for loader in loaders]


def test_dataloader_batches_unchanged(tmp_path, monkeypatch):
    """The loaders resize through the engine: their batches are the numpy
    copy's and the JAX loaders', byte for byte."""
    from PIL import Image

    from rovit_kan_tpu.data.dataset import \
        create_dataloaders as jax_create_dataloaders
    rng = np.random.RandomState(7)
    for tree, n in (("Augmented Image", 6), ("Original Image", 3)):
        for c in ("a", "b"):
            d = tmp_path / tree / c
            d.mkdir(parents=True)
            for i in range(n):
                hw = [(40, 40), (17, 30), (24, 24)][i % 3]
                Image.fromarray(rng.randint(0, 256, (*hw, 3)).astype(
                    np.uint8)).save(d / f"{i}.png")
    calls = []
    engine = native.resize_batch
    got = _loader_batches(tmp_path, monkeypatch, lambda *a, **k: (
        calls.append(1), engine(*a, **k))[1])
    assert calls                        # the engine resized them
    plain = _loader_batches(tmp_path, monkeypatch, lambda ims, size, **k:
                            np.stack([resize_image(im, size)
                                      for im in ims]))
    jax_loaders = jax_create_dataloaders(
        tmp_path / "Augmented Image", tmp_path / "Original Image",
        ["a", "b"], {"a": 0, "b": 1}, batch_size=4, image_size=24,
        prefetch=0, num_workers=2)
    for g_split, p_split, j_loader in zip(got, plain, jax_loaders):
        j_split = list(j_loader) if jax_native.available() else p_split
        assert len(g_split) == len(p_split) == len(j_split) > 0
        for g, p, j in zip(g_split, p_split, j_split):
            for k in g:
                assert g[k].tobytes() == p[k].tobytes(), k
                assert g[k].tobytes() == np.asarray(j[k]).tobytes(), k
