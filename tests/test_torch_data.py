"""The port's data pipeline, logger and timers against the JAX package's.

``Loader`` and ``DeviceLoader`` must give the JAX loaders' batches in the
same order, with the same padding and ``valid`` masks, epoch after epoch;
the synthetic images, the datasets over a JPEG tree and the train/val split
must be the same; images at other sizes than the target must load with the
JAX dataset's uint8 bits (its native resize, which ``data/resize.py``
copies), down and up, square or not; the logger must write the JAX logger's
CSV byte for byte; the transforms must normalize as the JAX ones (fp32,
1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.data import dataset as jds
from rovit_kan_tpu.data import device_cache as jdc
from rovit_kan_tpu.data import synthetic as jsyn
from rovit_kan_tpu import native
from rovit_kan_tpu.ops.preprocess import eval_batch as jax_eval_batch
from rovit_kan_tpu.results import logger as jlog
from rovit_kan_tpu_torch.data import dataset as tds
from rovit_kan_tpu_torch.data import device_cache as tdc
from rovit_kan_tpu_torch.data.resize import resize_image
from rovit_kan_tpu_torch.data import synthetic as tsyn
from rovit_kan_tpu_torch.data import transforms as ttr
from rovit_kan_tpu_torch.ops.augment_kernel import draw_factors
from rovit_kan_tpu_torch.ops.preprocess import augment_batch
from rovit_kan_tpu_torch.results import logger as tlog
from rovit_kan_tpu_torch.utils.profiling import StepTimer, annotate, trace

CLASSES = ("Healthy Leaf", "Leaf Holes", "Black Spot", "Dry Leaf")
SEVERITY = {c: i for i, c in enumerate(CLASSES)}


class ArrayDS:
    def __init__(self, n=21):
        rng = np.random.RandomState(0)
        self.imgs = rng.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
        self.labels = rng.randint(0, 4, n)
        self.sev = self.labels.astype(np.float32) / 2

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return self.imgs[i], int(self.labels[i]), float(self.sev[i])


def _np(batch):
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
            for k, v in batch.items()}


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True),
                                               (True, False)])
def test_loader_order_and_padding_match_jax(shuffle, drop_last):
    ds = ArrayDS()
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=7)
    j = jds.Loader(ds, 8, prefetch=2, **kw)
    t = tds.Loader(ds, 8, prefetch=2, **kw)
    assert len(t) == len(j)
    for epoch in range(2):
        _assert_same_batches(list(t), list(j))
    j.set_epoch(5)
    t.set_epoch(5)
    _assert_same_batches(list(t), list(j))


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True),
                                               (True, False)])
def test_device_loader_matches_jax(shuffle, drop_last):
    """Iteration, the training plan and the evaluation plan, over three
    epochs; the port's labels are int64 (the JAX loader's int32)."""
    ds = ArrayDS()
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=3)
    j = jdc.DeviceLoader(ds, 8, num_workers=2, **kw)
    t = tdc.DeviceLoader(ds, 8, device="cpu", num_workers=2, **kw)
    assert len(t) == len(j) and t.nbytes == ds.imgs.nbytes + 21 * (8 + 4)
    for _ in range(2):
        got, want = list(t), list(j)
        assert all(b["labels"].dtype == torch.int64 for b in got)
        _assert_same_batches(got, want)
    np.testing.assert_array_equal(t.epoch_index_plan(), j.epoch_index_plan())
    for a, b in zip(t.eval_index_plan(), j.eval_index_plan()):
        np.testing.assert_array_equal(a, b)
    # A gathered plan row is the batch the JAX scanned epoch gathers.
    idx = t.eval_index_plan()[0][-1]
    batch = t.gather(torch.from_numpy(idx))
    np.testing.assert_array_equal(batch["images"].numpy(), ds.imgs[idx])
    np.testing.assert_array_equal(batch["labels"].numpy(), ds.labels[idx])


def test_synthetic_images_and_dataset_tree_match_jax(tmp_path):
    rng_j, rng_t = np.random.RandomState(4), np.random.RandomState(4)
    for c in range(4):
        np.testing.assert_array_equal(tsyn.make_leaf_image(c, rng_t, 48),
                                      jsyn.make_leaf_image(c, rng_j, 48))
    root_t = tsyn.generate_synthetic_dataset(tmp_path / "t", n_per_class=3,
                                             size=32, seed=1)
    root_j = jsyn.generate_synthetic_dataset(tmp_path / "j", n_per_class=3,
                                             size=32, seed=1)
    t = tds.RoseLeafDataset(root_t, CLASSES, SEVERITY, image_size=32)
    j = jds.RoseLeafDataset(root_j, CLASSES, SEVERITY, image_size=32)
    assert len(t) == len(j) == 12
    for i in range(len(t)):
        a, b = t[i], j[i]
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
    np.testing.assert_array_equal(t.get_class_weights(),
                                  j.get_class_weights())
    # Resized on load: the JAX dataset's bits where its native resize
    # builds (the port's copy of it otherwise, as the JAX dataset would
    # then fall back to PIL).
    small = tds.RoseLeafDataset(root_t, CLASSES, SEVERITY, image_size=16)
    if native.available():
        ref = jds.RoseLeafDataset(root_t, CLASSES, SEVERITY, image_size=16)
        for i in range(len(small)):
            np.testing.assert_array_equal(small[i][0], ref[i][0])
    else:
        from PIL import Image
        with Image.open(small.samples[0]["path"]) as im:
            src = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(small[0][0], resize_image(src, 16))
    assert small[0][0].shape == (16, 16, 3)


def test_create_dataloaders_split_matches_jax(tmp_path):
    root = tsyn.generate_synthetic_dataset(tmp_path / "aug", n_per_class=5,
                                           size=32, seed=2)
    kw = dict(batch_size=4, seed=11, image_size=32, prefetch=0,
              num_workers=1)
    t = tds.create_dataloaders(root, root, CLASSES, SEVERITY, **kw)
    j = jds.create_dataloaders(root, root, CLASSES, SEVERITY, **kw)
    assert t[0].dataset.indices == j[0].dataset.indices
    assert t[1].dataset.indices == j[1].dataset.indices
    np.testing.assert_array_equal(t[0].dataset.get_class_weights(),
                                  j[0].dataset.get_class_weights())
    for a, b in zip(t, j):
        assert (a.shuffle, a.drop_last) == (b.shuffle, b.drop_last)
        _assert_same_batches(list(a), list(b))


def _png_tree(root, hw, n_per_class=2, seed=0):
    """A class-per-folder tree of smooth RGB PNGs of height x width ``hw``
    (noise on a gradient, so every resize weight matters)."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    h, w = hw
    ramp = (np.arange(h)[:, None, None] * 3 + np.arange(w)[None, :, None] * 5
            + np.array([0, 85, 170]))
    for c in CLASSES:
        (root / c).mkdir(parents=True)
        for i in range(n_per_class):
            img = (ramp + rng.randint(0, 64, (h, w, 3))) % 256
            Image.fromarray(img.astype(np.uint8)).save(root / c / f"{i}.png")
    return root


def _need_native():
    if not native.available():
        pytest.skip("the JAX dataset resizes through its native library, "
                    "which did not build here (no g++): its PIL fallback is "
                    "not the reference the port copies")


# (height, width) -> target: down and up, non-square, one side at the target.
RESIZES = [((100, 90), 64), ((480, 640), 224), ((777, 1000), 384),
           ((200, 150), 224), ((300, 224), 224)]


@pytest.mark.parametrize("hw,size", RESIZES,
                         ids=[f"{h}x{w}to{s}" for (h, w), s in RESIZES])
def test_dataset_resize_matches_jax_bits(tmp_path, hw, size):
    _need_native()
    root = _png_tree(tmp_path / "tree", hw, n_per_class=1, seed=sum(hw))
    t = tds.RoseLeafDataset(root, CLASSES, SEVERITY, image_size=size)
    j = jds.RoseLeafDataset(root, CLASSES, SEVERITY, image_size=size)
    assert len(t) == len(j) == len(CLASSES)
    for i in range(len(t)):
        a, b = t[i], j[i]
        assert a[0].shape == (size, size, 3) and a[0].dtype == np.uint8
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]


def test_create_dataloaders_resized_match_jax(tmp_path):
    """Train and val order, padding and ``valid`` over PNGs resized on
    load (100 x 90 to 64), and the DeviceLoader cache built from them."""
    _need_native()
    root = _png_tree(tmp_path / "aug", (100, 90), n_per_class=5, seed=3)
    kw = dict(batch_size=3, seed=5, image_size=64, prefetch=0,
              num_workers=2)
    t = tds.create_dataloaders(root, root, CLASSES, SEVERITY, **kw)
    j = jds.create_dataloaders(root, root, CLASSES, SEVERITY, **kw)
    for a, b in zip(t, j):
        got, want = list(a), list(b)
        assert got[0]["images"].shape == (3, 64, 64, 3)
        _assert_same_batches(got, want)
    # 16 train images in 5 full batches; 4 val images, the second batch
    # padded with two zero rows.
    assert [len(list(x)) for x in t] == [5, 2, 7]
    assert list(t[1])[-1]["valid"].tolist() == [1.0, 0.0, 0.0]
    cached = tdc.DeviceLoader(t[1].dataset, 3, device="cpu", num_workers=2)
    _assert_same_batches(list(cached), list(jdc.DeviceLoader(
        j[1].dataset, 3, num_workers=2)))


def test_resize_image_by_hand():
    """3 x 5 to 2 x 2: rows sample at 0.25 and 1.75, columns at 0.75 and
    3.25 (half-pixel centres, scales 1.5 and 2.5). Channel 0 is
    30 * row + 40 * col, so bilinear gives 37.5, 137.5, 82.5, 182.5 exactly,
    and +0.5 then truncation rounds each half up; channel 1 is 255 minus
    it; channel 2 is constant."""
    r, c = np.meshgrid(np.arange(3), np.arange(5), indexing="ij")
    lin = 30 * r + 40 * c
    src = np.stack([lin, 255 - lin, np.full_like(lin, 7)], -1).astype(
        np.uint8)
    got = resize_image(src, 2)
    assert got.dtype == np.uint8 and got.shape == (2, 2, 3)
    np.testing.assert_array_equal(got[..., 0], [[38, 138], [83, 183]])
    np.testing.assert_array_equal(got[..., 1], [[218, 118], [173, 73]])
    np.testing.assert_array_equal(got[..., 2], [[7, 7], [7, 7]])
    with pytest.raises(ValueError):
        resize_image(src.astype(np.float32), 2)


def test_transforms_match_jax():
    imgs = np.random.RandomState(5).randint(0, 256, (3, 16, 16, 3)).astype(
        np.uint8)
    want = np.asarray(jax_eval_batch(jnp.asarray(imgs)))
    for fn in (ttr.original_transforms(), ttr.inference_transforms()):
        np.testing.assert_allclose(fn(torch.from_numpy(imgs)).numpy(), want,
                                   atol=1e-6)
    # The augmented pipeline draws its factors as the train step does.
    aug = ttr.augmented_transforms()
    got = aug(torch.from_numpy(imgs), torch.Generator().manual_seed(9))
    factors = draw_factors(torch.Generator().manual_seed(9), 3)
    assert torch.equal(got, augment_batch(torch.from_numpy(imgs), factors))
    a, b = aug(torch.from_numpy(imgs)), aug(torch.from_numpy(imgs))
    assert a.shape == (3, 16, 16, 3) and not torch.equal(a, b)


def test_logger_writes_the_jax_csv(tmp_path):
    assert tlog.CSV_COLUMNS == jlog.CSV_COLUMNS and len(tlog.CSV_COLUMNS) == 14
    rng = np.random.RandomState(0)
    keys = ("total_loss", "cls_loss", "ord_loss", "unc_loss", "kan_loss",
            "accuracy")
    rows = [(e, min(e, 4), {k: float(rng.rand()) for k in keys},
             {k: float(rng.rand()) for k in keys}) for e in range(1, 5)]
    loggers = [cls(tmp_path / name, "run") for cls, name in
               ((tlog.ExperimentLogger, "t"), (jlog.ExperimentLogger, "j"))]
    for lg in loggers:
        for e, s, tm, vm in rows:
            lg.log_epoch(e, s, tm, {**vm, "accuracy": np.float32(0.5)})
        assert lg.truncate_from(4) == 1
        lg.save_metrics({"acc": np.float32(0.25), "cm": np.eye(2)},
                        "test_metrics.json")
        lg.log_experiment("run", "cfg", {"acc": np.float64(0.5)})
    for name in ("run_epochs.csv", "test_metrics.json", "run_summary.txt"):
        assert (tmp_path / "t" / name).read_bytes() \
            == (tmp_path / "j" / name).read_bytes(), name
    assert loggers[0].reset() and not (tmp_path / "t" / "run_epochs.csv") \
        .exists()


def test_step_timer_and_trace(tmp_path):
    timer = StepTimer(warmup=1, device="cpu")
    for _ in range(3):
        with timer.step():
            pass
    s = timer.summary(batch_size=8)
    assert s["steps"] == 2 and set(s) == {"steps", "mean_s", "p50_s",
                                          "p95_s", "total_s",
                                          "images_per_sec"}
    timer.reset()
    assert timer.summary() == {"steps": 0}
    with trace(tmp_path / "trace"):
        with annotate("matmul"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
