"""Host-side dataset and loader: fixed-shape numpy batches.

Counterpart of ``rovit_kan_tpu/data/dataset.py``, numpy and the standard
library only (the port keeps its own copy):

- ``RoseLeafDataset(root_dir, class_names, severity_map, ...)`` scans a
  class-per-folder image tree; ``.samples`` holds ``path`` / ``class_idx`` /
  ``severity``; ``.get_class_weights()`` feeds the focal alpha;
- ``create_dataloaders(...)`` -> (train, val, test): train/val a seeded
  80/20 split of the Augmented tree, test the Original tree.

Batches always have one shape (drop_last for training; a zero-padded tail
and a ``valid`` mask for evaluation), as in the JAX package. Images are
decoded once on the host with PIL, resized by ``data/resize.py`` (the JAX
package's native half-pixel bilinear resize, copied in numpy, so the pixels
are the reference's) and cached as uint8; the random augmentations run on
the device inside the train step. A background thread prefetches batches.
The trainer moves each batch to the card.
"""
from __future__ import annotations

import threading
import queue as queue_mod
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rovit_kan_tpu_torch.data.resize import resize_image

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm"}


class RoseLeafDataset:
    """Class-per-folder image dataset with severity labels."""

    def __init__(
        self,
        root_dir,
        class_names: Sequence[str],
        severity_map: Dict[str, int],
        image_size: int = 224,
        mode: str = "original",
        cache: bool = True,
        transform=None,
        split: Optional[str] = None,
    ):
        """``transform`` is an optional callable applied to each loaded uint8
        HWC image (the batch-level augmentations run on the device instead,
        see ``data/transforms.py``); ``split`` is recorded for
        bookkeeping."""
        self.root_dir = Path(root_dir)
        self.class_names = list(class_names)
        self.severity_map = dict(severity_map)
        self.image_size = image_size
        self.mode = mode
        self.transform = transform
        self.split = split
        self.class_to_idx = {c: i for i, c in enumerate(self.class_names)}

        self.samples: List[dict] = []
        for cname in self.class_names:
            cdir = self.root_dir / cname
            if not cdir.is_dir():
                continue
            for p in sorted(cdir.rglob("*")):
                if p.suffix.lower() in IMG_EXTENSIONS:
                    self.samples.append({
                        "path": str(p),
                        "class_idx": self.class_to_idx[cname],
                        "severity": float(self.severity_map[cname]),
                    })
        self._cache: Optional[List[Optional[np.ndarray]]] = (
            [None] * len(self.samples) if cache else None)
        print(f"Loaded {len(self.samples)} images in {mode} mode")

    def __len__(self) -> int:
        return len(self.samples)

    def _load_image(self, idx: int) -> np.ndarray:
        if self._cache is not None and self._cache[idx] is not None:
            return self._cache[idx]
        from PIL import Image
        s = self.samples[idx]
        with Image.open(s["path"]) as im:
            arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
        if arr.shape[:2] != (self.image_size, self.image_size):
            arr = resize_image(arr, self.image_size)
        if self._cache is not None:
            self._cache[idx] = arr
        return arr

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int, float]:
        s = self.samples[idx]
        img = self._load_image(idx)
        if self.transform is not None:
            img = self.transform(img)
        return img, s["class_idx"], s["severity"]

    def get_class_weights(self) -> np.ndarray:
        """Inverse-frequency class weights (focal alpha):
        ``n_samples / (num_classes * count_c)``."""
        counts = np.zeros(len(self.class_names), dtype=np.float64)
        for s in self.samples:
            counts[s["class_idx"]] += 1
        counts = np.maximum(counts, 1.0)
        w = len(self.samples) / (len(self.class_names) * counts)
        return w.astype(np.float32)


class Subset:
    """Index-restricted view of a dataset (train/val split)."""

    def __init__(self, dataset: RoseLeafDataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    def get_class_weights(self) -> np.ndarray:
        counts = np.zeros(len(self.dataset.class_names), dtype=np.float64)
        for i in self.indices:
            counts[self.dataset.samples[i]["class_idx"]] += 1
        counts = np.maximum(counts, 1.0)
        w = len(self.indices) / (len(self.dataset.class_names) * counts)
        return w.astype(np.float32)


def epoch_shuffle_seed(seed: int, epoch: int) -> int:
    """Decorrelated per-epoch shuffle seed. A plain ``seed + epoch`` fold
    collides across runs (seed 42/epoch 3 == seed 43/epoch 2); a large odd
    multiplier keeps distinct (seed, epoch) pairs distinct within numpy's
    32-bit seed space for any realistic epoch count."""
    return (seed * 1000003 + epoch) % (2 ** 32)


class Loader:
    """Fixed-shape numpy batch iterator with optional shuffling + prefetch.

    Yields dict batches:
        images:   (B, H, W, 3) uint8
        labels:   (B,) int32
        severity: (B,) float32
        valid:    (B,) float32 — 0 on zero-padded tail rows (eval only)
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 prefetch: int = 2, num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.num_workers = num_workers
        self._epoch = 0
        self._executor = None

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (
            (n + self.batch_size - 1) // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Align the epoch-keyed shuffle stream (resume support) — the
        next iteration behaves as epoch ``epoch + 1``."""
        self._epoch = epoch

    def _pool(self):
        # One shared thread pool per Loader (not per batch): thread spawn
        # overhead off the hot path.
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor
            self._executor = ThreadPoolExecutor(self.num_workers)
        return self._executor

    def _make_batch(self, idxs: np.ndarray) -> dict:
        bs = self.batch_size
        first = self.dataset[int(idxs[0])]
        images = np.zeros((bs, *first[0].shape), dtype=np.uint8)
        labels = np.zeros((bs,), dtype=np.int32)
        severity = np.zeros((bs,), dtype=np.float32)
        valid = np.zeros((bs,), dtype=np.float32)

        def fill(j, i):
            # Row 0 reuses the sample already decoded for the shape probe.
            img, lab, sev = first if j == 0 else self.dataset[int(i)]
            images[j], labels[j], severity[j] = img, lab, sev
            valid[j] = 1.0

        if self.num_workers > 1 and len(idxs) > 1:
            # PIL's decode and numpy's resize release the GIL for most of
            # their work, so plain threads parallelize the batch assembly.
            list(self._pool().map(fill, range(len(idxs)), idxs))
        else:
            for j, i in enumerate(idxs):
                fill(j, i)
        return {"images": images, "labels": labels,
                "severity": severity, "valid": valid}

    def _batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(
                epoch_shuffle_seed(self.seed, self._epoch))
            rng.shuffle(order)
        stop = n - n % self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            yield self._make_batch(order[start:start + self.batch_size])

    def __iter__(self):
        self._epoch += 1
        if self.prefetch <= 0:
            yield from self._batches()
            return
        # Background thread overlaps host decode with device compute.
        # Worker exceptions are
        # forwarded through the queue and re-raised here — a corrupt image
        # must fail the epoch, not silently truncate it. A stop event keeps
        # the worker from blocking forever on a full queue when the
        # consumer abandons the iterator mid-epoch.
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        SENTINEL = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def worker():
            try:
                for b in self._batches():
                    if not put(b):
                        return
                put(SENTINEL)
            except BaseException as e:     # noqa: BLE001 — forwarded
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is SENTINEL:
                    break
                if isinstance(b, BaseException):
                    raise b
                yield b
        finally:
            stop.set()
            t.join()


def create_dataloaders(
    augmented_root,
    original_root,
    class_names: Sequence[str],
    severity_map: Dict[str, int],
    batch_size: int = 32,
    train_val_split: float = 0.8,
    seed: int = 42,
    image_size: int = 224,
    prefetch: int = 2,
    num_workers: int = 4,
    augmented_transform=None,
    original_transform=None,
) -> Tuple[Loader, Loader, Loader]:
    """Train/val from the Augmented tree (seeded split), test from Original.

    The transforms are optional host-side per-image callables (uint8 HWC ->
    uint8 HWC) applied at load time; the standard normalization and
    augmentations run on the device inside the train step
    (``data/transforms.py`` over ``ops/preprocess.py``), so most callers
    leave them None.
    """
    aug = RoseLeafDataset(augmented_root, class_names, severity_map,
                          image_size=image_size, mode="augmented",
                          transform=augmented_transform, split="train")
    test_ds = RoseLeafDataset(original_root, class_names, severity_map,
                              image_size=image_size, mode="original",
                              transform=original_transform, split="test")

    n = len(aug)
    rng = np.random.RandomState(seed)
    order = rng.permutation(n)
    n_train = int(round(n * train_val_split))
    train_ds = Subset(aug, order[:n_train])
    val_ds = Subset(aug, order[n_train:])

    train_loader = Loader(train_ds, batch_size, shuffle=True, drop_last=True,
                          seed=seed, prefetch=prefetch,
                          num_workers=num_workers)
    val_loader = Loader(val_ds, batch_size, prefetch=prefetch,
                        num_workers=num_workers)
    test_loader = Loader(test_ds, batch_size, prefetch=prefetch,
                         num_workers=num_workers)
    return train_loader, val_loader, test_loader
