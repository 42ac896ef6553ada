"""Device-resident dataset: the whole uint8 set lives on the card.

Counterpart of ``rovit_kan_tpu/data/device_cache.py`` for one device. The
images, labels and severities are uploaded once; each batch is then an
``index_select`` gather on the device, so the host decodes nothing and
copies nothing per step. ``DeviceLoader`` yields the same fixed-shape dict
batches as ``data.dataset.Loader`` (as tensors on the device), and its index
plans (``epoch_index_plan``, ``eval_index_plan``) are numpy and give the
JAX loader's order for the same seed and epoch, so the trainer's
device-resident epoch (``Trainer.train_epoch``) walks the batches the JAX
scanned epoch walks. Sharded storage over a mesh and multi-host assembly
are not ported.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import numpy as np
import torch

from rovit_kan_tpu_torch import resolve_device
from rovit_kan_tpu_torch.data.dataset import epoch_shuffle_seed


class DeviceLoader:
    """Device-resident dataset and fixed-shape batch iterator.

    ``dataset[i]`` gives ``(uint8 HWC image, label, severity)``. Batches:
    ``images`` uint8 ``(B, H, W, 3)``, ``labels`` int64, ``severity`` and
    ``valid`` fp32, on ``device``; a padded tail (``drop_last=False``) has
    ``valid`` 0 on the padding rows, which repeat row 0 of the set."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, device="cuda",
                 num_workers: int = 4):
        self.device = resolve_device(device)
        n = len(dataset)
        first = dataset[0]
        images = np.zeros((n, *first[0].shape), np.uint8)
        labels = np.zeros((n,), np.int64)
        severity = np.zeros((n,), np.float32)

        def fill(i):
            img, lab, sev = first if i == 0 else dataset[i]
            images[i], labels[i], severity[i] = img, lab, sev

        if num_workers > 1 and n > 1:
            # PIL's decode and numpy's resize release the GIL for most of
            # their work.
            with ThreadPoolExecutor(num_workers) as ex:
                list(ex.map(fill, range(n)))
        else:
            for i in range(n):
                fill(i)
        self._images = torch.from_numpy(images).to(self.device)
        self._labels = torch.from_numpy(labels).to(self.device)
        self._severity = torch.from_numpy(severity).to(self.device)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0
        self.n = n

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Align the epoch-keyed shuffle stream (resume support)."""
        self._epoch = epoch

    @property
    def nbytes(self) -> int:
        """Device bytes of the cached set."""
        return sum(t.numel() * t.element_size() for t in self.arrays)

    @property
    def arrays(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The device-resident (images, labels, severity)."""
        return self._images, self._labels, self._severity

    def gather(self, idx: torch.Tensor,
               valid: torch.Tensor = None) -> Dict[str, torch.Tensor]:
        """One batch: the rows ``idx`` (int64 on the device) of each array,
        gathered on the device, and ``valid`` (all ones when not given)."""
        batch = {"images": self._images.index_select(0, idx),
                 "labels": self._labels.index_select(0, idx),
                 "severity": self._severity.index_select(0, idx)}
        batch["valid"] = (valid if valid is not None else
                          torch.ones(idx.shape[0], device=self.device))
        return batch

    def _epoch_order(self) -> np.ndarray:
        """Advance the epoch counter and return this epoch's sample order
        (shared by ``__iter__`` and ``epoch_index_plan``: one of them runs
        per training epoch)."""
        self._epoch += 1
        order = np.arange(self.n)
        if self.shuffle:
            np.random.RandomState(
                epoch_shuffle_seed(self.seed, self._epoch)).shuffle(order)
        return order

    def epoch_index_plan(self) -> np.ndarray:
        """This epoch's shuffled ``(steps, batch)`` index matrix for the
        device-resident training epoch (full batches only)."""
        order = self._epoch_order()
        steps = self.n // self.batch_size
        return order[:steps * self.batch_size].reshape(
            steps, self.batch_size).astype(np.int64)

    def eval_index_plan(self) -> Tuple[np.ndarray, np.ndarray]:
        """The unshuffled full-coverage ``(steps, batch)`` index plan and its
        ``(steps, batch)`` valid mask (the tail zero-padded)."""
        bs = self.batch_size
        steps = (self.n + bs - 1) // bs
        idx = np.zeros((steps, bs), np.int64)
        valid = np.zeros((steps, bs), np.float32)
        flat = np.arange(self.n)
        for s in range(steps):
            chunk = flat[s * bs:(s + 1) * bs]
            idx[s, :len(chunk)] = chunk
            valid[s, :len(chunk)] = 1.0
        return idx, valid

    def __iter__(self):
        order = self._epoch_order()
        stop = self.n - self.n % self.batch_size if self.drop_last else self.n
        bs = self.batch_size
        for start in range(0, stop, bs):
            idx = order[start:start + bs]
            n_valid = len(idx)
            if n_valid < bs:                   # pad the tail batch
                idx = np.concatenate([idx, np.zeros(bs - n_valid, np.int64)])
            valid = torch.from_numpy(
                (np.arange(bs) < n_valid).astype(np.float32))
            yield self.gather(torch.from_numpy(idx).to(self.device),
                              valid.to(self.device))


def device_cache_loaders(train_ds, val_ds, test_ds, batch_size: int,
                         seed: int = 42, device="cuda"):
    """Device-resident loaders for the standard three splits."""
    train = DeviceLoader(train_ds, batch_size, shuffle=True, drop_last=True,
                         seed=seed, device=device)
    val = DeviceLoader(val_ds, batch_size, device=device)
    test = DeviceLoader(test_ds, batch_size, device=device)
    return train, val, test
