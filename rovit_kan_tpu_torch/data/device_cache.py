"""Device-resident dataset: the whole uint8 set lives on the card.

Counterpart of ``rovit_kan_tpu/data/device_cache.py``. The images, labels
and severities are uploaded once; each batch is then an ``index_select``
gather on the device, so the host decodes nothing and copies nothing per
step. ``DeviceLoader`` yields the same fixed-shape dict batches as
``data.dataset.Loader`` (as tensors on the device), and its index plans
(``epoch_index_plan``, ``eval_index_plan``) are numpy and give the JAX
loader's order for the same seed and epoch, so the trainer's
device-resident epoch (``Trainer.train_epoch``) walks the batches the JAX
scanned epoch walks.

Over a data mesh (``mesh=``, one process per card) every rank holds the
whole set by default. With ``shard_data=True`` each rank stores only its
shard, as the JAX ``P("data")`` storage: shard s owns the samples s, s+dp,
s+2*dp, ... (so each class spreads over every shard), each rank decodes
only those, and the plans are the JAX ones, number for number: the
stratified train plan ``(steps, dp, batch/dp)`` of shard-local ids (each
shard shuffled in turn from one epoch-keyed stream) and the full-coverage
eval plan with its valid mask. A rank gathers its column of the plan; the
global batch is the ``all_gather`` of the ranks' rows, shard-major.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import numpy as np
import torch

from rovit_kan_tpu_torch import resolve_device
from rovit_kan_tpu_torch.data.dataset import epoch_shuffle_seed
from rovit_kan_tpu_torch.parallel.multihost import make_global_array


class DeviceLoader:
    """Device-resident dataset and fixed-shape batch iterator.

    ``dataset[i]`` gives ``(uint8 HWC image, label, severity)``. Batches:
    ``images`` uint8 ``(B, H, W, 3)``, ``labels`` int64, ``severity`` and
    ``valid`` fp32, on ``device``; a padded tail (``drop_last=False``) has
    ``valid`` 0 on the padding rows, which repeat row 0 of the set (of the
    rank's shard when sharded).

    ``mesh``: the data mesh; the set lives on ``mesh.device``. With
    ``shard_data`` and more than one rank, this rank stores its shard only
    (module docstring); the batch size must divide by the ranks."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, device="cuda",
                 num_workers: int = 4, mesh=None, shard_data: bool = False):
        self.device = resolve_device(device if mesh is None
                                     else mesh.device)
        self.mesh = mesh
        self.dp = 1
        if shard_data and mesh is not None and mesh.size > 1:
            self.dp = mesh.size
            if batch_size % self.dp:
                raise ValueError(f"shard_data needs batch_size "
                                 f"({batch_size}) divisible by the data "
                                 f"axis ({self.dp})")
        self.sharded = self.dp > 1
        n = len(dataset)
        rank = mesh.rank if self.sharded else 0
        # This rank's samples: every one, or globals rank, rank + dp, ...
        # stored at local rows 0, 1, ...; a shard shorter than the longest
        # keeps zero rows at its end.
        mine = range(rank, n, self.dp)
        rows = (n + self.dp - 1) // self.dp
        first = dataset[mine[0]]
        images = np.zeros((rows, *first[0].shape), np.uint8)
        labels = np.zeros((rows,), np.int64)
        severity = np.zeros((rows,), np.float32)

        def fill(j):
            img, lab, sev = first if j == 0 else dataset[mine[j]]
            images[j], labels[j], severity[j] = img, lab, sev

        if num_workers > 1 and len(mine) > 1:
            # PIL's decode and the C++ resize release the GIL for most of
            # their work.
            with ThreadPoolExecutor(num_workers) as ex:
                list(ex.map(fill, range(len(mine))))
        else:
            for j in range(len(mine)):
                fill(j)
        self._images = torch.from_numpy(images).to(self.device)
        self._labels = torch.from_numpy(labels).to(self.device)
        self._severity = torch.from_numpy(severity).to(self.device)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0
        self.n = n
        self.rows_per_shard = rows
        # Real (non-pad) rows per shard: shard s owns globals s, s+dp, ...
        self._shard_sizes = [len(range(s, n, self.dp))
                             for s in range(self.dp)]

    def __len__(self):
        if self.sharded:
            bpd = self.batch_size // self.dp
            if self.shuffle or self.drop_last:
                return min(self._shard_sizes) // bpd
            return (max(self._shard_sizes) + bpd - 1) // bpd
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Align the epoch-keyed shuffle stream (resume support)."""
        self._epoch = epoch

    @property
    def nbytes(self) -> int:
        """Device bytes of the cached set on this card (its shard's when
        sharded)."""
        return sum(t.numel() * t.element_size() for t in self.arrays)

    @property
    def arrays(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The device-resident (images, labels, severity)."""
        return self._images, self._labels, self._severity

    def gather(self, idx: torch.Tensor,
               valid: torch.Tensor = None) -> Dict[str, torch.Tensor]:
        """One batch: the rows ``idx`` (int64 on the device; shard-local
        ids when sharded) of each array, gathered on the device, and
        ``valid`` (all ones when not given)."""
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
        device-resident training epoch (full batches only). Sharded:
        ``(steps, dp, batch/dp)`` shard-local ids (stratified batches,
        per-shard shuffle)."""
        if self.sharded:
            return self._sharded_train_plan()
        order = self._epoch_order()
        steps = self.n // self.batch_size
        return order[:steps * self.batch_size].reshape(
            steps, self.batch_size).astype(np.int64)

    def _sharded_train_plan(self) -> np.ndarray:
        self._epoch += 1
        bpd = self.batch_size // self.dp
        steps = min(self._shard_sizes) // bpd
        rng = np.random.RandomState(
            epoch_shuffle_seed(self.seed, self._epoch))
        plan = np.zeros((steps, self.dp, bpd), np.int64)
        for s in range(self.dp):
            order = np.arange(self._shard_sizes[s])
            if self.shuffle:
                rng.shuffle(order)
            plan[:, s, :] = order[:steps * bpd].reshape(steps, bpd)
        return plan

    def _sharded_eval_plan(self, shuffled: bool = False):
        """Full-coverage per-shard plan and valid mask (tails zero-padded);
        ``shuffled`` permutes each shard's order first (epoch-keyed)."""
        bpd = self.batch_size // self.dp
        steps = (max(self._shard_sizes) + bpd - 1) // bpd
        idx = np.zeros((steps, self.dp, bpd), np.int64)
        valid = np.zeros((steps, self.dp, bpd), np.float32)
        rng = None
        if shuffled:
            self._epoch += 1
            rng = np.random.RandomState(
                epoch_shuffle_seed(self.seed, self._epoch))
        for s in range(self.dp):
            flat = np.arange(self._shard_sizes[s])
            if rng is not None:
                rng.shuffle(flat)
            for st in range(steps):
                chunk = flat[st * bpd:(st + 1) * bpd]
                idx[st, s, :len(chunk)] = chunk
                valid[st, s, :len(chunk)] = 1.0
        return idx, valid

    def eval_index_plan(self) -> Tuple[np.ndarray, np.ndarray]:
        """The unshuffled full-coverage ``(steps, batch)`` index plan and its
        ``(steps, batch)`` valid mask (the tail zero-padded). Sharded:
        ``(steps, dp, batch/dp)`` shard-local ids and their mask."""
        if self.sharded:
            return self._sharded_eval_plan()
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
        if self.sharded:
            yield from self._sharded_batches()
            return
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


    def _sharded_batches(self):
        """Global batches over the stratified plans (the train plan with
        ``drop_last``, else the padded full-coverage plan, shuffled per
        shard when asked): each rank gathers its rows, and every rank gets
        the ``all_gather`` of them. A collective: every rank iterates."""
        if self.drop_last:
            plan = self._sharded_train_plan()
            valid_plan = np.ones(plan.shape, np.float32)
        else:
            plan, valid_plan = self._sharded_eval_plan(shuffled=self.shuffle)
            if not self.shuffle:
                self._epoch += 1
        r = self.mesh.rank
        for st in range(plan.shape[0]):
            local = self.gather(
                torch.from_numpy(plan[st, r]).to(self.device),
                torch.from_numpy(valid_plan[st, r]).to(self.device))
            yield make_global_array(local, self.mesh)


def device_cache_loaders(train_ds, val_ds, test_ds, batch_size: int,
                         seed: int = 42, device="cuda", mesh=None,
                         shard_data: bool = False):
    """Device-resident loaders for the standard three splits; with
    ``shard_data`` each split is stored sharded over the mesh."""
    kw = dict(device=device, mesh=mesh, shard_data=shard_data)
    train = DeviceLoader(train_ds, batch_size, shuffle=True, drop_last=True,
                         seed=seed, **kw)
    val = DeviceLoader(val_ds, batch_size, **kw)
    test = DeviceLoader(test_ds, batch_size, **kw)
    return train, val, test
