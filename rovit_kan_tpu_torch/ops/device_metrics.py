"""Metrics computed on the device, masked by ``valid``.

Counterpart of ``rovit_kan_tpu/ops/device_metrics.py``: the host metrics of
``evaluation/metrics.py`` as torch operations over whole concatenated
tensors, so an evaluation over the card's outputs reads nothing back until
the scalars are done. Every function takes a ``valid`` mask (1 on real
rows, 0 on the padded tail of a fixed-shape batch) and reduces over the
whole tensor. These are XLA operations in the JAX package, not a Pallas
kernel, so plain torch operations are their port.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def _masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return (x * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def _valid(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """``valid`` as fp32 (a bool or float mask), all ones when None."""
    if valid is None:
        return torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    return valid.float()


def accuracy(preds: torch.Tensor, labels: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    valid = _valid(preds, valid)
    return _masked_mean((preds == labels).float(), valid)


def mae(pred: torch.Tensor, target: torch.Tensor,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    valid = _valid(pred, valid)
    return _masked_mean(torch.abs(pred - target), valid)


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor,
                     num_classes: int,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(K, K) counts ``C[true, pred]`` over the valid rows, as fp32.

    The JAX package sums one-hot products in fp32; here the counts are
    int64 adds (padded rows go to a spare cell past the K x K ones), exact
    in any order on the card, and no matmul that TF32 could round."""
    valid = _valid(preds, valid)
    k = num_classes
    cell = torch.where(valid > 0, labels.long() * k + preds.long(),
                       torch.full_like(preds, k * k, dtype=torch.long))
    counts = torch.zeros(k * k + 1, dtype=torch.long, device=preds.device)
    counts.index_add_(0, cell, torch.ones_like(cell))
    return counts[:k * k].view(k, k).float()


def macro_f1_from_cm(cm: torch.Tensor) -> torch.Tensor:
    tp = torch.diagonal(cm)
    pred_pos = cm.sum(dim=0)
    true_pos = cm.sum(dim=1)
    precision = torch.where(pred_pos > 0, tp / torch.clamp(pred_pos, min=1),
                            0.0)
    recall = torch.where(true_pos > 0, tp / torch.clamp(true_pos, min=1), 0.0)
    denom = precision + recall
    f1 = torch.where(denom > 0, 2 * precision * recall
                     / torch.clamp(denom, min=1e-12), 0.0)
    return f1.mean()


def _average_ranks(x: torch.Tensor) -> torch.Tensor:
    """Fractional (average-tie) ranks, 1-based — rankdata('average').

    Sort, give each tie group an id from sorted-neighbour equality, add the
    ordinal ranks of each group, then scatter each group's average back to
    the original order. O(n log n) time, O(n) memory.

    The group sums are int64 adds, exact in any order the card runs them.
    The JAX package adds the same integers in fp32, which is exact while a
    group's sum stays below 2^24 (every group when n <= 5,792, since
    n(n+1)/2 < 2^24); there the two give the same bits, and past it this
    is the exact sum that JAX's fp32 adds round."""
    n = x.shape[0]
    order = torch.argsort(x, stable=True)
    xs = x[order]
    new_group = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                           xs[1:] != xs[:-1]])
    gid = torch.cumsum(new_group, 0) - 1
    pos = torch.arange(1, n + 1, dtype=torch.long, device=x.device)
    sums = torch.zeros(n, dtype=torch.long, device=x.device)
    sums.index_add_(0, gid, pos)
    cnts = torch.zeros(n, dtype=torch.long, device=x.device)
    cnts.index_add_(0, gid, torch.ones_like(pos))
    avg = sums.float() / torch.clamp(cnts, min=1).float()
    return torch.empty(n, dtype=torch.float32,
                       device=x.device).scatter_(0, order, avg[gid])


def spearman_rho(a: torch.Tensor, b: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Spearman rank correlation with average-tie ranks (scipy semantics).

    Padded entries (valid=0) are pushed to a sentinel beyond the data range
    (fp32, as in the JAX package) so they occupy the tail ranks, then
    masked out of the correlation.
    """
    valid = _valid(a, valid)
    big = torch.maximum(torch.abs(a).max(), torch.abs(b).max()) + 1.0
    tail = big + torch.arange(a.shape[0], dtype=torch.float32,
                              device=a.device)
    a = torch.where(valid > 0, a, tail)
    b = torch.where(valid > 0, b, tail)
    ra = _average_ranks(a)
    rb = _average_ranks(b)
    n = torch.clamp(valid.sum(), min=1.0)
    ma = (ra * valid).sum() / n
    mb = (rb * valid).sum() / n
    da = (ra - ma) * valid
    db = (rb - mb) * valid
    denom = torch.sqrt((da ** 2).sum() * (db ** 2).sum())
    return torch.where(denom > 0, (da * db).sum() / denom, 0.0)


def brier_score(probs: torch.Tensor, labels: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    valid = _valid(probs, valid)
    onehot = F.one_hot(labels.long(), probs.shape[-1]).to(probs.dtype)
    per = ((probs - onehot) ** 2).sum(dim=-1)
    return _masked_mean(per, valid)


def bin_edges(n_bins: int, device=None) -> torch.Tensor:
    """The JAX package's fp32 ``jnp.linspace(0, 1, n_bins + 1)``: edge i is
    ``i * fp32(1 / n_bins)``, the last exactly 1. These are not
    ``torch.linspace``'s bits: at 10 bins JAX's 0.9 is 0x3F666667 where
    torch and numpy give 0x3F666666, and a confidence between the two would
    fall in another bin."""
    step = torch.tensor(1.0, dtype=torch.float32) / n_bins
    edges = torch.arange(n_bins + 1, dtype=torch.float32) * step
    edges[-1] = 1.0
    return edges.to(device)


def ece(probs: torch.Tensor, labels: torch.Tensor, n_bins: int = 10,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ECE over ``n_bins`` half-open ``(lo, hi]`` confidence bins, all bins
    in one pass."""
    valid = _valid(probs, valid)
    conf = probs.max(dim=-1).values
    correct = (probs.argmax(dim=-1) == labels).float()
    edges = bin_edges(n_bins, probs.device)
    n = torch.clamp(valid.sum(), min=1.0)
    in_bin = ((conf[:, None] > edges[None, :-1])
              & (conf[:, None] <= edges[None, 1:])).float() * valid[:, None]
    cnt = in_bin.sum(dim=0)
    safe = torch.clamp(cnt, min=1.0)
    gap = torch.abs((correct[:, None] * in_bin).sum(dim=0) / safe
                    - (conf[:, None] * in_bin).sum(dim=0) / safe)
    return torch.where(cnt > 0, (cnt / n) * gap, 0.0).sum()


def all_metrics(probs: torch.Tensor, labels: torch.Tensor,
                severity_pred: torch.Tensor, severity_true: torch.Tensor,
                valid: torch.Tensor,
                num_classes: int = 4) -> Dict[str, torch.Tensor]:
    """The full metric set over the device tensors: 0-dim tensors and the
    ``(K, K)`` confusion matrix."""
    preds = probs.argmax(dim=-1)
    cm = confusion_matrix(preds, labels, num_classes, valid)
    return {
        "accuracy": accuracy(preds, labels, valid),
        "macro_f1": macro_f1_from_cm(cm),
        "mae": mae(severity_pred, severity_true, valid),
        "spearman_rho": spearman_rho(severity_true, severity_pred, valid),
        "brier_score": brier_score(probs, labels, valid),
        "ece": ece(probs, labels, valid=valid),
        "confusion_matrix": cm,
    }
