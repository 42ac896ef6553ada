"""Evaluation metrics on the host.

A copy of ``rovit_kan_tpu/evaluation/metrics.py`` (numpy; the port keeps its
own copy): accuracy, macro/weighted F1, MAE, Spearman's rho, multiclass
Brier score, 10-bin ECE, confusion matrix and per-class
precision/recall/F1/support, closed-form with no sklearn or scipy. Two
functions are rewritten for torch: ``count_params`` counts a module's
parameters or a state dict's tensors, and ``fps_benchmark`` times
single-image forwards on the forward's device.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Top-1 accuracy."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return float((y_true == y_pred).mean()) if y_true.size else 0.0


def compute_confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray,
                             num_classes: int) -> np.ndarray:
    """Confusion matrix ``C[i, j]`` = count(true=i, pred=j)."""
    y_true = np.asarray(y_true, np.int64)
    y_pred = np.asarray(y_pred, np.int64)
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def _f1_per_class(cm: np.ndarray):
    tp = np.diag(cm).astype(np.float64)
    pred_pos = cm.sum(axis=0).astype(np.float64)
    true_pos = cm.sum(axis=1).astype(np.float64)
    precision = np.where(pred_pos > 0, tp / np.maximum(pred_pos, 1), 0.0)
    recall = np.where(true_pos > 0, tp / np.maximum(true_pos, 1), 0.0)
    denom = precision + recall
    f1 = np.where(denom > 0, 2 * precision * recall / np.maximum(denom, 1e-12),
                  0.0)
    return precision, recall, f1, true_pos


def macro_f1(y_true: np.ndarray, y_pred: np.ndarray,
             num_classes: Optional[int] = None) -> float:
    """Unweighted mean of per-class F1 (sklearn ``average='macro'``)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if num_classes is None:
        num_classes = int(max(y_true.max(initial=0), y_pred.max(initial=0))) + 1
    cm = compute_confusion_matrix(y_true, y_pred, num_classes)
    _, _, f1, _ = _f1_per_class(cm)
    return float(f1.mean())


def weighted_f1(y_true: np.ndarray, y_pred: np.ndarray,
                num_classes: Optional[int] = None) -> float:
    """Support-weighted mean of per-class F1 (sklearn
    ``average='weighted'``)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if num_classes is None:
        num_classes = int(max(y_true.max(initial=0), y_pred.max(initial=0))) + 1
    cm = compute_confusion_matrix(y_true, y_pred, num_classes)
    _, _, f1, support = _f1_per_class(cm)
    total = support.sum()
    return float((f1 * support).sum() / total) if total else 0.0


def mae(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Mean absolute error."""
    y_true = np.asarray(y_true, np.float64).ravel()
    y_pred = np.asarray(y_pred, np.float64).ravel()
    return float(np.abs(y_true - y_pred).mean()) if y_true.size else 0.0


def _rank(x: np.ndarray) -> np.ndarray:
    """Fractional ranks (average rank for ties) — matches
    scipy.stats.rankdata(method='average')."""
    x = np.asarray(x, np.float64).ravel()
    order = np.argsort(x, kind="stable")
    ranks = np.empty_like(x)
    ranks[order] = np.arange(1, x.size + 1, dtype=np.float64)
    # Average ranks within tie groups.
    sorted_x = x[order]
    boundaries = np.flatnonzero(np.r_[True, sorted_x[1:] != sorted_x[:-1],
                                      True])
    for a, b in zip(boundaries[:-1], boundaries[1:]):
        if b - a > 1:
            ranks[order[a:b]] = (a + 1 + b) / 2.0
    return ranks


def spearman_rho(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Spearman rank correlation — Pearson correlation of fractional ranks
    (scipy.stats.spearmanr semantics)."""
    y_true = np.asarray(y_true, np.float64).ravel()
    y_pred = np.asarray(y_pred, np.float64).ravel()
    if y_true.size < 2:
        return 0.0
    ra, rb = _rank(y_true), _rank(y_pred)
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    if denom == 0.0:
        return 0.0
    return float((ra * rb).sum() / denom)


def brier_score(probs: np.ndarray, y_true: np.ndarray) -> float:
    """Multiclass Brier score ``mean_i sum_k (p_ik - onehot_ik)^2``."""
    probs = np.asarray(probs, np.float64)
    y_true = np.asarray(y_true, np.int64)
    onehot = np.zeros_like(probs)
    onehot[np.arange(y_true.size), y_true] = 1.0
    return float(((probs - onehot) ** 2).sum(axis=1).mean())


def ece(probs: np.ndarray, y_true: np.ndarray, n_bins: int = 10) -> float:
    """Expected calibration error: 10-bin confidence-vs-accuracy gap
    weighted by bin mass, half-open ``(lo, hi]`` bins."""
    probs = np.asarray(probs, np.float64)
    y_true = np.asarray(y_true, np.int64)
    conf = probs.max(axis=1)
    pred = probs.argmax(axis=1)
    correct = (pred == y_true).astype(np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    out = 0.0
    n = y_true.size
    for i in range(n_bins):
        lo, hi = edges[i], edges[i + 1]
        in_bin = (conf > lo) & (conf <= hi)
        if in_bin.sum() == 0:
            continue
        out += (in_bin.sum() / n) * abs(correct[in_bin].mean()
                                        - conf[in_bin].mean())
    return float(out)


def count_params(params) -> int:
    """Parameter count of an ``nn.Module`` (its parameters only, as JAX's
    ``count_params(variables["params"])``: 5,706,394 for the flagship), or of
    a dict of parameter tensors. A module's buffers (the baselines'
    BatchNorm running statistics) are not parameters, so pass the module
    rather than its ``state_dict()``, which holds them too."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    return sum(int(v.numel()) for v in params.values())


def per_class_metrics(y_true: np.ndarray, y_pred: np.ndarray,
                      class_names) -> Dict[str, Dict[str, float]]:
    """Per-class precision/recall/F1/support."""
    num_classes = len(class_names)
    cm = compute_confusion_matrix(y_true, y_pred, num_classes)
    precision, recall, f1, support = _f1_per_class(cm)
    return {
        name: {
            "precision": float(precision[i]),
            "recall": float(recall[i]),
            "f1": float(f1[i]),
            "support": int(support[i]),
        }
        for i, name in enumerate(class_names)
    }


def _a_leaf(out) -> torch.Tensor:
    """The first tensor of a (nested) dict, list or tuple of outputs."""
    while isinstance(out, (dict, list, tuple)):
        out = next(iter(out.values())) if isinstance(out, dict) else out[0]
    return out


def fps_benchmark(forward: Callable, example_input,
                  warmup: int = 10, iters: int = 100,
                  n_chunks: int = 5) -> float:
    """Images per second of ``forward`` on ``example_input``: 10 warm-up
    forwards, then ``iters`` timed forwards in ``n_chunks`` chunks; the best
    chunk gives ``batch * per_chunk / seconds``.

    The input runs where it lies (a numpy array is taken as a CPU tensor),
    so a caller places it on the forward's device before the clock starts.
    The forwards run under ``torch.inference_mode()``. On the card each
    chunk ends in ``torch.cuda.synchronize()``, since a CUDA launch returns
    before the device finishes; on the CPU the last output is read."""
    x = (example_input if torch.is_tensor(example_input)
         else torch.from_numpy(np.asarray(example_input)))

    def close(out) -> None:
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        else:
            float(_a_leaf(out).reshape(-1)[0])

    per_chunk = max(1, iters // n_chunks)
    best = float("inf")
    with torch.inference_mode():
        out = None
        for _ in range(warmup):
            out = forward(x)
        if out is not None:
            close(out)
        for _ in range(n_chunks):
            t0 = time.perf_counter()
            for _ in range(per_chunk):
                out = forward(x)
            close(out)
            best = min(best, time.perf_counter() - t0)
    batch = x.shape[0] if x.ndim else 1
    return batch * per_chunk / best
