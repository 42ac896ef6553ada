"""Post-hoc confidence calibration: temperature scaling + reliability curve.

A copy of ``rovit_kan_tpu/evaluation/calibration.py`` (numpy only; the port
keeps its own copy, and the same numpy operations give the same bits): a
single scalar ``T > 0`` fitted on *validation* logits by NLL minimization
(Guo et al. 2017, "On Calibration of Modern Neural Networks"), applied at
inference as ``softmax(z / T)``. Scaling by a positive scalar cannot change
the argmax, so accuracy/F1/confusion are invariant — only the confidence
distribution (and with it ECE and Brier) moves.

The NLL is convex in 1/T, hence unimodal in T: a golden-section search over
log-T is exact enough (tol 1e-4) and dependency-free. Fitting runs once on
the host over the gathered validation logits; the forward on the card only
divides by the final scalar.
"""
from __future__ import annotations

import warnings
from typing import Dict

import numpy as np

__all__ = ["fit_temperature", "fit_temperature_report", "apply_temperature",
           "reliability_curve", "T_FLOOR", "NLL_SATURATED"]

#: Lower clamp for fitted temperatures. On a perfectly separated validation
#: set NLL is strictly decreasing as T → 0 (every correct margin sharpens),
#: so the unguarded golden-section fit slams into the bracket's low edge and
#: returns T ≈ 0.05 — "calibrated" metrics of exactly 0 and, if stored via
#: ``cli.evaluate --store_temperature``, a serving model that emits saturated
#: 0/1 confidences on any out-of-distribution input. 0.25 (a 4× sharpening)
#: is already far beyond any legitimate under-confidence fix at this scale;
#: anything below it is treated as a degenerate fit and clamped.
T_FLOOR = 0.25

#: NLL saturation threshold for degenerate-fit detection. On a perfectly
#: separated validation set the NLL underflows to a flat 0.0 plateau well
#: before the bracket's low edge (margin-20 logits are already exactly 0 in
#: fp64 at T ≈ 0.5), so the golden-section minimizer can converge *anywhere*
#: inside the plateau — the T_FLOOR check alone misses it. An NLL this small
#: means every validation probability is ≈ 1.0 on the true class: calibrated
#: ECE/Brier of exactly 0 and nothing real to fit.
NLL_SATURATED = 1e-3


def _nll(logits: np.ndarray, labels: np.ndarray, temp: float) -> float:
    z = logits / temp
    z = z - z.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    return float(-logp[np.arange(len(labels)), labels].mean())


def fit_temperature_report(logits, labels, lo: float = 0.05,
                           hi: float = 10.0, tol: float = 1e-4,
                           floor: float = T_FLOOR) -> Dict[str, float]:
    """Fit the NLL-minimizing temperature and report fit diagnostics.

    Returns a dict:
        ``temperature``    — the guarded T to use (raw fit clamped to
                             ``floor``; see :data:`T_FLOOR`).
        ``raw_temperature``— the unclamped golden-section minimizer.
        ``degenerate``     — True when the fit is meaningless: either the
                             raw minimizer fell below ``floor`` (NLL keeps
                             improving as T → 0) or the minimized NLL is
                             saturated below :data:`NLL_SATURATED` (the
                             validation set is perfectly separated and the
                             NLL surface is a flat 0 plateau — the minimizer
                             lands at an arbitrary point inside it). Callers
                             that persist T (``cli.evaluate
                             --store_temperature``) or write golden CSVs
                             should surface this flag.
        ``val_accuracy``   — argmax accuracy of the validation logits (1.0
                             is the classic perfect-separation trigger).
        ``nll``            — validation NLL at the *guarded* temperature.
    """
    logits = np.asarray(logits, np.float64)
    labels = np.asarray(labels)
    a, b = np.log(lo), np.log(hi)           # scale-free log-T search
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc = _nll(logits, labels, np.exp(c))
    fd = _nll(logits, labels, np.exp(d))
    while b - a > tol:
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = _nll(logits, labels, np.exp(c))
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = _nll(logits, labels, np.exp(d))
    raw = float(np.exp((a + b) / 2.0))
    nll_raw = _nll(logits, labels, max(raw, floor))
    degenerate = raw < floor or nll_raw < NLL_SATURATED
    t = max(raw, floor)
    if degenerate:
        warnings.warn(
            f"Degenerate temperature fit: raw T={raw:.4f} "
            f"(floor {floor}), NLL at fit {nll_raw:.3e} "
            f"(saturation threshold {NLL_SATURATED}), validation accuracy "
            f"{float((logits.argmax(1) == labels).mean()):.4f} — NLL "
            f"minimization on a separated validation set has no real "
            f"minimum. Using T={t}; do not persist this fit.",
            stacklevel=2)
    return {"temperature": t,
            "raw_temperature": raw,
            "degenerate": degenerate,
            "val_accuracy": float((logits.argmax(1) == labels).mean()),
            "nll": _nll(logits, labels, t)}


def fit_temperature(logits, labels, lo: float = 0.05, hi: float = 10.0,
                    tol: float = 1e-4, floor: float = T_FLOOR) -> float:
    """Scalar temperature minimizing validation NLL.

    Args:
        logits: ``(N, K)`` raw (pre-softmax) validation logits.
        labels: ``(N,)`` int labels.
        lo/hi: search bracket for T.
        floor: degenerate-fit clamp (see :data:`T_FLOOR`); fits below it
            warn and are clamped. Use :func:`fit_temperature_report` when
            the caller needs the ``degenerate`` flag programmatically.

    Returns:
        The fitted temperature (T > 1 softens an over-confident model,
        T < 1 sharpens an under-confident one), clamped to ``floor``.
    """
    return fit_temperature_report(logits, labels, lo, hi, tol,
                                  floor)["temperature"]


def apply_temperature(logits: np.ndarray, temp: float) -> np.ndarray:
    """``softmax(logits / temp)`` (host-side, fp64-stable)."""
    z = np.asarray(logits, np.float64) / temp
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)


def reliability_curve(probs: np.ndarray, labels: np.ndarray,
                      n_bins: int = 10) -> Dict[str, np.ndarray]:
    """Per-bin confidence/accuracy/mass for a reliability diagram.

    Half-open ``(lo, hi]`` bins matching the ECE implementation
    (``evaluation/metrics.py::ece``). Empty bins carry
    NaN confidence/accuracy and zero mass.
    """
    probs = np.asarray(probs)
    labels = np.asarray(labels)
    conf = probs.max(axis=1)
    correct = (probs.argmax(axis=1) == labels).astype(np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    confidence = np.full(n_bins, np.nan)
    accuracy = np.full(n_bins, np.nan)
    fraction = np.zeros(n_bins)
    for i in range(n_bins):
        m = (conf > edges[i]) & (conf <= edges[i + 1])
        if m.any():
            confidence[i] = conf[m].mean()
            accuracy[i] = correct[m].mean()
            fraction[i] = m.mean()
    return {"edges": edges, "confidence": confidence,
            "accuracy": accuracy, "fraction": fraction}
