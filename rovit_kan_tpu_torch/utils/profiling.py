"""Profiling and timing: ``trace``, ``annotate`` and ``StepTimer``.

Counterpart of ``rovit_kan_tpu/utils/profiling.py``:

- ``trace(logdir)``: ``torch.profiler`` over the host and the card, written
  as a Chrome trace into ``logdir`` (the JAX package writes an XPlane trace
  with ``jax.profiler``);
- ``annotate(name)``: a named region in the profiler's timeline
  (``torch.profiler.record_function``);
- ``StepTimer``: wall-clock step statistics with warm-up exclusion. PyTorch
  returns before the card finishes, so where a ``device`` on the card is
  given the timer synchronizes it before it reads the clock, at the points
  where the JAX trainer blocks on its results.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir):
    """``torch.profiler`` trace of the host and the card; writes
    ``trace.json`` into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


def annotate(name: str):
    """Named region for the profiler timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling per-step timing with warm-up exclusion.

    The first ``warmup`` recorded steps (kernel builds, allocator growth) are
    left out of the statistics. ``device``: a CUDA device is synchronized
    before each clock reading, so a step's time includes its device work.
    """

    def __init__(self, warmup: int = 1, device=None):
        self.warmup = warmup
        self.device = None if device is None else torch.device(device)
        self._all: List[float] = []
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self._sync()
        dt = time.perf_counter() - self._t0
        self._all.append(dt)
        return dt

    @contextlib.contextmanager
    def step(self):
        self.start()
        yield
        self.stop()

    @property
    def times(self) -> np.ndarray:
        return np.asarray(self._all[self.warmup:])

    def summary(self, batch_size: Optional[int] = None) -> Dict[str, float]:
        t = self.times
        if t.size == 0:
            return {"steps": 0}
        out = {
            "steps": int(t.size),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "total_s": float(np.asarray(self._all).sum()),
        }
        if batch_size:
            out["images_per_sec"] = batch_size / out["mean_s"]
        return out

    def reset(self) -> None:
        self._all.clear()
