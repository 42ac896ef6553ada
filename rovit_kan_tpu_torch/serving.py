"""Fixed-batch serving on the card: ``InferenceEngine`` and ``MicroBatcher``.

Counterpart of ``rovit_kan_tpu/serving.py``, with the same semantics:

- raw uint8 NHWC input, normalized on the device;
- one fixed batch size: a partial batch is zero-padded to ``batch_size`` and
  sliced back, so every forward has the same shapes;
- the derived outputs of ``predict`` (softmax with an optional calibration
  temperature, argmax, ordinal class probabilities and expected severity,
  uncertainty std, KAN severity), packed on the device into ONE fp32
  ``(B, sum K)`` tensor, moved to the host in one copy and split there
  through a sorted layout;
- ``dispatch`` returns without waiting for the card (pinned host buffer,
  non-blocking host->device copy, kernels enqueued on the current stream)
  and ``fetch`` does the device->host copy, so a caller overlaps the next
  batch's host work with this batch's compute;
- busy-span throughput stats.

``MicroBatcher`` is copied from the JAX package (it is NumPy and threads
only). ``load_engine`` builds an engine from a checkpoint of the port's
``Trainer`` (``utils/checkpoint.py``).
"""
from __future__ import annotations

import math
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Tuple

import numpy as np
import torch

from rovit_kan_tpu_torch import resolve_device
from rovit_kan_tpu_torch.ops.ordinal import (
    cumulative_to_class_probs,
    ordinal_expected_severity,
)
from rovit_kan_tpu_torch.ops.preprocess import eval_batch


def build_serving_forward(model, temperature: float = 1.0):
    """Serving function ``uint8 NHWC images -> outputs``: normalization,
    forward and derived predictions. ``temperature`` divides the logits
    before the softmax only (post-hoc calibration); a positive scalar cannot
    change the argmax, so every other output is unaffected."""
    if not (math.isfinite(temperature) and temperature > 0.0):
        raise ValueError(
            f"calibration temperature must be a positive finite scalar, "
            f"got {temperature!r} — re-fit it or pass temperature=1.0 to "
            f"disable")
    with_ordinal = getattr(model, "with_ordinal", True)
    with_uncertainty = getattr(model, "with_uncertainty", True)
    inv_t = float(1.0 / temperature)

    def forward(images_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = model(eval_batch(images_u8))
        res = {
            "cls_probs": torch.softmax(out["cls_logits"] * inv_t, dim=-1),
            # int32, as the JAX engine serves it.
            "cls_pred": torch.argmax(out["cls_logits"], dim=-1)
            .to(torch.int32),
            "kan_severity": out["kan_severity"][:, 0],
        }
        if with_ordinal:
            res["ordinal_probs"] = cumulative_to_class_probs(
                out["ordinal_logits"])
            res["ordinal_severity"] = ordinal_expected_severity(
                out["ordinal_logits"])[:, 0]
        if with_uncertainty:
            res["uncertainty_std"] = torch.exp(0.5 * out["log_var"][:, 0])
        return res

    return forward


def serving_layout(model) -> List[Tuple[str, int, np.dtype, int]]:
    """``(name, width, host dtype, ndim)`` of each served output, sorted by
    name: the column layout of the packed tensor."""
    k = model.num_classes
    widths = {"cls_probs": (k, np.float32, 2), "cls_pred": (1, np.int32, 1),
              "kan_severity": (1, np.float32, 1)}
    if getattr(model, "with_ordinal", True):
        widths["ordinal_probs"] = (k, np.float32, 2)
        widths["ordinal_severity"] = (1, np.float32, 1)
    if getattr(model, "with_uncertainty", True):
        widths["uncertainty_std"] = (1, np.float32, 1)
    return [(name, *widths[name]) for name in sorted(widths)]


class InferenceEngine:
    """Serves a model at a fixed ``batch_size`` on ``device``."""

    def __init__(self, model, batch_size: int = 64, temperature: float = 1.0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.temperature = float(temperature)
        # Rolling windows (bounded); request/image totals stay exact.
        self._latencies: deque = deque(maxlen=10_000)
        self._request_sizes: deque = deque(maxlen=10_000)
        # Non-overlapping busy spans: pipelined requests must not
        # double-count overlapped wall time.
        self._busy: deque = deque(maxlen=10_000)
        self._last_end = 0.0
        self._n_requests = 0
        self._n_images = 0

        self._named = build_serving_forward(model, self.temperature)
        self._layout = serving_layout(model)
        size = model.image_size
        shape = (batch_size, size, size, 3)
        on_card = self.device.type == "cuda"
        # Two pinned staging buffers, used in turn: a dispatch may refill one
        # while the previous batch's copy still reads the other. Each copy
        # records an event, and a buffer is rewritten only after it fires.
        self._staging = [torch.empty(shape, dtype=torch.uint8,
                                     pin_memory=on_card) for _ in range(2)]
        self._copied = [None, None]
        self._turn = 0
        self._lock = threading.Lock()

    def _packed(self, images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            res = self._named(images)
            return torch.cat(
                [(res[k][:, None] if nd == 1 else res[k]).to(torch.float32)
                 for k, _, _, nd in self._layout], dim=1)

    def _unpack(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        out, off = {}, 0
        for k, width, dtype, ndim in self._layout:
            col = flat[:, off:off + width]
            if ndim == 1:
                col = col[:, 0]
            out[k] = col.astype(dtype)
            off += width
        return out

    def warmup(self) -> None:
        """Build the kernels and run one batch ahead of traffic (not counted
        in the stats)."""
        size = self.model.image_size
        dummy = torch.zeros((self.batch_size, size, size, 3),
                            dtype=torch.uint8, device=self.device)
        self._packed(dummy).cpu()

    def dispatch(self, images_u8: np.ndarray):
        """Async half of ``predict``: pad, stage, enqueue the copy and the
        forward, and return a handle without waiting for the card."""
        n = images_u8.shape[0]
        if n > self.batch_size:
            raise ValueError(f"dispatch takes <= batch_size={self.batch_size}"
                             f" images, got {n}; use predict() to split")
        t0 = time.perf_counter()
        with self._lock:
            i = self._turn
            self._turn ^= 1
            if self._copied[i] is not None:
                self._copied[i].synchronize()
            buf = self._staging[i]
            host = buf.numpy()
            host[:n] = images_u8
            host[n:] = 0
            images = buf.to(self.device, non_blocking=True)
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                self._copied[i] = ev
            else:
                images = images.clone()     # to() returned the buffer itself
        return self._packed(images), n, t0

    def fetch(self, handle) -> Dict[str, np.ndarray]:
        """Blocking half of ``predict``: device->host copy, unpack, stats."""
        flat, n, t0 = handle
        out = self._unpack(flat.cpu().numpy()[:n])
        end = time.perf_counter()
        self._latencies.append(end - t0)
        self._busy.append(end - max(t0, self._last_end))
        self._last_end = end
        self._request_sizes.append(n)
        self._n_requests += 1
        self._n_images += n
        return out

    def predict(self, images_u8: np.ndarray) -> Dict[str, np.ndarray]:
        """Serve one request of uint8 NHWC images; a request larger than
        ``batch_size`` is split and pipelined two chunks deep."""
        n = images_u8.shape[0]
        if n > self.batch_size:
            parts, prev = [], None
            for i in range(0, n, self.batch_size):
                h = self.dispatch(images_u8[i:i + self.batch_size])
                if prev is not None:
                    parts.append(self.fetch(prev))
                prev = h
            parts.append(self.fetch(prev))
            return {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}
        return self.fetch(self.dispatch(images_u8))

    def stats(self) -> Dict[str, float]:
        """Rolling serving stats (last 10k requests; totals exact).
        Throughput counts the images actually served over non-overlapping
        busy spans; the first request is left out of latency and throughput
        when more exist."""
        skip = 1 if self._n_requests > 1 and len(self._latencies) > 1 else 0
        lat = np.asarray(list(self._latencies)[skip:])
        busy = np.asarray(list(self._busy)[skip:])
        sizes = np.asarray(list(self._request_sizes)[skip:])
        if lat.size == 0:
            return {"requests": self._n_requests,
                    "temperature": self.temperature}
        return {
            "requests": self._n_requests,
            "temperature": self.temperature,
            "images_served": self._n_images,
            "mean_latency_ms": float(lat.mean() * 1e3),
            "p50_latency_ms": float(np.percentile(lat, 50) * 1e3),
            "p95_latency_ms": float(np.percentile(lat, 95) * 1e3),
            "images_per_sec": float(sizes.sum() / max(busy.sum(), 1e-9)),
        }


class MicroBatcher:
    """Dynamic request coalescing in front of an :class:`InferenceEngine`.

    Requests enqueue; ONE worker thread greedily packs whole queued requests
    into a single batch (up to ``engine.batch_size`` images), runs the engine
    once and slices the outputs back per request. With ``window_ms == 0`` the
    worker never waits; ``window_ms > 0`` lingers that long after the first
    request of a batch for stragglers. Thread-safe: ``submit``/``predict``
    may be called from any number of threads; the worker is the engine's only
    caller.
    """

    _STOP = object()

    def __init__(self, engine: InferenceEngine, window_ms: float = 0.0):
        self.engine = engine
        self.window = window_ms / 1e3
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()   # orders submit() vs close()
        self._closed = False
        self._carry = None              # popped request awaiting next batch
        self.batches_run = 0
        self.requests_coalesced = 0
        self._worker = threading.Thread(
            target=self._loop, name="microbatch-worker", daemon=True)
        self._worker.start()

    # -- client side -----------------------------------------------------
    def submit(self, images_u8: np.ndarray):
        """Enqueue one request; returns a ``concurrent.futures.Future``
        resolving to the dict ``InferenceEngine.predict`` returns. The shape
        and dtype are checked here, so a malformed request fails alone."""
        from concurrent.futures import Future
        if images_u8.ndim != 4 or images_u8.shape[-1] != 3:
            raise ValueError(f"expected (N, H, W, 3), got {images_u8.shape}")
        if images_u8.dtype != np.uint8:
            raise ValueError(f"expected uint8 images, got {images_u8.dtype}")
        size = getattr(getattr(self.engine, "model", None),
                       "image_size", None)
        if size is not None and images_u8.shape[1:3] != (size, size):
            raise ValueError(f"engine serves {size}x{size}px, got "
                             f"{images_u8.shape[1]}x{images_u8.shape[2]}")
        fut: Future = Future()
        with self._lock:
            # closed-check + put are atomic: no request lands behind _STOP.
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.put((images_u8, fut))
        return fut

    def predict(self, images_u8: np.ndarray) -> Dict[str, np.ndarray]:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(images_u8).result()

    def close(self) -> None:
        """Drain outstanding requests, then stop the worker."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(self._STOP)
        self._worker.join()

    def stats(self) -> Dict[str, float]:
        s = dict(self.engine.stats())
        s["batches_run"] = self.batches_run
        s["requests_coalesced"] = self.requests_coalesced
        if self.batches_run:
            s["mean_requests_per_batch"] = (
                self.requests_coalesced / self.batches_run)
        return s

    # -- worker side -----------------------------------------------------
    def _collect(self, block: bool = True, linger: bool = True):
        """Pack whole queued requests into one engine batch. Returns
        ``None`` on the _STOP sentinel and ``[]`` when ``block=False`` finds
        nothing queued. A popped request that does not fit goes into
        ``self._carry`` and LEADS the next batch (FIFO, no starvation)."""
        if self._carry is not None:
            first, self._carry = self._carry, None
        else:
            try:
                first = (self._queue.get() if block
                         else self._queue.get_nowait())
            except queue.Empty:
                return []
            if first is self._STOP:
                return None
        batch, total = [first], first[0].shape[0]
        deadline = time.perf_counter() + (self.window if linger else 0.0)
        while total < self.engine.batch_size:
            try:
                timeout = deadline - time.perf_counter()
                item = (self._queue.get_nowait() if timeout <= 0
                        else self._queue.get(timeout=timeout))
            except queue.Empty:
                break
            if item is self._STOP:
                self._queue.put(self._STOP)   # re-arm for the next loop
                break
            if total + item[0].shape[0] > self.engine.batch_size:
                self._carry = item            # whole requests, FIFO order
                break
            batch.append(item)
            total += item[0].shape[0]
        return batch

    # Engines expose async dispatch/fetch halves; predict-only duck-typed
    # engines still work, unpipelined (their predict runs at dispatch time).
    def _dispatch(self, imgs):
        if hasattr(self.engine, "dispatch") and hasattr(self.engine,
                                                        "fetch"):
            return ("async", self.engine.dispatch(imgs))
        return ("done", self.engine.predict(imgs))

    def _fetch(self, tagged):
        tag, v = tagged
        if tag == "async":
            return self.engine.fetch(v)
        if tag == "sync":                # oversize: engine splits it
            return self.engine.predict(v)
        return v                         # "done": already computed

    def _resolve(self, pending) -> None:
        batch, tagged = pending
        try:
            out = self._fetch(tagged)
        except Exception as e:
            for _, fut in batch:
                fut.set_exception(e)
            return
        self.batches_run += 1
        self.requests_coalesced += len(batch)
        off = 0
        for img, fut in batch:
            n = img.shape[0]
            fut.set_result({k: v[off:off + n] for k, v in out.items()})
            off += n

    def _loop(self) -> None:
        # Depth-2 pipeline: dispatch batch k+1 before fetching batch k, so
        # host-side collection, padding and the copy of the next batch
        # overlap the card's compute of the current one.
        pending = None                 # (claimed batch, dispatch handle)
        while True:
            # No linger while a batch is in flight: its results may already
            # be ready.
            batch = self._collect(block=pending is None,
                                  linger=pending is None)
            stop = batch is None
            new_pending = None
            if batch:
                # A client may have cancelled its Future while queued;
                # claim each future first and drop the cancelled ones.
                batch = [(img, fut) for img, fut in batch
                         if fut.set_running_or_notify_cancel()]
            if batch:
                arrays = [img for img, _ in batch]
                imgs = (arrays[0] if len(arrays) == 1 else
                        np.concatenate(arrays, axis=0))
                if imgs.shape[0] <= self.engine.batch_size:
                    try:
                        new_pending = (batch, self._dispatch(imgs))
                    except Exception as e:
                        for _, fut in batch:
                            fut.set_exception(e)
                else:
                    # Oversize single request: engine.predict splits it, on
                    # the sync path, after the in-flight batch resolves.
                    if pending is not None:
                        self._resolve(pending)
                        pending = None
                    self._resolve((batch, ("sync", imgs)))
            if pending is not None:
                self._resolve(pending)
            pending = new_pending
            if stop and pending is None:
                return


def load_engine(checkpoint_path, batch_size: int = 64, config=None,
                image_size: int = None, temperature: float = None,
                device="cuda") -> InferenceEngine:
    """Checkpoint -> engine on ``device``. ``image_size`` serves at another
    resolution than trained (``transfer_resolution``; at >= 512 tokens in
    bf16 on the card the "auto" policy picks the attention kernels for an
    unfused block). ``temperature=None`` adopts the calibration temperature
    recorded in the checkpoint's sidecar, when there is one; pass a float to
    override it, or 1.0 to serve raw confidences."""
    from rovit_kan_tpu_torch.evaluation.evaluator import \
        load_model_for_evaluation
    from rovit_kan_tpu_torch.utils.checkpoint import load_meta
    model, _ = load_model_for_evaluation(checkpoint_path, config,
                                         image_size=image_size, device=device)
    if temperature is None:
        temperature = float(load_meta(checkpoint_path).get("temperature",
                                                           1.0))
    return InferenceEngine(model, batch_size=batch_size,
                           temperature=temperature, device=device)
