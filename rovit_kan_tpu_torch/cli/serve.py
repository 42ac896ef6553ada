"""HTTP serving endpoint around the port's ``InferenceEngine``, on one card
(stdlib only).

    python -m rovit_kan_tpu_torch.cli.serve --checkpoint CK [--host H] \
        [--port 8000] [--batch_size 64] [--image_size S] \
        [--batch_window_ms MS] [--temperature T] [--cpu]

The protocol of the JAX package's ``scripts/serve.py``:

  POST /predict    body = ``.npy`` bytes of a uint8 (N, H, W, 3) array
                   (``np.save(buf, imgs)``) -> JSON dict of predictions;
                   400 for a malformed body or another resolution, 413 past
                   ``4 * batch_size * S * S * 3 + 4096`` bytes, 503 when no
                   answer comes within 120 s.
  GET  /healthz    -> 200 + JSON engine and batcher stats.
  GET  /metrics    -> Prometheus text of the same stats (``rovit_serving_*``;
                   counters: requests, images_served, batches_run,
                   requests_coalesced; the rest gauges).

Concurrent requests are coalesced by the port's ``MicroBatcher`` into the
engine's fixed batch. On SIGTERM the server stops accepting, answers every
request it accepted, drains the batcher and exits 0. Runs on the card
unless ``--cpu`` is given.

Client sketch:
  buf = io.BytesIO(); np.save(buf, imgs_u8)
  req = urllib.request.Request("http://host:8000/predict", buf.getvalue())
  preds = json.loads(urllib.request.urlopen(req).read())
"""
from __future__ import annotations

import argparse
import io
import json
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

#: The stats that are exact totals; every other stat is a gauge.
COUNTERS = ("requests", "images_served", "batches_run", "requests_coalesced")
#: Seconds a request waits for its answer before a 503.
ANSWER_TIMEOUT_S = 120


class _Server(ThreadingHTTPServer):
    # Handler threads are joined by server_close(), so a drain answers every
    # request accepted before the shutdown.
    daemon_threads = False


def make_server(engine, host: str = "0.0.0.0", port: int = 8000,
                batch_window_ms: float = 0.0) -> ThreadingHTTPServer:
    """Wrap an ``InferenceEngine`` in a ready-to-run threaded HTTP server.

    One ``MicroBatcher`` worker owns the engine and packs whole queued
    requests into one padded batch; with the default 0 ms window a lone
    client sees the unbatched latency, ``batch_window_ms > 0`` lingers for
    stragglers. The caller closes ``server.batcher`` after
    ``server_close()``."""
    from rovit_kan_tpu_torch.serving import MicroBatcher
    batcher = MicroBatcher(engine, window_ms=batch_window_ms)

    class Handler(BaseHTTPRequestHandler):
        size = engine.model.image_size
        # 4 full batches of raw pixels and the npy header.
        max_body = 4 * engine.batch_size * size * size * 3 + 4096

        def log_message(self, fmt, *args):     # no access log
            pass

        def _send(self, code: int, body: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, payload) -> None:
            self._send(code, json.dumps(payload).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, batcher.stats())
            elif self.path == "/metrics":
                lines = []
                for k, v in sorted(batcher.stats().items()):
                    name = f"rovit_serving_{k}"
                    kind = "counter" if k in COUNTERS else "gauge"
                    lines += [f"# TYPE {name} {kind}", f"{name} {v}"]
                self._send(200, ("\n".join(lines) + "\n").encode(),
                           "text/plain; version=0.0.4")
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > self.max_body:
                    self._json(413, {"error": f"body {n} bytes exceeds "
                                              f"cap {self.max_body}"})
                    return
                imgs = np.load(io.BytesIO(self.rfile.read(n)),
                               allow_pickle=False)
                if imgs.dtype != np.uint8 or imgs.ndim != 4 \
                        or imgs.shape[-1] != 3:
                    raise ValueError(
                        f"expected uint8 (N, H, W, 3), got "
                        f"{imgs.dtype} {imgs.shape}")
                if imgs.shape[1:3] != (self.size, self.size):
                    raise ValueError(
                        f"engine serves {self.size}x{self.size}px, got "
                        f"{imgs.shape[1]}x{imgs.shape[2]}")
            except Exception as e:             # a malformed request
                self._json(400, {"error": str(e)})
                return
            fut = None
            try:
                fut = batcher.submit(imgs)
                # Bounded wait: a wedged worker gives a 503, not a handler
                # thread stuck forever. The worker drops cancelled futures.
                out = fut.result(timeout=ANSWER_TIMEOUT_S)
                self._json(200, {k: np.asarray(v).tolist()
                                 for k, v in out.items()})
            except TimeoutError:
                fut.cancel()
                self._json(503, {"error": "inference timed out"})
            except Exception as e:             # a serving failure
                if fut is not None:
                    fut.cancel()
                self._json(500, {"error": str(e)})

    server = _Server((host, port), Handler)
    server.batcher = batcher
    return server


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", type=Path, required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000,
                   help="0 picks a free port (printed at start)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--image_size", type=int, default=None,
                   help="serve at another resolution than trained "
                        "(position-embedding transfer)")
    p.add_argument("--batch_window_ms", type=float, default=0.0,
                   help="linger this long for more requests before running "
                        "a partly filled batch (0: greedy coalescing, no "
                        "added latency)")
    p.add_argument("--temperature", type=float, default=None,
                   help="calibration temperature for the served cls_probs "
                        "(softmax(logits/T); argmax unchanged). Default: "
                        "the checkpoint sidecar's (cli.evaluate "
                        "--store_temperature), else 1.0")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from rovit_kan_tpu_torch.serving import load_engine

    engine = load_engine(args.checkpoint, batch_size=args.batch_size,
                         image_size=args.image_size,
                         temperature=args.temperature,
                         device="cpu" if args.cpu else "cuda")
    if engine.temperature != 1.0:
        print(f"Serving calibrated confidences (T={engine.temperature:.4f})")
    print(f"Warming up (batch {args.batch_size}, {engine.model.image_size}px,"
          f" {engine.device})...", flush=True)
    engine.warmup()
    server = make_server(engine, args.host, args.port,
                         batch_window_ms=args.batch_window_ms)

    # SIGTERM (an orchestrator's stop) drains as Ctrl-C does: stop
    # accepting, answer what was accepted, finish the queue, exit 0.
    # shutdown() must run off the serving thread.
    def _term(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    print(f"Serving on http://{args.host}:{server.server_address[1]} "
          f"(POST /predict, GET /healthz, GET /metrics)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()          # joins the handler threads
        server.batcher.close()
    print("Drained; exiting", flush=True)


if __name__ == "__main__":
    main()
