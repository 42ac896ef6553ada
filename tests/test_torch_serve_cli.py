"""The port's HTTP server (``rovit_kan_tpu_torch/cli/serve.py``) against the
JAX package's (``scripts/serve.py``, imported as ``tests/test_serving.py``
imports it).

Both ``make_server``s front the same gated stand-in engine (each its own
instance): equal JSON bodies and status codes for good, malformed,
wrong-resolution, wrong-dtype, oversize and unknown-path requests; the
same ``/healthz`` keys and values and the same ``/metrics`` names and
``# TYPE`` lines; six concurrent requests coalesced into the same batches.
Then ``cli.serve --cpu`` in a subprocess on a tiny checkpoint: its answers
are ``load_engine``'s, and SIGTERM drains it to exit 0. Every server and
subprocess has a timeout of its own.
"""
import io
import json
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from rovit_kan_tpu_torch.cli.serve import make_server
from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.models.rovit_kan import build_model
from rovit_kan_tpu_torch.serving import load_engine
from rovit_kan_tpu_torch.utils.checkpoint import save_checkpoint

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from serve import make_server as jax_make_server  # noqa: E402

SIZE = 8
TIMEOUT = 60


class _StandIn:
    """Predict-only engine: each image's answer is a function of its pixels;
    a call waits for ``gate``. Its stats are fixed numbers."""
    batch_size = 8

    def __init__(self):
        self.model = SimpleNamespace(image_size=SIZE)
        self.gate = threading.Event()
        self.gate.set()
        self.calls = []

    def predict(self, imgs):
        self.calls.append(len(imgs))
        assert self.gate.wait(TIMEOUT)
        m = imgs.reshape(len(imgs), -1).astype(np.float32).mean(1) / 255.0
        return {"cls_pred": (m > 0.5).astype(np.int32),
                "cls_probs": np.stack([m, 1.0 - m], 1).astype(np.float32),
                "kan_severity": (3.0 * m).astype(np.float32)}

    def stats(self):
        return {"requests": len(self.calls), "temperature": 1.0,
                "images_served": int(sum(self.calls)),
                "p50_latency_ms": 1.5, "images_per_sec": 250.0}


@pytest.fixture
def servers():
    """The JAX and the port server on free ports, each over a stand-in."""
    made = []
    for factory in (jax_make_server, make_server):
        engine = _StandIn()
        server = factory(engine, host="127.0.0.1", port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        made.append((f"http://127.0.0.1:{server.server_address[1]}",
                     engine, server, thread))
    yield made
    for _, engine, server, thread in made:
        engine.gate.set()
        server.shutdown()
        server.server_close()
        server.batcher.close()
        thread.join(timeout=TIMEOUT)
        assert not thread.is_alive()


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _imgs(n, seed=0, size=SIZE):
    return np.random.RandomState(seed).randint(
        0, 256, (n, size, size, 3)).astype(np.uint8)


def _request(base, path, body=None):
    """(status, body bytes, content type) of one request."""
    req = urllib.request.Request(f"{base}{path}", body)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers["Content-Type"]


CASES = {
    "one image": ("/predict", _npy(_imgs(1, seed=1))),
    "three images": ("/predict", _npy(_imgs(3, seed=2))),
    "malformed": ("/predict", b"not npy"),
    "wrong resolution": ("/predict", _npy(_imgs(1, size=4))),
    "wrong dtype": ("/predict", _npy(_imgs(1).astype(np.float32))),
    "not NHWC": ("/predict", _npy(np.zeros((2, SIZE, SIZE), np.uint8))),
    "oversize": ("/predict", b"\0" * (4 * 8 * SIZE * SIZE * 3 + 4097)),
    "unknown POST": ("/other", b""),
    "unknown GET": ("/other", None),
}


def test_bodies_and_codes_match_jax(servers):
    (jax_base, *_), (port_base, *_) = servers
    codes = {}
    for name, (path, body) in CASES.items():
        want = _request(jax_base, path, body)
        got = _request(port_base, path, body)
        assert got[0] == want[0], name
        assert got[2] == want[2], name
        assert json.loads(got[1]) == json.loads(want[1]), name
        codes[name] = got[0]
    assert codes == {"one image": 200, "three images": 200, "malformed": 400,
                     "wrong resolution": 400, "wrong dtype": 400,
                     "not NHWC": 400, "oversize": 413, "unknown POST": 404,
                     "unknown GET": 404}


def test_healthz_and_metrics_match_jax(servers):
    pages = []
    for base, *_ in servers:
        for seed in range(3):
            assert _request(base, "/predict",
                            _npy(_imgs(2, seed=seed)))[0] == 200
        health = _request(base, "/healthz")
        metrics = _request(base, "/metrics")
        assert health[0] == metrics[0] == 200
        pages.append((json.loads(health[1]), metrics[1].decode(),
                      metrics[2]))
    (jax_health, jax_metrics, jax_type), (health, metrics, ctype) = pages
    assert health == jax_health
    assert ctype == jax_type
    assert metrics == jax_metrics
    kinds = dict(line.split()[2:] for line in metrics.splitlines()
                 if line.startswith("# TYPE"))
    assert kinds["rovit_serving_requests"] == "counter"
    assert kinds["rovit_serving_requests_coalesced"] == "counter"
    assert kinds["rovit_serving_images_per_sec"] == "gauge"
    assert len(kinds) == len(health)


def test_six_concurrent_requests_coalesce(servers):
    got = []
    for base, engine, server, _ in servers:
        engine.gate.clear()            # the first batch waits in predict
        answers = {}

        def post(i):
            answers[i] = json.loads(_request(base, "/predict",
                                             _npy(_imgs(1, seed=10 + i)))[1])

        first = threading.Thread(target=post, args=(0,))
        first.start()
        deadline = time.monotonic() + TIMEOUT
        while len(engine.calls) < 1:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        rest = [threading.Thread(target=post, args=(i,)) for i in range(1, 6)]
        for t in rest:
            t.start()
        while server.batcher._queue.qsize() < 5:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        engine.gate.set()
        for t in [first] + rest:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        for i in range(6):
            want = engine.predict(_imgs(1, seed=10 + i))
            assert answers[i] == {k: v.tolist() for k, v in want.items()}
        health = json.loads(_request(base, "/healthz")[1])
        got.append((engine.calls[:2], health["batches_run"],
                    health["requests_coalesced"]))
    # One batch of the first request, then one of the five queued behind it.
    assert got[1] == got[0] == ([1, 5], 2, 6)


def test_shutdown_answers_accepted_requests(servers):
    """The drain that SIGTERM starts: ``shutdown`` stops the accept loop
    while three requests wait in the engine and the queue; ``server_close``
    returns only once each is answered."""
    _, (base, engine, server, thread) = servers
    engine.gate.clear()
    answers = {}

    def post(i):
        answers[i] = _request(base, "/predict", _npy(_imgs(1, seed=30 + i)))

    clients = [threading.Thread(target=post, args=(i,)) for i in range(3)]
    deadline = time.monotonic() + TIMEOUT
    clients[0].start()
    while len(engine.calls) < 1:       # the first batch waits in predict
        assert time.monotonic() < deadline
        time.sleep(0.005)
    for t in clients[1:]:
        t.start()
    while server.batcher._queue.qsize() < 2:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    server.shutdown()
    thread.join(timeout=TIMEOUT)
    assert not thread.is_alive()
    closing = threading.Thread(target=server.server_close)
    closing.start()
    time.sleep(0.2)
    assert closing.is_alive()          # waiting on the accepted requests
    engine.gate.set()
    closing.join(timeout=TIMEOUT)
    assert not closing.is_alive()
    for t in clients:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert sorted(answers) == [0, 1, 2]
    for i, (code, body, _) in answers.items():
        want = engine.predict(_imgs(1, seed=30 + i))
        assert code == 200
        assert json.loads(body) == {k: v.tolist() for k, v in want.items()}


def _tiny_checkpoint(path: Path) -> None:
    cfg = Config()
    cfg.data.image_size = 32
    cfg.model.depth = 1
    cfg.model.embed_dim = 32
    cfg.model.num_heads = 2
    cfg.model.hidden_dim = 16
    cfg.model.kan_layers = [32, 8, 1]
    cfg.flags.mixed_precision = False
    save_checkpoint(path, build_model(cfg, device="cpu", seed=3).state_dict(),
                    config=cfg)


def test_sigterm_drains_cli_serve(tmp_path):
    ck = tmp_path / "best_model"
    _tiny_checkpoint(ck)
    engine = load_engine(ck, batch_size=4, device="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "rovit_kan_tpu_torch.cli.serve",
         "--checkpoint", str(ck), "--host", "127.0.0.1", "--port", "0",
         "--batch_size", "4", "--cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT)
    try:
        started = []

        def wait_for_start():
            for line in proc.stdout:
                if line.startswith("Serving on http://"):
                    started.append(line.split()[2])
                    return

        reader = threading.Thread(target=wait_for_start, daemon=True)
        reader.start()
        reader.join(timeout=240)
        assert started, "cli.serve did not start"
        base = started[0]
        answers = {}

        def post(i):
            answers[i] = json.loads(_request(
                base, "/predict", _npy(_imgs(1 + i % 4, seed=20 + i,
                                             size=32)))[1])

        clients = [threading.Thread(target=post, args=(i,)) for i in range(6)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert "Drained" in out
    assert sorted(answers) == list(range(6))
    for i, body in answers.items():
        want = engine.predict(_imgs(1 + i % 4, seed=20 + i, size=32))
        assert set(body) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(np.asarray(body[k], v.dtype), v,
                                       rtol=0, atol=1e-6, err_msg=k)
