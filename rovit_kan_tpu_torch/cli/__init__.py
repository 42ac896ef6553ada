"""Command-line entry points of the port: ``python -m
rovit_kan_tpu_torch.cli.<name>`` for ``train``, ``evaluate``,
``export_model``, ``serve``, ``bench``, ``profile_train``, ``visualize``,
``run_ablation``, ``run_baselines``, ``bench_host_pipeline`` (``--cpu`` off
the card) and ``convert_checkpoint`` (CPU only); and the data-parallel
launch that ``train`` and ``run_ablation`` share (``--devices``,
``--multihost``)."""
from __future__ import annotations

import contextlib
import os
import random
import signal
import socket
import subprocess
import sys
import time

#: ``--matmul_precision``'s values (the JAX scripts' XLA precisions) and the
#: ``torch.set_float32_matmul_precision`` setting each maps to.
MATMUL_PRECISION = {"bfloat16": "medium", "tensorfloat32": "high",
                    "float32": "highest"}
MATMUL_PRECISION_HELP = (
    "fp32 matmul precision of the plain PyTorch path (bfloat16, "
    "tensorfloat32 or float32: torch.set_float32_matmul_precision medium, "
    "high or highest); the hand-written kernels keep their own arithmetic")


def set_matmul_precision(name) -> None:
    """Apply ``--matmul_precision`` (None leaves torch's setting)."""
    if name is not None:
        import torch
        torch.set_float32_matmul_precision(MATMUL_PRECISION[name])


MULTIHOST_HELP = (
    "be one rank of the torch.distributed job torchrun describes (RANK / "
    "WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT) and train over a "
    "mesh spanning every process's card")


def data_parallel_size(devices: int, cpu: bool) -> int:
    """The ranks ``--devices`` asks for: -1 is every visible card (one
    process on the CPU). Refuses more cards than are visible."""
    if cpu:
        return max(devices, 1)
    import torch
    visible = torch.cuda.device_count()
    n = visible if devices == -1 else devices
    if n > visible:
        raise ValueError(f"--devices {devices} asks for {n} cards, but "
                         f"{visible} are visible")
    return max(n, 1)


def _ephemeral_floor() -> int:
    """The lowest port the kernel gives an outgoing connection."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def _free_port() -> int:
    """A port for rank 0's store, free when it is drawn, at random below
    the ephemeral range: a port that ``bind(0)`` hands out and the caller
    releases is free for the kernel to give again, to any outgoing
    connection (each pair of gloo ranks opens some), before rank 0 binds
    it; below that range only another explicit bind can take it."""
    rng = random.SystemRandom()
    top = _ephemeral_floor()
    while True:
        port = rng.randrange(max(1024, top - 16384), top)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port


def spawn_workers(cmd, n: int, log_dir=None, timeout=None) -> None:
    """Run the command ``cmd`` (an argv list) as ``n`` ranks on this host,
    with torchrun's variables set, forwarding SIGTERM to them. ``log_dir``:
    each rank's output goes to ``log_dir/rank{r}.log`` (else to this
    process's). Returns when every rank has exited 0; when one fails, or
    ``timeout`` seconds pass first, stops the others and raises SystemExit
    naming it."""
    port = _free_port()
    procs, logs = [], []
    deadline = None if timeout is None else time.monotonic() + timeout
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        out = None
        if log_dir is not None:
            out = open(os.path.join(log_dir, f"rank{r}.log"), "w")
            logs.append(out)
        procs.append(subprocess.Popen(
            [str(a) for a in cmd], env=env, stdout=out,
            stderr=None if out is None else subprocess.STDOUT))

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    prev = None
    with contextlib.suppress(ValueError):     # not the main thread
        prev = signal.signal(signal.SIGTERM, forward)
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c]
            if failed:
                raise SystemExit(f"rank {failed[0][0]} of {n} exited with "
                                 f"code {failed[0][1]}")
            if all(c == 0 for c in codes):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise SystemExit(f"ranks of {n} still running after "
                                 f"{timeout} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for out in logs:
            out.close()
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
