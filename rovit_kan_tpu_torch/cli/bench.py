"""Headline benchmark of the port on one card, printed as ONE JSON line.

    python -m rovit_kan_tpu_torch.cli.bench [--cpu]

The single-card counterpart of the JAX package's root ``bench.py``, on the
flagship config (``get_config()``: DeiT-Tiny, 224 px) in bf16, weights from
seed 0:

- ``fwd_ips_bs64`` (the headline ``value``) and ``fwd_ips_bs256``: forward
  img/s through the inference build, which "auto" puts on the fused block
  (#1);
- ``fps_bs1``: ``evaluation/metrics.py::fps_benchmark`` on one image;
- ``train_ips_bs64`` and ``train_ips_bs256``: ``TrainStep`` img/s at stage
  4 with CutMix/MixUp on (#1, #2 and #7);
- ``device_ops_fwd`` and ``device_ops_step``: the kernels and copies one
  forward or one train step at batch 64 enqueues (torch.profiler);
- ``flops_fwd_per_image`` and ``flops_train_per_image``: an analytic count
  of the model's products from its shapes (``model_flops``; a train step is
  three forwards), so it stays the same whatever implements a kernel;
  ``implied_tflops_*`` and ``implied_mfu_*`` against the H100's 989 TFLOP/s
  dense bf16, and ``timing_suspect`` when an MFU reads over 1;
- ``device``: the card's name and count, and its name and power limit as
  ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
  them.

Each rate is the best of ``N_CHUNKS`` chunks after warm-ups, each chunk
closed by a host fetch of its last result; on one stream that fetch waits
for every launch of the chunk. With ``--cpu`` it runs the plain path on the
CPU and leaves the device metrics (operations, MFU) null.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import time
from typing import Callable, Optional

import numpy as np
import torch

#: The H100's dense bf16 peak (NVIDIA's data sheet, SXM part, 700 W).
PEAK_BF16_FLOPS = 989e12
BATCHES = (64, 256)
FWD_WARMUP, FWD_CHUNK = 10, 20          # forwards: warm-up, per chunk
TRAIN_WARMUP, TRAIN_CHUNK = 5, 20       # train steps: warm-up, per chunk
N_CHUNKS = 5
FPS_WARMUP, FPS_ITERS = 10, 100         # fps_benchmark's own defaults


def bench_config():
    """The benchmarked configuration: the flagship."""
    from rovit_kan_tpu_torch.config import get_config
    return get_config()


def model_flops(config) -> int:
    """Operations (2 per multiply-add) of one image's forward through the
    model's products, from the config's shapes: the patch embedding, each
    block's qkv, attention (q k^T and P v), projection and MLP, and the
    heads (classification; ordinal, uncertainty and the KAN head's dense
    and spline paths where present). Elementwise work, norms and softmax
    are left out."""
    m, size = config.model, config.data.image_size
    d, p, classes, hid = m.embed_dim, m.patch_size, m.num_classes, \
        m.hidden_dim
    patches = (size // p) ** 2
    n = patches + 1
    mlp = int(d * m.mlp_ratio)
    block = 2 * n * d * (3 * d + d + 2 * mlp) + 2 * 2 * n * n * d
    flops = 2 * patches * p * p * 3 * d + m.depth * block
    flops += 2 * (d * hid + hid * classes)
    if m.with_ordinal:
        flops += 2 * (d * hid + hid * (classes - 1))
    if m.with_uncertainty:
        flops += 2 * (d * hid + 2 * hid)
    if m.with_kan:
        n_basis = m.kan_num_knots + m.kan_degree - 1
        dims = m.kan_layers
        flops += sum(2 * a * b * (1 + n_basis)
                     for a, b in zip(dims[:-1], dims[1:]))
    return flops


def card_power() -> Optional[str]:
    """nvidia-smi's name and power limit of the first card, or None where
    there is no nvidia-smi."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def best_seconds(run_chunk: Callable[[], None]) -> float:
    """Seconds of the best of ``N_CHUNKS`` chunks; ``run_chunk`` runs a
    fixed number of iterations and fetches its last result."""
    best = float("inf")
    for _ in range(N_CHUNKS):
        t0 = time.perf_counter()
        run_chunk()
        best = min(best, time.perf_counter() - t0)
    return best


def device_ops(fn: Callable[[], None], device: torch.device, calls: int = 3,
               takes: int = 5) -> Optional[float]:
    """Device operations (kernels, copies, fills) one call of ``fn``
    enqueues, from torch.profiler over ``calls`` calls after a warm-up. The
    profiler traces and discards one round of ``calls`` first (its
    schedule's warm-up), since a trace can lose its first operations; a
    profile whose counts are not multiples of ``calls`` lost some and is
    taken again. None off the card."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(takes):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        counts = [e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")]
        if counts and all(c % calls == 0 for c in counts):
            return sum(counts) / calls
    raise RuntimeError(f"no whole profile of {calls} calls in {takes} takes")


def _train_batch(config, batch: int, device, seed: int):
    rng = np.random.RandomState(seed)
    size = config.data.image_size
    labels = torch.from_numpy(rng.randint(0, config.model.num_classes,
                                          batch)).long().to(device)
    return {"images": torch.from_numpy(rng.randint(
                0, 256, (batch, size, size, 3)).astype(np.uint8)).to(device),
            "labels": labels, "severity": labels.float()}


def run(device: torch.device) -> dict:
    from rovit_kan_tpu_torch.evaluation.metrics import fps_benchmark
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.training.optimizer import (
        build_optimizer,
        set_hyperparams,
    )
    from rovit_kan_tpu_torch.training.trainer import make_train_step

    config = bench_config()
    bf16 = torch.bfloat16
    size = config.data.image_size
    model_inf = build_model(config, dtype=bf16, inference=True,
                            device=device, seed=0)
    model = build_model(config, dtype=bf16, device=device, seed=0)
    opt = set_hyperparams(build_optimizer(model, config), 5e-4, 0.1)
    step = make_train_step(model, opt, config,
                           generator=torch.Generator(device).manual_seed(1))
    gen = torch.Generator(device).manual_seed(0)
    res = {"metric": f"images_per_sec_fwd_bs{BATCHES[0]}", "value": None,
           "unit": "images/sec",
           "config": {"image_size": size,
                      "depth": config.model.depth,
                      "embed_dim": config.model.embed_dim,
                      "dtype": "bfloat16"},
           "fused_block": {
               "inference": all(b.use_fused_block for b in
                                model_inf.backbone.model.blocks),
               "train": all(b.use_fused_block for b in
                            model.backbone.model.blocks)},
           "fused_augment": step.fused_augment}

    def forward(x):
        return model_inf(x)["cls_logits"]

    with torch.inference_mode():
        for batch in BATCHES:
            x = torch.randn((batch, size, size, 3), generator=gen,
                            device=device)
            for _ in range(FWD_WARMUP):
                out = forward(x)
            float(out[0, 0])

            def fwd_chunk():
                for _ in range(FWD_CHUNK):
                    out = forward(x)
                float(out[0, 0])            # the host fetch closes the chunk
            res[f"fwd_ips_bs{batch}"] = batch * FWD_CHUNK / best_seconds(
                fwd_chunk)
            if batch == BATCHES[0]:
                res["device_ops_fwd"] = device_ops(lambda: forward(x),
                                                   device)
        res["fps_bs1"] = float(fps_benchmark(
            forward, torch.randn((1, size, size, 3), generator=gen,
                                 device=device),
            warmup=FPS_WARMUP, iters=FPS_ITERS))

    for batch in BATCHES:
        data = _train_batch(config, batch, device, seed=batch)
        for _ in range(TRAIN_WARMUP):
            metrics = step(data, 4, 1.0, 1)
        float(metrics["total_loss"])

        def train_chunk():
            for _ in range(TRAIN_CHUNK):
                metrics = step(data, 4, 1.0, 1)
            loss = float(metrics["total_loss"])
            if not np.isfinite(loss):
                raise RuntimeError(f"non-finite train loss {loss}")
        res[f"train_ips_bs{batch}"] = batch * TRAIN_CHUNK / best_seconds(
            train_chunk)
        if batch == BATCHES[0]:
            res["device_ops_step"] = device_ops(
                lambda: step(data, 4, 1.0, 1), device)
    res["value"] = res[f"fwd_ips_bs{BATCHES[0]}"]

    flops = model_flops(config)
    res["flops_fwd_per_image"] = flops
    res["flops_train_per_image"] = 3 * flops
    on_card = device.type == "cuda"
    mfus = []
    for kind, per_image in (("fwd", flops), ("train", 3 * flops)):
        for batch in BATCHES:
            tflops = res[f"{kind}_ips_bs{batch}"] * per_image / 1e12
            mfu = tflops * 1e12 / PEAK_BF16_FLOPS if on_card else None
            res[f"implied_tflops_{kind}_bs{batch}"] = tflops
            res[f"implied_mfu_{kind}_bs{batch}"] = mfu
            mfus.append(mfu)
    res["peak_tflops_bf16"] = PEAK_BF16_FLOPS / 1e12 if on_card else None
    res["timing_suspect"] = any(m is not None and m > 1.0 for m in mfus)
    res["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": torch.cuda.device_count() if on_card else 0,
        "nvidia_smi": card_power() if on_card else None}
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="run the plain path on the CPU (no device metrics)")
    args = p.parse_args(argv)
    from rovit_kan_tpu_torch import resolve_device
    res = run(resolve_device("cpu" if args.cpu else "cuda"))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
