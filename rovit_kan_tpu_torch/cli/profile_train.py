"""Profile the flagship train step on one card: a stage decomposition and a
torch.profiler trace.

    python -m rovit_kan_tpu_torch.cli.profile_train [--batches 64 256] \
        [--iters 20] [--trace_dir DIR] [--out FILE] [--no_fused_augment] \
        [--cpu]

The counterpart of the JAX package's ``scripts/profile_train.py``, on the
flagship config in bf16 (weights from seed 0, stage 4, CutMix/MixUp on):

1. Stage decomposition, per batch size, on ``cli.bench``'s configuration.
   Each stage runs alone, timed as ``cli.bench`` times (the best of its
   ``N_CHUNKS`` chunks of ``--iters`` iterations, each closed by a host
   fetch of its last result): ``h2d_ms`` (the uint8
   batch from the host), ``augment_ms`` (the augment, kernel #7 where the
   step takes it, then CutMix/MixUp), ``forward_ms`` (the train-mode forward
   with dropout, no autograd), ``fwd_bwd_ms`` (forward, joint loss and
   backward), ``update_ms`` (the flat AdamW update alone) and
   ``full_step_ms`` (``TrainStep``), with ``train_ips`` and each stage's
   share of the full step (``pct_of_full``).
2. With ``--trace_dir``: a torch.profiler trace (``trace.json``) of
   ``TRACE_STEPS`` full steps per batch size under ``DIR/bs<B>``, and its
   per-op table (``ops.txt``, by self device time on the card, by self host
   time on the CPU), whose top device operations (host ops on the CPU) also
   go into the JSON.

``config.train.fused_augment`` is set as the JAX script sets it: False with
``--no_fused_augment``, else the config's "auto". One JSON line per batch
size; ``--out`` also writes them all, with the device, into one file. Runs
on the card unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from rovit_kan_tpu_torch.cli import bench

TRACE_STEPS = 10
TOP_OPS = 15


def _fetch(t: torch.Tensor) -> float:
    """A host fetch of one element: waits for every launch before it."""
    return float(t.detach().reshape(-1)[0])


def profile_batch(batch_size: int, iters: int, device: torch.device,
                  fused_augment=None):
    """The stage times of one batch size; returns ``(result, step,
    batch)``."""
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.ops.mixing import cutmix_or_mixup
    from rovit_kan_tpu_torch.training.losses import joint_loss
    from rovit_kan_tpu_torch.training.optimizer import (
        build_optimizer,
        set_hyperparams,
    )
    from rovit_kan_tpu_torch.training.trainer import make_train_step

    config = bench.bench_config()
    if fused_augment is not None:
        config.train.fused_augment = fused_augment
    model = build_model(config, dtype=torch.bfloat16, device=device, seed=0)
    opt = set_hyperparams(build_optimizer(model, config), 5e-4, 0.1)
    step = make_train_step(model, opt, config,
                           generator=torch.Generator(device).manual_seed(1))
    size, lc = config.data.image_size, config.loss
    rng = np.random.RandomState(0)
    host = torch.from_numpy(rng.randint(
        0, 256, (batch_size, size, size, 3)).astype(np.uint8))
    labels = torch.from_numpy(rng.randint(
        0, config.model.num_classes, batch_size)).long().to(device)
    batch = {"images": host.to(device), "labels": labels,
             "severity": labels.float()}
    out = {"batch_size": batch_size, "fused_augment": step.fused_augment,
           "fused_block": all(b.use_fused_block
                              for b in model.backbone.model.blocks)}

    def timed(one: Callable[[], torch.Tensor]) -> float:
        _fetch(one())                               # warm-up

        def chunk():
            for _ in range(iters):
                last = one()
            _fetch(last)
        return bench.best_seconds(chunk) / iters * 1e3

    out["h2d_ms"] = timed(lambda: host.to(device))

    def augment():
        images = batch["images"]
        B, H, W, _ = images.shape
        draws = step.draw(B, H, W, 1)
        x = step.augment(images, draws["factors"])
        return cutmix_or_mixup(x, labels, draws["mix"])[0]
    out["augment_ms"] = timed(augment)

    x = augment()
    model.train()

    def forward():
        with torch.no_grad():
            return model(x, generator=step.generator)["cls_logits"]
    out["forward_ms"] = timed(forward)

    def loss():
        o = model(x, generator=step.generator)
        return joint_loss(o, labels, batch["severity"], 4,
                          lambda_ord=lc.lambda_ord, mu_unc=lc.mu_unc,
                          nu_kan=lc.nu_kan, focal_gamma=lc.focal_gamma,
                          head_mask=model.head_mask)["total_loss"]

    def fwd_bwd():
        opt.zero_grad()
        total = loss()
        total.backward()
        return total
    out["fwd_bwd_ms"] = timed(fwd_bwd)

    first = next(model.parameters())

    def update():
        opt.step()
        return first
    out["update_ms"] = timed(update)

    def full():
        return step(batch, 4, 1.0, 1)["total_loss"]
    out["full_step_ms"] = timed(full)
    out["train_ips"] = batch_size / out["full_step_ms"] * 1e3
    out["pct_of_full"] = {k: v / out["full_step_ms"] * 100
                          for k, v in out.items()
                          if k.endswith("_ms") and k != "full_step_ms"}
    return out, step, batch


def capture_trace(trace_dir: Path, step, batch, device: torch.device,
                  steps: int = TRACE_STEPS) -> dict:
    """torch.profiler trace of ``steps`` full steps and its per-op table."""
    from rovit_kan_tpu_torch.utils.profiling import trace
    with trace(trace_dir) as prof:
        for _ in range(steps):
            loss = step(batch, 4, 1.0, 1)["total_loss"]
        _fetch(loss)
    on_card = device.type == "cuda"
    key = "self_device_time_total" if on_card else "self_cpu_time_total"
    table = prof.key_averages().table(sort_by=key, row_limit=40)
    (trace_dir / "ops.txt").write_text(table)
    # On the card the top rows are the device's own operations (kernels,
    # copies), not the host ops that launched them.
    events = sorted((e for e in prof.key_averages() if not on_card
                     or e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: -getattr(e, key))
    return {"trace_dir": str(trace_dir),
            "trace": str(trace_dir / "trace.json"),
            "op_table": str(trace_dir / "ops.txt"),
            "top_ops": [{"name": e.key[:90], "calls": e.count,
                         "ms_per_step": getattr(e, key) / 1e3 / steps}
                        for e in events[:TOP_OPS]]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batches", type=int, nargs="+", default=[64, 256])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--trace_dir", type=Path, default=None,
                   help="also write a torch.profiler trace and per-op table "
                        "per batch size here")
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--no_fused_augment", action="store_true",
                   help="the plain fp32 augment chain inside the step "
                        "(config.train.fused_augment = False)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    args = p.parse_args(argv)
    from rovit_kan_tpu_torch import resolve_device
    device = resolve_device("cpu" if args.cpu else "cuda")

    results = []
    for bs in args.batches:
        r, step, batch = profile_batch(
            bs, args.iters, device,
            fused_augment=False if args.no_fused_augment else None)
        if args.trace_dir:
            r["trace"] = capture_trace(args.trace_dir / f"bs{bs}", step,
                                       batch, device)
        results.append(r)
        print(json.dumps(r), flush=True)
    final = {"device": (torch.cuda.get_device_name(0)
                        if device.type == "cuda" else "cpu"),
             "results": results}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(final, indent=2))
    return final


if __name__ == "__main__":
    main()
