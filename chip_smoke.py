"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the script
exits non-zero:

1. device: the card's name and power limit;
2. build: every ``rovit_kan_tpu_torch/csrc/*.cu`` compiled from a clean
   build directory, one ``nvcc`` per source, all started together;
3. kernels: each ported kernel against its plain PyTorch version on the
   card at the serving shape, with the stated tolerance, and timed (CUDA
   events, warm-up, median) beside its bound, the plain version and one
   PyTorch library call computing the same function;
4. serve: the full-width DeiT-Tiny RoViT-KAN (seeded random weights) built
   with ``build_model`` and served through ``InferenceEngine`` and
   ``MicroBatcher``; the launch counters are set to 0 just before and read
   just after, and the served outputs are held against the same model run
   with the plain block.

The line before the last is ``nvidia-smi``'s name and power limit; the last
is ``{"ok": true, "device": {...}}``. Imports torch and the port only.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet; dense, no sparsity).
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

BATCH, TOKENS, DIM, HEADS, HIDDEN = 64, 197, 192, 3, 768
FP32_TOL = 1e-4     # fp32 sums in another order; K <= 768


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bf16_tol(ref: torch.Tensor) -> float:
    """Two bf16 ulps at the largest magnitude of ``ref``: the plain version
    rounds at the same points, so the two differ only where an fp32 sum in
    another order lands on the other side of a rounding boundary."""
    top = float(ref.float().abs().max())
    return 2.0 * 2.0 ** (np.floor(np.log2(top)) - 7)


def time_ms(fn, reps: int = 15, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def block_inputs(dtype, seed: int):
    from rovit_kan_tpu_torch.ops.block_kernel import prepare_block_params
    rng = np.random.RandomState(seed)

    def t(*shape, scale=0.05, center=0.0):
        return torch.tensor(center + rng.normal(0, scale, shape),
                            dtype=torch.float32)

    raw = {"ln1_scale": t(DIM, scale=0.02, center=1.0),
           "ln1_bias": t(DIM, scale=0.02),
           "wqkv": t(3 * DIM, DIM), "bqkv": t(3 * DIM, scale=0.02),
           "wproj": t(DIM, DIM), "bproj": t(DIM, scale=0.02),
           "ln2_scale": t(DIM, scale=0.02, center=1.0),
           "ln2_bias": t(DIM, scale=0.02),
           "w1": t(HIDDEN, DIM), "b1": t(HIDDEN, scale=0.02),
           "w2": t(DIM, HIDDEN), "b2": t(DIM, scale=0.02)}
    x = t(BATCH, TOKENS, DIM, scale=1.0).to("cuda", dtype)
    params = prepare_block_params({k: v.cuda() for k, v in raw.items()},
                                  dtype)
    return x, params


def library_layer(params, dtype):
    """``nn.TransformerEncoderLayer`` computing the same pre-LN block with the
    same weights: the library yardstick, never called by the port."""
    layer = torch.nn.TransformerEncoderLayer(
        DIM, HEADS, HIDDEN, dropout=0.0, activation="gelu", batch_first=True,
        norm_first=True, layer_norm_eps=1e-6).eval()
    with torch.no_grad():
        layer.self_attn.in_proj_weight.copy_(params["wqkv"].float())
        layer.self_attn.in_proj_bias.copy_(params["bqkv"])
        layer.self_attn.out_proj.weight.copy_(params["wproj"].float())
        layer.self_attn.out_proj.bias.copy_(params["bproj"])
        layer.norm1.weight.copy_(params["ln1_scale"])
        layer.norm1.bias.copy_(params["ln1_bias"])
        layer.norm2.weight.copy_(params["ln2_scale"])
        layer.norm2.bias.copy_(params["ln2_bias"])
        layer.linear1.weight.copy_(params["w1"].float())
        layer.linear1.bias.copy_(params["b1"])
        layer.linear2.weight.copy_(params["w2"].float())
        layer.linear2.bias.copy_(params["b2"])
    return layer.to("cuda", dtype)


def block_bound_ms(x, params, dtype) -> float:
    B, N, D = x.shape
    hd = D // HEADS
    flops = 2 * B * N * D * (4 * D + 2 * HIDDEN) + 4 * B * HEADS * N * N * hd
    nbytes = 2 * x.numel() * x.element_size() + sum(
        p.numel() * p.element_size() for p in params.values())
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return 1e3 * max(flops / peak, nbytes / PEAK_BYTES_PER_S)


def check_block(dtype, seed: int):
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    x, params = block_inputs(dtype, seed)
    with torch.inference_mode():
        got = bk.fused_vit_block(x, params, HEADS)
        ref = bk.block_reference(x, params, HEADS)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"block kernel ({dtype}) gave non-finite "
                               f"values")
        err = float((got.float() - ref.float()).abs().max())
        tol = bf16_tol(ref) if dtype == torch.bfloat16 else FP32_TOL
        if not err <= tol:
            raise RuntimeError(f"block kernel ({dtype}) max |err| {err} > "
                               f"tolerance {tol}")
        layer = library_layer(params, dtype)
        lib_err = float((layer(x).float() - ref.float()).abs().max())
        ms = time_ms(lambda: bk.fused_vit_block(x, params, HEADS))
        plain_ms = time_ms(lambda: bk.block_reference(x, params, HEADS))
        library_ms = time_ms(lambda: layer(x))
    return {"replaces": "rovit_kan_tpu/ops/block_kernel.py::"
                        "_vit_block_kernel",
            "dtype": str(dtype).replace("torch.", ""),
            "shape": list(x.shape), "heads": HEADS,
            "launches_per_batch": "12 (one per block; counted in 'serve')",
            "max_abs_err": err, "tolerance": tol, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": lib_err,
            "bound_ms": block_bound_ms(x, params, dtype),
            "bound_by": "operations"}


def features(model, images_u8: np.ndarray) -> np.ndarray:
    """The backbone's fp32 CLS features for a uint8 batch."""
    from rovit_kan_tpu_torch.ops.preprocess import eval_batch
    with torch.inference_mode():
        x = eval_batch(torch.from_numpy(images_u8).cuda())
        return model.backbone(x).float().cpu().numpy()


def profile_serving(engine, images_u8: np.ndarray, smi: str):
    """torch.profiler over one pipelined request of several batches: device
    time by kernel and the device's busy share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile
    engine.predict(images_u8[:engine.batch_size])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict(images_u8)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return {"phase": "profile", "images": int(images_u8.shape[0]),
            "batches": -(-images_u8.shape[0] // engine.batch_size),
            "wall_ms": wall_ms, "device_kernel_ms": total,
            "device_busy_share": total / wall_ms,
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top], "card": smi}


def serve(smi: str):
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    from rovit_kan_tpu_torch.serving import InferenceEngine, MicroBatcher

    cfg = Config()
    model = build_model(cfg, inference=True, device="cuda", seed=0)
    blocks = model.backbone.model.blocks
    if not all(b.use_fused_block for b in blocks):
        raise RuntimeError("the 'auto' policy did not pick the block kernel")
    engine = InferenceEngine(model, batch_size=BATCH, device="cuda")
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0

    rng = np.random.RandomState(0)
    size = cfg.data.image_size
    full = [rng.randint(0, 256, (BATCH, size, size, 3)).astype(np.uint8)
            for _ in range(8)]
    partial = rng.randint(0, 256, (17, size, size, 3)).astype(np.uint8)
    singles = rng.randint(0, 256, (32, size, size, 3)).astype(np.uint8)

    # The main path, between the counter reset and the read.
    bk.LAUNCHES = 0
    outs = [engine.predict(imgs) for imgs in full]
    out_partial = engine.predict(partial)
    batcher = MicroBatcher(engine)
    got = [None] * len(singles)

    def client(i):
        got[i] = batcher.predict(singles[i:i + 1])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(singles))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("MicroBatcher clients did not finish")
    batcher.close()
    direct = engine.predict(singles)
    stats = engine.stats()
    launches = bk.LAUNCHES
    batches = stats["requests"]
    depth = len(blocks)
    if launches != depth * batches:
        raise RuntimeError(f"block kernel launched {launches} times for "
                           f"{batches} batches; want {depth} per batch")

    # Shapes, finiteness, probabilities.
    for out, n in [(o, BATCH) for o in outs] + [(out_partial, 17),
                                                 (direct, 32)]:
        for k, v in out.items():
            if v.shape[0] != n or not np.isfinite(v).all():
                raise RuntimeError(f"{k}: shape {v.shape} or non-finite")
        for k in ("cls_probs", "ordinal_probs"):
            if not np.allclose(out[k].sum(-1), 1.0, atol=1e-5):
                raise RuntimeError(f"{k} rows do not sum to 1")
    # MicroBatcher slices against direct predictions: each image is computed
    # independently of its batch neighbours in padded batches of one shape,
    # so they agree to fp32 noise.
    mb_err = max(float(np.abs(got[i][k][0].astype(np.float64)
                              - direct[k][i]).max())
                 for i in range(len(singles)) for k in direct)
    if not mb_err <= 1e-5:
        raise RuntimeError(f"MicroBatcher slices differ from direct "
                           f"predictions by {mb_err}")

    # References on the first request: the same bf16 model with the plain
    # block, and the fp32 model (the port's unfused fp32 path, held against
    # the JAX model at 2e-5 on the CPU) with the same seeded weights.
    for b in blocks:
        b.block_fn = bk.block_reference
    plain = engine.predict(full[0])
    plain["features"] = features(model, full[0])
    for b in blocks:
        b.block_fn = bk.fused_vit_block
    served = dict(outs[0], features=features(model, full[0]))
    model32 = build_model(cfg, dtype=torch.float32, inference=True,
                          device="cuda", seed=0)
    exact = InferenceEngine(model32, batch_size=BATCH,
                            device="cuda").predict(full[0])
    exact["features"] = features(model32, full[0])
    # The kernel and the plain block round at the same points; where an fp32
    # sum in another order crosses a bf16 rounding boundary, the one-ulp
    # difference spreads through the 12 blocks like any other bf16 rounding
    # error. So the kernel path must be as accurate as the plain bf16 path:
    # by the triangle inequality both its distance from the plain-block
    # model and its distance from fp32 then stay within twice the plain
    # model's own distance from fp32 (floor 1e-3 for outputs bf16 barely
    # moves).
    checks, failed = {}, []
    for k in ("features", "cls_probs", "ordinal_probs", "ordinal_severity",
              "uncertainty_std", "kan_severity"):
        ref_err = float(np.abs(plain[k] - exact[k]).max())
        checks[k] = {"vs_plain_block": float(np.abs(served[k]
                                                    - plain[k]).max()),
                     "vs_fp32": float(np.abs(served[k] - exact[k]).max()),
                     "plain_block_vs_fp32": ref_err,
                     "tolerance": 2 * max(ref_err, 1e-3)}
        c = checks[k]
        if not max(c["vs_plain_block"], c["vs_fp32"]) <= c["tolerance"]:
            failed.append(k)
    # An argmax may flip only where the top two probabilities are closer
    # than the probabilities moved.
    flips = np.nonzero(served["cls_pred"] != plain["cls_pred"])[0]
    top2 = np.sort(plain["cls_probs"], axis=-1)[:, -2:]
    gaps = top2[flips, 1] - top2[flips, 0]
    checks["cls_pred"] = {
        "flips_vs_plain_block": int(flips.size),
        "flips_vs_fp32": int(np.sum(served["cls_pred"]
                                    != exact["cls_pred"])),
        "max_flip_gap": float(gaps.max()) if flips.size else 0.0}
    if np.any(gaps > 2 * checks["cls_probs"]["vs_plain_block"]):
        failed.append("cls_pred")
    if failed:
        emit({"phase": "serve", "outputs": checks})
        raise RuntimeError(f"served outputs out of tolerance: {failed}")

    emit(profile_serving(engine, np.concatenate(full[:5]), smi))
    return {"phase": "serve", "model": "DeiT-Tiny RoViT-KAN d=192 depth=12 "
            "heads=3 224px bf16", "batch_size": BATCH,
            "batches": batches, "block_launches": launches,
            "launches_per_batch": launches / batches,
            "microbatcher_batches": batcher.batches_run,
            "warmup_s": warmup_s, "images_per_sec": stats["images_per_sec"],
            "p50_latency_ms": stats["p50_latency_ms"],
            "p95_latency_ms": stats["p95_latency_ms"],
            "microbatcher_max_abs_err": mb_err, "outputs": checks,
            "card": smi}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rovit_kan_tpu_torch.ops import _build
    from rovit_kan_tpu_torch.ops import block_kernel as bk

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "torch_name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    logs = _build.build(_build.all_sources())
    emit({"phase": "build", "sources": sorted(logs),
          "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for log in logs.values()
                    for ln in log.splitlines() if "Used" in ln]})

    bf16 = check_block(torch.bfloat16, seed=0)
    fp32 = check_block(torch.float32, seed=1)
    emit({"phase": "kernels", "vit_block_fwd": [bf16, fp32], "card": smi})

    result = serve(smi)
    emit(result)

    emit({"kernels": [{
        "name": "vit_block_fwd", "route": "cuda",
        "source": "rovit_kan_tpu_torch/csrc/vit_block_fwd.cu",
        "replaces": "rovit_kan_tpu/ops/block_kernel.py:92",
        "launches": result["block_launches"],
        "max_abs_err": bf16["max_abs_err"], "ms": bf16["kernel_ms"],
        "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"],
        "fp32": {k: fp32[k] for k in ("max_abs_err", "kernel_ms", "plain_ms",
                                      "bound_ms", "library_ms")}}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
