"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the script
exits non-zero:

1. device: the card's name and power limit;
2. build: every ``rovit_kan_tpu_torch/csrc/*.cu`` compiled from a clean
   build directory, one ``nvcc`` per source, all started together;
3. kernels: each ported kernel against its plain PyTorch version on the
   card at the main path's shapes, with the stated tolerance, and timed
   (CUDA events, warm-up, median) beside its bound, the plain version and
   one PyTorch library call computing the same function: the block forward
   (#1) and backward (#2) at (64, 197, 192), 3 heads, and the augment (#7)
   at (64, 224, 224, 3), each in bf16 and fp32; the KAN head's forward
   (#10) and backward (#11) at (64, [192, 64, 16, 1]) and one KAN layer's
   (#8, #9) at (64, 192 -> 64), fp32, each output within 1e-4 of its
   largest magnitude and the same bits on a repeated call, their ``ms`` and
   their plain versions' ``plain_ms`` the device time per call from
   torch.profiler (CUDA events around back-to-back calls time the host
   work there, kept as ``call_ms`` and ``plain_call_ms``);
4. serve: the full-width DeiT-Tiny RoViT-KAN (seeded random weights) built
   with ``build_model`` and served through ``InferenceEngine`` and
   ``MicroBatcher``; the launch counters are set to 0 just before and read
   just after, and the served outputs are held against the same model run
   with the plain block;
5. train: the same model built for training, ten flat-AdamW steps at batch
   64 through ``make_train_step`` (stage 4, mixing on) between a counter
   reset and a read, which must show 12 launches of #1 and of #2 and one of
   #7 per step; finite losses; a falling loss on one repeated batch; one
   step held against the same step through the plain versions and the fp32
   model (``hold_train_step``: #2 per parameter, each image's loss, the
   stage-3 gradient by parameter group); training images/s and one
   profiled step;
6. kan: the flagship with ``tpu.use_pallas_kan=True``: four served batches
   (12 x #1 and 1 x #10 each; every output but the severity the same bits
   as with the plain KAN head, the severity within 1e-5), the KAN
   trajectory and its gradient to the features (3 x #8, 3 x #9, held
   against the plain layers), five train steps at stage 4 (12 x #1,
   12 x #2, 1 x #7, 1 x #10, 1 x #11 each; finite losses), the same three
   steps of that step object timed with the KAN kernels on and off in
   turns, one step held against the plain KAN head (``hold_kan_step``),
   and the device operations per served batch and per train step with the
   flag on and off, from profiles;
7. long: the flagship at 384 px (577 tokens), batch 32, its weights the
   seed-0 224-px model's carried over by ``transfer_resolution``: the
   attention-only kernels #5/#6 at (32, 3, 577, 64) and (64, 3, 197, 64)
   and #1/#2 at (32, 577, 192), bf16 and fp32, against their plain versions
   (same bits on repeat for #5/#6) and timed beside their bounds, the plain
   versions and SDPA; served through ``InferenceEngine`` with "auto" (12 x
   #1 per batch, no #5) and with ``use_pallas_block=False`` (12 x #5 per
   batch, no #1), each held against its plain versions and the fp32 model
   as in "serve"; three train steps with ``use_pallas_block=False,
   use_pallas_attention=True`` (12 x #5, 12 x #6, 1 x #7 each), two with
   "auto" (12 x #1, 12 x #2, 1 x #7 each), finite losses; one step held per
   parameter against the same step with #6's plain version.

The line before the last is ``nvidia-smi``'s name and power limit; the last
is ``{"ok": true, "device": {...}}``. Imports torch and the port only.
"""
from __future__ import annotations

import functools
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


def block_inputs(dtype, seed: int, batch: int = BATCH, tokens: int = TOKENS):
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
    x = t(batch, tokens, DIM, scale=1.0).to("cuda", dtype)
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


def check_block(dtype, seed: int, batch: int = BATCH, tokens: int = TOKENS):
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    x, params = block_inputs(dtype, seed, batch, tokens)
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


def bwd_tol(ref: torch.Tensor, dtype) -> float:
    """Backward tolerance, relative to the largest magnitude of each output:
    fp32 1e-4 (sums in another order, up to B*N rows); bf16 1e-2 (a rounding
    boundary that an fp32 sum in another order crosses moves one rounded
    intermediate by one bf16 ulp, 2^-8 of it, before the sums over rows)."""
    top = max(float(ref.float().abs().max()), 1e-6)
    return (1e-4 if dtype == torch.float32 else 1e-2) * top


def check_block_bwd(dtype, seed: int, batch: int = BATCH,
                    tokens: int = TOKENS):
    """Kernel #2 against ``block_backward_reference``: dx and all 12 grads,
    each against its own tolerance."""
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    x, params = block_inputs(dtype, seed, batch, tokens)
    g = torch.tensor(np.random.RandomState(seed + 10).normal(
        0, 1, x.shape), dtype=torch.float32, device="cuda")
    with torch.no_grad():
        dx, grads = bk._launch_bwd(x, g, params, HEADS)
        want_dx, want = bk.block_backward_reference(x, g, params, HEADS)
        torch.cuda.synchronize()
    errs, failed = {}, []
    for name, got, ref in [("dx", dx, want_dx)] + [
            (k, grads[k], want[k]) for k in bk.PKEYS]:
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"backward kernel ({dtype}) {name}: "
                               f"non-finite values")
        err = float((got.float() - ref.float()).abs().max())
        tol = bwd_tol(ref, dtype)
        errs[name] = {"max_abs_err": err, "tolerance": tol,
                      "rel_err": err / max(float(ref.float().abs().max()),
                                           1e-6)}
        if not err <= tol:
            failed.append(name)
    if failed:
        raise RuntimeError(f"backward kernel ({dtype}) out of tolerance: "
                           f"{ {k: errs[k] for k in failed} }")

    with torch.no_grad():
        ms = time_ms(lambda: bk._launch_bwd(x, g, params, HEADS), reps=9)
        plain_ms = time_ms(lambda: bk.block_backward_reference(
            x, g, params, HEADS), reps=5, inner=3)
    # Forward plus backward: the port's #1 + #2 through autograd, and the
    # same pre-LN block as nn.TransformerEncoderLayer (the library yardstick).
    raw = {k: v.float().detach().clone().requires_grad_()
           for k, v in params.items()}
    xg = x.detach().clone().requires_grad_()
    gx = g.to(dtype)

    def port_fwd_bwd():
        bk.fused_vit_block(xg, raw, HEADS, kernel_params=params).backward(gx)

    layer = library_layer(params, dtype).train()

    def library_fwd_bwd():
        layer(xg).backward(gx)

    port_ms = time_ms(port_fwd_bwd, reps=9)
    library_ms = time_ms(library_fwd_bwd, reps=9)
    # The needed work: the forward recomputed without fc2 (no gradient
    # reads the block's output), then two products per forward product.
    B, N, D = x.shape
    flops = 3 * (2 * B * N * D * (4 * D + 2 * HIDDEN)
                 + 4 * B * HEADS * N * N * (D // HEADS)) \
        - 2 * B * N * D * HIDDEN
    nbytes = (2 * x.numel() * x.element_size() + g.numel() * 4
              + sum(p.numel() * p.element_size() for p in params.values())
              + sum(p.numel() * 4 for p in params.values()))
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return {"replaces": "rovit_kan_tpu/ops/block_kernel.py::"
                        "_vit_block_bwd_kernel",
            "dtype": str(dtype).replace("torch.", ""),
            "shape": list(x.shape), "heads": HEADS,
            "launches_per_step": "12 (one per block; counted in 'train')",
            "outputs": errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "max_rel_err": max(e["rel_err"] for e in errs.values()),
            "kernel_ms": ms, "plain_ms": plain_ms,
            "port_fwd_bwd_ms": port_ms, "library_ms": library_ms,
            "library": "nn.TransformerEncoderLayer forward + backward",
            "bound_ms": 1e3 * max(flops / peak, nbytes / PEAK_BYTES_PER_S),
            "bound_by": "operations"}


def augment_tol(compute) -> float:
    """Both sides round at the same points; the pivot sums H*W*3 terms in
    another order, and a rounding boundary it crosses moves each of the
    three rounded blends by at most one ulp of [0, 1] (2^-8 in bf16), scaled
    by 1/std (<= 1/0.224) in the normalization. fp32: sum order only."""
    return 3 * 2.0 ** -8 / 0.224 if compute == torch.bfloat16 else 1e-5


def check_augment(compute, seed: int):
    """Kernel #7 against ``augment_reference`` at the training batch."""
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    rng = np.random.RandomState(seed)
    imgs = torch.from_numpy(rng.randint(0, 256, (BATCH, 224, 224, 3))
                            .astype(np.uint8)).cuda()
    factors = ak.draw_factors(torch.Generator("cuda").manual_seed(seed),
                              BATCH)
    got = ak.fused_augment_batch(imgs, factors, compute)
    want = ak.augment_reference(imgs, factors, compute)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise RuntimeError(f"augment kernel ({compute}) non-finite values")
    err = float((got - want).abs().max())
    tol = augment_tol(compute)
    if not err <= tol:
        raise RuntimeError(f"augment kernel ({compute}) max |err| {err} > "
                           f"tolerance {tol}")
    ms = time_ms(lambda: ak.fused_augment_batch(imgs, factors, compute))
    plain_ms = time_ms(lambda: ak.augment_reference(imgs, factors, compute),
                       reps=9, inner=3)
    nbytes = imgs.numel() * (1 + got.element_size()) + factors.numel() * 4
    return {"replaces": "rovit_kan_tpu/ops/augment_kernel.py::"
                        "_augment_kernel",
            "compute_dtype": str(compute).replace("torch.", ""),
            "out_dtype": "float32", "shape": list(imgs.shape),
            "launches_per_step": "1 (counted in 'train')",
            "max_abs_err": err, "tolerance": tol, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no single PyTorch call computes the flips, "
                       "jitter and normalization, and the card has no "
                       "torchvision",
            "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
            "bound_by": "bytes"}


KAN_DIMS = (192, 64, 16, 1)
KAN_BASES = 7
KAN_LIBRARY = ("none: no PyTorch call computes a KAN layer (a B-spline "
               "basis of tanh x contracted with per-edge coefficients)")


def kan_inputs(seed: int, dims=KAN_DIMS):
    """Seeded fp32 inputs on the card: features ``(64, dims[0])``, the
    head's parameters in the port's layouts (spline N(0, 0.1^2), linear
    N(0, 1/in), bias N(0, 0.1^2)) and an upstream gradient."""
    rng = np.random.RandomState(seed)

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device="cuda")

    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        params += [t(rng.normal(0, 0.1, (a, b, KAN_BASES))),
                   t(rng.normal(0, a ** -0.5, (b, a))),
                   t(rng.normal(0, 0.1, (b,)))]
    return (t(rng.normal(0, 1.5, (BATCH, dims[0]))), params,
            t(rng.normal(0, 1, (BATCH, dims[-1]))))


def kan_flops(dims, module: bool) -> tuple:
    """FLOP of the KAN head (``module``) or one layer at batch 64, unpadded:
    each layer is ``KAN_BASES + 1`` products of ``(64, in) x (in, out)``.
    Each backward does two products per forward product (the weight
    gradients and dx); the head's (#11) also recomputes the forward, one
    layer's (#9) only the bases."""
    fwd = sum(2 * (KAN_BASES + 1) * BATCH * a * b
              for a, b in zip(dims[:-1], dims[1:]))
    return fwd, (3 if module else 2) * fwd


def hold_kan(what: str, pairs):
    """Each output within 1e-4 of its largest magnitude (fp32 sums in
    another order); raises on a miss."""
    errs, failed = {}, []
    for name, got, ref in pairs:
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{what} {name}: non-finite values")
        err = float((got - ref).abs().max())
        tol = 1e-4 * max(float(ref.abs().max()), 1e-6)
        errs[name] = {"max_abs_err": err, "tolerance": tol}
        if not err <= tol:
            failed.append(name)
    if failed:
        raise RuntimeError(f"{what} out of tolerance: "
                           f"{ {k: errs[k] for k in failed} }")
    return errs


def same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def kan_result(replaces, shape, errs, ms, plain_ms, flops, nbytes,
               launches):
    bound = {"operations": flops / PEAK_FP32_FLOPS,
             "bytes": nbytes / PEAK_BYTES_PER_S}
    by = max(bound, key=bound.get)
    return {"replaces": "rovit_kan_tpu/ops/kan_kernel.py::" + replaces,
            "dtype": "float32", "shape": shape,
            "launches_per_use": launches, "outputs": errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "identical_bits_on_repeat": True, "kernel_ms": ms,
            "kernel_ms_source": "torch.profiler device time per call",
            "plain_ms": plain_ms,
            "plain_ms_source": "torch.profiler device time per call, all "
                               "device operations",
            "library_ms": None,
            "library": KAN_LIBRARY, "flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * bound[by], "bound_by": by}


def device_ms(fn, kernels=None, calls: int = 50) -> float:
    """Device time per call of ``fn``, from torch.profiler over ``calls``
    calls after a warm-up: the time of the named kernels, or of every device
    operation when ``kernels`` is None. A wrapper call's host time exceeds
    these kernels' device time, so CUDA events around back-to-back calls
    would time the host. Raises if a named kernel, or any device operation,
    is missing from the profile."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if kernels is not None:
        missing = [k for k in kernels if not any(k in e.key for e in events)]
        if missing:
            raise RuntimeError(f"no device time recorded for {missing}")
        events = [e for e in events if any(k in e.key for k in kernels)]
    us = sum(e.self_device_time_total for e in events)
    if not us > 0:
        raise RuntimeError("the profile recorded no device time")
    return us / 1e3 / calls


def check_kan(seed: int):
    """Kernels #10/#11 at (64, [192, 64, 16, 1]) and #8/#9 at (64, 192->64)
    against their plain versions, identical bits on a repeated call, and
    timed. Bytes: each input read once, each output written once."""
    from rovit_kan_tpu_torch.ops import kan_kernel as kk
    from rovit_kan_tpu_torch.ops.spline import make_knots
    knots = make_knots()
    out = {}
    for dims, fwd_name, bwd_name in ((KAN_DIMS, "kan_module_fwd",
                                      "kan_module_bwd"),
                                     (KAN_DIMS[:2], "kan_layer_fwd",
                                      "kan_layer_bwd")):
        x, params, g = kan_inputs(seed, dims)
        module = len(dims) > 2
        if module:
            def fwd():
                return [kk._launch_module(x, params, knots, 3)]

            def bwd():
                dx, grads = kk._launch_module_bwd(x, g, params, knots, 3)
                return [dx, *grads]

            def plain_fwd():
                return [kk.kan_module_reference(x, params, knots)]

            def plain_bwd():
                dx, grads = kk.kan_module_backward_reference(x, g, params,
                                                             knots)
                return [dx, *grads]
        else:
            def fwd():
                return [kk._launch_layer(x, *params, knots, 3)]

            def bwd():
                return list(kk._launch_layer_bwd(x, g, *params[:2], knots,
                                                 3))

            def plain_fwd():
                return [kk.kan_layer_reference(x, *params, knots)]

            def plain_bwd():
                return list(kk.kan_layer_backward_reference(
                    x, g, *params[:2], knots))
        names = ["dx"] + [f"d{k}{layer}" for layer in range(len(dims) - 1)
                          for k in ("spline", "weight", "bias")]
        with torch.no_grad():
            got_f, got_b = fwd(), bwd()
            want_f, want_b = plain_fwd(), plain_bwd()
            torch.cuda.synchronize()
            errs_f = hold_kan(fwd_name, [("y", got_f[0], want_f[0])])
            errs_b = hold_kan(bwd_name, list(zip(names, got_b, want_b)))
            if not (same_bits(fwd(), got_f) and same_bits(bwd(), got_b)):
                raise RuntimeError(f"{fwd_name}/{bwd_name}: a repeated call "
                                   f"gave other bits")
            call_f, call_b = time_ms(fwd), time_ms(bwd)
            tag = "module" if module else "layer"
            ms_f = device_ms(fwd, [f"kan_{tag}_fwd_kernel"])
            ms_b = device_ms(bwd, ["kan_layer_bwd_kernel"] if not module
                             else ["kan_module_bwd_rows_kernel",
                                   "kan_module_wgrad_kernel"])
            # The plain versions on the kernels' clock: the device time of
            # all their operations; CUDA events keep their call time.
            plain_f = device_ms(plain_fwd, calls=10)
            plain_b = device_ms(plain_bwd, calls=10)
            plain_call_f = time_ms(plain_fwd, reps=9, inner=3)
            plain_call_b = time_ms(plain_bwd, reps=9, inner=3)
        flops_f, flops_b = kan_flops(dims, module)
        wbytes = 4 * sum(p.numel() for p in params)
        # y has the shape of g.
        xbytes, gbytes = 4 * x.numel(), 4 * g.numel()
        shape = [BATCH, list(dims)]
        out[fwd_name] = kan_result(
            "_kan_module_kernel" if module else "_kan_kernel", shape, errs_f,
            ms_f, plain_f, flops_f, xbytes + wbytes + gbytes,
            "1 per served batch and per train step (counted in 'kan')"
            if module else "1 per layer of a trajectory (counted in 'kan')")
        out[bwd_name] = kan_result(
            "_kan_module_bwd_kernel" if module else "_kan_layer_bwd_kernel",
            shape, errs_b, ms_b, plain_b, flops_b,
            2 * xbytes + gbytes + 2 * wbytes,
            "1 per train step, two passes (counted in 'kan')" if module
            else "1 per layer of a trajectory's gradient (counted in 'kan')")
        out[fwd_name].update(call_ms=call_f, plain_call_ms=plain_call_f)
        out[bwd_name].update(call_ms=call_b, plain_call_ms=plain_call_b)
        if module:
            with torch.no_grad():
                out[bwd_name]["ms_by_launch"] = {
                    k: device_ms(bwd, [k]) for k in (
                        "kan_module_bwd_rows_kernel",
                        "kan_module_wgrad_kernel")}
    return out


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


def hold_served(served, plain, exact):
    """Served outputs of a kernel path against the same model through the
    plain versions (``plain``) and the fp32 model (``exact``). The kernel
    and the plain path round at the same points; where an fp32 sum in
    another order crosses a bf16 rounding boundary, the one-ulp difference
    spreads through the 12 blocks like any other bf16 rounding error. So
    the kernel path must be as accurate as the plain bf16 path: by the
    triangle inequality both its distance from the plain model and its
    distance from fp32 then stay within twice the plain model's own distance
    from fp32 (floor 1e-3 for outputs bf16 barely moves). Returns the
    readings and the names of the outputs that failed."""
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
    return checks, failed


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
        b.block_fn = bk.plain_vit_block
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
    checks, failed = hold_served(served, plain, exact)
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


def train_batch(cfg, seed: int, batch: int = BATCH):
    rng = np.random.RandomState(seed)
    size = cfg.data.image_size
    labels = torch.from_numpy(rng.randint(0, 4, batch)).long().cuda()
    return {"images": torch.from_numpy(rng.randint(
                0, 256, (batch, size, size, 3)).astype(np.uint8)).cuda(),
            "labels": labels, "severity": labels.float()}


@functools.lru_cache(maxsize=None)
def _plain_backward_block():
    from rovit_kan_tpu_torch.ops import block_kernel as bk

    class PlainBackward(bk.FusedViTBlock):
        @staticmethod
        def backward(ctx, g):
            ctx.plain = True
            return bk.FusedViTBlock.backward(ctx, g)

    return PlainBackward


def _kernel_fwd_plain_bwd(x, params, heads=HEADS, kernel_params=None):
    """A block ``block_fn``: #1 in the forward, #2's plain version in the
    backward, so a step through it differs from the kernel step only in the
    backward."""
    from rovit_kan_tpu_torch.ops.block_kernel import PKEYS
    return _plain_backward_block().apply(x, heads, kernel_params, False,
                                         *(params[k] for k in PKEYS))


def one_step(cfg, kind: str, batch, draws, stage: int):
    """One step at ``stage`` from the seed-0 weights with fixed draws:
    ``kernels`` (bf16, #1, #2 and #7), ``kernel_fwd`` (as ``kernels``, but
    the block backward is #2's plain version), ``plain`` (bf16 through the
    kernels' plain versions), ``fp32`` (the fp32 model, unfused, fp32
    augment chain) or ``fp32_rounded`` (as ``fp32``, its input images
    rounded to bf16). Returns the loss, each image's loss alone and the
    gradient of every parameter."""
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    from rovit_kan_tpu_torch.ops.mixing import cutmix_or_mixup
    from rovit_kan_tpu_torch.ops.preprocess import augment_batch
    from rovit_kan_tpu_torch.training.losses import joint_loss
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    fp32 = kind.startswith("fp32")
    model = build_model(cfg, dtype=torch.float32 if fp32 else torch.bfloat16,
                        device="cuda", seed=0)
    blocks = model.backbone.model.blocks
    for b in blocks:
        b.block_fn = {"plain": bk.plain_vit_block,
                      "kernel_fwd": _kernel_fwd_plain_bwd}.get(kind,
                                                               b.block_fn)
    opt = build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg,
                           generator=torch.Generator("cuda").manual_seed(1))
    if kind == "plain":
        step.augment = ak.augment_reference
    if kind == "fp32_rounded":
        step.augment = lambda images, factors: augment_batch(
            images, factors).to(torch.bfloat16).float()
    if fp32 == (step.fused_augment and all(b.use_fused_block
                                           for b in blocks)):
        raise RuntimeError(f"{kind} step: unexpected kernel policy")
    outputs = {}
    model.register_forward_hook(lambda mod, args, out: outputs.update(out))
    m = step(batch, stage, 1.0, 1, draws=dict(
        draws, dropout=torch.Generator("cuda").manual_seed(2)))
    # Each image's loss alone: the step's joint loss over one valid row.
    labels = batch["labels"]
    _, la, lb, lam = cutmix_or_mixup(torch.zeros(batch["images"].shape,
                                                 device="cuda"),
                                     labels, draws["mix"])
    lc, eye = cfg.loss, torch.eye(BATCH, device="cuda")
    per_image = np.array([float(joint_loss(
        {k: v.detach() for k, v in outputs.items()}, labels,
        batch["severity"], stage, lambda_ord=lc.lambda_ord, mu_unc=lc.mu_unc,
        nu_kan=lc.nu_kan, focal_gamma=lc.focal_gamma,
        head_mask=model.head_mask,
        mixup={"labels_a": la, "labels_b": lb, "lam": lam},
        valid=eye[i])["total_loss"]) for i in range(BATCH)])
    return {"loss": float(m["total_loss"]), "per_image": per_image,
            "outputs": {k: outputs[k].detach().float()
                        for k in ("features", "kan_severity")},
            "grads": {k: p.grad.detach().clone()
                      for k, p in zip(opt.names, opt.params)}}


GROUPS = ("backbone.", "classification_head.", "ordinal_head.",
          "uncertainty_head.", "kan_module.")


def grad_gaps(a, b, leaves=None):
    """The L2 distance ``|a - b|`` and the norm ``|b|`` of the gradient of
    each parameter group (and of all of them), from two ``one_step``
    results."""
    def cat(r, keys):
        return torch.cat([r["grads"][k].reshape(-1) for k in keys])

    out = {}
    for group in GROUPS + ("all",):
        keys = [k for k in (leaves or a["grads"])
                if group == "all" or k.startswith(group)]
        if not keys:
            continue
        ga, gb = cat(a, keys), cat(b, keys)
        out[group.rstrip(".")] = {"dist": float((ga - gb).norm()),
                                  "norm": float(gb.norm())}
    return out


def hold_train_step(cfg, batch, draws):
    """One step held against its plain versions; raises on a miss.

    1. Backward (#2), stage 4: the kernel step against the same step with
       #2's plain version. The forwards are the same launches, so the loss
       and the heads' grads agree exactly, and each parameter's gradient
       may differ only by #2's own rounding, summed over 12 blocks: it must
       lie within 5e-2 of its L2 norm (the card test's limit).
    2. Loss, stage 4: each image's loss in the kernel step within twice the
       plain bf16 step's largest distance from fp32 (the serve phase's
       triangle rule, floor 1e-3). Per image, because the batch mean
       cancels: the two means may land far closer than any image's loss.
    3. Gradient, stage 3: per parameter group and in all, the kernel step's
       distances from the plain step and from fp32 within twice the plain
       step's distance from fp32 (floor 1e-3 of the fp32 norm). Stage 3,
       because stage 4's KAN loss makes the gradient ill-conditioned at
       these weights: rounding the fp32 step's input images to bf16 alone
       moves it by the ``conditioning`` readings, so there no bf16 step can
       be told apart from a wrong one (readings in ``stage4_readings``).
    """
    runs = {(kind, stage): one_step(cfg, kind, batch, draws, stage)
            for stage, kinds in ((4, ("kernels", "kernel_fwd", "plain",
                                      "fp32", "fp32_rounded")),
                                 (3, ("kernels", "plain", "fp32",
                                      "fp32_rounded")))
            for kind in kinds}
    failed = []

    k4, kf4 = runs["kernels", 4], runs["kernel_fwd", 4]
    leaf = {}
    for name, g in k4["grads"].items():
        ref = kf4["grads"][name]
        leaf[name] = float((g - ref).norm()) / max(float(ref.norm()), 1e-30)
    worst = max(leaf, key=leaf.get)
    backward = {"tolerance": 5e-2, "worst_leaf": worst,
                "worst_rel": leaf[worst],
                "median_leaf_rel": float(np.median(list(leaf.values()))),
                "all_rel": grad_gaps(k4, kf4)["all"],
                "loss_diff": k4["loss"] - kf4["loss"]}
    if not leaf[worst] <= 5e-2:
        failed.append("backward")

    p4, f4 = runs["plain", 4], runs["fp32", 4]
    ref = max(float(np.abs(p4["per_image"] - f4["per_image"]).max()), 1e-3)
    loss = {"kernels": k4["loss"], "plain": p4["loss"], "fp32": f4["loss"],
            "per_image_vs_plain": float(np.abs(k4["per_image"]
                                               - p4["per_image"]).max()),
            "per_image_vs_fp32": float(np.abs(k4["per_image"]
                                              - f4["per_image"]).max()),
            "per_image_plain_vs_fp32": ref, "tolerance": 2 * ref}
    if not max(loss["per_image_vs_plain"],
               loss["per_image_vs_fp32"]) <= loss["tolerance"]:
        failed.append("loss")

    k3, p3, f3 = runs["kernels", 3], runs["plain", 3], runs["fp32", 3]
    live = [k for k, g in f3["grads"].items() if float(g.norm()) > 0]
    vs_p, vs_f, p_f = (grad_gaps(a, b, live)
                       for a, b in ((k3, p3), (k3, f3), (p3, f3)))
    grad = {}
    for group, pf in p_f.items():
        if pf["norm"] == 0:
            continue
        tol = 2 * max(pf["dist"], 1e-3 * pf["norm"])
        grad[group] = {"vs_plain": vs_p[group]["dist"] / pf["norm"],
                       "vs_fp32": vs_f[group]["dist"] / pf["norm"],
                       "plain_vs_fp32": pf["dist"] / pf["norm"],
                       "tolerance": tol / pf["norm"]}
        if not max(vs_p[group]["dist"], vs_f[group]["dist"]) <= tol:
            failed.append(f"stage-3 grad {group}")

    def rel(gaps):
        return {g: v["dist"] / v["norm"] for g, v in gaps.items()
                if v["norm"] > 0}

    def moved(a, b):
        return {f"{k}_max_abs": float((a["outputs"][k]
                                       - b["outputs"][k]).abs().max())
                for k in a["outputs"]}

    held = {"backward_stage4": backward, "loss_stage4": loss,
            "grad_stage3": grad,
            "stage4_readings": {
                "kernels_vs_plain": rel(grad_gaps(k4, p4)),
                "plain_vs_fp32": rel(grad_gaps(p4, f4)),
                "kernels_vs_fp32": rel(grad_gaps(k4, f4))},
            "conditioning": {
                **moved(runs["fp32_rounded", 4], f4),
                "stage4": rel(grad_gaps(runs["fp32_rounded", 4], f4)),
                "stage3": rel(grad_gaps(runs["fp32_rounded", 3], f3,
                                        live))}}
    if failed:
        emit({"phase": "train", "held": held})
        raise RuntimeError(f"train step out of tolerance: {failed}")
    return held


def profile_step(step, batch):
    """torch.profiler over one train step: device time by kernel and the
    device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, 4, 1.0, 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]
    return {"wall_ms": wall_ms, "device_kernel_ms": total,
            "device_busy_share": total / wall_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def train(smi: str):
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    from rovit_kan_tpu_torch.ops.mixing import draw_mix
    from rovit_kan_tpu_torch.training.optimizer import (
        build_optimizer,
        set_hyperparams,
    )
    from rovit_kan_tpu_torch.training.trainer import make_train_step

    cfg = Config()
    model = build_model(cfg, device="cuda", seed=0)
    blocks = model.backbone.model.blocks
    if not model.training or not all(b.use_fused_block for b in blocks):
        raise RuntimeError("the 'auto' policy did not pick the block kernel "
                           "for training")
    opt = build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg,
                           generator=torch.Generator("cuda").manual_seed(0))
    if not step.fused_augment:
        raise RuntimeError("the 'auto' policy did not pick the augment kernel")
    batches = [train_batch(cfg, 100 + i) for i in range(10)]
    torch.cuda.synchronize()

    # The main path, between the counter reset and the read.
    bk.LAUNCHES = bk.BWD_LAUNCHES = ak.LAUNCHES = 0
    metrics = []
    for i, batch in enumerate(batches):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        metrics.append(step(batch, 4, 1.0, 1))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"vit_block_fwd": bk.LAUNCHES, "vit_block_bwd":
                bk.BWD_LAUNCHES, "augment": ak.LAUNCHES}
    steps = len(batches)
    want = {"vit_block_fwd": 12 * steps, "vit_block_bwd": 12 * steps,
            "augment": steps}
    if launches != want:
        raise RuntimeError(f"train launches {launches}, want {want}")
    losses = [float(m["total_loss"]) for m in metrics]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite train losses {losses}")

    prof = profile_step(step, batches[0])

    # One repeated batch, mixing off, at lr 1e-3: the loss must fall.
    set_hyperparams(opt, 1e-3, 0.1)
    repeat = [float(step(batches[0], 4, 1.0, 0)["total_loss"])
              for _ in range(8)]
    if not repeat[-1] < repeat[0]:
        raise RuntimeError(f"loss did not fall on a repeated batch: "
                           f"{repeat}")

    # One step with the kernels, with their plain versions and with the
    # fp32 model, on the same weights and draws (see hold_train_step).
    held = hold_train_step(cfg, batches[0], {
        "factors": ak.draw_factors(torch.Generator("cuda").manual_seed(3),
                                   BATCH),
        "mix": draw_mix(torch.Generator().manual_seed(4), BATCH,
                        cfg.data.image_size, cfg.data.image_size)})

    emit({"phase": "train_profile", "batch_size": BATCH, **prof,
          "card": smi})
    return {"phase": "train", "model": "DeiT-Tiny RoViT-KAN d=192 depth=12 "
            "heads=3 224px bf16, stage 4, CutMix/MixUp, flat AdamW",
            "batch_size": BATCH, "steps": steps, "launches": launches,
            "launches_per_step": {k: v / steps for k, v in launches.items()},
            "losses": losses, "repeated_batch_losses": repeat,
            "images_per_sec": BATCH * (steps - 2) / elapsed,
            "step_ms": 1e3 * elapsed / (steps - 2), "held": held,
            "card": smi}


def count_device_ops(fn) -> int:
    """Device operations (kernels, copies) that one call of ``fn`` enqueues,
    from torch.profiler, after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def set_kan_fused(kan, fused: bool) -> None:
    """The KAN head through the kernels (``fused``) or plain PyTorch: the
    module (#10/#11) and each layer called alone (#8/#9)."""
    kan.use_fused = fused
    for layer in kan.kan_layers:
        layer.use_fused = fused


def kan_step(cfg, fused: bool, batch, draws):
    """One stage-4 step from the seed-0 weights with fixed draws and dropout
    masks, the KAN head through the kernels (``fused``) or plain PyTorch.
    Returns the loss, the features' gradient and every parameter's."""
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    model = build_model(cfg, device="cuda", seed=0)
    set_kan_fused(model.kan_module, fused)
    opt = build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg,
                           generator=torch.Generator("cuda").manual_seed(1))
    feats = {}

    def keep_features(mod, args, out):
        out["features"].retain_grad()
        feats["t"] = out["features"]

    model.register_forward_hook(keep_features)
    m = step(batch, 4, 1.0, 1, draws=dict(
        draws, dropout=torch.Generator("cuda").manual_seed(2)))
    return {"loss": float(m["total_loss"]),
            "features": feats["t"].grad.detach().clone(),
            "grads": {k: p.grad.detach().clone()
                      for k, p in zip(opt.names, opt.params)}}


def hold_kan_step(cfg, batch, draws):
    """One stage-4 step through #10/#11 against the same step with the plain
    KAN head (same weights, draws and dropout masks; the trunk's launches
    are the same, so the features agree to the bit): the loss within 1e-5
    relative; each KAN parameter's gradient and the features' gradient
    within 1e-4 of its L2 norm (fp32 sums in another order); every other
    parameter's within 5e-2, the limit hold_train_step sets for #2, since
    the KAN head's fp32 differences enter the bf16 block backward."""
    k, p = (kan_step(cfg, fused, batch, draws) for fused in (True, False))

    def rel(a, b):
        return float((a - b).norm()) / max(float(b.norm()), 1e-30)

    loss_rel = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    leaves = {name: rel(g, p["grads"][name]) for name, g in k["grads"].items()}
    kan = {n: v for n, v in leaves.items() if n.startswith("kan_module.")}
    rest = {n: v for n, v in leaves.items() if n not in kan}
    worst = max(rest, key=rest.get)
    held = {"loss_kernels": k["loss"], "loss_plain": p["loss"],
            "loss_rel": loss_rel, "loss_tolerance": 1e-5,
            "features_grad_rel": rel(k["features"], p["features"]),
            "kan_grad_rel": kan, "kan_tolerance": 1e-4,
            "other_worst_leaf": worst, "other_worst_rel": rest[worst],
            "other_median_rel": float(np.median(list(rest.values()))),
            "other_tolerance": 5e-2}
    failed = [n for n, ok in (
        ("loss", loss_rel <= 1e-5),
        ("features", held["features_grad_rel"] <= 1e-4),
        ("kan", max(kan.values()) <= 1e-4),
        ("other", rest[worst] <= 5e-2)) if not ok]
    if failed:
        emit({"phase": "kan", "held_step": held})
        raise RuntimeError(f"KAN train step out of tolerance: {failed}")
    return held


def kan_phase(smi: str):
    """The flagship with ``tpu.use_pallas_kan=True``: served, its KAN
    trajectory and the trajectory's gradient, and trained; each between a
    counter reset and a read."""
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    from rovit_kan_tpu_torch.ops import kan_kernel as kk
    from rovit_kan_tpu_torch.ops.mixing import draw_mix
    from rovit_kan_tpu_torch.serving import InferenceEngine
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step

    def reset():
        bk.LAUNCHES = bk.BWD_LAUNCHES = ak.LAUNCHES = 0
        kk.LAUNCHES = kk.BWD_LAUNCHES = 0
        kk.LAYER_LAUNCHES = kk.LAYER_BWD_LAUNCHES = 0

    def read():
        return {"vit_block_fwd": bk.LAUNCHES, "vit_block_bwd": bk.BWD_LAUNCHES,
                "augment": ak.LAUNCHES, "kan_module_fwd": kk.LAUNCHES,
                "kan_module_bwd": kk.BWD_LAUNCHES,
                "kan_layer_fwd": kk.LAYER_LAUNCHES,
                "kan_layer_bwd": kk.LAYER_BWD_LAUNCHES}

    def zeros(**want):
        return {k: want.get(k, 0) for k in read()}

    cfg = Config()
    cfg.tpu.use_pallas_kan = True
    size = cfg.data.image_size
    model = build_model(cfg, inference=True, device="cuda", seed=0)
    kan = model.kan_module
    if not kan.use_fused:
        raise RuntimeError("use_pallas_kan did not reach the KAN module")
    engine = InferenceEngine(model, batch_size=BATCH, device="cuda")
    engine.warmup()
    rng = np.random.RandomState(7)
    batches = [rng.randint(0, 256, (BATCH, size, size, 3)).astype(np.uint8)
               for _ in range(4)]

    # Serving: the main path between a reset and a read.
    reset()
    served = [engine.predict(b) for b in batches]
    serve_launches = read()
    n = len(batches)
    if serve_launches != zeros(vit_block_fwd=12 * n, kan_module_fwd=n):
        raise RuntimeError(f"served launches {serve_launches}")
    # The same model with the plain KAN head: every other output the same
    # bits, the severity within 1e-5.
    set_kan_fused(kan, False)
    plain = [engine.predict(b) for b in batches]
    serve_ops_off = count_device_ops(lambda: engine.predict(batches[0]))
    set_kan_fused(kan, True)
    serve_ops_on = count_device_ops(lambda: engine.predict(batches[0]))
    sev_err = max(float(np.abs(a["kan_severity"] - b["kan_severity"]).max())
                  for a, b in zip(served, plain))
    differ = sorted({k for a, b in zip(served, plain) for k in a
                     if k != "kan_severity" and not np.array_equal(a[k],
                                                                   b[k])})
    if differ or not sev_err <= 1e-5:
        raise RuntimeError(f"served with #10: outputs {differ} differ, "
                           f"severity by {sev_err}")

    # The trajectory (#8 per layer) and its gradient to the features (#9
    # per layer), against the plain layers.
    feats = torch.from_numpy(features(model, batches[0])).cuda()

    def trajectory(fused):
        set_kan_fused(kan, fused)
        x = feats.clone().requires_grad_()
        acts = kan.activation_trajectory(x)
        acts[-1].sum().backward()
        return [a.detach() for a in acts] + [x.grad]

    reset()
    traj = trajectory(True)
    torch.cuda.synchronize()
    traj_launches = read()
    if traj_launches != zeros(kan_layer_fwd=3, kan_layer_bwd=3):
        raise RuntimeError(f"trajectory launches {traj_launches}")
    traj_errs = hold_kan("trajectory", list(zip(
        ["features", "layer1", "layer2", "score", "d_features"], traj,
        trajectory(False))))
    set_kan_fused(kan, True)
    score_err = float(np.abs(traj[3][:, 0].cpu().numpy()
                             - served[0]["kan_severity"]).max())
    if not score_err <= 1e-5:
        raise RuntimeError(f"trajectory score differs from the served "
                           f"severity by {score_err}")

    # Training: five stage-4 steps between a reset and a read.
    train_model = build_model(cfg, device="cuda", seed=0)
    opt = build_optimizer(train_model, cfg)
    step = make_train_step(train_model, opt, cfg,
                           generator=torch.Generator("cuda").manual_seed(0))
    tb = [train_batch(cfg, 200 + i) for i in range(5)]
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    losses = [float(step(b, 4, 1.0, 1)["total_loss"]) for b in tb]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    train_launches = read()
    s = len(tb)
    want = zeros(vit_block_fwd=12 * s, vit_block_bwd=12 * s, augment=s,
                 kan_module_fwd=s, kan_module_bwd=s)
    if train_launches != want:
        raise RuntimeError(f"train launches {train_launches}, want {want}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite train losses {losses}")
    # Flag on against off, like for like: the same steps of this step
    # object, on and off in turns (the host's speed drifts within a call).
    step_ms = {"kan_kernels": [], "plain_kan": []}
    for fused in (True, False, True, False):
        set_kan_fused(train_model.kan_module, fused)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for b in tb[2:]:
            step(b, 4, 1.0, 1)
        torch.cuda.synchronize()
        step_ms["kan_kernels" if fused else "plain_kan"].append(
            1e3 * (time.perf_counter() - t1) / len(tb[2:]))
    set_kan_fused(train_model.kan_module, True)
    prof_on = profile_step(step, tb[0])
    set_kan_fused(train_model.kan_module, False)
    prof_off = profile_step(step, tb[0])
    set_kan_fused(train_model.kan_module, True)

    held = hold_kan_step(cfg, tb[0], {
        "factors": ak.draw_factors(torch.Generator("cuda").manual_seed(3),
                                   BATCH),
        "mix": draw_mix(torch.Generator().manual_seed(4), BATCH, size,
                        size)})
    return {"phase": "kan", "model": "DeiT-Tiny RoViT-KAN d=192 depth=12 "
            "heads=3 224px bf16, KAN [192,64,16,1] through #10/#11",
            "batch_size": BATCH, "served_batches": n,
            "serve_launches": serve_launches,
            "serve_severity_vs_plain_head": sev_err,
            "device_ops_per_served_batch": {"kan_kernels": serve_ops_on,
                                            "plain_kan": serve_ops_off},
            "trajectory_launches": traj_launches,
            "trajectory": traj_errs,
            "trajectory_score_vs_served": score_err,
            "train_steps": s, "train_launches": train_launches,
            "train_losses": losses,
            "train_step_ms": 1e3 * elapsed / s,
            "step_ms_same_steps": step_ms,
            "device_ops_per_train_step": {
                "kan_kernels": prof_on["kernel_launches"],
                "plain_kan": prof_off["kernel_launches"]},
            "train_profile": {"kan_kernels": prof_on, "plain_kan": prof_off},
            "held_step": held, "card": smi}


LONG_BATCH, LONG_SIZE = 32, 384
LONG_TOKENS = (LONG_SIZE // 16) ** 2 + 1            # 577
SDPA = "F.scaled_dot_product_attention(q, k, v, scale=1.0)"


def attention_bounds(shape, dtype) -> dict:
    """Least times of #5 and #6 on the card: FLOP of their products (#5 two
    N x N x hd products, #6 five: S again, dV, dP, dQ, dK) over the peak of
    the input type, and bytes (q, k, v in and an fp32 out; q, k, v and the
    fp32 g in and dq, dk, dv out in the input type) over the HBM rate."""
    B, h, N, hd = shape
    size = 2 if dtype == torch.bfloat16 else 4
    numel = B * h * N * hd
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    out = {}
    for name, products, nbytes in (
            ("fwd", 2, numel * (3 * size + 4)),
            ("bwd", 5, numel * (6 * size + 4))):
        bound = {"operations": 2 * products * B * h * N * N * hd / peak,
                 "bytes": nbytes / PEAK_BYTES_PER_S}
        by = max(bound, key=bound.get)
        out[name] = {"bound_ms": 1e3 * bound[by], "bound_by": by,
                     "flops": 2 * products * B * h * N * N * hd,
                     "bytes": nbytes}
    return out


def check_attention(shape, dtype, seed: int):
    """#5 and #6 against ``attention_reference`` and
    ``attention_backward_reference`` on seeded inputs (q pre-scaled), the
    same bits on a repeated call, and timed (CUDA events) beside their
    bounds, the plain versions and SDPA (forward, and forward + backward,
    the library yardstick; never on the port's path). Tolerances: the
    forward's fp32 output within 1e-4 in fp32 and two bf16 ulps at its
    largest magnitude in bf16 (both round P at the same point; they differ
    where an fp32 sum in another order crosses a rounding boundary); the
    backward's outputs as #2's (``bwd_tol``)."""
    import torch.nn.functional as F
    from rovit_kan_tpu_torch.ops import attention as at
    rng = np.random.RandomState(seed)
    hd = shape[-1]

    def t(scale=1.0, dt=dtype):
        return torch.tensor(rng.normal(0, scale, shape), dtype=torch.float32,
                            device="cuda").to(dt)

    q, k, v = t(hd ** -0.5), t(), t()
    g = t(dt=torch.float32)
    with torch.no_grad():
        out = at._launch(q, k, v)
        grads = at._launch_bwd(q, k, v, g)
        ref = at.attention_reference(q, k, v)
        want = at.attention_backward_reference(q, k, v, g)
        torch.cuda.synchronize()
        same = (torch.equal(at._launch(q, k, v), out)
                and all(torch.equal(a, b) for a, b in
                        zip(at._launch_bwd(q, k, v, g), grads)))
    what = f"attention {list(shape)} {dtype}"
    if not same:
        raise RuntimeError(f"{what}: a repeated call gave other bits")
    errs, failed = {}, []
    for name, got, w in [("out", out, ref)] + list(zip(("dq", "dk", "dv"),
                                                       grads, want)):
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"{what} {name}: non-finite values")
        if got.dtype != (torch.float32 if name == "out" else dtype):
            raise RuntimeError(f"{what} {name}: dtype {got.dtype}")
        err = float((got.float() - w.float()).abs().max())
        tol = (bwd_tol(w, dtype) if name != "out" else
               FP32_TOL if dtype == torch.float32 else bf16_tol(w))
        errs[name] = {"max_abs_err": err, "tolerance": tol}
        if not err <= tol:
            failed.append(name)
    if failed:
        raise RuntimeError(f"{what} out of tolerance: "
                           f"{ {k: errs[k] for k in failed} }")

    with torch.no_grad():
        ms_f = time_ms(lambda: at._launch(q, k, v))
        ms_b = time_ms(lambda: at._launch_bwd(q, k, v, g))
        plain_f = time_ms(lambda: at.attention_reference(q, k, v), reps=9,
                          inner=3)
        plain_b = time_ms(lambda: at.attention_backward_reference(
            q, k, v, g), reps=9, inner=3)
        sdpa_f = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=1.0))
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    gx = g.to(dtype)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(*leaves, scale=1.0).backward(gx)

    def port_fwd_bwd():
        at.fused_attention(*leaves).backward(g)

    sdpa_fb = time_ms(sdpa_fwd_bwd, reps=9)
    port_fb = time_ms(port_fwd_bwd, reps=9)
    bounds = attention_bounds(shape, dtype)
    common = {"dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
              "identical_bits_on_repeat": True}
    fwd = {"replaces": "rovit_kan_tpu/ops/attention.py::_attention_kernel",
           **common, "outputs": {"out": errs["out"]},
           "max_abs_err": errs["out"]["max_abs_err"], "kernel_ms": ms_f,
           "plain_ms": plain_f, "library_ms": sdpa_f, "library": SDPA,
           **bounds["fwd"]}
    bwd = {"replaces": "rovit_kan_tpu/ops/attention.py::"
                       "_attention_bwd_kernel",
           **common, "outputs": {k: errs[k] for k in ("dq", "dk", "dv")},
           "max_abs_err": max(errs[k]["max_abs_err"]
                              for k in ("dq", "dk", "dv")),
           "kernel_ms": ms_b, "plain_ms": plain_b, "library_ms": sdpa_fb,
           "library": SDPA + " forward + backward",
           "port_fwd_bwd_ms": port_fb, **bounds["bwd"]}
    return fwd, bwd


def long_model(cfg, inference: bool, dtype=None):
    """The flagship built at ``cfg.data.image_size`` (in ``dtype``, by
    default the config's) with the seed-0 224-px weights carried over by
    ``transfer_resolution`` (the resolution-transfer recipe: the position
    embedding resampled, every other weight as it is)."""
    import copy

    from rovit_kan_tpu_torch.models.convert import transfer_resolution
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    base = copy.deepcopy(cfg)
    base.data.image_size = 224
    src = build_model(base, dtype=torch.float32, inference=True,
                      device="cpu", seed=0)
    model = build_model(cfg, dtype=dtype, inference=inference, device="cuda",
                        seed=1)
    model.load_state_dict(transfer_resolution(
        src.state_dict(), cfg.data.image_size, cfg.model.patch_size))
    return model


def long_config(**tpu):
    from rovit_kan_tpu_torch.config import Config
    cfg = Config()
    cfg.data.image_size = LONG_SIZE
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    return cfg


def long_counters():
    from rovit_kan_tpu_torch.ops import attention as at
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops import block_kernel as bk

    def reset():
        bk.LAUNCHES = bk.BWD_LAUNCHES = ak.LAUNCHES = 0
        at.LAUNCHES = at.BWD_LAUNCHES = 0

    def read():
        return {"vit_block_fwd": bk.LAUNCHES, "vit_block_bwd": bk.BWD_LAUNCHES,
                "augment": ak.LAUNCHES, "attention_fwd": at.LAUNCHES,
                "attention_bwd": at.BWD_LAUNCHES}

    return reset, read


def long_serve(smi: str, label: str, **tpu):
    """The 384-px flagship served through ``InferenceEngine`` (3 batches of
    32) between a counter reset and a read, held against the same model
    through the plain versions and the fp32 model (``hold_served``)."""
    from rovit_kan_tpu_torch.ops import attention as at
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    from rovit_kan_tpu_torch.serving import InferenceEngine
    reset, read = long_counters()
    cfg = long_config(**tpu)
    model = long_model(cfg, inference=True)
    blocks = model.backbone.model.blocks
    engine = InferenceEngine(model, batch_size=LONG_BATCH, device="cuda")
    engine.warmup()
    rng = np.random.RandomState(11)
    batches = [rng.randint(0, 256, (LONG_BATCH, LONG_SIZE, LONG_SIZE, 3))
               .astype(np.uint8) for _ in range(3)]
    torch.cuda.synchronize()
    reset()
    outs = [engine.predict(b) for b in batches]
    launches = read()
    for out in outs:
        for k, v in out.items():
            if v.shape[0] != LONG_BATCH or not np.isfinite(v).all():
                raise RuntimeError(f"{label} {k}: shape {v.shape} or "
                                   f"non-finite")
    served = dict(outs[0], features=features(model, batches[0]))
    for b in blocks:
        b.block_fn, b.attn.attn_fn = bk.plain_vit_block, at.plain_attention
    plain = engine.predict(batches[0])
    plain["features"] = features(model, batches[0])
    for b in blocks:
        b.block_fn, b.attn.attn_fn = bk.fused_vit_block, at.fused_attention
    # The fp32 model: the unfused fp32 path under "auto" on these weights.
    model32 = long_model(cfg, inference=True, dtype=torch.float32)
    exact = InferenceEngine(model32, batch_size=LONG_BATCH,
                            device="cuda").predict(batches[0])
    exact["features"] = features(model32, batches[0])
    checks, failed = hold_served(served, plain, exact)
    if failed:
        emit({"phase": "long", "serve": label, "outputs": checks})
        raise RuntimeError(f"{label}: served outputs out of tolerance: "
                           f"{failed}")
    prof = profile_serving(engine, np.concatenate(batches), smi)
    return {"tpu": tpu, "batches": len(batches), "launches": launches,
            "block_path": all(b.use_fused_block for b in blocks),
            "attention_path": all(b.attn.use_fused and not b.use_fused_block
                                  for b in blocks),
            "outputs": checks, "images_per_sec":
                engine.stats()["images_per_sec"], "profile": prof}


@functools.lru_cache(maxsize=None)
def _plain_backward_attention():
    from rovit_kan_tpu_torch.ops import attention as at

    class PlainBackward(at.FusedAttention):
        @staticmethod
        def backward(ctx, g):
            ctx.plain = True
            return at.FusedAttention.backward(ctx, g)

    return PlainBackward


def _kernel_fwd_plain_bwd_attention(q, k, v):
    """An ``attn_fn``: #5 in the forward, #6's plain version in the
    backward."""
    return _plain_backward_attention().apply(q, k, v, False)


def long_step(cfg, batch, draws, attn_fn=None):
    """One stage-4 step of the 384-px flagship from the transferred weights
    with fixed draws; ``attn_fn`` replaces every block's attention core.
    Returns the loss and every parameter's gradient."""
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    model = long_model(cfg, inference=False)
    if attn_fn is not None:
        for b in model.backbone.model.blocks:
            b.attn.attn_fn = attn_fn
    opt = build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg,
                           generator=torch.Generator("cuda").manual_seed(1))
    m = step(batch, 4, 1.0, 1, draws=dict(
        draws, dropout=torch.Generator("cuda").manual_seed(2)))
    return {"loss": float(m["total_loss"]),
            "grads": {k: p.grad.detach().clone()
                      for k, p in zip(opt.names, opt.params)}}


def long_train(smi: str, label: str, steps: int, want_per_step: dict,
               **tpu):
    """``steps`` stage-4 steps (mixing on) of the 384-px flagship between a
    counter reset and a read, which must show ``want_per_step`` per step;
    finite losses; one profiled step."""
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    reset, read = long_counters()
    cfg = long_config(**tpu)
    model = long_model(cfg, inference=False)
    opt = build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg,
                           generator=torch.Generator("cuda").manual_seed(0))
    batches = [train_batch(cfg, 300 + i, LONG_BATCH) for i in range(steps)]
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    losses = [float(step(b, 4, 1.0, 1)["total_loss"]) for b in batches]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read()
    want = {k: want_per_step.get(k, 0) * steps for k in launches}
    if launches != want:
        raise RuntimeError(f"{label} train launches {launches}, want {want}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{label}: non-finite train losses {losses}")
    return {"tpu": tpu, "steps": steps, "launches": launches,
            "losses": losses, "step_ms": 1e3 * elapsed / steps,
            "profile": profile_step(step, batches[0]), "card": smi}


def hold_attention_step(cfg, batch, draws):
    """One stage-4 step through #5 and #6 against the same step with #6's
    plain version (same weights, draws and dropout masks; the forwards are
    the same launches, so the losses agree to the bit): each parameter's
    gradient within 5e-2 of its L2 norm, hold_train_step's limit for #2."""
    k = long_step(cfg, batch, draws)
    p = long_step(cfg, batch, draws, _kernel_fwd_plain_bwd_attention)
    leaf = {n: float((g - p["grads"][n]).norm())
            / max(float(p["grads"][n].norm()), 1e-30)
            for n, g in k["grads"].items()}
    worst = max(leaf, key=leaf.get)
    held = {"loss_kernels": k["loss"], "loss_plain_bwd": p["loss"],
            "tolerance": 5e-2, "worst_leaf": worst,
            "worst_rel": leaf[worst],
            "median_leaf_rel": float(np.median(list(leaf.values())))}
    if k["loss"] != p["loss"] or not leaf[worst] <= 5e-2:
        emit({"phase": "long", "held_step": held})
        raise RuntimeError("attention train step out of tolerance")
    return held


def long_phase(smi: str):
    """The 384-px (577-token) flagship, batch 32, with the seed-0 224-px
    weights carried over: #5/#6 and #1/#2 at the long path's shapes against
    their plain versions, served and trained through the block kernels
    ("auto") and through the attention-only kernels."""
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops.mixing import draw_mix
    attention = {}
    for seed, (shape, dtype) in enumerate(
            (((LONG_BATCH, HEADS, LONG_TOKENS, DIM // HEADS), torch.bfloat16),
             ((LONG_BATCH, HEADS, LONG_TOKENS, DIM // HEADS), torch.float32),
             ((BATCH, HEADS, TOKENS, DIM // HEADS), torch.bfloat16),
             ((BATCH, HEADS, TOKENS, DIM // HEADS), torch.float32))):
        attention[shape[2], dtype] = check_attention(shape, dtype, 20 + seed)
    blocks577 = {dtype: (check_block(dtype, 30 + i, LONG_BATCH, LONG_TOKENS),
                         check_block_bwd(dtype, 32 + i, LONG_BATCH,
                                         LONG_TOKENS))
                 for i, dtype in enumerate((torch.bfloat16, torch.float32))}

    serve_auto = long_serve(smi, "serve auto")
    serve_attn = long_serve(smi, "serve attention", use_pallas_block=False)
    for got, want in ((serve_auto, {"vit_block_fwd": 12}),
                      (serve_attn, {"attention_fwd": 12})):
        per_batch = {k: v / got["batches"] for k, v in got["launches"].items()}
        if per_batch != {k: want.get(k, 0) for k in per_batch}:
            raise RuntimeError(f"long serve launches {got['launches']} for "
                               f"{got['batches']} batches, want {want} each")

    train_attn = long_train(smi, "attention", 3, {
        "attention_fwd": 12, "attention_bwd": 12, "augment": 1},
        use_pallas_block=False, use_pallas_attention=True)
    train_auto = long_train(smi, "auto", 2, {
        "vit_block_fwd": 12, "vit_block_bwd": 12, "augment": 1})
    cfg = long_config(use_pallas_block=False, use_pallas_attention=True)
    held = hold_attention_step(cfg, train_batch(cfg, 400, LONG_BATCH), {
        "factors": ak.draw_factors(torch.Generator("cuda").manual_seed(5),
                                   LONG_BATCH),
        "mix": draw_mix(torch.Generator().manual_seed(6), LONG_BATCH,
                        LONG_SIZE, LONG_SIZE)})
    return {"phase": "long", "model": "DeiT-Tiny RoViT-KAN d=192 depth=12 "
            "heads=3 384px (577 tokens) bf16, seed-0 224-px weights through "
            "transfer_resolution", "batch_size": LONG_BATCH,
            "attention_kernels": {f"{n}_{str(d).replace('torch.', '')}": r
                                  for (n, d), r in attention.items()},
            "block_kernels_577": {str(d).replace("torch.", ""): r
                                  for d, r in blocks577.items()},
            "serve_auto": serve_auto, "serve_attention": serve_attn,
            "train_attention": train_attn, "train_auto": train_auto,
            "held_attention_step": held, "card": smi}, attention, blocks577


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
    bwd16 = check_block_bwd(torch.bfloat16, seed=2)
    bwd32 = check_block_bwd(torch.float32, seed=3)
    aug16 = check_augment(torch.bfloat16, seed=4)
    aug32 = check_augment(torch.float32, seed=5)
    kan = check_kan(seed=6)
    emit({"phase": "kernels", "vit_block_fwd": [bf16, fp32],
          "vit_block_bwd": [bwd16, bwd32], "augment": [aug16, aug32], **kan,
          "card": smi})

    result = serve(smi)
    emit(result)
    trained = train(smi)
    emit(trained)
    kanned = kan_phase(smi)
    emit(kanned)
    longed, attn, blocks577 = long_phase(smi)
    emit(longed)

    keys = ("max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "library_ms")

    def entry(name, source, replaces, launches, lo, hi, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": lo["max_abs_err"], "ms": lo["kernel_ms"],
                "plain_ms": lo["plain_ms"], "bound_ms": lo["bound_ms"],
                "bound_by": lo["bound_by"], "library_ms": lo["library_ms"],
                **extra, "fp32": {k: hi[k] for k in keys}}

    csrc = "rovit_kan_tpu_torch/csrc/"

    def kan_entry(name, line, r, phase):
        by_path = {"serve": phase["serve_launches"][name],
                   "trajectory": phase["trajectory_launches"][name],
                   "train": phase["train_launches"][name]}
        return {"name": name, "route": "cuda", "source": csrc + "kan.cu",
                "replaces": f"rovit_kan_tpu/ops/kan_kernel.py:{line}",
                "launches": sum(by_path.values()),
                "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                "call_ms": r["call_ms"], "plain_call_ms": r["plain_call_ms"],
                "launches_by_path": by_path}

    def n577(i):
        return {str(d).replace("torch.", ""): {k: r[i][k] for k in keys}
                for d, r in blocks577.items()}

    def long_launches(name):
        return {path: longed[path]["launches"][name] for path in (
            "serve_auto", "serve_attention", "train_attention",
            "train_auto")}

    def attn_entry(name, line, i):
        by_path = long_launches(name)
        lo = attn[LONG_TOKENS, torch.bfloat16][i]
        return {**entry(name, csrc + "attention.cu",
                        f"rovit_kan_tpu/ops/attention.py:{line}",
                        sum(by_path.values()), lo,
                        attn[LONG_TOKENS, torch.float32][i],
                        launches_by_path=by_path, library=lo["library"],
                        n197={str(d).replace("torch.", ""):
                              {k: attn[TOKENS, d][i][k] for k in keys}
                              for d in (torch.bfloat16, torch.float32)}),
                **({"port_fwd_bwd_ms": lo["port_fwd_bwd_ms"]} if i else {})}

    emit({"kernels": [
        entry("vit_block_fwd", csrc + "vit_block_fwd.cu",
              "rovit_kan_tpu/ops/block_kernel.py:92",
              result["block_launches"], bf16, fp32,
              train_launches=trained["launches"]["vit_block_fwd"],
              long_launches=long_launches("vit_block_fwd"), n577=n577(0)),
        entry("vit_block_bwd", csrc + "vit_block_bwd.cu",
              "rovit_kan_tpu/ops/block_kernel.py:399",
              trained["launches"]["vit_block_bwd"], bwd16, bwd32,
              port_fwd_bwd_ms=bwd16["port_fwd_bwd_ms"],
              long_launches=long_launches("vit_block_bwd"), n577=n577(1)),
        entry("augment", csrc + "augment.cu",
              "rovit_kan_tpu/ops/augment_kernel.py:73",
              trained["launches"]["augment"], aug16, aug32)] + [
        kan_entry(name, line, kan[name], kanned)
        for name, line in (("kan_layer_fwd", 48), ("kan_layer_bwd", 129),
                           ("kan_module_fwd", 252),
                           ("kan_module_bwd", 367))] + [
        attn_entry("attention_fwd", 36, 0),
        attn_entry("attention_bwd", 120, 1)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
