"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the script
exits non-zero:

1. device: the card's name and power limit;
2. build: every ``rovit_kan_tpu_torch/csrc/*.cu`` compiled from a clean
   build directory, one ``nvcc`` per source, all started together; the
   fp32 block stages' and the KAN kernels' instances on the main path
   must not spill (``ptxas``; #11's may keep the 4 bytes it spilled
   before, ``KAN_SPILL_BYTES``);
3. kernels: each ported kernel against its plain PyTorch version on the
   card at the main path's shapes, with the stated tolerance, and timed
   (CUDA events, warm-up, median) beside its bound, the plain version and
   one PyTorch library call computing the same function: the block forward
   (#1) and backward (#2) at (64, 197, 192), 3 heads, and the augment (#7)
   at (64, 224, 224, 3), each in bf16 and fp32 (#7 also at (32, 384, 384, 3)
   in bf16, timed, and at (3, 33, 35, 3) in both, held; #1, #2 and #7 also
   the same bits on a repeated call; #7 also by profiler device time per
   launch name; #1, #2, #7 and ``TransformerEncoderLayer``'s forward
   also by CUDA-graph replay, the device time; #1's three stages and each of
   #2's stages by torch.profiler beside each stage's bound, #2 in either
   type failing if a first-design stage it replaced runs; #1 + #2 under
   autograd and ``TransformerEncoderLayer``'s forward + backward, and the
   layer's backward alone (forward + backward less forward), also by
   profiler device time); the KAN head's forward
   (#10) and backward (#11) at (64, [192, 64, 16, 1]) and one KAN layer's
   (#8, #9: ``kan_module.cu``'s kernels without the head) at
   (64, 192 -> 64), fp32, each output within 1e-4 of its largest
   magnitude, the same bits on a repeated call and with the basis's
   reciprocal divisions off, the kernels of a call (#10, #11 and #8 one
   launch; #9 four clusters of 16 rows, then the slots' ordered add as a
   second launch), their ``ms`` and
   their plain versions' ``plain_ms`` the device time per call from
   torch.profiler, the kernels' ``kernel_graph_ms`` by CUDA-graph replay
   (CUDA events around back-to-back calls time the host work there, kept
   as ``call_ms`` and ``plain_call_ms``), #9 also at 16, 32 and 64 rows a
   group by graph replay; then, on a line of its own
   ("kan_layer_widths"), #8/#9 checked and timed the same way at the
   trajectory's other layers, 64 -> 16 and 16 -> 1;
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
   (bf16: the mma.sync kernels of ``attention_mma.cuh``; fp32: the 3xTF32
   mma.sync kernels of ``attention_tf32.cuh``) and #1/#2 at
   (32, 577, 192), bf16 and fp32, against their plain versions (same bits
   on repeat for #1, #5 and #6) and timed beside their bounds, the plain
   versions and SDPA or ``TransformerEncoderLayer`` (#1, #2, #5, #6 and the
   library forwards also by CUDA-graph replay, #1's stages by
   torch.profiler; SDPA's forward + backward, its backward alone and the
   port's #5 + #6 under autograd by profiler device time, with SDPA's
   kernel names); served through ``InferenceEngine``
   with "auto" (12 x #1 per batch, no #5) and with
   ``use_pallas_block=False`` (12 x #5 per batch, no #1), each held
   against its plain versions and the fp32 model as in "serve"; three
   train steps with ``use_pallas_block=False, use_pallas_attention=True``
   (12 x #5, 12 x #6, 1 x #7 each), two with "auto" (12 x #1, 12 x #2,
   1 x #7 each), finite losses; one step held per
   parameter against the same step with #6's plain version; the fp32 arm
   (``flags.mixed_precision=False``, the attention kernels, block off):
   one served batch (12 x #5) and one train step (12 x #5, 12 x #6; no
   #7, which the trainer takes only under mixed precision) held against
   ``plain_attention`` (outputs and loss 1e-4 relative, the flat gradient
   1e-3 in L2);
8. fit: the saved-residual pair. #3 and #4 at (64, 197, 192) and
   (32, 577, 192), bf16 and fp32, against their plain versions (#3's output
   the bits of #1's, the same bits on a repeated #3 and #4 call), timed
   beside their bounds, the plain versions and ``TransformerEncoderLayer``
   (#3, #4 and the layer's forward also by CUDA-graph replay; #4's stages
   beside their bounds, and #3 + #4, #1 + #2, the layer's forward +
   backward and its backward alone, by profiler device time); one flagship
   train step with ``ROVIT_BLOCK_RESIDUAL_BWD=1`` held against the same step
   through #1/#2 and through #4's plain version (``hold_residual_step``);
   then ``Trainer.fit`` at the flagship's full width over a device-resident
   synthetic set (``make_leaf_image``, 4 classes x 100 images, 80/20 split:
   5 train steps and 2 validation batches, the second padded, per epoch)
   for 4 epochs across curriculum stages 1-4 and the backbone's unfreeze
   with the opt-in (12 x #3 and 12 x #4 and no #1/#2 per train step, 12 x
   #1 per validation batch, finite losses, the epoch CSV and the best
   checkpoint written), ``resume`` and one more epoch, ``load_engine`` on
   the best checkpoint serving two batches (its outputs the bits of the
   trainer's best weights through the same kernels); the same fit with the
   opt-in off and on in turns for the epoch img/s of both arms;
9. eval: the train -> evaluate -> serve loop through the CLIs, on a
   synthetic JPEG tree at 224 px (``generate_synthetic_dataset``: 4 x 48
   augmented images, split 80/20 into 2 train steps and 1 validation batch
   an epoch, and 4 x 25 test images, 2 batches, the second 36 of 64 valid).
   ``cli.train`` for 2 epochs at batch 64 (12 x #1, 12 x #2 and 1 x #7 per
   step; 12 x #1 per validation and test batch and per bs=1 FPS forward;
   finite losses; the CSV, ``best_model`` and ``test_metrics.json``);
   ``cli.evaluate --calibrate --store_temperature`` on ``best_model`` (T
   stored and served by ``load_engine``, or a degenerate fit refused with
   the sidecar unchanged), then with ``--device_metrics on``: the counts
   equal to the host path's, accuracy equal in fp32, macro F1 within 1e-6,
   the other metrics within 1e-5; one ``Evaluator`` pass through #1 held against the
   plain block and the fp32 model as "serve" holds served outputs
   (``hold_served``); the test pass's seconds, evaluation img/s and the
   bs=1 FPS, which must be finite and positive.

The line before the last is ``nvidia-smi``'s name and power limit; the last
is ``{"ok": true, "device": {...}}``. Imports torch and the port only.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet; dense, no sparsity).
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
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


def op_seconds(flops, dtype, fma: bool = False) -> float:
    """Least seconds for ``flops`` of products in the route of ``dtype``:
    bf16 at the bf16 tensor peak; fp32 as 3xTF32, three TF32 products each
    at the TF32 peak, or on the FMA units (``fma``) at 67 TFLOP/s."""
    if dtype == torch.bfloat16:
        return flops / PEAK_BF16_FLOPS
    return flops / PEAK_FP32_FLOPS if fma else 3 * flops / PEAK_TF32_FLOPS


def block_bound_ms(x, params, dtype, fma: bool = False) -> float:
    """#1's least time: the larger of its FLOP over the route's rate
    (``op_seconds``) and its bytes over the HBM rate."""
    B, N, D = x.shape
    hd = D // HEADS
    flops = 2 * B * N * D * (4 * D + 2 * HIDDEN) + 4 * B * HEADS * N * N * hd
    nbytes = 2 * x.numel() * x.element_size() + sum(
        p.numel() * p.element_size() for p in params.values())
    return 1e3 * max(op_seconds(flops, dtype, fma),
                     nbytes / PEAK_BYTES_PER_S)


# The kernels of #1's three launches in a profile, by stage and route.
BLOCK_STAGES = {
    torch.bfloat16: {"ln_qkv": "ln_qkv_mma_kernel",
                     "attention": "attn_fwd_mma_kernel",
                     "proj_mlp": "proj_mlp_mma_kernel"},
    torch.float32: {"ln_qkv": "ln_qkv_tf32_kernel<",
                    "attention": "attn_fwd_tf32_kernel<",
                    "proj_mlp": "proj_mlp_tf32_kernel<"}}
# The first design's fp32 forward stages, which the 3xTF32 stages replaced:
# no profile of #1, #2 or #3 may show one.
REPLACED_FWD_STAGES = ("namespace)::ln_qkv_kernel<",
                       "namespace)::attn_fwd_kernel<",
                       "namespace)::proj_mlp_kernel<")


# The fp32 block stages' instances at the flagship's widths (D = 192, head
# width 64), which must not spill (the build line's ``ptxas`` table).
MAIN_PATH_TF32 = ("ln_qkv_tf32_kernel<192,", "proj_mlp_tf32_kernel<192,",
                  "attn_fwd_tf32_kernel<64,true>")
# The kan_module.cu instances of the flagship head and its trajectory (7
# bases: 8 feature slots; with the head and without it). None may spill
# more than listed here: #11's keeps the 4 bytes it spilled before #8/#9
# moved into its source (each variant that removed them ran #11 slower on
# an H100; PERF.md §6).
MAIN_PATH_KAN = ("kan_module_fwd_kernel<8,", "kan_module_bwd_kernel<8,")
KAN_SPILL_BYTES = {"kan_module_bwd_kernel<8,true>": 4}


def no_replaced_fwd(ops: dict, what: str) -> None:
    """Raises if a profile (``device_ops``) ran a replaced forward stage."""
    old = [k for k in ops if any(o in k for o in REPLACED_FWD_STAGES)]
    if old:
        raise RuntimeError(f"{what} ran replaced forward stages: {old}")


def stage_bounds_ms(x, dtype) -> dict:
    """Each of #1's stages' least time: the larger of its FLOP over the
    route's rate (``op_seconds``: fp32 as 3xTF32) and its bytes (inputs
    read once, outputs written once; qkv and the attention output pass
    through device memory between the stages) over the HBM rate."""
    B, N, D = x.shape
    M, size = B * N, x.element_size()
    work = {"ln_qkv": (2 * M * D * 3 * D, (M * 4 * D + 3 * D * D) * size),
            "attention": (4 * B * N * N * D, M * 4 * D * size),
            "proj_mlp": (2 * M * D * (D + 2 * HIDDEN),
                         (3 * M * D + D * (D + 2 * HIDDEN)) * size)}
    return {k: 1e3 * max(op_seconds(f, dtype), b / PEAK_BYTES_PER_S)
            for k, (f, b) in work.items()}


def check_block(dtype, seed: int, batch: int = BATCH, tokens: int = TOKENS):
    """#1 against ``block_reference`` (and the same bits on a repeated
    call), timed by CUDA events around back-to-back calls and by CUDA-graph
    replay (device time) beside its bound, the plain version and
    ``TransformerEncoderLayer``'s forward; its three stages' device time
    from torch.profiler."""
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    x, params = block_inputs(dtype, seed, batch, tokens)
    with torch.inference_mode():
        got = bk.fused_vit_block(x, params, HEADS)
        ref = bk.block_reference(x, params, HEADS)
        again = bk.fused_vit_block(x, params, HEADS)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"block kernel ({dtype}) gave non-finite "
                               f"values")
        if not torch.equal(again, got):
            raise RuntimeError(f"block kernel ({dtype}) gave other bits on "
                               f"a repeated call")
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
        graph = graph_ms(lambda: bk.fused_vit_block(x, params, HEADS))
        library_graph = graph_ms(lambda: layer(x))
        ops = device_ops(lambda: bk.fused_vit_block(x, params, HEADS))
        no_replaced_fwd(ops, f"block kernel ({dtype})")
        stages = by_label(ops, BLOCK_STAGES[dtype])
    return {"replaces": "rovit_kan_tpu/ops/block_kernel.py::"
                        "_vit_block_kernel",
            "dtype": str(dtype).replace("torch.", ""),
            "shape": list(x.shape), "heads": HEADS,
            "launches_per_batch": "12 (one per block; counted in 'serve')",
            "max_abs_err": err, "tolerance": tol,
            "identical_bits_on_repeat": True, "kernel_ms": ms,
            "kernel_graph_ms": graph, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_graph_ms": library_graph,
            "graph_ms_source": "CUDA events around replays of a CUDA graph "
                               "of 20 calls (device time)",
            "stages_device_ms": stages,
            "stages_bound_ms": stage_bounds_ms(x, dtype),
            "library_max_abs_err": lib_err,
            "bound_ms": block_bound_ms(x, params, dtype),
            "bound_by": "operations",
            **({"fma_bound_ms": block_bound_ms(x, params, dtype, fma=True)}
               if dtype == torch.float32 else {})}


# The kernels of #2's and #4's stages in a profile, by stage and route
# (#2 also runs #1's ln_qkv and attention stages to recompute qkv and the
# attention output). Each route's must run, and the first design's stages,
# which both routes replaced, must not (``REPLACED_BWD_STAGES``).
BWD_STAGES = {
    torch.bfloat16: {"mlp_bwd": "mlp_bwd_mma_kernel<",
                     "attention_q": "attn_bwd_q_mma_kernel<",
                     "attention_kv": "attn_bwd_kv_mma_kernel<",
                     "qkv_bwd": "qkv_bwd_mma_kernel<",
                     "wgrad": "wgrad_mma_kernel",
                     "reduce": "namespace)::reduce_kernel<"},
    torch.float32: {"mlp_bwd": "mlp_bwd_fma_kernel<",
                    "attention_q": "attn_bwd_q_fma_kernel<",
                    "attention_kv": "attn_bwd_kv_fma_kernel<",
                    "qkv_bwd": "qkv_bwd_fma_kernel<",
                    "wgrad": "wgrad_fma_kernel<",
                    "reduce": "namespace)::reduce_kernel<"}}
REPLACED_BWD_STAGES = ("namespace)::mlp_bwd_kernel<",
                       "namespace)::qkv_bwd_kernel<",
                       "namespace)::wgrad_kernel<")


def bwd_stages(fn, dtype, recompute: bool, calls: int = 10) -> dict:
    """Device time per call of each stage of one backward call ``fn`` (#2
    when ``recompute``, else #4), and of all its device operations, from
    one profile; it raises if a replaced stage ran."""
    ops = device_ops(fn, calls)
    kernels = dict(BWD_STAGES[dtype])
    if recompute:
        kernels.update({k: BLOCK_STAGES[dtype][k]
                        for k in ("ln_qkv", "attention")})
    old = [k for k in ops if any(o in k for o in REPLACED_BWD_STAGES)]
    if old:
        raise RuntimeError(f"{dtype} backward ran replaced stages: {old}")
    no_replaced_fwd(ops, f"{dtype} backward")
    out = by_label(ops, kernels)
    out["all"] = sum(ops.values())
    return out


def bwd_stage_bounds_ms(x, dtype, recompute: bool) -> dict:
    """Each of #2's (``recompute``) or #4's stages' least time: the larger
    of its needed FLOP over the peak and its bytes (inputs read once,
    outputs written once, in the compute type; partials and grads fp32)
    over the HBM rate. mlp_bwd: proj again, fc1 again (#2 only), dh, dz and
    dattn; the attention query side S, dP and dQ, the key side S, dP, dK
    and dV; the reduce reads every partial once."""
    B, N, D = x.shape
    M, H, hd, size = B * N, HIDDEN, D // HEADS, x.element_size()
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    attn = 2 * B * HEADS * N * N * hd             # one N x N x hd product
    rows = M * D * size
    weights = (4 * D * D + 2 * H * D) * size
    tiles = -(-M // 64)
    work = {
        "mlp_bwd": (2 * M * D * (2 * D + (3 if recompute else 2) * H),
                    5 * rows + 4 * M * D + 2 * M * H * size
                    + (0 if recompute else M * H * size) + weights
                    + 4 * tiles * (4 * D + H)),
        "attention_q": (3 * attn, 5 * rows + 4 * 3 * B * HEADS * N),
        "attention_kv": (4 * attn, 6 * rows + 4 * 3 * B * HEADS * N),
        "qkv_bwd": (2 * M * 3 * D * D,
                    5 * rows + 4 * M * D + 3 * D * D * size
                    + (0 if recompute else rows) + 4 * tiles * 2 * D),
        "wgrad": (2 * M * (4 * D * D + 2 * H * D),
                  (6 * M * D + 2 * M * H) * size + 4 * (4 * D * D + 2 * H * D)),
        "reduce": (0, 4 * 2 * (4 * D * D + 2 * H * D + 6 * D + H))}
    out = {k: 1e3 * max(f / peak, b / PEAK_BYTES_PER_S)
           for k, (f, b) in work.items()}
    if recompute:
        first = stage_bounds_ms(x, dtype)
        out.update({k: first[k] for k in ("ln_qkv", "attention")})
    return out


def split_device_ms(fwd, fwd_bwd, calls: int = 10,
                    graph: bool = False) -> dict:
    """A backward alone by device time: ``fwd_bwd`` (forward + backward)
    less ``fwd`` (the same training forward, autograd recording), so each
    backward kernel has a library factor of its own; by profiler device time
    (``device_ms``), or by CUDA-graph replay (``graph_ms``) when ``graph``."""
    timer = graph_ms if graph else device_ms
    both = timer(fwd_bwd, calls=calls)
    forward = timer(fwd, calls=calls)
    return {"fwd_bwd": both, "fwd": forward, "bwd": both - forward}


def layer_bwd_device_ms(layer, xg, gx, calls: int = 10) -> dict:
    """``TransformerEncoderLayer``'s backward alone (``split_device_ms``)."""
    def fwd():
        layer(xg)

    def fwd_bwd():
        layer(xg).backward(gx)

    return split_device_ms(fwd, fwd_bwd, calls)


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
    each against its own tolerance, and the same bits on a repeated call;
    timed by CUDA events, by CUDA-graph replay and by stage
    (``bwd_stages``) beside the plain version; #1 + #2 under autograd and
    ``TransformerEncoderLayer``'s forward + backward by events and by
    profiler device time."""
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    x, params = block_inputs(dtype, seed, batch, tokens)
    g = torch.tensor(np.random.RandomState(seed + 10).normal(
        0, 1, x.shape), dtype=torch.float32, device="cuda")
    with torch.no_grad():
        dx, grads = bk._launch_bwd(x, g, params, HEADS)
        want_dx, want = bk.block_backward_reference(x, g, params, HEADS)
        again_dx, again = bk._launch_bwd(x, g, params, HEADS)
        torch.cuda.synchronize()
    if not (torch.equal(again_dx, dx) and all(
            torch.equal(again[k], grads[k]) for k in bk.PKEYS)):
        raise RuntimeError(f"backward kernel ({dtype}) gave other bits on a "
                           f"repeated call")
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
        graph = graph_ms(lambda: bk._launch_bwd(x, g, params, HEADS),
                         calls=5)
        stages = bwd_stages(lambda: bk._launch_bwd(x, g, params, HEADS),
                            dtype, recompute=True)
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
    port_device = device_ms(port_fwd_bwd, calls=10)
    library_split = layer_bwd_device_ms(layer, xg, gx)
    library_device = library_split["fwd_bwd"]
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
            "identical_bits_on_repeat": True,
            "outputs": errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "max_rel_err": max(e["rel_err"] for e in errs.values()),
            "kernel_ms": ms, "kernel_graph_ms": graph, "plain_ms": plain_ms,
            "stages_device_ms": stages,
            "stages_bound_ms": bwd_stage_bounds_ms(x, dtype, True),
            "port_fwd_bwd_ms": port_ms, "library_ms": library_ms,
            "port_fwd_bwd_device_ms": port_device,
            "library_device_ms": library_device,
            "library_bwd_device_ms": library_split["bwd"],
            "library_fwd_train_device_ms": library_split["fwd"],
            "library": "nn.TransformerEncoderLayer forward + backward",
            "device_ms_source": "torch.profiler: every device operation of "
                                "10 calls, per call",
            "bound_ms": 1e3 * max(flops / peak, nbytes / PEAK_BYTES_PER_S),
            "bound_by": "operations"}


def augment_tol(compute) -> float:
    """Both sides round at the same points; the pivot sums H*W*3 terms in
    another order, and a rounding boundary it crosses moves each of the
    three rounded blends by at most one ulp of [0, 1] (2^-8 in bf16), scaled
    by 1/std (<= 1/0.224) in the normalization. fp32: sum order only."""
    return 3 * 2.0 ** -8 / 0.224 if compute == torch.bfloat16 else 1e-5


#: #7's timed shapes: the 224-px train step's batch in bf16 and fp32
#: compute and the 384-px ("long") step's in bf16, fp32 out; and one odd
#: shape (W * 3 % 16 != 0, so no bulk copies) held but not timed.
AUGMENT_SHAPES = (((BATCH, 224, 224), torch.bfloat16),
                  ((BATCH, 224, 224), torch.float32),
                  ((32, 384, 384), torch.bfloat16))
AUGMENT_ODD = (3, 33, 35)


def check_augment(compute, seed: int, shape=(BATCH, 224, 224),
                  timed: bool = True):
    """Kernel #7 against ``augment_reference`` within ``augment_tol``, the
    same bits on a repeated call, and timed three ways: by CUDA events
    around back-to-back wrapper calls (``kernel_ms``, as #1-#6), by
    CUDA-graph replay (``kernel_graph_ms``, the device time) and by
    torch.profiler device time per launch name (``device_ms_by_kernel``).
    Bytes: each input read once, each output written once."""
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    B, H, W = shape
    rng = np.random.RandomState(seed)
    imgs = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3))
                            .astype(np.uint8)).cuda()
    factors = ak.draw_factors(torch.Generator("cuda").manual_seed(seed), B)
    got = ak.fused_augment_batch(imgs, factors, compute)
    again = ak.fused_augment_batch(imgs, factors, compute)
    want = ak.augment_reference(imgs, factors, compute)
    torch.cuda.synchronize()
    what = f"augment kernel ({compute}, {tuple(shape)})"
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{what} non-finite values")
    if not torch.equal(got, again):
        raise RuntimeError(f"{what}: a repeated call gave other bits")
    err = float((got - want).abs().max())
    tol = augment_tol(compute)
    if not err <= tol:
        raise RuntimeError(f"{what} max |err| {err} > tolerance {tol}")
    out = {"compute_dtype": str(compute).replace("torch.", ""),
           "out_dtype": "float32", "shape": [B, H, W, 3],
           "max_abs_err": err, "tolerance": tol,
           "identical_bits_on_repeat": True}
    if not timed:
        return out
    fn = functools.partial(ak.fused_augment_batch, imgs, factors, compute)
    ops = device_ops(fn)
    nbytes = imgs.numel() * (1 + got.element_size()) + factors.numel() * 4
    return {"replaces": "rovit_kan_tpu/ops/augment_kernel.py::"
                        "_augment_kernel", **out,
            "launches_per_step": "1 (counted in 'train')",
            "kernel_ms": time_ms(fn), "kernel_graph_ms": graph_ms(fn),
            "device_ms_by_kernel": {k[:90]: v for k, v in ops.items()},
            "device_ms": sum(ops.values()),
            "plain_ms": time_ms(lambda: ak.augment_reference(
                imgs, factors, compute), reps=9, inner=3),
            "library_ms": None,
            "library": "none: no single PyTorch call computes the flips, "
                       "jitter and normalization, and the card has no "
                       "torchvision",
            "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
            "bound_by": "bytes"}


def augment_checks(seed: int = 4) -> dict:
    """#7 at ``AUGMENT_SHAPES`` (timed) and ``AUGMENT_ODD`` in bf16 and
    fp32 compute (held only)."""
    timed = [check_augment(c, seed + i, shape)
             for i, (shape, c) in enumerate(AUGMENT_SHAPES)]
    odd = [check_augment(c, seed + 7 + i, AUGMENT_ODD, timed=False)
           for i, c in enumerate((torch.bfloat16, torch.float32))]
    return {"bf16": timed[0], "fp32": timed[1], "n384": timed[2],
            "odd": odd}


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
    names = {"all": ""} if kernels is None else {k: k for k in kernels}
    return sum(device_ms_by(fn, names, calls).values())


def profile_device(fn, calls: int = 20, takes: int = 5) -> dict:
    """Launches and device time (ms) per device operation name over
    ``calls`` calls of ``fn``, from torch.profiler after a warm-up call. The
    profiler first traces one warm-up round of ``calls`` calls that it
    discards (its schedule's warm-up step), since the first operations of a
    trace can be lost. A profile in which an operation's launches are not a
    multiple of ``calls`` lost some of them, and would time the calls it
    kept as if they were all; it is taken again, up to ``takes`` times, and
    the function raises if none is whole."""
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
        ops = {e.key: (e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")}   # the step span
        if ops and all(n % calls == 0 for n, _ in ops.values()):
            return ops
    raise RuntimeError(f"no whole profile in {takes} takes of {calls} calls:"
                       f" launches {({k[:80]: n for k, (n, _) in ops.items()})}")


def device_ops(fn, calls: int = 20) -> dict:
    """Device time per call of ``fn`` by device operation name (ms), from a
    whole profile of ``calls`` calls (``profile_device``)."""
    return {k: ms / calls for k, (_, ms) in profile_device(fn, calls).items()}


def by_label(ops: dict, kernels: dict) -> dict:
    """Sums of ``device_ops`` by label, each label the operations whose name
    holds its substring ("" holds every one). Raises if a label has no
    device time."""
    out = {}
    for label, sub in kernels.items():
        ms = sum(v for k, v in ops.items() if sub in k)
        if not ms > 0:
            raise RuntimeError(f"no device time recorded for {sub}")
        out[label] = ms
    return out


def device_ms_by(fn, kernels: dict, calls: int = 20) -> dict:
    """Device time per call of ``fn`` by label (``by_label``), from one
    torch.profiler run over ``calls`` calls after a warm-up."""
    return by_label(device_ops(fn, calls), kernels)


def graph_ms(fn, calls: int = 20) -> float:
    """Device time per call of ``fn``: CUDA events around replays of one
    CUDA graph that captured ``calls`` calls, so the host enqueues one graph
    launch per replay and a call whose host work exceeds its device time is
    still timed by the device. Three warm-up calls off the capture, as
    PyTorch asks before a capture of autograd's backward."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, reps=10, inner=3) / calls


def kernel_label(mangled: str) -> str:
    """A mangled kernel name as its identifier and integer and bool
    template arguments, ``attn_fwd_tf32_kernel<64,true>``."""
    m = re.match(r"_ZN", mangled)
    if not m:
        return mangled[:60]
    pos, name = m.end(), mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        n = re.match(r"\d+", mangled[pos:]).group()
        pos += len(n)
        name, pos = mangled[pos:pos + int(n)], pos + int(n)
    args = [v if t == "i" else ("true" if v == "1" else "false")
            for t, v in re.findall(r"L([ib])(\d+)E",
                                   mangled[pos:].split("EEv")[0])]
    return name + (f"<{','.join(args)}>" if args else "")


def ptxas_table(log: str) -> list:
    """[kernel, registers, spill stores in bytes, stack frame in bytes] for
    each entry function of an ``nvcc -Xptxas -v`` log."""
    out, fn, spill, stack = [], None, 0, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn, spill, stack = m.group(1), 0, 0
        m = re.search(r"(\d+) bytes stack frame", ln)
        if m:
            stack = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out.append([kernel_label(fn), int(m.group(1)), spill, stack])
            fn = None
    return out


def kan_calls(dims, seed: int):
    """The smoke's seeded inputs at ``dims`` and the calls of the kernels and
    their plain versions on them: #10/#11 for the head, #8/#9 for one
    layer (``len(dims) == 2``). Each call returns a list of outputs; the
    kernels' take ``recip``, the basis's reciprocal divisions on or off."""
    from rovit_kan_tpu_torch.ops import kan_kernel as kk
    from rovit_kan_tpu_torch.ops.spline import make_knots
    knots = make_knots()
    x, params, g = kan_inputs(seed, dims)
    if len(dims) > 2:
        def fwd(recip=True):
            return [kk._launch_module(x, params, knots, 3, recip)]

        def bwd(recip=True):
            return flat_bwd(kk._launch_module_bwd(x, g, params, knots, 3,
                                                  recip))

        def plain_fwd():
            return [kk.kan_module_reference(x, params, knots)]

        def plain_bwd():
            return flat_bwd(kk.kan_module_backward_reference(x, g, params,
                                                             knots))
    else:
        def fwd(recip=True):
            return [kk._launch_layer(x, *params, knots, 3, recip)]

        def bwd(recip=True):
            return list(kk._launch_layer_bwd(x, g, *params[:2], knots, 3,
                                             recip))

        def plain_fwd():
            return [kk.kan_layer_reference(x, *params, knots)]

        def plain_bwd():
            return list(kk.kan_layer_backward_reference(
                x, g, *params[:2], knots))
    return (x, params, g), (fwd, bwd, plain_fwd, plain_bwd)


def kan_module_outputs(seed: int = 6) -> list:
    """#10's output and #11's gradients at the smoke's inputs, for holding
    two checkouts' kernels against each other bit for bit (this file copied
    into the other checkout and called there)."""
    _, (fwd, bwd, _, _) = kan_calls(KAN_DIMS, seed)
    with torch.no_grad():
        out = [t.cpu() for t in fwd() + bwd()]
    torch.cuda.synchronize()
    return out


def kernels_per_call(fn, want: dict) -> dict:
    """The device operations of one call of ``fn`` (whole profiles): raises
    unless they are ``want``'s kernels (name: launches), each named op
    holding one of its names."""
    with torch.no_grad():
        ops = profile_device(fn, calls=10)
    per_call = {k[:80]: n / 10 for k, (n, _) in ops.items()}
    got = {name: sum(n for k, n in per_call.items() if name in k)
           for name in want}
    if got != want or sum(per_call.values()) != sum(want.values()):
        raise RuntimeError(f"launches per call {per_call}, want {want}")
    return per_call


def kan_bwd_kernels(dims, batch: int = BATCH) -> dict:
    """The kernels of one #11 call (#9 for one layer) under its plan: a
    launch a wave of at most ``slots`` clusters, then, past one row group,
    the slots' ordered add."""
    from rovit_kan_tpu_torch.ops import kan_kernel as kk
    plan = kk.module_plan(batch, tuple(dims), KAN_BASES, True, len(dims) > 2)
    want = {"kan_module_bwd_kernel": -(-plan.groups // plan.slots)}
    if plan.groups > 1:
        want["kan_grad_reduce_kernel"] = 1
    return want


def check_kan_case(dims, names, seed: int, floor: float) -> dict:
    """#10/#11 (the head) or #8/#9 (one layer) at (64, ``dims``): each
    output against its plain version, the same bits on a repeated call and
    with the basis's reciprocal divisions off, the kernels of a call
    (``kan_bwd_kernels``), and timed by torch.profiler device time (every
    device operation of a call: its kernels) and by CUDA-graph replay
    beside the launch floor ``floor``. Bytes: each input read once, each
    output written once."""
    (x, params, g), (fwd, bwd, plain_fwd, plain_bwd) = kan_calls(dims, seed)
    module = len(dims) > 2
    fwd_name, bwd_name = names
    grad_names = ["dx"] + [f"d{k}{layer}" for layer in range(len(dims) - 1)
                           for k in ("spline", "weight", "bias")]
    with torch.no_grad():
        got_f, got_b = fwd(), bwd()
        want_f, want_b = plain_fwd(), plain_bwd()
        torch.cuda.synchronize()
        errs_f = hold_kan(fwd_name, [("y", got_f[0], want_f[0])])
        errs_b = hold_kan(bwd_name, list(zip(grad_names, got_b, want_b)))
        if not (same_bits(fwd(), got_f) and same_bits(bwd(), got_b)):
            raise RuntimeError(f"{fwd_name}/{bwd_name}: a repeated call "
                               f"gave other bits")
        if not (same_bits(fwd(False), got_f)
                and same_bits(bwd(False), got_b)):
            raise RuntimeError(f"{fwd_name}/{bwd_name}: the reciprocal "
                               f"basis gave other bits than __fdiv_rn")
        call_f, call_b = time_ms(fwd), time_ms(bwd)
        ms_f, ms_b = device_ms(fwd), device_ms(bwd)
        graph_f, graph_b = graph_ms(fwd), graph_ms(bwd)
        # The plain versions on the kernels' clock: the device time of
        # all their operations; CUDA events keep their call time.
        plain_f = device_ms(plain_fwd, calls=10)
        plain_b = device_ms(plain_bwd, calls=10)
        plain_call_f = time_ms(plain_fwd, reps=9, inner=3)
        plain_call_b = time_ms(plain_bwd, reps=9, inner=3)
    per_call_f = kernels_per_call(fwd, {"kan_module_fwd_kernel": 1})
    per_call_b = kernels_per_call(bwd, kan_bwd_kernels(dims))
    flops_f, flops_b = kan_flops(dims, module)
    wbytes = 4 * sum(p.numel() for p in params)
    # y has the shape of g.
    xbytes, gbytes = 4 * x.numel(), 4 * g.numel()
    shape = [BATCH, list(dims)]
    out = {fwd_name: kan_result(
        "_kan_module_kernel" if module else "_kan_kernel", shape, errs_f,
        ms_f, plain_f, flops_f, xbytes + wbytes + gbytes,
        "1 per served batch and per train step (counted in 'kan')"
        if module else "1 per layer of a trajectory (counted in 'kan')"),
        bwd_name: kan_result(
        "_kan_module_bwd_kernel" if module else "_kan_layer_bwd_kernel",
        shape, errs_b, ms_b, plain_b, flops_b,
        2 * xbytes + gbytes + 2 * wbytes,
        "1 per train step, one launch (counted in 'kan')" if module
        else "1 per layer of a trajectory's gradient, a cluster launch and "
             "the slots' ordered add (counted in 'kan')")}
    for name, call, plain_call, graph, per_call in (
            (fwd_name, call_f, plain_call_f, graph_f, per_call_f),
            (bwd_name, call_b, plain_call_b, graph_b, per_call_b)):
        out[name].update(call_ms=call, plain_call_ms=plain_call,
                         kernel_graph_ms=graph, launch_floor_ms=floor,
                         launches_per_call=per_call,
                         reciprocal_basis_same_bits=True)
    return out


def kan_layer_bwd_rows(seed: int) -> dict:
    """#9 at (64, 192 -> 64) with 16, 32 and 64 rows a group
    (``LAYER_BWD_ROWS``: 4, 2 and 1 clusters; past one, the slots' ordered
    add as a second launch), each held against its plain version and timed
    by CUDA-graph replay, ms."""
    from rovit_kan_tpu_torch.ops import kan_kernel as kk
    _, (_, bwd, _, plain_bwd) = kan_calls(KAN_DIMS[:2], seed)
    rows, out = kk.LAYER_BWD_ROWS, {}
    try:
        for r in (16, 32, 64):
            kk.LAYER_BWD_ROWS = r
            kk.module_plan.cache_clear()
            kk._module_args.cache_clear()
            with torch.no_grad():
                hold_kan(f"kan_layer_bwd at {r} rows", list(zip(
                    ("dx", "dspline", "dweight", "dbias"), bwd(),
                    plain_bwd())))
                out[str(r)] = graph_ms(bwd)
    finally:
        kk.LAYER_BWD_ROWS = rows
        kk.module_plan.cache_clear()
        kk._module_args.cache_clear()
    return out


def check_kan(seed: int):
    """#10/#11 at (64, [192, 64, 16, 1]) and #8/#9 at (64, 192 -> 64)
    (``check_kan_case``), #9's rows a group (``kan_layer_bwd_rows``), and
    the trajectory's other layers, 64 -> 16 and 16 -> 1, under
    "kan_layer_widths"."""
    tiny = torch.zeros(1, device="cuda")
    floor = graph_ms(lambda: tiny.fill_(1.0))
    out = {**check_kan_case(KAN_DIMS, ("kan_module_fwd", "kan_module_bwd"),
                            seed, floor),
           **check_kan_case(KAN_DIMS[:2], ("kan_layer_fwd", "kan_layer_bwd"),
                            seed, floor)}
    out["kan_layer_bwd"]["rows_graph_ms"] = kan_layer_bwd_rows(seed)
    out["kan_layer_widths"] = {
        f"{a}->{b}": check_kan_case((a, b), ("kan_layer_fwd",
                                             "kan_layer_bwd"), seed, floor)
        for a, b in zip(KAN_DIMS[1:-1], KAN_DIMS[2:])}
    return out


def flat_bwd(result):
    """#11's (dx, grads) as one list."""
    dx, grads = result
    return [dx, *grads]


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


SERVED_KEYS = ("features", "cls_probs", "ordinal_probs", "ordinal_severity",
               "uncertainty_std", "kan_severity")


def hold_served(served, plain, exact, keys=SERVED_KEYS):
    """Served outputs ``keys`` (and the argmax ``cls_pred``) of a kernel path
    against the same model through the
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
    for k in keys:
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
    if fp32:
        # An fp32 model under the mixed-precision config: the trainer's
        # "auto" would take the augment kernel (bf16), as the JAX step does,
        # so the fp32 kinds ask for the fp32 chain.
        cfg = copy.deepcopy(cfg)
        cfg.train.fused_augment = False
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
    from torch.profiler, after a warm-up call (``profile_device``)."""
    return sum(n for n, _ in profile_device(fn, calls=1).values())


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
    N x N x hd products, #6 five: S again, dV, dP, dQ, dK) over the rate of
    the route's arithmetic, and bytes (q, k, v in and an fp32 out; q, k, v
    and the fp32 g in and dq, dk, dv out in the input type) over the HBM
    rate. bf16 runs at the bf16 tensor peak. The fp32 route takes each
    product as three TF32 products (3xTF32), so its bound is three times
    the FLOP at the TF32 peak; the fp32 FMA bound (the FLOP at 67 TFLOP/s)
    is printed beside it as ``fma_bound_ms``."""
    B, h, N, hd = shape
    size = 2 if dtype == torch.bfloat16 else 4
    numel = B * h * N * hd
    out = {}
    for name, products, nbytes in (
            ("fwd", 2, numel * (3 * size + 4)),
            ("bwd", 5, numel * (6 * size + 4))):
        flops = 2 * products * B * h * N * N * hd
        seconds = (flops / PEAK_BF16_FLOPS if dtype == torch.bfloat16
                   else 3 * flops / PEAK_TF32_FLOPS)
        bound = {"operations": seconds, "bytes": nbytes / PEAK_BYTES_PER_S}
        by = max(bound, key=bound.get)
        out[name] = {"bound_ms": 1e3 * bound[by], "bound_by": by,
                     "flops": flops, "bytes": nbytes}
        if dtype == torch.float32:
            out[name]["fma_bound_ms"] = 1e3 * max(
                flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)
    return out


# The route of #5/#6 by dtype (csrc/attention.cu): design and device code.
ATTN_DESIGN = {torch.bfloat16: ("mma.sync two-pass, registers",
                                "attention_mma.cuh"),
               torch.float32: ("3xTF32 mma.sync two-pass, registers",
                               "attention_tf32.cuh")}


def top_kernels(ops: dict, n: int = 4) -> list:
    """The ``n`` device operations of a profile (``device_ops``) with the
    most time, as [name, ms per call]."""
    return [[k[:160], v] for k, v in
            sorted(ops.items(), key=lambda kv: -kv[1])[:n]]


def check_attention(shape, dtype, seed: int):
    """#5 and #6 against ``attention_reference`` and
    ``attention_backward_reference`` on seeded inputs (q pre-scaled), the
    same bits on a repeated call, and timed (CUDA events) beside their
    bounds, the plain versions and SDPA (forward, and forward + backward,
    the library yardstick; never on the port's path), and the kernels' and
    SDPA's forward device time from CUDA-graph replays; SDPA's forward +
    backward, its training forward and its backward alone (the difference)
    by CUDA-graph replay too, the port's #5 + #6 under autograd the same
    way, and the names and profiler device times of SDPA's device kernels
    (``profile_device``'s whole profiles). Tolerances: the
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

    def sdpa_fwd():
        for x in leaves:
            x.grad = None
        return F.scaled_dot_product_attention(*leaves, scale=1.0)

    def sdpa_fwd_bwd():
        sdpa_fwd().backward(gx)

    def port_fwd():
        for x in leaves:
            x.grad = None
        return at.fused_attention(*leaves)

    def port_fwd_bwd():
        port_fwd().backward(g)

    sdpa_fb = time_ms(sdpa_fwd_bwd, reps=9)
    port_fb = time_ms(port_fwd_bwd, reps=9)
    sdpa_device = split_device_ms(sdpa_fwd, sdpa_fwd_bwd, graph=True)
    port_device = split_device_ms(port_fwd, port_fwd_bwd, graph=True)
    sdpa_ops = device_ops(sdpa_fwd_bwd, calls=5)
    with torch.no_grad():
        sdpa_fwd_ops = device_ops(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=1.0), calls=5)
    # Device time beside the event times (once a call's host work exceeds
    # its kernel's device time, events time the host): replays of a CUDA
    # graph of the wrapper calls (the backward's includes the wrapper's cast
    # of g).
    with torch.no_grad():
        graph_f = graph_ms(lambda: at._launch(q, k, v))
        graph_b = graph_ms(lambda: at._launch_bwd(q, k, v, g))
        sdpa_graph_f = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=1.0))
    bounds = attention_bounds(shape, dtype)
    common = {"dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
              "design": ATTN_DESIGN[dtype][0],
              "device_source": "rovit_kan_tpu_torch/csrc/"
                               + ATTN_DESIGN[dtype][1],
              "identical_bits_on_repeat": True,
              "kernel_ms_source": "CUDA events around 10 back-to-back calls",
              "kernel_graph_ms_source": "CUDA events around replays of a "
                                        "CUDA graph of 20 calls, per call"}
    fwd = {"replaces": "rovit_kan_tpu/ops/attention.py::_attention_kernel",
           **common, "outputs": {"out": errs["out"]},
           "max_abs_err": errs["out"]["max_abs_err"], "kernel_ms": ms_f,
           "kernel_graph_ms": graph_f, "plain_ms": plain_f,
           "library_ms": sdpa_f, "library_graph_ms": sdpa_graph_f,
           "library": SDPA, "library_kernels": top_kernels(sdpa_fwd_ops),
           **bounds["fwd"]}
    bwd = {"replaces": "rovit_kan_tpu/ops/attention.py::"
                       "_attention_bwd_kernel",
           **common, "outputs": {k: errs[k] for k in ("dq", "dk", "dv")},
           "max_abs_err": max(errs[k]["max_abs_err"]
                              for k in ("dq", "dk", "dv")),
           "kernel_ms": ms_b, "kernel_graph_ms": graph_b, "plain_ms": plain_b,
           "library_ms": sdpa_fb, "library": SDPA + " forward + backward",
           "library_device_ms_source": "CUDA events around replays of a "
                                       "CUDA graph of 10 calls, per call; "
                                       "bwd = fwd_bwd - fwd",
           "library_device_ms": sdpa_device["fwd_bwd"],
           "library_fwd_device_ms": sdpa_device["fwd"],
           "library_bwd_device_ms": sdpa_device["bwd"],
           "library_kernels": top_kernels(sdpa_ops),
           "port_fwd_bwd_ms": port_fb,
           "port_fwd_bwd_device_ms": port_device["fwd_bwd"],
           "port_bwd_device_ms": port_device["bwd"], **bounds["bwd"]}
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


def long_config(mixed_precision: bool = True, **tpu):
    from rovit_kan_tpu_torch.config import Config
    cfg = Config()
    cfg.data.image_size = LONG_SIZE
    cfg.flags.mixed_precision = mixed_precision
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


def rel_err(got, want) -> float:
    """Largest absolute difference over the largest magnitude of ``want``."""
    got, want = (torch.as_tensor(x).double() for x in (got, want))
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def long_fp32_arm(smi: str):
    """The attention-only path in fp32 (``flags.mixed_precision=False``,
    ``use_pallas_attention=True``, block off) at 384 px, batch 32, weights
    through ``transfer_resolution``: one served batch (12 x #5) and one
    stage-4 train step (12 x #5, 12 x #6; the augment is plain PyTorch, as
    the trainer takes #7 only under mixed precision), each between a counter
    reset and a read, held against the same batch and step through
    ``plain_attention``: every served output and the loss within 1e-4 of
    its largest magnitude, the flat gradient within 1e-3 in L2 (3xTF32
    products, about 2^-21 relative each, against fp32's)."""
    from rovit_kan_tpu_torch.ops import attention as at
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops.mixing import draw_mix
    from rovit_kan_tpu_torch.serving import InferenceEngine
    reset, read = long_counters()
    cfg = long_config(mixed_precision=False, use_pallas_block=False,
                      use_pallas_attention=True)
    model = long_model(cfg, inference=True)
    blocks = model.backbone.model.blocks
    if not all(b.attn.use_fused and not b.use_fused_block
               and b.attn.dtype == torch.float32 for b in blocks):
        raise RuntimeError("fp32 arm: the blocks are not on the fp32 "
                           "attention-only path")
    engine = InferenceEngine(model, batch_size=LONG_BATCH, device="cuda")
    engine.warmup()
    images = np.random.RandomState(12).randint(
        0, 256, (LONG_BATCH, LONG_SIZE, LONG_SIZE, 3)).astype(np.uint8)
    torch.cuda.synchronize()
    reset()
    served = engine.predict(images)
    torch.cuda.synchronize()
    serve_launches = read()
    for b in blocks:
        b.attn.attn_fn = at.plain_attention
    plain = engine.predict(images)
    outputs = {k: rel_err(v, plain[k]) for k, v in served.items()}

    batch = train_batch(cfg, 410, LONG_BATCH)
    draws = {"factors": ak.draw_factors(
                 torch.Generator("cuda").manual_seed(7), LONG_BATCH),
             "mix": draw_mix(torch.Generator().manual_seed(8), LONG_BATCH,
                             LONG_SIZE, LONG_SIZE)}
    torch.cuda.synchronize()
    reset()
    k = long_step(cfg, batch, draws)
    torch.cuda.synchronize()
    step_launches = read()
    p = long_step(cfg, batch, draws, at.plain_attention)
    flat_k, flat_p = (torch.cat([g.flatten() for g in r["grads"].values()])
                      for r in (k, p))
    held = {"served_rel_err": outputs, "loss_kernels": k["loss"],
            "loss_plain": p["loss"],
            "loss_rel_err": abs(k["loss"] - p["loss"]) / abs(p["loss"]),
            "grad_rel_l2": float((flat_k - flat_p).norm())
            / float(flat_p.norm()),
            "tolerances": {"served": 1e-4, "loss": 1e-4, "grad_l2": 1e-3}}
    want_serve = {"attention_fwd": 12}
    want_step = {"attention_fwd": 12, "attention_bwd": 12}
    launches = {"serve": serve_launches, "train": step_launches}
    for got, want in ((serve_launches, want_serve),
                      (step_launches, want_step)):
        if got != {n: want.get(n, 0) for n in got}:
            raise RuntimeError(f"fp32 arm launches {launches}")
    if not (all(e <= 1e-4 for e in outputs.values())
            and np.isfinite(k["loss"]) and held["loss_rel_err"] <= 1e-4
            and held["grad_rel_l2"] <= 1e-3):
        emit({"phase": "long", "fp32_attention_arm": held})
        raise RuntimeError("fp32 attention arm out of tolerance")
    return {"tpu": {"use_pallas_block": False,
                    "use_pallas_attention": True},
            "mixed_precision": False, "launches": launches, "held": held,
            "card": smi}


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
    fp32_arm = long_fp32_arm(smi)
    return {"phase": "long", "model": "DeiT-Tiny RoViT-KAN d=192 depth=12 "
            "heads=3 384px (577 tokens) bf16, seed-0 224-px weights through "
            "transfer_resolution", "batch_size": LONG_BATCH,
            "attention_kernels": {f"{n}_{str(d).replace('torch.', '')}": r
                                  for (n, d), r in attention.items()},
            "block_kernels_577": {str(d).replace("torch.", ""): r
                                  for d, r in blocks577.items()},
            "serve_auto": serve_auto, "serve_attention": serve_attn,
            "train_attention": train_attn, "train_auto": train_auto,
            "held_attention_step": held, "fp32_attention_arm": fp32_arm,
            "card": smi}, attention, blocks577


RES_ENV = "ROVIT_BLOCK_RESIDUAL_BWD"


@contextlib.contextmanager
def residual_opt_in(on: bool):
    """``ROVIT_BLOCK_RESIDUAL_BWD`` set to 1 (or 0) inside the block."""
    old = os.environ.get(RES_ENV)
    os.environ[RES_ENV] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(RES_ENV, None)
        else:
            os.environ[RES_ENV] = old


def res_bounds(x, params, dtype) -> dict:
    """Least times of #3 and #4. #3: #1's FLOP; its bytes x, out, the
    returned qkv, attention output and a1 (8D per row in the compute type)
    and the weights. #4: two products per forward product, the proj
    recompute and one S rebuild; its bytes x, the fp32 g, dx, the three
    residuals, the weights and the fp32 grads."""
    B, N, D = x.shape
    M, hd = B * N, D // HEADS
    size = x.element_size()
    fwd = 2 * M * D * (4 * D + 2 * HIDDEN) + 4 * B * HEADS * N * N * hd
    bwd = 2 * fwd + 2 * M * D * D + 2 * B * HEADS * N * N * hd
    wbytes = sum(p.numel() * p.element_size() for p in params.values())
    wcount = sum(p.numel() for p in params.values())
    res = M * (4 * D + HIDDEN) * size
    out = {}
    for name, flops, nbytes in (
            ("fwd", fwd, 2 * x.numel() * size + res + wbytes),
            ("bwd", bwd, 2 * x.numel() * size + 4 * x.numel() + res + wbytes
             + 4 * wcount)):
        # fp32 #3 runs 3xTF32 (the FMA bound beside it); fp32 #4 runs FMA.
        fma = name == "bwd"
        bound = {"operations": op_seconds(flops, dtype, fma),
                 "bytes": nbytes / PEAK_BYTES_PER_S}
        by = max(bound, key=bound.get)
        out[name] = {"bound_ms": 1e3 * bound[by], "bound_by": by,
                     "flops": flops, "bytes": nbytes}
        if dtype == torch.float32 and not fma:
            out[name]["fma_bound_ms"] = 1e3 * max(
                op_seconds(flops, dtype, True), nbytes / PEAK_BYTES_PER_S)
    return out


def check_block_res(dtype, seed: int, batch: int = BATCH,
                    tokens: int = TOKENS):
    """#3 against ``block_residual_reference`` (its output also against
    #1's, bit for bit; qkv, attn and a1 within the forward's tolerance) and
    #4 against ``block_backward_residual_reference`` on #3's residuals (each
    output within ``bwd_tol``; the same bits on a repeated call); timed
    beside their bounds, the plain versions and ``TransformerEncoderLayer``
    (forward, and forward + backward, also by profiler device time); #4 also
    by CUDA-graph replay and by stage (``bwd_stages``); one block's forward +
    backward through the port with the opt-in on (#3 + #4) and off (#1 +
    #2), in turns, by events and by profiler device time."""
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    x, params = block_inputs(dtype, seed, batch, tokens)
    g = torch.tensor(np.random.RandomState(seed + 10).normal(
        0, 1, x.shape), dtype=torch.float32, device="cuda")
    what = f"residual pair {list(x.shape)} {dtype}"
    with torch.no_grad():
        got = bk._launch_res(x, params, HEADS)
        out1 = bk._launch(x, params, HEADS)
        want = bk.block_residual_reference(x, params, HEADS)
        got_again = bk._launch_res(x, params, HEADS)
        res = got[1:]
        dx, grads = bk._launch_bwd_res(x, g, *res, params, HEADS)
        want_dx, want_g = bk.block_backward_residual_reference(
            x, g, *res, params, HEADS)
        again = bk._launch_bwd_res(x, g, *res, params, HEADS)
        torch.cuda.synchronize()
    if not torch.equal(got[0], out1):
        raise RuntimeError(f"{what}: #3's output is not #1's bits")
    if not all(torch.equal(a, b) for a, b in zip(got_again, got)):
        raise RuntimeError(f"{what}: a repeated #3 call gave other bits")
    if not (torch.equal(again[0], dx) and all(
            torch.equal(again[1][k], grads[k]) for k in bk.PKEYS)):
        raise RuntimeError(f"{what}: a repeated #4 call gave other bits")
    errs, failed = {}, []
    pairs = ([(n, a, b, "fwd") for n, a, b in
              zip(("out", "qkv", "attn", "a1"), got, want)]
             + [("dx", dx, want_dx, "bwd")]
             + [(k, grads[k], want_g[k], "bwd") for k in bk.PKEYS])
    for name, a, b, side in pairs:
        if not torch.isfinite(a.float()).all():
            raise RuntimeError(f"{what} {name}: non-finite values")
        err = float((a.float() - b.float()).abs().max())
        tol = (bwd_tol(b, dtype) if side == "bwd" else
               bf16_tol(b) if dtype == torch.bfloat16 else FP32_TOL)
        errs[name] = {"max_abs_err": err, "tolerance": tol}
        if not err <= tol:
            failed.append(name)
    if failed:
        raise RuntimeError(f"{what} out of tolerance: "
                           f"{ {k: errs[k] for k in failed} }")

    with torch.no_grad():
        ms3 = time_ms(lambda: bk._launch_res(x, params, HEADS))
        ms4 = time_ms(lambda: bk._launch_bwd_res(x, g, *res, params, HEADS),
                      reps=9)
        graph4 = graph_ms(lambda: bk._launch_bwd_res(x, g, *res, params,
                                                     HEADS), calls=5)
        stages4 = bwd_stages(lambda: bk._launch_bwd_res(x, g, *res, params,
                                                        HEADS),
                             dtype, recompute=False)
        plain3 = time_ms(lambda: bk.block_residual_reference(
            x, params, HEADS), reps=9, inner=3)
        plain4 = time_ms(lambda: bk.block_backward_residual_reference(
            x, g, *res, params, HEADS), reps=5, inner=3)
        graph3 = graph_ms(lambda: bk._launch_res(x, params, HEADS))
        no_replaced_fwd(device_ops(lambda: bk._launch_res(x, params, HEADS)),
                        what)
        layer = library_layer(params, dtype)
        lib3 = time_ms(lambda: layer(x))
        lib3_graph = graph_ms(lambda: layer(x))
    raw = {k: v.float().detach().clone().requires_grad_()
           for k, v in params.items()}
    xg = x.detach().clone().requires_grad_()
    gx = g.to(dtype)

    def port_fwd_bwd():
        bk.fused_vit_block(xg, raw, HEADS, kernel_params=params).backward(gx)

    layer.train()

    def library_fwd_bwd():
        layer(xg).backward(gx)

    lib4 = time_ms(library_fwd_bwd, reps=9)
    lib4_split = layer_bwd_device_ms(layer, xg, gx)
    lib4_device = lib4_split["fwd_bwd"]
    pair_ms = {"residual": [], "recompute": []}
    pair_device = {"residual": [], "recompute": []}
    for on in (True, False, True, False):
        with residual_opt_in(on):
            arm = "residual" if on else "recompute"
            pair_ms[arm].append(time_ms(port_fwd_bwd, reps=9))
            pair_device[arm].append(device_ms(port_fwd_bwd, calls=10))
    bounds = res_bounds(x, params, dtype)
    common = {"dtype": str(dtype).replace("torch.", ""),
              "shape": list(x.shape), "heads": HEADS,
              "launches_per_step": "12 with the opt-in (counted in 'fit')"}
    fwd = {"replaces": "rovit_kan_tpu/ops/block_kernel.py::"
                       "_vit_block_res_kernel", **common,
           "outputs": {k: errs[k] for k in ("out", "qkv", "attn", "a1")},
           "out_bits_equal_to_vit_block_fwd": True,
           "identical_bits_on_repeat": True,
           "max_abs_err": max(errs[k]["max_abs_err"]
                              for k in ("out", "qkv", "attn", "a1")),
           "kernel_ms": ms3, "kernel_graph_ms": graph3, "plain_ms": plain3,
           "library_ms": lib3, "library_graph_ms": lib3_graph,
           "library": "nn.TransformerEncoderLayer forward",
           **bounds["fwd"]}
    bwd = {"replaces": "rovit_kan_tpu/ops/block_kernel.py::"
                       "_vit_block_bwd_res_kernel", **common,
           "outputs": {k: errs[k] for k in ("dx",) + bk.PKEYS},
           "identical_bits_on_repeat": True,
           "max_abs_err": max(errs[k]["max_abs_err"]
                              for k in ("dx",) + bk.PKEYS),
           "kernel_ms": ms4, "kernel_graph_ms": graph4,
           "stages_device_ms": stages4,
           "stages_bound_ms": bwd_stage_bounds_ms(x, dtype, False),
           "plain_ms": plain4,
           "library_ms": lib4, "library_device_ms": lib4_device,
           "library_bwd_device_ms": lib4_split["bwd"],
           "library_fwd_train_device_ms": lib4_split["fwd"],
           "library": "nn.TransformerEncoderLayer forward + backward",
           "port_fwd_bwd_ms": pair_ms, "port_fwd_bwd_device_ms": pair_device,
           **bounds["bwd"]}
    return fwd, bwd


def hold_residual_step(cfg, batch, draws):
    """One stage-4 flagship step with the opt-in (#3, #4, #7) against the
    same step through #1/#2 and against the same step with #4's plain
    version (same weights, draws and dropout masks). #3's output has #1's
    bits, so the three losses must be the same bits; each parameter's
    gradient within 5e-2 of its L2 norm of the other step's (the limit
    ``hold_train_step`` sets for a bf16 block backward; against #2, a1 is
    rounded to bf16 before GELU and GELU')."""
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    with residual_opt_in(True):
        bk.RES_LAUNCHES = bk.BWD_RES_LAUNCHES = 0
        k = one_step(cfg, "kernels", batch, draws, 4)
        launches = (bk.RES_LAUNCHES, bk.BWD_RES_LAUNCHES)
        p = one_step(cfg, "kernel_fwd", batch, draws, 4)
    with residual_opt_in(False):
        r = one_step(cfg, "kernels", batch, draws, 4)
    if launches != (12, 12):
        raise RuntimeError(f"residual step launched {launches} of #3/#4")
    held = {"loss_residual": k["loss"], "loss_recompute": r["loss"],
            "loss_plain_bwd": p["loss"], "tolerance": 5e-2}
    failed = []
    for name, ref in (("vs_recompute", r), ("vs_plain_bwd", p)):
        leaf = {n: float((g - ref["grads"][n]).norm())
                / max(float(ref["grads"][n].norm()), 1e-30)
                for n, g in k["grads"].items()}
        worst = max(leaf, key=leaf.get)
        held[name] = {"worst_leaf": worst, "worst_rel": leaf[worst],
                      "median_leaf_rel": float(np.median(list(
                          leaf.values()))),
                      "all": grad_gaps(k, ref)["all"]}
        if not leaf[worst] <= 5e-2:
            failed.append(name)
    if not k["loss"] == r["loss"] == p["loss"]:
        failed.append("loss bits")
    if failed:
        emit({"phase": "fit", "held_step": held})
        raise RuntimeError(f"residual train step out of tolerance: {failed}")
    return held


FIT_PER_CLASS = 100


class LeafSet:
    """An in-memory synthetic rose-leaf set: ``per_class`` images of each of
    the four classes from ``make_leaf_image`` (numpy only), severity the
    class index, as the JAX package's severity map gives it."""

    def __init__(self, per_class: int, size: int, seed: int):
        from rovit_kan_tpu_torch.data.synthetic import make_leaf_image
        rng = np.random.RandomState(seed)
        self.labels = np.repeat(np.arange(4), per_class)
        self.images = np.stack([make_leaf_image(int(c), rng, size)
                                for c in self.labels])

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.images[i], int(self.labels[i]), float(self.labels[i])


def fit_counters():
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops import block_kernel as bk

    def reset():
        bk.LAUNCHES = bk.BWD_LAUNCHES = ak.LAUNCHES = 0
        bk.RES_LAUNCHES = bk.BWD_RES_LAUNCHES = 0

    def read():
        return {"vit_block_fwd": bk.LAUNCHES, "vit_block_bwd": bk.BWD_LAUNCHES,
                "vit_block_res_fwd": bk.RES_LAUNCHES,
                "vit_block_bwd_res": bk.BWD_RES_LAUNCHES,
                "augment": ak.LAUNCHES}

    return reset, read


def fit_config(root):
    """The flagship ``Config()`` (224 px, d=192, 12 blocks, bf16, batch 64)
    for four epochs across curriculum stages 1-4, the backbone frozen in
    epoch 1."""
    from rovit_kan_tpu_torch.config import Config
    cfg = Config()
    cfg.train.batch_size = BATCH
    cfg.train.epochs = 4
    cfg.train.stage_1_epochs, cfg.train.stage_2_epochs = 1, 2
    cfg.train.stage_3_epochs = 3
    cfg.flags.freeze_backbone_epochs = 1
    cfg.paths.checkpoints_dir = root / "ckpt"
    return cfg


def run_fit(cfg, loaders, residual: bool, logger=None, resume=False):
    """``Trainer.fit`` between a counter reset and a read, with the opt-in
    on or off; ``resume`` continues from best_model for one more epoch.
    Returns the trainer, fit's result and the launches, with the launches
    each train step and validation batch should have made."""
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.training.trainer import Trainer
    reset, read = fit_counters()
    train, val = loaders
    tr = Trainer(build_model(cfg, device="cuda", seed=1), train, val, cfg,
                 logger=logger, seed=0)
    if not all(b.use_fused_block for b in tr.model.backbone.model.blocks):
        raise RuntimeError("the 'auto' policy did not pick the block kernel")
    args = {}
    if resume:
        state, nxt = tr.resume()
        cfg.train.epochs = nxt
        if logger is not None:
            logger.truncate_from(nxt)
        args = {"state": state, "start_epoch": nxt}
    else:
        train.set_epoch(0)
    torch.cuda.synchronize()
    with residual_opt_in(residual):
        reset()
        res = tr.fit(**args)
        torch.cuda.synchronize()
        launches = read()
    epochs = len(res["history"]["train"])
    steps, vals = epochs * len(train), epochs * len(val)
    want = {"vit_block_fwd": 12 * vals, "vit_block_bwd": 0,
            "vit_block_res_fwd": 0, "vit_block_bwd_res": 0,
            "augment": steps}
    if residual:
        want.update(vit_block_res_fwd=12 * steps, vit_block_bwd_res=12 * steps)
    else:
        want.update(vit_block_fwd=12 * (steps + vals),
                    vit_block_bwd=12 * steps)
    if launches != want:
        raise RuntimeError(f"fit (opt-in {residual}) launches {launches}, "
                           f"want {want}")
    for part in ("train", "val"):
        for m in res["history"][part]:
            if not np.isfinite(m["total_loss"]):
                raise RuntimeError(f"fit: non-finite {part} loss {m}")
    return tr, res, launches


def fit_phase(smi: str):
    """The saved-residual pair's kernels, a train step held through it, and
    ``Trainer.fit`` with its data, checkpoints and logger (module
    docstring, phase 8)."""
    from pathlib import Path

    from rovit_kan_tpu_torch.data.dataset import Subset
    from rovit_kan_tpu_torch.data.device_cache import DeviceLoader
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops.mixing import draw_mix
    from rovit_kan_tpu_torch.results.logger import CSV_COLUMNS, \
        ExperimentLogger
    from rovit_kan_tpu_torch.serving import InferenceEngine, load_engine
    from rovit_kan_tpu_torch.training.trainer import Trainer
    from rovit_kan_tpu_torch.utils.checkpoint import is_finalized

    kernels = {}
    for seed, (batch, tokens, dtype) in enumerate(
            ((BATCH, TOKENS, torch.bfloat16), (BATCH, TOKENS, torch.float32),
             (LONG_BATCH, LONG_TOKENS, torch.bfloat16),
             (LONG_BATCH, LONG_TOKENS, torch.float32))):
        kernels[tokens, dtype] = check_block_res(dtype, 40 + seed, batch,
                                                 tokens)

    cfg = fit_config(Path("."))
    held = hold_residual_step(cfg, train_batch(cfg, 500), {
        "factors": ak.draw_factors(torch.Generator("cuda").manual_seed(7),
                                   BATCH),
        "mix": draw_mix(torch.Generator().manual_seed(8), BATCH,
                        cfg.data.image_size, cfg.data.image_size)})

    t0 = time.perf_counter()
    ds = LeafSet(FIT_PER_CLASS, cfg.data.image_size, seed=0)
    order = np.random.RandomState(42).permutation(len(ds))
    n_train = int(round(len(ds) * cfg.data.train_val_split))
    loaders = (DeviceLoader(Subset(ds, order[:n_train]), BATCH, shuffle=True,
                            drop_last=True, seed=42, device="cuda"),
               DeviceLoader(Subset(ds, order[n_train:]), BATCH,
                            device="cuda"))
    data_s = time.perf_counter() - t0
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    try:
        # The main path: fit with the opt-in, resume, serve.
        cfg = fit_config(root / "residual")
        logger = ExperimentLogger(root / "residual" / "logs", "fit")
        tr, res, launches = run_fit(cfg, loaders, True, logger)
        with open(logger.csv_path) as f:
            header, *rows = [ln.strip().split(",") for ln in f]
        best = cfg.paths.checkpoints_dir / "best_model"
        if header != CSV_COLUMNS or len(rows) != 4 or not is_finalized(best):
            raise RuntimeError(f"fit wrote {len(rows)} CSV rows under "
                               f"{header}; best_model finalized: "
                               f"{is_finalized(best)}")
        tr2, res2, resume_launches = run_fit(cfg, loaders, True, logger,
                                             resume=True)
        reset, read = fit_counters()
        engine = load_engine(best, batch_size=BATCH, device="cuda")
        images = ds.images[order[n_train:]]
        reset()
        served = [engine.predict(images[i * BATCH:(i + 1) * BATCH])
                  for i in range(2)]
        serve_launches = read()
        if serve_launches["vit_block_fwd"] != 24 or sum(
                serve_launches.values()) != 24:
            raise RuntimeError(f"load_engine served with {serve_launches}")
        ref_model = build_model(cfg, inference=True, device="cuda", seed=2)
        ref_model.load_state_dict(Trainer.eval_params(res2["best_state"]))
        ref = InferenceEngine(ref_model, batch_size=BATCH, device="cuda")
        expect = [ref.predict(images[i * BATCH:(i + 1) * BATCH])
                  for i in range(2)]
        differ = sorted({k for a, b in zip(served, expect) for k in a
                         if not np.array_equal(a[k], b[k])})
        if differ:
            raise RuntimeError(f"load_engine outputs {differ} differ from "
                               f"the trainer's best weights")

        # The epoch img/s of both arms, in turns.
        arms = {"residual": [], "recompute": []}
        for i, on in enumerate((False, True, False, True)):
            arm_cfg = fit_config(root / f"arm{i}")
            _, arm, arm_launches = run_fit(arm_cfg, loaders, on)
            arms["residual" if on else "recompute"].append(
                {"epoch_images_per_sec": [m["images_per_sec"] for m in
                                          arm["history"]["train"]],
                 "launches": arm_launches})
        # One profiled step of the fit's train step on each arm.
        batch = loaders[0].gather(torch.arange(BATCH, device="cuda"))
        step_profiles = {}
        for on in (True, False):
            with residual_opt_in(on):
                step_profiles["residual" if on else "recompute"] = \
                    profile_step(tr.train_step, batch)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def hist(r):
        return [{"stage": t["stage"], "lr": t["lr"],
                 "train_loss": t["total_loss"], "val_loss": v["total_loss"],
                 "val_accuracy": v["accuracy"],
                 "images_per_sec": t["images_per_sec"]}
                for t, v in zip(r["history"]["train"], r["history"]["val"])]

    return {"phase": "fit", "model": "DeiT-Tiny RoViT-KAN d=192 depth=12 "
            "heads=3 224px bf16, batch 64, Trainer.fit over a "
            "device-resident synthetic set", "images": len(ds),
            "train_images": n_train, "val_images": len(ds) - n_train,
            "data_seconds": data_s,
            "steps_per_epoch": len(loaders[0]),
            "val_batches_per_epoch": len(loaders[1]),
            "residual_kernels": {
                f"{n}_{str(d).replace('torch.', '')}": r
                for (n, d), r in kernels.items()},
            "held_step": held, "fit_launches": launches,
            "fit_history": hist(res), "best_val_loss": res["best_val_loss"],
            "resume_launches": resume_launches,
            "resume_history": hist(res2),
            "serve_launches": serve_launches,
            "served_equals_best_weights": True,
            "arms_in_turns": arms, "step_profiles": step_profiles,
            "card": smi}, kernels


EVAL_AUG_PER_CLASS = 48     # 192 images: 154 train (2 steps), 38 validation
EVAL_TEST_PER_CLASS = 25    # 100 test images: 2 batches, the second 36 valid
FPS_FORWARDS = 110          # fps_benchmark: 10 warm-up + 100 timed


def run_cli(fn, argv):
    """``fn(argv)`` between a launch-counter reset and a read, its printing
    kept off the smoke's output; returns its result, the launches, the
    seconds and what it printed."""
    reset, read = fit_counters()
    out = io.StringIO()
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = fn([str(a) for a in argv])
    torch.cuda.synchronize()
    return result, read(), time.perf_counter() - t0, out.getvalue()


def check_launches(what: str, got: dict, fwd: int, bwd: int = 0,
                   augment: int = 0) -> None:
    want = {"vit_block_fwd": fwd, "vit_block_bwd": bwd,
            "vit_block_res_fwd": 0, "vit_block_bwd_res": 0,
            "augment": augment}
    if got != want:
        raise RuntimeError(f"{what} launches {got}, want {want}")


def check_fps(what: str, metrics: dict) -> float:
    fps = metrics.get("fps")
    if "fps_error" in metrics or not (fps is not None and np.isfinite(fps)
                                      and fps > 0):
        raise RuntimeError(f"{what}: fps {fps}, {metrics.get('fps_error')}")
    return fps


def eval_phase(smi: str):
    """The train CLI -> evaluate CLI -> ``load_engine`` loop on the flagship
    (module docstring, phase 9)."""
    from pathlib import Path

    from rovit_kan_tpu_torch.cli import evaluate as cli_evaluate
    from rovit_kan_tpu_torch.cli import train as cli_train
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.data.dataset import Loader, RoseLeafDataset
    from rovit_kan_tpu_torch.data.synthetic import generate_synthetic_dataset
    from rovit_kan_tpu_torch.evaluation.evaluator import (
        Evaluator,
        load_model_for_evaluation,
    )
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.serving import load_engine
    from rovit_kan_tpu_torch.utils.checkpoint import is_finalized, load_meta

    cfg = Config()
    size = cfg.data.image_size
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_eval_"))
    try:
        t0 = time.perf_counter()
        data = root / "data"
        generate_synthetic_dataset(data / "Augmented Image",
                                   n_per_class=EVAL_AUG_PER_CLASS, size=size,
                                   seed=42)
        generate_synthetic_dataset(data / "Original Image",
                                   n_per_class=EVAL_TEST_PER_CLASS, size=size,
                                   seed=43)
        data_s = time.perf_counter() - t0

        # The train CLI: 2 epochs of 2 steps and 1 validation batch, then
        # the Evaluator's 2 test batches and its bs=1 FPS forwards.
        out = root / "train"
        metrics, train_launches, train_s, _ = run_cli(cli_train.main, [
            "--data_root", data, "--output_dir", out, "--epochs", 2,
            "--batch_size", BATCH])
        with open(out / "logs" / "train_epochs.csv") as f:
            header, *rows = [ln.strip().split(",") for ln in f]
        best = out / "checkpoints" / "best_model"
        if not (rows and is_finalized(best)
                and (out / "results" / "test_metrics.json").exists()):
            raise RuntimeError(f"train CLI wrote {len(rows)} CSV rows; "
                               f"best_model finalized: {is_finalized(best)}")
        losses = [float(r[header.index(c)]) for r in rows for c in header
                  if c.endswith("_loss")]
        if not np.all(np.isfinite(losses)):
            raise RuntimeError(f"train CLI: non-finite losses {losses}")
        steps, vals, tests = 2 * len(rows), len(rows), 2
        check_launches("train CLI", train_launches,
                       12 * (steps + vals + tests + FPS_FORWARDS),
                       12 * steps, steps)
        train_fps = check_fps("train CLI", metrics)

        # The evaluate CLI, host metrics, with the temperature stored.
        sidecar = best.parent / "best_model.meta.json"
        before = sidecar.read_bytes()
        host_out = root / "eval_host"
        ev, host_launches, host_s, printed = run_cli(cli_evaluate.main, [
            "--checkpoint", best, "--data_root", data, "--output_dir",
            host_out, "--batch_size", BATCH, "--calibrate",
            "--store_temperature", "--device_metrics", "off"])
        check_launches("evaluate CLI (host metrics)", host_launches,
                       12 * (1 + tests + FPS_FORWARDS))
        host = json.loads((host_out / "test_metrics.json").read_text())
        eval_fps = check_fps("evaluate CLI", host)
        t, degenerate = ev.temperature, ev.temperature_degenerate
        engine = load_engine(best, batch_size=BATCH, device="cuda")
        if degenerate:
            case = "degenerate fit refused, sidecar unchanged"
            ok = (sidecar.read_bytes() == before
                  and "Refusing --store_temperature" in printed
                  and engine.stats()["temperature"] == 1.0)
        else:
            case = "stored, and load_engine serves with it"
            ok = (load_meta(best).get("temperature") == t
                  and host["temperature"] == t
                  and engine.stats()["temperature"] == t)
        if not ok:
            raise RuntimeError(f"temperature {t} (degenerate {degenerate}): "
                               f"sidecar {load_meta(best).get('temperature')},"
                               f" engine {engine.stats()['temperature']}")
        reset, read = fit_counters()
        with contextlib.redirect_stdout(io.StringIO()):
            test_ds = RoseLeafDataset(data / "Original Image",
                                      cfg.data.class_names,
                                      cfg.data.severity_map, image_size=size)
        images = np.stack([test_ds[i][0] for i in range(BATCH)])
        reset()
        served = engine.predict(images)
        serve_launches = read()
        check_launches("load_engine", serve_launches, 12)
        if not (np.isfinite(served["cls_probs"]).all() and np.allclose(
                served["cls_probs"].sum(-1), 1.0, atol=1e-5)):
            raise RuntimeError("load_engine served non-finite probabilities")

        # The evaluate CLI, device metrics, at the same temperature.
        dev_out = root / "eval_device"
        ev2, dev_launches, dev_s, _ = run_cli(cli_evaluate.main, [
            "--checkpoint", best, "--data_root", data, "--output_dir",
            dev_out, "--batch_size", BATCH, "--calibrate",
            "--device_metrics", "on"])
        check_launches("evaluate CLI (device metrics)", dev_launches,
                       12 * (1 + tests))
        dev = json.loads((dev_out / "test_metrics_device.json").read_text())
        gaps = {k: abs(dev[k] - host[k]) for k in
                ("accuracy", "macro_f1", "mae", "spearman_rho",
                 "brier_score", "ece")}
        # The device path computes in fp32 (as the JAX one does), the host
        # in fp64: the counts agree exactly, accuracy to the fp32 rounding
        # of the same quotient, macro F1 to its fp32 arithmetic.
        if (ev2.temperature != t
                or dev["confusion_matrix"] != host["confusion_matrix"]
                or np.float32(dev["accuracy"]) != np.float32(host["accuracy"])
                or gaps["macro_f1"] > 1e-6 or max(gaps.values()) > 1e-5):
            raise RuntimeError(f"device metrics differ from the host path: "
                               f"{gaps}, T {ev2.temperature} vs {t}")

        # One Evaluator on the same weights through #1, the plain block and
        # the fp32 model; its collected outputs held as served ones.
        loader = Loader(test_ds, BATCH)
        model, state = load_model_for_evaluation(best, device="cuda")
        kernel_ev = Evaluator(model, state, loader, cfg)
        kernel_ev._collect()                  # decodes and caches the set
        pass_s = []
        reset()
        for _ in range(3):
            t0 = time.perf_counter()
            d = kernel_ev._collect()
            pass_s.append(time.perf_counter() - t0)
        collect_launches = read()
        check_launches("Evaluator", collect_launches, 3 * 12 * tests)
        # Where the time of a test pass and of a bs=1 FPS forward goes:
        # device operations and device time per call against the wall time.
        one = torch.zeros((1, size, size, 3), dtype=torch.uint8,
                          device=kernel_ev.device)
        kernel_fps = kernel_ev._fps()
        profiles = {}
        for name, fn, calls, wall_s in (
                ("test_pass", kernel_ev._collect, 3,
                 statistics.median(pass_s)),
                ("fps_forward", lambda: kernel_ev._forward(one), 20,
                 1.0 / kernel_fps)):
            ops = profile_device(fn, calls)
            device_ms = sum(ms for _, ms in ops.values()) / calls
            profiles[name] = {
                "device_ops": sum(n for n, _ in ops.values()) / calls,
                "device_ms": device_ms, "wall_ms": 1e3 * wall_s,
                "device_busy_share": device_ms / (1e3 * wall_s),
                "top": top_kernels({k: ms / calls
                                    for k, (_, ms) in ops.items()})}
        plain_cfg = copy.deepcopy(cfg)
        plain_cfg.tpu.use_pallas_block = False
        refs = {}
        for name, ref_cfg, dtype in (("plain", plain_cfg, None),
                                     ("exact", cfg, torch.float32)):
            ref_model = build_model(ref_cfg, dtype=dtype, inference=True,
                                    device="cuda")
            reset()
            refs[name] = Evaluator(ref_model, state, loader, cfg)._collect()
            check_launches(f"Evaluator ({name})", read(), 0)

        def as_served(arr):
            return {"cls_probs": arr["probs"],
                    "cls_pred": arr["probs"].argmax(1),
                    "kan_severity": arr["severity_pred"],
                    "uncertainty_std": arr["uncertainty"]}

        checks, failed = hold_served(
            as_served(d), as_served(refs["plain"]), as_served(refs["exact"]),
            keys=("cls_probs", "uncertainty_std", "kan_severity"))
        if failed:
            emit({"phase": "eval", "outputs": checks})
            raise RuntimeError(f"evaluated outputs out of tolerance: "
                               f"{failed}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    n_test = int(d["labels"].size)
    return {"phase": "eval", "model": "DeiT-Tiny RoViT-KAN d=192 depth=12 "
            "heads=3 224px bf16, batch 64: cli.train -> cli.evaluate -> "
            "load_engine over a synthetic JPEG tree",
            "images": {"augmented": 4 * EVAL_AUG_PER_CLASS,
                       "test": n_test},
            "data_seconds": data_s,
            "train_cli": {"seconds": train_s, "epochs": len(rows),
                          "launches": train_launches, "fps_bs1": train_fps,
                          "test_accuracy": metrics["accuracy"],
                          "losses_finite": True},
            "evaluate_cli_host": {"seconds": host_s,
                                  "launches": host_launches,
                                  "fps_bs1": eval_fps,
                                  "ece": host["ece"],
                                  "ece_precalibration":
                                      host.get("ece_precalibration")},
            "evaluate_cli_device": {"seconds": dev_s,
                                    "launches": dev_launches,
                                    "gaps_vs_host": gaps},
            "temperature": t, "temperature_degenerate": degenerate,
            "temperature_case": case,
            "serve_launches": serve_launches,
            "evaluator_launches": collect_launches,
            "test_pass_seconds": pass_s,
            "eval_images_per_sec": n_test / statistics.median(pass_s),
            "fps_bs1": eval_fps, "fps_bs1_evaluator": kernel_fps,
            "profiles": profiles,
            "held_vs_plain_block": checks, "card": smi}


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
    ptxas = {src: ptxas_table(log) for src, log in logs.items()}
    emit({"phase": "build", "sources": sorted(logs),
          "seconds": time.perf_counter() - t0, "ptxas": ptxas})
    spilled = [row for src in ("vit_block_fwd", "vit_block_bwd_f32")
               for row in ptxas[src]
               if row[0].startswith(MAIN_PATH_TF32) and row[2]]
    kan_rows = [row for row in ptxas["kan_module"]
                if row[0].startswith(MAIN_PATH_KAN)]
    if len(kan_rows) != 4:
        raise RuntimeError(f"want 4 main-path KAN instances, ptxas lists "
                           f"{kan_rows}")
    spilled += [row for row in kan_rows
                if row[2] > KAN_SPILL_BYTES.get(row[0], 0)]
    if spilled:
        raise RuntimeError(f"main-path instances spill: {spilled}")

    bf16 = check_block(torch.bfloat16, seed=0)
    fp32 = check_block(torch.float32, seed=1)
    bwd16 = check_block_bwd(torch.bfloat16, seed=2)
    bwd32 = check_block_bwd(torch.float32, seed=3)
    aug = augment_checks()
    aug16, aug32 = aug["bf16"], aug["fp32"]
    kan = check_kan(seed=6)
    kan_widths = kan.pop("kan_layer_widths")
    emit({"phase": "kernels", "vit_block_fwd": [bf16, fp32],
          "vit_block_bwd": [bwd16, bwd32],
          "augment": [aug16, aug32, aug["n384"], *aug["odd"]], **kan,
          "card": smi})
    emit({"phase": "kan_layer_widths", "layers": kan_widths, "card": smi})

    result = serve(smi)
    emit(result)
    trained = train(smi)
    emit(trained)
    kanned = kan_phase(smi)
    emit(kanned)
    longed, attn, blocks577 = long_phase(smi)
    emit(longed)
    fitted, res_kernels = fit_phase(smi)
    emit(fitted)
    evaled = eval_phase(smi)
    emit(evaled)

    keys = ("max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "library_ms")

    def entry(name, source, replaces, launches, lo, hi, more=(), **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": lo["max_abs_err"], "ms": lo["kernel_ms"],
                "plain_ms": lo["plain_ms"], "bound_ms": lo["bound_ms"],
                "bound_by": lo["bound_by"], "library_ms": lo["library_ms"],
                **{k: lo[k] for k in more}, **extra,
                "fp32": {k: hi[k] for k in keys + more}}

    # Beside the common keys: #1's and #3's graph-replay device times and
    # #1's stages; #2's and #4's graph times, their stages beside the
    # stages' bounds, and the layer's forward + backward and its backward
    # alone by profiler device time.
    more1 = ("kernel_graph_ms", "library_graph_ms", "stages_device_ms",
             "stages_bound_ms")
    more2 = ("kernel_graph_ms", "stages_device_ms", "stages_bound_ms",
             "library_device_ms", "library_bwd_device_ms",
             "port_fwd_bwd_device_ms")
    more3 = ("kernel_graph_ms", "library_graph_ms")
    more4 = ("kernel_graph_ms", "stages_device_ms", "stages_bound_ms",
             "library_device_ms", "library_bwd_device_ms")
    # #7's graph-replay and per-launch profiler device times.
    more7 = ("kernel_graph_ms", "device_ms_by_kernel")

    csrc = "rovit_kan_tpu_torch/csrc/"

    def kan_entry(name, line, r, phase):
        by_path = {"serve": phase["serve_launches"][name],
                   "trajectory": phase["trajectory_launches"][name],
                   "train": phase["train_launches"][name]}
        return {"name": name, "route": "cuda",
                "source": csrc + "kan_module.cu",
                "replaces": f"rovit_kan_tpu/ops/kan_kernel.py:{line}",
                "launches": sum(by_path.values()),
                "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                "kernel_graph_ms": r["kernel_graph_ms"],
                "launch_floor_ms": r["launch_floor_ms"],
                "call_ms": r["call_ms"], "plain_call_ms": r["plain_call_ms"],
                "launches_by_path": by_path}

    def n577(i, more):
        return {str(d).replace("torch.", ""):
                {k: r[i][k] for k in keys + more}
                for d, r in blocks577.items()}

    def long_launches(name):
        by_path = {path: longed[path]["launches"][name] for path in (
            "serve_auto", "serve_attention", "train_attention",
            "train_auto")}
        fp32 = longed["fp32_attention_arm"]["launches"]
        by_path.update({"serve_attention_fp32": fp32["serve"][name],
                        "train_attention_fp32": fp32["train"][name]})
        return by_path

    # Beside the common keys: the graph-replay device times, the route, and
    # SDPA's kernels; for #6 also SDPA's forward + backward, its training
    # forward and its backward alone, and the port's #5 + #6 under
    # autograd, by CUDA-graph replay.
    attn_more = (("kernel_graph_ms", "library_graph_ms", "design",
                  "device_source", "library_kernels"),
                 ("kernel_graph_ms", "design", "device_source",
                  "library_device_ms", "library_fwd_device_ms",
                  "library_bwd_device_ms", "library_kernels",
                  "port_fwd_bwd_ms", "port_fwd_bwd_device_ms",
                  "port_bwd_device_ms"))

    def attn_entry(name, line, i):
        by_path = long_launches(name)
        lo = attn[LONG_TOKENS, torch.bfloat16][i]
        hi = attn[LONG_TOKENS, torch.float32][i]
        more = attn_more[i]
        out = entry(name, csrc + "attention.cu",
                    f"rovit_kan_tpu/ops/attention.py:{line}",
                    sum(by_path.values()), lo, hi, more,
                    launches_by_path=by_path, library=lo["library"],
                    n197={str(d).replace("torch.", ""):
                          {k: attn[TOKENS, d][i][k] for k in keys + more}
                          for d in (torch.bfloat16, torch.float32)})
        out["fp32"]["fma_bound_ms"] = hi["fma_bound_ms"]
        out["n197"]["float32"]["fma_bound_ms"] = \
            attn[TOKENS, torch.float32][i]["fma_bound_ms"]
        return out

    def res_entry(name, source, line, i):
        by_path = {"fit": fitted["fit_launches"][name],
                   "resume": fitted["resume_launches"][name]}
        lo = res_kernels[TOKENS, torch.bfloat16][i]
        more = more3 if i == 0 else more4
        return entry(name, csrc + source,
                     f"rovit_kan_tpu/ops/block_kernel.py:{line}",
                     sum(by_path.values()), lo,
                     res_kernels[TOKENS, torch.float32][i], more,
                     launches_by_path=by_path,
                     n577={str(d).replace("torch.", ""):
                           {k: res_kernels[LONG_TOKENS, d][i][k]
                            for k in keys + more}
                           for d in (torch.bfloat16, torch.float32)},
                     **({k: lo[k] for k in ("port_fwd_bwd_ms",
                                              "port_fwd_bwd_device_ms")}
                        if i else {}))

    fwd1 = entry("vit_block_fwd", csrc + "vit_block_fwd.cu",
                 "rovit_kan_tpu/ops/block_kernel.py:92",
                 result["block_launches"], bf16, fp32, more1,
                 train_launches=trained["launches"]["vit_block_fwd"],
                 long_launches=long_launches("vit_block_fwd"),
                 eval_launches={
                     path: evaled[path]["launches"]["vit_block_fwd"]
                     for path in ("train_cli", "evaluate_cli_host",
                                  "evaluate_cli_device")} | {
                     "load_engine": evaled["serve_launches"]["vit_block_fwd"],
                     "evaluator": evaled["evaluator_launches"][
                         "vit_block_fwd"]},
                 n577=n577(0, more1))
    fwd3 = res_entry("vit_block_res_fwd", "vit_block_fwd.cu", 227, 0)
    # The fp32 #1 and #3 run 3xTF32: their FMA bound beside the bound.
    fwd1["fp32"]["fma_bound_ms"] = fp32["fma_bound_ms"]
    fwd1["n577"]["float32"]["fma_bound_ms"] = \
        blocks577[torch.float32][0]["fma_bound_ms"]
    fwd3["fp32"]["fma_bound_ms"] = \
        res_kernels[TOKENS, torch.float32][0]["fma_bound_ms"]
    fwd3["n577"]["float32"]["fma_bound_ms"] = \
        res_kernels[LONG_TOKENS, torch.float32][0]["fma_bound_ms"]
    emit({"kernels": [
        fwd1,
        entry("vit_block_bwd", csrc + "vit_block_bwd.cu",
              "rovit_kan_tpu/ops/block_kernel.py:399",
              trained["launches"]["vit_block_bwd"], bwd16, bwd32, more2,
              port_fwd_bwd_ms=bwd16["port_fwd_bwd_ms"],
              long_launches=long_launches("vit_block_bwd"),
              n577=n577(1, more2)),
        entry("augment", csrc + "augment.cu",
              "rovit_kan_tpu/ops/augment_kernel.py:73",
              trained["launches"]["augment"], aug16, aug32, more7,
              n384={k: aug["n384"][k] for k in keys + more7},
              odd=aug["odd"])] + [
        kan_entry(name, line, kan[name], kanned)
        for name, line in (("kan_layer_fwd", 48), ("kan_layer_bwd", 129),
                           ("kan_module_fwd", 252),
                           ("kan_module_bwd", 367))] + [
        attn_entry("attention_fwd", 36, 0),
        attn_entry("attention_bwd", 120, 1)] + [
        fwd3,
        res_entry("vit_block_bwd_res", "vit_block_bwd.cu", 549, 1)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
