"""KAN layer and whole KAN head: the CUDA kernels' wrappers and their plain
versions.

Counterpart of ``rovit_kan_tpu/ops/kan_kernel.py``. Its four TPU kernels are
replaced on Hopper by the two cluster kernels of ``csrc/kan_module.cu`` (its
source note says what bounds them and how they are tiled), which split every
width across a cluster's CTAs (``module_plan``):

- ``_kan_module_kernel`` (#10) and ``_kan_module_bwd_kernel`` (#11): the
  whole stack, ReLU between layers and ``3 * sigmoid`` at the end (the
  plan's head), and its recompute backward;
- ``_kan_kernel`` (#8) and ``_kan_layer_bwd_kernel`` (#9): one KAN layer
  ``x W_lin^T + b + sum_k basis_k(tanh x) S[:, :, k]`` and its gradient, as
  the same kernels on a one-layer plan without the head: no squash, and a
  backward that takes ``g`` as its top gradient and recomputes no forward.

Everything is fp32 and every product true fp32 (the TPU kernels run at
``Precision.HIGHEST``). The functions take the port's parameter layouts as
they are: ``spline_weights`` ``(in, out, K)``, the ``nn.Linear`` weight
``(out, in)`` and the bias ``(out,)``; the gradients come back in those
layouts. A CPU tensor runs the plain versions (the backward is the
hand-written gradient, not autograd); a CUDA tensor launches the kernels or
raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from rovit_kan_tpu_torch.ops.spline import (
    bspline_basis_and_deriv_list,
    bspline_basis_list,
    matmul_fp32,
)

#: Launches of the whole-module forward (#10) since import (one per wrapper
#: call on a CUDA tensor). The CPU path never touches it.
LAUNCHES = 0
#: Launches of the whole-module backward (#11), counted the same way (one per
#: call: one kernel launch while the batch fits one row group; past it, one
#: a wave of at most ``BWD_SLOTS`` clusters and one that adds the slots'
#: weight gradients).
BWD_LAUNCHES = 0
#: Launches of the one-layer forward (#8).
LAYER_LAUNCHES = 0
#: Launches of the one-layer backward (#9).
LAYER_BWD_LAUNCHES = 0

# What csrc/kan_common.cuh holds (its kMax* constants).
MAX_LAYERS, MAX_BASIS, MAX_IN, MAX_OUT = 4, 10, 1024, 256
# What csrc/kan_module.cu's plans may use: CTAs of a cluster (16 is
# Hopper's non-portable most), rows of a group, shared floats of a CTA.
CLUSTER, FWD_ROWS, BWD_ROWS = 16, 16, 64
# Rows of a group of #9 (the backward without the head): at (64, 192 -> 64)
# on an H100, 16 rows (four clusters, then the slots' ordered add) ran
# faster than 32 or 64 (one cluster, whose CTAs evaluate their bases in two
# rounds); chip_smoke.py::kan_layer_bwd_rows times the three.
LAYER_BWD_ROWS = 16
SLAB_FLOATS, SMEM_FLOATS = 8192, 232448 // 4
# #11's clusters a launch at most: its CTAs take one SM each, so 8 clusters
# of 16 fill an H100's 132 SMs; each keeps one fp32 copy of the weight
# gradients, so their memory is bounded whatever the batch.
BWD_SLOTS = 8


# ------------------------------------------------------------------ plain

def kan_layer_reference(x: torch.Tensor, spline_weights: torch.Tensor,
                        weight: torch.Tensor, bias: torch.Tensor,
                        knots: np.ndarray, degree: int = 3) -> torch.Tensor:
    """Plain version of #8, in the shape of ``_kan_kernel``: the dense
    product plus the bias, then one product per basis, all fp32."""
    basis = bspline_basis_list(torch.tanh(x), knots, degree)
    acc = matmul_fp32(x, weight.t()) + bias
    for k, bk in enumerate(basis):
        acc = acc + matmul_fp32(bk, spline_weights[:, :, k])
    return acc


def kan_layer_backward_reference(x: torch.Tensor, g: torch.Tensor,
                                 spline_weights: torch.Tensor,
                                 weight: torch.Tensor, knots: np.ndarray,
                                 degree: int = 3):
    """Plain version of #9, in the shape of ``_kan_layer_bwd_kernel``:
    ``dS[:, :, k] = basis_k^T g``, ``dW = g^T x``, ``db = sum g``,
    ``dx = g W + (sum_k (g S_k^T) basis'_k(t)) (1 - t^2)``.

    Returns ``(dx, d_spline_weights, d_weight, d_bias)``."""
    t = torch.tanh(x)
    basis, dbasis = bspline_basis_and_deriv_list(t, knots, degree)
    d_bias = g.sum(0)
    d_weight = matmul_fp32(g.t(), x)
    d_spline = torch.stack([matmul_fp32(bk.t(), g) for bk in basis], dim=-1)
    dspl = torch.zeros_like(x)
    for k in range(len(basis)):
        dspl = dspl + matmul_fp32(g, spline_weights[:, :, k].t()) * dbasis[k]
    dx = matmul_fp32(g, weight) + dspl * (1.0 - t * t)
    return dx, d_spline, d_weight, d_bias


def kan_module_reference(x: torch.Tensor, params: Sequence[torch.Tensor],
                         knots: np.ndarray, degree: int = 3) -> torch.Tensor:
    """Plain version of #10: the layers of ``params`` (flat
    ``(spline_weights, weight, bias)`` per layer), ReLU between them,
    ``3 * sigmoid`` at the end."""
    n = len(params) // 3
    for layer in range(n):
        x = kan_layer_reference(x, *params[3 * layer:3 * layer + 3], knots,
                                degree)
        if layer < n - 1:
            x = torch.relu(x)
    return 3.0 * torch.sigmoid(x)


def kan_module_backward_reference(x: torch.Tensor, g: torch.Tensor,
                                  params: Sequence[torch.Tensor],
                                  knots: np.ndarray, degree: int = 3):
    """Plain version of #11, in the shape of ``_kan_module_bwd_kernel``:
    recompute the forward keeping each layer's input and pre-activation,
    then walk back through ``3 * sigmoid'``, each layer's gradient and
    ``relu'`` (0 at 0).

    Returns ``(dx, grads)`` with ``grads`` flat like ``params``."""
    n = len(params) // 3
    hs, accs = [x], []
    for layer in range(n):
        acc = kan_layer_reference(hs[-1], *params[3 * layer:3 * layer + 3],
                                  knots, degree)
        accs.append(acc)
        hs.append(torch.relu(acc) if layer < n - 1 else acc)
    sig = torch.sigmoid(accs[-1])
    gcur = g * 3.0 * sig * (1.0 - sig)
    grads: List[torch.Tensor] = [None] * (3 * n)
    for layer in range(n - 1, -1, -1):
        dh, ds, dw, db = kan_layer_backward_reference(
            hs[layer], gcur, params[3 * layer], params[3 * layer + 1], knots,
            degree)
        grads[3 * layer:3 * layer + 3] = [ds, dw, db]
        # relu'(0) = 0 for the ReLU that made this layer's input.
        gcur = dh * (accs[layer - 1] > 0).to(dh.dtype) if layer else dh
    return gcur, grads


# ------------------------------------------------------------------ plan

class ModulePlan(NamedTuple):
    """How #10 (``backward=False``) or #11 splits a batch (#8 and #9 with
    ``head`` off): ``groups`` row groups of ``rows`` batch rows (the last
    group's rows past the batch are padding), a cluster of ``cluster`` CTAs
    each; the backward runs them in waves of ``slots`` clusters, cluster s
    of each wave adding its group's weight gradients into slot s (so slot
    s sums groups s, s + slots, ... in order), and then adds the slots in
    order; rank j of a cluster owns
    ``bounds[d][j]:bounds[d][j + 1]`` of width ``d`` (layer d's inputs,
    layer d - 1's outputs) and stages its slice of layer l's weights
    ``chunk[l]`` inputs at a time; ``smem_floats`` is a CTA's shared
    memory, as ``csrc/kan_module.cu::make_plan`` lays it out. With
    ``reciprocal_basis`` the basis recursion divides through a table of
    reciprocals where that gives the same bits (the source note says
    where); without it every division is ``__fdiv_rn``. With ``head`` the
    last layer ends in ``3 * sigmoid`` (#10/#11); without it (one layer
    only) the forward writes the pre-activation and the backward takes the
    upstream gradient as its top gradient (#8/#9)."""
    rows: int
    cluster: int
    groups: int
    slots: int
    smem_floats: int
    chunk: Tuple[int, ...]
    bounds: Tuple[Tuple[int, ...], ...]
    reciprocal_basis: bool = True
    head: bool = True

    def ints(self) -> List[int]:
        """The plan as the C entry points take it."""
        chunk = list(self.chunk) + [0] * (MAX_LAYERS - len(self.chunk))
        return [self.rows, self.cluster, self.groups, self.slots,
                self.smem_floats, int(self.reciprocal_basis), int(self.head),
                *chunk, *(b for d in self.bounds for b in d)]


def _smem_floats(rows, widest, chunk, dims, k1p, backward) -> int:
    """A CTA's shared floats: features (and #11's basis derivatives) of the
    rank's slices, two weight chunks, two partial-sum buffers, and (#11) two
    gradient slices and each layer's gathered output gradient."""
    n_layers = len(dims) - 1
    feat = sum(widest[l] * k1p * rows for l in range(n_layers))
    slab = max(chunk[l] * k1p * dims[l + 1] for l in range(n_layers))
    total = feat * (2 if backward else 1) + 2 * slab \
        + 2 * (rows + 4) * max(dims[1:])
    if backward:
        total += 2 * rows * max(widest[1:]) + (rows + 4) * sum(dims[1:])
    return total


@functools.lru_cache(maxsize=None)
def module_plan(B: int, dims: Tuple[int, ...], n_basis: int,
                backward: bool, head: bool = True) -> ModulePlan:
    """The launch plan of #10/#11 (#8/#9 without ``head``, one layer only)
    for a batch of ``B`` rows through a head of widths ``dims``: every width
    split into ``CLUSTER`` contiguous slices, ``FWD_ROWS`` / ``BWD_ROWS``
    (``LAYER_BWD_ROWS`` without the head) rows a group (fewer for a small
    batch, or where a CTA's shared memory would not hold the features of
    that many rows), each layer's weight chunk at most ``SLAB_FLOATS``; the
    backward's waves at most ``BWD_SLOTS`` clusters (the forward's
    ``slots`` is its groups: one launch)."""
    dims = tuple(int(d) for d in dims)
    if not head and len(dims) != 2:
        raise ValueError(f"a plan without the head takes one layer, got "
                         f"widths {list(dims)}")
    k1p = (n_basis + 4) // 4 * 4
    c = CLUSTER
    bounds = tuple(tuple(j * d // c for j in range(c + 1)) for d in dims)
    widest = [max(b[j + 1] - b[j] for j in range(c)) for b in bounds]
    chunk = tuple(min(widest[l], max(1, SLAB_FLOATS // (dims[l + 1] * k1p)))
                  for l in range(len(dims) - 1))
    most = (BWD_ROWS if head else LAYER_BWD_ROWS) if backward else FWD_ROWS
    rows = min(most, -(-B // 8) * 8)
    while _smem_floats(rows, widest, chunk, dims, k1p, backward) \
            > SMEM_FLOATS and rows > 8:
        rows = max(8, rows // 16 * 8)
    if _smem_floats(rows, widest, chunk, dims, k1p, backward) > SMEM_FLOATS:
        raise ValueError(f"no plan fits KAN widths {list(dims)}")
    groups = -(-B // rows)
    return ModulePlan(rows, c, groups,
                      min(groups, BWD_SLOTS) if backward else groups,
                      _smem_floats(rows, widest, chunk, dims, k1p, backward),
                      chunk, bounds, head=head)


# --------------------------------------------------------------- kernels

def _layer_dims(params: Sequence[torch.Tensor]) -> List[int]:
    dims = [int(params[0].shape[0])]
    for layer in range(len(params) // 3):
        dims.append(int(params[3 * layer].shape[1]))
    return dims


def _check_cuda_args(x: torch.Tensor, params: Sequence[torch.Tensor],
                     knots: np.ndarray, degree: int) -> List[int]:
    """What the kernels take; returns the layer widths."""
    if x.dim() != 2 or not x.is_contiguous() or x.shape[0] < 1:
        raise ValueError(f"x must be a contiguous non-empty (B, in) tensor, "
                         f"got shape {tuple(x.shape)}")
    n = len(params) // 3
    nb = len(knots) - degree - 1
    if len(params) % 3 or not 1 <= n <= MAX_LAYERS or degree != 3 \
            or not 1 <= nb <= MAX_BASIS:
        raise ValueError(
            f"unsupported KAN stack: {n} layers, degree {degree}, {nb} "
            f"bases; the kernels take 1-{MAX_LAYERS} layers of cubic splines "
            f"with at most {MAX_BASIS} bases")
    dims = _layer_dims(params)
    if dims[0] != x.shape[1] or max(dims) > MAX_IN \
            or max(dims[1:]) > MAX_OUT:
        raise ValueError(
            f"unsupported KAN widths {dims} for x {tuple(x.shape)}: inputs up "
            f"to {MAX_IN} wide, outputs up to {MAX_OUT}")
    for layer in range(n):
        din, dout = dims[layer], dims[layer + 1]
        for name, t, shape in zip(
                ("spline_weights", "weight", "bias"),
                params[3 * layer:3 * layer + 3],
                ((din, dout, nb), (dout, din), (dout,))):
            if tuple(t.shape) != shape or t.dtype != torch.float32 \
                    or t.device != x.device or not t.is_contiguous():
                raise ValueError(
                    f"layer {layer} {name}: want contiguous {shape} fp32 on "
                    f"{x.device}, got {tuple(t.shape)} {t.dtype} on "
                    f"{t.device}")
    return dims


_P = ctypes.c_void_p
_I = ctypes.c_int
_FLOATS = ctypes.POINTER(ctypes.c_float)
_INTS = ctypes.POINTER(ctypes.c_int)
_PTRS = ctypes.POINTER(ctypes.c_void_p)


@functools.lru_cache(maxsize=None)
def _module_library():
    """``csrc/kan_module.cu``: #8-#11, built on first use."""
    from rovit_kan_tpu_torch.ops import _build
    lib = _build.load("kan_module")
    for fn_name, argtypes in {
            "kan_module_fwd": [_P, _PTRS, _P, _I, _INTS, _I, _FLOATS, _I,
                               _INTS, _P],
            "kan_module_bwd": [_P, _P, _PTRS, _P, _PTRS, _P, _I, _INTS, _I,
                               _FLOATS, _I, _INTS, _P]}.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.error_string = lib.kan_module_error_string
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def _c_array(ctype, values):
    return (ctype * len(values))(*values)


@functools.lru_cache(maxsize=None)
def _c_knots(knots: Tuple[float, ...]):
    return _c_array(ctypes.c_float, knots)


@functools.lru_cache(maxsize=None)
def _module_args(B: int, dims: Tuple[int, ...], n_basis: int,
                 backward: bool, reciprocal_basis: bool, head: bool):
    """The plan of a shape and its ctypes arrays (plan, widths), made once
    per shape."""
    plan = module_plan(B, dims, n_basis, backward, head)._replace(
        reciprocal_basis=reciprocal_basis)
    return plan, _c_array(ctypes.c_int, plan.ints()), \
        _c_array(ctypes.c_int, dims)


def _raise_on(rc: int, lib, what: str, x: torch.Tensor, dims) -> None:
    if rc != 0:
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg}) "
                           f"at B={x.shape[0]} dims={list(dims)}")


def _check_grad(x: torch.Tensor, g: torch.Tensor, dims) -> None:
    want = (x.shape[0], dims[-1])
    if g.dtype != torch.float32 or tuple(g.shape) != want \
            or g.device != x.device or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous fp32 {want} tensor on "
                         f"{x.device}, got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")


def _fwd(x, params, knots, degree, reciprocal_basis, head):
    """One launch of ``kan_module_fwd``: #10 with ``head``, #8 without."""
    dims = _check_cuda_args(x, params, knots, degree)
    lib = _module_library()
    kn = _c_knots(tuple(float(v) for v in knots))
    _, cplan, cdims = _module_args(x.shape[0], tuple(dims),
                                   len(knots) - degree - 1, False,
                                   reciprocal_basis, head)
    ptrs = _c_array(ctypes.c_void_p, [p.data_ptr() for p in params])
    with torch.cuda.device(x.device):
        y = torch.empty((x.shape[0], dims[-1]), dtype=torch.float32,
                        device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.kan_module_fwd(x.data_ptr(), ptrs, y.data_ptr(), x.shape[0],
                                cdims, len(dims) - 1, kn, len(kn), cplan,
                                stream)
    _raise_on(rc, lib, "kan_module_fwd", x, dims)
    return y


def _bwd(x, g, params, knots, degree, reciprocal_basis, head):
    """One call of ``kan_module_bwd``: #11 with ``head``, #9 without.
    Returns ``(dx, grads)`` with ``grads`` flat like ``params``."""
    dims = _check_cuda_args(x, params, knots, degree)
    _check_grad(x, g, dims)
    lib = _module_library()
    kn = _c_knots(tuple(float(v) for v in knots))
    plan, cplan, cdims = _module_args(x.shape[0], tuple(dims),
                                      len(knots) - degree - 1, True,
                                      reciprocal_basis, head)
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        grads = [torch.empty_like(p) for p in params]
        # Each slot's fp32 weight-gradient sums, added in slot order by a
        # second launch; none with one slot.
        partials = torch.empty(
            (plan.slots, sum(p.numel() for p in params)),
            dtype=torch.float32, device=x.device) if plan.slots > 1 else None
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.kan_module_bwd(
            x.data_ptr(), g.data_ptr(),
            _c_array(ctypes.c_void_p, [p.data_ptr() for p in params]),
            dx.data_ptr(),
            _c_array(ctypes.c_void_p, [t.data_ptr() for t in grads]),
            None if partials is None else partials.data_ptr(), x.shape[0],
            cdims, len(dims) - 1, kn, len(kn), cplan, stream)
    _raise_on(rc, lib, "kan_module_bwd", x, dims)
    return dx, grads


def _launch_layer(x, spline_weights, weight, bias, knots, degree,
                  reciprocal_basis=True):
    global LAYER_LAUNCHES
    y = _fwd(x, (spline_weights, weight, bias), knots, degree,
             reciprocal_basis, head=False)
    LAYER_LAUNCHES += 1
    return y


def _launch_layer_bwd(x, g, spline_weights, weight, knots, degree,
                      reciprocal_basis=True):
    global LAYER_BWD_LAUNCHES
    # The backward reads no bias: an unset tensor of its shape stands in.
    bias = torch.empty(weight.shape[0], dtype=torch.float32,
                       device=x.device)
    dx, (ds, dw, db) = _bwd(x, g, (spline_weights, weight, bias), knots,
                            degree, reciprocal_basis, head=False)
    LAYER_BWD_LAUNCHES += 1
    return dx, ds, dw, db


def _launch_module(x, params, knots, degree, reciprocal_basis=True):
    global LAUNCHES
    y = _fwd(x, params, knots, degree, reciprocal_basis, head=True)
    LAUNCHES += 1
    return y


def _launch_module_bwd(x, g, params, knots, degree, reciprocal_basis=True):
    global BWD_LAUNCHES
    dx, grads = _bwd(x, g, params, knots, degree, reciprocal_basis,
                     head=True)
    BWD_LAUNCHES += 1
    return dx, grads


def _route(x: torch.Tensor, name: str) -> bool:
    """True for the kernels (a CUDA tensor), False for the plain versions (a
    CPU tensor); raises for any other device or a non-fp32 input."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name} takes fp32, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, got {x.device}")
    return x.device.type == "cuda"


def _layer_forward(x, spline_weights, weight, bias, knots, degree):
    if _route(x, "fused_kan_layer"):
        return _launch_layer(x, spline_weights, weight, bias, knots, degree)
    return kan_layer_reference(x, spline_weights, weight, bias, knots, degree)


def _layer_backward(x, g, spline_weights, weight, knots, degree):
    if _route(x, "fused_kan_layer"):
        return _launch_layer_bwd(x, g, spline_weights, weight, knots, degree)
    return kan_layer_backward_reference(x, g, spline_weights, weight, knots,
                                        degree)


def _module_forward(x, params, knots, degree):
    if _route(x, "fused_kan_module"):
        return _launch_module(x, params, knots, degree)
    return kan_module_reference(x, params, knots, degree)


def _module_backward(x, g, params, knots, degree):
    if _route(x, "fused_kan_module"):
        return _launch_module_bwd(x, g, params, knots, degree)
    return kan_module_backward_reference(x, g, params, knots, degree)


class FusedKANLayer(torch.autograd.Function):
    """One KAN layer under autograd: ``apply(x, knots, degree,
    spline_weights, weight, bias)``. Saves ``x`` and the weights; the
    backward is #9 on the card, its plain version on the CPU."""

    @staticmethod
    def forward(ctx, x, knots, degree, spline_weights, weight, bias):
        ctx.save_for_backward(x, spline_weights, weight)
        ctx.knots, ctx.degree = knots, degree
        return _layer_forward(x, spline_weights, weight, bias, knots, degree)

    @staticmethod
    def backward(ctx, g):
        x, spline_weights, weight = ctx.saved_tensors
        dx, ds, dw, db = _layer_backward(x, g.contiguous(), spline_weights,
                                         weight, ctx.knots, ctx.degree)
        return dx, None, None, ds, dw, db


class FusedKANModule(torch.autograd.Function):
    """The whole KAN head under autograd: ``apply(x, knots, degree,
    *params)``. Saves ``x`` and the parameters and nothing else; the
    backward recomputes the forward (#11 on the card, its plain version on
    the CPU)."""

    @staticmethod
    def forward(ctx, x, knots, degree, *params):
        ctx.save_for_backward(x, *params)
        ctx.knots, ctx.degree = knots, degree
        return _module_forward(x, params, knots, degree)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        dx, grads = _module_backward(x, g.contiguous(), params, ctx.knots,
                                     ctx.degree)
        return (dx, None, None, *grads)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fused_kan_layer(x: torch.Tensor, spline_weights: torch.Tensor,
                    weight: torch.Tensor, bias: torch.Tensor,
                    knots: np.ndarray, degree: int = 3) -> torch.Tensor:
    """One KAN layer, fused: ``(B, in)`` fp32 -> ``(B, out)``.

    ``spline_weights`` ``(in, out, K)``, ``weight`` ``(out, in)`` (an
    ``nn.Linear`` weight), ``bias`` ``(out,)``, ``knots`` the static knot
    vector. When grad is enabled and an input needs it, the call goes
    through ``FusedKANLayer``."""
    knots = np.asarray(knots, np.float32)
    x = x.contiguous()
    if _needs_grad(x, spline_weights, weight, bias):
        return FusedKANLayer.apply(x, knots, degree, spline_weights, weight,
                                   bias)
    return _layer_forward(x, spline_weights, weight, bias, knots, degree)


def fused_kan_module(x: torch.Tensor, params: Sequence[torch.Tensor],
                     knots: np.ndarray, degree: int = 3) -> torch.Tensor:
    """The whole KAN head in one kernel: ``(B, dims[0])`` fp32 -> ``(B,
    dims[-1])`` severity in [0, 3].

    ``params`` is flat: ``(spline_weights, weight, bias)`` per layer, in the
    layouts of ``fused_kan_layer``. When grad is enabled and an input needs
    it, the call goes through ``FusedKANModule``."""
    knots = np.asarray(knots, np.float32)
    x = x.contiguous()
    if _needs_grad(x, *params):
        return FusedKANModule.apply(x, knots, degree, *params)
    return _module_forward(x, tuple(params), knots, degree)

