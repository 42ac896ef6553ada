"""The partition of the KAN kernels of ``csrc/kan_module.cu``, the whole
head (#10/#11) and one layer (#8/#9: the same kernels without the head),
modelled in torch fp32 and held against the JAX package.

The model runs the launch plan of ``ops/kan_kernel.py::module_plan`` as the
kernels do: the batch in row groups; in each group, every layer's inputs
split by rank, each rank's partial pre-activation over its slice, the
partials added in rank order and then the bias; backward, dh and the
weight gradients of each rank's slice from the layer's whole output
gradient, the weight gradients summed over each group's rows, then over
each slot's groups in order (#11's waves of ``slots`` clusters put group
gi in slot gi % slots), then over the slots in order. Without the head
there is no sigmoid, and the backward takes the upstream gradient as the
layer's output gradient and recomputes no forward. Seeded numpy inputs go
through the model and through the JAX ``fused_kan_module`` or
``fused_kan_layer`` and its ``jax.vjp`` (the Pallas kernels in interpret
mode, as tests/test_torch_kan_kernel.py runs them). Tolerances
are the slice's (tests/test_torch_kan_kernel.py, after
tests/test_spline.py): values rtol 1e-4 / atol 1e-5, gradients atol 1e-4.
The plan is also checked to cover every input and row once, within a CTA's
shared memory, for every shape the kernels take.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.ops.kan_kernel import fused_kan_layer as jax_layer
from rovit_kan_tpu.ops.kan_kernel import fused_kan_module as jax_module
from rovit_kan_tpu_torch.ops import kan_kernel as kk
from rovit_kan_tpu_torch.ops.spline import (
    bspline_basis_and_deriv_list,
    make_knots,
    matmul_fp32,
)

KNOTS = make_knots(5, 3)
VALUES = dict(rtol=1e-4, atol=1e-5)
GRADS = dict(rtol=0, atol=1e-4)


def _pre_activation(h, S, W, bias, bounds):
    """Layer pre-activation of a group's rows: each rank's partial over its
    slice of the inputs, added in rank order (ranks with no inputs hold
    none), then the bias."""
    acc = torch.zeros(h.shape[0], W.shape[0])
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi == lo:
            continue
        hs = h[:, lo:hi]
        basis, _ = bspline_basis_and_deriv_list(torch.tanh(hs), KNOTS, 3)
        part = matmul_fp32(hs, W[:, lo:hi].t())
        for k, bk in enumerate(basis):
            part = part + matmul_fp32(bk, S[lo:hi, :, k])
        acc = acc + part
    return acc + bias


def _group_forward(h, params, plan):
    hs, accs = [h], []
    n = len(params) // 3
    for layer in range(n):
        acc = _pre_activation(hs[-1], *params[3 * layer:3 * layer + 3],
                              plan.bounds[layer])
        accs.append(acc)
        hs.append(torch.relu(acc) if layer < n - 1 else acc)
    return hs, accs


def cluster_forward(x, params, head=True):
    """#10's arithmetic under its plan; #8's without the head."""
    dims = kk._layer_dims(params)
    plan = kk.module_plan(x.shape[0], tuple(dims), len(KNOTS) - 4, False,
                          head)
    out = []
    for g in range(plan.groups):
        rows = x[g * plan.rows:(g + 1) * plan.rows]
        _, accs = _group_forward(rows, params, plan)
        out.append(3.0 * torch.sigmoid(accs[-1]) if head else accs[-1])
    return torch.cat(out)


def _group_backward(h, g, params, plan):
    """dx and the weight gradients of one row group: per layer from the
    last, every rank forms dh and dS, dW of its slice of the inputs, and
    db of its slice of the outputs, from the layer's whole output
    gradient. Without the head that gradient is g, and no forward runs."""
    n = len(params) // 3
    if plan.head:
        hs, accs = _group_forward(h, params, plan)
        sig = torch.sigmoid(accs[-1])
        ga = g * 3.0 * sig * (1.0 - sig)
    else:
        hs, ga = [h], g
    grads = [None] * (3 * n)
    for layer in range(n - 1, -1, -1):
        S, W, _ = params[3 * layer:3 * layer + 3]
        hl = hs[layer]
        dh = torch.zeros_like(hl)
        dS = torch.zeros_like(S)
        dW = torch.zeros_like(W)
        db = torch.zeros(W.shape[0])
        bounds = plan.bounds[layer]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if hi == lo:
                continue
            t = torch.tanh(hl[:, lo:hi])
            basis, dbasis = bspline_basis_and_deriv_list(t, KNOTS, 3)
            sp = torch.zeros_like(t)
            for k in range(len(basis)):
                sp = sp + matmul_fp32(ga, S[lo:hi, :, k].t()) * dbasis[k]
                dS[lo:hi, :, k] = matmul_fp32(basis[k].t(), ga)
            dh[:, lo:hi] = matmul_fp32(ga, W[:, lo:hi]) + sp * (1.0 - t * t)
            dW[:, lo:hi] = matmul_fp32(ga.t(), hl[:, lo:hi])
        out_bounds = plan.bounds[layer + 1]
        for lo, hi in zip(out_bounds[:-1], out_bounds[1:]):
            db[lo:hi] = ga[:, lo:hi].sum(0)
        grads[3 * layer:3 * layer + 3] = [dS, dW, db]
        ga = dh * (accs[layer - 1] > 0).to(dh.dtype) if layer else dh
    return ga, grads


def cluster_backward(x, g, params, head=True):
    """#11's arithmetic under its plan (#9's without the head): dx per
    group; the weight gradients of slot s's groups s, s + slots, ... added
    in order, then the slots added in order."""
    dims = kk._layer_dims(params)
    plan = kk.module_plan(x.shape[0], tuple(dims), len(KNOTS) - 4, True,
                          head)
    dxs, slots = [None] * plan.groups, [None] * plan.slots
    for gi in range(plan.groups):
        rows = slice(gi * plan.rows, (gi + 1) * plan.rows)
        dxs[gi], grads = _group_backward(x[rows], g[rows], params, plan)
        s = gi % plan.slots
        slots[s] = grads if slots[s] is None else [
            a + b for a, b in zip(slots[s], grads)]
    total = slots[0]
    for more in slots[1:]:
        total = [a + b for a, b in zip(total, more)]
    return torch.cat(dxs), total


def _inputs(dims, B, seed):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1.5, (B, dims[0])).astype(np.float32)
    x.flat[:4] = [10.0, -10.0, 12.0, -30.0]      # tanh exactly +-1
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        params += [rng.normal(0, 0.1, (a, b, 7)).astype(np.float32),
                   (rng.normal(0, 1, (a, b)) / np.sqrt(a)).astype(np.float32),
                   rng.normal(0, 0.1, (b,)).astype(np.float32)]
    return x, params, rng.normal(0, 1, (B, dims[-1])).astype(np.float32)


@pytest.mark.parametrize("dims,B", [((192, 64, 16, 1), 64),
                                    ((192, 64, 16, 1), 37),
                                    ((200, 60, 13, 3), 70),
                                    ((24, 8, 1), 600)],
                         ids=["flagship-64", "flagship-37", "ragged-70",
                              "slots-600"])
def test_cluster_model_matches_jax(dims, B):
    """The model of #10/#11's partition against the Pallas module and its
    VJP. The ragged widths (200, 60 and 13 over 16 ranks) leave ranks with
    unequal and empty slices; B = 70 spans five forward row groups and two
    backward ones; B = 600 spans ten backward row groups over eight slots,
    so two slots take two groups each."""
    x, params, g = _inputs(dims, B, seed=B + len(dims))
    want, vjp = jax.vjp(lambda xx, *p: jax_module(xx, tuple(p), dims, KNOTS),
                        jnp.asarray(x), *map(jnp.asarray, params))
    jgrads = vjp(jnp.asarray(g))
    tp = [torch.from_numpy(np.ascontiguousarray(p.T if i % 3 == 1 else p))
          for i, p in enumerate(params)]
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    if B > 64:
        assert kk.module_plan(B, dims, 7, True).groups > 1
    if B > 512:
        plan = kk.module_plan(B, dims, 7, True)
        assert plan.groups > plan.slots == kk.BWD_SLOTS
    np.testing.assert_allclose(cluster_forward(tx, tp).numpy(),
                               np.asarray(want), **VALUES)
    dx, grads = cluster_backward(tx, tg, tp)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jgrads[0]), **GRADS)
    for i, (a, ref) in enumerate(zip(grads, jgrads[1:])):
        a = a.t() if i % 3 == 1 else a
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **GRADS,
                                   err_msg=f"param {i}")


@pytest.mark.parametrize("dims,B", [((192, 64), 64), ((64, 16), 64),
                                    ((16, 1), 64), ((200, 60), 70),
                                    ((24, 8), 600)],
                         ids=["trajectory-192", "trajectory-64",
                              "trajectory-16", "ragged-70", "slots-600"])
def test_layer_cluster_model_matches_jax(dims, B):
    """The model of #8/#9's partition (the head's kernels on a one-layer
    plan without the head) against the Pallas layer and its VJP: the
    trajectory's three layers at B = 64 (four row groups each way, #9's in
    four slots); 200 -> 60 at B = 70 (ragged slices over 16 ranks, empty
    ranks of 60, five row groups each way); 24 -> 8 at B = 600 (38
    backward row groups over eight slots)."""
    x, params, g = _inputs(dims, B, seed=B + dims[0])
    want, vjp = jax.vjp(
        lambda xx, s, w, b: jax_layer(xx, s, w, b, KNOTS),
        jnp.asarray(x), *map(jnp.asarray, params))
    jgrads = vjp(jnp.asarray(g))
    tp = [torch.from_numpy(np.ascontiguousarray(p.T if i == 1 else p))
          for i, p in enumerate(params)]
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    fwd = kk.module_plan(B, dims, 7, False, False)
    bwd = kk.module_plan(B, dims, 7, True, False)
    assert not (fwd.head or bwd.head)
    assert fwd.groups == -(-B // kk.FWD_ROWS)
    assert bwd.groups == -(-B // kk.LAYER_BWD_ROWS) > 1
    if B > 512:
        assert bwd.groups > bwd.slots == kk.BWD_SLOTS
    np.testing.assert_allclose(cluster_forward(tx, tp, False).numpy(),
                               np.asarray(want), **VALUES)
    dx, grads = cluster_backward(tx, tg, tp, False)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jgrads[0]), **GRADS)
    for i, (a, ref) in enumerate(zip(grads, jgrads[1:])):
        a = a.t() if i == 1 else a
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **GRADS,
                                   err_msg=f"param {i}")


# Widths the kernels take: inputs 1-1,024, later widths 1-256, 1-4 layers,
# 1-10 bases; batches around the row groups' edges.
WIDTHS_IN = (1, 15, 16, 17, 192, 1000, 1024)
WIDTHS = (1, 3, 16, 64, 200, 256)
BATCHES = (1, 8, 15, 16, 17, 63, 64, 65, 1000)


def _shapes():
    for n_layers in range(1, 5):
        for d0 in WIDTHS_IN:
            for rest in itertools.product(WIDTHS, repeat=n_layers):
                if n_layers > 2 and len(set(rest)) > 2:
                    continue                  # keep the sweep small
                yield (d0, *rest)


def _plans():
    """(dims, nb, backward, B, head) of the sweep: every shape with the
    head, one-layer shapes also without it (#8/#9)."""
    for dims in _shapes():
        for nb in (1, 3, 4, 7, 8, 10):
            for backward in (False, True):
                for B in BATCHES:
                    for head in ((True, False) if len(dims) == 2
                                 else (True,)):
                        yield dims, nb, backward, B, head


def test_plan_covers_every_input_and_row_once():
    count = 0
    for dims, nb, backward, B, head in _plans():
        k1p = (nb + 4) // 4 * 4
        plan = kk.module_plan(B, dims, nb, backward, head)
        count += 1
        most = kk.FWD_ROWS if not backward else \
            kk.BWD_ROWS if head else kk.LAYER_BWD_ROWS
        assert plan.rows % 8 == 0 and 8 <= plan.rows <= most
        # Rows: groups of plan.rows cover 0..B-1 once.
        assert (plan.groups - 1) * plan.rows < B \
            <= plan.groups * plan.rows
        # Groups: slot s takes s, s + slots, ...: each once; #11's
        # waves at most BWD_SLOTS clusters, #10 one launch.
        taken = sorted(gi for s in range(plan.slots)
                       for gi in range(s, plan.groups, plan.slots))
        assert taken == list(range(plan.groups))
        assert plan.slots == (min(plan.groups, kk.BWD_SLOTS)
                              if backward else plan.groups)
        assert plan.cluster == kk.CLUSTER
        assert plan.smem_floats <= kk.SMEM_FLOATS
        assert len(plan.bounds) == len(dims)
        for d, b in zip(dims, plan.bounds):
            # Inputs: the ranks' slices cover 0..d-1 once.
            assert b[0] == 0 and b[-1] == d
            assert all(lo <= hi for lo, hi in zip(b, b[1:]))
            covered = [i for lo, hi in zip(b, b[1:])
                       for i in range(lo, hi)]
            assert covered == list(range(d))
        for layer, c in enumerate(plan.chunk):
            widest = max(hi - lo for lo, hi in zip(
                plan.bounds[layer], plan.bounds[layer][1:]))
            assert 1 <= c <= widest
            assert c * k1p * dims[layer + 1] <= kk.SLAB_FLOATS \
                or c == 1
        ints = plan.ints()
        assert len(ints) == 7 + kk.MAX_LAYERS + sum(
            len(b) for b in plan.bounds)
        assert plan.head == head and ints[6] == int(head)
    assert count > 10_000


def test_flagship_plan():
    """The flagship's plans: #10 in four clusters of 16 rows at B = 64,
    #11 in one cluster of all 64 rows (one launch); every rank holds 12 of
    layer 0's 192 inputs, in one weight chunk. The trajectory's layers
    (#8/#9, no head) split the same way, each in four clusters of 16 rows
    (#9's four slots then added in order), each rank's inputs of the layer
    in one chunk."""
    fwd = kk.module_plan(64, (192, 64, 16, 1), 7, False)
    bwd = kk.module_plan(64, (192, 64, 16, 1), 7, True)
    assert (fwd.rows, fwd.groups, bwd.rows, bwd.groups) == (16, 4, 64, 1)
    assert (fwd.slots, bwd.slots) == (4, 1)
    for plan in (fwd, bwd):
        assert plan.bounds[0] == tuple(range(0, 193, 12))
        assert plan.chunk == (12, 4, 1)
    assert bwd.smem_floats * 4 <= 232448
    for dims, chunk in (((192, 64), 12), ((64, 16), 4), ((16, 1), 1)):
        lf = kk.module_plan(64, dims, 7, False, False)
        lb = kk.module_plan(64, dims, 7, True, False)
        assert (lf.rows, lf.groups, lf.slots) == (16, 4, 4)
        assert (lb.rows, lb.groups, lb.slots) == (16, 4, 4)
        for plan in (lf, lb):
            assert not plan.head and plan.chunk == (chunk,)
            assert plan.bounds[0] == tuple(range(0, dims[0] + 1, chunk))
        assert lb.smem_floats * 4 <= 232448


@pytest.mark.parametrize("dims", [(192, 64, 16, 1), (24, 8, 1)])
def test_plan_without_the_head_takes_one_layer(dims):
    for backward in (False, True):
        with pytest.raises(ValueError, match="one layer"):
            kk.module_plan(64, dims, 7, backward, False)
