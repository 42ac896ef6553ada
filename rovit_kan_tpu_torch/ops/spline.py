"""B-spline basis and KAN layer numerics.

Counterpart of ``rovit_kan_tpu/ops/spline.py``. The knot vector is a static
NumPy array, so the Cox-de Boor recursion unrolls in Python into a handful of
elementwise ops over the whole (batch, features) tensor, and the spline
contraction is one ``(B, in*K) @ (in*K, out)`` product. Semantics match the
JAX functions exactly: half-open degree-0 intervals
(``knots[i] <= x < knots[i+1]``), a clamp to the knot range, static
zero-denominator guards, ``num_basis = num_knots + degree - 1``.

Both products run in true fp32: TF32 is switched off around them, whatever
the process-wide setting, because the KAN head drives the severity metric.
"""
from __future__ import annotations

import numpy as np
import torch


def make_knots(num_knots: int = 5, degree: int = 3) -> np.ndarray:
    """Uniform knot vector in [-1, 1]."""
    return np.linspace(-1.0, 1.0, num_knots + 2 * degree).astype(np.float32)


def num_basis_functions(num_knots: int = 5, degree: int = 3) -> int:
    """Number of B-spline basis functions."""
    return num_knots + degree - 1


def bspline_basis_list(x: torch.Tensor, knots: np.ndarray, degree: int = 3):
    """All B-spline basis functions at ``x``, as a list of ``num_basis``
    tensors shaped like ``x``."""
    knots = np.asarray(knots, dtype=np.float32)
    num_knots = knots.shape[0]
    num_basis = num_knots - degree - 1
    k = [float(v) for v in knots]

    x = torch.clamp(x, k[0], k[-1])

    # Degree 0: indicator of the half-open interval [knots[i], knots[i+1]).
    basis = [((x >= k[i]) & (x < k[i + 1])).to(x.dtype)
             for i in range(num_basis)]

    # Cox-de Boor recursion; the zero-denominator guards are static tests on
    # the concrete knot vector.
    for d in range(1, degree + 1):
        new_basis = []
        for i in range(num_basis):
            term = torch.zeros_like(x)
            if k[i + d] != k[i]:
                left = (x - k[i]) / (k[i + d] - k[i])
                term = term + left * basis[i]
            if i + d + 1 < num_knots and k[i + d + 1] != k[i + 1]:
                if i + 1 < num_basis:
                    right = (k[i + d + 1] - x) / (k[i + d + 1] - k[i + 1])
                    term = term + right * basis[i + 1]
            new_basis.append(term)
        basis = new_basis
    return basis


def bspline_basis_and_deriv_list(x: torch.Tensor, knots: np.ndarray,
                                 degree: int = 3):
    """Basis values and their d/dx in one pass: (value, tangent) pairs
    carried through the same truncated Cox-de Boor recursion as
    ``bspline_basis_list``. The hand-written KAN backward
    (``ops/kan_kernel.py``) consumes it.

    Returns:
        (basis, dbasis): two lists of ``num_basis`` tensors shaped like x.
    """
    knots = np.asarray(knots, dtype=np.float32)
    num_knots = knots.shape[0]
    num_basis = num_knots - degree - 1
    k = [float(v) for v in knots]

    # The clamp's VJP: unit gradient inside the knot range (inclusive at
    # both ends), zero outside.
    in_range = ((x >= k[0]) & (x <= k[-1])).to(x.dtype)
    x = torch.clamp(x, k[0], k[-1])

    basis = [((x >= k[i]) & (x < k[i + 1])).to(x.dtype)
             for i in range(num_basis)]
    dbasis = [torch.zeros_like(x) for _ in range(num_basis)]

    for d in range(1, degree + 1):
        nb, ndb = [], []
        for i in range(num_basis):
            term = torch.zeros_like(x)
            dterm = torch.zeros_like(x)
            if k[i + d] != k[i]:
                denom = k[i + d] - k[i]
                left = (x - k[i]) / denom
                term = term + left * basis[i]
                dterm = dterm + basis[i] / denom + left * dbasis[i]
            if i + d + 1 < num_knots and k[i + d + 1] != k[i + 1]:
                if i + 1 < num_basis:
                    denom = k[i + d + 1] - k[i + 1]
                    right = (k[i + d + 1] - x) / denom
                    term = term + right * basis[i + 1]
                    dterm = (dterm - basis[i + 1] / denom
                             + right * dbasis[i + 1])
            nb.append(term)
            ndb.append(dterm)
        basis, dbasis = nb, ndb
    return basis, [db * in_range for db in dbasis]


def bspline_basis(x: torch.Tensor, knots: np.ndarray,
                  degree: int = 3) -> torch.Tensor:
    """``(*x.shape, num_basis)`` basis values."""
    return torch.stack(bspline_basis_list(x, knots, degree), dim=-1)


def matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in IEEE fp32, never TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def kan_layer_apply(x: torch.Tensor, spline_weights: torch.Tensor,
                    linear_kernel: torch.Tensor, linear_bias: torch.Tensor,
                    knots: np.ndarray, degree: int = 3) -> torch.Tensor:
    """One KAN layer: ``x @ W_lin + b + sum_k basis_k(tanh x) W_spl[:, :, k]``.

    Args:
        x: ``(B, in_features)``.
        spline_weights: ``(in_features, out_features, num_basis)``.
        linear_kernel: ``(in_features, out_features)`` (the JAX layout; a
            ``nn.Linear`` weight transposed).
        linear_bias: ``(out_features,)``.
        knots: static knot vector.

    Returns:
        ``(B, out_features)``.
    """
    in_features, out_features, num_basis = spline_weights.shape
    basis = bspline_basis(torch.tanh(x), knots, degree)      # (B, in, K)
    b2 = basis.reshape(x.shape[0], in_features * num_basis)
    w2 = spline_weights.permute(0, 2, 1).reshape(in_features * num_basis,
                                                 out_features)
    spline_out = matmul_fp32(b2, w2)
    linear_out = matmul_fp32(x, linear_kernel) + linear_bias
    return linear_out + spline_out


def spline_curve(spline_weights, knots: np.ndarray, input_idx: int,
                 output_idx: int, num_points: int = 100, degree: int = 3):
    """One learned spline ``phi_ij`` on a [-1, 1] grid, for plotting:
    ``(x, y)`` as numpy arrays."""
    w = spline_weights[input_idx, output_idx]               # (K,)
    w = (w.detach().cpu() if isinstance(w, torch.Tensor)
         else torch.from_numpy(np.asarray(w))).float()
    x = torch.linspace(-1.0, 1.0, num_points)
    y = (bspline_basis(x, knots, degree) * w).sum(-1)
    return x.numpy(), y.numpy()
