"""KAN (Kolmogorov-Arnold) severity module, plain fp32.

Counterpart of ``rovit_kan_tpu/models/kan.py``: each layer adds learned
splines of ``tanh(x)`` (coefficients ``(in, out, K)``) to a dense path on the
raw ``x`` (``linear``, the reference's key name); ReLU between layers and
``3 * sigmoid`` at the end put the score on the [0, 3] severity range.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from rovit_kan_tpu_torch.ops.spline import (
    kan_layer_apply,
    make_knots,
    num_basis_functions,
)


class KANLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 num_knots: int = 5, degree: int = 3):
        super().__init__()
        self.degree = degree
        self.knots = make_knots(num_knots, degree)        # static, numpy
        self.spline_weights = nn.Parameter(torch.zeros(
            in_features, out_features,
            num_basis_functions(num_knots, degree)))
        self.linear = nn.Linear(in_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return kan_layer_apply(x, self.spline_weights, self.linear.weight.t(),
                               self.linear.bias, self.knots, self.degree)


class KANSeverityModule(nn.Module):
    def __init__(self, layer_dims: Sequence[int] = (192, 64, 16, 1),
                 num_knots: int = 5, degree: int = 3):
        super().__init__()
        dims = list(layer_dims)
        self.kan_layers = nn.ModuleList([
            KANLayer(dims[i], dims[i + 1], num_knots, degree)
            for i in range(len(dims) - 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.kan_layers[:-1]:
            x = torch.relu(layer(x))
        return 3.0 * torch.sigmoid(self.kan_layers[-1](x))
