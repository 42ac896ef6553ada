"""KAN (Kolmogorov-Arnold) severity module, fp32.

Counterpart of ``rovit_kan_tpu/models/kan.py``: each layer adds learned
splines of ``tanh(x)`` (coefficients ``(in, out, K)``) to a dense path on the
raw ``x`` (``linear``, the reference's key name); ReLU between layers and
``3 * sigmoid`` at the end put the score on the [0, 3] severity range.

With ``use_fused`` (the JAX ``use_pallas``) the module runs through
``ops.kan_kernel.fused_kan_module``, one kernel for the whole stack forward
and one for its backward, and each layer called alone through
``fused_kan_layer``; the CUDA kernels on the card, their plain versions on
the CPU. The parameters are the same either way.
"""
from __future__ import annotations

from typing import List, Mapping, Sequence, Tuple, Union

import torch
import torch.nn as nn

from rovit_kan_tpu_torch.ops.kan_kernel import (
    fused_kan_layer,
    fused_kan_module,
)
from rovit_kan_tpu_torch.ops.spline import (
    kan_layer_apply,
    make_knots,
    num_basis_functions,
)


class KANLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 num_knots: int = 5, degree: int = 3,
                 use_fused: bool = False):
        super().__init__()
        self.degree = degree
        self.use_fused = use_fused
        self.knots = make_knots(num_knots, degree)        # static, numpy
        self.spline_weights = nn.Parameter(torch.zeros(
            in_features, out_features,
            num_basis_functions(num_knots, degree)))
        self.linear = nn.Linear(in_features, out_features)

    def param_tuple(self):
        """``(spline_weights, weight, bias)`` in the kernels' layouts."""
        return self.spline_weights, self.linear.weight, self.linear.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_fused:
            return fused_kan_layer(x, *self.param_tuple(), self.knots,
                                   self.degree)
        return kan_layer_apply(x, self.spline_weights, self.linear.weight.t(),
                               self.linear.bias, self.knots, self.degree)


class KANSeverityModule(nn.Module):
    def __init__(self, layer_dims: Sequence[int] = (192, 64, 16, 1),
                 num_knots: int = 5, degree: int = 3,
                 use_fused: bool = False):
        super().__init__()
        dims = list(layer_dims)
        self.degree = degree
        self.use_fused = use_fused
        self.kan_layers = nn.ModuleList([
            KANLayer(dims[i], dims[i + 1], num_knots, degree, use_fused)
            for i in range(len(dims) - 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_fused:
            flat = [t for layer in self.kan_layers
                    for t in layer.param_tuple()]
            return fused_kan_module(x, flat, self.kan_layers[0].knots,
                                    self.degree)
        for layer in self.kan_layers[:-1]:
            x = torch.relu(layer(x))
        return 3.0 * torch.sigmoid(self.kan_layers[-1](x))

    def activation_trajectory(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Per-layer activations, the input and the final score included;
        each layer runs alone (``fused_kan_layer`` when fused)."""
        acts = [x]
        for layer in self.kan_layers[:-1]:
            x = torch.relu(layer(x))
            acts.append(x)
        acts.append(3.0 * torch.sigmoid(self.kan_layers[-1](x)))
        return acts


KANLike = Union[KANSeverityModule, Mapping[str, torch.Tensor]]


def kan_layer_params(kan: KANLike) -> List[Tuple[torch.Tensor, ...]]:
    """Each layer's ``(spline_weights (in, out, K), weight (out, in),
    bias (out))``, from the module or its ``state_dict``."""
    if isinstance(kan, KANSeverityModule):
        return [layer.param_tuple() for layer in kan.kan_layers]
    out = []
    while f"kan_layers.{len(out)}.spline_weights" in kan:
        pre = f"kan_layers.{len(out)}."
        out.append((kan[pre + "spline_weights"], kan[pre + "linear.weight"],
                    kan[pre + "linear.bias"]))
    return out


def get_spline_weights(kan: KANLike) -> List[torch.Tensor]:
    """Each layer's spline coefficients ``(in, out, K)``."""
    return [spline for spline, _, _ in kan_layer_params(kan)]
