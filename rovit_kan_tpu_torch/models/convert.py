"""Weights between the JAX package's param tree and the port's modules.

The JAX tree is a nested dict of arrays, as ``model.init(...)["params"]`` or
``rovit_kan_tpu.models.convert.load_npz`` gives it. The port's modules carry
the reference's state_dict names, so the mapping is mechanical:

- ``backbone.model.X`` <-> ``backbone/X``; ``blocks.{i}`` <-> ``blocks_{i}``
  and ``kan_layers.{i}`` <-> ``kan_layers_{i}``;
- a head's first Linear ``fc1`` sits under ``trunk`` in the JAX tree;
- a Linear ``weight (out, in)`` <-> a Dense ``kernel (in, out)``,
  transposed; the PatchEmbed kernel ``(768, 192)`` keeps its
  (row, col, channel) flattening, since both sides flatten that way;
- a LayerNorm ``weight`` <-> ``scale``;
- a KAN layer's ``linear.{weight,bias}`` <-> ``kernel`` / ``bias``;
  ``spline_weights (in, out, K)``, ``cls_token`` and ``pos_embed`` are
  copied as they are.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from rovit_kan_tpu_torch import resolve_device

_HEADS = ("classification_head", "ordinal_head", "uncertainty_head")


def _jax_path(key: str, ndim: int) -> Tuple[Tuple[str, ...], bool]:
    """JAX tree path of a state_dict entry, and whether it transposes."""
    parts = key.split(".")
    if parts[:2] == ["backbone", "model"]:
        parts = ["backbone"] + parts[2:]
    path = []
    i = 0
    while i < len(parts):
        if parts[i] in ("blocks", "kan_layers"):
            path.append(f"{parts[i]}_{parts[i + 1]}")
            i += 2
        else:
            path.append(parts[i])
            i += 1
    if path[0] in _HEADS and path[1] == "fc1":
        path.insert(1, "trunk")
    leaf = path[-1]
    if len(path) >= 2 and path[-2] == "linear":            # KAN dense path
        return tuple(path[:-2] + ["kernel" if leaf == "weight" else "bias"]), \
            leaf == "weight"
    if leaf == "weight":
        if ndim == 1:                                       # LayerNorm
            return tuple(path[:-1] + ["scale"]), False
        return tuple(path[:-1] + ["kernel"]), True          # Linear
    return tuple(path), False


def _get(tree: Mapping, path: Tuple[str, ...]) -> Any:
    node = tree
    for p in path:
        node = node[p]
    return node


def load_jax_params(model: nn.Module, params: Mapping,
                    device="cuda") -> nn.Module:
    """Load a JAX param tree into ``model`` and move it to ``device``.

    Every parameter of the model must be in the tree with the matching
    shape; raises otherwise, and when CUDA is asked for and absent."""
    dev = resolve_device(device)
    sd = {}
    for key, cur in model.state_dict().items():
        path, transpose = _jax_path(key, cur.dim())
        try:
            value = np.asarray(_get(params, path), dtype=np.float32)
        except KeyError as e:
            raise KeyError(f"{key}: no {'/'.join(path)} in the JAX tree") \
                from e
        if transpose:
            value = value.T
        if tuple(value.shape) != tuple(cur.shape):
            raise ValueError(f"{key}: JAX {'/'.join(path)} has shape "
                             f"{value.shape}, the module wants "
                             f"{tuple(cur.shape)}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(value))
    model.load_state_dict(sd, strict=True)
    return model.to(dev)


def to_jax_params(model: nn.Module) -> Dict:
    """The inverse of ``load_jax_params``: the model's weights as a JAX param
    tree of fp32 numpy arrays (used by the tests)."""
    tree: Dict = {}
    for key, t in model.state_dict().items():
        path, transpose = _jax_path(key, t.dim())
        value = t.detach().to("cpu", torch.float32).numpy()
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(value.T if transpose
                                              else value)
    return tree
