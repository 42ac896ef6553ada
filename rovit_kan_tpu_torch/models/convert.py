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
  copied as they are;
- a MoE block's ``moe.gate.weight (E, D)`` <-> ``moe/gate/kernel (D, E)``,
  transposed as any Linear; the stacked ``moe.w1``, ``b1``, ``w2``, ``b2``
  are copied as they are.

Weight import, the JAX module's converter in numpy and torch: a reference
``best_model.pth`` (``load_torch_checkpoint``,
``convert_reference_checkpoint``) or a timm ViT state_dict
(``convert_timm_vit``) becomes the JAX param tree, leaf for leaf the JAX
functions' tree, which ``save_npz`` writes as the JAX package's ``.npz``
(one file serves both packages) and ``merge_pretrained`` lays over an
initialized tree. The reference has no MoE, so
``convert_reference_checkpoint`` knows no ``moe`` keys; a port MoE
checkpoint round-trips through the port's own ``model.pt``
(``utils/checkpoint.py``).

``load_baseline_variables`` maps a JAX ``BaselineModel``'s ``{"params",
"batch_stats"}`` tree the same way, with a conv ``weight (O, I/g, kh, kw)``
<-> ``kernel (kh, kw, I/g, O)`` (a depthwise ``(C, 1, k, k)`` <-> ``(k, k, 1,
C)``), a BatchNorm's ``weight``/``bias`` <-> ``params`` ``scale``/``bias``
and its ``running_mean``/``running_var`` <-> ``batch_stats`` ``mean``/``var``.
The port's VGG-16 flattens in the JAX (H, W, C) order, so its ``fc1`` needs
no permutation; Swin's ``rel_bias`` is copied as it is.

``transfer_resolution`` carries a state_dict to another image size (the
JAX package's resolution-transfer recipe): the position embedding's patch
grid is resampled bilinearly; every other weight is independent of the
token count.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from rovit_kan_tpu_torch import resolve_device
from rovit_kan_tpu_torch.ops.preprocess import resize_bilinear
from rovit_kan_tpu_torch.utils.checkpoint import patch_weight_from_conv

_HEADS = ("classification_head", "ordinal_head", "uncertainty_head")
POS_EMBED_KEY = "backbone.model.pos_embed"


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


def jax_state_dict(model: nn.Module, params: Mapping
                   ) -> Dict[str, torch.Tensor]:
    """``model``'s state_dict with every value taken from the JAX param
    tree ``params`` (fp32, on the CPU). Every parameter of the model must
    be in the tree with the matching shape; raises otherwise."""
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
    return sd


def load_jax_params(model: nn.Module, params: Mapping,
                    device="cuda") -> nn.Module:
    """Load a JAX param tree into ``model`` (``jax_state_dict``) and move
    it to ``device``; raises when CUDA is asked for and absent."""
    dev = resolve_device(device)
    model.load_state_dict(jax_state_dict(model, params), strict=True)
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


_BN_STATS = {"running_mean": "mean", "running_var": "var"}


def _variable_path(key: str, ndim: int) -> Tuple[str, Tuple[str, ...],
                                                  Tuple[int, ...]]:
    """The JAX collection and path of a baseline state_dict entry, and the
    axis order that takes the port's tensor to the JAX array (inverse:
    ``np.argsort`` of it)."""
    leaf = key.rpartition(".")[2]
    if leaf in _BN_STATS:
        path, _ = _jax_path(key, ndim)
        return "batch_stats", path[:-1] + (_BN_STATS[leaf],), ()
    path, transpose = _jax_path(key, ndim)
    order = ((2, 3, 1, 0) if ndim == 4 else (1, 0)) if transpose else ()
    return "params", path, order


def load_baseline_variables(model: nn.Module, variables: Mapping,
                            device="cuda") -> nn.Module:
    """Load a JAX ``BaselineModel``'s variables (``{"params": ...,
    "batch_stats": ...}``, the latter absent for DeiT) into the port's
    ``BaselineModel`` and move it to ``device``. Every parameter and
    running statistic must be in the tree with the matching shape."""
    dev = resolve_device(device)
    sd = {}
    for key, cur in model.state_dict().items():
        col, path, order = _variable_path(key, cur.dim())
        try:
            value = np.array(_get(variables[col], path), dtype=np.float32)
        except KeyError as e:
            raise KeyError(f"{key}: no {col}/{'/'.join(path)} in the JAX "
                           f"variables") from e
        if order:
            value = value.transpose(np.argsort(order))
        if tuple(value.shape) != tuple(cur.shape):
            raise ValueError(f"{key}: JAX {col}/{'/'.join(path)} has shape "
                             f"{value.shape}, the module wants "
                             f"{tuple(cur.shape)}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(value))
    model.load_state_dict(sd, strict=True)
    return model.to(dev)


def to_baseline_variables(model: nn.Module) -> Dict:
    """The inverse of ``load_baseline_variables``: ``{"params", and
    "batch_stats" where the model has BatchNorms}`` of fp32 numpy arrays
    (used by the tests)."""
    tree: Dict = {}
    for key, t in model.state_dict().items():
        col, path, order = _variable_path(key, t.dim())
        value = t.detach().to("cpu", torch.float32).numpy()
        node = tree.setdefault(col, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(
            value.transpose(order) if order else value)
    return tree


def interpolate_pos_embed(pos_embed: torch.Tensor,
                          target_tokens: int) -> torch.Tensor:
    """Bilinearly resample a ViT position embedding ``(1, 1 + N, D)`` to
    ``target_tokens`` (JAX ``convert.interpolate_pos_embed``): the CLS
    position is kept; the N patch positions reshape to their sqrt(N) x
    sqrt(N) grid and resample to the target grid, at half-pixel centres and
    antialiased when the grid shrinks, as ``jax.image.resize(...,
    "bilinear")`` does."""
    cls_pos, patch_pos = pos_embed[:, :1], pos_embed[:, 1:]
    n_src, n_dst = patch_pos.shape[1], target_tokens - 1
    if n_src == n_dst:
        return pos_embed
    gs, gd = math.isqrt(n_src), math.isqrt(n_dst)
    d = patch_pos.shape[-1]
    grid = patch_pos.reshape(1, gs, gs, d).permute(0, 3, 1, 2).float()
    resized = resize_bilinear(grid, (gd, gd))
    resized = resized.permute(0, 2, 3, 1).reshape(1, gd * gd, d)
    return torch.cat([cls_pos, resized.to(pos_embed.dtype)], dim=1)


def transfer_resolution(state: Mapping[str, torch.Tensor], image_size: int,
                        patch_size: int) -> Dict[str, torch.Tensor]:
    """A copy of a RoViTKAN state_dict with the backbone's position
    embedding resampled for ``image_size`` (JAX
    ``convert.transfer_resolution``); the input is untouched. Load it into
    a model built at ``image_size``."""
    out = dict(state)
    out[POS_EMBED_KEY] = interpolate_pos_embed(
        state[POS_EMBED_KEY], (image_size // patch_size) ** 2 + 1)
    return out


# -- weight import: reference and timm checkpoints -------------------------

def _np(x) -> np.ndarray:
    """An owned fp32 numpy copy (never a view of a live tensor)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.array(x, dtype=np.float32, copy=True)


def _linear(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": _np(sd[f"{prefix}.weight"]).T,
            "bias": _np(sd[f"{prefix}.bias"])}


def _layernorm(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def convert_timm_vit(sd: Mapping, depth: int = 12, prefix: str = "") -> Dict:
    """A timm VisionTransformer state_dict (deit_tiny layout: ``cls_token``,
    ``pos_embed``, ``patch_embed.proj``, ``blocks.{i}.{norm1, attn.qkv,
    attn.proj, norm2, mlp.fc1, mlp.fc2}``, ``norm``) as the JAX backbone
    tree. The patch convolution ``(D, C, p, p)`` becomes the ``(p * p * C,
    D)`` kernel; other keys (``head.*``, ``fc_norm``, ...) are ignored."""
    p = prefix
    conv = torch.from_numpy(_np(sd[f"{p}patch_embed.proj.weight"]))
    out: Dict = {
        "cls_token": _np(sd[f"{p}cls_token"]),
        "pos_embed": _np(sd[f"{p}pos_embed"]),
        "patch_embed": {"proj": {
            "kernel": np.ascontiguousarray(
                patch_weight_from_conv(conv).numpy().T),
            "bias": _np(sd[f"{p}patch_embed.proj.bias"])}},
        "norm": _layernorm(sd, f"{p}norm"),
    }
    for i in range(depth):
        b = f"{p}blocks.{i}"
        out[f"blocks_{i}"] = {
            "norm1": _layernorm(sd, f"{b}.norm1"),
            "attn": {"qkv": _linear(sd, f"{b}.attn.qkv"),
                     "proj": _linear(sd, f"{b}.attn.proj")},
            "norm2": _layernorm(sd, f"{b}.norm2"),
            "mlp": {"fc1": _linear(sd, f"{b}.mlp.fc1"),
                    "fc2": _linear(sd, f"{b}.mlp.fc2")},
        }
    return out


def convert_reference_checkpoint(sd: Mapping, depth: int = 12) -> Dict:
    """A reference RoViTKAN ``model_state_dict`` as the JAX param tree. A
    head the checkpoint lacks (an ablation variant) is absent from the
    tree, as in the variant's model."""
    params: Dict = {"backbone": convert_timm_vit(sd, depth=depth,
                                                 prefix="backbone.model.")}
    if "classification_head.fc1.weight" in sd:
        params["classification_head"] = {
            "trunk": {"fc1": _linear(sd, "classification_head.fc1")},
            "fc2": _linear(sd, "classification_head.fc2")}
    if "ordinal_head.fc1.weight" in sd:
        params["ordinal_head"] = {
            "trunk": {"fc1": _linear(sd, "ordinal_head.fc1")},
            "fc2": _linear(sd, "ordinal_head.fc2")}
    if "uncertainty_head.fc1.weight" in sd:
        params["uncertainty_head"] = {
            "trunk": {"fc1": _linear(sd, "uncertainty_head.fc1")},
            "fc_mu": _linear(sd, "uncertainty_head.fc_mu"),
            "fc_logvar": _linear(sd, "uncertainty_head.fc_logvar")}
    if "kan_module.kan_layers.0.spline_weights" in sd:
        n_kan = sum(1 for k in sd if k.startswith("kan_module.kan_layers.")
                    and k.endswith(".spline_weights"))
        params["kan_module"] = {
            f"kan_layers_{i}": {
                "spline_weights": _np(
                    sd[f"kan_module.kan_layers.{i}.spline_weights"]),
                "kernel": _np(
                    sd[f"kan_module.kan_layers.{i}.linear.weight"]).T,
                "bias": _np(sd[f"kan_module.kan_layers.{i}.linear.bias"])}
            for i in range(n_kan)}
    return params


def load_torch_checkpoint(path) -> Dict[str, np.ndarray]:
    """A reference ``best_model.pth`` (its ``model_state_dict``) or a bare
    state_dict file, as fp32 numpy arrays. ``torch.load`` unpickles the
    whole file, as the JAX function does: load only files you trust."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    sd = ck.get("model_state_dict", ck)
    return {k: _np(v) for k, v in sd.items()}


def save_npz(params: Mapping, path) -> None:
    """Flatten a param tree to an ``.npz``, keys joined with '/' (the JAX
    package's format)."""
    flat: Dict[str, np.ndarray] = {}

    def rec(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                rec(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    rec(params)
    np.savez(path, **flat)


def load_npz(path) -> Dict:
    """The inverse of ``save_npz``."""
    out: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = out
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = z[key]
    return out


def convert_checkpoint_file(pth_path, npz_path=None, depth: int = 12) -> Dict:
    """A reference ``.pth`` as the JAX param tree, also written to
    ``npz_path`` when given."""
    params = convert_reference_checkpoint(load_torch_checkpoint(pth_path),
                                          depth=depth)
    if npz_path is not None:
        save_npz(params, npz_path)
    return params


def merge_pretrained(params: Mapping, pretrained: Mapping,
                     verbose: bool = True) -> Dict:
    """A copy of the JAX param tree ``params`` with the converted
    ``pretrained`` weights laid over it (the reference's
    ``pretrained=True``): a leaf of the same shape replaces the init; a
    ``pos_embed`` of another grid (same width) is resampled to this one by
    ``interpolate_pos_embed``; keys ``params`` lacks are skipped, and a leaf
    of another shape keeps its init. ``params`` is left as it was."""
    out = copy.deepcopy(params)

    def rec(dst, src, path=""):
        for k, v in src.items():
            if k not in dst:
                if verbose:
                    print(f"  [pretrained] skipping unknown {path}{k}")
                continue
            if isinstance(v, Mapping):
                rec(dst[k], v, f"{path}{k}/")
            elif np.shape(dst[k]) == np.shape(v):
                dst[k] = np.asarray(v, dtype=np.float32)
            elif k == "pos_embed" and np.ndim(v) == 3 \
                    and np.shape(v)[-1] == np.shape(dst[k])[-1]:
                dst[k] = interpolate_pos_embed(
                    torch.from_numpy(np.array(v, np.float32)),
                    np.shape(dst[k])[1]).numpy()
                if verbose:
                    print(f"  [pretrained] interpolated {path}{k} "
                          f"{np.shape(v)} -> {np.shape(dst[k])}")
            elif verbose:
                print(f"  [pretrained] shape mismatch {path}{k}: "
                      f"{np.shape(v)} vs {np.shape(dst[k])} — keeping init")

    rec(out, pretrained)
    return out
